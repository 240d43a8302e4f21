"""``chip_smoke.py``'s failover additions rehearsed on the CPU at a tiny
size (2 layers): phase ``engine``'s ``--failover-local`` wave on the paged
local engine (a crash at the fourth decode chunk: the streams equal the
fault-free wave 8/8, one failover, 8 recovered, the pool whole), and phase
``distributed``'s TCP failover (topology B, w2 unreachable for good from
mid-decode of wave 1: the streams migrate to w2b and equal the dense local
engine's wave 1, cake_failover_total{w2} 1, with heartbeats on) and its
no-replica case (topology A, w1 killed: the streams end "error", every
lane back, the next wave served), under the gates of the card run."""

import pytest
import torch

import _chip_smoke_rehearsal as R
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)
from cake_tpu_torch.parallel.topology import Topology
from cake_tpu_torch.runtime import faults
from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig


@pytest.fixture(scope="module")
def smoke():
    return R.load_smoke()


@pytest.fixture(scope="module")
def main_path(smoke):
    return R.generate_row(smoke)


@pytest.fixture(autouse=True)
def _no_plan():
    faults.clear()
    yield
    faults.clear()


def test_engine_failover_local_rehearses_on_the_cpu(smoke, main_path, capsys):
    """The early replay 8/8; the late fault under a budget far below the
    replay's price re-prefills (1 ms on the CPU, where the tiny model's
    replay is cheap); the prefix-cache engine re-prefills; on the CPU every
    rebuild keeps the streams."""
    row = smoke._engine_failover_local(torch, main_path)
    assert row["late"]["budget_s"] == 1e-3
    assert row["equal_streams"] == smoke.ENGINE_BATCH
    assert (row["failovers"], row["recovered"], row["stream_errors"]) == (
        1, smoke.ENGINE_BATCH, 0)
    assert row["pool_whole"] and row["plan"].startswith("crash@backend.decode")
    assert [m["how"] for m in row["migrations"]] == ["replay"]
    assert [m["how"] for m in row["late"]["migrations"]] == ["reprefill"]
    assert row["late"]["equal_streams"] == smoke.ENGINE_BATCH
    assert row["prefix_cache"]["equal_streams"] == smoke.ENGINE_BATCH
    assert R.phases(capsys.readouterr().out) == ["engine_failover"]


def _local_wave1(smoke, main_path):
    gen = main_path["generator"]
    eng = BatchEngine(gen.config, gen.step.params, gen.tokenizer,
                      max_seq_len=smoke.ENGINE_MAX_SEQ, cache_dtype=torch.bfloat16,
                      serve=ServeConfig(max_batch=smoke.ENGINE_BATCH, decode_chunk_size=8),
                      device="cpu")
    try:
        return smoke._wave(eng, smoke.ENGINE_TOKENS, together=True)["streams"]
    finally:
        eng.stop()


def test_tcp_failover_and_no_replica_rehearse_on_the_cpu(smoke, main_path):
    gen = main_path["generator"]
    config, params = gen.config, gen.step.params
    want = _local_wave1(smoke, main_path)
    topo_b = Topology.from_dict({
        "w1": {"host": "placeholder", "layers": ["model.layers.0"]},
        "w2": {"host": "placeholder", "layers": ["model.layers.1"]},
        "w2b": {"host": "placeholder", "layers": ["model.layers.1"]},
    })
    fo = smoke._tcp_failover(torch, config, params, gen.tokenizer, torch.device("cpu"), topo_b,
                             smoke.ENGINE_MAX_SEQ,
                             f"kill@client.send:node=w2:after={smoke.FAILOVER_AFTER}:count=0",
                             heartbeat=True, prefer="w2")
    assert fo["streams"] == want  # the migration's streams: the local wave's, 8/8
    assert (fo["failovers"], fo["recovered"], fo["stream_errors"]) == (1, smoke.ENGINE_BATCH, 0)
    assert fo["failover_total"] == {"w1": 0, "w2": 1, "w2b": 0}
    assert fo["router"]["routes"]["w2"] == "w2b" and fo["router"]["ejected"] == ["w2"]
    assert fo["heartbeat"] is not None and len(fo["failover_seconds"]) == 1
    assert fo["next_wave_streams"] == want
    topo_a = Topology.from_dict({"w1": {"host": "placeholder", "layers": ["model.layers.1"]}})
    nr = smoke._tcp_failover(torch, config, params, gen.tokenizer, torch.device("cpu"), topo_a,
                             smoke.ENGINE_MAX_SEQ,
                             f"kill@client.send:node=w1:after={smoke.FAILOVER_AFTER}:count=0",
                             heartbeat=False, prefer="w1")
    assert nr["finish_reasons"] == ["error"] * smoke.ENGINE_BATCH
    assert nr["failovers"] == 0 and nr["stream_errors"] == smoke.ENGINE_BATCH
    assert nr["live_after"] == 0
    assert nr["next_wave_streams"] == want
    # Each stream ended with a prefix of its fault-free stream.
    assert all(s == w[: len(s)] and len(s) < len(w) for s, w in zip(nr["streams"], want))


def test_failover_times_script_rehearses_on_the_cpu(capsys):
    """scripts/failover_times.py's sections at a 2-layer tiny config: the
    K/V bits of a decode against a prefill (f32 on the CPU: equal), the
    local engine's replay and re-prefill migrations late and early, the
    prefix-cache engine's, and the TCP ones; every migrated wave finishes
    without an error, each run rebuilds as its budget says."""
    import importlib.util
    import json

    from cake_tpu_torch.models.llama.config import LlamaConfig

    spec = importlib.util.spec_from_file_location("failover_times",
                                                  R.REPO / "scripts" / "failover_times.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.run(dev="cpu", config=LlamaConfig.tiny(num_hidden_layers=2), tokens=48, after=4)
    rows = {r["section"]: r for r in map(json.loads, capsys.readouterr().out.splitlines())}
    assert set(rows) == {"setup", "kv_bits", "local", "tcp"}
    assert len(rows["kv_bits"]["layers"]) == 2
    runs = {f"{s}.{k}": v for s in ("local", "tcp") for k, v in rows[s].items()
            if isinstance(v, dict)}
    assert sorted(runs) == ["local.early_replay", "local.early_reprefill", "local.late_replay",
                            "local.late_reprefill", "local.prefix_early", "tcp.early_reprefill",
                            "tcp.late_replay", "tcp.late_reprefill"]
    for name, run in runs.items():
        assert run["stream_errors"] == 0 and len(run["migrations"]) == 1, name
        how = run["migrations"][0]["how"]
        assert how == ("replay" if name.endswith("replay") else "reprefill"), name
        assert run["equal_streams"] == 8 and set(run["first_differences"]) == {None}, name
