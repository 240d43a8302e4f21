"""``chip_smoke.py``'s phase ``obs`` rehearsed on the CPU.

On the card the phase serves Llama-3-8B's waves through the paged engine
behind the port's API with every recorder armed. Here it runs over a tiny
2-layer model with CPU tensors, cut to 96 tokens out over pages of 16 so
that the pool of one epoch's charges runs dry within them: every gate of
the phase runs (the armed streams equal the off ones, /metrics against the
engine's stats, the ledger's buckets and its MBU and MFU against the card's
peaks passed as flags, every /explain adding up, a restore phase, the trace,
the routes and the request log)."""

import pytest
import torch

import _chip_smoke_rehearsal as R
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import LlamaGenerator, LocalForwardStep, SamplingConfig
from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
from cake_tpu_torch.obs.timeline import timeline
from cake_tpu_torch.ops.fuse import fuse_params
from cake_tpu_torch.utils import metrics


@pytest.fixture(scope="module")
def smoke():
    return R.load_smoke()


def test_obs_rehearses_on_the_cpu(smoke, monkeypatch, capsys):
    config = LlamaConfig.tiny(num_hidden_layers=2)
    params = fuse_params(M.init_params(config, torch.Generator().manual_seed(0), torch.bfloat16,
                                       "cpu"))
    step = LocalForwardStep(config, params, max_seq_len=smoke.MAX_SEQ,
                            cache_dtype=torch.bfloat16, device="cpu")
    gen = LlamaGenerator(config, step, ByteTokenizer(),
                         SamplingConfig(temperature=0.0, repeat_penalty=1.0))
    monkeypatch.setattr(smoke, "ENGINE_PAGE", 16)
    try:
        row = smoke.phase_obs(torch, {"generator": gen, "card": "cpu"}, tokens=96)
    finally:
        metrics.flight.attach_jsonl(None)
        timeline.attach_jsonl(None)
    assert R.phases(capsys.readouterr().out) == ["obs"]
    assert row["config"]["pool_pages"] == 8 * 31
    assert row["armed_equal_off"] == {"cold": smoke.ENGINE_BATCH,
                                      "pressured": smoke.ENGINE_BATCH}
    assert row["armed"]["pressured"]["preemptions"] >= 1
    assert row["armed"]["pressured"]["restores"] >= 1 and row["explain_restore"] >= 1
    # A cold wave: the only prefix hits are restores forking their own spills.
    cold = row["armed"]["cold"]
    assert cold["prefix_hits"] == cold["restores"]
    for name, pair in row["counters"].items():
        assert pair["metrics"] == pair["engine"], name
    assert row["counters"]["requests"]["engine"] == 3 * smoke.ENGINE_BATCH
    assert row["accounted_frac"] >= 0.95
    assert 0 < row["roofline"]["mbu"] <= 1 and 0 < row["roofline"]["mfu"] <= 1
    assert row["roofline"]["source"] == "flag"
    assert len(row["explain"]) == 2 * smoke.ENGINE_BATCH
    assert row["trace_errors"] == [] and row["request_log_lines"] == 3 * smoke.ENGINE_BATCH
    assert row["events_jsonl_lines"] > 0 and row["trace_jsonl_events"] > 0
    assert set(row["routes"].values()) == {200}
    assert row["launches"]["paged_decode_attention_plain"] > 0
    assert row["launches"]["paged_chunk_attention_plain"] > 0
    assert row["launches"]["paged_decode_attention"] == 0  # the kernels never run here
