"""``chip_smoke.py``'s phase ``decode_graph`` rehearsed on the CPU at a tiny
size, over the generate phase's row and the int4 phase's weights: on the
CPU a DecodeChunk runs its loop uncaptured, so this rehearses the bits
checks' and the timings' bookkeeping (the card gates skip here)."""

import pytest
import torch

import _chip_smoke_rehearsal as R
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def smoke():
    return R.load_smoke()


@pytest.fixture(scope="module")
def paths(smoke):
    row = R.generate_row(smoke)
    return row, smoke.phase_generate_int4(torch, row)


def test_decode_graph_rehearses_on_the_cpu(smoke, paths, capsys):
    row, int4 = paths
    capsys.readouterr()
    graph = smoke.phase_decode_graph(torch, row, int4)
    assert set(graph["generator_bits"]) == {
        f"{c}_{k}" for c in ("bf16_none", "bf16_all", "int4_none") for k in ("greedy", "sampled")}
    for r in graph["generator_bits"].values():
        assert r["chunks_equal"] == [True] * smoke.GRAPH_CHUNKS and r["kv_equal"] and r["key_equal"]
        assert r["per_step_equal"]
    assert [(r["spec"], r["kv_mode"], r["int4"]) for r in graph["engine_bits"]] == [
        ("none", "paged", False), ("all", "paged", False), ("none", "paged", True),
        ("all", "dense", False)]
    for r in graph["engine_bits"]:
        assert r["dispatches"] > 0 and r["equal"] == r["dispatches"]
        if r["kv_mode"] == "paged":
            assert r["short_chunks"] > 0 and r["table_changes"] > 0
    assert graph["engine_bits"][1]["pads_changes"] > 0  # the ragged wave's joins
    assert [t["mode"] for t in graph["generator_timing"]] == ["graph", "eager"] * 3
    assert [t["mode"] for t in graph["engine_timing"]] == ["graph", "eager"] * 2
    assert graph["captures"]["captures"] == 0  # nothing is captured on the CPU
    assert R.phases(capsys.readouterr().out) == ["decode_graph"]
