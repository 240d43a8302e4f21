"""``chip_smoke.py``'s phases ``engine`` and ``api_engine`` rehearsed on the
CPU at a tiny size, over the generate phase's row: the paged and dense
engines' launch counts of the plain versions, warm ≡ cold, paged ≡ dense,
the recorded dispatch operands and the engine's API with SSE clients."""

import pytest
import torch

import _chip_smoke_rehearsal as R
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def smoke():
    return R.load_smoke()


@pytest.fixture(scope="module")
def main_path(smoke):
    return R.generate_row(smoke)


def test_engine_and_api_engine_rehearse_on_the_cpu(smoke, main_path, capsys):
    engine = smoke.phase_engine(torch, main_path)
    assert engine["launches"] == engine["expected_launches"]
    assert engine["launches"]["paged_decode_attention_plain"] > 0
    assert engine["launches"]["paged_chunk_attention_plain"] > 0
    assert engine["dense_launches"] == engine["dense_expected_launches"]
    assert engine["dense_launches"]["decode_attention_plain"] > 0
    assert engine["dense_launches"]["chunk_prefill_attention_plain"] > 0
    assert engine["prefix_hits_wave2"] > 0
    assert engine["wave2_equal_streams"] == smoke.ENGINE_BATCH  # warm == cold, gated
    assert engine["waves"][2]["joins"] > 0 and engine["dense_waves"][1]["joins"] > 0
    # Both runs of each check are the plain path here.
    assert engine["check"]["max_abs_err"] == 0.0
    assert engine["dense_check"]["max_abs_err"] == 0.0
    # On the CPU every path is the plain arithmetic: paged equals dense.
    assert engine["dense_equal_streams"] == smoke.ENGINE_BATCH
    assert engine["ragged_dense_equal_streams"] == len(smoke.RAGGED_TURNS)
    for mode, names in (("paged", ("paged_decode_attention", "paged_chunk_attention")),
                        ("dense", ("decode_attention", "chunk_prefill_attention"))):
        assert set(engine["dispatches"][mode]) == set(names)
    smoke.phase_api_engine(main_path, engine)
    # The kernels line reads the row's launches and the f8 phase its pool.
    assert engine["pool_bytes"] > 0
    # The failover-local wave (the crash mid-decode) migrates 8/8.
    assert engine["failover"]["equal_streams"] == smoke.ENGINE_BATCH
    assert engine["failover"]["failovers"] == 1
    assert R.phases(capsys.readouterr().out) == ["engine", "paged_model_check",
                                                 "dense_model_check", "engine_failover",
                                                 "api_engine"]
