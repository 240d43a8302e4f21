"""``chip_smoke.py``'s phases ``generate_fused`` and ``engine_fused``
rehearsed on the CPU at a tiny size, over the generate phase's row: the
fusions' plain versions take every call, their launch counts gated, every
stream agrees, and the sampled waves draw their noise through the twin."""

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


def test_fused_phases_rehearse_on_the_cpu(smoke, main_path, capsys):
    fused_gen = smoke.phase_generate_fused(torch, main_path)
    assert fused_gen["launches"] == fused_gen["expected_launches"]
    assert fused_gen["launches"]["fused_sample_tail_plain"] > 0
    assert fused_gen["launches"]["fused_norm_matmul_plain"] > 0
    assert fused_gen["check"]["max_abs_err"] == 0.0  # on the CPU both runs are plain
    fused_engine = smoke.phase_engine_fused(torch, main_path)
    assert [r["spec"] for r in fused_engine["runs"]] == ["none", "ingest,tail", "all", "all"]
    for r in fused_engine["runs"]:
        assert r["launches"] == r["expected_launches"]
    all_paged = fused_engine["runs"][2]["launches"]
    assert all_paged["fused_qkv_ingest_plain"] > 0 and all_paged["fused_sample_tail_plain"] > 0
    # On the CPU every fusion is the plain arithmetic: all streams agree.
    assert fused_engine["ingest_tail_equal_streams"] == [smoke.ENGINE_BATCH] * 2
    assert fused_engine["all_equal_streams"] == [smoke.ENGINE_BATCH] * 2
    assert fused_engine["check"]["max_abs_err"] == fused_engine["dense_check"]["max_abs_err"] == 0.0
    # The sampled waves drew their noise through the plain twin here, once a
    # first sample and once a decode step (gated), and never the kernel.
    for r in fused_engine["runs"][:3]:
        assert r["launches"]["threefry_noise_plain"] > 0
        assert r["launches"]["threefry_noise_plain"] == r["expected_launches"]["threefry_noise_plain"]
    assert fused_engine["runs"][3]["launches"]["threefry_noise_plain"] == 0  # dense: greedy only
    assert fused_engine["noise_launches"] == 0
    # The kernels line reads both rows' fused launches.
    for path in (fused_gen, fused_engine):
        assert set(path["fused_launches"]) == set(smoke.FUSED_MAIN)
    assert R.phases(capsys.readouterr().out) == [
        "generate_fused", "fused_model_check", "engine_fused", "paged_fused_model_check",
        "dense_fused_model_check"]
