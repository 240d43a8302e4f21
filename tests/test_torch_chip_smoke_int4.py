"""``chip_smoke.py``'s phases ``generate_int4``, ``engine_int4`` and
``generate_int8`` rehearsed on the CPU at a tiny size, over the generate
phase's row: int4_matmul's plain version takes every quantized product,
its launches gated; the int4 engines' waves (submitted one request at a
time) agree across the paged, dense and fused engines, each run's batches
and joins in its row."""

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


def test_int4_and_int8_phases_rehearse_on_the_cpu(smoke, main_path, capsys):
    int4 = smoke.phase_generate_int4(torch, main_path)
    for r in int4["runs"]:
        assert r["launches"] == r["expected_launches"]
        assert r["launches"]["int4_matmul_plain"] > 0 and r["launches"]["int4_matmul"] == 0
    assert int4["chunked_equal_tokens"] == smoke.DECODE_TOKENS
    assert int4["check"]["max_abs_err"] == 0.0  # on the CPU both runs are plain
    int4_engine = smoke.phase_engine_int4(torch, main_path, int4)
    assert [(r["spec"], r["kv_mode"]) for r in int4_engine["runs"]] == [
        ("none", "paged"), ("none", "dense"), ("all", "paged")]
    for r in int4_engine["runs"]:
        assert r["launches"] == r["expected_launches"]
        assert r["launches"]["int4_matmul_plain"] > 0
    fused_int4 = int4_engine["runs"][2]["launches"]
    assert fused_int4["fused_norm_matmul.quantized"] > 0
    assert fused_int4["fused_norm_matmul_plain"] == fused_int4["fused_norm_matmul"] == 0
    assert int4_engine["dense_equal_paged"] == int4_engine["all_equal_none"] == smoke.ENGINE_BATCH
    # The compared wave went in one request at a time; its batches and joins
    # are recorded for every run.
    assert int4_engine["wave_submitted"] == "one request at a time"
    for r in int4_engine["runs"]:
        assert len(r["batches_joins"]) == 1 and r["batches_joins"][0][0] >= 1
    int8 = smoke.phase_generate_int8(torch, main_path)
    assert int8["run"]["launches"] == int8["run"]["expected_launches"]
    assert int8["run"]["launches"]["int4_matmul_plain"] == 0
    # The kernels line reads both int4 rows' launches: the kernel's, none here.
    assert int4["int4_launches"] == int4_engine["int4_launches"] == 0
    assert R.phases(capsys.readouterr().out) == [
        "generate_int4", "int4_model_check", "engine_int4", "generate_int8"]
