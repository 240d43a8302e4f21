"""``chip_smoke.py``'s kernels line and the int4 bits probe rehearsed on the
CPU.

The line (``kernel_summary``) adds up each kernel's launches from the
phases' rows and takes each kernel's timed case. Each phase's rehearsal
(tests/test_torch_chip_smoke_<phase>.py) pins the keys its row hands the
line; here rows of those shapes, with launch counts of their own, hold the
line's arithmetic and keys: every kernel's entry has the contract's keys,
the redesigned kernels their instructions, the kernels of no Pallas
counterpart (the noise kernel, the grouped expert GEMM) their counterpart
note, and each launch count is the sum of its phases'."""

import pytest
import torch

import _chip_smoke_rehearsal as R
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)

KERNEL_KEYS = {
    "name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
    "bound_ms", "bound_by", "library_ms",
}


@pytest.fixture(scope="module")
def smoke():
    return R.load_smoke()


def _launch_row(counters, n: int) -> dict:
    """A phase row's launches: each of ``counters`` at ``n``."""
    return {"launches": dict.fromkeys([c.__name__ for c in counters], n)}


def test_kernels_line_rehearses_on_the_cpu(smoke, capsys):
    # The int4 bodies' bits probe at a small width (on the CPU every body is
    # the plain version, so they agree).
    bits = smoke.int4_wgmma_bits(torch, torch.device("cpu"), sites=(("w", 256, 128),), n_rows=40)
    assert bits["answer"] == smoke.WGMMA_AGREE
    assert set(bits["equal"]) == {f"w_wgmma{n}" for n in smoke.WGMMA_WIDTHS} | {
        f"w_wgmma{n}_fold" for n in (32, 64, 128)}
    timed = {"max_abs_err": 0.0, "ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5,
             "bound_by": "bytes", "library_ms": None, "route": "mma.sync"}
    names = ["decode_attention", "chunk_prefill_attention", "paged_decode_attention",
             "paged_chunk_attention", "fused_norm_matmul", "fused_qkv_ingest",
             "fused_sample_tail", "int4_matmul"]
    rows = {(name, "main_path"): timed for name in names[:4]}
    rows.update({(name, case): timed for name, case in smoke.FUSED_MAIN.items()})
    rows[("int4_matmul", smoke.INT4_MAIN)] = timed
    rows[("int4_matmul", "w_gu_row_independence")] = {"equal": {"row0": True}}
    rows[("int4_matmul", "wgmma_bits")] = bits
    rows[("int4_matmul", "w_gu_rows3840")] = dict(timed, route="wgmma")
    rows[("launch_floor", "empty_kernel")] = {"ms": 0.25}
    f8_names = ["decode_attention", "chunk_prefill_attention", "paged_decode_attention",
                "paged_chunk_attention", "fused_qkv_ingest"]
    rows.update({(name, "main_path_f8"): dict(timed, library="sdpa") for name in f8_names[:4]})
    rows[("fused_qkv_ingest", "paged_b8_f8")] = dict(timed, library="unfused")
    rows[("threefry_noise", "per_row_b8")] = dict(timed, library="torch.rand", gumbel_bitwise=True)
    rows[("grouped_matmul", "mixtral_w_gate")] = dict(timed, library={"call": "torch._grouped_mm"})
    rows[("grouped_matmul", "mixtral_w_gate_row_independence")] = {"equal": {"a": True}}
    # The generate phase counts the dense kernels, the engine phase every
    # wrapper (its dense ones idle).
    row, engine = _launch_row(smoke._counters(), 11), _launch_row(smoke._paged_counters(), 13)
    fused_gen = {"fused_launches": dict.fromkeys(smoke.FUSED_MAIN, 2)}
    fused_engine = {"fused_launches": dict.fromkeys(smoke.FUSED_MAIN, 3), "noise_launches": 4}
    int4, int4_engine = {"int4_launches": 5}, {"int4_launches": 6}
    f8_gen = {"f8_launches": dict.fromkeys(f8_names, 1)}
    f8_engine = {"f8_launches": dict.fromkeys(f8_names, 2)}
    # engine_continuous's launches (tests/test_torch_chip_smoke_continuous.py
    # rehearses the phase) add to the paged kernels' and the noise kernel's,
    # and so do obs's; the moe phase's to the grouped GEMM's.
    cont = {"launches": {"paged_decode_attention": 3, "paged_chunk_attention": 5,
                         "threefry_noise": 7}}
    obs = {"launches": {"paged_decode_attention": 17, "paged_chunk_attention": 19}}
    moe = {"phase": "moe", "launches": {"grouped_matmul": 23}}
    summary = smoke.kernel_summary(rows, row, engine, (fused_gen, fused_engine),
                                   (int4, int4_engine), (f8_gen, f8_engine), cont,
                                   model_paths=(moe,), obs_path=obs)
    assert [k["name"] for k in summary["kernels"]] == (
        names + [f"{n}_f8" for n in f8_names] + ["threefry_noise", "grouped_matmul"])
    for k in summary["kernels"]:
        extra = {"redesigned", "instructions"} if k["name"] in smoke.REDESIGNED else set()
        if k["name"] in ("fused_qkv_ingest", "fused_sample_tail", "fused_qkv_ingest_f8",
                         "threefry_noise"):
            assert k["launch_floor_ms"] == 0.25
            extra |= {"launch_floor_ms"}
        if k["name"] == "threefry_noise":
            extra |= {"counterpart", "library", "gumbel_bitwise"}
        if k["name"] == "grouped_matmul":
            extra |= {"counterpart", "library", "row_independence"}
        if k["name"].endswith("_f8"):
            extra |= {"kv_dtype", "library"}
        extra |= {"shapes"} if not k["name"].endswith("_f8") else set()
        assert set(k) == KERNEL_KEYS | extra | ({"wgmma_bits"} if k["name"] == "int4_matmul" else set())
    by_name = {k["name"]: k for k in summary["kernels"]}
    assert by_name["int4_matmul"]["instructions"] == ["mma.sync", "wgmma"]
    assert all(by_name[n]["redesigned"] == pr for n, pr in smoke.REDESIGNED.items())
    assert by_name["int4_matmul"]["wgmma_bits"] == smoke.WGMMA_AGREE
    assert by_name["int4_matmul"]["launches"] == int4["int4_launches"] + int4_engine["int4_launches"]
    assert by_name["threefry_noise"]["launches"] == fused_engine["noise_launches"] + 7
    for name, n in (("paged_decode_attention", 3 + 17), ("paged_chunk_attention", 5 + 19)):
        assert by_name[name]["launches"] == engine["launches"][name] + n
    assert by_name["decode_attention"]["launches"] == row["launches"]["decode_attention"]
    assert by_name["fused_norm_matmul"]["launches"] == 2 + 3
    assert by_name["decode_attention_f8"]["launches"] == 1 + 2
    gmm = by_name["grouped_matmul"]
    assert gmm["launches"] == 23 and gmm["row_independence"] is True
    assert gmm["source"] == "cake_tpu_torch/ops/csrc/moe_grouped.cu"
    assert gmm["replaces"] == "cake_tpu/ops/moe.py:95"
    assert R.phases(capsys.readouterr().out) == ["kernels"]
