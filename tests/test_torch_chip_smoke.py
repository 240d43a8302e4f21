"""``chip_smoke.py``'s helpers rehearsed on the CPU at a tiny size.

The phases rehearse in files of their own, one a phase
(tests/test_torch_chip_smoke_<phase>.py: generate, engine, fused, f8,
int4, decode_graph, cli, kernels_line, continuous, admission, distributed,
moe, obs). Here: the operands the kernel cases are timed at against a real
engine dispatch's, the f8 and noise cases and the bits gates at small
sizes, the trace readers and the bound. Without CUDA, or outside a
checkout of the repo, the script must fail and print no result.
"""

import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cake_tpu_torch.models.llama.config import LlamaConfig
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kv_mode", ["paged", "dense"])
def test_engine_layout_follows_the_engine(smoke, kv_mode):
    """The operands chip_smoke times the kernels at are the ones a real
    engine dispatch hands them: ``recording`` against a spy on the plain
    versions the wrappers run on the CPU, over one cold wave."""
    from unittest import mock

    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.chat import Message
    from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
    from cake_tpu_torch.ops import chunk_prefill, decode_attention, paged_attention, paged_prefill
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    config = LlamaConfig.tiny(num_hidden_layers=2)
    params = M.init_params(config, torch.Generator().manual_seed(0), torch.float32)
    paged = kv_mode == "paged"
    serve = ServeConfig(max_batch=4, decode_chunk_size=2, kv_mode=kv_mode, page_size=16,
                        prefix_cache=paged)
    engine = BatchEngine(config, params, ByteTokenizer(), max_seq_len=256,
                         cache_dtype=torch.float32, serve=serve, device="cpu")
    plains = ((paged_prefill, "paged_chunk_attention_plain"),
              (paged_attention, "paged_decode_attention_plain")) if paged else (
              (chunk_prefill, "chunk_prefill_attention_plain"),
              (decode_attention, "decode_attention_plain"))
    spies = [mock.patch.object(mod, name, wraps=getattr(mod, name)) for mod, name in plains]
    decode_call = 2 * config.num_hidden_layers  # layer 0 of the third decode step
    engine.start()
    try:
        with spies[0] as chunk_spy, spies[1] as decode_spy:
            with smoke.recording(decode_call) as seen:
                messages = [[Message.system("share this prefix"), Message.user("q" * n)]
                            for n in (3, 20, 9)]
                smoke._wave(engine, 8, messages)
    finally:
        engine.stop()
    shapes = smoke.dispatch_shapes(seen)
    names = (("paged_chunk_attention", "paged_decode_attention") if paged
             else ("chunk_prefill_attention", "decode_attention"))
    for name, spy, call in zip(names, (chunk_spy, decode_spy), (0, decode_call)):
        args = spy.call_args_list[call].args
        got = shapes[name]
        assert got["q"] == tuple(args[0].shape) and got["kv"] == tuple(args[1].shape)
        for key, index in smoke._RECORDED[name].items():
            assert got[key] == args[index].tolist(), (name, key)
        if paged:
            assert got["n_p"] == args[smoke._TABLE_ARG[name]].shape[1]
    # The prefill covers every lane at once, the decode call one token each.
    assert shapes[names[0]]["q"][0] == shapes[names[1]]["q"][0] == 4
    assert shapes[names[1]]["q"][1] == 1


def test_f8_bits_gate_rehearses_on_the_cpu(smoke, capsys):
    """The f8 kernels' bits gate at small engine-like operands: on the CPU
    each wrapper runs its plain version, which widens f8 to bf16 exactly,
    so the f8 calls equal the widened and the dense ones, and the row is
    emitted."""
    decode = {"lengths": [5, 130, 200], "starts": [0, 3, 64], "n_p": 2}
    chunk = {"q": (3, 20, smoke.N_Q, smoke.HD), "q_starts": [0, 110, 180],
             "lengths": [20, 130, 200], "k_starts": [0, 3, 64], "n_p": 2}
    g = torch.Generator().manual_seed(0)
    row = smoke.f8_bits(torch, torch.device("cpu"), g, 1, decode, chunk)
    (emitted,) = [smoke.json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert emitted["case"] == "f8_bits" and emitted["kv_dtype"] == "f8"
    assert {k: v for k, v in row.items() if k.startswith("paged_")} == dict.fromkeys(
        ("paged_decode_eq_widened", "paged_decode_eq_dense", "paged_chunk_eq_widened",
         "paged_chunk_eq_dense"), True)


def test_f8_kernel_cases_rehearse_on_the_cpu(smoke, monkeypatch, capsys):
    """The f8 kernel cases at a small cache on the CPU (the timings, which
    need the card, stubbed): each holds its f8 call to the plain version,
    counts fewer bytes than its bf16 case for the same operations, and
    names its yardstick; the ingest's six values past +-464 come back NaN
    in the bytes compared."""
    monkeypatch.setattr(smoke, "cuda_ms", lambda torch, fn, iters, warmup=2: (fn(), 0.5)[1])
    monkeypatch.setattr(smoke, "traced_route", lambda torch, run: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    dev, f8 = torch.device("cpu"), torch.float8_e4m3fn
    g = torch.Generator().manual_seed(0)
    rows = {}
    for kv in (None, f8):
        name = "f8" if kv else "bf16"
        rows["decode", name] = smoke._decode_case(torch, dev, g, name, [5, 200], None, {},
                                                  max_seq=256, kv=kv)
        rows["chunk", name] = smoke._chunk_case(torch, dev, g, name, 16, [0, 100], [0, 3], {},
                                                max_seq=256, kv=kv)
        rows["paged_decode", name] = smoke._paged_decode_case(torch, dev, g, 1, name, [5, 200],
                                                              [0, 3], 2, kv=kv)
        rows["paged_chunk", name] = smoke._paged_chunk_case(torch, dev, g, 2, name, 16, [0, 100],
                                                            [16, 116], [0, 3], 2, kv=kv)
    for kernel in ("decode", "chunk", "paged_decode", "paged_chunk"):
        bf, f8_row = rows[kernel, "bf16"], rows[kernel, "f8"]
        assert f8_row["max_abs_err"] == 0.0 and f8_row["kv_dtype"] == "f8"
        assert f8_row["library"] == smoke.F8_LIBRARY and "kv_dtype" not in bf
        assert f8_row["bytes"] < bf["bytes"] and f8_row["flops"] == bf["flops"]
    for case, b, paged in (("dense_b1_f8", 1, False), ("paged_b8_f8", 8, True)):
        row = smoke._ingest_case(torch, dev, g, case, b, 300, paged=paged, kv=f8)
        assert row["equal"] and row["nan_written"] == 6 and row["kv_dtype"] == "f8"
    capsys.readouterr()


def test_bound_takes_the_larger_of_bytes_and_operations(smoke):
    assert smoke.bound(3.35e9, 1.0) == (1.0, "bytes")
    assert smoke.bound(1.0, 989e9) == (1.0, "operations")
    assert smoke.bound(1.0, 67e9, smoke.CUDA_CORE_OPS_PER_S) == (1.0, "operations")


def test_noise_cases_rehearse_on_the_cpu(smoke, monkeypatch, capsys):
    """The noise kernel's cases at Llama-3's vocabulary on the CPU (the
    timings, which need the card, stubbed): the wrapper runs the plain twin
    here, so keys, bits, uniforms and the gumbel plane agree to the bit;
    the bound counts the plane's bytes and the threefry operations; the
    constants case holds the twin and the wrapper to jax's values."""
    monkeypatch.setattr(smoke, "cuda_ms", lambda torch, fn, iters, warmup=2: (fn(), 0.5)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    per_row, shared, constants = smoke.noise_cases(torch, torch.device("cpu"))
    for row, shape in ((per_row, [8, smoke.VOCAB]), (shared, [1, smoke.VOCAB])):
        assert row["shape"] == shape and row["max_abs_err"] == 0.0 and row["gumbel_bitwise"]
        assert row["equal"] == {"keys": True, "bits": True, "uniform": True}
        assert row["bytes"] >= 4 * shape[0] * shape[1]
        assert row["flops"] == smoke.NOISE_OPS_PER_ELEMENT * shape[0] * shape[1]
        assert row["bound_ms"] == 1e3 * max(row["bytes"] / smoke.HBM_BYTES_PER_S,
                                            row["flops"] / smoke.CUDA_CORE_OPS_PER_S)
    assert per_row["per_row"] and not shared["per_row"]
    assert constants["known_answers"] == [True] * 3 and constants["categorical"]
    assert constants["kernel_split"] and constants["kernel_split_of_zero_key"]
    capsys.readouterr()


@pytest.mark.parametrize(
    "name,family",
    [
        ("void cake::decode_kernel<__nv_bfloat16, 128, 4>(...)", "decode_attention"),
        ("void cake::chunk_kernel<__nv_bfloat16, 128>(...)", "chunk_prefill_attention"),
        ("void cake::decode_kernel<__nv_bfloat16, 128, 4, cake::StridedLayout>(...)",
         "decode_attention"),
        ("void cake::decode_kernel<__nv_bfloat16, 128, 4, cake::PagedLayout>(...)",
         "paged_decode_attention"),
        ("void cake::chunk_kernel<__nv_bfloat16, 128, cake::PagedLayout>(...)",
         "paged_chunk_attention"),
        ("nvjet_tst_128x64_64x8_1x2_h_bz_TNN", "matmul"),
        ("void gemv2T_kernel_val<int, int, __nv_bfloat16>(...)", "matmul"),
        ("void at::native::vectorized_elementwise_kernel<4, ...>(...)", "other"),
        ("void cake::norm_matmul_kernel<__nv_bfloat16, 8, 16>(...)", "fused_norm_matmul"),
        ("void cake::norm_matmul_wgmma_kernel<__nv_bfloat16, 128>(...)", "fused_norm_matmul"),
        ("void cake::norm_rows_kernel<__nv_bfloat16>(...)", "fused_norm_matmul"),
        ("void cake::ingest_kernel<__nv_bfloat16>(...)", "fused_qkv_ingest"),
        ("void cake::tail_kernel<true, true, true>(...)", "fused_sample_tail"),
        ("void cake::int4mm::int4_mma_kernel<__nv_bfloat16, 16, 1, false>(...)", "int4_matmul"),
        ("void cake::int4mm::int4_f32_kernel(...)", "int4_matmul"),
        ("void cake::int4mm::int4_wgmma_kernel<__nv_bfloat16, 128, 128, true>(...)", "int4_matmul"),
        ("void cake::chunk_kernel_tc<__nv_bfloat16, 128, cake::StridedLayout>(...)",
         "chunk_prefill_attention"),
        ("void cake::chunk_kernel_tc<__nv_bfloat16, 128, cake::PagedLayout>(...)",
         "paged_chunk_attention"),
        ("void cake::int4mm::int4_reduce_kernel<__nv_bfloat16>(...)", "int4_matmul"),
        ("void cake::split_decode_kernel<__nv_bfloat16, 128, 4, cake::DenseLayout>(...)",
         "decode_attention"),
        ("void cake::split_decode_kernel<__nv_bfloat16, 128, 4, cake::PagedLayout>(...)",
         "paged_decode_attention"),
        ("void cake::norm_matmul_swap_ab_kernel<__nv_bfloat16, 8, true>(...)",
         "fused_norm_matmul"),
        ("void cake::norm_matmul_ws_kernel<__nv_bfloat16, 256, true>(...)", "fused_norm_matmul"),
        ("void cake::threefry_noise_kernel<0>(...)", "threefry_noise"),
    ],
)
def test_profile_kernel_families(smoke, name, family):
    assert smoke._kernel_family(name) == family


@pytest.mark.parametrize(
    "name,wrapper",
    [
        ("void cake::split_decode_kernel<__nv_bfloat16, 128, 4, cake::DenseLayout>(...)",
         "decode_attention"),
        ("void cake::split_decode_kernel<__nv_bfloat16, 128, 4, cake::PagedLayout>(...)",
         "paged_decode_attention"),
        ("void cake::chunk_kernel_tc<__nv_bfloat16, 128, cake::StridedLayout>(...)",
         "chunk_prefill_attention"),
        ("void cake::chunk_kernel<float, 64, cake::PagedLayout>(...)", "paged_chunk_attention"),
        ("void cake::norm_matmul_swap_ab_kernel<__nv_bfloat16, 8, true>(...)",
         "fused_norm_matmul"),
        ("void cake::norm_matmul_ws_kernel<__nv_bfloat16, 256, true>(...)", "fused_norm_matmul"),
        ("void cake::norm_matmul_kernel<float, 1, 16>(...)", "fused_norm_matmul"),
        ("void cake::norm_rows_kernel<__nv_bfloat16>(...)", None),
        ("void cake::ingest_kernel<__nv_bfloat16, 8, 8>(...)", "fused_qkv_ingest"),
        ("void cake::tail_kernel<true, true, true, true>(...)", "fused_sample_tail"),
        ("void cake::int4mm::int4_mma_kernel<__half>(...)", "int4_matmul"),
        ("void cake::int4mm::int4_wgmma_kernel<__nv_bfloat16, 128, true>(...)", "int4_matmul"),
        ("void cake::int4mm::int4_f32_kernel(...)", "int4_matmul"),
        ("void cake::int4mm::int4_reduce_kernel<__half>(...)", None),
        ("void cake::threefry_noise_kernel<0>(...)", "threefry_noise"),
        ("void cake::empty_kernel()", None),
        ("nvjet_tst_128x64_64x8_1x2_h_bz_TNN", None),
    ],
)
def test_each_wrapper_counts_one_launch_kernel(smoke, name, wrapper):
    """The kernel a trace shows once for each counted launch of a wrapper:
    the body, never its helper kernels (norm rows, the split-K reduce)."""
    assert smoke.launch_of(name) == wrapper


def test_launches_seen_and_ops_diff_read_a_trace(smoke):
    events = [
        {"cat": "kernel", "name": "void cake::ingest_kernel<float, 4, 4>(...)"},
        {"cat": "kernel", "name": "void cake::norm_rows_kernel<float>(...)"},
        {"cat": "kernel", "name": "void cake::norm_matmul_swap_ab_kernel<__half, 8, true>(...)"},
        {"cat": "kernel", "name": "void cake::norm_matmul_swap_ab_kernel<__half, 8, true>(...)"},
        {"cat": "gpu_memcpy", "name": "ingest_kernel"},
    ]
    seen = smoke.launches_seen(events)
    assert set(seen) == set(smoke.KERNEL_WRAPPERS)
    assert seen["fused_qkv_ingest"] == 1 and seen["fused_norm_matmul"] == 2
    assert sum(seen.values()) == 3
    assert smoke.ops_diff({"a": 1, "b": 2}, {"b": 2, "c": 1}) == {"a": [1, 0], "c": [0, 1]}
    assert smoke._minus({"a": 3, "b": 1}, {"b": 2, "c": 1}) == {"a": 3, "b": -1, "c": -1}
    assert smoke._tally([{"name": "k(int)"}, {"name": "k(float)"}, {"name": "m"}], "name") == {
        "k": 2, "m": 1}


def test_an_incomplete_trace_is_taken_again(smoke, monkeypatch, capsys):
    """A trace whose launch kernels fall short of the counters' growth is
    emitted and taken again after the setup; the first complete one is
    returned. A trace with more launches than counted raises at once."""
    from cake_tpu_torch.ops.fused_ingest import fused_qkv_ingest

    kernel = {"cat": "kernel", "name": "void cake::ingest_kernel<__nv_bfloat16, 8, 8>(...)"}
    shown = iter([1, 2])
    setups = []

    def run():
        fused_qkv_ingest.launches += 2

    monkeypatch.setattr(smoke, "_device_events", lambda torch, fn: (
        fn(), ([dict(kernel) for _ in range(next(shown))], -120.0))[1])
    monkeypatch.setattr(fused_qkv_ingest, "launches", 0)
    events, tries, offset = smoke._complete_trace(torch, run, setup=lambda: setups.append(1))
    assert (len(events), tries, len(setups), offset) == (2, 2, 2, -120.0)
    (row,) = [smoke.json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert row["phase"] == "trace_incomplete" and row["launch_kernels"]["fused_qkv_ingest"] == 1
    expect = dict.fromkeys(smoke.KERNEL_WRAPPERS, 0)
    monkeypatch.setattr(smoke, "_device_events", lambda torch, fn: ([dict(kernel)], 0.0))
    with pytest.raises(AssertionError, match="did not see"):
        smoke._complete_trace(torch, lambda: None, expect=expect)
    monkeypatch.setattr(smoke, "_device_events", lambda torch, fn: (None, None))
    with pytest.raises(AssertionError, match="no complete trace"):
        smoke._complete_trace(torch, lambda: None, expect=expect)
    # A wave split over two epochs is taken again.
    waves = iter([{"batches": 2, "joins": 0}, {"batches": 1, "joins": 0}])
    monkeypatch.setattr(smoke, "_device_events", lambda torch, fn: (fn(), ([], 0.0))[1])
    _, tries, _ = smoke._complete_trace(torch, lambda: next(waves), expect=expect,
                                        valid=smoke._one_epoch)
    assert tries == 2


def _run(script: Path, cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, capture_output=True, text=True, timeout=120
    )


@pytest.mark.parametrize(
    "names,route",
    [
        (["void cake::int4mm::int4_wgmma_kernel<__nv_bfloat16, 128, true>(...)"], "wgmma"),
        (["void cake::int4mm::int4_mma_kernel<__half>(...)",
          "void cake::int4mm::int4_reduce_kernel<__half>(...)"], "mma.sync"),
        (["void cake::int4mm::int4_f32_kernel(...)"], "CUDA cores"),
        (["void cake::chunk_kernel_tc<__nv_bfloat16, 128, cake::PagedLayout>(...)"], "mma.sync"),
        (["void cake::chunk_kernel<float, 64, cake::StridedLayout>(...)"], "CUDA cores"),
        (["void cake::int4mm::int4_wgmma_kernel<__half, 8, false>(...)",
          "void cake::int4mm::int4_mma_kernel<__half>(...)"], "mma.sync+wgmma"),
        (["void cake::decode_kernel<__nv_bfloat16, 128>(...)", "nvjet_tst_128x256"], None),
        (["void cake::split_decode_kernel<__nv_bfloat16, 128, 4, cake::PagedLayout>(...)"],
         "CUDA cores"),
        (["void cake::norm_rows_kernel<__half>(...)",
          "void cake::norm_matmul_swap_ab_kernel<__half, 32, false>(...)"], "wgmma"),
        (["void cake::norm_rows_kernel<__nv_bfloat16>(...)",
          "void cake::norm_matmul_ws_kernel<__nv_bfloat16, 128, false>(...)"], "wgmma"),
        (["void cake::norm_matmul_kernel<__nv_bfloat16, 1, 16>(...)"], "CUDA cores"),
    ],
)
def test_route_is_read_from_the_traced_kernel_names(smoke, names, route):
    assert smoke.kernel_route(names) == route


def test_norm_matmul_bits_gate_rehearses_on_the_cpu(smoke, capsys):
    """The row-independence gate at a small width: every body plan()
    picks at NORM_BITS_ROWS rows is checked (on the CPU each is the plain
    version, so they agree), and the row is emitted."""
    row = smoke.norm_matmul_bits(torch, torch.device("cpu"), sites=(("w", 256, 384),))
    bodies = {smoke.json.loads(line)["case"] for line in capsys.readouterr().out.splitlines()}
    assert bodies == {"bits"}
    assert all(row["equal"].values())
    assert {k.rsplit("_row", 1)[0] for k in row["equal"]} == {
        "w_rows1_swap_ab", "w_rows8_swap_ab", "w_rows16_swap_ab", "w_rows64_swap_ab",
        "w_rows256_warp_specialized"}


def test_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = _run(REPO / "chip_smoke.py", REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_refuses_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
