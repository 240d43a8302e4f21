"""``chip_smoke.py``'s phase ``rolling``, the ring kernel cases' helpers and
the ring entries of the kernels line, rehearsed on the CPU at a tiny size.

On the card the phase runs Mistral-7B-v0.1 at full width and depth over a
4608-slot ring against an 8192-slot cache; here a tiny Mistral (window 100,
64-token chunks: a 256-slot ring against 1024) over a 600-token prompt, so
the ring wraps during the prefill as it does there, and every attention
call takes the ring's plain versions: this checks the control flow, the
launch gates (decode and continuation calls on ``decode_ring_plain`` /
``chunk_ring_plain``), ring ≡ full cache in ids and first-decode-step
logits per step and in chunks, and the f8 pass. The phi3 phase's rolling
pass rehearses in tests/test_torch_chip_smoke_moe.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _chip_smoke_rehearsal as R
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)
from cake_tpu_torch.models.llama import cache as PC
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.config import LlamaConfig


@pytest.fixture(scope="module")
def smoke():
    return R.load_smoke()


@pytest.fixture(scope="module")
def main_path(smoke):
    config = LlamaConfig.tiny(num_hidden_layers=1)
    params = M.init_params(config, torch.Generator().manual_seed(0), torch.bfloat16)
    path = smoke._model_path(torch, config, params, "cpu", "hi", torch.device("cpu"))
    return {**path, "card": "cpu", "phase": "generate"}


def tiny_mistral(smoke):
    config = smoke.mistral_config(2)
    assert (config.hidden_size, config.intermediate_size, config.num_hidden_layers,
            config.num_attention_heads, config.num_key_value_heads, config.head_dim,
            config.vocab_size, config.sliding_window, config.max_position_embeddings,
            config.rope_theta, config.rms_norm_eps, config.bos_token_id,
            config.eos_token_ids) == (4096, 14336, 2, 32, 8, 128, 32000, 4096, 32768, 1e4,
                                      1e-5, 1, (2,))
    return LlamaConfig.tiny(**{**config.__dict__, "hidden_size": 128, "intermediate_size": 192,
                               "num_attention_heads": 4, "num_key_value_heads": 2,
                               "vocab_size": 512, "bos_token_id": 256,
                               "eos_token_ids": (259, 260), "sliding_window": 100})


def test_rolling_phase_rehearses_on_the_cpu(smoke, main_path, monkeypatch, capsys):
    monkeypatch.setattr(smoke, "DECODE_TOKENS", 20)
    monkeypatch.setattr(smoke, "ROLL_CHUNK", 64)
    monkeypatch.setattr(smoke, "ROLL_F8_TOKENS", 6)
    row = smoke.phase_rolling(torch, main_path, config=tiny_mistral(smoke), prompt_tokens=600,
                              max_seq=1024)
    assert all(row["gates"].values())
    for key in ("per_step", "graph_chunks", "f8_per_step"):
        runs = row["runs"][key]
        assert runs["logits_bitwise"]
        assert runs["rolling"]["cache_slots"] == 256 and runs["full"]["cache_slots"] == 1024
        assert runs["rolling"]["kv_bytes"] * 4 == runs["full"]["kv_bytes"]
        for name in ("rolling", "full"):
            r = runs[name]
            assert r["launches"] == r["expected_launches"]
        rolling, full = runs["rolling"]["launches"], runs["full"]["launches"]
        assert rolling["decode_ring_plain"] > 0 and rolling["decode_attention_plain"] == 0
        assert rolling["chunk_ring_plain"] > 0 and rolling["chunk_prefill_attention_plain"] == 0
        assert full["decode_ring_plain"] == 0 and full["decode_attention_plain"] > 0
    assert row["runs"]["per_step"]["equal_tokens"] == 20
    assert row["runs"]["graph_chunks"]["rolling"]["decode_chunk"] == smoke.FUSED_CHUNK
    assert row["prompt_tokens"] == 600
    # Off the card no ring kernel launches: the kernels line's counts are 0.
    assert row["launches"] == dict.fromkeys(
        ["decode_attention_ring", "chunk_prefill_attention_ring", "decode_attention_ring_f8",
         "chunk_prefill_attention_ring_f8"], 0)
    assert R.phases(capsys.readouterr().out) == ["rolling"]


@pytest.mark.parametrize("newest", [[5], [300], [1031, 200]])
def test_ring_of_is_the_rolling_write(smoke, newest):
    """The kernel cases build their ring from a full cache (``_ring_of``):
    the ring write_layer_rolling leaves after writing positions 0..newest
    one token at a time, bf16 and f8."""
    b, n_kv, hd, ring, limit = len(newest), 2, 16, 128, 1152
    g = torch.Generator().manual_seed(sum(newest))
    for dtype in (torch.bfloat16, torch.float8_e4m3fn):
        full_bf = torch.randn(b, n_kv, limit, hd, generator=g).to(torch.bfloat16)
        full = full_bf.to(dtype)
        got = smoke._ring_of(torch, full, ring, torch.tensor(newest))
        for r, p_max in enumerate(newest):
            want = torch.zeros(1, n_kv, ring, hd).to(dtype)
            other = torch.zeros_like(want)
            for p in range(p_max + 1):
                row = full_bf[r : r + 1, :, p : p + 1].transpose(1, 2)
                PC.write_layer_rolling(want, other, row, row, p, 1)
            written = min(p_max + 1, ring)
            slots = [p % ring for p in range(p_max + 1 - written, p_max + 1)]
            assert torch.equal(got[r : r + 1, :, slots].view(torch.uint8),
                               want[:, :, slots].view(torch.uint8))


def test_kernels_line_carries_the_ring_entries(smoke):
    timed = {"max_abs_err": 0.001, "ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5,
             "bound_by": "bytes", "library_ms": 0.7, "dense_bitwise": True,
             "library": "scaled_dot_product_attention over the gathered window"}
    rows = {("decode_attention", "main_path"): timed,
            ("chunk_prefill_attention", "main_path"): timed}
    for kernel in ("decode_attention_ring", "chunk_prefill_attention_ring"):
        for case in ("mistral", "mistral_f8", "phi3_hd96"):
            rows[(kernel, case)] = dict(timed, max_abs_err=0.002 if case == "phi3_hd96" else 0.001)
    rolling = {"launches": {"decode_attention_ring": 640, "chunk_prefill_attention_ring": 384,
                            "decode_attention_ring_f8": 512, "chunk_prefill_attention_ring_f8": 352}}
    phi3 = {"phase": "phi3", "launches": {"decode_attention_ring": 7,
                                          "chunk_prefill_attention_ring": 3}}
    spec_names = smoke.kernel_summary.__code__.co_consts  # the line reads only what it is given
    assert spec_names
    row = {"launches": {"decode_attention": 1, "chunk_prefill_attention": 1}}
    engine = {"launches": {"paged_decode_attention": 1, "paged_chunk_attention": 1}}
    rows.update({(n, "main_path"): timed for n in ("paged_decode_attention",
                                                   "paged_chunk_attention")})
    rows.update({(n, c): timed for n, c in smoke.FUSED_MAIN.items()})
    rows[("int4_matmul", smoke.INT4_MAIN)] = timed
    rows[("launch_floor", "empty_kernel")] = {"ms": 0.25}
    f8_names = ["decode_attention", "chunk_prefill_attention", "paged_decode_attention",
                "paged_chunk_attention"]
    rows.update({(n, "main_path_f8"): timed for n in f8_names})
    rows[("fused_qkv_ingest", "paged_b8_f8")] = timed
    rows[("threefry_noise", "per_row_b8")] = dict(timed, gumbel_bitwise=True)
    summary = smoke.kernel_summary(
        rows, row, engine, ({"fused_launches": dict.fromkeys(smoke.FUSED_MAIN, 1)},),
        ({"int4_launches": 1},), ({"f8_launches": dict.fromkeys(f8_names + ["fused_qkv_ingest"],
                                                                1)},),
        model_paths=(phi3,), rolling_path=rolling)
    by_name = {k["name"]: k for k in summary["kernels"]}
    ring = {n: by_name[n] for n in ("decode_attention_ring", "decode_attention_ring_f8",
                                    "chunk_prefill_attention_ring",
                                    "chunk_prefill_attention_ring_f8")}
    assert by_name["decode_attention_ring"]["launches"] == 640 + 7
    assert by_name["chunk_prefill_attention_ring"]["launches"] == 384 + 3
    assert by_name["decode_attention_ring_f8"]["launches"] == 512
    assert by_name["chunk_prefill_attention_ring_f8"]["launches"] == 352
    for name, k in ring.items():
        assert k["route"] == "cuda" and k["dense_bitwise"] is True
        assert k["replaces"] == by_name[name.split("_ring")[0]]["replaces"]
        assert k["source"].startswith("cake_tpu_torch/ops/csrc/ring_")
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
            assert key in k
    assert by_name["decode_attention_ring"]["max_abs_err"] == 0.002  # the hd96 case counts
    shapes = {s["case"]: s for s in by_name["decode_attention_ring"]["shapes"]}
    assert shapes["phi3_hd96"]["launches"] == 7
    assert by_name["decode_attention_ring_f8"]["kv_dtype"] == "f8"
