"""chip_smoke.py's ``moe`` and ``phi3`` phases and its new kernel cases,
rehearsed on the CPU at a tiny size.

On the card the phases run Mixtral-8x7B's widths at 8 layers and
Phi-3-mini-4k at full size; here a tiny Mixtral (4 experts, top-2) and a
tiny Phi-3 (head dim 96 through every attention call, a window the prompt
passes) on CPU tensors, so every attention call takes the plain version:
this checks the control flow, the launch-count gates of the generator
(per step and in chunks), of both engines and of ``--quantize int4``
(expert stacks int8), the fused-tensor checkpoint round trip, and the
kernels line's shape rows.
"""

import importlib.util
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


@pytest.fixture(scope="module")
def main_path(smoke):
    # The generate phase's row, as the model phases read it: its device and card.
    config = LlamaConfig.tiny(num_hidden_layers=1)
    from cake_tpu_torch.models.llama import model as M

    params = M.init_params(config, torch.Generator().manual_seed(0), torch.bfloat16)
    path = smoke._model_path(torch, config, params, "cpu", "hi", torch.device("cpu"))
    return {**path, "card": "cpu", "phase": "generate"}


def test_moe_phase_rehearses_on_the_cpu(smoke, main_path, monkeypatch, capsys):
    monkeypatch.setattr(smoke, "DECODE_TOKENS", 20)
    monkeypatch.setattr(smoke, "ENGINE_TOKENS", 12)
    config = smoke.mixtral_config(2)
    config = LlamaConfig.tiny(**{**config.__dict__, "hidden_size": 128, "intermediate_size": 192,
                                 "vocab_size": 512, "num_attention_heads": 4,
                                 "num_key_value_heads": 2, "num_local_experts": 4,
                                 "bos_token_id": 256, "eos_token_ids": (259, 260),
                                 "max_position_embeddings": 8192})
    row = smoke.phase_moe(torch, main_path, config=config)
    per_step, chunked = row["runs"]
    for r in row["runs"]:
        assert r["launches"] == r["expected_launches"]
        assert r["launches"]["decode_attention_plain"] > 0
    assert chunked["chunks"] > 0 and per_step["chunks"] == 0
    # The 700-token prompt in 256-token chunks took the grouped dispatch:
    # every row (the last chunk's pads too) routed to two experts a layer.
    chunks = -(-row["prompt_tokens"] // 256)
    assert row["prompt_tokens"] == smoke.PROMPT_TOKENS
    assert per_step["grouped_dispatches"] == 2 * chunks
    assert sum(per_step["rows_per_expert_layer0"]) == 2 * 256 * chunks
    assert row["check"]["max_abs_err"] == 0.0  # on the CPU both runs are the plain path
    assert [(r["spec"], r["kv_mode"]) for r in row["engine_runs"]] == [
        ("none", "paged"), ("all", "paged"), ("none", "dense")]
    assert row["paged_equal_dense"] == smoke.ENGINE_BATCH
    assert row["all_equal_none"] == smoke.ENGINE_BATCH  # all plain versions here
    assert row["int4"]["experts_int8"]
    int4 = row["int4"]
    assert int4["launches"] == int4["expected_launches"]
    # 2 int4 products a layer (wqkv, wo) and the head, per forward.
    assert int4["launches"]["int4_matmul_plain"] > 0
    assert int4["launches"]["int4_matmul_plain"] % (2 * 2 + 1) == 0
    phases = [line for line in capsys.readouterr().out.splitlines() if '"phase"' in line]
    assert any('"phase": "moe_model_check"' in p for p in phases)
    assert row["launches"]["paged_decode_attention_plain"] > 0
    # The warm prefix waves equal the cold ones (gated), and the grouped
    # dispatch's products took the grouped GEMM's plain version, three a
    # dispatch, in every run.
    assert row["warm_equal_cold"] == {"none": smoke.ENGINE_BATCH, "all": smoke.ENGINE_BATCH}
    assert all(row["warm_prefix_hits"].values())
    assert per_step["launches"]["grouped_matmul_plain"] == 3 * per_step["grouped_dispatches"]
    assert all(r["launches"]["grouped_matmul_plain"] == 3 * r["grouped_dispatches"] > 0
               for r in row["engine_runs"])
    assert sum(row["group_sizes"]) > 0 and len(row["group_sizes"]) == 4
    # The grouped GEMM's kernel cases at that group (plain versions here).
    monkeypatch.setattr(smoke, "cuda_ms", lambda torch, fn, iters, warmup=2: (fn(), 0.5)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    cases = smoke.moe_grouped_cases(torch, torch.device("cpu"), row["group_sizes"], config)
    assert {c for _, c in cases} == {"mixtral_w_gate", "mixtral_w_gate_int8", "mixtral_w_down",
                                     "mixtral_w_down_int8", "mixtral_w_gate_row_independence",
                                     "mixtral_w_down_row_independence"}
    gate = cases[("grouped_matmul", "mixtral_w_gate")]
    assert gate["max_abs_err"] == 0.0 and gate["rows"] == sum(row["group_sizes"])
    assert gate["flops"] == 2.0 * gate["rows"] * 128 * 192


def test_phi3_phase_rehearses_on_the_cpu(smoke, main_path, monkeypatch, capsys):
    monkeypatch.setattr(smoke, "DECODE_TOKENS", 20)
    monkeypatch.setattr(smoke, "ENGINE_TOKENS", 12)
    monkeypatch.setattr(smoke, "PHI3_MAX_SEQ", 1024)
    monkeypatch.setattr(smoke, "PREFILL_CHUNK", 64)
    config = smoke.phi3_config(3)
    n_q, n_kv, hd = smoke.PHI3_HEADS
    assert (config.num_attention_heads, config.num_key_value_heads, config.head_dim) == (
        n_q, n_kv, hd)
    config = LlamaConfig.tiny(**{**config.__dict__, "hidden_size": 2 * hd,
                                 "num_attention_heads": 2, "num_key_value_heads": 2,
                                 "intermediate_size": 256, "vocab_size": 512,
                                 "bos_token_id": 256, "eos_token_ids": (259, 260),
                                 "sliding_window": 100})
    assert config.head_dim == 96
    row = smoke.phase_phi3(torch, main_path, config=config, ckpt_layers=2, prompt_tokens=300)
    assert all(row["loader"]["equal"].values()) and "wqkv" in row["loader"]["keys"]
    assert row["prompt_tokens"] == 300
    for r in row["runs"]:
        assert r["launches"] == r["expected_launches"]
    assert row["check"]["max_abs_err"] == 0.0
    assert [r["spec"] for r in row["engine_runs"]] == ["none", "ingest,tail", "all", "none"]
    assert row["ingest_tail_equal_none"] == smoke.ENGINE_BATCH
    assert row["engine_runs"][1]["launches"]["fused_qkv_ingest_plain"] > 0
    # The rolling pass at head dim 96: ring ≡ full cache, per step and in chunks.
    assert row["rolling"]["equal"] and row["rolling"]["ring_slots"] == 256
    assert row["rolling"]["equal_tokens"] == [20, 20]


def test_kernels_line_carries_the_shape_rows(smoke):
    timed = {"max_abs_err": 0.0, "ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5,
             "bound_by": "bytes", "library_ms": 0.7}
    rows = {("decode_attention", c): timed for c in ("phi3_generator", "phi3_generator_f8",
                                                     "qwen3_235b_g16", "g12", "g32", "lengths")}
    paths = ({"phase": "moe", "launches": {"decode_attention": 5}},
             {"phase": "phi3", "launches": {"decode_attention": 7, "decode_attention.f8": 0}})
    shapes = {r["case"]: r for r in smoke._shape_rows(rows, "decode_attention", paths)}
    assert set(shapes) == {"phi3_generator", "phi3_generator_f8", "qwen3_235b_g16", "g12", "g32"}
    assert shapes["phi3_generator"]["launches"] == 7
    assert shapes["phi3_generator_f8"]["launches"] == 0
    assert shapes["g32"]["launches"] is None
    assert shapes["g12"]["bound_ms"] == 0.5 and shapes["g12"]["library_ms"] == 0.7


def test_shape_cases_rehearse_on_the_cpu(smoke, monkeypatch, capsys):
    """The new shapes' kernel cases on small caches on the CPU (the timings,
    which need the card, stubbed): each holds the call to its plain version
    (here the same function) and counts its bytes from its own heads."""
    monkeypatch.setattr(smoke, "cuda_ms", lambda torch, fn, iters, warmup=2: (fn(), 0.5)[1])
    monkeypatch.setattr(smoke, "traced_route", lambda torch, run: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    dev, g = torch.device("cpu"), torch.Generator().manual_seed(0)
    heads = (8, 2, 96)
    row = smoke._decode_case(torch, dev, g, "phi3", [5, 200], None, {"window": 64},
                             max_seq=256, heads=heads)
    assert row["max_abs_err"] == 0.0
    live = 5 + 64
    assert row["bytes"] == 2 * 2 * 8 * 96 * 2 + live * 2 * 96 * 2 * 2
    row = smoke._chunk_case(torch, dev, g, "phi3", 16, [0, 100], None, {}, max_seq=256,
                            heads=heads)
    assert row["flops"] > 0 and row["max_abs_err"] == 0.0
    for kv in (None, torch.float8_e4m3fn):
        row = smoke._ingest_case(torch, dev, g, "phi3", 8, 300, paged=True, kv=kv, heads=heads)
        assert row["equal"]
    row = smoke._paged_decode_case(torch, dev, g, 1, "g16", [5, 200], [0, 3], 2,
                                   heads=(32, 2, 64))
    assert row["max_abs_err"] == 0.0
    capsys.readouterr()
