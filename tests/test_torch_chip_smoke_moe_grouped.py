"""chip_smoke.py's grouped expert GEMM additions, rehearsed on the CPU at a
tiny size: the Qwen3-30B-A3B cases, the straddling row-independence
layouts, and phase moe's prefill A/B (the kernel against its plain version
patched in). On the CPU both sides of every comparison are the plain
version, so this checks the control flow, the routing layout and the rows'
fields; the card runs them at full width.
"""

import pytest
import torch

import _chip_smoke_rehearsal as R
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.config import LlamaConfig

TINY_QWEN3 = {"hidden": 64, "inter": 32, "experts": 16, "top_k": 4}


@pytest.fixture(scope="module")
def smoke():
    return R.load_smoke()


@pytest.fixture
def no_card(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "cuda_ms", lambda torch, fn, iters, warmup=2: (fn(), 0.5)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)


def test_qwen3_routing_leaves_experts_a_handful_of_rows_or_none(smoke):
    sizes = smoke.qwen3_moe_sizes(torch)
    assert len(sizes) == smoke.QWEN3_MOE["experts"] == 128
    assert sum(sizes) == smoke.QWEN3_TOKENS * smoke.QWEN3_MOE["top_k"] == 4096
    assert 0 in sizes and sum(1 for n in sizes if 0 < n <= 16) >= 32
    assert sizes == smoke.qwen3_moe_sizes(torch)  # seeded


def test_qwen3_grouped_cases_rehearse_on_the_cpu(smoke, no_card, capsys):
    cases = smoke.moe_grouped_qwen3_cases(torch, torch.device("cpu"), TINY_QWEN3)
    assert {c for _, c in cases} == {"qwen3_30b_a3b_w_gate", "qwen3_30b_a3b_w_gate_int8",
                                     "qwen3_30b_a3b_w_down", "qwen3_30b_a3b_w_down_int8"}
    gate = cases[("grouped_matmul", "qwen3_30b_a3b_w_gate")]
    assert gate["max_abs_err"] == 0.0 and gate["rows"] == smoke.QWEN3_TOKENS * 4
    assert gate["flops"] == 2.0 * gate["rows"] * 64 * 32
    assert gate["plan"]["body"] == "warp_specialized"
    assert cases[("grouped_matmul", "qwen3_30b_a3b_w_down_int8")]["plan"]["body"] == "swap_ab"
    assert R.phases(capsys.readouterr().out) == ["kernels"] * 4


def test_row_independence_probes_straddle_the_tiles(smoke, no_card, capsys):
    config = LlamaConfig.tiny(model_type="mixtral", hidden_size=128, intermediate_size=192,
                              num_local_experts=4, num_experts_per_tok=2)
    cases = smoke.moe_grouped_cases(torch, torch.device("cpu"), [40, 0, 25, 7], config)
    row = cases[("grouped_matmul", "mixtral_w_gate_row_independence")]
    assert all(row["equal"].values())
    # probes across a warpgroup's 64 rows, a block's 128, an item's 256 and 384
    for a, b in ((3, 60), (0, 124), (97, 253), (1, 381)):
        assert any(k.startswith(f"e0_{a}_before_{b}_") for k in row["equal"])
    capsys.readouterr()


def test_moe_prefill_ab_rehearses_on_the_cpu(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "ENGINE_MAX_SEQ", 1024)
    config = LlamaConfig.tiny(model_type="mixtral", num_hidden_layers=2, hidden_size=128,
                              intermediate_size=192, vocab_size=512, num_attention_heads=4,
                              num_key_value_heads=2, num_local_experts=4, num_experts_per_tok=2,
                              bos_token_id=256, eos_token_ids=(259, 260),
                              max_position_embeddings=8192)
    params = M.init_params(config, torch.Generator().manual_seed(1), torch.bfloat16)
    path = smoke._model_path(torch, config, params, "cpu", "hi", torch.device("cpu"))
    ab = smoke._moe_prefill_ab(torch, path)
    assert len(ab["kernel"]) == len(ab["plain"]) == 2
    for r in ab["kernel"] + ab["plain"]:
        assert r["prefill_s"] > 0 and r["ttft_p50_s"] > 0
        assert r["batches"] == 1 and r["prefix_hits"] == 0  # one cold group each
        assert r["grouped_dispatches"] == config.num_hidden_layers
        # on the CPU the kernel's wrapper takes its plain version too
        assert r["plain_launches"] == 3 * r["grouped_dispatches"] and r["grouped_launches"] == 0
        assert sum(r["rows_per_expert_layer0"]) > 0
    assert ab["streams_equal"] == [smoke.ENGINE_BATCH] * 4
