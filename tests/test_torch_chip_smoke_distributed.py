"""``chip_smoke.py``'s phase ``distributed`` rehearsed on the CPU at a tiny
size (2 layers): topology A (the master runs layer 0, w1 layer 1), B (w1
layer 0, w2 and its replica w2b layer 1), the recovery and the TCP engine
against the dense local engine, under every gate of the card run. A file of
its own, beside tests/test_torch_chip_smoke.py, so that a parallel run of
the suite schedules it apart from the long rehearsal there."""

import importlib.util
from pathlib import Path

import pytest
import torch

from cake_tpu_torch.models.llama.config import LlamaConfig

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_distributed_phase_rehearses_on_the_cpu(smoke):
    """Phase ``distributed`` at a tiny size: topology A (master 0, w1 1),
    B (w1 0, w2 and its replica w2b 1), the recovery and the TCP engine
    against the dense local engine, every gate of the card run."""
    config = LlamaConfig.tiny(num_hidden_layers=2)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        main_path = smoke.phase_generate(torch, "cpu", dev=torch.device("cpu"), config=config)
        row = smoke.phase_distributed(torch, main_path)
    finally:
        torch.set_num_threads(n)
    assert row["A"]["equal_tokens"] == smoke.DECODE_TOKENS
    assert row["A"]["first_decode_logits_bitwise"]
    assert row["A"]["round_trips_per_token"] == 1  # one span a token
    assert row["A"]["launches"] == main_path["launches"]
    assert row["A"]["launches"]["decode_attention_plain"] == 2 * (smoke.DECODE_TOKENS - 1)
    assert row["B"]["master_layers"] == 0 and row["B"]["equal_streams"]
    assert row["recovery"]["replays"] == 1
    assert row["engine"]["equal_streams"] == [smoke.ENGINE_BATCH] * 2
    assert row["engine"]["launches_equal"] and row["engine"]["node"] == "w1"
    assert row["engine"]["round_trips_per_step"] == 1
    assert row["engine"]["wire_by_kind"]["prefill"][0] == 2  # one a wave
    assert row["launches"]["threefry_noise"] == 0  # on the CPU the plain twin draws
