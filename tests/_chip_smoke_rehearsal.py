"""Shared by the CPU rehearsals of chip_smoke.py's phases
(tests/test_torch_chip_smoke_*.py): the script loaded as a module, and the
generate phase's row at the tiny size, which every later phase reads (its
generator, weights, prompt and card)."""

import importlib.util
import json
from pathlib import Path

import torch

from cake_tpu_torch.models.llama.config import LlamaConfig

REPO = Path(__file__).resolve().parent.parent


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def generate_row(smoke) -> dict:
    """phase_generate at a 2-layer tiny config on the CPU, gated as the
    generate rehearsal gates it."""
    config = LlamaConfig.tiny(num_hidden_layers=2)
    row = smoke.phase_generate(torch, "cpu", dev=torch.device("cpu"), config=config)
    assert row["launches"] == row["expected_launches"]
    return row


def phases(out: str) -> list[str]:
    """The phase names of the result lines a phase printed."""
    return [json.loads(line)["phase"] for line in out.splitlines()]
