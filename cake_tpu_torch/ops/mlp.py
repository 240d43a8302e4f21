"""Gated feed-forward (port of ``cake_tpu/ops/mlp.py``):
``down(act(gate(x)) * up(x))`` with SiLU (SwiGLU) or tanh-GELU (GeGLU).
Weights are [in, out], plain or quantized, applied as ``qmat(x, w)``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cake_tpu_torch.ops.quant import qmat


def _act(g: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "silu":
        return F.silu(g)
    if activation == "gelu_tanh":
        return F.gelu(g, approximate="tanh")
    raise ValueError(f"unknown MLP activation {activation!r}")


def swiglu(x, w_gate, w_up, w_down, activation: str = "silu") -> torch.Tensor:
    return qmat(_act(qmat(x, w_gate), activation) * qmat(x, w_up), w_down)


def swiglu_gu(x, w_gu, w_down, activation: str = "silu") -> torch.Tensor:
    """SwiGLU over the fused gate|up projection [hidden, 2*inter] (ops/fuse.py)."""
    return swiglu_gu_from(qmat(x, w_gu), w_down, activation)


def swiglu_gu_from(gu, w_down, activation: str = "silu") -> torch.Tensor:
    """The tail of ``swiglu_gu`` after the gate|up projection."""
    gate, up = gu.chunk(2, dim=-1)
    return qmat(_act(gate, activation) * up, w_down)
