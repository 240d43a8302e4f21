"""RMSNorm (port of ``cake_tpu/ops/norm.py``): reduced in f32, cast back."""

from __future__ import annotations

import torch


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float, offset: bool = False
) -> torch.Tensor:
    """y = x / rms(x) * weight over the last axis, in f32.

    ``offset``: the weight is stored zero-centered and applied as (1 + w),
    the Gemma-family convention."""
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if offset:
        w = 1.0 + w
    return (y * w).to(dtype)
