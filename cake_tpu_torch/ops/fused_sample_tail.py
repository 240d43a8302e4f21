"""Fused sampling tail: repeat penalty + temperature + top-k + the draw.

Replaces the Pallas TPU kernel ``cake_tpu/ops/pallas/fused_sample_tail.py``
(``fused_sample_tail``) with a CUDA kernel written for Hopper,
``ops/csrc/fused_sample_tail.cu``. Each decode step of the batch engine and
of the generator's ``decode_chunk`` samples its next ids through it.

Arithmetic, in the order of the plain composition (``ops/sampling.py``):
``apply_repeat_penalty``'s select over the ring; the division by the
temperature; the top-k threshold, the k-th largest value counting
duplicates (``torch.topk(...).values[..., -1]``) with the strict ``<``
mask; the argmax of ``scaled + noise``. The noise (gumbel rows) is an
operand: the caller draws it exactly as the unfused path does, so the two
walk one random stream. Greedy takes no noise and argmaxes the penalized
logits.

What bounds it on the H100: the bytes of the logits, ``b * V * 4`` (twice
that with noise): 1.2 us greedy at b=8 over Llama-3's 128256 ids. The
unfused tail is a dozen ops, each a full pass over ``[b, V]`` plus a sort
for the top-k.

What the design does about it: one block of 1024 threads per row. The ring
becomes a V-bit bitmap in shared memory (16 KB at V = 128256; a token twice
in the ring is penalized once, the plain select's set semantics). The top-k
threshold is a radix select over the order-preserving uint32 key of each
scaled value: four passes of 8 bits with per-warp shared histograms, exact
with duplicates; the row does not fit in shared memory, so each pass
re-reads it (from the L2 after the first) and recomputes the scaled value.
The last pass masks, adds the noise and argmaxes: lowest index among equal
maxima, NaN as the maximum, a fully ``-inf`` row giving 0, as
``torch.argmax``. The divisions repeat torch's CUDA arithmetic for a tensor
divided by a Python scalar (a product with the scalar's f32 reciprocal), so
the ids equal the plain composition's on the card. With b rows the grid is
b blocks: far from filling 132 SMs, so the kernel is bound by one SM's load
rate, not the card's.

``top_p`` keeps the plain composition (the nucleus needs a full sort), as
the JAX package keeps its sort twin: such calls are counted in
``fused_sample_tail.unfused`` and logged once per process.

For tensors on the CPU the wrapper runs :func:`fused_sample_tail_plain`;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import logging

import numpy as np
import torch

from cake_tpu_torch.ops import _build
from cake_tpu_torch.ops.sampling import _filter, apply_repeat_penalty

log = logging.getLogger("cake_tpu_torch.fused_sample_tail")
_top_p_noted = False


def scalar_reciprocal(x: float) -> float:
    """The f32 factor torch's CUDA kernels multiply by for ``t / x`` (a
    float tensor over a Python scalar): the reciprocal taken in double,
    rounded once to f32."""
    return float(np.float32(1.0 / float(x)))


def _composition(logits, ring, noise, temperature, top_k, top_p, repeat_penalty):
    pen = apply_repeat_penalty(logits, repeat_penalty, ring)
    if temperature is None or temperature <= 0.0:
        return torch.argmax(pen, dim=-1)
    return torch.argmax(_filter(pen, temperature, top_k, top_p) + noise, dim=-1)


def fused_sample_tail_plain(logits, ring, noise, *, temperature, top_k, top_p, repeat_penalty):
    """Plain PyTorch version: ``apply_repeat_penalty``, ``_filter`` and the
    argmax of ``scaled + noise`` (of the penalized logits when greedy)."""
    fused_sample_tail_plain.launches += 1
    return _composition(logits, ring, noise, temperature, top_k, top_p, repeat_penalty)


fused_sample_tail_plain.launches = 0


def fused_sample_tail(logits, ring, noise, *, temperature, top_k, top_p, repeat_penalty):
    """Next ids [b] int64 from one decode step's logits.

    Args:
      logits: [b, V] f32.
      ring: [b, W] int64 recent ids, -1 = empty.
      noise: [b, V] f32 gumbel rows, or None when greedy (temperature <= 0).
      temperature/top_k/top_p/repeat_penalty: host scalars."""
    global _top_p_noted
    greedy = temperature is None or temperature <= 0.0
    if top_p is not None and not greedy:
        fused_sample_tail.unfused += 1
        if not _top_p_noted:
            _top_p_noted = True
            log.warning(
                "fused_sample_tail: top_p needs a full sort; it keeps the plain composition "
                "(counted in fused_sample_tail.unfused)"
            )
        return _composition(logits, ring, noise, temperature, top_k, top_p, repeat_penalty)
    if logits.device.type == "cpu":
        return fused_sample_tail_plain(
            logits, ring, noise, temperature=temperature, top_k=top_k, top_p=top_p,
            repeat_penalty=repeat_penalty,
        )
    if logits.device.type != "cuda":
        raise ValueError(f"fused_sample_tail: unsupported device {logits.device}")
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError(f"fused_sample_tail: logits must be [b, V] f32, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    b, vocab = logits.shape
    if ring.dim() != 2 or ring.shape[0] != b or ring.dtype != torch.int64:
        raise ValueError(f"fused_sample_tail: ring must be [b, W] int64, got "
                         f"{tuple(ring.shape)} {ring.dtype}")
    if not greedy and (noise is None or noise.shape != logits.shape
                       or noise.dtype != torch.float32):
        raise ValueError("fused_sample_tail: a sampled step needs [b, V] f32 noise")
    k = 0 if greedy or top_k is None else int(top_k)
    if not greedy and top_k is not None and not 1 <= k <= vocab:
        raise ValueError(f"fused_sample_tail: top_k {top_k} outside [1, {vocab}]")
    tensors = [("logits", logits), ("ring", ring)] + ([] if greedy else [("noise", noise)])
    for name, t in tensors:
        if t.device != logits.device or not t.is_contiguous():
            raise ValueError(f"fused_sample_tail: {name} must be contiguous on {logits.device}")
    out = torch.empty((b,), dtype=torch.int64, device=logits.device)
    if b == 0:
        return out
    window = ring.shape[1]
    err = _build.library().cake_fused_sample_tail(
        logits.data_ptr(), ring.data_ptr() if window else None,
        None if greedy else noise.data_ptr(), out.data_ptr(),
        b, vocab, window, int(repeat_penalty != 1.0 and window > 0),
        float(repeat_penalty), scalar_reciprocal(repeat_penalty),
        1.0 if greedy else scalar_reciprocal(temperature), k,
        ctypes.c_void_p(torch.cuda.current_stream(logits.device).cuda_stream),
    )
    _build.check(err, "fused_sample_tail")
    fused_sample_tail.launches += 1
    return out


fused_sample_tail.launches = 0
fused_sample_tail.unfused = 0
