"""RMSNorm folded into the projection it feeds: ``rms_norm(x, w_norm) @ W``.

Replaces the Pallas TPU kernel ``cake_tpu/ops/pallas/fused_norm_matmul.py``
(``fused_norm_matmul``) with a CUDA kernel written for Hopper,
``ops/csrc/fused_norm_matmul.cu``. The decode sites (model.py): the input
norm -> ``wqkv``, the post-attention norm -> ``w_gu``, the final norm ->
``lm_head``.

What bounds it on the H100: device-memory bytes at decode rows, where each
weight element is read once and used once per row: ~2/3 of a decode token's
weight bytes stream through these three sites (wqkv 50 MB, w_gu 235 MB,
lm_head 1051 MB at Llama-3-8B). Past a few dozen rows the products
approach the tensor cores' rate (a 256-row prefill chunk into w_gu is 60
GFLOP against 235 MB).

What the design does about it: two bodies in one C entry point.
- Up to ``GEMV_ROWS`` rows (and every f32 call): a CUDA-core GEMV. One
  block per (row tile, column strip of W), row tiles fastest so the blocks
  sharing a strip run together and read it once from device memory. Each
  block recomputes its rows' inverse RMS in f32 (redundant work, not
  divergent: every block gets the same bits), stages the normalized rows in
  shared memory, then streams its strip with 16-byte loads, several loads
  in flight per thread, and reduces its K-lanes in shared memory. The strip
  is as wide as still leaves two strips per SM: 16 column groups of 16
  bytes (lm_head, 256 bytes of each row of W), 8 (w_gu) or 4 (wqkv).
- Past ``GEMV_ROWS`` rows, f16/bf16: the tensor cores. A small kernel
  normalizes each row once into a [rows, hidden] scratch the wrapper
  allocates (at most 2 MB at 256 rows, held in the L2); the product kernel
  runs ``wgmma`` over 128-row tiles (two warpgroups of m64 rows) from a
  ring of cp.async stages, K 64 deep, in 128-byte swizzled shared memory.
  Column strips are 128 wide, 64 where that would leave SMs idle (wqkv).
Either way the normalized row is cast to the activation dtype exactly where
``rms_norm`` casts it. Rows past ``MAX_ROWS`` (the JAX package's bound) take
the unfused composition, counted in ``fused_norm_matmul.unfused``. The sums
run in another order than cuBLAS's, so the kernel is held to the plain
version within a tolerance, never bitwise.

A quantized weight (ops/quant.py) is not the kernel's: as in the JAX
package (``norm_matmul_supported`` takes plain weights only), the wrapper
computes ``qmat(rms_norm(x, ...), w)``, so an int4 weight runs the int4
kernel at the norm sites; these calls count in
``fused_norm_matmul.quantized``.

For a tensor on the CPU the wrapper runs :func:`fused_norm_matmul_plain`;
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from cake_tpu_torch.ops import _build
from cake_tpu_torch.ops.norm import rms_norm
from cake_tpu_torch.ops.quant import QUANT_TYPES, qmat

_KERNEL_DTYPES = (torch.float32, torch.float16, torch.bfloat16)
# Rows the kernel takes, as the JAX package's kernel (a 256-row prefill
# chunk); longer windows take the unfused composition.
MAX_ROWS = 256
# Rows up to which f16/bf16 run the CUDA-core GEMV; past it, the tensor cores.
GEMV_ROWS = 4


def _unfused(x, norm_w, w, eps, offset):
    return qmat(rms_norm(x, norm_w, eps, offset), w)


def fused_norm_matmul_plain(x, norm_w, w, *, eps: float, offset: bool = False):
    """Plain PyTorch version: ``rms_norm`` then the product, the unfused
    composition itself."""
    fused_norm_matmul_plain.launches += 1
    return _unfused(x, norm_w, w, eps, offset)


fused_norm_matmul_plain.launches = 0


def fused_norm_matmul(x, norm_w, w, *, eps: float, offset: bool = False):
    """``rms_norm(x, norm_w, eps, offset) @ w`` on the card.

    Args:
      x: [b, t, hidden] activations; norm_w: [hidden]; w: [hidden, out] as
        stored ([in, out]), all one dtype, or a quantized weight (qmat).
      offset: the Gemma (1 + w) norm weight.

    Returns [b, t, out] in x's dtype (f32-accumulated)."""
    if isinstance(w, QUANT_TYPES):
        fused_norm_matmul.quantized += 1
        return _unfused(x, norm_w, w, eps, offset)
    if x.device.type == "cpu":
        return fused_norm_matmul_plain(x, norm_w, w, eps=eps, offset=offset)
    if x.device.type != "cuda":
        raise ValueError(f"fused_norm_matmul: unsupported device {x.device}")
    if x.dim() != 3 or w.dim() != 2 or norm_w.dim() != 1:
        raise ValueError(
            f"fused_norm_matmul: x {tuple(x.shape)}, norm_w {tuple(norm_w.shape)}, "
            f"w {tuple(w.shape)}: expected [b, t, hidden], [hidden], [hidden, out]"
        )
    b, t, hidden = x.shape
    rows = b * t
    if rows > MAX_ROWS:
        fused_norm_matmul.unfused += 1
        return _unfused(x, norm_w, w, eps, offset)
    out_dim = w.shape[1]
    if w.shape[0] != hidden or norm_w.shape[0] != hidden:
        raise ValueError(
            f"fused_norm_matmul: hidden {hidden} does not match norm_w {tuple(norm_w.shape)} "
            f"/ w {tuple(w.shape)}"
        )
    if x.dtype not in _KERNEL_DTYPES or w.dtype != x.dtype or norm_w.dtype != x.dtype:
        raise ValueError(
            f"fused_norm_matmul: dtypes x {x.dtype}, norm_w {norm_w.dtype}, w {w.dtype} must "
            f"match and be one of {_KERNEL_DTYPES}"
        )
    per16 = 16 // x.element_size()
    if out_dim % per16 or hidden % per16:
        raise ValueError(
            f"fused_norm_matmul: out {out_dim} and hidden {hidden} must be multiples of "
            f"{per16} (16-byte rows)"
        )
    x2 = x.reshape(rows, hidden).contiguous()  # a copy only for a strided view
    for name, tn in (("x", x2), ("norm_w", norm_w), ("w", w)):
        if tn.device != x.device or not tn.is_contiguous() or tn.data_ptr() % 16:
            raise ValueError(
                f"fused_norm_matmul: {name} must be contiguous and 16-byte aligned on {x.device}"
            )
    out = torch.empty((b, t, out_dim), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    # The GEMV takes no scratch; the tensor cores the normalized rows. The
    # scratch is freed on return: the caching allocator hands its memory
    # only to work queued after this launch on the same stream.
    h = None
    if rows > GEMV_ROWS and x.dtype != torch.float32:
        h = torch.empty((rows, hidden), dtype=x.dtype, device=x.device)
    err = _build.library().cake_fused_norm_matmul(
        x2.data_ptr(), norm_w.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if h is None else h.data_ptr(), rows, hidden, out_dim,
        _build.DTYPE_CODES[str(x.dtype).removeprefix("torch.")], float(eps), int(bool(offset)),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    _build.check(err, "fused_norm_matmul")
    fused_norm_matmul.launches += 1
    return out


fused_norm_matmul.launches = 0
fused_norm_matmul.unfused = 0
fused_norm_matmul.quantized = 0
