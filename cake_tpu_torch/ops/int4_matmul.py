"""Packed-int4 weight-only matmul: ``x @ dequant(packed, scale)``.

Replaces the Pallas TPU kernel ``cake_tpu/ops/pallas/int4_matmul.py``
(``int4_matmul``) with a CUDA kernel written for Hopper,
``ops/csrc/int4_matmul.cu``. ``ops/quant.qmat`` sends every int4 matmul
here: decode rows, prefill chunks and the engine's prefill windows.

What it computes is the TPU kernel's arithmetic: for each logical in-row k,
``w[k, n] = to_xdtype(float(nibble[k, n]) * scale[k // group, n])`` (one
rounding of the scaled weight to the activation dtype), then
``out[r, n] = to_xdtype(sum_k float(x[r, k]) * float(w[k, n]))`` with f32
accumulation.

What bounds it on the H100: at decode rows, device-memory bytes (only the
packed nibbles and the f32 scales stream: Llama-3-8B's w_gu is 62 MB, 0.019
ms at 3.35 TB/s); past a few hundred rows, the tensor cores (w_gu at 256
rows is 60 GFLOP, 0.061 ms at 989 TFLOP/s).

What the design does about it (see the source note): a block owns a
column strip of W and walks K in 64-row steps through a ring of cp.async
stages that carry only the packed bytes and their scales; each warp unpacks
and scales them in registers straight into ``mma.sync`` m16n8k16 operands
(f32 accumulators), for every row count. f32 activations take a CUDA-core
FMA body. Where too few strips fill the card (every projection but lm_head
at decode rows), K is split in a way fixed by the weight's shape alone, and
each split is a block whose f32 partial sums a second pass adds in split
order, over a scratch the wrapper allocates (rows go through in chunks that
keep it under ``SCRATCH_BYTES``). A row's bits do not depend on how many
rows share the call.

For a tensor on the CPU the wrapper runs :func:`int4_matmul_plain`; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from cake_tpu_torch.ops import _build

_KERNEL_DTYPES = (torch.float32, torch.float16, torch.bfloat16)
_DTYPE_CODES = {getattr(torch, name): code for name, code in _build.DTYPE_CODES.items()}
# Geometry shared with csrc/int4_matmul.cu.
BLOCK_K = 64  # logical in-rows a K step covers
SMS = 132  # H100 SXM streaming multiprocessors: the split-K target
MAX_SPLITS = 16
# A call whose K is split writes f32 partials [splits, rows, out]; longer
# calls go through in row chunks that keep this scratch under this size.
SCRATCH_BYTES = 256 << 20


def unpack4(packed: torch.Tensor, dtype: torch.dtype = torch.int8):
    """The two nibble planes of a packed int4 tensor, sign-extended:
    (lo, hi) = logical even / odd in-rows, each the packed shape."""
    lo = (packed << 4) >> 4  # int8 shifts: arithmetic, sign-extending
    hi = packed >> 4
    return lo.to(dtype), hi.to(dtype)


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: unpack, scale in f32, round to x's dtype, then
    an f32 product rounded to x's dtype."""
    int4_matmul_plain.launches += 1
    half, out = packed.shape
    groups = scale.shape[0]
    lo, hi = unpack4(packed, torch.float32)
    w = torch.stack([lo, hi], dim=1).reshape(2 * half, out)
    w = (w.reshape(groups, -1, out) * scale[:, None, :]).reshape(2 * half, out)
    return (x.float() @ w.to(x.dtype).float()).to(x.dtype)


int4_matmul_plain.launches = 0


def split_steps(in_dim: int, out_dim: int) -> int:
    """K steps (of BLOCK_K rows) a split of K covers, fixed by the weight's
    shape alone: every step where the decode blocks' column strips (256
    wide) fill the card, else enough splits for two blocks an SM, at most
    MAX_SPLITS."""
    strips = -(-out_dim // 256)
    steps = -(-in_dim // BLOCK_K)
    if strips >= SMS:
        return steps
    return -(-steps // min(MAX_SPLITS, steps, -(-2 * SMS // strips)))


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(packed, scale)`` on the card.

    Args:
      x: [rows, in] activations, f32/f16/bf16.
      packed: [in/2, out] int8, quantize4_weight's adjacent nibble pairing.
      scale: [G, out] f32 group scales; in / G even.

    Returns [rows, out] in x's dtype."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    if x.dim() != 2 or packed.dim() != 2 or scale.dim() != 2:
        raise ValueError(
            f"int4_matmul: x {tuple(x.shape)}, packed {tuple(packed.shape)}, scale "
            f"{tuple(scale.shape)}: expected [rows, in], [in/2, out], [G, out]"
        )
    rows, in_dim = x.shape
    half, out_dim = packed.shape
    groups = scale.shape[0]
    if in_dim != 2 * half or scale.shape[1] != out_dim:
        raise ValueError(
            f"int4_matmul: x {tuple(x.shape)}, packed {tuple(packed.shape)} and scale "
            f"{tuple(scale.shape)} do not agree"
        )
    if x.dtype not in _KERNEL_DTYPES or packed.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(
            f"int4_matmul: dtypes x {x.dtype}, packed {packed.dtype}, scale {scale.dtype}: "
            f"expected one of {_KERNEL_DTYPES}, int8, float32"
        )
    if groups < 1 or in_dim % groups or (in_dim // groups) % 2:
        raise ValueError(f"int4_matmul: {groups} groups do not split in {in_dim} into even groups")
    if in_dim % 16 or out_dim % 16:
        raise ValueError(f"int4_matmul: in {in_dim} and out {out_dim} must be multiples of 16")
    for name, t in (("x", x), ("packed", packed), ("scale", scale)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"int4_matmul: {name} must be contiguous and 16-byte aligned on {x.device}"
            )
    out = torch.empty((rows, out_dim), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    per = split_steps(in_dim, out_dim)
    splits = -(-in_dim // (BLOCK_K * per))
    # Each split is a block of its own; a second kernel adds the partials
    # in split order. The scratch is freed on return: the caching allocator
    # hands its memory only to work queued after these launches.
    chunk, scratch = rows, None
    if splits > 1:
        chunk = max(16, min(rows, SCRATCH_BYTES // (4 * splits * out_dim)))
        scratch = torch.empty((splits, chunk, out_dim), dtype=torch.float32, device=x.device)
    fn = _build.library().cake_int4_matmul
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    x_ptr, out_ptr = x.data_ptr(), out.data_ptr()
    row_in, row_out = in_dim * x.element_size(), out_dim * out.element_size()
    for r0 in range(0, rows, chunk):
        err = fn(
            x_ptr + r0 * row_in, packed.data_ptr(), scale.data_ptr(), out_ptr + r0 * row_out,
            None if scratch is None else scratch.data_ptr(), min(chunk, rows - r0), in_dim,
            out_dim, in_dim // groups, per, _DTYPE_CODES[x.dtype], stream,
        )
        if err:
            break
    _build.check(err, "int4_matmul")
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0
