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

What the design does about it (see the source note): :func:`plan` picks
one of three bodies from the shapes alone. Decode rows (up to
``DECODE_ROWS``) take ``mma.sync`` m16n8k16: a block owns a 256-column strip
and each warp unpacks the packed bytes and scales, staged by cp.async, in
registers straight into the operands. Past them f16/bf16 take ``wgmma`` with
the weight as the register A operand ("swap AB"), x by TMA as the shared B
operand, ``R`` rows of x (the row tile) a block, so each weight element is
unpacked once per tile. f32 activations take a CUDA-core FMA body. Where too
few strips fill the card, K is split in a way fixed by the weight's shape
alone (:func:`split_steps`). Split blocks write f32 partials that a second
pass adds in split order, over a scratch the wrapper allocates (rows go
through in chunks that keep it under ``SCRATCH_BYTES``); where a wgmma
call's blocks fill at least half the card, each walks every split and
folds them in the same order instead, with no scratch. A row's bits do
not depend on how many rows share the call: wgmma at every product width
and mma.sync give the same bits (measured on the card, PERF.md). Decode
rows keep mma.sync because wgmma at row tiles 8 and 16 is no faster there
(measured, PERF.md) and takes fewer scale-group sizes.

For a tensor on the CPU the wrapper runs :func:`int4_matmul_plain`; for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from cake_tpu_torch.ops import _build
from cake_tpu_torch.ops.launches import count

_KERNEL_DTYPES = (torch.float32, torch.float16, torch.bfloat16)
_DTYPE_CODES = {getattr(torch, name): code for name, code in _build.DTYPE_CODES.items()}
# Geometry shared with csrc/int4_matmul.cu.
BLOCK_K = 64  # logical in-rows a K step covers
SMS = 132  # H100 SXM streaming multiprocessors: the split-K and fill target
MAX_SPLITS = 16
DECODE_ROWS = 16  # rows the mma.sync body takes (wgmma is no faster there); past them, wgmma
WG_COLS = 128  # output columns a wgmma block covers
FOLD_TILES = (32, 64, 128)  # wgmma row tiles that can fold splits (a running total each)
WIDE_TILE = 256  # the row tile of an unsplit K (no running total to hold)
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
    count(int4_matmul_plain)
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


@dataclass(frozen=True)
class Plan:
    """How one call runs: which body, its row tile, and the split of K."""

    route: str  # "mma.sync", "wgmma" or "CUDA cores"
    tile: int  # wgmma's row tile, the width of its products; 0 for the other bodies
    per: int  # K steps a split covers: split_steps, the same for every row count
    splits: int
    fold: bool  # one block walks every split and folds them in order (no scratch)


def wgmma_group(group: int) -> bool:
    """Whether the wgmma body takes scale groups of ``group`` rows: a
    multiple or a divisor of BLOCK_K, and 16 rows or more (a K step's scale
    rows then fit its shared memory)."""
    return group >= 16 and (group % BLOCK_K == 0 or BLOCK_K % group == 0)


def plan(rows: int, in_dim: int, out_dim: int, dtype: torch.dtype, group: int) -> Plan:
    """The body, tile and fold for ``rows`` rows into an [in_dim, out_dim]
    weight of ``group``-row scale groups: a pure function of the shapes.

    f32 takes the CUDA-core body, and decode rows (or scale groups the
    wgmma body does not take, :func:`wgmma_group`) the mma.sync body, each split a block and an
    ordered reduce. Past DECODE_ROWS f16/bf16 take wgmma with the smallest
    row tile that holds every row (at most 128, WIDE_TILE past that where K
    is not split): a weight element is unpacked once per tile, so the
    widest tile is the fastest (measured on the card, PERF.md). Where its
    blocks fill at least half the card, one block walks every split of K
    and folds them; where they fill less, each split is a block of its own.
    The split points are split_steps's whatever the rows, so every route
    adds a row's split sums in the same order."""
    per = split_steps(in_dim, out_dim)
    splits = -(-(-(-in_dim // BLOCK_K)) // per)
    if dtype == torch.float32:
        return Plan("CUDA cores", 0, per, splits, False)
    if rows <= DECODE_ROWS or not wgmma_group(group):
        return Plan("mma.sync", 0, per, splits, False)
    tile = next((t for t in FOLD_TILES if t >= rows), FOLD_TILES[-1])
    if splits == 1 and rows > tile:
        tile = WIDE_TILE
    blocks = -(-rows // tile) * -(-out_dim // WG_COLS)
    return Plan("wgmma", tile, per, splits, splits > 1 and 2 * blocks >= SMS)


def scratch_rows(p: Plan, rows: int, out_dim: int) -> int:
    """Rows a pass of split blocks covers (their f32 partials held under
    SCRATCH_BYTES, at least 16 rows), or 0 where the call needs no scratch
    (one split, or a fold)."""
    if p.splits == 1 or p.fold:
        return 0
    return max(16, min(rows, SCRATCH_BYTES // (4 * p.splits * out_dim)))


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
    if rows == 0:
        return torch.empty((0, out_dim), dtype=x.dtype, device=x.device)
    out = _run(x, packed, scale, plan(rows, in_dim, out_dim, x.dtype, in_dim // groups))
    count(int4_matmul)
    return out


int4_matmul.launches = 0


def _run(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, p: Plan) -> torch.Tensor:
    """Launch the body ``p`` names on operands int4_matmul has checked (the
    plain version for a tensor on the CPU). Only :func:`plan`'s Plan keeps
    a row's bits independent of the rows beside it; the card tests and
    chip_smoke.py hand it others to compare the bodies."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scale)
    rows, in_dim = x.shape
    out_dim = packed.shape[1]
    out = torch.empty((rows, out_dim), dtype=x.dtype, device=x.device)
    # Split blocks write f32 partials that a second kernel adds in split
    # order. The scratch is freed on return: the caching allocator hands its
    # memory only to work queued after these launches (inside a CUDA graph
    # capture it comes from the graph's pool, which each replay reuses in
    # the captured order). Nothing here is made lazily, so a capture needs
    # no warm-up of this wrapper.
    chunk, scratch = scratch_rows(p, rows, out_dim), None
    if chunk:
        scratch = torch.empty((p.splits, chunk, out_dim), dtype=torch.float32, device=x.device)
    else:
        chunk = rows
    fn = _build.library().cake_int4_matmul
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    x_ptr, out_ptr = x.data_ptr(), out.data_ptr()
    row_in, row_out = in_dim * x.element_size(), out_dim * out.element_size()
    for r0 in range(0, rows, chunk):
        err = fn(
            x_ptr + r0 * row_in, packed.data_ptr(), scale.data_ptr(), out_ptr + r0 * row_out,
            None if scratch is None else scratch.data_ptr(), min(chunk, rows - r0), in_dim,
            out_dim, in_dim // scale.shape[0], p.per, p.tile, _DTYPE_CODES[x.dtype], stream,
        )
        if err:
            break
    _build.check(err, "int4_matmul")
    return out
