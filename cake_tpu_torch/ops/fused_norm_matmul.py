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

What the design does about it: :func:`plan` picks one of three bodies from
the shapes alone, and the C entry point runs the geometry it is handed.
- f32: a CUDA-core GEMV. One block per (row tile, column strip of W), each
  recomputing its rows' inverse RMS in f32, staging the normalized rows in
  shared memory and streaming its strip with 16-byte loads.
- 1 to ``DECODE_ROWS`` f16/bf16 rows: "swap AB" on ``wgmma``. W's output
  columns are the product's M (read MN-major from shared memory, W as
  stored), the rows padded to 8/16/32/64 its N. One producer warp keeps a
  ring of TMA stages of W and the rows in flight, 128 columns a block,
  blocks small enough that several share an SM. Where the 128-column strips
  leave SMs idle, K is split by (hidden, out) alone (:func:`split_steps`);
  the last block of a strip adds the splits' f32 partials in split order
  (an atomic ticket, no atomics on the values).
- ``DECODE_ROWS`` + 1 to ``MAX_ROWS`` f16/bf16 rows: a warp-specialized
  persistent ``wgmma`` body over 128-row tiles (a producer warpgroup of TMA
  loads, two consumer warpgroups), 256-column tiles, 128 where those leave
  SMs idle.
Both tensor-core bodies read the rows from a [rows, hidden] scratch that a
small kernel writes first, each row normalized once and cast to the
activation dtype exactly where ``rms_norm`` casts it; the product kernel
starts while it runs (a programmatic dependent launch), streaming W. Within
a body a row's bits do not depend on the rows beside it.
Rows past ``MAX_ROWS`` (the JAX package's bound) take the unfused
composition, counted in ``fused_norm_matmul.unfused``. The sums run in
another order than cuBLAS's, so the kernel is held to the plain version
within a tolerance, never bitwise.

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
from dataclasses import dataclass

import torch

from cake_tpu_torch.ops import _build
from cake_tpu_torch.ops.launches import count
from cake_tpu_torch.ops.norm import rms_norm
from cake_tpu_torch.ops.quant import QUANT_TYPES, qmat
from cake_tpu_torch.ops.tickets import tickets

_KERNEL_DTYPES = (torch.float32, torch.float16, torch.bfloat16)
# Rows the kernel takes, as the JAX package's kernel (a 256-row prefill
# chunk); longer windows take the unfused composition.
MAX_ROWS = 256
# f16/bf16 rows swap AB takes; past them the warp-specialized body.
DECODE_ROWS = 64
# Geometry shared with csrc/fused_norm_matmul.cu.
SMS = 132  # H100 SXM streaming multiprocessors: the split and tile target
BLOCK_K = 64  # K rows a step covers
SA_COLS = 128  # output columns a swap-AB block covers
ROW_TILES = (8, 16, 32, 64)  # swap AB's product widths
WS_ROWS = 128  # rows a warp-specialized tile covers
MAX_SPLITS = 8
MAX_STAGES = 8
SA_STAGES = 3  # swap AB's ring depth: several blocks an SM (measured fastest: PERF.md)
W_STAGE = 2 * BLOCK_K * 128  # a swap-AB step of W: 64 k x 128 columns of 16-bit, 16 KB
SMEM_CAP = 227 * 1024  # dynamic shared memory a block may take
GEMV_SMEM_CAP = 100 * 1024  # the GEMV's staged rows (NM_SMEM_CAP)
BODIES = {"gemv": 0, "swap_ab": 1, "warp_specialized": 2}  # the C entry point's codes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class Plan:
    """How one call runs: the body, its tile, the split of K, the ring."""

    body: str  # "gemv", "swap_ab" or "warp_specialized"
    tile: int  # swap AB: the rows' product width; warp-specialized: the column tile; GEMV: 0
    per: int  # K steps (of BLOCK_K) a split covers
    splits: int
    stages: int  # the ring's depth (0: the GEMV has none)

    @property
    def route(self) -> str:
        return "CUDA cores" if self.body == "gemv" else "wgmma"


def split_steps(hidden: int, out_dim: int) -> int:
    """K steps a swap-AB split covers, fixed by the weight's shape alone:
    enough splits of K that the 128-column strips give every SM two blocks,
    at most MAX_SPLITS (every step where the strips alone do)."""
    steps = _cdiv(hidden, BLOCK_K)
    return _cdiv(steps, max(1, min(MAX_SPLITS, steps, 2 * SMS // _cdiv(out_dim, SA_COLS))))


def plan(rows: int, hidden: int, out_dim: int, dtype: torch.dtype) -> Plan:
    """The body and geometry for ``rows`` rows into a [hidden, out_dim]
    weight: a pure function of the shapes.

    The body changes with the dtype and at DECODE_ROWS only; the split of
    K is split_steps's whatever the rows, so within a body a row's sums run
    over the same steps in the same order. Raises for what the kernel does
    not take."""
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"fused_norm_matmul: dtype {dtype} is not one of {_KERNEL_DTYPES}")
    elem = torch.finfo(dtype).bits // 8
    if hidden < 1 or out_dim < 1 or (hidden * elem) % 16 or (out_dim * elem) % 16:
        raise ValueError(
            f"fused_norm_matmul: out {out_dim} and hidden {hidden} must be positive multiples "
            f"of {16 // elem} (16-byte rows)"
        )
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"fused_norm_matmul: {rows} rows; the kernel takes 1 to {MAX_ROWS}")
    steps = _cdiv(hidden, BLOCK_K)
    if dtype == torch.float32:
        if hidden * elem > GEMV_SMEM_CAP:
            raise ValueError(f"fused_norm_matmul: hidden {hidden} exceeds the GEMV's staged row")
        return Plan("gemv", 0, steps, 1, 0)
    if rows <= DECODE_ROWS:
        per = split_steps(hidden, out_dim)
        tile = next(t for t in ROW_TILES if t >= rows)
        return Plan("swap_ab", tile, per, _cdiv(steps, per), SA_STAGES)
    # 256 columns where those tiles give every SM one, else 128 (widths
    # between that are not multiples of 64 measured slower: PERF.md). A
    # row's bits do not depend on it: the product's width does not change
    # a column's sum.
    tile = 256 if _cdiv(rows, WS_ROWS) * _cdiv(out_dim, 256) >= SMS else 128
    stage = WS_ROWS * 128 + tile // 64 * BLOCK_K * 128
    return Plan("warp_specialized", tile, steps, 1, min(MAX_STAGES, (SMEM_CAP - 1024) // stage))


def smem_bytes(p: Plan, rows: int, hidden: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory a block of ``p`` takes (the kernel's launch
    computes the same)."""
    elem = torch.finfo(dtype).bits // 8
    if p.body == "gemv":
        rt = 1
        while rt < rows and rt < 8:
            rt *= 2
        while rt > 1 and hidden * rt * elem > GEMV_SMEM_CAP:
            rt //= 2
        return hidden * rt * elem
    if p.body == "swap_ab":
        return p.stages * (W_STAGE + p.tile * 128) + 1024
    return p.stages * (WS_ROWS * 128 + p.tile // 64 * BLOCK_K * 128) + 1024


def _unfused(x, norm_w, w, eps, offset):
    return qmat(rms_norm(x, norm_w, eps, offset), w)


def fused_norm_matmul_plain(x, norm_w, w, *, eps: float, offset: bool = False):
    """Plain PyTorch version: ``rms_norm`` then the product, the unfused
    composition itself."""
    count(fused_norm_matmul_plain)
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
        count(fused_norm_matmul, "quantized")
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
        count(fused_norm_matmul, "unfused")
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
    p = plan(max(rows, 1), hidden, out_dim, x.dtype)  # raises for shapes the kernel does not take
    x2 = x.reshape(rows, hidden).contiguous()  # a copy only for a strided view
    for name, tn in (("x", x2), ("norm_w", norm_w), ("w", w)):
        if tn.device != x.device or not tn.is_contiguous() or tn.data_ptr() % 16:
            raise ValueError(
                f"fused_norm_matmul: {name} must be contiguous and 16-byte aligned on {x.device}"
            )
    if rows == 0:
        return torch.empty((b, t, out_dim), dtype=x.dtype, device=x.device)
    out = _run(x2, norm_w, w, p, eps=eps, offset=offset)
    count(fused_norm_matmul)
    return out.view(b, t, out_dim)


fused_norm_matmul.launches = 0
fused_norm_matmul.unfused = 0
fused_norm_matmul.quantized = 0


def _run(x: torch.Tensor, norm_w: torch.Tensor, w: torch.Tensor, p: Plan, *, eps: float,
         offset: bool = False) -> torch.Tensor:
    """Launch the body ``p`` names on operands fused_norm_matmul has checked
    (x [rows, hidden] contiguous; the plain version for a tensor on the
    CPU). Only :func:`plan`'s Plan keeps a row's bits independent of the
    rows beside it; the card tests and chip_smoke.py hand it others to
    compare the bodies. Returns [rows, out]."""
    if x.device.type == "cpu":
        return fused_norm_matmul_plain(x, norm_w, w, eps=eps, offset=offset)
    rows, hidden = x.shape
    out_dim = w.shape[1]
    out = torch.empty((rows, out_dim), dtype=x.dtype, device=x.device)
    # The scratch of the normalized rows and the f32 partials of split K
    # are freed on return: the caching allocator hands their memory only to
    # work queued after this launch on the same stream (inside a CUDA graph
    # capture, they come from the graph's pool). The strips' tickets come
    # from ops/tickets.py.
    h = part = strips = None
    if p.body != "gemv":
        h = torch.empty((rows, hidden), dtype=x.dtype, device=x.device)
    if p.body == "swap_ab" and p.splits > 1:
        part = torch.empty((p.splits, rows, out_dim), dtype=torch.float32, device=x.device)
        strips = tickets("fused_norm_matmul", x.device, _cdiv(out_dim, SA_COLS))
    err = _build.library().cake_fused_norm_matmul(
        x.data_ptr(), norm_w.data_ptr(), w.data_ptr(), out.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (h, part, strips)),
        rows, hidden, out_dim, _build.DTYPE_CODES[str(x.dtype).removeprefix("torch.")],
        float(eps), int(bool(offset)), BODIES[p.body], p.tile, p.per, p.stages,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    _build.check(err, "fused_norm_matmul")
    return out
