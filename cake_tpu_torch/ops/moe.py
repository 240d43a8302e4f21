"""Sparse mixture-of-experts SwiGLU block (port of ``cake_tpu/ops/moe.py``):
Mixtral, Qwen2-MoE and Qwen3-MoE.

Routing follows HF's MixtralSparseMoeBlock: router logits in x's dtype ->
a full softmax over every expert in f32 -> the top-k probabilities,
renormalized to sum 1 where the config asks (``norm_topk``) -> the weighted
sum of the selected experts' SwiGLU outputs.

Two dispatch regimes share that one routing definition, chosen by the JAX
package's rule:

  * **Dense combine** (fewer than :data:`GROUPED_MIN_TOKENS` tokens a row,
    so every decode step): every expert's SwiGLU runs as one batched
    product and the routing probability, zero for an unselected expert,
    weights the combine. Shapes are static and nothing is read back, so a
    CUDA graph captures it. A decode step streams every expert's weights,
    selected or not (ROADMAP.md, parked speed items).
  * **Grouped dispatch** (chunks of :data:`GROUPED_MIN_TOKENS` or more):
    the token-expert assignments are sorted stably by expert and each
    expert multiplies only its own contiguous row group (the JAX package's
    ``ragged_dot``, an XLA primitive, not a Pallas kernel). On the card
    each product (gate, up, down) is one launch of the grouped expert GEMM
    (:func:`grouped_matmul`, ``csrc/moe_grouped.cu``) over every expert,
    the group offsets read from device memory. For f16/bf16 rows it is a
    persistent Hopper kernel: blocks walk work items (expert, 256-row pair
    of its group, column strip), numbered expert by expert with a strip's
    row pairs side by side so each strip of W streams from device memory
    about once; each block scans the groups' pair counts from ``offsets``
    once and finds an item's expert by a binary search (:func:`tile_items`
    is the same arithmetic on the host). TMA brings the x rows (a 2-D map
    over [M, K]) and the W strip (a 3-D map over the stack, so a ragged
    last K step reads zeros, never the next expert) into a ring a producer
    warpgroup keeps full, and two consumer warpgroups run ``wgmma`` and
    store only the rows below their group's end. A 16-bit stack runs on a
    cluster of two blocks, 128 rows each, that multicast halves of the W
    strip into both; an int8 stack runs "swap AB", W's columns the
    product's M, widened from int8 straight into wgmma's register operand,
    the item's 256 rows its N. Its rows are independent of their
    neighbours, bitwise: the body, tile and instruction come from (K, N,
    dtype, quant) alone (:func:`plan`), K runs in one fixed order, f32
    accumulation, so a warm prefix wave gives the cold wave's bits. f32
    rows take a CUDA-core loop. Its plain version, one ``torch`` product an
    expert (:func:`grouped_matmul_plain`), runs on the CPU. The group sizes
    still come back to the host (:data:`GROUP_SIZES`, the
    capture guard), so this path never runs under a CUDA graph capture.

The two reduce the experts' contributions in different orders, so a
sequence's low-precision stream depends on the chunk width, as in the JAX
package (its ``GROUPED_MIN_TOKENS`` note); the port takes the path the JAX
package takes at the same width.

Parity details: the top-k breaks ties by the lower expert index, as
``jax.lax.top_k`` does (``torch.topk`` promises no order on ties, which bf16
router logits make common): a stable descending sort. The grouped combine
adds a token's contributions in ascending expert order, the order of the
JAX package's scatter-add over the expert-sorted assignments, by sums of
gathered rows rather than atomic adds, so the bits do not depend on the
device. int8 expert stacks (``QuantWeight``, scale [E, 1, out]) are
converted to x's dtype and scaled per expert and output channel; int4
expert stacks raise ``TypeError``, as in the JAX package
(``quantize_layer_tree`` keeps experts int8 under ``int4``).

Not ported (ROADMAP.md, queue A item 9, the in-process backends): the
expert-parallel ``tp_axis`` and the capacity dispatch it takes, and the
``valid`` pad mask, which feeds only that dispatch.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from cake_tpu_torch.ops import _build
from cake_tpu_torch.ops.launches import count
from cake_tpu_torch.ops.quant import Quant4Weight, QuantWeight

# Below this many tokens a row the dense combine runs; at or above it, the
# grouped dispatch (the JAX package's threshold).
GROUPED_MIN_TOKENS = 8

# While a list, every grouped dispatch appends its group sizes (rows an
# expert, the tokens routed to it) here: the records' tokens per expert.
GROUP_SIZES: list | None = None

_TP_TODO = (
    "tensor-parallel MoE (the expert-capacity dispatch and its pad mask) is not ported "
    "(ROADMAP.md queue A item 9, the in-process backends)"
)


def _expert_scale(w: QuantWeight, dtype) -> torch.Tensor:
    """An int8 stack's scale [E, 1, out] as [E, out] in ``dtype``."""
    e, _, o = w.scale.shape
    return w.scale.reshape(e, o).to(dtype)


def _expert_products(x2: torch.Tensor, w) -> torch.Tensor:
    """Every expert's product of the rows [n, in] -> [E, n, out] (the JAX
    package's ``_qeinsum``), plain or int8 (scaled per expert and output
    channel). One batched product over the stack as it lies in memory: an
    einsum would lay the experts' columns side by side, a copy of the stack."""
    if isinstance(w, QuantWeight):
        return torch.matmul(x2, w.w.to(x2.dtype)) * w.scale.to(x2.dtype)
    return torch.matmul(x2, w)


def route_topk_select(logits: torch.Tensor, top_k: int, norm_topk: bool = True):
    """HF routing: softmax in f32 -> top-k (ties to the lower index) ->
    optional renormalization. Returns (values [..., k] f32, indices
    [..., k] int64)."""
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = vals[..., :top_k], idx[..., :top_k]
    if norm_topk:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    return topv, topi


def route_topk(logits: torch.Tensor, top_k: int, n_experts: int, norm_topk: bool = True):
    """Dense combine weights [..., n_experts] f32, zero for unselected experts."""
    topv, topi = route_topk_select(logits, top_k, norm_topk)
    weights = torch.zeros((*logits.shape[:-1], n_experts), dtype=torch.float32,
                          device=logits.device)
    return weights.scatter(-1, topi, topv)


# Geometry shared with csrc/moe_grouped.cu.
ROW_TILE = 128  # rows a block of the warp-specialized body covers: two warpgroups of 64
CLUSTER = 2  # its blocks of an item, one row tile each, sharing the W strip by multicast
PAIR_ROWS = CLUSTER * ROW_TILE  # rows a work item covers (swap AB: one block)
BLOCK_K = 64  # K a step covers
X_STAGE = ROW_TILE * 128  # a step's x tile, 16 KB
W_BOX = BLOCK_K * 128  # 64 k x 64 16-bit columns, or 64 k x 128 int8 columns, 8 KB
SA_COLS = 128  # W columns a swap-AB item covers (int8 stacks)
MAX_STAGES = 8
SMEM_CAP = 227 * 1024  # dynamic shared memory a block may take
BODIES = {"f32": 0, "warp_specialized": 1, "swap_ab": 2}  # the C entry point's codes


@dataclass(frozen=True)
class Plan:
    """How one grouped product runs: the body, its column tile, the ring."""

    body: str  # "f32" (CUDA cores), "warp_specialized" or "swap_ab" (wgmma)
    tile: int  # output columns an item covers
    stages: int  # the ring's depth (0: the f32 body has none)

    @property
    def instruction(self) -> str:
        """The product instruction every output element accumulates on."""
        if self.body == "warp_specialized":
            return f"wgmma m64n{self.tile}k16 (x and W from shared memory)"
        if self.body == "swap_ab":
            return f"wgmma m64n{PAIR_ROWS}k16 (W^T from registers, x^T from shared memory)"
        return "fmaf"

    @property
    def route(self) -> str:
        return "CUDA cores" if self.body == "f32" else "wgmma"


def stage_bytes(tile: int, quant: bool) -> int:
    """A TMA stage of a wgmma body: the x tile and the W strip as stored
    (16-bit, or the raw int8 strip the swap-AB body widens in registers)."""
    return (PAIR_ROWS * 128 + W_BOX) if quant else X_STAGE + tile // 64 * W_BOX


def plan(k: int, n: int, dtype: torch.dtype, quant: bool, experts: int) -> Plan:
    """The body and geometry of a product into an [experts, k, n] stack.

    The body, the column tile and so the instruction are a function of (k,
    n, dtype, quant) alone, never of the rows or the group sizes, so a
    row's sum runs over the same K steps in the same order whatever its
    group holds: f32 rows the CUDA-core loop, 16-bit stacks the
    warp-specialized body (m64n{tile}k16, 256 columns an item where the
    strips stay mostly full, else 128), int8 stacks swap AB (m64n256k16
    over an item's 256 rows, 128 columns). ``experts`` sets only the ring's
    depth (the group offsets and their prefix share the block's shared
    memory; the ring is a pipeline, not arithmetic). Raises for what the
    kernel does not take."""
    if dtype not in (torch.float32, torch.float16, torch.bfloat16):
        raise TypeError(f"grouped_matmul: rows of {dtype}")
    if k < 32 or k % 32 or n < 8 or n % (16 if quant else 8) or experts < 1:
        raise ValueError(f"grouped_matmul: K {k} must be a multiple of 32 and N {n} of "
                         f"{16 if quant else 8}")
    if dtype == torch.float32:
        return Plan("f32", 128, 0)
    body, tile = ("swap_ab", SA_COLS) if quant else ("warp_specialized", 256 if n >= 512 else 128)
    # The ring, the 1024-byte alignment, the offsets and their prefix, and
    # room for the kernel's static mbarriers.
    stages = min(MAX_STAGES, (SMEM_CAP - 2048 - 8 * (experts + 1)) // stage_bytes(tile, quant))
    if stages < 2:
        raise ValueError(f"grouped_matmul: {experts} experts leave no room for the ring")
    return Plan(body, tile, stages)


def item_prefix(offsets) -> list[int]:
    """The work items a strip of the groups before each expert, [E + 1]
    (the kernel's ``tpre``: a scan of ceil(rows / PAIR_ROWS) a group)."""
    offs = [int(v) for v in offsets]
    pre = [0]
    for lo, hi in zip(offs, offs[1:]):
        pre.append(pre[-1] + -(-(hi - lo) // PAIR_ROWS))
    return pre


def tile_items(offsets, n: int, p: Plan) -> list[tuple[int, int, int, int, int, int]]:
    """The wgmma bodies' work in order, one entry a block of an item:
    (item, expert, the block's first row, its rows, the group's row end,
    first column), by the kernels' arithmetic. Item t's expert is the last
    whose first item is at or before t (a binary search of the prefix),
    then its strip and row pair (the pair fastest). The warp-specialized
    body runs an item on a cluster of two blocks of 128 rows, swap AB on
    one block of 256; a block computes all its rows and stores those below
    the group's end. ``offsets``: [E + 1] group bounds (a list or a CPU
    tensor)."""
    offs = [int(v) for v in offsets]
    pre = item_prefix(offs)
    n_e, strips = len(offs) - 1, -(-n // p.tile)
    blocks = CLUSTER if p.body == "warp_specialized" else 1
    rows = PAIR_ROWS // blocks
    out = []
    for t in range(strips * pre[-1]):
        lo, hi = 0, n_e
        while hi - lo > 1:
            mid = (lo + hi) >> 1
            if strips * pre[mid] <= t:
                lo = mid
            else:
                hi = mid
        pairs, local = pre[lo + 1] - pre[lo], t - strips * pre[lo]
        for rank in range(blocks):
            out.append((t, lo, offs[lo] + local % pairs * PAIR_ROWS + rank * rows, rows,
                        offs[lo + 1], local // pairs * p.tile))
    return out


def item_bound(m: int, n: int, experts: int, p: Plan) -> int:
    """The host's bound on the items (the persistent grid's item slots
    before the card's cap): each group wastes at most one row pair a
    strip."""
    return -(-n // p.tile) * (-(-m // PAIR_ROWS) + experts)


def grouped_matmul_plain(xs: torch.Tensor, mats: torch.Tensor, sizes: list[int]) -> torch.Tensor:
    """Plain PyTorch version of :func:`grouped_matmul`: one product an
    expert with rows (an int8 stack widened to x's dtype)."""
    count(grouped_matmul_plain)
    out = torch.empty((xs.shape[0], mats.shape[-1]), dtype=xs.dtype, device=xs.device)
    lo = 0
    for e, n in enumerate(sizes):
        if n:
            w = mats[e] if mats.dtype == xs.dtype else mats[e].to(xs.dtype)
            out[lo : lo + n] = xs[lo : lo + n] @ w
        lo += n
    return out


grouped_matmul_plain.launches = 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (TMA's requirement)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def grouped_matmul(xs: torch.Tensor, mats: torch.Tensor, offsets: torch.Tensor,
                   sizes: list[int]) -> torch.Tensor:
    """Rows sorted by expert [M, K], each group times its own expert's
    weight of ``mats`` [E, K, N] (x's dtype, or int8 widened in the kernel):
    [M, N] in x's dtype. ``offsets`` [E + 1] int32 on x's device delimit the
    groups (the kernel reads them there); ``sizes`` are the same groups on
    the host, read by the plain version only. On the card one launch covers
    every expert, in the geometry :func:`plan` gives; an output row's bits
    depend on that row and its expert's weights alone (a fixed tile and
    instruction, K in one fixed order, f32 accumulation)."""
    if xs.device.type == "cpu":
        return grouped_matmul_plain(xs, mats, sizes)
    if xs.device.type != "cuda":
        raise ValueError(f"grouped_matmul: unsupported device {xs.device}")
    quant = mats.dtype == torch.int8
    if not quant and mats.dtype != xs.dtype:
        raise TypeError(f"grouped_matmul: {mats.dtype} experts under {xs.dtype} rows")
    m, k = xs.shape
    e, k2, n = mats.shape
    if k2 != k or offsets.shape != (e + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"grouped_matmul: rows {tuple(xs.shape)}, experts {tuple(mats.shape)}, "
                         f"offsets {tuple(offsets.shape)} {offsets.dtype}")
    p = plan(k, n, xs.dtype, quant, e)
    xs = _aligned(xs)
    mats = _aligned(mats)
    out = torch.empty((m, n), dtype=xs.dtype, device=xs.device)
    if m:
        err = _build.library().cake_moe_grouped(
            xs.data_ptr(), mats.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            m, k, n, e, _build.dtype_code(xs.dtype), int(quant), BODIES[p.body], p.tile,
            p.stages, ctypes.c_void_p(torch.cuda.current_stream(xs.device).cuda_stream),
        )
        _build.check(err, "grouped_matmul")
        count(grouped_matmul)
    return out


grouped_matmul.launches = 0


def _ragged(xs: torch.Tensor, w, sizes: list[int], offsets: torch.Tensor,
            eids: torch.Tensor) -> torch.Tensor:
    """Rows sorted by expert, each group times its own expert's weight (the
    JAX package's ``ragged_dot``), an int8 stack's per-expert scale applied
    after the product."""
    quant = isinstance(w, QuantWeight)
    out = grouped_matmul(xs, w.w if quant else w, offsets, sizes)
    if quant:
        out = out * _expert_scale(w, xs.dtype)[eids]
    return out


def _grouped(x, logits, w_gate, w_up, w_down, top_k: int, norm_topk: bool, e_local: int):
    """The grouped dispatch over [b, t, h]: FLOPs proportional to top_k / E."""
    if x.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "the grouped MoE dispatch reads its group sizes back to the host and cannot run "
            "under a CUDA graph capture (a captured decode step takes the dense combine)"
        )
    b, t, h = x.shape
    n = b * t
    topv, topi = route_topk_select(logits, top_k, norm_topk)
    eids = topi.reshape(n * top_k)
    wts = topv.reshape(n * top_k)
    eids_s, order = torch.sort(eids, stable=True)
    tok_s = order // top_k
    xs = x.reshape(n, h)[tok_s]  # [n*k, h], expert-sorted
    counts = torch.bincount(eids_s, minlength=e_local)
    offsets = torch.zeros(e_local + 1, dtype=torch.int32, device=x.device)
    offsets[1:] = torch.cumsum(counts, 0)
    sizes = counts.tolist()
    if GROUP_SIZES is not None:
        GROUP_SIZES.append(sizes)
    g = F.silu(_ragged(xs, w_gate, sizes, offsets, eids_s))
    u = _ragged(xs, w_up, sizes, offsets, eids_s)
    y = _ragged(g * u, w_down, sizes, offsets, eids_s)  # [n*k, h]
    y = y * wts[order][:, None].to(y.dtype)
    # A token's rows in the sorted list, in list order (ascending expert):
    # summed one after another, as a serial scatter-add over the list.
    where = torch.empty_like(order)
    where[order] = torch.arange(n * top_k, device=order.device)
    rows = torch.sort(where.reshape(n, top_k), dim=-1).values
    out = y[rows[:, 0]]
    for j in range(1, top_k):
        out = out + y[rows[:, j]]
    return out.reshape(b, t, h).to(x.dtype)


def moe_swiglu(
    x: torch.Tensor,
    router_w: torch.Tensor,
    w_gate,
    w_up,
    w_down,
    top_k: int,
    tp_axis: str | None = None,
    norm_topk: bool = True,
    valid: torch.Tensor | None = None,
    dispatch: str = "auto",
) -> torch.Tensor:
    """Routed SwiGLU over stacked experts.

    Args:
      x: [batch, chunk, hidden], the post-norm activations.
      router_w: [hidden, n_experts].
      w_gate/w_up: [n_experts, hidden, inter]; w_down: [n_experts, inter,
        hidden]; plain or int8 (``QuantWeight``, scale [E, 1, out]).
      top_k: experts combined per token; norm_topk: renormalize them.
      dispatch: "auto" (grouped at ``chunk >= GROUPED_MIN_TOKENS``) or
        "dense" (the dense combine at any width).

    Returns [batch, chunk, hidden] in x's dtype.
    """
    if dispatch not in ("auto", "dense"):
        raise ValueError(f"unknown MoE dispatch {dispatch!r}")
    if tp_axis is not None or valid is not None:
        raise NotImplementedError(_TP_TODO)
    if any(isinstance(w, Quant4Weight) for w in (w_gate, w_up, w_down)):
        raise TypeError(
            "MoE expert stacks do not support int4; use quantize_layer_tree(mode='int4'), "
            "which keeps experts int8"
        )
    e_local = (w_gate.w if isinstance(w_gate, QuantWeight) else w_gate).shape[0]
    logits = x @ router_w.to(x.dtype)  # [b, t, E] in x's dtype
    if dispatch != "dense" and x.shape[1] >= GROUPED_MIN_TOKENS:
        return _grouped(x, logits, w_gate, w_up, w_down, top_k, norm_topk, e_local)
    b, t, h = x.shape
    weights = route_topk(logits, top_k, logits.shape[-1], norm_topk).reshape(b * t, 1, -1)
    x2 = x.reshape(b * t, h)
    g = F.silu(_expert_products(x2, w_gate))
    u = _expert_products(x2, w_up)
    y = _expert_products(g * u, w_down)  # [E, n, h]
    # The weighted sum over the experts, one rounding (the JAX einsum's).
    out = torch.bmm(weights.to(y.dtype), y.transpose(0, 1))  # [n, 1, h]
    return out.reshape(b, t, h).to(x.dtype)

