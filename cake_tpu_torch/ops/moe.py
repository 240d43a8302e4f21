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
    the group offsets read from device memory; its rows are independent of
    their neighbours, so a warm prefix wave gives the cold wave's bits. Its
    plain version, one ``torch`` product an expert
    (:func:`grouped_matmul_plain`), runs on the CPU. The group sizes still
    come back to the host (:data:`GROUP_SIZES`, the capture guard), so this
    path never runs under a CUDA graph capture.

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


# The grouped GEMM's row tile (csrc/moe_grouped.cu BM): its grid has at
# most ceil(rows / ROW_TILE) + E row tiles.
ROW_TILE = 64


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


def grouped_matmul(xs: torch.Tensor, mats: torch.Tensor, offsets: torch.Tensor,
                   sizes: list[int]) -> torch.Tensor:
    """Rows sorted by expert [M, K], each group times its own expert's
    weight of ``mats`` [E, K, N] (x's dtype, or int8 widened in the kernel):
    [M, N] in x's dtype. ``offsets`` [E + 1] int32 on x's device delimit the
    groups (the kernel reads them there); ``sizes`` are the same groups on
    the host, read by the plain version only. On the card one launch covers
    every expert; an output row's bits depend on that row and its expert's
    weights alone (a fixed row tile, K in one fixed order, f32 accumulation)."""
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
    if k % 32 or n % (16 if quant else 8):
        raise ValueError(f"grouped_matmul: K {k} must be a multiple of 32 and N {n} of "
                         f"{16 if quant else 8}")
    xs = xs.contiguous()
    mats = mats.contiguous()
    out = torch.empty((m, n), dtype=xs.dtype, device=xs.device)
    if m:
        tiles = -(-m // ROW_TILE) + e
        err = _build.library().cake_moe_grouped(
            xs.data_ptr(), mats.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            m, k, n, e, _build.dtype_code(xs.dtype), int(quant), tiles,
            ctypes.c_void_p(torch.cuda.current_stream(xs.device).cuda_stream),
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

