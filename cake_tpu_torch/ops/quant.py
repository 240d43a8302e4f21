"""Weight-only int8 and int4 quantization (port of ``cake_tpu/ops/quant.py``).

Decode at batch 1 is bound by the weight bytes it streams; int8 storage
halves them and int4 halves them again. Activations stay in their dtype.

Representations, each a leaf of two tensors:

``QuantWeight``, int8, per-output-channel symmetric:

    w:     int8  [..., in, out]
    scale: f32   [..., 1, out]

``Quant4Weight``, int4, per-(in-group, output-channel) symmetric:

    w:     int8  [..., in/2, out]   two nibbles a byte: byte i holds logical
                                    in-rows 2i (low nibble) and 2i+1 (high)
    scale: f32   [..., G, out]      G = in / group_size along the reduction

Indexing a leaf indexes both tensors (``leaf[i]`` is layer i of a stacked
leaf), so the model's per-layer views (``{name: w[i] ...}``) work on plain
and quantized weights alike.

``qmat(x, w)`` is the one matmul entry point: a plain tensor (``x @ w``), a
QuantWeight (``(x @ w.to(x.dtype)) * scale.to(x.dtype)``, outside any
kernel, as in the JAX package) or a Quant4Weight, which goes through
``ops/int4_matmul.int4_matmul`` on every device and for every row count: the
CUDA kernel on the card, its plain version on the CPU. That is the JAX
package's TPU route (the Pallas kernel for every int4 matmul), not its
XLA ``_qmat4``: one path for every row count keeps a row's bits independent
of the rows it shares a call with.

Quantization itself gives the JAX package's bits: f32 division by the
scale and round-half-to-even (``torch.round``, as ``jnp.round``). Stacked
leaves are quantized one layer slice at a time into preallocated outputs,
so a full-depth model needs one layer's f32 temporary, not the stack's.

MoE trees take the JAX package's mixed mode: the expert stacks go int8
under both ``int8`` and ``int4`` (ops/moe.py reads their per-expert
[E, 1, out] int8 scales), the shared expert goes with the mode, and the
router and the shared expert's gate stay at full precision.

Not ported (ROADMAP.md): the native-s4 representation (``QuantS4Weight``,
``CAKE_INT4_REPR=s4``).
"""

from __future__ import annotations

import torch

from cake_tpu_torch.ops.int4_matmul import int4_matmul, unpack4

DEFAULT_GROUP_SIZE = 128


class _QuantLeaf:
    """A quantized weight: its integer tensor and its f32 scales."""

    __slots__ = ("w", "scale")

    def __init__(self, w: torch.Tensor, scale: torch.Tensor):
        self.w = w
        self.scale = scale

    def __getitem__(self, idx):
        return type(self)(self.w[idx], self.scale[idx])

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(w={self.w.dtype}{list(self.w.shape)}, "
                f"scale={self.scale.dtype}{list(self.scale.shape)})")


class QuantWeight(_QuantLeaf):
    """Int8 weight [..., in, out] + per-output-channel scale [..., 1, out]."""


class Quant4Weight(_QuantLeaf):
    """Packed int4 weight [..., in/2, out] + per-group scale [..., G, out]."""

    @property
    def in_dim(self) -> int:
        return 2 * self.w.shape[-2]


QUANT_TYPES = (QuantWeight, Quant4Weight)


def _per_layer(fn, w: torch.Tensor, leaf_cls):
    """``fn`` over the trailing [in, out] matrices of a stacked ``w``, one
    slice at a time, written into preallocated stacked outputs."""
    if w.dim() == 2:
        return fn(w)
    lead = w.shape[:-2]
    flat = w.reshape(-1, *w.shape[-2:])
    out_w = out_s = None
    for i in range(flat.shape[0]):
        q = fn(flat[i])
        if out_w is None:
            out_w = torch.empty((flat.shape[0], *q.w.shape), dtype=q.w.dtype, device=w.device)
            out_s = torch.empty((flat.shape[0], *q.scale.shape), dtype=q.scale.dtype,
                                device=w.device)
        out_w[i] = q.w
        out_s[i] = q.scale
        del q
    return leaf_cls(out_w.reshape(*lead, *out_w.shape[1:]), out_s.reshape(*lead, *out_s.shape[1:]))


def _quantize8_2d(w: torch.Tensor) -> QuantWeight:
    w32 = w.to(torch.float32)
    absmax = w32.abs().amax(dim=-2, keepdim=True)  # [1, out]
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantWeight(q, scale)


def quantize_weight(w: torch.Tensor) -> QuantWeight:
    """Per-output-channel symmetric int8 quantization of [..., in, out]."""
    return _per_layer(_quantize8_2d, w, QuantWeight)


def _group_size_for(in_dim: int, group_size: int) -> int:
    """Largest usable group size: divides in_dim, stays even (nibble pairs
    must not straddle groups), and keeps G = in/gs >= 4 on tiny widths (real
    model dims keep the requested 128)."""
    g = min(group_size, max(2, in_dim // 4))
    while in_dim % g or g % 2:
        g -= 1
        if g < 2:
            return in_dim
    return g


def _quantize4_2d(w: torch.Tensor, gs: int) -> Quant4Weight:
    in_dim, out = w.shape
    w32 = w.to(torch.float32).reshape(in_dim // gs, gs, out)
    absmax = w32.abs().amax(dim=-2, keepdim=True)  # [G, 1, out]
    scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w32 / scale), -7, 7).to(torch.int8).reshape(in_dim, out)
    # byte i = (row 2i+1) << 4 | (row 2i) & 0xF: a contiguous slice of the
    # packed in-axis is a contiguous slice of the logical one.
    packed = (q[1::2] << 4) | (q[0::2] & 0x0F)
    return Quant4Weight(packed, scale[:, 0, :])


def quantize4_weight(w: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE) -> Quant4Weight:
    """Group-wise symmetric int4 quantization of [..., in, out]."""
    in_dim = w.shape[-2]
    if in_dim % 2:
        raise ValueError(f"int4 packing needs an even in dim, got {in_dim}")
    gs = _group_size_for(in_dim, group_size)
    return _per_layer(lambda m: _quantize4_2d(m, gs), w, Quant4Weight)


def weight_out_dim(w) -> int:
    """Output dim of a linear weight, plain or quantized."""
    return w.w.shape[-1] if isinstance(w, QUANT_TYPES) else w.shape[-1]


def qmat(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a plain tensor, a QuantWeight or a Quant4Weight. The
    int8 product converts the weight at every call; inside a CUDA graph
    capture the converted copy comes from the graph's pool, so the largest
    one (lm_head's) sets the pool's size."""
    if isinstance(w, QuantWeight):
        scale = w.scale.reshape(*w.scale.shape[:-2], w.scale.shape[-1])
        return (x @ w.w.to(x.dtype)) * scale.to(x.dtype)
    if isinstance(w, Quant4Weight):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()  # a copy only for a strided view
        y = int4_matmul(x2, w.w, w.scale)
        return y.reshape(*lead, y.shape[-1])
    return x @ w


# Linear layer weights to quantize (the embedding is a gather and the norms
# are not products; both stay full precision; so do the MoE router and the
# shared expert's gate). The fused projections quantize like their parts:
# scales are per output column, so quantization commutes with the
# output-axis concatenation of ops/fuse.py.
_QUANT_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                     "sh_gate", "sh_up", "sh_down", "wqkv", "w_gu", "sh_gu")
# MoE expert stacks: int8 under both modes.
_MOE_EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def _quantize_one(w: torch.Tensor, mode: str):
    return quantize4_weight(w) if mode == "int4" else quantize_weight(w)


def tree_quantization(params: dict) -> str | None:
    """The quantization mode a param tree already carries, or None."""
    kinds = set()

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, QUANT_TYPES):
            kinds.add(type(node))

    walk(params)
    if Quant4Weight in kinds:
        return "int4"
    if QuantWeight in kinds:
        return "int8"
    return None


def quantize_layer_tree(layers: dict, mode: str = "int8") -> dict:
    """Quantize a stacked-layer tree (every linear weight, layer by layer)."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown quantize mode {mode!r}")
    if tree_quantization(layers):
        raise ValueError(
            f"layer tree is already quantized ({tree_quantization(layers)}); re-quantizing "
            "would corrupt it"
        )
    moe = "router" in layers
    out = {}
    for k, v in layers.items():
        if k not in _QUANT_LAYER_KEYS:
            out[k] = v
        elif moe and k in _MOE_EXPERT_KEYS:
            out[k] = quantize_weight(v)
        else:
            out[k] = _quantize_one(v, mode)
    return out


def quantize_params(params: dict, mode: str = "int8") -> dict:
    """Quantize every linear weight of a model param tree (int8 or int4).

    Layer weights keep their stacked [n_layers, in, out] layout; lm_head is
    quantized when present (untied); the embedding and norms stay full
    precision. The caller drops the full-precision tree to free it."""
    out = dict(params)
    out["layers"] = quantize_layer_tree(params["layers"], mode)
    if "lm_head" in params:
        out["lm_head"] = _quantize_one(params["lm_head"], mode)
    return out


def dequantize_weight(qw, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The full-precision weight (tests and debugging only)."""
    if isinstance(qw, Quant4Weight):
        lo, hi = unpack4(qw.w, torch.float32)
        lead, out = qw.w.shape[:-2], qw.w.shape[-1]
        in_dim = qw.in_dim
        full = torch.stack([lo, hi], dim=-2).reshape(*lead, in_dim, out)
        groups = qw.scale.shape[-2]
        full = full.reshape(*lead, groups, in_dim // groups, out) * qw.scale[..., :, None, :]
        return full.reshape(*lead, in_dim, out).to(dtype)
    return (qw.w.to(torch.float32) * qw.scale).to(dtype)


def quantized_bytes(params) -> int:
    """Total parameter bytes under the current representation."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, QUANT_TYPES):
        return quantized_bytes(params.w) + quantized_bytes(params.scale)
    return params.numel() * params.element_size()
