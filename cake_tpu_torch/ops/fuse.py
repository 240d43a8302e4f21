"""Prep-time weight fusion (port of ``cake_tpu/ops/fuse.py``): the q/k/v
projections become one ``wqkv`` [in, (n_q + 2*n_kv) * hd] and gate/up one
``w_gu`` [in, 2*inter], concatenated along the output axis, so a layer runs
one large product where it ran three and two. Each output column is the same
dot product as before, so numerics do not change; quantized projections
fuse their weights and scales alike (ops/quant.py). MoE layer trees fuse the
attention projections and the Qwen2-MoE shared expert's gate|up into
``sh_gu``; the expert stacks keep their [E, in, out] layout for the
dispatch of ops/moe.py. Single-device only (the tensor-parallel
shard-major order waits for the distributed slice).

Fusing a tree in memory holds the fused and the unfused projections at once
until the caller drops the unfused tree; ``io/safetensors_io.load_params``
fuses while it reads a checkpoint instead, so loaded weights never are.

It also holds the grammar of the decode op fusions (``--fusion``,
``LlamaConfig.fusion_impl``, ``ServeConfig.fusion_impl``): three hand-written
kernels that each replace a run of small ops on the decode path:

  "norm"    ops/fused_norm_matmul.py: RMSNorm folded into the projection it
            feeds (input norm -> wqkv, post-attention norm -> w_gu, final
            norm -> lm_head).
  "ingest"  ops/fused_ingest.py: head split + RoPE on q/k + the one-slot
            K/V write, dense or through the block table (engine decode).
  "tail"    ops/fused_sample_tail.py: repeat penalty + temperature + top-k
            + the gumbel-argmax draw in one pass over the vocab.
"""

from __future__ import annotations

import torch

from cake_tpu_torch.ops.quant import QUANT_TYPES

FUSED_QKV = "wqkv"
FUSED_QKV_BIAS = "bqkv"
FUSED_GU = "w_gu"
FUSED_SHARED_GU = "sh_gu"

FUSION_NAMES = ("norm", "ingest", "tail")


def parse_fusion_spec(spec: str) -> frozenset:
    """Parse a fusion spec -> the set of enabled fusions.

    Grammar: ``none`` | ``all`` | a comma list drawn from {norm, ingest,
    tail}. Examples: ``all``, ``norm,tail``. The JAX package's ``@impl``
    suffix has no counterpart: each fused wrapper launches its CUDA kernel
    for a CUDA tensor and runs its plain version for a CPU one, so a spec
    carrying one is refused with the port's spelling."""
    spec = (spec or "none").strip()
    if "@" in spec:
        names, impl = spec.split("@", 1)
        raise ValueError(
            f"fusion spec {spec!r}: the port takes no '@{impl}' suffix (the fused wrappers pick "
            f"the CUDA kernel or the plain version by the tensor's device); write "
            f"{names.strip() or 'none'!r}"
        )
    if spec == "none":
        return frozenset()
    if spec == "all":
        return frozenset(FUSION_NAMES)
    names = [n.strip() for n in spec.split(",") if n.strip()]
    for n in names:
        if n not in FUSION_NAMES:
            raise ValueError(
                f"unknown fusion {n!r} (expected 'none', 'all', or a comma "
                f"list from {'/'.join(FUSION_NAMES)})"
            )
    if not names:
        raise ValueError(f"empty fusion spec {spec!r}")
    return frozenset(names)


def resolve_fusion(config) -> frozenset:
    """The enabled fusions of a config, resolved once per dispatch and
    handed down to every site."""
    return parse_fusion_spec(getattr(config, "fusion_impl", "none"))


def concat_out(ws: list):
    """Concatenate along the output (last) axis. Quantized leaves fuse
    component by component: the integer weight and its scales ([..., 1, out]
    int8, [..., G, out] int4) carry the same columns, so fusing quantized
    parts gives the bits of quantizing the fused weight."""
    if isinstance(ws[0], QUANT_TYPES):
        return type(ws[0])(
            torch.cat([w.w for w in ws], dim=-1), torch.cat([w.scale for w in ws], dim=-1)
        )
    return torch.cat(ws, dim=-1)


def fuse_layer_tree(layers: dict) -> dict:
    """Fuse a stacked layer tree ([n_layers, ...] leaves). Idempotent."""
    if FUSED_QKV in layers:
        return layers
    out = dict(layers)
    if "wq" in out:
        out[FUSED_QKV] = concat_out([out.pop("wq"), out.pop("wk"), out.pop("wv")])
        if "bq" in out:
            out[FUSED_QKV_BIAS] = concat_out([out.pop("bq"), out.pop("bk"), out.pop("bv")])
    if "router" in out:
        if "sh_gate" in out:
            out[FUSED_SHARED_GU] = concat_out([out.pop("sh_gate"), out.pop("sh_up")])
    elif "w_gate" in out:
        out[FUSED_GU] = concat_out([out.pop("w_gate"), out.pop("w_up")])
    return out


def fuse_params(params: dict) -> dict:
    """Fuse a full param tree (embed / ln_f / lm_head untouched)."""
    out = dict(params)
    out["layers"] = fuse_layer_tree(params["layers"])
    return out
