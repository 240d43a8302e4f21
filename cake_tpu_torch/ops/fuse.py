"""Prep-time weight fusion (port of ``cake_tpu/ops/fuse.py``): the q/k/v
projections become one ``wqkv`` [in, (n_q + 2*n_kv) * hd] and gate/up one
``w_gu`` [in, 2*inter], concatenated along the output axis, so a layer runs
one large product where it ran three and two. Each output column is the same
dot product as before, so numerics do not change. Single-device only (the
tensor-parallel shard-major order waits for the distributed slice).

Fusing a tree in memory holds the fused and the unfused projections at once
until the caller drops the unfused tree; ``io/safetensors_io.load_params``
fuses while it reads a checkpoint instead, so loaded weights never are.
"""

from __future__ import annotations

import torch

FUSED_QKV = "wqkv"
FUSED_QKV_BIAS = "bqkv"
FUSED_GU = "w_gu"


def fuse_layer_tree(layers: dict) -> dict:
    """Fuse a stacked layer tree ([n_layers, ...] leaves). Idempotent."""
    if FUSED_QKV in layers:
        return layers
    if "router" in layers:
        raise NotImplementedError(
            "MoE layer trees are not ported yet (ROADMAP.md queue A, item 9)"
        )
    out = dict(layers)
    if "wq" in out:
        out[FUSED_QKV] = torch.cat([out.pop("wq"), out.pop("wk"), out.pop("wv")], dim=-1)
        if "bq" in out:
            out[FUSED_QKV_BIAS] = torch.cat(
                [out.pop("bq"), out.pop("bk"), out.pop("bv")], dim=-1
            )
    if "w_gate" in out:
        out[FUSED_GU] = torch.cat([out.pop("w_gate"), out.pop("w_up")], dim=-1)
    return out


def fuse_params(params: dict) -> dict:
    """Fuse a full param tree (embed / ln_f / lm_head untouched)."""
    out = dict(params)
    out["layers"] = fuse_layer_tree(params["layers"])
    return out
