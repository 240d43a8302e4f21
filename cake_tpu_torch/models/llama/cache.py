"""Preallocated dense KV cache (port of ``cake_tpu/models/llama/cache.py``).

Layout [n_layers, batch, n_kv_heads, max_seq, head_dim], head-major: each KV
head's sequence is contiguous, which is what the decode and chunked-prefill
kernels stream. Unlike the JAX package, whose arrays are immutable and whose
cache is donated back to each step, the port writes the cache IN PLACE: a
step's K/V land in the preallocated tensors with a slice assignment (a
prefill at a host offset) or an ``index_copy_`` (a decode step at a device
slot), and nothing is copied or reallocated per token. A cache of another
dtype than the activations (``--kv-dtype``) takes each chunk through
``ops/kv_dtype.narrow``, the JAX package's ``astype`` (NaN past f8's range,
not torch's saturation); an f8 cache is written through its byte view
(``kv_view``), since ``index_copy_`` has no Float8 kernel.

The rolling window cache (``write_layer_rolling``, ``rolling_kv_positions``)
serves single-window models: the cache holds the last ``window + chunk
budget`` positions, position p in slot ``p % L`` (L, the ring's length, a
multiple of SEQ_MULTIPLE), and the attention kernels read it through their
ring layout (ops/csrc/kv_layout.cuh ``RingLayout``); the slot arithmetic
the kernels' plain versions share lives beside ``causal_mask`` in
ops/attention.py and is re-exported here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cake_tpu_torch.ops.attention import ROLLING_DEAD, rolling_kv_positions  # noqa: F401
from cake_tpu_torch.ops.kv_dtype import kv_view, narrow


class KVCache(NamedTuple):
    """Fixed-shape KV storage for a contiguous run of layers."""

    k: torch.Tensor  # [n_layers, batch, n_kv_heads, max_seq, head_dim]
    v: torch.Tensor

    @property
    def n_layers(self) -> int:
        return self.k.shape[0]

    @property
    def batch_size(self) -> int:
        return self.k.shape[1]

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[3]


# Kept from the JAX package so both caches have the same padded length; on
# the GPU it also keeps every head's rows 16-byte aligned.
SEQ_MULTIPLE = 128


def init_cache(
    n_layers: int,
    batch: int,
    max_seq_len: int,
    n_kv_heads: int,
    head_dim: int,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cpu",
) -> KVCache:
    """Allocate a zeroed cache; the seq axis is rounded up to SEQ_MULTIPLE."""
    padded = -(-max_seq_len // SEQ_MULTIPLE) * SEQ_MULTIPLE
    shape = (n_layers, batch, n_kv_heads, padded, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def write_layer(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos: int | torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write a [batch, chunk, n_kv, hd] chunk at sequence offset ``pos`` into
    one layer's [batch, n_kv, max_seq, hd] cache, in place. Returns the same
    two tensors.

    ``pos`` is a host int (a slice assignment, bounds-checked here) or a 0-d
    int64 tensor on the cache's device, the decode step's slot: the write is
    then an ``index_copy_`` along the slot axis at the tensor's value, the
    counterpart of the JAX package's ``dynamic_update_slice`` at a traced
    start, so a captured CUDA graph writes where the tensor says at each
    replay. Its bound is the caller's to check, on the host ints it holds
    (reading the tensor back would be a sync).

    The chunk is narrowed to the cache's dtype from the dtype it comes in
    (the activations'), as the JAX package's ``astype`` narrows it."""
    chunk = k_new.shape[1]
    k_rows = kv_view(narrow(k_new.transpose(1, 2), k_cache.dtype))
    v_rows = kv_view(narrow(v_new.transpose(1, 2), v_cache.dtype))
    if isinstance(pos, torch.Tensor):
        idx = pos.reshape(1) if chunk == 1 else pos + torch.arange(chunk, device=pos.device)
        kv_view(k_cache).index_copy_(2, idx, k_rows)
        kv_view(v_cache).index_copy_(2, idx, v_rows)
        return k_cache, v_cache
    if pos < 0 or pos + chunk > k_cache.shape[2]:
        raise ValueError(
            f"cache write [{pos}, {pos + chunk}) outside [0, {k_cache.shape[2]})"
        )
    kv_view(k_cache)[:, :, pos : pos + chunk] = k_rows
    kv_view(v_cache)[:, :, pos : pos + chunk] = v_rows
    return k_cache, v_cache


# ------------------------------------------------------------- rolling cache
#
# Sliding-window models (the Mistral family) never attend past ``window``
# keys, so the cache need only hold the last ``window + chunk_budget``
# positions: position p lives in slot p % L. A chunk write can only evict
# keys already outside every live query's window, because L exceeds the
# window plus the largest chunk written in one dispatch. This bounds KV
# memory by the window, not the sequence length: a 32K-context Mistral-7B
# with window 4096 stores 4608 slots instead of 32768.


def write_layer_rolling(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos: int | torch.Tensor,
    valid_len: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write a [batch, chunk, n_kv, hd] chunk at slots ``(pos + j) % L`` for
    j < ``valid_len`` into one layer's ring [batch, n_kv, L, hd], in place;
    the padded tail (j >= valid_len) is DROPPED: in a ring a write past the
    valid tokens would evict live keys. ``pos`` is a host int or, for a
    decode step, the 0-d int64 device slot of ``write_layer``: the ring slot
    is then computed from it on the device, so a captured graph writes
    where the position says at every replay."""
    ring = k_cache.shape[2]
    chunk = k_new.shape[1]
    n = min(int(valid_len), chunk)
    if n > ring:
        raise ValueError(f"a rolling write of {n} tokens exceeds the ring's {ring} slots")
    k_rows = kv_view(narrow(k_new[:, :n].transpose(1, 2), k_cache.dtype))
    v_rows = kv_view(narrow(v_new[:, :n].transpose(1, 2), v_cache.dtype))
    if isinstance(pos, torch.Tensor):
        idx = pos.reshape(1) if n == 1 else pos + torch.arange(n, device=pos.device)
        idx = idx % ring
    else:
        idx = torch.arange(pos, pos + n, device=k_cache.device) % ring
    kv_view(k_cache).index_copy_(2, idx, k_rows)
    kv_view(v_cache).index_copy_(2, idx, v_rows)
    return k_cache, v_cache
