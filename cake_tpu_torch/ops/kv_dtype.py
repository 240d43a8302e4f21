"""KV-cache storage dtypes (``--kv-dtype``): resolution, the one narrowing
cast into a cache, and the rule by which the attention kernels read a cache
of another dtype than their queries.

Port of ``cake_tpu/cli.py`` ``_resolve_kv_dtype`` and of the narrowing that
``astype`` does where the JAX package writes its cache
(``cake_tpu/models/llama/cache.py`` ``write_layer``). f8 (``float8_e4m3fn``)
storage halves the cache's bytes against bf16; the attention kernels widen
it in registers after the narrow load and compute in the query's dtype.

Two torch traps that this module keeps out of the port:

* ``Tensor.to(torch.float8_e4m3fn)`` saturates (500 -> 448), where the JAX
  package's ``astype`` (ml_dtypes) gives NaN for every magnitude that rounds
  past 448 (465 -> NaN, 464 -> 448). :func:`narrow` gives the reference's
  bits: torch's round-to-nearest-even cast, and NaN (with the input's sign)
  past :data:`F8_OVERFLOW`.
* Several in-place index ops have no Float8 kernel (``index_copy_``, and
  ``torch.equal``): in-place writes into, and gathers out of, an f8 tensor
  go through its byte view, :func:`kv_view`.
"""

from __future__ import annotations

import torch

F8 = torch.float8_e4m3fn
KV_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32, "f8": F8}
KV_DTYPE_CHOICES = ("auto", *KV_DTYPES)
# Round to nearest even puts every magnitude above this past e4m3fn's
# largest finite value (448; 464 is the tie between 448 and 480, and 448's
# mantissa is the even one).
F8_OVERFLOW = 464.0
_ATTENTION_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def resolve_kv_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    """``--kv-dtype`` name -> torch dtype; "auto" is the activation dtype."""
    if name == "auto":
        return dtype
    if name not in KV_DTYPES:
        raise ValueError(f"unknown KV dtype {name!r}; choose from {KV_DTYPE_CHOICES}")
    return KV_DTYPES[name]


def narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast into the cache dtype ``dtype``, as the JAX package's
    ``astype`` casts it: round to nearest even, and for f8 NaN past
    F8_OVERFLOW (and for a NaN or infinite input), keeping the sign. Every
    other dtype is a plain ``.to``."""
    if dtype != F8:
        return x.to(dtype)
    raw = x.to(F8).view(torch.uint8)  # saturates: sign | 0x7E past 448, NaN stays NaN
    # sign | 0x7F is NaN; bf16, f16 and f32 all hold 464 exactly.
    return torch.where(x.abs() > F8_OVERFLOW, raw | 0x7F, raw).view(F8)


def kv_view(t: torch.Tensor) -> torch.Tensor:
    """The tensor in-place index writes and gathers go through: an f8
    tensor's byte view (the same storage), any other tensor itself."""
    return t.view(torch.uint8) if t.dtype == F8 else t


def attention_dtype(name: str, q_dtype: torch.dtype, k_dtype: torch.dtype,
                    v_dtype: torch.dtype) -> torch.dtype:
    """The dtype an attention kernel runs its queries in over a K/V cache of
    ``k_dtype``: ``widen_qkv``'s rule (ops/attention.py). K/V of q's dtype
    or f8 (widened exactly in registers): q's dtype. A wider K/V (f32 under
    f16/bf16): the K/V dtype, the query upcast exactly, the output cast
    back to q's dtype by the caller. Raises NotImplementedError for the
    same-width cross pairs (f16 K/V under bf16 queries and the reverse) and
    ValueError for the rest (K/V that differ, a narrower 16-bit cache)."""
    if q_dtype not in _ATTENTION_DTYPES or k_dtype != v_dtype:
        raise ValueError(
            f"{name}: q/k/v dtypes {q_dtype}/{k_dtype}/{v_dtype}: q must be one of "
            f"{_ATTENTION_DTYPES} and k, v alike"
        )
    if k_dtype in (q_dtype, F8):
        return q_dtype
    if k_dtype not in _ATTENTION_DTYPES:
        raise ValueError(f"{name}: unsupported K/V dtype {k_dtype}")
    if k_dtype.itemsize > q_dtype.itemsize:
        return k_dtype
    if k_dtype.itemsize == q_dtype.itemsize:
        raise NotImplementedError(
            f"{name}: a {k_dtype} cache under {q_dtype} queries is not ported "
            "(ROADMAP.md, queue B item 1: same-width cross-dtype caches)"
        )
    raise ValueError(
        f"{name}: q/k/v dtypes {q_dtype}/{k_dtype}/{v_dtype} must match, or the cache "
        "be f8 or wider than q"
    )
