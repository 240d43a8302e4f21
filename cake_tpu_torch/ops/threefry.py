"""Threefry keys and draws: the JAX package's random stream, in the port.

The JAX package samples with ``jax.random``: threefry2x32-20 keys, split
once a step, and ``categorical``'s gumbel noise. Its jax keeps the
partitionable layout (``jax_threefry_partitionable``, the default since jax
0.5). This module gives the port the same keys, bits and uniforms, so a
seeded sampled stream of the port is the JAX package's stream.

A key is a ``[2]`` int64 tensor holding two uint32 words; ``[b, 2]`` holds
b keys. torch has no uint32 arithmetic on the CPU (``+``, ``<<``, ``>>``
refuse it), so the plain functions work in int64 and mask with
``0xFFFFFFFF``.

- ``prng_key(seed)`` is ``jax.random.PRNGKey(seed)`` without x64:
  ``[0, seed mod 2**32]``.
- ``split(key)`` is ``jax.random.split``: the next key is
  ``threefry2x32(key, (0, 0))``, the subkey ``threefry2x32(key, (0, 1))``.
  Over ``[b, 2]`` keys it is ``vmap(split)``.
- ``random_bits(key, shape)``: element i of the row-major flat index takes
  the counter pair ``(i >> 32, i & 0xFFFFFFFF)`` and is ``b1 ^ b2`` of its
  threefry pair. A ``[b, 2]`` key draws ``shape`` for each key (``vmap``),
  so a shared key over ``[b, n]`` counts over ``b * n`` and per-row keys
  count over ``n`` from 0 in each row; at b = 1 the two agree.
- ``uniform`` is ``jax.random.uniform(minval=tiny, maxval=1)``, the one
  ``gumbel`` draws: ``f = bitcast((bits >> 9) | 0x3F800000) - 1``, then
  ``max(tiny, f * (1 - tiny) + tiny)``, which in f32 is ``f``, or ``tiny``
  where ``f`` is 0. So ``u`` lies in ``[tiny, 1 - 2**-23]`` and the noise
  ``-log(-log(u))`` is finite everywhere.

Keys, bits and uniforms equal jax's bitwise. The gumbel plane differs from
jax's on the CPU by the last bit of some ``log`` values (XLA's and torch's
``log`` round differently, up to ~1e-6).

:func:`threefry_noise` draws a step's noise. For CPU tensors it runs
:func:`threefry_noise_plain`, these functions composed; for CUDA tensors it
launches ``ops/csrc/threefry.cu`` or raises. The kernel replaces no Pallas
kernel: the JAX package draws this noise with XLA, outside its kernels. It
was added because the draw, as plain torch ops, is ~170 ops over an int64
plane a step (~3 GB of traffic at b = 8 over Llama-3's 128256 ids, and as
many graph nodes), where one launch reads the key from device memory and
writes the f32 plane once: its bound is the plane's bytes, 4.1 MB at b = 8
(1.2 us at 3.35 TB/s), beside ~80 32-bit integer operations an element.
The design: one thread an element, the block's key (split from the carried
key by its first thread, when asked) in shared memory, so each element
costs one threefry; the split's next and sub keys go to fresh buffers, so a
launch never writes the key it reads (a CUDA graph replays it safely).
"""

from __future__ import annotations

import ctypes
import math

import torch

from cake_tpu_torch.ops import _build
from cake_tpu_torch.ops.launches import count

M32 = 0xFFFFFFFF
TINY = torch.finfo(torch.float32).tiny
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
KINDS = {"gumbel": 0, "uniform": 1, "bits": 2}  # csrc/threefry.cu's output kinds


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds over int64 tensors holding uint32 values
    (broadcast against each other): the pair ``(y1, y2)`` of counter
    ``(x1, x2)`` under key ``(k1, k2)``."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    y1 = (x1 + ks[0]) & M32
    y2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            y1 = (y1 + y2) & M32
            y2 = _rotl(y2, r) ^ y1
        y1 = (y1 + ks[(i + 1) % 3]) & M32
        y2 = (y2 + ks[(i + 2) % 3] + i + 1) & M32
    return y1, y2


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``[2]`` from an int, ``[b, 2]`` from a
    sequence of ints, each ``[0, seed mod 2**32]``."""
    many = not isinstance(seed, int)
    low = torch.tensor([int(s) & M32 for s in seed] if many else [int(seed) & M32],
                       dtype=torch.int64)
    keys = torch.stack([torch.zeros_like(low), low], dim=1).to(device)
    return keys if many else keys[0]


def split(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(next keys, subkeys) of ``[2]`` or ``[b, 2]`` keys."""
    _check_keys(keys)
    k1, k2 = keys[..., 0], keys[..., 1]
    zero = torch.zeros_like(k1)
    nxt = torch.stack(threefry2x32(k1, k2, zero, zero), dim=-1)
    sub = torch.stack(threefry2x32(k1, k2, zero, zero + 1), dim=-1)
    return nxt, sub


def random_bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """uint32 bits (in int64) of ``jax.random.bits(key, shape)`` for each
    key: ``keys.shape[:-1] + shape``."""
    _check_keys(keys)
    shape = tuple(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=keys.device)
    k1, k2 = keys[..., 0, None], keys[..., 1, None]
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & M32)
    return (y1 ^ y2).reshape(*keys.shape[:-1], *shape)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """jax's f32 uniform over ``[tiny, 1)`` from uint32 bits (in int64)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # jax: max(tiny, f * (1 - tiny) + tiny); 1 - tiny rounds to 1 in f32.
    return torch.clamp_min(f + TINY, TINY)


def uniform(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=tiny, maxval=1.)`` for each key."""
    return uniform_from_bits(random_bits(keys, shape))


def gumbel(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (f32, mode "low") for each key."""
    return -torch.log(-torch.log(uniform(keys, shape)))


def _check_keys(keys: torch.Tensor) -> None:
    if keys.dtype != torch.int64 or keys.dim() not in (1, 2) or keys.shape[-1] != 2:
        raise ValueError(f"threefry: keys must be [2] or [b, 2] int64, got "
                         f"{tuple(keys.shape)} {keys.dtype}")


_DRAWS = {"gumbel": gumbel, "uniform": uniform, "bits": random_bits}


def threefry_noise_plain(keys, shape, *, split_keys=True, kind="gumbel"):
    """Plain PyTorch version of :func:`threefry_noise`."""
    count(threefry_noise_plain)
    nxt, sub = split(keys) if split_keys else (None, keys)
    return nxt, sub, _DRAWS[kind](sub, shape)


threefry_noise_plain.launches = 0


def threefry_noise(keys: torch.Tensor, shape, *, split_keys: bool = True, kind: str = "gumbel"):
    """One draw for each key: (next keys, the keys drawn with, the plane).

    Args:
      keys: ``[2]`` int64 (one key, the plane counted over its whole
        ``shape``) or ``[b, 2]`` (a key a row, each drawing ``shape``).
      shape: the draw of each key.
      split_keys: split first and draw with the subkey (next is the carried
        key); else draw with ``keys`` themselves (next is None).
      kind: "gumbel" (f32), "uniform" (f32) or "bits" (uint32 in int64).

    The plane is ``keys.shape[:-1] + shape``."""
    if kind not in KINDS:
        raise ValueError(f"threefry_noise: unknown kind {kind!r}")
    _check_keys(keys)
    shape = tuple(int(d) for d in shape)
    if keys.device.type == "cpu":
        return threefry_noise_plain(keys, shape, split_keys=split_keys, kind=kind)
    if keys.device.type != "cuda":
        raise ValueError(f"threefry_noise: unsupported device {keys.device}")
    if not keys.is_contiguous():
        raise ValueError("threefry_noise: keys must be contiguous")
    per_row = keys.dim() == 2
    rows, n = (keys.shape[0] if per_row else 1), math.prod(shape)
    if rows > 65535:
        raise ValueError(f"threefry_noise: {rows} keys, more than a grid's 65535 rows")
    dtype = torch.int32 if kind == "bits" else torch.float32
    out = torch.empty((*keys.shape[:-1], *shape), dtype=dtype, device=keys.device)
    nxt = torch.empty_like(keys) if split_keys else None
    sub = torch.empty_like(keys) if split_keys else keys
    if rows:
        err = _build.library().cake_threefry_noise(
            keys.data_ptr(), None if nxt is None else nxt.data_ptr(),
            sub.data_ptr() if split_keys else None, out.data_ptr(),
            rows, n, int(per_row), KINDS[kind],
            ctypes.c_void_p(torch.cuda.current_stream(keys.device).cuda_stream),
        )
        _build.check(err, "threefry_noise")
        count(threefry_noise)
    if kind == "bits":
        out = out.to(torch.int64) & M32
    return nxt, sub, out


threefry_noise.launches = 0
