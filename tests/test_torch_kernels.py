"""The port's attention kernel modules against the JAX package's Pallas
kernels, run in interpret mode on the CPU.

On a CPU tensor each port wrapper runs its plain PyTorch version, so these
tests pin the arithmetic the CUDA kernels are held to on the card
(chip_smoke.py). Inputs come from numpy with a fixed seed and go through both
packages in f32; tolerance 1e-4 max-abs (XLA and torch reduce in different
orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.ops.pallas.chunk_prefill import chunk_prefill_attention as jax_chunk
from cake_tpu.ops.pallas.decode_attention import decode_attention as jax_decode
from cake_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from cake_tpu_torch.ops.chunk_prefill import (
    chunk_prefill_attention,
    chunk_prefill_attention_plain,
)
from cake_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from cake_tpu_torch.ops.flash_attention import flash_attention

ATOL = 1e-4


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "lens,starts,win,flag,scale,softcap",
    [
        ([1, 77, 256], None, None, None, None, None),       # lengths spread
        ([100, 256, 40], [0, 37, 39], None, None, None, None),  # left-pad starts
        ([100, 256, 40], None, 32, None, None, None),       # window always on
        ([100, 256, 40], [5, 0, 0], 32, True, 0.15, 20.0),  # Gemma-2 local layer
        ([100, 256, 40], None, 32, False, None, 30.0),      # Gemma-2 global layer
    ],
)
def test_decode_attention_matches_pallas(lens, starts, win, flag, scale, softcap):
    rng = np.random.default_rng(0)
    b, n_q, n_kv, d, max_seq = 3, 8, 2, 32, 256
    q = _rand(rng, b, 1, n_q, d)
    k = _rand(rng, b, n_kv, max_seq, d)
    v = _rand(rng, b, n_kv, max_seq, d)
    lengths = np.asarray(lens, np.int32)
    st = None if starts is None else np.asarray(starts, np.int32)
    ref = jax_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        None if st is None else jnp.asarray(st),
        None if flag is None else jnp.bool_(flag),
        window=win, scale=scale, softcap=softcap, interpret=True,
    )
    calls = decode_attention_plain.launches
    out = decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), None if st is None else torch.from_numpy(st),
        None if flag is None else torch.tensor(flag),
        window=win, scale=scale, softcap=softcap,
    )
    assert decode_attention_plain.launches == calls + 1  # the CPU path is the plain one
    assert decode_attention.launches == 0  # no kernel launch on the CPU
    _close(out, ref)


@pytest.mark.parametrize(
    "q_starts,k_starts,win,flag,softcap",
    [
        ([60, 10], None, None, None, None),      # continuation at q_starts > 0
        ([60, 10], [0, 7], None, None, None),    # left-padded second row
        ([60, 10], None, 24, True, 20.0),        # windowed, soft-capped
        ([60, 10], [3, 0], 24, False, None),     # window gated off
    ],
)
def test_chunk_prefill_matches_pallas(q_starts, k_starts, win, flag, softcap):
    rng = np.random.default_rng(1)
    b, n_q, n_kv, d, max_seq, chunk = 2, 8, 2, 64, 256, 48
    q = _rand(rng, b, chunk, n_q, d)
    k = _rand(rng, b, n_kv, max_seq, d)
    v = _rand(rng, b, n_kv, max_seq, d)
    qs = np.asarray(q_starts, np.int32)
    lengths = qs + chunk
    ks = None if k_starts is None else np.asarray(k_starts, np.int32)
    ref = jax_chunk(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qs), jnp.asarray(lengths),
        None if flag is None else jnp.bool_(flag), None if ks is None else jnp.asarray(ks),
        window=win, softcap=softcap, interpret=True,
    )
    out = chunk_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(qs), torch.from_numpy(lengths),
        None if flag is None else torch.tensor(flag),
        None if ks is None else torch.from_numpy(ks),
        window=win, softcap=softcap,
    )
    _close(out, ref)


def test_chunk_prefill_fully_padded_rows_are_exact_zeros():
    """Query rows that see only left-pad slots come out exactly 0, never NaN,
    as the Pallas kernel's m_safe guard makes them."""
    rng = np.random.default_rng(2)
    b, n_q, n_kv, d, max_seq, chunk = 1, 4, 2, 64, 64, 48
    q = _rand(rng, b, chunk, n_q, d)
    k = _rand(rng, b, n_kv, max_seq, d)
    v = _rand(rng, b, n_kv, max_seq, d)
    pads = np.asarray([32], np.int32)
    qs = np.zeros((b,), np.int32)
    lengths = np.asarray([chunk], np.int32)
    ref = np.asarray(jax_chunk(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qs), jnp.asarray(lengths),
        None, jnp.asarray(pads), block_q=16, block_k=16, interpret=True,
    ))
    out = chunk_prefill_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(qs), torch.from_numpy(lengths), None, torch.from_numpy(pads),
    ).numpy()
    assert np.all(np.isfinite(out))
    np.testing.assert_array_equal(out[:, :32], np.zeros_like(out[:, :32]))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "s,n_q,n_kv,win,flag,softcap",
    [
        (40, 8, 2, None, None, None),
        (33, 4, 1, 16, True, 25.0),
        (33, 4, 4, 16, False, None),
    ],
)
def test_flash_attention_matches_pallas(s, n_q, n_kv, win, flag, softcap):
    rng = np.random.default_rng(3)
    b, d = 2, 64
    q = _rand(rng, b, s, n_q, d)
    k = _rand(rng, b, s, n_kv, d)
    v = _rand(rng, b, s, n_kv, d)
    ref = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if flag is None else jnp.bool_(flag),
        window=win, softcap=softcap, interpret=True,
    )
    out = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if flag is None else torch.tensor(flag), window=win, softcap=softcap,
    )
    _close(out, ref)


def test_wrappers_reject_what_the_kernels_do_not_take():
    """Tensors on a device that is neither the CPU nor CUDA are refused, not
    silently computed elsewhere."""
    meta = torch.empty((1, 1, 4, 64), device="meta")
    cache = torch.empty((1, 2, 128, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(meta, cache, cache, torch.tensor([1]))
    with pytest.raises(ValueError, match="unsupported device"):
        chunk_prefill_attention(meta, cache, cache, torch.tensor([0]), torch.tensor([1]))
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(meta, meta, meta)
