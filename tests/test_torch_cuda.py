"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips, with its reason, where no CUDA device is present. On a machine with
the GPU (and nvcc, which builds the kernels at first use):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets up JAX, which this file does
not use and a GPU machine need not have.)

Where ``chip_smoke.py`` checks the kernels at Llama-3-8B shapes in bf16,
these cover every dtype, head_dim and GQA group size the kernels take.
Tolerances are max-abs against the plain version on the same inputs: f32
within 1e-4 (fast ``__expf`` and another summation order), f16 within 1e-2
and bf16 within 4e-2 (one ulp of an output up to 8 in magnitude; the kernels
round the softmax numerator before normalizing, the plain versions after).
"""

import pytest
import torch

from cake_tpu_torch.ops.chunk_prefill import (
    chunk_prefill_attention,
    chunk_prefill_attention_plain,
)
from cake_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from cake_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.float16: 1e-2, torch.bfloat16: 4e-2}
DTYPES = list(TOL)
HEAD_DIMS = [64, 128, 256]
GROUPS = [1, 3, 8]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _randn(gen, dev, dtype, *shape):
    return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)


def _assert_close(out, ref, dtype):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], f"max-abs {err} > {TOL[dtype]}"


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_decode_kernel_matches_plain(dev, dtype, hd, group):
    gen = torch.Generator(device=dev).manual_seed(hd + group)
    b, n_kv, max_seq = 3, 2, 384
    q = _randn(gen, dev, dtype, b, 1, n_kv * group, hd)
    k = _randn(gen, dev, dtype, b, n_kv, max_seq, hd)
    v = _randn(gen, dev, dtype, b, n_kv, max_seq, hd)
    lengths = torch.tensor([1, 200, 384], dtype=torch.int32, device=dev)
    starts = torch.tensor([0, 50, 0], dtype=torch.int32, device=dev)
    for kw in ({}, {"window": 64, "softcap": 30.0, "scale": 0.2}):
        before = decode_attention.launches
        out = decode_attention(q, k, v, lengths, starts, **kw)
        assert decode_attention.launches == before + 1
        _assert_close(out, decode_attention_plain(q, k, v, lengths, starts, **kw), dtype)


def test_decode_window_flag_gates_the_window(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _randn(gen, dev, torch.bfloat16, 2, 1, 8, 128)
    k = _randn(gen, dev, torch.bfloat16, 2, 2, 256, 128)
    v = _randn(gen, dev, torch.bfloat16, 2, 2, 256, 128)
    lengths = torch.tensor([256, 100], dtype=torch.int32, device=dev)
    outs = []
    for flag in (True, False):
        f = torch.tensor(flag, device=dev)
        out = decode_attention(q, k, v, lengths, None, f, window=32)
        _assert_close(out, decode_attention_plain(q, k, v, lengths, None, f, window=32),
                      torch.bfloat16)
        outs.append(out)
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_chunk_kernel_matches_plain(dev, dtype, hd, group):
    gen = torch.Generator(device=dev).manual_seed(hd * group)
    b, n_kv, max_seq, chunk = 2, 2, 384, 70
    q = _randn(gen, dev, dtype, b, chunk, n_kv * group, hd)
    k = _randn(gen, dev, dtype, b, n_kv, max_seq, hd)
    v = _randn(gen, dev, dtype, b, n_kv, max_seq, hd)
    q_starts = torch.tensor([0, 100], dtype=torch.int32, device=dev)
    lengths = q_starts + chunk
    k_starts = torch.tensor([0, 30], dtype=torch.int32, device=dev)
    flag = torch.tensor(True, device=dev)
    for args, kw in (
        ((None, None), {}),
        ((None, k_starts), {}),
        ((flag, k_starts), {"window": 48, "softcap": 25.0}),
    ):
        before = chunk_prefill_attention.launches
        out = chunk_prefill_attention(q, k, v, q_starts, lengths, *args, **kw)
        assert chunk_prefill_attention.launches == before + 1
        ref = chunk_prefill_attention_plain(q, k, v, q_starts, lengths, *args, **kw)
        _assert_close(out, ref, dtype)


def test_chunk_fully_padded_rows_are_exact_zeros(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    q = _randn(gen, dev, torch.bfloat16, 1, 64, 8, 128)
    k = _randn(gen, dev, torch.bfloat16, 1, 2, 128, 128)
    v = _randn(gen, dev, torch.bfloat16, 1, 2, 128, 128)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    lengths = torch.full((1,), 64, dtype=torch.int32, device=dev)
    pads = torch.full((1,), 40, dtype=torch.int32, device=dev)
    out = chunk_prefill_attention(q, k, v, zero, lengths, None, pads)
    torch.cuda.synchronize()
    assert torch.equal(out[:, :40], torch.zeros_like(out[:, :40]))
    _assert_close(out, chunk_prefill_attention_plain(q, k, v, zero, lengths, None, pads),
                  torch.bfloat16)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_flash_kernel_reads_strided_projections(dev, dtype, hd):
    """The position-0 prefill reads q/k/v as views of one fused projection
    output, through strides, and matches the plain version."""
    gen = torch.Generator(device=dev).manual_seed(hd)
    s, n_q, n_kv = 100, 6, 2
    qkv = _randn(gen, dev, dtype, 2, s, (n_q + 2 * n_kv) * hd)
    q = qkv[..., : n_q * hd].reshape(2, s, n_q, hd)
    k = qkv[..., n_q * hd : (n_q + n_kv) * hd].reshape(2, s, n_kv, hd)
    v = qkv[..., (n_q + n_kv) * hd :].reshape(2, s, n_kv, hd)
    assert not v.is_contiguous()
    before = chunk_prefill_attention.launches
    out = flash_attention(q, k, v, window=40)
    assert chunk_prefill_attention.launches == before + 1
    _assert_close(out, flash_attention_plain(q, k, v, window=40), dtype)


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros(1, 1, 8, 128, device=dev, dtype=torch.bfloat16)
    cache = torch.zeros(1, 2, 128, 128, device=dev, dtype=torch.bfloat16)
    lengths = torch.ones(1, dtype=torch.int32, device=dev)
    f8 = cache.to(torch.float8_e4m3fn)
    with pytest.raises(NotImplementedError, match="f8"):
        decode_attention(q, f8, f8, lengths)
    with pytest.raises(NotImplementedError, match="f8"):
        chunk_prefill_attention(q, f8, f8, lengths - 1, lengths)
    with pytest.raises(ValueError):
        decode_attention(q, cache.transpose(2, 3), cache, lengths)  # not contiguous
    with pytest.raises(ValueError):
        decode_attention(q.float(), cache, cache, lengths)  # mixed dtypes
    with pytest.raises(ValueError):
        decode_attention(torch.zeros(1, 1, 18, 128, device=dev, dtype=torch.bfloat16),
                         cache, cache, lengths)  # group 9 > 8
    with pytest.raises(ValueError):
        decode_attention(q[..., :96].contiguous(), cache[..., :96].contiguous(),
                         cache[..., :96].contiguous(), lengths)  # head_dim 96
