"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips, with its reason, where no CUDA device is present. On a machine with
the GPU (and nvcc, which builds the kernels at first use):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets up JAX, which this file does
not use and a GPU machine need not have.)

Where ``chip_smoke.py`` checks the kernels at Llama-3-8B shapes in bf16,
these cover every dtype, head_dim and GQA group size the kernels take. The
paged kernels share their bodies with the dense ones, so on the same keys
they must give the dense kernels' bits exactly.
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
from cake_tpu_torch.models.llama.paged_cache import gather_pages
from cake_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
)
from cake_tpu_torch.ops.paged_prefill import (
    paged_chunk_attention,
    paged_chunk_attention_plain,
)

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


# ------------------------------------------------------------- paged kernels

PAGE = 128


def _pool(gen, dev, dtype, n_pages, n_kv, hd):
    """A pool of ``n_pages`` pages plus the write sink, random contents."""
    k = _randn(gen, dev, dtype, n_pages + 1, n_kv, PAGE, hd)
    v = _randn(gen, dev, dtype, n_pages + 1, n_kv, PAGE, hd)
    return k, v


def _tables(dev, rows: list[list[int]], n_p: int):
    """Block tables [b, n_p] int32, rows padded with -1 (unmapped)."""
    t = torch.full((len(rows), n_p), -1, dtype=torch.int32)
    for r, pages in enumerate(rows):
        t[r, : len(pages)] = torch.tensor(pages, dtype=torch.int32)
    return t.to(dev)


# Shuffled physical pages; row 1's third entry is unmapped past its live range.
_ROWS = [[7, 2, 9, 4], [5, 0, -1, -1], [1, 8, 3, 6]]
_LENGTHS = [450, 200, 512]  # mid-page ends
_STARTS = [0, 70, 300]  # left pads, mid-page


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_paged_decode_kernel_matches_plain_and_dense(dev, dtype, hd, group):
    gen = torch.Generator(device=dev).manual_seed(hd + 7 * group)
    n_kv = 2
    k, v = _pool(gen, dev, dtype, 10, n_kv, hd)
    tables = _tables(dev, _ROWS, 4)
    q = _randn(gen, dev, dtype, 3, 1, n_kv * group, hd)
    lengths = torch.tensor(_LENGTHS, dtype=torch.int32, device=dev)
    starts = torch.tensor(_STARTS, dtype=torch.int32, device=dev)
    k_dense = gather_pages(k, tables).contiguous()
    v_dense = gather_pages(v, tables).contiguous()
    for kw in ({}, {"window": 100, "softcap": 30.0, "scale": 0.2}):
        before = paged_decode_attention.launches
        out = paged_decode_attention(q, k, v, lengths, tables, starts, **kw)
        assert paged_decode_attention.launches == before + 1
        ref = paged_decode_attention_plain(q, k, v, lengths, tables, starts, **kw)
        _assert_close(out, ref, dtype)
        dense = decode_attention(q, k_dense, v_dense, lengths, starts, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, dense), "paged decode must give the dense kernel's bits"


def test_paged_decode_reads_a_sliced_table(dev):
    """The engine slices the table to the epoch capacity: a strided view
    reads the same keys as its contiguous copy, never past ``n_p``."""
    gen = torch.Generator(device=dev).manual_seed(3)
    k, v = _pool(gen, dev, torch.bfloat16, 10, 8, 128)
    wide = _tables(dev, _ROWS, 16)
    wide[:, 4:] = 9  # columns past the slice must never be read
    view = wide[:, :4]
    assert not view.is_contiguous()
    q = _randn(gen, dev, torch.bfloat16, 3, 1, 32, 128)
    lengths = torch.tensor(_LENGTHS, dtype=torch.int32, device=dev)
    out = paged_decode_attention(q, k, v, lengths, view)
    ref = paged_decode_attention(q, k, v, lengths, view.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_paged_chunk_kernel_matches_plain_and_dense(dev, dtype, hd, group):
    gen = torch.Generator(device=dev).manual_seed(hd * 5 + group)
    n_kv, chunk = 2, 96
    k, v = _pool(gen, dev, dtype, 10, n_kv, hd)
    tables = _tables(dev, _ROWS, 4)
    q = _randn(gen, dev, dtype, 3, chunk, n_kv * group, hd)
    k_dense = gather_pages(k, tables).contiguous()
    v_dense = gather_pages(v, tables).contiguous()
    pads = torch.tensor(_STARTS, dtype=torch.int32, device=dev)
    flag = torch.tensor(True, device=dev)
    shapes = {
        # cold prefill: queries from slot 0, keys from each row's pad
        "cold": (torch.zeros(3, dtype=torch.int32, device=dev), pads, None, {}),
        # warm suffix: queries at the window start over the cached prefix
        "suffix": (torch.tensor([300, 100, 400], dtype=torch.int32, device=dev), pads, None, {}),
        "window": (torch.tensor([300, 100, 400], dtype=torch.int32, device=dev), pads, flag,
                   {"window": 80, "softcap": 25.0}),
    }
    for name, (q_starts, k_starts, wflag, kw) in shapes.items():
        lengths = q_starts + chunk
        before = paged_chunk_attention.launches
        out = paged_chunk_attention(q, k, v, q_starts, lengths, k_starts, tables, wflag, **kw)
        assert paged_chunk_attention.launches == before + 1
        ref = paged_chunk_attention_plain(
            q, k, v, q_starts, lengths, k_starts, tables, wflag, **kw
        )
        _assert_close(out, ref, dtype)
        dense = chunk_prefill_attention(
            q, k_dense, v_dense, q_starts, lengths, wflag, k_starts, **kw
        )
        torch.cuda.synchronize()
        assert torch.equal(out, dense), f"{name}: paged chunk must give the dense kernel's bits"


def test_paged_chunk_dead_query_tiles_write_zeros(dev):
    """Rows below their pad see no key: a whole 32-query tile of them must
    still come out as exact zeros (no stale memory reaches later layers)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    k, v = _pool(gen, dev, torch.bfloat16, 4, 2, 128)
    tables = _tables(dev, [[3, 1]], 2)
    q = _randn(gen, dev, torch.bfloat16, 1, 128, 8, 128)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    lengths = torch.full((1,), 128, dtype=torch.int32, device=dev)
    pads = torch.full((1,), 70, dtype=torch.int32, device=dev)
    out = paged_chunk_attention(q, k, v, zero, lengths, pads, tables)
    torch.cuda.synchronize()
    assert torch.equal(out[:, :70], torch.zeros_like(out[:, :70]))
    ref = paged_chunk_attention_plain(q, k, v, zero, lengths, pads, tables)
    _assert_close(out, ref, torch.bfloat16)


def test_paged_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros(1, 1, 8, 128, device=dev, dtype=torch.bfloat16)
    pool = torch.zeros(3, 2, PAGE, 128, device=dev, dtype=torch.bfloat16)
    tables = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    lengths = torch.ones(1, dtype=torch.int32, device=dev)
    f8 = pool.to(torch.float8_e4m3fn)
    with pytest.raises(NotImplementedError, match="f8"):
        paged_decode_attention(q, f8, f8, lengths, tables)
    with pytest.raises(NotImplementedError, match="f8"):
        paged_chunk_attention(q, f8, f8, lengths - 1, lengths, None, tables)
    small = pool[:, :, :64].contiguous()
    with pytest.raises(ValueError, match="page_size"):
        paged_decode_attention(q, small, small, lengths, tables)  # page 64: no quiet fallback
    with pytest.raises(ValueError, match="page_size"):
        paged_chunk_attention(q, small, small, lengths - 1, lengths, None, tables)
    with pytest.raises(ValueError):
        paged_decode_attention(q, pool, pool, lengths, tables.long())  # int64 table


def test_engine_on_the_card_serves_through_the_paged_kernels(dev):
    """The batch engine at a small width on the card: paged (prefix cache
    on) and dense give the same greedy streams, and the paged run goes
    through the paged kernels, never their plain versions."""
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.chat import Message
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import SamplingConfig
    from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.float32, dev)
    greedy = SamplingConfig(temperature=0.0, repeat_penalty=1.0)
    prompts = [[Message.system("a shared system prompt " * 8), Message.user(f"question {i}")]
               for i in range(3)]
    streams = {}
    for mode, kw in (("dense", {}), ("paged", {"kv_mode": "paged", "prefix_cache": True})):
        eng = BatchEngine(cfg, params, ByteTokenizer(), max_seq_len=512,
                          cache_dtype=torch.float32, serve=ServeConfig(max_batch=4, **kw),
                          device=dev)
        eng.start()
        try:
            plain0 = paged_decode_attention_plain.launches + paged_chunk_attention_plain.launches
            kern0 = paged_decode_attention.launches, paged_chunk_attention.launches
            streams[mode] = []
            for m in prompts:  # one epoch each: the later ones hit the first one's chain
                streams[mode].append([t.id for t in eng.submit(m, 12, greedy).tokens()])
                assert eng.wait_idle(60)
        finally:
            eng.stop()
        if mode == "paged":
            assert eng.stats["prefix_hits"] >= 1  # prompts 2 and 3 reuse prompt 1's chain
            assert paged_decode_attention.launches > kern0[0]
            assert paged_chunk_attention.launches > kern0[1]
            assert (paged_decode_attention_plain.launches
                    + paged_chunk_attention_plain.launches) == plain0
    assert streams["paged"][0] == streams["dense"][0]  # the cold stream: same shapes, same bits
    assert all(len(s) == 12 for s in streams["paged"])


def test_paged_backend_refuses_a_page_the_kernels_do_not_take(dev):
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.runtime.batch_backend import PagedLocalBackend

    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4, num_key_value_heads=2)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    with pytest.raises(ValueError, match="page_size"):
        PagedLocalBackend(cfg, params, max_seq_len=256, cache_dtype=torch.float32,
                          page_size=64, device=dev)
