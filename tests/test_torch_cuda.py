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
from cake_tpu_torch.ops.decode_attention import SPLIT, decode_attention, decode_attention_plain
from cake_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from cake_tpu_torch.ops.kv_dtype import kv_view
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
HEAD_DIMS = [64, 96, 128, 256]
# Past 16 query heads a KV head (8 at head_dim 256) the decode kernels take
# the group in passes.
GROUPS = [1, 3, 8, 12, 16, 32]


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


# Lengths on both sides of a split edge, the generator's 733 and a full cache;
# starts at 0, on split edges and inside splits.
SPLIT_LENGTHS = [1, SPLIT - 1, SPLIT, SPLIT + 1, 733, 8192]
SPLIT_STARTS = [[0] * 6, [0, 0, 0, SPLIT, 128, 4096], [0, 1, SPLIT - 1, 1, 300, 8191]]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_decode_split_edges_match_plain(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(17)
    b, n_kv, group, hd, max_seq = len(SPLIT_LENGTHS), 8, 4, 128, 8192
    q = _randn(gen, dev, dtype, b, 1, n_kv * group, hd)
    k = _randn(gen, dev, dtype, b, n_kv, max_seq, hd)
    v = _randn(gen, dev, dtype, b, n_kv, max_seq, hd)
    lengths = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32, device=dev)
    for st in SPLIT_STARTS:
        starts = torch.tensor(st, dtype=torch.int32, device=dev)
        out = decode_attention(q, k, v, lengths, starts)
        _assert_close(out, decode_attention_plain(q, k, v, lengths, starts), dtype)


def test_decode_rows_are_independent_and_paged_equals_dense(dev):
    """Split points are key positions only: a row's bits are the same alone
    (one block a split) and in a batch of 8 whose long rows make blocks
    stride over several splits, under max_seq 2048 and 8192, paged and
    dense; and a second call gives the first one's bits (the tickets reset)."""
    gen = torch.Generator(device=dev).manual_seed(23)
    dt, n_kv, hd, n_p = torch.bfloat16, 8, 128, 16
    lens = [733, 1, 64, 65, 2000, 300, 129, 1500]
    b = len(lens)
    k = _randn(gen, dev, dt, b * n_p + 1, n_kv, PAGE, hd)
    v = _randn(gen, dev, dt, b * n_p + 1, n_kv, PAGE, hd)
    perm = torch.randperm(b * n_p, generator=torch.Generator().manual_seed(2))
    tables = perm.view(b, n_p).to(torch.int32).to(dev)
    q = _randn(gen, dev, dt, b, 1, 4 * n_kv, hd)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    starts = torch.tensor([5, 0, 0, 63, 100, 299, 64, 0], dtype=torch.int32, device=dev)
    paged = paged_decode_attention(q, k, v, lengths, tables, starts)
    _assert_close(paged, paged_decode_attention_plain(q, k, v, lengths, tables, starts), dt)
    dk, dv = gather_pages(k, tables).contiguous(), gather_pages(v, tables).contiguous()
    wk = torch.zeros(b, n_kv, 8192, hd, device=dev, dtype=dt)
    wv = torch.zeros_like(wk)
    wk[:, :, : dk.shape[2]], wv[:, :, : dv.shape[2]] = dk, dv
    outs = {
        "dense 2048": decode_attention(q, dk, dv, lengths, starts),
        "dense 8192": decode_attention(q, wk, wv, lengths, starts),
        "paged again": paged_decode_attention(q, k, v, lengths, tables, starts),
    }
    for r in range(b):
        rs = slice(r, r + 1)
        alone = paged_decode_attention(q[rs], k, v, lengths[rs], tables[rs], starts[rs])
        outs[f"row {r} alone"] = torch.cat([paged[:r], alone, paged[r + 1 :]])
        dense_alone = decode_attention(q[rs], wk[rs], wv[rs], lengths[rs], starts[rs])
        outs[f"row {r} alone, dense 8192"] = torch.cat([paged[:r], dense_alone, paged[r + 1 :]])
    torch.cuda.synchronize()
    for name, out in outs.items():
        assert torch.equal(out, paged), name


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


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_chunk_body_over_gqa_groups_dense_and_paged(dev, dtype, hd, group):
    """The chunk body over several key tiles per query block: dense against
    the plain version, with k_starts, a window gated on and a softcap, and
    the paged kernel on the same keys equal to the dense one to the bit."""
    gen = torch.Generator(device=dev).manual_seed(hd * 7 + group)
    n_kv, chunk = 2, 150
    k, v = _pool(gen, dev, dtype, 10, n_kv, hd)
    tables = _tables(dev, _ROWS, 4)
    k_dense = gather_pages(k, tables).contiguous()
    v_dense = gather_pages(v, tables).contiguous()
    q = _randn(gen, dev, dtype, 3, chunk, n_kv * group, hd)
    q_starts = torch.tensor([0, 40, 350], dtype=torch.int32, device=dev)
    lengths = torch.tensor([150, 190, 500], dtype=torch.int32, device=dev)
    pads = torch.tensor([0, 17, 300], dtype=torch.int32, device=dev)
    flag = torch.tensor(True, device=dev)
    for wflag, kw in ((None, {}), (flag, {"window": 70, "softcap": 25.0})):
        dense = chunk_prefill_attention(q, k_dense, v_dense, q_starts, lengths, wflag, pads, **kw)
        ref = chunk_prefill_attention_plain(q, k_dense, v_dense, q_starts, lengths, wflag, pads,
                                            **kw)
        _assert_close(dense, ref, dtype)
        paged = paged_chunk_attention(q, k, v, q_starts, lengths, pads, tables, wflag, **kw)
        torch.cuda.synchronize()
        assert torch.equal(paged, dense)


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_chunk_warm_suffix_gives_the_cold_prefill_bits(dev, dtype, group):
    """A query's output does not depend on which query block holds it: the
    suffix of a prompt prefilled over its cached prefix (queries from
    position s) equals, to the bit, the same queries of the cold prefill
    from position 0, with left pads and a window."""
    gen = torch.Generator(device=dev).manual_seed(group)
    n_kv, total, hd = 2, 300, 128
    k = _randn(gen, dev, dtype, 2, n_kv, 384, hd)
    v = _randn(gen, dev, dtype, 2, n_kv, 384, hd)
    q = _randn(gen, dev, dtype, 2, total, n_kv * group, hd)
    pads = torch.tensor([0, 37], dtype=torch.int32, device=dev)
    lengths = torch.full((2,), total, dtype=torch.int32, device=dev)
    flag = torch.tensor(True, device=dev)
    for wflag, kw in ((None, {}), (flag, {"window": 90})):
        cold = chunk_prefill_attention(q, k, v, torch.zeros_like(pads), lengths, wflag, pads, **kw)
        for start in (129, 200, 257):
            qs = torch.full((2,), start, dtype=torch.int32, device=dev)
            warm = chunk_prefill_attention(q[:, start:].contiguous(), k, v, qs, lengths, wflag,
                                           pads, **kw)
            torch.cuda.synchronize()
            assert torch.equal(warm, cold[:, start:]), (start, kw)


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
    f16 = cache.half()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode_attention(q, f16, f16, lengths)  # a same-width cache of another dtype
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        chunk_prefill_attention(q, f16, f16, lengths - 1, lengths)
    with pytest.raises(ValueError):
        decode_attention(q, cache.to(torch.float8_e4m3fn), cache, lengths)  # K and V apart
    with pytest.raises(ValueError):
        decode_attention(q, cache.transpose(2, 3), cache, lengths)  # not contiguous
    with pytest.raises(ValueError):
        decode_attention(q.float(), cache, cache, lengths)  # mixed dtypes
    with pytest.raises(ValueError):
        decode_attention(torch.zeros(1, 1, 9, 128, device=dev, dtype=torch.bfloat16),
                         cache, cache, lengths)  # 9 query heads over 2 KV heads
    with pytest.raises(ValueError, match="ROADMAP"):
        decode_attention(q[..., :80].contiguous(), cache[..., :80].contiguous(),
                         cache[..., :80].contiguous(), lengths)  # head_dim 80
    with pytest.raises(ValueError, match="ROADMAP"):
        chunk_prefill_attention(q[..., :80].contiguous(), cache[..., :80].contiguous(),
                                cache[..., :80].contiguous(), lengths - 1, lengths)


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
    f16 = pool.half()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        paged_decode_attention(q, f16, f16, lengths, tables)  # a same-width pool of another dtype
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        paged_chunk_attention(q, f16, f16, lengths - 1, lengths, None, tables)
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


def test_two_engines_capture_their_decode_graphs_by_turns(dev, monkeypatch):
    """Two engines, each capturing in a scope of its own, decode at once on
    two threads: their chunk runs take turns (fused.CARD_RUN_LOCK), so no
    capture overlaps another, and both give the same sampled streams."""
    import threading
    import time

    from cake_tpu_torch.models.llama import fused
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.chat import Message
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import SamplingConfig
    from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
    from cake_tpu_torch.runtime import batch_backend
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.bfloat16, dev)
    spans = []
    real = fused.DecodeChunk._capture

    def capture(chunk):
        t0 = time.perf_counter()
        real(chunk)
        spans.append((t0, time.perf_counter()))

    monkeypatch.setattr(fused.DecodeChunk, "_capture", capture)
    engines = [BatchEngine(cfg, params, ByteTokenizer(), max_seq_len=256,
                           cache_dtype=torch.bfloat16,
                           serve=ServeConfig(max_batch=4, kv_mode="paged"),
                           device=dev) for _ in range(2)]
    for eng in engines:
        eng.backend._chunks = batch_backend._Chunks(fused.CaptureScope())
    sampled = SamplingConfig(temperature=0.7, top_k=40, seed=3)
    prompts = [[Message.user(f"question {i}")] for i in range(4)]
    streams, reasons = [None, None], [None, None]
    barrier = threading.Barrier(2)

    def wave(i):
        barrier.wait()
        handles = [engines[i].submit(m, 16, sampled) for m in prompts]
        engines[i].start()
        streams[i] = [[t.id for t in h.tokens()] for h in handles]
        reasons[i] = [h.finish_reason for h in handles]

    threads = [threading.Thread(target=wave, args=(i,)) for i in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        for eng in engines:
            eng.stop()
    assert len(spans) >= 2
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert streams[0] == streams[1] and reasons[0] == reasons[1]
    assert set(reasons[0]) <= {"length", "stop"}  # a sampled stream may draw EOS
    assert all(0 < len(s) <= 16 for s in streams[0])


def test_paged_backend_refuses_a_page_the_kernels_do_not_take(dev):
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.runtime.batch_backend import PagedLocalBackend

    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4, num_key_value_heads=2)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    with pytest.raises(ValueError, match="page_size"):
        PagedLocalBackend(cfg, params, max_seq_len=256, cache_dtype=torch.float32,
                          page_size=64, device=dev)


# ------------------------------------------------------------- decode fusions


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("rows", [1, 2, 3, 5, 8, 12, 16, 17, 33, 64, 65, 128, 129, 255, 256])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_norm_matmul_kernel_matches_plain(dev, dtype, rows, offset):
    """rms_norm + product against the plain composition, over row counts up
    to the bound on both sides of each body's edge (f32 on the GEMV; swap AB
    to 64 rows, the warp-specialized body past it) and of every product
    width, each strip width, outputs that end mid-strip, split and unsplit
    K, a hidden size that ends mid-K-step and the Gemma (1 + w) offset;
    f32-accumulated, so held to a tolerance, not bitwise: TOL, or one
    rounding step of the output's dtype at its magnitude where that is
    larger."""
    from cake_tpu_torch.ops.fused_norm_matmul import (
        MAX_ROWS, fused_norm_matmul, fused_norm_matmul_plain,
    )

    assert rows <= MAX_ROWS
    gen = torch.Generator(device=dev).manual_seed(rows + 100 * offset)
    # 384, 200 (a ragged last strip) and 1000 split K in swap AB and take
    # 128-column tiles past it; 17000 and 40000 (the GEMV's 8- and 16-group
    # strips of wide outputs) one split and, 40000 from 65 rows, 256-column
    # tiles; hidden 520 ends mid-K-step.
    for hidden, out_dim in ((512, 384), (512, 200), (512, 17000), (512, 40000), (520, 1000)):
        x = _randn(gen, dev, dtype, rows, 1, hidden) * 3.0
        nw = _randn(gen, dev, dtype, hidden)
        w = _randn(gen, dev, dtype, hidden, out_dim) * hidden**-0.5
        before = fused_norm_matmul.launches
        out = fused_norm_matmul(x, nw, w, eps=1e-5, offset=offset)
        assert fused_norm_matmul.launches == before + 1
        ref = fused_norm_matmul_plain(x, nw, w, eps=1e-5, offset=offset)
        torch.cuda.synchronize()
        assert out.shape == ref.shape and out.dtype == ref.dtype
        step = torch.finfo(dtype).eps * 2.0 ** torch.floor(torch.log2(ref.float().abs().max()))
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= max(TOL[dtype], step.item()), (hidden, out_dim, err)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_norm_matmul_gemv_rows_at_full_hidden_and_width(dev, dtype):
    """Every row count up to 8 at Llama-3-8B's hidden into a wide output:
    for f32 every GEMV row tile into its widest strips (the staged rows and
    the reduction buffer pass 48 KB of shared memory from 4 rows on), for
    f16/bf16 swap AB's first product width."""
    from cake_tpu_torch.ops.fused_norm_matmul import fused_norm_matmul, fused_norm_matmul_plain

    gen = torch.Generator(device=dev).manual_seed(11)
    hidden, out_dim = 4096, 34000
    w = _randn(gen, dev, dtype, hidden, out_dim) * hidden**-0.5
    nw = _randn(gen, dev, dtype, hidden)
    for rows in range(1, 9):
        x = _randn(gen, dev, dtype, rows, 1, hidden) * 3.0
        out = fused_norm_matmul(x, nw, w, eps=1e-5)
        ref = fused_norm_matmul_plain(x, nw, w, eps=1e-5)
        torch.cuda.synchronize()
        step = torch.finfo(dtype).eps * 2.0 ** torch.floor(torch.log2(ref.float().abs().max()))
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= max(TOL[dtype], step.item()), (rows, err)


def test_norm_matmul_rows_past_the_bound_take_the_composition(dev):
    from cake_tpu_torch.ops.fused_norm_matmul import MAX_ROWS, fused_norm_matmul
    from cake_tpu_torch.ops.norm import rms_norm

    gen = torch.Generator(device=dev).manual_seed(5)
    x = _randn(gen, dev, torch.bfloat16, 2, MAX_ROWS, 256)
    nw = _randn(gen, dev, torch.bfloat16, 256)
    w = _randn(gen, dev, torch.bfloat16, 256, 128)
    before = fused_norm_matmul.launches, fused_norm_matmul.unfused
    out = fused_norm_matmul(x, nw, w, eps=1e-6)
    assert (fused_norm_matmul.launches, fused_norm_matmul.unfused) == (before[0], before[1] + 1)
    assert torch.equal(out, rms_norm(x, nw, 1e-6) @ w)


def test_norm_matmul_reads_a_strided_row_view(dev):
    """head_forward hands the kernel x[:, seq_len - 1], a strided view: at
    1, 4 and 100 rows (each body)."""
    from cake_tpu_torch.ops.fused_norm_matmul import fused_norm_matmul

    gen = torch.Generator(device=dev).manual_seed(6)
    for b in (1, 4, 100):
        x = _randn(gen, dev, torch.bfloat16, b, 7, 256)
        nw = _randn(gen, dev, torch.bfloat16, 256)
        w = _randn(gen, dev, torch.bfloat16, 256, 256)
        view = x[:, 5][:, None]
        got = fused_norm_matmul(view, nw, w, eps=1e-5)
        want = fused_norm_matmul(view.contiguous(), nw, w, eps=1e-5)
        torch.cuda.synchronize()
        assert torch.equal(got, want), b


def _norm_rows_f32(x, nw, eps, offset=False):
    """rms_norm's normalized rows, rounded to x's dtype, in f32."""
    from cake_tpu_torch.ops.norm import rms_norm

    return rms_norm(x, nw, eps, offset).float()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_norm_matmul_one_tile_descriptor_probe(dev, dtype):
    """One K step and one tile of each tensor-core body against an f32
    product of the same normalized rows: swap AB (W's 64 columns MN-major
    as the A operand) and the warp-specialized body (W MN-major as B) at
    both column tiles, one and two row tiles. A wrong descriptor stride or
    swizzle scrambles whole 16-byte chunks, far past the one rounding step
    this allows."""
    import dataclasses

    from cake_tpu_torch.ops.fused_norm_matmul import _run, plan

    gen = torch.Generator(device=dev).manual_seed(21)
    for rows, out_dim, variants in (
        (8, 64, ({},)),
        (64, 128, ({},)),
        (128, 256, ({"tile": 128}, {"tile": 256, "stages": 4})),
        (256, 256, ({}, {"tile": 256, "stages": 4})),
    ):
        x = _randn(gen, dev, dtype, rows, 64) * 3.0
        nw = _randn(gen, dev, dtype, 64)
        w = _randn(gen, dev, dtype, 64, out_dim) * 0.125
        ref = _norm_rows_f32(x, nw, 1e-5) @ w.float()
        base = plan(rows, 64, out_dim, dtype)
        assert base.body == ("swap_ab" if rows <= 64 else "warp_specialized")
        for change in variants:
            p = dataclasses.replace(base, **change)
            got = _run(x, nw, w, p, eps=1e-5)
            torch.cuda.synchronize()
            step = torch.finfo(dtype).eps * 2.0 ** torch.floor(torch.log2(ref.abs().max()))
            err = (got.float() - ref).abs().max().item()
            assert err <= step.item(), (rows, out_dim, change, err)


@pytest.mark.parametrize("shape", [(4096, 6144), (512, 40000), (520, 1000)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_norm_matmul_rows_are_independent_bitwise(dev, dtype, shape):
    """For each body (plan()'s at 1, 8, 16, 32, 64 and 256 rows), a row
    computed alone and the same row among all the body's rows give the same
    bits, through the private _run."""
    from cake_tpu_torch.ops.fused_norm_matmul import _run, plan

    hidden, out_dim = shape
    gen = torch.Generator(device=dev).manual_seed(9)
    x = _randn(gen, dev, dtype, 256, hidden) * 3.0
    nw = _randn(gen, dev, dtype, hidden)
    w = _randn(gen, dev, dtype, hidden, out_dim) * hidden**-0.5
    for n in (1, 8, 16, 32, 64, 256):
        p = plan(n, hidden, out_dim, dtype)
        full = _run(x[:n], nw, w, p, eps=1e-5, offset=True)
        for r in sorted({0, n // 2, n - 1}):
            alone = _run(x[r : r + 1], nw, w, p, eps=1e-5, offset=True)
            assert torch.equal(alone, full[r : r + 1]), (n, p, r)


def _ingest_operands(gen, dev, dtype, b, n_q, n_kv, hd):
    qkv = _randn(gen, dev, dtype, b, 1, (n_q + 2 * n_kv) * hd)
    cos = torch.randn(b, 1, hd // 2, generator=gen, device=dev)
    sin = torch.randn(b, 1, hd // 2, generator=gen, device=dev)
    return qkv, cos, sin


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_ingest_kernel_gives_the_plain_bits_dense_and_paged(dev, dtype, hd, group):
    """q and every written K/V byte equal the plain version's (split +
    apply_rope + write_layer / paged_write_layer); paged through shuffled
    pages, an unmapped entry and a past-the-table row; paged q ≡ dense q."""
    from cake_tpu_torch.ops.fused_ingest import fused_qkv_ingest, fused_qkv_ingest_plain

    gen = torch.Generator(device=dev).manual_seed(hd + group)
    b, n_kv, slot = 3, 2, 133
    n_q = n_kv * group
    qkv, cos, sin = _ingest_operands(gen, dev, dtype, b, n_q, n_kv, hd)
    kw = dict(n_q=n_q, n_kv=n_kv)
    # dense
    k0 = _randn(gen, dev, dtype, b, n_kv, 256, hd)
    v0 = _randn(gen, dev, dtype, b, n_kv, 256, hd)
    k1, v1, k2, v2 = k0.clone(), v0.clone(), k0.clone(), v0.clone()
    before = fused_qkv_ingest.launches
    q_dense = fused_qkv_ingest(qkv, cos, sin, slot, k1, v1, **kw)
    assert fused_qkv_ingest.launches == before + 1
    q_ref = fused_qkv_ingest_plain(qkv, cos, sin, slot, k2, v2, **kw)
    torch.cuda.synchronize()
    assert torch.equal(q_dense, q_ref)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    # paged: slot 133 is logical page 1; row 1's entry there is unmapped.
    kp, vp = _pool(gen, dev, dtype, 10, n_kv, hd)
    tables = _tables(dev, [[7, 2, 9], [5, -1, 1], [3, 8, 4]], 3)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    q_paged = fused_qkv_ingest(qkv, cos, sin, slot, k1, v1, block_tables=tables, **kw)
    q_ref = fused_qkv_ingest_plain(qkv, cos, sin, slot, k2, v2, block_tables=tables, **kw)
    torch.cuda.synchronize()
    assert torch.equal(q_paged, q_ref) and torch.equal(q_paged, q_dense)
    assert torch.equal(k1[:-1], k2[:-1]) and torch.equal(v1[:-1], v2[:-1])  # the sink aside
    assert not torch.equal(k1[2], kp[2]) and torch.equal(k1[1], kp[1])  # row 1 dropped
    # a slot past the table drops every write
    k1 = kp.clone()
    fused_qkv_ingest(qkv, cos, sin, 3 * PAGE + 5, k1, vp.clone(), block_tables=tables, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k1, kp)


def test_ingest_kernel_refuses_what_it_does_not_take(dev):
    from cake_tpu_torch.ops.fused_ingest import fused_qkv_ingest

    qkv = torch.zeros(1, 1, 12 * 64, device=dev, dtype=torch.bfloat16)
    cos = torch.zeros(1, 1, 32, device=dev)
    cache = torch.zeros(1, 2, 16, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_qkv_ingest(qkv, cos, cos, 0, cache.half(), cache.half(), n_q=8, n_kv=2)  # f16 cache
    with pytest.raises(ValueError):
        fused_qkv_ingest(qkv, cos, cos, 16, cache, cache.clone(), n_q=8, n_kv=2)  # slot
    with pytest.raises(ValueError):
        fused_qkv_ingest(qkv.float(), cos, cos, 0, cache, cache.clone(), n_q=8, n_kv=2)
    with pytest.raises(ValueError):
        tables = torch.zeros(1, 1, dtype=torch.int64, device=dev)
        fused_qkv_ingest(qkv, cos, cos, 0, cache, cache.clone(), n_q=8, n_kv=2,
                         block_tables=tables)


@pytest.mark.parametrize("heads", [(32, 8), (8, 1), (16, 16)], ids=lambda h: f"{h[0]}-{h[1]}")
@pytest.mark.parametrize("hd", [2, 6, 34, 80, 96])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_ingest_kernel_bits_at_every_vector_width(dev, dtype, hd, heads):
    """Head dims whose halves are not whole 16-byte vectors take narrower
    ones (plan()); q and the K/V written stay the plain version's bits,
    dense and paged."""
    from cake_tpu_torch.ops.fused_ingest import fused_qkv_ingest, fused_qkv_ingest_plain

    n_q, n_kv = heads
    gen = torch.Generator(device=dev).manual_seed(hd * n_q + n_kv)
    b, slot = 5, 200
    qkv, cos, sin = _ingest_operands(gen, dev, dtype, b, n_q, n_kv, hd)
    kw = dict(n_q=n_q, n_kv=n_kv)
    k0 = _randn(gen, dev, dtype, b, n_kv, 256, hd)
    v0 = _randn(gen, dev, dtype, b, n_kv, 256, hd)
    k1, v1, k2, v2 = k0.clone(), v0.clone(), k0.clone(), v0.clone()
    q1 = fused_qkv_ingest(qkv, cos, sin, slot, k1, v1, **kw)
    q2 = fused_qkv_ingest_plain(qkv, cos, sin, slot, k2, v2, **kw)
    torch.cuda.synchronize()
    assert torch.equal(q1, q2) and torch.equal(k1, k2) and torch.equal(v1, v2)
    kp, vp = _pool(gen, dev, dtype, 12, n_kv, hd)
    tables = _tables(dev, [[7, 2, 9], [5, -1, 1], [3, 8, 4], [0, 11, 10], [1, 6, -1]], 3)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    q1 = fused_qkv_ingest(qkv, cos, sin, slot, k1, v1, block_tables=tables, **kw)
    q2 = fused_qkv_ingest_plain(qkv, cos, sin, slot, k2, v2, block_tables=tables, **kw)
    torch.cuda.synchronize()
    assert torch.equal(q1, q2) and torch.equal(k1[:-1], k2[:-1]) and torch.equal(v1[:-1], v2[:-1])


def test_ingest_rows_alone_equal_the_batch_and_repeat_calls(dev):
    from cake_tpu_torch.ops.fused_ingest import fused_qkv_ingest

    gen = torch.Generator(device=dev).manual_seed(3)
    b, n_q, n_kv, hd, slot = 8, 32, 8, 128, 301
    qkv, cos, sin = _ingest_operands(gen, dev, torch.bfloat16, b, n_q, n_kv, hd)
    kp, vp = _pool(gen, dev, torch.bfloat16, 20, n_kv, hd)
    tables = _tables(dev, [[2 * r, 2 * r + 1, 19 - r] for r in range(b)], 3)
    kw = dict(n_q=n_q, n_kv=n_kv, block_tables=tables)
    k1, v1 = kp.clone(), vp.clone()
    q = fused_qkv_ingest(qkv, cos, sin, slot, k1, v1, **kw)
    k2, v2 = kp.clone(), vp.clone()
    assert torch.equal(fused_qkv_ingest(qkv, cos, sin, slot, k2, v2, **kw), q)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    k3, v3 = kp.clone(), vp.clone()
    for r in range(b):
        alone = fused_qkv_ingest(qkv[r : r + 1], cos[r : r + 1], sin[r : r + 1], slot, k3, v3,
                                 n_q=n_q, n_kv=n_kv, block_tables=tables[r : r + 1])
        assert torch.equal(alone, q[r : r + 1])
    torch.cuda.synchronize()
    assert torch.equal(k3, k1) and torch.equal(v3, v1)


@pytest.mark.parametrize("rows", [1, 8])
def test_ingest_straight_after_the_wqkv_product(dev, rows):
    """Under ``all`` the ingest follows the wqkv fused_norm_matmul (swap AB)
    on the stream: q and the cache equal the ingest launched after a
    synchronize."""
    from cake_tpu_torch.ops.fused_ingest import fused_qkv_ingest
    from cake_tpu_torch.ops.fused_norm_matmul import fused_norm_matmul, plan as nm_plan

    gen = torch.Generator(device=dev).manual_seed(rows)
    n_q, n_kv, hd, hidden, slot = 32, 8, 128, 4096, 77
    bf = torch.bfloat16
    assert nm_plan(rows, hidden, (n_q + 2 * n_kv) * hd, bf).body == "swap_ab"
    x = _randn(gen, dev, bf, rows, 1, hidden) * 3
    nw = _randn(gen, dev, bf, hidden) * 0.1 + 1
    w = _randn(gen, dev, bf, hidden, (n_q + 2 * n_kv) * hd) * hidden**-0.5
    cos = torch.randn(rows, 1, hd // 2, generator=gen, device=dev)
    sin = torch.randn(rows, 1, hd // 2, generator=gen, device=dev)
    k0 = _randn(gen, dev, bf, rows, n_kv, 256, hd)
    v0 = _randn(gen, dev, bf, rows, n_kv, 256, hd)
    outs = []
    for sync in (False, True):
        k, v = k0.clone(), v0.clone()
        torch.cuda.synchronize()
        qkv = fused_norm_matmul(x, nw, w, eps=1e-5)
        if sync:
            torch.cuda.synchronize()
        q = fused_qkv_ingest(qkv, cos, sin, slot, k, v, n_q=n_q, n_kv=n_kv)
        torch.cuda.synchronize()
        outs.append((q, k, v))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


_TAIL_KNOBS = [
    dict(temperature=0.0, top_k=None, repeat_penalty=1.0),
    dict(temperature=0.0, top_k=None, repeat_penalty=1.3),
    dict(temperature=0.7, top_k=None, repeat_penalty=1.0),
    dict(temperature=0.7, top_k=40, repeat_penalty=1.1),
    dict(temperature=1.3, top_k=1, repeat_penalty=0.9),
]


def _tail_operands(gen, dev, b, vocab, window, quantize):
    logits = torch.randn(b, vocab, generator=gen, device=dev) * 3.0
    if quantize:  # duplicate-heavy rows: the top-k tie shape
        logits = torch.round(logits * 4) / 4
    ring = torch.randint(-1, vocab, (b, window), generator=gen, device=dev)
    u = torch.rand(b, vocab, generator=gen, device=dev).clamp(min=1e-30)
    return logits, ring, -torch.log(-torch.log(u))


@pytest.mark.parametrize("knobs", _TAIL_KNOBS, ids=lambda k: "-".join(map(str, k.values())))
@pytest.mark.parametrize("vocab", [256, 1000, 128256])
@pytest.mark.parametrize("b", [1, 8])
def test_sample_tail_kernel_gives_the_plain_ids(dev, b, vocab, knobs):
    from cake_tpu_torch.ops.fused_sample_tail import fused_sample_tail, fused_sample_tail_plain

    gen = torch.Generator(device=dev).manual_seed(b * vocab)
    for quantize in (False, True):
        logits, ring, noise = _tail_operands(gen, dev, b, vocab, 128, quantize)
        noise = noise if knobs["temperature"] > 0 else None
        before = fused_sample_tail.launches
        got = fused_sample_tail(logits, ring, noise, top_p=None, **knobs)
        assert fused_sample_tail.launches == before + 1
        want = fused_sample_tail_plain(logits, ring, noise, top_p=None, **knobs)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype == torch.int64
        assert torch.equal(got, want), (quantize, got.tolist(), want.tolist())


@pytest.mark.parametrize("knobs", _TAIL_KNOBS, ids=lambda k: "-".join(map(str, k.values())))
@pytest.mark.parametrize("b,vocab", [(3, 1027), (2, 4099), (8, 32000), (8, 151936), (33, 128256),
                                     (2, 2_000_000)])
def test_sample_tail_cluster_grid_gives_the_plain_ids(dev, b, vocab, knobs):
    """Vocabularies not a multiple of 4 or of the cluster, more clusters
    than fit at once (b = 33), and a top-k slice too large to stage."""
    from cake_tpu_torch.ops.fused_sample_tail import fused_sample_tail, fused_sample_tail_plain

    gen = torch.Generator(device=dev).manual_seed(b + vocab)
    logits, ring, noise = _tail_operands(gen, dev, b, vocab, 64, True)
    noise = noise if knobs["temperature"] > 0 else None
    got = fused_sample_tail(logits, ring, noise, top_p=None, **knobs)
    want = fused_sample_tail_plain(logits, ring, noise, top_p=None, **knobs)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got.tolist(), want.tolist())


@pytest.mark.parametrize("knobs", _TAIL_KNOBS, ids=lambda k: "-".join(map(str, k.values())))
def test_sample_tail_unaligned_rows_cluster_sizes_and_repeats(dev, knobs):
    """Rows that start off a 16-byte boundary stage their ends by plain
    loads; every cluster size and a row alone give the batch's ids; a
    repeat call gives the same."""
    from cake_tpu_torch.ops import fused_sample_tail as tail
    from cake_tpu_torch.ops.fused_sample_tail import Plan, fused_sample_tail_plain, smem_bytes

    gen = torch.Generator(device=dev).manual_seed(11)
    b, vocab = 8, 128256
    lg, ring, nz = _tail_operands(gen, dev, b, vocab + 1, 128, True)
    logits = lg.flatten()[1 : 1 + b * vocab].view(b, vocab)  # 4 bytes past an aligned base
    noise = nz.flatten()[3 : 3 + b * vocab].view(b, vocab) if knobs["temperature"] > 0 else None
    ring = ring.clamp(max=vocab - 1)
    kw = dict(top_p=None, **knobs)
    want = fused_sample_tail_plain(logits, ring, noise, **kw)
    got = tail.fused_sample_tail(logits, ring, noise, **kw)
    assert torch.equal(tail.fused_sample_tail(logits, ring, noise, **kw), got)
    for r in (0, 5, 7):
        alone = tail.fused_sample_tail(logits[r : r + 1], ring[r : r + 1],
                                       None if noise is None else noise[r : r + 1], **kw)
        assert torch.equal(alone, got[r : r + 1])
    k = knobs["top_k"] if knobs["temperature"] > 0 else None
    for cluster in (1, 4, 8, 16):
        sl = -(-(-(-vocab // cluster)) // 4) * 4
        staged = k is not None and smem_bytes(sl, True, True) <= tail.SMEM_CAP
        p = Plan(cluster, sl, staged, smem_bytes(sl, k is not None, staged))
        ids = tail._run(logits, ring, noise, p, temperature=knobs["temperature"], top_k=k or 0,
                        repeat_penalty=knobs["repeat_penalty"])
        assert torch.equal(ids, got), cluster
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_sample_tail_cluster_sizes_fit_on_the_card(dev):
    from cake_tpu_torch.ops.fused_sample_tail import _max_active_clusters, candidates

    for sampled, top_k in ((False, None), (True, None), (True, 40)):
        for p in candidates(8, 128256, sampled, top_k):
            assert _max_active_clusters(p, True, sampled, top_k or 0) > 0, p


def test_sample_tail_tie_breaks_and_guards(dev):
    """Equal maxima give the lowest index, NaN wins, an all -inf row gives 0,
    a ring token twice is penalized once, and top_k = V masks nothing."""
    from cake_tpu_torch.ops.fused_sample_tail import fused_sample_tail, fused_sample_tail_plain

    vocab = 1024
    logits = torch.zeros(5, vocab, device=dev)
    logits[0, [300, 17, 900]] = 5.0  # tie: 17
    logits[1] = float("-inf")
    logits[2, 400] = float("nan")
    logits[2, 10] = float("inf")
    logits[3, [5, 6]] = 2.0  # 5 is in the ring twice: 6 wins
    logits[4, 77] = -0.0
    ring = torch.full((5, 4), -1, dtype=torch.int64, device=dev)
    ring[3, :2] = 5
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = -torch.log(-torch.log(torch.rand(5, vocab, generator=gen, device=dev)))
    for knobs, nz in ((dict(temperature=0.0, top_k=None, repeat_penalty=1.5), None),
                      (dict(temperature=0.5, top_k=vocab, repeat_penalty=1.5), noise),
                      (dict(temperature=0.5, top_k=3, repeat_penalty=1.0), noise)):
        got = fused_sample_tail(logits, ring, nz, top_p=None, **knobs)
        want = fused_sample_tail_plain(logits, ring, nz, top_p=None, **knobs)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (knobs, got.tolist(), want.tolist())
    greedy = fused_sample_tail(logits, ring, None, temperature=0.0, top_k=None, top_p=None,
                               repeat_penalty=1.5)
    assert greedy.tolist()[:4] == [17, 0, 400, 6]


def test_sample_tail_top_p_keeps_the_composition(dev):
    from cake_tpu_torch.ops.fused_sample_tail import fused_sample_tail, fused_sample_tail_plain

    gen = torch.Generator(device=dev).manual_seed(1)
    logits, ring, noise = _tail_operands(gen, dev, 4, 512, 8, False)
    knobs = dict(temperature=0.8, top_k=None, top_p=0.9, repeat_penalty=1.1)
    before = fused_sample_tail.launches, fused_sample_tail.unfused
    got = fused_sample_tail(logits, ring, noise, **knobs)
    assert (fused_sample_tail.launches, fused_sample_tail.unfused) == (before[0], before[1] + 1)
    assert torch.equal(got, fused_sample_tail_plain(logits, ring, noise, **knobs))


def _fusion_engine_streams(dev, cfg, params, fusion, kv_mode, sampling):
    from cake_tpu_torch.models.llama.chat import Message
    from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    kw = {"kv_mode": "paged", "prefix_cache": True} if kv_mode == "paged" else {}
    eng = BatchEngine(cfg, params, ByteTokenizer(), max_seq_len=512, cache_dtype=torch.float32,
                      serve=ServeConfig(max_batch=4, fusion_impl=fusion, **kw), device=dev)
    eng.start()
    try:
        hs = [eng.submit([Message.user(f"question number {i}")], 12, sampling) for i in range(3)]
        out = [[t.id for t in h.tokens()] for h in hs]
        assert eng.wait_idle(60)
    finally:
        eng.stop()
    return out


@pytest.mark.parametrize("kv_mode", ["dense", "paged"])
def test_engine_fusions_on_the_card(dev, kv_mode):
    """The exact fusions (ingest, tail) keep the unfused streams, greedy and
    sampled; "all" runs every fused kernel and no plain version."""
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import SamplingConfig
    from cake_tpu_torch.ops import fused_ingest, fused_norm_matmul, fused_sample_tail

    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.float32, dev)
    for s in (SamplingConfig(temperature=0.0, repeat_penalty=1.0),
              SamplingConfig(temperature=0.8, top_k=20, repeat_penalty=1.1, seed=3)):
        base = _fusion_engine_streams(dev, cfg, params, "none", kv_mode, s)
        assert _fusion_engine_streams(dev, cfg, params, "ingest,tail", kv_mode, s) == base
    kernels = (fused_norm_matmul.fused_norm_matmul, fused_ingest.fused_qkv_ingest,
               fused_sample_tail.fused_sample_tail)
    plains = (fused_norm_matmul.fused_norm_matmul_plain, fused_ingest.fused_qkv_ingest_plain,
              fused_sample_tail.fused_sample_tail_plain)
    before = [k.launches for k in kernels], [p.launches for p in plains]
    streams = _fusion_engine_streams(dev, cfg, params, "all", kv_mode, s)
    assert all(1 <= len(x) <= 12 for x in streams)
    assert all(k.launches > n for k, n in zip(kernels, before[0]))
    assert [p.launches for p in plains] == before[1]


def test_generator_chunks_equal_per_step_on_the_card(dev, tmp_path):
    """decode_chunk with the fused tail gives the per-step stream, greedy
    and seeded sampled; a bf16 checkpoint runs through every fusion."""
    from cake_tpu_torch.io.safetensors_io import save_tiny_checkpoint
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.chat import Message
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import LlamaGenerator, SamplingConfig
    from cake_tpu_torch.ops.fused_sample_tail import fused_sample_tail

    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2)
    save_tiny_checkpoint(tmp_path, M.init_params(cfg, torch.Generator().manual_seed(1),
                                                 torch.float32), cfg)
    for s in (SamplingConfig(temperature=0.0, repeat_penalty=1.1),
              SamplingConfig(temperature=0.9, top_k=30, repeat_penalty=1.1, seed=5)):
        streams = []
        for chunk, fusion in ((1, "none"), (4, "tail")):
            gen = LlamaGenerator.load(tmp_path, dtype=torch.float32, max_seq_len=256, sampling=s,
                                      device=dev, decode_chunk_size=chunk, fusion_impl=fusion)
            gen.add_message(Message.user("tell me a story"))
            before = fused_sample_tail.launches
            gen.generate(13)
            streams.append(list(gen.generated_token_ids))
            assert (fused_sample_tail.launches > before) == (chunk > 1)
        assert streams[0] == streams[1]
    # A loaded checkpoint through every fusion: lm_head and the stacked
    # weights come out row-major, as the norm-matmul kernel reads them.
    from cake_tpu_torch.ops.fused_norm_matmul import fused_norm_matmul

    gen = LlamaGenerator.load(tmp_path, dtype=torch.bfloat16, max_seq_len=256, sampling=s,
                              device=dev, decode_chunk_size=4, fusion_impl="all")
    gen.add_message(Message.user("tell me a story"))
    before = fused_norm_matmul.launches
    gen.generate(9)
    assert fused_norm_matmul.launches > before and len(gen.generated_token_ids) >= 1


# ------------------------------------------------------------ decode graphs
#
# A decode chunk on the card replays one CUDA graph (models/llama/fused.py
# DecodeChunk). Held here against the eager loop on a clone of the same
# state, to the bit, at a small width.

GRAPH_CFG = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_ingest_graph_replays_read_the_slot_from_device_memory(dev, paged):
    """One ingest launch captured in a graph, replayed at several slots (the
    slot tensor written between replays; paged: one past the table, whose
    write drops), equals its plain version at each slot: q and the cache,
    the sink page aside."""
    from cake_tpu_torch.ops.fused_ingest import fused_qkv_ingest, fused_qkv_ingest_plain

    gen = torch.Generator(device=dev).manual_seed(41)
    b, n_q, n_kv, hd = 4, 8, 2, 128
    qkv, cos, sin = _ingest_operands(gen, dev, torch.bfloat16, b, n_q, n_kv, hd)
    kw = dict(n_q=n_q, n_kv=n_kv)
    if paged:
        k0, v0 = _pool(gen, dev, torch.bfloat16, 10, n_kv, hd)
        kw["block_tables"] = _tables(dev, [[7, 2, 9], [5, -1, 1], [3, 8, 4], [0, 6, -1]], 3)
        slots = [0, 127, 128, 300, 3 * PAGE + 5]
    else:
        k0 = _randn(gen, dev, torch.bfloat16, b, n_kv, 512, hd)
        v0 = _randn(gen, dev, torch.bfloat16, b, n_kv, 512, hd)
        slots = [0, 1, 255, 511]
    slot = torch.zeros((), dtype=torch.int64, device=dev)
    k1, v1 = k0.clone(), v0.clone()
    fused_qkv_ingest(qkv, cos, sin, slot, k1, v1, **kw)  # warm-up outside the capture
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        q = fused_qkv_ingest(qkv, cos, sin, slot, k1, v1, **kw)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    for at in slots:
        k1.copy_(k0)
        v1.copy_(v0)
        slot.fill_(at)
        graph.replay()
        k2, v2 = k0.clone(), v0.clone()
        q2 = fused_qkv_ingest_plain(qkv, cos, sin, at, k2, v2, **kw)
        torch.cuda.synchronize()
        keep = slice(None, -1) if paged else slice(None)
        assert torch.equal(q, q2), at
        assert torch.equal(k1[keep], k2[keep]) and torch.equal(v1[keep], v2[keep]), at
        assert not torch.equal(k1, k0) or at == 3 * PAGE + 5


@pytest.mark.parametrize("op", ["decode_attention", "fused_norm_matmul", "decode_attention_f8"])
def test_a_graph_replays_after_a_larger_call_grew_the_tickets(dev, op, monkeypatch):
    """A graph captured over a small call's ticket buffer, replayed after a
    larger eager call needed more tickets and other tensors took what the
    allocator had free, equals the small call run eagerly, and leaves those
    tensors alone: the buffer a graph holds is never freed (the engine's
    epochs go from 2 lanes to 8 and back)."""
    from cake_tpu_torch.ops import tickets
    from cake_tpu_torch.ops.fused_norm_matmul import fused_norm_matmul

    monkeypatch.setattr(tickets, "_held", {})
    gen = torch.Generator(device=dev).manual_seed(43)
    dt = torch.bfloat16
    if op.startswith("decode_attention"):
        n_q, n_kv, hd, max_seq = 32, 8, 128, 1024
        kv_dt = torch.float8_e4m3fn if op.endswith("f8") else dt

        def operands(b):
            return (_randn(gen, dev, dt, b, 1, n_q, hd),
                    _randn(gen, dev, kv_dt, b, n_kv, max_seq, hd),
                    _randn(gen, dev, kv_dt, b, n_kv, max_seq, hd),
                    torch.arange(700, 700 + b, dtype=torch.int32, device=dev))

        def call(args):
            return decode_attention(*args)
    else:
        hidden = 4096

        def operands(out):  # the strips' tickets grow with the product's width
            return (_randn(gen, dev, dt, 2, 1, hidden), _randn(gen, dev, dt, hidden),
                    _randn(gen, dev, dt, hidden, out) * hidden**-0.5)

        def call(args):
            return fused_norm_matmul(*args, eps=1e-5)
    small, large = (operands(2), operands(8)) if op.startswith("decode_attention") else (
        operands(1024), operands(8192))
    call(small)  # the warm-up makes the small call's tickets
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        got = call(small)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    call(large)
    (held,) = tickets._held.values()
    assert len(held) == 2 and held[1].numel() >= 2 * held[0].numel()
    junk = [torch.full((held[0].numel(),), 7, dtype=torch.int32, device=dev) for _ in range(64)]
    for _ in range(3):
        graph.replay()
        want = call(small)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert all(bool((j == 7).all()) for j in junk)
    assert not held[0].any() and not held[1].any()


def _graph_engine(dev, kv_mode, fusion, dtype, quantize=None, kv_dtype=None):
    """A backend at the small width with three prompts prefilled: (backend,
    kv, carries, slot); its cache of ``kv_dtype`` (None: ``dtype``)."""
    import dataclasses

    from cake_tpu_torch.models.llama import batch as B
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import SamplingConfig
    from cake_tpu_torch.ops.quant import quantize_params
    from cake_tpu_torch.ops.threefry import prng_key
    from cake_tpu_torch.runtime.batch_backend import LocalBatchBackend, PagedLocalBackend

    cfg = dataclasses.replace(LlamaConfig.tiny(**GRAPH_CFG), fusion_impl=fusion)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(2), dtype, dev)
    if quantize:
        params = quantize_params(params, quantize)
    kv_dtype = kv_dtype or dtype
    if kv_mode == "paged":
        be = PagedLocalBackend(cfg, params, max_seq_len=512, cache_dtype=kv_dtype, device=dev)
    else:
        be = LocalBatchBackend(cfg, params, max_seq_len=512, cache_dtype=kv_dtype, device=dev)
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist() for n in (40, 121, 77)]
    tokens, pads, bucket = B.layout_prompts(prompts, 512)
    s = SamplingConfig(temperature=0.0, repeat_penalty=1.1, repeat_last_n=16)
    with torch.inference_mode():
        kv = be.init_kv(3)
        if kv_mode == "paged":
            for lane, pad in enumerate(pads):
                be.allocator.map_range(lane, int(pad), bucket + 8)
        logits, kv = be.prefill(tokens, kv, pads)
        ring, ring_idx = B.seed_rings(prompts, 16)
        first, keys, ring, ring_idx = B.first_sample(logits, s, ring, ring_idx,
                                                     prng_key([4, 5, 6], dev))
    carries = dict(tok=torch.as_tensor(first, dtype=torch.int64, device=dev),
                   pads=torch.as_tensor(pads, device=dev), keys=keys,
                   ring=torch.as_tensor(ring, dtype=torch.int64, device=dev),
                   ring_idx=torch.as_tensor(ring_idx, dtype=torch.int64, device=dev))
    return be, kv, carries, bucket


@pytest.mark.parametrize("case", [
    ("dense", "none", torch.bfloat16, None), ("dense", "all", torch.bfloat16, None),
    ("paged", "none", torch.bfloat16, None), ("paged", "all", torch.bfloat16, None),
    ("paged", "ingest,tail", torch.float32, None), ("paged", "all", torch.bfloat16, "int4"),
    # f8 caches: the unfused writes (narrow) and the ingest kernel's
    ("paged", "none", torch.bfloat16, None, torch.float8_e4m3fn),
    ("dense", "all", torch.bfloat16, None, torch.float8_e4m3fn),
], ids=lambda c: f"{c[0]}-{c[1]}-{str(c[2])[6:]}-{c[3]}" + (f"-{str(c[4])[6:]}" if c[4:] else ""))
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_engine_decode_graph_equals_the_eager_chunk(dev, case, sampled):
    """Five chunks of the backend's decode (one graph, replayed at moving
    slots; paged: pages mapped between chunks change the table) against
    batch.decode_chunk / paged_decode_chunk on a clone of the cache, the
    slot a host int: ids, KV and carries to the bit. The launch counters
    count the replays."""
    from cake_tpu_torch.models.llama import batch as B
    from cake_tpu_torch.models.llama.generator import SamplingConfig
    from cake_tpu_torch.ops.decode_attention import decode_attention
    from cake_tpu_torch.ops.paged_attention import paged_decode_attention

    kv_mode, fusion, dtype, quantize = case[:4]
    be, kv, c, slot = _graph_engine(dev, kv_mode, fusion, dtype, quantize, *case[4:])
    s = SamplingConfig(temperature=0.8, top_k=20, repeat_penalty=1.1, repeat_last_n=16) \
        if sampled else SamplingConfig(temperature=0.0, repeat_penalty=1.1, repeat_last_n=16)
    n = 4
    ref = type(kv)(kv.k.clone(), kv.v.clone())
    tok, keys, ring, ring_idx = c["tok"], c["keys"], c["ring"], c["ring_idx"]
    r_tok, r_keys, r_ring, r_idx = tok.clone(), keys.clone(), ring.clone(), ring_idx.clone()
    counter = paged_decode_attention if kv_mode == "paged" else decode_attention
    for i in range(5):
        if kv_mode == "paged":
            for lane in range(3):
                be.allocator.map_range(lane, slot, slot + n + 128 * (i % 2))
        with torch.inference_mode():
            before = counter.launches
            ids, kv, keys, ring, ring_idx = be.decode(kv, tok, slot, c["pads"], keys, ring,
                                                      ring_idx, n, s)
            assert counter.launches - before == n * be.config.num_hidden_layers
            if kv_mode == "paged":
                tables = torch.as_tensor(be._host_tables(), device=dev)
                want, ref, r_keys, r_ring, r_idx = B.paged_decode_chunk(
                    be.params, ref, r_tok, slot, c["pads"], tables, r_keys, r_ring, r_idx,
                    be.config, n, s, be.rope)
            else:
                want, ref, r_keys, r_ring, r_idx = B.decode_chunk(
                    be.params, ref, r_tok, slot, c["pads"], r_keys, r_ring, r_idx, be.config,
                    n, s, be.rope)
            torch.cuda.synchronize()
            assert torch.equal(ids, want), (i, ids, want)
            assert torch.equal(keys, r_keys) and torch.equal(ring, r_ring)
            assert torch.equal(ring_idx, r_idx)
            assert torch.equal(kv_view(kv.k), kv_view(ref.k))
            assert torch.equal(kv_view(kv.v), kv_view(ref.v))
            tok, r_tok, slot = ids[:, -1].clone(), want[:, -1].clone(), slot + n
    (chunk,) = be._chunks.values()
    assert chunk.graph is not None and chunk.replays == 5


@pytest.mark.parametrize("fusion", ["none", "all"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_generator_decode_graph_equals_the_eager_loop(dev, fusion, sampled):
    """Three chunks of LocalForwardStep.decode_chunk (one graph; the shared
    threefry key carried on the device and split in it) against
    sampled_decode_loop from a copy of the key, on a clone of the cache:
    ids, KV and the advanced key to the bit."""
    _generator_graph_case(dev, fusion, sampled, torch.bfloat16)


@pytest.mark.parametrize("fusion", ["none", "all"])
def test_generator_f8_decode_graph_equals_the_eager_loop(dev, fusion):
    """The same over an f8 cache: the graph writes it through narrow and
    reads it through the f8 decode kernel, the eager loop the same, to the
    bit."""
    _generator_graph_case(dev, fusion, True, torch.float8_e4m3fn)


def _generator_graph_case(dev, fusion, sampled, kv_dtype):
    import dataclasses

    import numpy as np

    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.fused import sampled_decode_loop
    from cake_tpu_torch.models.llama.generator import LocalForwardStep, SamplingConfig
    from cake_tpu_torch.ops.fuse import resolve_fusion
    from cake_tpu_torch.ops.threefry import prng_key

    cfg = dataclasses.replace(LlamaConfig.tiny(**GRAPH_CFG), fusion_impl=fusion)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(8), torch.bfloat16, dev)
    step = LocalForwardStep(cfg, params, max_seq_len=512, cache_dtype=kv_dtype, device=dev)
    s = SamplingConfig(temperature=0.9, top_k=30, repeat_penalty=1.1, repeat_last_n=16, seed=9) \
        if sampled else SamplingConfig(temperature=0.0, repeat_penalty=1.1, repeat_last_n=16)
    prompt = np.arange(3, 60, dtype=np.int64)[None]
    with torch.inference_mode():
        last = int(step(prompt, 0, prompt.shape[1]).argmax(-1)[0])
    ref = type(step._kv)(step._kv.k.clone(), step._kv.v.clone())
    key, ref_key = prng_key(s.seed, dev), prng_key(s.seed, dev)

    def forward_one(tok, kv, p):
        return M.forward(step.params, tok, kv, p, 1, cfg, rope=step._rope)

    history, pos = prompt[0].tolist() + [last], prompt.shape[1]
    for _ in range(3):
        ring = np.full((1, 16), -1, np.int64)
        ring[0, : min(16, len(history))] = history[-16:]
        ring_idx = min(len(history), 16) % 16
        with torch.inference_mode():
            got, key = step.decode_chunk(np.asarray([history[-1]]), pos, 8, s, key, ring,
                                         ring_idx)
            want, ref, ref_key, _, _ = sampled_decode_loop(
                forward_one, ref, torch.tensor([history[-1]], device=dev), pos, ref_key,
                torch.as_tensor(ring, device=dev),
                torch.full((1,), ring_idx, dtype=torch.int64, device=dev), n_steps=8, s=s,
                fused_tail="tail" in resolve_fusion(cfg))
        np.testing.assert_array_equal(got, want.cpu().numpy())
        history += got[0].tolist()
        pos += 8
    torch.cuda.synchronize()
    assert torch.equal(kv_view(step._kv.k), kv_view(ref.k))
    assert torch.equal(kv_view(step._kv.v), kv_view(ref.v))
    assert torch.equal(key, ref_key)
    assert torch.equal(key, prng_key(s.seed, dev)) != sampled  # a sampled step splits it
    (chunk,) = step._chunks.values()
    assert chunk.graph is not None and chunk.replays == 3


def test_profiler_sees_every_kernel_of_a_replay(dev):
    """torch.profiler reports a replay's device work node by node: as many
    kernels, memcpys and memsets as the same chunk run eagerly."""
    import json
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    be, kv, c, slot = _graph_engine(dev, "paged", "all", torch.bfloat16)
    from cake_tpu_torch.models.llama.generator import SamplingConfig

    s = SamplingConfig(temperature=0.0, repeat_penalty=1.1, repeat_last_n=16)
    with torch.inference_mode():
        be.decode(kv, c["tok"], slot, c["pads"], c["keys"], c["ring"], c["ring_idx"], 4, s)
    (chunk,) = be._chunks.values()

    def device_ops(fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "t.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        return [e["name"] for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]

    with torch.inference_mode():
        device_ops(chunk.graph.replay)  # the profiler's own warm-up
        replayed = device_ops(chunk.graph.replay)
        eager = device_ops(chunk.body)
    assert len(replayed) == len(eager) > 100, (len(replayed), len(eager))


# ------------------------------------------------------------ int4_matmul
#
# The kernel against int4_matmul_plain (the same scaled-then-rounded weight,
# an f32 product): another summation order may round an output one step of
# its dtype the other way (f32: 1e-5 of the largest output).


def _int4_weight(dev, in_dim, out, group, seed):
    from cake_tpu_torch.ops.quant import _quantize4_2d

    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(in_dim, out, generator=gen, device=dev) * in_dim**-0.5
    return _quantize4_2d(w, group)


def _int4_close(out, ref, dtype):
    import math

    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype == dtype
    assert torch.isfinite(out).all()
    top = ref.float().abs().max().item()
    bits = {torch.bfloat16: 7, torch.float16: 10}.get(dtype)
    tol = 1e-5 * top if bits is None else 2.0 ** (math.floor(math.log2(top)) - bits)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol, f"max-abs {err} > {tol}"
    cos = torch.nn.functional.cosine_similarity(out.float().flatten(), ref.float().flatten(), dim=0)
    assert cos.item() >= 0.9999


INT4_ROWS = [1, 2, 4, 8, 16, 64, 256, 300, 3840]
# (in, out, group): group sizes 32, 64, 128, a tiny width's 16 and a group
# that is neither a divisor nor a multiple of the 64-row K step (24); split
# K on and off; a ragged last K step (in 96) and a half column strip (48).
INT4_SHAPES = [(1024, 384, 32), (1024, 512, 64), (2048, 640, 128), (64, 128, 16), (96, 48, 24)]


@pytest.mark.parametrize("shape", INT4_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("rows", INT4_ROWS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_int4_kernel_matches_plain(dev, dtype, rows, shape):
    from cake_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_plain

    in_dim, out, group = shape
    q = _int4_weight(dev, in_dim, out, group, rows + in_dim)
    x = _randn(torch.Generator(device=dev).manual_seed(rows), dev, dtype, rows, in_dim)
    before = int4_matmul.launches
    got = int4_matmul(x, q.w, q.scale)
    assert int4_matmul.launches == before + 1
    _int4_close(got, int4_matmul_plain(x, q.w, q.scale), dtype)


LLAMA3_INT4 = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 128256)]


@pytest.mark.parametrize("shape", LLAMA3_INT4, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_int4_kernel_at_llama3_widths(dev, dtype, shape):
    from cake_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_plain

    q = _int4_weight(dev, *shape, 128, shape[1])
    for rows in (1, 8, 16, 17, 64, 256, 3840):
        x = _randn(torch.Generator(device=dev).manual_seed(rows), dev, dtype, rows, shape[0])
        _int4_close(int4_matmul(x, q.w, q.scale), int4_matmul_plain(x, q.w, q.scale), dtype)


@pytest.mark.parametrize("shape", [(4096, 6144), (4096, 28672), (14336, 4096), (1024, 384)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_int4_rows_are_independent_bitwise(dev, dtype, shape):
    """A row's bits do not depend on the rows beside it: every prefix and
    single row of a 3840-row call (split K in one pass and in two) equals
    that row's own call."""
    from cake_tpu_torch.ops.int4_matmul import int4_matmul

    q = _int4_weight(dev, *shape, 128, 7)
    x = _randn(torch.Generator(device=dev).manual_seed(3), dev, dtype, 3840, shape[0])
    full = int4_matmul(x, q.w, q.scale)
    for n in (1, 2, 8, 16, 17, 64, 256, 300):
        assert torch.equal(int4_matmul(x[:n], q.w, q.scale), full[:n]), n
    for r in (0, 9, 255, 3839):
        assert torch.equal(int4_matmul(x[r : r + 1], q.w, q.scale), full[r : r + 1]), r


@pytest.mark.parametrize("shape", [(4096, 6144), (4096, 28672), (14336, 4096), (1024, 384, 32),
                                   (96, 48, 16), (2048, 640, 256)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_int4_bodies_agree_to_the_bit(dev, dtype, shape):
    """The bits probe: the same operands through mma.sync m16n8k16 (the
    decode rows' body) and through wgmma at every product width, each split
    a block and, where K is split, one block folding the splits in order.
    Every variant must give mma.sync's bits; the ones that agree are
    recorded in the assertion message."""
    import dataclasses

    from cake_tpu_torch.ops.int4_matmul import _run, plan

    in_dim, out = shape[:2]
    group = shape[2] if len(shape) > 2 else 128
    q = _int4_weight(dev, in_dim, out, group, 11)
    x = _randn(torch.Generator(device=dev).manual_seed(5), dev, dtype, 256, in_dim)
    base = plan(256, in_dim, out, dtype, group)
    ref = _run(x, q.w, q.scale, dataclasses.replace(base, route="mma.sync", tile=0, fold=False))
    agree = {}
    for width in (8, 16, 32, 64, 128, 256):
        for fold in (False, True) if base.splits > 1 and width in (32, 64, 128) else (False,):
            got = _run(x, q.w, q.scale, dataclasses.replace(base, route="wgmma", tile=width,
                                                            fold=fold))
            agree[f"wgmma{width}" + ("_fold" if fold else "")] = bool(torch.equal(got, ref))
    assert all(agree.values()), agree


def test_built_library_runs_the_tensor_cores(dev):
    """The redesigned kernels' SASS: HGMMA in int4_matmul's wgmma body and
    in fused_norm_matmul's swap-AB and warp-specialized bodies, HMMA in the
    chunk body's f16/bf16 kernels (dense and paged)."""
    import os
    import subprocess

    from cake_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.build())], capture_output=True, text=True,
                          check=True).stdout
    bodies = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0]
        bodies.setdefault("int4_wgmma" if "int4_wgmma_kernel" in name else
                          "chunk_tc" if "chunk_kernel_tc" in name else
                          "norm_swap_ab" if "norm_matmul_swap_ab_kernel" in name else
                          "norm_ws" if "norm_matmul_ws_kernel" in name else "other",
                          []).append(fn)
    assert bodies.get("int4_wgmma") and bodies.get("chunk_tc")
    assert bodies.get("norm_swap_ab") and bodies.get("norm_ws")
    assert all("HGMMA" in fn for fn in bodies["int4_wgmma"] + bodies["norm_swap_ab"]
               + bodies["norm_ws"])
    assert all("HMMA" in fn or "HGMMA" in fn for fn in bodies["chunk_tc"])


def test_int4_sign_extends_every_nibble(dev):
    """Packed bytes holding every nibble -8 .. 7 in both halves (a
    quantizer writes -7 .. 7; -8 only a hand-built byte holds), unit
    scales: the product is exact in f32 and must equal the plain version."""
    from cake_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_plain, unpack4

    packed = torch.arange(-128, 128, dtype=torch.int8, device=dev).reshape(16, 16).repeat(1, 2)
    lo, hi = unpack4(packed)
    assert lo.min().item() == hi.min().item() == -8 and lo.max().item() == hi.max().item() == 7
    scale = torch.ones(2, 32, dtype=torch.float32, device=dev)
    eye = torch.eye(32, device=dev)
    for dtype in DTYPES:
        got = int4_matmul(eye.to(dtype), packed, scale)
        torch.cuda.synchronize()
        assert torch.equal(got, int4_matmul_plain(eye.to(dtype), packed, scale))
        want = torch.stack([lo, hi], dim=1).reshape(32, 32).to(dtype)
        assert torch.equal(got, want)


def test_int4_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from cake_tpu_torch.ops.int4_matmul import int4_matmul

    q = _int4_weight(dev, 256, 128, 64, 0)
    x = torch.randn(3, 256, device=dev, dtype=torch.bfloat16)
    bad = [
        (x, q.w, q.scale.to(torch.bfloat16)),            # scale not f32
        (x, q.w.to(torch.uint8), q.scale),               # packed not int8
        (x.to(torch.int32), q.w, q.scale),               # activations
        (x[:, :128], q.w, q.scale),                      # in != 2 * packed rows
        (x, q.w, q.scale[:3]),                           # 3 groups: odd rows a group
        (x, q.w[:, :120], q.scale[:, :120]),             # out not a multiple of 16
        (x, q.w.t().contiguous().t(), q.scale),          # a strided packed view
        (torch.zeros(3 * 256 + 8, device=dev, dtype=torch.bfloat16)[1:3 * 256 + 1].view(3, 256),
         q.w, q.scale),                                  # x not 16-byte aligned
        (x, q.w.cpu(), q.scale),                         # mixed devices
        (x[None], q.w, q.scale),                         # x not 2-D
    ]
    for args in bad:
        with pytest.raises(ValueError):
            int4_matmul(*args)


def test_int4_generator_and_engine_on_the_card(dev, tmp_path):
    """A .q4 checkpoint (the port's save_tiny_checkpoint over an int4 tree)
    loads quantized; per-step and 4-token decode give one stream; the paged
    and dense engines give it too; every int4 product launched the kernel
    and no plain version ran."""
    from cake_tpu_torch.io.safetensors_io import save_tiny_checkpoint
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.chat import Message
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import LlamaGenerator, SamplingConfig
    from cake_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_plain
    from cake_tpu_torch.ops.quant import quantize_params, tree_quantization
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2,
                           tie_word_embeddings=False)
    params = M.init_params(cfg, torch.Generator().manual_seed(2), torch.float32)
    save_tiny_checkpoint(tmp_path, quantize_params(params, "int4"), cfg)
    greedy = SamplingConfig(temperature=0.0, repeat_penalty=1.0)
    plain0, streams = int4_matmul_plain.launches, []
    for chunk in (1, 4):
        gen = LlamaGenerator.load(tmp_path, dtype=torch.bfloat16, max_seq_len=256, sampling=greedy,
                                  device=dev, decode_chunk_size=chunk, prefill_chunk=16)
        assert tree_quantization(gen.step.params) == "int4"
        gen.add_message(Message.user("tell me a story about a cake"))
        before = int4_matmul.launches
        gen.generate(12)
        assert int4_matmul.launches > before
        streams.append(list(gen.generated_token_ids))
    assert streams[0] == streams[1]
    engine_streams = {}
    for kv_mode in ("paged", "dense"):
        serve = ServeConfig(max_batch=4, decode_chunk_size=4, kv_mode=kv_mode,
                            **({"page_size": 128} if kv_mode == "paged" else {}))
        eng = BatchEngine(cfg, gen.step.params, gen.tokenizer, max_seq_len=256,
                          cache_dtype=torch.bfloat16, serve=serve, device=dev)
        eng.start()
        try:
            hs = [eng.submit([Message.user(u)], 8, greedy) for u in ("a cake", "bread", "pie")]
            engine_streams[kv_mode] = [[t.id for t in h.tokens()] for h in hs]
        finally:
            eng.stop()
    assert engine_streams["paged"] == engine_streams["dense"]
    assert int4_matmul_plain.launches == plain0


# ------------------------------------------------------------- f8 KV caches

F8 = torch.float8_e4m3fn


def _f8(gen, dev, *shape):
    return _randn(gen, dev, F8, *shape)


def _bits_equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(kv_view(a), kv_view(b))


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_decode_kernel_f8_matches_plain_and_the_widened_cache(dev, dtype, hd, group):
    """The f8 decode body against the plain version, and to the bit the
    same kernel over the cache widened to q's dtype (exact: the body loads
    narrow and widens in registers, the rest unchanged)."""
    gen = torch.Generator(device=dev).manual_seed(hd + group + 1)
    b, n_kv, max_seq = 3, 2, 384
    q = _randn(gen, dev, dtype, b, 1, n_kv * group, hd)
    k, v = _f8(gen, dev, b, n_kv, max_seq, hd), _f8(gen, dev, b, n_kv, max_seq, hd)
    lengths = torch.tensor([1, 200, 384], dtype=torch.int32, device=dev)
    starts = torch.tensor([0, 50, 0], dtype=torch.int32, device=dev)
    for kw in ({}, {"window": 64, "softcap": 30.0, "scale": 0.2}):
        before = decode_attention.launches
        out = decode_attention(q, k, v, lengths, starts, **kw)
        assert decode_attention.launches == before + 1 and out.dtype == dtype
        _assert_close(out, decode_attention_plain(q, k, v, lengths, starts, **kw), dtype)
        wide = decode_attention(q, k.to(dtype), v.to(dtype), lengths, starts, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, wide)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_chunk_kernel_f8_matches_plain_and_the_widened_cache(dev, dtype, hd, group):
    """The f8 chunk body (narrow tiles widened in shared memory; f32: in
    registers) against the plain version, and to the bit the kernel over
    the widened cache, over several key tiles with k_starts, a window and
    a softcap."""
    gen = torch.Generator(device=dev).manual_seed(hd * group + 2)
    b, n_kv, max_seq, chunk = 2, 2, 384, 150
    q = _randn(gen, dev, dtype, b, chunk, n_kv * group, hd)
    k, v = _f8(gen, dev, b, n_kv, max_seq, hd), _f8(gen, dev, b, n_kv, max_seq, hd)
    q_starts = torch.tensor([0, 200], dtype=torch.int32, device=dev)
    lengths = q_starts + chunk
    k_starts = torch.tensor([0, 30], dtype=torch.int32, device=dev)
    flag = torch.tensor(True, device=dev)
    for args, kw in (((None, None), {}), ((flag, k_starts), {"window": 80, "softcap": 25.0})):
        before = chunk_prefill_attention.launches
        out = chunk_prefill_attention(q, k, v, q_starts, lengths, *args, **kw)
        assert chunk_prefill_attention.launches == before + 1 and out.dtype == dtype
        ref = chunk_prefill_attention_plain(q, k, v, q_starts, lengths, *args, **kw)
        _assert_close(out, ref, dtype)
        wide = chunk_prefill_attention(q, k.to(dtype), v.to(dtype), q_starts, lengths, *args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, wide)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_paged_kernels_f8_match_plain_and_dense(dev, dtype, hd):
    """The paged f8 kernels against their plain versions and, to the bit,
    the dense f8 kernels over the gathered pages (shuffled pages, an
    unmapped entry past a row's range, left pads)."""
    gen = torch.Generator(device=dev).manual_seed(hd + 3)
    n_kv, group = 2, 4
    k, v = _f8(gen, dev, 11, n_kv, PAGE, hd), _f8(gen, dev, 11, n_kv, PAGE, hd)
    tables = _tables(dev, _ROWS, 4)
    k_dense, v_dense = gather_pages(k, tables).contiguous(), gather_pages(v, tables).contiguous()
    assert k_dense.dtype == F8
    lengths = torch.tensor(_LENGTHS, dtype=torch.int32, device=dev)
    starts = torch.tensor(_STARTS, dtype=torch.int32, device=dev)
    q = _randn(gen, dev, dtype, 3, 1, n_kv * group, hd)
    paged = paged_decode_attention(q, k, v, lengths, tables, starts)
    _assert_close(paged, paged_decode_attention_plain(q, k, v, lengths, tables, starts), dtype)
    assert torch.equal(paged, decode_attention(q, k_dense, v_dense, lengths, starts))
    qc = _randn(gen, dev, dtype, 3, 150, n_kv * group, hd)
    q_starts = torch.tensor([0, 40, 350], dtype=torch.int32, device=dev)
    c_lengths = torch.tensor([150, 190, 500], dtype=torch.int32, device=dev)
    pads = torch.tensor([0, 17, 300], dtype=torch.int32, device=dev)
    chunk = paged_chunk_attention(qc, k, v, q_starts, c_lengths, pads, tables)
    ref = paged_chunk_attention_plain(qc, k, v, q_starts, c_lengths, pads, tables)
    _assert_close(chunk, ref, dtype)
    dense = chunk_prefill_attention(qc, k_dense, v_dense, q_starts, c_lengths, None, pads)
    torch.cuda.synchronize()
    assert torch.equal(chunk, dense)


@pytest.mark.parametrize("kernel", ["decode", "chunk", "paged_decode", "paged_chunk"])
def test_a_wider_cache_upgrades_the_query(dev, kernel):
    """An f32 cache under bf16 queries: the f32 kernel over the query
    upcast (the reference's widen_qkv), the output back in bf16, within
    tolerance of the plain version and to the bit the f32 call cast down."""
    gen = torch.Generator(device=dev).manual_seed(5)
    bf, n_kv, hd = torch.bfloat16, 2, 128
    lengths = torch.tensor([300, 200, 384], dtype=torch.int32, device=dev)
    starts = torch.tensor([0, 70, 130], dtype=torch.int32, device=dev)
    chunk = 1 if "decode" in kernel else 64
    q = _randn(gen, dev, bf, 3, chunk, 4 * n_kv, hd)
    if kernel.startswith("paged"):
        k, v = _pool(gen, dev, torch.float32, 10, n_kv, hd)
        tables = _tables(dev, [[7, 2, 9], [5, 0, -1], [1, 8, 3]], 3)
    else:
        k = _randn(gen, dev, torch.float32, 3, n_kv, 384, hd)
        v = _randn(gen, dev, torch.float32, 3, n_kv, 384, hd)
    q_starts = lengths - chunk
    calls = {
        "decode": lambda q_: decode_attention(q_, k, v, lengths, starts),
        "chunk": lambda q_: chunk_prefill_attention(q_, k, v, q_starts, lengths, None, starts),
        "paged_decode": lambda q_: paged_decode_attention(q_, k, v, lengths, tables, starts),
        "paged_chunk": lambda q_: paged_chunk_attention(q_, k, v, q_starts, lengths, starts,
                                                        tables),
    }
    plains = {
        "decode": lambda: decode_attention_plain(q, k, v, lengths, starts),
        "chunk": lambda: chunk_prefill_attention_plain(q, k, v, q_starts, lengths, None, starts),
        "paged_decode": lambda: paged_decode_attention_plain(q, k, v, lengths, tables, starts),
        "paged_chunk": lambda: paged_chunk_attention_plain(q, k, v, q_starts, lengths, starts,
                                                           tables),
    }
    out = calls[kernel](q)
    assert out.dtype == bf
    _assert_close(out, plains[kernel](), bf)
    assert torch.equal(out, calls[kernel](q.float()).to(bf))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("hd", [64, 96, 128])
@pytest.mark.parametrize("dtype,cache", [(d, c) for d in DTYPES for c in ("f8", "f32")
                                         if (d, c) != (torch.float32, "f32")],
                         ids=lambda x: str(x).removeprefix("torch."))
def test_ingest_kernel_f8_gives_the_plain_bits(dev, dtype, cache, hd, paged):
    """The ingest over an f8 cache (k rounded to the activations' dtype,
    then narrowed; NaN past +-464, with the sign) or an f32 cache under
    16-bit activations: q and every written cache byte equal the plain
    version's."""
    from cake_tpu_torch.ops.fused_ingest import fused_qkv_ingest, fused_qkv_ingest_plain

    kv_dt = F8 if cache == "f8" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(hd + 11)
    b, n_q, n_kv, slot = 3, 8, 2, 133
    qkv, cos, sin = _ingest_operands(gen, dev, dtype, b, n_q, n_kv, hd)
    # Row 0 (mapped in both layouts): four k and two v values past +-464,
    # roped as they are.
    qkv[0, 0, n_q * hd : n_q * hd + 4] = torch.tensor([470.0, -470.0, 1000.0, -2000.0])
    qkv[0, 0, (n_q + n_kv) * hd : (n_q + n_kv) * hd + 2] = torch.tensor([500.0, -465.5])
    cos[0, 0, :4], sin[0, 0, :4] = 1.0, 0.0
    kw = dict(n_q=n_q, n_kv=n_kv)
    if paged:
        k0, v0 = _pool(gen, dev, kv_dt, 10, n_kv, hd)
        kw["block_tables"] = _tables(dev, [[7, 2, 9], [5, -1, 1], [3, 8, 4]], 3)
    else:
        k0, v0 = _randn(gen, dev, kv_dt, b, n_kv, 256, hd), _randn(gen, dev, kv_dt, b, n_kv, 256, hd)
    k1, v1, k2, v2 = k0.clone(), v0.clone(), k0.clone(), v0.clone()
    before = fused_qkv_ingest.launches
    q1 = fused_qkv_ingest(qkv, cos, sin, slot, k1, v1, **kw)
    assert fused_qkv_ingest.launches == before + 1
    q2 = fused_qkv_ingest_plain(qkv, cos, sin, slot, k2, v2, **kw)
    torch.cuda.synchronize()
    live = slice(None, -1) if paged else slice(None)  # the sink aside
    assert torch.equal(q1, q2)
    assert _bits_equal(k1[live], k2[live]) and _bits_equal(v1[live], v2[live])
    if cache == "f8":  # the six values came back NaN, with their signs
        nan = torch.cat([kv_view(k1[live]).flatten(), kv_view(v1[live]).flatten()])
        assert sorted(nan[nan & 0x7F == 0x7F].tolist()) == [0x7F, 0x7F, 0x7F, 0xFF, 0xFF, 0xFF]


# ------------------------------------------------------------ threefry noise


@pytest.mark.parametrize("rows,n", [(None, 1), (None, 1000), (None, 128256), (1, 128256),
                                    (8, 128256), (3, 257), (5, 1)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("split", [False, True], ids=["draw", "split"])
def test_threefry_noise_matches_its_twin(dev, rows, n, split):
    """The noise kernel against its plain twin on the same keys: the next
    and sub keys, the bits and the uniforms to the bit, the gumbel plane
    within 1e-6 (the kernel's logf against torch's log) and finite; one key
    (rows None: the plane [1, n] counted over both dims) or a key a row."""
    from cake_tpu_torch.ops.threefry import prng_key, threefry_noise, threefry_noise_plain

    if rows is None:
        keys, shape = prng_key(299792458 + n, dev), (1, n)
    else:
        keys, shape = prng_key([1000 * n + r for r in range(rows)], dev), (n,)
    before = threefry_noise.launches
    for kind in ("bits", "uniform", "gumbel"):
        nxt, sub, got = threefry_noise(keys, shape, split_keys=split, kind=kind)
        r_nxt, r_sub, ref = threefry_noise_plain(keys, shape, split_keys=split, kind=kind)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert (nxt is None) == (not split) and torch.equal(sub, r_sub)
        if split:
            assert torch.equal(nxt, r_nxt)
        if kind == "gumbel":
            assert torch.isfinite(got).all()
            assert (got - ref).abs().max().item() <= 1e-6
        else:
            assert torch.equal(got, ref)
    assert threefry_noise.launches - before == 3


def test_threefry_noise_replays_in_a_graph(dev):
    """The kernel reads its key from device memory: one launch captured in
    a CUDA graph, replayed after another key is copied into the same
    buffer, draws that key's plane and writes its split."""
    from cake_tpu_torch.ops.threefry import prng_key, threefry_noise, threefry_noise_plain

    keys = prng_key([1, 2, 3, 4], dev)
    threefry_noise(keys, (4096,))  # build and load the library outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        nxt, sub, noise = threefry_noise(keys, (4096,))
    for seeds in ([5, 6, 7, 8], [9, 10, 11, 12]):
        keys.copy_(prng_key(seeds, dev))
        graph.replay()
        torch.cuda.synchronize()
        r_nxt, r_sub, ref = threefry_noise_plain(keys, (4096,))
        assert torch.equal(nxt, r_nxt) and torch.equal(sub, r_sub)
        assert (noise - ref).abs().max().item() <= 1e-6


def test_threefry_noise_refuses_what_it_cannot_draw(dev):
    from cake_tpu_torch.ops.threefry import prng_key, threefry_noise

    with pytest.raises(ValueError, match="keys must be"):
        threefry_noise(prng_key([1, 2], dev).int(), (8,))
    with pytest.raises(ValueError, match="contiguous"):
        threefry_noise(prng_key([1, 2, 3], dev).t().contiguous().t()[:, :2], (8,))
    nxt, sub, noise = threefry_noise(torch.zeros((0, 2), dtype=torch.int64, device=dev), (8,))
    assert nxt.shape == sub.shape == (0, 2) and noise.shape == (0, 8)


# ---------------------------------------------------------------- sparse MoE


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("t", [1, 3, 24], ids=["decode", "dense", "grouped"])
def test_moe_swiglu_on_the_card_matches_the_cpu(dev, t, quant):
    """The dense combine (t < 8) and the grouped dispatch (t >= 8) on the
    card give the CPU's experts (the same routing) and its output within
    bf16 rounding: one bf16 step of the output's magnitude."""
    from cake_tpu_torch.ops import moe
    from cake_tpu_torch.ops.quant import quantize_weight

    gen = torch.Generator().manual_seed(t)
    h, n_e, inter, b = 128, 8, 96, 2
    x = torch.randn(b, t, h, generator=gen).to(torch.bfloat16)
    ws = [torch.randn(*s, generator=gen).mul(s[-2] ** -0.5).to(torch.bfloat16)
          for s in ((h, n_e), (n_e, h, inter), (n_e, h, inter), (n_e, inter, h))]
    if quant:
        ws[1:] = [quantize_weight(w) for w in ws[1:]]
    cpu = moe.moe_swiglu(x, *ws, top_k=2)
    on = [w.to(dev) if isinstance(w, torch.Tensor) else type(w)(w.w.to(dev), w.scale.to(dev))
          for w in ws]
    card = moe.moe_swiglu(x.to(dev), *on, top_k=2)
    torch.cuda.synchronize()
    assert card.shape == cpu.shape and card.dtype == torch.bfloat16
    assert torch.isfinite(card).all()
    step = 2.0 ** -7 * cpu.float().abs().max().item()
    assert (card.cpu().float() - cpu.float()).abs().max().item() <= step
    logits = x @ ws[0]
    _, idx_cpu = moe.route_topk_select(logits, 2)
    _, idx_card = moe.route_topk_select(logits.to(dev), 2)
    assert torch.equal(idx_card.cpu(), idx_cpu)


def test_moe_grouped_dispatch_refuses_a_capture(dev):
    from cake_tpu_torch.ops import moe

    h, n_e = 64, 4
    x = torch.randn(1, 16, h, device=dev, dtype=torch.bfloat16)
    w = torch.randn(n_e, h, h, device=dev, dtype=torch.bfloat16)
    router = torch.randn(h, n_e, device=dev, dtype=torch.bfloat16)
    moe.moe_swiglu(x, router, w, w, w, top_k=2)  # eager: fine
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(graph):
            moe.moe_swiglu(x, router, w, w, w, top_k=2)
    out = moe.moe_swiglu(x[:, :1], router, w, w, w, top_k=2)  # the dense combine still runs
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()


def _grouped_case(dev, dtype, sizes, k, n, quant, seed):
    from cake_tpu_torch.ops.quant import quantize_weight

    gen = torch.Generator(device=dev).manual_seed(seed)
    m = sum(sizes)
    xs = _randn(gen, dev, dtype, m, k)
    w = _randn(gen, dev, torch.float32, len(sizes), k, n).mul(k ** -0.5)
    mats = quantize_weight(w).w if quant else w.to(dtype)
    offsets = torch.zeros(len(sizes) + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(torch.tensor(sizes, device=dev), 0)
    return xs, mats, offsets


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("sizes,k,n", [([3, 0, 70, 1], 128, 96), ([130, 64, 0, 5, 17, 1, 0, 9], 256, 384),
                                       ([0, 0, 1], 96, 48)],
                         ids=["4e", "8e", "one_row"])
def test_moe_grouped_kernel_matches_plain(dev, dtype, sizes, k, n, quant):
    """The grouped expert GEMM equals its plain version (one product an
    expert) within one rounding step of the output's magnitude (f32: 1e-4
    relative), empty groups included."""
    from cake_tpu_torch.ops.moe import grouped_matmul, grouped_matmul_plain

    if quant and n % 16:
        pytest.skip("int8 stacks need a multiple of 16 columns")
    xs, mats, offsets = _grouped_case(dev, dtype, sizes, k, n, quant, 5)
    out = grouped_matmul(xs, mats, offsets, sizes)
    ref = grouped_matmul_plain(xs, mats, sizes)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == dtype and torch.isfinite(out).all()
    mag = ref.float().abs().max().item()
    step = {torch.float32: 1e-4, torch.float16: 2.0 ** -10, torch.bfloat16: 2.0 ** -7}[dtype]
    assert (out.float() - ref.float()).abs().max().item() <= step * mag


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_moe_grouped_rows_are_independent_of_the_group_sizes(dev, quant):
    """The same rows give the same bits whatever shares their expert's
    group: expert 1's rows alone, among 9 others, among 300 others, and
    split across tiles at another offset."""
    from cake_tpu_torch.ops.moe import grouped_matmul

    xs, mats, _ = _grouped_case(dev, torch.bfloat16, [400, 400], 4096, 1024, quant, 9)
    probe = xs[:7]

    def run(n_e0, before, after):
        # expert 0 takes n_e0 rows; expert 1 the probe between its neighbours
        rows = torch.cat([xs[700 : 700 + n_e0], xs[400 : 400 + before], probe,
                          xs[100 : 100 + after]])
        sizes = [n_e0, before + 7 + after]
        offsets = torch.tensor([0, sizes[0], sum(sizes)], dtype=torch.int32, device=dev)
        out = grouped_matmul(rows, mats, offsets, sizes)
        return out[n_e0 + before : n_e0 + before + 7]

    ref = run(0, 0, 0)
    for n_e0, before, after in [(0, 0, 9), (3, 0, 300), (0, 64, 0), (5, 61, 250), (64, 130, 5)]:
        assert torch.equal(run(n_e0, before, after), ref), (n_e0, before, after)


def test_moe_grouped_kernel_refuses_what_it_does_not_take(dev):
    from cake_tpu_torch.ops.moe import grouped_matmul

    xs, mats, offsets = _grouped_case(dev, torch.bfloat16, [4, 4], 48, 64, False, 1)
    with pytest.raises(ValueError, match="multiple of 32"):
        grouped_matmul(xs, mats, offsets, [4, 4])
    xs, mats, offsets = _grouped_case(dev, torch.bfloat16, [4, 4], 64, 64, False, 1)
    with pytest.raises(TypeError):
        grouped_matmul(xs, mats.half(), offsets, [4, 4])
    with pytest.raises(ValueError, match="offsets"):
        grouped_matmul(xs, mats, offsets.long(), [4, 4])


# The engine prefill's rows an expert at Mixtral's widths (phase moe of
# chip_smoke.py), and a seeded layout at Qwen3-30B-A3B's: 512 tokens, top 8
# of 128 experts, skewed, so many experts get a handful of rows and some none.
MIXTRAL_SIZES = [3162, 48, 759, 0, 8, 80, 2273, 1094]


def _qwen3_sizes():
    gen = torch.Generator().manual_seed(3)
    pref = torch.randn(128, generator=gen).mul(1.5).exp()
    picks = torch.multinomial(pref.expand(512, 128), 8, generator=gen)
    return torch.bincount(picks.flatten(), minlength=128).tolist()


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("model,k,n", [("mixtral", 4096, 14336), ("mixtral", 14336, 4096),
                                       ("qwen3", 2048, 768), ("qwen3", 768, 2048)],
                         ids=["mixtral_gate", "mixtral_down", "qwen3_gate", "qwen3_down"])
def test_moe_grouped_kernel_matches_plain_at_model_widths(dev, model, k, n, quant):
    """The kernel at the widths its models run it, against its plain
    version: within one bf16 rounding step of the output's magnitude."""
    from cake_tpu_torch.ops.moe import grouped_matmul, grouped_matmul_plain

    sizes = MIXTRAL_SIZES if model == "mixtral" else _qwen3_sizes()
    xs, mats, offsets = _grouped_case(dev, torch.bfloat16, sizes, k, n, quant, 11)
    out = grouped_matmul(xs, mats, offsets, sizes)
    ref = grouped_matmul_plain(xs, mats, sizes)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and torch.isfinite(out).all()
    step = 2.0 ** -7 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= step


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_moe_grouped_rows_straddling_tiles_are_independent(dev, dtype, quant):
    """Probe rows that straddle a warpgroup's 64 rows, a block's 128, an
    item's 256 and 384 give the bits they give alone at the top of the
    group."""
    from cake_tpu_torch.ops.moe import grouped_matmul

    xs, mats, _ = _grouped_case(dev, dtype, [700, 700], 1024, 512, quant, 12)
    probe = xs[:7]

    def run(n_e0, before, after):
        rows = torch.cat([xs[1000 : 1000 + n_e0], xs[300 : 300 + before], probe,
                          xs[100 : 100 + after]])
        sizes = [n_e0, before + 7 + after]
        offsets = torch.tensor([0, sizes[0], sum(sizes)], dtype=torch.int32, device=dev)
        return grouped_matmul(rows, mats, offsets, sizes)[n_e0 + before : n_e0 + before + 7]

    ref = run(0, 0, 0)
    for n_e0, before, after in [(3, 60, 200), (0, 124, 5), (97, 253, 40), (1, 381, 2),
                                (255, 122, 0), (256, 250, 300)]:
        assert torch.equal(run(n_e0, before, after), ref), (n_e0, before, after)


def test_moe_grouped_kernels_run_the_tensor_cores(dev):
    """The grouped GEMM's SASS: HGMMA in both wgmma bodies (16-bit stacks
    and swap AB for int8 stacks), f16 and bf16."""
    import os
    import subprocess

    from cake_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.build())], capture_output=True, text=True,
                          check=True).stdout
    bodies = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0]
        for body in ("grouped_ws_kernel", "grouped_swap_kernel"):
            if body in name:
                bodies.setdefault(body, []).append(fn)
    assert len(bodies.get("grouped_ws_kernel", [])) == 4  # f16/bf16 x 128/256 columns
    assert len(bodies.get("grouped_swap_kernel", [])) == 2
    assert all("HGMMA" in fn for fns in bodies.values() for fn in fns)


# ------------------------------------------------- the rolling ring layout


def _ring_from_full(full, ring, newest):
    """The ring a rolling cache of ``ring`` slots holds for rows whose newest
    written position is ``newest`` (a list): slot s holds the full cache's
    position rolling_kv_positions gives it (f8 gathered by bytes)."""
    from cake_tpu_torch.models.llama.cache import rolling_kv_positions

    rows = []
    for r, p in enumerate(newest):
        kpos = rolling_kv_positions(ring, p, 1).clamp(min=0, max=full.shape[2] - 1).to(full.device)
        rows.append(kv_view(full[r : r + 1])[:, :, kpos])
    return torch.cat(rows).view(full.dtype).contiguous()


RING_KV = [torch.bfloat16, torch.float16, torch.float32, torch.float8_e4m3fn]
# A relative L2 error beside the max-abs TOL: a ring output averages many
# keys, and a dropped or misplaced split moves it by far more than this.
RING_REL_TOL = {torch.float32: 1e-4, torch.float16: 1e-2, torch.bfloat16: 1e-2}


def _assert_rel_l2(out, ref, dtype):
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= RING_REL_TOL[dtype], f"relative L2 {rel} > {RING_REL_TOL[dtype]}"


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("kv", RING_KV, ids=str)
@pytest.mark.parametrize("group", [1, 4, 16])
def test_ring_decode_matches_plain_and_dense_bits(dev, kv, hd, group):
    """The ring decode instantiation (ring_limit) within TOL and RING_REL_TOL
    of the ring's plain version and bitwise the dense kernel over the same keys in the
    full cache, rows before, at and past several wraps."""
    from cake_tpu_torch.ops.decode_attention import decode_ring_plain

    dtype = torch.bfloat16 if kv == torch.float8_e4m3fn else kv
    gen = torch.Generator(device=dev).manual_seed(hd + group)
    b, n_kv, ring, limit, window = 4, 2, 256, 1152, 200
    q = _randn(gen, dev, dtype, b, 1, n_kv * group, hd)
    full_k = _randn(gen, dev, dtype, b, n_kv, limit, hd).to(kv)
    full_v = _randn(gen, dev, dtype, b, n_kv, limit, hd).to(kv)
    lens = [1, 256, 700, 1152]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    rk = _ring_from_full(full_k, ring, [n - 1 for n in lens])
    rv = _ring_from_full(full_v, ring, [n - 1 for n in lens])
    out = decode_attention(q, rk, rv, lengths, window=window, ring_limit=limit)
    ref = decode_ring_plain(q, rk, rv, lengths, window=window)
    _assert_close(out, ref, dtype)
    _assert_rel_l2(out, ref, dtype)
    dense = decode_attention(q, full_k, full_v, lengths, window=window)
    assert torch.equal(out, dense)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("kv", RING_KV, ids=str)
@pytest.mark.parametrize("group", [1, 4])
def test_ring_chunk_matches_plain_and_dense_bits(dev, kv, hd, group):
    """The ring chunk instantiation: a continuation chunk whose keys
    straddle the ring's wrap, within TOL and RING_REL_TOL of its plain
    version and bitwise
    the dense kernel's over the full cache."""
    from cake_tpu_torch.ops.chunk_prefill import chunk_ring_plain

    dtype = torch.bfloat16 if kv == torch.float8_e4m3fn else kv
    gen = torch.Generator(device=dev).manual_seed(hd * group)
    b, n_kv, ring, limit, window, chunk = 2, 2, 256, 1024, 150, 96
    q_starts = [300, 650]
    q = _randn(gen, dev, dtype, b, chunk, n_kv * group, hd)
    full_k = _randn(gen, dev, dtype, b, n_kv, limit, hd).to(kv)
    full_v = _randn(gen, dev, dtype, b, n_kv, limit, hd).to(kv)
    qs = torch.tensor(q_starts, dtype=torch.int32, device=dev)
    lengths = qs + chunk
    newest = [s + chunk - 1 for s in q_starts]
    rk, rv = _ring_from_full(full_k, ring, newest), _ring_from_full(full_v, ring, newest)
    out = chunk_prefill_attention(q, rk, rv, qs, lengths, window=window, ring_limit=limit)
    ref = chunk_ring_plain(q, rk, rv, qs, lengths, window=window)
    _assert_close(out, ref, dtype)
    _assert_rel_l2(out, ref, dtype)
    dense = chunk_prefill_attention(q, full_k, full_v, qs, lengths, window=window)
    assert torch.equal(out, dense)


def test_ring_wrappers_count_and_refuse(dev):
    """Ring launches count in the wrappers' ``ring`` side counts; a ring of
    a length the layout cannot take, or a window that does not fit it, is
    refused before a launch."""
    from cake_tpu_torch.ops import chunk_prefill, decode_attention as D

    q = torch.zeros(1, 1, 4, 128, device=dev, dtype=torch.bfloat16)
    kv = torch.zeros(1, 2, 256, 128, device=dev, dtype=torch.bfloat16)
    lengths = torch.tensor([300], dtype=torch.int32, device=dev)
    before = D.decode_attention.ring, chunk_prefill.chunk_prefill_attention.ring
    decode_attention(q, kv, kv, lengths, window=100, ring_limit=512)
    chunk_prefill_attention(q.expand(1, 8, 4, 128).contiguous(), kv, kv,
                            torch.tensor([292], dtype=torch.int32, device=dev), lengths,
                            window=100, ring_limit=512)
    assert (D.decode_attention.ring, chunk_prefill.chunk_prefill_attention.ring) == (
        before[0] + 1, before[1] + 1)
    bad = torch.zeros(1, 2, 192, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ring"):
        decode_attention(q, bad, bad, lengths, window=100, ring_limit=512)
    with pytest.raises(ValueError, match="ring"):
        decode_attention(q, kv, kv, lengths, window=300, ring_limit=512)


def test_rolling_generator_equals_the_full_cache_on_the_card(dev):
    """A tiny Mistral on the card over the ring (ring kernels) and over the
    full cache (dense kernels): the same greedy ids past several wraps, and
    the first decode step's logits to the bit."""
    import numpy as np

    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import LocalForwardStep

    cfg = LlamaConfig.tiny(model_type="mistral", sliding_window=100, num_hidden_layers=2,
                           hidden_size=256, num_attention_heads=2, num_key_value_heads=1)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(3), torch.bfloat16, dev)
    rng = np.random.default_rng(0)
    prompt = [int(t) for t in rng.integers(0, 256, 400)]
    out = {}
    for name, budget in (("full", None), ("rolling", 64)):
        step = LocalForwardStep(cfg, params, max_seq_len=1024, cache_dtype=torch.bfloat16,
                                device=dev, rolling_budget=budget)
        assert step.rolling == (budget is not None)
        pos, logits, firsts = 0, None, []
        while pos < len(prompt):
            part = prompt[pos : pos + 64]
            buf = np.zeros((1, 64), np.int64)
            buf[0, : len(part)] = part
            logits = step(buf, pos, len(part))
            pos += len(part)
        ids = []
        for _ in range(200):
            nxt = int(torch.argmax(logits[0]))
            ids.append(nxt)
            logits = step(np.asarray([[nxt]]), pos, 1)
            firsts.append(logits)
            pos += 1
        out[name] = (ids, firsts[0])
    assert out["rolling"][0] == out["full"][0]
    assert torch.equal(out["rolling"][1], out["full"][1])
