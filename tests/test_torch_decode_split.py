"""The decode kernels' split design (flash-decoding), on the CPU.

``ops/decode_attention.plan`` and ``live_splits`` are the geometry the CUDA
kernel (``ops/csrc/decode_attention.cuh``) launches with: they are pinned
here without a card. A test-only f32 model of the kernel's arithmetic, each
live split's partial softmax state merged in ascending split order, is held
to the port's plain versions and to the JAX package's Pallas kernels
(interpret mode on the CPU, as the JAX package's own tests run them) within
1e-4 max-abs (XLA and torch reduce in different orders).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.ops.pallas.decode_attention import decode_attention as jax_decode
from cake_tpu.ops.pallas.paged_attention import paged_decode_attention as jax_paged_decode
from cake_tpu_torch.models.llama.paged_cache import gather_pages
from cake_tpu_torch.ops.decode_attention import (
    SPLIT,
    SMS,
    decode_attention_plain,
    live_splits,
    plan,
    row_bounds,
)
from cake_tpu_torch.ops.paged_attention import paged_decode_attention_plain
from cake_tpu_torch.ops.paged_prefill import paged_kernel_supported

TOL = 1e-4
PAGE = 128  # the JAX Pallas paged kernel takes 128-slot pages


def _t(a):
    return torch.from_numpy(np.array(a))


def split_combine(q, k, v, lengths, starts, *, scale=None, softcap=None):
    """Test-only f32 model of the kernel: every live split of a row (keys cut
    at multiples of SPLIT) gives a partial (max m, sum l, acc) per query
    head; the partials merge in ascending split order. q [b, 1, n_q, hd],
    k/v head-major [b, n_kv, limit, hd], starts already folded (window)."""
    b, _, n_q, hd = q.shape
    n_kv, limit = k.shape[1], k.shape[2]
    scale = hd**-0.5 if scale is None else scale
    out = torch.zeros(b, n_q, hd)
    for r in range(b):
        qr = q[r, 0].reshape(n_kv, n_q // n_kv, hd)
        parts = []
        for lo, hi in live_splits(int(starts[r]), int(lengths[r]), limit):
            s = torch.einsum("kgd,ksd->kgs", qr, k[r, :, lo:hi]) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            parts.append((m, p.sum(-1, keepdim=True), torch.einsum("kgs,ksd->kgd", p, v[r, :, lo:hi])))
        if not parts:
            continue  # an empty row is zeros
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        lsum, acc = torch.zeros_like(mx), torch.zeros(n_kv, n_q // n_kv, hd)
        for m, l, a in parts:
            c = torch.exp(m - mx)
            lsum = lsum + l * c
            acc = acc + a * c
        out[r] = (acc / lsum).reshape(n_q, hd)
    return out.reshape(b, 1, n_q, hd)


# ------------------------------------------------------------- geometry


def test_split_size_fits_every_kernel_page():
    assert 128 % SPLIT == 0
    pages = [p for p in range(1, 1025) if paged_kernel_supported(p)]
    assert pages and all(p % SPLIT == 0 for p in pages)


@pytest.mark.parametrize("start,length", [(0, 1), (0, 733), (10, 64), (63, 65), (64, 128),
                                          (129, 512), (500, 2048)])
def test_split_points_depend_on_positions_only(start, length):
    want = live_splits(start, length, 2048)
    assert live_splits(start, length, 8192) == want
    assert want[0][0] == start and want[-1][1] == length
    # Inner edges sit on multiples of SPLIT; every split is inside one.
    for (lo, hi), (nlo, _) in zip(want, want[1:]):
        assert hi == nlo and hi % SPLIT == 0
    assert all(lo // SPLIT == (hi - 1) // SPLIT for lo, hi in want)
    assert live_splits(start, start, 2048) == []


def test_grid_depends_on_shapes_only():
    assert list(inspect.signature(plan).parameters) == [
        "b", "n_kv", "group", "head_dim", "limit", "sms"]
    assert plan(1, 8, 4, 128, 8192) == plan(1, 8, 4, 128, 8192, SMS)
    for b in (1, 8):
        for limit in (2048, 8192):
            p = plan(b, 8, 4, 128, limit)
            assert 1 <= p.z <= p.n_split == limit // SPLIT


@pytest.mark.parametrize("b,n_kv,group,hd,limit", [(1, 8, 4, 128, 8192), (8, 8, 4, 128, 2048),
                                                   (3, 2, 8, 256, 384), (2, 1, 1, 64, 100)])
def test_scratch_holds_every_partial(b, n_kv, group, hd, limit):
    p = plan(b, n_kv, group, hd, limit)
    assert p.scratch == b * n_kv * p.n_split * group * (hd + 2)
    # The furthest split a row can reach has its slot.
    (lo, _), = live_splits(limit - 1, limit, limit)
    assert lo // SPLIT == p.n_split - 1


@pytest.mark.parametrize("shape", ["generator", "engine"])
def test_llama3_8b_shapes_give_each_live_split_a_block(shape):
    """At Llama-3-8B's generator shape (batch 1, 8 KV heads, max_seq 8192, a
    733-key row) and the engine's (8 lanes, 16 pages of 128, rows of
    470-536 keys), z covers every live split of a row, so each gets a block
    of its own: ceil(733 / SPLIT) blocks a KV head (12 at SPLIT = 64), and
    at the engine about 9 a (KV head, row) (~540 blocks at 64), where one
    block a (KV head, row) took the whole row before (8 and 64 blocks)."""
    if shape == "generator":
        b, limit, rows = 1, 8192, [(0, 733)]
    else:
        b, limit, rows = 8, 16 * 128, [(st, 536) for st in (0, 3, 17, 40, 66, 12, 25, 5)]
    p = plan(b, 8, 4, 128, limit)
    counts = [len(live_splits(st, ln, limit)) for st, ln in rows]
    assert all(c <= p.z for c in counts)
    assert counts == [-(-ln // SPLIT) - st // SPLIT for st, ln in rows]
    working = 8 * sum(counts)
    if shape == "generator":
        assert working == 8 * -(-733 // SPLIT)
    assert working >= 4 * 8 * b  # against the b * n_kv blocks of one block a row


# ------------------------------------------------------------- arithmetic

# (lengths, starts, window, window_flag, scale, softcap), b = 4, max_seq 384.
DENSE_CASES = {
    "single_and_edges": ([1, SPLIT - 1, SPLIT + 1, 384], None, None, None, None, None),
    "starts_inside_and_on_edges": ([300, 200, 384, 130], [10, SPLIT, SPLIT + 1, SPLIT - 1],
                                   None, None, None, None),
    "window": ([300, 200, 384, 130], [0, 70, 0, 5], 100, True, None, None),
    "window_off_softcap": ([300, 200, 384, 130], [0, 70, 0, 5], 100, False, 0.2, 30.0),
    "softcap": ([1, 77, 256, 384], None, None, None, 0.15, 20.0),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
@pytest.mark.parametrize("group", [1, 4])
def test_split_model_matches_plain_and_jax(case, group):
    lens, starts, win, flag, scale, softcap = DENSE_CASES[case]
    rng = np.random.default_rng(group)
    b, n_kv, hd, max_seq = 4, 2, 64, 384
    q = rng.standard_normal((b, 1, n_kv * group, hd)).astype(np.float32)
    k = rng.standard_normal((b, n_kv, max_seq, hd)).astype(np.float32)
    v = rng.standard_normal((b, n_kv, max_seq, hd)).astype(np.float32)
    st = None if starts is None else np.asarray(starts, np.int32)
    pflag = None if flag is None else torch.tensor(flag)
    lengths, folded = row_bounds(_t(q), _t(np.asarray(lens, np.int32)),
                                 None if st is None else _t(st), win, pflag)
    got = split_combine(_t(q), _t(k), _t(v), lengths, folded, scale=scale, softcap=softcap)
    plain = decode_attention_plain(_t(q), _t(k), _t(v), _t(np.asarray(lens, np.int32)),
                                   None if st is None else _t(st), pflag,
                                   window=win, scale=scale, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL, rtol=0)
    want = jax_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(np.asarray(lens, np.int32)),
        None if st is None else jnp.asarray(st), None if flag is None else jnp.bool_(flag),
        window=win, scale=scale, softcap=softcap, interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_split_model_writes_zeros_for_an_empty_row():
    rng = np.random.default_rng(3)
    q = _t(rng.standard_normal((4, 1, 8, 64)).astype(np.float32))
    k = _t(rng.standard_normal((4, 2, 256, 64)).astype(np.float32))
    v = _t(rng.standard_normal((4, 2, 256, 64)).astype(np.float32))
    lengths = _t(np.array([100, 50, 200, 7], np.int32))
    starts = _t(np.array([0, 50, 130, 9], np.int32))  # rows 1 and 3 are empty
    got = split_combine(q, k, v, lengths, starts)
    assert torch.equal(got[[1, 3]], torch.zeros_like(got[[1, 3]]))
    plain = decode_attention_plain(q, k, v, lengths, starts)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL, rtol=0)
    live = [0, 2]  # the JAX kernel takes rows with start < length only
    want = jax_decode(jnp.asarray(q.numpy()[live]), jnp.asarray(k.numpy()[live]),
                      jnp.asarray(v.numpy()[live]), jnp.asarray(lengths.numpy()[live]),
                      jnp.asarray(starts.numpy()[live]), interpret=True)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want), atol=TOL, rtol=0)


# Shuffled physical pages; row 1's third entry is unmapped past its live range.
TABLES = np.array([[7, 2, 9], [5, 0, -1], [1, 8, 3]], np.int32)
PAGED_KNOBS = {
    "plain": {},
    "softcap": {"softcap": 30.0, "scale": 0.2},
    "window": {"window": 100, "window_flag": True},
}


@pytest.mark.parametrize("knobs", list(PAGED_KNOBS))
def test_split_model_matches_paged_plain_and_jax(knobs):
    kw = dict(PAGED_KNOBS[knobs])
    flag = kw.pop("window_flag", None)
    rng = np.random.default_rng(11)
    n_kv, hd, group = 2, 64, 4
    shape = (10, n_kv, PAGE, hd)
    kp, vp = rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32)
    q = rng.standard_normal((3, 1, n_kv * group, hd)).astype(np.float32)
    lengths = np.array([300, 200, 384], np.int32)  # mid-page and page-edge ends
    starts = np.array([0, 70, 130], np.int32)  # left pads inside a split
    sink = np.zeros((1,) + shape[1:], np.float32)  # the port's write-sink page
    pk, pv = _t(np.concatenate([kp, sink])), _t(np.concatenate([vp, sink]))
    pflag = None if flag is None else torch.tensor(flag)
    lens_t, folded = row_bounds(_t(q), _t(lengths), _t(starts), kw.get("window"), pflag)
    dk, dv = gather_pages(pk, _t(TABLES)), gather_pages(pv, _t(TABLES))
    got = split_combine(_t(q), dk, dv, lens_t, folded,
                        scale=kw.get("scale"), softcap=kw.get("softcap"))
    plain = paged_decode_attention_plain(_t(q), pk, pv, _t(lengths), _t(TABLES), _t(starts),
                                         pflag, **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL, rtol=0)
    want = jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lengths),
        jnp.asarray(TABLES), jnp.asarray(starts), None if flag is None else jnp.asarray(flag),
        **kw,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_split_model_rows_do_not_depend_on_the_batch_or_the_width():
    """A row's bits depend only on its own keys' positions: the same alone
    and beside 7 rows of other lengths, under max_seq 2048 and 8192."""
    rng = np.random.default_rng(5)
    n_kv, hd = 2, 64
    q = _t(rng.standard_normal((8, 1, 8, hd)).astype(np.float32))
    k = _t(rng.standard_normal((8, n_kv, 8192, hd)).astype(np.float32))
    v = _t(rng.standard_normal((8, n_kv, 8192, hd)).astype(np.float32))
    lengths = _t(np.array([733, 1, 64, 65, 2000, 300, 129, 1500], np.int32))
    starts = _t(np.array([5, 0, 0, 63, 100, 299, 64, 0], np.int32))
    wide = split_combine(q, k, v, lengths, starts)
    narrow = split_combine(q, k[:, :, :2048].contiguous(), v[:, :, :2048].contiguous(),
                           lengths, starts)
    assert torch.equal(wide, narrow)
    alone = split_combine(q[:1], k[:1], v[:1], lengths[:1], starts[:1])
    assert torch.equal(alone, wide[:1])
