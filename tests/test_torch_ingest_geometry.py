"""The decode ingest's thread split, on the CPU.

``ops/fused_ingest.plan`` is the geometry the CUDA kernel
(``ops/csrc/fused_ingest.cu``) launches with: a grid of ``(blocks, b)``,
each thread owning one vector of a q/k head's first half and the matching
vector of its second half, or one vector of a v head, mapped from its index
by shifts. A test-only model walks that mapping thread by thread: it must
reach every (row, head, vector) exactly once, and the model's writes, each
thread's rope rounded op by op, must give the plain version's q and cache
bits, dense and through a block table.
"""

import pytest
import torch

from cake_tpu_torch.ops.fused_ingest import THREADS, fused_qkv_ingest_plain, plan

HEAD_DIMS = [64, 80, 96, 128, 256]
HEADS = [(32, 8), (8, 1), (16, 16)]
DTYPES = [torch.float32, torch.float16, torch.bfloat16]


def threads_of(p, n_q, n_kv):
    """Each working thread of a row as the kernel maps it: (kind, head, j)
    with kind "rope" (q heads, then k heads) or "v"."""
    out = []
    n_rope = (n_q + n_kv) << p.rope_shift
    for bx in range(p.blocks):
        for tx in range(p.threads):
            t = bx * p.threads + tx
            rope = t < n_rope
            u = t if rope else t - n_rope
            shift = p.rope_shift if rope else p.v_shift
            head, j = u >> shift, u & ((1 << shift) - 1)
            out.append(("rope" if rope else "v", head, j))
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n_q,n_kv", HEADS)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_plan_covers_every_head_vector_once(hd, n_q, n_kv, dtype):
    p = plan(3, n_q, n_kv, hd, dtype)
    item = torch.empty((), dtype=dtype).element_size()
    half = hd // 2
    assert p.vec_rope * item <= 16 and half % p.vec_rope == 0
    assert p.vec_v * item <= 16 and hd % p.vec_v == 0
    # 16 bytes a vector wherever the head allows it
    assert p.vec_rope * item == 16 or (half * item) % (2 * p.vec_rope * item)
    assert p.vec_v * item == 16 or (hd * item) % (2 * p.vec_v * item)
    assert p.threads <= THREADS and p.threads % 32 == 0
    covered = {}
    for kind, head, j in threads_of(p, n_q, n_kv):
        if kind == "rope":
            if j * p.vec_rope >= half:
                continue  # an idle thread of a power-of-two head
            assert head < n_q + n_kv
            for e in range(j * p.vec_rope, (j + 1) * p.vec_rope):
                for el in (e, e + half):
                    covered[(head, el)] = covered.get((head, el), 0) + 1
        else:
            if head >= n_kv or j * p.vec_v >= hd:
                continue
            for el in range(j * p.vec_v, (j + 1) * p.vec_v):
                key = (n_q + n_kv + head, el)
                covered[key] = covered.get(key, 0) + 1
    want = {(h, e) for h in range(n_q + 2 * n_kv) for e in range(hd)}
    assert set(covered) == want and set(covered.values()) == {1}
    # no block is wholly idle
    per_row = ((n_q + n_kv) << p.rope_shift) + (n_kv << p.v_shift)
    assert (p.blocks - 1) * p.threads < per_row <= p.blocks * p.threads


def test_plan_depends_on_the_shapes_only():
    p = plan(8, 32, 8, 128, torch.bfloat16)
    assert plan(1, 32, 8, 128, torch.bfloat16) == p  # the rows are the grid's y
    # Llama-3-8B in bf16: 40 x 8 rope threads plus 8 x 16 copy threads a row
    assert (p.vec_rope, p.vec_v, 1 << p.rope_shift, 1 << p.v_shift) == (8, 8, 8, 16)
    assert (40 << p.rope_shift) + (8 << p.v_shift) == 448 and (p.blocks, p.threads) == (4, 128)


def split_ingest(qkv, cos, sin, slot, k_cache, v_cache, *, n_q, n_kv, block_tables=None):
    """Test-only model of the kernel: each working thread of plan()'s split
    ropes its two vectors in f32, each product and sum its own op, and
    writes q, k at the slot, or copies its v vector; the paged slot's page
    and offset divided once, the page clamped before the lookup, an
    unmapped or past-the-table entry dropping the row's writes."""
    b = qkv.shape[0]
    hd = qkv.shape[-1] // (n_q + 2 * n_kv)
    half = hd // 2
    p = plan(b, n_q, n_kv, hd, qkv.dtype)
    q = torch.zeros(b, 1, n_q, hd, dtype=qkv.dtype)
    seq = k_cache.shape[2]
    page, off = (slot // seq, slot % seq) if block_tables is not None else (0, slot)
    for row in range(b):
        x = qkv[row, 0].reshape(n_q + 2 * n_kv, hd)
        c, s = cos[row].reshape(half), sin[row].reshape(half)
        if block_tables is None:
            dest = row
        else:
            n_p = block_tables.shape[1]
            phys = int(block_tables[row, min(page, n_p - 1)])
            dest = phys if page < n_p and phys >= 0 else None
        for kind, head, j in threads_of(p, n_q, n_kv):
            if kind == "rope" and j * p.vec_rope < half:
                lo, hi = j * p.vec_rope, (j + 1) * p.vec_rope
                x1, x2 = x[head, lo:hi].float(), x[head, half + lo : half + hi].float()
                o1 = (x1 * c[lo:hi] - x2 * s[lo:hi]).to(qkv.dtype)
                o2 = (x2 * c[lo:hi] + x1 * s[lo:hi]).to(qkv.dtype)
                if head < n_q:
                    q[row, 0, head, lo:hi], q[row, 0, head, half + lo : half + hi] = o1, o2
                elif dest is not None:
                    kh = k_cache[dest, head - n_q, off]
                    kh[lo:hi], kh[half + lo : half + hi] = o1, o2
            elif kind == "v" and head < n_kv and j * p.vec_v < hd and dest is not None:
                lo, hi = j * p.vec_v, (j + 1) * p.vec_v
                v_cache[dest, head, off, lo:hi] = x[n_q + n_kv + head, lo:hi]
    return q


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("hd,n_q,n_kv", [(64, 8, 1), (96, 16, 16), (128, 8, 2), (80, 4, 2)])
def test_split_model_gives_the_plain_bits_dense_and_paged(dtype, hd, n_q, n_kv):
    g = torch.Generator().manual_seed(hd + n_q)
    b, slot, page = 3, 37, 16
    qkv = torch.randn(b, 1, (n_q + 2 * n_kv) * hd, generator=g).to(dtype)
    cos = torch.randn(b, 1, hd // 2, generator=g)
    sin = torch.randn(b, 1, hd // 2, generator=g)
    kw = dict(n_q=n_q, n_kv=n_kv)
    k0 = torch.randn(b, n_kv, 64, hd, generator=g).to(dtype)
    v0 = torch.randn(b, n_kv, 64, hd, generator=g).to(dtype)
    k1, v1, k2, v2 = k0.clone(), v0.clone(), k0.clone(), v0.clone()
    q1 = split_ingest(qkv, cos, sin, slot, k1, v1, **kw)
    q2 = fused_qkv_ingest_plain(qkv, cos, sin, slot, k2, v2, **kw)
    assert torch.equal(q1, q2) and torch.equal(k1, k2) and torch.equal(v1, v2)
    # paged: slot 37 is logical page 2; row 1's entry there is unmapped,
    # and a slot past the table drops every write.
    n_pages = 9
    kp = torch.randn(n_pages + 1, n_kv, page, hd, generator=g).to(dtype)
    vp = torch.randn(n_pages + 1, n_kv, page, hd, generator=g).to(dtype)
    tables = torch.tensor([[7, 2, 5], [4, 1, -1], [0, 8, 3]], dtype=torch.int32)
    for s in (slot, 3 * page + 5):
        k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        q1 = split_ingest(qkv, cos, sin, s, k1, v1, block_tables=tables, **kw)
        q2 = fused_qkv_ingest_plain(qkv, cos, sin, s, k2, v2, block_tables=tables, **kw)
        assert torch.equal(q1, q2)
        # every page but the sink, where the plain path sends dropped writes
        assert torch.equal(k1[:-1], k2[:-1]) and torch.equal(v1[:-1], v2[:-1])
        assert torch.equal(k1[-1], kp[-1])
