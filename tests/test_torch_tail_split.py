"""The sampling tail's cluster split, on the CPU.

``ops/fused_sample_tail.plan`` is the geometry the CUDA kernel
(``ops/csrc/fused_sample_tail.cu``) launches with: a cluster of C blocks a
row, block r owning ``[r * slice, (r + 1) * slice)`` of the vocabulary. A
test-only model of the kernel's split — each slice's penalty bitmap from
the ring, each slice's radix histograms summed in rank order, each slice's
(value, index) argmax partial combined in rank order — is held to the
port's plain version and to the JAX package's Pallas kernel (interpret
mode on the CPU, as the JAX package's own tests run it; the XLA twin where
the vocabulary does not tile into 128 lanes): the ids must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.ops.pallas.fused_sample_tail import fused_sample_tail as jax_tail
from cake_tpu_torch.ops import fused_sample_tail as tail_mod
from cake_tpu_torch.ops.fused_sample_tail import (
    CLUSTERS,
    MIN_SLICE,
    SMEM_CAP,
    Plan,
    candidates,
    fused_sample_tail_plain,
    plan,
    smem_bytes,
)

INT_MAX = 0x7FFFFFFF


def order_key(v: torch.Tensor) -> np.ndarray:
    """The kernel's order-preserving uint32 key of each f32 (NaN canonical,
    above every number)."""
    b = v.numpy().view(np.uint32).astype(np.int64)
    k = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    return np.where(np.isnan(v.numpy()), 0xFFFFFFFF, k)


def key_value(k: int) -> float:
    bits = (k & 0x7FFFFFFF) if k & 0x80000000 else (~k & 0xFFFFFFFF)
    return float(np.array([bits], np.uint32).view(np.float32)[0])


def ahead(a: float, ia: int, b: float, ib: int) -> bool:
    """torch.argmax's order: NaN first, then the larger value, then the lower index."""
    an, bn = np.isnan(a), np.isnan(b)
    if an or bn:
        return ia < ib if an and bn else bool(an)
    if a != b:
        return a > b
    return ia < ib


def cluster_tail(logits, ring, noise, p: Plan, *, temperature, top_k, repeat_penalty):
    """Test-only model of the kernel's split: ids [b] from slices of ``p``."""
    b, vocab = logits.shape
    greedy = temperature is None or temperature <= 0
    slices = [(r * p.slice, min(vocab, (r + 1) * p.slice)) for r in range(p.cluster)]
    ids = []
    for row in range(b):
        vals = []
        for lo, hi in slices:
            x = logits[row, lo:max(lo, hi)]
            if repeat_penalty != 1.0 and ring.shape[1]:
                toks = ring[row]
                seen = torch.zeros(x.shape[0], dtype=torch.bool)
                seen[toks[(toks >= lo) & (toks < hi)] - lo] = True  # this slice's bitmap
                x = torch.where(seen, torch.where(x > 0, x / repeat_penalty, x * repeat_penalty), x)
            if not greedy:
                x = x / temperature
            vals.append(x)
        thresh = None
        if not greedy and top_k is not None:
            keys = [order_key(v) for v in vals]
            prefix, mask, rank = 0, 0, top_k
            for shift in (24, 16, 8, 0):
                tot = np.zeros(256, np.int64)
                for k in keys:  # each slice's histogram, summed in rank order
                    tot += np.bincount((k[(k & mask) == prefix] >> shift) & 255, minlength=256)
                run = 0
                for d in range(255, -1, -1):
                    if run + tot[d] >= rank:
                        break
                    run += tot[d]
                prefix, mask, rank = prefix | (d << shift), mask | (255 << shift), rank - run
            thresh = key_value(prefix)
        best = (float("-inf"), INT_MAX)
        for (lo, hi), v in zip(slices, vals):
            if v.numel() == 0:
                part = (float("-inf"), INT_MAX)
            else:
                if not greedy:
                    v = v + noise[row, lo:hi] if thresh is None else torch.where(
                        v < thresh, float("-inf"), v + noise[row, lo:hi])
                i = int(torch.argmax(v))
                part = (float(v[i]), lo + i)
            if ahead(*part, *best):
                best = part
        ids.append(best[1])
    return torch.tensor(ids, dtype=torch.int64)


def _operands(seed, b, vocab, window=16):
    rng = np.random.default_rng(seed)
    logits = np.round(rng.standard_normal((b, vocab)) * 4).astype(np.float32) / 4  # ties
    ring = rng.integers(-1, vocab, (b, window)).astype(np.int64)
    ring[:, 1] = ring[:, 0]  # a token twice in the ring
    u = rng.uniform(np.finfo(np.float32).tiny, 1.0, (b, vocab))
    noise = (-np.log(-np.log(u))).astype(np.float32)
    return logits, ring, noise


def _jax_ids(logits, ring, noise, knobs):
    greedy = knobs["temperature"] <= 0
    return np.asarray(jax_tail(
        jnp.asarray(logits), jnp.asarray(ring, jnp.int32), None if greedy else jnp.asarray(noise),
        top_p=None, impl="pallas" if logits.shape[1] % 128 == 0 else "xla",
        interpret=True, **knobs,
    ))


def _all_agree(logits, ring, noise, knobs, p, jax_too=True):
    t = [torch.from_numpy(a) for a in (logits, ring, noise)]
    nz = None if knobs["temperature"] <= 0 else t[2]
    model = cluster_tail(t[0], t[1], t[2], p, **knobs)
    plain = fused_sample_tail_plain(t[0], t[1], nz, top_p=None, **knobs)
    assert torch.equal(model, plain), (p, knobs, model.tolist(), plain.tolist())
    if jax_too:
        np.testing.assert_array_equal(model.numpy(), _jax_ids(logits, ring, noise, knobs))
    return model


KNOBS = [
    dict(temperature=0.0, top_k=None, repeat_penalty=1.0),
    dict(temperature=0.0, top_k=None, repeat_penalty=1.3),
    dict(temperature=0.7, top_k=None, repeat_penalty=1.0),
    dict(temperature=0.7, top_k=40, repeat_penalty=1.1),
    dict(temperature=1.3, top_k=1, repeat_penalty=0.8),
]


@pytest.fixture
def small_slices(monkeypatch):
    """plan() cuts a small vocabulary into 16- and 8-block clusters, as it
    cuts Llama-3's."""
    monkeypatch.setattr(tail_mod, "MIN_SLICE", 16)


# ------------------------------------------------------------- geometry


@pytest.mark.parametrize("vocab", [1, 5, 1000, 4099, 32000, 128256, 151936, 2_000_000])
@pytest.mark.parametrize("sampled,top_k", [(False, None), (True, None), (True, 40)])
def test_every_planned_slice_set_covers_the_vocabulary_once(vocab, sampled, top_k):
    for p in candidates(8, vocab, sampled, top_k):
        assert p.slice % 4 == 0 and 1 <= p.cluster <= max(CLUSTERS)
        assert p.cluster * p.slice >= vocab > (p.cluster - 1) * p.slice
        assert p.cluster == 1 or vocab // p.cluster >= MIN_SLICE
        staged = smem_bytes(p.slice, True, True) <= SMEM_CAP
        assert p.staged == (top_k is not None and staged)
        assert p.smem == smem_bytes(p.slice, top_k is not None, p.staged) <= SMEM_CAP


def test_llama3_vocab_takes_a_cluster_of_at_least_8_and_stages_top_k():
    for b in (1, 4, 5, 8, 33):
        greedy = plan(b, 128256, False, None)
        sampled = plan(b, 128256, True, None)
        top_k = plan(b, 128256, True, 40)
        assert greedy.cluster == sampled.cluster == 16  # 8 rows: 128 of the H100's 132 SMs
        assert top_k.cluster == (16 if b * 16 <= 66 else 8)  # top-k past half the SMs: 8
        assert not greedy.staged and not sampled.staged and top_k.staged
    # a slice that does not fit at 16 blocks reads device memory each pass
    assert not plan(1, 2_000_000, True, 40).staged


@pytest.mark.parametrize("vocab", [256000, 262144])
@pytest.mark.parametrize("b", [1, 5, 8, 33])
def test_gemma_vocab_top_k_takes_the_cluster_that_stages(b, vocab):
    """Past ~208K ids an 8-block slice no longer fits in shared memory: a
    top-k row takes 16 blocks, whose slice stages, whatever b; an
    unstaged 8-block plan stays behind it for a card that cannot
    schedule 16."""
    p = plan(b, vocab, True, 40)
    assert p.cluster == 16 and p.staged and p.smem <= SMEM_CAP
    assert smem_bytes(-(-vocab // 32) * 4, True, True) > SMEM_CAP  # the 8-block slice
    assert [(q.cluster, q.staged) for q in candidates(b, vocab, True, 40)] == [(16, True),
                                                                                (8, False)]
    assert plan(b, vocab, True, 40, occupancy=lambda q: 0 if q.cluster == 16 else 2).cluster == 8


@pytest.mark.parametrize("b,top_k", [(1, None), (1, 40), (8, None), (8, 40)])
def test_plan_takes_the_first_cluster_the_card_schedules(b, top_k):
    order = [p.cluster for p in candidates(b, 128256, True, top_k)]
    assert sorted(order, reverse=True) == list(CLUSTERS)
    p = plan(b, 128256, True, top_k, occupancy=lambda q: 0 if q.cluster == order[0] else 3)
    assert p.cluster == order[1]


def test_plan_raises_when_the_card_schedules_no_cluster():
    """A stubbed occupancy query of 0 for every size: the wrapper's plan
    names the limit instead of launching a kernel that never runs."""
    with pytest.raises(RuntimeError, match="cudaOccupancyMaxActiveClusters returned 0") as e:
        plan(8, 128256, True, 40, occupancy=lambda q: 0)
    msg = str(e.value)
    for p in candidates(8, 128256, True, 40):
        assert f"{p.cluster} blocks of 512 threads with {p.smem} bytes of shared memory" in msg


# ------------------------------------------------------------- the model


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "-".join(map(str, k.values())))
@pytest.mark.parametrize("b,vocab", [(1, 1280), (3, 1000), (8, 2048), (3, 1027)])
def test_split_model_matches_plain_and_jax(small_slices, b, vocab, knobs):
    """Over plan()'s 16- and 8-block cuts; V not a multiple of 4 or of C."""
    logits, ring, noise = _operands(b * vocab, b, vocab)
    for p in candidates(b, vocab, knobs["temperature"] > 0, knobs["top_k"]):
        assert p.cluster in (16, 8)
        _all_agree(logits, ring, noise, knobs, p)


@pytest.mark.parametrize("knobs", KNOBS[1:2] + KNOBS[3:],
                         ids=lambda k: "-".join(map(str, k.values())))
def test_ties_across_a_slice_edge_take_the_lower_index(small_slices, knobs):
    vocab, b = 1280, 3
    logits, ring, noise = _operands(5, b, vocab)
    ring[:] = -1
    p = plan(b, vocab, knobs["temperature"] > 0, knobs["top_k"])
    edge = p.slice * 3
    logits[:, edge - 1] = logits[:, edge] = 100.0  # equal maxima either side of an edge
    noise[:, edge - 1] = noise[:, edge] = 0.5
    got = _all_agree(logits, ring, noise, knobs, p)
    assert got.tolist() == [edge - 1] * b


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "-".join(map(str, k.values())))
def test_nan_and_all_minus_inf_rows(small_slices, knobs):
    vocab, b = 1280, 4
    logits, ring, noise = _operands(6, b, vocab)
    p = plan(b, vocab, knobs["temperature"] > 0, knobs["top_k"])
    logits[0] = -np.inf
    logits[1, p.slice * 5 + 7] = np.nan
    logits[2] = -np.inf
    logits[2, p.slice * 9] = np.nan
    logits[3, [p.slice + 1, p.slice * 7]] = np.nan  # the lower NaN wins
    got = _all_agree(logits, ring, noise, knobs, p)
    assert got.tolist() == [0, p.slice * 5 + 7, p.slice * 9, p.slice + 1]


@pytest.mark.parametrize("top_k", ["one", "slice", "slice+1", "vocab"])
def test_top_k_at_one_a_slice_edge_and_the_vocabulary(small_slices, top_k):
    vocab, b = 2048, 8
    logits, ring, noise = _operands(7, b, vocab)
    p = plan(b, vocab, True, 40)
    k = {"one": 1, "slice": p.slice, "slice+1": p.slice + 1, "vocab": vocab}[top_k]
    _all_agree(logits, ring, noise, dict(temperature=0.9, top_k=k, repeat_penalty=1.2), p)


@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
def test_ids_do_not_depend_on_the_cluster_size(cluster):
    vocab, b = 4099, 3
    logits, ring, noise = _operands(8, b, vocab)
    knobs = dict(temperature=0.7, top_k=40, repeat_penalty=1.1)
    sl = -(-(-(-vocab // cluster)) // 4) * 4
    p = Plan(cluster, sl, True, smem_bytes(sl, True, True))
    _all_agree(logits, ring, noise, knobs, p, jax_too=False)


@pytest.mark.parametrize("seed", range(4))
def test_duplicate_heavy_rows_across_seeds(small_slices, seed):
    vocab, b = 1536, 8
    rng = np.random.default_rng(seed)
    logits = rng.integers(-3, 4, (b, vocab)).astype(np.float32)  # seven values
    _, ring, noise = _operands(seed, b, vocab)
    for knobs in KNOBS:
        p = plan(b, vocab, knobs["temperature"] > 0, knobs["top_k"])
        _all_agree(logits, ring, noise, knobs, p)
