"""The decode fusions of the port (``ops/fuse.py``, ``ops/fused_*.py``)
against the JAX package's, on the CPU.

Inputs come from a numpy seed and go through the JAX function and the
port's counterpart. The JAX side runs its Pallas kernels in interpret mode
(``impl="pallas", interpret=True``) and, for the norm-matmul, its XLA twin
too; the port's wrappers run their plain versions for CPU tensors. The
tolerances are f32 ones: the norm-matmul within 1e-5 (the JAX kernel's own
bitwise pin against its unfused composition fails at the seed, so the port
is held to a tolerance); the sampled ids exactly; the ingest outputs exactly
against the JAX twin evaluated op by op and within 2e-6 of the interpret
kernel (XLA compiles the interpret kernel into one graph that contracts the
rope's products and sums into FMAs, one rounding apart); the tiny model's
logits through every fused site within 1e-4.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models.llama import model as JM
from cake_tpu.models.llama.cache import init_cache as jax_init_cache
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.ops import fuse as jax_fuse
from cake_tpu.ops.pallas.fused_ingest import fused_qkv_ingest as jax_ingest
from cake_tpu.ops.pallas.fused_norm_matmul import fused_norm_matmul as jax_norm_matmul
from cake_tpu.ops.pallas.fused_sample_tail import fused_sample_tail as jax_tail
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.cache import init_cache
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.ops import fused_sample_tail as tail_mod
from cake_tpu_torch.ops.fuse import fuse_params, parse_fusion_spec, resolve_fusion
from cake_tpu_torch.ops.fused_ingest import fused_qkv_ingest, fused_qkv_ingest_plain
from cake_tpu_torch.ops.fused_norm_matmul import fused_norm_matmul, fused_norm_matmul_plain
from cake_tpu_torch.ops.fused_sample_tail import fused_sample_tail, fused_sample_tail_plain
from cake_tpu_torch.ops.sampling import sample, sample_step
from cake_tpu_torch.ops.threefry import TINY, gumbel, prng_key, split, uniform_from_bits
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)

SPECS = [
    "none", "", "all", "norm", "ingest", "tail", "norm,tail", " ingest , tail ",
    "norm,ingest,tail", "all@auto", "all@pallas", "norm@xla", "tail,ingest@pallas",
    "foo", ",", "all@bogus", "norm,bogus", "@pallas", "all@", "norm;tail", "none@xla",
]


@pytest.mark.parametrize("spec", SPECS)
def test_fusion_spec_grammar_matches_jax(spec):
    """Specs without an '@impl' suffix parse to the JAX package's sets and
    refuse alike. The port has no impl suffix: a spec the JAX package takes
    with one is refused, naming the spelling without it, which parses to
    the same set."""
    try:
        want, _ = jax_fuse.parse_fusion_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            parse_fusion_spec(spec)
        return
    if "@" in spec:
        names = spec.split("@", 1)[0]
        with pytest.raises(ValueError, match=re.escape(repr(names.strip() or "none"))):
            parse_fusion_spec(spec)
        assert parse_fusion_spec(names) == want
        return
    assert parse_fusion_spec(spec) == want


@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
def test_jax_impl_names_are_refused_with_the_port_spelling(jax_impl):
    with pytest.raises(ValueError, match="'norm,tail'"):
        parse_fusion_spec(f"norm,tail@{jax_impl}")


@pytest.mark.parametrize(
    "spec,want",
    [("none", frozenset()), ("all", frozenset({"norm", "ingest", "tail"})),
     ("tail", frozenset({"tail"})), ("norm, ingest", frozenset({"norm", "ingest"}))],
)
def test_resolve_fusion(spec, want):
    assert resolve_fusion(LlamaConfig.tiny(fusion_impl=spec)) == want


# ------------------------------------------------------------- norm-matmul


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
def test_norm_matmul_matches_jax(jax_impl, offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 128)).astype(np.float32) * 3
    nw = rng.standard_normal(128).astype(np.float32)
    w = (rng.standard_normal((128, 256)) / 11).astype(np.float32)
    want = jax_norm_matmul(
        jnp.asarray(x), jnp.asarray(nw), jnp.asarray(w), eps=1e-5, offset=offset,
        impl=jax_impl, interpret=True if jax_impl == "pallas" else None,
    )
    before = fused_norm_matmul_plain.launches
    got = fused_norm_matmul(
        torch.from_numpy(x), torch.from_numpy(nw), torch.from_numpy(w), eps=1e-5, offset=offset
    )
    assert fused_norm_matmul_plain.launches == before + 1  # CPU: the plain version
    assert got.shape == (3, 2, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# ------------------------------------------------------------------ ingest


def _ingest_operands(seed, b, n_q, n_kv, hd):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, 1, (n_q + 2 * n_kv) * hd)).astype(np.float32)
    cos = rng.standard_normal((b, 1, hd // 2)).astype(np.float32)
    sin = rng.standard_normal((b, 1, hd // 2)).astype(np.float32)
    return qkv, cos, sin


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# The JAX twin evaluated op by op rounds every rope product alone, as the
# port does: bitwise. The interpret kernel runs as one compiled XLA graph,
# which contracts the rope's products and sums into FMAs: a rounding apart.
INGEST_ATOL = {"xla": 0.0, "pallas": 2e-6}


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_ingest_matches_jax_dense(jax_impl):
    b, n_q, n_kv, hd, max_seq, slot = 3, 4, 2, 16, 64, 17
    qkv, cos, sin = _ingest_operands(3, b, n_q, n_kv, hd)
    base = np.random.default_rng(4).standard_normal((b, n_kv, max_seq, hd)).astype(np.float32)
    jq, jk, jv = jax_ingest(
        *map(jnp.asarray, (qkv, cos, sin)), jnp.int32(slot), jnp.asarray(base),
        jnp.asarray(base + 1.0), n_q=n_q, n_kv=n_kv, impl=jax_impl, interpret=True,
    )
    k, v = _t(base, base + 1.0)
    before = fused_qkv_ingest_plain.launches
    q = fused_qkv_ingest(*_t(qkv, cos, sin), slot, k, v, n_q=n_q, n_kv=n_kv)
    assert fused_qkv_ingest_plain.launches == before + 1
    tol = dict(atol=INGEST_ATOL[jax_impl], rtol=0)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), **tol)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **tol)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert not np.array_equal(k.numpy()[:, :, slot], base[:, :, slot])
    others = np.arange(max_seq) != slot
    np.testing.assert_array_equal(k.numpy()[:, :, others], base[:, :, others])


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize(
    "tables,slot",
    [
        # scattered physical pages; row 2 unmapped at the written page
        ([[3, 5, -1], [6, 2, -1], [-1, -1, -1]], 11),
        # logical page 1 is past a one-page table: every write drops
        ([[1], [4], [0]], 9),
    ],
    ids=["scattered-unmapped", "past-the-table"],
)
def test_ingest_matches_jax_paged(tables, slot, jax_impl):
    """Equal to the JAX kernel's q and pool, the port's write-sink page
    aside (where the JAX kernel drops a write, the plain version sinks it)."""
    b, n_q, n_kv, hd, ps, n_pages = 3, 4, 2, 16, 8, 7
    qkv, cos, sin = _ingest_operands(5, b, n_q, n_kv, hd)
    pool = np.random.default_rng(6).standard_normal((n_pages, n_kv, ps, hd)).astype(np.float32)
    tab = np.asarray(tables, np.int32)
    jq, jk, jv = jax_ingest(
        *map(jnp.asarray, (qkv, cos, sin)), jnp.int32(slot), jnp.asarray(pool),
        jnp.asarray(pool + 1.0), n_q=n_q, n_kv=n_kv, block_tables=jnp.asarray(tab),
        impl=jax_impl, interpret=True,
    )
    sink = np.zeros((1, n_kv, ps, hd), np.float32)
    k, v = _t(np.concatenate([pool, sink]), np.concatenate([pool + 1.0, sink]))
    q = fused_qkv_ingest(*_t(qkv, cos, sin), slot, k, v, n_q=n_q, n_kv=n_kv,
                         block_tables=torch.from_numpy(tab))
    tol = dict(atol=INGEST_ATOL[jax_impl], rtol=0)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), **tol)
    np.testing.assert_allclose(k.numpy()[:-1], np.asarray(jk), **tol)
    np.testing.assert_array_equal(v.numpy()[:-1], np.asarray(jv))
    written = {int(p) for p in tab[:, slot // ps]} if slot // ps < tab.shape[1] else set()
    for page in sorted(set(range(n_pages)) - written):  # untouched pages, bit for bit
        np.testing.assert_array_equal(k.numpy()[page], pool[page])


# -------------------------------------------------------------- sample tail

TAIL_KNOBS = [
    dict(temperature=0.0, top_k=None, repeat_penalty=1.0),
    dict(temperature=0.0, top_k=None, repeat_penalty=1.2),
    dict(temperature=0.7, top_k=5, repeat_penalty=1.1),
    dict(temperature=0.7, top_k=None, repeat_penalty=1.0),
    dict(temperature=1.3, top_k=1, repeat_penalty=0.8),
    dict(temperature=0.5, top_k=256, repeat_penalty=1.5),
]


def _tail_operands(seed, b=4, vocab=256):
    rng = np.random.default_rng(seed)
    logits = np.round(rng.standard_normal((b, vocab)) * 4).astype(np.float32) / 4  # ties
    ring = np.asarray([[1, 2, -1, -1], [7, 7, 3, -1], [-1] * 4, [250, 0, 1, 2]], np.int64)[:b]
    u = rng.uniform(np.finfo(np.float32).tiny, 1.0, (b, vocab))
    noise = (-np.log(-np.log(u))).astype(np.float32)
    return logits, ring, noise


def _both_tails(logits, ring, noise, knobs):
    greedy = knobs["temperature"] <= 0
    want = jax_tail(
        jnp.asarray(logits), jnp.asarray(ring, jnp.int32), None if greedy else jnp.asarray(noise),
        top_p=None, impl="pallas", interpret=True, **knobs,
    )
    got = fused_sample_tail(
        torch.from_numpy(logits), torch.from_numpy(ring),
        None if greedy else torch.from_numpy(noise), top_p=None, **knobs,
    )
    return got, want


@pytest.mark.parametrize("knobs", TAIL_KNOBS, ids=lambda k: "-".join(map(str, k.values())))
def test_sample_tail_matches_jax(knobs):
    logits, ring, noise = _tail_operands(9)
    before = fused_sample_tail_plain.launches
    got, want = _both_tails(logits, ring, noise, knobs)
    assert fused_sample_tail_plain.launches == before + 1
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("knobs", TAIL_KNOBS[:1] + TAIL_KNOBS[2:3])
def test_sample_tail_guards_match_jax(knobs):
    """All -inf rows give 0 and NaN rows the NaN, as the JAX kernel does."""
    logits, ring, noise = _tail_operands(10, b=3)
    logits[0] = -np.inf
    logits[1, 7] = np.nan
    logits[2, :] = -np.inf
    logits[2, 200] = np.nan
    got, want = _both_tails(logits, ring, noise, knobs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0] == 0


def test_sample_tail_top_p_keeps_the_composition_and_logs_once(monkeypatch, caplog):
    logits, ring, noise = (torch.from_numpy(a) for a in _tail_operands(11))
    monkeypatch.setattr(tail_mod, "_top_p_noted", False)
    knobs = dict(temperature=0.8, top_k=None, top_p=0.9, repeat_penalty=1.1)
    before = fused_sample_tail.unfused, fused_sample_tail_plain.launches
    with caplog.at_level("WARNING", logger="cake_tpu_torch.fused_sample_tail"):
        for _ in range(3):
            got = fused_sample_tail(logits, ring, noise, **knobs)
    assert fused_sample_tail.unfused == before[0] + 3
    assert fused_sample_tail_plain.launches == before[1]
    assert sum("top_p" in r.message for r in caplog.records) == 1
    assert torch.equal(got, fused_sample_tail_plain(logits, ring, noise, **knobs))


@pytest.mark.parametrize("knobs", TAIL_KNOBS, ids=lambda k: "-".join(map(str, k.values())))
def test_sample_step_through_the_tail_walks_the_unfused_stream(knobs):
    """Per-row threefry keys: the same ids, keys and rings fused or not; the
    noise is each row's gumbel draw from its split key, the plane the
    unfused ``sample_per_row`` adds, so the ids agree to the bit."""
    logits, ring, _ = (torch.from_numpy(a) for a in _tail_operands(12))
    outs = []
    for fused in (False, True):
        keys = prng_key([3, 4, 5, 6])
        r, idx = ring.clone(), torch.zeros(4, dtype=torch.int64)
        for _ in range(3):
            nxt, keys, r, idx = sample_step(logits, keys, r, idx, top_p=None, fused_tail=fused,
                                            **knobs)
        outs.append((nxt, keys, r, idx))
    for got in outs[1:]:
        for a, b in zip(got, outs[0]):
            assert torch.equal(a, b)


def test_per_row_uniforms_stay_inside_the_open_interval():
    """The extreme bits map into [tiny, 1 - 2**-23] (jax's uniform over
    [tiny, 1)), strictly inside (0, 1), so the gumbel noise is finite: with
    top-k, an infinite draw on a masked token (-inf + inf = NaN) would win
    the argmax, and the fused tail (which masks after adding the noise, as
    the JAX kernel does) would part from the plain version."""
    u = uniform_from_bits(torch.tensor([0, 1, 511, 512, 2**31, 2**32 - 1], dtype=torch.int64))
    assert u.dtype == torch.float32
    assert u[:3].tolist() == [TINY] * 3 and u[3].item() == 2.0**-23
    assert u[4].item() == 0.5 and u[-1].item() == 1.0 - 2.0**-23
    assert bool(((u > 0) & (u < 1)).all())
    assert torch.isfinite(-torch.log(-torch.log(u))).all()


def test_sample_step_with_a_shared_generator_draws_like_sample():
    """The generator's shared stream: the fused tail and the per-step
    ``sample`` (a split, then a draw with the subkey) walk one [2] threefry
    key to the same ids and the same key."""
    logits, ring, _ = (torch.from_numpy(a) for a in _tail_operands(13, b=1))
    knobs = dict(temperature=0.9, top_k=20, top_p=None)
    per_step, fused = [], []
    k1 = k2 = prng_key(8)
    idx = torch.zeros(1, dtype=torch.int64)
    for _ in range(4):
        k1, sub = split(k1)
        per_step.append(int(sample(logits, sub, **knobs)[0]))
        nxt, k2, _, _ = sample_step(logits, k2, torch.full((1, 0), -1), idx, repeat_penalty=1.0,
                                    fused_tail=True, **knobs)
        fused.append(int(nxt[0]))
    assert per_step == fused and torch.equal(k1, k2)
    noise = gumbel(prng_key([1]), (16,))
    assert noise.shape == (1, 16) and torch.isfinite(noise).all()


# ------------------------------------------------------------ the model


def test_fused_forward_matches_jax():
    """Every "norm" site through the JAX kernels (interpret) against the
    port's fused forward: logits within 1e-4, greedy tokens equal."""
    kw = dict(num_hidden_layers=2)
    jcfg = JaxConfig.tiny(attention_impl="pallas", fusion_impl="all@pallas", **kw)
    pcfg = LlamaConfig.tiny(fusion_impl="all", **kw)
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(2), jnp.float32))
    params = fuse_params(M.params_from_jax(tree))
    jtree = jax_fuse.fuse_params(tree)
    prompt = np.random.default_rng(1).integers(0, pcfg.vocab_size, (1, 8)).astype(np.int32)
    hd, n_kv, n = pcfg.head_dim, pcfg.num_key_value_heads, pcfg.num_hidden_layers
    jkv = jax_init_cache(n, 1, 64, n_kv, hd, jnp.float32)
    pkv = init_cache(n, 1, 64, n_kv, hd, torch.float32)
    before = fused_norm_matmul_plain.launches
    toks, pos, seq_len = prompt, 0, 8
    for _ in range(6):
        jl, jkv = JM.forward(jtree, jnp.asarray(toks), jkv, jnp.int32(pos), jnp.int32(seq_len),
                             jcfg)
        pl, pkv = M.forward(params, torch.from_numpy(np.array(toks)), pkv, pos, seq_len, pcfg)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
        nxt = pl.argmax(-1).numpy().astype(np.int32)
        np.testing.assert_array_equal(nxt, np.asarray(jnp.argmax(jl, -1)))
        pos, seq_len, toks = pos + seq_len, 1, nxt[:, None]
    assert fused_norm_matmul_plain.launches == before + 6 * (2 * n + 1)


@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_fused_forward_equals_unfused_on_the_cpu(family):
    """On the CPU the fused wrappers run the plain versions, which ARE the
    unfused compositions: bitwise equal logits, Gemma's (1 + w) included;
    tied embeddings keep the unfused head."""
    kw = dict(num_hidden_layers=2)
    if family == "gemma":
        kw.update(rmsnorm_offset=True, hidden_activation="gelu_tanh", tie_word_embeddings=True)
    cfg = LlamaConfig.tiny(**kw)
    params = fuse_params(M.init_params(cfg, torch.Generator().manual_seed(4), torch.float32))
    toks = torch.randint(0, cfg.vocab_size, (2, 5), generator=torch.Generator().manual_seed(5))
    outs = {}
    for spec in ("none", "all", "norm"):
        kv = init_cache(2, 2, 32, cfg.num_key_value_heads, cfg.head_dim, torch.float32)
        before = fused_norm_matmul_plain.launches
        outs[spec], _ = M.forward(params, toks, kv, 0, 5, dataclasses.replace(cfg, fusion_impl=spec))
        heads = 0 if family == "gemma" else 1
        assert fused_norm_matmul_plain.launches - before == (0 if spec == "none" else 4 + heads)
    assert torch.equal(outs["all"], outs["none"]) and torch.equal(outs["norm"], outs["none"])
