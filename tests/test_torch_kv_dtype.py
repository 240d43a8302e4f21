"""f8 KV caches (``--kv-dtype``) in the port, against the JAX package.

The port's one narrowing cast (``ops/kv_dtype.narrow``) gives the bits of
the JAX package's ``astype(float8_e4m3fn)``: round to nearest even, NaN past
+-464 (torch's own cast saturates). The cache writes (dense at a host offset
and at a device slot, paged), the page gathers and copies carry f8 bits
unchanged. The five functions that read or write the cache (decode, chunk,
paged decode, paged chunk attention and the fused ingest) run their plain
versions on f8 contents against the Pallas kernels in interpret mode:
within 1e-4 for f32 queries and one bf16 step at the output's magnitude for
bf16 queries; the ingest's written cache to the bit. ``widen_qkv`` and the
wider-cache rule are pinned. Then the tiny model: the generator's greedy
streams over an f8 cache (f32 weights; decode chunks of 1 and 4, unfused and
under ``ingest``) equal the JAX ``LocalForwardStep(cache_dtype=f8)`` streams,
and the batch engine's, dense, paged and paged with the prefix cache, equal
the JAX engine's rows (the warm wave the cold one). Inputs come from numpy
with a fixed seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.cli import build_parser as jax_build_parser
from cake_tpu.io.safetensors_io import load_params as jax_load_params
from cake_tpu.io.safetensors_io import save_tiny_checkpoint as jax_save_tiny_checkpoint
from cake_tpu.models.llama import cache as JC
from cake_tpu.models.llama import model as JM
from cake_tpu.models.llama import paged_cache as JP
from cake_tpu.models.llama.chat import Message as JaxMessage
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.models.llama.generator import LlamaGenerator as JaxGenerator
from cake_tpu.models.llama.generator import LocalForwardStep as JaxStep
from cake_tpu.models.llama.generator import SamplingConfig as JaxSampling
from cake_tpu.models.llama.tokenizer import load_tokenizer as jax_load_tokenizer
from cake_tpu.ops.attention import gqa_attention_hm as jax_gqa_hm
from cake_tpu.ops.attention import widen_qkv as jax_widen_qkv
from cake_tpu.ops.pallas.chunk_prefill import chunk_prefill_attention as jax_chunk
from cake_tpu.ops.pallas.decode_attention import decode_attention as jax_decode
from cake_tpu.ops.pallas.fused_ingest import fused_qkv_ingest as jax_ingest
from cake_tpu.ops.pallas.paged_attention import paged_decode_attention as jax_paged_decode
from cake_tpu.ops.pallas.paged_prefill import paged_chunk_attention as jax_paged_chunk
from cake_tpu.runtime.serving import BatchEngine as JaxEngine
from cake_tpu.runtime.serving import ServeConfig as JaxServe
from cake_tpu_torch.cli import build_parser
from cake_tpu_torch.io.safetensors_io import load_params
from cake_tpu_torch.models.llama import cache as C
from cake_tpu_torch.models.llama import paged_cache as P
from cake_tpu_torch.models.llama.chat import Message
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import LlamaGenerator, SamplingConfig
from cake_tpu_torch.models.llama.tokenizer import load_tokenizer
from cake_tpu_torch.ops.attention import gqa_attention_hm, widen_qkv
from cake_tpu_torch.ops.chunk_prefill import chunk_prefill_attention
from cake_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from cake_tpu_torch.ops.fused_ingest import fused_qkv_ingest, fused_qkv_ingest_plain
from cake_tpu_torch.ops.kv_dtype import (
    F8, KV_DTYPE_CHOICES, attention_dtype, kv_view, narrow, resolve_kv_dtype,
)
from cake_tpu_torch.ops.paged_attention import paged_decode_attention
from cake_tpu_torch.ops.paged_prefill import paged_chunk_attention
from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)

JF8 = jnp.float8_e4m3fn
F32_TOL = 1e-4  # f32 queries: XLA and torch reduce in different orders
GREEDY = dict(temperature=0.0, repeat_penalty=1.0)
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _bits(t: torch.Tensor) -> np.ndarray:
    return kv_view(t).numpy()


def _jax_bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint8)


def _f8_pair(rng, shape, scale=1.0):
    """The same f8 contents for both packages: (jax array, torch tensor)."""
    j = jnp.asarray((scale * rng.standard_normal(shape)).astype(np.float32)).astype(JF8)
    return j, torch.from_numpy(_jax_bits(j).copy()).view(F8)


def _q_pair(rng, shape, dtype):
    q = rng.standard_normal(shape).astype(np.float32)
    j = jnp.asarray(q).astype(JAX_DTYPES[dtype])
    return j, torch.from_numpy(q).to(dtype)


def _close(got: torch.Tensor, want, dtype):
    """f32: within F32_TOL; bf16: within one bf16 rounding step at the
    output's largest magnitude."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    if dtype == torch.float32:
        tol = F32_TOL
    else:
        tol = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


# ------------------------------------------------------------- narrowing


def _e4m3_ties() -> np.ndarray:
    """The midpoints between neighbouring finite e4m3 values (ties), and
    the values themselves."""
    vals = np.arange(256, dtype=np.uint8).view(jnp.float8_e4m3fn).astype(np.float32)
    vals = np.unique(vals[np.isfinite(vals)])
    return np.concatenate([vals, (vals[1:] + vals[:-1]) / 2])


SPECIALS = np.array(
    [0.0, -0.0, 448.0, -448.0, 449.0, 460.0, 464.0, -464.0, 465.0, -465.0, 480.0, 1000.0,
     -1000.0, 2.0**-9, 2.0**-10, 3 * 2.0**-10, -(2.0**-10), 2.0**-6, 1.0625, 1.1875, 1e-30,
     np.inf, -np.inf], np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=str)
def test_narrow_matches_jax_astype_bitwise(dtype):
    rng = np.random.default_rng(0)
    every_bf16 = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    randn = (rng.standard_normal(200_000) * rng.choice([1e-3, 0.1, 1, 30, 300], 200_000))
    x = np.concatenate([every_bf16, SPECIALS, _e4m3_ties(), randn.astype(np.float32)])
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}[dtype]
    with np.errstate(invalid="ignore", over="ignore"):
        xj = jnp.asarray(x).astype(jdt)
        if dtype != torch.float32:
            # XLA's 16-bit -> f8 convert drops a NaN's sign; NaN inputs aside.
            xj = xj[~np.isnan(np.asarray(xj.astype(jnp.float32)))]
        want = _jax_bits(xj.astype(JF8))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(dtype)
    got = _bits(narrow(xt, F8))
    np.testing.assert_array_equal(got, want)


def test_narrow_overflow_gives_nan_with_the_sign():
    x = torch.tensor([448.0, 464.0, 465.0, -465.0, 1000.0, -1000.0, float("inf")])
    assert _bits(narrow(x, F8)).tolist() == [0x7E, 0x7E, 0x7F, 0xFF, 0x7F, 0xFF, 0x7F]
    assert torch.equal(narrow(x, torch.bfloat16), x.to(torch.bfloat16))  # a plain .to


def test_resolve_kv_dtype_and_the_cli_flag():
    assert resolve_kv_dtype("auto", torch.float16) is torch.float16
    assert [resolve_kv_dtype(n, torch.float32) for n in ("bf16", "f16", "f32", "f8")] == [
        torch.bfloat16, torch.float16, torch.float32, F8]
    with pytest.raises(ValueError, match="unknown KV dtype"):
        resolve_kv_dtype("e5m2", torch.float32)
    jax_choices = next(a.choices for a in jax_build_parser()._actions
                       if "--kv-dtype" in a.option_strings)
    assert tuple(jax_choices) == KV_DTYPE_CHOICES
    assert build_parser().parse_args(["--model", "m"]).kv_dtype == "auto"
    assert build_parser().parse_args(["--model", "m", "--kv-dtype", "f8"]).kv_dtype == "f8"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--model", "m", "--kv-dtype", "int8"])


def test_attention_dtype_rule():
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    assert attention_dtype("t", bf, F8, F8) == bf
    assert attention_dtype("t", f32, F8, F8) == f32
    assert attention_dtype("t", bf, bf, bf) == bf
    assert attention_dtype("t", bf, f32, f32) == f32  # a wider cache upgrades the query
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention_dtype("t", bf, f16, f16)  # same width, another dtype
    with pytest.raises(ValueError):
        attention_dtype("t", f32, bf, bf)  # a narrower 16-bit cache
    with pytest.raises(ValueError):
        attention_dtype("t", bf, F8, bf)  # K and V apart


# ------------------------------------------------------------- cache writes


@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("pos", ["host", "device"])
def test_write_layer_f8_matches_jax_bitwise(pos, act):
    rng = np.random.default_rng(1)
    b, n_kv, s, hd, chunk, at = 2, 2, 32, 8, 3 if pos == "host" else 1, 9
    k_new = rng.standard_normal((b, chunk, n_kv, hd)).astype(np.float32) * 200
    v_new = rng.standard_normal((b, chunk, n_kv, hd)).astype(np.float32) * 200
    jk, jv = JC.write_layer(
        jnp.zeros((b, n_kv, s, hd), JF8), jnp.zeros((b, n_kv, s, hd), JF8),
        jnp.asarray(k_new).astype(JAX_DTYPES[act]), jnp.asarray(v_new).astype(JAX_DTYPES[act]),
        jnp.int32(at),
    )
    kc = torch.zeros((b, n_kv, s, hd), dtype=F8)
    vc = torch.zeros((b, n_kv, s, hd), dtype=F8)
    slot = at if pos == "host" else torch.tensor(at, dtype=torch.int64)
    C.write_layer(kc, vc, torch.from_numpy(k_new).to(act), torch.from_numpy(v_new).to(act), slot)
    np.testing.assert_array_equal(_bits(kc), _jax_bits(jk))
    np.testing.assert_array_equal(_bits(vc), _jax_bits(jv))
    assert np.isnan(kc.float().numpy()).any()  # 200-sigma values past 464 came back NaN


def test_paged_writes_gathers_and_copies_keep_f8_bits():
    rng = np.random.default_rng(2)
    n_pages, n_kv, ps, hd = 5, 2, 8, 8
    tables = np.array([[3, 0, -1], [1, 4, 2]], np.int32)
    k_new = (rng.standard_normal((2, 11, n_kv, hd)) * 100).astype(np.float32)
    jpool = jnp.zeros((n_pages, n_kv, ps, hd), JF8)
    jk, _ = JP.paged_write_layer(jpool, jpool, jnp.asarray(k_new), jnp.asarray(k_new),
                                 jnp.int32(6), jnp.asarray(tables))
    cache = P.init_paged_cache(2, n_pages, n_kv, ps, hd, F8)
    P.paged_write_layer(cache.k[0], cache.v[0], torch.from_numpy(k_new),
                        torch.from_numpy(k_new), 6, torch.from_numpy(tables))
    np.testing.assert_array_equal(_bits(cache.k[0, :-1]), _jax_bits(jk))  # the sink aside
    gathered = P.gather_pages(cache.k[0], torch.from_numpy(tables))
    assert gathered.dtype == F8
    np.testing.assert_array_equal(
        _bits(gathered), _jax_bits(JP.gather_pages(jk, jnp.asarray(tables))))
    before = _bits(cache.k).copy()
    P.copy_pages(cache, [3], [4])
    np.testing.assert_array_equal(_bits(cache.k)[:, 4], before[:, 3])


@pytest.mark.parametrize("cache", ["f8", "f32"])
def test_widen_qkv_matches_jax(cache):
    """f8 under bf16 queries widens K/V to bf16 (exactly); an f32 cache
    upgrades the query to f32."""
    rng = np.random.default_rng(3)
    jq, q = _q_pair(rng, (1, 1, 4, 16), torch.bfloat16)
    if cache == "f8":
        jk, k = _f8_pair(rng, (1, 2, 8, 16))
    else:
        k_np = rng.standard_normal((1, 2, 8, 16)).astype(np.float32)
        jk, k = jnp.asarray(k_np), torch.from_numpy(k_np)
    got, want = widen_qkv(q, k, k), jax_widen_qkv(jq, jk, jk)
    for g, w in zip(got, want):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))


def test_wider_cache_upgrades_compute():
    """An f32 cache under bf16 queries computes in f32 (the JAX package's
    rule), so it differs from the same cache cast to bf16, and the decode
    wrapper's plain path returns bf16 equal to the JAX package's."""
    rng = np.random.default_rng(4)
    b, n_kv, seq, d, n_q = 1, 2, 64, 32, 4
    kf = rng.standard_normal((b, n_kv, seq, d)).astype(np.float32)
    vf = rng.standard_normal((b, n_kv, seq, d)).astype(np.float32)
    jq, q = _q_pair(rng, (b, 1, n_q, d), torch.bfloat16)
    pos = torch.arange(seq)[None]
    qpos = torch.full((b, 1), seq - 1)
    full = gqa_attention_hm(q, torch.from_numpy(kf), torch.from_numpy(vf), qpos, pos)
    truncated = gqa_attention_hm(q, torch.from_numpy(kf).to(torch.bfloat16),
                                 torch.from_numpy(vf).to(torch.bfloat16), qpos, pos)
    assert full.dtype == torch.bfloat16
    assert not torch.equal(full, truncated)
    want = jax_gqa_hm(jq, jnp.asarray(kf), jnp.asarray(vf), jnp.asarray(qpos.numpy()),
                      jnp.asarray(pos.numpy()))
    _close(full, want, torch.bfloat16)
    lengths = torch.full((b,), seq, dtype=torch.int32)
    got = decode_attention(q, torch.from_numpy(kf), torch.from_numpy(vf), lengths)
    assert got.dtype == torch.bfloat16 and torch.equal(got, full)


# ------------------------------------------------- the five plain versions


QDTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("knobs", ["plain", "starts_window"])
@pytest.mark.parametrize("dtype", QDTYPES, ids=str)
def test_decode_plain_f8_matches_pallas(dtype, knobs):
    rng = np.random.default_rng(5)
    b, n_q, n_kv, d, max_seq = 3, 8, 2, 32, 256
    jq, q = _q_pair(rng, (b, 1, n_q, d), dtype)
    jk, k = _f8_pair(rng, (b, n_kv, max_seq, d))
    jv, v = _f8_pair(rng, (b, n_kv, max_seq, d))
    lengths = np.array([1, 197, 256], np.int32)
    starts = np.array([0, 37, 100], np.int32) if knobs != "plain" else None
    kw = {"window": 64} if knobs != "plain" else {}
    want = jax_decode(jq, jk, jv, jnp.asarray(lengths),
                      None if starts is None else jnp.asarray(starts), interpret=True, **kw)
    before = decode_attention_plain.launches
    got = decode_attention(q, k, v, torch.from_numpy(lengths),
                           None if starts is None else torch.from_numpy(starts), **kw)
    assert decode_attention_plain.launches == before + 1 and got.dtype == dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", QDTYPES, ids=str)
def test_chunk_plain_f8_matches_pallas(dtype):
    rng = np.random.default_rng(6)
    b, chunk, n_q, n_kv, d, max_seq = 2, 48, 8, 2, 32, 256
    jq, q = _q_pair(rng, (b, chunk, n_q, d), dtype)
    jk, k = _f8_pair(rng, (b, n_kv, max_seq, d))
    jv, v = _f8_pair(rng, (b, n_kv, max_seq, d))
    q_starts = np.array([60, 10], np.int32)
    lengths = q_starts + chunk
    k_starts = np.array([3, 0], np.int32)
    for kw in ({}, {"window": 24, "softcap": 20.0}):
        flag = jnp.asarray(True) if kw else None
        want = jax_chunk(jq, jk, jv, jnp.asarray(q_starts), jnp.asarray(lengths), flag,
                         jnp.asarray(k_starts), interpret=True, **kw)
        got = chunk_prefill_attention(
            q, k, v, torch.from_numpy(q_starts), torch.from_numpy(lengths),
            None if flag is None else torch.tensor(True), torch.from_numpy(k_starts), **kw)
        _close(got, want, dtype)


PS = 128  # the Pallas paged kernels take 128-multiples
TABLES = np.array([[7, 2, 9], [5, 0, -1], [1, 8, 3]], np.int32)  # row 1: unmapped past its range


def _f8_pools(rng, n_pages, n_kv, hd):
    """(jax pool, port pool with the write sink) for K and for V."""
    out = []
    for _ in range(2):
        j, t = _f8_pair(rng, (n_pages, n_kv, PS, hd))
        out += [j, torch.cat([t, torch.zeros((1, n_kv, PS, hd), dtype=F8)])]
    return out


@pytest.mark.parametrize("dtype", QDTYPES, ids=str)
def test_paged_decode_plain_f8_matches_pallas(dtype):
    rng = np.random.default_rng(7)
    n_kv, group, hd = 2, 4, 64
    jk, pk, jv, pv = _f8_pools(rng, 10, n_kv, hd)
    jq, q = _q_pair(rng, (3, 1, n_kv * group, hd), dtype)
    lengths = np.array([300, 200, 384], np.int32)  # mid-page ends
    starts = np.array([0, 70, 130], np.int32)  # left pads
    for kw in ({}, {"window": 100}):
        want = jax_paged_decode(jq, jk, jv, jnp.asarray(lengths), jnp.asarray(TABLES),
                                jnp.asarray(starts), interpret=True, **kw)
        got = paged_decode_attention(q, pk, pv, torch.from_numpy(lengths),
                                     torch.from_numpy(TABLES), torch.from_numpy(starts), **kw)
        _close(got, want, dtype)


@pytest.mark.parametrize("shape", ["cold", "suffix"])
@pytest.mark.parametrize("dtype", QDTYPES, ids=str)
def test_paged_chunk_plain_f8_matches_pallas(dtype, shape):
    """A cold prefill from slot 0 and a warm suffix window over a cached
    prefix, with left pads (row 1's pad past some of its queries)."""
    rng = np.random.default_rng(8)
    n_kv, group, hd = 2, 4, 64
    jk, pk, jv, pv = _f8_pools(rng, 10, n_kv, hd)
    q_start, chunk = (0, 160) if shape == "cold" else (128, 96)
    q_starts = np.full(3, q_start, np.int32)
    lengths = q_starts + chunk
    pads = np.array([3, 150, 0], np.int32)
    tables = TABLES.copy()
    tables[1, 2] = -1 if lengths[1] <= 2 * PS else 4
    jq, q = _q_pair(rng, (3, chunk, n_kv * group, hd), dtype)
    want = jax_paged_chunk(jq, jk, jv, jnp.asarray(q_starts), jnp.asarray(lengths),
                           jnp.asarray(pads), jnp.asarray(tables), interpret=True)
    got = paged_chunk_attention(q, pk, pv, torch.from_numpy(q_starts), torch.from_numpy(lengths),
                                torch.from_numpy(pads), torch.from_numpy(tables))
    _close(got, want, dtype)


def _ingest_operands(seed, b, n_q, n_kv, hd, dtype):
    rng = np.random.default_rng(seed)
    qkv = (3.0 * rng.standard_normal((b, 1, (n_q + 2 * n_kv) * hd))).astype(np.float32)
    qkv[0, 0, n_q * hd : n_q * hd + 4] = [470.0, -470.0, 1000.0, -2000.0]  # k past +-464: NaN
    qkv[0, 0, (n_q + n_kv) * hd : (n_q + n_kv) * hd + 2] = [500.0, -465.5]  # v past it too
    ang = rng.uniform(0.0, 6.0, (b, 1, hd // 2))
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    jqkv = jnp.asarray(qkv).astype(JAX_DTYPES[dtype])
    return jqkv, torch.from_numpy(qkv).to(dtype), cos, sin


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("dtype", QDTYPES, ids=str)
def test_ingest_plain_f8_matches_pallas(dtype, paged):
    """The plain ingest writes the Pallas kernel's f8 cache to the bit (k
    roped in f32, rounded to the activations' dtype, then narrowed; NaN
    past +-464), and its q within tolerance."""
    b, n_q, n_kv, hd, slot = 3, 4, 2, 16, 11
    jqkv, qkv, cos, sin = _ingest_operands(9, b, n_q, n_kv, hd, dtype)
    rng = np.random.default_rng(10)
    if paged:
        ps, n_pages = 8, 7
        tab = np.array([[3, 5, -1], [6, 2, -1], [-1, -1, -1]], np.int32)  # row 2 unmapped
        jk, k = _f8_pair(rng, (n_pages, n_kv, ps, hd))
        jv, v = _f8_pair(rng, (n_pages, n_kv, ps, hd))
        sink = torch.zeros((1, n_kv, ps, hd), dtype=F8)
        k, v = torch.cat([k, sink]), torch.cat([v, sink])
        extra = dict(block_tables=torch.from_numpy(tab))
        jextra = dict(block_tables=jnp.asarray(tab))
    else:
        jk, k = _f8_pair(rng, (b, n_kv, 32, hd))
        jv, v = _f8_pair(rng, (b, n_kv, 32, hd))
        extra, jextra = {}, {}
    for impl in ("pallas", "xla"):
        jq, jk2, jv2 = jax_ingest(jqkv, jnp.asarray(cos), jnp.asarray(sin), jnp.int32(slot), jk,
                                  jv, n_q=n_q, n_kv=n_kv, impl=impl, interpret=True, **jextra)
        k2, v2 = k.clone(), v.clone()
        before = fused_qkv_ingest_plain.launches
        q = fused_qkv_ingest(qkv, torch.from_numpy(cos), torch.from_numpy(sin), slot, k2, v2,
                             n_q=n_q, n_kv=n_kv, **extra)
        assert fused_qkv_ingest_plain.launches == before + 1
        live = slice(None, -1) if paged else slice(None)
        np.testing.assert_array_equal(_bits(k2[live]), _jax_bits(jk2))
        np.testing.assert_array_equal(_bits(v2[live]), _jax_bits(jv2))
        _close(q, jq, dtype)
    assert np.isnan(k2[live].float().numpy()).any() and np.isnan(v2[live].float().numpy()).any()


# ------------------------------------------------------------- the tiny model


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = JaxConfig.tiny(num_hidden_layers=2)
    params = JM.init_params(cfg, jax.random.PRNGKey(105), jnp.float32)
    path = tmp_path_factory.mktemp("tiny_f8")
    jax_save_tiny_checkpoint(path, params, cfg)
    return path


PROMPT = "an f8 cache holds this prompt's keys and values in half the bytes"


@pytest.mark.parametrize("fusion", ["none", "ingest"])
@pytest.mark.parametrize("chunk", [1, 4])
def test_generator_f8_streams_match_jax(ckpt, chunk, fusion):
    def step(config, params):
        jfusion = "ingest@pallas" if fusion == "ingest" else "none"
        return JaxStep(dataclasses.replace(config, fusion_impl=jfusion), params,
                       max_seq_len=256, cache_dtype=JF8)

    jgen = JaxGenerator.load(ckpt, dtype=jnp.float32, max_seq_len=256,
                             sampling=JaxSampling(**GREEDY), step_factory=step,
                             decode_chunk_size=chunk)
    jgen.add_message(JaxMessage.user(PROMPT))
    jgen.generate(12)
    pgen = LlamaGenerator.load(ckpt, dtype=torch.float32, kv_dtype=F8, max_seq_len=256,
                               sampling=SamplingConfig(**GREEDY), device="cpu",
                               decode_chunk_size=chunk, fusion_impl=fusion)
    assert pgen.step._kv.k.dtype == F8
    pgen.add_message(Message.user(PROMPT))
    pgen.generate(12)
    assert pgen.generated_token_ids == jgen.generated_token_ids
    assert len(pgen.generated_token_ids) > 1


TURNS = ["Tell me about cakes.", "What is the capital of France?", "Name a colour.",
         "And about pies?"]
# Pages of 128: the JAX paged kernels' (below it the JAX engine takes its XLA
# twins, whose fresh prefill attends the chunk's own K/V, not the f8 cache).
ENGINE_MODES = {
    "dense": {},
    "paged": {"kv_mode": "paged", "page_size": PS},
    # Pages enough for the cached chains beside 4 live lanes (the default
    # pool, lanes x pages a sequence, truncates a warm lane in both packages).
    "prefix": {"kv_mode": "paged", "page_size": PS, "prefix_cache": True, "max_pages": 32},
}
SERVE = dict(max_batch=4, decode_chunk_size=4, admission_window=0.05)


# Longer than two pages of 128 byte tokens: a second wave forks its pages.
SYSTEM = ("You are a terse assistant who answers every question in one short sentence, "
          "keeps to plain words, never repeats the question, and ends without a question "
          "of its own. When a question has no answer, say so in five words or fewer, and "
          "when it has one, give the answer first and the reason after it, if at all.")


def _wave(engine, message_cls, sampling, n=10):
    handles = [engine.submit([message_cls.system(SYSTEM), message_cls.user(t)], n, sampling)
               for t in TURNS]
    return [[t.id for t in h.tokens()] for h in handles]


@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_engine_f8_rows_match_jax(ckpt, mode):
    """The JAX engine on its TPU route, the Pallas kernels (interpret mode),
    whose prefill reads the f8 cache it has just written, as the port's
    does; its CPU default, the XLA twins, attends a fresh prefill over the
    chunk's unrounded K/V instead."""
    cfg = dataclasses.replace(JaxConfig.from_model_dir(ckpt), attention_impl="pallas")
    jeng = JaxEngine(cfg, jax_load_params(ckpt, cfg, jnp.float32), jax_load_tokenizer(ckpt),
                     max_seq_len=512, cache_dtype=JF8,
                     serve=JaxServe(**SERVE, **ENGINE_MODES[mode]))
    jeng.start()
    try:
        want = _wave(jeng, JaxMessage, JaxSampling(**GREEDY))
    finally:
        jeng.stop()
    pcfg = LlamaConfig.from_model_dir(ckpt)
    eng = BatchEngine(pcfg, load_params(ckpt, pcfg, torch.float32, "cpu"), load_tokenizer(ckpt),
                      max_seq_len=512, cache_dtype=F8,
                      serve=ServeConfig(**SERVE, **ENGINE_MODES[mode]), device="cpu")
    eng.start()
    try:
        waves = []
        for _ in range(2 if mode == "prefix" else 1):
            waves.append(_wave(eng, Message, SamplingConfig(**GREEDY)))
            assert eng.wait_idle(10.0)
        stats = eng.snapshot()
    finally:
        eng.stop()
    assert waves[0] == want
    assert all(len(ids) > 0 for ids in want)
    if mode == "prefix":
        assert waves[1] == waves[0]  # warm (served from the prefix cache) = cold
        assert stats["prefix_hits"] > 0 and stats["page_truncations"] == 0
