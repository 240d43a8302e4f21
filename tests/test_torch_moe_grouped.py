"""The grouped expert GEMM's plain version and the MoE warm prefix wave, on
the CPU.

``ops/moe.grouped_matmul`` launches ``csrc/moe_grouped.cu`` on the card and
takes its plain version (one product an expert) on the CPU; the kernel
itself is held to that plain version in tests/test_torch_cuda.py and by
chip_smoke.py. Here:

  * the plain grouped product's rows are bitwise independent of the group
    sizes: the same rows give the same bits whatever else their expert got
    (f32 and bf16, plain and int8 stacks), which is what the kernel's fixed
    row tile and K order give on the card;
  * the wrapper takes the plain version on a CPU tensor, counts it there,
    and keeps the int8 stacks' per-expert scale after the product;
  * on a tiny Mixtral ``BatchEngine`` with the prefix cache, a warm wave
    (the same prompts, their chains cached) gives the cold wave's streams,
    and both equal the JAX engine's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import _continuous_pair as P
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)
from cake_tpu.io.safetensors_io import save_tiny_checkpoint as jax_save_tiny_checkpoint
from cake_tpu.models.llama import model as JM
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu_torch.ops import moe
from cake_tpu_torch.ops.quant import quantize_weight

MIXTRAL = dict(model_type="mixtral", num_local_experts=4, num_experts_per_tok=2)


def _case(dtype, quant, k=64, n=48, e=4, rows=200, seed=0):
    gen = torch.Generator().manual_seed(seed)
    xs = torch.randn(rows, k, generator=gen).to(dtype)
    w = torch.randn(e, k, n, generator=gen) * k ** -0.5
    mats = quantize_weight(w).w if quant else w.to(dtype)
    return xs, mats


def _offsets(sizes):
    off = torch.zeros(len(sizes) + 1, dtype=torch.int32)
    off[1:] = torch.cumsum(torch.tensor(sizes), 0)
    return off


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_plain_grouped_rows_are_independent_of_the_group_sizes(dtype, quant):
    xs, mats = _case(dtype, quant)
    probe = xs[:5]

    def run(n_e0, before, after):
        rows = torch.cat([xs[150 : 150 + n_e0], xs[20 : 20 + before], probe,
                          xs[60 : 60 + after]])
        sizes = [n_e0, before + 5 + after, 0, 3]
        rows = torch.cat([rows, xs[190:193]])
        out = moe.grouped_matmul(rows, mats, _offsets(sizes), sizes)
        return out[n_e0 + before : n_e0 + before + 5]

    ref = run(0, 0, 0)
    for n_e0, before, after in [(0, 0, 1), (3, 0, 40), (0, 17, 0), (40, 33, 90), (1, 64, 64)]:
        assert torch.equal(run(n_e0, before, after), ref), (n_e0, before, after)


def test_wrapper_takes_the_plain_version_on_the_cpu_and_keeps_the_scale():
    xs, _ = _case(torch.float32, False)
    w = torch.randn(4, 64, 48, generator=torch.Generator().manual_seed(1))
    q = quantize_weight(w)
    sizes = [50, 0, 100, 50]
    eids = torch.repeat_interleave(torch.arange(4), torch.tensor(sizes))
    before = moe.grouped_matmul_plain.launches
    out = moe._ragged(xs, q, sizes, _offsets(sizes), eids)
    assert moe.grouped_matmul_plain.launches == before + 1
    want = torch.cat([xs[lo : lo + n] @ q.w[e].float() * q.scale[e, 0].float()
                      for e, (lo, n) in enumerate(zip([0, 50, 50, 150], sizes)) if n])
    assert torch.equal(out, want)


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny_mixtral_warm")
    cfg = JaxConfig.tiny(num_hidden_layers=2, **MIXTRAL)
    jax_save_tiny_checkpoint(path, JM.init_params(cfg, jax.random.PRNGKey(13), jnp.float32), cfg)
    pkgs = P.packages(path)
    pkgs["jax"].cfg = dataclasses.replace(pkgs["jax"].cfg, attention_impl="pallas")
    return pkgs


def _cold_then_warm(pkg, eng):
    """The same wave twice on one engine: cold, then warm over the chains
    the cold wave cached."""
    eng.start()
    waves = []
    for _ in range(2):
        hs = [eng.submit([pkg.message.user(u)], n, pkg.sampling(seed=seed, **P.KNOBS["greedy"]))
              for u, n, seed in P.MIXED]
        waves.append([[t.id for t in h.tokens()] for h in hs])
        assert pkg.idle(eng)
    return waves, eng.stats["prefix_hits"]


def test_mixtral_warm_wave_equals_the_cold_wave_and_the_jax_engine(packages):
    sizes = []
    moe.GROUP_SIZES = sizes
    try:
        got = P.both(packages, _cold_then_warm, **P.MODES["prefix"])
    finally:
        moe.GROUP_SIZES = None
    (cold, warm), hits = got["port"]
    assert warm == cold and hits >= len(P.MIXED)
    assert got["port"][0] == got["jax"][0]
    assert any(sum(s) >= moe.GROUPED_MIN_TOKENS for s in sizes)  # the grouped dispatch ran
