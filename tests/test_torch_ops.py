"""The port's plain ops against their JAX counterparts: the same numpy inputs
through both packages in f32, max-abs 1e-4 on activations and 1e-3 on
logits-sized outputs, exact where the op only selects or concatenates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.models.llama.config import RopeScaling as JaxRopeScaling
from cake_tpu.ops import fuse as jfuse
from cake_tpu.ops import mlp as jmlp
from cake_tpu.ops import norm as jnorm
from cake_tpu.ops import rope as jrope
from cake_tpu.ops import sampling as jsampling
from cake_tpu_torch.models.llama.config import RopeScaling
from cake_tpu_torch.ops import fuse, mlp, norm, rope, sampling

ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("offset", [False, True])
def test_rms_norm(offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    ref = jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset)
    out = norm.rms_norm(_t(x), _t(w), 1e-5, offset)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("scaled", [False, True])
def test_rope_with_llama31_scaling(scaled):
    kw = dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
              original_max_position_embeddings=64)
    js = JaxRopeScaling(**kw) if scaled else None
    ps = RopeScaling(**kw) if scaled else None
    np.testing.assert_array_equal(
        rope.rope_frequencies(64, 500000.0, ps), jrope.rope_frequencies(64, 500000.0, js)
    )
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    jc, js_ = jrope.rope_table(64, 256, 500000.0, js)
    pc, ps_ = rope.rope_table(64, 256, 500000.0, ps)
    ref = jrope.apply_rope(jnp.asarray(x), jc, js_, jnp.asarray(pos))
    out = rope.apply_rope(_t(x), pc, ps_, _t(pos).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("activation", ["silu", "gelu_tanh"])
def test_swiglu_gu(activation):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    w_gu = (rng.standard_normal((32, 2 * 48)) * 0.2).astype(np.float32)
    w_down = (rng.standard_normal((48, 32)) * 0.2).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jmlp.swiglu_gu(jnp.asarray(x), jnp.asarray(w_gu), jnp.asarray(w_down), activation)
    out = mlp.swiglu_gu(_t(x), _t(w_gu), _t(w_down), activation)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_fuse_params_columns_match_the_jax_fusion():
    """wqkv / bqkv / w_gu are the same column concatenation in both packages."""
    rng = np.random.default_rng(3)
    layers = {
        name: rng.standard_normal(shape).astype(np.float32)
        for name, shape in {
            "wq": (2, 16, 32), "wk": (2, 16, 8), "wv": (2, 16, 8),
            "bq": (2, 32), "bk": (2, 8), "bv": (2, 8),
            "w_gate": (2, 16, 24), "w_up": (2, 16, 24), "w_down": (2, 24, 16),
        }.items()
    }
    ref = jfuse.fuse_params({"layers": {k: jnp.asarray(v) for k, v in layers.items()}})
    out = fuse.fuse_params({"layers": {k: _t(v) for k, v in layers.items()}})
    assert set(out["layers"]) == set(ref["layers"])
    for key, val in ref["layers"].items():
        np.testing.assert_array_equal(out["layers"][key].numpy(), np.asarray(val))
    assert fuse.fuse_params(out)["layers"] is out["layers"]  # idempotent


def test_apply_repeat_penalty():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 50)).astype(np.float32)
    ctx = np.asarray([[3, 7, 7, -1, -1], [0, 49, -1, -1, -1]], np.int32)
    ref = jsampling.apply_repeat_penalty(jnp.asarray(logits), 1.3, jnp.asarray(ctx))
    out = sampling.apply_repeat_penalty(_t(logits), 1.3, _t(ctx))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=0, rtol=1e-6)


@pytest.mark.parametrize(
    "temperature,top_k,top_p", [(0.7, None, None), (1.0, 5, None), (0.9, None, 0.8), (1.3, 10, 0.5)]
)
def test_filter(temperature, top_k, top_p):
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, 64)) * 3).astype(np.float32)
    ref = np.asarray(jsampling._filter(jnp.asarray(logits), temperature, top_k, top_p))
    out = sampling._filter(_t(logits), temperature, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    finite = np.isfinite(ref)
    np.testing.assert_allclose(out[finite], ref[finite], atol=1e-5, rtol=0)


@pytest.mark.parametrize("temperature,top_k,top_p", [(0.0, None, None), (0.8, 8, None), (1.0, None, 0.9)])
def test_sample_with_the_same_gumbel_noise(temperature, top_k, top_p):
    """JAX's categorical draw is argmax(logits + gumbel(key)); feeding the
    port that same noise must give the same ids."""
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((4, 128)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jsampling.sample(
        jnp.asarray(logits), key, temperature=temperature, top_k=top_k, top_p=top_p
    ))
    noise = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
    out = sampling.sample(
        _t(logits), temperature=temperature, top_k=top_k, top_p=top_p, noise=_t(noise)
    ).numpy()
    np.testing.assert_array_equal(out, ref)


def test_sample_from_a_generator_is_seeded():
    """A draw is seeded by its threefry key alone: the same key gives the
    same id, and it is jax.random.categorical's id for that key."""
    from cake_tpu_torch.ops.threefry import prng_key

    logits = torch.zeros((1, 1000))
    draws = [sampling.sample(logits, prng_key(7), temperature=1.0).item() for _ in range(2)]
    assert draws[0] == draws[1]
    assert draws[0] == int(jax.random.categorical(jax.random.PRNGKey(7), jnp.zeros((1, 1000)))[0])
    with pytest.raises(ValueError, match="key or noise"):
        sampling.sample(logits, None, temperature=1.0)


def test_config_copy_parses_like_the_jax_package():
    from cake_tpu_torch.models.llama.config import LlamaConfig

    for cfg in (JaxConfig(), JaxConfig.tiny(model_type="gemma2", sliding_window=16)):
        d = cfg.to_hf_dict()
        assert LlamaConfig.from_hf_dict(d).to_hf_dict() == JaxConfig.from_hf_dict(d).to_hf_dict()
    port = LlamaConfig()
    assert (port.hidden_size, port.num_hidden_layers, port.intermediate_size, port.vocab_size) == (
        4096, 32, 14336, 128256,
    )
    assert not hasattr(port, "attention_impl")
