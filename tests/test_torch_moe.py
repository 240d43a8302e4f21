"""The port's sparse-MoE block (``cake_tpu_torch/ops/moe.py``) and the MoE
param-tree transforms against the JAX package's, on the CPU.

Inputs come from numpy with a fixed seed and go through
``cake_tpu.ops.moe.moe_swiglu`` and the port's: the dense combine (chunks
below ``GROUPED_MIN_TOKENS``) and the grouped dispatch, with and without
the top-k renormalization, plain and int8 experts. f32 within 1e-5
max-abs, bf16 within one bf16 step at the output's magnitude; the selected
experts are equal exactly, a case with router logits tied in bf16
included (both pick the lower index). Quantization and fusion of MoE trees
are bitwise the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cake_tpu.ops.moe as jmoe
from cake_tpu.models.llama import model as JM
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.ops import fuse as jfuse
from cake_tpu.ops import quant as jquant
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.ops import moe
from cake_tpu_torch.ops.fuse import fuse_params
from cake_tpu_torch.ops.quant import Quant4Weight, QuantWeight, quantize_params, quantize_weight
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)

E, H, INTER = 8, 64, 96


def _operands(seed, b, t, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, H)).astype(np.float32)
    router = (rng.standard_normal((H, E)) * 0.5).astype(np.float32)
    wg = (rng.standard_normal((E, H, INTER)) * H**-0.5).astype(np.float32)
    wu = (rng.standard_normal((E, H, INTER)) * H**-0.5).astype(np.float32)
    wd = (rng.standard_normal((E, INTER, H)) * INTER**-0.5).astype(np.float32)
    return x, router, wg, wu, wd


def _jax(a, dtype):
    return jnp.asarray(a, jnp.float32).astype(dtype)


def _torch(a, dtype):
    """The JAX array's values as a torch tensor of the matching dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _both(ws, dtype, quant):
    """The weights for each package: cast to ``dtype``, int8 where asked
    (each package quantizes its own copy: bitwise the same, tested below)."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jws = [_jax(w, jd) for w in ws]
    pws = [_torch(w, dtype) for w in jws]
    if quant:
        jws = jws[:1] + [jquant.quantize_weight(w) for w in jws[1:]]
        pws = pws[:1] + [quantize_weight(w) for w in pws[1:]]
    return jws, pws


def _bf16_step(ref) -> float:
    top = float(np.abs(ref).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("norm_topk", [True, False], ids=["renorm", "raw"])
@pytest.mark.parametrize("t", [1, 5, 8, 24], ids=lambda t: f"t{t}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_moe_swiglu_matches_jax(dtype, t, norm_topk, quant):
    x, *ws = _operands(t, 2, t)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jws, pws = _both(ws, dtype, quant)
    jx = _jax(x, jd)
    want = np.asarray(jmoe.moe_swiglu(jx, *jws, 2, norm_topk=norm_topk).astype(jnp.float32))
    got = moe.moe_swiglu(_torch(jx, dtype), *pws, 2, norm_topk=norm_topk)
    assert got.dtype == dtype and got.shape == (2, t, H)
    tol = 1e-5 if dtype == torch.float32 else _bf16_step(want)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    # The same experts, exactly, from the same router logits.
    logits = jx @ jws[0].astype(jx.dtype)
    _, jidx = jmoe.route_topk_select(logits, 2, norm_topk)
    jv, _ = jmoe.route_topk_select(logits, 2, norm_topk)
    pv, pidx = moe.route_topk_select(_torch(logits, dtype), 2, norm_topk)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-7, rtol=0)


def test_tied_bf16_router_logits_pick_the_lower_index():
    """bf16 router logits tie often; jax.lax.top_k returns the lower index
    first, and so must the port (torch.topk promises no order on ties)."""
    rng = np.random.default_rng(3)
    vals = rng.standard_normal((4, 6, E)).astype(np.float32)
    vals[..., 5] = vals[..., 2]  # experts 2 and 5 tie
    vals[..., 7] = vals[..., 1] = vals.max(-1) + 1.0  # experts 1 and 7 tie above all
    logits = jnp.asarray(vals).astype(jnp.bfloat16)
    for k in (1, 2, 3, 4):
        jv, ji = jmoe.route_topk_select(logits, k)
        pv, pi = moe.route_topk_select(_torch(logits, torch.bfloat16), k)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-7, rtol=0)
    assert (np.asarray(ji)[..., :2] == [1, 7]).all()
    # The dense weights place the same probabilities at the same experts.
    pw = moe.route_topk(_torch(logits, torch.bfloat16), 3, E).numpy()
    jw = np.asarray(jmoe.route_topk(logits, 3, E))
    np.testing.assert_array_equal(pw > 0, jw > 0)
    np.testing.assert_allclose(pw, jw, atol=1e-7, rtol=0)
    # And a whole block routed through the tie gives the JAX package's output.
    x, _, *ws = _operands(9, 2, 12)
    router = np.zeros((H, E), np.float32)
    router[:, 2] = router[:, 5] = 0.25  # every token's logits tie at 2 and 5
    jws, pws = _both([router, *ws], torch.float32, False)
    want = jmoe.moe_swiglu(jnp.asarray(x), *jws, 2)
    got = moe.moe_swiglu(torch.from_numpy(x), *pws, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("norm_topk,quant", [(True, False), (False, False), (True, True)])
def test_grouped_dispatch_matches_dense(norm_topk, quant):
    """tests/test_moe.py's property on the port: the grouped dispatch
    (every chunk) and the dense combine (forced) agree within 2e-6."""
    rng = np.random.default_rng(11)
    b, t, h, inter, e, k = 2, 16, 32, 64, 8, 2
    x = torch.from_numpy(rng.standard_normal((b, t, h)).astype(np.float32))
    router = torch.from_numpy((rng.standard_normal((h, e)) * 0.1).astype(np.float32))
    ws = [torch.from_numpy((rng.standard_normal(s) * s[-2] ** -0.5).astype(np.float32))
          for s in ((e, h, inter), (e, h, inter), (e, inter, h))]
    if quant:
        ws = [quantize_weight(w) for w in ws]
    dense = moe.moe_swiglu(x, router, *ws, k, norm_topk=norm_topk, dispatch="dense")
    sizes = []
    moe.GROUP_SIZES = sizes
    try:
        grouped = moe.moe_swiglu(x, router, *ws, k, norm_topk=norm_topk)
    finally:
        moe.GROUP_SIZES = None
    assert len(sizes) == 1 and sum(sizes[0]) == b * t * k and len(sizes[0]) == e
    np.testing.assert_allclose(grouped.numpy(), dense.numpy(), atol=2e-6, rtol=2e-6)


def test_moe_refuses_what_it_does_not_take():
    x, router, *ws = (torch.from_numpy(a) for a in _operands(0, 1, 8))
    with pytest.raises(TypeError, match="int4"):
        moe.moe_swiglu(x, router, Quant4Weight(ws[0][:, ::2], ws[0][:, :1]), *ws[1:], 2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A item 9"):
        moe.moe_swiglu(x, router, *ws, 2, tp_axis="tp")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A item 9"):
        moe.moe_swiglu(x, router, *ws, 2, valid=torch.ones(1, 8, dtype=torch.bool))
    with pytest.raises(ValueError, match="dispatch"):
        moe.moe_swiglu(x, router, *ws, 2, dispatch="capacity")


# ---------------------------------------------------------------- transforms

FAMILIES = {
    "mixtral": dict(model_type="mixtral", num_local_experts=4, num_experts_per_tok=2),
    "qwen2_moe": dict(model_type="qwen2_moe", num_local_experts=4, num_experts_per_tok=2,
                      norm_topk_prob=False, moe_intermediate_size=48,
                      shared_expert_intermediate_size=80, attention_bias=True),
    "qwen3_moe": dict(model_type="qwen3_moe", num_local_experts=8, num_experts_per_tok=4,
                      norm_topk_prob=True, moe_intermediate_size=48, qk_norm=True,
                      head_dim_override=32),
}


def _jax_tree(family, seed=0):
    cfg = JaxConfig.tiny(num_hidden_layers=2, **FAMILIES[family])
    return jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32))


def _assert_trees_equal(port, ref):
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    for key in ref:
        p, r = port[key], ref[key]
        if isinstance(r, dict):
            _assert_trees_equal(p, r)
        elif hasattr(r, "_fields"):
            assert type(p).__name__ == type(r).__name__, key
            np.testing.assert_array_equal(p.w.numpy(), np.asarray(r.w), err_msg=key)
            np.testing.assert_array_equal(p.scale.numpy(), np.asarray(r.scale), err_msg=key)
        else:
            np.testing.assert_array_equal(p.numpy(), np.asarray(r), err_msg=key)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_init_params_has_the_jax_moe_leaves(family):
    cfg = M.LlamaConfig.tiny(num_hidden_layers=2, **FAMILIES[family])
    port = M.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    ref = _jax_tree(family)
    assert set(port["layers"]) == set(ref["layers"])
    for key, leaf in ref["layers"].items():
        assert tuple(port["layers"][key].shape) == leaf.shape, key


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fusion_of_moe_trees_matches_jax(family):
    ref = _jax_tree(family)
    _assert_trees_equal(fuse_params(M.params_from_jax(ref)), jfuse.fuse_params(ref))
    fused = fuse_params(M.params_from_jax(ref))["layers"]
    assert "w_gu" not in fused and ("sh_gu" in fused) == (family == "qwen2_moe")


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantization_of_moe_trees_matches_jax(family, mode):
    """The mixed mode: expert stacks int8 under both modes, the router and
    the shared expert's gate full precision, the shared expert with the mode."""
    ref = _jax_tree(family, 1)
    port = quantize_params(M.params_from_jax(ref), mode)
    _assert_trees_equal(port, jquant.quantize_params(ref, mode))
    layers = port["layers"]
    assert all(isinstance(layers[k], QuantWeight) for k in ("w_gate", "w_up", "w_down"))
    assert isinstance(layers["router"], torch.Tensor)
    if "sh_gate" in layers:
        assert isinstance(layers["se_gate"], torch.Tensor)
        want = Quant4Weight if mode == "int4" else QuantWeight
        assert isinstance(layers["sh_gate"], want)
    # Fusing a quantized tree fuses the shared expert's scales alike.
    _assert_trees_equal(fuse_params(port), jfuse.fuse_params(jquant.quantize_params(ref, mode)))
