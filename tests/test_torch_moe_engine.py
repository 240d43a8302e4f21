"""The port's serving paths with a sparse-MoE model against the JAX
package's, on the CPU: a tiny Mixtral (4 layers, 4 experts, top-2) written
by the JAX package.

  * The batch engine, paged with the prefix cache and dense, under the epoch
    and the continuous schedulers: greedy and seeded sampled streams equal
    the JAX ``BatchEngine``'s (its attention through the Pallas kernels in
    interpret mode). Prefill windows of 8 rows or more take the grouped
    dispatch, pads included; decode steps the dense combine.
  * The TCP pipeline: the port's master with a port worker that loads
    layers 1-2 of the MoE checkpoint gives the local generator's greedy ids
    (tests/test_moe.py's pin for the JAX package), and so does the JAX
    master over JAX workers.
  * The CLI serves it with ``--quantize int8|int4`` and ``--kv-dtype f8``,
    and ``--fusion all --decode-chunk 4`` gives the plain prompt's text.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import _continuous_pair as P
import _tcp_cluster as C
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)
from cake_tpu.io.safetensors_io import save_tiny_checkpoint as jax_save_tiny_checkpoint
from cake_tpu.models.llama import model as JM
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.runtime.master import DistributedForwardStep as JaxStep
from cake_tpu_torch.io.safetensors_io import load_params
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import LocalForwardStep
from cake_tpu_torch.ops import moe
from cake_tpu_torch.runtime.master import DistributedForwardStep

MIXTRAL = dict(model_type="mixtral", num_local_experts=4, num_experts_per_tok=2)


def _write(path, n_layers, seed):
    cfg = JaxConfig.tiny(num_hidden_layers=n_layers, **MIXTRAL)
    jax_save_tiny_checkpoint(path, JM.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32),
                             cfg)
    return path


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    pkgs = P.packages(_write(tmp_path_factory.mktemp("tiny_mixtral"), 2, 13))
    pkgs["jax"].cfg = dataclasses.replace(pkgs["jax"].cfg, attention_impl="pallas")
    assert pkgs["port"].cfg.num_local_experts == 4
    return pkgs


def _together(pkg, eng, knobs):
    """Every request submitted before start(): the engines admit one group."""
    handles = [eng.submit([pkg.message.user(u)], n, pkg.sampling(seed=seed, **knobs))
               for u, n, seed in P.MIXED]
    eng.start()
    out = [[t.id for t in h.tokens()] for h in handles]
    assert pkg.idle(eng)
    return out


@pytest.mark.parametrize("knobs", list(P.KNOBS))
@pytest.mark.parametrize("mode", ["prefix", "dense"])
def test_epoch_engine_streams_equal_the_jax_engine(packages, mode, knobs):
    sizes = []
    moe.GROUP_SIZES = sizes
    try:
        got = P.both(packages, lambda pkg, e: _together(pkg, e, P.KNOBS[knobs]),
                     **P.MODES[mode])
    finally:
        moe.GROUP_SIZES = None
    assert got["port"] == got["jax"]
    assert all(len(ids) > 1 for ids in got["port"])
    assert sizes  # the prefill windows took the grouped dispatch


@pytest.mark.parametrize("knobs", list(P.KNOBS))
@pytest.mark.parametrize("mode", ["prefix", "dense"])
def test_continuous_engine_streams_equal_the_jax_engine(packages, mode, knobs):
    got = P.both(packages, lambda pkg, e: P.mixed(pkg, e, P.KNOBS[knobs]),
                 scheduler="continuous", **P.MODES[mode])
    assert got["port"] == got["jax"]
    assert got["port"][1] >= 1  # the late requests joined


def test_moe_over_tcp_equals_the_local_generator(tmp_path):
    model_dir = _write(tmp_path / "model", 4, 8)
    cfg = LlamaConfig.from_model_dir(model_dir)
    params = load_params(model_dir, cfg, torch.float32)
    layout = {"w1": ["model.layers.1-2"]}
    local = LocalForwardStep(cfg, params, max_seq_len=C.MAX_SEQ, cache_dtype=torch.float32,
                             device="cpu")
    want = C.port_ids(cfg, local, "moe over tcp", 8)
    with C.port_cluster(model_dir, layout) as (topo, workers):
        assert set(workers["w1"].range_params[(1, 3)]) >= {"router", "w_gate", "w_down"}
        step = DistributedForwardStep(cfg, model_dir, topo, dtype=torch.float32,
                                      max_seq_len=C.MAX_SEQ, device="cpu")
        try:
            assert C.port_ids(cfg, step, "moe over tcp", 8) == want
        finally:
            step.close()
    jcfg = JaxConfig.from_model_dir(model_dir)
    with C.jax_cluster(model_dir, layout) as (jtopo, _):
        jstep = JaxStep(jcfg, model_dir, jtopo, dtype=jnp.float32, max_seq_len=C.MAX_SEQ)
        try:
            assert C.jax_ids(jcfg, jstep, "moe over tcp", 8) == want
        finally:
            jstep.close()


@pytest.fixture(scope="module")
def mixtral_dir(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("cli_mixtral"), 2, 21)


def _cli(model_dir, *flags):
    proc = subprocess.run(
        [sys.executable, "-m", "cake_tpu_torch.cli", "--model", str(model_dir), "--prompt",
         "route me", "-n", "6", "--device", "cpu", "--dtype", "f32", "--temperature", "0",
         *flags],
        cwd=Path(__file__).resolve().parent.parent, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout
    return proc.stdout


@pytest.mark.parametrize("flags", [("--quantize", "int8"), ("--quantize", "int4"),
                                   ("--kv-dtype", "f8")], ids=lambda f: f[-1])
def test_cli_serves_a_moe_model(mixtral_dir, flags):
    _cli(mixtral_dir, *flags)


def test_cli_fused_chunks_equal_the_plain_prompt(mixtral_dir):
    """On the CPU every fusion is its plain arithmetic, so the greedy text of
    ``--fusion all --decode-chunk 4`` is the plain prompt's."""
    assert _cli(mixtral_dir, "--fusion", "all", "--decode-chunk", "4") == _cli(mixtral_dir)
