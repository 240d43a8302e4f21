"""Mixed clusters: the port's frames are the JAX package's, so a port master
drives JAX workers and a JAX master drives port workers. Greedy streams of
both mixes equal the all-JAX cluster's (w1: layers 0-1, w2: 3-4, the master
2 and 5; a tiny f32 checkpoint), for a fresh dialog and after a reset on
live connections."""

import jax.numpy as jnp
import pytest
import torch

import _tcp_cluster as C
from _tcp_cluster import one_torch_thread  # noqa: F401  (autouse)
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.parallel.topology import Topology as JaxTopology
from cake_tpu.runtime.master import DistributedForwardStep as JaxStep
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.parallel.topology import Topology
from cake_tpu_torch.runtime.master import DistributedForwardStep

PROMPTS = ("mixed cluster probe", "a second dialog on the same connections")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return C.write_checkpoint(tmp_path_factory.mktemp("mixed") / "model", seed=17)


@pytest.fixture(scope="module")
def jax_streams(model_dir):
    cfg = JaxConfig.from_model_dir(model_dir)
    with C.jax_cluster(model_dir) as (topo, _):
        step = JaxStep(cfg, model_dir, topo, dtype=jnp.float32, max_seq_len=C.MAX_SEQ)
        try:
            return [C.jax_ids(cfg, step, p, 8) for p in PROMPTS]
        finally:
            step.close()


def test_port_master_over_jax_workers(model_dir, jax_streams):
    cfg = LlamaConfig.from_model_dir(model_dir)
    with C.jax_cluster(model_dir) as (jtopo, _):
        step = DistributedForwardStep(cfg, model_dir, C.as_topology(Topology, jtopo),
                                      dtype=torch.float32, max_seq_len=C.MAX_SEQ, device="cpu")
        try:
            assert all(c.info.batch_ops for c in step.clients.values())
            assert [C.port_ids(cfg, step, p, 8) for p in PROMPTS] == jax_streams
        finally:
            step.close()


def test_jax_master_over_port_workers(model_dir, jax_streams):
    cfg = JaxConfig.from_model_dir(model_dir)
    with C.port_cluster(model_dir) as (topo, workers):
        step = JaxStep(cfg, model_dir, C.as_topology(JaxTopology, topo), dtype=jnp.float32,
                       max_seq_len=C.MAX_SEQ)
        try:
            assert [C.jax_ids(cfg, step, p, 8) for p in PROMPTS] == jax_streams
            assert all(w.ops > 0 for w in workers.values())
        finally:
            step.close()
