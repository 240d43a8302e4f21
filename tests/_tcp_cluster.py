"""Shared by the tests of the port's master/worker pipeline
(tests/test_torch_distributed*.py): one tiny f32 checkpoint written by the
JAX package, live loopback clusters of port or JAX workers in this process
(the pattern of tests/test_runtime.py), and greedy / seeded sampled
generation through either package's generator."""

import contextlib

import jax
import jax.numpy as jnp
import pytest
import torch

from cake_tpu.io.safetensors_io import save_tiny_checkpoint as jax_save_tiny_checkpoint
from cake_tpu.models.llama import model as JM
from cake_tpu.models.llama.chat import Message as JaxMessage
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.models.llama.generator import LlamaGenerator as JaxGenerator
from cake_tpu.models.llama.generator import SamplingConfig as JaxSampling
from cake_tpu.models.llama.tokenizer import ByteTokenizer as JaxByteTokenizer
from cake_tpu.parallel.topology import Topology as JaxTopology
from cake_tpu.runtime.worker import Worker as JaxWorker
from cake_tpu_torch.models.llama.chat import Message
from cake_tpu_torch.models.llama.generator import LlamaGenerator, SamplingConfig
from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
from cake_tpu_torch.parallel.topology import Topology
from cake_tpu_torch.runtime.worker import Worker

MAX_SEQ = 96
N_LAYERS = 6
# w1 serves 0-1 and w2 3-4; the master runs 2 and 5, so a walk interleaves
# local ranges with round trips.
LAYOUT = {"w1": ["model.layers.0-1"], "w2": ["model.layers.3-4"]}
KNOBS = {
    "greedy": dict(temperature=0.0, repeat_penalty=1.0),
    "sampled": dict(temperature=0.8, top_k=20, repeat_penalty=1.1, repeat_last_n=8, seed=9),
}


def write_checkpoint(path, seed: int = 11):
    cfg = JaxConfig.tiny(num_hidden_layers=N_LAYERS)
    jax_save_tiny_checkpoint(path, JM.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32),
                             cfg)
    return path


def topology(cls, layout=LAYOUT):
    return cls.from_dict({n: {"host": "placeholder", "layers": list(l)}
                          for n, l in layout.items()})


@contextlib.contextmanager
def port_cluster(model_dir, layout=LAYOUT, max_seq_len: int = MAX_SEQ, **kw):
    """Port workers for ``layout`` on loopback ports: (topology, {name: worker})."""
    topo = topology(Topology, layout)
    workers = {}
    try:
        for name in layout:
            w = Worker(name, model_dir, topo, ("127.0.0.1", 0), dtype=torch.float32,
                       max_seq_len=max_seq_len, device="cpu", **kw)
            w.start()
            topo.nodes[name].host = f"127.0.0.1:{w.address[1]}"
            workers[name] = w
        yield topo, workers
    finally:
        for w in workers.values():
            w.stop()


@contextlib.contextmanager
def jax_cluster(model_dir, layout=LAYOUT, max_seq_len: int = MAX_SEQ):
    """JAX package workers for ``layout``: (JAX topology, {name: worker})."""
    topo = topology(JaxTopology, layout)
    workers = {}
    try:
        for name in layout:
            w = JaxWorker(name, model_dir, topo, ("127.0.0.1", 0), dtype=jnp.float32,
                          max_seq_len=max_seq_len)
            w.start()
            topo.nodes[name].host = f"127.0.0.1:{w.address[1]}"
            workers[name] = w
        yield topo, workers
    finally:
        for w in workers.values():
            w.stop()


def as_topology(cls, topo):
    """The same nodes and hosts as the other package's Topology."""
    return cls.from_dict(topo.to_dict())


def port_ids(cfg, step, prompt: str, n: int, knobs: str = "greedy", **gen_kw) -> list[int]:
    gen = LlamaGenerator(cfg, step, ByteTokenizer(), SamplingConfig(**KNOBS[knobs]), **gen_kw)
    gen.add_message(Message.user(prompt))
    gen.generate(n)
    return list(gen.generated_token_ids)


def jax_ids(cfg, step, prompt: str, n: int, knobs: str = "greedy") -> list[int]:
    gen = JaxGenerator(cfg, step, JaxByteTokenizer(), JaxSampling(**KNOBS[knobs]))
    gen.add_message(JaxMessage.user(prompt))
    gen.generate(n)
    return list(gen.generated_token_ids)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for a module's tests (imported by name, it applies
    to the module that imports it): under a parallel run of the suite more
    contend with the other workers' for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
