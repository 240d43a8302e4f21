"""Shared by the tests that hold the port's continuous scheduler to the JAX
package's (tests/test_torch_continuous_jax.py, test_torch_preempt_jax.py,
test_torch_continuous_prefix_jax.py): one tiny checkpoint (2 layers, written
by the JAX package), each package's engine over it at max_seq 256 and pages
of 16, and the scenarios, written once for both packages; and the fixture that
runs a module's tests on one torch thread."""

import jax
import jax.numpy as jnp
import pytest
import torch

from cake_tpu.io.safetensors_io import load_params as jax_load_params
from cake_tpu.io.safetensors_io import save_tiny_checkpoint as jax_save_tiny_checkpoint
from cake_tpu.models.llama import model as JM
from cake_tpu.models.llama.chat import Message as JaxMessage
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.models.llama.generator import SamplingConfig as JaxSampling
from cake_tpu.models.llama.tokenizer import load_tokenizer as jax_load_tokenizer
from cake_tpu.runtime.serving import BatchEngine as JaxEngine
from cake_tpu.runtime.serving import ServeConfig as JaxServe
from cake_tpu_torch.io.safetensors_io import load_params
from cake_tpu_torch.models.llama.chat import Message
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import SamplingConfig
from cake_tpu_torch.models.llama.tokenizer import load_tokenizer
from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

MAX_SEQ = 256
PAGE = 16
SERVE = dict(max_batch=4, decode_chunk_size=4, admission_window=0.05)
MODES = {
    "dense": {},
    "paged": {"kv_mode": "paged", "page_size": PAGE},
    "prefix": {"kv_mode": "paged", "page_size": PAGE, "prefix_cache": True},
}
KNOBS = {
    "greedy": dict(temperature=0.0, repeat_penalty=1.0),
    "sampled": dict(temperature=0.8, top_k=20, repeat_penalty=1.1, repeat_last_n=8),
}
# (user turn, max_tokens, seed): the first two open the segment, the last
# two join it.
MIXED = [
    ("short", 24, 7),
    ("a medium prompt with some more words in it", 24, 2**32 + 3),
    ("the long prompt of this batch, padded out with further words so its bucket is "
     "clearly taller than the short one's", 10, 11),
    ("late joiner", 8, -5),
]
# Two long prompts, 48 tokens each: 14 pages cannot hold both to the end.
PRESSURE = ["alpha prompt padded out to be long " * 2, "row two also made quite long here " * 2]
SMALL_POOL = 14


def write_checkpoint(path):
    cfg = JaxConfig.tiny(num_hidden_layers=2)
    jax_save_tiny_checkpoint(path, JM.init_params(cfg, jax.random.PRNGKey(31), jnp.float32), cfg)
    return path


class JaxPackage:
    """The JAX package's engine and message and sampling classes."""

    def __init__(self, ckpt):
        self.cfg = JaxConfig.from_model_dir(ckpt)
        self.params = jax_load_params(ckpt, self.cfg, jnp.float32)
        self.tok = jax_load_tokenizer(ckpt)
        self.message, self.sampling = JaxMessage, JaxSampling

    def engine(self, max_seq=MAX_SEQ, **kw):
        return JaxEngine(self.cfg, self.params, self.tok, max_seq_len=max_seq,
                         cache_dtype=jnp.float32, serve=JaxServe(**{**SERVE, **kw}))

    def idle(self, eng):
        return eng.quiesce()


class PortPackage:
    """The port's."""

    def __init__(self, ckpt):
        self.cfg = LlamaConfig.from_model_dir(ckpt)
        self.params = load_params(ckpt, self.cfg, torch.float32, "cpu")
        self.tok = load_tokenizer(ckpt)
        self.message, self.sampling = Message, SamplingConfig

    def engine(self, max_seq=MAX_SEQ, **kw):
        return BatchEngine(self.cfg, self.params, self.tok, max_seq_len=max_seq,
                           cache_dtype=torch.float32, serve=ServeConfig(**{**SERVE, **kw}),
                           device="cpu")

    def idle(self, eng):
        return eng.wait_idle(30.0)


def packages(ckpt) -> dict:
    return {"jax": JaxPackage(ckpt), "port": PortPackage(ckpt)}


def serve(pkg, run, **kw):
    """``run(engine)`` on a new engine of ``pkg``, stopped after."""
    eng = pkg.engine(**kw)
    try:
        return run(eng)
    finally:
        eng.stop()


def mixed(pkg, eng, knobs: dict) -> tuple[list[list[int]], int]:
    """MIXED's first two submitted before start(), the other two once the
    first stream has its first token: (the streams, the joins)."""
    handles = [eng.submit([pkg.message.user(u)], n, pkg.sampling(seed=seed, **knobs))
               for u, n, seed in MIXED[:2]]
    eng.start()
    first = handles[0].tokens()
    head = [next(first).id]
    handles += [eng.submit([pkg.message.user(u)], n, pkg.sampling(seed=seed, **knobs))
                for u, n, seed in MIXED[2:]]
    out = [head + [t.id for t in first]] + [[t.id for t in h.tokens()] for h in handles[1:]]
    assert pkg.idle(eng)
    return out, eng.stats["joins"]


def pressure(pkg, eng, knobs: dict, reqs) -> tuple:
    """``reqs``: (prompt, max_tokens, priority), all submitted before
    start(). Returns (the streams, the finish reasons, the counts)."""
    handles = [eng.submit([pkg.message.user(p)], n, pkg.sampling(seed=7 + i, **knobs),
                          priority=pr) for i, (p, n, pr) in enumerate(reqs)]
    eng.start()
    out = [[t.id for t in h.tokens()] for h in handles]
    assert pkg.idle(eng)
    stats = {k: eng.stats[k] for k in ("preemptions", "restores", "page_truncations",
                                        "batches", "joins")}
    return out, [h.finish_reason for h in handles], stats


def both(pkgs: dict, run, **kw) -> dict:
    """``run(pkg, engine)`` on each package's engine."""
    return {name: serve(pkg, lambda e, pkg=pkg: run(pkg, e), **kw) for name, pkg in pkgs.items()}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for a module's tests (imported by name, it applies
    to the module that imports it): the tiny models gain nothing from more,
    and under a parallel run of the suite more contend with the other
    workers' for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
