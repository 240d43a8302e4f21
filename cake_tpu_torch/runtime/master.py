"""Master: owns the generator-side model and walks the stage plan per step
(port of ``cake_tpu/runtime/master.py``, ``DistributedForwardStep`` and
``Master``).

The master runs the embedding, the final norm and the LM head (sampling runs
in the generator or the engine on top); each stage of the topology's plan
either runs locally (layers no node names) or is forwarded to a worker as
ONE round trip per contiguous span. It holds only the head's weights and its
own ranges. Speculative verify over TCP and the cluster-stats pull are not
ported (ROADMAP.md queue A).
"""

from __future__ import annotations

import logging
import time
import uuid
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from cake_tpu_torch.device import resolve_device
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.cache import SEQ_MULTIPLE, init_cache
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import LlamaGenerator, StepConnectionError, Token
from cake_tpu_torch.ops.fuse import fuse_layer_tree, resolve_fusion
from cake_tpu_torch.ops.rope import model_rope_tables
from cake_tpu_torch.parallel.topology import MASTER_NODE, Stage, Topology
from cake_tpu_torch.runtime.client import StageClient
from cake_tpu_torch.runtime.router import ReplicaRouter
from cake_tpu_torch.runtime.worker import range_layers, torch_to_wire, wire_to_torch

log = logging.getLogger("cake_tpu_torch.master")

HEAD_KEYS = ("embed", "ln_f", "lm_head")


class DistributedForwardStep:
    """ForwardStep that walks local stages and remote workers per step.

    From a checkpoint directory, or (the test and chip_smoke seam) from
    ``params``, a full stacked tree already on the device: the head and the
    local ranges are then views of its tensors. One client per node of the
    plan, every replica member included, so a failover is a route flip, not
    a cold dial."""

    def __init__(
        self,
        config: LlamaConfig,
        model_dir: str | Path | None,
        topology: Topology,
        *,
        dtype: torch.dtype = torch.bfloat16,
        max_seq_len: int | None = None,
        kv_dtype: torch.dtype | None = None,
        op_deadline_s: float | None = None,
        op_retries: int = 2,
        reconnect_attempts: int = 3,
        reconnect_backoff_s: float = 0.5,
        device: torch.device | str | None = None,
        params: dict | None = None,
    ):
        if (params is None) == (model_dir is None):
            raise ValueError("DistributedForwardStep takes a model_dir or params, not both")
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        self.kv_dtype = dtype if kv_dtype is None else kv_dtype
        self._max_seq = int(max_seq_len or config.max_position_embeddings)
        self.plan: list[Stage] = topology.stage_plan(config.num_hidden_layers)
        topology.validate(config.num_hidden_layers)
        # The request id of the current request (runtime/api.py sets it); it
        # rides every FORWARD header. None = untraced.
        self.trace_id: str | None = None

        local = [(s.lo, s.hi) for s in self.plan if s.node == MASTER_NODE]
        if params is not None:
            self.head = {k: params[k] for k in HEAD_KEYS if k in params}
            layers = fuse_layer_tree(params["layers"])
            self.local_params = {r: range_layers(layers, *r) for r in local}
        else:
            from cake_tpu_torch.io.safetensors_io import load_head, load_params

            self.head = load_head(model_dir, config, dtype, self.device)
            self.local_params = {
                r: load_params(model_dir, config, dtype, self.device, layer_range=r,
                               head=False)["layers"]
                for r in local
            }

        # The plan names each span's PRIMARY; the router resolves it to the
        # member that serves this sequence (epoch).
        self.replica_groups = topology.replica_groups()
        self.router = ReplicaRouter({
            s.node: self.replica_groups.get(s.node, [s.node])
            for s in self.plan if s.node != MASTER_NODE
        })
        self.clients: dict[str, StageClient] = {}
        for s in self.plan:
            if s.node == MASTER_NODE:
                continue
            for member in self.replica_groups.get(s.node, [s.node]):
                if member not in self.clients:
                    self.clients[member] = StageClient(
                        topology.nodes[member].host, member, op_deadline_s=op_deadline_s,
                        op_retries=op_retries, reconnect_attempts=reconnect_attempts,
                        reconnect_backoff_s=reconnect_backoff_s,
                    )

        padded = -(-self._max_seq // SEQ_MULTIPLE) * SEQ_MULTIPLE  # the caches' length
        self._rope = model_rope_tables(config, padded, self.device)
        self._local_kv = None
        self.reset()

    @property
    def max_seq_len(self) -> int:
        return self._max_seq

    def reset(self) -> None:
        """A new sequence: the router's next route, and a fresh replay
        session on every routed worker (the previous sid retired where one
        was held). The local ranges' caches are kept: slots past the live
        prefix are never read."""
        if self._local_kv is None:
            c = self.config
            self._local_kv = {
                (lo, hi): init_cache(hi - lo, 1, self._max_seq, c.num_key_value_heads,
                                     c.head_dim, self.kv_dtype, self.device)
                for (lo, hi) in self.local_params
            }
        routes = self.router.refresh()
        sid = f"seq-{uuid.uuid4().hex[:12]}"
        routed = set(routes.values())
        for name, client in self.clients.items():
            if client.sid is not None:
                try:
                    client.reset()  # retire the previous sid's worker state
                except (ConnectionError, TimeoutError, OSError):
                    # A dead connection holds nothing to retire; reconnect
                    # only nodes this route still uses.
                    if name in routed:
                        client.reconnect()
                client.sid = None
            if name in routed:
                client.begin_session(sid)

    @torch.inference_mode()
    def __call__(self, tokens: np.ndarray, pos: int, seq_len: int) -> torch.Tensor:
        """[b, vocab] f32 logits at ``seq_len - 1`` on the master's device."""
        fusion = resolve_fusion(self.config)
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int64).to(self.device)
        x = self._walk_plan(M.embed_tokens(self.head, toks, self.config), int(pos), fusion)
        return M.head_forward(self.head, x, int(seq_len), self.config, fusion)

    def _walk_plan(self, x: torch.Tensor, pos: int, fusion) -> torch.Tensor:
        cached = M.is_cached_prefill(pos, x.shape[1])
        i = 0
        while i < len(self.plan):
            s = self.plan[i]
            if s.node == MASTER_NODE:
                r = (s.lo, s.hi)
                x, self._local_kv[r] = M.blocks_forward(
                    self.local_params[r], x, self._local_kv[r], *self._rope, pos, self.config,
                    cached_prefill=cached, fusion=fusion,
                )
                i += 1
                continue
            # One round trip for every consecutive stage of one worker.
            ranges = []
            primary = s.node
            while i < len(self.plan) and self.plan[i].node == primary:
                ranges.append((self.plan[i].lo, self.plan[i].hi))
                i += 1
            node = self.router.route(primary)
            try:
                out = self.clients[node].forward(torch_to_wire(x), ranges, pos,
                                                 trace=self.trace_id)
            except (ConnectionError, TimeoutError, OSError) as e:
                # The client's retries are spent or the worker lost the
                # session: eject the member (the history replay walks a
                # healthy replica where there is one), re-dial, and raise
                # the error the generator recovers from. The range is never
                # computed here instead.
                log.warning("hop to %s failed: %s", node, e)
                self.router.report_failure(node)
                try:
                    self.clients[node].reconnect()
                except (ConnectionError, TimeoutError, OSError):
                    pass
                raise StepConnectionError(node) from e
            self.router.report_success(node)
            x = wire_to_torch(out, self.dtype, self.device)
        return x

    def close(self) -> None:
        for c in self.clients.values():
            c.close()


class Master:
    """Generation orchestrator with tokens/s reporting."""

    def __init__(self, generator: LlamaGenerator, sample_len: int = 100):
        self.generator = generator
        self.sample_len = sample_len

    def generate(self, on_token: Callable[[Token], None] | None = None) -> str:
        """The decode loop; tokens/s excludes the first token (the prefill)."""
        first_token_at: float | None = None
        count = 0

        def hook(tok: Token) -> None:
            nonlocal first_token_at, count
            count += 1
            if count == 1:
                first_token_at = time.perf_counter()
            if on_token is not None:
                on_token(tok)

        start = time.perf_counter()
        text = self.generator.generate(self.sample_len, on_token=hook)
        elapsed = time.perf_counter() - start
        if count > 1 and first_token_at is not None:
            dt = time.perf_counter() - first_token_at
            log.info("%d tokens in %.2fs: %.2f tok/s (first token %.2fs, excluded)", count,
                     elapsed, (count - 1) / dt if dt > 0 else float("inf"),
                     first_token_at - start)
        return text
