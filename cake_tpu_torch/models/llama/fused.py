"""Multi-token decode on the device (port of
``cake_tpu/models/llama/fused.py``).

The per-step decode loop pays a device-to-host readback per token to pull
the sampled id out. Here the chain

    forward -> repeat penalty -> temperature/top-k/top-p sample -> feed back

runs on the device for ``n_steps`` tokens, and the ids come back once per
chunk. Sampling walks the same random stream as the per-step path
(``ops/sampling.sample_step``), so a seeded chunked stream equals the
per-step one.

The JAX package compiles the chain into one ``lax.scan`` under ``jit``, with
the position a traced scalar, and dispatches a chunk to the device once. The
port's chain is :func:`sampled_decode_loop`, a Python loop of one-token
forwards and ``sample_step`` calls: eagerly it costs the host a launch for
every op of every step (~400-1500 a token). On the card a chunk therefore
runs as a CUDA graph (:class:`DecodeChunk`): the loop is captured once per
key, over static device buffers, and each chunk copies its few inputs into
those buffers, replays the graph and reads the ids back once. The slot is a
0-d device tensor that the forward reads on the device (cache writes,
lengths, rope rows, the ingest kernel's slot) and that each step advances in
place, so no position is baked into the graph. Over the rolling window
cache (models/llama/cache.py) the forward computes each step's ring slot,
the slot modulo the ring's length, from the same tensor, so a graph
replays across the ring's wrap; the generator keys its chunks by whether
the cache rolls. On the CPU the same loop runs over the same buffers,
uncaptured. A MoE layer's one-token step takes the
dense combine, static in shape; the grouped dispatch reads its group sizes
back to the host and raises under a capture (ops/moe.py).

EOS cannot stop a chunk early; the caller scans the returned ids and drops
the tail past EOS. Its KV writes sit past the live length, where no read
reaches them, and are overwritten if the sequence continues.

With the "tail" fusion (``LlamaConfig.fusion_impl``) each step samples
through ops/fused_sample_tail.py. The generator's ``decode_chunk``
(``LocalForwardStep``) and the batch engine's decode chunks
(runtime/batch_backend.py) run a :class:`DecodeChunk`; ``batch.decode_chunk``
and ``batch.paged_decode_chunk`` run the loop eagerly, the plain version the
graph is held against.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref

import numpy as np
import torch

from cake_tpu_torch.device import upload_into
from cake_tpu_torch.ops import launches
from cake_tpu_torch.ops.sampling import sample_step

# What every capture so far cost, for the smoke's and the bench's records:
# captures, seconds of warm-up runs and of captures (instantiation
# included), and the bytes the shared graph pool grew by.
STATS = {"captures": 0, "warmup_s": 0.0, "capture_s": 0.0, "pool_bytes": 0}

class CaptureScope:
    """Where decode graphs are captured: per device, the side stream they
    are warmed up and captured on (capture cannot use the default stream;
    the warm-up on the same stream sets up what the capture will find,
    cuBLAS's workspace for that stream included), and the one memory pool
    every live graph of the scope shares (a replay's intermediates are dead
    once it ends, and no two graphs of a scope run at once).

    Every chunk captures in :data:`SHARED_SCOPE` unless its owner gives it
    another. A batch backend that abandons a dispatch (runtime/
    batch_backend.py) moves its later chunks to a scope of their own: the
    abandoned dispatch, should it wake inside a capture, records onto its
    own stream and allocates from its own pool, and never joins a live
    capture of the next epoch; :data:`CARD_RUN_LOCK` keeps it from running
    beside one."""

    def __init__(self):
        self._pools: dict = {}
        self._streams: dict = {}

    def pool(self, device: torch.device):
        """(handle, users) of the scope's pool on ``device``. ``users`` holds
        the chunks whose graphs were captured into it; a pool whose graphs
        are all gone has been released, and a new one takes its place."""
        handle, users = self._pools.get(device, (None, None))
        if not users:
            handle, users = self._pools[device] = (torch.cuda.graph_pool_handle(),
                                                   weakref.WeakSet())
        return handle, users

    def stream(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]


SHARED_SCOPE = CaptureScope()

# On the card one chunk runs at a time in a process: its input copies, its
# warm-up and capture, and its replay's launch. A stream capture is
# invalidated by what another thread does to the context meanwhile (a
# context-wide synchronization, a kernel's first load), even in scopes of
# their own, and a dispatch the engine abandoned may wake inside a chunk
# while the next epoch captures its own (runtime/batch_backend.py).
CARD_RUN_LOCK = threading.Lock()


def sampled_decode_loop(
    forward_one, kv, tok, slot, keys, ring, ring_idx, *, n_steps, s, fused_tail=False, out=None,
):
    """``n_steps`` one-token steps, forward -> sample_step -> feed back, all
    on the device (port of ``fused.sampled_decode_scan``).

    ``forward_one(tok [B, 1], kv, slot) -> (logits [B, vocab] f32, kv)``;
    ``tok`` [B] is the most recent token at shared ``slot``; its KV is
    written there and the logits predict slot + 1. ``slot`` is a host int
    (step i feeds slot + i) or a 0-d int64 tensor on the device, advanced in
    place one a step (it ends at slot + n_steps). ``keys``: [B, 2] per-row
    threefry keys, one [2] key the rows share, or None when greedy, split
    once a sampled step (see ``sample_step``); ``s``: the sampling knobs;
    ``out``: a [B, n_steps] int64 buffer for the ids. Returns (tokens [B,
    n_steps] on the device, kv, keys, ring, ring_idx); the caller reads the
    tokens back once per chunk."""
    on_device = isinstance(slot, torch.Tensor)
    toks = []
    for i in range(n_steps):
        logits, kv = forward_one(tok[:, None], kv, slot if on_device else slot + i)
        tok, keys, ring, ring_idx = sample_step(
            logits, keys, ring, ring_idx,
            temperature=s.temperature, top_k=s.top_k, top_p=s.top_p,
            repeat_penalty=s.repeat_penalty, fused_tail=fused_tail,
        )
        if on_device:
            slot.add_(1)
        toks.append(tok)
    return torch.stack(toks, dim=1, out=out), kv, keys, ring, ring_idx


class DecodeChunk:
    """The decode chunk of one key (``n_steps``, batch, sampling knobs; the
    owner's forward fixes the KV mode, the fusions and the weights): static
    device buffers, the loop over them, and on the card the CUDA graph that
    replays it (the JAX package jits one scan per ``n_steps`` and knobs).

    Static inputs: ``tok`` [B], ``slot`` (0-d), ``ring`` [B, window],
    ``ring_idx`` [B], ``keys`` ([B, 2] per-row threefry keys, or the [2] key
    the rows share: the graph splits it and draws the noise on the device
    once a sampled step, so nothing is drawn on the host), and ``extra``, the
    buffers the owner's forward reads (pads, block tables). Static outputs:
    ``ids`` [B, n], and the carries for the next chunk in ``tok``, ``ring``,
    ``ring_idx``, ``keys`` and ``slot`` (advanced by n).

    The first :meth:`run` on the card captures the graph: the loop runs
    once eagerly on the capture stream (a warm-up: it makes the kernel
    wrappers' lazy buffers and cuBLAS's workspace outside the capture; its
    KV writes are the ones the replay repeats, and the other buffers are
    restored after it), then it is captured into the shared pool and
    replayed (on the stream and into the pool of its ``scope``, see
    :class:`CaptureScope`). A capture that fails raises: there is no eager fallback on
    the card. The wrappers' launch counts of the capture are added to their
    counters at every replay; the warm-up's are not counted
    (ops/launches.py)."""

    def __init__(self, forward_one, kv, *, batch: int, window: int, n_steps: int, s,
                 fused_tail: bool, per_row: bool, device: torch.device, extra=None,
                 scope: CaptureScope | None = None):
        i64 = dict(dtype=torch.int64, device=device)
        self.forward_one, self.kv, self.n_steps, self.s = forward_one, kv, n_steps, s
        self.fused_tail, self.device = fused_tail, device
        self.scope = scope or SHARED_SCOPE
        self.tok = torch.zeros(batch, **i64)
        self.slot = torch.zeros((), **i64)
        self.ring = torch.full((batch, window), -1, **i64)
        self.ring_idx = torch.zeros(batch, **i64)
        self.keys = torch.zeros((batch, 2) if per_row else (2,), **i64)
        self.ids = torch.zeros((batch, n_steps), **i64)
        self.extra = dict(extra or {})
        self.graph = None
        self.captured = None  # the wrappers' launch counts of the capture (ops/launches.py)
        self.replays = 0

    def body(self) -> None:
        """The chunk over the static buffers: what the graph captures."""
        ids, _, keys, _, ring_idx = sampled_decode_loop(
            self.forward_one, self.kv, self.tok, self.slot, self.keys, self.ring, self.ring_idx,
            n_steps=self.n_steps, s=self.s, fused_tail=self.fused_tail, out=self.ids,
        )
        self.tok.copy_(ids[:, -1])
        self.ring_idx.copy_(ring_idx)
        if keys is not self.keys:  # a greedy chunk leaves the keys as they are
            self.keys.copy_(keys)

    def load(self, *, tok, slot: int, ring, ring_idx, keys, **extra) -> None:
        """Copy a chunk's inputs into the static buffers: device tensors by
        a device copy (none where the value is the buffer itself, as the
        carries a previous run returned are), host values through pinned
        memory."""
        upload_into(self.slot, np.int64(slot))
        for buf, value in ((self.tok, tok), (self.ring, ring), (self.ring_idx, ring_idx),
                           (self.keys, keys), *((self.extra[k], v) for k, v in extra.items())):
            if value is not buf:
                upload_into(buf, value)

    def run(self, **inputs) -> torch.Tensor:
        """One chunk from ``inputs`` (see :meth:`load`): a replay of the
        graph on the card (captured at the first run), the loop itself on
        the CPU. Returns the ids buffer [B, n]. On the card it holds
        :data:`CARD_RUN_LOCK` throughout."""
        if self.device.type == "cuda":
            with CARD_RUN_LOCK:
                self.load(**inputs)
                if self.graph is None:
                    self._capture()
                self.graph.replay()
            launches.replayed(self.captured)
            self.replays += 1
        else:
            self.load(**inputs)
            self.body()
        return self.ids

    def _capture(self) -> None:
        dev = self.device
        stream = self.scope.stream(dev)
        carries = [self.tok, self.slot, self.ring, self.ring_idx, self.keys]
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream), launches.diverted():
            saved = [t.clone() for t in carries]
            self.body()
            for t, value in zip(carries, saved):
                t.copy_(value)
            del saved
        stream.synchronize()
        t1 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        pool, users = self.scope.pool(dev)
        with torch.cuda.stream(stream), launches.diverted() as self.captured:
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                self.body()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.graph = graph
        users.add(self)
        STATS["captures"] += 1
        STATS["warmup_s"] += t1 - t0
        STATS["capture_s"] += time.perf_counter() - t1
        STATS["pool_bytes"] += torch.cuda.memory_reserved(dev) - reserved
