"""Fused sampling tail: repeat penalty + temperature + top-k + the draw.

Replaces the Pallas TPU kernel ``cake_tpu/ops/pallas/fused_sample_tail.py``
(``fused_sample_tail``) with a CUDA kernel written for Hopper,
``ops/csrc/fused_sample_tail.cu``. Each decode step of the batch engine and
of the generator's ``decode_chunk`` samples its next ids through it.

Arithmetic, in the order of the plain composition (``ops/sampling.py``):
``apply_repeat_penalty``'s select over the ring; the division by the
temperature; the top-k threshold, the k-th largest value counting
duplicates (``torch.topk(...).values[..., -1]``) with the strict ``<``
mask; the argmax of ``scaled + noise``. The noise (gumbel rows) is an
operand: the caller draws it exactly as the unfused path does, so the two
walk one random stream. Greedy takes no noise and argmaxes the penalized
logits.

What bounds it on the H100: the bytes of the logits, ``b * V * 4`` (twice
that with noise): 1.2 us greedy at b=8 over Llama-3's 128256 ids, if the
reads spread over the card. The unfused tail is a dozen ops, each a full
pass over ``[b, V]`` plus a sort for the top-k.

What the design does about it: a thread-block cluster of C blocks a row
(:func:`plan`, from the shapes alone: 16, the non-portable size, or 8 for
top-k rows past half the SMs where its slice stages; the first the card
can schedule), block r
owning one contiguous slice of the vocabulary, so b rows keep up to b x C
SMs reading (128 of 132 at b = 8). Each block builds the penalty bitmap of its own slice from the ring (a token
twice in the ring is penalized once, the plain select's set semantics).
Greedy, and sampling without top-k, read the slice once from device memory
and argmax it. With top-k, the block copies its slice of the logits and of
the noise into shared memory (one bulk copy each on an mbarrier; the noise
arrives under the select passes), so each logit is read from device memory
once; where a slice does not fit (a vocabulary past ~420K ids), the same
kernel re-reads it from device memory in each pass. The threshold is an
exact radix select over the order-preserving uint32 key of each scaled
value, the keys written over the staged logits: four passes of 8 bits, a
block's histogram from per-warp sub-histograms into one of two shared
buffers, one cluster barrier a pass, then every block sums the C
histograms through distributed shared memory in rank order and picks the
same digit. The argmax runs over ``scaled + noise`` with the mask: lowest
index among equal maxima, NaN as the maximum, a fully ``-inf`` row giving
0, as ``torch.argmax``; each block's (value, index) goes into rank 0's
shared memory, which combines them, so the id does not depend on C. The
divisions repeat torch's CUDA arithmetic for a tensor divided by a Python
scalar (a product with the scalar's f32 reciprocal), so the ids equal the
plain composition's on the card. Where the card can schedule no cluster
of any planned size, the wrapper raises.

``top_p`` keeps the plain composition (the nucleus needs a full sort), as
the JAX package keeps its sort twin: such calls are counted in
``fused_sample_tail.unfused`` and logged once per process.

For tensors on the CPU the wrapper runs :func:`fused_sample_tail_plain`;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import logging
from dataclasses import dataclass

import numpy as np
import torch

from cake_tpu_torch.ops import _build
from cake_tpu_torch.ops.launches import count
from cake_tpu_torch.ops.sampling import _filter, apply_repeat_penalty

log = logging.getLogger("cake_tpu_torch.fused_sample_tail")
_top_p_noted = False

# Geometry shared with csrc/fused_sample_tail.cu.
THREADS = 512  # a block's threads
WARPS = THREADS // 32
CLUSTERS = (16, 8)  # cluster sizes in order of preference, the first the card schedules
SMS = 132  # H100 SXM streaming multiprocessors
MIN_SLICE = 1024  # a block's fewest elements: a smaller vocabulary takes fewer blocks
SMEM_CAP = 227 * 1024 - 1024  # dynamic shared memory a block may take, its static part aside


@dataclass(frozen=True)
class Plan:
    """A cluster of ``cluster`` blocks a row, ``slice`` elements a block (a
    multiple of 4; block r owns ``[r * slice, (r + 1) * slice)`` of the
    vocabulary), the top-k slice staged in shared memory when ``staged``;
    ``smem`` dynamic shared bytes a block."""

    cluster: int
    slice: int
    staged: bool
    smem: int


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def smem_bytes(slice_: int, top_k: bool, staged: bool) -> int:
    """A block's dynamic shared memory (the kernel's ``tail_smem_bytes``):
    the slice's penalty bitmap; with top-k the warps' sub-histograms, two
    block histograms and the cluster's sum; when staged, the slice's logits
    and noise."""
    words = _round_up(-(-slice_ // 32), 4)
    hists = WARPS * 256 + 3 * 256 if top_k else 0
    staging = 2 * _round_up(slice_ + 4, 4) if staged else 0
    return 4 * (words + hists + staging)


def candidates(b: int, vocab: int, sampled: bool, top_k) -> list[Plan]:
    """The plans for each cluster size of CLUSTERS, from the shapes alone,
    in order of preference: 16 blocks a row first, but 8 for top-k rows
    that would fill more than half the SMs at 16 (measured faster from 8
    rows on: PERF.md), and a top-k plan whose slice is staged in shared
    memory before one that re-reads it (past ~208K ids only 16 blocks
    stage). A vocabulary under ``c * MIN_SLICE`` ids takes the largest
    power of two of blocks that gives each MIN_SLICE."""
    topk = sampled and top_k is not None
    most = 1 << (max(1, vocab // MIN_SLICE).bit_length() - 1)
    order = sorted(CLUSTERS) if topk and b * max(CLUSTERS) > SMS // 2 else CLUSTERS
    out: list[Plan] = []
    for c in order:
        c = min(c, most)
        if any(p.cluster == c for p in out):
            continue
        sl = _round_up(-(-vocab // c), 4)
        staged = topk and smem_bytes(sl, True, True) <= SMEM_CAP
        out.append(Plan(c, sl, staged, smem_bytes(sl, topk, staged)))
    return sorted(out, key=lambda p: topk and not p.staged)  # stable: staged plans first


def plan(b: int, vocab: int, sampled: bool, top_k, occupancy=None) -> Plan:
    """The first of :func:`candidates` that ``occupancy(plan)`` (the card's
    count of such clusters it can hold at once) finds schedulable, or the
    first with no query. Raises where the card can schedule none."""
    plans = candidates(b, vocab, sampled, top_k)
    if occupancy is None:
        return plans[0]
    for p in plans:
        if occupancy(p) > 0:
            return p
    sizes = ", ".join(f"{p.cluster} blocks of {THREADS} threads with {p.smem} bytes of shared "
                      f"memory each" for p in plans)
    raise RuntimeError(
        f"fused_sample_tail: the card can schedule no cluster of the sizes planned for a "
        f"vocabulary of {vocab} ({sizes}): cudaOccupancyMaxActiveClusters returned 0"
    )


def _max_active_clusters(p: Plan, penalize: bool, sampled: bool, top_k: int) -> int:
    """cudaOccupancyMaxActiveClusters for the kernel ``p`` launches."""
    n = _build.library().cake_fused_sample_tail_clusters(
        p.cluster, p.slice, int(p.staged), int(penalize), int(sampled), top_k)
    if n < 0:
        raise RuntimeError(f"fused_sample_tail: occupancy query failed (CUDA error {-n})")
    return n


_plans: dict = {}  # the wrapper's plan per (device, shape, kernel flags)


def scalar_reciprocal(x: float) -> float:
    """The f32 factor torch's CUDA kernels multiply by for ``t / x`` (a
    float tensor over a Python scalar): the reciprocal taken in double,
    rounded once to f32."""
    return float(np.float32(1.0 / float(x)))


def _composition(logits, ring, noise, temperature, top_k, top_p, repeat_penalty):
    pen = apply_repeat_penalty(logits, repeat_penalty, ring)
    if temperature is None or temperature <= 0.0:
        return torch.argmax(pen, dim=-1)
    return torch.argmax(_filter(pen, temperature, top_k, top_p) + noise, dim=-1)


def fused_sample_tail_plain(logits, ring, noise, *, temperature, top_k, top_p, repeat_penalty):
    """Plain PyTorch version: ``apply_repeat_penalty``, ``_filter`` and the
    argmax of ``scaled + noise`` (of the penalized logits when greedy)."""
    count(fused_sample_tail_plain)
    return _composition(logits, ring, noise, temperature, top_k, top_p, repeat_penalty)


fused_sample_tail_plain.launches = 0


def fused_sample_tail(logits, ring, noise, *, temperature, top_k, top_p, repeat_penalty):
    """Next ids [b] int64 from one decode step's logits.

    Args:
      logits: [b, V] f32.
      ring: [b, W] int64 recent ids, -1 = empty.
      noise: [b, V] f32 gumbel rows, or None when greedy (temperature <= 0).
      temperature/top_k/top_p/repeat_penalty: host scalars."""
    global _top_p_noted
    greedy = temperature is None or temperature <= 0.0
    if top_p is not None and not greedy:
        count(fused_sample_tail, "unfused")
        if not _top_p_noted:
            _top_p_noted = True
            log.warning(
                "fused_sample_tail: top_p needs a full sort; it keeps the plain composition "
                "(counted in fused_sample_tail.unfused)"
            )
        return _composition(logits, ring, noise, temperature, top_k, top_p, repeat_penalty)
    if logits.device.type == "cpu":
        return fused_sample_tail_plain(
            logits, ring, noise, temperature=temperature, top_k=top_k, top_p=top_p,
            repeat_penalty=repeat_penalty,
        )
    if logits.device.type != "cuda":
        raise ValueError(f"fused_sample_tail: unsupported device {logits.device}")
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError(f"fused_sample_tail: logits must be [b, V] f32, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    b, vocab = logits.shape
    if ring.dim() != 2 or ring.shape[0] != b or ring.dtype != torch.int64:
        raise ValueError(f"fused_sample_tail: ring must be [b, W] int64, got "
                         f"{tuple(ring.shape)} {ring.dtype}")
    if not greedy and (noise is None or noise.shape != logits.shape
                       or noise.dtype != torch.float32):
        raise ValueError("fused_sample_tail: a sampled step needs [b, V] f32 noise")
    k = 0 if greedy or top_k is None else int(top_k)
    if not greedy and top_k is not None and not 1 <= k <= vocab:
        raise ValueError(f"fused_sample_tail: top_k {top_k} outside [1, {vocab}]")
    tensors = [("logits", logits), ("ring", ring)] + ([] if greedy else [("noise", noise)])
    for name, t in tensors:
        if t.device != logits.device or not t.is_contiguous():
            raise ValueError(f"fused_sample_tail: {name} must be contiguous on {logits.device}")
    if b == 0:
        return torch.empty((0,), dtype=torch.int64, device=logits.device)
    penalize = repeat_penalty != 1.0 and ring.shape[1] > 0
    key = (logits.device.index, b, vocab, greedy, k > 0, penalize)
    if key not in _plans:
        with torch.cuda.device(logits.device):
            _plans[key] = plan(b, vocab, not greedy, k or None,
                               occupancy=lambda q: _max_active_clusters(q, penalize, not greedy, k))
    out = _run(logits, ring, None if greedy else noise, _plans[key], temperature=temperature,
               top_k=k, repeat_penalty=repeat_penalty)
    count(fused_sample_tail)
    return out


def _run(logits, ring, noise, p: Plan, *, temperature, top_k: int, repeat_penalty):
    """Launch the kernel with plan ``p`` on checked operands (``top_k`` 0:
    none; ``noise`` None: greedy); the ids [b]."""
    b, vocab = logits.shape
    greedy = noise is None
    window = ring.shape[1]
    out = torch.empty((b,), dtype=torch.int64, device=logits.device)
    err = _build.library().cake_fused_sample_tail(
        logits.data_ptr(), ring.data_ptr() if window else None,
        None if greedy else noise.data_ptr(), out.data_ptr(),
        b, vocab, window, int(repeat_penalty != 1.0 and window > 0),
        float(repeat_penalty), scalar_reciprocal(repeat_penalty),
        1.0 if greedy else scalar_reciprocal(temperature), top_k,
        p.cluster, p.slice, int(p.staged),
        ctypes.c_void_p(torch.cuda.current_stream(logits.device).cuda_stream),
    )
    _build.check(err, "fused_sample_tail")
    return out


fused_sample_tail.launches = 0
fused_sample_tail.unfused = 0
