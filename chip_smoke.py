#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cake_tpu_torch``) end to end on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line; the first failure ends the run with a
nonzero exit and no final result line:

  1. env       card name and power limit (nvidia-smi), torch/CUDA versions,
               TF32 switched off for every comparison below.
  2. build     nvcc builds the kernels from ops/csrc (seconds reported).
  3. kernels   each CUDA kernel against its plain PyTorch version in bf16 at
               Llama-3-8B attention shapes (n_q 32, n_kv 8, head_dim 128):
               max-abs error (tolerance TOL), kernel / plain /
               scaled_dot_product_attention ms, and the bound (the larger of
               bytes / 3.35 TB/s and FLOPs / 989 TFLOP/s). The paged kernels
               read a pool of 128-slot pages through shuffled block tables
               (one entry unmapped); their SDPA time is over a dense view
               gathered beforehand (the gather is not timed). The dense
               kernels' "main_path" cases have the generate phase's shapes.
               The decode fusions at Llama-3-8B widths: fused_norm_matmul at
               1 to MAX_ROWS rows into wqkv, w_gu and lm_head (swap AB on
               wgmma to 64, the warp-specialized wgmma body past it), and a
               Gemma (1 + w) case (max-abs <= TOL or one bf16 rounding step
               at the output's magnitude, whichever is larger, and cosine
               >= 0.9999), then its row independence ("bits", gated): at
               each site, each body's rows (plan() at 1, 8, 16, 64, 256
               rows) equal the same rows run alone through that body, to
               the bit;
               fused_qkv_ingest dense b=1 and b=8, paged b=8 over shuffled
               pages with an unmapped entry, and a slot past the table (q
               and every page but the sink bitwise); fused_sample_tail
               greedy b=1/8, sampled b=1/8 (temperature 0.7, top_k 40,
               repeat_penalty 1.1, ring 128) and a row all -inf beside a
               NaN row (ids equal); the ingest reads its slot from device
               memory: one launch captured in a CUDA graph and replayed at
               several slots equals its plain version at each (gated). Their library_ms is the unfused PyTorch
               composition, not one call; beside them an empty kernel's
               time, the launch floor (launch_floor_ms in the kernels
               line, beside their bytes bound). int4_matmul: first the bits
               probe (every projection's operands through mma.sync, wgmma
               at each product width, split blocks and the fold: equal to
               the bit, gated), then Llama-3-8B's five projections (wqkv,
               wo, w_gu, w_down, lm_head) at 1, 8, 256 and 3840 rows in
               bf16, one f16 and one f32 case (one rounding step of the
               dtype at the output's magnitude, cosine >= 0.9999; its
               library_ms is cuBLAS over the dequantized weight), and row
               independence: rows of 8-, 17-, 64-, 256- and 3840-row calls
               equal the 1-row call to the bit (wqkv, w_gu, w_down), and
               the decode bodies: mma.sync against wgmma at row tiles 8
               and 16, at 1 and 8 rows, timed in the same run. The
               redesigned kernels' rows name the instructions they ran on
               ("route": wgmma, mma.sync, CUDA cores), read from the
               kernel names a trace of the case's call records (a second
               call, after a warm-up call). The decode kernels' cases
               cover lengths to 8192 keys, starts, window and softcap.
               The f8 KV cases (``--kv-dtype f8``): the five functions that
               read or write the cache over float8_e4m3fn K/V, each beside
               its bf16 case and with its bytes bound (the K/V bytes
               halved): decode and chunk at the main path's operands and
               the dense engine's, the paged kernels at the paged engine's
               recorded wave-1 operands ("main_path_f8"), each within TOL of
               its plain version on the same f8 contents (library_ms: SDPA
               over the cache widened to bf16, PyTorch having no call that
               reads f8); "f8_bits" (gated): at the engine's operands each
               paged f8 kernel equals, to the bit, itself over the pool
               widened to bf16 and the dense f8 kernel over the pages
               gathered; fused_qkv_ingest dense b=1 and paged b=8 into f8,
               bitwise, with six k/v values past +-464 that must come back
               NaN.
               The noise kernel (threefry_noise, ops/csrc/threefry.cu: a
               sampled step's key split and gumbel plane, replacing no
               Pallas kernel) per row at b=8 and shared at b=1 over
               Llama-3's vocabulary: next and sub keys, bits and uniforms
               equal to its plain twin's to the bit, the gumbel plane within
               1e-6 (gated; whether bitwise is recorded); library_ms is
               torch.rand and two logs at the same shape (another stream).
               Then jax's constants (gated): threefry2x32's known answers,
               the kernel's split of PRNGKey(299792458) and the ids of
               categorical over zeros((2, 128256)) at that key.
  4. generate  Llama-3-8B at full width and depth, random bf16 weights drawn
               on the card from a seeded torch.Generator: a ~700 byte-token
               prompt prefilled in 256-token chunks (the position-0 and the
               continuation kernels), then 64 greedy tokens; the kernels'
               launch counters must equal n_layers x calls and the plain
               versions must not run.
  5. api       the port's ApiServer over that generator answers a JSON chat,
               an SSE chat with usage, and a seeded sampled chat.
  6. engine    the batch serving engine over the generate phase's weights,
               at the CLI's default admission window: paged KV (page 128,
               max_seq 2048), prefix cache on, 8 lanes. Two waves of 8
               concurrent greedy requests, each a shared system prompt
               longer than two pages plus its own user turn of one common
               length, 64 tokens out, then a ragged wave of 12 requests
               whose turns differ in length (several page-alignment classes,
               more requests than lanes: joins must happen): TTFT, decode
               tok/s, ms per decode step, prefix hits in wave 2 (must be
               > 0) and wave 2's streams equal wave 1's (the warm suffix
               prefill against the cold one, 8/8); the paged kernels' launch counters must equal n_layers
               x their dispatches (epoch starts and joins) and every other
               counter must stay 0. Then wave 1 and the ragged wave through
               the dense engine, with the same launch gate on the dense
               kernels (how many streams equal the paged ones is reported,
               not gated: cuBLAS may pick other GEMM kernels for other row
               counts), a profiled wave for the device idle share and the
               device time by kernel family, and the full-width paged and
               dense lockstep forwards through the kernels against the plain
               versions. The operands the engine hands each kernel (its
               first prefill, a mid-wave decode step) are recorded, and
               each kernel is then timed and checked at exactly those
               shapes: the paged kernels' "main_path", the dense kernels'
               "dense_engine" cases; at the decode operands the split
               design's bits are gated ("split_bits"): the paged kernel
               equals the dense one over the same keys (max_seq 2048 and
               8192), each row called alone, and a second call.
  7. api_engine the ApiServer with that engine answers 4 concurrent SSE chats.
  8. generate_fused  the generator with ``fusion_impl="all"`` and
               ``decode_chunk_size=8`` over the generate phase's weights, the
               same prompt, 64 greedy tokens: fused_norm_matmul and
               fused_sample_tail launches must equal the counts derived from
               the forwards and chunked steps that ran, every plain version
               0; ms/token and device ops/token beside the generate phase's;
               full-width logits with "norm" against the plain path (cosine
               >= 0.999).
  9. engine_fused  the paged engine (prefix cache on) serves wave 1 and a
               seeded sampled wave of 8 (top_k 40, repeat_penalty 1.1) three
               ways: fusion "none", "ingest,tail" and "all", one engine at a
               time; "ingest,tail" streams must equal "none"'s 8/8, greedy
               and sampled; fused_qkv_ingest = n_layers x decode steps,
               fused_sample_tail = decode steps, fused_norm_matmul = the
               derived count, threefry_noise = the sampled wave's prefill
               dispatches (first samples) + its decode steps, the attention
               gates as before, every plain version 0. Then one wave
               through the dense engine with "all",
               and the full-width paged and dense forwards with "all"
               against the plain path (cosine >= 0.999). TTFT, ms per decode
               step, device ops and ms per step (by kernel family) and the device
               idle share of each.
  9a. engine_continuous  the continuous scheduler on the paged engine
               (prefix cache on, fusion none, one engine at a time): after a
               warm-up wave, wave 1 submitted as one group (the engine's
               lock held) to an epoch and a continuous engine (the same
               admission: equal streams 8/8, gated; TTFT and ms a step side
               by side); the ragged
               wave of 12 under both schedulers after a warm-up wave of its
               shapes (TTFT p50 and max, ms a decode step, joins, the step
               budget's deferrals; agreement reported); wave 1's prompts
               with 384 tokens out, greedy and the sampled wave of
               engine_fused, on the smallest pool that admits all 8 in one
               epoch (the sum of their admission charges) and on the default
               pool. Gated: >= 2 preemptions and restores on the small pool
               and none on the full one, no truncation, the same finish
               reasons and token counts on both pools, no spill left and
               every page not cached free; every restore (into a running
               segment or as a new segment's seed) held to its spill: the
               token, key, ring row, ring index and pad it decodes from
               equal the spill's host copies, its K/V over history[:-1]
               within TOL of the K/V it held in each layer's relative L2
               norm, by position (max-abs reported); then the sampled wave with half the
               lanes at 192 tokens and a step grant of 2048, whose spills
               come back into the running segment (>= 1, gated); the paged
               kernels' launches = n_layers x prefill dispatches and decode
               steps, the noise kernel's = the sampled wave's first samples
               + decode steps (restores sample nothing); a second sampled
               run on the small pool (submitted as one group, the prefix
               cache cleared) captures no new graph. Agreement
               between pools reported, with each stream's first difference.
  9a'. engine_admission  admission on the paged engine (prefix cache on,
               one engine at a time, 32 tokens out): wave 1 cold across 4
               tenants with every gate armed (quotas, shed gates, a default
               deadline, the stall watchdog, SLO objectives) and the same
               requests in the order the fair queue admitted them with every
               gate off: equal streams 8/8, ms a decode step, TTFT and ms a
               decode dispatch side by side, the guard's cost a dispatch;
               a flood of 24 from tenant A then 2 from B: B's admitted in the
               first two rounds with the fair queue and after all of A's
               without; a stream cap and a token bucket refusing (429), a
               finished stream freeing its slot; the depth gate shedding low
               priority at half the depth with the quota refunded, the page
               gate not shedding over cold prefix-cache pages; a queued
               request expiring unmapped, a running one at a chunk boundary,
               spilled lanes past their deadline never restored (continuous
               scheduler, the pool of one epoch's charges); a 429, a 503 and
               a cancel over the API; a host-side stall in one decode
               dispatch ending its epoch's streams "error" within the 2 s
               bound, the stalled thread then writing NaN into every buffer
               it held while the next wave runs, whose streams equal the
               gates-off engine's bitwise; every page not cached free after
               each wave; the paged kernels' launches = n_layers x the
               dispatches. All gated.
  9a''. obs    observability on the paged engine (continuous scheduler,
               prefix cache, the pool of one epoch's charges) behind the
               port's API with every recorder armed (request log, trace and
               events JSONL, timeline, efficiency ledger and decision audit,
               black box): a cold wave of 8 and wave 1's prompts with 384
               tokens out (spills and restores), the same on an engine with
               every recorder off: equal streams 8/8 each; /metrics parsed,
               its counters equal to the engine's stats; /efficiency's
               buckets >= 95% of its wall, MBU and MFU in (0, 1]; every
               request's /explain adding up to its wall and its request-log
               line, a restore phase in the pressured wave; /trace valid
               Chrome JSON with segment and step spans; /events, /requests,
               /timeseries answering; ms a decode step and TTFT armed
               against off. All gated but the cost.
  9b. generate_f8  the generate phase's weights over an f8 KV cache: the
               same prompt, 64 greedy tokens per token and in 8-token
               graph-replayed chunks (equal streams), every decode and
               continuation launch over f8 (the wrappers' ``f8`` side
               counts, gated), graph against eager to the bit (greedy and
               sampled), full-width logits through the f8 kernels against
               the plain versions; wall and device ms a token, the KV bytes
               beside bf16's, greedy agreement with the bf16 stream.
  9c. engine_f8  the batch engine over an f8 cache, one engine at a time:
               paged (prefix cache on: wave 1 cold, then warm) and dense
               (wave 1), each with fusion "none" and "all": launches over
               f8 gated; paged = dense 8/8 and warm = cold 8/8 under each
               fusion, gated; the four full-width forwards through the f8
               kernels against the plain versions; the f8 pool half the
               bf16 pool's bytes (gated); ms a step, device ms by family,
               TTFT.
 10. generate_int4  the generate phase's weights quantized on the card
               to int4 (``quantize_params``, one layer at a time), the same
               prompt and 64 greedy tokens per token and with 8-token
               chunks: equal streams; int4_matmul launches = (4 x n_layers +
               1) x forwards, every plain version 0; full-width logits against
               the plain path (int4_matmul_plain, cosine >= 0.999); prefill,
               ms/token, device ops and ms per token.
 11. engine_int4  wave 1 over the int4 weights through the paged engine,
               the dense engine, then the paged engine with fusion "all":
               paged streams equal dense 8/8; int4_matmul and
               fused_norm_matmul.quantized launches derived from the
               dispatches (the norm sites run rms_norm + the int4 product),
               fused_norm_matmul's own kernel 0; TTFT, ms per decode step,
               device idle share; int4_matmul timed at the engine's
               prefill rows into w_gu.
 12. decode_graph  the decode chunk as one CUDA graph (DecodeChunk,
               models/llama/fused.py) against its eager plain version in
               the same run. Bits, gated: the generator (bf16 "none" and
               "all", int4; greedy and seeded sampled) over 3 chunks of 8
               from one graph, against sampled_decode_loop with a host-int
               slot on a clone of the cache and of the dialog's threefry key
               (ids, the whole cache, the advanced key), and the same dialog
               decoded per step (equal ids); the engine,
               every decode dispatch against batch.decode_chunk /
               paged_decode_chunk on clones (paged "none", "all", int4
               "none", dense "all"; greedy, sampled, the ragged wave's joins,
               chunks after a block-table change, and a 32-token wave whose
               epoch capacity ends on a 7-step chunk, the capacity edge's
               own graph). Timings: the generator's ms/token (8-token
               chunks) and the paged engine's ms a decode step, graph and
               eager (the chunk's loop run op by op over the same buffers),
               with device ms, ops and idle share; gated: device ops a token
               and a step equal to eager's, the generator's ms/token under
               eager's, the same streams. The captures' count, warm-up and
               capture seconds and the graph pool's growth.
 13. generate_int8  the same weights in int8, 16 greedy tokens: ms/token
               and device ms (no kernel of its own: each product converts
               the weight, multiplies and scales, three ops).
 14. shapes    the attention kernels at Phi-3-mini's head dim 96 (the
               generator's and the engine's operands, bf16 and f8), the
               decode kernels at Qwen3-235B-A22B's group of 16 and at groups
               12 and 32, the ingest at head dim 96 (bitwise): each within
               TOL of its plain version, timed beside its bound and SDPA.
     moe       Mixtral-8x7B's widths at 8 layers (random bf16 weights): the
               generator per step and in 8-token graph chunks (equal ids;
               the prefill's rows an expert), logits against the plain path
               (MoE routing teacher-forced, the flips counted), the paged
               engine's cold wave equal to the dense engine's 8/8, the warm
               prefix waves (the same wave again over the cached chains)
               equal to the cold ones 8/8 (none and all), a ``--fusion all``
               wave, ``--quantize int4`` (expert stacks int8; int4_matmul
               launches as the attention products and the head imply); the
               grouped expert GEMM's launches, three a grouped dispatch.
               Then the grouped GEMM's kernel cases (grouped_matmul,
               csrc/moe_grouped.cu) at that engine prefill's rows an
               expert: Mixtral's gate and down products, bf16 and int8
               stacks, within one bf16 step of the cuBLAS loop it replaced,
               and rows bitwise under other group sizes (gated).
     phi3      Phi-3-mini-4k at full size: a 4-layer checkpoint of fused
               qkv_proj / gate_up_proj read back bitwise, the generator
               over a 2300-token prompt (the 2047-key window masks), per
               step and in graph chunks (equal ids), logits against the
               plain path, the paged engine under none, ingest,tail (equal
               8/8) and all, and the dense engine.
     phi3 (rolling)  then the rolling window cache at head dim 96: a prompt
               300 tokens longer over a ring of window + chunk slots (2304)
               against the full cache, per step and in graph chunks: equal
               ids (gated).
     ring      the ring instantiations of the two dense attention kernels
               (``ring_limit``, csrc/ring_*.cu, RingLayout) at the rolling
               paths' operands: Mistral-7B's decode (about 6000 logical
               positions through 4608 slots, window 4096) and a 512-query
               continuation chunk whose keys straddle the wrap, bf16 and
               f8; Phi-3-mini's at head dim 96. Each within TOL of its plain
               version and bitwise the dense kernel over the same keys in
               the full cache (gated), timed beside its bytes bound and SDPA
               over the gathered window.
     rolling   Mistral-7B-v0.1 at full width and depth (random bf16 weights,
               seed 18, ~14.5 GB, freed after) over the rolling window cache
               (4608 slots) and over the full cache (8192): a ~6000-token
               prompt in 512-token chunks, then 64 greedy tokens per step
               and in 8-token graph chunks: equal ids 64/64, the first
               decode step's logits (per step) and one step's after the
               chunks bitwise, the launches gated; KV bytes, prefill
               seconds, wall and device ms a token of each; an f8 pass (16
               tokens, the same gates).
  Failover (runtime/faults.py plans): phase engine adds ``failover_local``
               on the paged local engine, crash@backend.decode at the fourth
               chunk of wave 1: the migration replays the epoch, streams
               equal the fault-free wave 8/8, one failover, 8 recovered, the
               pool whole (gated); a late fault (chunk 36 of a 320-token
               wave) under a 2 s budget the replay's price overruns:
               re-prefilled under that price and within the budget (gated),
               streams recorded; the
               prefix-cache engine's re-prefill at the fourth chunk: one
               failover, 8 recovered, the pool whole (gated). Phase
               distributed adds topology B with heartbeats on and w2 killed
               for good from mid-decode of wave 1 (kill@client.send:node=w2:
               after=30:count=0): the streams migrate to w2b and equal the
               local dense engine's wave 1 8/8, one failover, 8 recovered,
               cake_failover_total{w2} 1; and topology A with w1 killed: the
               streams end "error", every lane back, the next wave served
               (gated).
 15. cli       ``python -m cake_tpu_torch.cli`` on a small checkpoint written
               by the port's save_tiny_checkpoint: one prompt, the same with
               ``--fusion all --decode-chunk 4``, with ``--quantize int4``,
               a ``.q4`` checkpoint (save_tiny_checkpoint over an int4 tree)
               with no flag, ``--kv-dtype f8``, a tiny Mixtral with
               ``--fusion all --decode-chunk 4``, then a ``--api-batch 4
               --kv-mode paged`` server that answers a chat, and the same
               with ``--kv-dtype f8``.
 16.           ``{"kernels": [...]}``: one entry per kernel with its launches
               on the main path (the fused and int4 phases for their
               kernels) and its timings at the main path's shapes; the
               redesigned kernels also carry "redesigned" (the PR) and the
               instructions their cases ran on; int4_matmul's the
               wgmma-bits answer; then the f8 instantiations of the five
               kernels that read or write the cache ("<name>_f8", launches
               over f8 in the f8 phases), then threefry_noise (launches in
               engine_fused's sampled waves; "counterpart" says that the
               JAX package has no Pallas kernel for it). The attention
               kernels and the ingest carry "shapes": their cases of phase
               14, each with the launches the model phase of its shape made
               (phi3; None for the shapes no phase serves). The ring
               instantiations ("<name>_ring", "<name>_ring_f8": launches in
               phase rolling and phi3's rolling pass, "dense_bitwise").
 17.           ``{"ok": true, "device": {...}}`` as the last line.

On the card every decode chunk (the generator's ``decode_chunk`` and both
engines' decode) replays a captured CUDA graph. A wrapper's launch counter
counts its kernel's eager launches and, at every replay, the launches the
capture recorded (ops/launches.py); the warm-up run a graph makes before
its capture is not counted. So every launch gate below holds for replayed
chunks as it held for eager ones.

Exits nonzero without a result when no CUDA device is present or when run
outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

STARTED = time.perf_counter()
TOL = 2e-2  # bf16 outputs of f32-accumulated attention, max-abs vs the plain version
# The ring cases' outputs average thousands of keys (RMS ~0.026 at a
# 4096-key window), so TOL is about a typical value: they are held to two
# bf16 steps at their largest outputs (< 0.5) and to a relative L2 error
# that a dropped or misplaced 128-key split (~18% of the output) exceeds.
RING_TOL = 4e-3
RING_REL_TOL = 1e-2
# An f8 case's library_ms: PyTorch has no call that reads an f8 cache.
F8_LIBRARY = "scaled_dot_product_attention over the same cache widened to bf16"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM f32 peak outside the tensor cores (32-bit ops)
N_Q, N_KV, HD = 32, 8, 128  # Llama-3-8B attention shapes
HIDDEN, INTER, VOCAB = 4096, 14336, 128256  # Llama-3-8B widths
# jax.random's values the noise kernel must give (tests/test_torch_threefry.py
# holds them to jax): threefry2x32-20 (key, counter) -> pair, and at
# PRNGKey(THREEFRY_SEED) jax.random.split and jax.random.categorical over
# zeros((2, VOCAB)).
THREEFRY_KAT = (
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
)
THREEFRY_SEED = 299792458
SPLIT_OF_SEED = ((2133886344, 1704773556), (3188621163, 1269772507))
CATEGORICAL_OF_SEED = (102805, 31574)
FUSED_CHUNK = 8  # the generator's decode chunk in phase generate_fused
MAX_SEQ = 8192
PROMPT_TOKENS = 700
PREFILL_CHUNK = 256
DECODE_TOKENS = 64
# The engine phase: Llama-3-8B served by the paged batch engine.
ENGINE_MAX_SEQ = 2048
ENGINE_PAGE = 128
ENGINE_BATCH = 8
ENGINE_TOKENS = 64
SYSTEM_PROMPT = (
    "You are the assistant of a small bakery. Answer questions about cakes, breads and "
    "pastries in a friendly, concise way. Give quantities in grams and temperatures in "
    "degrees Celsius, name the tools a home baker needs, and say when a step can be done "
    "a day ahead. If a question is not about baking, say so politely and steer back."
)
# Equal lengths: every prompt gets the same left pad, so all eight share one
# page-alignment class of the prefix cache (a chain is reusable only at the
# pad it was written at, modulo the page size).
USER_TURNS = [
    f"Question {i}: how do I make a {what:<15} that stays moist for two days, and what "
    f"is the most common mistake?"
    for i, what in enumerate(
        ["sponge cake", "carrot cake", "lemon drizzle", "banana bread", "brioche loaf",
         "chocolate torte", "apple strudel", "cheesecake"]
    )
]
# Ragged lengths, so the prompts fall in several alignment classes, and more
# requests than lanes: cache-aware admission opens an epoch for the head's
# class and the rest join it as lanes free.
RAGGED_TURNS = [
    f"Question {i}: how do I make a {what} that stays moist for two days, and what is "
    f"the most common mistake?"
    for i, what in enumerate(
        ["sponge cake", "carrot cake", "lemon drizzle", "banana bread", "brioche loaf",
         "chocolate torte", "apple strudel", "cheesecake", "scone", "croissant", "pavlova",
         "focaccia"]
    )
]


def emit(obj) -> None:
    """Print one result line; a phase's line carries the seconds into the
    run at which it was printed (``t_s``), so the phases' walls can be read
    off any run."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - STARTED, 3)}
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS_PER_S) -> tuple[float, str]:
    """(least ms, "bytes" or "operations"): bytes over the memory rate, or
    operations over ``peak`` (the tensor cores' bf16 rate unless given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _spin_cycles_per_ms(torch) -> float:
    """Clock cycles ``torch.cuda._sleep`` spins per millisecond on this card."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


# Calls timed behind one spin kernel. The host blocks once the device's
# launch queue is full (about a thousand launches), so a longer run behind
# one spin ran at the host's launch rate, not the device's.
SPIN_BATCH = 100


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.

    A spin kernel queued ahead of each batch of at most SPIN_BATCH timed
    calls holds the device while the host enqueues them, so the events time
    the device's work and not the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    cycles_per_ms = _spin_cycles_per_ms(torch)
    total = 0.0
    for done in range(0, iters, SPIN_BATCH):
        n = min(SPIN_BATCH, iters - done)
        spin_ms = min(1.5 * n * call_ms + 1.0, 3000.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * cycles_per_ms))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# Timing a bytes-bound kernel on one small operand set measures the 50 MB
# L2, not device memory: the main-path cases of the decode kernels rotate
# over copies of their operands worth at least this many bytes in all, as a
# model's walk over its layers does.
COLD_BYTES = 200e6


def copies_for(live_bytes: float) -> int:
    """How many operand copies a cold-cache timing rotates over."""
    return max(1, min(64, -(-int(COLD_BYTES) // max(1, int(live_bytes)))))


def rotating(fns):
    """One callable running ``fns`` in turn, a different copy each call."""
    state = {"i": 0}

    def call():
        fn = fns[state["i"] % len(fns)]
        state["i"] += 1
        return fn()

    return call


# ---------------------------------------------------------------- phase 1-2


def phase_env(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {
        "phase": "env",
        "nvidia_smi": smi,
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    }
    emit(info)
    return info


def phase_build() -> None:
    from cake_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build(force=True)
    _build.library()
    emit({
        "phase": "build",
        "seconds": round(time.perf_counter() - t0, 3),
        "library": os.path.relpath(path),
        "sources": [os.path.relpath(p) for p in _build.sources()],
    })


# ---------------------------------------------------------------- phase 3


def _sdpa(torch, q, k, v, mask=None, scale=None, causal=False):
    """scaled_dot_product_attention on [b, h, s, d] operands (the yardstick;
    the port never calls it)."""
    F = torch.nn.functional
    major_minor = tuple(int(x) for x in torch.__version__.split(".")[:2])
    if major_minor >= (2, 5):
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale, is_causal=causal, enable_gqa=True
        )
    g = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale, is_causal=causal)


COS_TOL = 0.9999  # fused_norm_matmul's cosine to its plain version


def bf16_ulp(ref) -> float:
    """One bf16 rounding step at the largest magnitude of ``ref``: a product
    summed in another order than cuBLAS's may round its last bit the other
    way, and fused_norm_matmul's outputs reach ~6, where that step (1/32)
    exceeds TOL."""
    import math

    top = ref.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def _check(torch, name, case, out, ref, ms, plain_ms, nbytes, flops, library_ms, copies=1,
           exact=False, cosine=False, tol=TOL, route=None, extra=None, peak=BF16_FLOPS_PER_S,
           rel_tol=None):
    """Emit a kernel case's row and hold ``out`` to ``ref``: within ``tol``
    max-abs (and, with ``cosine``, at cosine >= COS_TOL; with ``rel_tol``,
    a relative L2 error ||out - ref|| / ||ref|| within it), or with
    ``exact`` equal to the bit (fused_qkv_ingest's outputs,
    fused_sample_tail's ids, whose rows may hold NaN and -inf by design).
    ``route``: the instructions the case ran on (the redesigned kernels:
    wgmma, mma.sync, CUDA cores)."""
    err = (out.float() - ref.float()).abs().max().item() if out.numel() else 0.0
    finite = exact or bool(torch.isfinite(out.float()).all().item())
    b_ms, b_by = bound(nbytes, flops, peak)
    row = {
        "phase": "kernels", "kernel": name, "case": case,
        "max_abs_err": err, "tol": 0.0 if exact else tol, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        "bytes": nbytes, "flops": flops, "operand_copies": copies,
    }
    if route is not None:
        row["route"] = route
    row.update(extra or {})
    if cosine:
        row["cosine"] = torch.nn.functional.cosine_similarity(
            out.float().flatten(), ref.float().flatten(), dim=0).item()
    if rel_tol is not None:
        row["rel_l2_err"] = ((out.float() - ref.float()).norm()
                             / ref.float().norm().clamp(min=1e-30)).item()
        row["rel_tol"] = rel_tol
    if exact:
        row["equal"] = out.shape == ref.shape and bool(torch.equal(out, ref))
        row["max_abs_err"] = 0.0 if row["equal"] else float("inf")
    emit(row)
    if exact and not row["equal"]:
        raise AssertionError(f"{name}/{case}: not equal to its plain version")
    if not exact and (not finite or not err <= tol):
        raise AssertionError(f"{name}/{case}: max-abs error {err} (finite={finite}) > {tol}")
    if cosine and not row["cosine"] >= COS_TOL:
        raise AssertionError(f"{name}/{case}: cosine {row['cosine']} < {COS_TOL}")
    if rel_tol is not None and not row["rel_l2_err"] <= rel_tol:
        raise AssertionError(f"{name}/{case}: relative L2 error {row['rel_l2_err']} > {rel_tol}")
    return row


def _kv_case(torch, kv) -> tuple:
    """(cache dtype, its element size, the row fields of an f8 case): bf16,
    or ``kv`` (f8, whose library yardstick reads the cache widened to bf16)."""
    if kv is None:
        return torch.bfloat16, 2, {}
    return kv, 1, {"kv_dtype": "f8", "library": F8_LIBRARY}


def _decode_case(torch, dev, g, case, lens, starts, kw, max_seq=MAX_SEQ, cold=False, kv=None,
                 heads=None):
    """One decode_attention case over a [b, n_kv, max_seq, hd] cache (bf16,
    or ``kv``: f8); a cold case rotates over copies of its cache, one per
    call."""
    from cake_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain, fold_window,
    )

    n_q, n_kv, hd = heads or (N_Q, N_KV, HD)
    bf = torch.bfloat16
    kv_dt, esize, extra = _kv_case(torch, kv)
    b, kw = len(lens), dict(kw)
    live0 = sum(max(0, ln - s0) for ln, s0 in zip(lens, starts or [0] * b))
    n_copy = copies_for(live0 * n_kv * hd * 2 * esize) if cold else 1
    q = torch.randn(b, 1, n_q, hd, generator=g, device=dev, dtype=bf)
    k = torch.randn(b * n_copy, n_kv, max_seq, hd, generator=g, device=dev, dtype=bf).to(kv_dt)
    v = torch.randn(b * n_copy, n_kv, max_seq, hd, generator=g, device=dev, dtype=bf).to(kv_dt)
    kvs = [(k[c * b : (c + 1) * b], v[c * b : (c + 1) * b]) for c in range(n_copy)]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
    window_flag = kw.pop("window_flag", None)
    runs = [lambda kc=kc, vc=vc: decode_attention(q, kc, vc, lengths, st, window_flag, **kw)
            for kc, vc in kvs]
    plains = [lambda kc=kc, vc=vc: decode_attention_plain(
        q, kc, vc, lengths, st, window_flag, **kw) for kc, vc in kvs]
    out, ref = runs[0](), plains[0]()
    torch.cuda.synchronize()
    st0 = torch.zeros_like(lengths) if st is None else st
    eff = fold_window(st0, lengths, kw.get("window"), window_flag)
    live = int((lengths - eff).clamp(min=0).sum().item())
    nbytes = 2 * q.numel() * 2 + live * n_kv * hd * 2 * esize
    flops = 4.0 * live * n_q * hd
    library_ms = None
    if "softcap" not in kw:
        kpos = torch.arange(max_seq, device=dev)
        mask = ((kpos[None] >= eff[:, None]) & (kpos[None] < lengths[:, None]))[:, None, None, :]
        qh = q.transpose(1, 2)
        wide = [(kc.to(bf), vc.to(bf)) for kc, vc in kvs]  # no PyTorch call reads f8
        libs = [lambda kc=kc, vc=vc: _sdpa(torch, qh, kc, vc, mask, kw.get("scale"))
                for kc, vc in wide]
        library_ms = cuda_ms(torch, rotating(libs), 10 * n_copy)
        del wide, libs
    return _check(
        torch, "decode_attention", case, out, ref,
        cuda_ms(torch, rotating(runs), 50 * n_copy), cuda_ms(torch, rotating(plains), 5),
        nbytes, flops, library_ms, copies=n_copy, route=traced_route(torch, runs[0]),
        extra=extra,
    )


def decode_cases(torch, dev):
    g = torch.Generator(device=dev).manual_seed(1)
    cases = [
        ("lengths", [1, 300, 4097, 8192], None, {}),
        ("starts", [300, 4097, 8192, 8192], [0, 100, 4000, 8191], {}),
        ("window", [1, 300, 4097, 8192], None,
         {"window": 1024, "window_flag": torch.tensor(True, device=dev)}),
        ("softcap", [1, 300, 4097, 8192], None, {"softcap": 50.0, "scale": 0.1}),
    ]
    rows = [_decode_case(torch, dev, g, *c) for c in cases]
    # The generate phase's decode reads its cache cold; generate_f8's the same, f8.
    rows.append(_decode_case(torch, dev, g, "main_path", [733], None, {}, cold=True))
    rows.append(_decode_case(torch, dev, g, "main_path_f8", [733], None, {}, cold=True,
                             kv=torch.float8_e4m3fn))
    return rows


def _chunk_case(torch, dev, g, case, chunk, q_starts, k_starts, kw, max_seq=MAX_SEQ,
                lens=None, kv=None, heads=None):
    """One chunk_prefill_attention case over a [b, n_kv, max_seq, hd] cache
    (bf16, or ``kv``: f8); ``lens`` defaults to each row's chunk end."""
    from cake_tpu_torch.ops.chunk_prefill import (
        chunk_prefill_attention, chunk_prefill_attention_plain,
    )

    n_q, n_kv, hd = heads or (N_Q, N_KV, HD)
    bf = torch.bfloat16
    kv_dt, esize, extra = _kv_case(torch, kv)
    b, kw = len(q_starts), dict(kw)
    q = torch.randn(b, chunk, n_q, hd, generator=g, device=dev, dtype=bf)
    k = torch.randn(b, n_kv, max_seq, hd, generator=g, device=dev, dtype=bf).to(kv_dt)
    v = torch.randn(b, n_kv, max_seq, hd, generator=g, device=dev, dtype=bf).to(kv_dt)
    qs = torch.tensor(q_starts, dtype=torch.int32, device=dev)
    lengths = qs + chunk if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
    ks = None if k_starts is None else torch.tensor(k_starts, dtype=torch.int32, device=dev)
    window_flag = kw.pop("window_flag", None)
    run = lambda: chunk_prefill_attention(q, k, v, qs, lengths, window_flag, ks, **kw)  # noqa: E731
    plain = lambda: chunk_prefill_attention_plain(q, k, v, qs, lengths, window_flag, ks, **kw)  # noqa: E731
    out, ref = run(), plain()
    torch.cuda.synchronize()
    # The pairs (query, key) this run's masks admit, and the key rows read.
    qpos = qs[:, None] + torch.arange(chunk, device=dev)[None]
    kpos = torch.arange(max_seq, device=dev)[None, None]
    k0 = torch.zeros_like(qs) if ks is None else ks
    mask = (kpos <= qpos[:, :, None]) & (kpos >= k0[:, None, None]) & (kpos < lengths[:, None, None])
    if kw.get("window") is not None:
        mask &= kpos > qpos[:, :, None] - kw["window"]
    pairs = int(mask.sum().item())
    keys = int(mask.any(dim=1).sum().item())
    nbytes = 2 * q.numel() * 2 + keys * n_kv * hd * 2 * esize
    flops = 4.0 * pairs * n_q * hd
    qh, kw_, vw = q.transpose(1, 2), k.to(bf), v.to(bf)  # no PyTorch call reads f8
    library_ms = cuda_ms(torch, lambda: _sdpa(torch, qh, kw_, vw, mask[:, None], kw.get("scale")),
                         5)
    del kw_, vw
    return _check(
        torch, "chunk_prefill_attention", case, out, ref,
        cuda_ms(torch, run, 20), cuda_ms(torch, plain, 3), nbytes, flops, library_ms,
        route=traced_route(torch, run), extra=extra,
    )


def chunk_cases(torch, dev):
    g = torch.Generator(device=dev).manual_seed(2)
    cases = [
        ("q_starts", 512, [0, 1024], None, {}),
        ("k_starts", 512, [0, 1024], [0, 300], {}),
        ("window", 512, [0, 1024], None,
         {"window": 256, "window_flag": torch.tensor(True, device=dev)}),
        ("main_path", PREFILL_CHUNK, [2 * PREFILL_CHUNK], None, {}),
    ]
    rows = [_chunk_case(torch, dev, g, *c) for c in cases]
    rows.append(_chunk_case(torch, dev, g, "main_path_f8", PREFILL_CHUNK, [2 * PREFILL_CHUNK],
                            None, {}, kv=torch.float8_e4m3fn))
    return rows


def flash_cases(torch, dev):
    from cake_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for case, q_len in (("q_len_2048", 2048), ("q_len_1000", 1000), ("main_path", PREFILL_CHUNK)):
        # q and k as rope leaves them (contiguous), v a strided view of the
        # fused projection output, as the model hands them over.
        qkv = torch.randn(1, q_len, (N_Q + 2 * N_KV) * HD, generator=g, device=dev,
                          dtype=torch.bfloat16)
        q = qkv[..., : N_Q * HD].reshape(1, q_len, N_Q, HD).contiguous()
        k = qkv[..., N_Q * HD: (N_Q + N_KV) * HD].reshape(1, q_len, N_KV, HD).contiguous()
        v = qkv[..., (N_Q + N_KV) * HD:].reshape(1, q_len, N_KV, HD)
        run = lambda: flash_attention(q, k, v)  # noqa: E731
        plain = lambda: flash_attention_plain(q, k, v)  # noqa: E731
        out, ref = run(), plain()
        torch.cuda.synchronize()
        pairs = q_len * (q_len + 1) // 2
        nbytes = 2 * q.numel() * 2 + q_len * N_KV * HD * 2 * 2
        flops = 4.0 * pairs * N_Q * HD
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        library_ms = cuda_ms(torch, lambda: _sdpa(torch, qh, kh, vh, causal=True), 10)
        rows.append(_check(
            torch, "flash_attention", case, out, ref,
            cuda_ms(torch, run, 20), cuda_ms(torch, plain, 3), nbytes, flops, library_ms,
            route=traced_route(torch, run),
        ))
    return rows


def engine_messages(turns=USER_TURNS, system=SYSTEM_PROMPT):
    from cake_tpu_torch.models.llama.chat import Message

    return [[Message.system(system), Message.user(u)] for u in turns]


def warm_messages():
    """Wave 1's shapes with other bytes: the system prompt reversed (as long
    in byte tokens, no prefix in common). A wave of them captures the decode
    chunks' graphs wave 1's epoch replays, and serves no prefix of it."""
    return engine_messages(system=SYSTEM_PROMPT[::-1])


def _paged_pool(torch, dev, g, seed, n_rows, n_p, kv=None, heads=None):
    """A bf16 (or ``kv``: f8) pool of n_rows * n_p pages (+ the write sink)
    and block tables [n_rows, n_p] naming them in a shuffled order."""
    _, n_kv, hd = heads or (N_Q, N_KV, HD)
    n_pages = n_rows * n_p
    shape = (n_pages + 1, n_kv, ENGINE_PAGE, hd)
    kv_dt = kv or torch.bfloat16
    k = torch.randn(*shape, generator=g, device=dev, dtype=torch.bfloat16).to(kv_dt)
    v = torch.randn(*shape, generator=g, device=dev, dtype=torch.bfloat16).to(kv_dt)
    perm = torch.randperm(n_pages, generator=torch.Generator().manual_seed(seed))
    return k, v, perm.view(n_rows, n_p).to(torch.int32).to(dev)


def _table_bytes(starts, lengths) -> int:
    """Bytes of the block-table entries a walk of [start, length) reads."""
    return 4 * sum(max(0, -(-ln // ENGINE_PAGE) - st // ENGINE_PAGE) for st, ln in zip(starts, lengths))


def _paged_decode_case(torch, dev, g, seed, case, lens, starts, npp, cold=False,
                       unmapped=None, kv=None, heads=None):
    """One paged_decode_attention case over tables of ``npp`` pages a row
    (a bf16 pool, or ``kv``: f8). A cold case's pool holds disjoint page
    sets, one block table each, and each call reads the next set.
    ``unmapped`` (row, column) marks one table entry -1."""
    from cake_tpu_torch.models.llama.paged_cache import gather_pages
    from cake_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain,
    )

    n_q, n_kv, hd = heads or (N_Q, N_KV, HD)
    b = len(lens)
    kv_dt, esize, extra = _kv_case(torch, kv)
    live = sum(max(0, ln - s0) for s0, ln in zip(starts, lens))
    n_copy = copies_for(live * n_kv * hd * 2 * esize) if cold else 1
    k, v, all_tables = _paged_pool(torch, dev, g, seed, b * n_copy, npp, kv, heads)
    tables = [all_tables[c * b : (c + 1) * b] for c in range(n_copy)]
    if unmapped is not None:
        tables[0][unmapped] = -1
    q = torch.randn(b, 1, n_q, hd, generator=g, device=dev, dtype=torch.bfloat16)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    runs = [lambda t=t: paged_decode_attention(q, k, v, lengths, t, st) for t in tables]
    plains = [lambda t=t: paged_decode_attention_plain(q, k, v, lengths, t, st)
              for t in tables]
    out, ref = runs[0](), plains[0]()
    torch.cuda.synchronize()
    nbytes = 2 * q.numel() * 2 + live * n_kv * hd * 2 * esize + _table_bytes(starts, lens)
    flops = 4.0 * live * n_q * hd
    # The yardstick reads dense views gathered here (widened to bf16: no
    # PyTorch call reads f8), outside the timing.
    views = [(gather_pages(k, t).to(torch.bfloat16), gather_pages(v, t).to(torch.bfloat16))
             for t in tables]
    kpos = torch.arange(views[0][0].shape[2], device=dev)
    mask = ((kpos[None] >= st[:, None]) & (kpos[None] < lengths[:, None]))[:, None, None, :]
    qh = q.transpose(1, 2)
    libs = [lambda dk=dk, dv=dv: _sdpa(torch, qh, dk, dv, mask) for dk, dv in views]
    library_ms = cuda_ms(torch, rotating(libs), 10 * n_copy)
    del views, libs
    return _check(
        torch, "paged_decode_attention", case, out, ref,
        cuda_ms(torch, rotating(runs), 50 * n_copy), cuda_ms(torch, rotating(plains), 5),
        nbytes, flops, library_ms, copies=n_copy, route=traced_route(torch, runs[0]),
        extra=extra,
    )


def paged_decode_cases(torch, dev):
    g = torch.Generator(device=dev).manual_seed(4)
    n_p = ENGINE_MAX_SEQ // ENGINE_PAGE
    return [
        # Column 5 of row 0 lies past its live range.
        _paged_decode_case(torch, dev, g, 10, "lengths", [1, 130, 700, 2047, 256, 1000, 1500, 64],
                           [0] * 8, n_p, unmapped=(0, 5)),
        _paged_decode_case(torch, dev, g, 11, "starts",
                           [300, 700, 2047, 1000, 129, 640, 1500, 2000],
                           [0, 100, 1000, 513, 0, 200, 64, 1999], n_p),
    ]


def decode_split_bits(torch, dev, g, seed, lens, starts, npp) -> dict:
    """The split design's bits at the engine's decode operands: the paged
    kernel equals the dense kernel over the same keys gathered (max_seq
    ``npp`` pages and MAX_SEQ), each row called alone, and a second call
    (the tickets reset), all to the bit."""
    from cake_tpu_torch.models.llama.paged_cache import gather_pages
    from cake_tpu_torch.ops.decode_attention import decode_attention
    from cake_tpu_torch.ops.paged_attention import paged_decode_attention

    b = len(lens)
    k, v, tables = _paged_pool(torch, dev, g, seed, b, npp)
    q = torch.randn(b, 1, N_Q, HD, generator=g, device=dev, dtype=torch.bfloat16)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    paged = paged_decode_attention(q, k, v, lengths, tables, st)
    dk, dv = gather_pages(k, tables).contiguous(), gather_pages(v, tables).contiguous()
    wk = torch.zeros(b, N_KV, max(MAX_SEQ, dk.shape[2]), HD, device=dev, dtype=torch.bfloat16)
    wv = torch.zeros_like(wk)
    wk[:, :, : dk.shape[2]], wv[:, :, : dv.shape[2]] = dk, dv
    alone = torch.cat([paged_decode_attention(q[r : r + 1], k, v, lengths[r : r + 1],
                                              tables[r : r + 1], st[r : r + 1]) for r in range(b)])
    checks = {
        "paged_eq_dense": decode_attention(q, dk, dv, lengths, st),
        f"paged_eq_dense_max_seq_{wk.shape[2]}": decode_attention(q, wk, wv, lengths, st),
        "rows_alone_eq_batch": alone,
        "second_call_eq_first": paged_decode_attention(q, k, v, lengths, tables, st),
    }
    torch.cuda.synchronize()
    row = {"phase": "kernels", "kernel": "paged_decode_attention", "case": "split_bits",
           "lengths": list(lens), "starts": list(starts), "n_p": npp,
           **{name: bool(torch.equal(out, paged)) for name, out in checks.items()}}
    emit(row)
    failed = [name for name in checks if not row[name]]
    if failed:
        raise AssertionError(f"decode split bits at the engine's operands: {failed} failed")
    return row


def f8_bits(torch, dev, g, seed, decode: dict, chunk: dict) -> dict:
    """The f8 kernels' bits at the engine's operands (``decode``, ``chunk``:
    recorded dispatches): over an f8 pool, each paged kernel equals, to the
    bit, the same kernel over the pool widened to bf16 (the f8 bodies load
    narrow and widen exactly, the rest is the bf16 body) and the dense f8
    kernel over the pages gathered. Gated."""
    from cake_tpu_torch.models.llama.paged_cache import gather_pages
    from cake_tpu_torch.ops.chunk_prefill import chunk_prefill_attention
    from cake_tpu_torch.ops.decode_attention import decode_attention
    from cake_tpu_torch.ops.paged_attention import paged_decode_attention
    from cake_tpu_torch.ops.paged_prefill import paged_chunk_attention

    bf = torch.bfloat16
    b, npp = len(decode["lengths"]), max(decode["n_p"], chunk["n_p"])
    k, v, tables = _paged_pool(torch, dev, g, seed, b, npp, torch.float8_e4m3fn)
    kw, vw = k.to(bf), v.to(bf)
    dk, dv = gather_pages(k, tables).contiguous(), gather_pages(v, tables).contiguous()

    def rows(key, d):
        return torch.tensor(d[key], dtype=torch.int32, device=dev)

    q = torch.randn(b, 1, N_Q, HD, generator=g, device=dev, dtype=bf)
    lengths, starts = rows("lengths", decode), rows("starts", decode)
    dec = paged_decode_attention(q, k, v, lengths, tables, starts)
    qc = torch.randn(b, chunk["q"][1], N_Q, HD, generator=g, device=dev, dtype=bf)
    qs, cl, ks = rows("q_starts", chunk), rows("lengths", chunk), rows("k_starts", chunk)
    chk = paged_chunk_attention(qc, k, v, qs, cl, ks, tables)
    checks = {
        "paged_decode_eq_widened": (dec, paged_decode_attention(q, kw, vw, lengths, tables, starts)),
        "paged_decode_eq_dense": (dec, decode_attention(q, dk, dv, lengths, starts)),
        "paged_chunk_eq_widened": (chk, paged_chunk_attention(qc, kw, vw, qs, cl, ks, tables)),
        "paged_chunk_eq_dense": (chk, chunk_prefill_attention(qc, dk, dv, qs, cl, None, ks)),
    }
    _sync(torch, dev)
    row = {"phase": "kernels", "kernel": "paged_decode_attention", "case": "f8_bits",
           "kv_dtype": "f8", "n_p": npp,
           **{name: bool(torch.equal(a, b_)) for name, (a, b_) in checks.items()}}
    emit(row)
    failed = [name for name in checks if not row[name]]
    if failed:
        raise AssertionError(f"f8 kernel bits at the engine's operands: {failed} failed")
    return row


def _paged_chunk_case(torch, dev, g, seed, case, chunk, q_starts, lens, k_starts, npp,
                      kv=None, heads=None):
    """One paged_chunk_attention case over tables of ``npp`` pages a row (a
    bf16 pool, or ``kv``: f8)."""
    from cake_tpu_torch.models.llama.paged_cache import gather_pages
    from cake_tpu_torch.ops.paged_prefill import (
        paged_chunk_attention, paged_chunk_attention_plain,
    )

    n_q, n_kv, hd = heads or (N_Q, N_KV, HD)
    b = len(lens)
    kv_dt, esize, extra = _kv_case(torch, kv)
    k, v, tables = _paged_pool(torch, dev, g, seed, b, npp, kv, heads)
    q = torch.randn(b, chunk, n_q, hd, generator=g, device=dev, dtype=torch.bfloat16)
    qs = torch.tensor(q_starts, dtype=torch.int32, device=dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    ks = torch.tensor(k_starts, dtype=torch.int32, device=dev)
    run = lambda: paged_chunk_attention(q, k, v, qs, lengths, ks, tables)  # noqa: E731
    plain = lambda: paged_chunk_attention_plain(q, k, v, qs, lengths, ks, tables)  # noqa: E731
    out, ref = run(), plain()
    torch.cuda.synchronize()
    # Widened to bf16 for the yardstick: no PyTorch call reads f8.
    dk, dv = gather_pages(k, tables).to(torch.bfloat16), gather_pages(v, tables).to(torch.bfloat16)
    qpos = qs[:, None] + torch.arange(chunk, device=dev)[None]
    kpos = torch.arange(dk.shape[2], device=dev)[None, None]
    mask = (kpos <= qpos[:, :, None]) & (kpos >= ks[:, None, None]) & (kpos < lengths[:, None, None])
    pairs = int(mask.sum().item())
    keys = int(mask.any(dim=1).sum().item())
    nbytes = 2 * q.numel() * 2 + keys * n_kv * hd * 2 * esize + _table_bytes(k_starts, lens)
    flops = 4.0 * pairs * n_q * hd
    qh = q.transpose(1, 2)
    library_ms = cuda_ms(torch, lambda: _sdpa(torch, qh, dk, dv, mask[:, None]), 5)
    del dk, dv
    return _check(
        torch, "paged_chunk_attention", case, out, ref,
        cuda_ms(torch, run, 20), cuda_ms(torch, plain, 3), nbytes, flops, library_ms,
        route=traced_route(torch, run), extra=extra,
    )


def paged_chunk_cases(torch, dev):
    g = torch.Generator(device=dev).manual_seed(5)
    pads4 = [0, 17, 100, 200]
    return [
        _paged_chunk_case(torch, dev, g, 20, "cold", 256, [0] * 4, [256] * 4, pads4, 2),
        _paged_chunk_case(torch, dev, g, 21, "suffix", 64, [300] * 4, [364] * 4, pads4, 3),
    ]


# The decode fusions' main-path cases: the kernels line reports these.
FUSED_MAIN = {
    "fused_norm_matmul": "w_gu_rows8",
    "fused_qkv_ingest": "paged_b8",
    "fused_sample_tail": "greedy_b8",
}


NORM_SITES = (("wqkv", HIDDEN, (N_Q + 2 * N_KV) * HD), ("w_gu", HIDDEN, 2 * INTER),
              ("lm_head", HIDDEN, VOCAB))
NORM_BITS_ROWS = (1, 8, 16, 64, 256)  # swap AB at four product widths, the warp-specialized body


def norm_matmul_cases(torch, dev):
    """fused_norm_matmul into each site's weight from 1 to MAX_ROWS rows
    (every body), and a Gemma (1 + w) case; the weights read cold (wqkv
    rotates over copies, the others exceed the L2 alone)."""
    from cake_tpu_torch.ops.fused_norm_matmul import (
        MAX_ROWS, _unfused, fused_norm_matmul, fused_norm_matmul_plain,
    )

    g = torch.Generator(device=dev).manual_seed(8)
    bf = torch.bfloat16
    rows_out = []
    cases = [(site, n, r, False) for site, _, n in NORM_SITES
             for r in (1, 4, 8, 16, 64, 128, MAX_ROWS)]
    cases.append(("wqkv", NORM_SITES[0][2], 8, True))
    weights = {}
    for site, out_dim, n_rows, offset in cases:
        if site not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            n_copy = copies_for(HIDDEN * out_dim * 2)
            weights[site] = [
                torch.randn(HIDDEN, out_dim, generator=g, device=dev, dtype=bf) * HIDDEN**-0.5
                for _ in range(n_copy)
            ]
        ws = weights[site]
        x = (3.0 * torch.randn(n_rows, 1, HIDDEN, generator=g, device=dev)).to(bf)
        nw = (0.1 * torch.randn(HIDDEN, generator=g, device=dev) + (0.0 if offset else 1.0)).to(bf)
        kw = dict(eps=1e-5, offset=offset)
        runs = [lambda w=w: fused_norm_matmul(x, nw, w, **kw) for w in ws]
        plains = [lambda w=w: fused_norm_matmul_plain(x, nw, w, **kw) for w in ws]
        libs = [lambda w=w: _unfused(x, nw, w, 1e-5, offset) for w in ws]
        out, ref = runs[0](), plains[0]()
        torch.cuda.synchronize()
        nbytes = 2 * (n_rows * HIDDEN + HIDDEN + HIDDEN * out_dim + n_rows * out_dim)
        flops = 2.0 * n_rows * HIDDEN * out_dim
        case = f"{site}_rows{n_rows}" + ("_offset" if offset else "")
        rows_out.append(_check(
            torch, "fused_norm_matmul", case, out, ref,
            cuda_ms(torch, rotating(runs), 20 * len(ws)),
            cuda_ms(torch, rotating(plains), 10 * len(ws)), nbytes, flops,
            cuda_ms(torch, rotating(libs), 10 * len(ws)), copies=len(ws), cosine=True,
            tol=max(TOL, bf16_ulp(ref)), route=traced_route(torch, runs[0]),
        ))
    weights.clear()
    torch.cuda.empty_cache()
    rows_out.append(norm_matmul_bits(torch, dev))
    return rows_out


def norm_matmul_bits(torch, dev, sites=NORM_SITES) -> dict:
    """fused_norm_matmul's row independence, bitwise: at each site, the
    body plan() picks at each of NORM_BITS_ROWS rows, run through the
    private _run on that many rows, gives its first and last rows the bits
    of the same row run alone through the same body. Gated: a row's bits
    must not depend on the rows beside it."""
    from cake_tpu_torch.ops.fused_norm_matmul import _run, plan

    g = torch.Generator(device=dev).manual_seed(14)
    bf = torch.bfloat16
    equal = {}
    for site, hidden, out_dim in sites:
        w = (torch.randn(hidden, out_dim, generator=g, device=dev) * hidden**-0.5).to(bf)
        nw = (0.1 * torch.randn(hidden, generator=g, device=dev) + 1.0).to(bf)
        x = (3.0 * torch.randn(max(NORM_BITS_ROWS), hidden, generator=g, device=dev)).to(bf)
        for n in NORM_BITS_ROWS:
            p = plan(n, hidden, out_dim, bf)
            full = _run(x[:n], nw, w, p, eps=1e-5)
            for r in sorted({0, n - 1}):
                alone = _run(x[r : r + 1], nw, w, p, eps=1e-5)
                equal[f"{site}_rows{n}_{p.body}_row{r}"] = bool(torch.equal(alone, full[r : r + 1]))
        del w, x
    _sync(torch, dev)
    row = {"phase": "kernels", "kernel": "fused_norm_matmul", "case": "bits",
           "rows": list(NORM_BITS_ROWS), "equal": equal}
    emit(row)
    if not all(equal.values()):
        raise AssertionError(f"fused_norm_matmul rows depend on the call's other rows: {row}")
    return row


def _ingest_case(torch, dev, g, case, b, slot, paged, unmapped=None, kv=None, heads=None):
    """One fused_qkv_ingest case at Llama-3-8B heads: the kernel and the
    plain version each write their own copy of the cache (bf16, or ``kv``:
    f8, with four k and two v values of row 0 past +-464, which must come
    back NaN, six NaN bytes in all); q and every page but the sink must be
    equal, byte for byte. The library time is the unfused step as the
    engine runs it (split, rope on q and k, the write through a plan built
    once per dispatch)."""
    from cake_tpu_torch.models.llama.cache import write_layer
    from cake_tpu_torch.models.llama.paged_cache import write_pages, write_plan
    from cake_tpu_torch.ops.fused_ingest import fused_qkv_ingest, fused_qkv_ingest_plain
    from cake_tpu_torch.ops.kv_dtype import kv_view
    from cake_tpu_torch.ops.rope import apply_rope

    n_q, n_kv, hd = heads or (N_Q, N_KV, HD)
    bf = torch.bfloat16
    kv_dt, esize, extra = _kv_case(torch, kv)
    n_p = ENGINE_MAX_SEQ // ENGINE_PAGE
    qkv = torch.randn(b, 1, (n_q + 2 * n_kv) * hd, generator=g, device=dev, dtype=bf)
    cos = torch.randn(b, 1, hd // 2, generator=g, device=dev)
    sin = torch.randn(b, 1, hd // 2, generator=g, device=dev)
    if kv is not None:  # row 0: four k values and two v values past +-464 (rope them as they are)
        qkv[0, 0, n_q * hd : n_q * hd + 4] = torch.tensor([470.0, -470.0, 1000.0, -2000.0])
        qkv[0, 0, (n_q + n_kv) * hd : (n_q + n_kv) * hd + 2] = torch.tensor([500.0, -465.5])
        cos[0, 0, :4], sin[0, 0, :4] = 1.0, 0.0
    tables = None
    if paged:
        k0, v0, tables = _paged_pool(torch, dev, g, 40 + b, b, n_p, kv, heads)
        if unmapped is not None:
            tables[unmapped] = -1
    else:
        k0 = torch.randn(b, n_kv, ENGINE_MAX_SEQ, hd, generator=g, device=dev, dtype=bf).to(kv_dt)
        v0 = torch.randn(b, n_kv, ENGINE_MAX_SEQ, hd, generator=g, device=dev, dtype=bf).to(kv_dt)
    kw = dict(n_q=n_q, n_kv=n_kv, block_tables=tables)
    k1, v1, k2, v2 = k0.clone(), v0.clone(), k0.clone(), v0.clone()
    at = torch.full((), slot, dtype=torch.int64, device=dev)  # read by the kernel on the card
    q1 = fused_qkv_ingest(qkv, cos, sin, at, k1, v1, **kw)
    q2 = fused_qkv_ingest_plain(qkv, cos, sin, at, k2, v2, **kw)
    torch.cuda.synchronize()
    live = slice(None, -1) if paged else slice(None)  # every page but the sink
    if kv is None:
        out = torch.cat([q1.flatten(), k1[live].flatten(), v1[live].flatten()])
        ref = torch.cat([q2.flatten(), k2[live].flatten(), v2[live].flatten()])
    else:  # bytes: NaN is no float's equal
        out, ref = (torch.cat([qq.view(torch.uint8).flatten(), kv_view(kk[live]).flatten(),
                               kv_view(vv[live]).flatten()])
                    for qq, kk, vv in ((q1, k1, v1), (q2, k2, v2)))
        nan = (kv_view(k1[live]) & 0x7F == 0x7F).sum() + (kv_view(v1[live]) & 0x7F == 0x7F).sum()
        extra = dict(extra, nan_written=int(nan.item()))
        if extra["nan_written"] != 6:
            emit({"phase": "kernels", "kernel": "fused_qkv_ingest", "case": case, **extra})
            raise AssertionError(f"fused_qkv_ingest/{case}: values past +-464 did not come back NaN")
    plan = write_plan(slot, 1, tables, k0.shape[0] - 1, ENGINE_PAGE) if paged else None

    def unfused():
        qw, kw_ = n_q * hd, n_kv * hd
        q = apply_rope(qkv[..., :qw].reshape(b, 1, n_q, hd), cos, sin, None)
        k = apply_rope(qkv[..., qw : qw + kw_].reshape(b, 1, n_kv, hd), cos, sin, None)
        v = qkv[..., qw + kw_ :].reshape(b, 1, n_kv, hd)
        if paged:
            write_pages(k2, v2, k, v, plan)
        else:
            write_layer(k2, v2, k, v, slot)
        return q

    n_written = 0 if paged and slot // ENGINE_PAGE >= n_p else b - (unmapped is not None)
    nbytes = (b * (n_q + 2 * n_kv) * hd * 2 + 2 * b * hd // 2 * 4 + b * n_q * hd * 2
              + n_written * 2 * n_kv * hd * esize + (4 * b if paged else 0))
    flops = 6.0 * b * (n_q + n_kv) * hd // 2
    run = lambda: fused_qkv_ingest(qkv, cos, sin, at, k1, v1, **kw)  # noqa: E731
    if kv is not None:  # the f8 case's yardstick: the same unfused step (narrow) into f8
        extra["library"] = "the unfused composition into the f8 cache"
    return _check(
        torch, "fused_qkv_ingest", case, out, ref, cuda_ms(torch, run, 200),
        cuda_ms(torch, lambda: fused_qkv_ingest_plain(qkv, cos, sin, at, k2, v2, **kw), 50),
        nbytes, flops, cuda_ms(torch, unfused, 50), exact=True, route=traced_route(torch, run),
        extra=extra,
    )


def ingest_slot_replays(torch, dev) -> dict:
    """The ingest reads its slot from device memory: one launch captured in
    a CUDA graph (as the decode chunk captures it), replayed at several
    slots written into the slot tensor between replays, equals the plain
    version at each slot, to the bit: dense b=1, and paged b=8 through the
    engine's pool with an unmapped entry and a slot past the table (every
    page but the sink). Gated."""
    from cake_tpu_torch.ops.fused_ingest import fused_qkv_ingest, fused_qkv_ingest_plain

    g = torch.Generator(device=dev).manual_seed(19)
    bf = torch.bfloat16
    n_p = ENGINE_MAX_SEQ // ENGINE_PAGE
    equal = {}
    for name, b, paged, slots in (
            ("dense_b1", 1, False, (0, 1, 733, ENGINE_MAX_SEQ - 1)),
            ("paged_b8", 8, True, (0, 127, 128, 505, 1000, n_p * ENGINE_PAGE + 5))):
        qkv = torch.randn(b, 1, (N_Q + 2 * N_KV) * HD, generator=g, device=dev, dtype=bf)
        cos = torch.randn(b, 1, HD // 2, generator=g, device=dev)
        sin = torch.randn(b, 1, HD // 2, generator=g, device=dev)
        tables = None
        if paged:
            k0, v0, tables = _paged_pool(torch, dev, g, 60, b, n_p)
            tables[5, 3] = -1
        else:
            k0 = torch.randn(b, N_KV, ENGINE_MAX_SEQ, HD, generator=g, device=dev, dtype=bf)
            v0 = torch.randn(b, N_KV, ENGINE_MAX_SEQ, HD, generator=g, device=dev, dtype=bf)
        kw = dict(n_q=N_Q, n_kv=N_KV, block_tables=tables)
        at = torch.zeros((), dtype=torch.int64, device=dev)
        k1, v1 = k0.clone(), v0.clone()
        fused_qkv_ingest(qkv, cos, sin, at, k1, v1, **kw)  # outside the capture
        graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            graph.capture_begin()
            q1 = fused_qkv_ingest(qkv, cos, sin, at, k1, v1, **kw)
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
        live = slice(None, -1) if paged else slice(None)
        for slot in slots:
            k1.copy_(k0)
            v1.copy_(v0)
            at.fill_(slot)
            graph.replay()
            k2, v2 = k0.clone(), v0.clone()
            q2 = fused_qkv_ingest_plain(qkv, cos, sin, slot, k2, v2, **kw)
            torch.cuda.synchronize()
            equal[f"{name}_slot{slot}"] = bool(
                torch.equal(q1, q2) and torch.equal(k1[live], k2[live])
                and torch.equal(v1[live], v2[live]))
        del graph, k0, v0, k1, v1, k2, v2
    row = {"phase": "kernels", "kernel": "fused_qkv_ingest", "case": "graph_slot_replays",
           "equal": equal}
    emit(row)
    if not all(equal.values()):
        raise AssertionError(f"fused_qkv_ingest replayed at a new slot parted from plain: {row}")
    return row


def ingest_cases(torch, dev):
    g = torch.Generator(device=dev).manual_seed(9)
    n_p = ENGINE_MAX_SEQ // ENGINE_PAGE
    return [
        _ingest_case(torch, dev, g, "dense_b1", 1, 733, paged=False),
        _ingest_case(torch, dev, g, "dense_b8", 8, 505, paged=False),
        # slot 505 is logical page 3: row 5's entry there is unmapped.
        _ingest_case(torch, dev, g, "paged_b8", 8, 505, paged=True, unmapped=(5, 3)),
        _ingest_case(torch, dev, g, "paged_past_table", 8, n_p * ENGINE_PAGE + 5, paged=True),
        _ingest_case(torch, dev, g, "dense_b1_f8", 1, 733, paged=False, kv=torch.float8_e4m3fn),
        _ingest_case(torch, dev, g, "paged_b8_f8", 8, 505, paged=True, unmapped=(5, 3),
                     kv=torch.float8_e4m3fn),
        ingest_slot_replays(torch, dev),
    ]


def _tail_case(torch, dev, g, case, b, knobs, guards=False):
    """One fused_sample_tail case over Llama-3's vocab: logits as the model
    hands them over (bf16 products cast to f32, many duplicates), a ring of
    128 recent ids, gumbel noise when sampled; the ids must equal the plain
    version's."""
    from cake_tpu_torch.ops.fused_sample_tail import (
        _composition, fused_sample_tail, fused_sample_tail_plain,
    )

    window = 128
    logits = (2.0 * torch.randn(b, VOCAB, generator=g, device=dev)).to(torch.bfloat16).float()
    if guards:
        logits[0] = float("-inf")
        logits[1, VOCAB // 3] = float("nan")
    ring = torch.randint(-1, VOCAB, (b, window), generator=g, device=dev)
    sampled = knobs["temperature"] > 0
    noise = None
    if sampled:
        u = torch.rand(b, VOCAB, generator=g, device=dev)
        noise = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    kw = dict(top_p=None, **knobs)
    run = lambda: fused_sample_tail(logits, ring, noise, **kw)  # noqa: E731
    plain = lambda: fused_sample_tail_plain(logits, ring, noise, **kw)  # noqa: E731
    out, ref = run(), plain()
    torch.cuda.synchronize()
    nbytes = b * VOCAB * 4 * (2 if sampled else 1) + b * window * 8 + b * 8
    lib = lambda: _composition(logits, ring, noise, knobs["temperature"], knobs["top_k"], None,  # noqa: E731
                               knobs["repeat_penalty"])
    return _check(
        torch, "fused_sample_tail", case, out, ref, cuda_ms(torch, run, 50),
        cuda_ms(torch, plain, 20), nbytes, 0.0, cuda_ms(torch, lib, 20), exact=True,
        route=traced_route(torch, run),
    )


def tail_cases(torch, dev):
    g = torch.Generator(device=dev).manual_seed(10)
    greedy = dict(temperature=0.0, top_k=None, repeat_penalty=1.0)
    sampled = dict(temperature=0.7, top_k=40, repeat_penalty=1.1)
    return [
        _tail_case(torch, dev, g, "greedy_b1", 1, greedy),
        _tail_case(torch, dev, g, "greedy_b8", 8, greedy),
        _tail_case(torch, dev, g, "sampled_b1", 1, sampled),  # the generator's sampled step
        _tail_case(torch, dev, g, "sampled_b8", 8, sampled),
        _tail_case(torch, dev, g, "guards_b8", 8, sampled, guards=True),
    ]


# 32-bit integer operations an element of the noise kernel: one
# threefry2x32-20 (2 key adds, 20 rounds of add, rotate and xor, 5 key
# injections of 2 adds) and the bits' xor; the float tail (a shift, an or, a
# subtract, a max, two logs) is not counted.
NOISE_OPS_PER_ELEMENT = 73
NOISE_TOL = 1e-6  # gumbel planes: kernel logf against torch's log, the same inputs


def _noise_case(torch, dev, case, keys, shape):
    """The noise kernel (ops/threefry.py) at one draw, split included,
    against its plain twin on the same keys: the next and sub keys, the
    bits and the uniforms to the bit, the gumbel plane within NOISE_TOL
    (and whether it is bitwise), finite. Timed as the decode step draws it
    (gumbel, with the split); library_ms is ``torch.rand`` and two logs at
    the same shape (another stream: a time only)."""
    import math

    from cake_tpu_torch.ops.threefry import threefry_noise, threefry_noise_plain

    equal = {}
    planes = {}
    for kind in ("bits", "uniform", "gumbel"):
        got, ref = threefry_noise(keys, shape, kind=kind), threefry_noise_plain(keys, shape, kind=kind)
        torch.cuda.synchronize()
        equal["keys"] = equal.get("keys", True) and all(
            torch.equal(a, b) for a, b in zip(got[:2], ref[:2]))
        bits_of = (lambda t: t) if kind == "bits" else (lambda t: t.view(torch.int32))
        equal[kind] = bool(torch.equal(bits_of(got[2]), bits_of(ref[2])))
        planes[kind] = got[2], ref[2]
    full = tuple(planes["gumbel"][0].shape)
    rows = keys.shape[0] if keys.dim() == 2 else 1
    n = math.prod(full)
    nbytes = 4 * n + 16 * rows + 32 * rows  # the plane; the keys read, the next and sub written
    run = lambda: threefry_noise(keys, shape)  # noqa: E731
    plain = lambda: threefry_noise_plain(keys, shape)  # noqa: E731
    lib = lambda: -torch.log(-torch.log(torch.rand(full, device=dev)))  # noqa: E731
    row = _check(
        torch, "threefry_noise", case, *planes["gumbel"], cuda_ms(torch, run, 200),
        cuda_ms(torch, plain, 10), nbytes, n * NOISE_OPS_PER_ELEMENT, cuda_ms(torch, lib, 50),
        tol=NOISE_TOL, peak=CUDA_CORE_OPS_PER_S,
        extra={"shape": list(full), "per_row": keys.dim() == 2,
               "equal": {k: equal[k] for k in ("keys", "bits", "uniform")},
               "gumbel_bitwise": equal["gumbel"],
               "library": "torch.rand + two logs at the same shape (another stream)"},
    )
    if not all(row["equal"].values()):
        raise AssertionError(f"threefry_noise/{case}: keys, bits or uniforms differ from the "
                             f"plain twin: {row['equal']}")
    return row


def _noise_constants(torch, dev) -> dict:
    """The noise kernel and its twin give jax's values on the card: the
    twin's threefry2x32 on the known answers, the kernel's split of key
    (0, 0) (its next key is the first known answer) and of
    PRNGKey(THREEFRY_SEED), and ``sample`` (the kernel's shared draw) over
    zeros((2, VOCAB)) at that key: jax's categorical ids."""
    from cake_tpu_torch.ops.sampling import sample
    from cake_tpu_torch.ops.threefry import prng_key, threefry2x32, threefry_noise

    def pair(t):
        return tuple(int(v) for v in t)

    kat = [pair(threefry2x32(*(torch.tensor(v, dtype=torch.int64, device=dev) for v in k + c)))
           == want for k, c, want in THREEFRY_KAT]
    zero_next, _, _ = threefry_noise(torch.zeros(2, dtype=torch.int64, device=dev), (1,))
    nxt, sub, _ = threefry_noise(prng_key(THREEFRY_SEED, dev), (1,))
    ids = sample(torch.zeros((2, VOCAB), device=dev), prng_key(THREEFRY_SEED, dev),
                 temperature=1.0)
    row = {"phase": "kernels", "kernel": "threefry_noise", "case": "jax_constants",
           "known_answers": kat, "kernel_split_of_zero_key": pair(zero_next) == THREEFRY_KAT[0][2],
           "kernel_split": (pair(nxt), pair(sub)) == SPLIT_OF_SEED,
           "categorical": tuple(ids.tolist()) == CATEGORICAL_OF_SEED, "ids": ids.tolist()}
    emit(row)
    if not (all(kat) and row["kernel_split_of_zero_key"] and row["kernel_split"]
            and row["categorical"]):
        raise AssertionError(f"threefry_noise: jax's constants not met: {row}")
    return row


def noise_cases(torch, dev):
    """The noise kernel where the main path launches it: the engine's
    per-row draw (8 keys over VOCAB), the generator's shared one (one key,
    one row); then jax's constants."""
    from cake_tpu_torch.ops.threefry import prng_key

    return [
        _noise_case(torch, dev, "per_row_b8", prng_key([100 + i for i in range(8)], dev), (VOCAB,)),
        _noise_case(torch, dev, "shared_b1", prng_key(THREEFRY_SEED, dev), (1, VOCAB)),
        _noise_constants(torch, dev),
    ]


def launch_floor(torch) -> dict:
    """The time of an empty kernel from the port's library, timed as the
    cases are: the floor under any kernel's time, beside the bytes bound of
    the small ones (fused_qkv_ingest, fused_sample_tail)."""
    import ctypes

    from cake_tpu_torch.ops import _build

    lib = _build.library()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    row = {"phase": "kernels", "kernel": "launch_floor", "case": "empty_kernel",
           "ms": cuda_ms(torch, lambda: _build.check(lib.cake_empty_kernel(stream), "empty"), 200)}
    emit(row)
    return row


# Llama-3-8B's int4 projections: (site, in, out).
INT4_SITES = (("wqkv", HIDDEN, (N_Q + 2 * N_KV) * HD), ("wo", N_Q * HD, HIDDEN),
              ("w_gu", HIDDEN, 2 * INTER), ("w_down", INTER, HIDDEN), ("lm_head", HIDDEN, VOCAB))
INT4_MAIN = "w_gu_rows1"  # the kernels line: the generator's decode into w_gu
# One f16 and one f32 case beside the bf16 ones: (site, rows).
INT4_OTHER_DTYPES = {"float16": ("w_gu", 8), "float32": ("wqkv", 8)}
INT4_INDEPENDENT = ("wqkv", "w_gu", "w_down")  # row independence: splits, no split, 8 splits
INDEPENDENT_ROWS = 3840  # the engine's prefill window: 8 lanes of ~480 rows
INT4_ROWS = (1, 8, 256, INDEPENDENT_ROWS)  # the bf16 cases of each projection
WGMMA_WIDTHS = (8, 16, 32, 64, 128, 256)  # the wgmma product widths the bits probe holds
DECODE_BODY_ROWS = (1, 8)  # rows at which mma.sync and wgmma's decode tiles are timed


def dtype_step(torch, ref, dtype) -> float:
    """One rounding step of ``dtype`` at the largest magnitude of ``ref``
    (f32: 1e-5 of it, another summation order)."""
    import math

    top = ref.float().abs().max().item()
    if top == 0:
        return 0.0
    if dtype == torch.float32:
        return 1e-5 * top
    bits = 7 if dtype == torch.bfloat16 else 10
    return 2.0 ** (math.floor(math.log2(top)) - bits)


def _int4_case(torch, dev, g, site, qs, n_rows, dtype, case=None):
    """int4_matmul at [n_rows, in] against ``qs`` (operand copies of one
    int4 weight, rotated so each call reads its weight cold); the yardstick
    is cuBLAS over the dequantized weight in x's dtype (copies rotated too)."""
    from cake_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_plain
    from cake_tpu_torch.ops.quant import dequantize_weight

    in_dim, out_dim = qs[0].in_dim, qs[0].w.shape[-1]
    x = (torch.randn(n_rows, in_dim, generator=g, device=dev)).to(dtype)
    runs = [lambda q=q: int4_matmul(x, q.w, q.scale) for q in qs]
    plains = [lambda q=q: int4_matmul_plain(x, q.w, q.scale) for q in qs]
    out, ref = runs[0](), plains[0]()
    torch.cuda.synchronize()
    n_lib = min(len(qs), copies_for(in_dim * out_dim * x.element_size()))
    dense = [dequantize_weight(q, dtype) for q in qs[:n_lib]]
    libs = [lambda w=w: x @ w for w in dense]
    library_ms = cuda_ms(torch, rotating(libs), 10 * n_lib)
    del dense
    nbytes = (qs[0].w.numel() + 4 * qs[0].scale.numel()
              + (n_rows * in_dim + n_rows * out_dim) * x.element_size())
    flops = 2.0 * n_rows * in_dim * out_dim
    return _check(
        torch, "int4_matmul", case or f"{site}_rows{n_rows}" + (
            "" if dtype == torch.bfloat16 else "_" + str(dtype).removeprefix("torch.")),
        out, ref, cuda_ms(torch, rotating(runs), 20 * len(qs)),
        cuda_ms(torch, rotating(plains), 2 * len(qs)), nbytes, flops, library_ms,
        copies=len(qs), cosine=True, tol=dtype_step(torch, ref, dtype),
        route=traced_route(torch, runs[0]),
    )


def _int4_independent(torch, dev, g, site, q) -> dict:
    """Rows of 8-, 17-, 64-, 256- and INDEPENDENT_ROWS-row calls against the
    1-row call, to the bit: a row's sum must not depend on its neighbours
    (nor on the body, mma.sync or wgmma, and the row tile its count picks)."""
    from cake_tpu_torch.ops.int4_matmul import int4_matmul

    x = torch.randn(INDEPENDENT_ROWS, q.in_dim, generator=g, device=dev).to(torch.bfloat16)
    full = int4_matmul(x, q.w, q.scale)
    equal = {}
    for n in (8, 17, 64, 256):
        equal[f"rows{n}_prefix"] = bool(torch.equal(int4_matmul(x[:n], q.w, q.scale), full[:n]))
    for r in (0, 7, 255, INDEPENDENT_ROWS - 1):
        equal[f"row{r}"] = bool(torch.equal(int4_matmul(x[r : r + 1], q.w, q.scale), full[r : r + 1]))
    torch.cuda.synchronize()
    row = {"phase": "kernels", "kernel": "int4_matmul", "case": f"{site}_row_independence",
           "rows": INDEPENDENT_ROWS, "equal": equal}
    emit(row)
    if not all(equal.values()):
        raise AssertionError(f"int4_matmul rows depend on the call's other rows: {row}")
    return row


def int4_wgmma_bits(torch, dev, sites=INT4_SITES, n_rows: int = 256) -> dict:
    """One operand set per projection through every int4 body: mma.sync
    (the decode rows'), wgmma at each product width of WGMMA_WIDTHS, each
    split a block (the ordered reduce) and, where K is split, one block
    folding the splits. All must give the mma.sync body's bits: the wrapper
    picks the body and the width by row count, so any difference would
    change a row's bits with the rows beside it."""
    from cake_tpu_torch.ops.int4_matmul import _run, plan
    from cake_tpu_torch.ops.quant import quantize4_weight

    g = torch.Generator(device=dev).manual_seed(13)
    equal = {}
    for site, in_dim, out_dim in sites:
        q = quantize4_weight(
            (torch.randn(in_dim, out_dim, generator=g, device=dev) * in_dim**-0.5).to(torch.bfloat16))
        x = torch.randn(n_rows, in_dim, generator=g, device=dev).to(torch.bfloat16)
        base = plan(n_rows, in_dim, out_dim, torch.bfloat16, in_dim // q.scale.shape[0])
        ref = _run(x, q.w, q.scale, dataclasses.replace(base, route="mma.sync", tile=0, fold=False))
        for width in WGMMA_WIDTHS:
            folds = (False, True) if base.splits > 1 and width in (32, 64, 128) else (False,)
            for fold in folds:
                out = _run(x, q.w, q.scale, dataclasses.replace(base, route="wgmma", tile=width,
                                                                fold=fold))
                equal[f"{site}_wgmma{width}" + ("_fold" if fold else "")] = bool(torch.equal(out, ref))
        del q, x
    _sync(torch, dev)
    agree = all(equal.values())
    row = {"phase": "kernels", "kernel": "int4_matmul", "case": "wgmma_bits", "rows": n_rows,
           "equal": equal, "answer": WGMMA_AGREE if agree else "differ"}
    emit(row)
    if not agree:
        raise AssertionError(f"int4_matmul bodies disagree to the bit: {row}")
    return row


# The wgmma-bits answer the kernels line reports when the probe holds.
WGMMA_AGREE = "wgmma at every product width and mma.sync m16n8k16 give the same bits"


def _int4_decode_bodies(torch, dev, g, site, qs) -> dict:
    """mma.sync (plan()'s body at decode rows) against wgmma at row tiles
    8 and 16 (the same split blocks and ordered reduce) at DECODE_BODY_ROWS,
    timed in the same run over the same cold weight copies: the measurement
    behind int4_matmul.DECODE_ROWS. Each must give plan()'s bits."""
    from cake_tpu_torch.ops.int4_matmul import _run, plan

    in_dim, out_dim = qs[0].in_dim, qs[0].w.shape[-1]
    ms, equal = {}, {}
    for n_rows in DECODE_BODY_ROWS:
        x = torch.randn(n_rows, in_dim, generator=g, device=dev).to(torch.bfloat16)
        base = plan(n_rows, in_dim, out_dim, torch.bfloat16, in_dim // qs[0].scale.shape[0])
        ref = _run(x, qs[0].w, qs[0].scale, base)
        for tile in (0, 8, 16):
            p = base if tile == 0 else dataclasses.replace(base, route="wgmma", tile=tile)
            name = f"rows{n_rows}_" + (base.route if tile == 0 else f"wgmma{tile}")
            runs = [lambda q=q, p=p: _run(x, q.w, q.scale, p) for q in qs]
            equal[name] = bool(torch.equal(runs[0](), ref))
            ms[name] = cuda_ms(torch, rotating(runs), 20 * len(qs))
    row = {"phase": "kernels", "kernel": "int4_matmul", "case": f"{site}_decode_bodies",
           "ms_by_body": ms, "equal": equal, "operand_copies": len(qs)}
    emit(row)
    if not all(equal.values()):
        raise AssertionError(f"int4_matmul decode bodies disagree to the bit: {row}")
    return row


def int4_cases(torch, dev):
    """int4_matmul into each of Llama-3-8B's projections, its weight
    quantized from N(0, 1/in) bf16 draws; copies enough to read it cold."""
    from cake_tpu_torch.ops.quant import quantize4_weight

    g = torch.Generator(device=dev).manual_seed(11)
    rows_out = [int4_wgmma_bits(torch, dev)]
    torch.cuda.empty_cache()
    for site, in_dim, out_dim in INT4_SITES:
        n_copy = copies_for(in_dim * out_dim // 2)
        qs = [quantize4_weight(
            (torch.randn(in_dim, out_dim, generator=g, device=dev) * in_dim**-0.5).to(torch.bfloat16)
        ) for _ in range(n_copy)]
        for n_rows in INT4_ROWS:
            rows_out.append(_int4_case(torch, dev, g, site, qs, n_rows, torch.bfloat16))
        for name, (other_site, n_rows) in INT4_OTHER_DTYPES.items():
            if other_site == site:
                rows_out.append(_int4_case(torch, dev, g, site, qs, n_rows, getattr(torch, name)))
        if site in INT4_INDEPENDENT:
            rows_out.append(_int4_independent(torch, dev, g, site, qs[0]))
        rows_out.append(_int4_decode_bodies(torch, dev, g, site, qs))
        del qs
        torch.cuda.empty_cache()
    return rows_out


def phase_kernels(torch) -> dict:
    dev = torch.device("cuda")
    rows = decode_cases(torch, dev) + chunk_cases(torch, dev) + flash_cases(torch, dev)
    rows += paged_decode_cases(torch, dev) + paged_chunk_cases(torch, dev)
    torch.cuda.empty_cache()
    rows += norm_matmul_cases(torch, dev) + ingest_cases(torch, dev) + tail_cases(torch, dev)
    rows += noise_cases(torch, dev)
    rows.append(launch_floor(torch))
    torch.cuda.empty_cache()
    rows += int4_cases(torch, dev)
    return {(r["kernel"], r["case"]): r for r in rows}


def engine_kernel_cases(torch, engine_path: dict) -> dict:
    """Each kernel at the operands the engine handed it in phase engine:
    the paged kernels' main path (the cold wave's prefill window and a
    mid-wave decode step) and the dense kernels under the dense engine."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    paged, dense = engine_path["dispatches"]["paged"], engine_path["dispatches"]["dense"]
    for shapes in (paged, dense):
        for name, d in shapes.items():
            if d["q"][2:] != (N_Q, HD):
                raise AssertionError(f"{name}: the engine's q is {d['q']}, not [.., {N_Q}, {HD}]")
    d, c = paged["paged_decode_attention"], paged["paged_chunk_attention"]
    f8 = torch.float8_e4m3fn
    rows = [
        _paged_decode_case(torch, dev, g, 30, "main_path", d["lengths"], d["starts"], d["n_p"],
                           cold=True),
        decode_split_bits(torch, dev, g, 32, d["lengths"], d["starts"], d["n_p"]),
        _paged_chunk_case(torch, dev, g, 31, "main_path", c["q"][1], c["q_starts"],
                          c["lengths"], c["k_starts"], c["n_p"]),
        # engine_f8's paged kernels: the same operands over an f8 pool
        _paged_decode_case(torch, dev, g, 33, "main_path_f8", d["lengths"], d["starts"],
                           d["n_p"], cold=True, kv=f8),
        _paged_chunk_case(torch, dev, g, 34, "main_path_f8", c["q"][1], c["q_starts"],
                          c["lengths"], c["k_starts"], c["n_p"], kv=f8),
        f8_bits(torch, dev, g, 35, d, c),
    ]
    d, c = dense["decode_attention"], dense["chunk_prefill_attention"]
    for case, kv in (("dense_engine", None), ("dense_engine_f8", f8)):
        rows += [
            _decode_case(torch, dev, g, case, d["lengths"], d["starts"], {},
                         max_seq=d["kv"][2], cold=True, kv=kv),
            _chunk_case(torch, dev, g, case, c["q"][1], c["q_starts"], c["k_starts"], {},
                        max_seq=c["kv"][2], lens=c["lengths"], kv=kv),
        ]
    torch.cuda.empty_cache()
    return {(r["kernel"], r["case"]): r for r in rows}


# ---------------------------------------------------------------- phase 4


def _counters():
    from cake_tpu_torch.ops import chunk_prefill, decode_attention, flash_attention

    return (
        decode_attention.decode_attention,
        chunk_prefill.chunk_prefill_attention,
        decode_attention.decode_attention_plain,
        chunk_prefill.chunk_prefill_attention_plain,
        flash_attention.flash_attention_plain,
        decode_attention.decode_ring_plain,
        chunk_prefill.chunk_ring_plain,
    )


@contextlib.contextmanager
def _plain_attention(M):
    """Patch the model's attention calls and the int4 product to the plain
    versions (the reference forward of the full-model check; never the main
    path)."""
    from unittest import mock

    from cake_tpu_torch.ops import quant
    from cake_tpu_torch.ops.chunk_prefill import chunk_prefill_attention_plain
    from cake_tpu_torch.ops.decode_attention import decode_attention_plain
    from cake_tpu_torch.ops.flash_attention import flash_attention_plain
    from cake_tpu_torch.ops.int4_matmul import int4_matmul_plain

    with mock.patch.multiple(
        M,
        decode_attention=decode_attention_plain,
        chunk_prefill_attention=chunk_prefill_attention_plain,
        flash_attention=flash_attention_plain,
    ), mock.patch.object(quant, "int4_matmul", int4_matmul_plain):
        yield


@contextlib.contextmanager
def _routing(routes: list, record: bool):
    """MoE routing of a model check: record each router call's experts, or
    make the reference run take the recorded ones. The experts are a
    discrete choice: a router logit the attention kernels move by a bf16
    rounding can pick another expert for a token, so the reference runs
    the kernels' choices and the flips its own logits would make are
    counted (yielded as [count]), not compared."""
    from unittest import mock

    from cake_tpu_torch.ops import moe

    select = moe.route_topk_select
    flips = [0]

    def recorded(logits, top_k, norm_topk=True):
        topv, topi = select(logits, top_k, norm_topk)
        routes.append(topi)
        return topv, topi

    def replayed(logits, top_k, norm_topk=True):
        topi = routes.pop(0)
        flips[0] += int((select(logits, top_k, norm_topk)[1] != topi).any(-1).sum().item())
        topv = logits.float().softmax(-1).gather(-1, topi)
        if norm_topk:
            topv = topv / topv.sum(-1, keepdim=True)
        return topv, topi

    with mock.patch.object(moe, "route_topk_select", recorded if record else replayed):
        yield flips


def _full_model_check(torch, M, config, params, dev, phase: str = "full_model_check",
                      cache_dtype=None, chunks=(48, 32)) -> dict:
    """Full-width logits through the kernels against the same forward with
    the plain attention and int4 versions and, for a fused config, unfused
    (the composition each fused plain version is), on a short input
    (``chunks``: a prefill at 0 and continuation chunks, then two decode
    steps), over a bf16 cache or one of ``cache_dtype``."""
    from cake_tpu_torch.models.llama.cache import init_cache
    from cake_tpu_torch.ops.rope import model_rope_tables

    total = sum(chunks)
    max_seq = max(256, -(-(total + 2) // 256) * 256)
    rope = model_rope_tables(config, max_seq, dev)
    g = torch.Generator(device="cpu").manual_seed(5)
    inputs = [torch.randint(0, config.vocab_size, (1, n), generator=g).to(dev) for n in chunks]

    def run():
        kv = init_cache(config.num_hidden_layers, 1, max_seq, config.num_key_value_heads,
                        config.head_dim, cache_dtype or torch.bfloat16, dev)
        outs = []
        pos = 0
        with torch.inference_mode():
            for toks in inputs:
                n = toks.shape[1]
                logits, kv = M.forward(params, toks, kv, pos, n, config, cached_prefill=pos > 0,
                                       rope=rope)
                outs.append(logits)
                pos += n
            for _ in range(2):
                nxt = logits.argmax(-1)[:, None]
                logits, kv = M.forward(params, nxt, kv, pos, 1, config, rope=rope)
                outs.append(logits)
                pos += 1
        return torch.stack(outs)

    routes: list = []
    with _routing(routes, record=True):
        got = run()
    config = dataclasses.replace(config, fusion_impl="none")
    with _plain_attention(M), _routing(routes, record=False) as flips:
        want = run()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    cos = torch.nn.functional.cosine_similarity(got.flatten(1), want.flatten(1), dim=-1).min().item()
    row = {"phase": phase, "max_abs_err": err, "ref_max_abs": scale,
           "min_cosine": cos, "tol_rel": 0.05, "tol_cosine": 0.999}
    if config.num_local_experts:
        row["routing_flips"] = flips[0]
    emit(row)
    if not (torch.isfinite(got).all().item() and err <= 0.05 * scale and cos >= 0.999):
        raise AssertionError(f"full-model logits: {row}")
    return row


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _kernel_family(name: str) -> str:
    for kernel, family in (("norm_matmul_", "fused_norm_matmul"),
                           ("norm_rows_kernel", "fused_norm_matmul"),
                           ("ingest_kernel", "fused_qkv_ingest"),
                           ("tail_kernel", "fused_sample_tail"),
                           ("int4_mma_kernel", "int4_matmul"),
                           ("int4_wgmma_kernel", "int4_matmul"),
                           ("int4_f32_kernel", "int4_matmul"),
                           ("int4_reduce_kernel", "int4_matmul"),
                           ("threefry_noise_kernel", "threefry_noise")):
        if kernel in name:
            return family
    # split_decode_kernel (its splits' combine runs inside it) and chunk_kernel(_tc)
    # over the page pool, then over the dense cache.
    if "PagedLayout" in name:
        return "paged_decode_attention" if "decode_kernel" in name else "paged_chunk_attention"
    if "decode_kernel" in name:
        return "decode_attention"
    if "chunk_kernel" in name:
        return "chunk_prefill_attention"
    if any(s in name.lower() for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitk")):
        return "matmul"
    return "other"


TRACE_TRIES = 3  # traces traced_route takes at most


TRACE_WINDOW = "chip_smoke_window"
TRACE_PAD_S = 0.02  # host pause inside a trace's padding
PAD_KERNELS = 256  # small kernels that open and close every trace, outside its fences


def _fence(torch) -> None:
    """A spin kernel (``torch.cuda._sleep``: no path of the port launches
    one), waited for."""
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def _pad(torch) -> None:
    """PAD_KERNELS small kernels and a pause: a trace's first and last
    device events are these, never the fences or the call's."""
    x = torch.zeros(256, device="cuda")
    for _ in range(PAD_KERNELS):
        x.abs_()
    torch.cuda.synchronize()
    time.sleep(TRACE_PAD_S)


def _device_events(torch, run, warmup: bool = False) -> tuple[list | None, float | None]:
    """Run ``run`` under torch.profiler: (the kernels, memcpys and memsets
    of the exported trace that ran between two fences around the call, the
    clock offset in µs). With ``warmup``, ``run`` runs twice and only the
    second call is recorded (the first one starts the profiler's tracing).

    A trace can lack device events near its start and its end, and places
    device events by a clock that can sit ~100 µs off the host's (PERF.md,
    PR 9): work launched after the host's end of a call can fall inside the
    host's span of it. So a recorded call is padded and fenced on the
    device: padding (``_pad``), a spin kernel, the call and its synchronize
    (inside a ``record_function`` span, the host's window), a spin kernel,
    padding; only the device events between the two spin kernels, by the
    device's own timestamps, are the call's. The clock offset is the second
    fence's start less the host window's end (the fence is launched after
    it: a negative offset is the trace's clock running early). Returns
    (None, offset) where a fence is missing.

    Each event carries the thread of the runtime call that launched it
    ("launch_tid"; None where the trace holds no such call)."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    plan = schedule(wait=0, warmup=1, active=1, repeat=1) if warmup else None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], schedule=plan) as prof:
        for _ in range(2 if warmup else 1):
            _pad(torch)
            _fence(torch)
            with record_function(TRACE_WINDOW):
                run()
                torch.cuda.synchronize()
            _fence(torch)
            _pad(torch)
            if warmup:
                prof.step()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    fences = sorted(e["ts"] for e in device if "spin_kernel" in e.get("name", ""))
    window = [e for e in events
              if e.get("cat") == "user_annotation" and e.get("name") == TRACE_WINDOW]
    offset = fences[-1] - (window[-1]["ts"] + window[-1]["dur"]) if fences and window else None
    if len(fences) < 2:
        return None, offset
    launcher = {e["args"]["correlation"]: e.get("tid") for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    device = [e for e in device if fences[0] < e["ts"] < fences[-1]]
    for e in device:
        e["launch_tid"] = launcher.get(e.get("args", {}).get("correlation"))
    return device, offset


# The redesigned kernels' bodies by the name of their kernel, and the
# instructions each runs its products on (chunk_kernel_tc before
# chunk_kernel, whose name it contains).
BODY_ROUTES = (("int4_wgmma_kernel", "wgmma"), ("int4_mma_kernel", "mma.sync"),
               ("int4_f32_kernel", "CUDA cores"), ("chunk_kernel_tc", "mma.sync"),
               ("chunk_kernel", "CUDA cores"), ("split_decode_kernel", "CUDA cores"),
               ("norm_matmul_swap_ab_kernel", "wgmma"), ("norm_matmul_ws_kernel", "wgmma"),
               ("norm_matmul_kernel", "CUDA cores"), ("ingest_kernel", "CUDA cores"),
               ("tail_kernel", "CUDA cores"), ("grouped_ws_kernel", "wgmma"),
               ("grouped_swap_kernel", "wgmma"))


def kernel_route(names) -> str | None:
    """The instructions of the redesigned bodies among kernel ``names``
    (several joined by "+"), or None where none of them ran."""
    routes = {next((r for k, r in BODY_ROUTES if k in n), None) for n in names} - {None}
    return "+".join(sorted(routes)) or None


def traced_route(torch, run) -> str | None:
    """The instructions one call of ``run`` ran on, read from the names of
    the kernels its trace records; None where no trace of TRACE_TRIES held
    a redesigned body's kernel. Each trace records a second call, after a
    warm-up call that starts the tracing, with the allocator's cached blocks
    released first (single-call traces at the engine's operands came back
    without their kernel: PERF.md, section 7)."""
    torch.cuda.empty_cache()
    for _ in range(TRACE_TRIES):
        events = _device_events(torch, run, warmup=True)[0] or []
        names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
        route = kernel_route(names)
        if route is not None:
            return route
    # What the last trace held, for the open question in PERF.md section 7.
    free, total = torch.cuda.mem_get_info()
    emit({"phase": "trace_miss", "seconds_into_run": time.perf_counter() - STARTED,
          "device_events": len(events), "kernels": sorted({n.split("(")[0] for n in names}),
          "free_mib": free / 2**20, "total_mib": total / 2**20})
    return None


# The kernel each wrapper launches once a call (its counter's unit): the
# norm-matmul bodies (not norm_rows_kernel, which runs before the tensor-core
# ones), the int4 bodies (not the split-K reduce), and the attention bodies
# over the page pool or the dense cache.
KERNEL_WRAPPERS = ("decode_attention", "paged_decode_attention", "chunk_prefill_attention",
                   "paged_chunk_attention", "fused_norm_matmul", "fused_qkv_ingest",
                   "fused_sample_tail", "int4_matmul", "threefry_noise")
_LAUNCH_KERNELS = (("norm_matmul_", "fused_norm_matmul"), ("ingest_kernel", "fused_qkv_ingest"),
                   ("tail_kernel", "fused_sample_tail"), ("int4_mma_kernel", "int4_matmul"),
                   ("int4_wgmma_kernel", "int4_matmul"), ("int4_f32_kernel", "int4_matmul"),
                   ("threefry_noise_kernel", "threefry_noise"))


def launch_of(name: str) -> str | None:
    """The wrapper whose one launch kernel ``name`` is, or None."""
    for kernel, wrapper in _LAUNCH_KERNELS:
        if kernel in name:
            return wrapper
    paged = "PagedLayout" in name
    if "split_decode_kernel" in name:
        return "paged_decode_attention" if paged else "decode_attention"
    if "chunk_kernel" in name:
        return "paged_chunk_attention" if paged else "chunk_prefill_attention"
    return None


def launches_seen(events) -> dict:
    """Each wrapper's launch kernels among a trace's device events."""
    seen = dict.fromkeys(KERNEL_WRAPPERS, 0)
    for e in events:
        wrapper = launch_of(e.get("name", "")) if e.get("cat") == "kernel" else None
        if wrapper is not None:
            seen[wrapper] += 1
    return seen


PROFILE_TRIES = 4  # traces _complete_trace takes at most


def _complete_trace(torch, run, setup=None, expect=None,
                    valid=None) -> tuple[list, int, float | None]:
    """(device events, tries, clock offset µs) of the first of PROFILE_TRIES traces of
    ``run`` that holds every launch: each wrapper's launch kernels as many
    as its counter grew by over the call (``expect`` instead, where the
    call counts nothing, as a bare graph replay). A replayed decode chunk
    adds its capture's counts (ops/launches.py); the trace sees the
    replay's kernels themselves, so the two counts are independent.

    A trace that lacks a launch or a fence (``_device_events``), that
    captured a graph (its warm-up's launches are not counted, and a
    capture is no part of what is measured), or whose ``run`` returned what
    ``valid`` refuses (a wave the engine split over two epochs) is emitted
    ("trace_incomplete") and taken again, after ``setup`` (which puts back
    what ``run`` changed). Raises when no trace is complete, or when one
    holds launches the counters did not see without a capture."""
    from cake_tpu_torch.models.llama import fused

    counters = _paged_counters()
    for tries in range(1, PROFILE_TRIES + 1):
        if setup is not None:
            setup()
        before, captures = _counts(counters), fused.STATS["captures"]
        out = []
        events, offset = _device_events(torch, lambda: out.append(run()))
        after = _counts(counters)
        captured = fused.STATS["captures"] - captures
        seen = launches_seen(events or [])
        counted = expect or {w: after[w] - before[w] for w in KERNEL_WRAPPERS}
        kept = valid is None or valid(out[0])
        if events is not None and seen == counted and not captured and kept:
            return events, tries, offset
        row = {"phase": "trace_incomplete", "try": tries,
               "device_events": None if events is None else len(events),
               "launch_kernels": seen, "counted": counted, "clock_offset_us": offset,
               "seconds_into_run": time.perf_counter() - STARTED,
               "captures_inside": captured, "valid": kept}
        emit(row)
        if not captured and any(seen[w] > counted[w] for w in KERNEL_WRAPPERS):
            raise AssertionError(f"a trace holds launches the counters did not see: {row}")
    raise AssertionError(f"no complete trace in {PROFILE_TRIES}: {row}")


def _one_epoch(wave: dict) -> bool:
    """A profiled wave the engine served as one epoch, no join."""
    return wave["batches"] == 1 and wave["joins"] == 0


def _device_profile(torch, run, setup=None, valid=None) -> dict:
    """Run ``run`` under torch.profiler (``_complete_trace``: the launch
    counters held to the trace's kernels) and sum the device time of its
    kernels, memcpys and memsets by family (ms), from the exported trace;
    "names" counts the events by name and "launchers" by the thread that
    launched them, for ``ops_diff``."""
    events, tries, offset = _complete_trace(torch, run, setup, valid=valid)
    by_family: dict[str, float] = {}
    for e in events:
        cat = e.get("cat")
        fam = _kernel_family(e.get("name", "")) if cat == "kernel" else cat
        by_family[fam] = by_family.get(fam, 0.0) + e.get("dur", 0.0) / 1e3
    return {"device_ms": sum(by_family.values()), "device_ops": len(events),
            "by_family_ms": by_family, "launches_seen": launches_seen(events),
            "trace_tries": tries, "clock_offset_us": offset, "names": _tally(events, "name"),
            "launchers": _tally(events, "launch_tid")}


def _minus(a: dict, b: dict) -> dict:
    """Tally ``a`` less tally ``b``, key by key (negative counts kept)."""
    return {k: a.get(k, 0) - b.get(k, 0) for k in set(a) | set(b)}


def ops_diff(a: dict, b: dict) -> dict:
    """Where two event tallies (a profile's "names" or "launchers", or
    differences of them) part: {key: [count in a, count in b]}."""
    return {k: [a.get(k, 0), b.get(k, 0)] for k in sorted(set(a) | set(b))
            if a.get(k, 0) != b.get(k, 0)}


def _profile_main_path(torch, gen, text: str, decode_ms_per_token: float | None,
                       phase: str = "profile") -> dict:
    """Device time of one prefill and of 16 decode steps, by kernel family,
    beside the unprofiled decode time per token (the device idle share)."""
    from cake_tpu_torch.models.llama.chat import Message

    n_decode = 16

    def fresh(prefilled: bool) -> None:
        gen.reset()
        gen.add_message(Message.user(text))
        if prefilled:
            gen.generate(1)

    prefill = _device_profile(torch, lambda: gen.generate(1), setup=lambda: fresh(False))
    decode = _device_profile(torch, lambda: gen.generate(n_decode), setup=lambda: fresh(True))
    per_token = {k: v / n_decode for k, v in decode["by_family_ms"].items()}
    busy = decode["device_ms"] / n_decode
    row = {
        "phase": phase,
        "prefill_device_ms": prefill["device_ms"],
        "prefill_device_ops": prefill["device_ops"],
        "prefill_by_family_ms": prefill["by_family_ms"],
        "decode_tokens": n_decode,
        "decode_device_ms_per_token": busy,
        "decode_device_ops_per_token": decode["device_ops"] / n_decode,
        "decode_launches_seen": decode["launches_seen"],
        "trace_tries": [prefill["trace_tries"], decode["trace_tries"]],
        "clock_offset_us": [prefill["clock_offset_us"], decode["clock_offset_us"]],
        "decode_by_family_ms_per_token": per_token,
        "decode_wall_ms_per_token": decode_ms_per_token,
        "decode_device_idle_share": (
            1.0 - busy / decode_ms_per_token if decode_ms_per_token and busy else None
        ),
    }
    emit(row)
    return row | {"decode_names": decode["names"], "decode_launchers": decode["launchers"]}


def phase_generate(torch, card: str, dev=None, config=None) -> dict:
    """``dev``/``config`` default to the card and Llama-3-8B; a CPU run at a
    tiny config rehearses the phase's control flow without a card."""
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.chat import Message
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import (
        LlamaGenerator, LocalForwardStep, SamplingConfig,
    )
    from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
    from cake_tpu_torch.ops.fuse import fuse_params

    dev = torch.device("cuda") if dev is None else dev
    config = LlamaConfig() if config is None else config  # Llama-3-8B widths and depth
    t0 = time.perf_counter()
    params = fuse_params(M.init_params(
        config, torch.Generator(device=dev).manual_seed(0), torch.bfloat16, dev
    ))
    _sync(torch, dev)
    init_s = time.perf_counter() - t0
    weight_bytes = M.count_params(params) * 2
    step = LocalForwardStep(
        config, params, max_seq_len=MAX_SEQ, cache_dtype=torch.bfloat16, device=dev
    )
    gen = LlamaGenerator(
        config, step, ByteTokenizer(),
        SamplingConfig(temperature=0.0, repeat_penalty=1.0), prefill_chunk=PREFILL_CHUNK,
    )
    sentence = "The quick brown fox jumps over the lazy dog while the cake cools. "
    text = (sentence * 20)[: PROMPT_TOKENS - 23]  # the llama3 template adds 23 tokens

    gen.add_message(Message.user(text))
    gen.generate(4)  # warm-up: cuBLAS handles, allocator, kernel library
    _sync(torch, dev)

    counters = _counters()
    for c in counters:
        c.launches = 0
    gen.reset()
    gen.add_message(Message.user(text))
    stamps = []
    t_start = time.perf_counter()
    gen.generate(DECODE_TOKENS, on_token=lambda tok: stamps.append(time.perf_counter()))
    _sync(torch, dev)
    t_end = time.perf_counter()
    launches = {c.__name__: c.launches for c in counters}

    n_prompt, n_gen = gen.prompt_tokens, gen.generated_count
    n_chunks = -(-n_prompt // PREFILL_CHUNK)
    n_layers = config.num_hidden_layers
    if dev.type == "cuda":  # every attention call launches a kernel
        expected = {
            "decode_attention": n_layers * (n_gen - 1),
            "chunk_prefill_attention": n_layers * n_chunks,
            "decode_attention_plain": 0,
            "chunk_prefill_attention_plain": 0,
            "flash_attention_plain": 0,
            "decode_ring_plain": 0,
            "chunk_ring_plain": 0,
        }
    else:  # a CPU rehearsal: every call takes the plain version
        expected = {
            "decode_attention": 0,
            "chunk_prefill_attention": 0,
            "decode_attention_plain": n_layers * (n_gen - 1),
            "chunk_prefill_attention_plain": n_layers * (n_chunks - 1),
            "flash_attention_plain": n_layers,
            "decode_ring_plain": 0,
            "chunk_ring_plain": 0,
        }
    ids = gen.generated_token_ids
    prefill_s = stamps[0] - t_start
    decode_s = (stamps[-1] - stamps[0]) if n_gen > 1 else float("nan")
    gaps_ms = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
    # The spread of prefill: the same prompt again, timed to its first token.
    prefill_repeats_s = []
    for _ in range(4):
        gen.reset()
        gen.add_message(Message.user(text))
        t0 = time.perf_counter()
        gen.generate(1)
        _sync(torch, dev)
        prefill_repeats_s.append(time.perf_counter() - t0)
    row = {
        "phase": "generate",
        "card": card,
        "model": (
            f"hidden {config.hidden_size}, {n_layers} layers, {config.num_attention_heads}/"
            f"{config.num_key_value_heads} heads, inter {config.intermediate_size}, vocab "
            f"{config.vocab_size}; random bf16 weights (seed 0)"
        ),
        "layers": n_layers,
        "weights_gb": weight_bytes / 1e9,
        "init_s": init_s,
        "prompt_tokens": n_prompt,
        "prefill_chunks": n_chunks,
        "generated_tokens": n_gen,
        "finish_reason": gen.last_finish_reason,
        "prefill_s": prefill_s,
        "prefill_tok_s": n_prompt / prefill_s,
        "prefill_repeats_s": prefill_repeats_s,
        "decode_s": decode_s,
        "decode_tok_s": (n_gen - 1) / decode_s if n_gen > 1 else None,
        "decode_ms_per_token": 1e3 * decode_s / (n_gen - 1) if n_gen > 1 else None,
        # Token gaps: the median and the 80th percentile (12 of 63 gaps above it).
        "decode_gap_ms_p50": gaps_ms[len(gaps_ms) // 2] if gaps_ms else None,
        "decode_gap_ms_p80": gaps_ms[int(0.8 * len(gaps_ms))] if gaps_ms else None,
        "decode_bound_ms_per_token": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "wall_s": t_end - t_start,
        "launches": launches,
        "expected_launches": expected,
        "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None,
    }
    emit(row)
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != expected {expected}")
    if n_gen < 1 or not all(0 <= t < config.vocab_size for t in ids):
        raise AssertionError(f"generated ids out of range: {ids}")
    if dev.type == "cuda":
        row["profile"] = _profile_main_path(torch, gen, text, row["decode_ms_per_token"])
    row["check"] = _full_model_check(torch, M, config, step.params, dev)
    row["generator"] = gen
    row["text"] = text
    row["generated_ids"] = ids
    return row


# ---------------------------------------------------------------- phase 5


def _post(port: int, body: dict) -> tuple[int, str]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/api/v1/chat/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _check_usage(usage: dict, max_tokens: int) -> None:
    if not (usage["prompt_tokens"] > 0 and 1 <= usage["completion_tokens"] <= max_tokens
            and usage["total_tokens"] == usage["prompt_tokens"] + usage["completion_tokens"]):
        raise AssertionError(f"bad usage {usage}")


def phase_api(main_path: dict) -> None:
    """Serve the generate phase's generator."""
    import threading

    from cake_tpu_torch.runtime.api import ApiServer

    api =ApiServer(main_path["generator"], default_max_tokens=16)
    server = api.make_server("127.0.0.1", 0)
    port = server.server_port
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    results = []
    try:
        msgs = [{"role": "user", "content": "Name three colours of cake icing."}]
        t0 = time.perf_counter()
        status, body = _post(port, {"messages": msgs, "max_tokens": 16})
        reply = json.loads(body)
        if status != 200 or reply["choices"][0]["finish_reason"] not in ("stop", "length"):
            raise AssertionError(f"json chat: {status} {body[:500]}")
        _check_usage(reply["usage"], 16)
        results.append({"kind": "json", "status": status, "s": time.perf_counter() - t0,
                        "finish_reason": reply["choices"][0]["finish_reason"],
                        "usage": reply["usage"]})

        t0 = time.perf_counter()
        status, body = _post(port, {"messages": msgs, "max_tokens": 16, "stream": True,
                                    "stream_options": {"include_usage": True}})
        events = [line[6:] for line in body.splitlines() if line.startswith("data: ")]
        if status != 200 or not events or events[-1] != "[DONE]":
            raise AssertionError(f"sse chat: {status} {body[:500]}")
        chunks = [json.loads(e) for e in events[:-1]]
        if any("error" in c for c in chunks):
            raise AssertionError(f"sse chat reported an error: {chunks}")
        finish = [c["choices"][0]["finish_reason"] for c in chunks
                  if c.get("choices") and c["choices"][0]["finish_reason"]]
        if finish[-1:] not in (["stop"], ["length"]) or "usage" not in chunks[-1]:
            raise AssertionError(f"sse chat without finish/usage: {chunks[-2:]}")
        _check_usage(chunks[-1]["usage"], 16)
        results.append({"kind": "sse", "status": status, "s": time.perf_counter() - t0,
                        "events": len(events), "finish_reason": finish[-1],
                        "usage": chunks[-1]["usage"]})

        t0 = time.perf_counter()
        status, body = _post(port, {"messages": msgs, "max_tokens": 16,
                                    "temperature": 0.8, "top_k": 50, "seed": 7})
        reply = json.loads(body)
        if status != 200 or reply["choices"][0]["finish_reason"] not in ("stop", "length"):
            raise AssertionError(f"sampled chat: {status} {body[:500]}")
        _check_usage(reply["usage"], 16)
        results.append({"kind": "sampled", "status": status, "s": time.perf_counter() - t0,
                        "finish_reason": reply["choices"][0]["finish_reason"],
                        "usage": reply["usage"]})
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("api server thread did not stop")
    emit({"phase": "api", "requests": results})


# ---------------------------------------------------------------- phase 6


def _fused_counters():
    from cake_tpu_torch.ops import fused_ingest, fused_norm_matmul, fused_sample_tail, threefry

    return (
        fused_norm_matmul.fused_norm_matmul,
        fused_norm_matmul.fused_norm_matmul_plain,
        fused_ingest.fused_qkv_ingest,
        fused_ingest.fused_qkv_ingest_plain,
        fused_sample_tail.fused_sample_tail,
        fused_sample_tail.fused_sample_tail_plain,
        threefry.threefry_noise,
        threefry.threefry_noise_plain,
    )


def _paged_counters():
    from cake_tpu_torch.ops import int4_matmul, moe, paged_attention, paged_prefill

    return _counters() + (
        paged_attention.paged_decode_attention,
        paged_prefill.paged_chunk_attention,
        paged_attention.paged_decode_attention_plain,
        paged_prefill.paged_chunk_attention_plain,
    ) + _fused_counters() + (int4_matmul.int4_matmul, int4_matmul.int4_matmul_plain,
                             moe.grouped_matmul, moe.grouped_matmul_plain)


# Side counts a wrapper keeps beside its launches: calls it left to the
# unfused composition, calls it routed to qmat for a quantized weight,
# launches over an f8 cache, launches over a rolling ring.
_SIDE_COUNTS = ("unfused", "quantized", "f8", "ring")


def _zero_counters():
    counters = _paged_counters()
    for c in counters:
        c.launches = 0
        for side in _SIDE_COUNTS:
            if hasattr(c, side):
                setattr(c, side, 0)
    return counters


def _counts(counters) -> dict:
    """Each counter's launches, and its side counts (``name.unfused``,
    ``name.quantized``)."""
    out = {c.__name__: c.launches for c in counters}
    out.update({f"{c.__name__}.{side}": getattr(c, side)
                for c in counters for side in _SIDE_COUNTS if hasattr(c, side)})
    return out


def _expected_launches(counters, waves, decode: str, chunk: str, n_layers: int, on_card: bool):
    """(launches, expected) after ``waves``: n_layers per decode step on the
    decode kernel and per prefill (epoch starts and joins) on the chunk
    kernel, or on their plain versions off the card; every other count 0."""
    launches = _counts(counters)
    expected = dict.fromkeys(launches, 0)
    suffix = "" if on_card else "_plain"
    expected[decode + suffix] = n_layers * sum(w["decode_steps"] for w in waves)
    expected[chunk + suffix] = n_layers * sum(w["batches"] + w["joins"] for w in waves)
    return launches, expected


# batch.py's attention calls: the positional index of each int32 operand.
_RECORDED = {
    "decode_attention": {"lengths": 3, "starts": 4},
    "chunk_prefill_attention": {"q_starts": 3, "lengths": 4, "k_starts": 6},
    "paged_decode_attention": {"lengths": 3, "starts": 5},
    "paged_chunk_attention": {"q_starts": 3, "lengths": 4, "k_starts": 5},
}
_TABLE_ARG = {"paged_decode_attention": 4, "paged_chunk_attention": 6}


@contextlib.contextmanager
def recording(decode_call: int):
    """Record the operands the engine hands batch.py's attention wrappers:
    each chunk kernel's first call and each decode kernel's call number
    ``decode_call`` (0-based). Yields {kernel: operands}; read it with
    ``dispatch_shapes`` once the wave is over. The wrappers underneath
    launch, and count their launches, as they do without it."""
    from unittest import mock

    from cake_tpu_torch.models.llama import batch as B

    seen: dict = {}
    calls = dict.fromkeys(_RECORDED, -1)

    def wrap(name, fn):
        pick = decode_call if "decode" in name else 0

        def call(*args, **kw):
            calls[name] += 1
            if calls[name] == pick:
                rec = {"q": tuple(args[0].shape), "kv": tuple(args[1].shape)}
                rec.update({k: args[i].clone() for k, i in _RECORDED[name].items()})
                if name in _TABLE_ARG:
                    rec["n_p"] = args[_TABLE_ARG[name]].shape[1]
                seen[name] = rec
            return fn(*args, **kw)

        return call

    with mock.patch.multiple(B, **{n: wrap(n, getattr(B, n)) for n in _RECORDED}):
        yield seen


def dispatch_shapes(seen: dict) -> dict:
    """``recording``'s operands as plain lists."""
    return {name: {k: v.tolist() if hasattr(v, "tolist") else v for k, v in rec.items()}
            for name, rec in seen.items()}


def _wave(engine, n_tokens, messages=None, samplings=None, together: bool = False,
          submit_kw=None) -> dict:
    """Submit one wave of concurrent requests (greedy, or one
    ``samplings`` entry each; ``n_tokens`` out, or one entry each; more
    ``submit`` keywords, one dict each, in ``submit_kw``), read every
    stream, and wait for the epoch to end. ``together``: the engine's
    lock is held while the wave is submitted, so a running engine admits it
    as one group, as one not yet started does (the continuous scheduler
    has no admission window to gather a burst). TTFT is the engine's submit-to-first-token time; decode tok/s
    counts the tokens after each stream's first over the engine's
    decode-chunk wall time (device work plus the chunk's readback)."""
    from cake_tpu_torch.models.llama.generator import SamplingConfig

    messages = messages or engine_messages()
    samplings = samplings or [SamplingConfig(temperature=0.0, repeat_penalty=1.0)] * len(messages)
    before = dict(engine.stats)
    t0 = time.perf_counter()
    budgets = n_tokens if isinstance(n_tokens, list) else [n_tokens] * len(messages)
    submit_kw = submit_kw or [{}] * len(messages)
    with engine._cv if together else contextlib.nullcontext():
        handles = [engine.submit(m, n, s, **kw)
                   for m, n, s, kw in zip(messages, budgets, samplings, submit_kw)]
        engine.start()
    streams = [[t.id for t in h.tokens()] for h in handles]
    wall = time.perf_counter() - t0
    if not engine.wait_idle(600):
        raise AssertionError("the engine did not go idle after a wave")
    after = engine.snapshot()
    delta = {k: after[k] - before[k] for k in (
        "batches", "joins", "decode_s", "decode_steps", "decode_chunks", "prefill_s",
        "prefix_hits", "prefix_misses", "preemptions", "restores", "page_truncations",
        "budget_deferrals", "deadline_expired", "stream_errors",
    )}
    ttft = [h.ttft_s for h in handles if h.ttft_s is not None]
    decoded = sum(max(0, h.completion_tokens - 1) for h in handles)
    return {
        "streams": streams, "wall_s": wall, "request_ids": [h.request_id for h in handles],
        "ttft_p50_s": statistics.median(ttft) if ttft else None,
        "ttft_max_s": max(ttft, default=None),
        "completion_tokens": [h.completion_tokens for h in handles],
        "finish_reasons": [h.finish_reason for h in handles],
        "decode_tok_s": decoded / delta["decode_s"] if delta["decode_s"] else None,
        "decode_ms_per_step": (
            1e3 * delta["decode_s"] / delta["decode_steps"] if delta["decode_steps"] else None
        ),
        "aggregate_tok_s": sum(h.completion_tokens for h in handles) / wall,
        **delta,
    }


def _batch_model_check(torch, config, params, dev, kv_mode: str, phase: str | None = None,
                       cache_dtype=None) -> dict:
    """The full-width lockstep forward through the kernels against the same
    forward with the attention kernels' plain versions, unfused (the
    composition each fused plain version is): paged (a cold prefill
    through the block tables, a suffix window over it, two decode steps) or
    dense (a left-padded prefill, two decode steps)."""
    from unittest import mock

    from cake_tpu_torch.models.llama import batch as B
    from cake_tpu_torch.models.llama.cache import init_cache
    from cake_tpu_torch.models.llama.paged_cache import PageAllocator, init_paged_cache
    from cake_tpu_torch.ops.chunk_prefill import chunk_prefill_attention_plain
    from cake_tpu_torch.ops.decode_attention import decode_attention_plain
    from cake_tpu_torch.ops.paged_attention import paged_decode_attention_plain
    from cake_tpu_torch.ops.paged_prefill import paged_chunk_attention_plain
    from cake_tpu_torch.ops.rope import model_rope_tables

    g = torch.Generator().manual_seed(6)
    ids = [torch.randint(0, config.vocab_size, (n,), generator=g).tolist() for n in (48, 30)]
    tokens, pads, bucket = B.layout_prompts(ids, 256)
    alloc = PageAllocator(4, ENGINE_PAGE, 2, 2)
    for r, p in enumerate(pads):
        alloc.map_range(r, int(p), 256)
    tables = torch.as_tensor(alloc.block_tables).to(dev)
    pads_t = torch.as_tensor(pads).to(dev)
    tokens_t = torch.as_tensor(tokens).long().to(dev)
    feed = torch.randint(0, config.vocab_size, (2, 2), generator=g).to(dev)
    rope = model_rope_tables(config, 256, dev)
    start = bucket - 16

    def run_paged():
        kv = init_paged_cache(config.num_hidden_layers, 4, config.num_key_value_heads,
                              ENGINE_PAGE, config.head_dim, cache_dtype or torch.bfloat16, dev)
        with torch.inference_mode():
            logits, kv = B.paged_prefill(params, tokens_t, kv, pads_t, tables, config, rope=rope)
            outs = [logits]
            ws = torch.full((2,), start, dtype=torch.int32, device=dev)
            logits, kv = B.paged_suffix_prefill(params, tokens_t[:, start:], kv, pads_t, ws,
                                                tables, config, start, rope=rope)
            outs.append(logits)
            fwd = B.paged_forward_one(params, pads_t, tables, config, rope)
            for i in range(2):
                logits, kv = fwd(feed[:, i : i + 1], kv, bucket + i)
                outs.append(logits)
        return torch.stack(outs)

    def run_dense():
        kv = init_cache(config.num_hidden_layers, 2, 256, config.num_key_value_heads,
                        config.head_dim, cache_dtype or torch.bfloat16, dev)
        with torch.inference_mode():
            logits, kv = B.batched_prefill(params, tokens_t, kv, pads_t, config, rope=rope)
            outs = [logits]
            fwd = B.batched_forward_one(params, pads_t, config, rope)
            for i in range(2):
                logits, kv = fwd(feed[:, i : i + 1], kv, bucket + i)
                outs.append(logits)
        return torch.stack(outs)

    if kv_mode == "paged":
        run = run_paged
        plains = {"paged_decode_attention": paged_decode_attention_plain,
                  "paged_chunk_attention": paged_chunk_attention_plain}
    else:
        run = run_dense
        plains = {"decode_attention": decode_attention_plain,
                  "chunk_prefill_attention": chunk_prefill_attention_plain}
    got = run()
    config = dataclasses.replace(config, fusion_impl="none")
    with mock.patch.multiple(B, **plains):
        want = run()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    cos = torch.nn.functional.cosine_similarity(got.flatten(1), want.flatten(1), dim=-1).min().item()
    row = {"phase": phase or f"{kv_mode}_model_check", "max_abs_err": err, "ref_max_abs": scale,
           "min_cosine": cos, "tol_rel": 0.05, "tol_cosine": 0.999}
    emit(row)
    if not (torch.isfinite(got).all().item() and err <= 0.05 * scale and cos >= 0.999):
        raise AssertionError(f"{kv_mode} full-model logits: {row}")
    return row


def phase_engine(torch, main_path: dict) -> dict:
    """Serve three waves through the paged engine over the generate phase's
    weights (no second copy), two through the dense engine, then the
    profile and the full-width forward checks. Returns the row, with the
    running paged engine under "engine" and the operands recorded from
    each engine's first wave under "dispatches"."""
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    gen = main_path["generator"]
    config, params, dev = gen.config, gen.step.params, gen.step.device
    n_layers = config.num_hidden_layers
    on_card = dev.type == "cuda"
    mid_decode = n_layers * (ENGINE_TOKENS // 2)  # layer 0 of a mid-wave decode step

    def make(**kw):
        # ServeConfig's admission window: the one the CLI serves with.
        serve = ServeConfig(max_batch=ENGINE_BATCH, decode_chunk_size=8, **kw)
        eng = BatchEngine(config, params, gen.tokenizer, max_seq_len=ENGINE_MAX_SEQ,
                          cache_dtype=torch.bfloat16, serve=serve, device=dev)
        eng.start()
        return eng

    def strip(w):
        return {k: v for k, v in w.items() if k != "streams"}

    def equal(a, b):
        return sum(x == y for x, y in zip(a["streams"], b["streams"]))

    engine = make(kv_mode="paged", page_size=ENGINE_PAGE, prefix_cache=True)
    # Warm-up on other prompts of wave 1's shapes (their chains do not serve
    # the waves' prefix): it captures the decode chunks' graphs.
    _wave(engine, ENGINE_TOKENS, warm_messages())
    counters = _zero_counters()
    # Wave 1's decode chunks run their loops op by op (eager_chunks): a
    # replay calls no wrapper, and the recorder reads the operands at the
    # wrapper's call. Waves 2 and 3 replay the chunks' graphs.
    with recording(mid_decode) as seen, eager_chunks():
        waves = [_wave(engine, ENGINE_TOKENS)]
    dispatches = {"paged": dispatch_shapes(seen)}
    waves.append(_wave(engine, ENGINE_TOKENS))
    waves.append(_wave(engine, ENGINE_TOKENS, engine_messages(RAGGED_TURNS)))
    launches, expected = _expected_launches(
        counters, waves, "paged_decode_attention", "paged_chunk_attention", n_layers, on_card
    )

    dense = make()
    try:
        _wave(dense, ENGINE_TOKENS, warm_messages())
        counters = _zero_counters()
        with recording(mid_decode) as seen, eager_chunks():
            dense_waves = [_wave(dense, ENGINE_TOKENS)]
        dispatches["dense"] = dispatch_shapes(seen)
        dense_waves.append(_wave(dense, ENGINE_TOKENS, engine_messages(RAGGED_TURNS)))
        dense_launches, dense_expected = _expected_launches(
            counters, dense_waves, "decode_attention", "chunk_prefill_attention", n_layers,
            on_card,
        )
    finally:
        dense.stop()
    del dense
    if on_card:
        torch.cuda.empty_cache()
    # The profile: one short wave unprofiled (its wall time), then the same
    # wave under torch.profiler (its device time by kernel family). The
    # engine sleeps one admission window before the wave's epoch: not idle
    # time of the device's making, so the share leaves it out. A wave first
    # captures the decode chunks' graphs of its epoch capacity.
    _wave(engine, 16)
    timed = _wave(engine, 16)
    profile = (_device_profile(torch, lambda: _wave(engine, 16), valid=_one_epoch)
               if on_card else None)
    if profile:
        profile = {k: v for k, v in profile.items() if k not in ("names", "launchers")}
    busy = profile["device_ms"] if profile else None
    window_ms = 1e3 * engine.admission_window
    row = {
        "phase": "engine",
        "card": main_path["card"],
        "config": {"kv_mode": "paged", "page_size": ENGINE_PAGE, "max_seq": ENGINE_MAX_SEQ,
                   "max_batch": ENGINE_BATCH, "prefix_cache": True, "decode_chunk": 8,
                   "admission_window_s": engine.admission_window,
                   "tokens_out": ENGINE_TOKENS, "layers": n_layers},
        "waves": [strip(w) for w in waves],
        "prefix_hits_wave2": waves[1]["prefix_hits"],
        "launches": launches,
        "expected_launches": expected,
        "dense_waves": [strip(w) for w in dense_waves],
        "dense_launches": dense_launches,
        "dense_expected_launches": dense_expected,
        "dense_equal_streams": equal(dense_waves[0], waves[0]),
        "ragged_dense_equal_streams": equal(dense_waves[1], waves[2]),
        "wave2_equal_streams": equal(waves[1], waves[0]),
        "dispatches": dispatches,
        "profile_wave_wall_ms": 1e3 * timed["wall_s"],
        "profile": profile,
        "device_idle_share": (
            1.0 - busy / (1e3 * timed["wall_s"] - window_ms) if busy else None
        ),
        "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
        "pool_bytes": 2 * engine.backend._pool.k.numel() * engine.backend._pool.k.element_size(),
    }
    emit(row)
    if launches != expected:
        raise AssertionError(f"engine launch counts {launches} != expected {expected}")
    if dense_launches != dense_expected:
        raise AssertionError(
            f"dense engine launch counts {dense_launches} != expected {dense_expected}"
        )
    if waves[1]["prefix_hits"] <= 0:
        raise AssertionError("wave 2 took no prefix-cache hit")
    # Wave 2 repeats wave 1's prompts over its cached prefix: the warm
    # suffix prefill must give the cold prefill's streams (the chunk body
    # places key tiles by key position, so a query's sums do not move).
    if row["wave2_equal_streams"] != ENGINE_BATCH:
        raise AssertionError(
            f"warm wave 2 streams equal cold wave 1's {row['wave2_equal_streams']}/{ENGINE_BATCH}")
    if waves[2]["joins"] <= 0 or dense_waves[1]["joins"] <= 0:
        raise AssertionError("the ragged wave drove no join")
    for w in waves + dense_waves:
        if not all(1 <= len(ids) <= ENGINE_TOKENS and all(0 <= t < config.vocab_size for t in ids)
                   for ids in w["streams"]):
            raise AssertionError(f"engine streams out of range: {w['completion_tokens']}")
    row["check"] = _batch_model_check(torch, config, params, dev, "paged")
    row["dense_check"] = _batch_model_check(torch, config, params, dev, "dense")
    row["failover"] = _engine_failover_local(torch, main_path)
    row["engine"] = engine
    return row


# ---------------------------------------------------------------- phase 7


def phase_api_engine(main_path: dict, engine_path: dict) -> None:
    """The ApiServer with the engine answers 4 concurrent SSE chats; each
    gets its own stream and a correct usage block. Stops the engine."""
    from cake_tpu_torch.runtime.api import ApiServer

    api = ApiServer(main_path["generator"], default_max_tokens=16, engine=engine_path["engine"])
    server = api.make_server("127.0.0.1", 0)
    port = server.server_port
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    replies: dict[int, tuple] = {}

    def client(i: int) -> None:
        msgs = [{"role": "system", "content": SYSTEM_PROMPT},
                {"role": "user", "content": USER_TURNS[i]}]
        replies[i] = _post(port, {"messages": msgs, "max_tokens": 16, "stream": True,
                                  "stream_options": {"include_usage": True}})

    t0 = time.perf_counter()
    try:
        clients = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        if any(c.is_alive() for c in clients) or len(replies) != 4:
            raise AssertionError("api_engine: a client did not finish")
        results = []
        for i, (status, body) in sorted(replies.items()):
            events = [line[6:] for line in body.splitlines() if line.startswith("data: ")]
            if status != 200 or not events or events[-1] != "[DONE]":
                raise AssertionError(f"api_engine chat {i}: {status} {body[:500]}")
            chunks = [json.loads(e) for e in events[:-1]]
            ids = {c["id"] for c in chunks}
            if any("error" in c for c in chunks) or len(ids) != 1:
                raise AssertionError(f"api_engine chat {i}: {chunks[:3]}")
            finish = [c["choices"][0]["finish_reason"] for c in chunks
                      if c.get("choices") and c["choices"][0]["finish_reason"]]
            if finish[-1:] not in (["stop"], ["length"]) or "usage" not in chunks[-1]:
                raise AssertionError(f"api_engine chat {i} without finish/usage: {chunks[-2:]}")
            _check_usage(chunks[-1]["usage"], 16)
            results.append({"id": ids.pop(), "finish_reason": finish[-1],
                            "usage": chunks[-1]["usage"]})
        if len({r["id"] for r in results}) != 4:
            raise AssertionError("api_engine: streams share an id")
    finally:
        server.shutdown()
        server.server_close()
        api.close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("api server thread did not stop")
    emit({"phase": "api_engine", "s": time.perf_counter() - t0, "requests": results,
          "engine_stats": {k: v for k, v in engine_path["engine"].snapshot().items()
                           if k != "prefix"}})


# ---------------------------------------------------------------- phase 8


def _norm_sites(groups, n_layers: int):
    """(kernel launches, unfused calls) of fused_norm_matmul over forwards
    given as (rows through the blocks, rows through the head, count): per
    forward 2 x n_layers block sites and the head, each on the kernel up to
    MAX_ROWS rows and on the unfused composition past it."""
    from cake_tpu_torch.ops.fused_norm_matmul import MAX_ROWS

    kernel = unfused = 0
    for block_rows, head_rows, count in groups:
        for sites, rows in ((2 * n_layers, block_rows), (1, head_rows)):
            if rows <= MAX_ROWS:
                kernel += sites * count
            else:
                unfused += sites * count
    return kernel, unfused


@contextlib.contextmanager
def step_recorder(step_cls):
    """Record the generator's forwards: each step call's (batch, width,
    pos) and each ``decode_chunk``'s (batch, n_steps)."""
    from unittest import mock

    import numpy as np

    rec = {"calls": [], "chunks": []}
    call0, chunk0 = step_cls.__call__, step_cls.decode_chunk

    def call(self, tokens, pos, seq_len):
        rec["calls"].append((*np.shape(tokens), int(pos)))
        return call0(self, tokens, pos, seq_len)

    def chunk(self, last_token, pos, n_steps, *args):
        rec["chunks"].append((int(np.size(last_token)), int(n_steps)))
        return chunk0(self, last_token, pos, n_steps, *args)

    with mock.patch.object(step_cls, "__call__", call), \
            mock.patch.object(step_cls, "decode_chunk", chunk):
        yield rec


# int4_matmul calls a forward makes: wqkv, wo, w_gu, w_down in each layer,
# and lm_head once (the last position's rows); a MoE layer (Mixtral) runs
# only wqkv and wo on it, its expert stacks being int8.
def _int4_per_forward(n_layers: int, moe: bool = False) -> int:
    return (2 if moe else 4) * n_layers + 1


def _int4_expected(expected: dict, forwards: int, n_layers: int, norm: bool, on_card: bool,
                   moe: bool = False):
    """Add an int4 tree's counts for ``forwards`` forwards: every product on
    int4_matmul (its plain version off the card) and, with "norm", every
    norm site (2 a layer and the head) routed to qmat, none on
    fused_norm_matmul's own kernel or plain version."""
    expected["int4_matmul" if on_card else "int4_matmul_plain"] = \
        _int4_per_forward(n_layers, moe) * forwards
    if norm:
        for key in ("fused_norm_matmul", "fused_norm_matmul_plain", "fused_norm_matmul.unfused"):
            expected[key] = 0
        expected["fused_norm_matmul.quantized"] = (2 * n_layers + 1) * forwards


def _generator_expected(counters, rec, n_layers: int, on_card: bool, fused: bool = True,
                        int4: bool = False, f8: bool = False, moe: bool = False,
                        rolling: bool = False):
    """(launches, expected) of a generator run recorded by
    ``step_recorder``: the attention kernels per forward as in phase
    generate; when ``fused`` ("all"), fused_norm_matmul per ``_norm_sites``
    and fused_sample_tail once per chunked step; for an ``int4`` tree,
    ``_int4_expected``; over an ``f8`` cache, every decode and continuation
    launch over f8 (the position-0 chunk attends its own fresh K/V); over a
    ``rolling`` ring, every decode and continuation launch on the ring
    instantiations (``ring`` side counts); off the card the plain versions
    take every call (the ring's plain versions under ``rolling``)."""
    launches = _counts(counters)
    expected = dict.fromkeys(launches, 0)
    decode = sum(n for _, n in rec["chunks"]) + sum(1 for _, w, _ in rec["calls"] if w == 1)
    first = sum(1 for _, w, p in rec["calls"] if w > 1 and p == 0)
    cont = sum(1 for _, w, p in rec["calls"] if w > 1 and p > 0)
    groups = [(b * w, b, 1) for b, w, _ in rec["calls"]] + [(b, b, n) for b, n in rec["chunks"]]
    kernel, unfused = _norm_sites(groups, n_layers) if fused else (0, 0)
    tail = sum(n for _, n in rec["chunks"]) if fused else 0
    if on_card:
        expected.update({
            "decode_attention": n_layers * decode,
            "chunk_prefill_attention": n_layers * (first + cont),
            "fused_norm_matmul": kernel, "fused_norm_matmul.unfused": unfused,
            "fused_sample_tail": tail,
        })
        if f8:
            expected["decode_attention.f8"] = n_layers * decode
            expected["chunk_prefill_attention.f8"] = n_layers * cont
        if rolling:
            expected["decode_attention.ring"] = n_layers * decode
            expected["chunk_prefill_attention.ring"] = n_layers * cont
    else:
        ring = "ring" if rolling else None
        expected.update({
            "decode_ring_plain" if ring else "decode_attention_plain": n_layers * decode,
            "chunk_ring_plain" if ring else "chunk_prefill_attention_plain": n_layers * cont,
            "flash_attention_plain": n_layers * first,
            "fused_norm_matmul_plain": kernel + unfused,
            "fused_sample_tail_plain": tail,
        })
    if int4:
        forwards = len(rec["calls"]) + sum(n for _, n in rec["chunks"])
        _int4_expected(expected, forwards, n_layers, fused, on_card, moe)
    if moe:
        # Every window of GROUPED_MIN_TOKENS or more takes the grouped
        # dispatch: its gate, up and down products, a launch each a layer.
        from cake_tpu_torch.ops.moe import GROUPED_MIN_TOKENS

        grouped = sum(1 for _, w, _ in rec["calls"] if w >= GROUPED_MIN_TOKENS)
        expected["grouped_matmul" if on_card else "grouped_matmul_plain"] = 3 * n_layers * grouped
    return launches, expected


def phase_generate_fused(torch, main_path: dict) -> dict:
    """The generator with every decode fusion and fused multi-token decode
    over the generate phase's weights (no second copy), its prompt and 64
    greedy tokens, gated on the launches its forwards imply."""
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.chat import Message
    from cake_tpu_torch.models.llama.generator import LlamaGenerator, LocalForwardStep

    gen0, text = main_path["generator"], main_path["text"]
    step0 = gen0.step
    dev = step0.device
    config = dataclasses.replace(gen0.config, fusion_impl="all")
    n_layers = config.num_hidden_layers
    step = LocalForwardStep(config, step0.params, max_seq_len=MAX_SEQ,
                            cache_dtype=torch.bfloat16, device=dev)
    gen = LlamaGenerator(config, step, gen0.tokenizer, gen0.sampling,
                         prefill_chunk=PREFILL_CHUNK, decode_chunk_size=FUSED_CHUNK)
    gen.add_message(Message.user(text))
    gen.generate(FUSED_CHUNK + 2)  # warm-up: the fused kernels' first launches
    _sync(torch, dev)

    counters = _zero_counters()
    gen.reset()
    gen.add_message(Message.user(text))
    stamps = []
    with step_recorder(LocalForwardStep) as rec:
        t_start = time.perf_counter()
        gen.generate(DECODE_TOKENS, on_token=lambda tok: stamps.append(time.perf_counter()))
        _sync(torch, dev)
    launches, expected = _generator_expected(counters, rec, n_layers, dev.type == "cuda")
    ids = gen.generated_token_ids
    n_gen = len(ids)
    decode_s = stamps[-1] - stamps[0] if n_gen > 1 else float("nan")
    row = {
        "phase": "generate_fused",
        "card": main_path["card"],
        "fusion": config.fusion_impl,
        "decode_chunk": FUSED_CHUNK,
        "generated_tokens": n_gen,
        "finish_reason": gen.last_finish_reason,
        "chunks": rec["chunks"],
        "step_calls": len(rec["calls"]),
        "prefill_s": stamps[0] - t_start,
        "decode_ms_per_token": 1e3 * decode_s / (n_gen - 1) if n_gen > 1 else None,
        "unfused_decode_ms_per_token": main_path["decode_ms_per_token"],
        "tokens_equal_to_unfused": _stream_agreement(ids, main_path["generated_ids"]),
        "launches": launches,
        "expected_launches": expected,
    }
    emit(row)
    if launches != expected:
        raise AssertionError(f"fused generator launch counts {launches} != expected {expected}")
    row["fused_launches"] = {name: launches[name] for name in FUSED_MAIN}
    if n_gen < 1 or not all(0 <= t < config.vocab_size for t in ids):
        raise AssertionError(f"generated ids out of range: {ids}")
    if dev.type == "cuda":
        row["profile"] = _profile_main_path(torch, gen, text, row["decode_ms_per_token"],
                                            phase="profile_fused")
    row["check"] = _full_model_check(
        torch, M, dataclasses.replace(config, fusion_impl="norm"), step.params, dev,
        phase="fused_model_check",
    )
    del gen, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------- phase 9

# The sampled wave of phase engine_fused: one seed per request, shared knobs.
SAMPLED_KNOBS = dict(temperature=0.7, top_k=40, repeat_penalty=1.1)


@contextlib.contextmanager
def dispatch_recorder(backend):
    """Record an engine backend's dispatches: each prefill's (rows, lanes)
    (epoch prefills, suffix windows and joins) and each decode chunk's
    (lanes, steps). The backend runs as it does without it."""
    import numpy as np

    rec = {"prefills": [], "decodes": []}
    token_arg = {"prefill": 0, "suffix_prefill": 0, "join": 1, "suffix_join": 1}
    patched = []

    def wrap(name, fn):
        def call(*args, **kw):
            if name == "decode":
                rec["decodes"].append((int(args[1].shape[0]), int(args[7])))
            else:
                b, w = np.shape(args[token_arg[name]])
                rec["prefills"].append((b * w, b))
            return fn(*args, **kw)

        return call

    for name in ("decode", *token_arg):
        if hasattr(backend, name):
            setattr(backend, name, wrap(name, getattr(backend, name)))
            patched.append(name)
    try:
        yield rec
    finally:
        for name in patched:
            delattr(backend, name)


def _engine_fused_expected(counters, rec, fusions, kv_mode: str, n_layers: int, on_card: bool,
                           int4: bool = False, f8: bool = False, sampled=None):
    """(launches, expected) of engine dispatches recorded by
    ``dispatch_recorder``: the attention gates of phase engine, and per
    enabled fusion fused_qkv_ingest = n_layers x decode steps,
    fused_sample_tail = decode steps, fused_norm_matmul per ``_norm_sites``;
    for an ``int4`` tree ``_int4_expected`` over one forward a prefill
    dispatch and one a decode step; over an ``f8`` cache every attention and
    ingest launch over f8; threefry_noise once a first sample (a prefill
    dispatch) and once a decode step of the sampled dispatches ``sampled``
    (the part of ``rec`` a sampled wave made); off the card the plain
    versions take every call."""
    launches = _counts(counters)
    expected = dict.fromkeys(launches, 0)
    decode, chunk = (("paged_decode_attention", "paged_chunk_attention") if kv_mode == "paged"
                     else ("decode_attention", "chunk_prefill_attention"))
    steps = sum(n for _, n in rec["decodes"])
    sfx = "" if on_card else "_plain"
    expected[decode + sfx] = n_layers * steps
    expected[chunk + sfx] = n_layers * len(rec["prefills"])
    if "norm" in fusions:
        groups = [(r, b, 1) for r, b in rec["prefills"]] + [(b, b, n) for b, n in rec["decodes"]]
        kernel, unfused = _norm_sites(groups, n_layers)
        if on_card:
            expected["fused_norm_matmul"] = kernel
            expected["fused_norm_matmul.unfused"] = unfused
        else:
            expected["fused_norm_matmul_plain"] = kernel + unfused
    if "ingest" in fusions:
        expected["fused_qkv_ingest" + sfx] = n_layers * steps
    if "tail" in fusions:
        expected["fused_sample_tail" + sfx] = steps
    if sampled is not None:
        expected["threefry_noise" + sfx] = (len(sampled["prefills"])
                                            + sum(n for _, n in sampled["decodes"]))
    if f8 and on_card:
        for name in (decode, chunk, "fused_qkv_ingest"):
            expected[name + ".f8"] = expected[name]
    if int4:
        _int4_expected(expected, len(rec["prefills"]) + steps, n_layers, "norm" in fusions,
                       on_card)
    return launches, expected


def _fused_engine_run(torch, make, spec: str, kv_mode: str, n_layers: int, on_card: bool,
                      sampled: bool, int4: bool = False, f8: bool = False,
                      warm: bool = False, together: bool = True) -> dict:
    """One engine with fusion ``spec``: warm-up waves (they capture the
    decode chunks' graphs), then wave 1 (and the sampled wave; with
    ``warm``, wave 1 again, served from the prefix cache) under the launch
    gate, then two warm profiled waves of 16 and 32 tokens: their
    difference gives the device ops and ms of 16 decode steps, the prefill
    being the same in both. ``together=False`` submits wave 1 and the warm
    wave one request at a time, for the admission window to gather."""
    from cake_tpu_torch.models.llama.generator import SamplingConfig
    from cake_tpu_torch.ops.fuse import parse_fusion_spec

    kw = {"kv_mode": "paged", "page_size": ENGINE_PAGE, "prefix_cache": True} \
        if kv_mode == "paged" else {}
    eng = make(fusion_impl=spec, **kw)
    sampled_wave = [SamplingConfig(seed=100 + i, **SAMPLED_KNOBS) for i in range(ENGINE_BATCH)]
    try:
        # Waves of wave 1's shapes on other prompts capture the decode
        # chunks' graphs (greedy, and sampled when that wave runs).
        _wave(eng, ENGINE_TOKENS, warm_messages())
        if sampled:
            _wave(eng, ENGINE_TOKENS, warm_messages(), samplings=sampled_wave)
        counters = _zero_counters()
        sampled_rec = None
        # A compared wave submitted as one group cannot be split by the
        # admission window (a split wave joins other shapes and may give
        # other bits); each wave's batches and joins are in its row.
        with dispatch_recorder(eng.backend) as rec:
            waves = [_wave(eng, ENGINE_TOKENS, together=together)]
            if sampled:
                at = {k: len(v) for k, v in rec.items()}
                waves.append(_wave(eng, ENGINE_TOKENS, samplings=sampled_wave, together=True))
                sampled_rec = {k: v[at[k]:] for k, v in rec.items()}
            if warm:
                waves.append(_wave(eng, ENGINE_TOKENS, together=together))
        launches, expected = _engine_fused_expected(
            counters, rec, parse_fusion_spec(spec), kv_mode, n_layers, on_card, int4, f8,
            sampled_rec)
        # Unprofiled first: the 16- and 32-token waves' epochs capture their
        # chunks' graphs (the 32-token one ends on a 7-step chunk).
        _wave(eng, 32)
        timed = _wave(eng, 16)
        profile = None
        if on_card:
            short = _device_profile(torch, lambda: _wave(eng, 16), valid=_one_epoch)
            long = _device_profile(torch, lambda: _wave(eng, 32), valid=_one_epoch)
            busy = short["device_ms"]
            profile = {
                "device_ms_16": short["device_ms"], "device_ops_16": short["device_ops"],
                "launches_seen_16": short["launches_seen"],
                "trace_tries": [short["trace_tries"], long["trace_tries"]],
                "clock_offset_us": [short["clock_offset_us"], long["clock_offset_us"]],
                "device_ms_32": long["device_ms"], "device_ops_32": long["device_ops"],
                "device_ops_per_step": (long["device_ops"] - short["device_ops"]) / 16,
                "device_ms_per_step": (long["device_ms"] - short["device_ms"]) / 16,
                "by_family_ms_16": short["by_family_ms"],
                "by_family_ms_per_step": {
                    f: (long["by_family_ms"].get(f, 0.0) - short["by_family_ms"].get(f, 0.0)) / 16
                    for f in long["by_family_ms"]},
                "device_idle_share": 1.0 - busy / (1e3 * timed["wall_s"] - 1e3 * eng.admission_window),
            }
        kv = getattr(eng.backend, "_pool", None) or eng.backend._kv
        kv_bytes = kv.k.numel() * kv.k.element_size() * 2
    finally:
        eng.stop()
    return {"spec": spec, "kv_mode": kv_mode, "waves": waves, "launches": launches,
            "expected_launches": expected, "profile_wave_wall_ms": 1e3 * timed["wall_s"],
            "profile": profile, "prefills": rec["prefills"], "kv_bytes": kv_bytes}


def phase_engine_fused(torch, main_path: dict) -> dict:
    """The paged engine three ways (fusion none, ingest+tail, all) over wave
    1 and a seeded sampled wave, then the dense engine with all; one engine
    at a time, each freed before the next. Gates: the exact fusions keep the
    unfused streams, every launch count is derived from the dispatches."""
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    gen = main_path["generator"]
    config, params, dev = gen.config, gen.step.params, gen.step.device
    n_layers = config.num_hidden_layers
    on_card = dev.type == "cuda"

    def make(**kw):
        serve = ServeConfig(max_batch=ENGINE_BATCH, decode_chunk_size=8, **kw)
        eng = BatchEngine(config, params, gen.tokenizer, max_seq_len=ENGINE_MAX_SEQ,
                          cache_dtype=torch.bfloat16, serve=serve, device=dev)
        eng.start()
        return eng

    runs = []
    for spec, kv_mode in (("none", "paged"), ("ingest,tail", "paged"), ("all", "paged"),
                          ("all", "dense")):
        # Wave 1 gathered by the admission window, as a client's burst is.
        runs.append(_fused_engine_run(torch, make, spec, kv_mode, n_layers, on_card,
                                      sampled=kv_mode == "paged", together=False))
        if on_card:
            torch.cuda.empty_cache()
    none, exact, fused, dense = runs

    def equal(a, b):
        return [sum(x == y for x, y in zip(wa["streams"], wb["streams"]))
                for wa, wb in zip(a["waves"], b["waves"])]

    def summary(r):
        w = r["waves"][0]
        out = {"spec": r["spec"], "kv_mode": r["kv_mode"], "ttft_p50_s": w["ttft_p50_s"],
               "ttft_max_s": w["ttft_max_s"], "decode_ms_per_step": w["decode_ms_per_step"],
               "greedy_completion_tokens": w["completion_tokens"],
               "greedy_finish_reasons": w["finish_reasons"],
               "decode_tok_s": w["decode_tok_s"], "profile_wave_wall_ms": r["profile_wave_wall_ms"],
               "profile": r["profile"], "launches": r["launches"],
               "expected_launches": r["expected_launches"],
               "batches_joins": [[x["batches"], x["joins"]] for x in r["waves"]]}
        if len(r["waves"]) > 1:
            s = r["waves"][1]
            out.update(sampled_ttft_p50_s=s["ttft_p50_s"],
                       sampled_decode_ms_per_step=s["decode_ms_per_step"],
                       sampled_prefix_hits=s["prefix_hits"])
        return out

    row = {
        "phase": "engine_fused",
        "card": main_path["card"],
        "config": {"page_size": ENGINE_PAGE, "max_seq": ENGINE_MAX_SEQ, "max_batch": ENGINE_BATCH,
                   "decode_chunk": 8, "tokens_out": ENGINE_TOKENS, "layers": n_layers,
                   "sampled": SAMPLED_KNOBS},
        "runs": [summary(r) for r in runs],
        # [greedy, sampled] streams equal to the unfused engine's, of 8 each
        "ingest_tail_equal_streams": equal(exact, none),
        "all_equal_streams": equal(fused, none),
        "dense_all_equal_paged_all": equal(dense, fused)[0],
    }
    emit(row)
    for r in runs:
        if r["launches"] != r["expected_launches"]:
            raise AssertionError(
                f"{r['kv_mode']} engine with fusion {r['spec']}: launch counts {r['launches']} "
                f"!= expected {r['expected_launches']}")
        for w in r["waves"]:
            if not all(1 <= len(ids) <= ENGINE_TOKENS and all(0 <= t < config.vocab_size for t in ids)
                       for ids in w["streams"]):
                raise AssertionError(f"engine streams out of range: {w['completion_tokens']}")
    if row["ingest_tail_equal_streams"] != [ENGINE_BATCH, ENGINE_BATCH]:
        raise AssertionError(
            f"ingest,tail streams differ from the unfused ones: {row['ingest_tail_equal_streams']}")
    fused_config = dataclasses.replace(config, fusion_impl="all")
    row["check"] = _batch_model_check(torch, fused_config, params, dev, "paged",
                                      phase="paged_fused_model_check")
    row["dense_check"] = _batch_model_check(torch, fused_config, params, dev, "dense",
                                            phase="dense_fused_model_check")
    row["fused_launches"] = {
        name: sum(r["launches"][name] for r in runs)
        for name in ("fused_norm_matmul", "fused_qkv_ingest", "fused_sample_tail")
    }
    # The noise kernel's launches over the gated sampled waves (the paged runs').
    row["noise_launches"] = sum(r["launches"]["threefry_noise"] for r in runs)
    if on_card and not all(r["launches"]["threefry_noise"] > 0 for r in runs[:3]):
        raise AssertionError("a sampled wave ran without the noise kernel")
    return row


# ---------------------------------------------------------------- phase 9a

CONTINUOUS_TOKENS = 384  # tokens out of the preemption runs


def _pool_for_one_epoch(engine, messages) -> int:
    """The smallest pool that admits every request of ``messages`` into one
    epoch: the sum of their admission charges (the prompt's pages plus the
    reserve), the prefix cache being empty."""
    from cake_tpu_torch.models.llama.chat import encode_dialog

    alloc = engine.backend.allocator
    lengths = [len(engine.tokenizer.encode(encode_dialog(m, engine.config.dialog_template)))
               for m in messages]
    return sum(alloc.pages_needed(n) + alloc.reserve_pages for n in lengths)


def _lane_kv(engine, kv, lane: int, lo: int, hi: int):
    """``lane``'s K and V over slots [lo, hi), through its block table, by
    position: [hi - lo, layers, kv heads, head dim] each."""
    import numpy as np
    import torch

    page = engine.backend.page_size
    slots = np.arange(lo, hi)
    table = engine.backend.allocator.block_tables[lane]
    pages = torch.as_tensor(table[slots // page], dtype=torch.long, device=kv.k.device)
    offs = torch.as_tensor(slots % page, dtype=torch.long, device=kv.k.device)
    if bool((pages < 0).any()):
        raise AssertionError(f"lane {lane} has unmapped slots in [{lo}, {hi})")
    return kv.k[:, pages, :, offs].clone(), kv.v[:, pages, :, offs].clone()


@contextlib.contextmanager
def restore_checker(engine):
    """Hold every restore to its spill. The instance's ``_spill_lane`` is
    wrapped to keep, for each lane it parks, the K/V over its history[:-1]
    (read before its pages go); ``_restore_lane`` (a restore into a running
    segment) and ``_pop_spill_seed`` (the seeds of a new segment) note which
    lane each spill comes back to; and at the next decode dispatch, whose
    operands are the state that lane decodes from, its token, key, ring row,
    ring index and pad are compared with the spill's copies (bitwise) and
    its K/V with the kept K/V (max-abs, and per layer the difference's norm
    over the kept K/V's). Yields {"checks": [...], "seeded":
    [seeds of each spill-seeded segment], "respilled": restores spilled
    again before they decoded}."""
    import numpy as np

    checks: list = []
    state = {"checks": checks, "seeded": [], "respilled": 0}
    kept: dict = {}  # id(spill record) -> (K, V) before the spill
    pending: dict = {}  # lane -> (spill record, route, history length)
    spill, restore, seed = engine._spill_lane, engine._restore_lane, engine._pop_spill_seed
    decode = engine.backend.decode

    def spill_lane(rows, lane, slot, spill_ctx, reason):
        row = rows[lane]
        n_hist = len(row.history) - 1
        kv = _lane_kv(engine, engine.backend._pool, lane, slot - n_hist, slot)
        for other, (sp, _, _) in list(pending.items()):
            if sp.row is row:  # spilled again before it decoded
                del pending[other]
                kept.pop(id(sp), None)
                state["respilled"] += 1
        spill(rows, lane, slot, spill_ctx, reason)
        sp = engine._spilled.get(row.req.rid)
        if sp is not None and sp.row is row:
            kept[id(sp)] = kv

    def restore_lane(sp, lane, *args):
        kv = restore(sp, lane, *args)
        pending[lane] = (sp, "in_segment", len(sp.row.history) - 1)
        return kv

    def pop_spill_seed():
        seeds = seed()
        if seeds:
            state["seeded"].append(len(seeds))
        for lane, sp in enumerate(seeds):
            pending[lane] = (sp, "seeded", len(sp.row.history) - 1)
        return seeds

    def decode_chunk(kv, tok, slot, pads, keys, ring, ring_idx, n, s):
        for lane, (sp, route, n_hist) in list(pending.items()):
            del pending[lane]
            k0, v0 = kept.pop(id(sp))
            k, v = _lane_kv(engine, kv, lane, slot - n_hist, slot)
            diffs = [(a.float() - b.float()) for a, b in ((k, k0), (v, v0))]
            err = max(d.abs().max().item() for d in diffs)
            # Per layer (dim 1 of a [positions, layers, heads, dim] view), the
            # difference's norm over the kept K/V's: rounding compounded
            # through the layers moves small elements as much as large ones.
            rel = max((d.square().sum((0, 2, 3)).sqrt()
                       / b.float().square().sum((0, 2, 3)).sqrt()).max().item()
                      for d, b in zip(diffs, (k0, v0)))
            window = ring.shape[1] if ring.ndim == 2 else 0
            checks.append({
                "route": route, "history": n_hist,
                "token": int(tok[lane]) == sp.row.history[n_hist],
                "key": bool(np.array_equal(keys[lane].cpu().numpy(), sp.key)),
                "ring": (window == 0 or (
                    bool(np.array_equal(ring[lane].cpu().numpy(), sp.ring))
                    and int(ring_idx[lane]) == sp.ring_idx)),
                "pad": int(pads[lane]) == slot - n_hist,
                "kv_max_abs_err": err,
                "kv_ref_max_abs": max(k0.float().abs().max().item(), v0.float().abs().max().item()),
                "kv_rel_err": rel,
                "kv_bitwise": err == 0.0,
            })
        return decode(kv, tok, slot, pads, keys, ring, ring_idx, n, s)

    patches = ((engine, "_spill_lane", spill_lane), (engine, "_restore_lane", restore_lane),
               (engine, "_pop_spill_seed", pop_spill_seed), (engine.backend, "decode", decode_chunk))
    # Instance attributes already set (another recorder's) are put back after.
    saved = [(obj, name, obj.__dict__.get(name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        yield state
    finally:
        for obj, name, old in saved:
            if old is None:
                delattr(obj, name)
            else:
                setattr(obj, name, old)


def _first_difference(a: list, b: list) -> int | None:
    """The first position where two streams differ (None when equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def _continuous_pressure_run(torch, make, knobs: str, max_pages, n_layers: int,
                             on_card: bool, tokens, repeat: bool = False, **serve) -> dict:
    """Wave 1's prompts, ``tokens`` out (one number, or one each), greedy or
    the seeded sampled wave, submitted before start() to a new continuous
    engine (``serve``: more ServeConfig knobs) on a pool of ``max_pages``
    (None: the default pool): the wave, its launch gate, the restore checks
    and the pool's state after it. With ``repeat``, the same wave again once
    the prefix cache is cleared (the first run's page state): the graph
    captures of the second run."""
    from cake_tpu_torch.models.llama import fused
    from cake_tpu_torch.models.llama.generator import SamplingConfig

    samplings = ([SamplingConfig(seed=100 + i, **SAMPLED_KNOBS) for i in range(ENGINE_BATCH)]
                 if knobs == "sampled" else None)
    eng = make(scheduler="continuous", max_pages=max_pages, **serve)
    try:
        counters = _zero_counters()
        with dispatch_recorder(eng.backend) as rec, restore_checker(eng) as checked:
            wave = _wave(eng, tokens, engine_messages(), samplings, together=True)
        seeded = checked["seeded"]
        in_segment = wave["restores"] - sum(seeded)
        # Restores and the seeds' prefills sample nothing: the wave's first
        # samples are its other prefill dispatches.
        sampled = None
        if samplings is not None:
            firsts = len(rec["prefills"]) - in_segment - len(seeded)
            sampled = {"prefills": [None] * firsts, "decodes": rec["decodes"]}
        launches, expected = _engine_fused_expected(counters, rec, set(), "paged", n_layers,
                                                    on_card, sampled=sampled)
        snap = eng.snapshot()
        held = snap["prefix"]["pages"]
        out = {
            "knobs": knobs, "max_pages": snap["pages_total"], "wave": wave,
            "launches": launches, "expected_launches": expected,
            "restore_checks": checked["checks"], "respilled_before_decode": checked["respilled"],
            "in_segment_restores": in_segment, "seeded_segments": len(seeded),
            "seeded_restores": sum(seeded), "prefills": len(rec["prefills"]),
            "pool_whole": snap["spilled"] == 0 and snap["pages_free"] == snap["pages_total"] - held,
            "spilled_left": snap["spilled"], "pages_free": snap["pages_free"],
            "cache_pages": held,
        }
        if repeat:
            eng._prefix.clear()
            captures, keys = fused.STATS["captures"], set(eng.backend._chunks)
            again = _wave(eng, tokens, engine_messages(), samplings, together=True)
            out["repeat_new_captures"] = fused.STATS["captures"] - captures
            # A chunk key is a graph on the card (and the loop's buffers on the CPU).
            out["repeat_new_chunk_keys"] = len(set(eng.backend._chunks) - keys)
            out["repeat_equal_streams"] = sum(
                x == y for x, y in zip(again["streams"], wave["streams"]))
            out["repeat_preemptions"] = again["preemptions"]
    finally:
        eng.stop()
    return out


def phase_engine_continuous(torch, main_path: dict, tokens: int = CONTINUOUS_TOKENS) -> dict:
    """The continuous scheduler (``ServeConfig(scheduler="continuous")``) on
    the paged engine (page 128, max_seq 2048, 8 lanes, prefix cache on,
    fusion none), one engine at a time: (1) after a warm-up wave, wave 1
    submitted as one group to an epoch engine and to a continuous one
    (equal streams, gated); (2)
    the ragged wave of 12 under both schedulers, each after a warm-up wave of
    its shapes (TTFT, ms a decode step, joins, the step budget's deferrals;
    agreement reported); (3) wave 1's prompts with 384 tokens out, greedy
    and the seeded sampled wave, on the smallest pool that admits all 8 in
    one epoch and on the default pool: preemptions and restores >= 2 on the
    small pool and 0 on the full one, no truncation, the same finish reasons
    and token counts on both pools, the pool whole after each, every restore
    held to its spill (``restore_checker``: state bitwise, each layer's K/V
    within TOL in relative norm),
    the paged kernels' and the noise kernel's launches derived from the
    dispatches, and a second sampled run on the small pool capturing no new
    graph (nor a new decode chunk key). Then (4) the sampled wave on the small pool with half the
    requests asking half the tokens and a step budget of max_seq: the
    short streams' lanes free up mid-segment and spills come back into the
    running segment (``_restore_lane``), held to their spills as above.
    ``tokens`` (384) is what the CPU rehearsal cuts (with the page size)."""
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    gen = main_path["generator"]
    config, params, dev = gen.config, gen.step.params, gen.step.device
    n_layers = config.num_hidden_layers
    on_card = dev.type == "cuda"

    def make(**kw):
        # Not started: a wave submitted before start() is one admission.
        serve = ServeConfig(max_batch=ENGINE_BATCH, decode_chunk_size=8, kv_mode="paged",
                            page_size=ENGINE_PAGE, prefix_cache=True, **kw)
        return BatchEngine(config, params, gen.tokenizer, max_seq_len=ENGINE_MAX_SEQ,
                           cache_dtype=torch.bfloat16, serve=serve, device=dev)

    def strip(w):
        return {k: v for k, v in w.items() if k != "streams"}

    t0 = time.perf_counter()
    ragged = engine_messages(RAGGED_TURNS)
    ragged_warm = engine_messages(RAGGED_TURNS, system=SYSTEM_PROMPT[::-1])
    same_admission, ragged_runs = {}, {}
    for scheduler in ("epoch", "continuous"):
        eng = make(scheduler=scheduler)
        try:
            # Wave 1's shapes on other prompts capture the graphs first.
            _wave(eng, ENGINE_TOKENS, warm_messages(), together=True)
            same_admission[scheduler] = _wave(eng, ENGINE_TOKENS, together=True)
            _wave(eng, ENGINE_TOKENS, ragged_warm)  # captures the ragged wave's graphs
            ragged_runs[scheduler] = _wave(eng, ENGINE_TOKENS, ragged)
        finally:
            eng.stop()
        del eng
        if on_card:
            torch.cuda.empty_cache()

    probe = make(scheduler="continuous")
    small_pool = _pool_for_one_epoch(probe, engine_messages())
    full_pool = probe.backend.allocator.pages_total
    del probe
    runs = []
    for knobs in ("greedy", "sampled"):
        for pool in (small_pool, None):
            runs.append(_continuous_pressure_run(
                torch, make, knobs, pool, n_layers, on_card, tokens,
                repeat=knobs == "sampled" and pool is not None))
            if on_card:
                torch.cuda.empty_cache()
    # The oldest lanes stop early; the youngest, spilled first, come back
    # into the running segment.
    mixed_tokens = [tokens // 2] * (ENGINE_BATCH // 2) + [tokens] * (ENGINE_BATCH // 2)
    runs.append(_continuous_pressure_run(torch, make, "sampled", small_pool, n_layers, on_card,
                                         mixed_tokens, step_prefill_tokens=ENGINE_MAX_SEQ))

    def agreement(small, full):
        a, b = small["wave"]["streams"], full["wave"]["streams"]
        return {"equal": sum(x == y for x, y in zip(a, b)),
                "first_difference": [_first_difference(x, y) for x, y in zip(a, b)]}

    checks = [c for r in runs for c in r["restore_checks"]]
    pairs = {"greedy": (runs[0], runs[1]), "sampled": (runs[2], runs[3])}
    # The mixed run's streams against the full pool's, each up to its length.
    mixed_prefix_equal = sum(a == b[: len(a)] for a, b in zip(runs[4]["wave"]["streams"],
                                                             runs[3]["wave"]["streams"]))
    row = {
        "phase": "engine_continuous",
        "card": main_path["card"],
        "config": {"kv_mode": "paged", "page_size": ENGINE_PAGE, "max_seq": ENGINE_MAX_SEQ,
                   "max_batch": ENGINE_BATCH, "prefix_cache": True, "fusion": "none",
                   "decode_chunk": 8, "tokens_out": ENGINE_TOKENS,
                   "pressure_tokens_out": tokens, "mixed_tokens_out": mixed_tokens,
                   "mixed_step_prefill": ENGINE_MAX_SEQ, "small_pool": small_pool,
                   "full_pool": full_pool, "sampled": SAMPLED_KNOBS, "layers": n_layers},
        "same_admission": {s: strip(w) for s, w in same_admission.items()},
        "same_admission_equal_streams": sum(
            x == y for x, y in zip(same_admission["epoch"]["streams"],
                                   same_admission["continuous"]["streams"])),
        "ragged": {s: strip(w) for s, w in ragged_runs.items()},
        "ragged_equal_streams": sum(
            x == y for x, y in zip(ragged_runs["epoch"]["streams"],
                                   ragged_runs["continuous"]["streams"])),
        "pressure": [{k: (strip(v) if k == "wave" else v) for k, v in r.items()
                      if k != "restore_checks"} for r in runs],
        "pressure_agreement": {k: agreement(*p) for k, p in pairs.items()},
        "mixed_prefix_equal_full_pool": mixed_prefix_equal,
        "restore_checks": len(checks),
        "restore_routes": {route: sum(c["route"] == route for c in checks)
                           for route in ("in_segment", "seeded")},
        "restore_state_equal": sum(c["token"] and c["key"] and c["ring"] and c["pad"]
                                   for c in checks),
        "restore_kv_max_abs_err": max((c["kv_max_abs_err"] for c in checks), default=None),
        "restore_kv_ref_max_abs": max((c["kv_ref_max_abs"] for c in checks), default=None),
        "restore_kv_rel_err": max((c["kv_rel_err"] for c in checks), default=None),
        "restore_check_rows": checks,
        "restore_kv_bitwise": sum(c["kv_bitwise"] for c in checks),
        "tol": TOL,
        "seconds": time.perf_counter() - t0,
    }
    emit(row)
    if row["same_admission_equal_streams"] != ENGINE_BATCH:
        raise AssertionError(
            f"continuous streams equal epoch's {row['same_admission_equal_streams']}"
            f"/{ENGINE_BATCH} under the same admission")
    for knobs, (small, full) in pairs.items():
        ws, wf = small["wave"], full["wave"]
        if ws["preemptions"] < 2 or ws["restores"] < 2:
            raise AssertionError(f"{knobs}: the small pool preempted {ws['preemptions']} and "
                                 f"restored {ws['restores']} times")
        if wf["preemptions"] or wf["restores"]:
            raise AssertionError(f"{knobs}: the full pool preempted")
        if ws["page_truncations"] or wf["page_truncations"]:
            raise AssertionError(f"{knobs}: a stream was truncated")
        if (ws["finish_reasons"], ws["completion_tokens"]) != (wf["finish_reasons"],
                                                               wf["completion_tokens"]):
            raise AssertionError(f"{knobs}: finish reasons or token counts differ between pools")
    for r in runs:
        if not r["pool_whole"]:
            raise AssertionError(f"{r['knobs']} pool {r['max_pages']}: a spill or pages left: "
                                 f"{r['spilled_left']} spilled, {r['pages_free']} free")
        if r["launches"] != r["expected_launches"]:
            raise AssertionError(f"{r['knobs']} pool {r['max_pages']}: launch counts "
                                 f"{r['launches']} != expected {r['expected_launches']}")
        for w in (r["wave"],):
            if not all(1 <= len(ids) <= tokens
                       and all(0 <= t < config.vocab_size for t in ids) for ids in w["streams"]):
                raise AssertionError(f"engine streams out of range: {w['completion_tokens']}")
    restored = sum(r["wave"]["restores"] - r["respilled_before_decode"] for r in runs)
    if len(checks) != restored:
        raise AssertionError(f"{len(checks)} restores checked of the {restored} that decoded")
    if row["restore_state_equal"] != len(checks):
        raise AssertionError("a restore wrote back another key, ring, token or pad than its "
                             f"spill's: {[c for c in checks if not (c['token'] and c['key'])]}")
    # Re-prefilled on other GEMM shapes, the K/V's rounding compounds through
    # the layers: each layer's K and V within TOL of the spilled ones in
    # norm (relative L2); the max-abs is reported beside it.
    if checks and row["restore_kv_rel_err"] > TOL:
        raise AssertionError(f"a restored lane's K/V is {row['restore_kv_rel_err']} from the "
                             f"K/V it held in a layer's norm (TOL {TOL}; max-abs "
                             f"{row['restore_kv_max_abs_err']})")
    if runs[4]["in_segment_restores"] < 1 or runs[4]["wave"]["page_truncations"]:
        raise AssertionError(f"the mixed run restored {runs[4]['in_segment_restores']} lanes "
                             f"into its segment and truncated {runs[4]['wave']['page_truncations']}")
    if runs[2]["repeat_new_captures"] or runs[2]["repeat_new_chunk_keys"]:
        raise AssertionError(f"a second continuous run captured {runs[2]['repeat_new_captures']} "
                             f"new graphs ({runs[2]['repeat_new_chunk_keys']} new chunk keys)")
    # The launches this phase adds to the kernels line.
    row["launches"] = {name: sum(r["launches"][name] for r in runs)
                       for name in ("paged_decode_attention", "paged_chunk_attention",
                                    "threefry_noise")}
    return row


# ---------------------------------------------------------------- phase 9a'

OBS_ROUTES = ("/metrics", "/events", "/trace", "/efficiency", "/requests", "/timeseries")
OBS_EXPLAIN_SLACK_S = 0.05  # the reference's slack on an explanation's phase sum


def _get(port: int, route: str) -> tuple[int, str]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("GET", route)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _exposition(text: str) -> dict:
    """A Prometheus text exposition parsed to {series: value}; raises on a
    line that is neither a HELP/TYPE comment nor ``series value``."""
    out = {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            if not line.startswith(("# HELP ", "# TYPE ")):
                raise AssertionError(f"obs: /metrics line {line!r}")
            continue
        series, value = line.rsplit(" ", 1)
        out[series] = float(value)
    return out


def phase_obs(torch, main_path: dict, tokens: int = CONTINUOUS_TOKENS) -> dict:
    """Observability on the paged ``--api-batch`` engine (the continuous
    scheduler, page 128, max_seq 2048, 8 lanes, prefix cache on, the
    smallest pool that admits wave 1 in one epoch) behind the port's API
    with every recorder armed: the request log, the trace and events JSONL
    sinks, the timeline, the efficiency ledger and decision audit, the black
    box. After a warm-up wave (it captures the graphs), one cold wave of 8
    (wave 1, ENGINE_TOKENS out) and one wave under page pressure (wave 1's
    prompts, ``tokens`` out for half and half that for the others: spills
    and restores into the running segment), each submitted as one
    group; first the same waves on an engine with every recorder off (no
    API, no sinks, no black box). Gates: the armed streams equal the off
    ones 8/8 both waves; /metrics parses and its batches, requests, tokens,
    prefix hits, preemptions and restores counters equal the engine's
    stats; /efficiency's buckets sum to >= 95% of its device wall, its MBU
    and MFU in (0, 1]; every finished request's /explain phases sum to its
    end-to-end time (its request-log wall) within the reference's tolerance
    (>= 95% less 50 ms, <= 50 ms over), and a pressured request shows a
    restore phase; /trace is valid Chrome trace
    JSON with segment and step spans; /events, /requests and /timeseries
    answer; the request log has one line a finished request; the paged
    kernels launched in the armed waves. Cost: ms a decode step and TTFT p50
    armed against off. ``tokens``: what the CPU rehearsal cuts."""
    from cake_tpu_torch.obs import critpath
    from cake_tpu_torch.obs.timeline import load_jsonl, timeline, validate_export
    from cake_tpu_torch.runtime.api import ApiServer
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig
    from cake_tpu_torch.utils import metrics

    gen = main_path["generator"]
    config, params, dev = gen.config, gen.step.params, gen.step.device
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()

    def make(pool, **kw):
        serve = ServeConfig(max_batch=ENGINE_BATCH, decode_chunk_size=8, kv_mode="paged",
                            page_size=ENGINE_PAGE, prefix_cache=True, scheduler="continuous",
                            max_pages=pool, step_prefill_tokens=ENGINE_MAX_SEQ, **kw)
        return BatchEngine(config, params, gen.tokenizer, max_seq_len=ENGINE_MAX_SEQ,
                           cache_dtype=torch.bfloat16, serve=serve, device=dev)

    # The pressured wave: half the requests ask half the tokens, so their
    # lanes free up mid-segment and the spills come back into the running
    # segment (``_restore_lane``: /explain's restore phase; a spill that
    # seeds a segment of its own is that segment's prefill).
    pressured_tokens = [tokens // 2] * (ENGINE_BATCH // 2) + [tokens] * (ENGINE_BATCH // 2)
    probe = make(None)
    pool = _pool_for_one_epoch(probe, engine_messages())
    del probe

    def serve_waves(eng) -> dict:
        _wave(eng, ENGINE_TOKENS, warm_messages(), together=True)
        # Each measured wave cold: no chain cached (the chat template's
        # bytes open every prompt), so every lane holds its own pages and
        # the pressured wave runs the pool dry.
        eng._prefix.clear()
        cold = _wave(eng, ENGINE_TOKENS, together=True)
        eng._prefix.clear()
        pressured = _wave(eng, pressured_tokens, together=True)
        return {"cold": cold, "pressured": pressured}

    off_engine = make(pool)
    try:
        off = serve_waves(off_engine)
    finally:
        off_engine.stop()
    del off_engine
    if on_card:
        torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    sinks = {name: os.path.join(tmp, f"{name}.jsonl") for name in ("requests", "trace", "events")}
    # A fresh registry, flight ring and timeline for the armed engine (the
    # ledgers resolve their counters at construction).
    metrics.registry.clear()
    metrics.flight.clear()
    timeline.clear()
    # Off the card no table entry: peaks of the CPU's own order, so the
    # rehearsal's roofline gates run.
    peaks = {} if on_card else {"peak_tflops": 1.0, "peak_hbm_gbps": 100.0}
    armed_engine = make(pool, blackbox_dir=os.path.join(tmp, "blackbox"),
                        blackbox_min_interval_s=0.0, blackbox_p99_mult=3.0, **peaks)
    api = ApiServer(gen, engine=armed_engine, request_log=sinks["requests"],
                    trace_jsonl=sinks["trace"], events_jsonl=sinks["events"])
    server = api.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_port
    try:
        counters = _zero_counters()
        armed = serve_waves(armed_engine)
        launches = _counts(counters)
        answers = {route: _get(port, route) for route in OBS_ROUTES}
        ids = [rid for w in armed.values() for rid in w["request_ids"]]
        explains = {rid: _get(port, f"/explain?request_id={rid}") for rid in ids}
        stats = dict(armed_engine.stats)
        blackbox = armed_engine.blackbox.stats()
    finally:
        metrics.flight.attach_jsonl(None)
        timeline.attach_jsonl(None)
        server.shutdown()
        server.server_close()
        api.close()
        thread.join(30)
    del armed_engine, api
    if on_card:
        torch.cuda.empty_cache()

    bad = {r: code for r, (code, _) in answers.items() if code != 200}
    bad.update({f"/explain {rid}": code for rid, (code, _) in explains.items() if code != 200})
    values = _exposition(answers["/metrics"][1]) if not bad else {}
    eff = json.loads(answers["/efficiency"][1]) if not bad else {}
    trace = json.loads(answers["/trace"][1]) if not bad else {"traceEvents": []}
    log_lines = [json.loads(line) for line in open(sinks["requests"])]
    wall_of = {r["request_id"]: r["wall_s"] for r in log_lines}
    explained = {rid: json.loads(body) for rid, (code, body) in explains.items() if code == 200}
    sums = {rid: {"wall_s": e["wall_s"], "phase_sum_s": sum(e["phases"].values()),
                  "coverage": e["coverage"], "log_wall_s": wall_of.get(rid),
                  "restore_s": e["phases"].get("restore", 0.0), "dominant": e["dominant"]}
            for rid, e in explained.items()}
    finished = len(ids) + ENGINE_BATCH  # the warm-up wave's too
    completed = sum(r["completion_tokens"] for r in log_lines if r["finish_reason"] in
                    ("stop", "length"))
    counted = {
        "batches": (values.get("cake_engine_batches_total"), stats["batches"]),
        "requests": (values.get("cake_engine_completed_total"), finished),
        "submitted": (values.get("cake_engine_submitted_total"), finished),
        "tokens": (values.get('cake_goodput_tokens_total{class="completed"}'), completed),
        "prefix_hits": (values.get("cake_prefix_hits_total", 0.0), stats["prefix_hits"]),
        "preemptions": (values.get("cake_preemptions_total", 0.0), stats["preemptions"]),
        "restores": (values.get("cake_restores_total", 0.0), stats["restores"]),
    }
    roof = eff.get("roofline", {})
    names = {e.get("name") for e in trace["traceEvents"]}
    suffix = "" if on_card else "_plain"

    def cost(w):
        return {k: w[k] for k in ("ttft_p50_s", "ttft_max_s", "decode_ms_per_step", "wall_s",
                                  "batches", "joins", "preemptions", "restores", "prefix_hits")}

    row = {
        "phase": "obs",
        "card": main_path["card"],
        "config": {"kv_mode": "paged", "scheduler": "continuous", "page_size": ENGINE_PAGE,
                   "max_seq": ENGINE_MAX_SEQ, "max_batch": ENGINE_BATCH, "pool_pages": pool,
                   "decode_chunk": 8, "tokens_out": ENGINE_TOKENS,
                   "pressure_tokens_out": pressured_tokens, "step_prefill": ENGINE_MAX_SEQ,
                   "layers": config.num_hidden_layers},
        "armed": {k: cost(w) for k, w in armed.items()},
        "off": {k: cost(w) for k, w in off.items()},
        "armed_equal_off": {k: _equal_streams(armed[k]["streams"], off[k]["streams"])
                            for k in armed},
        "routes": {r: code for r, (code, _) in answers.items()},
        "counters": {k: {"metrics": a, "engine": b} for k, (a, b) in counted.items()},
        "efficiency": {k: eff.get(k) for k in ("wall_s", "accounted_s", "device_s", "dispatches",
                                              "buckets", "goodput_frac", "tokens")},
        "roofline": roof, "model": eff.get("model"),
        # The weights a decode step streams over the cold wave's ms a step,
        # against the card's memory rate: the decode's own bandwidth share.
        "decode_weight_stream_frac": (
            main_path["weights_gb"] * 1e9 / (armed["cold"]["decode_ms_per_step"] / 1e3)
            / HBM_BYTES_PER_S if main_path.get("weights_gb") else None),
        "accounted_frac": eff["accounted_s"] / eff["wall_s"] if eff.get("wall_s") else None,
        "explain": sums,
        "explain_restore": sum(v["restore_s"] > 0 for v in sums.values()),
        "trace_errors": validate_export(trace)[:5],
        "trace_events": len(trace["traceEvents"]),
        "request_log_lines": len(log_lines),
        "events_jsonl_lines": sum(1 for _ in open(sinks["events"])),
        "trace_jsonl_events": len(load_jsonl(sinks["trace"])),
        "blackbox": blackbox,
        "launches": launches,
        "seconds": time.perf_counter() - t0,
    }
    emit(row)
    if bad:
        raise AssertionError(f"obs: routes answered {bad}")
    if any(n != ENGINE_BATCH for n in row["armed_equal_off"].values()):
        raise AssertionError(f"obs: armed streams equal off {row['armed_equal_off']} (8/8 each)")
    if any(a != b for a, b in counted.values()):
        raise AssertionError(f"obs: /metrics counters differ from the engine's: {row['counters']}")
    if not row["accounted_frac"] or row["accounted_frac"] < 0.95:
        raise AssertionError(f"obs: /efficiency buckets cover {row['accounted_frac']} of the wall")
    for key in ("mfu", "mbu"):
        if not 0.0 < roof.get(key, 0.0) <= 1.0:
            raise AssertionError(f"obs: /efficiency {key} {roof.get(key)} outside (0, 1]")
    for rid in ids:
        v = sums.get(rid)
        if v is None or v["log_wall_s"] is None:
            raise AssertionError(f"obs: request {rid} has no explanation or no request-log line")
        # The reference's tolerance (tests/test_critpath.py): the phases sum
        # to at least 95% of the end-to-end time less 50 ms and at most 50
        # ms over it; the end-to-end time is the request log's.
        e2e = v["log_wall_s"]
        if not 0.95 * e2e - OBS_EXPLAIN_SLACK_S <= v["phase_sum_s"] <= e2e + OBS_EXPLAIN_SLACK_S:
            raise AssertionError(f"obs: /explain of {rid} does not add up: {v}")
    if row["explain_restore"] < 1 or armed["pressured"]["restores"] < 1:
        raise AssertionError("obs: the pressured wave shows no restore phase")
    if row["trace_errors"] or not {"segment", "step"} <= names:
        raise AssertionError(f"obs: /trace invalid or without segment/step spans "
                             f"{row['trace_errors']}")
    if len(log_lines) != finished or not set(ids) <= set(wall_of):
        raise AssertionError(f"obs: {len(log_lines)} request-log lines for {finished} requests")
    for name in ("paged_decode_attention", "paged_chunk_attention"):
        if not launches[name + suffix]:
            raise AssertionError(f"obs: {name}{suffix} never launched in the armed waves")
    return row


ADMISSION_TOKENS = 32  # tokens out of the admission phase's waves
# The watchdog's bound: above a decode graph's capture at Llama-3-8B (a new
# decode key captures under the 1x bound once its op has run).
ADMISSION_STALL_S = 2.0
ADMISSION_FLOOD = 24  # tenant A's requests in the fairness scenario
# Every gate armed, none tripped by a wave of 8: the quota and the shed
# gates far above it, a deadline far beyond it, the watchdog, the SLO
# tracker with objectives and its feedback.
ARMED = dict(tenant_rate=1e6, tenant_burst=1e7, tenant_streams=64, shed_queue_depth=256,
             shed_min_free_pages=1, default_deadline_s=600.0, epoch_stall_s=ADMISSION_STALL_S,
             slo_ttft_ms=10000.0, slo_deadline_rate=0.5, stream_buffer_tokens=8192)


class _StalledDecode:
    """Wraps an engine backend's ``decode``. Its first call stalls on the
    host until the next wave's first decode; then, on its abandoned thread
    (the guard's, under the engine's stream), it fills every buffer it
    captured with garbage (its KV, its operands, every decode chunk's
    static buffers and KV) and only then calls the real decode, which must
    refuse (the backend abandoned that storage). Later calls release it and
    wait for those writes first, so they are queued on the engine's stream
    between the next epoch's prefill and its first decode."""

    def __init__(self, torch, backend):
        self.torch, self.backend, self.real = torch, backend, backend.decode
        self.calls = 0
        self.stalled, self.release, self.wrote = (threading.Event() for _ in range(3))
        self.t_stalled = None
        self.old_kv = None
        self.late_error = None
        backend.decode = self

    def __call__(self, kv, *args):
        torch = self.torch
        self.calls += 1
        if self.calls > 1:
            self.release.set()
            if not self.wrote.wait(600):
                raise AssertionError("the stalled dispatch never wrote its garbage")
            return self.real(kv, *args)
        bufs = [kv.k, kv.v] + [a for a in args if isinstance(a, torch.Tensor)]
        for c in list(self.backend._chunks.values()):
            bufs += [c.tok, c.slot, c.ring, c.ring_idx, c.keys, c.ids, c.kv.k, c.kv.v,
                     *c.extra.values()]
        self.old_kv = kv
        self.t_stalled = time.perf_counter()
        self.stalled.set()
        self.release.wait(600)
        try:
            for t in bufs:
                t.fill_(float("nan") if t.is_floating_point() else 7)
        finally:
            self.wrote.set()
        try:
            return self.real(kv, *args)
        except BaseException as e:  # noqa: BLE001 - kept for the gate
            self.late_error = e
            raise


class _StalledInside:
    """Stalls an engine backend's next decode INSIDE the real dispatch,
    after its storage check passed: in ``DecodeChunk.run``, which for a new
    key captures the chunk's graph and replays it on the card. The next
    wave's first decode releases it without waiting, so on waking it
    captures and replays over the abandoned storage while the next epoch
    captures its own graphs: the two take turns at their chunk runs
    (``fused.CARD_RUN_LOCK``). ``close()`` restores both wrapped calls."""

    def __init__(self, fused, backend):
        self.fused, self.backend, self.outer = fused, backend, backend.decode
        self.inner = fused.DecodeChunk.run
        self.calls, self.thread = 0, None
        self.stalled, self.release, self.done = (threading.Event() for _ in range(3))
        self.t_stalled = self.t_woke = self.t_done = None
        self.late_error = None
        inside = self

        def run(chunk, **inputs):
            if threading.current_thread() is not inside.thread:
                return inside.inner(chunk, **inputs)
            inside.t_stalled = time.perf_counter()
            inside.stalled.set()
            inside.release.wait(600)
            inside.t_woke = time.perf_counter()
            try:
                return inside.inner(chunk, **inputs)
            except BaseException as e:  # noqa: BLE001 - kept for the row
                inside.late_error = e
                raise
            finally:
                inside.t_done = time.perf_counter()
                inside.done.set()

        fused.DecodeChunk.run = run
        backend.decode = self

    def __call__(self, *args):
        self.calls += 1
        if self.calls == 1:
            self.thread = threading.current_thread()  # the guard's, for this dispatch
        else:
            self.release.set()
        return self.outer(*args)

    def close(self) -> None:
        self.release.set()
        self.fused.DecodeChunk.run = self.inner
        self.backend.__dict__.pop("decode", None)


@contextlib.contextmanager
def _take_order(engine):
    """Record each non-empty ``take`` of the engine's fair queue (one
    admission round: an epoch's admission or a chunk boundary's joins) as
    the list of request ids it dequeued."""
    rounds: list[list[str]] = []
    real = engine._queue.take

    def take(limit, accept):
        out = real(limit, accept)
        if out:
            rounds.append([r.rid for r in out])
        return out

    engine._queue.take = take
    try:
        yield rounds
    finally:
        del engine._queue.take


def _gated_wave(torch, engine, n_layers: int, on_card: bool, *args, **kw) -> dict:
    """``_wave`` with the launch gate: the paged kernels' launches against
    the backend's recorded dispatches (n_layers per decode step and per
    prefill dispatch, every other kernel 0)."""
    counters = _zero_counters()
    with dispatch_recorder(engine.backend) as rec:
        wave = _wave(engine, *args, **kw)
    launches, expected = _engine_fused_expected(counters, rec, set(), "paged", n_layers, on_card)
    wave["launches"], wave["expected_launches"] = launches, expected
    return wave


def _refusal(fn) -> dict | None:
    """None if ``fn()`` was admitted, else the refusal's type, kind and
    Retry-After."""
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 - the refusal is the result
        return {"type": type(e).__name__, "kind": getattr(e, "kind", None),
                "retry_after_s": getattr(e, "retry_after_s", None)}


def _sse_cancel(port: int, body: dict) -> dict:
    """Open an SSE chat, read its first event for the id, cancel it over
    ``POST /api/v1/cancel`` and read the stream to its end."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/api/v1/chat/completions", json.dumps({**body, "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"engine_admission: the chat to cancel got {resp.status}: "
                                 f"{resp.read()[:300]!r}")
        line = resp.readline().decode()
        while line and not line.startswith("data: "):
            line = resp.readline().decode()
        if not line:
            raise AssertionError("engine_admission: the chat to cancel sent no event")
        rid = json.loads(line[6:])["id"]
        c2 = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c2.request("POST", "/api/v1/cancel", json.dumps({"id": rid}),
                   {"Content-Type": "application/json"})
        r2 = c2.getresponse()
        cancel = (r2.status, json.loads(r2.read()))
        c2.close()
        rest = resp.read().decode()
    finally:
        conn.close()
    events = [json.loads(x[6:]) for x in rest.splitlines() if x.startswith("data: {")]
    finish = [e["choices"][0]["finish_reason"] for e in events
              if e.get("choices") and e["choices"][0]["finish_reason"]]
    return {"id": rid, "cancel_status": cancel[0], "cancel_body": cancel[1],
            "finish_reason": finish[-1] if finish else None,
            "chunks": sum(1 for e in events if e.get("choices"))}


def _chat(port: int, body: dict, headers=None) -> tuple[int, dict, str]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/api/v1/chat/completions", json.dumps(body),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read().decode()
    finally:
        conn.close()


def phase_engine_admission(torch, main_path: dict, tokens: int = ADMISSION_TOKENS,
                           flood: int = ADMISSION_FLOOD,
                           stall_s: float = ADMISSION_STALL_S) -> dict:
    """Admission on the paged engine (page 128, max_seq 2048, 8 lanes,
    prefix cache on, epoch scheduler unless named), over the generate
    phase's Llama-3-8B weights, one engine at a time (``tokens`` out, 32):

      * equal streams and timing: wave 1 cold (the prefix cache cleared)
        on an engine with every gate armed (``ARMED``: quotas, shed gates,
        default deadline, the watchdog, SLO objectives and feedback) across
        4 tenants, and the same requests, in the order the fair queue
        admitted them, on an engine with every gate off, each after a
        warm-up wave of its shapes: equal streams 8/8 (gated); ms a decode
        step, TTFT p50/max, ms a decode dispatch side by side, and the
        guard's cost a dispatch (a no-op through ``_dispatch``, guarded
        against inline);
      * launches: the paged kernels' = n_layers x the recorded dispatches,
        on every gated wave (gated);
      * fair queueing: tenant A's ``flood`` requests then tenant B's 2, one
        group, 8 tokens out: with the fair queue B's both leave the queue
        within the first two admission rounds, with ``fair_queue=False``
        after all of A's (gated);
      * quota: a stream cap of 2 refuses a tenant's third submission, a
        bucket of 1.5 long requests its second (429s); a finished stream
        frees its slot (gated);
      * shedding: the depth gate (4) sheds low priority at depth 2 and
        normal at 4, keeps high, and refunds the quota charge; the page
        gate with the prefix cache holding cold pages does not shed
        (gated);
      * deadlines: a queued request (other knobs than the running plug's)
        expires with no page mapped; a running stream finishes
        "deadline" at a chunk boundary beside an untouched one; under the
        continuous scheduler on the pool of one epoch's charges, the
        priority-0 lanes carry deadlines, each spilled lane's deadline is
        moved to the moment it is parked, and none is restored; every page
        not cached is free after each wave (gated);
      * the API over the quota engine: a 429 and a 503 (the page gate),
        each with Retry-After, and a stream cancelled over
        ``/api/v1/cancel`` (gated);
      * the watchdog: on the armed engine, a host-side stall in one decode
        dispatch ends its epoch's 8 streams "error" within the bound
        (``stall_s``); the stalled thread, released at the next wave's
        first decode, fills every buffer it captured with NaN on the
        engine's stream and is refused by the backend; that wave's greedy
        streams equal the gates-off engine's cold wave 1 bitwise (gated);
      * the watchdog inside the dispatch: a sampled wave's first decode (a
        new key, so under the first call's grace) stalls in
        ``DecodeChunk.run`` after its storage check passed; its epoch's
        streams end "error" within the grace's bound; released at the next
        wave's first decode, it captures and replays its graph over the
        abandoned storage while that wave captures its own (the two chunk
        runs take turns, ``fused.CARD_RUN_LOCK``); that wave's streams
        equal the gates-off engine's sampled wave 1 bitwise, with no stream
        error (gated).
    """
    from cake_tpu_torch.models.llama import fused
    from cake_tpu_torch.models.llama.chat import Message
    from cake_tpu_torch.models.llama.generator import SamplingConfig
    from cake_tpu_torch.runtime.api import ApiServer
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    gen = main_path["generator"]
    config, params, dev = gen.config, gen.step.params, gen.step.device
    n_layers = config.num_hidden_layers
    on_card = dev.type == "cuda"
    greedy = SamplingConfig(temperature=0.0, repeat_penalty=1.0)
    t0 = time.perf_counter()

    def make(**kw):
        serve = ServeConfig(max_batch=ENGINE_BATCH, decode_chunk_size=8, kv_mode="paged",
                            page_size=ENGINE_PAGE, prefix_cache=True, **kw)
        return BatchEngine(config, params, gen.tokenizer, max_seq_len=ENGINE_MAX_SEQ,
                           cache_dtype=torch.bfloat16, serve=serve, device=dev)

    def free_card() -> None:
        # Called with no engine referenced: its KV storage and graphs go first.
        if on_card:
            torch.cuda.empty_cache()

    def pool_whole(eng) -> bool:
        snap = eng.snapshot()
        return (snap["spilled"] == 0
                and snap["pages_free"] == snap["pages_total"] - snap["prefix"]["pages"])

    def strip(w):
        return {k: v for k, v in w.items() if k not in ("streams", "launches",
                                                         "expected_launches")}

    def guard_us(eng, n: int = 200) -> float:
        eng._dispatch("noop", lambda: None)  # the op's first call
        t = time.perf_counter()
        for _ in range(n):
            eng._dispatch("noop", lambda: None)
        return 1e6 * (time.perf_counter() - t) / n

    gates: dict[str, bool] = {}
    gated_waves = []
    sampled = [SamplingConfig(seed=100 + i, **SAMPLED_KNOBS) for i in range(ENGINE_BATCH)]
    real_run = fused.DecodeChunk.run
    # Decode graphs captured by each engine's first wave: on the guard
    # thread (armed) and on the engine thread (off).
    warm_captures: dict[str, dict] = {}
    wave1 = engine_messages()
    tenants = [f"t{i % 4}" for i in range(ENGINE_BATCH)]

    # -- equal streams and timing: armed, then off in the armed admission order
    eng = make(**{**ARMED, "epoch_stall_s": stall_s})
    try:
        warm_captures["armed"] = _captures_of(
            fused, lambda: _wave(eng, tokens, warm_messages(), together=True))[1]
        eng._prefix.clear()
        with _take_order(eng) as rounds:
            armed = _gated_wave(torch, eng, n_layers, on_card, tokens, wave1, together=True,
                                submit_kw=[{"tenant": t, "request_id": f"a{i}"}
                                           for i, t in enumerate(tenants)])
        gated_waves.append(armed)
        order = [int(rid[1:]) for r in rounds for rid in r]
        armed_guard_us = guard_us(eng)
        # -- the watchdog on the same engine (its ops' first calls are spent)
        eng._prefix.clear()
        stall = _StalledDecode(torch, eng.backend)
        stalled = _wave(eng, tokens, engine_messages(USER_TURNS[::-1]), together=True)
        t_detected = time.perf_counter()
        storage_dropped = eng.backend._pool is None
        after, after_captures = _captures_of(fused, lambda: _gated_wave(
            torch, eng, n_layers, on_card, tokens, wave1, together=True))
        gated_waves.append(after)
        old_nan = bool(torch.isnan(stall.old_kv.k[0, :2]).all())
        late = repr(stall.late_error)
        stall_row = {
            "bound_s": stall_s,
            "stalled_to_streams_ended_s": t_detected - stall.t_stalled,
            "finish_reasons": stalled["finish_reasons"],
            "completion_tokens": stalled["completion_tokens"],
            "epoch_stalls": eng.stats["epoch_stalls"], "storage_dropped": storage_dropped,
            "old_storage_nan": old_nan, "late_dispatch_refused": late,
            "guard_resolved_late": eng._guard.resolved,
            "after": strip(after), "after_captures": after_captures,
        }
        del stall
        # -- the watchdog inside the dispatch: a capture wakes beside the
        # next epoch's (released without waiting; the next wave is not
        # launch-gated, the late replay adds to the counters)
        eng._prefix.clear()
        inside = _StalledInside(fused, eng.backend)
        errors_before = eng.stats["stream_errors"]
        stalled2 = _wave(eng, tokens, engine_messages(USER_TURNS[::-1]), samplings=sampled,
                         together=True)
        t_detected2 = time.perf_counter()
        errors_stalled = eng.stats["stream_errors"]
        t_next = time.perf_counter()
        after2, after2_captures = _captures_of(
            fused, lambda: _wave(eng, tokens, wave1, samplings=sampled, together=True))
        t_next_end = time.perf_counter()
        inside.release.set()  # already set by the next wave's first decode, if it ran
        woke = inside.done.wait(120)
        while eng._guard.resolved < 2 and time.perf_counter() - t_next_end < 60:
            time.sleep(0.01)
        inside_row = {
            "bound_s": stall_s * eng._guard.FIRST_CALL_GRACE,
            "stalled_to_streams_ended_s": t_detected2 - inside.t_stalled,
            "finish_reasons": stalled2["finish_reasons"],
            "stream_errors": [errors_stalled - errors_before,
                              eng.stats["stream_errors"] - errors_stalled],
            "epoch_stalls": eng.stats["epoch_stalls"],
            "late_woke_after_next_wave_start_s": inside.t_woke - t_next,
            "late_ran_s": inside.t_done - inside.t_woke if woke else None,
            "next_wave_s": t_next_end - t_next,
            "late_error": repr(inside.late_error), "guard_resolved_late": eng._guard.resolved,
            "after": strip(after2), "after_captures": after2_captures,
        }
        inside.close()
        del inside
        armed_pool_whole = pool_whole(eng)
    finally:
        eng.backend.__dict__.pop("decode", None)  # the stall wrapper, if still there
        fused.DecodeChunk.run = real_run
        eng.stop()
    eng = None
    free_card()
    eng = make()
    try:
        warm_captures["off"] = _captures_of(
            fused, lambda: _wave(eng, tokens, warm_messages(), together=True))[1]
        eng._prefix.clear()
        cold1 = _gated_wave(torch, eng, n_layers, on_card, tokens, wave1, together=True)
        eng._prefix.clear()
        off = _gated_wave(torch, eng, n_layers, on_card, tokens, [wave1[i] for i in order],
                          together=True)
        gated_waves += [cold1, off]
        off_guard_us = guard_us(eng)
        small_pool = _pool_for_one_epoch(eng, wave1)
        # -- deadlines: a queued request with other knobs expires unmapped
        mapped = []
        real_map = eng.backend.allocator.map_range

        def map_range(lane, lo, hi):
            mapped.append(lane)
            return real_map(lane, lo, hi)

        eng.backend.allocator.map_range = map_range
        plug = eng.submit(wave1[0], 3 * tokens, greedy)
        while not plug.completion_tokens:  # its epoch is running
            time.sleep(0.001)
        n_mapped = len(mapped)
        doomed = eng.submit(wave1[1], tokens, SamplingConfig(seed=5, **SAMPLED_KNOBS),
                            deadline_s=0.05)
        doomed_ids = [t.id for t in doomed.tokens()]
        plug_ids = [t.id for t in plug.tokens()]
        queued_expiry = {
            "finish_reason": doomed.finish_reason, "tokens": len(doomed_ids),
            "lanes_mapped_while_queued": sorted(set(mapped[n_mapped:])),
            "plug_tokens": len(plug_ids),
        }
        del eng.backend.allocator.map_range
        if not eng.wait_idle(600):
            raise AssertionError("engine_admission: the plug never finished")
        queued_expiry["pool_whole"] = pool_whole(eng)
        # -- a running stream past its deadline, beside one without
        eng._prefix.clear()
        running = _wave(eng, [8 * tokens, tokens], wave1[:2], together=True,
                        submit_kw=[{"deadline_s": 0.3}, {}])
        running["pool_whole"] = pool_whole(eng)
        eng._prefix.clear()
        off_sampled = _wave(eng, tokens, wave1, samplings=sampled, together=True)
        off_pool_whole = pool_whole(eng)
    finally:
        eng.stop()
    by_request = [None] * len(order)
    for pos, i in enumerate(order):
        by_request[i] = off["streams"][pos]
    equal_streams = sum(x == y for x, y in zip(armed["streams"], by_request))
    after_equal = sum(x == y for x, y in zip(after["streams"], cold1["streams"]))
    inside_row["equal_streams_after"] = sum(
        x == y for x, y in zip(after2["streams"], off_sampled["streams"]))
    inside_row["finish_reasons_after"] = [after2["finish_reasons"], off_sampled["finish_reasons"]]

    # -- fair queueing: tenant A's flood, then tenant B's 2, as one group
    fairness = {}
    flood_msgs = [engine_messages()[i % ENGINE_BATCH] for i in range(flood + 2)]
    flood_kw = ([{"tenant": "A", "request_id": f"A{i}"} for i in range(flood)]
                + [{"tenant": "B", "request_id": f"B{i}"} for i in range(2)])
    for fair in (True, False):
        eng = None
        free_card()
        eng = make(fair_queue=fair)
        try:
            with _take_order(eng) as rounds:
                w = _gated_wave(torch, eng, n_layers, on_card, 8, flood_msgs, together=True,
                                submit_kw=flood_kw)
            gated_waves.append(w)
            flat = [rid for r in rounds for rid in r]
            fairness["fair" if fair else "fifo"] = {
                "rounds": len(rounds), "round_sizes": [len(r) for r in rounds],
                "b_rounds": [i for i, r in enumerate(rounds) if any(x[0] == "B" for x in r)],
                "b_positions": [flat.index(f"B{i}") for i in range(2)],
                "finish_reasons": sorted(set(w["finish_reasons"])),
                "pool_whole": pool_whole(eng), **{k: w[k] for k in ("batches", "joins")},
            }
        finally:
            eng.stop()

    # -- quota, shedding and the API on one engine
    short = [Message.user("hi")]
    long_cost = len(gen.tokenizer.encode(_dialog_text(config, wave1[0]))) + 4
    eng = None
    free_card()
    eng = make(tenant_streams=2, tenant_rate=1.0, tenant_burst=1.5 * long_cost,
               shed_queue_depth=4)
    api = server = thread = None
    try:
        quota = {
            "streams": [_refusal(lambda: eng.submit(short, 4, greedy, tenant="s"))
                        for _ in range(3)],
            "rate": [_refusal(lambda: eng.submit(wave1[0], 4, greedy, tenant="r"))
                     for _ in range(2)],
        }
        before = eng.tenant_meter.snapshot().get("sh")
        shed = {"low": _refusal(lambda: eng.submit(short, 4, greedy, tenant="sh", priority=0)),
                "normal_at_3": _refusal(lambda: eng.submit(short, 4, greedy, tenant="sh")),
                "normal_at_4": _refusal(lambda: eng.submit(short, 4, greedy, tenant="sh")),
                "high_at_4": _refusal(lambda: eng.submit(short, 4, greedy, tenant="sh",
                                                         priority=2))}
        snap_sh = eng.tenant_meter.snapshot()["sh"]
        shed["refunded"] = (before is None and snap_sh["active_streams"] == 2
                            and snap_sh["tokens"] == 2 * (len(gen.tokenizer.encode(
                                _dialog_text(config, short))) + 4))
        eng.start()
        if not eng.wait_idle(600):
            raise AssertionError("engine_admission: the quota engine did not drain")
        quota["slot_freed"] = _refusal(lambda: eng.submit(short, 4, greedy, tenant="s")) is None
        if not eng.wait_idle(600):
            raise AssertionError("engine_admission: the quota engine did not drain")
        alloc, cold = eng.backend.allocator, eng._prefix.reclaimable()
        eng.shed_min_free_pages = alloc.pages_free + cold
        shed["page_gate"] = {"pages_free": alloc.pages_free, "cold_pages": cold,
                             "floor": eng.shed_min_free_pages,
                             "refusal": _refusal(lambda: eng.submit(short, 2, greedy))}
        if not eng.wait_idle(600):
            raise AssertionError("engine_admission: the quota engine did not drain")
        eng.shed_min_free_pages = 0
        api = ApiServer(gen, default_max_tokens=4, engine=eng)
        server = api.make_server("127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_port
        body = {"messages": [m.to_dict() for m in wave1[0]], "max_tokens": 4}
        api_row = {"first": _chat(port, {**body, "tenant": "api"})[0]}
        status, headers, text = _chat(port, body, {"X-Cake-Tenant": "api"})
        api_row["429"] = {"status": status, "retry_after": headers.get("Retry-After"),
                          "error": text[:160]}
        eng.shed_min_free_pages = alloc.pages_total + 1
        status, headers, text = _chat(port, {**body, "tenant": "api503", "priority": 0})
        eng.shed_min_free_pages = 0
        api_row["503"] = {"status": status, "retry_after": headers.get("Retry-After"),
                          "error": text[:160]}
        api_row["cancel"] = _sse_cancel(port, {**body, "max_tokens": 1024, "tenant": "cancel"})
        if not eng.wait_idle(600):
            raise AssertionError("engine_admission: the API engine did not drain")
        api_row["pool_whole"] = quota_pool_whole = pool_whole(eng)
        counts = {k: eng.stats[k] for k in ("shed", "quota_refusals", "cancelled")}
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(60)
        eng.stop()

    # -- continuous: a spilled lane past its deadline is never restored
    api = server = thread = eng = None
    free_card()
    eng = make(scheduler="continuous", max_pages=small_pool)
    spilled, restored = [], []
    real_spill, real_restore, real_seed = eng._spill_lane, eng._restore_lane, eng._pop_spill_seed

    def spill(rows, lane, *a, **kw):
        req = rows[lane].req
        real_spill(rows, lane, *a, **kw)
        with eng._cv:
            if req.rid in eng._spilled and req.deadline:
                spilled.append(req.rid)
                req.deadline = time.monotonic()  # its deadline passes while it is parked

    def restore(sp, *a, **kw):
        restored.append(sp.row.req.rid)
        return real_restore(sp, *a, **kw)

    def seed():
        out = real_seed()
        restored.extend(sp.row.req.rid for sp in out)
        return out

    eng._spill_lane, eng._restore_lane, eng._pop_spill_seed = spill, restore, seed
    try:
        pressure = _gated_wave(
            torch, eng, n_layers, on_card, 6 * tokens, wave1, together=True,
            submit_kw=[{"request_id": f"c{i}", "priority": 0 if i >= 6 else 1,
                        **({"deadline_s": 600.0} if i >= 6 else {})}
                       for i in range(ENGINE_BATCH)])
        gated_waves.append(pressure)
        spill_row = {
            "small_pool": small_pool, "spilled_with_deadline": spilled,
            "restored": restored, "finish_reasons": pressure["finish_reasons"],
            "completion_tokens": pressure["completion_tokens"],
            "preemptions": pressure["preemptions"], "restores": pressure["restores"],
            "deadline_expired": pressure["deadline_expired"], "pool_whole": pool_whole(eng),
        }
    finally:
        # The wrappers close over the engine: drop them so it goes with its
        # last reference.
        del eng._spill_lane, eng._restore_lane, eng._pop_spill_seed
        eng.stop()

    real_spill = real_restore = real_seed = eng = None
    free_card()
    launches_ok = all(w["launches"] == w["expected_launches"] for w in gated_waves)
    row = {
        "phase": "engine_admission",
        "card": main_path["card"],
        "config": {"kv_mode": "paged", "page_size": ENGINE_PAGE, "max_seq": ENGINE_MAX_SEQ,
                   "max_batch": ENGINE_BATCH, "prefix_cache": True, "decode_chunk": 8,
                   "tokens_out": tokens, "armed": ARMED, "layers": n_layers},
        "timing": {
            "armed": strip(armed), "off": strip(off),
            "armed_ms_per_step": armed["decode_ms_per_step"],
            "off_ms_per_step": off["decode_ms_per_step"],
            "armed_ttft_p50_s": armed["ttft_p50_s"], "off_ttft_p50_s": off["ttft_p50_s"],
            "armed_ttft_max_s": armed["ttft_max_s"], "off_ttft_max_s": off["ttft_max_s"],
            "armed_ms_per_decode_dispatch": 1e3 * armed["decode_s"] / armed["decode_chunks"],
            "off_ms_per_decode_dispatch": 1e3 * off["decode_s"] / off["decode_chunks"],
            "guard_us_per_dispatch": armed_guard_us, "inline_us_per_dispatch": off_guard_us,
            "warm_captures": warm_captures,
        },
        "admission_order": order,
        "equal_streams": equal_streams,
        "watchdog": {**stall_row, "equal_streams_after": after_equal},
        "watchdog_inside": inside_row,
        "fairness": fairness,
        "quota": quota, "shed": shed, "api": api_row, "counts": counts,
        "deadlines": {"queued": queued_expiry,
                      "running": {k: running[k] for k in ("finish_reasons", "completion_tokens",
                                                          "deadline_expired", "pool_whole")},
                      "spilled": spill_row},
        "pools_whole": {"armed": armed_pool_whole, "off": off_pool_whole,
                        "quota": quota_pool_whole},
        "launch_gate": launches_ok,
        "seconds": time.perf_counter() - t0,
    }
    emit(row)
    n = ENGINE_BATCH
    gates["equal_streams"] = equal_streams == n
    gates["launches"] = launches_ok
    gates["fair"] = max(fairness["fair"]["b_rounds"]) <= 1
    gates["fifo"] = min(fairness["fifo"]["b_positions"]) >= flood
    gates["quota"] = ([r and r["kind"] for r in quota["streams"]] == [None, None, "streams"]
                      and [r and r["kind"] for r in quota["rate"]] == [None, "rate"]
                      and quota["rate"][1]["retry_after_s"] > 0 and quota["slot_freed"])
    gates["shed"] = ([shed[k] and shed[k]["type"] for k in ("low", "normal_at_3", "normal_at_4",
                                                             "high_at_4")]
                     == ["EngineOverloaded", None, "EngineOverloaded", None]
                     and shed["refunded"] and shed["page_gate"]["refusal"] is None
                     and shed["page_gate"]["cold_pages"] > 0)
    gates["queued_deadline"] = (queued_expiry["finish_reason"] == "deadline"
                                and queued_expiry["tokens"] == 0
                                and queued_expiry["lanes_mapped_while_queued"] in ([], [0])
                                and queued_expiry["pool_whole"])
    gates["running_deadline"] = (running["finish_reasons"][0] == "deadline"
                                 and 0 < running["completion_tokens"][0] < 8 * tokens
                                 and running["finish_reasons"][1] in ("stop", "length")
                                 and running["pool_whole"])
    gates["spilled_deadline"] = (len(spilled) >= 1 and not set(spilled) & set(restored)
                                 and all(pressure["finish_reasons"][int(r[1:])] == "deadline"
                                         for r in spilled)
                                 and spill_row["pool_whole"])
    gates["api"] = (api_row["first"] == 200 and api_row["429"]["status"] == 429
                    and int(api_row["429"]["retry_after"]) >= 1
                    and api_row["503"]["status"] == 503 and api_row["503"]["retry_after"] == "2"
                    and api_row["cancel"]["cancel_body"].get("cancelled") is True
                    and api_row["cancel"]["finish_reason"] == "cancelled")
    gates["watchdog"] = (stall_row["finish_reasons"] == ["error"] * n
                         and stall_row["stalled_to_streams_ended_s"] <= stall_s + 0.25
                         and storage_dropped and old_nan and "abandoned" in late
                         and after_equal == n)
    gates["watchdog_inside"] = (
        inside_row["finish_reasons"] == ["error"] * n
        and inside_row["stalled_to_streams_ended_s"] <= inside_row["bound_s"] + 0.25
        and inside_row["stream_errors"] == [n, 0] and inside_row["epoch_stalls"] == 2
        and inside_row["late_ran_s"] is not None and inside_row["equal_streams_after"] == n
        and inside_row["finish_reasons_after"][0] == inside_row["finish_reasons_after"][1])
    gates["pools_whole"] = all(row["pools_whole"].values()) and all(
        fairness[k]["pool_whole"] for k in fairness)
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"engine_admission gates failed: {failed}")
    row["launches"] = {name: sum(w["launches"][name] for w in gated_waves)
                       for name in ("paged_decode_attention", "paged_chunk_attention")}
    return row


def _captures_of(fused, run) -> tuple:
    """(``run()``, the decode graphs it captured: count, warm-up and capture
    seconds, from ``fused.STATS``)."""
    before = dict(fused.STATS)
    out = run()
    return out, {k: fused.STATS[k] - before[k] for k in ("captures", "warmup_s", "capture_s")}


def _dialog_text(config, messages) -> str:
    from cake_tpu_torch.models.llama.chat import encode_dialog

    return encode_dialog(messages, config.dialog_template)


# ---------------------------------------------------------------- phase 9d


class _LogitsTap:
    """A generator step that records the logits of its first one-token call
    after each reset (the first decode step) and passes everything on."""

    def __init__(self, step):
        self.step, self.first_decode = step, None
        self.device = getattr(step, "device", None)

    @property
    def max_seq_len(self) -> int:
        return self.step.max_seq_len

    def reset(self) -> None:
        self.first_decode = None
        self.step.reset()

    def __call__(self, tokens, pos, seq_len):
        logits = self.step(tokens, pos, seq_len)
        if self.first_decode is None and tokens.shape[1] == 1:
            self.first_decode = logits.clone()
        return logits


def _wire_totals(step) -> tuple[int, int]:
    """(round trips, payload bytes both ways) of a TCP step's clients."""
    return (sum(c.round_trips for c in step.clients.values()),
            sum(c.tx_bytes + c.rx_bytes for c in step.clients.values()))


def _tally_wire(step) -> dict:
    """From now on, {batch kind: [round trips, payload bytes both ways]} of
    ``step``'s clients' forwards (the measurement wraps each client)."""
    tally: dict = {}
    for client in step.clients.values():
        def counted(x, ranges, pos, batch=None, trace=None, _real=client.forward):
            out = _real(x, ranges, pos, batch=batch, trace=trace)
            t = tally.setdefault(batch["kind"] if batch else "stream", [0, 0])
            t[0] += 1
            t[1] += len(x.data) + len(out.data)
            return out

        client.forward = counted
    return tally


def _start_workers(torch, config, params, topo, max_seq: int, dev) -> dict:
    """In-process workers of ``topo`` over views of ``params`` (on the card
    already), each serving on its own threads on a loopback port."""
    from cake_tpu_torch.runtime.worker import Worker

    workers = {}
    for name in topo.nodes:
        w = Worker(name, None, topo, ("127.0.0.1", 0), dtype=torch.bfloat16, max_seq_len=max_seq,
                   device=dev, config=config, params=params)
        w.start()
        topo.nodes[name].host = f"127.0.0.1:{w.address[1]}"
        workers[name] = w
    return workers


def _tcp_generation(torch, main_path: dict, step, replays: list | None = None) -> dict:
    """The generate phase's prompt and 64 greedy tokens through ``step``:
    ids, first-decode-step logits, launches, ms a token, round trips and
    wire bytes a token. ``replays`` collects the history replays."""
    from cake_tpu_torch.models.llama.chat import Message
    from cake_tpu_torch.models.llama.generator import LlamaGenerator, SamplingConfig

    gen0 = main_path["generator"]
    tap = _LogitsTap(step)
    gen = LlamaGenerator(gen0.config, tap, gen0.tokenizer,
                         SamplingConfig(temperature=0.0, repeat_penalty=1.0),
                         prefill_chunk=PREFILL_CHUNK)
    if replays is not None:
        real = gen._replay_history
        gen._replay_history = lambda: (replays.append(len(gen._tokens)), real())[1]
    counters = _counters()
    for c in counters:
        c.launches = 0
    gen.add_message(Message.user(main_path["text"]))
    stamps, wire = [], []
    base = _wire_totals(step)
    on_token = lambda tok: (stamps.append(time.perf_counter()), wire.append(
        tuple(x - b for x, b in zip(_wire_totals(step), base))))
    t0 = time.perf_counter()
    gen.generate(DECODE_TOKENS, on_token=on_token)
    return {"gen": gen, "tap": tap, "ids": gen.generated_token_ids, "t0": t0, "stamps": stamps,
            "wire": wire, "launches": {c.__name__: c.launches for c in counters}}


def phase_distributed(torch, main_path: dict) -> dict:
    """Cake's master/worker pipeline over loopback TCP at the generate
    phase's weights and shapes (Llama-3-8B, 32 layers, bf16, the 700-token
    prompt in 256-token chunks, 64 greedy tokens), workers in this process
    on their own threads over views of the weights already on the card.

    A: the master runs layers 0-15, worker w1 16-31: ids equal the local
    generator's 64/64 and the first decode step's logits equal the local
    ones to the bit (gated), launch counts equal the local run's (gated);
    ms a token, round trips and wire bytes a token, a profile for the device
    idle share (not gated). B: w1 0-15, w2 16-31 and its replica w2b, the
    master running no layer: two sequences route to w2 and to w2b and give
    equal streams (gated). Recovery: topology A without wire retries, w1's
    socket closed under the master after 5 tokens: the stream equals the
    uninterrupted one with exactly one history replay (gated). Engine:
    ``DistributedBatchBackend`` over topology A against the dense local
    engine (max_seq 2048, 8 lanes, decode chunk 8): wave 1 submitted as one
    group, then the seeded sampled wave of engine_fused; streams equal 8/8
    and launch counts equal (gated); ms a decode step of each."""
    from cake_tpu_torch.models.llama.generator import SamplingConfig
    from cake_tpu_torch.parallel.topology import Topology
    from cake_tpu_torch.runtime.batch_backend import DistributedBatchBackend
    from cake_tpu_torch.runtime.master import DistributedForwardStep
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    t_phase = time.perf_counter()
    gen0 = main_path["generator"]
    config, params, dev = gen0.config, gen0.step.params, gen0.step.device
    n_layers = config.num_hidden_layers
    half = n_layers // 2
    on_card = dev.type == "cuda"

    def span(lo: int, hi: int) -> list[str]:
        return [f"model.layers.{lo}-{hi - 1}" if hi - lo > 1 else f"model.layers.{lo}"]

    want = main_path["generated_ids"]
    row = {"phase": "distributed", "card": main_path["card"],
           "topologies": {"A": {"master": [0, half], "w1": [half, n_layers]},
                          "B": {"w1": [0, half], "w2": [half, n_layers], "w2b": [half, n_layers]}}}

    # The local generator's first decode-step logits, at the same prompt.
    from cake_tpu_torch.models.llama.chat import Message
    from cake_tpu_torch.models.llama.generator import LlamaGenerator

    local_tap = _LogitsTap(gen0.step)
    local = LlamaGenerator(config, local_tap, gen0.tokenizer,
                           SamplingConfig(temperature=0.0, repeat_penalty=1.0),
                           prefill_chunk=PREFILL_CHUNK)
    local.add_message(Message.user(main_path["text"]))
    local.generate(2)
    local_logits = local_tap.first_decode

    workers = {}
    try:
        # -- A: master 0-15, w1 16-31.
        topo_a = Topology.from_dict({"w1": {"host": "placeholder", "layers": span(half, n_layers)}})
        workers.update(_start_workers(torch, config, params, topo_a, MAX_SEQ, dev))
        step = DistributedForwardStep(config, None, topo_a, dtype=torch.bfloat16,
                                      max_seq_len=MAX_SEQ, device=dev, params=params)
        _tcp_generation(torch, main_path, step)  # warm-up
        _sync(torch, dev)
        a = _tcp_generation(torch, main_path, step)
        _sync(torch, dev)
        stamps, wire = a["stamps"], a["wire"]
        n_gen = len(a["ids"])
        decode_ms = 1e3 * (stamps[-1] - stamps[0]) / (n_gen - 1)
        trips = (wire[-1][0] - wire[0][0]) / (n_gen - 1)
        nbytes = (wire[-1][1] - wire[0][1]) / (n_gen - 1)
        logits_bitwise = bool(torch.equal(a["tap"].first_decode, local_logits))
        row["A"] = {
            "equal_tokens": sum(x == y for x, y in zip(a["ids"], want)),
            "generated_tokens": n_gen,
            "first_decode_logits_bitwise": logits_bitwise,
            "first_decode_logits_max_abs": float(
                (a["tap"].first_decode - local_logits).abs().max()),
            "prefill_s": stamps[0] - a["t0"],
            "decode_ms_per_token": decode_ms,
            "local_decode_ms_per_token": main_path["decode_ms_per_token"],
            "round_trips_per_token": trips,
            "wire_bytes_per_token": nbytes,
            "prefill_round_trips": wire[0][0],
            "launches": a["launches"], "local_launches": main_path["launches"],
        }
        if on_card:
            try:
                prof = _profile_main_path(torch, a["gen"], main_path["text"], decode_ms,
                                          phase="distributed_profile")
                row["A"]["decode_device_ms_per_token"] = prof["decode_device_ms_per_token"]
                row["A"]["decode_device_idle_share"] = prof["decode_device_idle_share"]
            except AssertionError as e:  # the idle share is not gated
                row["A"]["profile_error"] = str(e)[:300]
        # -- Recovery: no wire retries, so the blip reaches the generator.
        rstep = DistributedForwardStep(config, None, topo_a, dtype=torch.bfloat16,
                                       max_seq_len=MAX_SEQ, device=dev, params=params,
                                       op_retries=0)
        replays: list = []
        blip = {"done": False}

        def close_after_5(tok):
            if len(blip_gen.generated_token_ids) == 5 and not blip["done"]:
                blip["done"] = True
                rstep.clients["w1"]._sock.close()

        from cake_tpu_torch.models.llama.generator import LlamaGenerator as _G

        blip_gen = _G(config, rstep, gen0.tokenizer,
                      SamplingConfig(temperature=0.0, repeat_penalty=1.0),
                      prefill_chunk=PREFILL_CHUNK)
        real = blip_gen._replay_history
        blip_gen._replay_history = lambda: (replays.append(len(blip_gen._tokens)), real())[1]
        blip_gen.add_message(Message.user(main_path["text"]))
        blip_gen.generate(DECODE_TOKENS, on_token=close_after_5)
        row["recovery"] = {
            "equal_tokens": sum(x == y for x, y in zip(blip_gen.generated_token_ids, want)),
            "generated_tokens": len(blip_gen.generated_token_ids), "replays": len(replays),
            "replayed_history_tokens": replays,
        }
        rstep.close()
        step.close()
        for w in workers.values():
            w.stop()
        workers.clear()

        # -- B: w1 0-15, w2 16-31 and its replica w2b; the master runs no layer.
        topo_b = Topology.from_dict({
            "w1": {"host": "placeholder", "layers": span(0, half)},
            "w2": {"host": "placeholder", "layers": span(half, n_layers)},
            "w2b": {"host": "placeholder", "layers": span(half, n_layers)},
        })
        workers.update(_start_workers(torch, config, params, topo_b, MAX_SEQ, dev))
        bstep = DistributedForwardStep(config, None, topo_b, dtype=torch.bfloat16,
                                       max_seq_len=MAX_SEQ, device=dev, params=params)
        streams, served = [], []
        for _ in range(2):
            before = {n: w.ops for n, w in workers.items()}
            streams.append(_tcp_generation(torch, main_path, bstep)["ids"])
            served.append(sorted(n for n, w in workers.items() if w.ops > before[n]))
        row["B"] = {"master_layers": sum(hi - lo for lo, hi in bstep.local_params),
                    "served": served, "equal_streams": streams[0] == streams[1],
                    "equal_tokens_to_local": sum(x == y for x, y in zip(streams[0], want))}
        bstep.close()
        for w in workers.values():
            w.stop()
        workers.clear()

        # -- Engine: DistributedBatchBackend over topology A against the
        # dense local engine, one engine at a time.
        sampled = [SamplingConfig(seed=100 + i, **SAMPLED_KNOBS) for i in range(ENGINE_BATCH)]
        serve = dict(max_batch=ENGINE_BATCH, decode_chunk_size=8)
        topo_e = Topology.from_dict({"w1": {"host": "placeholder", "layers": span(half, n_layers)}})
        runs = {}
        for name in ("local", "tcp"):
            if name == "local":
                eng = BatchEngine(config, params, gen0.tokenizer, max_seq_len=ENGINE_MAX_SEQ,
                                  cache_dtype=torch.bfloat16, serve=ServeConfig(**serve),
                                  device=dev)
            else:
                workers.update(_start_workers(torch, config, params, topo_e, ENGINE_MAX_SEQ, dev))
                estep = DistributedForwardStep(config, None, topo_e, dtype=torch.bfloat16,
                                               max_seq_len=ENGINE_MAX_SEQ, device=dev,
                                               params=params)
                eng = BatchEngine(config, None, gen0.tokenizer, max_seq_len=ENGINE_MAX_SEQ,
                                  cache_dtype=torch.bfloat16, serve=ServeConfig(**serve),
                                  backend=DistributedBatchBackend(estep))
            try:
                # Warm-up waves of wave 1's shapes (the local engine captures
                # its decode chunks' graphs), then the counted waves.
                _wave(eng, ENGINE_TOKENS, warm_messages(), together=True)
                _wave(eng, ENGINE_TOKENS, warm_messages(), samplings=sampled, together=True)
                counters = _zero_counters()
                if name == "tcp":
                    kinds = _tally_wire(estep)
                waves = [_wave(eng, ENGINE_TOKENS, together=True),
                         _wave(eng, ENGINE_TOKENS, samplings=sampled, together=True)]
                runs[name] = {"waves": waves, "launches": _counts(counters),
                              "node": eng.snapshot()["node"]}
                if name == "tcp":
                    steps = sum(w["decode_steps"] for w in waves)
                    runs[name]["wire_by_kind"] = kinds
                    runs[name]["round_trips_per_step"] = kinds["decode"][0] / steps
                    runs[name]["wire_bytes_per_step"] = kinds["decode"][1] / steps
            finally:
                eng.stop()
                if name == "tcp":
                    estep.close()
            if on_card:
                torch.cuda.empty_cache()
        equal = [sum(x == y for x, y in zip(a["streams"], b["streams"]))
                 for a, b in zip(runs["tcp"]["waves"], runs["local"]["waves"])]
        row["engine"] = {
            "equal_streams": equal, "node": runs["tcp"]["node"],
            "wire_by_kind": runs["tcp"]["wire_by_kind"],
            "round_trips_per_step": runs["tcp"]["round_trips_per_step"],
            "wire_bytes_per_step": runs["tcp"]["wire_bytes_per_step"],
            **{f"{n}_{k}": [w[k] for w in runs[n]["waves"]] for n in runs
               for k in ("decode_ms_per_step", "ttft_p50_s", "batches", "joins", "decode_steps")},
            "launches_equal": runs["tcp"]["launches"] == runs["local"]["launches"],
            "launches": {k: v for k, v in runs["tcp"]["launches"].items() if v},
        }
        for w in workers.values():
            w.stop()
        workers.clear()
        # -- Failover: topology B with heartbeats on, w2 unreachable for good
        # from mid-decode of wave 1: the live streams migrate to w2b. Then
        # topology A, w1 killed: no replica, the streams end "error".
        local_wave1 = runs["local"]["waves"][0]["streams"]
        topo_f = Topology.from_dict({
            "w1": {"host": "placeholder", "layers": span(0, half)},
            "w2": {"host": "placeholder", "layers": span(half, n_layers)},
            "w2b": {"host": "placeholder", "layers": span(half, n_layers)},
        })
        fo = _tcp_failover(torch, config, params, gen0.tokenizer, dev, topo_f, ENGINE_MAX_SEQ,
                           f"kill@client.send:node=w2:after={FAILOVER_AFTER}:count=0",
                           heartbeat=True, prefer="w2")
        fo["equal_streams"] = _equal_streams(fo["streams"], local_wave1)
        fo["next_wave_equal_streams"] = _equal_streams(fo["next_wave_streams"], local_wave1)
        topo_n = Topology.from_dict({"w1": {"host": "placeholder",
                                            "layers": span(half, n_layers)}})
        nr = _tcp_failover(torch, config, params, gen0.tokenizer, dev, topo_n, ENGINE_MAX_SEQ,
                           f"kill@client.send:node=w1:after={FAILOVER_AFTER}:count=0",
                           heartbeat=False, prefer="w1")
        nr["next_wave_equal_streams"] = _equal_streams(nr["next_wave_streams"], local_wave1)
        row["failover"] = {k: v for k, v in fo.items() if "streams" not in k or "equal" in k}
        row["no_replica"] = {k: v for k, v in nr.items() if "streams" not in k or "equal" in k}
    finally:
        for w in workers.values():
            w.stop()
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    gates = {
        "A ids equal the local stream": row["A"]["equal_tokens"] == len(want) == DECODE_TOKENS,
        "A first-decode logits bitwise": row["A"]["first_decode_logits_bitwise"],
        "A launches equal the local run's": row["A"]["launches"] == main_path["launches"],
        "B replica pair equal streams": row["B"]["equal_streams"],
        "B routed to both members": sorted(map(tuple, row["B"]["served"])) == [
            ("w1", "w2"), ("w1", "w2b")],
        "recovery equal stream": row["recovery"]["equal_tokens"] == len(want),
        "recovery one replay": row["recovery"]["replays"] == 1,
        "engine streams equal 8/8": equal == [ENGINE_BATCH, ENGINE_BATCH],
        "engine launches equal": row["engine"]["launches_equal"],
        "failover streams equal the local wave 8/8": fo["equal_streams"] == ENGINE_BATCH,
        "failover one failover, 8 recovered": (fo["failovers"], fo["recovered"]) == (
            1, ENGINE_BATCH),
        "failover cake_failover_total{w2} 1": fo["failover_total"]["w2"] == 1,
        "failover no error": fo["stream_errors"] == 0,
        "no replica streams end error": nr["finish_reasons"] == ["error"] * ENGINE_BATCH,
        "no replica every lane back": nr["live_after"] == 0,
        "no replica next wave served": all(
            f in ("stop", "length") for f in nr["next_wave_finish_reasons"]),
    }
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"distributed phase gates failed: {failed}")
    # The launches this phase adds to the kernels line: the TCP runs of A
    # and of the engine (the local runs are what they are held to).
    row["launches"] = {name: row["A"]["launches"].get(name, 0)
                       + runs["tcp"]["launches"].get(name, 0)
                       for name in ("decode_attention", "chunk_prefill_attention",
                                    "threefry_noise")}
    return row


# ---------------------------------------------------------------- phase 10-12


def _quantized_step(torch, main_path: dict, mode: str):
    """(config, params, step, quantize seconds, streamed bytes): the generate
    phase's weights quantized on the card, one layer slice at a time, and a
    step over them. The streamed bytes are what a decode token reads: every
    weight but the embedding (a gather of one row)."""
    from cake_tpu_torch.models.llama.generator import LocalForwardStep
    from cake_tpu_torch.ops.quant import quantize_params, quantized_bytes

    gen0 = main_path["generator"]
    dev = gen0.step.device
    t0 = time.perf_counter()
    params = quantize_params(gen0.step.params, mode)
    _sync(torch, dev)
    quant_s = time.perf_counter() - t0
    streamed = quantized_bytes({k: v for k, v in params.items() if k != "embed"})
    step = LocalForwardStep(gen0.config, params, max_seq_len=MAX_SEQ,
                            cache_dtype=torch.bfloat16, device=dev)
    return gen0.config, params, step, quant_s, streamed


def _quantized_generate(torch, main_path: dict, step, chunk: int, n_tokens: int, int4: bool,
                        f8: bool = False):
    """One warmed-up greedy run of the generate phase's prompt over ``step``
    (an int4 tree, or an ``f8`` cache) with ``chunk``-token decode, gated on
    the launches its forwards imply."""
    from cake_tpu_torch.models.llama.chat import Message
    from cake_tpu_torch.models.llama.generator import LlamaGenerator, LocalForwardStep

    gen0, text = main_path["generator"], main_path["text"]
    dev = step.device
    gen = LlamaGenerator(gen0.config, step, gen0.tokenizer, gen0.sampling,
                         prefill_chunk=PREFILL_CHUNK, decode_chunk_size=chunk)
    gen.add_message(Message.user(text))
    gen.generate(chunk + 2)  # warm-up
    _sync(torch, dev)
    counters = _zero_counters()
    gen.reset()
    gen.add_message(Message.user(text))
    stamps = []
    with step_recorder(LocalForwardStep) as rec:
        t_start = time.perf_counter()
        gen.generate(n_tokens, on_token=lambda tok: stamps.append(time.perf_counter()))
        _sync(torch, dev)
    launches, expected = _generator_expected(
        counters, rec, gen0.config.num_hidden_layers, dev.type == "cuda", fused=False, int4=int4,
        f8=f8, moe=bool(gen0.config.num_local_experts), rolling=getattr(step, "rolling", False))
    ids = gen.generated_token_ids
    n_gen = len(ids)
    decode_s = stamps[-1] - stamps[0] if n_gen > 1 else float("nan")
    run = {
        "decode_chunk": chunk, "generated_tokens": n_gen, "chunks": len(rec["chunks"]),
        "step_calls": len(rec["calls"]), "prefill_s": stamps[0] - t_start,
        "decode_ms_per_token": 1e3 * decode_s / (n_gen - 1) if n_gen > 1 else None,
        "launches": launches, "expected_launches": expected,
    }
    if launches != expected:
        emit({"phase": "quantized_generate", **run})
        raise AssertionError(f"quantized generator launch counts {launches} != {expected}")
    if n_gen < 1 or not all(0 <= t < gen0.config.vocab_size for t in ids):
        raise AssertionError(f"generated ids out of range: {ids}")
    return gen, ids, run


def phase_generate_int4(torch, main_path: dict) -> dict:
    """The generate phase's weights in int4: 64 greedy tokens per token and
    with 8-token chunks (equal streams), every product on int4_matmul,
    full-width logits against the plain path, the device profile. Returns
    the row with the int4 params under "params" for phase engine_int4."""
    from cake_tpu_torch.models.llama import model as M

    config, params, step, quant_s, streamed = _quantized_step(torch, main_path, "int4")
    dev = step.device
    gen, ids, per_token = _quantized_generate(torch, main_path, step, 1, DECODE_TOKENS, True)
    _, ids_chunked, chunked = _quantized_generate(
        torch, main_path, step, FUSED_CHUNK, DECODE_TOKENS, True)
    row = {
        "phase": "generate_int4",
        "card": main_path["card"],
        "quantize_s": quant_s,
        "streamed_gb": streamed / 1e9,
        "decode_bound_ms_per_token": streamed / HBM_BYTES_PER_S * 1e3,
        "runs": [per_token, chunked],
        "chunked_equal_tokens": sum(a == b for a, b in zip(ids, ids_chunked)),
        "bf16_decode_ms_per_token": main_path["decode_ms_per_token"],
        "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None,
    }
    emit(row)
    if ids_chunked != ids:
        raise AssertionError(f"int4 chunked decode parted from per-token decode: {row}")
    if dev.type == "cuda":
        row["profile"] = _profile_main_path(torch, gen, main_path["text"],
                                            per_token["decode_ms_per_token"], phase="profile_int4")
    row["check"] = _full_model_check(torch, M, config, step.params, dev, phase="int4_model_check")
    row["int4_launches"] = sum(r["launches"]["int4_matmul"] for r in row["runs"])
    row["params"] = step.params
    del gen, step
    return row


def _stream_agreement(a: list, b: list) -> int:
    """How many leading ids two streams share."""
    same = 0
    while same < min(len(a), len(b)) and a[same] == b[same]:
        same += 1
    return same


def phase_generate_f8(torch, main_path: dict) -> dict:
    """The generate phase's weights over an f8 KV cache (``--kv-dtype f8``):
    the same prompt, 64 greedy tokens per token and in FUSED_CHUNK-token
    graph-replayed chunks (equal streams, gated), every decode and
    continuation launch over f8 (the counters' ``f8`` side counts, gated),
    the graph against its eager loop to the bit (greedy and sampled, gated),
    full-width logits through the f8 kernels against the plain versions;
    wall and device ms a token, the KV bytes beside a bf16 cache's, and
    the greedy agreement with phase generate's bf16 stream (random weights:
    reported, not gated)."""
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.generator import LocalForwardStep

    f8 = torch.float8_e4m3fn
    gen0, text = main_path["generator"], main_path["text"]
    dev = gen0.step.device
    on_card = dev.type == "cuda"
    step = LocalForwardStep(gen0.config, gen0.step.params, max_seq_len=MAX_SEQ, cache_dtype=f8,
                            device=dev)
    kv_bytes = 2 * step._kv.k.numel() * step._kv.k.element_size()
    gen, ids, per_token = _quantized_generate(torch, main_path, step, 1, DECODE_TOKENS, False,
                                              f8=True)
    profile = (_profile_main_path(torch, gen, text, per_token["decode_ms_per_token"],
                                  phase="profile_f8") if on_card else None)
    gen8, ids8, chunked = _quantized_generate(torch, main_path, step, FUSED_CHUNK, DECODE_TOKENS,
                                              False, f8=True)
    profile8 = (_profile_main_path(torch, gen8, text, chunked["decode_ms_per_token"],
                                   phase="profile_f8_graph") if on_card else None)
    bits = {name: _generator_bits(torch, step, gen0.tokenizer, text, knobs)
            for name, knobs in GRAPH_KNOBS.items()}
    row = {
        "phase": "generate_f8",
        "card": main_path["card"],
        "kv_dtype": "f8",
        "kv_bytes": kv_bytes,
        "bf16_kv_bytes": 2 * kv_bytes,
        "runs": [per_token, chunked],
        "chunked_equal_tokens": sum(a == b for a, b in zip(ids, ids8)),
        "graph_bits": bits,
        "device_ms_per_token": profile and profile["decode_device_ms_per_token"],
        "graph_device_ms_per_token": profile8 and profile8["decode_device_ms_per_token"],
        "bf16_decode_ms_per_token": main_path["decode_ms_per_token"],
        "bf16_greedy_agreement": _stream_agreement(ids, main_path["generated_ids"]),
        "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
    }
    emit(row)
    if ids8 != ids:
        raise AssertionError(f"f8 chunked decode parted from per-token decode: {row}")
    for name, b in bits.items():
        if not (all(b["chunks_equal"]) and b["kv_equal"] and b["key_equal"]
                and b["per_step_equal"]):
            raise AssertionError(f"f8 generator graph parted from its eager loop ({name}): {b}")
    row["check"] = _full_model_check(torch, M, gen0.config, step.params, dev,
                                     phase="f8_model_check", cache_dtype=f8)
    row["f8_launches"] = {name: sum(r["launches"][name + ".f8"] for r in row["runs"])
                          for name in ("decode_attention", "chunk_prefill_attention")}
    del gen, gen8, step
    if on_card:
        torch.cuda.empty_cache()
    return row


def phase_engine_f8(torch, main_path: dict, engine_path: dict) -> dict:
    """The batch engine over an f8 cache (``--kv-dtype f8``), one engine at a
    time: paged (prefix cache on) and dense, with fusion "none" and "all".
    The paged engines serve wave 1 cold and again warm (prefix hits), the
    dense ones wave 1. Gates: every launch over f8 (the side counts), paged
    streams equal dense 8/8 and warm equal cold 8/8 under each fusion, the
    full-width paged and dense forwards with each fusion through the f8
    kernels against the plain versions, and the f8 pool half the bytes of
    phase engine's bf16 pool at the same lanes x slots. "all" against
    "none" is reported, not gated (random weights)."""
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    f8 = torch.float8_e4m3fn
    gen = main_path["generator"]
    config, params, dev = gen.config, gen.step.params, gen.step.device
    n_layers = config.num_hidden_layers
    on_card = dev.type == "cuda"

    def make(**kw):
        serve = ServeConfig(max_batch=ENGINE_BATCH, decode_chunk_size=8, **kw)
        eng = BatchEngine(config, params, gen.tokenizer, max_seq_len=ENGINE_MAX_SEQ,
                          cache_dtype=f8, serve=serve, device=dev)
        eng.start()
        return eng

    runs = {}
    for spec, kv_mode in (("none", "paged"), ("none", "dense"), ("all", "paged"),
                          ("all", "dense")):
        # The compared waves one request at a time, as engine_int4's: a
        # wave the admission window splits shows in its batches and joins.
        runs[spec, kv_mode] = _fused_engine_run(torch, make, spec, kv_mode, n_layers, on_card,
                                                sampled=False, f8=True, warm=kv_mode == "paged",
                                                together=False)
        if on_card:
            torch.cuda.empty_cache()

    def equal(a, b):
        return sum(x == y for x, y in zip(a["streams"], b["streams"]))

    def summary(r):
        w = r["waves"][0]
        out = {"spec": r["spec"], "kv_mode": r["kv_mode"], "ttft_p50_s": w["ttft_p50_s"],
               "ttft_max_s": w["ttft_max_s"], "decode_ms_per_step": w["decode_ms_per_step"],
               "decode_tok_s": w["decode_tok_s"], "profile_wave_wall_ms": r["profile_wave_wall_ms"],
               "profile": r["profile"], "kv_bytes": r["kv_bytes"], "launches": r["launches"],
               "expected_launches": r["expected_launches"],
               "batches_joins": [[x["batches"], x["joins"]] for x in r["waves"]]}
        if len(r["waves"]) > 1:
            warm = r["waves"][1]
            out.update(warm_ttft_p50_s=warm["ttft_p50_s"], warm_prefix_hits=warm["prefix_hits"],
                       warm_decode_ms_per_step=warm["decode_ms_per_step"])
        return out

    row = {
        "phase": "engine_f8",
        "card": main_path["card"],
        "kv_dtype": "f8",
        "config": {"page_size": ENGINE_PAGE, "max_seq": ENGINE_MAX_SEQ, "max_batch": ENGINE_BATCH,
                   "decode_chunk": 8, "tokens_out": ENGINE_TOKENS, "layers": n_layers},
        "runs": [summary(r) for r in runs.values()],
        "wave_submitted": "one request at a time",
        "pool_bytes": runs["none", "paged"]["kv_bytes"],
        "bf16_pool_bytes": engine_path["pool_bytes"],
        "dense_equal_paged": {spec: equal(runs[spec, "dense"]["waves"][0],
                                          runs[spec, "paged"]["waves"][0])
                              for spec in ("none", "all")},
        "warm_equal_cold": {spec: equal(runs[spec, "paged"]["waves"][1],
                                        runs[spec, "paged"]["waves"][0])
                            for spec in ("none", "all")},
        "all_equal_none": equal(runs["all", "paged"]["waves"][0], runs["none", "paged"]["waves"][0]),
    }
    emit(row)
    for r in runs.values():
        if r["launches"] != r["expected_launches"]:
            raise AssertionError(
                f"f8 {r['kv_mode']} engine with fusion {r['spec']}: launch counts "
                f"{r['launches']} != expected {r['expected_launches']}")
        for w in r["waves"]:
            if not all(1 <= len(ids) <= ENGINE_TOKENS and all(0 <= t < config.vocab_size for t in ids)
                       for ids in w["streams"]):
                raise AssertionError(f"engine streams out of range: {w['completion_tokens']}")
    for spec in ("none", "all"):
        if row["dense_equal_paged"][spec] != ENGINE_BATCH:
            raise AssertionError(f"f8 dense engine streams differ from paged ({spec}): {row}")
        if row["warm_equal_cold"][spec] != ENGINE_BATCH:
            raise AssertionError(f"f8 warm wave streams differ from cold ({spec}): {row}")
        if runs[spec, "paged"]["waves"][1]["prefix_hits"] <= 0:
            raise AssertionError(f"the f8 warm wave took no prefix-cache hit ({spec})")
    if 2 * row["pool_bytes"] != row["bf16_pool_bytes"]:
        raise AssertionError(f"the f8 pool is not half the bf16 pool: {row}")
    for spec in ("none", "all"):
        fused_config = dataclasses.replace(config, fusion_impl=spec)
        for kv_mode in ("paged", "dense"):
            row[f"{kv_mode}_{spec}_check"] = _batch_model_check(
                torch, fused_config, params, dev, kv_mode, phase=f"{kv_mode}_{spec}_f8_model_check",
                cache_dtype=f8)
    row["f8_launches"] = {
        name: sum(r["launches"][name + ".f8"] for r in runs.values())
        for name in ("decode_attention", "chunk_prefill_attention", "paged_decode_attention",
                     "paged_chunk_attention", "fused_qkv_ingest")}
    return row


def phase_engine_int4(torch, main_path: dict, int4_path: dict) -> dict:
    """Wave 1 over the int4 weights through the paged engine, the dense
    engine and the paged engine with every fusion, one engine at a time,
    each wave submitted one request at a time (the admission window
    gathers it; each run's batches and joins are in its row, so a wave the
    window splits shows as more than one batch or as joins); then
    int4_matmul timed at the engine's first prefill window into w_gu
    (layer 0's quantized weight)."""
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    gen = main_path["generator"]
    config, params, dev = gen.config, int4_path["params"], gen.step.device
    n_layers = config.num_hidden_layers
    on_card = dev.type == "cuda"

    def make(**kw):
        serve = ServeConfig(max_batch=ENGINE_BATCH, decode_chunk_size=8, **kw)
        eng = BatchEngine(config, params, gen.tokenizer, max_seq_len=ENGINE_MAX_SEQ,
                          cache_dtype=torch.bfloat16, serve=serve, device=dev)
        eng.start()
        return eng

    runs = []
    for spec, kv_mode in (("none", "paged"), ("none", "dense"), ("all", "paged")):
        runs.append(_fused_engine_run(torch, make, spec, kv_mode, n_layers, on_card,
                                      sampled=False, int4=True, together=False))
        if on_card:
            torch.cuda.empty_cache()
    paged, dense, fused = runs

    def summary(r):
        w = r["waves"][0]
        return {"spec": r["spec"], "kv_mode": r["kv_mode"], "ttft_p50_s": w["ttft_p50_s"],
                "ttft_max_s": w["ttft_max_s"], "decode_ms_per_step": w["decode_ms_per_step"],
                "decode_tok_s": w["decode_tok_s"], "profile_wave_wall_ms": r["profile_wave_wall_ms"],
                "profile": r["profile"], "prefills": r["prefills"][:4], "launches": r["launches"],
                "expected_launches": r["expected_launches"],
                "batches_joins": [[x["batches"], x["joins"]] for x in r["waves"]]}

    def equal(a, b):
        return sum(x == y for x, y in zip(a["waves"][0]["streams"], b["waves"][0]["streams"]))

    row = {
        "phase": "engine_int4",
        "card": main_path["card"],
        "config": {"page_size": ENGINE_PAGE, "max_seq": ENGINE_MAX_SEQ, "max_batch": ENGINE_BATCH,
                   "decode_chunk": 8, "tokens_out": ENGINE_TOKENS, "layers": n_layers},
        "runs": [summary(r) for r in runs],
        "wave_submitted": "one request at a time",
        "dense_equal_paged": equal(dense, paged),
        "all_equal_none": equal(fused, paged),
    }
    emit(row)
    for r in runs:
        if r["launches"] != r["expected_launches"]:
            raise AssertionError(
                f"int4 {r['kv_mode']} engine with fusion {r['spec']}: launch counts "
                f"{r['launches']} != expected {r['expected_launches']}")
        for w in r["waves"]:
            if not all(1 <= len(ids) <= ENGINE_TOKENS and all(0 <= t < config.vocab_size for t in ids)
                       for ids in w["streams"]):
                raise AssertionError(f"engine streams out of range: {w['completion_tokens']}")
    if row["dense_equal_paged"] != ENGINE_BATCH:
        raise AssertionError(f"int4 dense engine streams differ from paged: {row['dense_equal_paged']}")
    row["int4_launches"] = sum(r["launches"]["int4_matmul"] for r in runs)
    if on_card:
        rows = paged["prefills"][0][0]
        g = torch.Generator(device=dev).manual_seed(12)
        case = _int4_case(torch, dev, g, "w_gu", [params["layers"]["w_gu"][0]], rows,
                          torch.bfloat16, case="w_gu_engine_prefill")
        row["kernel_rows"] = {("int4_matmul", case["case"]): case}
    return row


def phase_generate_int8(torch, main_path: dict) -> dict:
    """The generate phase's weights in int8: 16 greedy tokens per token and
    their device profile. int8 has no kernel of its own: each product
    converts the weight to the activation dtype, multiplies and scales."""
    config, params, step, quant_s, streamed = _quantized_step(torch, main_path, "int8")
    dev = step.device
    gen, ids, run = _quantized_generate(torch, main_path, step, 1, 16, False)
    row = {
        "phase": "generate_int8", "card": main_path["card"], "quantize_s": quant_s,
        "streamed_gb": streamed / 1e9, "decode_bound_ms_per_token": streamed / HBM_BYTES_PER_S * 1e3,
        "run": run, "bf16_decode_ms_per_token": main_path["decode_ms_per_token"],
    }
    emit(row)
    if dev.type == "cuda":
        row["profile"] = _profile_main_path(torch, gen, main_path["text"],
                                            run["decode_ms_per_token"], phase="profile_int8")
    del gen, step, params
    return row


# ---------------------------------------------------------------- phase 13

GRAPH_CHUNKS = 3  # chunks each generator bits check runs graph against eager
GRAPH_KNOBS = {"greedy": dict(temperature=0.0, repeat_penalty=1.0),
               "sampled": dict(seed=77, **SAMPLED_KNOBS)}


@contextlib.contextmanager
def eager_chunks():
    """Every DecodeChunk runs its loop op by op over its static buffers
    (``body``, the ops a replay runs) instead of replaying its graph: the
    eager side of the graph's timings and device-op counts."""
    from unittest import mock

    from cake_tpu_torch.models.llama.fused import DecodeChunk

    def run(self, **inputs):
        self.load(**inputs)
        self.body()
        return self.ids

    with mock.patch.object(DecodeChunk, "run", run):
        yield


def eager_generator_chunk(torch, step, kv, last_token, pos, n_steps, s, key, ring, ring_idx):
    """The generator's decode chunk as it ran before the graph:
    sampled_decode_loop over ``kv`` with a host-int slot, the inputs
    uploaded and the ids read back once (the plain version the graph is
    held against). Returns (ids, the advanced key)."""
    import numpy as np

    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.fused import sampled_decode_loop
    from cake_tpu_torch.ops.fuse import resolve_fusion

    dev = step.device

    def forward_one(tok, kv_, p):
        return M.forward(step.params, tok, kv_, p, 1, step.config, rope=step._rope)

    tok = torch.as_tensor(np.asarray(last_token, np.int64)).to(dev)
    ring_t = torch.as_tensor(np.asarray(ring, np.int64)).to(dev)
    ring_idx_t = torch.full((tok.shape[0],), int(ring_idx), dtype=torch.int64, device=dev)
    with torch.inference_mode():
        toks, _, key, _, _ = sampled_decode_loop(
            forward_one, kv, tok, int(pos), key, ring_t, ring_idx_t, n_steps=n_steps, s=s,
            fused_tail="tail" in resolve_fusion(step.config))
    return toks.cpu().numpy(), key


def _generator_bits(torch, step, tokenizer, text, knobs: dict) -> dict:
    """GRAPH_CHUNKS decode chunks through ``step.decode_chunk`` (its graph,
    replayed at moving slots) and through ``eager_generator_chunk`` on a
    clone of the cache and of the dialog's threefry key, from the same
    prefill: the ids of each chunk, the whole cache and the advanced key
    after them, to the bit. Then the same dialog decoded per step (a fresh
    generator, one split of the key a token) must give the same ids as the
    first token and the chunks ("per_step_equal")."""
    import numpy as np

    from cake_tpu_torch.models.llama.cache import KVCache
    from cake_tpu_torch.models.llama.chat import Message
    from cake_tpu_torch.models.llama.generator import LlamaGenerator, SamplingConfig
    from cake_tpu_torch.ops.kv_dtype import kv_view

    s = SamplingConfig(**knobs)
    dev = step.device
    gen = LlamaGenerator(step.config, step, tokenizer, s, prefill_chunk=PREFILL_CHUNK,
                         decode_chunk_size=FUSED_CHUNK)
    gen.add_message(Message.user(text))
    gen.generate(1)  # the prefill and the first token
    history = list(gen._tokens)
    key = gen._key
    ref_key = key.clone()
    ref = KVCache(step._kv.k.clone(), step._kv.v.clone())
    window = s.repeat_last_n
    chunks = []
    for _ in range(GRAPH_CHUNKS):
        ring = np.full((1, window), -1, np.int64)
        recent = history[-window:]
        ring[0, : len(recent)] = recent
        ring_idx = min(len(history), window) % window
        pos = len(history) - 1
        got, key = step.decode_chunk(np.asarray([history[-1]]), pos, FUSED_CHUNK, s, key, ring,
                                     ring_idx)
        want, ref_key = eager_generator_chunk(torch, step, ref, [history[-1]], pos, FUSED_CHUNK,
                                              s, ref_key, ring, ring_idx)
        chunks.append(bool(np.array_equal(got, want)))
        history += got[0].tolist()
    _sync(torch, dev)
    out = {"chunks_equal": chunks,
           "kv_equal": bool(torch.equal(kv_view(step._kv.k), kv_view(ref.k))
                            and torch.equal(kv_view(step._kv.v), kv_view(ref.v))),
           "key_equal": bool(torch.equal(key, ref_key))}
    del ref
    chunked = history[gen.prompt_tokens:]
    per_step = LlamaGenerator(step.config, step, tokenizer, s, prefill_chunk=PREFILL_CHUNK)
    per_step.add_message(Message.user(text))
    per_step.generate(len(chunked))
    out["per_step_equal"] = per_step.generated_token_ids == chunked[:len(
        per_step.generated_token_ids)] and len(per_step.generated_token_ids) > 1
    return out


@contextlib.contextmanager
def graph_vs_eager(torch, backend):
    """Hold every decode dispatch of ``backend`` (a DecodeChunk replay on the
    card) against its eager plain version: the cache and the carries are
    cloned before the dispatch, and ``batch.decode_chunk`` /
    ``paged_decode_chunk`` (sampled_decode_loop with a host-int slot, the
    table uploaded) runs on the clones after it; its ids, cache and carries
    must equal the dispatch's to the bit. Yields the tally: dispatches,
    equal ones, short chunks (the capacity edge), chunks after a table or
    pads change."""
    from cake_tpu_torch.models.llama import batch as B
    from cake_tpu_torch.ops.kv_dtype import kv_view

    rec = {"dispatches": 0, "equal": 0, "short_chunks": 0, "table_changes": 0,
           "pads_changes": 0, "first_mismatch": None}
    decode = backend.decode
    paged = backend.kv_mode == "paged"
    seen = {"tables": None, "pads": None}

    def call(kv, tok, slot, pads, keys, ring, ring_idx, n, s):
        with torch.inference_mode():
            tables = torch.as_tensor(backend._host_tables()).to(backend.device) if paged else None
            ref = type(kv)(kv.k.clone(), kv.v.clone())
            r_tok, r_pads, r_keys, r_ring, r_idx = (
                t.clone() for t in (tok, pads, keys, ring, ring_idx))
            out = decode(kv, tok, slot, pads, keys, ring, ring_idx, n, s)
            if paged:
                want = B.paged_decode_chunk(backend.params, ref, r_tok, int(slot), r_pads, tables,
                                            r_keys, r_ring, r_idx, backend.config, n, s,
                                            backend.rope)
            else:
                want = B.decode_chunk(backend.params, ref, r_tok, int(slot), r_pads, r_keys,
                                      r_ring, r_idx, backend.config, n, s, backend.rope)
            ok = (torch.equal(out[0], want[0]) and torch.equal(kv_view(kv.k), kv_view(ref.k))
                  and torch.equal(kv_view(kv.v), kv_view(ref.v))
                  and all(torch.equal(a, b) for a, b in zip(out[2:], want[2:])))
        rec["dispatches"] += 1
        rec["equal"] += int(ok)
        if not ok and rec["first_mismatch"] is None:
            rec["first_mismatch"] = {"slot": int(slot), "n": n, "graph": out[0].tolist(),
                                     "eager": want[0].tolist()}
        rec["short_chunks"] += int(n < FUSED_CHUNK)
        if paged:
            now = tables.cpu()
            rec["table_changes"] += int(seen["tables"] is not None and not (
                seen["tables"].shape == now.shape and torch.equal(seen["tables"], now)))
            seen["tables"] = now
        now = r_pads.cpu()
        rec["pads_changes"] += int(seen["pads"] is not None and not torch.equal(seen["pads"], now))
        seen["pads"] = now
        del ref
        return out

    backend.decode = call
    try:
        yield rec
    finally:
        del backend.decode


def _engine_bits(torch, make, spec: str, kv_mode: str, ragged: bool) -> dict:
    """One engine with fusion ``spec`` under ``graph_vs_eager``: wave 1
    greedy and the sampled wave (64 tokens), the ragged wave (joins: pads
    and tables change between chunks of one graph), and a 32-token wave,
    whose epoch capacity (the 480-slot bucket plus 32, 512) ends it on a
    7-step chunk: the capacity edge's own graph."""
    from cake_tpu_torch.models.llama.generator import SamplingConfig

    kw = {"kv_mode": "paged", "page_size": ENGINE_PAGE, "prefix_cache": True} \
        if kv_mode == "paged" else {}
    eng = make(fusion_impl=spec, **kw)
    try:
        with graph_vs_eager(torch, eng.backend) as rec:
            _wave(eng, ENGINE_TOKENS)
            _wave(eng, ENGINE_TOKENS, samplings=[
                SamplingConfig(seed=300 + i, **SAMPLED_KNOBS) for i in range(ENGINE_BATCH)])
            if ragged:
                _wave(eng, ENGINE_TOKENS, engine_messages(RAGGED_TURNS))
            _wave(eng, 32)
        graphs = len(eng.backend._chunks)
    finally:
        eng.stop()
    return {"spec": spec, "kv_mode": kv_mode, "graphs": graphs, **rec}


def _chunk_ops(torch, chunk, repeats: int = 5) -> dict:
    """Device ops of one decode chunk three ways, each the count most of
    ``repeats`` complete traces hold (``_complete_trace``; a complete trace
    can still lack a few events besides the launch kernels, PERF.md, PR 9;
    every count is kept under "traces", and a spread is emitted with the
    events by name and by launching thread): its graph's replay (held to
    its capture's launch record); its loop run op by op over the same
    buffers (the eager side, the same ops); and the loop with a host-int
    slot over copies of its carries (the path before the graph). Run at the
    end of the chunk's use: each writes the cache past the live slots."""
    from cake_tpu_torch.models.llama.fused import sampled_decode_loop

    replay = dict.fromkeys(KERNEL_WRAPPERS, 0)
    for (fn, what), n in chunk.captured.items():
        if what == "launches" and fn.__name__ in replay:
            replay[fn.__name__] += n
    with torch.inference_mode():
        slot = int(chunk.slot)
        carries = [t.clone() for t in (chunk.tok, chunk.keys, chunk.ring, chunk.ring_idx)]

        def int_slot():
            tok, keys, ring, ring_idx = carries
            sampled_decode_loop(chunk.forward_one, chunk.kv, tok, slot, keys, ring, ring_idx,
                                n_steps=chunk.n_steps, s=chunk.s, fused_tail=chunk.fused_tail)

        traces = {}
        for name, fn, expect in (("graph", chunk.graph.replay, replay),
                                 ("eager", chunk.body, None), ("int_slot", int_slot, None)):
            runs = [_complete_trace(torch, fn, expect=expect)[0] for _ in range(repeats)]
            traces[name] = [len(r) for r in runs]
            if len(set(traces[name])) > 1:  # what the outlying traces held
                most, fewest = max(runs, key=len), min(runs, key=len)
                emit({"phase": "chunk_ops_spread", "chunk": name, "traces": traces[name],
                      "names": ops_diff(*(_tally(r, "name") for r in (most, fewest))),
                      "launchers": ops_diff(*(_tally(r, "launch_tid") for r in (most, fewest))),
                      "main_tid": threading.get_native_id()})
    return {"steps": chunk.n_steps, **{k: statistics.mode(v) for k, v in traces.items()},
            "traces": traces}


def _tally(events, key: str) -> dict:
    """Device events by name (cut at its argument list) or by launching thread."""
    import collections

    return collections.Counter(str(e.get(key, "")).split("(")[0][:96] for e in events)


def _generator_timing(torch, step, tokenizer, text, eager: bool, name: str) -> dict:
    """64 greedy tokens in FUSED_CHUNK-token chunks after a warm-up run
    (which captures the chunk's graph): wall ms a token, then the device
    profile of 16 tokens (ms, ops and idle share), each chunk a replay or,
    with ``eager``, its loop run op by op (``eager_chunks``); in a graph
    run, ``_chunk_ops`` of its chunk."""
    from cake_tpu_torch.models.llama.chat import Message
    from cake_tpu_torch.models.llama.generator import LlamaGenerator, SamplingConfig

    dev = step.device
    gen = LlamaGenerator(step.config, step, tokenizer, SamplingConfig(**GRAPH_KNOBS["greedy"]),
                         prefill_chunk=PREFILL_CHUNK, decode_chunk_size=FUSED_CHUNK)
    with eager_chunks() if eager else contextlib.nullcontext():
        gen.add_message(Message.user(text))
        gen.generate(FUSED_CHUNK + 2)
        gen.reset()
        gen.add_message(Message.user(text))
        stamps = []
        gen.generate(DECODE_TOKENS, on_token=lambda tok: stamps.append(time.perf_counter()))
        _sync(torch, dev)
        ms = 1e3 * (stamps[-1] - stamps[0]) / (len(stamps) - 1)
        profile = chunk_ops = None
        if dev.type == "cuda":
            profile = _profile_main_path(torch, gen, text, ms,
                                         phase=f"profile_{name}_{'eager' if eager else 'graph'}")
            if not eager:
                chunk_ops = _chunk_ops(torch, max(step._chunks.values(), key=lambda c: c.replays))
    return {"name": name, "mode": "eager" if eager else "graph", "decode_ms_per_token": ms,
            "ids": gen.generated_token_ids, "profile": profile, "chunk_ops": chunk_ops}


WAVE_TRIES = 3  # times _engine_timing serves wave 1 at most


def _engine_timing(torch, make, spec: str, eager: bool) -> dict:
    """The paged engine with fusion ``spec``: after a warm-up wave of wave
    1's shapes, wave 1 (64 tokens) for its ms a decode step, then
    unprofiled and profiled waves of 16 and 32 tokens (their difference:
    device ops and ms of 16 steps), each decode chunk a replay or, with
    ``eager``, its loop run op by op; in a graph run, ``_chunk_ops`` of its
    most replayed chunk. Wave 1 is served again (at most WAVE_TRIES times)
    until it runs as one epoch with no join: its streams are held to the
    other mode's, and a wave split by the admission window prefills its
    joined rows alone, on other GEMM shapes."""
    eng = make(fusion_impl=spec, kv_mode="paged", page_size=ENGINE_PAGE, prefix_cache=True)
    try:
        with eager_chunks() if eager else contextlib.nullcontext():
            _wave(eng, ENGINE_TOKENS, warm_messages())
            for tries in range(1, WAVE_TRIES + 1):
                wave = _wave(eng, ENGINE_TOKENS)
                if _one_epoch(wave):
                    break
            _wave(eng, 32)
            timed = _wave(eng, 16)
            profile = chunk_ops = None
            if eng.backend.device.type == "cuda":
                short = _device_profile(torch, lambda: _wave(eng, 16), valid=_one_epoch)
                long = _device_profile(torch, lambda: _wave(eng, 32), valid=_one_epoch)
                profile = {
                    "device_ops_per_step": (long["device_ops"] - short["device_ops"]) / 16,
                    "device_ms_per_step": (long["device_ms"] - short["device_ms"]) / 16,
                    "device_idle_share": 1.0 - short["device_ms"] / (
                        1e3 * timed["wall_s"] - 1e3 * eng.admission_window),
                    "names": _minus(long["names"], short["names"]),
                    "launchers": _minus(long["launchers"], short["launchers"]),
                }
                if not eager:
                    chunk_ops = _chunk_ops(
                        torch, max(eng.backend._chunks.values(), key=lambda c: c.replays))
    finally:
        eng.stop()
    return {"spec": spec, "mode": "eager" if eager else "graph",
            "decode_ms_per_step": wave["decode_ms_per_step"], "streams": wave["streams"],
            "wave_tries": tries, "batches": wave["batches"], "joins": wave["joins"],
            "profile": profile, "chunk_ops": chunk_ops}


def phase_decode_graph(torch, main_path: dict, int4_path: dict) -> dict:
    """The decode chunk as one CUDA graph (DecodeChunk) against its eager
    plain version, in one run:

    * bits, gated: the generator (bf16 ``none`` and ``all``, int4; greedy and
      sampled) over GRAPH_CHUNKS chunks, and the engine dispatch by dispatch
      (``graph_vs_eager``: paged ``none`` and ``all``, int4 paged, dense
      ``all``; greedy, sampled, the ragged wave's joins and the capacity
      edge's 7-step chunk);
    * timings: the generator's wall ms a token and the paged engine's ms a
      decode step, graph and eager (``eager_chunks``) side by side, with
      device ms, ops and idle share; gated on the card: device ops a token
      and a step equal to eager's, over the whole profiled waves and over one
      chunk (``_chunk_ops``), a mismatch emitted with the events by name and
      by launching thread; the generator's wall ms a token under eager's;
      the same greedy streams;
    * the captures' cost: count, warm-up and capture seconds, the graph
      pool's growth."""
    from cake_tpu_torch.models.llama import fused
    from cake_tpu_torch.models.llama.generator import LocalForwardStep
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    gen0, text = main_path["generator"], main_path["text"]
    config, dev, tok = gen0.config, gen0.step.device, gen0.tokenizer
    on_card = dev.type == "cuda"
    bf16 = gen0.step.params
    int4 = int4_path["params"]
    all_config = dataclasses.replace(config, fusion_impl="all")
    steps = {
        "bf16_none": gen0.step,
        "bf16_all": LocalForwardStep(all_config, bf16, max_seq_len=MAX_SEQ,
                                     cache_dtype=torch.bfloat16, device=dev),
        "int4_none": LocalForwardStep(config, int4, max_seq_len=MAX_SEQ,
                                      cache_dtype=torch.bfloat16, device=dev),
    }
    generator_bits = {f"{name}_{kind}": _generator_bits(torch, step, tok, text, knobs)
                      for name, step in steps.items() for kind, knobs in GRAPH_KNOBS.items()}
    generator_timing = []
    for name, step in steps.items():
        # One graph run and one eager run a step: the eager runs are
        # host-bound traces of ~50 s each, and the smoke's wall limit binds.
        for eager in (False, True):
            generator_timing.append(_generator_timing(torch, step, tok, text, eager, name))
    del steps
    if on_card:
        torch.cuda.empty_cache()

    def make(params=bf16, **kw):
        serve = ServeConfig(max_batch=ENGINE_BATCH, decode_chunk_size=FUSED_CHUNK, **kw)
        eng = BatchEngine(config, params, tok, max_seq_len=ENGINE_MAX_SEQ,
                          cache_dtype=torch.bfloat16, serve=serve, device=dev)
        eng.start()
        return eng

    engine_bits = []
    for spec, kv_mode, params, ragged in (("none", "paged", bf16, False),
                                          ("all", "paged", bf16, True),
                                          ("none", "paged", int4, False),
                                          ("all", "dense", bf16, False)):
        engine_bits.append(dict(_engine_bits(torch, lambda **kw: make(params, **kw), spec, kv_mode,
                                             ragged), int4=params is int4))
        if on_card:
            torch.cuda.empty_cache()
    engine_timing = []
    for spec in ("none", "all"):
        for eager in (False, True):
            engine_timing.append(_engine_timing(torch, make, spec, eager))
            if on_card:
                torch.cuda.empty_cache()

    def ops(p, key):
        return None if p is None else p[key]

    row = {
        "phase": "decode_graph",
        "card": main_path["card"],
        "decode_chunk": FUSED_CHUNK,
        "generator_bits": generator_bits,
        "engine_bits": engine_bits,
        "generator_timing": [
            {k: v for k, v in t.items() if k not in ("ids", "profile")}
            | {"device_ms_per_token": ops(t["profile"], "decode_device_ms_per_token"),
               "device_ops_per_token": ops(t["profile"], "decode_device_ops_per_token"),
               "device_idle_share": ops(t["profile"], "decode_device_idle_share")}
            for t in generator_timing],
        "engine_timing": [
            {k: v for k, v in t.items() if k not in ("streams", "profile")}
            | {k: v for k, v in (t["profile"] or {}).items() if k not in ("names", "launchers")}
            for t in engine_timing],
        "captures": dict(fused.STATS, pool_mb=fused.STATS["pool_bytes"] / 2**20),
    }
    emit(row)
    for name, r in generator_bits.items():
        if not (all(r["chunks_equal"]) and r["kv_equal"] and r["key_equal"]
                and r["per_step_equal"]):
            raise AssertionError(f"generator {name}: the graph parted from the eager loop: {r}")
    for r in engine_bits:
        if r["dispatches"] == 0 or r["equal"] != r["dispatches"]:
            raise AssertionError(f"engine {r['spec']} {r['kv_mode']}: the graph parted from the "
                                 f"eager chunk: {r}")
        if r["kv_mode"] == "paged" and (r["short_chunks"] == 0 or r["table_changes"] == 0):
            raise AssertionError(f"paged engine {r['spec']}: no capacity-edge chunk or no chunk "
                                 f"after a table change: {r}")
    if not any(r["pads_changes"] for r in engine_bits):
        raise AssertionError("no engine chunk replayed after a join changed the pads")
    pairs = [(g, e) for g, e in zip(generator_timing[::2], generator_timing[1::2])]
    for g, e in pairs:
        if g["ids"] != e["ids"]:
            raise AssertionError(f"generator {g['name']}: graph and eager streams differ")
    for g, e in zip(engine_timing[::2], engine_timing[1::2]):
        if g["streams"] != e["streams"]:
            parted = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), min(len(x), len(y)))
                      if x != y else None for x, y in zip(g["streams"], e["streams"])]
            raise AssertionError(
                f"engine {g['spec']}: graph and eager streams differ (first differing token of "
                f"each stream: {parted}; graph wave {g['batches']} epochs, {g['joins']} joins, "
                f"eager {e['batches']}, {e['joins']})")
    if on_card:
        for g, e in pairs:
            if not g["decode_ms_per_token"] < e["decode_ms_per_token"]:
                raise AssertionError(f"generator {g['name']}: graph {g['decode_ms_per_token']} ms "
                                     f"a token, not below eager's {e['decode_ms_per_token']}")
        for t in generator_timing + engine_timing:
            ops = t["chunk_ops"]
            if ops is not None and ops["graph"] != ops["eager"]:
                raise AssertionError(f"{t.get('name') or t['spec']}: a chunk's replay ran "
                                     f"{ops['graph']} device ops, its loop {ops['eager']}")
        # The whole waves: device ops a token (16 generated tokens) and a
        # step (32-token wave less 16-token wave), graph against eager.
        waves = [(g["name"], "decode_device_ops_per_token", g["profile"], "decode_",
                  e["profile"]) for g, e in pairs]
        waves += [(g["spec"], "device_ops_per_step", g["profile"], "", e["profile"])
                  for g, e in zip(engine_timing[::2], engine_timing[1::2])]
        for name, key, g, prefix, e in waves:
            if g[key] != e[key]:
                diff = {"phase": "decode_graph_ops_diff", "run": name, key: [g[key], e[key]],
                        "names": ops_diff(g[prefix + "names"], e[prefix + "names"]),
                        "launchers": ops_diff(g[prefix + "launchers"], e[prefix + "launchers"]),
                        "main_tid": threading.get_native_id()}
                emit(diff)
                raise AssertionError(f"{name}: {key} graph {g[key]}, eager {e[key]}: {diff}")
    return row


# ---------------------------------------------------------------- phase 14


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _serve_and_chat(cmd: list[str], cwd: str) -> dict:
    """Start ``cmd`` (a CLI API server), wait for /health, answer one chat,
    and stop the server."""
    import http.client

    port = _free_port()
    with tempfile.TemporaryFile(mode="w+") as errs:
        proc = subprocess.Popen([*cmd, "--api", f"127.0.0.1:{port}"], cwd=cwd,
                                stdout=subprocess.DEVNULL, stderr=errs, text=True)
        try:
            deadline = time.monotonic() + 600
            while True:
                if proc.poll() is not None or time.monotonic() > deadline:
                    errs.seek(0)
                    raise AssertionError(f"cli server did not come up: {errs.read()[-2000:]}")
                try:
                    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
                    conn.request("GET", "/health")
                    up = conn.getresponse().status == 200
                    conn.close()
                    if up:
                        break
                except (OSError, http.client.HTTPException):
                    time.sleep(0.5)
            status, body = _post(port, {"messages": [{"role": "user", "content": "hi"}],
                                        "max_tokens": 8})
            reply = json.loads(body)
            if status != 200:
                raise AssertionError(f"cli server chat: {status} {body[:500]}")
            _check_usage(reply["usage"], 8)
            return {"status": status, "usage": reply["usage"],
                    "finish_reason": reply["choices"][0]["finish_reason"]}
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)


def phase_cli(torch, extra_args=()) -> None:
    from cake_tpu_torch.io.safetensors_io import save_tiny_checkpoint
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.ops.quant import quantize_params

    # Llama-3 layout cut to hidden 512, 2 layers, the byte tokenizer's vocab.
    config = LlamaConfig.tiny(
        hidden_size=512, intermediate_size=1792, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=1, max_position_embeddings=1024,
    )
    params = M.init_params(config, torch.Generator().manual_seed(3), torch.float32)
    # A Mixtral of the same cut: 4 experts, top-2.
    moe_config = dataclasses.replace(config, model_type="mixtral", num_local_experts=4)
    moe_params = M.init_params(moe_config, torch.Generator().manual_seed(4), torch.float32)
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp, tempfile.TemporaryDirectory() as tmp_q4, \
            tempfile.TemporaryDirectory() as tmp_moe:
        save_tiny_checkpoint(tmp, params, config, dtype=torch.bfloat16)
        save_tiny_checkpoint(tmp_moe, moe_params, moe_config, dtype=torch.bfloat16)
        # The same weights as a .q4 checkpoint: it loads quantized, no flag.
        save_tiny_checkpoint(tmp_q4, quantize_params(params, "int4"), config, dtype=torch.bfloat16)
        cli = [sys.executable, "-m", "cake_tpu_torch.cli", "--model", tmp]
        row = {"phase": "cli"}
        for key, model, flags in (
            ("prompt", tmp, ()),
            ("fused", tmp, ("--fusion", "all", "--decode-chunk", "4")),
            ("quantize_int4", tmp, ("--quantize", "int4")),
            ("q4_checkpoint", tmp_q4, ()),
            ("kv_f8", tmp, ("--kv-dtype", "f8")),
            ("moe_fused", tmp_moe, ("--fusion", "all", "--decode-chunk", "4")),
        ):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [*cli[:-1], model, "--prompt", "hi", "-n", "8", *flags, *extra_args],
                cwd=here, capture_output=True, text=True, timeout=600,
            )
            row[key] = {"returncode": proc.returncode, "s": time.perf_counter() - t0,
                        "stdout_chars": len(proc.stdout), "stdout": proc.stdout[-200:]}
            if key == "prompt":
                local_stdout = proc.stdout
            if proc.returncode != 0 or not proc.stdout:
                emit(row)
                raise AssertionError(f"cli {key} failed: {proc.stderr[-2000:]}")
        t0 = time.perf_counter()
        row["api_batch"] = _serve_and_chat(
            [*cli, "--api-batch", "4", "--kv-mode", "paged", *extra_args], here
        )
        row["api_batch"]["s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        row["api_batch_f8"] = _serve_and_chat(
            [*cli, "--api-batch", "4", "--kv-mode", "paged", "--kv-dtype", "f8", *extra_args], here
        )
        row["api_batch_f8"]["s"] = time.perf_counter() - t0
        row.update(_cli_tcp(cli, tmp, here, extra_args, local_stdout))
    emit(row)


def _cli_tcp(cli: list, tmp: str, here: str, extra_args, local_stdout: str) -> dict:
    """Cake's master/worker pipeline from the CLI: a ``--mode worker``
    subprocess serving layer 1 (the master runs layer 0) of a topology file
    written by the port's writer, a ``--mode master --topology`` prompt
    whose output must equal the local ``--prompt`` run's, and a ``--api
    --api-batch 4`` master over the same worker that answers a chat."""
    from cake_tpu_torch.parallel.topology import Topology

    port = _free_port()
    path = os.path.join(tmp, "topology.yml")
    Topology.from_dict({"w1": {"host": f"127.0.0.1:{port}", "description": "chip_smoke worker",
                               "layers": ["model.layers.1"]}}).save(path)
    out = {}
    with tempfile.TemporaryFile(mode="w+") as errs:
        t0 = time.perf_counter()
        worker = subprocess.Popen(
            [*cli, "--mode", "worker", "--name", "w1", "--topology", path, "--address",
             f"127.0.0.1:{port}", *extra_args], cwd=here, stdout=subprocess.DEVNULL,
            stderr=errs, text=True)
        try:
            deadline = time.monotonic() + 600
            while True:
                if worker.poll() is not None or time.monotonic() > deadline:
                    errs.seek(0)
                    raise AssertionError(f"cli worker did not come up: {errs.read()[-2000:]}")
                try:
                    socket.create_connection(("127.0.0.1", port), timeout=2).close()
                    break
                except OSError:
                    time.sleep(0.5)
            out["tcp_worker_up_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            proc = subprocess.run(
                [*cli, "--mode", "master", "--topology", path, "--prompt", "hi", "-n", "8",
                 *extra_args], cwd=here, capture_output=True, text=True, timeout=600)
            out["tcp_prompt"] = {"returncode": proc.returncode, "s": time.perf_counter() - t0,
                                 "stdout": proc.stdout[-200:],
                                 "equal_to_local": proc.stdout == local_stdout}
            if proc.returncode != 0 or proc.stdout != local_stdout:
                raise AssertionError(f"cli tcp master: {out['tcp_prompt']} "
                                     f"local {local_stdout[-200:]!r}: {proc.stderr[-2000:]}")
            t0 = time.perf_counter()
            out["tcp_api_batch"] = _serve_and_chat(
                [*cli, "--mode", "master", "--topology", path, "--api-batch", "4", *extra_args],
                here)
            out["tcp_api_batch"]["s"] = time.perf_counter() - t0
        finally:
            worker.terminate()
            try:
                worker.wait(timeout=30)
            except subprocess.TimeoutExpired:
                worker.kill()
                worker.wait(timeout=30)
    return out


# ---------------------------------------------------------------- phase 9


# ---------------------------------------------------------------- phases moe, phi3

# Phi-3-mini-4k-instruct's attention (microsoft/Phi-3-mini-4k-instruct
# config.json): 32 query heads over 32 KV heads of 96, a 2047-key window.
PHI3_HEADS = (32, 32, 96)
PHI3_WINDOW = 2047
PHI3_MAX_SEQ = 4096
PHI3_PROMPT_TOKENS = 2300  # past the window: the chunk and decode kernels mask it
# Qwen3-235B-A22B's (Qwen/Qwen3-235B-A22B config.json): 64 query heads over
# 4 KV heads of 128, a GQA group of 16.
QWEN3_235B_HEADS = (64, 4, 128)
# Decode groups past 16 query heads a block take passes: 12 (one block of
# 12) and 32 (two of 16), over 4 KV heads of 128.
GROUP_HEADS = {"g12": (48, 4, 128), "g32": (128, 4, 128)}
MOE_LAYERS = 8  # Mixtral-8x7B's 32 layers cut to 8: 93 GB of bf16 weights do not fit the card
MOE_INT4_TOKENS = 16
MOE_SEED, PHI3_SEED = 14, 15
PHI3_CKPT_LAYERS = 4  # the checkpoint the fused-tensor loader reads


def mixtral_config(n_layers: int = MOE_LAYERS):
    """mistralai/Mixtral-8x7B-v0.1's config.json widths, ``n_layers`` deep."""
    from cake_tpu_torch.models.llama.config import LlamaConfig

    return LlamaConfig(
        model_type="mixtral", hidden_size=4096, intermediate_size=14336, vocab_size=32000,
        num_hidden_layers=n_layers, num_attention_heads=32, num_key_value_heads=8,
        rms_norm_eps=1e-5, rope_theta=1e6, max_position_embeddings=32768, bos_token_id=1,
        eos_token_ids=(2,), num_local_experts=8, num_experts_per_tok=2,
    )


def phi3_config(n_layers: int = 32):
    """microsoft/Phi-3-mini-4k-instruct's config.json (full depth: 32)."""
    from cake_tpu_torch.models.llama.config import LlamaConfig

    n_q, n_kv, hd = PHI3_HEADS
    return LlamaConfig(
        model_type="phi3", hidden_size=n_q * hd, intermediate_size=8192, vocab_size=32064,
        num_hidden_layers=n_layers, num_attention_heads=n_q, num_key_value_heads=n_kv,
        rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=4096,
        sliding_window=PHI3_WINDOW, bos_token_id=1, eos_token_ids=(32000, 32007),
    )


def shape_cases(torch, dev) -> list:
    """The attention kernels at the shapes the MoE and Phi-3 families bring,
    each held to its plain version within TOL and timed beside its bound and
    SDPA: Phi-3-mini's head dim 96 at the generator's operands (a 256-query
    chunk at 2048 and a decode at 2332 keys, the window masking both) and
    the paged engine's (a cold 8-row wave, its decode), bf16 and f8; the
    decode kernels at Qwen3-235B-A22B's group of 16 and at groups 12 and 32;
    the ingest at head dim 96, bitwise, dense and paged, bf16 and f8."""
    g = torch.Generator(device=dev).manual_seed(16)
    f8 = torch.float8_e4m3fn
    n_p = ENGINE_MAX_SEQ // ENGINE_PAGE
    win = {"window": PHI3_WINDOW}
    pads = [0, 3, 17, 40, 66, 12, 25, 5]
    wave = [480] * ENGINE_BATCH
    rows = []
    for kv, sfx in ((None, ""), (f8, "_f8")):
        rows += [
            _decode_case(torch, dev, g, "phi3_generator" + sfx, [PHI3_PROMPT_TOKENS + 32], None,
                         win, max_seq=PHI3_MAX_SEQ, cold=True, kv=kv, heads=PHI3_HEADS),
            _chunk_case(torch, dev, g, "phi3_generator" + sfx, PREFILL_CHUNK, [2048], None, win,
                        max_seq=PHI3_MAX_SEQ, kv=kv, heads=PHI3_HEADS),
            _paged_decode_case(torch, dev, g, 50, "phi3_engine" + sfx, [w + 32 for w in wave],
                               pads, n_p, cold=True, kv=kv, heads=PHI3_HEADS),
            _paged_chunk_case(torch, dev, g, 51, "phi3_engine" + sfx, wave[0], [0] * 8, wave,
                              pads, n_p, kv=kv, heads=PHI3_HEADS),
        ]
    torch.cuda.empty_cache()
    rows += [
        _decode_case(torch, dev, g, "qwen3_235b_g16", [733], None, {}, cold=True,
                     heads=QWEN3_235B_HEADS),
        _paged_decode_case(torch, dev, g, 52, "qwen3_235b_g16", [w + 32 for w in wave], pads,
                           n_p, cold=True, heads=QWEN3_235B_HEADS),
    ]
    rows += [_decode_case(torch, dev, g, case, [733], None, {}, cold=True, heads=heads)
             for case, heads in GROUP_HEADS.items()]
    rows += [
        _ingest_case(torch, dev, g, "phi3_dense_b1", 1, 733, paged=False, heads=PHI3_HEADS),
        _ingest_case(torch, dev, g, "phi3_paged_b8", 8, 505, paged=True, unmapped=(5, 3),
                     heads=PHI3_HEADS),
        _ingest_case(torch, dev, g, "phi3_paged_b8_f8", 8, 505, paged=True, unmapped=(5, 3),
                     kv=f8, heads=PHI3_HEADS),
    ]
    torch.cuda.empty_cache()
    return rows


GROUPED_SITES = (("w_gate", "hidden", "inter"), ("w_down", "inter", "hidden"))


def moe_grouped_cases(torch, dev, sizes: list[int], config=None) -> dict:
    """The grouped expert GEMM (ops/moe.grouped_matmul, csrc/moe_grouped.cu;
    no Pallas counterpart: the JAX package's grouped dispatch is XLA's
    ``ragged_dot``) at the rows an expert that phase moe's engine prefill
    gave its first layer (``sizes``), Mixtral's gate (4096 -> 14336) and
    down (14336 -> 4096) products over 8 random experts, bf16 and int8
    stacks: within one bf16 rounding step of its plain version (one cuBLAS
    product an expert: the cuBLAS loop the kernel replaced). Its library
    call is ``torch._grouped_mm`` where this torch has it (bf16 only); on
    the card each case's instructions come from a trace of its kernels.
    Then row independence (gated): a probe's rows give the same bits among
    other group sizes, as a warm prefix wave needs, the probe also
    straddling a warpgroup's 64 rows, a block's 128 and an item's 256 and
    384. ``config``: a tiny one off the card."""
    from cake_tpu_torch.ops import moe
    from cake_tpu_torch.ops.quant import quantize_weight

    cfg = config or mixtral_config()
    width = {"hidden": cfg.hidden_size, "inter": cfg.intermediate_size}
    n_exp = cfg.num_local_experts
    g = torch.Generator(device=dev).manual_seed(16)
    m = sum(sizes)
    offsets = torch.zeros(n_exp + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(torch.tensor(sizes, device=dev), 0)
    used = sum(1 for n in sizes if n)
    out: dict = {}
    for site, k_name, n_name in GROUPED_SITES:
        k, n = width[k_name], width[n_name]
        xs = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        w = torch.randn(n_exp, k, n, generator=g, device=dev).mul_(k ** -0.5)
        for quant in (False, True):
            mats = quantize_weight(w).w if quant else w.to(torch.bfloat16)
            run = lambda mats=mats: moe.grouped_matmul(xs, mats, offsets, sizes)  # noqa: E731
            plain = lambda mats=mats: moe.grouped_matmul_plain(xs, mats, sizes)  # noqa: E731
            got, ref = run(), plain()
            torch.cuda.synchronize()
            library_ms, library = None, None
            if not quant and hasattr(torch, "_grouped_mm"):
                try:
                    lib = lambda mats=mats: torch._grouped_mm(xs, mats, offs=offsets[1:])  # noqa: E731
                    lib_out = lib()
                    torch.cuda.synchronize()
                    library = {"call": "torch._grouped_mm",
                               "max_abs_err": (lib_out.float() - ref.float()).abs().max().item()}
                    library_ms = cuda_ms(torch, lib, 10)
                except (RuntimeError, TypeError) as e:
                    library = {"call": "torch._grouped_mm", "error": str(e)[:200]}
            # Each used expert's weights read once, the rows and the outputs once.
            nbytes = (used * k * n * mats.element_size()
                      + m * k * xs.element_size() + m * n * 2)
            case = f"mixtral_{site}" + ("_int8" if quant else "")
            route = traced_route(torch, run) if dev.type == "cuda" else None
            out[("grouped_matmul", case)] = _check(
                torch, "grouped_matmul", case, got, ref, cuda_ms(torch, run, 10),
                cuda_ms(torch, plain, 5), nbytes, 2.0 * m * k * n, library_ms,
                tol=bf16_ulp(ref), route=route,
                extra={"rows": m, "rows_per_expert": sizes, "library": library,
                       "plan": dataclasses.asdict(moe.plan(k, n, xs.dtype, quant, n_exp))})
            del got, ref, mats
        # Row independence: 7 probe rows of expert 1 among other rows.
        probe = xs[:7]
        pool = xs.repeat(-(-800 // m), 1)  # rows enough for every layout

        def rows_of(n_e0: int, before: int, after: int, w_=w.to(torch.bfloat16), xs_=pool):
            rows = torch.cat([xs_[-n_e0:] if n_e0 else xs_[:0], xs_[7 : 7 + before], probe,
                              xs_[100 : 100 + after]])
            grp = [n_e0, before + 7 + after] + [0] * (n_exp - 2)
            off = torch.zeros(n_exp + 1, dtype=torch.int32, device=dev)
            off[1:] = torch.cumsum(torch.tensor(grp, device=dev), 0)
            return moe.grouped_matmul(rows, w_, off, grp)[n_e0 + before : n_e0 + before + 7]

        want = rows_of(0, 0, 0)
        equal = {f"e0_{a}_before_{b}_after_{c}": bool(torch.equal(rows_of(a, b, c), want))
                 for a, b, c in ((0, 0, 9), (5, 0, 300), (0, 64, 0), (61, 130, 250),
                                 (64, 57, 7), (3, 60, 200), (0, 124, 5), (97, 253, 40),
                                 (1, 381, 2))}
        row = {"phase": "kernels", "kernel": "grouped_matmul",
               "case": f"mixtral_{site}_row_independence", "equal": equal}
        emit(row)
        out[("grouped_matmul", row["case"])] = row
        if not all(equal.values()):
            raise AssertionError(f"grouped_matmul rows depend on the group sizes: {row}")
        del xs, w, pool
        torch.cuda.empty_cache()
    return out


# Qwen/Qwen3-30B-A3B's config.json: hidden 2048, moe_intermediate_size 768,
# 128 experts, top 8.
QWEN3_MOE = {"hidden": 2048, "inter": 768, "experts": 128, "top_k": 8}
QWEN3_TOKENS = 512  # a prefill chunk's tokens: 4096 rows over the experts


def qwen3_moe_sizes(torch, tokens: int = QWEN3_TOKENS, experts: int = QWEN3_MOE["experts"],
                    top_k: int = QWEN3_MOE["top_k"]) -> list[int]:
    """A seeded routing of ``tokens`` tokens to ``top_k`` of ``experts``
    experts each, skewed (log-normal preferences), as rows an expert: many
    experts get a handful of rows, some none."""
    gen = torch.Generator().manual_seed(3)
    pref = torch.randn(experts, generator=gen).mul(1.5).exp()
    picks = torch.multinomial(pref.expand(tokens, experts), top_k, generator=gen)
    return torch.bincount(picks.flatten(), minlength=experts).tolist()


def moe_grouped_qwen3_cases(torch, dev, widths=None) -> dict:
    """The grouped expert GEMM at Qwen3-30B-A3B's expert widths (gate 2048
    -> 768, down 768 -> 2048, 128 experts, bf16 and int8 stacks) over a
    seeded routing of a 512-token chunk (``qwen3_moe_sizes``): within one
    bf16 rounding step of its plain version, beside ``torch._grouped_mm``
    (bf16). ``widths``: tiny ones off the card."""
    from cake_tpu_torch.ops import moe
    from cake_tpu_torch.ops.quant import quantize_weight

    cfg = widths or QWEN3_MOE
    sizes = qwen3_moe_sizes(torch, experts=cfg["experts"], top_k=cfg["top_k"])
    n_exp, m = cfg["experts"], sum(sizes)
    offsets = torch.zeros(n_exp + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(torch.tensor(sizes, device=dev), 0)
    used = sum(1 for n in sizes if n)
    g = torch.Generator(device=dev).manual_seed(17)
    out: dict = {}
    for site, k_name, n_name in GROUPED_SITES:
        k, n = cfg[k_name], cfg[n_name]
        xs = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        w = torch.randn(n_exp, k, n, generator=g, device=dev).mul_(k ** -0.5)
        for quant in (False, True):
            mats = quantize_weight(w).w if quant else w.to(torch.bfloat16)
            run = lambda mats=mats: moe.grouped_matmul(xs, mats, offsets, sizes)  # noqa: E731
            plain = lambda mats=mats: moe.grouped_matmul_plain(xs, mats, sizes)  # noqa: E731
            got, ref = run(), plain()
            torch.cuda.synchronize()
            library_ms = None
            if not quant and hasattr(torch, "_grouped_mm"):
                try:
                    lib = lambda mats=mats: torch._grouped_mm(xs, mats, offs=offsets[1:])  # noqa: E731
                    lib()
                    library_ms = cuda_ms(torch, lib, 10)
                except (RuntimeError, TypeError):
                    library_ms = None
            nbytes = (used * k * n * mats.element_size()
                      + m * k * xs.element_size() + m * n * 2)
            case = f"qwen3_30b_a3b_{site}" + ("_int8" if quant else "")
            out[("grouped_matmul", case)] = _check(
                torch, "grouped_matmul", case, got, ref, cuda_ms(torch, run, 10),
                cuda_ms(torch, plain, 5), nbytes, 2.0 * m * k * n, library_ms,
                tol=bf16_ulp(ref),
                extra={"rows": m, "experts": n_exp, "experts_used": used,
                       "rows_per_expert_max": max(sizes),
                       "plan": dataclasses.asdict(moe.plan(k, n, xs.dtype, quant, n_exp)),
                       "library": {"call": "torch._grouped_mm"} if library_ms else None})
            del got, ref, mats
        del xs, w
        torch.cuda.empty_cache()
    return out


def _prompt_text(tokenizer, config, n_tokens: int) -> str:
    """A user turn whose dialog (the config's chat template) encodes to
    ``n_tokens`` tokens."""
    from cake_tpu_torch.models.llama.chat import Message, encode_dialog

    frame = len(tokenizer.encode(encode_dialog([Message.user("")], config.dialog_template)))
    sentence = "The quick brown fox jumps over the lazy dog while the cake cools. "
    return (sentence * (n_tokens // len(sentence) + 1))[: n_tokens - frame]


def _model_path(torch, config, params, card: str, text: str, dev) -> dict:
    """A generator over ``params`` in the shape of phase generate's row
    (what _quantized_generate and the engines read)."""
    from cake_tpu_torch.models.llama.generator import (
        LlamaGenerator, LocalForwardStep, SamplingConfig,
    )
    from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer

    max_seq = PHI3_MAX_SEQ if config.model_type == "phi3" else MAX_SEQ
    step = LocalForwardStep(config, params, max_seq_len=max_seq, cache_dtype=torch.bfloat16,
                            device=dev)
    gen = LlamaGenerator(config, step, ByteTokenizer(),
                         SamplingConfig(temperature=0.0, repeat_penalty=1.0),
                         prefill_chunk=PREFILL_CHUNK)
    return {"generator": gen, "text": text, "card": card}


def _generate_runs(torch, path: dict, phase: str) -> dict:
    """64 greedy tokens per step and in 8-token chunks (graphs on the card),
    each gated on the launches its forwards imply; the ids must be equal.
    The per-step run records the grouped dispatch's rows an expert."""
    from cake_tpu_torch.ops import moe

    runs, ids = [], []
    for chunk in (1, FUSED_CHUNK):
        sizes = []
        moe.GROUP_SIZES = sizes
        try:
            gen, got, run = _quantized_generate(torch, path, path["generator"].step, chunk,
                                                DECODE_TOKENS, False)
        finally:
            moe.GROUP_SIZES = None
        run["prompt_tokens"] = gen.prompt_tokens
        run["graph"] = chunk > 1 and path["generator"].step.device.type == "cuda"
        run["decode_tok_s"] = 1e3 / run["decode_ms_per_token"] if run["decode_ms_per_token"] else None
        if sizes:  # the warm-up's prefill, then the run's, of the same prompt
            sizes = sizes[len(sizes) // 2:]
            n_layers = path["generator"].config.num_hidden_layers
            run["grouped_dispatches"] = len(sizes)
            # Rows an expert took: the prompt's tokens and the last chunk's
            # pads, top-k rows each (the grouped dispatch routes pads too).
            run["rows_per_expert_layer0"] = [sum(col) for col in zip(*sizes[::n_layers])]
            run["rows_per_expert"] = [sum(col) for col in zip(*sizes)]
        runs.append(run)
        ids.append(got)
    if ids[0] != ids[1]:
        emit({"phase": phase, "runs": runs, "ids": ids})
        raise AssertionError(f"{phase}: graph chunks parted from the per-step ids")
    return {"runs": runs, "ids": ids[0], "launches": _sum_launches(r["launches"] for r in runs)}


def _sum_launches(tallies) -> dict:
    out: dict = {}
    for t in tallies:
        for k, v in t.items():
            out[k] = out.get(k, 0) + v
    return out


def _engine_waves(torch, path: dict, specs) -> dict:
    """One greedy wave of 8 through the paged engine (prefix cache on,
    8-token decode chunks) per fusion spec, then through the dense engine
    (no fusion), each engine fresh: the cold wave (it captures its decode
    chunks' graphs) under the launch gate, its streams compared across
    engines; then the same wave again, its chunks replayed, for the ms a
    step. The paged engine serves the second wave from the prefix cache:
    whether it equals the cold wave is reported (the caller gates it). A
    MoE model's cold wave records its grouped dispatches' rows an expert
    (``group_sizes``: the first paged run's first) and gates the grouped
    GEMM's launches, three a dispatch."""
    from cake_tpu_torch.ops import moe
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    gen = path["generator"]
    dev, n_layers = gen.step.device, gen.config.num_hidden_layers
    on_card = dev.type == "cuda"
    out: dict = {"runs": [], "streams": {}}
    for spec, kv_mode in [*((s, "paged") for s in specs), ("none", "dense")]:
        config = dataclasses.replace(gen.config, fusion_impl=spec)
        paged = kv_mode == "paged"
        serve = ServeConfig(max_batch=ENGINE_BATCH, decode_chunk_size=8, fusion_impl=spec,
                            **(dict(kv_mode="paged", page_size=ENGINE_PAGE, prefix_cache=True)
                               if paged else {}))
        eng = BatchEngine(config, gen.step.params, gen.tokenizer, max_seq_len=ENGINE_MAX_SEQ,
                          cache_dtype=torch.bfloat16, serve=serve, device=dev)
        sizes: list = []
        try:
            counters = _zero_counters()
            moe.GROUP_SIZES = sizes
            try:
                cold = _wave(eng, ENGINE_TOKENS, together=True)
            finally:
                moe.GROUP_SIZES = None
            launches = _counts(counters)
            again = _wave(eng, ENGINE_TOKENS, together=True)
        finally:
            eng.stop()
        del eng
        if paged and sizes and "group_sizes" not in out:
            out["group_sizes"] = sizes[0]  # the epoch prefill's first layer
        decode, chunk = (("paged_decode_attention", "paged_chunk_attention") if paged
                         else ("decode_attention", "chunk_prefill_attention"))
        suffix = "" if on_card else "_plain"
        keep = ("ttft_p50_s", "decode_ms_per_step", "decode_tok_s", "prefix_hits", "batches",
                "joins", "decode_steps", "finish_reasons")
        run = {"spec": spec, "kv_mode": kv_mode, "cold": {k: cold[k] for k in keep},
               "again": {k: again[k] for k in keep},
               "again_equal_cold": _equal_streams(again["streams"], cold["streams"]),
               "launches": launches}
        want = {decode + suffix: n_layers * cold["decode_steps"],
                chunk + suffix: n_layers * (cold["batches"] + cold["joins"])}
        if gen.config.num_local_experts:
            want["grouped_matmul" + suffix] = 3 * len(sizes)
            run["grouped_dispatches"] = len(sizes)
        run["expected_launches"] = want
        if any(launches[k] != v for k, v in want.items()):
            emit({"phase": "engine_waves", **run})
            raise AssertionError(f"{spec}/{kv_mode}: launches {launches} != {want}")
        if on_card and "ingest" in spec and launches["fused_qkv_ingest"] == 0:
            raise AssertionError(f"{spec}: the ingest kernel never launched")
        out["runs"].append(run)
        out["streams"][f"{spec}/{kv_mode}"] = cold["streams"]
        if on_card:
            torch.cuda.empty_cache()
    out["launches"] = _sum_launches(r["launches"] for r in out["runs"])
    return out


def _equal_streams(a, b) -> int:
    return sum(x == y for x, y in zip(a, b))


AB_TOKENS = 2  # tokens out a prefill A/B wave: the first token and one decode step


def _moe_prefill_ab(torch, path: dict) -> dict:
    """One cold engine prefill of wave 1 (the paged engine's, whose first
    layer's rows an expert the grouped GEMM's kernel cases take), timed
    with the grouped GEMM's kernel and with its plain version (one cuBLAS
    product an expert) patched in, alternately (kernel, plain, kernel,
    plain), the prefix cache cleared before each. Reports the engine's
    prefill seconds and TTFT p50 per wave and the launches each took; the
    plain waves' streams need not equal the kernel's (cuBLAS sums in
    another order)."""
    from unittest import mock

    from cake_tpu_torch.ops import moe
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    gen = path["generator"]
    dev = gen.step.device
    serve = ServeConfig(max_batch=ENGINE_BATCH, decode_chunk_size=8, kv_mode="paged",
                        page_size=ENGINE_PAGE, prefix_cache=True)
    eng = BatchEngine(gen.config, gen.step.params, gen.tokenizer, max_seq_len=ENGINE_MAX_SEQ,
                      cache_dtype=torch.bfloat16, serve=serve, device=dev)

    def plain(xs, mats, offsets, sizes):
        return moe.grouped_matmul_plain(xs, mats, sizes)

    out: dict = {"kernel": [], "plain": []}
    try:
        _wave(eng, AB_TOKENS, warm_messages(), together=True)  # captures the decode chunk
        for variant in ("kernel", "plain", "kernel", "plain"):
            eng._prefix.clear()
            sizes: list = []
            counters = _zero_counters()
            moe.GROUP_SIZES = sizes
            try:
                with (mock.patch.object(moe, "grouped_matmul", plain) if variant == "plain"
                      else contextlib.nullcontext()):
                    wave = _wave(eng, AB_TOKENS, together=True)
            finally:
                moe.GROUP_SIZES = None
            launches = _counts(counters)
            out[variant].append({
                "prefill_s": wave["prefill_s"], "ttft_p50_s": wave["ttft_p50_s"],
                "batches": wave["batches"], "prefix_hits": wave["prefix_hits"],
                "grouped_dispatches": len(sizes),
                "grouped_launches": launches.get("grouped_matmul", 0),
                "plain_launches": launches.get("grouped_matmul_plain", 0),
                "rows_per_expert_layer0": sizes[0] if sizes else None,
                "streams": wave["streams"]})
    finally:
        eng.stop()
    del eng
    first = out["kernel"][0]
    out["streams_equal"] = [_equal_streams(r["streams"], first["streams"])
                            for r in out["kernel"] + out["plain"]]
    for r in out["kernel"] + out["plain"]:
        del r["streams"]
    return out


def phase_moe(torch, main_path: dict, config=None) -> dict:
    """Mixtral-8x7B's widths at MOE_LAYERS layers (``config``: a tiny one
    off the card), random bf16 weights from a seed: the generator per step
    and in graph chunks (equal ids; the prefill's tokens an expert),
    full-width logits against the plain path, the paged engine against the
    dense one (8/8 streams) and a ``--fusion all`` wave, and ``--quantize
    int4`` (expert stacks int8, the attention products and the head on
    int4_matmul by launch count)."""
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.ops.fuse import fuse_params
    from cake_tpu_torch.ops.quant import QuantWeight, quantize_params, quantized_bytes

    dev = main_path["generator"].step.device
    on_card = dev.type == "cuda"
    config = config or mixtral_config()
    n_layers = config.num_hidden_layers
    t0 = time.perf_counter()
    params = fuse_params(M.init_params(
        config, torch.Generator(device=dev).manual_seed(MOE_SEED), torch.bfloat16, dev))
    _sync(torch, dev)
    init_s = time.perf_counter() - t0
    weight_bytes = M.count_params(params) * 2
    # A decode step under the dense combine streams every weight but the embedding.
    streamed = quantized_bytes({k: v for k, v in params.items() if k != "embed"})
    from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer

    text = _prompt_text(ByteTokenizer(), config, PROMPT_TOKENS)
    path = _model_path(torch, config, params, main_path["card"], text, dev)
    gen_runs = _generate_runs(torch, path, "moe")
    per_step = gen_runs["runs"][0]
    row = {
        "phase": "moe",
        "card": main_path["card"],
        "model": (f"Mixtral-8x7B widths (hidden {config.hidden_size}, {config.num_attention_heads}"
                  f"/{config.num_key_value_heads} heads of {config.head_dim}, "
                  f"{config.num_local_experts} experts top-{config.num_experts_per_tok}, expert "
                  f"inter {config.intermediate_size}, vocab {config.vocab_size}, rope theta "
                  f"{config.rope_theta:g}); random bf16 weights (seed {MOE_SEED})"),
        "layers": n_layers, "full_depth_layers": 32,
        "reduced": f"depth 32 -> {n_layers}: 93 GB of bf16 weights at full depth",
        "weights_gb": weight_bytes / 1e9, "init_s": init_s,
        "decode_streamed_gb": streamed / 1e9,
        "decode_bound_ms_per_token": streamed / HBM_BYTES_PER_S * 1e3,
        "prompt_tokens": per_step["prompt_tokens"],
        "runs": gen_runs["runs"],
    }
    if on_card:
        row["profile"] = _profile_main_path(torch, path["generator"], text,
                                            per_step["decode_ms_per_token"], phase="moe_profile")
    row["check"] = _full_model_check(torch, M, config, params, dev, phase="moe_model_check")
    engines = _engine_waves(torch, path, ("none", "all"))
    streams = engines["streams"]
    row["engine_runs"] = engines["runs"]
    row["paged_equal_dense"] = _equal_streams(streams["none/paged"], streams["none/dense"])
    row["all_equal_none"] = _equal_streams(streams["all/paged"], streams["none/paged"])
    # The warm prefix waves (the paged engines' second waves, served from the
    # cached chains) against the cold ones: the grouped GEMM's rows do not
    # depend on their neighbours, so they must be equal.
    row["warm_equal_cold"] = {r["spec"]: r["again_equal_cold"] for r in engines["runs"]
                              if r["kv_mode"] == "paged"}
    row["warm_prefix_hits"] = {r["spec"]: r["again"]["prefix_hits"] for r in engines["runs"]
                               if r["kv_mode"] == "paged"}
    row["group_sizes"] = engines.get("group_sizes")
    # The grouped GEMM's share of a cold prefill: the kernel against its
    # plain version patched in, on the same wave.
    row["prefill_ab"] = _moe_prefill_ab(torch, path)
    # --quantize int4: the expert stacks int8 (the mixed mode), the
    # attention products and the head through int4_matmul.
    t0 = time.perf_counter()
    qparams = quantize_params(params, "int4")
    _sync(torch, dev)
    experts_int8 = all(isinstance(qparams["layers"][k], QuantWeight)
                       for k in ("w_gate", "w_up", "w_down"))
    qpath = _model_path(torch, config, qparams, main_path["card"], text, dev)
    _, _, int4_run = _quantized_generate(torch, qpath, qpath["generator"].step, FUSED_CHUNK,
                                         MOE_INT4_TOKENS, True)
    row["int4"] = {"quantize_s": time.perf_counter() - t0, "experts_int8": experts_int8,
                   "streamed_gb": quantized_bytes(
                       {k: v for k, v in qparams.items() if k != "embed"}) / 1e9,
                   **{k: int4_run[k] for k in ("decode_chunk", "generated_tokens",
                                               "decode_ms_per_token", "launches",
                                               "expected_launches")}}
    emit(row)
    if not experts_int8:
        raise AssertionError("moe: --quantize int4 left an expert stack that is not int8")
    if row["paged_equal_dense"] != ENGINE_BATCH:
        raise AssertionError(f"moe: paged engine streams equal dense {row['paged_equal_dense']}/8")
    if any(n != ENGINE_BATCH for n in row["warm_equal_cold"].values()) or not all(
            row["warm_prefix_hits"].values()):
        raise AssertionError(f"moe: warm prefix waves {row['warm_equal_cold']} (prefix hits "
                             f"{row['warm_prefix_hits']}) are not the cold waves 8/8")
    row["launches"] = _sum_launches([gen_runs["launches"], engines["launches"],
                                     int4_run["launches"]])
    del path, qpath, params, qparams
    if on_card:
        torch.cuda.empty_cache()
    return row


def phase_phi3(torch, main_path: dict, config=None, ckpt_layers: int = PHI3_CKPT_LAYERS,
               prompt_tokens: int = PHI3_PROMPT_TOKENS) -> dict:
    """Phi-3-mini-4k at full width and depth (``config``: a tiny one off
    the card), random bf16 weights from a seed: the first ``ckpt_layers``
    written as a checkpoint with Phi-3's fused qkv_proj / gate_up_proj and
    read back by the loader, bitwise; the generator over a prompt past the
    2047-key window, per step and in graph chunks (equal ids), its logits
    against the plain path; the paged engine under none, ingest,tail (equal
    streams, gated) and all, and the dense engine. Then the rolling window
    cache at head dim 96: a prompt PHI3_ROLL_EXTRA tokens longer (past the
    2304-slot ring: it wraps during the prefill), per step and in graph
    chunks, the ring's ids equal to the full cache's (gated)."""
    from cake_tpu_torch.io.safetensors_io import load_params, save_tiny_checkpoint
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
    from cake_tpu_torch.ops.fuse import fuse_params
    from cake_tpu_torch.ops.quant import quantized_bytes

    dev = main_path["generator"].step.device
    on_card = dev.type == "cuda"
    config = config or phi3_config()
    n_layers = config.num_hidden_layers
    t0 = time.perf_counter()
    raw = M.init_params(config, torch.Generator(device=dev).manual_seed(PHI3_SEED),
                        torch.bfloat16, dev)
    params = fuse_params(raw)
    _sync(torch, dev)
    init_s = time.perf_counter() - t0
    # The fused-tensor loader: the first layers written and read back.
    t0 = time.perf_counter()
    cut = dataclasses.replace(config, num_hidden_layers=ckpt_layers)
    head = {k: v for k, v in raw.items() if k != "layers"}
    with tempfile.TemporaryDirectory() as tmp:
        save_tiny_checkpoint(tmp, {**head, "layers": {k: v[:ckpt_layers]
                                                      for k, v in raw["layers"].items()}},
                             cut, dtype=torch.bfloat16)
        files = sorted(os.listdir(tmp))
        loaded = load_params(tmp, LlamaConfig.from_model_dir(tmp), torch.bfloat16, dev)
    del raw, head
    want = {**{k: v for k, v in params.items() if k != "layers"},
            "layers": {k: v[:ckpt_layers] for k, v in params["layers"].items()}}
    loader_equal = {k: bool(torch.equal(loaded["layers"][k], want["layers"][k]))
                    for k in want["layers"]}
    loader_equal.update({k: bool(torch.equal(loaded[k], want[k])) for k in want if k != "layers"})
    loader = {"layers": ckpt_layers, "files": files, "s": time.perf_counter() - t0,
              "keys": sorted(loaded["layers"]), "equal": loader_equal}
    del loaded, want
    weight_bytes = M.count_params(params) * 2
    streamed = quantized_bytes({k: v for k, v in params.items() if k != "embed"})
    text = _prompt_text(ByteTokenizer(), config, prompt_tokens)
    path = _model_path(torch, config, params, main_path["card"], text, dev)
    gen_runs = _generate_runs(torch, path, "phi3")
    per_step = gen_runs["runs"][0]
    row = {
        "phase": "phi3",
        "card": main_path["card"],
        "model": (f"Phi-3-mini-4k widths (hidden {config.hidden_size}, {n_layers} layers, "
                  f"{config.num_attention_heads}/{config.num_key_value_heads} heads of "
                  f"{config.head_dim}, inter {config.intermediate_size}, vocab "
                  f"{config.vocab_size}, window {config.sliding_window}, untied head); "
                  f"random bf16 weights (seed {PHI3_SEED})"),
        "layers": n_layers, "weights_gb": weight_bytes / 1e9, "init_s": init_s,
        "decode_streamed_gb": streamed / 1e9,
        "decode_bound_ms_per_token": streamed / HBM_BYTES_PER_S * 1e3,
        "loader": loader,
        "prompt_tokens": per_step["prompt_tokens"],
        "runs": gen_runs["runs"],
    }
    if on_card:
        row["profile"] = _profile_main_path(torch, path["generator"], text,
                                            per_step["decode_ms_per_token"], phase="phi3_profile")
    # The windowed prompt through the kernels against the plain path.
    n_chunks = -(-prompt_tokens // PREFILL_CHUNK)
    row["check"] = _full_model_check(
        torch, M, config, params, dev, phase="phi3_model_check",
        chunks=[PREFILL_CHUNK] * (n_chunks - 1) + [prompt_tokens - PREFILL_CHUNK * (n_chunks - 1)])
    engines = _engine_waves(torch, path, ("none", "ingest,tail", "all"))
    streams = engines["streams"]
    row["engine_runs"] = engines["runs"]
    row["ingest_tail_equal_none"] = _equal_streams(streams["ingest,tail/paged"],
                                                   streams["none/paged"])
    row["all_equal_none"] = _equal_streams(streams["all/paged"], streams["none/paged"])
    row["paged_equal_dense"] = _equal_streams(streams["none/paged"], streams["none/dense"])
    emit(row)
    if not all(loader_equal.values()) or "wqkv" not in loader["keys"]:
        raise AssertionError(f"phi3: the fused-tensor checkpoint did not load bitwise: {loader}")
    if row["ingest_tail_equal_none"] != ENGINE_BATCH:
        raise AssertionError(f"phi3: ingest,tail streams equal none "
                             f"{row['ingest_tail_equal_none']}/8")
    row["rolling"] = _phi3_rolling(torch, config, params, path, prompt_tokens + PHI3_ROLL_EXTRA)
    emit({"phase": "phi3_rolling", **row["rolling"]})
    if not row["rolling"]["equal"]:
        raise AssertionError(f"phi3: the rolling cache's ids parted from the full cache's: "
                             f"{row['rolling']['equal_tokens']}")
    row["launches"] = _sum_launches([gen_runs["launches"], engines["launches"],
                                     row["rolling"]["launches"]])
    del path, params
    if on_card:
        torch.cuda.empty_cache()
    return row


# ------------------------------------------------------- rolling window cache

# mistralai/Mistral-7B-v0.1's config.json; the rolling phase's traffic.
MISTRAL_SEED = 18
ROLL_MAX_SEQ = 8192
ROLL_CHUNK = 512  # --prefill-chunk: the ring holds window + this (4608 slots)
ROLL_PROMPT_TOKENS = 6000  # past the ring's 4608: it wraps during the prefill
ROLL_F8_TOKENS = 16  # tokens out of the f8 rolling pass
PHI3_ROLL_EXTRA = 300  # the phi3 rolling pass's prompt: the phase's prompt plus this


def mistral_config(n_layers: int = 32):
    """mistralai/Mistral-7B-v0.1's config.json (full depth: 32)."""
    from cake_tpu_torch.models.llama.config import LlamaConfig

    return LlamaConfig(
        model_type="mistral", hidden_size=4096, intermediate_size=14336, vocab_size=32000,
        num_hidden_layers=n_layers, num_attention_heads=32, num_key_value_heads=8,
        rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=32768,
        sliding_window=4096, bos_token_id=1, eos_token_ids=(2,),
    )


def _ring_of(torch, full, ring: int, newest):
    """The ring of ``ring`` slots a rolling cache holds for rows whose newest
    written position is ``newest`` ([b] int tensor): slot s holds the full
    cache's position rolling_kv_positions gives it (an f8 cache is gathered
    through its byte view)."""
    from cake_tpu_torch.models.llama.cache import rolling_kv_positions
    from cake_tpu_torch.ops.kv_dtype import kv_view

    kpos = rolling_kv_positions(ring, newest.long(), 1).clamp(min=0, max=full.shape[2] - 1)
    rows = [kv_view(full[r : r + 1])[:, :, kpos[r]] for r in range(full.shape[0])]
    return torch.cat(rows).view(full.dtype).contiguous()


def _ring_against_dense(torch, ring_run, dense_run, iters: int) -> dict:
    """The ring call and the dense call over the same keys, warm, timed in
    turns (ring, dense, dense, ring, ring, dense), each side's median: what
    the ring's addressing costs (one turn in a dev run read 8x its
    others)."""
    t = [cuda_ms(torch, f, iters)
         for f in (ring_run, dense_run, dense_run, ring_run, ring_run, dense_run)]
    return {"ring_warm_ms": statistics.median(t[0::3] + t[4:5]),
            "dense_warm_ms": statistics.median(t[1:3] + t[5:6]), "turns_ms": t}


def _ring_decode_case(torch, dev, g, case, heads, ring, limit, window, lens, kv=None):
    """decode_attention over a ring (``ring_limit``): held to its plain
    version within RING_TOL and RING_REL_TOL and to the dense-layout kernel
    over the same keys in the full cache to the bit; timed over rotating
    copies of the ring, beside its bytes bound and SDPA over the gathered
    window."""
    from cake_tpu_torch.ops.decode_attention import decode_attention, decode_ring_plain

    n_q, n_kv, hd = heads
    bf = torch.bfloat16
    kv_dt, esize, extra = _kv_case(torch, kv)
    b = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    live = sum(min(ln, window) for ln in lens)
    n_copy = copies_for(live * n_kv * hd * 2 * esize)
    q = torch.randn(b, 1, n_q, hd, generator=g, device=dev, dtype=bf)
    full_k = torch.randn(b, n_kv, limit, hd, generator=g, device=dev, dtype=bf).to(kv_dt)
    full_v = torch.randn(b, n_kv, limit, hd, generator=g, device=dev, dtype=bf).to(kv_dt)
    rk, rv = _ring_of(torch, full_k, ring, lengths - 1), _ring_of(torch, full_v, ring, lengths - 1)
    rings = [(rk, rv)] + [(rk.clone(), rv.clone()) for _ in range(n_copy - 1)]
    runs = [lambda kc=kc, vc=vc: decode_attention(q, kc, vc, lengths, window=window,
                                                  ring_limit=limit) for kc, vc in rings]
    plain = lambda: decode_ring_plain(q, rk, rv, lengths, window=window)  # noqa: E731
    out, ref = runs[0](), plain()
    dense_run = lambda: decode_attention(q, full_k, full_v, lengths, window=window)  # noqa: E731
    dense = dense_run()
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(out, dense))
    pair = _ring_against_dense(torch, runs[0], dense_run, 50)
    nbytes = 2 * q.numel() * 2 + live * n_kv * hd * 2 * esize
    flops = 4.0 * live * n_q * hd
    wins = [(full_k[r : r + 1, :, max(0, ln - window) : ln].to(bf),
             full_v[r : r + 1, :, max(0, ln - window) : ln].to(bf)) for r, ln in enumerate(lens)]
    libs = [lambda r=r, kw=kw, vw=vw: _sdpa(torch, q[r : r + 1].transpose(1, 2), kw, vw)
            for r, (kw, vw) in enumerate(wins)]
    library_ms = cuda_ms(torch, lambda: [f() for f in libs], 10)
    del wins, libs, full_k, full_v
    row = _check(torch, "decode_attention_ring", case, out, ref,
                 cuda_ms(torch, rotating(runs), 50 * n_copy), cuda_ms(torch, plain, 3),
                 nbytes, flops, library_ms, copies=n_copy, tol=RING_TOL, rel_tol=RING_REL_TOL,
                 extra={**extra, **pair, "ring": ring, "limit": limit, "window": window,
                        "lengths": lens, "dense_bitwise": bitwise,
                        "library": "scaled_dot_product_attention over the gathered window"})
    if not bitwise:
        raise AssertionError(f"decode_attention_ring/{case}: not the dense kernel's bits")
    return row


def _ring_chunk_case(torch, dev, g, case, heads, ring, limit, window, chunk, q_start, kv=None):
    """chunk_prefill_attention over a ring (a continuation chunk whose keys
    straddle the wrap): within RING_TOL and RING_REL_TOL of its plain
    version, bitwise the dense
    kernel's over the full cache; timed beside its bound and SDPA over the
    gathered window."""
    from cake_tpu_torch.ops.chunk_prefill import chunk_prefill_attention, chunk_ring_plain

    n_q, n_kv, hd = heads
    bf = torch.bfloat16
    kv_dt, esize, extra = _kv_case(torch, kv)
    end = q_start + chunk
    q = torch.randn(1, chunk, n_q, hd, generator=g, device=dev, dtype=bf)
    full_k = torch.randn(1, n_kv, limit, hd, generator=g, device=dev, dtype=bf).to(kv_dt)
    full_v = torch.randn(1, n_kv, limit, hd, generator=g, device=dev, dtype=bf).to(kv_dt)
    qs = torch.tensor([q_start], dtype=torch.int32, device=dev)
    lengths = qs + chunk
    rk, rv = _ring_of(torch, full_k, ring, lengths - 1), _ring_of(torch, full_v, ring, lengths - 1)
    run = lambda: chunk_prefill_attention(q, rk, rv, qs, lengths, window=window,  # noqa: E731
                                          ring_limit=limit)
    plain = lambda: chunk_ring_plain(q, rk, rv, qs, lengths, window=window)  # noqa: E731
    out, ref = run(), plain()
    dense_run = lambda: chunk_prefill_attention(  # noqa: E731
        q, full_k, full_v, qs, lengths, window=window)
    dense = dense_run()
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(out, dense))
    pair = _ring_against_dense(torch, run, dense_run, 20)
    k0 = max(0, q_start - window + 1)
    qpos = torch.arange(q_start, end, device=dev)[:, None]
    kpos = torch.arange(k0, end, device=dev)[None]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    pairs = int(mask.sum().item())
    nbytes = 2 * q.numel() * 2 + (end - k0) * n_kv * hd * 2 * esize
    flops = 4.0 * pairs * n_q * hd
    kw_, vw = full_k[:, :, k0:end].to(bf), full_v[:, :, k0:end].to(bf)
    qh = q.transpose(1, 2)
    library_ms = cuda_ms(torch, lambda: _sdpa(torch, qh, kw_, vw, mask[None, None]), 5)
    del kw_, vw, full_k, full_v
    row = _check(torch, "chunk_prefill_attention_ring", case, out, ref, cuda_ms(torch, run, 20),
                 cuda_ms(torch, plain, 3), nbytes, flops, library_ms, tol=RING_TOL,
                 rel_tol=RING_REL_TOL,
                 extra={**extra, **pair, "ring": ring, "limit": limit, "window": window,
                        "chunk": chunk, "q_start": q_start, "dense_bitwise": bitwise,
                        "library": "scaled_dot_product_attention over the gathered window"})
    if not bitwise:
        raise AssertionError(f"chunk_prefill_attention_ring/{case}: not the dense kernel's bits")
    return row


def ring_cases(torch, dev) -> list:
    """The ring instantiations at the rolling paths' operands: Mistral-7B's
    decode (about 6000 logical positions through 4608 slots, window 4096)
    and a 512-query continuation chunk whose keys straddle the wrap, bf16
    and f8; Phi-3-mini's at head dim 96 (2304 slots, window 2047)."""
    g = torch.Generator(device=dev).manual_seed(18)
    f8 = torch.float8_e4m3fn
    mistral = ((N_Q, N_KV, HD), 4608, ROLL_MAX_SEQ, 4096)
    phi3 = (PHI3_HEADS, 2304, PHI3_MAX_SEQ, PHI3_WINDOW)
    rows = [_ring_decode_case(torch, dev, g, "mistral", *mistral, [ROLL_PROMPT_TOKENS + 32]),
            _ring_decode_case(torch, dev, g, "mistral_f8", *mistral, [ROLL_PROMPT_TOKENS + 32],
                              kv=f8),
            _ring_decode_case(torch, dev, g, "phi3_hd96", *phi3, [2640]),
            _ring_chunk_case(torch, dev, g, "mistral", *mistral, ROLL_CHUNK, 5120),
            _ring_chunk_case(torch, dev, g, "mistral_f8", *mistral, ROLL_CHUNK, 5120, kv=f8),
            _ring_chunk_case(torch, dev, g, "phi3_hd96", *phi3, PREFILL_CHUNK, 2304)]
    return rows


def _ring_counts() -> dict:
    """The ring side counts of the two attention wrappers."""
    from cake_tpu_torch.ops import chunk_prefill, decode_attention

    return {"decode_attention": decode_attention.decode_attention.ring,
            "chunk_prefill_attention": chunk_prefill.chunk_prefill_attention.ring}


def _rolling_generation(torch, config, step, text: str, chunk: int, n_tokens: int) -> dict:
    """One warmed-up greedy generation over ``step`` (``chunk``-token decode;
    prefill in ROLL_CHUNK-token chunks): ids, the first decode step's
    logits (per step) or the logits of one step after the chunks, prefill
    seconds, wall ms a token, the launches its forwards imply (gated) and
    the ring launches."""
    from cake_tpu_torch.models.llama.chat import Message
    from cake_tpu_torch.models.llama.generator import (
        LlamaGenerator, LocalForwardStep, SamplingConfig,
    )
    from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer

    import numpy as np

    dev = step.device
    tap = _LogitsTap(step)
    # Through the class at each call: step_recorder patches it there.
    tap.decode_chunk = lambda *a, **kw: step.decode_chunk(*a, **kw)
    gen = LlamaGenerator(config, tap, ByteTokenizer(),
                         SamplingConfig(temperature=0.0, repeat_penalty=1.0),
                         prefill_chunk=ROLL_CHUNK, decode_chunk_size=chunk)
    gen.add_message(Message.user(text))
    gen.generate(chunk + 2)  # warm-up: captures the chunk's graph
    _sync(torch, dev)
    gen.reset()
    gen.add_message(Message.user(text))
    counters = _zero_counters()
    stamps = []
    with step_recorder(LocalForwardStep) as rec:
        t0 = time.perf_counter()
        gen.generate(n_tokens, on_token=lambda tok: stamps.append(time.perf_counter()))
        _sync(torch, dev)
    launches, expected = _generator_expected(
        counters, rec, config.num_hidden_layers, dev.type == "cuda", fused=False,
        f8=step._cache_dtype == torch.float8_e4m3fn, rolling=step.rolling)
    ring = _ring_counts()
    logits = tap.first_decode
    if chunk > 1:  # one step at the next position, over the KV the graphs wrote
        toks = gen._tokens
        logits = step(np.asarray([[toks[-1]]], np.int64), len(toks) - 1, 1)
    ids = gen.generated_token_ids
    run = {"decode_chunk": chunk, "generated_tokens": len(ids), "prefill_s": stamps[0] - t0,
           "decode_ms_per_token": 1e3 * (stamps[-1] - stamps[0]) / max(1, len(ids) - 1),
           "kv_bytes": 2 * step._kv.k.numel() * step._kv.k.element_size(),
           "cache_slots": step._kv.max_seq_len, "rolling": step.rolling,
           "launches": launches, "expected_launches": expected, "ring_launches": ring}
    if launches != expected:
        emit({"phase": "rolling_generation", **run})
        raise AssertionError(f"rolling generation launch counts {launches} != {expected}")
    return {"run": run, "ids": ids, "logits": logits, "gen": gen}


def phase_rolling(torch, main_path: dict, config=None, prompt_tokens: int = ROLL_PROMPT_TOKENS,
                  max_seq: int = ROLL_MAX_SEQ) -> dict:
    """Mistral-7B-v0.1 at full width and depth (``config``: a tiny one off
    the card), random bf16 weights from a seed of its own, over the rolling
    window cache (window + ROLL_CHUNK slots, 4608) and over the full cache
    (``max_seq``, 8192): a ~6000-token prompt in ROLL_CHUNK-token chunks, so
    the ring wraps during the prefill, then 64 greedy tokens per step and in
    8-token graph chunks. Gated: the ring and the full cache give the same
    ids 64/64, the first decode step's logits (per step) and one step's
    after the graph chunks equal to the bit, the launches their forwards
    imply with every decode and continuation launch on the ring
    instantiations. Recorded: KV bytes, prefill seconds, wall and device ms
    a token of each. Then an f8 pass (ROLL_F8_TOKENS per step, ring against
    full cache, the same gates). The weights are freed at the end."""
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.generator import LocalForwardStep
    from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
    from cake_tpu_torch.ops.fuse import fuse_params

    dev = main_path["generator"].step.device
    on_card = dev.type == "cuda"
    config = config or mistral_config()
    t0 = time.perf_counter()
    params = fuse_params(M.init_params(config, torch.Generator(device=dev).manual_seed(
        MISTRAL_SEED), torch.bfloat16, dev))
    _sync(torch, dev)
    init_s = time.perf_counter() - t0
    text = _prompt_text(ByteTokenizer(), config, prompt_tokens)

    def steps(kv_dtype):
        return {name: LocalForwardStep(config, params, max_seq_len=max_seq, cache_dtype=kv_dtype,
                                       device=dev, rolling_budget=budget)
                for name, budget in (("full", None), ("rolling", ROLL_CHUNK))}

    bf16 = steps(torch.bfloat16)
    runs, gates, ring_launches = {}, {}, {"bf16": {}, "f8": {}}
    for chunk in (1, FUSED_CHUNK):
        got = {name: _rolling_generation(torch, config, step, text, chunk, DECODE_TOKENS)
               for name, step in bf16.items()}
        key = "per_step" if chunk == 1 else "graph_chunks"
        runs[key] = {name: g["run"] for name, g in got.items()}
        equal = sum(x == y for x, y in zip(got["rolling"]["ids"], got["full"]["ids"]))
        runs[key]["equal_tokens"] = equal
        runs[key]["logits_bitwise"] = bool(torch.equal(got["rolling"]["logits"],
                                                       got["full"]["logits"]))
        gates[f"{key} ids equal"] = equal == len(got["full"]["ids"]) == DECODE_TOKENS
        gates[f"{key} logits bitwise"] = runs[key]["logits_bitwise"]
        if on_card:  # off the card the plain versions take the ring (the launch gate)
            gates[f"{key} ring launches"] = (
                got["rolling"]["run"]["ring_launches"]["decode_attention"] > 0
                and got["full"]["run"]["ring_launches"]["decode_attention"] == 0)
        for k, n in got["rolling"]["run"]["ring_launches"].items():
            ring_launches["bf16"][k] = ring_launches["bf16"].get(k, 0) + n
        if on_card and chunk > 1:
            for name, g in got.items():
                prof = _profile_main_path(torch, g["gen"], text,
                                          g["run"]["decode_ms_per_token"],
                                          phase=f"rolling_profile_{name}")
                runs[key][name]["decode_device_ms_per_token"] = prof["decode_device_ms_per_token"]
                runs[key][name]["decode_device_idle_share"] = prof["decode_device_idle_share"]
                runs[key][name]["prefill_device_ms"] = prof["prefill_device_ms"]
        del got
    del bf16
    if on_card:
        torch.cuda.empty_cache()
    f8 = steps(torch.float8_e4m3fn)
    got = {name: _rolling_generation(torch, config, step, text, 1, ROLL_F8_TOKENS)
           for name, step in f8.items()}
    runs["f8_per_step"] = {name: g["run"] for name, g in got.items()}
    f8_equal = sum(x == y for x, y in zip(got["rolling"]["ids"], got["full"]["ids"]))
    runs["f8_per_step"]["equal_tokens"] = f8_equal
    runs["f8_per_step"]["logits_bitwise"] = bool(torch.equal(got["rolling"]["logits"],
                                                             got["full"]["logits"]))
    gates["f8 ids equal"] = f8_equal == len(got["full"]["ids"]) == ROLL_F8_TOKENS
    gates["f8 logits bitwise"] = runs["f8_per_step"]["logits_bitwise"]
    ring_launches["f8"] = got["rolling"]["run"]["ring_launches"]
    del got, f8
    row = {
        "phase": "rolling", "card": main_path["card"],
        "model": (f"Mistral-7B-v0.1 widths (hidden {config.hidden_size}, "
                  f"{config.num_hidden_layers} layers, {config.num_attention_heads}/"
                  f"{config.num_key_value_heads} heads of {config.head_dim}, inter "
                  f"{config.intermediate_size}, vocab {config.vocab_size}, window "
                  f"{config.sliding_window}); random bf16 weights (seed {MISTRAL_SEED})"),
        "weights_gb": M.count_params(params) * 2 / 1e9, "init_s": init_s,
        "max_seq_len": max_seq, "prefill_chunk": ROLL_CHUNK, "prompt_tokens": prompt_tokens,
        "runs": runs, "ring_launches": ring_launches, "gates": gates,
    }
    emit(row)
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"rolling phase gates failed: {failed}")
    del params
    if on_card:
        torch.cuda.empty_cache()
    row["launches"] = {"decode_attention_ring": ring_launches["bf16"]["decode_attention"],
                       "chunk_prefill_attention_ring": ring_launches["bf16"]
                       ["chunk_prefill_attention"],
                       "decode_attention_ring_f8": ring_launches["f8"]["decode_attention"],
                       "chunk_prefill_attention_ring_f8": ring_launches["f8"]
                       ["chunk_prefill_attention"]}
    return row


# ------------------------------------------------------------------ failover

FAILOVER_AFTER = 30  # sends to the killed worker before the kill: wave 1's prefill + 29 steps


def _tcp_failover(torch, config, params, tokenizer, dev, topo, max_seq: int, plan: str, *,
                  heartbeat: bool, prefer: str) -> dict:
    """Wave 1 through a DistributedBatchBackend over ``topo`` (workers in
    this process; the wave routes ``prefer`` in its replica group) with the
    fault ``plan`` installed for the wave: its streams, finishes and the
    engine's failover records, then, with the plan cleared, wave 1 again
    (the engine still serves)."""
    from cake_tpu_torch.runtime import faults
    from cake_tpu_torch.runtime.batch_backend import DistributedBatchBackend
    from cake_tpu_torch.runtime.master import DistributedForwardStep
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig
    from cake_tpu_torch.utils import metrics

    workers = _start_workers(torch, config, params, topo, max_seq, dev)
    step = DistributedForwardStep(config, None, topo, dtype=torch.bfloat16, max_seq_len=max_seq,
                                  device=dev, params=params)
    serve = ServeConfig(max_batch=ENGINE_BATCH, decode_chunk_size=8,
                        heartbeat_interval_s=0.5 if heartbeat else 0.0)
    metrics.registry.clear()
    metrics.flight.clear()
    eng = BatchEngine(config, None, tokenizer, max_seq_len=max_seq,
                      cache_dtype=torch.bfloat16, serve=serve,
                      backend=DistributedBatchBackend(step))
    try:
        step.router.prefer(prefer)
        faults.install(faults.parse(plan))
        t0 = time.perf_counter()
        wave = _wave(eng, ENGINE_TOKENS, together=True)
        wall = time.perf_counter() - t0
        faults.clear()
        out = {
            "plan": plan, "streams": wave["streams"], "finish_reasons": wave["finish_reasons"],
            "wall_s": wall, "failovers": eng.stats["failovers"],
            "recovered": eng.stats["recovered"], "stream_errors": eng.stats["stream_errors"],
            "failover_total": {n: metrics.registry.counter("cake_failover_total").value(node=n)
                               for n in topo.nodes},
            "failover_seconds": [e.get("seconds") for e in metrics.flight.snapshot()
                                 if e["event"] == "failover-migrated"],
            "failover_how": [e.get("how") for e in metrics.flight.snapshot()
                             if e["event"] == "failover-migrated"],
            "router": step.router.snapshot(),
            "heartbeat": None if eng.monitor is None else eng.monitor.snapshot(),
            "live_after": eng.snapshot()["live"],
        }
        again = _wave(eng, ENGINE_TOKENS, together=True)
        out["next_wave_streams"] = again["streams"]
        out["next_wave_finish_reasons"] = again["finish_reasons"]
    finally:
        faults.clear()
        eng.stop()
        step.close()
        for w in workers.values():
            w.stop()
    return out


FAILOVER_LATE_TOKENS = 320  # the late fault's wave: tokens out a request
FAILOVER_LATE_AFTER = 36  # decode chunks before the late fault (slot ~770)
FAILOVER_LATE_BUDGET_S = 2.0  # the late row's failover budget, under the replay's price


def _failover_wave(eng, n_tokens: int, plan: str, budget_s: float | None = None) -> dict:
    """One greedy wave with the fault ``plan`` installed (and the engine's
    failover budget ``budget_s``): the wave and its migrations' flight
    records (slot, seconds, rebuild)."""
    from cake_tpu_torch.runtime import faults
    from cake_tpu_torch.utils import metrics

    if budget_s is not None:
        eng.failover_budget_s = budget_s
    t0 = time.perf_counter()
    faults.install(faults.parse(plan))
    try:
        wave = _wave(eng, n_tokens, together=True)
    finally:
        faults.clear()
    wave["migrations"] = [{k: e.get(k) for k in ("slot", "seconds", "how")}
                          for e in metrics.flight.snapshot()
                          if e["event"] == "failover-migrated" and e["mono"] >= round(t0, 6)]
    return wave


def _engine_failover_local(torch, main_path: dict, late_budget_s: float | None = None) -> dict:
    """``--failover-local`` on the paged local engine: after a warm-up wave,
    wave 1 fault-free, then wave 1 with crash@backend.decode firing at its
    fourth decode chunk: the migration replays the epoch's dispatches and
    the streams equal the fault-free ones 8/8, one failover, 8 recovered,
    the pool whole after (gated). Then a late fault (chunk
    FAILOVER_LATE_AFTER of a FAILOVER_LATE_TOKENS wave) under a budget
    (``late_budget_s``: FAILOVER_LATE_BUDGET_S on the card, 1 ms on the CPU,
    where the tiny model's replay is cheap) the replay's measured price
    overruns: the migration re-prefills (gated; on the card, in less than
    that price and within the budget), its streams against the fault-free
    wave's recorded. Then the prefix-cache engine's migration at the fourth
    chunk, the reference's re-prefill through the cached-chunk arithmetic:
    one failover, 8 recovered, the pool whole (gated), its streams
    recorded."""
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    gen = main_path["generator"]
    config, params, dev = gen.config, gen.step.params, gen.step.device
    early = "crash@backend.decode:after=3:count=1"
    late = f"crash@backend.decode:after={FAILOVER_LATE_AFTER}:count=1"
    if late_budget_s is None:
        late_budget_s = FAILOVER_LATE_BUDGET_S if dev.type == "cuda" else 1e-3
    row = {"phase": "engine_failover", "card": main_path["card"], "plan": early}
    for prefix in (False, True):
        serve = ServeConfig(max_batch=ENGINE_BATCH, decode_chunk_size=8, kv_mode="paged",
                            page_size=ENGINE_PAGE, failover_local=True, prefix_cache=prefix)
        eng = BatchEngine(config, params, gen.tokenizer, max_seq_len=ENGINE_MAX_SEQ,
                          cache_dtype=torch.bfloat16, serve=serve, device=dev)
        try:
            _wave(eng, ENGINE_TOKENS, warm_messages(), together=True)
            want = _wave(eng, ENGINE_TOKENS, together=True)
            got = _failover_wave(eng, ENGINE_TOKENS, early)
            if prefix:
                eng._prefix.clear()
                alloc = eng.backend.allocator
                row["prefix_cache"] = {
                    "equal_streams": _equal_streams(got["streams"], want["streams"]),
                    "finish_reasons": got["finish_reasons"], "migrations": got["migrations"],
                    "failovers": eng.stats["failovers"], "recovered": eng.stats["recovered"],
                    "stream_errors": eng.stats["stream_errors"], "wall_s": got["wall_s"],
                    "pool_whole": alloc.pages_free == alloc.pages_total}
                continue
            alloc = eng.backend.allocator
            row.update({
                "equal_streams": _equal_streams(got["streams"], want["streams"]),
                "finish_reasons": got["finish_reasons"], "failovers": eng.stats["failovers"],
                "recovered": eng.stats["recovered"], "stream_errors": eng.stats["stream_errors"],
                "wall_s": got["wall_s"], "fault_free_wall_s": want["wall_s"],
                "migrations": got["migrations"],
                "replay_s_per_position": eng._replay_s_per_pos,
                "pool_whole": alloc.pages_free == alloc.pages_total})
            want_late = _wave(eng, FAILOVER_LATE_TOKENS, together=True)
            price = eng._replay_s_per_pos * 8 * FAILOVER_LATE_AFTER
            got_late = _failover_wave(eng, FAILOVER_LATE_TOKENS, late, late_budget_s)
            row["late"] = {
                "plan": late, "budget_s": late_budget_s, "replay_price_s": price,
                "equal_streams": _equal_streams(got_late["streams"], want_late["streams"]),
                "finish_reasons": got_late["finish_reasons"],
                "stream_errors": got_late["stream_errors"], "migrations": got_late["migrations"],
                "wall_s": got_late["wall_s"], "fault_free_wall_s": want_late["wall_s"],
                "pool_whole": alloc.pages_free == alloc.pages_total}
        finally:
            eng.stop()
    emit(row)
    late_row, pc = row["late"], row["prefix_cache"]
    gates = {"streams equal 8/8": row["equal_streams"] == ENGINE_BATCH,
             "one failover": row["failovers"] == 1,
             "recovered 8": row["recovered"] == ENGINE_BATCH,
             "no error": row["stream_errors"] == 0, "pool whole": row["pool_whole"],
             "replayed": [m["how"] for m in row["migrations"]] == ["replay"],
             "late: re-prefilled": [m["how"] for m in late_row["migrations"]] == ["reprefill"],
             "late: under the replay's price and within the budget on the card": (
                 dev.type != "cuda" or all(
                     m["seconds"] < min(late_row["replay_price_s"], late_budget_s)
                     for m in late_row["migrations"])),
             "late: no error": late_row["stream_errors"] == 0 and set(
                 late_row["finish_reasons"]) <= {"length", "stop"},
             "late: pool whole": late_row["pool_whole"],
             "prefix cache: one failover, 8 recovered, no error": (
                 pc["failovers"], pc["recovered"], pc["stream_errors"]) == (1, ENGINE_BATCH, 0),
             "prefix cache: re-prefilled": [m["how"] for m in pc["migrations"]] == ["reprefill"],
             "prefix cache: pool whole": pc["pool_whole"]}
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"engine failover gates failed: {failed}")
    return row


def _phi3_rolling(torch, config, params, path: dict, n_tokens: int) -> dict:
    """Phi-3's rolling pass: the full cache (the phase's step) and a ring of
    window + PREFILL_CHUNK slots over an ``n_tokens`` prompt, 64 greedy
    tokens per step and in graph chunks (``_quantized_generate``: warmed
    up, launches gated, every decode and continuation on the ring)."""
    from cake_tpu_torch.models.llama.generator import LocalForwardStep
    from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer

    full = path["generator"].step
    roll = LocalForwardStep(config, params, max_seq_len=PHI3_MAX_SEQ, cache_dtype=torch.bfloat16,
                            device=full.device, rolling_budget=PREFILL_CHUNK)
    rpath = {**path, "text": _prompt_text(ByteTokenizer(), config, n_tokens)}
    runs, equal, launches = [], [], {}
    for chunk in (1, FUSED_CHUNK):
        ids = {}
        for name, step in (("full", full), ("rolling", roll)):
            _, ids[name], run = _quantized_generate(torch, rpath, step, chunk, DECODE_TOKENS,
                                                    False)
            run.update(cache=name, ring_launches=_ring_counts(),
                       cache_slots=step._kv.max_seq_len,
                       kv_bytes=2 * step._kv.k.numel() * step._kv.k.element_size())
            runs.append(run)
            if name == "rolling":
                for k, n in run["ring_launches"].items():
                    launches[f"{k}_ring"] = launches.get(f"{k}_ring", 0) + n
        equal.append(sum(x == y for x, y in zip(ids["rolling"], ids["full"])))
    out = {"prompt_tokens": n_tokens, "ring_slots": roll._kv.max_seq_len, "runs": runs,
           "equal_tokens": equal, "launches": launches,
           "equal": equal == [DECODE_TOKENS, DECODE_TOKENS] and roll.rolling}
    del roll
    return out


def kernel_summary(rows: dict, main_path: dict, engine_path: dict, fused_paths=(),
                   int4_paths=(), f8_paths=(), continuous_path=None, distributed_path=None,
                   model_paths=(), admission_path=None, obs_path=None,
                   rolling_path=None) -> dict:
    # The generate phase counted the dense kernels, the engine phase the paged
    # ones, the fused phases (generate_fused, engine_fused) the fused ones,
    # the int4 phases (generate_int4, engine_int4) int4_matmul, the f8 phases
    # (generate_f8, engine_f8) the five kernels' launches over an f8 cache;
    # engine_continuous adds its paged kernels' and noise kernel's launches,
    # engine_admission its gated waves' paged kernels', obs its armed waves',
    # distributed its TCP
    # runs' dense kernels' and noise kernel's, the model phases (moe, phi3)
    # every kernel's they ran.
    launches = {**engine_path["launches"], **main_path["launches"]}
    extra = dict(continuous_path["launches"]) if continuous_path else {}
    for path in (distributed_path, admission_path, obs_path):
        for name, n in (path or {}).get("launches", {}).items():
            extra[name] = extra.get(name, 0) + n
    model_launches = _sum_launches(p["launches"] for p in model_paths)
    for name in ("paged_decode_attention", "paged_chunk_attention", "decode_attention",
                 "chunk_prefill_attention"):
        launches[name] += extra.get(name, 0)
    for name in FUSED_MAIN:
        launches[name] = sum(p["fused_launches"][name] for p in fused_paths)
    launches["int4_matmul"] = sum(p["int4_launches"] for p in int4_paths)
    for name in KERNEL_WRAPPERS:
        launches[name] = launches.get(name, 0) + model_launches.get(name, 0)
    spec = [
        ("decode_attention", "cake_tpu_torch/ops/csrc/decode_attention.cu",
         "cake_tpu/ops/pallas/decode_attention.py:106", ("decode_attention",),
         ("decode_attention", "main_path")),
        ("chunk_prefill_attention", "cake_tpu_torch/ops/csrc/chunk_prefill.cu",
         "cake_tpu/ops/pallas/chunk_prefill.py:151", ("chunk_prefill_attention", "flash_attention"),
         ("chunk_prefill_attention", "main_path")),
        ("paged_decode_attention", "cake_tpu_torch/ops/csrc/paged_decode_attention.cu",
         "cake_tpu/ops/pallas/paged_attention.py:130", ("paged_decode_attention",),
         ("paged_decode_attention", "main_path")),
        ("paged_chunk_attention", "cake_tpu_torch/ops/csrc/paged_chunk_attention.cu",
         "cake_tpu/ops/pallas/paged_prefill.py:173", ("paged_chunk_attention",),
         ("paged_chunk_attention", "main_path")),
        ("fused_norm_matmul", "cake_tpu_torch/ops/csrc/fused_norm_matmul.cu",
         "cake_tpu/ops/pallas/fused_norm_matmul.py:107", ("fused_norm_matmul",),
         ("fused_norm_matmul", FUSED_MAIN["fused_norm_matmul"])),
        ("fused_qkv_ingest", "cake_tpu_torch/ops/csrc/fused_ingest.cu",
         "cake_tpu/ops/pallas/fused_ingest.py:197", ("fused_qkv_ingest",),
         ("fused_qkv_ingest", FUSED_MAIN["fused_qkv_ingest"])),
        ("fused_sample_tail", "cake_tpu_torch/ops/csrc/fused_sample_tail.cu",
         "cake_tpu/ops/pallas/fused_sample_tail.py:172", ("fused_sample_tail",),
         ("fused_sample_tail", FUSED_MAIN["fused_sample_tail"])),
        ("int4_matmul", "cake_tpu_torch/ops/csrc/int4_matmul.cu",
         "cake_tpu/ops/pallas/int4_matmul.py:90", ("int4_matmul",), ("int4_matmul", INT4_MAIN)),
    ]
    # The f8 instantiations of the five kernels that read or write the cache,
    # timed at the same main-path operands over an f8 cache.
    f8_cases = {"decode_attention": "main_path_f8", "chunk_prefill_attention": "main_path_f8",
                "paged_decode_attention": "main_path_f8", "paged_chunk_attention": "main_path_f8",
                "fused_qkv_ingest": "paged_b8_f8"}
    for name in f8_cases:
        launches[f"{name}_f8"] = sum(p["f8_launches"].get(name, 0) for p in f8_paths)
        launches[f"{name}_f8"] += model_launches.get(f"{name}.f8", 0)
    spec += [(f"{name}_f8", source.replace("decode_attention.cu", "decode_attention_f8.cu"),
              replaces, families, (name, f8_cases[name]))
             for name, source, replaces, families, _ in list(spec) if name in f8_cases]
    # The noise kernel replaces no Pallas kernel: the JAX package draws the
    # same noise with XLA. Its launches: the sampled waves of engine_fused.
    launches["threefry_noise"] = (sum(p.get("noise_launches", 0) for p in fused_paths)
                                  + extra.get("threefry_noise", 0))
    spec.append(("threefry_noise", "cake_tpu_torch/ops/csrc/threefry.cu",
                 "cake_tpu/ops/pallas/fused_sample_tail.py:62", ("threefry_noise",),
                 ("threefry_noise", "per_row_b8")))
    # The grouped expert GEMM replaces no Pallas kernel either: the JAX
    # package's grouped MoE dispatch is XLA's ragged_dot. Its launches: the
    # moe phase's prefills (generator and engines).
    launches["grouped_matmul"] = model_launches.get("grouped_matmul", 0)
    if ("grouped_matmul", "mixtral_w_gate") in rows:
        spec.append(("grouped_matmul", "cake_tpu_torch/ops/csrc/moe_grouped.cu",
                     "cake_tpu/ops/moe.py:95", ("grouped_matmul",),
                     ("grouped_matmul", "mixtral_w_gate")))
    # The ring instantiations of the two dense attention kernels (the rolling
    # window cache): launches in phase rolling (Mistral-7B, bf16 and f8) and
    # phi3's rolling pass (head dim 96, among its shapes).
    for name, source in (("decode_attention_ring", "ring_decode_attention.cu"),
                         ("decode_attention_ring_f8", "ring_decode_attention_f8_wide.cu"),
                         ("chunk_prefill_attention_ring", "ring_chunk_attention.cu"),
                         ("chunk_prefill_attention_ring_f8", "ring_chunk_attention_f8.cu")):
        base = name.removesuffix("_f8")
        if (base, "mistral") not in rows:
            continue
        launches[name] = ((rolling_path or {}).get("launches", {}).get(name, 0)
                          + model_launches.get(name, 0))
        dense = "decode_attention" if name.startswith("decode") else "chunk_prefill_attention"
        replaces = next(r for n, _, r, _, _ in spec if n == dense)
        spec.append((name, f"cake_tpu_torch/ops/csrc/{source}", replaces, (base,),
                     (base, "mistral_f8" if name.endswith("_f8") else "mistral")))
    bits = rows.get(("int4_matmul", "wgmma_bits"), {}).get("answer")
    out = []
    for name, source, replaces, families, timed in spec:
        f8 = name.endswith("_f8")
        t = rows[timed]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for k, r in rows.items()
                               if k[0] in families and "max_abs_err" in r
                               and k[1].endswith("_f8") == f8),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        }
        if name in ("fused_qkv_ingest", "fused_sample_tail", "fused_qkv_ingest_f8",
                    "threefry_noise"):
            # An empty kernel's time: these kernels' bytes bound lies below it.
            entry["launch_floor_ms"] = rows[("launch_floor", "empty_kernel")]["ms"]
        if name == "grouped_matmul":
            entry["counterpart"] = ("no Pallas kernel: the JAX package's grouped MoE dispatch "
                                    "is XLA's ragged_dot (_ragged)")
            entry["library"] = t.get("library")
            entry["row_independence"] = all(all(r["equal"].values()) for k, r in rows.items()
                                            if k[0] == name and "row_independence" in k[1])
        if name == "threefry_noise":
            entry["counterpart"] = ("no Pallas kernel: the JAX package draws this noise with "
                                    "XLA (gumbel_noise, jax.random.gumbel)")
            entry["library"] = t.get("library")
            entry["gumbel_bitwise"] = all(r["gumbel_bitwise"] for k, r in rows.items()
                                          if k[0] == name and "gumbel_bitwise" in r)
        if "_ring" in name:
            entry["layout"] = ("RingLayout: the rolling window cache, logical position j in "
                               "slot j mod L; bitwise the dense-layout kernel on the same keys")
            entry["dense_bitwise"] = all(r["dense_bitwise"] for k, r in rows.items()
                                         if k[0] == families[0])
            entry["library"] = t.get("library")
        if f8:
            entry["kv_dtype"] = "f8"
            entry["library"] = t.get("library")
        elif name in REDESIGNED:
            # The instructions its cases ran on (traced), and int4_matmul's
            # bits probe answer.
            entry["redesigned"] = REDESIGNED[name]
            entry["instructions"] = sorted({r["route"] for k, r in rows.items()
                                            if k[0] in families and "route" in r})
            if name == "int4_matmul":
                entry["wgmma_bits"] = bits
        if model_paths and not f8:
            entry["shapes"] = _shape_rows(rows, name, model_paths)
        out.append(entry)
    return {"kernels": out}


# The shape cases a model phase runs: its launches stand beside them.
_SHAPE_PHASE = {"phi3": "phi3"}


def _shape_rows(rows: dict, name: str, model_paths) -> list:
    """A kernel's cases at the MoE and Phi-3 shapes (shape_cases), each
    with the launches the model phase of its shape made (Phi-3's head dim
    96; None where no phase serves the shape)."""
    by_phase = {p["phase"]: p["launches"] for p in model_paths}
    out = []
    for (kernel, case), r in rows.items():
        if kernel != name or not case.startswith(("phi3_", "qwen3_235b", "qwen3_30b", "g12",
                                                   "g32")):
            continue
        phase = _SHAPE_PHASE.get(case.split("_")[0])
        n = by_phase.get(phase, {}).get(kernel + (".f8" if case.endswith("_f8") else ""))
        out.append({"case": case, "launches": n,
                    **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")}})
    return out


# Kernels a later PR redesigned, with that PR.
REDESIGNED = {"chunk_prefill_attention": "PR 5", "paged_chunk_attention": "PR 5",
              "int4_matmul": "PR 5", "decode_attention": "PR 6",
              "paged_decode_attention": "PR 6", "fused_norm_matmul": "PR 7",
              "fused_qkv_ingest": "PR 8", "fused_sample_tail": "PR 8"}


# ---------------------------------------------------------------- main


def main() -> int:
    import cake_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    env = phase_env(torch)
    dev = torch.device("cuda")
    phase_build()
    kernel_rows = phase_kernels(torch)
    main_path = phase_generate(torch, env["nvidia_smi"])
    phase_api(main_path)
    engine_path = phase_engine(torch, main_path)
    kernel_rows.update(engine_kernel_cases(torch, engine_path))
    phase_api_engine(main_path, engine_path)
    fused_paths = (phase_generate_fused(torch, main_path), phase_engine_fused(torch, main_path))
    continuous_path = phase_engine_continuous(torch, main_path)
    torch.cuda.empty_cache()
    admission_path = phase_engine_admission(torch, main_path)
    torch.cuda.empty_cache()
    obs_path = phase_obs(torch, main_path)
    torch.cuda.empty_cache()
    distributed_path = phase_distributed(torch, main_path)
    torch.cuda.empty_cache()
    f8_paths = (phase_generate_f8(torch, main_path), phase_engine_f8(torch, main_path, engine_path))
    int4_path = phase_generate_int4(torch, main_path)
    int4_engine = phase_engine_int4(torch, main_path, int4_path)
    kernel_rows.update(int4_engine["kernel_rows"])
    torch.cuda.empty_cache()
    phase_decode_graph(torch, main_path, int4_path)
    del int4_path["params"]
    torch.cuda.empty_cache()
    phase_generate_int8(torch, main_path)
    torch.cuda.empty_cache()
    kernel_rows.update({(r["kernel"], r["case"]): r for r in shape_cases(torch, dev)})
    moe_path = phase_moe(torch, main_path)
    kernel_rows.update(moe_grouped_cases(torch, dev, moe_path["group_sizes"]))
    kernel_rows.update(moe_grouped_qwen3_cases(torch, dev))
    model_paths = (moe_path, phase_phi3(torch, main_path))
    torch.cuda.empty_cache()
    kernel_rows.update({(r["kernel"], r["case"]): r for r in ring_cases(torch, dev)})
    torch.cuda.empty_cache()
    rolling_path = phase_rolling(torch, main_path)
    torch.cuda.empty_cache()
    phase_cli(torch)
    emit(kernel_summary(kernel_rows, main_path, engine_path, fused_paths,
                        (int4_path, int4_engine), f8_paths, continuous_path, distributed_path,
                        model_paths, admission_path, obs_path, rolling_path))
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
