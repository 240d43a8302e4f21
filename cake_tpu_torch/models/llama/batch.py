"""Lockstep batch forward over the dense and the paged KV cache (port of
``cake_tpu/models/llama/batch.py``, the serving engine's device half).

B independent dialogs decode in lockstep:

  * Prompts are **left-padded** to one 16-multiple bucket, so every row's
    last prompt token sits at the same slot and prefill/decode keep SCALAR
    slot offsets.
  * Slot s of row r holds rope position ``s - pad_r``. Pad query rows clamp
    to position 0 (garbage nobody reads).
  * Decode runs the whole batch one token per step, ``n`` steps per chunk:
    forward -> per-row repeat penalty -> per-row sampling -> feed back, all
    on the device; the chunk's ids are read back once (the JAX package's
    fused ``lax.scan``; here a loop of one-token steps, which the backends
    capture as one CUDA graph on the card, models/llama/fused.py). The
    step's slot is then a device tensor, so nothing of it is baked in.

Masks live in SLOT space. The JAX package's XLA attention masks with a key
position grid (pad slots carry a sentinel position); its kernels, and every
attention path of the port (CUDA kernel or plain version), take per-row
bounds instead: ``pads`` (first live key slot), ``lengths`` (live prefix),
``q_starts`` and causality. Left-padding shifts a row's queries and keys
equally, so the two masks admit the same keys (tests/test_torch_batch.py
holds them equal); the position helpers below therefore return the query
(rope) positions and the per-row lengths, not the key grid.

The per-row int32 operands (pads, lengths, q_starts, write bounds, the block
table) and the gathered rope rows are built once per dispatch, never once
per layer. Keys rope at their query positions (the same for every live
slot; pad and dead slots get finite garbage that no mask admits).

The decode fusions (``LlamaConfig.fusion_impl``, ops/fuse.py) are resolved
once per dispatch: "norm" at the model's three norm sites, "ingest" on the
decode step (split + rope + the one-slot K/V write in one kernel, dense or
through the block table; Qwen3's q/k-norm trees keep the unfused path) and
"tail" in ``sampled_decode_loop``.

MoE layers run through ``block_finish`` (ops/moe.py): a prefill window of
8 rows or more takes the grouped dispatch, pads included, as in the JAX
package; a decode step the dense combine. Tensor parallelism (with it the
MoE capacity dispatch), the 1F1B row window and ragged pipeline stages are
not ported yet: they raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.cache import KVCache, write_layer
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.fused import sampled_decode_loop
from cake_tpu_torch.models.llama.paged_cache import PagedKVCache, write_pages, write_plan
from cake_tpu_torch.ops.chunk_prefill import chunk_prefill_attention
from cake_tpu_torch.ops.decode_attention import decode_attention
from cake_tpu_torch.ops.fuse import resolve_fusion
from cake_tpu_torch.ops.fused_ingest import fused_qkv_ingest
from cake_tpu_torch.ops.paged_attention import paged_decode_attention
from cake_tpu_torch.ops.paged_prefill import paged_chunk_attention
from cake_tpu_torch.ops.rope import model_rope_tables
from cake_tpu_torch.ops.sampling import apply_repeat_penalty, draw, sample

BUCKET_MULTIPLE = 16
_NOT_PORTED = "is not ported yet (ROADMAP.md queue A)"


def prompt_bucket(longest: int, max_seq_len: int) -> int:
    """The shared left-pad bucket for a batch whose longest prompt is
    ``longest``: a 16-multiple (admission uses the same helper, so refusal
    agrees with the real layout)."""
    return min(-(-longest // BUCKET_MULTIPLE) * BUCKET_MULTIPLE, max_seq_len)


def layout_prompts(
    ids_list: list[list[int]], max_seq_len: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Left-pad prompts into one shared bucket: (tokens [B, bucket], pads [B], bucket)."""
    longest = max(len(i) for i in ids_list)
    bucket = prompt_bucket(longest, max_seq_len)
    b = len(ids_list)
    tokens = np.zeros((b, bucket), np.int32)
    pads = np.zeros((b,), np.int32)
    for r, ids in enumerate(ids_list):
        pads[r] = bucket - len(ids)
        tokens[r, pads[r] :] = ids
    return tokens, pads, bucket


def seed_rings(ids_list: list[list[int]], window: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-row repeat-penalty rings seeded from each prompt's tail:
    (ring [B, window], ring_idx [B]), each row's circular window as in its
    single-sequence run."""
    b = len(ids_list)
    ring = np.full((b, max(window, 0)), -1, np.int32)
    ring_idx = np.zeros((b,), np.int32)
    if window > 0:
        for r, ids in enumerate(ids_list):
            recent = ids[-window:]
            ring[r, : len(recent)] = recent
            ring_idx[r] = min(window, len(ids)) % window
    return ring, ring_idx


def first_sample(logits: torch.Tensor, s, ring: np.ndarray, ring_idx: np.ndarray, keys):
    """Penalize + sample the FIRST post-prefill token and advance the rings:
    the one definition of the first-token arithmetic, shared by the epoch
    start and the joins. ``keys`` [B, 2] threefry keys give each row its own
    stream (the JAX package's ``vmap(split)`` and ``sample_per_row``).

    Returns (first [B] np.int32, keys, ring, ring_idx)."""
    penalized = apply_repeat_penalty(
        logits, s.repeat_penalty, torch.as_tensor(ring, device=logits.device)
    )
    keys, noise = draw(keys, penalized, s.temperature)
    first = sample(penalized, None, s.temperature, s.top_k, s.top_p, noise=noise)
    first = first.cpu().numpy().astype(np.int32)
    window = ring.shape[1]
    if window > 0:
        ring[np.arange(first.shape[0]), ring_idx] = first
        ring_idx = (ring_idx + 1) % window
    return first, keys, ring, ring_idx


# ---------------------------------------------------------------- positions


def prefill_positions(
    width: int, pads: torch.Tensor, ends: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The left-padded PREFILL layout over [B, width] slots: (q_pos [B, width]
    rope positions, lengths [B]). Pad slots and, with ``ends`` (a join's
    window), dead tail slots get position 0; lengths are ``ends`` or width."""
    slots = torch.arange(width, device=pads.device, dtype=torch.int64)[None, :]
    q_pos = (slots - pads.long()[:, None]).clamp(min=0)
    if ends is None:
        lengths = torch.full((pads.shape[0],), width, dtype=torch.int32, device=pads.device)
        return q_pos, lengths
    q_pos = torch.where(slots >= ends.long()[:, None], 0, q_pos)
    return q_pos, ends.to(torch.int32)


def decode_positions(slot, pads: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One token at shared ``slot``: (q_pos [B, 1], lengths [B] = slot + 1).
    ``slot`` is a host int or a 0-d int64 tensor on the device (the decode
    step of a captured chunk): both then derive from it on the device."""
    q_pos = (slot - pads.long())[:, None]
    if isinstance(slot, torch.Tensor):
        return q_pos, (slot.expand(pads.shape[0]) + 1).to(torch.int32)
    lengths = torch.full((pads.shape[0],), slot + 1, dtype=torch.int32, device=pads.device)
    return q_pos, lengths


def verify_positions(
    width: int, pads: torch.Tensor, slot: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """A cached chunk at slots [slot, slot + width): (q_pos [B, width],
    lengths [B] = slot + width). Rows whose window starts below their own
    pad get negative positions there; their queries see no key."""
    grid = slot + torch.arange(width, device=pads.device, dtype=torch.int64)[None, :]
    q_pos = grid - pads.long()[:, None]
    lengths = torch.full((pads.shape[0],), slot + width, dtype=torch.int32, device=pads.device)
    return q_pos, lengths


# ---------------------------------------------------------------- forward


def batched_blocks_forward(
    layers: M.Params,
    x: torch.Tensor,
    kv: KVCache | PagedKVCache,
    cos: torch.Tensor,
    sin: torch.Tensor,
    q_pos: torch.Tensor,
    config: LlamaConfig,
    *,
    decode: bool,
    pads: torch.Tensor,
    lengths: torch.Tensor,
    write_pos,
    cached_chunk: bool = False,
    block_tables: torch.Tensor | None = None,
    write_starts: torch.Tensor | None = None,
    valid=None,
    tp_axis=None,
    row_offset=None,
    fusion=None,
):
    """THE pad-aware layer walk for left-padded batches, dense or paged.

    Args:
      x: [B, W, hidden]; its tokens sit at slots [write_pos, write_pos + W).
        ``write_pos`` is a host int, or on a decode step a 0-d int64 device
        tensor (every write and bound then derives from it on the device).
      kv: the dense cache or (with ``block_tables``) the page pool, written
        in place.
      cos/sin: rope tables covering every position of the dispatch.
      q_pos: [B, W] rope positions (negative entries clamp to 0).
      decode: one token per row at slot ``write_pos``.
      pads: [B] int32 first live key slot per row (the left pads).
      lengths: [B] int32 live prefix per row (the kernels' pruning bound).
      cached_chunk: a multi-token chunk at ``write_pos`` > 0 attends the live
        cache prefix (the prefix-cache suffix prefill); otherwise a chunk is
        a fresh prefill from slot 0 (``q_starts = 0``).
      block_tables: [B, n_p] int32 on the device: PAGED mode. Writes go
        through the table (unmapped and past-the-table writes sink); decode
        reads run paged_decode_attention, chunks paged_chunk_attention.
      write_starts: [B] int32, paged only: row b's writes below
        ``write_starts[b]`` sink, so forked shared prefix pages stay
        byte-stable.
      fusion: the enabled fusions, from ``resolve_fusion`` (None: from the
        config).
    """
    if valid is not None:
        raise NotImplementedError(f"ragged pipeline stages (valid=) {_NOT_PORTED}")
    if tp_axis is not None:
        raise NotImplementedError(f"tensor-parallel batch bodies {_NOT_PORTED}")
    if row_offset is not None:
        raise NotImplementedError(f"the 1F1B row-window decode {_NOT_PORTED}")
    paged = block_tables is not None
    if write_starts is not None and not paged:
        raise ValueError("write_starts is a paged-only mode")
    if fusion is None:
        fusion = resolve_fusion(config)
    b, width, _ = x.shape
    q_pos = q_pos.clamp(min=0)
    # Layer-invariant: the rope rows, the query starts and the write plan.
    if cos.dim() == 3:  # dual-rope tables [2, seq, hd/2]; block_qkv selects
        cos, sin = cos[:, q_pos], sin[:, q_pos]
    else:
        cos, sin = cos[q_pos], sin[q_pos]
    q_starts = torch.full((b,), write_pos if cached_chunk else 0, dtype=torch.int32,
                          device=x.device)
    plan = None
    kw = dict(
        window=config.sliding_window,
        scale=config.attn_scale,
        softcap=config.attn_logit_softcap,
    )
    for i in range(kv.n_layers):
        lp = {name: w[i] for name, w in layers.items()}
        win_flag = lp.get("win_flag")
        k_c, v_c = kv.k[i], kv.v[i]
        if (decode and "ingest" in fusion and "wqkv" in lp and "q_norm" not in lp
                and write_starts is None):
            # Fused decode ingest (ops/fused_ingest.py): the flat projection
            # row is split, roped and its K/V written in one kernel; the
            # dual-rope layers (Gemma-3) select their plane as block_qkv does.
            qkv = M.block_qkv_flat(lp, x, config, fusion)
            cos_l, sin_l = (cos[lp["rope_sel"]], sin[lp["rope_sel"]]) if "rope_sel" in lp \
                else (cos, sin)
            q = fused_qkv_ingest(
                qkv, cos_l, sin_l, write_pos, k_c, v_c, n_q=config.num_attention_heads,
                n_kv=config.num_key_value_heads, block_tables=block_tables,
            )
        else:
            q, k, v = M.block_qkv(lp, x, cos, sin, None, config, fusion)
            if not paged:
                write_layer(k_c, v_c, k, v, write_pos)
            else:
                if plan is None:
                    plan = write_plan(
                        write_pos, width, block_tables, kv.n_pages, kv.page_size, write_starts
                    )
                write_pages(k_c, v_c, k, v, plan)
        if paged:
            if decode:
                attn = paged_decode_attention(
                    q, k_c, v_c, lengths, block_tables, pads, win_flag, **kw
                )
            else:
                attn = paged_chunk_attention(
                    q, k_c, v_c, q_starts, lengths, pads, block_tables, win_flag, **kw
                )
        else:
            if decode:
                attn = decode_attention(q, k_c, v_c, lengths, pads, win_flag, **kw)
            else:
                attn = chunk_prefill_attention(
                    q, k_c, v_c, q_starts, lengths, win_flag, pads, **kw
                )
        x = M.block_finish(lp, x, attn, config, fusion)
    return x, kv


def lockstep_range_ops(config: LlamaConfig, rope):
    """(prefill, decode, join) over a BARE stacked-layer range (port of
    ``make_lockstep_range_ops``): the lockstep ops a block-range executor
    runs, shared by the TCP worker (runtime/worker.py) and the TCP master's
    own ranges (runtime/batch_backend.DistributedBatchBackend), so both
    sides of the wire run the same code, and the same kernels at the same
    shapes as the local backends. ``rope`` is the (cos, sin) tables.

      prefill(layers, x, kv, pads, ends)         -> (x, kv)  slots [0, W)
      decode(layers, x, kv, pads, slot)          -> (x, kv)  one token at slot
      join(layers, x, kv, pads1, ends1, lane)    -> (x, kv)  one row's window
          prefilled straight into ``lane``'s strip of the cache (a view,
          written in place), as LocalBatchBackend.join does
    """
    cos, sin = rope
    fusion = resolve_fusion(config)

    def prefill(layers, x, kv, pads, ends):
        q_pos, lengths = prefill_positions(x.shape[1], pads, ends)
        return batched_blocks_forward(
            layers, x, kv, cos, sin, q_pos, config,
            decode=False, pads=pads, lengths=lengths, write_pos=0, fusion=fusion,
        )

    def decode(layers, x, kv, pads, slot: int):
        q_pos, lengths = decode_positions(slot, pads)
        return batched_blocks_forward(
            layers, x, kv, cos, sin, q_pos, config,
            decode=True, pads=pads, lengths=lengths, write_pos=slot, fusion=fusion,
        )

    def join(layers, x, kv, pads1, ends1, lane: int):
        lane_kv = KVCache(kv.k[:, lane : lane + 1], kv.v[:, lane : lane + 1])
        x, _ = prefill(layers, x, lane_kv, pads1, ends1)
        return x, kv

    return prefill, decode, join


def _rope(rope, config: LlamaConfig, n_slots: int, device):
    return rope if rope is not None else model_rope_tables(config, n_slots, device)


def batched_prefill(
    params: M.Params,
    tokens: torch.Tensor,  # [B, L] left-padded
    kv: KVCache,
    pads: torch.Tensor,  # [B] int32 left-pad counts
    config: LlamaConfig,
    ends: torch.Tensor | None = None,  # [B] int32 end slot per row (< L ok)
    seq_len: int | None = None,  # logits slot + 1; default L
    rope=None,
):
    """Prefill the padded batch at slots [0, L) of the dense cache; logits
    at slot ``seq_len - 1``. A continuous-batching JOIN prefills one row
    whose prompt ENDS at the running batch's shared slot: its window is
    wider than the prompt, so ends < L and seq_len = ends."""
    b, l = tokens.shape
    cos, sin = _rope(rope, config, kv.max_seq_len, tokens.device)
    fusion = resolve_fusion(config)
    x = M.embed_tokens(params, tokens, config)
    q_pos, lengths = prefill_positions(l, pads, ends)
    x, kv = batched_blocks_forward(
        params["layers"], x, kv, cos, sin, q_pos, config,
        decode=False, pads=pads, lengths=lengths, write_pos=0, fusion=fusion,
    )
    return M.head_forward(params, x, l if seq_len is None else seq_len, config, fusion), kv


def paged_prefill(
    params: M.Params,
    tokens: torch.Tensor,  # [B, L] left-padded
    kv: PagedKVCache,
    pads: torch.Tensor,
    block_tables: torch.Tensor,  # [B, n_p] int32
    config: LlamaConfig,
    ends: torch.Tensor | None = None,
    seq_len: int | None = None,
    write_starts: torch.Tensor | None = None,
    rope=None,
):
    """batched_prefill through the page pool: row r's prompt KV lands in
    the pages its table row maps; the chunk attends what its own writes
    just put there (paged_chunk_attention, ``q_starts = 0``)."""
    b, l = tokens.shape
    cos, sin = _rope(rope, config, block_tables.shape[1] * kv.page_size, tokens.device)
    fusion = resolve_fusion(config)
    x = M.embed_tokens(params, tokens, config)
    q_pos, lengths = prefill_positions(l, pads, ends)
    x, kv = batched_blocks_forward(
        params["layers"], x, kv, cos, sin, q_pos, config,
        decode=False, pads=pads, lengths=lengths, write_pos=0,
        block_tables=block_tables, write_starts=write_starts, fusion=fusion,
    )
    return M.head_forward(params, x, l if seq_len is None else seq_len, config, fusion), kv


def paged_suffix_prefill(
    params: M.Params,
    tokens: torch.Tensor,  # [B, W] window covering slots [start, start + W)
    kv: PagedKVCache,
    pads: torch.Tensor,  # [B] TRUE left pads (may lie outside the window)
    write_starts: torch.Tensor,  # [B] first slot each row may write
    block_tables: torch.Tensor,
    config: LlamaConfig,
    start: int,  # the window's first slot
    rope=None,
):
    """Warm-path prefill: compute ONLY the window [start, start + W), each
    row's prefix below ``write_starts[b]`` served from forked prefix-cache
    pages instead of recomputed. Queries carry their absolute-slot rope
    positions and attend the live pool prefix (cached pages plus their own
    writes); writes below each row's threshold sink. Logits land at the
    window's last slot, where the cold path reads them."""
    b, w = tokens.shape
    cos, sin = _rope(rope, config, block_tables.shape[1] * kv.page_size, tokens.device)
    fusion = resolve_fusion(config)
    x = M.embed_tokens(params, tokens, config)
    q_pos, lengths = verify_positions(w, pads, start)
    x, kv = batched_blocks_forward(
        params["layers"], x, kv, cos, sin, q_pos, config,
        decode=False, cached_chunk=True, pads=pads, lengths=lengths,
        write_pos=start, block_tables=block_tables, write_starts=write_starts, fusion=fusion,
    )
    return M.head_forward(params, x, w, config, fusion), kv


def batched_forward_one(params: M.Params, pads: torch.Tensor, config: LlamaConfig, rope):
    """The one-token dense forward ``(tok [B, 1], kv, slot) -> (logits, kv)``
    for sampled_decode_loop; ``slot`` is the shared slot of the fed token, a
    host int or a 0-d int64 device tensor. The fusions are resolved once,
    for every step of the chunk."""
    cos, sin = rope
    fusion = resolve_fusion(config)

    def forward_one(tok, kv, slot):
        x = M.embed_tokens(params, tok, config)
        q_pos, lengths = decode_positions(slot, pads)
        x, kv = batched_blocks_forward(
            params["layers"], x, kv, cos, sin, q_pos, config,
            decode=True, pads=pads, lengths=lengths, write_pos=slot, fusion=fusion,
        )
        return M.head_forward(params, x, 1, config, fusion), kv

    return forward_one


def paged_forward_one(
    params: M.Params, pads: torch.Tensor, block_tables: torch.Tensor, config: LlamaConfig, rope
):
    """The one-token paged forward, twin of batched_forward_one."""
    cos, sin = rope
    fusion = resolve_fusion(config)

    def forward_one(tok, kv, slot):
        x = M.embed_tokens(params, tok, config)
        q_pos, lengths = decode_positions(slot, pads)
        x, kv = batched_blocks_forward(
            params["layers"], x, kv, cos, sin, q_pos, config,
            decode=True, pads=pads, lengths=lengths, write_pos=slot,
            block_tables=block_tables, fusion=fusion,
        )
        return M.head_forward(params, x, 1, config, fusion), kv

    return forward_one


def decode_chunk(params, kv, tok, slot, pads, keys, ring, ring_idx, config, n, s, rope):
    """One dense decode chunk of ``n`` lockstep steps (the JAX package's
    ``_decode_fn``), run eagerly: the plain version of the captured chunk
    the engine's backend replays on the card (runtime/batch_backend.py)."""
    return sampled_decode_loop(
        batched_forward_one(params, pads, config, rope),
        kv, tok, slot, keys, ring, ring_idx, n_steps=n, s=s,
        fused_tail="tail" in resolve_fusion(config),
    )


def paged_decode_chunk(
    params, kv, tok, slot, pads, block_tables, keys, ring, ring_idx, config, n, s, rope
):
    """One paged decode chunk of ``n`` lockstep steps (the JAX package's
    ``_paged_decode_fn``), run eagerly as ``decode_chunk``; the block table
    holds for the whole chunk."""
    return sampled_decode_loop(
        paged_forward_one(params, pads, block_tables, config, rope),
        kv, tok, slot, keys, ring, ring_idx, n_steps=n, s=s,
        fused_tail="tail" in resolve_fusion(config),
    )
