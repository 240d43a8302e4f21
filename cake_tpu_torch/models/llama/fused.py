"""Multi-token decode on the device (port of
``cake_tpu/models/llama/fused.py``).

The per-step decode loop pays a device-to-host readback per token to pull
the sampled id out. Here the chain

    forward -> repeat penalty -> temperature/top-k/top-p sample -> feed back

runs on the device for ``n_steps`` tokens, and the ids come back once per
chunk. The JAX package compiles the chain into one ``lax.scan``; the port
runs it as a Python loop of one-token forwards and ``sample_step`` calls,
nothing read back in between. Sampling walks the same random stream as the
per-step path (``ops/sampling.sample_step``), so a seeded chunked stream
equals the per-step one.

EOS cannot stop a chunk early; the caller scans the returned ids and drops
the tail past EOS. Its KV writes sit past the live length, where no read
reaches them, and are overwritten if the sequence continues.

With the "tail" fusion (``LlamaConfig.fusion_impl``) each step samples
through ops/fused_sample_tail.py. The generator's ``decode_chunk``
(``LocalForwardStep``) and the batch engine's decode chunks (batch.py) run
this loop.
"""

from __future__ import annotations

import torch

from cake_tpu_torch.ops.sampling import sample_step


def sampled_decode_loop(
    forward_one, kv, tok, slot: int, keys, ring, ring_idx, *, n_steps, s, fused_tail=False
):
    """``n_steps`` one-token steps, forward -> sample_step -> feed back, all
    on the device (port of ``fused.sampled_decode_scan``).

    ``forward_one(tok [B, 1], kv, slot) -> (logits [B, vocab] f32, kv)``;
    ``tok`` [B] is the most recent token at shared ``slot``; its KV is
    written there and the logits predict slot + 1. ``keys``: [B, 2] per-row
    keys or one ``torch.Generator`` (see ``sample_step``); ``s``: the
    sampling knobs. Returns (tokens [B, n_steps] on the device, kv, keys,
    ring, ring_idx); the caller reads the tokens back once per chunk."""
    toks = []
    for i in range(n_steps):
        logits, kv = forward_one(tok[:, None], kv, slot + i)
        tok, keys, ring, ring_idx = sample_step(
            logits, keys, ring, ring_idx,
            temperature=s.temperature, top_k=s.top_k, top_p=s.top_p,
            repeat_penalty=s.repeat_penalty, fused_tail=fused_tail,
        )
        toks.append(tok)
    return torch.stack(toks, dim=1), kv, keys, ring, ring_idx
