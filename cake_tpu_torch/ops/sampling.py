"""Token sampling (port of ``cake_tpu/ops/sampling.py``): argmax,
temperature, top-k, top-p and the repeat penalty over the last
``repeat_last_n`` tokens.

A draw is ``jax.random.categorical``'s gumbel-argmax identity,
``argmax(scaled + g)`` with ``g`` the gumbel noise of a threefry key
(ops/threefry.py): the JAX package's keys, bits and uniforms, so a seeded
sampled stream of the port is the JAX package's. One key (``[2]``) draws a
plane counted over the whole ``[b, vocab]`` (``sample``, the generator's
shared stream); ``[b, 2]`` keys draw a row each (``sample_per_row``, the
batch engine's rows, each a stream of its own). Sampling sites hand f32
logits: jax draws the noise in the logits' dtype, and 16-bit bits would be
another stream.

Greedy (temperature <= 0) draws nothing and leaves a key as it is: its ids
do not depend on the key, and a stream's knobs are fixed for its lifetime.
"""

from __future__ import annotations

import torch

from cake_tpu_torch.ops.threefry import threefry_noise

DEFAULT_SEED = 299792458  # the reference's default seed


def apply_repeat_penalty(
    logits: torch.Tensor, penalty: float, context_tokens: torch.Tensor
) -> torch.Tensor:
    """Divide positive logits of seen tokens by ``penalty``, multiply negative
    ones. logits [b, vocab] f32; context_tokens [b, window] int, -1 = empty."""
    if penalty == 1.0:
        return logits
    b, vocab = logits.shape
    # Empty slots land in one extra column that is dropped.
    idx = torch.where(context_tokens >= 0, context_tokens, vocab).long()
    seen = torch.zeros((b, vocab + 1), dtype=torch.bool, device=logits.device)
    seen = seen.scatter_(1, idx, True)[:, :vocab]
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def _top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def _top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Keep the smallest prefix of sorted probabilities with sum >= p."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    kth_idx = keep_sorted.sum(dim=-1, keepdim=True) - 1
    threshold = torch.gather(sorted_logits, -1, kth_idx)
    return logits.masked_fill(logits < threshold, float("-inf"))


def _filter(logits, temperature, top_k, top_p):
    scaled = logits / temperature
    if top_k is not None:
        scaled = _top_k_mask(scaled, top_k)
    if top_p is not None:
        scaled = _top_p_mask(scaled, top_p)
    return scaled


def _sampled(temperature) -> bool:
    return temperature is not None and temperature > 0.0


def _noise_shape(keys: torch.Tensor, logits: torch.Tensor) -> tuple:
    """One plane over the logits for one key; a row each for [b, 2] keys."""
    if logits.dtype != torch.float32:
        raise ValueError(f"sampling: the draw needs f32 logits, got {logits.dtype}")
    if keys.dim() == 2 and keys.shape[0] != logits.shape[0]:
        raise ValueError(f"sampling: {keys.shape[0]} keys for {logits.shape[0]} rows")
    return tuple(logits.shape) if keys.dim() == 1 else tuple(logits.shape[-1:])


def draw(keys: torch.Tensor, logits: torch.Tensor, temperature):
    """(next keys, noise) of one sampled step over ``logits`` [b, vocab] f32:
    ``keys`` split once, the gumbel noise drawn with the subkeys, in one
    launch of the noise kernel on the card. Greedy: (keys, None)."""
    if not _sampled(temperature):
        return keys, None
    if keys is None:
        raise ValueError("sampling: a sampled step needs a key")
    nxt, _, noise = threefry_noise(keys, _noise_shape(keys, logits))
    return nxt, noise


def sample(
    logits: torch.Tensor,
    key: torch.Tensor | None = None,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Token ids [b] from [b, vocab] f32 logits. temperature <= 0 is argmax;
    otherwise ``jax.random.categorical(key, filtered)``: gumbel-argmax over
    the filtered logits with ``noise`` (given) or the noise of ``key`` ([2],
    one plane over the batch; [b, 2], a row each)."""
    if not _sampled(temperature):
        return torch.argmax(logits, dim=-1)
    scaled = _filter(logits, temperature, top_k, top_p)
    if noise is None:
        if key is None:
            raise ValueError("sample: temperature > 0 needs a key or noise")
        _, _, noise = threefry_noise(key, _noise_shape(key, logits), split_keys=False)
    return torch.argmax(scaled + noise, dim=-1)


def sample_per_row(
    logits: torch.Tensor,
    keys: torch.Tensor,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
) -> torch.Tensor:
    """``sample`` with an independent key per row (``keys``: [b, 2], the
    JAX package's ``vmap(categorical)``): row r's draw depends only on its
    own key, so its sampled stream equals a single-row run with that key
    whatever shares the batch."""
    if keys.dim() != 2:
        raise ValueError(f"sample_per_row: keys must be [b, 2], got {tuple(keys.shape)}")
    return sample(logits, keys, temperature, top_k, top_p)


def sample_step(
    logits, keys, ring, ring_idx, *, temperature, top_k, top_p, repeat_penalty, fused_tail=False,
):
    """ONE decode sampling step for a batch of rows (port of
    ``cake_tpu/models/llama/fused.py`` ``sample_step``): repeat penalty over
    each row's ring -> key split -> sample -> ring update.

    Args: logits [b, vocab] f32; keys [2], one stream the rows share (the
    generator's ``decode_chunk``), or [b, 2], a stream a row (the batch
    engine), or None when greedy; ring [b, window] int64 recent ids (-1 =
    empty), updated in place; ring_idx [b] int64 next circular slot. All on
    the device; nothing is read back.

    ``fused_tail`` routes penalty, temperature, top-k and the draw through
    the fused sampling tail (ops/fused_sample_tail.py). The key split and the
    noise stay here either way, so the fused and unfused steps walk one
    random stream and give the same ids.

    Returns (next ids [b] int64, keys, ring, ring_idx)."""
    keys, noise = draw(keys, logits, temperature)
    if fused_tail:
        from cake_tpu_torch.ops.fused_sample_tail import fused_sample_tail

        nxt = fused_sample_tail(
            logits, ring, noise, temperature=temperature, top_k=top_k, top_p=top_p,
            repeat_penalty=repeat_penalty,
        )
    else:
        logits = apply_repeat_penalty(logits, repeat_penalty, ring)
        nxt = sample(logits, None, temperature, top_k, top_p, noise=noise)
    window = ring.shape[1]
    if window > 0:
        ring[torch.arange(nxt.shape[0], device=nxt.device), ring_idx] = nxt
        ring_idx = (ring_idx + 1) % window
    return nxt, keys, ring, ring_idx
