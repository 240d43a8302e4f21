"""Token sampling (port of ``cake_tpu/ops/sampling.py``): argmax,
temperature, top-k, top-p and the repeat penalty over the last
``repeat_last_n`` tokens.

A draw is the gumbel-argmax identity ``argmax(logits + g)`` with
``g = -log(-log(u))``. The uniform ``u`` comes from an explicit
``torch.Generator`` or, so that tests can feed the port and the JAX package
the same noise, from a caller-supplied gumbel tensor; the batch engine's
per-row draws hash a per-row key instead (``sample_per_row``). The JAX
package draws its noise from threefry keys, so a seeded sampled stream
differs between the two packages; greedy streams are equal.
"""

from __future__ import annotations

import torch

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


def draw_uniforms(shape, generator: torch.Generator, device, out=None) -> torch.Tensor:
    """The f32 uniforms of one draw from ``generator`` (``out``: a buffer of
    ``shape`` to draw into, the same bits as a fresh tensor)."""
    return torch.rand(shape, generator=generator, device=device, dtype=torch.float32, out=out)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard gumbel noise from f32 uniforms."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard gumbel noise drawn from ``generator``."""
    return gumbel_from_uniform(draw_uniforms(shape, generator, device))


def sample(
    logits: torch.Tensor,
    generator: torch.Generator | None = None,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Token ids [b] from [b, vocab] f32 logits. temperature <= 0 is argmax;
    otherwise gumbel-argmax over the filtered logits with ``noise`` (given)
    or noise drawn from ``generator``."""
    if temperature is None or temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = _filter(logits, temperature, top_k, top_p)
    if noise is None:
        if generator is None:
            raise ValueError("sample: temperature > 0 needs a generator or noise")
        noise = gumbel_noise(scaled.shape, generator, scaled.device)
    return torch.argmax(scaled + noise, dim=-1)


# ------------------------------------------------------------- per-row keys
#
# The batch engine gives every row its own random stream, so a row's sampled
# tokens do not depend on what else shares the batch (the JAX package's
# per-row threefry keys). A key here is a row of a [b, 2] int64 tensor,
# (seed, counter), kept on the device; a draw hashes (seed, counter, vocab
# index) into a uniform with integer ops, the same bits on the CPU and the
# card, and a split advances the counter. The streams are not threefry's, so
# seeded sampled streams differ from the JAX package's (greedy ones do not).

_M32 = 0xFFFFFFFF


def row_keys(seeds, device) -> torch.Tensor:
    """[b, 2] int64 keys (seed mod 2**32, counter 0), one per row."""
    seeds = torch.as_tensor([int(s) & _M32 for s in seeds], dtype=torch.int64)
    return torch.stack([seeds, torch.zeros_like(seeds)], dim=1).to(device)


def split_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(next keys, the keys to draw with now): the counter advances."""
    nxt = keys.clone()
    nxt[:, 1] += 1
    return nxt, keys


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xorshift-multiply rounds) on int64 values in
    [0, 2**32); multipliers below 2**31 keep every product inside int64."""
    for mul in (0x7FEB352D, 0x68E31DA5, 0x2C1B3C6D):
        x = ((x ^ (x >> 16)) * mul) & _M32
    return x ^ (x >> 16)


def unit_float(h: torch.Tensor) -> torch.Tensor:
    """f32 in (0, 1) from int64 hash values in [0, 2**32): the top 23 bits
    plus a half, every step exact, so the largest is 1 - 2**-24. (24 bits
    plus a half round the top value up to exactly 1.0, where the gumbel
    noise -log(-log(u)) is infinite.)"""
    return ((h >> 9).float() + 0.5) * (1.0 / (1 << 23))


def uniform_per_row(keys: torch.Tensor, n: int) -> torch.Tensor:
    """[b, n] f32 uniforms in (0, 1) from each row's (seed, counter) key."""
    idx = torch.arange(n, device=keys.device, dtype=torch.int64)[None, :]
    h = _mix32(keys[:, :1] ^ 0x9E3779B9)
    h = _mix32(h ^ keys[:, 1:2])
    h = _mix32(h ^ idx)
    return unit_float(h)


def sample_per_row(
    logits: torch.Tensor,
    keys: torch.Tensor,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
) -> torch.Tensor:
    """``sample`` with an independent key per row (``keys``: [b, 2]): row
    r's draw depends only on its own key, so its sampled stream equals a
    single-row run with that key whatever shares the batch."""
    if temperature is None or temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = _filter(logits, temperature, top_k, top_p)
    u = uniform_per_row(keys, scaled.shape[-1])
    return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)


def gumbel_per_row(keys: torch.Tensor, n: int) -> torch.Tensor:
    """[b, n] gumbel rows from each row's key: ``-log(-log(u))`` of
    ``uniform_per_row``, so ``scaled + g`` is ``sample_per_row``'s
    ``scaled - log(-log(u))`` to the bit."""
    return -torch.log(-torch.log(uniform_per_row(keys, n)))


def sample_step(
    logits, keys, ring, ring_idx, *, temperature, top_k, top_p, repeat_penalty, fused_tail=False,
    uniform=None,
):
    """ONE decode sampling step for a batch of rows (port of
    ``cake_tpu/models/llama/fused.py`` ``sample_step``): repeat penalty over
    each row's ring -> key split -> sample -> ring update.

    Args: logits [b, vocab] f32; keys [b, 2] per-row keys, or a
    ``torch.Generator`` whose one stream the rows share (the generator's
    ``decode_chunk``: the draws of its per-step ``sample``, in the same
    order), or None: greedy, or a shared stream whose draw for this step is
    ``uniform`` ([b, vocab] f32, drawn beforehand by ``draw_uniforms``, as
    a captured decode chunk reads it); ring [b, window] int64 recent ids
    (-1 = empty), updated in place; ring_idx [b] int64 next circular slot.
    All on the device; nothing is read back.

    ``fused_tail`` routes penalty, temperature, top-k and the draw through
    the fused sampling tail (ops/fused_sample_tail.py). The key split and the
    noise stay here either way, so the fused and unfused steps walk one
    random stream and give the same ids.

    Returns (next ids [b] int64, keys, ring, ring_idx)."""
    shared = not isinstance(keys, torch.Tensor)
    sampled = temperature is not None and temperature > 0.0
    if sampled and keys is None and uniform is None:
        raise ValueError("sample_step: a sampled step needs keys, a generator or its uniforms")
    if fused_tail:
        from cake_tpu_torch.ops.fused_sample_tail import fused_sample_tail

        sub = keys
        if not shared:
            keys, sub = split_keys(keys)
        noise = None
        if sampled:
            if not shared:
                noise = gumbel_per_row(sub, logits.shape[-1])
            elif uniform is not None:
                noise = gumbel_from_uniform(uniform)
            else:
                noise = gumbel_noise(logits.shape, sub, logits.device)
        nxt = fused_sample_tail(
            logits, ring, noise, temperature=temperature, top_k=top_k, top_p=top_p,
            repeat_penalty=repeat_penalty,
        )
    else:
        logits = apply_repeat_penalty(logits, repeat_penalty, ring)
        if shared:
            noise = gumbel_from_uniform(uniform) if sampled and uniform is not None else None
            nxt = sample(logits, keys, temperature, top_k, top_p, noise=noise)
        else:
            keys, sub = split_keys(keys)
            nxt = sample_per_row(logits, sub, temperature, top_k, top_p)
    window = ring.shape[1]
    if window > 0:
        ring[torch.arange(nxt.shape[0], device=nxt.device), ring_idx] = nxt
        ring_idx = (ring_idx + 1) % window
    return nxt, keys, ring, ring_idx
