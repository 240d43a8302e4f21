"""Token sampling (port of ``cake_tpu/ops/sampling.py``): argmax,
temperature, top-k, top-p and the repeat penalty over the last
``repeat_last_n`` tokens.

A draw is the gumbel-argmax identity ``argmax(logits + g)`` with
``g = -log(-log(u))``. The uniform ``u`` comes from an explicit
``torch.Generator`` or, so that tests can feed the port and the JAX package
the same noise, from a caller-supplied gumbel tensor. The JAX package draws
its noise from threefry keys, so a seeded sampled stream differs between the
two packages; greedy streams are equal.
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


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard gumbel noise drawn from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


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
