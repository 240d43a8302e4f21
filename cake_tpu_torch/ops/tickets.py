"""The zeroed int32 ticket buffers of the kernels that split their work
(decode attention's key splits, ``fused_norm_matmul``'s split K).

A block that finishes a split takes a ticket of its output tile; the block
that draws the last one merges the partials and puts the ticket back to
zero. So every launch leaves its tickets at zero, and one buffer a device
serves every call, as long as the calls run on one stream at a time, as the
port's callers do.

A captured CUDA graph keeps the buffer's address. So a buffer, once handed
out, is never freed: where a call needs more tickets than the newest buffer
holds, a larger one (at least twice the size) takes its place for the calls
after it, and the older ones stay allocated, still zero, for the graphs
captured over them. A buffer made inside a capture would come from the
graph's pool and its zeroing would be a node of the graph, so a call that
would make one during a capture raises; a graph's warm-up run
(models/llama/fused.py) makes them first.
"""

from __future__ import annotations

import torch

_held: dict[tuple[str, torch.device], list[torch.Tensor]] = {}


def tickets(owner: str, device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 tickets of ``owner``'s kernels on
    ``device``: the newest buffer, or a larger one made now (eagerly)."""
    held = _held.setdefault((owner, device), [])
    if held and held[-1].numel() >= n:
        return held[-1]
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{owner}: its ticket buffer would be made during a CUDA graph capture; "
            "run the step once eagerly before capturing it")
    held.append(torch.zeros(max(n, 2 * held[-1].numel() if held else n),
                            dtype=torch.int32, device=device))
    return held[-1]
