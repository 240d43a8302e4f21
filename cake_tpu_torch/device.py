"""Device choice for the port's entry points."""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU. Raises when CUDA is asked for (the default) and there is none; the
    port never carries on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def upload(array, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A host array as a new tensor on ``device`` (never a view of the array,
    which its owner may mutate later). To a CUDA device the copy goes
    through pinned memory without blocking the host on the stream: a plain
    copy from pageable memory would wait for every kernel queued before it."""
    t = torch.as_tensor(np.ascontiguousarray(array))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def upload_into(buf: torch.Tensor, value) -> None:
    """Copy ``value`` into the existing tensor ``buf`` in place: a tensor by
    ``copy_``, a host array or number through pinned memory, without
    blocking the host on a CUDA stream (as :func:`upload`)."""
    if isinstance(value, torch.Tensor):
        buf.copy_(value)
        return
    t = torch.as_tensor(np.array(value, order="C")).to(buf.dtype)
    if buf.device.type == "cuda":
        buf.copy_(t.pin_memory(), non_blocking=True)
    else:
        buf.copy_(t)
