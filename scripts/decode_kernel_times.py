#!/usr/bin/env python3
"""Time the decode kernels of the tree this script sits in, on one card.

    python3 scripts/decode_kernel_times.py          # from the repo root

Runs chip_smoke.py's decode cases (the dense "lengths", "starts", "window",
"softcap" and "main_path" cases, the paged "lengths" and "starts" cases),
each held to its plain version as chip_smoke.py holds it, and the paged
kernel at the engine's shape (8 lanes, 16 pages of 128, rows of 470-536
keys, cold). For the main-path shapes it also reads each kernel's own
duration from a profiler trace of 64 calls (a second view of device time,
beside chip_smoke.py's event timing). To compare two trees in one call,
copy this script and chip_smoke.py into the other tree's checkout and run
it there too. The card's name and power limit first, a summary line last.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

ENGINE_STARTS = [0, 3, 17, 40, 66, 12, 25, 5]


def kernel_us(torch, fn, calls: int = 64) -> dict:
    """Mean duration (us) and count of each device kernel over ``calls``
    calls of ``fn``, from a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    durs: dict[str, list[float]] = {}
    for e in events:
        if e.get("cat") == "kernel":
            durs.setdefault(e["name"].split("(")[0], []).append(e.get("dur", 0.0))
    return {k: {"calls": len(v), "mean_us": sum(v) / len(v)} for k, v in durs.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_kernel_times: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from cake_tpu_torch.ops.decode_attention import decode_attention
    from cake_tpu_torch.ops.paged_attention import paged_decode_attention

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    rows = smoke.decode_cases(torch, dev) + smoke.paged_decode_cases(torch, dev)
    g = torch.Generator(device=dev).manual_seed(7)
    n_p = smoke.ENGINE_MAX_SEQ // smoke.ENGINE_PAGE
    rows.append(smoke._paged_decode_case(torch, dev, g, 30, "engine_shape", [536] * 8,
                                         ENGINE_STARTS, n_p, cold=True))
    # Kernel durations at the main-path shapes, rotating cold copies.
    bf = torch.bfloat16
    n_copy = 64
    q = torch.randn(1, 1, smoke.N_Q, smoke.HD, generator=g, device=dev, dtype=bf)
    k = torch.randn(n_copy, smoke.N_KV, smoke.MAX_SEQ, smoke.HD, generator=g, device=dev, dtype=bf)
    v = torch.randn_like(k)
    lengths = torch.tensor([733], dtype=torch.int32, device=dev)
    dense = smoke.rotating([lambda c=c: decode_attention(q, k[c : c + 1], v[c : c + 1], lengths)
                            for c in range(n_copy)])
    traces = {"decode_attention/main_path": kernel_us(torch, dense)}
    del k, v
    torch.cuda.empty_cache()
    pk, pv, tables = smoke._paged_pool(torch, dev, g, 31, 8 * 12, n_p)
    q8 = torch.randn(8, 1, smoke.N_Q, smoke.HD, generator=g, device=dev, dtype=bf)
    lens8 = torch.tensor([536] * 8, dtype=torch.int32, device=dev)
    st8 = torch.tensor(ENGINE_STARTS, dtype=torch.int32, device=dev)
    paged = smoke.rotating([
        lambda c=c: paged_decode_attention(q8, pk, pv, lens8, tables[8 * c : 8 * c + 8], st8)
        for c in range(12)])
    traces["paged_decode_attention/engine_shape"] = kernel_us(torch, paged)
    summary = {f"{r['kernel']}/{r['case']}": {k: r[k] for k in ("ms", "bound_ms", "library_ms",
                                                                "max_abs_err")}
               for r in rows}
    print(json.dumps({"phase": "decode_kernel_times", "card": smi, "cases": summary,
                      "kernel_traces": traces}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
