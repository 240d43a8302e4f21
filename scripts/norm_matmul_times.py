#!/usr/bin/env python3
"""Time fused_norm_matmul of the tree this script sits in, on one card.

    python3 scripts/norm_matmul_times.py              # from the repo root
    python3 scripts/norm_matmul_times.py --variants   # and the bodies' variants

Times the public call at Llama-3-8B's three norm sites (wqkv 6144, w_gu
28672, lm_head 128256 columns; hidden 4096; bf16) at 1 to 256 rows, its
weight read cold (operand copies rotated as in chip_smoke.py), beside the
unfused composition (rms_norm, then cuBLAS) on the same copies; each output
is held to the plain version as chip_smoke.py holds it. With --variants
(a tree whose wrapper has plan()), the same operands also go through other
geometries by the private _run: the GEMV against swap AB at decode rows,
other splits of K and ring depths, and the warp-specialized body's column
tiles, so plan()'s choices rest on times taken in one call. To compare two trees in one call, copy this script and
chip_smoke.py into the other tree's checkout and run it there too. The
card's name and power limit first, one JSON line a case.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SITES = (("wqkv", 6144), ("w_gu", 28672), ("lm_head", 128256))
ROWS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def variants(p, rows: int, hidden: int, out_dim: int) -> dict:
    """Geometries beside plan()'s for one call: name -> Plan."""
    import torch

    from cake_tpu_torch.ops import fused_norm_matmul as nm

    out = {}
    if p.body == "swap_ab":
        if rows <= 8:  # the CUDA-core GEMV the f32 calls take
            out["gemv"] = dataclasses.replace(p, body="gemv", tile=0, stages=0)
        steps = -(-hidden // nm.BLOCK_K)
        for splits in (1, 2, 3, 5, 8):  # other splits of K, as the plan stages the rows
            per = -(-steps // splits)
            if per != p.per:
                out[f"splits{splits}"] = dataclasses.replace(p, per=per, splits=-(-steps // per))
        for st in (3, 4, 6):
            if st != p.stages:
                q = dataclasses.replace(p, stages=st)
                if nm.smem_bytes(q, rows, hidden, torch.bfloat16) <= nm.SMEM_CAP:
                    out[f"stages{st}"] = q
    if p.body == "warp_specialized":
        for tile in (128, 256):
            if tile != p.tile:
                out[f"tile{tile}"] = dataclasses.replace(p, tile=tile, stages=4 if tile == 256 else 7)
        out["stages3"] = dataclasses.replace(p, stages=3)
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--trace", action="store_true", help="each case's kernels' own times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("norm_matmul_times: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from cake_tpu_torch.ops import fused_norm_matmul as nm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    bf = torch.bfloat16
    hidden = smoke.HIDDEN
    has_plan = hasattr(nm, "plan")
    for site, out_dim in SITES:
        torch.cuda.empty_cache()
        n_copy = smoke.copies_for(hidden * out_dim * 2)
        ws = [torch.randn(hidden, out_dim, generator=g, device=dev, dtype=bf) * hidden**-0.5
              for _ in range(n_copy)]
        nw = (0.1 * torch.randn(hidden, generator=g, device=dev) + 1.0).to(bf)
        for rows in ROWS:
            x = (3.0 * torch.randn(rows, 1, hidden, generator=g, device=dev)).to(bf)
            ref = nm.fused_norm_matmul_plain(x, nw, ws[0], eps=1e-5)
            tol = max(smoke.TOL, smoke.bf16_ulp(ref))
            nbytes = 2 * (rows * hidden + hidden + hidden * out_dim + rows * out_dim)
            b_ms, b_by = smoke.bound(nbytes, 2.0 * rows * hidden * out_dim)
            libs = [lambda w=w: nm._unfused(x, nw, w, 1e-5, False) for w in ws]
            row = {"site": site, "rows": rows, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": smoke.cuda_ms(torch, smoke.rotating(libs), 10 * len(ws)),
                   "operand_copies": len(ws)}
            cases = {"plan": None}
            if has_plan:
                p = nm.plan(rows, hidden, out_dim, bf)
                row["plan"] = dataclasses.asdict(p)
                if args.variants:
                    cases.update(variants(p, rows, hidden, out_dim))
            ms, err = {}, {}
            x2 = x.reshape(rows, hidden)
            for name, q in cases.items():
                if q is None:
                    runs = [lambda w=w: nm.fused_norm_matmul(x, nw, w, eps=1e-5) for w in ws]
                else:
                    runs = [lambda w=w, q=q: nm._run(x2, nw, w, q, eps=1e-5) for w in ws]
                out = runs[0]().reshape(ref.shape)
                torch.cuda.synchronize()
                err[name] = (out.float() - ref.float()).abs().max().item()
                ms[name] = smoke.cuda_ms(torch, smoke.rotating(runs), 20 * len(ws))
                if args.trace and name == "plan":
                    from decode_kernel_times import kernel_us  # this script's directory

                    row["kernel_us"] = kernel_us(torch, smoke.rotating(runs), 4 * len(ws))
            row.update(ms_by_variant=ms, max_abs_err=err, tol=tol)
            print(json.dumps(row), flush=True)
            if any(not e <= tol for e in err.values()):
                raise AssertionError(f"fused_norm_matmul {site} rows {rows}: {err} > {tol}")
        del ws
    return 0


if __name__ == "__main__":
    sys.exit(main())
