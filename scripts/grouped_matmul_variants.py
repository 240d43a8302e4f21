#!/usr/bin/env python3
"""Time the grouped expert GEMM against source variants of its kernel, on one card.

    python3 scripts/grouped_matmul_variants.py      # from the repo root

Each variant is ops/csrc/moe_grouped.cu with some work knocked out
(VARIANTS), so its time says what that work costs. A knocked-out variant
computes wrong values: only the kept kernel is held to the plain version.

- no_loads: the 16-bit body's producer marks each stage full without a
  TMA load (the products run on whatever the ring holds);
- no_products: no wgmma in either body (the loads, the widening of the
  int8 body's A operand, the barriers and the stores remain);
- no_stores: the 16-bit body's epilogue stores nothing;
- no_multicast: each block of a 16-bit item loads the whole W strip
  itself and releases its stages to its own producer only.

Every variant builds as a library of its own (nvcc, the one source, all at
once) under _checkout/grouped_variants/ (listed in .gitignore) and is
loaded beside the others in this process (the source's host helpers have
internal linkage, so each library keeps its own shared-memory opt-in).
Cases: Mixtral-8x7B's gate (4096 -> 14336) and down (14336 -> 4096) at
phase moe's engine prefill (7424 rows over 8 experts), bf16 and int8
stacks; Qwen3-30B-A3B's gate (2048 -> 768) over 128 experts; the kept
16-bit kernel also at ring depths 2 and 3. Order: the kept kernel, the
variants, the variants again in reverse, the kept kernel again; each timed
by chip_smoke.cuda_ms, beside torch._grouped_mm (bf16). The card's name and
power limit first, then one JSON line a case.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SOURCE = REPO / "cake_tpu_torch/ops/csrc/moe_grouped.cu"
OUT = REPO / "_checkout" / "grouped_variants"
MIXTRAL = [3162, 48, 759, 0, 8, 80, 2273, 1094]

# name -> [(text of the kept source, its replacement, occurrences)]
VARIANTS = {
    "no_loads": [(
        """        mbar_expect_tx(&full[s], X_BOX + boxes * W_BOX);
        tma_load_2d(st, &xmap, ks * BK, job.r0, &full[s]);
        for (int c = rank; c < boxes; c += CLUSTER)""",
        """        mbar_arrive(&full[s]);
        for (int c = rank; c < 0; c += CLUSTER)""", 1)],
    "no_products": [
        ("      for (int kk = 0; kk < BK / 16; ++kk)\n        wgmma_ss",
         "      for (int kk = 0; kk < (K < 0 ? BK / 16 : 0); ++kk)\n        wgmma_ss", 1),
        ("    for (int kk = 0; kk < BK / 16; ++kk)\n      wgmma_rs",
         "    for (int kk = 0; kk < (K < 0 ? BK / 16 : 0); ++kk)\n      wgmma_rs", 1)],
    "no_stores": [("      if (c >= N) continue;", "      if (c >= N || job.rend >= 0) continue;", 1)],
    "no_multicast": [
        ("      mbar_init(&empty[s], CLUSTER * CONSUMER_WARPS);",
         "      mbar_init(&empty[s], CONSUMER_WARPS);", 1),
        ("""        for (int c = rank; c < boxes; c += CLUSTER)
          tma_load_3d_multicast(st + X_BOX + c * W_BOX, &wmap, job.n0 + 64 * c, ks * BK, job.e,
                                &full[s], (1 << CLUSTER) - 1);""",
         """        for (int c = 0; c < boxes; ++c)
          tma_load_3d_multicast(st + X_BOX + c * W_BOX, &wmap, job.n0 + 64 * c, ks * BK, job.e,
                                &full[s], 1 << rank);""", 1),
        ("      for (int c = 0; c < CLUSTER; ++c) mbar_arrive_cluster(&empty[j % stages], c);",
         "      mbar_arrive(&empty[j % stages]);", 1)],
}


def build_all() -> dict:
    """Every variant (and the kept source) as a shared library, built at once."""
    from cake_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    kept = SOURCE.read_text()
    procs = {}
    for name in ["kept", *VARIANTS]:
        text = kept
        for old, new, count in VARIANTS.get(name, []):
            if text.count(old) != count:
                raise SystemExit(f"grouped_matmul_variants: {name}: the kept source no longer "
                                 f"holds {old[:60]!r}")
            text = text.replace(old, new)
        src = OUT / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", str(src),
             "-I", str(SOURCE.parent), "-o", str(OUT / f"lib{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"grouped_matmul_variants: {name} failed to build:\n{out}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        lib.cake_moe_grouped.argtypes = list(_build._SIGNATURES["cake_moe_grouped"])
        lib.cake_moe_grouped.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    import chip_smoke
    from cake_tpu_torch.ops import moe
    from cake_tpu_torch.ops.quant import quantize_weight

    if not torch.cuda.is_available():
        print("grouped_matmul_variants: no CUDA device is available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    cases = [("mixtral_w_gate", 4096, 14336, MIXTRAL), ("mixtral_w_down", 14336, 4096, MIXTRAL),
             ("qwen3_30b_a3b_w_gate", 2048, 768, chip_smoke.qwen3_moe_sizes(torch))]
    order = ["kept", *VARIANTS, *reversed(VARIANTS), "kept"]
    for case, k, n, sizes in cases:
        e, m = len(sizes), sum(sizes)
        xs = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        w = torch.randn(e, k, n, generator=g, device=dev).mul_(k ** -0.5)
        offsets = torch.zeros(e + 1, dtype=torch.int32, device=dev)
        offsets[1:] = torch.cumsum(torch.tensor(sizes, device=dev), 0)
        for quant in (False, True):
            mats = quantize_weight(w).w if quant else w.to(torch.bfloat16)
            ref = moe.grouped_matmul_plain(xs, mats, sizes)
            p = moe.plan(k, n, xs.dtype, quant, e)
            library_ms = None if quant else chip_smoke.cuda_ms(
                torch, lambda: torch._grouped_mm(xs, mats, offs=offsets[1:]), 10)
            runs = [(name, p.stages) for name in order]
            if not quant:
                runs += [("kept", s) for s in (2, 3) if s < p.stages]
            for name, stages in runs:
                out = torch.empty_like(ref)

                def call(lib=libs[name], stages=stages, out=out):
                    err = lib.cake_moe_grouped(
                        xs.data_ptr(), mats.data_ptr(), offsets.data_ptr(), out.data_ptr(), m, k,
                        n, e, 2, int(quant), moe.BODIES[p.body], p.tile, stages,
                        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err} at launch")

                call()
                torch.cuda.synchronize()
                row = {"case": case + ("_int8" if quant else ""), "variant": name,
                       "body": p.body, "tile": p.tile, "stages": stages,
                       "ms": chip_smoke.cuda_ms(torch, call, 10), "library_ms": library_ms}
                if name == "kept":
                    row["max_abs_err"] = (out.float() - ref.float()).abs().max().item()
                    row["tol"] = chip_smoke.bf16_ulp(ref)
                    if not row["max_abs_err"] <= row["tol"]:
                        raise AssertionError(f"kept kernel off its plain version: {row}")
                print(json.dumps(row), flush=True)
            del mats, ref
        del xs, w
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
