#!/usr/bin/env python3
"""Time fused_sample_tail against source variants of its kernel, on one card.

    python3 scripts/tail_variant_times.py      # from the repo root

Each variant is ops/csrc/fused_sample_tail.cu with one edit (VARIANTS):

- unbatched_shared_loads: the top-k passes after the first read one
  staged key from shared memory a histogram add, where the kept kernel
  reads ST_BATCH keys into registers before the first add.
- spread_scheduling: the cluster launch also asks for
  cudaClusterSchedulingPolicySpread.

The script copies the port (cake_tpu_torch/ and chip_smoke.py) into
_checkout/tail_variants/<name>/ (listed in .gitignore), applies the edit
there, builds every tree at once, then times chip_smoke.py's tail cases in
each tree in a process of its own: the kept kernel, the variants, the
variants again in reverse, the kept kernel again. Each case is held to the
plain version to the bit and timed by chip_smoke.cuda_ms. The card's name
and power limit first, then one JSON line a case.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SOURCE = "cake_tpu_torch/ops/csrc/fused_sample_tail.cu"

# name -> [(text of the kept source, its replacement, occurrences)]
VARIANTS = {
    "unbatched_shared_loads": [(
        """          // ST_BATCH keys read before the first add (measured faster
          // than one key an add: PERF.md).
          for (int i0 = tid; i0 < n; i0 += ST_THREADS * ST_BATCH) {
            uint32_t kb[ST_BATCH];
#pragma unroll
            for (int u = 0; u < ST_BATCH; ++u) {
              const int i = i0 + u * ST_THREADS;
              kb[u] = i < n ? keys[i] : 0u;
            }
#pragma unroll
            for (int u = 0; u < ST_BATCH; ++u)
              if (i0 + u * ST_THREADS < n && (kb[u] & mask) == prefix)
                atomicAdd(&my[(kb[u] >> shift) & 255u], 1u);
          }""",
        """          for (int i = tid; i < n; i += ST_THREADS) {
            const uint32_t k = keys[i];
            if ((k & mask) == prefix) atomicAdd(&my[(k >> shift) & 255u], 1u);
          }""",
        1,
    )],
    "spread_scheduling": [
        ("cudaLaunchAttribute attr[1];", "cudaLaunchAttribute attr[2];", 2),
        ("  cfg.numAttrs = 1;",
         """  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference = cudaClusterSchedulingPolicySpread;
  cfg.numAttrs = 2;""",
         1),
    ],
}


def make_tree(name: str) -> Path:
    """The port with variant `name`'s edit, under _checkout/tail_variants/."""
    dst = REPO / "_checkout" / "tail_variants" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(REPO / "cake_tpu_torch", dst / "cake_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy2(REPO / "chip_smoke.py", dst / "chip_smoke.py")
    src = dst / SOURCE
    text = src.read_text()
    for old, new, count in VARIANTS[name]:
        if text.count(old) != count:
            raise SystemExit(f"tail_variant_times: {name}: the kept source no longer holds "
                             f"{old.splitlines()[0].strip()!r} {count} time(s)")
        text = text.replace(old, new)
    src.write_text(text)
    return dst


def child(tree: Path, name: str) -> int:
    """chip_smoke's tail cases in `tree`, one JSON line each."""
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as smoke

    emit = smoke.emit
    smoke.emit = lambda obj: None
    try:
        rows = smoke.tail_cases(torch, torch.device("cuda"))
    finally:
        smoke.emit = emit
    for row in rows:
        print(json.dumps({"variant": name, "case": row["case"], "ms": row["ms"],
                          "equal": row["equal"]}), flush=True)
    return 0 if all(row["equal"] for row in rows) else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", nargs=2, metavar=("TREE", "NAME"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(Path(args.child[0]), args.child[1])
    import torch

    if not torch.cuda.is_available():
        print("tail_variant_times: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    trees = {"kept": REPO, **{name: make_tree(name) for name in VARIANTS}}
    build = "from cake_tpu_torch.ops import _build; _build.build()"
    builds = [subprocess.Popen([sys.executable, "-c", build], cwd=tree) for tree in trees.values()]
    if any([p.wait() for p in builds]):
        print("tail_variant_times: a build failed", file=sys.stderr)
        return 1
    names = list(VARIANTS)
    rc = 0
    for name in ["kept", *names, *reversed(names), "kept"]:
        rc |= subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                              str(trees[name]), name], cwd=trees[name]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
