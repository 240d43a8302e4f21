#!/usr/bin/env python3
"""Time the decode kernels at split sizes 32, 64 and 128 on one card.

    python3 scripts/decode_split_sweep.py            # from the repo root

The split size is a compile-time constant of the decode body
(``DEC_SPLIT`` in ``cake_tpu_torch/ops/csrc/decode_attention.cuh``, with
``SPLIT`` in ``ops/decode_attention.py``), as is its block's warp count
(``DEC_WARPS``); the blocks the grid offers an SM is ``BLOCKS_PER_SM`` in
the wrapper. For each (split, warps, blocks an SM) variant this script
copies the two decode sources and their headers into a temporary directory,
sets the constants there, builds them with nvcc into a library of their own
(all variants at once), and runs chip_smoke.py's decode cases through it: the generator's 733-key row
(cold), the dense "lengths" case (1 to 8192 keys, b = 4) and a paged case
at the engine's shape (8 lanes, 16 pages of 128, rows of 470-536 keys,
cold). Each case is held to its plain version as chip_smoke.py holds it.
The variants run in the order of ORDER; the first one runs again last, so
its repeat shows the spread. One JSON line per case, then a summary line; the card's name and
power limit first.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# (split, warps a block, blocks an SM)
ORDER = ((64, 8, 8), (32, 8, 8), (128, 8, 8), (128, 16, 8), (128, 8, 32), (64, 8, 8))
ENGINE_STARTS = [0, 3, 17, 40, 66, 12, 25, 5]


def build_variant(split: int, warps: int, out_dir: Path) -> Path:
    """The library of the two decode entry points with DEC_SPLIT = ``split``
    and DEC_WARPS = ``warps``."""
    from cake_tpu_torch.ops import _build

    src = out_dir / f"csrc_{split}_{warps}"
    src.mkdir()
    # Every unit of the decode body: the entry points, the wide head dims
    # and the f8 caches.
    units = sorted(p.name for p in _build.CSRC.glob("*decode_attention*.cu"))
    for name in ("common.cuh", "kv_layout.cuh", *units):
        (src / name).write_text((_build.CSRC / name).read_text())
    header = (_build.CSRC / "decode_attention.cuh").read_text()
    for name, value in (("DEC_SPLIT", split), ("DEC_WARPS", warps)):
        header, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                            header)
        if n != 1:
            raise RuntimeError(f"{name} not found in decode_attention.cuh")
    (src / "decode_attention.cuh").write_text(header)
    lib_path = out_dir / f"libdecode_{split}_{warps}.so"
    subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
         *(str(src / name) for name in units)],
        check=True,
    )
    return lib_path


def load(lib_path: Path) -> ctypes.CDLL:
    from cake_tpu_torch.ops import _build

    lib = ctypes.CDLL(str(lib_path))
    for name in ("cake_decode_attention", "cake_paged_decode_attention"):
        fn = getattr(lib, name)
        fn.argtypes = list(_build._SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_split_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from cake_tpu_torch.ops import _build
    from cake_tpu_torch.ops import decode_attention as D

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    n_p = smoke.ENGINE_MAX_SEQ // smoke.ENGINE_PAGE
    summary: dict[str, list] = {}
    with tempfile.TemporaryDirectory() as tmp:
        builds = sorted({(split, warps) for split, warps, _ in ORDER})
        with ThreadPoolExecutor(len(builds)) as pool:
            paths = list(pool.map(lambda v: build_variant(*v, Path(tmp)), builds))
        libs = {v: load(p) for v, p in zip(builds, paths)}
        for split, warps, per_sm in ORDER:
            _build._lib, D.SPLIT, D.BLOCKS_PER_SM = libs[split, warps], split, per_sm
            g = torch.Generator(device=dev).manual_seed(1)
            rows = [
                smoke._decode_case(torch, dev, g, "main_path", [733], None, {}, cold=True),
                smoke._decode_case(torch, dev, g, "lengths", [1, 300, 4097, 8192], None, {}),
                smoke._paged_decode_case(torch, dev, g, 30, "engine_shape", [536] * 8,
                                         ENGINE_STARTS, n_p, cold=True),
            ]
            for r in rows:
                summary.setdefault(f"{r['kernel']}/{r['case']}", []).append(
                    {"split": split, "warps": warps, "blocks_per_sm": per_sm, "ms": r["ms"],
                     "bound_ms": r["bound_ms"]})
            torch.cuda.empty_cache()
    print(json.dumps({"phase": "decode_split_sweep", "card": smi, "cases": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
