"""Build and bind the port's CUDA kernels (``ops/csrc/*.cu``).

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``) into an
object, all sources at once in parallel, and the objects are linked into one
shared library with a plain C interface that ``ctypes`` loads. Nothing
includes PyTorch's headers, so a cold build takes seconds, not minutes.

The library lands in ``ops/csrc/build/`` (listed in ``.gitignore``) under a
name that carries a hash of every source and of the flags: editing a source
rebuilds it at the next first use, and an unchanged tree reuses the file.
A build writes to a temporary name and renames it into place, so processes
that start together never load a half-written library.

Nothing here runs at import time: the first call of :func:`library` builds
(or finds) and loads it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
)

# dtype codes shared with csrc/common.cuh (enum DType)
DTYPE_CODES = {"float32": 0, "float16": 1, "bfloat16": 2, "float8_e4m3fn": 3}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_LONG = ctypes.c_longlong
_FLOAT = ctypes.c_float
_SIGNATURES = {
    "cake_decode_attention": (
        _VOID, _VOID, _VOID, _VOID, _VOID, _VOID,   # q k v out lengths starts
        _VOID, _VOID,                                # part tickets
        _INT, _INT, _INT, _INT,                      # b n_kv group heads
        _INT, _INT, _INT, _INT,                      # max_seq hd dtype kv_dtype
        _FLOAT, _FLOAT, _INT, _INT, _VOID,           # scale softcap n_split z stream
    ),
    "cake_chunk_prefill_attention": (
        _VOID, _VOID, _VOID, _VOID,                  # q k v out
        _VOID, _VOID, _VOID, _VOID,                  # q_starts lengths k_starts flag
        _INT, _INT, _INT, _INT, _INT, _INT, _INT,    # b chunk n_q n_kv kv_len hd dtype
        _INT,                                        # kv_dtype
        ctypes.POINTER(ctypes.c_longlong),           # strides[12]
        _INT, _FLOAT, _FLOAT, _VOID,                 # window scale softcap stream
    ),
    "cake_ring_decode_attention": (
        _VOID, _VOID, _VOID, _VOID, _VOID, _VOID,   # q k v out lengths starts
        _VOID, _VOID,                                # part tickets
        _INT, _INT, _INT, _INT,                      # b n_kv group heads
        _INT, _INT, _INT, _INT, _INT,                # ring max_seq hd dtype kv_dtype
        _FLOAT, _FLOAT, _INT, _INT, _VOID,           # scale softcap n_split z stream
    ),
    "cake_ring_chunk_attention": (
        _VOID, _VOID, _VOID, _VOID,                  # q k v out
        _VOID, _VOID, _VOID, _VOID,                  # q_starts lengths k_starts flag
        _INT, _INT, _INT, _INT, _INT, _INT, _INT,    # b chunk n_q n_kv ring max_seq hd
        _INT, _INT,                                  # dtype kv_dtype
        _LONG, _LONG, _LONG, _LONG, _LONG, _LONG,    # qsb qss qsh osb oss osh
        _INT, _FLOAT, _FLOAT, _VOID,                 # window scale softcap stream
    ),
    "cake_paged_decode_attention": (
        _VOID, _VOID, _VOID, _VOID,                  # q k v out
        _VOID, _VOID, _VOID,                         # lengths starts tables
        _VOID, _VOID,                                # part tickets
        _INT, _INT, _INT, _INT, _INT, _INT,          # b n_kv group heads page_size n_p
        _LONG, _INT, _INT, _INT,                     # table_stride hd dtype kv_dtype
        _FLOAT, _FLOAT, _INT, _INT, _VOID,           # scale softcap n_split z stream
    ),
    "cake_paged_chunk_attention": (
        _VOID, _VOID, _VOID, _VOID,                  # q k v out
        _VOID, _VOID, _VOID, _VOID, _VOID,           # q_starts lengths k_starts tables flag
        _INT, _INT, _INT, _INT, _INT, _INT,          # b chunk n_q n_kv page_size n_p
        _LONG, _INT, _INT, _INT,                     # table_stride hd dtype kv_dtype
        _LONG, _LONG, _LONG, _LONG, _LONG, _LONG,    # qsb qss qsh osb oss osh
        _INT, _FLOAT, _FLOAT, _VOID,                 # window scale softcap stream
    ),
    "cake_fused_norm_matmul": (
        _VOID, _VOID, _VOID, _VOID,                  # x norm_w w out
        _VOID, _VOID, _VOID,                         # h part tickets (each may be NULL)
        _INT, _INT, _INT, _INT,                      # rows hidden out dtype
        _FLOAT, _INT,                                # eps offset
        _INT, _INT, _INT, _INT, _VOID,               # body tile per stages stream
    ),
    "cake_fused_qkv_ingest": (
        _VOID, _VOID, _VOID, _VOID,                  # qkv cos sin q_out
        _VOID, _VOID, _VOID, _VOID,                  # k_cache v_cache tables (NULL: dense) slot
        _INT, _INT, _INT, _INT,                      # b n_q n_kv hd
        _INT, _INT, _LONG,                           # seq_stride n_p table_stride
        _INT, _INT, _INT, _INT, _INT, _INT,          # blocks threads vr vv rope_shift v_shift
        _INT, _INT, _VOID,                           # dtype kv_dtype stream
    ),
    "cake_int4_matmul": (
        _VOID, _VOID, _VOID, _VOID, _VOID,           # x packed scale out scratch (NULL: one pass)
        _INT, _INT, _INT, _INT, _INT,                # rows K N group per
        _INT, _INT, _VOID,                           # tile dtype stream
    ),
    "cake_fused_sample_tail": (
        _VOID, _VOID, _VOID, _VOID,                  # logits ring noise (NULL: greedy) out
        _INT, _INT, _INT, _INT,                      # b vocab window penalize
        _FLOAT, _FLOAT, _FLOAT,                      # penalty 1/penalty 1/temperature
        _INT, _INT, _INT, _INT, _VOID,               # top_k cluster slice staged stream
    ),
    "cake_fused_sample_tail_clusters": (
        _INT, _INT, _INT,                            # cluster slice staged
        _INT, _INT, _INT,                            # penalize sampled top_k
    ),
    "cake_threefry_noise": (
        _VOID, _VOID, _VOID, _VOID,                  # keys next sub (NULL: no split) out
        _INT, _LONG, _INT, _INT, _VOID,              # rows n per_row kind stream
    ),
    "cake_moe_grouped": (
        _VOID, _VOID, _VOID, _VOID,                  # x w offsets out
        _INT, _INT, _INT, _INT,                      # M K N E
        _INT, _INT, _INT, _INT, _INT, _VOID,         # dtype quant body tile stages stream
    ),
    "cake_empty_kernel": (_VOID,),                   # stream
}


def dtype_code(dtype) -> int:
    """A torch dtype's code in csrc/common.cuh's enum DType."""
    return DTYPE_CODES[str(dtype).removeprefix("torch.")]


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _fingerprint() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """``nvcc`` from CUDA_HOME, the standard install path, or PATH."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def build(force: bool = False) -> Path:
    """Compile the sources into the hashed shared library; return its path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"libcake_torch_kernels_{_fingerprint()}.so"
    if target.exists() and not force:
        return target
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(
                (src, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                ))
            )
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_lib, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), argtypes declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
