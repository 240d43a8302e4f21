#!/usr/bin/env python3
"""Time fused_qkv_ingest and fused_sample_tail of the tree this script sits in, on one card.

    python3 scripts/fused_small_times.py              # from the repo root
    python3 scripts/fused_small_times.py --variants   # and the kernels' variants
    python3 scripts/fused_small_times.py --engine     # and the engine's step under fusion "all"

Runs chip_smoke.py's ingest and tail cases as its kernels phase runs them
(each held to its plain version to the bit, timed by chip_smoke.cuda_ms)
and the launch floor (an empty kernel from the port's library, where the
tree has one). With --variants (a tree whose tail wrapper has
candidates()), the tail's cases at each planned cluster size through the
private _run, and a sampled top-k case at Gemma's 262144 ids, where only
16 blocks stage their slice. With --engine, Llama-3-8B's random bf16
weights (drawn as chip_smoke.py's generate phase draws them) served by the
paged engine with fusion "all", profiled as its engine_fused phase
profiles a greedy wave: device ms a decode step by kernel family. To
compare two trees in one call, copy this script into the other tree's
scripts/ and run it there too. The card's name and power limit first,
then one JSON line a case.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


@contextlib.contextmanager
def quiet(smoke):
    """chip_smoke's rows go to this script's own lines, not its emit()."""
    emit = smoke.emit
    smoke.emit = lambda obj: None
    try:
        yield
    finally:
        smoke.emit = emit


def case_line(row: dict, variant: str) -> str:
    keys = ("kernel", "case", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "route",
            "equal")
    return json.dumps({"variant": variant, **{k: row[k] for k in keys if k in row}})


def tail_variants(torch, smoke, tail) -> None:
    """chip_smoke's tail cases at each planned cluster size, operands drawn
    as _tail_case draws them, and sampled_b8 at 262144 ids; ids held to
    the plain version."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    greedy = dict(temperature=0.0, top_k=None, repeat_penalty=1.0)
    sampled = dict(temperature=0.7, top_k=40, repeat_penalty=1.1)
    for case, b, knobs, vocab in (("greedy_b1", 1, greedy, smoke.VOCAB),
                                  ("greedy_b8", 8, greedy, smoke.VOCAB),
                                  ("sampled_b1", 1, sampled, smoke.VOCAB),
                                  ("sampled_b8", 8, sampled, smoke.VOCAB),
                                  ("sampled_b8_v262144", 8, sampled, 262144)):
        logits = (2.0 * torch.randn(b, vocab, generator=g, device=dev)).to(torch.bfloat16)
        logits = logits.float()
        ring = torch.randint(-1, vocab, (b, 128), generator=g, device=dev)
        noise = None
        if knobs["temperature"] > 0:
            u = torch.rand(b, vocab, generator=g, device=dev)
            noise = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
        want = tail.fused_sample_tail_plain(logits, ring, noise, top_p=None, **knobs)
        k = knobs["top_k"] or 0
        for p in tail.candidates(b, vocab, noise is not None, knobs["top_k"]):
            def run(p=p):
                return tail._run(logits, ring, noise, p, temperature=knobs["temperature"],
                                 top_k=k, repeat_penalty=knobs["repeat_penalty"])
            ids = run()
            torch.cuda.synchronize()
            print(json.dumps({"variant": f"cluster{p.cluster}", "kernel": "fused_sample_tail",
                              "case": case, "plan": {"cluster": p.cluster, "slice": p.slice,
                                                     "staged": p.staged, "smem": p.smem},
                              "ms": smoke.cuda_ms(torch, run, 50),
                              "equal": bool(torch.equal(ids, want))}), flush=True)
            if not torch.equal(ids, want):
                raise AssertionError(f"fused_sample_tail {case} cluster {p.cluster}: ids differ")


def engine_profile(torch, smoke) -> None:
    """The paged engine with fusion "all" over Llama-3-8B's random weights:
    one greedy wave under the launch gate, then two profiled waves (16 and
    32 tokens) differenced into device ms a decode step by family."""
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
    from cake_tpu_torch.ops.fuse import fuse_params
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    dev = torch.device("cuda")
    config = LlamaConfig()  # Llama-3-8B widths and depth
    params = fuse_params(M.init_params(
        config, torch.Generator(device=dev).manual_seed(0), torch.bfloat16, dev))

    def make(**kw):
        serve = ServeConfig(max_batch=smoke.ENGINE_BATCH, decode_chunk_size=8, **kw)
        eng = BatchEngine(config, params, ByteTokenizer(), max_seq_len=smoke.ENGINE_MAX_SEQ,
                          cache_dtype=torch.bfloat16, serve=serve, device=dev)
        eng.start()
        return eng

    with quiet(smoke):
        r = smoke._fused_engine_run(torch, make, "all", "paged", config.num_hidden_layers,
                                    True, sampled=False)
    torch.cuda.empty_cache()
    if r["launches"] != r["expected_launches"]:
        raise AssertionError(f"launch counts {r['launches']} != {r['expected_launches']}")
    prof, wave = r["profile"], r["waves"][0]
    print(json.dumps({
        "variant": "tree", "engine": "paged", "fusion": "all",
        "decode_ms_per_step": wave["decode_ms_per_step"],
        "device_ms_per_step": prof["device_ms_per_step"],
        "device_ops_per_step": prof["device_ops_per_step"],
        "device_idle_share": prof["device_idle_share"],
        "by_family_ms_per_step": prof["by_family_ms_per_step"],
    }), flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--engine", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_small_times: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from cake_tpu_torch.ops import fused_sample_tail as tail

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    with quiet(smoke):
        rows = smoke.ingest_cases(torch, dev) + smoke.tail_cases(torch, dev)
        if hasattr(smoke, "launch_floor"):
            rows.append(smoke.launch_floor(torch))
    for row in rows:
        print(case_line(row, "tree"), flush=True)
    if args.variants and hasattr(tail, "candidates"):
        tail_variants(torch, smoke, tail)
    if args.engine:
        engine_profile(torch, smoke)
    return 0


if __name__ == "__main__":
    sys.exit(main())
