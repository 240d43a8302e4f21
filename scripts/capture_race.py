#!/usr/bin/env python3
"""Two batch engines capture their decode graphs at the same time, on one card.

    python3 scripts/capture_race.py [--layers 8] [--rounds 16]   # from the repo root

Two paged engines over one set of random weights at Llama-3-8B's widths
(depth cut to ``--layers``), each capturing in a ``CaptureScope`` of its
own, submit a wave of 8 sampled requests at the same moment, round after
round. Each round both engines' chunks move to fresh scopes, so each
engine's first decode of the round captures a new graph into a new pool
(allocating as it captures, as the first capture after an abandoned
dispatch does) on its dispatch thread while the other engine captures its
own. Each mode runs in a process of its own:

- locked: ``DecodeChunk.run`` as the port has it, holding
  ``fused.CARD_RUN_LOCK`` (one chunk run at a time in the process);
- unlocked: the lock replaced by a no-op, so the two captures overlap.

Per round: each engine's stream errors and finish reasons, any exception,
whether the two engines' streams are equal (same weights, prompts and
seeds), and the seconds the two engines' captures overlapped. The card's
name and power limit first, then one JSON line a round, then one summary
line a mode; the lines also go to _checkout/capture_race.jsonl (git-ignored).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
OUT = REPO / "_checkout" / "capture_race.jsonl"


def emit(row: dict) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    with OUT.open("a") as f:
        f.write(line + "\n")


def run_mode(mode: str, layers: int, rounds: int, tokens: int, dev: str = "cuda",
             config=None) -> None:
    """One mode's rounds (``dev``/``config`` rehearse the control flow on
    the CPU at a small config, where nothing is captured)."""
    import torch

    import chip_smoke as smoke
    from cake_tpu_torch.models.llama import fused
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import SamplingConfig
    from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
    from cake_tpu_torch.runtime import batch_backend
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    if mode == "unlocked":
        fused.CARD_RUN_LOCK = contextlib.nullcontext()
    captures: list[tuple[int, float, float]] = []  # (engine, start, end)
    real_capture = fused.DecodeChunk._capture
    owner: dict[int, int] = {}

    def capture(chunk):
        t0 = time.perf_counter()
        try:
            return real_capture(chunk)
        finally:
            captures.append((owner.get(id(chunk.scope), -1), t0, time.perf_counter()))

    fused.DecodeChunk._capture = capture
    dev = torch.device(dev)
    config = config or dataclasses.replace(LlamaConfig(), num_hidden_layers=layers)
    params = M.init_params(config, torch.Generator(device=dev).manual_seed(0), torch.bfloat16,
                           dev)
    serve = ServeConfig(max_batch=smoke.ENGINE_BATCH, decode_chunk_size=8, kv_mode="paged",
                        page_size=smoke.ENGINE_PAGE, prefix_cache=False)
    engines = []

    def fresh_scopes():
        for i, eng in enumerate(engines):
            scope = fused.CaptureScope()
            eng.backend._chunks = batch_backend._Chunks(scope)
            owner[id(scope)] = i

    for _ in range(2):
        engines.append(BatchEngine(config, params, ByteTokenizer(),
                                   max_seq_len=smoke.ENGINE_MAX_SEQ, cache_dtype=torch.bfloat16,
                                   serve=serve, device=dev))
    fresh_scopes()
    messages = smoke.engine_messages()
    for eng in engines:  # the kernels' first loads, one engine at a time
        smoke._wave(eng, tokens, messages, together=True)
    summary = {"mode": mode, "rounds": rounds, "failed_rounds": 0, "overlapped_rounds": 0}
    try:
        for r in range(rounds):
            knobs = dict(temperature=0.5 + 0.01 * r, top_k=40, repeat_penalty=1.1)
            samplings = [SamplingConfig(seed=100 + i, **knobs) for i in range(len(messages))]
            barrier = threading.Barrier(2)
            out: list = [None, None]
            captures.clear()
            fresh_scopes()

            def wave(i, barrier=barrier, samplings=samplings, out=out):
                barrier.wait()
                try:
                    out[i] = smoke._wave(engines[i], tokens, messages, samplings=samplings,
                                         together=True)
                except BaseException as e:  # noqa: BLE001 - recorded in the row
                    out[i] = e

            threads = [threading.Thread(target=wave, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            spans = {i: [(a, b) for e, a, b in captures if e == i] for i in range(2)}
            overlap = sum(max(0.0, min(b0, b1) - max(a0, a1))
                          for a0, b0 in spans[0] for a1, b1 in spans[1])
            row = {"mode": mode, "round": r, "captures": [len(spans[0]), len(spans[1])],
                   "capture_overlap_s": overlap}
            for i, w in enumerate(out):
                if isinstance(w, dict):
                    row[f"engine{i}"] = {"stream_errors": w["stream_errors"],
                                         "finish_reasons": sorted(set(w["finish_reasons"]))}
                else:
                    row[f"engine{i}"] = {"exception": repr(w)[:400]}
            ok = all(isinstance(w, dict) and w["stream_errors"] == 0
                     and set(w["finish_reasons"]) == {"length"} for w in out)
            row["ok"] = ok
            row["equal_streams"] = ok and out[0]["streams"] == out[1]["streams"]
            summary["failed_rounds"] += not ok
            summary["overlapped_rounds"] += overlap > 0
            emit(row)
    finally:
        for eng in engines:
            eng.stop()
    emit(summary)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16, help="tokens out a request")
    ap.add_argument("--mode", choices=("locked", "unlocked"),
                    help="run one mode in this process (default: each in its own)")
    args = ap.parse_args()
    OUT.parent.mkdir(exist_ok=True)
    if args.mode:
        run_mode(args.mode, args.layers, args.rounds, args.tokens)
        return 0
    OUT.unlink(missing_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    rc = 0
    for mode in ("unlocked", "locked"):
        p = subprocess.run([sys.executable, __file__, "--mode", mode, "--layers",
                            str(args.layers), "--rounds", str(args.rounds), "--tokens",
                            str(args.tokens)], timeout=1200)
        if p.returncode:
            print(f"capture_race: mode {mode} exited {p.returncode}", file=sys.stderr)
            rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
