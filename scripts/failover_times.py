#!/usr/bin/env python3
"""What a live-stream migration costs, by where the worker dies and how the KV is rebuilt.

    python3 scripts/failover_times.py [--tokens 640] [--after 70] [--no-tcp]   # from the repo root

At Llama-3-8B's widths and depth (random bf16 weights, seed 0), the smoke's
wave of 8 greedy requests goes through the batch engine (ENGINE_MAX_SEQ
2048, decode chunks of 8) fault-free, then again with a fault that kills
the backend at the decode chunk ``--after`` (the wave's prompts fill ~480
slots, so near slot ENGINE_MAX_SEQ / 2 at the defaults) and at the fourth
chunk, and the engine migrates the live
streams (runtime/serving.py ``_migrate_kv``) by each of its two rebuilds:

- replay: the epoch's dispatch log again, a decode chunk as one-token
  steps (the failover budget set to 600 s, so nothing cuts it short);
- reprefill: the reference's one windowed re-prefill (the budget set to
  1 ms, so the replay's price, known from the replay run, overruns it).

Sections, one JSON line each:

- ``kv_bits``: the dense local backend's K/V rows written by a prefill of
  128 positions and 64 one-token decode steps, against the rows one
  prefill of all 192 positions writes (what a re-prefill rounds otherwise):
  per layer, the share of equal elements and the largest difference.
- ``local``: the paged local engine (``failover_local``): each run's
  migration slot, seconds, rebuild, seconds a replayed position, streams
  equal to the fault-free wave's and each stream's first differing token;
  then the prefix-cache engine at the fourth chunk (always a re-prefill).
- ``tcp``: topology B (w1 layers 0-15, w2 16-31, w2b a replica of w2,
  in-process workers) with w2 unreachable for good from the same decode
  step (``kill@client.send``), the streams held to the local dense
  engine's fault-free wave.

The card's name and power limit come first; the lines also go to
_checkout/failover_times.jsonl (git-ignored).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
OUT = REPO / "_checkout" / "failover_times.jsonl"
BIG_BUDGET_S = 600.0
TINY_BUDGET_S = 1e-3


SINK: Path | None = None  # main() sets it to OUT


def emit(row: dict) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if SINK is not None:
        with SINK.open("a") as f:
            f.write(line + "\n")


def first_differences(got: list, want: list) -> list:
    """Each stream's first differing token index (None: equal)."""
    out = []
    for a, b in zip(got, want):
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        out.append(diff[0] if diff else (None if len(a) == len(b) else min(len(a), len(b))))
    return out


def kv_bits(torch, config, params, dev, prompt: int = 128, steps: int = 64) -> dict:
    """Decode-written K/V rows against a prefill's over the same tokens."""
    import numpy as np

    from cake_tpu_torch.runtime.batch_backend import LocalBatchBackend

    b = 8
    backend = LocalBatchBackend(config, params, max_seq_len=prompt + steps,
                                cache_dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    tokens = rng.integers(3, config.vocab_size, (b, prompt + steps)).astype(np.int32)
    pads = np.zeros((b,), np.int32)
    kv = backend.init_kv(b)
    _, kv = backend.prefill(tokens[:, :prompt], kv, pads)
    kv = backend.replay_decode(kv, tokens[:, prompt:].astype(np.int64), prompt, pads)
    dk, dv = kv.k.clone(), kv.v.clone()
    kv = backend.init_kv(b)
    _, kv = backend.prefill(tokens, kv, pads)
    rows = []
    for layer in range(config.num_hidden_layers):
        row = {"layer": layer}
        for name, got, want in (("k", dk, kv.k), ("v", dv, kv.v)):
            for part, sl in (("prompt", slice(0, prompt)),
                             ("decoded", slice(prompt, prompt + steps))):
                a, w = got[layer, :, :, sl].float(), want[layer, :, :, sl].float()
                row[f"{name}_{part}_equal_share"] = (a == w).float().mean().item()
                row[f"{name}_{part}_max_abs"] = (a - w).abs().max().item()
        rows.append(row)
    first = next((r["layer"] for r in rows if r["k_decoded_equal_share"] < 1.0), None)
    return {"section": "kv_bits", "prompt": prompt, "steps": steps,
            "first_layer_differing": first, "layers": rows}


def faulted_wave(smoke, eng, tokens: int, plan: str, budget_s: float) -> dict:
    """One wave under ``plan`` with the failover budget ``budget_s``."""
    from cake_tpu_torch.runtime import faults
    from cake_tpu_torch.utils import metrics

    metrics.flight.clear()
    eng.failover_budget_s = budget_s
    faults.install(faults.parse(plan))
    try:
        t0 = time.perf_counter()
        wave = smoke._wave(eng, tokens, together=True)
        wall = time.perf_counter() - t0
    finally:
        faults.clear()
    migrated = [e for e in metrics.flight.snapshot() if e["event"] == "failover-migrated"]
    return {"plan": plan, "budget_s": budget_s, "wall_s": wall, "streams": wave["streams"],
            "finish_reasons": wave["finish_reasons"], "stream_errors": wave["stream_errors"],
            "migrations": [{k: e.get(k) for k in ("slot", "seconds", "how", "live")}
                           for e in migrated],
            "replay_s_per_position": eng._replay_s_per_pos}


def held_to(run: dict, want: list) -> dict:
    """The run's row: its streams against ``want``."""
    out = {k: v for k, v in run.items() if k != "streams"}
    out["equal_streams"] = sum(a == b for a, b in zip(run["streams"], want))
    out["first_differences"] = first_differences(run["streams"], want)
    return out


def local_runs(smoke, torch, config, params, dev, tokens: int, after: int) -> dict:
    from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    rows = {}
    for prefix in (False, True):
        serve = ServeConfig(max_batch=smoke.ENGINE_BATCH, decode_chunk_size=8, kv_mode="paged",
                            page_size=smoke.ENGINE_PAGE, failover_local=True,
                            prefix_cache=prefix)
        eng = BatchEngine(config, params, ByteTokenizer(), max_seq_len=smoke.ENGINE_MAX_SEQ,
                          cache_dtype=torch.bfloat16, serve=serve, device=dev)
        try:
            smoke._wave(eng, 16, smoke.warm_messages(), together=True)
            early = smoke._wave(eng, smoke.ENGINE_TOKENS, together=True)
            plan = "crash@backend.decode:after={}:count=1"
            if prefix:
                rows["prefix_early"] = held_to(faulted_wave(
                    smoke, eng, smoke.ENGINE_TOKENS, plan.format(3), BIG_BUDGET_S),
                    early["streams"])
                continue
            t0 = time.perf_counter()
            late = smoke._wave(eng, tokens, together=True)
            rows["fault_free_late_wall_s"] = time.perf_counter() - t0
            rows["fault_free_early_wall_s"] = early["wall_s"]
            for how, budget in (("replay", BIG_BUDGET_S), ("reprefill", TINY_BUDGET_S)):
                rows[f"late_{how}"] = held_to(faulted_wave(
                    smoke, eng, tokens, plan.format(after), budget), late["streams"])
                rows[f"early_{how}"] = held_to(faulted_wave(
                    smoke, eng, smoke.ENGINE_TOKENS, plan.format(3), budget), early["streams"])
        finally:
            eng.stop()
    return {"section": "local", **rows}


def tcp_runs(smoke, torch, config, params, dev, tokens: int, after: int) -> dict:
    from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
    from cake_tpu_torch.parallel.topology import Topology
    from cake_tpu_torch.runtime.batch_backend import DistributedBatchBackend
    from cake_tpu_torch.runtime.master import DistributedForwardStep
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    n, half = config.num_hidden_layers, config.num_hidden_layers // 2
    serve = ServeConfig(max_batch=smoke.ENGINE_BATCH, decode_chunk_size=8)
    local = BatchEngine(config, params, ByteTokenizer(), max_seq_len=smoke.ENGINE_MAX_SEQ,
                        cache_dtype=torch.bfloat16, serve=serve, device=dev)
    try:
        smoke._wave(local, 16, smoke.warm_messages(), together=True)
        want = {t: smoke._wave(local, t, together=True)["streams"]
                for t in (smoke.ENGINE_TOKENS, tokens)}
    finally:
        local.stop()
    def span(lo: int, hi: int) -> list[str]:
        return [f"model.layers.{lo}-{hi - 1}" if hi - lo > 1 else f"model.layers.{lo}"]

    topo = Topology.from_dict({
        "w1": {"host": "placeholder", "layers": span(0, half)},
        "w2": {"host": "placeholder", "layers": span(half, n)},
        "w2b": {"host": "placeholder", "layers": span(half, n)},
    })
    workers = smoke._start_workers(torch, config, params, topo, smoke.ENGINE_MAX_SEQ, dev)
    rows, rate = {}, None
    try:
        for name, t, sends, budget in (
                ("late_replay", tokens, 1 + 8 * after, BIG_BUDGET_S),
                ("late_reprefill", tokens, 1 + 8 * after, TINY_BUDGET_S),
                ("early_reprefill", smoke.ENGINE_TOKENS, smoke.FAILOVER_AFTER, TINY_BUDGET_S)):
            step = DistributedForwardStep(config, None, topo, dtype=torch.bfloat16,
                                          max_seq_len=smoke.ENGINE_MAX_SEQ, device=dev,
                                          params=params)
            eng = BatchEngine(config, None, ByteTokenizer(),
                              max_seq_len=smoke.ENGINE_MAX_SEQ, cache_dtype=torch.bfloat16,
                              serve=serve, backend=DistributedBatchBackend(step))
            eng._replay_s_per_pos = rate
            try:
                step.router.prefer("w2")
                run = faulted_wave(smoke, eng, t, f"kill@client.send:node=w2:after={sends}:count=0",
                                   budget)
                rate = eng._replay_s_per_pos
                rows[name] = held_to(run, want[t])
            finally:
                eng.stop()
                step.close()
    finally:
        for w in workers.values():
            w.stop()
    return {"section": "tcp", **rows}


def run(dev: str = "cuda", config=None, tokens: int = 640, after: int = 70,
        tcp: bool = True) -> None:
    """Every section (``dev``/``config`` rehearse them on the CPU at a small
    config)."""
    import torch

    import chip_smoke as smoke
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.config import LlamaConfig

    dev = torch.device(dev)
    config = config or dataclasses.replace(LlamaConfig(), fusion_impl="none")
    t0 = time.perf_counter()
    params = M.init_params(config, torch.Generator(device=dev).manual_seed(0), torch.bfloat16,
                           dev)
    emit({"section": "setup", "layers": config.num_hidden_layers, "tokens": tokens,
          "after": after, "init_s": time.perf_counter() - t0})
    emit(kv_bits(torch, config, params, dev))
    emit(local_runs(smoke, torch, config, params, dev, tokens, after))
    if tcp:
        emit(tcp_runs(smoke, torch, config, params, dev, tokens, after))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=640, help="tokens out a late-fault request")
    ap.add_argument("--after", type=int, default=70,
                    help="decode chunks (of 8) before the late fault")
    ap.add_argument("--no-tcp", action="store_true")
    args = ap.parse_args()
    global SINK
    OUT.parent.mkdir(exist_ok=True)
    OUT.unlink(missing_ok=True)
    SINK = OUT
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    from cake_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    _build.library()
    emit({"section": "build", "seconds": time.perf_counter() - t0})
    run(tokens=args.tokens, after=args.after, tcp=not args.no_tcp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
