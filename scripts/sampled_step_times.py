#!/usr/bin/env python3
"""Device ops and ms of a seeded sampled decode step, on one card.

    python3 scripts/sampled_step_times.py      # from the repo root

Llama-3-8B's random bf16 weights (drawn as chip_smoke.py's generate phase
draws them), sampled with chip_smoke.SAMPLED_KNOBS (temperature 0.7, top_k
40, repeat_penalty 1.1), one seed a request:

- the paged batch engine (8 lanes, prefix cache on, decode chunk 8) with
  fusion "none" and "all": a sampled wave of 64 tokens (wall ms a decode
  step), then profiled sampled waves of 16 and 32 tokens, differenced into
  device ops and ms a decode step (chip_smoke._device_profile);
- the generator (8-token chunks, each a CUDA graph replay) with fusion
  "none" and "all", one sampled dialog: wall ms a token over 64 tokens,
  then device ops and ms a token over 16 profiled tokens
  (chip_smoke._profile_main_path).

It uses only what this tree and its parent both offer (chip_smoke's
profiling helpers, the public generator and engine), so a copy of it in
the parent's scripts/ measures the parent's draw on the same card: run
parent, change, change, parent in one call. The card's name and power limit
first, then one JSON line a case.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SPECS = ("none", "all")
TOKENS = 64


@contextlib.contextmanager
def quiet(smoke):
    """chip_smoke's rows go to this script's own lines, not its emit()."""
    emit = smoke.emit
    smoke.emit = lambda obj: None
    try:
        yield
    finally:
        smoke.emit = emit


def engine_case(torch, smoke, config, params, spec: str) -> dict:
    from cake_tpu_torch.models.llama.generator import SamplingConfig
    from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    serve = ServeConfig(max_batch=smoke.ENGINE_BATCH, decode_chunk_size=8, fusion_impl=spec,
                        kv_mode="paged", page_size=smoke.ENGINE_PAGE, prefix_cache=True)
    eng = BatchEngine(config, params, ByteTokenizer(), max_seq_len=smoke.ENGINE_MAX_SEQ,
                      cache_dtype=torch.bfloat16, serve=serve, device=torch.device("cuda"))
    eng.start()
    samplings = [SamplingConfig(seed=500 + i, **smoke.SAMPLED_KNOBS)
                 for i in range(smoke.ENGINE_BATCH)]
    try:
        # Capture every chunk's graph first (64-, 32- and 16-token waves).
        smoke._wave(eng, TOKENS, smoke.warm_messages(), samplings=samplings)
        smoke._wave(eng, 32, samplings=samplings)
        smoke._wave(eng, 16, samplings=samplings)
        timed = smoke._wave(eng, TOKENS, samplings=samplings)
        with quiet(smoke):
            short = smoke._device_profile(torch, lambda: smoke._wave(eng, 16, samplings=samplings),
                                          valid=smoke._one_epoch)
            long = smoke._device_profile(torch, lambda: smoke._wave(eng, 32, samplings=samplings),
                                         valid=smoke._one_epoch)
    finally:
        eng.stop()
    torch.cuda.empty_cache()
    return {
        "case": "engine_sampled", "engine": "paged", "fusion": spec,
        "decode_ms_per_step": timed["decode_ms_per_step"],
        "device_ops_per_step": (long["device_ops"] - short["device_ops"]) / 16,
        "device_ms_per_step": (long["device_ms"] - short["device_ms"]) / 16,
        "by_family_ms_per_step": {
            f: (long["by_family_ms"].get(f, 0.0) - short["by_family_ms"].get(f, 0.0)) / 16
            for f in long["by_family_ms"]},
        "trace_tries": [short["trace_tries"], long["trace_tries"]],
    }


def generator_case(torch, smoke, config, params, text: str, spec: str) -> dict:
    from cake_tpu_torch.models.llama.chat import Message
    from cake_tpu_torch.models.llama.generator import (
        LlamaGenerator, LocalForwardStep, SamplingConfig,
    )
    from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer

    cfg = dataclasses.replace(config, fusion_impl=spec)
    step = LocalForwardStep(cfg, params, max_seq_len=smoke.MAX_SEQ, cache_dtype=torch.bfloat16,
                            device=torch.device("cuda"))
    gen = LlamaGenerator(cfg, step, ByteTokenizer(), SamplingConfig(seed=77, **smoke.SAMPLED_KNOBS),
                         prefill_chunk=smoke.PREFILL_CHUNK, decode_chunk_size=smoke.FUSED_CHUNK)
    walls = []
    for _ in range(2):  # the first captures the chunk's graph
        gen.reset()
        gen.add_message(Message.user(text))
        gen.generate(1)
        torch.cuda.synchronize()
        n0, t0 = gen.generated_count, time.perf_counter()
        gen.generate(TOKENS)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0) / (gen.generated_count - n0))
    with quiet(smoke):
        prof = smoke._profile_main_path(torch, gen, text, walls[-1])
    del gen, step
    torch.cuda.empty_cache()
    return {
        "case": "generator_sampled", "chunk": smoke.FUSED_CHUNK, "fusion": spec,
        "decode_ms_per_token": walls[-1],
        "device_ops_per_token": prof["decode_device_ops_per_token"],
        "device_ms_per_token": prof["decode_device_ms_per_token"],
        "device_idle_share": prof["decode_device_idle_share"],
        "by_family_ms_per_token": prof["decode_by_family_ms_per_token"],
        "trace_tries": prof["trace_tries"],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sampled_step_times: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.ops.fuse import fuse_params

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    config = LlamaConfig()  # Llama-3-8B widths and depth
    params = fuse_params(M.init_params(
        config, torch.Generator(device=dev).manual_seed(0), torch.bfloat16, dev))
    sentence = "The quick brown fox jumps over the lazy dog while the cake cools. "
    text = (sentence * 20)[: smoke.PROMPT_TOKENS - 23]  # as chip_smoke's generate phase
    for spec in SPECS:
        print(json.dumps({"tree": str(REPO.name), **engine_case(torch, smoke, config, params,
                                                                  spec)}), flush=True)
    for spec in SPECS:
        print(json.dumps({"tree": str(REPO.name), **generator_case(torch, smoke, config, params,
                                                                     text, spec)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
