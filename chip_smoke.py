#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cake_tpu_torch``) end to end on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line; the first failure ends the run with a
nonzero exit and no final result line:

  1. env       card name and power limit (nvidia-smi), torch/CUDA versions,
               TF32 switched off for every comparison below.
  2. build     nvcc builds the kernels from ops/csrc (seconds reported).
  3. kernels   each CUDA kernel against its plain PyTorch version in bf16 at
               Llama-3-8B attention shapes (n_q 32, n_kv 8, head_dim 128):
               max-abs error (tolerance TOL), kernel / plain /
               scaled_dot_product_attention ms, and the bound (the larger of
               bytes / 3.35 TB/s and FLOPs / 989 TFLOP/s).
  4. generate  Llama-3-8B at full width and depth, random bf16 weights drawn
               on the card from a seeded torch.Generator: a ~700 byte-token
               prompt prefilled in 256-token chunks (the position-0 and the
               continuation kernels), then 64 greedy tokens; the kernels'
               launch counters must equal n_layers x calls and the plain
               versions must not run.
  5. api       the port's ApiServer over that generator answers a JSON chat,
               an SSE chat with usage, and a seeded sampled chat.
  6. cli       ``python -m cake_tpu_torch.cli`` on a small checkpoint written
               by the port's save_tiny_checkpoint.
  7.           ``{"kernels": [...]}``: one entry per kernel with its launches
               on the main path and its timings at the main path's shapes.
  8.           ``{"ok": true, "device": {...}}`` as the last line.

Exits nonzero without a result when no CUDA device is present or when run
outside a checkout of the repository.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

TOL = 2e-2  # bf16 outputs of f32-accumulated attention, max-abs vs the plain version
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
N_Q, N_KV, HD = 32, 8, 128  # Llama-3-8B attention shapes
MAX_SEQ = 8192
PROMPT_TOKENS = 700
PREFILL_CHUNK = 256
DECODE_TOKENS = 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _spin_cycles_per_ms(torch) -> float:
    """Clock cycles ``torch.cuda._sleep`` spins per millisecond on this card."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.

    A spin kernel queued ahead of the timed calls holds the device while the
    host enqueues them, so the events time the device's work and not the
    host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    spin_ms = min(1.5 * iters * call_ms + 1.0, 3000.0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_ms * _spin_cycles_per_ms(torch)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phase 1-2


def phase_env(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {
        "phase": "env",
        "nvidia_smi": smi,
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    }
    emit(info)
    return info


def phase_build() -> None:
    from cake_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build(force=True)
    _build.library()
    emit({
        "phase": "build",
        "seconds": round(time.perf_counter() - t0, 3),
        "library": os.path.relpath(path),
        "sources": [os.path.relpath(p) for p in _build.sources()],
    })


# ---------------------------------------------------------------- phase 3


def _sdpa(torch, q, k, v, mask=None, scale=None, causal=False):
    """scaled_dot_product_attention on [b, h, s, d] operands (the yardstick;
    the port never calls it)."""
    F = torch.nn.functional
    major_minor = tuple(int(x) for x in torch.__version__.split(".")[:2])
    if major_minor >= (2, 5):
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale, is_causal=causal, enable_gqa=True
        )
    g = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale, is_causal=causal)


def _check(torch, name, case, out, ref, ms, plain_ms, nbytes, flops, library_ms):
    err = (out.float() - ref.float()).abs().max().item()
    finite = bool(torch.isfinite(out.float()).all().item())
    b_ms, b_by = bound(nbytes, flops)
    row = {
        "phase": "kernels", "kernel": name, "case": case,
        "max_abs_err": err, "tol": TOL, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        "bytes": nbytes, "flops": flops,
    }
    emit(row)
    if not finite or not err <= TOL:
        raise AssertionError(f"{name}/{case}: max-abs error {err} (finite={finite}) > {TOL}")
    return row


def decode_cases(torch, dev):
    from cake_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain, fold_window,
    )

    g = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    rows = []
    cases = [
        ("lengths", 4, [1, 300, 4097, 8192], None, {}),
        ("starts", 4, [300, 4097, 8192, 8192], [0, 100, 4000, 8191], {}),
        ("window", 4, [1, 300, 4097, 8192], None,
         {"window": 1024, "window_flag": torch.tensor(True, device=dev)}),
        ("softcap", 4, [1, 300, 4097, 8192], None, {"softcap": 50.0, "scale": 0.1}),
        ("main_path", 1, [733], None, {}),
    ]
    for case, b, lens, starts, kw in cases:
        q = torch.randn(b, 1, N_Q, HD, generator=g, device=dev, dtype=bf)
        k = torch.randn(b, N_KV, MAX_SEQ, HD, generator=g, device=dev, dtype=bf)
        v = torch.randn(b, N_KV, MAX_SEQ, HD, generator=g, device=dev, dtype=bf)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
        window_flag = kw.pop("window_flag", None)
        run = lambda: decode_attention(q, k, v, lengths, st, window_flag, **kw)  # noqa: E731
        plain = lambda: decode_attention_plain(q, k, v, lengths, st, window_flag, **kw)  # noqa: E731
        out, ref = run(), plain()
        torch.cuda.synchronize()
        st0 = torch.zeros_like(lengths) if st is None else st
        eff = fold_window(st0, lengths, kw.get("window"), window_flag)
        live = int((lengths - eff).clamp(min=0).sum().item())
        nbytes = 2 * q.numel() * 2 + live * N_KV * HD * 2 * 2
        flops = 4.0 * live * N_Q * HD
        library_ms = None
        if "softcap" not in kw:
            kpos = torch.arange(MAX_SEQ, device=dev)
            mask = ((kpos[None] >= eff[:, None]) & (kpos[None] < lengths[:, None]))[:, None, None, :]
            qh = q.transpose(1, 2)
            library_ms = cuda_ms(torch, lambda: _sdpa(torch, qh, k, v, mask, kw.get("scale")), 10)
        rows.append(_check(
            torch, "decode_attention", case, out, ref,
            cuda_ms(torch, run, 50), cuda_ms(torch, plain, 5), nbytes, flops, library_ms,
        ))
    return rows


def chunk_cases(torch, dev):
    from cake_tpu_torch.ops.chunk_prefill import (
        chunk_prefill_attention, chunk_prefill_attention_plain,
    )

    g = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    rows = []
    cases = [
        ("q_starts", 2, 512, [0, 1024], None, {}),
        ("k_starts", 2, 512, [0, 1024], [0, 300], {}),
        ("window", 2, 512, [0, 1024], None,
         {"window": 256, "window_flag": torch.tensor(True, device=dev)}),
        ("main_path", 1, PREFILL_CHUNK, [2 * PREFILL_CHUNK], None, {}),
    ]
    for case, b, chunk, q_starts, k_starts, kw in cases:
        q = torch.randn(b, chunk, N_Q, HD, generator=g, device=dev, dtype=bf)
        k = torch.randn(b, N_KV, MAX_SEQ, HD, generator=g, device=dev, dtype=bf)
        v = torch.randn(b, N_KV, MAX_SEQ, HD, generator=g, device=dev, dtype=bf)
        qs = torch.tensor(q_starts, dtype=torch.int32, device=dev)
        lengths = qs + chunk
        ks = None if k_starts is None else torch.tensor(k_starts, dtype=torch.int32, device=dev)
        window_flag = kw.pop("window_flag", None)
        run = lambda: chunk_prefill_attention(q, k, v, qs, lengths, window_flag, ks, **kw)  # noqa: E731
        plain = lambda: chunk_prefill_attention_plain(q, k, v, qs, lengths, window_flag, ks, **kw)  # noqa: E731
        out, ref = run(), plain()
        torch.cuda.synchronize()
        # The pairs (query, key) this run's masks admit, and the key rows read.
        qpos = qs[:, None] + torch.arange(chunk, device=dev)[None]
        kpos = torch.arange(MAX_SEQ, device=dev)[None, None]
        k0 = torch.zeros_like(qs) if ks is None else ks
        mask = (kpos <= qpos[:, :, None]) & (kpos >= k0[:, None, None]) & (kpos < lengths[:, None, None])
        if kw.get("window") is not None:
            mask &= kpos > qpos[:, :, None] - kw["window"]
        pairs = int(mask.sum().item())
        keys = int(mask.any(dim=1).sum().item())
        nbytes = 2 * q.numel() * 2 + keys * N_KV * HD * 2 * 2
        flops = 4.0 * pairs * N_Q * HD
        qh = q.transpose(1, 2)
        library_ms = cuda_ms(torch, lambda: _sdpa(torch, qh, k, v, mask[:, None], kw.get("scale")), 5)
        rows.append(_check(
            torch, "chunk_prefill_attention", case, out, ref,
            cuda_ms(torch, run, 20), cuda_ms(torch, plain, 3), nbytes, flops, library_ms,
        ))
    return rows


def flash_cases(torch, dev):
    from cake_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for case, q_len in (("q_len_2048", 2048), ("q_len_1000", 1000), ("main_path", PREFILL_CHUNK)):
        # q and k as rope leaves them (contiguous), v a strided view of the
        # fused projection output, as the model hands them over.
        qkv = torch.randn(1, q_len, (N_Q + 2 * N_KV) * HD, generator=g, device=dev,
                          dtype=torch.bfloat16)
        q = qkv[..., : N_Q * HD].reshape(1, q_len, N_Q, HD).contiguous()
        k = qkv[..., N_Q * HD: (N_Q + N_KV) * HD].reshape(1, q_len, N_KV, HD).contiguous()
        v = qkv[..., (N_Q + N_KV) * HD:].reshape(1, q_len, N_KV, HD)
        run = lambda: flash_attention(q, k, v)  # noqa: E731
        plain = lambda: flash_attention_plain(q, k, v)  # noqa: E731
        out, ref = run(), plain()
        torch.cuda.synchronize()
        pairs = q_len * (q_len + 1) // 2
        nbytes = 2 * q.numel() * 2 + q_len * N_KV * HD * 2 * 2
        flops = 4.0 * pairs * N_Q * HD
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        library_ms = cuda_ms(torch, lambda: _sdpa(torch, qh, kh, vh, causal=True), 10)
        rows.append(_check(
            torch, "flash_attention", case, out, ref,
            cuda_ms(torch, run, 20), cuda_ms(torch, plain, 3), nbytes, flops, library_ms,
        ))
    return rows


def phase_kernels(torch) -> dict:
    dev = torch.device("cuda")
    rows = decode_cases(torch, dev) + chunk_cases(torch, dev) + flash_cases(torch, dev)
    torch.cuda.empty_cache()
    return {(r["kernel"], r["case"]): r for r in rows}


# ---------------------------------------------------------------- phase 4


def _counters():
    from cake_tpu_torch.ops import chunk_prefill, decode_attention, flash_attention

    return (
        decode_attention.decode_attention,
        chunk_prefill.chunk_prefill_attention,
        decode_attention.decode_attention_plain,
        chunk_prefill.chunk_prefill_attention_plain,
        flash_attention.flash_attention_plain,
    )


def _plain_attention(M):
    """Patch the model's attention calls to the plain versions (the
    reference forward of the full-model check; never the main path)."""
    from unittest import mock

    from cake_tpu_torch.ops.chunk_prefill import chunk_prefill_attention_plain
    from cake_tpu_torch.ops.decode_attention import decode_attention_plain
    from cake_tpu_torch.ops.flash_attention import flash_attention_plain

    stack = mock.patch.multiple(
        M,
        decode_attention=decode_attention_plain,
        chunk_prefill_attention=chunk_prefill_attention_plain,
        flash_attention=flash_attention_plain,
    )
    return stack


def _full_model_check(torch, M, config, params, dev) -> dict:
    """Full-width logits through the kernels against the same forward with
    the plain attention versions, on a short input (prefill at 0, a
    continuation chunk, two decode steps)."""
    from cake_tpu_torch.models.llama.cache import init_cache
    from cake_tpu_torch.ops.rope import model_rope_tables

    rope = model_rope_tables(config, 256, dev)
    g = torch.Generator(device="cpu").manual_seed(5)
    first = torch.randint(0, config.vocab_size, (1, 48), generator=g).to(dev)
    cont = torch.randint(0, config.vocab_size, (1, 32), generator=g).to(dev)

    def run():
        kv = init_cache(config.num_hidden_layers, 1, 256, config.num_key_value_heads,
                        config.head_dim, torch.bfloat16, dev)
        outs = []
        with torch.inference_mode():
            logits, kv = M.forward(params, first, kv, 0, 48, config, rope=rope)
            outs.append(logits)
            logits, kv = M.forward(params, cont, kv, 48, 32, config, cached_prefill=True, rope=rope)
            outs.append(logits)
            for pos in (80, 81):
                nxt = logits.argmax(-1)[:, None]
                logits, kv = M.forward(params, nxt, kv, pos, 1, config, rope=rope)
                outs.append(logits)
        return torch.stack(outs)

    got = run()
    with _plain_attention(M):
        want = run()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    cos = torch.nn.functional.cosine_similarity(got.flatten(1), want.flatten(1), dim=-1).min().item()
    row = {"phase": "full_model_check", "max_abs_err": err, "ref_max_abs": scale,
           "min_cosine": cos, "tol_rel": 0.05, "tol_cosine": 0.999}
    emit(row)
    if not (torch.isfinite(got).all().item() and err <= 0.05 * scale and cos >= 0.999):
        raise AssertionError(f"full-model logits: {row}")
    return row


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _kernel_family(name: str) -> str:
    if "decode_kernel" in name:
        return "decode_attention"
    if "chunk_kernel" in name:
        return "chunk_prefill_attention"
    if any(s in name.lower() for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitk")):
        return "matmul"
    return "other"


def _device_profile(torch, run) -> dict:
    """Run ``run`` under torch.profiler and sum the device time of its
    kernels, memcpys and memsets by family (ms), from the exported trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    by_family: dict[str, float] = {}
    count = 0
    for e in events:
        cat = e.get("cat")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        fam = _kernel_family(e.get("name", "")) if cat == "kernel" else cat
        by_family[fam] = by_family.get(fam, 0.0) + e.get("dur", 0.0) / 1e3
        count += 1
    return {"device_ms": sum(by_family.values()), "device_ops": count, "by_family_ms": by_family}


def _profile_main_path(torch, gen, text: str, decode_ms_per_token: float | None) -> dict:
    """Device time of one prefill and of 16 decode steps, by kernel family,
    beside the unprofiled decode time per token (the device idle share)."""
    from cake_tpu_torch.models.llama.chat import Message

    n_decode = 16
    gen.reset()
    gen.add_message(Message.user(text))
    prefill = _device_profile(torch, lambda: gen.generate(1))
    decode = _device_profile(torch, lambda: gen.generate(n_decode))
    per_token = {k: v / n_decode for k, v in decode["by_family_ms"].items()}
    busy = decode["device_ms"] / n_decode
    row = {
        "phase": "profile",
        "prefill_device_ms": prefill["device_ms"],
        "prefill_device_ops": prefill["device_ops"],
        "prefill_by_family_ms": prefill["by_family_ms"],
        "decode_tokens": n_decode,
        "decode_device_ms_per_token": busy,
        "decode_device_ops_per_token": decode["device_ops"] / n_decode,
        "decode_by_family_ms_per_token": per_token,
        "decode_wall_ms_per_token": decode_ms_per_token,
        "decode_device_idle_share": (
            1.0 - busy / decode_ms_per_token if decode_ms_per_token and busy else None
        ),
    }
    emit(row)
    return row


def phase_generate(torch, card: str, dev=None, config=None) -> dict:
    """``dev``/``config`` default to the card and Llama-3-8B; a CPU run at a
    tiny config rehearses the phase's control flow without a card."""
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.chat import Message
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import (
        LlamaGenerator, LocalForwardStep, SamplingConfig,
    )
    from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
    from cake_tpu_torch.ops.fuse import fuse_params

    dev = torch.device("cuda") if dev is None else dev
    config = LlamaConfig() if config is None else config  # Llama-3-8B widths and depth
    t0 = time.perf_counter()
    params = fuse_params(M.init_params(
        config, torch.Generator(device=dev).manual_seed(0), torch.bfloat16, dev
    ))
    _sync(torch, dev)
    init_s = time.perf_counter() - t0
    weight_bytes = M.count_params(params) * 2
    step = LocalForwardStep(
        config, params, max_seq_len=MAX_SEQ, cache_dtype=torch.bfloat16, device=dev
    )
    gen = LlamaGenerator(
        config, step, ByteTokenizer(),
        SamplingConfig(temperature=0.0, repeat_penalty=1.0), prefill_chunk=PREFILL_CHUNK,
    )
    sentence = "The quick brown fox jumps over the lazy dog while the cake cools. "
    text = (sentence * 20)[: PROMPT_TOKENS - 23]  # the llama3 template adds 23 tokens

    gen.add_message(Message.user(text))
    gen.generate(4)  # warm-up: cuBLAS handles, allocator, kernel library
    _sync(torch, dev)

    counters = _counters()
    for c in counters:
        c.launches = 0
    gen.reset()
    gen.add_message(Message.user(text))
    stamps = []
    t_start = time.perf_counter()
    gen.generate(DECODE_TOKENS, on_token=lambda tok: stamps.append(time.perf_counter()))
    _sync(torch, dev)
    t_end = time.perf_counter()
    launches = {c.__name__: c.launches for c in counters}

    n_prompt, n_gen = gen.prompt_tokens, gen.generated_count
    n_chunks = -(-n_prompt // PREFILL_CHUNK)
    n_layers = config.num_hidden_layers
    if dev.type == "cuda":  # every attention call launches a kernel
        expected = {
            "decode_attention": n_layers * (n_gen - 1),
            "chunk_prefill_attention": n_layers * n_chunks,
            "decode_attention_plain": 0,
            "chunk_prefill_attention_plain": 0,
            "flash_attention_plain": 0,
        }
    else:  # a CPU rehearsal: every call takes the plain version
        expected = {
            "decode_attention": 0,
            "chunk_prefill_attention": 0,
            "decode_attention_plain": n_layers * (n_gen - 1),
            "chunk_prefill_attention_plain": n_layers * (n_chunks - 1),
            "flash_attention_plain": n_layers,
        }
    ids = gen.generated_token_ids
    prefill_s = stamps[0] - t_start
    decode_s = (stamps[-1] - stamps[0]) if n_gen > 1 else float("nan")
    gaps_ms = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
    # The spread of prefill: the same prompt again, timed to its first token.
    prefill_repeats_s = []
    for _ in range(4):
        gen.reset()
        gen.add_message(Message.user(text))
        t0 = time.perf_counter()
        gen.generate(1)
        _sync(torch, dev)
        prefill_repeats_s.append(time.perf_counter() - t0)
    row = {
        "phase": "generate",
        "card": card,
        "model": (
            f"hidden {config.hidden_size}, {n_layers} layers, {config.num_attention_heads}/"
            f"{config.num_key_value_heads} heads, inter {config.intermediate_size}, vocab "
            f"{config.vocab_size}; random bf16 weights (seed 0)"
        ),
        "layers": n_layers,
        "weights_gb": weight_bytes / 1e9,
        "init_s": init_s,
        "prompt_tokens": n_prompt,
        "prefill_chunks": n_chunks,
        "generated_tokens": n_gen,
        "finish_reason": gen.last_finish_reason,
        "prefill_s": prefill_s,
        "prefill_tok_s": n_prompt / prefill_s,
        "prefill_repeats_s": prefill_repeats_s,
        "decode_s": decode_s,
        "decode_tok_s": (n_gen - 1) / decode_s if n_gen > 1 else None,
        "decode_ms_per_token": 1e3 * decode_s / (n_gen - 1) if n_gen > 1 else None,
        # Token gaps: the median and the 80th percentile (12 of 63 gaps above it).
        "decode_gap_ms_p50": gaps_ms[len(gaps_ms) // 2] if gaps_ms else None,
        "decode_gap_ms_p80": gaps_ms[int(0.8 * len(gaps_ms))] if gaps_ms else None,
        "decode_bound_ms_per_token": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "wall_s": t_end - t_start,
        "launches": launches,
        "expected_launches": expected,
        "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None,
    }
    emit(row)
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != expected {expected}")
    if n_gen < 1 or not all(0 <= t < config.vocab_size for t in ids):
        raise AssertionError(f"generated ids out of range: {ids}")
    if dev.type == "cuda":
        row["profile"] = _profile_main_path(torch, gen, text, row["decode_ms_per_token"])
    row["check"] = _full_model_check(torch, M, config, step.params, dev)
    row["generator"] = gen
    return row


# ---------------------------------------------------------------- phase 5


def _post(port: int, body: dict) -> tuple[int, str]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/api/v1/chat/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _check_usage(usage: dict, max_tokens: int) -> None:
    if not (usage["prompt_tokens"] > 0 and 1 <= usage["completion_tokens"] <= max_tokens
            and usage["total_tokens"] == usage["prompt_tokens"] + usage["completion_tokens"]):
        raise AssertionError(f"bad usage {usage}")


def phase_api(main_path: dict) -> None:
    """Serve the generate phase's generator."""
    import threading

    from cake_tpu_torch.runtime.api import ApiServer

    api =ApiServer(main_path["generator"], default_max_tokens=16)
    server = api.make_server("127.0.0.1", 0)
    port = server.server_port
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    results = []
    try:
        msgs = [{"role": "user", "content": "Name three colours of cake icing."}]
        t0 = time.perf_counter()
        status, body = _post(port, {"messages": msgs, "max_tokens": 16})
        reply = json.loads(body)
        if status != 200 or reply["choices"][0]["finish_reason"] not in ("stop", "length"):
            raise AssertionError(f"json chat: {status} {body[:500]}")
        _check_usage(reply["usage"], 16)
        results.append({"kind": "json", "status": status, "s": time.perf_counter() - t0,
                        "finish_reason": reply["choices"][0]["finish_reason"],
                        "usage": reply["usage"]})

        t0 = time.perf_counter()
        status, body = _post(port, {"messages": msgs, "max_tokens": 16, "stream": True,
                                    "stream_options": {"include_usage": True}})
        events = [line[6:] for line in body.splitlines() if line.startswith("data: ")]
        if status != 200 or not events or events[-1] != "[DONE]":
            raise AssertionError(f"sse chat: {status} {body[:500]}")
        chunks = [json.loads(e) for e in events[:-1]]
        if any("error" in c for c in chunks):
            raise AssertionError(f"sse chat reported an error: {chunks}")
        finish = [c["choices"][0]["finish_reason"] for c in chunks
                  if c.get("choices") and c["choices"][0]["finish_reason"]]
        if finish[-1:] not in (["stop"], ["length"]) or "usage" not in chunks[-1]:
            raise AssertionError(f"sse chat without finish/usage: {chunks[-2:]}")
        _check_usage(chunks[-1]["usage"], 16)
        results.append({"kind": "sse", "status": status, "s": time.perf_counter() - t0,
                        "events": len(events), "finish_reason": finish[-1],
                        "usage": chunks[-1]["usage"]})

        t0 = time.perf_counter()
        status, body = _post(port, {"messages": msgs, "max_tokens": 16,
                                    "temperature": 0.8, "top_k": 50, "seed": 7})
        reply = json.loads(body)
        if status != 200 or reply["choices"][0]["finish_reason"] not in ("stop", "length"):
            raise AssertionError(f"sampled chat: {status} {body[:500]}")
        _check_usage(reply["usage"], 16)
        results.append({"kind": "sampled", "status": status, "s": time.perf_counter() - t0,
                        "finish_reason": reply["choices"][0]["finish_reason"],
                        "usage": reply["usage"]})
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("api server thread did not stop")
    emit({"phase": "api", "requests": results})


# ---------------------------------------------------------------- phase 6


def phase_cli(torch, extra_args=()) -> None:
    from cake_tpu_torch.io.safetensors_io import save_tiny_checkpoint
    from cake_tpu_torch.models.llama import model as M
    from cake_tpu_torch.models.llama.config import LlamaConfig

    # Llama-3 layout cut to hidden 512, 2 layers, the byte tokenizer's vocab.
    config = LlamaConfig.tiny(
        hidden_size=512, intermediate_size=1792, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=1, max_position_embeddings=1024,
    )
    params = M.init_params(config, torch.Generator().manual_seed(3), torch.float32)
    with tempfile.TemporaryDirectory() as tmp:
        save_tiny_checkpoint(tmp, params, config, dtype=torch.bfloat16)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "cake_tpu_torch.cli", "--model", tmp,
             "--prompt", "hi", "-n", "8", *extra_args],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600,
        )
    row = {"phase": "cli", "returncode": proc.returncode, "s": time.perf_counter() - t0,
           "stdout_chars": len(proc.stdout), "stdout": proc.stdout[-200:]}
    emit(row)
    if proc.returncode != 0 or not proc.stdout:
        raise AssertionError(f"cli failed: {proc.stderr[-2000:]}")


# ---------------------------------------------------------------- phase 7


def kernel_summary(rows: dict, main_path: dict) -> dict:
    launches = main_path["launches"]
    spec = [
        ("decode_attention", "cake_tpu_torch/ops/csrc/decode_attention.cu",
         "cake_tpu/ops/pallas/decode_attention.py:106", ("decode_attention",),
         ("decode_attention", "main_path")),
        ("chunk_prefill_attention", "cake_tpu_torch/ops/csrc/chunk_prefill.cu",
         "cake_tpu/ops/pallas/chunk_prefill.py:151", ("chunk_prefill_attention", "flash_attention"),
         ("chunk_prefill_attention", "main_path")),
    ]
    out = []
    for name, source, replaces, families, timed in spec:
        t = rows[timed]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for k, r in rows.items() if k[0] in families),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    return {"kernels": out}


# ---------------------------------------------------------------- main


def main() -> int:
    import cake_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    env = phase_env(torch)
    phase_build()
    kernel_rows = phase_kernels(torch)
    main_path = phase_generate(torch, env["nvidia_smi"])
    phase_api(main_path)
    phase_cli(torch)
    emit(kernel_summary(kernel_rows, main_path))
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
