"""Autoregressive generation loop (port of
``cake_tpu/models/llama/generator.py``, single-host path).

Chat history, prefill (power-of-two buckets, optional fixed-size chunks),
the per-token decode loop, fused multi-token decode (``decode_chunk_size``
tokens per device dispatch, models/llama/fused.py), sampling with the repeat
penalty, incremental detokenization, EOS detection, KV prefix reuse across
``reset()``, and recovery from a lost worker connection (a step raising
``StepConnectionError``: the step is reset and the token history replayed).
Prefill and decode walls land in the ``cake_prefill_seconds`` and
``cake_decode_step_seconds`` histograms (utils/metrics.py), each ending at
the token's readback, so it holds the device work. A single-window model
may decode over the rolling window cache (``LocalForwardStep(rolling_budget=)``,
models/llama/cache.py). Speculative decoding is not ported yet
(ROADMAP.md).

The seam is the same as the JAX package's: the generator needs a step
``(tokens, pos, seq_len) -> logits``; :class:`LocalForwardStep` runs the
model on one device with the weights resident and the KV cache written in
place.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Callable, Protocol

import numpy as np
import torch

from cake_tpu_torch.device import resolve_device
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.cache import SEQ_MULTIPLE, init_cache
from cake_tpu_torch.models.llama.chat import Message, encode_dialog
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.fused import DecodeChunk
from cake_tpu_torch.models.llama.tokenizer import Tokenizer, load_tokenizer
from cake_tpu_torch.ops.fuse import fuse_params, parse_fusion_spec, resolve_fusion
from cake_tpu_torch.ops.quant import quantize_params
from cake_tpu_torch.ops.rope import model_rope_tables
from cake_tpu_torch.ops.sampling import DEFAULT_SEED, apply_repeat_penalty, draw, sample
from cake_tpu_torch.ops.threefry import prng_key
from cake_tpu_torch.utils import metrics


class StepConnectionError(RuntimeError):
    """A step's backing connection failed mid-call and was re-established
    (runtime/master.py): the step's KV state is lost, and the generator
    recovers by resetting the step and replaying its token history."""

    def __init__(self, node: str):
        super().__init__(f"connection to worker {node!r} was reset")
        self.node = node


@dataclasses.dataclass
class Token:
    """One generated token."""

    id: int
    text: str
    is_end_of_stream: bool


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Sampling knobs (the reference CLI's defaults)."""

    temperature: float = 1.0
    top_k: int | None = None
    top_p: float | None = None
    repeat_penalty: float = 1.1
    repeat_last_n: int = 128
    seed: int = DEFAULT_SEED


def decode_delta(tokenizer: Tokenizer, ids: list[int], decoded_len: int) -> tuple[str, int]:
    """Incremental detokenization: (newly stabilized text, new stable length).
    A trailing replacement char is held back: the next token may complete a
    partial UTF-8 sequence."""
    full = tokenizer.decode(ids)
    stable = len(full)
    if full.endswith("�"):
        stable -= 1
    return full[decoded_len:stable], stable


class ForwardStep(Protocol):
    """One model step over a token chunk; implementations own their KV."""

    def __call__(self, tokens: np.ndarray, pos: int, seq_len: int) -> torch.Tensor:
        ...  # [batch, vocab] f32 logits at the last valid position

    def reset(self) -> None: ...

    @property
    def max_seq_len(self) -> int: ...


class LocalForwardStep:
    """Single-device step: fused weights resident on ``device``, a dense KV
    cache written in place, rope tables built once; ``decode_chunk`` runs
    multi-token decode on the device (a CUDA graph replay on the card).

    ``rolling_budget`` (the reference's): the caller's promise about the
    largest chunk it will ever feed (its ``--prefill-chunk``). For a model
    with one sliding window the cache is then a ring of ``window + budget``
    slots rounded up to SEQ_MULTIPLE (models/llama/cache.py), but only
    where that is smaller than the full cache; the alternating-window
    patterns (Gemma-2, Gemma-3) never take it, since their full-attention
    layers need every key. ``max_seq_len`` stays the logical bound: the rope
    tables and the ring kernels' limit are built at it."""

    def __init__(
        self,
        config: LlamaConfig,
        params: M.Params,
        *,
        max_seq_len: int | None = None,
        batch_size: int = 1,
        cache_dtype: torch.dtype = torch.bfloat16,
        device: torch.device | str = "cuda",
        rolling_budget: int | None = None,
    ):
        self.config = config
        self.device = resolve_device(device)
        self.params = fuse_params(params)
        self._max_seq = int(max_seq_len or config.max_position_embeddings)
        self._batch = batch_size
        self._cache_dtype = cache_dtype
        # The logical bound, padded as the full cache pads it: the rope
        # tables' length and, under rolling, the ring kernels' limit.
        self._bound = -(-self._max_seq // SEQ_MULTIPLE) * SEQ_MULTIPLE
        self.rolling = False
        self._cache_len = self._max_seq
        win = config.sliding_window
        if config.alt_sliding_window or config.sliding_pattern is not None:
            win = None
        if rolling_budget is not None and win is not None:
            budget = max(int(rolling_budget), 1)
            s_roll = -(-(win + budget) // SEQ_MULTIPLE) * SEQ_MULTIPLE
            if s_roll < self._bound:
                self.rolling = True
                self._cache_len = s_roll
        self._kv = None
        self.reset()
        self._rope = model_rope_tables(config, self._bound, self.device)
        # DecodeChunk per (n_steps, batch, sampling knobs, KV dtype, rolling)
        self._chunks: dict = {}

    @property
    def max_seq_len(self) -> int:
        return self._max_seq

    def reset(self) -> None:
        if self._kv is None:
            self._kv = init_cache(
                self.config.num_hidden_layers, self._batch, self._cache_len,
                self.config.num_key_value_heads, self.config.head_dim,
                self._cache_dtype, self.device,
            )
        # Nothing to clear: slots past the live prefix are never read (the
        # decode kernel's lengths and the causal mask bound every read).

    @torch.inference_mode()
    def __call__(self, tokens: np.ndarray, pos: int, seq_len: int) -> torch.Tensor:
        if self.rolling:
            room = self._kv.max_seq_len - self.config.sliding_window
            if np.shape(tokens)[1] > room:
                raise ValueError(
                    f"chunk of {np.shape(tokens)[1]} tokens exceeds the rolling cache budget "
                    f"{room}; lower --prefill-chunk or raise rolling_budget"
                )
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int64).to(self.device)
        logits, self._kv = M.forward(
            self.params, toks, self._kv, int(pos), int(seq_len), self.config,
            cached_prefill=M.is_cached_prefill(pos, toks.shape[1]), rope=self._rope,
            rolling=self.rolling, rope_len=self._bound if self.rolling else None,
        )
        return logits

    @torch.inference_mode()
    def decode_chunk(
        self,
        last_token: np.ndarray,
        pos: int,
        n_steps: int,
        sampling,
        key: torch.Tensor,
        ring: np.ndarray,
        ring_idx: int,
    ) -> tuple[np.ndarray, torch.Tensor]:
        """Decode ``n_steps`` tokens on the device (port of the JAX package's
        ``FusedDecodeCapability.decode_chunk``); returns their ids [batch,
        n_steps], read back once, and the advanced key.

        ``last_token`` [batch] sits at position ``pos``. ``key`` is the
        dialog's [2] threefry key on the device, split once a sampled step
        exactly as the per-step path splits it; the advanced key stays on
        the device (the chunk's key buffer). The penalty ring ([batch,
        window], -1 = empty) and its next slot are values: the caller
        reseeds them from its token history each call, so an EOS truncation
        leaves no stale ring state behind.

        The chunk runs as a ``DecodeChunk`` (models/llama/fused.py), one a
        (n_steps, batch, sampling knobs): on the card a replay of its CUDA
        graph, captured at its first chunk; on the CPU the loop over the
        same buffers. The cache bound is checked here, on the host ints.
        Under rolling each step's ring slot is the device position modulo
        the ring (``write_layer_rolling``), so a graph replays across the
        wrap."""
        if pos < 0 or pos + n_steps > self._bound:
            raise ValueError(
                f"decode chunk writes positions [{pos}, {pos + n_steps}) outside the cache's "
                f"{self._bound}"
            )
        b, window = int(np.size(last_token)), np.shape(ring)[1]
        s = sampling
        ckey = (n_steps, b, window, s.temperature, s.top_k, s.top_p, s.repeat_penalty,
                self._kv.k.dtype, self.rolling)
        chunk = self._chunks.get(ckey)
        if chunk is None:
            params, config, rope = self.params, self.config, self._rope
            rolling, rope_len = self.rolling, self._bound if self.rolling else None

            def forward_one(tok, kv, p):
                return M.forward(params, tok, kv, p, 1, config, rope=rope, rolling=rolling,
                                 rope_len=rope_len)

            chunk = self._chunks[ckey] = DecodeChunk(
                forward_one, self._kv, batch=b, window=window, n_steps=n_steps, s=s,
                fused_tail="tail" in resolve_fusion(config), per_row=False, device=self.device,
            )
        ids = chunk.run(
            tok=np.asarray(last_token, np.int64).reshape(b), slot=pos,
            ring=np.asarray(ring, np.int64), ring_idx=np.full(b, ring_idx, np.int64),
            keys=key,
        )
        return ids.cpu().numpy(), chunk.keys


def prefill_bucket(n: int, max_seq_len: int, minimum: int = 16) -> int:
    """Power-of-two padding bucket (the JAX package compiles once per bucket;
    the port keeps the same chunk shapes so both run the same arithmetic)."""
    b = minimum
    while b < n:
        b *= 2
    return min(b, max_seq_len)


class LlamaGenerator:
    """Chat-aware token generator."""

    def __init__(
        self,
        config: LlamaConfig,
        step: ForwardStep,
        tokenizer: Tokenizer,
        sampling: SamplingConfig = SamplingConfig(),
        prefill_chunk: int | None = None,
        prefix_cache: bool = False,
        decode_chunk_size: int = 1,
    ):
        self.config = config
        self.step = step
        self.tokenizer = tokenizer
        self.sampling = sampling
        # Reuse the KV prefix across reset(): a new dialog sharing a token
        # prefix with the previous one prefills only the new suffix.
        self.prefix_cache = prefix_cache
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        # Tokens per fused decode dispatch (1 = per-token decode).
        self.decode_chunk_size = max(1, int(decode_chunk_size))
        self.last_finish_reason: str = "stop"
        self.reset()

    @classmethod
    def load(
        cls,
        model_dir: str | Path,
        *,
        dtype: torch.dtype = torch.bfloat16,
        max_seq_len: int | None = None,
        sampling: SamplingConfig = SamplingConfig(),
        prefill_chunk: int | None = None,
        prefix_cache: bool = False,
        device: torch.device | str | None = None,
        decode_chunk_size: int = 1,
        fusion_impl: str = "none",
        quantize: str | None = None,
        kv_dtype: torch.dtype | None = None,
        rolling_budget: int | None = None,
    ) -> "LlamaGenerator":
        """Config, weights and tokenizer from a checkpoint directory, on
        ``device`` (default CUDA; raises when there is none). ``fusion_impl``
        is set on the config before the step is built. ``quantize``
        ("int8" or "int4") quantizes the loaded weights on the device, one
        layer slice at a time, before the step is built; a quantized
        checkpoint loads quantized without it. ``kv_dtype``: the KV cache's
        dtype (``--kv-dtype``; None = ``dtype``), e.g. ``torch.float8_e4m3fn``,
        which halves the cache against bf16. ``rolling_budget``: the
        step's (``LocalForwardStep``), the rolling window cache."""
        from cake_tpu_torch.io.safetensors_io import load_params

        if quantize not in (None, "int8", "int4"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        dev = resolve_device(device)
        config = LlamaConfig.from_model_dir(model_dir)
        if fusion_impl != "none":
            parse_fusion_spec(fusion_impl)
            config = dataclasses.replace(config, fusion_impl=fusion_impl)
        params = load_params(model_dir, config, dtype, dev)
        if quantize is not None:
            params = quantize_params(params, quantize)
        step = LocalForwardStep(
            config, params, max_seq_len=max_seq_len, cache_dtype=kv_dtype or dtype, device=dev,
            rolling_budget=rolling_budget,
        )
        return cls(
            config, step, load_tokenizer(model_dir), sampling,
            prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
            decode_chunk_size=decode_chunk_size,
        )

    # ------------------------------------------------------------- chat state

    def reset(self) -> None:
        """Clear dialog and counters. With ``prefix_cache`` the step's KV
        survives as a snapshot of the tokens it is valid for, bounded by the
        last sampled token (never fed back) and by ``_kv_high``, the
        high-water mark of successful step calls."""
        if (
            self.prefix_cache
            and getattr(self, "_started", False)
            # A ring cannot offer prefix reuse: truncating it to a common
            # prefix would leave slots whose reconstructed positions lie
            # about data written past the prefix.
            and not getattr(self.step, "rolling", False)
        ):
            bound = min(self._kv_high, max(0, len(self._tokens) - 1))
            self._reusable = self._tokens[:bound]
        else:
            self._reusable = []
            if getattr(self, "step", None) is not None:
                self.step.reset()
        self._kv_high = 0
        self.messages: list[Message] = []
        self._tokens: list[int] = []
        self._n_prompt = 0
        self._decoded_len = 0
        self._started = False
        self._prompt_cache: tuple[str, list[int]] | None = None
        # The dialog's threefry key, on the step's device (the reference's
        # jax.random.PRNGKey(seed) at reset).
        self._key = prng_key(self.sampling.seed, getattr(self.step, "device", None))
        self.last_prefill_tokens = 0

    def add_message(self, message: Message) -> None:
        self.messages.append(message)

    @property
    def generated_count(self) -> int:
        return len(self._tokens) - self._n_prompt if self._started else 0

    @property
    def generated_token_ids(self) -> list[int]:
        return self._tokens[self._n_prompt :]

    @property
    def prompt_tokens(self) -> int:
        return self._n_prompt

    def prompt_token_count(self) -> int:
        """Token count of the current dialog's rendered prompt."""
        return len(self._encode_prompt())

    def _encode_prompt(self) -> list[int]:
        prompt = encode_dialog(self.messages, self.config.dialog_template)
        if self._prompt_cache is None or self._prompt_cache[0] != prompt:
            self._prompt_cache = (prompt, self.tokenizer.encode(prompt))
        return self._prompt_cache[1]

    # ------------------------------------------------------------- sampling

    def _penalty_window(self) -> np.ndarray:
        n = self.sampling.repeat_last_n
        w = np.full((1, n), -1, np.int64)
        if n > 0 and self._tokens:
            recent = self._tokens[-n:]
            w[0, : len(recent)] = recent
        return w

    def _sample(self, logits: torch.Tensor) -> int:
        """The next id: penalty, one split of the dialog's key, the draw
        (the JAX package's ``next_token``; the chunked path splits the same
        key in the same order)."""
        s = self.sampling
        if s.repeat_penalty != 1.0:
            window = torch.from_numpy(self._penalty_window()).to(logits.device)
            logits = apply_repeat_penalty(logits, s.repeat_penalty, window)
        self._key, noise = draw(self._key, logits, s.temperature)
        ids = sample(logits, None, s.temperature, s.top_k, s.top_p, noise=noise)
        return int(ids[0])

    # ------------------------------------------------------------- decoding

    def _prefill(self, ids: list[int], start: int = 0) -> torch.Tensor:
        """Run ``ids`` (positions [start, start + len)) through the step and
        return the last token's logits: full ``prefill_chunk``-sized chunks,
        then one power-of-two-bucketed tail chunk (one shot without a cap)."""
        cap = self.prefill_chunk
        off = start
        end = start + len(ids)
        if cap is not None:
            while end - off > cap:
                chunk = np.asarray([ids[off - start : off - start + cap]], np.int64)
                self.step(chunk, off, cap)  # logits discarded mid-prompt
                off += cap
                self._kv_high = max(self._kv_high, off)
        rem = ids[off - start :]
        bucket = prefill_bucket(len(rem), self.step.max_seq_len if cap is None else cap)
        # A bucket at offset `off` must stay inside the cache.
        bucket = min(bucket, self.step.max_seq_len - off)
        chunk = np.zeros((1, bucket), np.int64)
        chunk[0, : len(rem)] = rem
        logits = self.step(chunk, off, len(rem))
        self._kv_high = max(self._kv_high, off + len(rem))
        return logits

    def next_token(self) -> Token:
        """Generate one token. The wall from the dispatch to the sampled
        token's readback lands in ``cake_prefill_seconds`` (the prompt's
        prefill, all chunks) or ``cake_decode_step_seconds`` (mode "step")."""
        t0 = time.perf_counter()
        prefill = not self._started
        if not self._started:
            ids = self._encode_prompt()
            if len(ids) >= self.step.max_seq_len:
                raise ValueError(
                    f"prompt length {len(ids)} exceeds max_seq_len {self.step.max_seq_len}"
                )
            self._tokens = list(ids)
            self._n_prompt = len(ids)
            self._started = True
            # Prefix reuse: skip tokens whose KV the step already holds; the
            # last prompt token is always fed (its logits are needed).
            lcp = 0
            if self._reusable:
                cap_lcp = min(len(ids) - 1, len(self._reusable))
                while lcp < cap_lcp and ids[lcp] == self._reusable[lcp]:
                    lcp += 1
                self._reusable = []
            self.last_prefill_tokens = len(ids) - lcp
            logits = self._prefill(ids[lcp:], start=lcp)
        else:
            pos = len(self._tokens) - 1
            if pos >= self.step.max_seq_len:
                raise ValueError(
                    f"sequence length {pos + 1} exceeds max_seq_len {self.step.max_seq_len}"
                )
            logits = self.step(np.array([[self._tokens[-1]]], np.int64), pos, 1)
            self._kv_high = max(self._kv_high, pos + 1)
        tid = self._sample(logits)
        if prefill:
            metrics.registry.histogram(
                "cake_prefill_seconds", "Prompt prefill wall time per request (all chunks).",
            ).observe(time.perf_counter() - t0)
        else:
            metrics.registry.histogram(
                "cake_decode_step_seconds",
                "Decode dispatch wall time (mode: per-token step, fused "
                "chunk, or speculative verify).",
            ).observe(time.perf_counter() - t0, mode="step")
        return self._materialize(tid)

    def _materialize(self, tid: int) -> Token:
        """Append one id and produce its Token (EOS, incremental text)."""
        self._tokens.append(tid)
        is_eos = tid in self.config.eos_token_ids
        text = ""
        if not is_eos:
            text, self._decoded_len = decode_delta(
                self.tokenizer, self.generated_token_ids, self._decoded_len
            )
        return Token(id=tid, text=text, is_end_of_stream=is_eos)

    def _next_tokens_fused(self, n_steps: int) -> list[Token]:
        """Decode ``n_steps`` tokens in one fused device dispatch (the step's
        ``decode_chunk``), after the prefill. The penalty ring is reseeded
        from the token history each call, so chunks compose exactly with
        per-step decoding; an EOS truncates the chunk (the tail past it is
        dropped, its KV writes past the live length)."""
        window = self.sampling.repeat_last_n
        ring = self._penalty_window()
        ring_idx = min(len(self._tokens), window) % window if window > 0 else 0
        pos = len(self._tokens) - 1
        t0 = time.perf_counter()
        toks, self._key = self.step.decode_chunk(
            np.asarray([self._tokens[-1]], np.int64), pos, n_steps, self.sampling,
            self._key, ring, ring_idx,
        )
        ids = toks[0].tolist()
        metrics.registry.histogram(
            "cake_decode_step_seconds",
            "Decode dispatch wall time (mode: per-token step, fused "
            "chunk, or speculative verify).",
        ).observe(time.perf_counter() - t0, mode="fused")
        # Every fed position was written; reset()'s len - 1 bound drops the
        # slots of tokens an EOS below discards.
        self._kv_high = max(self._kv_high, pos + n_steps)
        out: list[Token] = []
        for tid in ids:
            tok = self._materialize(int(tid))
            out.append(tok)
            if tok.is_end_of_stream:
                break
        return out

    def _replay_history(self) -> None:
        """Recovery: rebuild ALL step-side KV from the token history. The
        step is reset, the prompt is prefilled in the chunks it was first
        prefilled in, and each generated token but the pending last one is
        fed as the decode step that first consumed it: the same kernels at
        the same shapes, so the rebuilt KV holds the lost KV's bits. (The
        JAX package replays the history as one chunked prefill; on the card
        that rounds the generated tokens' K/V otherwise, and a greedy stream
        then parts from the uninterrupted one.) The next regular step
        consumes the pending token and resumes the stream where it broke. A
        failure before the first token leaves nothing to replay: the
        prompt's prefill runs again. Under prefix reuse the reused prefix's
        KV is recomputed here, so its bits may differ."""
        self.step.reset()
        self._kv_high = 0  # everything below re-earns its mark
        n = self._n_prompt
        if len(self._tokens) <= n:
            self._started = False
            return
        self._prefill(self._tokens[:n])
        for pos in range(n, len(self._tokens) - 1):
            self.step(np.array([[self._tokens[pos]]], np.int64), pos, 1)
            self._kv_high = pos + 1

    def generate(
        self, max_new_tokens: int, on_token: Callable[[Token], None] | None = None
    ) -> str:
        """Decode up to ``max_new_tokens``, streaming through ``on_token``.
        Sets ``last_finish_reason``: "stop" at EOS, else "length".

        With ``decode_chunk_size`` > 1 the tokens after the first come in
        fused chunks of that size (``_next_tokens_fused``); the first token
        (prefill) and a tail shorter than a chunk go per step.

        A step that raises ``StepConnectionError`` (a lost worker, which it
        re-dialed) raises before any token of the iteration materializes:
        the history is replayed and the iteration retried. The budget is 2
        recoveries in a row; a produced token resets it, so separate blips
        each get their own."""
        chunk = self.decode_chunk_size
        out: list[str] = []
        self.last_finish_reason = "length"
        produced = 0
        recoveries = 0
        needs_replay = False
        produced_at_last_failure = 0
        while produced < max_new_tokens:
            if recoveries and produced > produced_at_last_failure:
                recoveries = 0
            if len(self._tokens) >= self.step.max_seq_len:
                break
            budget = min(max_new_tokens - produced, self.step.max_seq_len - len(self._tokens))
            try:
                if needs_replay:
                    # Inside the try: a blip during the replay spends the
                    # same budget.
                    self._replay_history()
                    needs_replay = False
                fused = chunk > 1 and budget >= chunk and self._started and hasattr(
                    self.step, "decode_chunk"
                )
                for tok in self._next_tokens_fused(chunk) if fused else [self.next_token()]:
                    produced += 1
                    if on_token is not None:
                        on_token(tok)
                    if tok.is_end_of_stream:
                        self.last_finish_reason = "stop"
                        return "".join(out)
                    out.append(tok.text)
            except StepConnectionError as e:
                recoveries += 1
                if recoveries > 2:
                    raise
                produced_at_last_failure = produced
                logging.getLogger("cake_tpu_torch.generator").warning(
                    "recovering from %s (replaying %d tokens)", e, len(self._tokens)
                )
                needs_replay = True
        return "".join(out)
