"""Command-line entry point of the port: ``python -m cake_tpu_torch.cli``.

    python -m cake_tpu_torch.cli --model DIR --prompt "..." -n 100
    python -m cake_tpu_torch.cli --model DIR --api 127.0.0.1:8080

Single-host generation on one CUDA device (``--device cpu`` runs the plain
PyTorch versions of the kernels on the CPU instead; without a CUDA device
and without ``--device cpu`` it exits with an error). The flags are the
subset of ``cake_tpu/cli.py``'s master path that the port has; others are
refused by the parser.
"""

from __future__ import annotations

import argparse
import logging
import sys

from cake_tpu_torch.device import DTYPES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cake-tpu-torch",
        description="Llama-family generation on one NVIDIA GPU (PyTorch/CUDA port)",
    )
    p.add_argument("--model", required=True, help="checkpoint directory")
    p.add_argument(
        "--api", default=None, metavar="HOST:PORT",
        help="serve the OpenAI-compatible REST API instead of one-shot generation",
    )
    p.add_argument("--prompt", default="Why can't cats taste sweetness?")
    p.add_argument("--system-prompt", default=None)
    p.add_argument("-n", "--sample-len", type=int, default=100)
    p.add_argument("--dtype", choices=tuple(DTYPES), default="bf16")
    p.add_argument("--max-seq-len", type=int, default=None)
    p.add_argument(
        "--prefill-chunk", type=int, default=None,
        help="prefill long prompts in chunks of at most N tokens",
    )
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--repeat-penalty", type=float, default=1.1)
    p.add_argument("--repeat-last-n", type=int, default=128)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="cuda (default; fails without a GPU) or cpu (plain PyTorch versions)",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _parse_address(addr: str) -> tuple[str, int]:
    host, sep, port = addr.rpartition(":")
    if not sep or not port.isdigit():
        raise SystemExit(f"--api expects HOST:PORT, got {addr!r}")
    return host or "127.0.0.1", int(port)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
    )
    from cake_tpu_torch.models.llama.chat import Message
    from cake_tpu_torch.models.llama.generator import LlamaGenerator, SamplingConfig

    sampling = SamplingConfig(
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        repeat_penalty=args.repeat_penalty,
        repeat_last_n=args.repeat_last_n,
        **({"seed": args.seed} if args.seed is not None else {}),
    )
    generator = LlamaGenerator.load(
        args.model,
        dtype=DTYPES[args.dtype],
        max_seq_len=args.max_seq_len,
        sampling=sampling,
        prefill_chunk=args.prefill_chunk,
        device=args.device,
    )
    if args.api:
        from cake_tpu_torch.runtime.api import ApiServer

        host, port = _parse_address(args.api)
        ApiServer(generator).serve_forever(host, port)
        return 0
    if args.system_prompt:
        generator.add_message(Message.system(args.system_prompt))
    generator.add_message(Message.user(args.prompt))
    generator.generate(args.sample_len, on_token=lambda t: print(t.text, end="", flush=True))
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
