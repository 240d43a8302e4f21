"""Tokenizer loading and a dependency-free fallback (the port's own copy of
``cake_tpu/models/llama/tokenizer.py``).

The reference loads a HF `tokenizer.json` via the tokenizers crate
(cake-core/src/models/llama3/llama.rs:19-32). Here:

  * ``HFTokenizer`` wraps the Python ``tokenizers`` package when the model dir has
    a ``tokenizer.json`` (the Llama-3 file carries its special tokens as added
    tokens, so chat-template markers encode to single ids).
  * ``ByteTokenizer`` is a self-contained byte-level fallback used by tests and
    tiny random models: ids 0-255 are raw bytes, 256+ are the Llama-3 special
    tokens. This is the testing seam the reference lacks (SURVEY.md §4): real
    tokenization behavior without a 2 MB fixture.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Protocol

from cake_tpu_torch.models.llama.chat import (
    BEGIN_OF_TEXT,
    END_HEADER,
    EOT,
    START_HEADER,
)

END_OF_TEXT = "<|end_of_text|>"

_BYTE_SPECIALS = {
    BEGIN_OF_TEXT: 256,
    START_HEADER: 257,
    END_HEADER: 258,
    EOT: 259,
    END_OF_TEXT: 260,
}
_BYTE_SPECIALS_INV = {v: k for k, v in _BYTE_SPECIALS.items()}
_SPECIAL_RE = re.compile(
    "(" + "|".join(re.escape(s) for s in _BYTE_SPECIALS) + ")"
)


class Tokenizer(Protocol):
    def encode(self, text: str) -> list[int]: ...

    def decode(self, ids: list[int]) -> str: ...

    @property
    def vocab_size(self) -> int: ...


class ByteTokenizer:
    """Byte-level tokenizer with Llama-3 special markers. Vocab: 512."""

    vocab_size = 512

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for part in _SPECIAL_RE.split(text):
            if not part:
                continue
            if part in _BYTE_SPECIALS:
                ids.append(_BYTE_SPECIALS[part])
            else:
                ids.extend(part.encode("utf-8"))
        return ids

    def decode(self, ids: list[int]) -> str:
        out: list[str] = []
        buf = bytearray()
        for i in ids:
            if i < 256:
                buf.append(i)
            else:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf.clear()
                out.append(_BYTE_SPECIALS_INV.get(i, ""))
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)


class HFTokenizer:
    """Wrapper over a HuggingFace ``tokenizer.json``."""

    def __init__(self, path: str | Path):
        from tokenizers import Tokenizer as _Tok

        self._tok = _Tok.from_file(str(path))

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


def load_tokenizer(model_dir: str | Path) -> Tokenizer:
    """``tokenizer.json`` if present (llama.rs:19-32), else the byte fallback."""
    path = Path(model_dir) / "tokenizer.json"
    if path.exists():
        return HFTokenizer(path)
    return ByteTokenizer()
