"""Chat message types and the chat templates (the port's own copy of
``cake_tpu/models/llama/chat.py``).

Covers the reference's chat layer: ``MessageRole``/``Message``
(cake-core/src/models/chat.rs:4-63) and the ``History`` prompt encoder
(cake-core/src/models/llama3/history.rs:8-33), which renders

    <|begin_of_text|>
    <|start_header_id|>{role}<|end_header_id|>\n\n{content}<|eot_id|>   (per message)
    <|start_header_id|>assistant<|end_header_id|>\n\n                  (trailer)

The template is produced as TEXT with special-token markers; tokenizers encode the
markers as single special tokens (see tokenizer.py), matching Meta's reference
encoding that history.rs hand-ports.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from enum import Enum

logger = logging.getLogger(__name__)

BEGIN_OF_TEXT = "<|begin_of_text|>"
START_HEADER = "<|start_header_id|>"
END_HEADER = "<|end_header_id|>"
EOT = "<|eot_id|>"


class MessageRole(str, Enum):
    SYSTEM = "system"
    USER = "user"
    ASSISTANT = "assistant"


@dataclasses.dataclass
class Message:
    role: MessageRole
    content: str

    @classmethod
    def system(cls, content: str) -> "Message":
        return cls(MessageRole.SYSTEM, content)

    @classmethod
    def user(cls, content: str) -> "Message":
        return cls(MessageRole.USER, content)

    @classmethod
    def assistant(cls, content: str) -> "Message":
        return cls(MessageRole.ASSISTANT, content)

    def to_dict(self) -> dict[str, str]:
        return {"role": self.role.value, "content": self.content}

    @classmethod
    def from_dict(cls, d: dict[str, str]) -> "Message":
        return cls(MessageRole(d["role"]), d["content"])


def encode_header(role: str) -> str:
    return f"{START_HEADER}{role}{END_HEADER}\n\n"


def encode_message(msg: Message) -> str:
    # history.rs:14-20: header, stripped content, eot.
    return f"{encode_header(msg.role.value)}{msg.content.strip()}{EOT}"


def encode_dialog_to_prompt(messages: list[Message]) -> str:
    """Full dialog template with the trailing assistant header (history.rs:22-33)."""
    parts = [BEGIN_OF_TEXT]
    parts.extend(encode_message(m) for m in messages)
    parts.append(encode_header(MessageRole.ASSISTANT.value))
    return "".join(parts)


QWEN2_DEFAULT_SYSTEM = "You are a helpful assistant."

_warned_qwen2_default = False
_warn_lock = threading.Lock()


def _warn_qwen2_default_system_once() -> None:
    # Qwen2.5 shares model_type "qwen2" but brands a different default system
    # prompt; surface the silent divergence once per process so users of 2.5
    # checkpoints know to pass an explicit system message. Lock-guarded:
    # concurrent serving threads race the flag otherwise.
    global _warned_qwen2_default
    with _warn_lock:
        if _warned_qwen2_default:
            return
        _warned_qwen2_default = True
        logger.warning(
            "chatml template: injecting the Qwen2 default system prompt "
            "(%r); Qwen2.5 checkpoints brand a different default — pass an "
            "explicit system message for exact parity",
            QWEN2_DEFAULT_SYSTEM,
        )


def encode_dialog_chatml(messages: list[Message]) -> str:
    """Qwen2-family ChatML template with the trailing assistant header:

        <|im_start|>{role}\\n{content}<|im_end|>\\n   (per message)
        <|im_start|>assistant\\n                      (trailer)

    Matches Qwen2's tokenizer_config chat template (no BOS; <|im_end|> is the
    eos/stop token), including its default system prompt when the dialog does
    not begin with a system message. Caveat: Qwen2.5 checkpoints share
    model_type "qwen2" but brand their default system prompt ("You are
    Qwen, ...") — config.json cannot distinguish them, so systemless Qwen2.5
    dialogs get the Qwen2 default; pass an explicit system message (or ship
    the branded text in it) for exact Qwen2.5 template parity.
    """
    parts = []
    if not messages or messages[0].role is not MessageRole.SYSTEM:
        _warn_qwen2_default_system_once()
        parts.append(
            f"<|im_start|>system\n{QWEN2_DEFAULT_SYSTEM}<|im_end|>\n"
        )
    parts.extend(
        f"<|im_start|>{m.role.value}\n{m.content.strip()}<|im_end|>\n"
        for m in messages
    )
    parts.append("<|im_start|>assistant\n")
    return "".join(parts)


def encode_dialog_chatml_no_default_system(messages: list[Message]) -> str:
    """Qwen3's ChatML: identical turn structure but NO default system prompt
    (Qwen3's tokenizer_config template omits it; a systemless dialog starts
    straight at the first user turn). Thinking-mode tags are a sampling-time
    concern, not a template one — the base template emits none."""
    parts = [
        f"<|im_start|>{m.role.value}\n{m.content.strip()}<|im_end|>\n"
        for m in messages
    ]
    parts.append("<|im_start|>assistant\n")
    return "".join(parts)


def encode_dialog_mistral(messages: list[Message]) -> str:
    """Mistral instruct template:

        <s>[INST] {user} [/INST]{assistant}</s>[INST] {user2} [/INST]

    A leading system message is folded into the first user turn separated by
    a blank line (Mistral's reference template has no system role); a
    system-only dialog renders as a single instruction turn. A system message
    arriving after the first user turn would have to rewrite already-rendered
    history, so it is rejected.
    """
    system = ""
    turns: list[list] = []  # [user_text, assistant_text | None]
    for m in messages:
        if m.role is MessageRole.SYSTEM:
            if turns:
                raise ValueError(
                    "mistral template cannot place a system message after "
                    "the first user turn (no system role in the template)"
                )
            system = m.content.strip()
        elif m.role is MessageRole.USER:
            turns.append([m.content.strip(), None])
        else:
            if not turns:
                turns.append(["", None])
            turns[-1][1] = m.content.strip()
    if not turns and system:
        turns.append(["", None])  # system-only dialog: one instruction turn
    parts = ["<s>"]
    for i, (user, assistant) in enumerate(turns):
        if i == 0 and system:
            user = f"{system}\n\n{user}" if user else system
        parts.append(f"[INST] {user} [/INST]")
        if assistant is not None:
            parts.append(f"{assistant}</s>")
    return "".join(parts)


def encode_dialog_llama2(messages: list[Message]) -> str:
    """Llama-2-chat template (for Llama-2 checkpoints, whose config.json is
    indistinguishable from base Llama — select with ``--chat-template
    llama2``):

        <s>[INST] <<SYS>>\\n{system}\\n<</SYS>>\\n\\n{user} [/INST] {a} </s>...

    Same turn structure as Mistral with the <<SYS>> system block.
    """
    system = None
    turns: list[list] = []
    for m in messages:
        if m.role is MessageRole.SYSTEM:
            if turns:
                raise ValueError(
                    "llama2 template cannot place a system message after "
                    "the first user turn"
                )
            system = m.content.strip()
        elif m.role is MessageRole.USER:
            turns.append([m.content.strip(), None])
        else:
            if not turns:
                turns.append(["", None])
            turns[-1][1] = m.content.strip()
    if not turns and system is not None:
        turns.append(["", None])
    parts = []
    for i, (user, assistant) in enumerate(turns):
        if i == 0 and system is not None:
            user = f"<<SYS>>\n{system}\n<</SYS>>\n\n{user}"
        parts.append(f"<s>[INST] {user} [/INST]")
        if assistant is not None:
            parts.append(f" {assistant} </s>")
    return "".join(parts)


def encode_dialog_gemma(messages: list[Message]) -> str:
    """Gemma-family template:

        <bos><start_of_turn>{user|model}\\n{content}<end_of_turn>\\n ...
        <start_of_turn>model\\n                                (trailer)

    The assistant role is "model". HF's Gemma template REJECTS system
    messages; here a leading system message folds into the first user turn
    (friendlier for the OpenAI-style API; a mid-dialog system is an error).
    """
    system = ""
    parts = ["<bos>"]
    first_user_done = False
    for m in messages:
        if m.role is MessageRole.SYSTEM:
            if first_user_done:
                raise ValueError(
                    "gemma template cannot place a system message after "
                    "the first user turn"
                )
            system = m.content.strip()
            continue
        role = "model" if m.role is MessageRole.ASSISTANT else "user"
        content = m.content.strip()
        if role == "user" and not first_user_done:
            if system:
                content = f"{system}\n\n{content}"
            first_user_done = True
        parts.append(f"<start_of_turn>{role}\n{content}<end_of_turn>\n")
    if system and not first_user_done:
        parts.append(f"<start_of_turn>user\n{system}<end_of_turn>\n")
    parts.append("<start_of_turn>model\n")
    return "".join(parts)


def encode_dialog_phi3(messages: list[Message]) -> str:
    """Phi-3 template:

        <|system|>\n{sys}<|end|>\n<|user|>\n{u}<|end|>\n<|assistant|>\n...
    """
    parts = [
        f"<|{m.role.value}|>\n{m.content.strip()}<|end|>\n" for m in messages
    ]
    parts.append("<|assistant|>\n")
    return "".join(parts)


# Template key -> dialog encoder. The generator picks by
# config.dialog_template (the model family, or the --chat-template override);
# the Llama-3 encoder is the reference-parity surface (history.rs), the
# others are the family extensions.
DIALOG_ENCODERS = {
    "llama": encode_dialog_to_prompt,
    "llama3": encode_dialog_to_prompt,
    "llama2": encode_dialog_llama2,
    "qwen2": encode_dialog_chatml,
    "qwen2_moe": encode_dialog_chatml,
    "qwen3": encode_dialog_chatml_no_default_system,
    "qwen3_moe": encode_dialog_chatml_no_default_system,
    "chatml": encode_dialog_chatml,
    "mistral": encode_dialog_mistral,
    "mixtral": encode_dialog_mistral,  # Mixtral-Instruct uses the same template
    "gemma": encode_dialog_gemma,
    "gemma2": encode_dialog_gemma,
    "gemma3_text": encode_dialog_gemma,
    "phi3": encode_dialog_phi3,
}


def encode_dialog(messages: list[Message], model_type: str = "llama") -> str:
    try:
        enc = DIALOG_ENCODERS[model_type]
    except KeyError:
        raise ValueError(f"no chat template for model_type {model_type!r}")
    return enc(messages)
