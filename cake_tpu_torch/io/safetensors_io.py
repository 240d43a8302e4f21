"""Safetensors checkpoints: a directory -> the port's stacked param tree.

Port of ``cake_tpu/io/safetensors_io.py`` for the dense families. The file
format (8-byte little-endian header length, JSON header, raw tensor bytes)
is read with numpy's memmap, so only the tensors asked for are touched; BF16
comes back as a uint16 view and becomes ``torch.bfloat16`` by ``.view``
(no ml_dtypes, no jax). HF's [out, in] linear weights are transposed to
[in, out]. ``load_params`` writes every layer straight into preallocated
stacked tensors on the target device and fuses the q/k/v and gate/up
projections as it goes (ops/fuse.py layout), so the weights are never held
twice.

MoE, Phi-3's fused checkpoint tensors and quantized (.q8/.q4) checkpoints
are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from cake_tpu_torch.models.llama.config import LlamaConfig

INDEX_FILE = "model.safetensors.index.json"
SINGLE_FILE = "model.safetensors"

# HF tensor-name templates for one decoder layer, keyed by the stacked-param
# name; True = a linear weight stored [out, in].
_LAYER_TEMPLATES: dict[str, tuple[str, bool]] = {
    "wq": ("model.layers.{i}.self_attn.q_proj.weight", True),
    "wk": ("model.layers.{i}.self_attn.k_proj.weight", True),
    "wv": ("model.layers.{i}.self_attn.v_proj.weight", True),
    "wo": ("model.layers.{i}.self_attn.o_proj.weight", True),
    "w_gate": ("model.layers.{i}.mlp.gate_proj.weight", True),
    "w_up": ("model.layers.{i}.mlp.up_proj.weight", True),
    "w_down": ("model.layers.{i}.mlp.down_proj.weight", True),
    "ln_attn": ("model.layers.{i}.input_layernorm.weight", False),
    "ln_mlp": ("model.layers.{i}.post_attention_layernorm.weight", False),
}
_LAYER_BIAS_TEMPLATES: dict[str, tuple[str, bool]] = {
    "bq": ("model.layers.{i}.self_attn.q_proj.bias", False),
    "bk": ("model.layers.{i}.self_attn.k_proj.bias", False),
    "bv": ("model.layers.{i}.self_attn.v_proj.bias", False),
}
_QK_NORM_TEMPLATES: dict[str, tuple[str, bool]] = {
    "q_norm": ("model.layers.{i}.self_attn.q_norm.weight", False),
    "k_norm": ("model.layers.{i}.self_attn.k_norm.weight", False),
}
# Gemma-2/3 four-norm layers: HF's post_attention_layernorm is a real
# post-attention norm there, and the pre-MLP norm is pre_feedforward_layernorm.
_GEMMA2_NORM_TEMPLATES: dict[str, tuple[str, bool]] = {
    "ln_mlp": ("model.layers.{i}.pre_feedforward_layernorm.weight", False),
    "ln_post_attn": ("model.layers.{i}.post_attention_layernorm.weight", False),
    "ln_post_mlp": ("model.layers.{i}.post_feedforward_layernorm.weight", False),
}
# Projections that load_params concatenates along the output axis.
_FUSED = {"wqkv": ("wq", "wk", "wv"), "bqkv": ("bq", "bk", "bv"), "w_gu": ("w_gate", "w_up")}

_NP_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
    "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}


class SafetensorsReader:
    """Lazy memmap reader over one or more safetensors files."""

    def __init__(self, paths: list[Path]):
        self._entries: dict[str, tuple[np.memmap, dict]] = {}
        for path in paths:
            with open(path, "rb") as f:
                header_len = int.from_bytes(f.read(8), "little")
                header = json.loads(f.read(header_len))
            mm = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + header_len)
            for name, meta in header.items():
                if name != "__metadata__":
                    self._entries[name] = (mm, meta)

    def names(self) -> Iterator[str]:
        return iter(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def st_dtype(self, name: str) -> str:
        return self._entries[name][1]["dtype"]

    def numpy(self, name: str) -> np.ndarray:
        """Raw view of a tensor (BF16 comes back as a uint16 view)."""
        mm, meta = self._entries[name]
        lo, hi = meta["data_offsets"]
        shape = tuple(meta["shape"])
        if meta["dtype"] == "BF16":
            return mm[lo:hi].view(np.uint16).reshape(shape)
        np_dtype = _NP_DTYPES.get(meta["dtype"])
        if np_dtype is None:
            raise ValueError(f"unsupported safetensors dtype {meta['dtype']!r}")
        return mm[lo:hi].view(np_dtype).reshape(shape)

    def torch(
        self, name: str, dtype: torch.dtype, device="cpu", transpose: bool = False
    ) -> torch.Tensor:
        """One tensor as ``dtype`` on ``device`` ([in, out] when transposed,
        laid out row-major: the fused norm-matmul kernel streams rows of W)."""
        arr = self.numpy(name)
        # Copy out of the read-only memmap; the cast happens on the device.
        if self.st_dtype(name) == "BF16":
            t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        t = t.to(device)
        if transpose:
            t = t.T.contiguous()
        return t.to(dtype)


def resolve_checkpoint_files(model_dir: str | Path) -> list[Path]:
    """Files from the index's weight_map, else the single-file fallback."""
    model_dir = Path(model_dir)
    index = model_dir / INDEX_FILE
    if index.exists():
        with open(index) as f:
            weight_map: dict[str, str] = json.load(f)["weight_map"]
        return [model_dir / fname for fname in sorted(set(weight_map.values()))]
    single = model_dir / SINGLE_FILE
    if single.exists():
        return [single]
    raise FileNotFoundError(f"no {INDEX_FILE} or {SINGLE_FILE} in {model_dir}")


def _layer_templates(reader: SafetensorsReader, config: LlamaConfig) -> dict:
    first = "model.layers.0."
    for name in reader.names():
        if name.startswith(first) and name.endswith((".q8", ".q4")):
            raise NotImplementedError(
                "quantized checkpoints are not ported yet (ROADMAP.md queue A, item 9)"
            )
    if config.num_local_experts or any(
        n.startswith(first) and (".experts." in n or "block_sparse_moe" in n)
        for n in reader.names()
    ):
        raise NotImplementedError("MoE checkpoints are not ported yet (ROADMAP.md queue A, item 9)")
    if "model.layers.0.self_attn.qkv_proj.weight" in reader:
        raise NotImplementedError(
            "Phi-3 fused checkpoint tensors are not ported yet (ROADMAP.md queue A, item 3)"
        )
    templates = dict(_LAYER_TEMPLATES)
    for key, entry in (*_LAYER_BIAS_TEMPLATES.items(), *_QK_NORM_TEMPLATES.items()):
        if entry[0].format(i=0) in reader:
            templates[key] = entry
    if _GEMMA2_NORM_TEMPLATES["ln_mlp"][0].format(i=0) in reader:
        templates.update(_GEMMA2_NORM_TEMPLATES)
    return templates


def load_params(
    model_dir: str | Path,
    config: LlamaConfig,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cpu",
) -> dict:
    """Load a full param tree onto ``device``, q/k/v and gate/up fused.

    Each stacked leaf is allocated once on the device and filled layer by
    layer, so peak device memory is the model plus one layer's tensor."""
    reader = SafetensorsReader(resolve_checkpoint_files(model_dir))
    templates = _layer_templates(reader, config)
    n = config.num_hidden_layers

    def parts(key: str) -> tuple[str, ...]:
        return tuple(p for p in _FUSED.get(key, (key,)) if p in templates)

    keys = [k for k in templates if not any(k in p for p in _FUSED.values())]
    keys += [fk for fk, ps in _FUSED.items() if ps[0] in templates]
    layers: dict[str, torch.Tensor] = {}
    for key in keys:
        for i in range(n):
            pieces = [
                reader.torch(templates[p][0].format(i=i), dtype, device, templates[p][1])
                for p in parts(key)
            ]
            t = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-1)
            if key not in layers:
                layers[key] = torch.empty((n, *t.shape), dtype=dtype, device=device)
            layers[key][i] = t
    if "ln_post_attn" in layers:
        if "q_norm" in layers:  # Gemma-3: per-layer window and rope plane
            if config.sliding_pattern is None:
                raise ValueError("gemma3 checkpoint needs sliding_pattern in the config")
            layers["win_flag"] = torch.tensor(config.sliding_pattern, device=device)
            layers["rope_sel"] = torch.tensor(
                config.sliding_pattern, dtype=torch.int32, device=device
            )
        else:  # Gemma-2: even layers local, odd global
            layers["win_flag"] = (torch.arange(n, device=device) % 2) == 0
    params = {
        "embed": reader.torch("model.embed_tokens.weight", dtype, device),
        "layers": layers,
        "ln_f": reader.torch("model.norm.weight", dtype, device),
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = reader.torch("lm_head.weight", dtype, device, transpose=True)
    return params


def hf_tensor_dict(params: dict, config: LlamaConfig, dtype=torch.float32) -> dict[str, np.ndarray]:
    """Flatten an unfused param tree into HF-named [out, in] numpy tensors
    (the inverse of load_params' name mapping). ``dtype`` is the storage
    dtype: float32, float16 or bfloat16."""
    if "wqkv" in params["layers"] or "router" in params["layers"]:
        raise ValueError("hf_tensor_dict takes an unfused dense param tree")

    def np_of(t: torch.Tensor, transpose: bool) -> np.ndarray:
        t = t.detach().to("cpu", dtype)
        if transpose:
            t = t.T
        t = t.contiguous()
        if dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy()
        return t.numpy().copy()

    tensors = {
        "model.embed_tokens.weight": np_of(params["embed"], False),
        "model.norm.weight": np_of(params["ln_f"], False),
    }
    if not config.tie_word_embeddings:
        tensors["lm_head.weight"] = np_of(params["lm_head"], True)
    templates = {**_LAYER_TEMPLATES, **_LAYER_BIAS_TEMPLATES, **_QK_NORM_TEMPLATES}
    layers = params["layers"]
    if "ln_post_attn" in layers:
        templates.update(_GEMMA2_NORM_TEMPLATES)
    for key, (tmpl, transpose) in templates.items():
        if key in layers:
            for i in range(layers[key].shape[0]):
                tensors[tmpl.format(i=i)] = np_of(layers[key][i], transpose)
    return tensors


_ST_DTYPES = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16", np.dtype(np.uint16): "BF16"}


def write_safetensors(path: Path, tensors: dict[str, np.ndarray]) -> int:
    """Write one .safetensors file (uint16 arrays are stored as BF16);
    returns the payload byte count."""
    header: dict[str, dict] = {}
    offset = 0
    for name, arr in tensors.items():
        header[name] = {
            "dtype": _ST_DTYPES[arr.dtype],
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + arr.nbytes],
        }
        offset += arr.nbytes
    header_bytes = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header_bytes)))
        f.write(header_bytes)
        for arr in tensors.values():
            f.write(np.ascontiguousarray(arr).tobytes())
    return offset


def save_tiny_checkpoint(
    model_dir: str | Path, params: dict, config: LlamaConfig, dtype=torch.float32
) -> None:
    """Write a param tree as a real safetensors checkpoint with its
    config.json and weight_map index (test and smoke fixture)."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    with open(model_dir / "config.json", "w") as f:
        json.dump(config.to_hf_dict(), f, indent=2)
    tensors = hf_tensor_dict(params, config, dtype)
    total = write_safetensors(model_dir / SINGLE_FILE, tensors)
    with open(model_dir / INDEX_FILE, "w") as f:
        json.dump(
            {"metadata": {"total_size": total},
             "weight_map": {name: SINGLE_FILE for name in tensors}},
            f, indent=2,
        )
