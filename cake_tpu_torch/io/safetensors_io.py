"""Safetensors checkpoints: a directory -> the port's stacked param tree.

Port of ``cake_tpu/io/safetensors_io.py``. The file
format (8-byte little-endian header length, JSON header, raw tensor bytes)
is read with numpy's memmap, so only the tensors asked for are touched; BF16
comes back as a uint16 view and becomes ``torch.bfloat16`` by ``.view``
(no ml_dtypes, no jax). HF's [out, in] linear weights are transposed to
[in, out]. ``load_params`` writes every layer straight into preallocated
stacked tensors on the target device and fuses the q/k/v and gate/up
projections as it goes (ops/fuse.py layout), so the weights are never held
twice.

Quantized checkpoints (written by ``cake_tpu/io/quantizer.py`` or by
:func:`save_tiny_checkpoint` over a ``quantize_params`` tree) store each
quantized linear weight as ``{name}.q8`` (int8 [in, out]) or ``{name}.q4``
(packed int4 [in/2, out]) beside ``{name}.scale`` (f32 [1|G, out]), in
compute orientation (no transpose). They load as the port's
``QuantWeight``/``Quant4Weight`` leaves, bitwise what ``quantize_params``
gives; the full-precision weights never exist.

MoE checkpoints (Mixtral's ``block_sparse_moe.*``, Qwen2/Qwen3-MoE's
``mlp.experts.*`` with Qwen2-MoE's shared expert; the layout is read from
the checkpoint) load the router [in, E] and each expert stack as one
[E, in, out] tensor a layer (int8 where the checkpoint stores it so); the
shared expert's gate|up fuses into ``sh_gu``. Phi-3's fused ``qkv_proj``
and ``gate_up_proj`` are already the fused layout once transposed: they
load as ``wqkv`` and ``w_gu`` after a check of their widths against the
config, bitwise the JAX package's split fused again.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.ops.fuse import concat_out
from cake_tpu_torch.ops.quant import QUANT_TYPES, Quant4Weight, QuantWeight

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
# MoE layers: a router and per-expert SwiGLU weights in place of the dense
# MLP, stacked [E, in, out] at load; Qwen2-MoE adds an always-on shared
# expert with a sigmoid gate (Qwen3-MoE has the same names, no shared one).
_MOE_LAYOUTS: dict[str, dict] = {
    "mixtral": {
        "router": "model.layers.{i}.block_sparse_moe.gate.weight",
        "experts": {
            "w_gate": "model.layers.{i}.block_sparse_moe.experts.{e}.w1.weight",
            "w_up": "model.layers.{i}.block_sparse_moe.experts.{e}.w3.weight",
            "w_down": "model.layers.{i}.block_sparse_moe.experts.{e}.w2.weight",
        },
        "shared": {},
    },
    "qwen2_moe": {
        "router": "model.layers.{i}.mlp.gate.weight",
        "experts": {
            "w_gate": "model.layers.{i}.mlp.experts.{e}.gate_proj.weight",
            "w_up": "model.layers.{i}.mlp.experts.{e}.up_proj.weight",
            "w_down": "model.layers.{i}.mlp.experts.{e}.down_proj.weight",
        },
        "shared": {
            "sh_gate": "model.layers.{i}.mlp.shared_expert.gate_proj.weight",
            "sh_up": "model.layers.{i}.mlp.shared_expert.up_proj.weight",
            "sh_down": "model.layers.{i}.mlp.shared_expert.down_proj.weight",
            "se_gate": "model.layers.{i}.mlp.shared_expert_gate.weight",
        },
    },
}
# Phi-3's fused projections, [out, in] like every HF linear weight.
_PHI3_FUSED = {
    "wqkv": "model.layers.{i}.self_attn.qkv_proj.weight",
    "w_gu": "model.layers.{i}.mlp.gate_up_proj.weight",
}
# Projections that load_params concatenates along the output axis.
_FUSED = {
    "wqkv": ("wq", "wk", "wv"), "bqkv": ("bq", "bk", "bv"), "w_gu": ("w_gate", "w_up"),
    "sh_gu": ("sh_gate", "sh_up"),
}

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


_QUANT_SUFFIXES = ((".q4", Quant4Weight), (".q8", QuantWeight))


def read_weight(
    reader: SafetensorsReader, name: str, dtype: torch.dtype, device="cpu",
    transpose: bool = False,
):
    """One weight by HF name: a plain tensor, or the quantized leaf stored
    under ``{name}.q4``/``{name}.q8`` + ``{name}.scale`` (no transpose, no
    cast: the bits as written)."""
    for suffix, cls in _QUANT_SUFFIXES:
        if name + suffix in reader:
            return cls(
                reader.torch(name + suffix, torch.int8, device),
                reader.torch(name + ".scale", torch.float32, device),
            )
    return reader.torch(name, dtype, device, transpose)


def _empty_like_stacked(n: int, t, device):
    """An [n, ...] stack to fill layer by layer, plain or quantized."""
    if isinstance(t, QUANT_TYPES):
        return type(t)(
            torch.empty((n, *t.w.shape), dtype=t.w.dtype, device=device),
            torch.empty((n, *t.scale.shape), dtype=t.scale.dtype, device=device),
        )
    return torch.empty((n, *t.shape), dtype=t.dtype, device=device)


def _set_layer(stack, i: int, t) -> None:
    if isinstance(stack, QUANT_TYPES):
        if type(t) is not type(stack):
            raise ValueError(f"layer {i} is stored as {type(t).__name__}, layer 0 as "
                             f"{type(stack).__name__}")
        stack.w[i] = t.w
        stack.scale[i] = t.scale
    else:
        if isinstance(t, QUANT_TYPES):
            raise ValueError(f"layer {i} is quantized, layer 0 is not")
        stack[i] = t


def _has_tensor(reader: SafetensorsReader, name: str) -> bool:
    """Present plain or quantized (``.q8``/``.q4``)."""
    return any(name + suffix in reader for suffix in ("", ".q8", ".q4"))


def _layer_templates(reader: SafetensorsReader, config: LlamaConfig, lo: int) -> dict:
    """The per-layer tensors of layers from ``lo``: stacked-param name ->
    (HF template, transposed). MoE expert templates carry ``{e}``."""
    templates = dict(_LAYER_TEMPLATES)
    for key, entry in (*_LAYER_BIAS_TEMPLATES.items(), *_QK_NORM_TEMPLATES.items()):
        if entry[0].format(i=lo) in reader:
            templates[key] = entry
    if _GEMMA2_NORM_TEMPLATES["ln_mlp"][0].format(i=lo) in reader:
        templates.update(_GEMMA2_NORM_TEMPLATES)
    layout = next((lay for lay in _MOE_LAYOUTS.values() if lay["router"].format(i=lo) in reader),
                  None)
    if layout is None and config.num_local_experts:
        raise ValueError(f"the config has {config.num_local_experts} experts a layer but the "
                         f"checkpoint has no router for layer {lo}")
    if layout is not None:
        for key, tmpl in layout["experts"].items():
            templates[key] = (tmpl, True)
        templates["router"] = (layout["router"], True)
        # The config decides whether the shared expert exists (0: none); a
        # config that does not say trusts the checkpoint.
        se = config.shared_expert_intermediate_size
        for key, tmpl in layout["shared"].items():
            if se == 0 or (se is None and not _has_tensor(reader, tmpl.format(i=lo))):
                continue
            templates[key] = (tmpl, True)
    if _has_tensor(reader, _PHI3_FUSED["wqkv"].format(i=lo)):
        for key in ("wq", "wk", "wv", "w_gate", "w_up"):
            del templates[key]
        templates.update({key: (tmpl, True) for key, tmpl in _PHI3_FUSED.items()})
    return templates


def _phi3_check(key: str, t, i: int, config: LlamaConfig) -> None:
    """Phi-3's fused widths against the config's geometry."""
    width = (t.w if isinstance(t, QUANT_TYPES) else t).shape[-1]
    hd = config.head_dim
    if key == "wqkv":
        want = (config.num_attention_heads + 2 * config.num_key_value_heads) * hd
        if width != want:
            raise ValueError(
                f"layer {i}: fused qkv width {width} does not match the config's geometry "
                f"q={config.num_attention_heads * hd} + 2*kv={2 * config.num_key_value_heads * hd}"
                " (config.json and checkpoint disagree)")
    elif width % 2:
        raise ValueError(f"layer {i}: fused gate_up width {width} is odd")


def _read_layer_leaf(reader, key, templates, parts, i, n_experts, dtype, device, config):
    """Layer i's tensor for ``key``: fused from its parts, an expert stack
    [E, ...], or a single weight."""
    pieces = []
    for p in parts:
        tmpl, transpose = templates[p]
        if "{e}" in tmpl:
            experts = [read_weight(reader, tmpl.format(i=i, e=e), dtype, device, transpose)
                       for e in range(n_experts)]
            if isinstance(experts[0], QUANT_TYPES):
                pieces.append(type(experts[0])(torch.stack([x.w for x in experts]),
                                               torch.stack([x.scale for x in experts])))
            else:
                pieces.append(torch.stack(experts))
        else:
            pieces.append(read_weight(reader, tmpl.format(i=i), dtype, device, transpose))
    t = pieces[0] if len(pieces) == 1 else concat_out(pieces)
    if parts == (key,) and key in _PHI3_FUSED:
        _phi3_check(key, t, i, config)
    return t


def _load_layers(reader: SafetensorsReader, config: LlamaConfig, dtype: torch.dtype, device,
                 lo: int, hi: int) -> dict:
    """Layers [lo, hi) as stacked leaves (index 0 = layer ``lo``)."""
    templates = _layer_templates(reader, config, lo)
    n = hi - lo
    n_experts = 0
    if "router" in templates:
        while _has_tensor(reader, templates["w_gate"][0].format(i=lo, e=n_experts)):
            n_experts += 1
    # Stacked-param name -> the templates it is read from (several: fused
    # along the output axis). Expert stacks keep gate and up apart.
    plan: dict[str, tuple[str, ...]] = {}
    for fk, ps in _FUSED.items():
        if fk not in templates and ps[0] in templates and not (
                fk == "w_gu" and "router" in templates):
            plan[fk] = tuple(p for p in ps if p in templates)
    fused_parts = {p for ps in plan.values() for p in ps}
    plan.update({k: (k,) for k in templates if k not in fused_parts})
    layers: dict = {}
    for key, parts in plan.items():
        for i in range(lo, hi):
            t = _read_layer_leaf(reader, key, templates, parts, i, n_experts, dtype, device,
                                 config)
            if key not in layers:
                layers[key] = _empty_like_stacked(n, t, device)
            _set_layer(layers[key], i - lo, t)
    if "ln_post_attn" in layers:
        if "q_norm" in layers:  # Gemma-3: per-layer window and rope plane
            if config.sliding_pattern is None:
                raise ValueError("gemma3 checkpoint needs sliding_pattern in the config")
            pattern = list(config.sliding_pattern)[lo:hi]
            layers["win_flag"] = torch.tensor(pattern, device=device)
            layers["rope_sel"] = torch.tensor(pattern, dtype=torch.int32, device=device)
        else:  # Gemma-2: even layers local, odd global
            layers["win_flag"] = (torch.arange(lo, hi, device=device) % 2) == 0
    return layers


def _load_head(reader: SafetensorsReader, config: LlamaConfig, dtype: torch.dtype,
               device) -> dict:
    head = {
        "embed": reader.torch("model.embed_tokens.weight", dtype, device),
        "ln_f": reader.torch("model.norm.weight", dtype, device),
    }
    if not config.tie_word_embeddings:
        head["lm_head"] = read_weight(reader, "lm_head.weight", dtype, device, transpose=True)
    return head


def load_params(
    model_dir: str | Path,
    config: LlamaConfig,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cpu",
    layer_range: tuple[int, int] | None = None,
    head: bool = True,
) -> dict:
    """Load a param tree onto ``device``, q/k/v and gate/up fused.

    ``layer_range`` (lo, hi) loads only layers [lo, hi), stacked from index 0
    (a TCP worker's or a master's own ranges, runtime/worker.py); ``head``
    False leaves out the embedding, the final norm and the LM head. Each
    stacked leaf is allocated once on the device and filled layer by layer,
    so peak device memory is the weights asked for plus one layer's tensor.
    Quantized weights load as quantized leaves (fused component-wise)."""
    reader = SafetensorsReader(resolve_checkpoint_files(model_dir))
    lo, hi = layer_range if layer_range is not None else (0, config.num_hidden_layers)
    if not 0 <= lo < hi <= config.num_hidden_layers:
        raise ValueError(f"layer_range {layer_range} outside [0, {config.num_hidden_layers})")
    params = _load_head(reader, config, dtype, device) if head else {}
    params["layers"] = _load_layers(reader, config, dtype, device, lo, hi)
    return params


def load_head(
    model_dir: str | Path,
    config: LlamaConfig,
    dtype: torch.dtype = torch.bfloat16,
    device: torch.device | str = "cpu",
) -> dict:
    """The embedding, final norm and LM head only (``lm_head`` quantized
    where the checkpoint stores it so): what a TCP master needs besides its
    own ranges (runtime/master.py)."""
    reader = SafetensorsReader(resolve_checkpoint_files(model_dir))
    return _load_head(reader, config, dtype, device)


def hf_tensor_dict(params: dict, config: LlamaConfig, dtype=torch.float32) -> dict[str, np.ndarray]:
    """Flatten an unfused param tree into HF-named [out, in] numpy tensors
    (the inverse of load_params' name mapping). ``dtype`` is the storage
    dtype of plain tensors: float32, float16 or bfloat16. A quantized leaf
    is stored as ``{name}.q8``/``{name}.q4`` and ``{name}.scale``, in
    compute orientation, its bits unchanged. MoE trees write their family's
    expert names (Mixtral's, or Qwen2/Qwen3-MoE's), one tensor an expert; a
    Phi-3 config writes the fused ``qkv_proj`` and ``gate_up_proj`` that
    Phi-3 checkpoints carry."""
    layers = params["layers"]
    if "wqkv" in layers:
        raise ValueError("hf_tensor_dict takes an unfused param tree")

    def np_of(t: torch.Tensor, transpose: bool) -> np.ndarray:
        t = t.detach().to("cpu", dtype)
        if transpose:
            t = t.T
        t = t.contiguous()
        if dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy()
        return t.numpy().copy()

    def emit(name: str, leaf, transpose: bool) -> None:
        if isinstance(leaf, QUANT_TYPES):
            suffix = ".q4" if isinstance(leaf, Quant4Weight) else ".q8"
            tensors[name + suffix] = leaf.w.detach().to("cpu").contiguous().numpy().copy()
            tensors[name + ".scale"] = leaf.scale.detach().to("cpu", torch.float32).numpy().copy()
        else:
            tensors[name] = np_of(leaf, transpose)

    tensors: dict[str, np.ndarray] = {
        "model.embed_tokens.weight": np_of(params["embed"], False),
        "model.norm.weight": np_of(params["ln_f"], False),
    }
    if not config.tie_word_embeddings:
        emit("lm_head.weight", params["lm_head"], True)
    templates = {**_LAYER_TEMPLATES, **_LAYER_BIAS_TEMPLATES, **_QK_NORM_TEMPLATES}
    if "ln_post_attn" in layers:
        templates.update(_GEMMA2_NORM_TEMPLATES)
    n = config.num_hidden_layers
    if "router" in layers:
        layout = _MOE_LAYOUTS[
            "qwen2_moe" if config.model_type in ("qwen2_moe", "qwen3_moe") else "mixtral"]
        for key, tmpl in layout["experts"].items():
            del templates[key]
            for i in range(n):
                stack = layers[key][i]
                n_e = (stack.w if isinstance(stack, QUANT_TYPES) else stack).shape[0]
                for e in range(n_e):
                    emit(tmpl.format(i=i, e=e), stack[e], True)
        templates.update({k: (t, True) for k, t in layout["shared"].items()})
        templates["router"] = (layout["router"], True)
    if config.model_type == "phi3":
        for key, parts in (("wqkv", ("wq", "wk", "wv")), ("w_gu", ("w_gate", "w_up"))):
            for i in range(n):
                emit(_PHI3_FUSED[key].format(i=i), concat_out([layers[p][i] for p in parts]),
                     True)
            for p in parts:
                del templates[p]
    for key, (tmpl, transpose) in templates.items():
        if key in layers:
            for i in range(n):
                emit(tmpl.format(i=i), layers[key][i], transpose)
    return tensors


_ST_DTYPES = {
    np.dtype(np.float32): "F32", np.dtype(np.float16): "F16", np.dtype(np.uint16): "BF16",
    np.dtype(np.int8): "I8",
}


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
    """Write an unfused param tree, plain or quantized (``quantize_params``),
    dense, MoE or Phi-3 (``hf_tensor_dict``'s names), as a real safetensors
    checkpoint with its config.json and weight_map index (test and smoke
    fixture)."""
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
