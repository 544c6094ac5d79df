"""Weights: HF checkpoints and the reference's parameter tree as the port's
tensors.

``load_hf_weights`` reads a HF Llama/Qwen2 checkpoint directory (every
``*.safetensors`` in it, in sorted order, so sharded checkpoints load;
``engine/safetensors_lite.py`` reads them) into the stacked ``[L, ...]``
tree of ``model.param_shapes``, as ``dynamo_tpu.engine.weights`` does:
projections transposed from HF's ``[out, in]`` to ``[in, out]``, Qwen2's
q/k/v biases, ``lm_head`` only when the embeddings are not tied, and every
dtype converted to bf16 by round-to-nearest-even (``ml_dtypes``' rounding
in the reference), so the leaves are the reference's bits. It fills
preallocated device tensors one HF tensor at a time: the file's bytes go
to the device as they are, and the conversion and transpose run there, so
device memory peaks about one tensor above the final tree and host memory
holds no copy of the checkpoint. With ``spec.quant == "int8"`` each
quantized leaf is quantized as soon as it is loaded (``quant.py``), so the
bf16 tree never exists whole.

``load_lora_weights`` reads a HF PEFT LoRA adapter directory into the
host stacks the adapter store uploads, bit-equal to the reference's
loader.

``params_from_jax`` takes the tree that ``dynamo_tpu.engine.model
.init_params`` (or the JAX ``quantize_params``) builds, as numpy arrays
(the caller converts with ``np.asarray``; this module never imports JAX),
and returns the same tree of torch tensors on ``device``.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import ModelSpec
from dynamo_tpu_torch.engine.model import param_shapes
from dynamo_tpu_torch.engine.quant import (QUANT_LAYER_KEYS, QTensor,
                                           quantize_embedding,
                                           quantize_weight)
from dynamo_tpu_torch.engine.safetensors_lite import SafeOpen
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("weights")

# Layer leaf -> (HF name inside "model.layers.{i}.", transposed).
HF_LAYER_NAMES = {
    "input_norm": ("input_layernorm.weight", False),
    "post_attn_norm": ("post_attention_layernorm.weight", False),
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "w_gate": ("mlp.gate_proj.weight", True),
    "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
    "bq": ("self_attn.q_proj.bias", False),
    "bk": ("self_attn.k_proj.bias", False),
    "bv": ("self_attn.v_proj.bias", False),
}
_WANTED_PREFIXES = ("model.", "lm_head.")


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device is cuda but no GPU is available")
    return device


def load_hf_weights(spec: ModelSpec, model_dir: str,
                    device: str | torch.device = "cuda") -> dict:
    """Load ``model_dir``'s safetensors into the param tree on ``device``
    (bf16; int8 QTensor leaves with ``spec.quant == "int8"``). Raises,
    naming what is missing, on a missing tensor, a wrong shape or an
    unsupported dtype; nothing is left random."""
    if spec.num_experts:
        raise NotImplementedError(
            f"{model_dir}: MoE checkpoints (num_local_experts="
            f"{spec.num_experts}) are not ported yet: they wait for ROADMAP "
            f"item 14 (MoE)")
    if spec.quant not in (None, "int8"):
        raise ValueError(f"weight quantization {spec.quant!r} is not "
                         f"supported (None or 'int8')")
    device = _device(device)
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors under {model_dir}")
    quant = spec.quant == "int8"
    with contextlib.ExitStack() as stack:
        # HF name -> the open file holding it; a later file's tensor of the
        # same name wins, as in the reference's dict.
        where: dict[str, SafeOpen] = {}
        for path in files:
            fh = stack.enter_context(SafeOpen(path))
            for name in fh.keys():
                if name.startswith(_WANTED_PREFIXES):
                    where[name] = fh

        def read(name: str, shape: tuple, transposed: bool) -> torch.Tensor:
            """One HF tensor as bf16 on the device, [in, out] if
            ``transposed``."""
            if name not in where:
                raise KeyError(f"{model_dir}: missing tensor {name}")
            hf_shape = tuple(reversed(shape)) if transposed else tuple(shape)
            if where[name].shape_of(name) != hf_shape:
                raise ValueError(f"{model_dir}: tensor {name} has shape "
                                 f"{list(where[name].shape_of(name))}, "
                                 f"expected {list(hf_shape)} for "
                                 f"{spec.name}")
            src = where[name].get_tensor(name)
            # The raw bytes go over as they are (a copy, even on the CPU:
            # nothing returned may still view the mapped file); the dtype
            # conversion and the transpose run on the device.
            t = src.to(device, copy=True).to(torch.bfloat16)
            return t.t() if transposed else t

        shapes = param_shapes(spec, quantized=False)
        layers = {}
        for key, shape in shapes["layers"].items():
            hf_name, transposed = HF_LAYER_NAMES[key]
            qkey = quant and key in QUANT_LAYER_KEYS
            if qkey:
                dst = QTensor(
                    torch.empty(shape, dtype=torch.int8, device=device),
                    torch.empty((shape[0], 1, shape[-1]),
                                dtype=torch.float32, device=device))
            else:
                dst = torch.empty(shape, dtype=torch.bfloat16, device=device)
            for i in range(spec.num_layers):
                t = read(f"model.layers.{i}.{hf_name}", shape[1:],
                         transposed)
                if qkey:
                    dst.q[i], dst.s[i] = quantize_weight(t)
                else:
                    dst[i].copy_(t)
                del t
            layers[key] = dst
        params = {"embed": read("model.embed_tokens.weight", shapes["embed"],
                                False),
                  "final_norm": read("model.norm.weight",
                                     shapes["final_norm"], False),
                  "layers": layers}
        if quant:
            params["embed"] = quantize_embedding(params["embed"])
        if not spec.tie_word_embeddings:
            head = read("lm_head.weight", shapes["lm_head"], True)
            params["lm_head"] = (quantize_weight(head) if quant
                                 else head.contiguous())
            del head
    log.info("loaded %d tensors from %s (%d files)", len(where), model_dir,
             len(files))
    return params


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.array(arr, order="C")  # a writable copy torch may own
    if arr.dtype.name == "bfloat16":
        # numpy has no native bf16: reinterpret the 2-byte payload.
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return t.to(device)


def _is_qtensor(leaf) -> bool:
    """A (q, s) pair: the reference's QTensor NamedTuple or the port's."""
    return getattr(leaf, "_fields", None) == ("q", "s")


def params_from_jax(np_params: dict, spec: ModelSpec,
                    device: str | torch.device = "cuda") -> dict:
    """Convert the reference's param tree (numpy leaves; int8 weights as
    QTensor (q, s) pairs) to the port's tensors, checking every leaf
    against ``param_shapes``: bf16 leaves, int8 q and float32 s."""
    device = _device(device)
    shapes = param_shapes(spec, quantized=_is_qtensor(np_params.get("embed")))

    def check(arr, shape, key):
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"param {key}: shape {arr.shape} != {shape}")

    def convert(tree: dict, want: dict) -> dict:
        if set(tree) != set(want):
            raise ValueError(f"param keys {sorted(tree)} != "
                             f"{sorted(want)} for {spec.name}")
        out = {}
        for key, shape in want.items():
            if isinstance(shape, dict):
                out[key] = convert(tree[key], shape)
            elif isinstance(shape, QTensor):
                if not _is_qtensor(tree[key]):
                    raise ValueError(f"param {key}: expected an int8 "
                                     f"(q, s) pair")
                q, s = (np.asarray(a) for a in tree[key])
                check(q, shape.q, key + ".q")
                check(s, shape.s, key + ".s")
                if q.dtype != np.int8 or s.dtype != np.float32:
                    raise ValueError(f"param {key}: q {q.dtype} and s "
                                     f"{s.dtype}, expected int8 and float32")
                out[key] = QTensor(torch.from_numpy(q.copy()).to(device),
                                   torch.from_numpy(s.copy()).to(device))
            else:
                arr = np.asarray(tree[key])
                check(arr, shape, key)
                out[key] = _to_tensor(arr, device)
        return out

    return convert(np_params, shapes)


# HF PEFT module suffix -> the stacked projection key it targets.
LORA_PROJ_OF = {"q_proj": "wq", "k_proj": "wk", "v_proj": "wv",
                "o_proj": "wo", "gate_proj": "w_gate", "up_proj": "w_up",
                "down_proj": "w_down"}


def load_lora_weights(spec: ModelSpec, adapter_dir: str, max_rank: int
                      ) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """A HF PEFT LoRA checkpoint as ``{key: (A [L, d_in, max_rank],
    B [L, max_rank, d_out])}`` bf16 host tensors over the projections it
    targets (the reference's ``load_lora_weights``).

    Reads ``adapter_config.json`` (``r``, ``lora_alpha``) and every
    ``*.safetensors`` of ``adapter_dir``. PEFT stores ``lora_A.weight`` as
    [r, in] and ``lora_B.weight`` as [out, r]; these are the transposes,
    with the ``lora_alpha / r`` scale folded into B in float32 before the
    bf16 rounding, so serving pays no extra multiply. Ranks below
    ``max_rank`` are zero-padded (padded columns contribute exact zeros);
    a rank above it raises. Layers a checkpoint does not cover stay zero."""
    with open(os.path.join(adapter_dir, "adapter_config.json")) as fh:
        cfg = json.load(fh)
    rank = int(cfg.get("r", 8))
    alpha = float(cfg.get("lora_alpha", rank))
    if rank > max_rank:
        raise ValueError(
            f"adapter rank {rank} exceeds lora_max_rank {max_rank} "
            f"({adapter_dir}); raise --max-lora-rank or re-train smaller")
    scale = alpha / max(1, rank)
    files = sorted(glob.glob(os.path.join(adapter_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors under {adapter_dir}")
    L = spec.num_layers
    found: dict[str, dict[int, list]] = {}
    for path in files:
        with SafeOpen(path) as fh:
            for name in fh.keys():
                # base_model.model.model.layers.{i}.self_attn.q_proj
                # .lora_A.weight
                parts = name.split(".")
                if "layers" not in parts or parts[-1] != "weight":
                    continue
                li = int(parts[parts.index("layers") + 1])
                key = LORA_PROJ_OF.get(parts[-3])
                kind = parts[-2]
                if key is None or kind not in ("lora_A", "lora_B") \
                        or li >= L:
                    continue
                # float32 on the host (exact from bf16/f16/f32), a copy
                # that outlives the mapping.
                arr = fh.get_tensor(name).float().numpy().copy()
                pair = found.setdefault(key, {}).setdefault(li, [None, None])
                pair[0 if kind == "lora_A" else 1] = arr
    if not found:
        raise ValueError(
            f"{adapter_dir}: no LoRA tensors matched the target "
            f"projections {sorted(LORA_PROJ_OF.values())}")
    out = {}
    for key, per_layer in found.items():
        a0, b0 = next(iter(per_layer.values()))
        if a0 is None or b0 is None:
            li = next(iter(per_layer))
            raise ValueError(f"{adapter_dir}: layer {li} {key} has only one "
                             f"of lora_A/lora_B")
        a_st = np.zeros((L, a0.shape[1], max_rank), np.float32)
        b_st = np.zeros((L, max_rank, b0.shape[0]), np.float32)
        for li, (a, b) in per_layer.items():
            if a is None or b is None:
                raise ValueError(f"{adapter_dir}: layer {li} {key} has only "
                                 f"one of lora_A/lora_B")
            r = a.shape[0]
            a_st[li, :, :r] = a.T
            b_st[li, :r, :] = b.T * np.float32(scale)
        # float32 -> bf16 rounds to nearest even, as ml_dtypes does.
        out[key] = (torch.from_numpy(a_st).to(torch.bfloat16),
                    torch.from_numpy(b_st).to(torch.bfloat16))
    log.info("loaded LoRA adapter from %s: rank %d (padded to %d), "
             "targets %s", adapter_dir, rank, max_rank, sorted(out))
    return out
