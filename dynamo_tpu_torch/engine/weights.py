"""Weights: the reference's parameter tree as the port's tensors.

``params_from_jax`` takes the tree that ``dynamo_tpu.engine.model.init_params``
builds, as numpy arrays (the caller converts with ``np.asarray``; this
module never imports JAX), and returns the same tree of torch tensors on
``device``. Layouts are kept as they are: stacked ``[L, ...]`` layers and
``[in, out]`` projections. Loading HF safetensors is a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import ModelSpec
from dynamo_tpu_torch.engine.model import param_shapes


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.array(arr, order="C")  # a writable copy torch may own
    if arr.dtype.name == "bfloat16":
        # numpy has no native bf16: reinterpret the 2-byte payload.
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return t.to(device)


def params_from_jax(np_params: dict, spec: ModelSpec,
                    device: str | torch.device = "cuda") -> dict:
    """Convert the reference's param tree (numpy leaves) to bf16 tensors,
    checking every leaf against the spec's shapes."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("params_from_jax: device is cuda but no GPU is "
                           "available")
    shapes = param_shapes(spec)

    def convert(tree: dict, want: dict) -> dict:
        if set(tree) != set(want):
            raise ValueError(f"param keys {sorted(tree)} != "
                             f"{sorted(want)} for {spec.name}")
        out = {}
        for key, shape in want.items():
            if isinstance(shape, dict):
                out[key] = convert(tree[key], shape)
                continue
            arr = np.asarray(tree[key])
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"param {key}: shape {arr.shape} != "
                                 f"{shape}")
            out[key] = _to_tensor(arr, device)
        return out

    return convert(np_params, shapes)
