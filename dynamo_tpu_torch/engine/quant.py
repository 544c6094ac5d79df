"""Weight-only int8 quantization with bf16 compute (counterpart of
``dynamo_tpu.engine.quant``, on torch tensors of any device).

Scheme: symmetric per-output-channel int8. A weight W[..., in, out] stores
q = round(W / s) in int8 and s[..., 1, out] in float32; ``model.mm`` runs
x @ q (q converted to bf16) and the scale multiplies the output. The
embedding table [V, H] quantizes per hidden channel (s [1, H]): the token
gather scales its rows, and the tied LM head folds the scale into the
activations. Norms and biases stay bf16.

The arithmetic is the reference's numpy, step for step, so q and s are the
same bits: the absmax in float32, an f32 division by 127, all-zero channels
at s = 1, s stepped down one ulp where 127 * s would overflow, q = the
f32 quotient rounded half to even (``torch.round`` as ``np.rint``) and
clipped to +-127. Stacked [L, in, out] weights are quantized one layer at a
time, and the embedding in blocks of rows, so no float32 copy of a whole
stacked weight exists at once.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class QTensor(NamedTuple):
    """int8 weight + broadcastable float32 scale."""
    q: Any   # int8 [..., in, out]
    s: Any   # float32 [..., 1, out]


# Layer leaves that quantize (the big matmuls); everything else stays bf16.
QUANT_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                    "moe_w_gate", "moe_w_up", "moe_w_down")
# Rows of the embedding table converted to float32 at a time.
EMBED_ROW_BLOCK = 8192


def _safe_scale(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127 with two guards: all-zero channels take s = 1 (exact
    round trip), and channels near float32-max step s down one ulp when the
    division rounded up, otherwise the saturated code dequantizes to
    127 * s = inf."""
    amax = amax.float()
    # A tensor divisor: on CUDA, torch divides by a Python scalar as a
    # multiply by its reciprocal, which can differ from amax / 127 by an
    # ulp (kv_quant.kv_quantize does the same).
    s = amax / torch.full_like(amax, 127.0)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    over = ~torch.isfinite(s * 127.0)
    return torch.where(over, torch.nextafter(s, torch.zeros_like(s)), s)


def _codes(wf: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)


def quantize_weight(w: torch.Tensor) -> QTensor:
    """Symmetric per-out-channel int8 over the last axis (reduce over the
    contraction axis -2), one [in, out] matrix at a time."""
    if w.dim() > 2:
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = torch.empty((*w.shape[:-2], 1, w.shape[-1]), dtype=torch.float32,
                        device=w.device)
        for i in range(w.shape[0]):
            q[i], s[i] = quantize_weight(w[i])
        return QTensor(q=q, s=s)
    wf = w.float()
    s = _safe_scale(wf.abs().amax(dim=-2, keepdim=True))
    return QTensor(q=_codes(wf, s), s=s)


def quantize_embedding(w: torch.Tensor) -> QTensor:
    """Embedding table [V, H]: per-H-channel scale [1, H], right for both
    the row gather and the tied head."""
    blocks = range(0, w.shape[0], EMBED_ROW_BLOCK)
    amax = torch.zeros((1, w.shape[1]), dtype=torch.float32, device=w.device)
    for r in blocks:
        amax = torch.maximum(amax, w[r:r + EMBED_ROW_BLOCK].float().abs()
                             .amax(dim=0, keepdim=True))
    s = _safe_scale(amax)
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    for r in blocks:
        q[r:r + EMBED_ROW_BLOCK] = _codes(
            w[r:r + EMBED_ROW_BLOCK].float(), s)
    return QTensor(q=q, s=s)


def is_quantized(params: dict) -> bool:
    return isinstance(params.get("embed"), QTensor)


def quantize_params(params: dict) -> dict:
    """bf16 param tree -> the same tree with QTensor leaves for the big
    matmuls, the embedding and an untied head. The input tree is not
    changed."""
    layers = dict(params["layers"])
    for key in QUANT_LAYER_KEYS:
        if key in layers:
            layers[key] = quantize_weight(layers[key])
    out = dict(params)
    out["layers"] = layers
    out["embed"] = quantize_embedding(params["embed"])
    if "lm_head" in params:
        out["lm_head"] = quantize_weight(params["lm_head"])
    return out


def weight_dtype_bytes(quant: str | None) -> float:
    """Bytes per weight element for capacity/roofline accounting."""
    return 1.0 if quant == "int8" else 2.0
