"""Llama/Qwen2-family transformer in torch over the paged KV pool
(counterpart of ``dynamo_tpu.engine.model``).

Parameters are a dict with the reference's tree and layouts: per-layer
weights stacked on a leading ``L`` axis, projections stored ``[in, out]``.
Numerics follow the reference: bf16 weights and activations, fp32 for
norms, RoPE, softmax and the logits. The forwards loop over layers in
Python, where the reference scans. With int8 weights (``--quant int8``)
the big matmuls, the embedding and an untied head are ``quant.QTensor``
leaves, applied with the reference's numerics (``mm``, ``embed_lookup``,
``lm_logits``): the int8 operand converts to bf16 for a bf16 matmul and
the float32 scale multiplies the output, or, for a tied head, the
activations.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine.config import ModelSpec
from dynamo_tpu_torch.engine.kv_quant import (gather_pages_folded,
                                              scatter_pages)
from dynamo_tpu_torch.engine.quant import QUANT_LAYER_KEYS, QTensor

Params = dict[str, Any]
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def mm(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., in] @ w [in, out] in bf16 (fp32 accumulate). A QTensor's
    int8 operand converts to bf16 for the matmul, whose bf16 output the
    [1, out] scale then multiplies in fp32."""
    if isinstance(w, QTensor):
        y = torch.matmul(x, w.q.to(torch.bfloat16))
        return (y.float() * w.s).to(torch.bfloat16)
    return torch.matmul(x, w)


def lora_delta(x: torch.Tensor, ll: dict, ids: torch.Tensor) -> torch.Tensor:
    """The batched low-rank correction ``x @ A[ids] @ B[ids]`` of one
    layer's target (the reference's ``lora_delta``, the S-LoRA / Punica
    step): x [N, H] or [B, T, H]; ``ll`` = {"a": [S, H, r], "b": [S, r, D]}
    over every slot; ids [N] or [B] slot ids, data on the device (0 = the
    base model, whose stacks are zeros).

    Each stack is read once, whatever the mix of slots: one batched
    product of x against every slot's A (fp32 accumulate and output), the
    columns of every slot but the row's own zeroed and the rest rounded to
    bf16, then one product against the B stacks laid as [S*r, D] with a
    bf16 output. Per row that is the reference's two gathered einsums: the
    other slots' columns are exact zeros in the second sum, and a slot-0
    row gets exact zeros. Gathering A[ids] and B[ids] instead would write
    and read one copy of a slot's stacks per row."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    rows = ids.reshape(-1)
    if xf.shape[0] != rows.shape[0]:  # [B, T, H]: a row's T positions
        rows = rows[:, None].expand(-1, xf.shape[0] // rows.shape[0])
        rows = rows.reshape(-1)
    a, b = ll["a"], ll["b"]
    s, r = a.shape[0], a.shape[2]
    u = _mm_f32(xf.expand(s, -1, -1), a)                       # [S, N, r]
    own = (rows.long()[None, :] == torch.arange(s, device=x.device)[:, None])
    u = torch.where(own[..., None], u, 0.0).to(x.dtype)
    u = u.permute(1, 0, 2).reshape(-1, s * r)                  # [N, S*r]
    out = torch.matmul(u, b.reshape(s * r, -1))
    return out.reshape(*shape[:-1], out.shape[-1])


def embed_lookup(embed, tokens: torch.Tensor) -> torch.Tensor:
    """Token-embedding gather; int8 tables gather q rows and scale by the
    per-hidden-channel scale."""
    if isinstance(embed, QTensor):
        rows = embed.q[tokens.long()].float() * embed.s[0]
        return rows.to(torch.bfloat16)
    return embed[tokens.long()]


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 operands, fp32 output (the reference's
    preferred_element_type=f32): [N, K] @ [K, D], or batched [S, N, K] @
    [S, K, D]."""
    if x.is_cuda:
        product = torch.bmm if x.dim() == 3 else torch.mm
        return product(x, w, out_dtype=torch.float32)
    return torch.matmul(x.float(), w.float())


def lm_logits(x: torch.Tensor, params: Params, spec: ModelSpec
              ) -> torch.Tensor:
    """Final hidden [B, H] -> fp32 logits [B, V]. A tied int8 embedding
    contracts over H, whose scale therefore folds into the activations; an
    untied int8 head scales the output columns."""
    if spec.tie_word_embeddings:
        w = params["embed"]
        if isinstance(w, QTensor):
            xs = (x.float() * w.s[0]).to(torch.bfloat16)
            return _mm_f32(xs, w.q.to(torch.bfloat16).t())
        return _mm_f32(x, w.t())
    w = params["lm_head"]
    if isinstance(w, QTensor):
        return _mm_f32(x, w.q.to(torch.bfloat16)) * w.s
    return _mm_f32(x, w)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., head_dim/2] for HF rotate-half RoPE."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [..., heads, head_dim]; cos/sin [..., half] (broadcast over heads)."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    out1 = xf1 * cos - xf2 * sin
    out2 = xf2 * cos + xf1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def ffn_block(h2: torch.Tensor, lp: dict, spec: ModelSpec,
              ll: dict | None = None,
              ids: torch.Tensor | None = None) -> torch.Tensor:
    """Dense SwiGLU over normalized hidden states [..., H]; with one
    layer's LoRA stacks ``ll`` the gate, up and down projections take
    their rows' adapter deltas."""
    if spec.num_experts:
        raise NotImplementedError("MoE is not ported yet")
    gate = mm(h2, lp["w_gate"])
    up = mm(h2, lp["w_up"])
    if ll is not None:
        gate = gate + lora_delta(h2, ll["w_gate"], ids)
        up = up + lora_delta(h2, ll["w_up"], ids)
    ff = F.silu(gate.float()).to(h2.dtype) * up
    down = mm(ff, lp["w_down"])
    if ll is not None:
        down = down + lora_delta(ff, ll["w_down"], ids)
    return down


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def param_shapes(spec: ModelSpec, quantized: bool | None = None) -> dict:
    """The param tree's shapes. ``quantized`` (default: ``spec.quant ==
    "int8"``) gives the int8 tree's, with a QTensor of (q, s) shapes for
    each quantized leaf."""
    if quantized is None:
        quantized = spec.quant == "int8"
    h, d = spec.hidden_size, spec.head_dim
    nh, nkv, L = spec.num_heads, spec.num_kv_heads, spec.num_layers
    i = spec.intermediate_size
    layers = {
        "input_norm": (L, h),
        "post_attn_norm": (L, h),
        "wq": (L, h, nh * d),
        "wk": (L, h, nkv * d),
        "wv": (L, h, nkv * d),
        "wo": (L, nh * d, h),
        "w_gate": (L, h, i),
        "w_up": (L, h, i),
        "w_down": (L, i, h),
    }
    if spec.qkv_bias:
        layers["bq"] = (L, nh * d)
        layers["bk"] = (L, nkv * d)
        layers["bv"] = (L, nkv * d)
    shapes = {"embed": (spec.vocab_size, h), "final_norm": (h,),
              "layers": layers}
    if not spec.tie_word_embeddings:
        shapes["lm_head"] = (h, spec.vocab_size)
    if quantized:
        for key in QUANT_LAYER_KEYS:
            if key in layers:
                shape = layers[key]
                layers[key] = QTensor(q=shape,
                                      s=(*shape[:-2], 1, shape[-1]))
        shapes["embed"] = QTensor(q=(spec.vocab_size, h), s=(1, h))
        if "lm_head" in shapes:
            shapes["lm_head"] = QTensor(q=(h, spec.vocab_size),
                                        s=(1, spec.vocab_size))
    return shapes


def init_params(spec: ModelSpec, generator: torch.Generator,
                device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.bfloat16) -> Params:
    """Random init with the reference's distribution (``model.py:251``):
    N(0, 1) / sqrt(fan_in) with fan_in = shape[-2], ones for norm scales
    (and for 1-D leaves such as biases). ``generator`` must live on
    ``device``."""
    if spec.num_experts:
        raise NotImplementedError("MoE is not ported yet")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_params: device is cuda but no GPU is "
                           "available")

    def init_one(shape):
        if len(shape) == 1 or shape[-1] == 1:
            return torch.ones(shape, dtype=dtype, device=device)
        w = torch.randn(shape, generator=generator, dtype=dtype,
                        device=device)
        return w.mul_(torch.tensor(1.0 / shape[-2] ** 0.5, dtype=dtype))

    shapes = param_shapes(spec, quantized=False)
    params: Params = {k: init_one(v) for k, v in shapes.items()
                      if k != "layers"}
    params["layers"] = {k: init_one(v) for k, v in shapes["layers"].items()}
    params["final_norm"] = torch.ones(shapes["final_norm"], dtype=dtype,
                                      device=device)
    for key in ("input_norm", "post_attn_norm"):
        params["layers"][key] = torch.ones(shapes["layers"][key],
                                           dtype=dtype, device=device)
    return params


def layer_params(params: Params, layer: int) -> dict:
    """One layer's weights: views into the stacked tensors (no copy); a
    QTensor's q and s are both sliced."""
    return {k: QTensor(v.q[layer], v.s[layer]) if isinstance(v, QTensor)
            else v[layer] for k, v in params["layers"].items()}


def layer_lora(lora: dict | None, layer: int) -> dict | None:
    """One layer's LoRA stacks ({key: {"a": [S, d_in, r], "b": [S, r,
    d_out]}}, views), or None without adapters."""
    if lora is None:
        return None
    return {k: {"a": v["a"][layer], "b": v["b"][layer]}
            for k, v in lora.items()}


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

# fp32 score bytes of one query block in prefill attention: the blocks
# bound the transient (scores, their softmax and the bf16 probabilities)
# whatever the prompt or history length.
SCORE_BLOCK_BYTES = 1 << 29


def causal_attention(q, k, v, q_positions, kv_len_mask, q_per_kv: int,
                     k_hist=None, v_hist=None, hist_lens=None,
                     q_block: int | None = None) -> torch.Tensor:
    """Prefill attention of a chunk over its own fresh K/V and, when given,
    the sequence's earlier tokens in the pool.

    q [B,S,Nh,D], k/v [B,S,Nkv,D], q_positions [B,S] (absolute),
    kv_len_mask [B,S] bool (valid chunk slots); k_hist/v_hist [Nkv,B,H,D]
    (``gather_pages_folded``) with hist_lens [B] valid history tokens.
    Causal by position within the chunk; the history lies before it. One
    fp32 softmax over the history and chunk columns, bf16 probabilities
    into both PV products, as the reference's ``dense_causal_attention``
    and ``_prefill_with_history``. GQA groups query heads without
    repeating K/V. Queries run in blocks of ``q_block`` rows (default:
    SCORE_BLOCK_BYTES of scores), each row's softmax being independent."""
    b, s, nh, d = q.shape
    nkv = k.shape[2]
    h = 0 if k_hist is None else k_hist.shape[2]
    qg = q.reshape(b, s, nkv, q_per_kv, d).float()
    kf = k.float()
    scale = d ** 0.5
    if h:
        kh = k_hist.float()
        hist_valid = (torch.arange(h, device=q.device)[None, :]
                      < hist_lens.long()[:, None])[:, None, None, None, :]
    valid = kv_len_mask[:, None, None, None, :]
    if q_block is None:
        q_block = max(1, SCORE_BLOCK_BYTES // (4 * b * nh * (h + s)))
    outs = []
    for q0 in range(0, s, q_block):
        qb = qg[:, q0:q0 + q_block]
        scores = torch.einsum("bqngd,bknd->bngqk", qb, kf)
        causal = (q_positions[:, None, None, q0:q0 + q_block, None]
                  >= q_positions[:, None, None, None, :])
        scores = torch.where(causal & valid, scores, NEG_INF)
        if h:
            hs = torch.einsum("bqngd,nbld->bngql", qb, kh)
            scores = torch.cat([torch.where(hist_valid, hs, NEG_INF),
                                scores], dim=-1)
        probs = torch.softmax(scores / scale, dim=-1).to(q.dtype)
        out = torch.einsum("bngqk,bknd->bqngd", probs[..., h:], v)
        if h:
            out = out + torch.einsum("bngql,nbld->bqngd", probs[..., :h],
                                     v_hist)
        outs.append(out)
    return torch.cat(outs, dim=1).reshape(b, s, nh, d)


def paged_window_attention(q, k_cache, v_cache, layer: int, page_table,
                           hist_lens, k_win, v_win, m: int, k_self, v_self,
                           q_per_kv: int) -> torch.Tensor:
    """Plain decode attention for step ``m`` of an M-step window
    (reference ``paged_window_attention_xla``): one softmax over the
    gathered history (hist_lens tokens), the in-window buffer k_win/v_win
    [Nkv,B,M,D] (cols j < m) and the current token k_self/v_self
    [B,Nkv,D]. An int8 pool is dequantized to bf16 in the gather.
    Probabilities are cast to bf16 before the PV products, as in the
    reference."""
    b, nh, d = q.shape
    nkv, page = k_cache.shape[1], k_cache.shape[3]
    maxp = page_table.shape[1]
    M = k_win.shape[2]
    k_all = gather_pages_folded(k_cache, layer, page_table).float()
    v_all = gather_pages_folded(v_cache, layer, page_table)
    qg = q.reshape(b, nkv, q_per_kv, d).float()
    scale = 1.0 / d ** 0.5
    s_hist = torch.einsum("bngd,nbld->bngl", qg, k_all) * scale
    pos = torch.arange(maxp * page, device=q.device)[None, :]
    s_hist = torch.where((pos < hist_lens.long()[:, None])[:, None, None, :],
                         s_hist, NEG_INF)
    s_win = torch.einsum("bngd,nbjd->bngj", qg, k_win.float()) * scale
    win_valid = (torch.arange(M, device=q.device) < m)[None, None, None, :]
    s_win = torch.where(win_valid, s_win, NEG_INF)
    s_self = torch.einsum("bngd,bnd->bng", qg,
                          k_self.float())[..., None] * scale
    full = torch.cat([s_hist, s_win, s_self], dim=-1)
    probs = torch.softmax(full, dim=-1)
    p_hist = probs[..., :maxp * page].to(q.dtype)
    p_win = probs[..., maxp * page:-1].to(q.dtype)
    p_self = probs[..., -1]
    out = (torch.einsum("bngl,nbld->bngd", p_hist, v_all)
           + torch.einsum("bngj,nbjd->bngd", p_win, v_win)
           + p_self[..., None].to(q.dtype) * v_self[:, :, None, :])
    return out.reshape(b, nh, d)


def paged_verify_attention_plain(q, k_cache, v_cache, layer: int, page_table,
                                 hist_lens, k_win, v_win, wlen, k_blk, v_blk,
                                 q_per_kv: int) -> torch.Tensor:
    """Plain attention of a speculative verify block (the einsum body of
    the reference's ``decode_window_multi_step``): q [B,S,Nh,D] over the
    gathered history (hist_lens tokens), the window buffer k_win/v_win
    [Nkv,B,W,D] (cols < wlen [B]) and the block's own k_blk/v_blk
    [B,S,Nkv,D] (causal: position j sees block cols t <= j). One fp32
    softmax, bf16 probabilities into the PV products."""
    b, s, nh, d = q.shape
    nkv, page = k_cache.shape[1], k_cache.shape[3]
    maxp = page_table.shape[1]
    w = k_win.shape[2]
    k_all = gather_pages_folded(k_cache, layer, page_table).float()
    v_all = gather_pages_folded(v_cache, layer, page_table)
    qg = q.reshape(b, s, nkv, q_per_kv, d).float()
    scale = 1.0 / d ** 0.5
    s_hist = torch.einsum("bsngd,nbld->bnsgl", qg, k_all) * scale
    lpos = torch.arange(maxp * page, device=q.device)[None, :]
    s_hist = torch.where(
        (lpos < hist_lens.long()[:, None])[:, None, None, None, :],
        s_hist, NEG_INF)
    s_win = torch.einsum("bsngd,nbjd->bnsgj", qg, k_win.float()) * scale
    wvalid = (torch.arange(w, device=q.device)[None, :]
              < wlen.long()[:, None])[:, None, None, None, :]
    s_win = torch.where(wvalid, s_win, NEG_INF)
    s_blk = torch.einsum("bsngd,btnd->bnsgt", qg, k_blk.float()) * scale
    causal = (torch.arange(s, device=q.device)[:, None]
              >= torch.arange(s, device=q.device)[None, :])
    s_blk = torch.where(causal[None, None, :, None, :], s_blk, NEG_INF)
    probs = torch.softmax(torch.cat([s_hist, s_win, s_blk], dim=-1), dim=-1)
    h = maxp * page
    p_hist = probs[..., :h].to(q.dtype)
    p_win = probs[..., h:h + w].to(q.dtype)
    p_blk = probs[..., h + w:].to(q.dtype)
    out = (torch.einsum("bnsgl,nbld->bsngd", p_hist, v_all)
           + torch.einsum("bnsgj,nbjd->bsngd", p_win, v_win)
           + torch.einsum("bnsgt,btnd->bsngd", p_blk, v_blk))
    return out.reshape(b, s, nh, d)


def paged_decode_attention(q, k_cache, v_cache, layer: int, page_table,
                           hist_lens, k_self, v_self,
                           q_per_kv: int) -> torch.Tensor:
    """Plain single-step decode attention: the window attention with zero
    in-window columns (reference ``paged_decode_attention_xla``)."""
    b = q.shape[0]
    nkv, d = k_cache.shape[1], k_cache.shape[4]
    empty = torch.zeros((nkv, b, 0, d), dtype=k_cache.dtype,
                        device=q.device)
    return paged_window_attention(q, k_cache, v_cache, layer, page_table,
                                  hist_lens, empty, empty, 0, k_self, v_self,
                                  q_per_kv)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def qkv_lora(q, k, v, h, ll: dict, ids: torch.Tensor):
    """The wq/wk/wv deltas of freshly projected q/k/v (h: the normed layer
    input the projections read)."""
    return (q + lora_delta(h, ll["wq"], ids), k + lora_delta(h, ll["wk"], ids),
            v + lora_delta(h, ll["wv"], ids))


def _out_proj(attn: torch.Tensor, lp: dict, ll: dict | None,
              ids: torch.Tensor | None) -> torch.Tensor:
    """The attention output projection, with its wo delta under LoRA."""
    proj = mm(attn, lp["wo"])
    if ll is not None:
        proj = proj + lora_delta(attn, ll["wo"], ids)
    return proj


def _qkv(h: torch.Tensor, lp: dict, spec: ModelSpec, cos, sin,
         ll: dict | None = None, ids: torch.Tensor | None = None):
    """Projected, biased, head-split and rotated q, k, v for one layer.
    With LoRA stacks the deltas go in before the bias, as in the
    reference."""
    d = spec.head_dim
    q = mm(h, lp["wq"])
    k = mm(h, lp["wk"])
    v = mm(h, lp["wv"])
    if ll is not None:
        q, k, v = qkv_lora(q, k, v, h, ll, ids)
    if spec.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = q.reshape(*q.shape[:-1], spec.num_heads, d)
    k = k.reshape(*k.shape[:-1], spec.num_kv_heads, d)
    v = v.reshape(*v.shape[:-1], spec.num_kv_heads, d)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def prefill_forward(params: Params, spec: ModelSpec, k_cache, v_cache,
                    tokens, positions, page_table, seq_lens, lora=None,
                    adapter_ids=None):
    """Whole-prompt prefill; writes K/V into pages.

    tokens/positions [B,S] (S a multiple of page_size), page_table
    [B, S//page_size] (pages covering the prompt; padding entries 0 = the
    scratch page), seq_lens [B]. ``lora`` (the runner's stacks, ``{key:
    {"a": [L, S, d_in, r], "b": [L, S, r, d_out]}}``) with adapter_ids [B]
    adds each row's adapter deltas at every target. Returns (last-token
    logits [B,V] fp32, k_cache, v_cache); the caches are updated in place
    (an int8 pool is quantized on the way in)."""
    return _prefill(params, spec, k_cache, v_cache, tokens, positions,
                    page_table, seq_lens, None, None, lora, adapter_ids)


def prefill_with_history(params: Params, spec: ModelSpec, k_cache, v_cache,
                         tokens, positions, page_table, seq_lens, hist_table,
                         hist_lens, lora=None, adapter_ids=None):
    """Chunk prefill over history (reference
    ``runner._prefill_with_history``): ``prefill_forward`` whose queries
    also attend to the sequence's earlier tokens, read from the pool
    through hist_table [B, maxP] (pages before the chunk; padding 0) up to
    hist_lens [B]. Serves a prompt's later chunks and the rest of a prompt
    after a prefix-cache hit, over a bf16 or an int8 pool. The history
    pages are disjoint from the chunk's, which are written after every
    layer has read the history. ``lora`` and ``adapter_ids`` as in
    ``prefill_forward``."""
    return _prefill(params, spec, k_cache, v_cache, tokens, positions,
                    page_table, seq_lens, hist_table, hist_lens, lora,
                    adapter_ids)


def _prefill(params, spec, k_cache, v_cache, tokens, positions, page_table,
             seq_lens, hist_table, hist_lens, lora, adapter_ids):
    b, s = tokens.shape
    d = spec.head_dim
    page = k_cache.shape[3]
    x = embed_lookup(params["embed"], tokens)
    cos, sin = rope_tables(positions, d, spec.rope_theta)
    valid = (torch.arange(s, device=tokens.device)[None, :]
             < seq_lens[:, None])
    k_layers, v_layers = [], []
    for layer in range(spec.num_layers):
        lp, ll = layer_params(params, layer), layer_lora(lora, layer)
        h = rms_norm(x, lp["input_norm"], spec.rms_norm_eps)
        q, k, v = _qkv(h, lp, spec, cos, sin, ll, adapter_ids)
        hist = {}
        if hist_table is not None:
            hist = dict(k_hist=gather_pages_folded(k_cache, layer, hist_table),
                        v_hist=gather_pages_folded(v_cache, layer, hist_table),
                        hist_lens=hist_lens)
        attn = causal_attention(q, k, v, positions, valid, spec.q_per_kv,
                                **hist)
        x = x + _out_proj(attn.reshape(b, s, -1), lp, ll, adapter_ids)
        h2 = rms_norm(x, lp["post_attn_norm"], spec.rms_norm_eps)
        x = x + ffn_block(h2, lp, spec, ll, adapter_ids)
        k_layers.append(k)
        v_layers.append(v)
    L, nkv = spec.num_layers, spec.num_kv_heads
    # [L,B,S,Nkv,D] -> page blocks [L,Nkv,B*S/page,page,D]; one scatter.
    k_blocks = (torch.stack(k_layers).reshape(L, b * (s // page), page, nkv, d)
                .permute(0, 3, 1, 2, 4))
    v_blocks = (torch.stack(v_layers).reshape(L, b * (s // page), page, nkv, d)
                .permute(0, 3, 1, 2, 4))
    flat_pages = page_table.reshape(-1)
    scatter_pages(k_cache, k_blocks, flat_pages)
    scatter_pages(v_cache, v_blocks, flat_pages)
    x = rms_norm(x, params["final_norm"], spec.rms_norm_eps)
    last_idx = torch.clamp(seq_lens.long() - 1, min=0)
    x_last = x[torch.arange(b, device=x.device), last_idx]
    return lm_logits(x_last, params, spec), k_cache, v_cache


def embed_forward(params: Params, spec: ModelSpec, tokens, seq_lens,
                  pooling: str = "last") -> torch.Tensor:
    """Embedding forward (the reference's ``embed_forward``): a full pass
    with no KV cache over tokens [B,S] (padded) with seq_lens [B], the
    final hidden states pooled over the valid positions, ``"last"`` (the
    final valid token) or ``"mean"`` (masked mean). Returns L2-normalized
    [B,H] float32 (the engine side of /v1/embeddings)."""
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    cos, sin = rope_tables(positions, spec.head_dim, spec.rope_theta)
    valid = positions < seq_lens[:, None]
    for layer in range(spec.num_layers):
        lp = layer_params(params, layer)
        h = rms_norm(x, lp["input_norm"], spec.rms_norm_eps)
        q, k, v = _qkv(h, lp, spec, cos, sin)
        attn = causal_attention(q, k, v, positions, valid, spec.q_per_kv)
        x = x + mm(attn.reshape(b, s, -1), lp["wo"])
        h2 = rms_norm(x, lp["post_attn_norm"], spec.rms_norm_eps)
        x = x + ffn_block(h2, lp, spec)
    x = rms_norm(x, params["final_norm"], spec.rms_norm_eps).float()
    if pooling == "mean":
        m = valid[..., None].float()
        pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
    else:
        last = (seq_lens.long() - 1).clamp(min=0)
        pooled = x[torch.arange(b, device=x.device), last]
    return pooled / torch.linalg.norm(pooled, dim=-1,
                                      keepdim=True).clamp(min=1e-12)


def decode_window_step(params: Params, spec: ModelSpec, k_cache, v_cache,
                       k_buf, v_buf, m: int, tokens, positions, page_table,
                       hist_lens, attention_impl=None, lora=None,
                       adapter_ids=None):
    """One decode step inside an M-step window. The caches are read-only
    here; this window's earlier tokens come from k_buf/v_buf
    [L,Nkv,B,M,D] (cols j < m), and the step's fresh K/V is returned as
    [L,B,Nkv,D] for the caller to append to the buffers.

    hist_lens [B]: tokens cache-resident before the window; ``lora`` and
    adapter_ids [B] as in ``prefill_forward``. Returns (logits [B,V] fp32,
    k_new, v_new)."""
    d = spec.head_dim
    b = tokens.shape[0]
    x = embed_lookup(params["embed"], tokens)
    cos, sin = rope_tables(positions, d, spec.rope_theta)
    attn_fn = attention_impl or paged_window_attention
    k_layers, v_layers = [], []
    for layer in range(spec.num_layers):
        lp, ll = layer_params(params, layer), layer_lora(lora, layer)
        h = rms_norm(x, lp["input_norm"], spec.rms_norm_eps)
        q, k, v = _qkv(h, lp, spec, cos, sin, ll, adapter_ids)
        attn = attn_fn(q, k_cache, v_cache, layer, page_table, hist_lens,
                       k_buf[layer], v_buf[layer], m, k, v, spec.q_per_kv)
        x = x + _out_proj(attn.reshape(b, -1), lp, ll, adapter_ids)
        h2 = rms_norm(x, lp["post_attn_norm"], spec.rms_norm_eps)
        x = x + ffn_block(h2, lp, spec, ll, adapter_ids)
        k_layers.append(k)
        v_layers.append(v)
    x = rms_norm(x, params["final_norm"], spec.rms_norm_eps)
    return (lm_logits(x, params, spec), torch.stack(k_layers),
            torch.stack(v_layers))


def decode_window_multi_step(params: Params, spec: ModelSpec, k_cache,
                             v_cache, k_buf, v_buf, wlen, tokens, positions,
                             page_table, hist_lens, attention_impl=None,
                             lora=None, adapter_ids=None):
    """Speculative verify step inside a window: S tokens per slot (the
    chained token and up to S-1 drafts) forwarded together, so one read
    of the weights verifies S positions. The caches are read-only here.

    tokens/positions [B,S]; k_buf/v_buf [L,Nkv,B,W,D] hold this window's
    committed columns (< wlen [B]); hist_lens [B]: cache-resident tokens.
    Position j attends the paged history, the buffer's valid columns and
    the block's columns t <= j. ``lora`` and adapter_ids [B] as in
    ``prefill_forward`` (a slot's S positions take its adapter). Returns
    (logits [B,S,V] fp32, k_new, v_new [L,B,S,Nkv,D])."""
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens)              # [B,S,H]
    cos, sin = rope_tables(positions, spec.head_dim, spec.rope_theta)
    attn_fn = attention_impl or paged_verify_attention_plain
    k_layers, v_layers = [], []
    for layer in range(spec.num_layers):
        lp, ll = layer_params(params, layer), layer_lora(lora, layer)
        h = rms_norm(x, lp["input_norm"], spec.rms_norm_eps)
        q, k, v = _qkv(h, lp, spec, cos, sin, ll, adapter_ids)  # [B,S,N,D]
        attn = attn_fn(q, k_cache, v_cache, layer, page_table, hist_lens,
                       k_buf[layer], v_buf[layer], wlen, k, v, spec.q_per_kv)
        x = x + _out_proj(attn.reshape(b, s, -1), lp, ll, adapter_ids)
        h2 = rms_norm(x, lp["post_attn_norm"], spec.rms_norm_eps)
        x = x + ffn_block(h2, lp, spec, ll, adapter_ids)
        k_layers.append(k)
        v_layers.append(v)
    x = rms_norm(x, params["final_norm"], spec.rms_norm_eps)
    logits = lm_logits(x.reshape(b * s, -1), params, spec)
    return (logits.reshape(b, s, -1), torch.stack(k_layers),
            torch.stack(v_layers))
