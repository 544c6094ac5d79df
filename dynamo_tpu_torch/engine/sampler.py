"""Token sampling: greedy / temperature / top-k / top-p, batched
(counterpart of ``dynamo_tpu.engine.sampler``).

Same semantics as the reference:
- temperature <= 0 is argmax for that row;
- sampling is Gumbel-max: argmax(logits / T + noise);
- top-k / top-p prefilter to the top MAX_TOPK=64 candidates, then apply
  top-p inside them;
- a row's noise is indexed by TOKEN ID, not by candidate rank, so a draw
  depends only on (noise field, logits): candidate order and the other
  rows cannot change it.

The reference takes one JAX PRNG key per row. Here the caller passes the
noise field itself, drawn from explicit ``torch.Generator``s with
``gumbel_noise``; ``sample_tokens`` draws it from one shared generator.
Nothing here reads a device value on the host, so sampling never stalls
the decode loop.
"""

from __future__ import annotations

import torch

MAX_TOPK = 64


def gumbel_noise(shape, generator: torch.Generator,
                 device: str | torch.device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U ~ U[0, 1), fp32."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(1e-20)))


def sample_tokens_per_row(logits: torch.Tensor, temperature: torch.Tensor,
                          top_k: torch.Tensor, top_p: torch.Tensor,
                          noise: torch.Tensor | None) -> torch.Tensor:
    """logits [B,V] fp32; temperature/top_k/top_p [B]; noise [B,V] Gumbel
    noise, one field per row indexed by token id, or None when every row
    is greedy. Returns [B] int32.

    temperature <= 0 means greedy for that row; top_k <= 0 disables
    top-k; top_p >= 1 disables top-p."""
    greedy = logits.argmax(dim=-1)
    if noise is None:
        return greedy.to(torch.int32)
    v = logits.shape[-1]
    sampling = temperature > 0
    filtered = (top_k > 0) | (top_p < 1.0)
    safe_t = torch.where(sampling, temperature, torch.ones_like(temperature))
    scaled = logits / safe_t[:, None]
    full_sample = (scaled + noise).argmax(dim=-1)
    # Among the top-64 candidates (sorted descending).
    max_k = min(MAX_TOPK, v)
    cand, cand_idx = torch.topk(scaled, max_k, dim=-1)
    pos = torch.arange(max_k, device=logits.device)[None, :]
    k_eff = torch.where(top_k > 0, torch.clamp(top_k, max=max_k),
                        torch.full_like(top_k, max_k))
    keep_k = pos < k_eff[:, None]
    probs = torch.softmax(torch.where(keep_k, cand, -torch.inf), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = (cum - probs) < top_p[:, None]  # the prefix reaching top_p
    masked = torch.where(keep_k & keep_p, cand, -torch.inf)
    cand_noise = torch.gather(noise, 1, cand_idx)
    choice = (masked + cand_noise).argmax(dim=-1)
    top_sample = torch.gather(cand_idx, 1, choice[:, None])[:, 0]
    sampled = torch.where(filtered, top_sample, full_sample)
    return torch.where(sampling, sampled, greedy).to(torch.int32)


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """Shared-generator wrapper: one noise draw covers the whole batch."""
    noise = gumbel_noise(logits.shape, generator, logits.device)
    return sample_tokens_per_row(logits, temperature, top_k, top_p, noise)
