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

The reference takes one JAX PRNG key per row and folds a seeded request's
token position into it (``jax.random.fold_in``). Here ``gumbel_field``
computes the noise on the device from a (key, counter) pair per row with a
counter-based hash, so a captured decode window draws without any host
generator, and the same pair gives the same field on the CPU and on the
card, bit for bit. Nothing here reads a device value on the host, so
sampling never stalls the decode loop.
"""

from __future__ import annotations

import torch

MAX_TOPK = 64

# SplitMix64 (Steele, Lea and Flood, OOPSLA 2014): the Weyl increment and
# the two multipliers of its output function, as int64 bit patterns.
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)
UNIFORM_BITS = 24


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (torch shifts signed
    values arithmetically, so the sign copies are masked off)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix64(z: torch.Tensor) -> torch.Tensor:
    """SplitMix64's output function, in place on an int64 tensor whose
    multiplies wrap around as uint64 arithmetic does."""
    z ^= _shr(z, 30)
    z *= _MIX1
    z ^= _shr(z, 27)
    z *= _MIX2
    z ^= _shr(z, 31)
    return z


def gumbel_field(keys: torch.Tensor, counters: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Standard Gumbel noise [B, vocab] fp32 from int64 ``keys`` [B] and
    ``counters`` [B]: row b is the SplitMix64 stream whose state is a hash
    of (keys[b], counters[b]), and entry t is its (t + 1)-th output, whose
    top UNIFORM_BITS bits ``gumbel_of_bits`` turns into noise. The field is
    a function of (key, counter, token id) alone, whatever the batch, and
    the same bits on the CPU and on the card."""
    state = _mix64(_mix64(keys.to(torch.int64) + _GOLDEN)
                   + counters.to(torch.int64))
    steps = torch.arange(1, vocab + 1, dtype=torch.int64,
                         device=keys.device) * _GOLDEN
    z = _mix64(state[:, None] + steps[None, :])
    return gumbel_of_bits(_shr(z, 64 - UNIFORM_BITS))


def gumbel_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """fp32 Gumbel noise from UNIFORM_BITS-bit integers: u = (bits + 1/2)
    / 2^24, then -log(-log(u)) in float64, rounded once to fp32."""
    u = bits.double()
    u += 0.5
    u *= 2.0 ** -UNIFORM_BITS
    return u.log_().neg_().log_().neg_().float()


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
