"""ModelRunner: parameters, the paged KV pool, prefill and decode windows
(the part of ``dynamo_tpu.engine.runner.ModelRunner`` the engine calls).

- ``prefill_batch``: bucketed prefill of whole prompts or of a prompt's
  final chunk, with or without history pages (earlier chunks, a cached
  prefix), that samples each row's first token and leaves it in
  ``tokens_dev`` so the next decode window chains from it without a host
  round trip. ``prefill_chunk_async`` runs an intermediate chunk, whose
  sampled token nobody needs.
- ``embed``: the pooled, normalized final hidden states of a padded batch
  of prompts (/v1/embeddings), one eager pass with no KV cache.
- ``decode_window``: M decode steps for the whole slot batch. The host
  uploads one packed int32 control array per window (the ``PK_*`` columns,
  byte-identical to the reference), tokens chain on the device, the
  window's K/V collects in a small buffer, and one commit scatter writes
  it into the pool at the end. As in the reference, where each window key
  is one compiled program (``_get_window``), each key here is one
  ``WindowProgram``: on the CPU its body runs eagerly every window; on
  the card it is captured once as a CUDA graph and every window replays
  it. The card has no eager window path.
- ``decode_spec_window`` (``spec_decode="ngram"``): a window of
  ``m_outer`` speculative verify steps, each drafting up to k tokens by
  bigram lookup in the slot's token history on the device (``hist_dev``)
  and verifying them in one [B, k+1] forward over the paged attention
  kernel; the data-dependent positions chain on the device
  (``positions_dev``), and ``seed_history`` writes each admitted prompt
  into the history. It is one more ``WindowProgram`` key.
- OpenAI frequency/presence penalties read a ``[max_num_seqs, vocab]``
  uint8 count state on the device (``counts``): prefills install a slot's
  row, penalised windows subtract ``freq * count + pres * (count > 0)``
  before temperature and top-k and bump the count of each live sampled
  token, saturating at 255. Logprobs (the chosen token's and the top
  ``TOP_LOGPROBS``) are computed only when some row asks for them.
- Sampling noise comes from ``sampler.gumbel_field`` on the device: a
  seeded row's field is keyed by (seed, position of the token being
  sampled), in prefill and in windows alike, so a seeded request's draw at
  a position does not depend on the batch, on which program sampled it or
  on a preemption; unseeded rows are keyed by (runner, row) and a device
  counter, ``_noise_step``, that every sampling step advances.

Batched LoRA (``max_adapters > 0``, ``engine/lora.py``): the runner holds
one pair of stacks per target projection, ``A [L, S, d_in, r]`` and
``B [L, S, r, d_out]`` with ``S = max_adapters + 1`` slots (slot 0 the
base model, all zeros) and every rank padded to ``lora_max_rank``,
allocated once. Every prefill, chunk, window and spec program adds each
row's low-rank delta at every target (``model.lora_delta``); the rows'
slot ids are data (``PrefillSeq.adapter_id``, the packed ``PK_ADAPTER``
column), never part of a program key, so heterogeneous adapters share one
window. ``set_adapter_slot`` writes a slot in place: the window graphs
captured the stacks' addresses.

Weights are bf16, or int8 with float32 per-channel scales (``--quant
int8``, ``quant.QTensor`` leaves): a bf16 tree given with an int8 spec is
quantized here, before the pool is sized from the memory it leaves free.
The pool is bf16, or int8 with per-token scales (``--quant-kv int8``,
``kv_quant.QuantKV``): the prefill scatter and the window commit quantize,
and the attention reads dequantize. Every decode step of every layer runs
the hand-written paged attention kernel (``engine/attention.py``) for the
pool's type on CUDA tensors; CPU tensors take its plain version. Prefill
attention over history is plain torch, as it is XLA in the reference.
Nothing here reads a device value on the host: windows and prefills are
enqueued and the engine reads results back when they are ready.

Disaggregation moves a prompt's pages between pools as host parcels
(``kv_quant``'s layouts). ``extract_pages_async`` gathers the pages on the
device, starts a non-blocking copy into pinned host memory and records a
CUDA event; ``finalize_extract`` (any thread) waits on that event alone
and packs int8 pages on the host. ``insert_pages`` uploads a parcel and
scatters it into the pool, converting between the bf16 and packed forms
as the reference does. Gathers and scatters are plain torch indexing, as
they are XLA in the reference.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from dynamo_tpu_torch.engine import attention, perf
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.kv_quant import (
    BF16, QuantKV, is_packed_parcel, pack_parcel, parcel_to_bf16, quantize_np,
    scatter_tokens, unpack_parcel)
from dynamo_tpu_torch.engine.model import (decode_window_multi_step,
                                           decode_window_step, embed_forward,
                                           init_params, prefill_forward,
                                           prefill_with_history)
from dynamo_tpu_torch.engine.quant import (QTensor, is_quantized,
                                           quantize_params)
from dynamo_tpu_torch.engine.sampler import (gumbel_field,
                                             sample_tokens_per_row)
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("runner")

# Packed per-window control array columns (int32; floats bitcast).
PK_OVERRIDE = 0   # 1 -> take PK_TOKEN instead of the chained device token
PK_TOKEN = 1
PK_POS = 2        # absolute position of the token to be written this window
PK_SEQLEN = 3     # length INCLUDING that token; 0 -> slot inactive
PK_TOPK = 4
PK_TEMP = 5       # float32 bits
PK_TOPP = 6       # float32 bits
PK_CAP = 7        # position capacity = allocated pages * page_size; a slot
                  # freezes when its position reaches this
PK_LOGPROB = 8    # 1 -> this slot wants logprobs (the window computes them
                  # when ANY slot asks; per-slot filtering is host-side)
PK_FREQPEN = 9    # float32 bits: OpenAI frequency_penalty (0 = off)
PK_PRESPEN = 10   # float32 bits: OpenAI presence_penalty (0 = off)
PK_SEED = 11      # int32 sampling seed (meaningful when PK_SEEDED)
PK_SEEDED = 12    # 1 -> slot uses a per-request seeded noise stream
PK_ADAPTER = 13   # resident LoRA adapter slot id (0 = base model)
PK_PREFIX = 14    # page table starts here

TOP_LOGPROBS = 8  # alternatives returned when logprobs are requested

SEED_MASK = 0x7FFFFFFF  # seeds ride int32 control columns: 31 usable bits
# Unseeded rows' noise keys are (runner seed + 1) * 2^32 + row: above every
# masked request seed, so the two key sets never meet.
UNSEEDED_KEY_STRIDE = 1 << 32

# One CUDA graph capture at a time in the process: two engines may share
# it, and the caching allocator must not empty its cache during a capture.
CAPTURE_LOCK = threading.Lock()


def mask_seed(seed: int) -> int:
    """The one place a request seed maps to its 31-bit control value."""
    return int(seed) & SEED_MASK


@dataclasses.dataclass
class PrefillSeq:
    """One whole-prompt or chunk prefill row."""
    tokens: np.ndarray          # [n] chunk tokens
    chunk_pages: np.ndarray     # pages covering the chunk
    sampling: tuple[float, int, float]  # (temperature, top_k, top_p)
    start_pos: int = 0          # absolute position of tokens[0]
    hist_pages: np.ndarray | None = None  # pages before the chunk
    logprobs: bool = False      # row wants first-token logprobs
    penalties: tuple[float, float] = (0.0, 0.0)  # (frequency, presence)
    seed: int | None = None     # per-request sampling seed
    adapter_id: int = 0         # resident LoRA slot (0 = base model)


def logprobs_of(logits: torch.Tensor, sampled: torch.Tensor):
    """(chosen logprob [B], top values [B,K], top ids [B,K] int32) from
    logits [B,V] fp32: log-softmax through one logsumexp, no full sort."""
    lse = torch.logsumexp(logits, dim=-1)
    chosen = torch.gather(logits, 1, sampled.long()[:, None])[:, 0]
    top_v, top_i = torch.topk(logits, TOP_LOGPROBS, dim=-1)
    return chosen - lse, top_v - lse[:, None], top_i.to(torch.int32)


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                    freq: torch.Tensor, pres: torch.Tensor) -> torch.Tensor:
    """OpenAI penalties over generated-token counts [B,V] (vLLM
    semantics): ``logits - freq * count - pres * (count > 0)``."""
    cf = counts.float()
    return logits - freq[:, None] * cf - pres[:, None] * (cf > 0)


def _unsupported(config: EngineConfig) -> list[str]:
    """What the engine cannot serve of ``config``, each with the ROADMAP
    item that ports it (or why nothing will)."""
    spec = config.model
    out = []
    for name in ("tp", "dp", "pp", "sp"):
        if getattr(config, name) != 1:
            out.append(f"{name}={getattr(config, name)} (ROADMAP item 16)")
    if spec.num_experts:
        out.append(f"MoE ({spec.num_experts} experts; ROADMAP item 14)")
    if spec.q_per_kv > attention.MAX_QPK:
        out.append(f"{spec.num_heads} query heads over {spec.num_kv_heads} "
                   f"KV heads: more than {attention.MAX_QPK} query heads per "
                   f"KV head (kMaxQpk of the paged attention kernel, "
                   f"csrc/paged_attention.cu)")
    if spec.quant not in (None, "int8"):
        out.append(f"weight quantization {spec.quant!r} (only int8)")
    if config.spec_decode not in (None, "ngram"):
        out.append(f"spec_decode={config.spec_decode!r} (only 'ngram')")
    if config.attention_backend not in ("auto", "pallas"):
        out.append(f"attention_backend={config.attention_backend!r} (the "
                   f"port always runs its paged attention kernel)")
    if config.warmup_prefill_ladder:
        out.append("warmup_prefill_ladder (no ROADMAP item: the port's "
                   "prefill is eager and has no programs to compile)")
    if config.dtype != "bfloat16":
        out.append(f"dtype={config.dtype}")
    return out


def check_supported(config: EngineConfig) -> None:
    """Raise ValueError naming everything of ``config`` the engine cannot
    serve; the entry points call it before they read any weights."""
    missing = _unsupported(config)
    if missing:
        raise ValueError("not ported yet: " + ", ".join(missing))


class ModelRunner:
    def __init__(self, config: EngineConfig, params: dict | None = None,
                 seed: int = 0):
        check_supported(config)
        # KV-pool quantization with the DTPU_QUANT_KV override applied.
        self.quant_kv = config.resolve_quant_kv()
        if self.quant_kv not in (None, "int8"):
            raise ValueError(
                f"quant_kv must be None or 'int8', got {self.quant_kv!r}")
        self.config = config
        self.spec = spec = config.model
        self.device = torch.device(config.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ModelRunner: device is cuda but no GPU is "
                               "available")
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(spec, gen, self.device)
        if spec.quant == "int8" and not is_quantized(params):
            # The bf16 tree (the runner's own for random weights) is dropped
            # here; _sized_pages empties the allocator's cache before it
            # reads the free memory, so the pool is not sized as if the
            # bf16 weights were still resident.
            params = quantize_params(params)
        self.params = params
        del params
        self._sized_pages()
        kv_shape = (spec.num_layers, spec.num_kv_heads, self.num_pages,
                    config.page_size, spec.head_dim)
        self.k_cache = self._zero_pool(kv_shape)
        self.v_cache = self._zero_pool(kv_shape)
        self.param_bytes = sum(t.numel() * t.element_size()
                               for t in _leaves(self.params))
        # The pool's real bytes: bf16 values, or int8 values + f32 scales.
        self.kv_pool_bytes = self.k_cache.nbytes + self.v_cache.nbytes
        # Unseeded sampling rows: key base and the device step counter.
        self._unseeded_key = (seed + 1) * UNSEEDED_KEY_STRIDE
        self._noise_step = torch.zeros(1, dtype=torch.int64,
                                       device=self.device)
        # The chained next-token per slot, on device: one fixed tensor,
        # written in place by prefills and by every window program.
        self.tokens_dev = torch.zeros(config.max_num_seqs, dtype=torch.int32,
                                      device=self.device)
        # Speculative decoding only: every slot's token history, which the
        # drafter looks up on the device, and its next position, which
        # chains between windows on the device because a window advances
        # a slot by how many drafts it accepted. Each has one sink entry
        # past the end (column H of hist_dev, slot max_num_seqs of
        # positions_dev) that takes the writes the reference drops.
        self.hist_dev = self.positions_dev = None
        if config.spec_decode:
            hist_w = config.max_pages_per_seq * config.page_size
            self.hist_dev = torch.zeros((config.max_num_seqs, hist_w + 1),
                                        dtype=torch.int32, device=self.device)
            self.positions_dev = torch.zeros(config.max_num_seqs + 1,
                                             dtype=torch.int32,
                                             device=self.device)
        # Window programs by key (``_get_window``); on the card they are
        # CUDA graphs sharing one memory pool and one capture stream.
        self.use_graphs = self.device.type == "cuda"
        self._window_cache: dict[tuple, WindowProgram] = {}
        self._graph_pool = None
        self._capture_stream = None
        self.window_replays = 0   # windows run as graph replays
        self.capture_seconds = 0.0
        # Perf plane (engine/perf.py): this runner's captures per key (a
        # second capture of a key after warmup is flagged) and the keys
        # of its program-less families already counted at first use.
        self._perf = perf.get_registry()
        self._captures: dict[tuple, int] = {}
        self._first_uses: set[tuple] = set()
        # Penalty state: generated-token counts per slot (saturating).
        self.counts = torch.zeros((config.max_num_seqs, spec.vocab_size),
                                  dtype=torch.uint8, device=self.device)
        # Logits [n, V] of the latest prefill_batch, after penalties (a
        # device tensor; nothing reads it back unless a caller does).
        self.last_prefill_logits: torch.Tensor | None = None
        # Bytes the paged attention launches of all windows so far must
        # move (attention.hist_flash_bytes), counted on the host.
        self.attention_bytes = 0
        # Batched LoRA stacks, allocated once: set_adapter_slot writes
        # slots in place, so the window graphs' addresses stay valid.
        self.lora = None
        if config.max_adapters > 0:
            S, r, L = (config.max_adapters + 1, config.lora_max_rank,
                       spec.num_layers)
            self.lora = {
                key: {"a": torch.zeros((L, S, d_in, r), dtype=torch.bfloat16,
                                       device=self.device),
                      "b": torch.zeros((L, S, r, d_out), dtype=torch.bfloat16,
                                       device=self.device)}
                for key, (d_in, d_out) in config.lora_target_shapes().items()}
        self.lora_bytes = sum(t.nbytes for ab in (self.lora or {}).values()
                              for t in ab.values())

    # -- setup ---------------------------------------------------------------
    def _zero_pool(self, shape):
        """One of K/V: bf16 zeros, or int8 zeros with zero scales (an
        unwritten page reads as 0 either way; every write goes through
        kv_quantize, whose scales are never 0)."""
        if self.quant_kv == "int8":
            return QuantKV(
                torch.zeros(shape, dtype=torch.int8, device=self.device),
                torch.zeros(shape[:-1], dtype=torch.float32,
                            device=self.device))
        return torch.zeros(shape, dtype=torch.bfloat16, device=self.device)

    def _sized_pages(self) -> None:
        """Pool pages: config.num_pages, or a hbm_kv_budget_frac share of
        the device memory left free after the params."""
        cfg = self.config
        if cfg.num_pages is not None:
            self.num_pages = cfg.num_pages
            return
        if self.device.type != "cuda":
            raise ValueError("num_pages must be set when the runner is not "
                             "on a GPU (there is no free memory to size from)")
        with CAPTURE_LOCK:  # another engine's capture may be under way
            torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info(self.device)
        budget = max(64 << 20, int(free * cfg.hbm_kv_budget_frac))
        page_bytes = cfg.kv_token_bytes() * cfg.page_size
        self.num_pages = max(16, budget // page_bytes)
        log.info("KV pool: %d pages of %d tokens (%.1f GiB)", self.num_pages,
                 cfg.page_size, self.num_pages * page_bytes / (1 << 30))

    def _pinned(self, arr: np.ndarray) -> torch.Tensor:
        """Host array as a CPU tensor, page-locked when the runner is on
        the card. Torch's pinned allocator does not hand the block out
        again before the copies queued from it have run, so a fresh
        buffer per upload never races a queued copy."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device without waiting for queued device work."""
        return self._pinned(arr).to(self.device, non_blocking=True)

    def _draw(self, seeded: torch.Tensor | None, seeds: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
        """Gumbel noise [B, V] for one sampling step, on the device. Row b
        is keyed by (seeds[b], positions[b]: the position of the token
        being sampled) where ``seeded[b]``, else by (this runner, b) and
        the noise step, which this advances; ``seeded`` None means no
        seeded row."""
        b = positions.shape[0]
        keys = self._unseeded_key + torch.arange(b, device=self.device)
        counters = self._noise_step.expand(b)
        if seeded is not None:
            keys = torch.where(seeded, seeds.long(), keys)
            counters = torch.where(seeded, positions.long(), counters)
        noise = gumbel_field(keys, counters, self.spec.vocab_size)
        self._noise_step += 1
        return noise

    def _noise(self, sampling: np.ndarray, seeds: np.ndarray,
               seeded: np.ndarray, positions: np.ndarray):
        """A prefill's first-token noise [B, V] (``_draw``), or None when
        no row samples."""
        if not sampling.any():
            return None
        mask = self._upload(np.asarray(seeded, bool)) if seeded.any() else None
        return self._draw(mask, self._upload(np.asarray(seeds, np.int64)),
                          self._upload(np.asarray(positions, np.int64)))

    # -- public API (called from the engine thread) --------------------------
    def _prefill_logits(self, seqs: list[PrefillSeq]) -> torch.Tensor:
        """Run one prefill program over ``seqs`` (padded to the bucket of
        the longest; rows with history read their earlier pages) and
        return the last valid position's logits [n, V]."""
        cfg = self.config
        page = cfg.page_size
        n_max = max(len(s.tokens) for s in seqs)
        if n_max > cfg.max_prompt_len:
            raise ValueError(f"prefill of {n_max} tokens exceeds the longest "
                             f"one program takes ({cfg.max_prompt_len})")
        bucket = cfg.bucket_for(n_max)
        b = len(seqs)
        tokens = np.zeros((b, bucket), np.int32)
        positions = np.zeros((b, bucket), np.int32)
        # Padding page-table entries stay 0 = the allocator's scratch page.
        table = np.zeros((b, bucket // page), np.int32)
        lens = np.zeros(b, np.int32)
        ids = np.zeros(b, np.int32)
        for i, s in enumerate(seqs):
            n = len(s.tokens)
            tokens[i, :n] = s.tokens
            positions[i] = s.start_pos + np.minimum(np.arange(bucket), n - 1)
            table[i, :len(s.chunk_pages)] = s.chunk_pages
            lens[i] = n
            ids[i] = s.adapter_id
        self._check_adapter_ids(ids)
        args = (self.params, self.spec, self.k_cache, self.v_cache,
                self._upload(tokens), self._upload(positions),
                self._upload(table), self._upload(lens))
        lora = {}
        if self.lora is not None:
            # Every prefill carries the stacks: the rows' ids are data.
            lora = dict(lora=self.lora, adapter_ids=self._upload(ids))
        with_hist = [i for i, s in enumerate(seqs)
                     if s.hist_pages is not None and len(s.hist_pages)]
        if not with_hist:
            self._note_first_use("prefill", (bucket, 0))
            return prefill_forward(*args, **lora)[0]
        # Rows without history keep hist_lens 0 and read nothing.
        width = self.bucket_pages_for(max(len(seqs[i].hist_pages)
                                          for i in with_hist))
        self._note_first_use("prefill", (bucket, width))
        hist_table = np.zeros((b, width), np.int32)
        hist_lens = np.zeros(b, np.int32)
        for i in with_hist:
            s = seqs[i]
            if s.start_pos != len(s.hist_pages) * page:
                raise ValueError(
                    f"a chunk at position {s.start_pos} needs "
                    f"{s.start_pos // page} whole history pages, got "
                    f"{len(s.hist_pages)}")
            hist_table[i, :len(s.hist_pages)] = s.hist_pages
            hist_lens[i] = s.start_pos
        return prefill_with_history(*args, self._upload(hist_table),
                                    self._upload(hist_lens), **lora)[0]

    def prefill_batch(self, seqs: list[PrefillSeq],
                      slots: list[int] | None = None,
                      count_rows: np.ndarray | None = None):
        """Prefill whole prompts or final chunks and sample each row's
        first token. ``count_rows`` [n, V] uint8 (the rows' generated-token
        counts so far) turns on the penalties. With ``slots`` the tokens are
        also written into ``tokens_dev[slots]``, and with ``count_rows``
        the counts (bumped by the sampled token) into ``counts[slots]``.

        Returns (tokens [n] int32, logprobs [n], top values [n, K], top ids
        [n, K]) as device tensors, the last three None unless a row asks
        for logprobs; the caller reads them back when ready."""
        logits = self._prefill_logits(seqs)
        b = len(seqs)
        temp = np.zeros(b, np.float32)
        top_k = np.zeros(b, np.int32)
        top_p = np.ones(b, np.float32)
        seeds = np.zeros(b, np.int64)
        seeded = np.zeros(b, bool)
        ends = np.zeros(b, np.int64)
        for i, s in enumerate(seqs):
            temp[i], top_k[i], top_p[i] = s.sampling
            if s.seed is not None:
                seeds[i] = mask_seed(s.seed)
                seeded[i] = True
            ends[i] = s.start_pos + len(s.tokens)
        if count_rows is not None:
            pen = np.asarray([s.penalties for s in seqs], np.float32)
            rows = self._upload(np.asarray(count_rows, np.uint8))
            logits = apply_penalties(logits, rows, self._upload(pen[:, 0]),
                                     self._upload(pen[:, 1]))
        self.last_prefill_logits = logits
        # The first generated token lands at position start + n.
        noise = self._noise(temp > 0, seeds, seeded, ends)
        sampled = sample_tokens_per_row(
            logits, self._upload(temp), self._upload(top_k),
            self._upload(top_p), noise)
        if slots is not None:
            idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
            self.tokens_dev[idx] = sampled
            if count_rows is not None:
                n = torch.arange(b, device=self.device)
                tok = sampled.long()
                bumped = rows.clone()
                bumped[n, tok] += (rows[n, tok] < 255).to(torch.uint8)
                self.counts[idx] = bumped
        lp = top_v = top_i = None
        if any(s.logprobs for s in seqs):
            lp, top_v, top_i = logprobs_of(logits, sampled)
        return sampled, lp, top_v, top_i

    def embed(self, token_lists: list[list[int]],
              pooling: str = "last") -> np.ndarray:
        """Pooled, L2-normalized embeddings [n, H] float32 on the host for
        a batch of prompts, padded to the bucket of the longest and to a
        power-of-two batch (padding rows: token 0, length 1, dropped).
        Eager, like the prefill: no CUDA graph."""
        cfg = self.config
        if not token_lists or any(not t for t in token_lists):
            raise ValueError("embeddings need at least one non-empty input")
        n_max = max(len(t) for t in token_lists)
        if n_max > cfg.prefill_buckets[-1]:
            raise ValueError(
                f"embedding input of {n_max} tokens exceeds the largest "
                f"prefill bucket ({cfg.prefill_buckets[-1]})")
        bucket = cfg.bucket_for(n_max)
        bp = 1
        while bp < len(token_lists):
            bp *= 2
        toks = np.zeros((bp, bucket), np.int32)
        lens = np.ones((bp,), np.int32)
        for i, t in enumerate(token_lists):
            toks[i, :len(t)] = t
            lens[i] = len(t)
        self._note_first_use("embed", (bucket, bp, pooling))
        out = embed_forward(self.params, self.spec, self._upload(toks),
                            self._upload(lens), pooling=pooling)
        return out[:len(token_lists)].cpu().numpy()

    def prefill_chunk_async(self, seq: PrefillSeq) -> None:
        """Enqueue one intermediate chunk of a long prompt. Nothing comes
        back to the host: the chunk's K/V lands in its pages, which the
        next chunk reads as history later on the same stream."""
        self._prefill_logits([seq])

    def set_count_rows(self, slots: list[int], rows: np.ndarray) -> None:
        """Install penalty-count rows [n, V] uint8 for ``slots``."""
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        self.counts[idx] = self._upload(np.asarray(rows, np.uint8))

    def bucket_pages_for(self, needed: int) -> int:
        """Page-table width bucket (power of two, >= 8) for a window."""
        b = 8
        maxp = self.config.max_pages_per_seq
        while b < needed and b < maxp:
            b *= 2
        return min(b, maxp)

    def _program(self, key: tuple) -> "WindowProgram":
        """The window program of one key (``WindowProgram``), made at its
        first use; on the card it is captured then."""
        prog = self._window_cache.get(key)
        if prog is None:
            prog = self._window_cache[key] = WindowProgram(self, key)
        return prog

    def _get_window(self, window: int, bucket_pages: int,
                    penalized: bool, seeded: bool,
                    logprobs: bool) -> "WindowProgram":
        return self._program((window, bucket_pages, penalized, seeded,
                              logprobs))

    def _get_spec_window(self, m_outer: int, k: int,
                         bucket_pages: int) -> "WindowProgram":
        """The speculative window program (the reference's
        ``_get_spec_window``): m_outer verify steps of up to ``k`` drafts.
        Temperature, top-k, top-p and seed are data, so one program serves
        every sampling mix of a bucket."""
        return self._program(("spec", m_outer, k, bucket_pages))

    def _check_adapter_ids(self, ids: np.ndarray) -> None:
        """Rows' adapter slots must be resident slots of this runner."""
        top = self.config.max_adapters if self.lora is not None else 0
        if ((ids < 0) | (ids > top)).any():
            raise ValueError(f"adapter slot ids {sorted(set(ids.tolist()))} "
                             f"outside [0, {top}] (max_adapters "
                             f"{self.config.max_adapters})")

    def _window_history(self, packed: np.ndarray) -> np.ndarray:
        """Host checks of a window's packed array; returns each slot's
        cache-resident history at dispatch (PK_SEQLEN - 1)."""
        self._check_adapter_ids(packed[:, PK_ADAPTER])
        h_hist = np.maximum(packed[:, PK_SEQLEN].astype(np.int64) - 1, 0)
        if (h_hist > (packed.shape[1] - PK_PREFIX)
                * self.config.page_size).any():
            raise ValueError("a slot's history is longer than its page-table "
                             "row covers")
        return h_hist

    def decode_window(self, packed: np.ndarray, window: int):
        """Run one M-step decode window.

        packed [max_num_seqs, PK_PREFIX + bucket_pages] int32 (see PK_*
        columns). Returns (tokens [M,B] int32, logprobs [M,B], top values
        [M,B,K], top ids [M,B,K]) as device tensors, the last three None
        unless some slot sets PK_LOGPROB. On the card they are the
        program's output buffers: valid until the next window's replay, so
        the caller queues their copies before it dispatches another."""
        M = int(window)
        spec = self.spec
        h_hist = self._window_history(packed)
        # Every step of every layer launches the kernel over this history.
        per_launch = attention.hist_flash_bytes(h_hist, spec.num_heads,
                                                self.k_cache)
        self.attention_bytes += M * spec.num_layers * per_launch
        self._maybe_cost("decode_window", packed, M, 1, h_hist)
        prog = self._get_window(
            M, packed.shape[1] - PK_PREFIX,
            penalized=bool(packed[:, PK_FREQPEN].any()
                           or packed[:, PK_PRESPEN].any()),
            seeded=bool(packed[:, PK_SEEDED].any()),
            logprobs=bool(packed[:, PK_LOGPROB].any()))
        return prog.run(packed)

    def decode_spec_window(self, packed: np.ndarray, m_outer: int, k: int):
        """Run one speculative window: ``m_outer`` verify steps of up to
        ``k`` n-gram drafts each (``_spec_body``). Tokens, positions and
        the token history chain on the device (``tokens_dev``,
        ``positions_dev``, ``hist_dev``); a slot with PK_OVERRIDE starts
        at PK_TOKEN and PK_POS instead.

        Returns (tokens [m_outer,B,k+1], emitted [m_outer,B], drafts
        [m_outer,B]) int32 device tensors: step m of slot b emitted its
        first emitted[m,b] tokens (0: frozen or inactive; 1: no draft
        accepted) after proposing drafts[m,b]. On the card they are the
        program's output buffers, as in ``decode_window``."""
        if self.hist_dev is None:
            raise ValueError("decode_spec_window needs spec_decode set")
        spec = self.spec
        h_hist = self._window_history(packed)
        # Every verify step of every layer launches the kernel once over
        # the k+1 rows of each slot, each reading the slot's history (the
        # host's dispatch-time bound on it).
        per_launch = attention.hist_flash_bytes(np.repeat(h_hist, k + 1),
                                                spec.num_heads, self.k_cache)
        self.attention_bytes += m_outer * spec.num_layers * per_launch
        self._maybe_cost("spec_window", packed, m_outer, k + 1, h_hist)
        prog = self._get_spec_window(int(m_outer), int(k),
                                     packed.shape[1] - PK_PREFIX)
        return prog.run(packed)

    # -- perf plane (engine/perf.py) -------------------------------------------
    def _note_first_use(self, family: str, key: tuple) -> None:
        """Count a program-less family's key at its first use (the
        counterpart of the reference's compile of that key)."""
        if (family, key) not in self._first_uses:
            self._first_uses.add((family, key))
            self._perf.note_compile(family, key, 0.0, unexpected=False)

    def note_capture(self, key: tuple, seconds: float) -> None:
        """A window program of ``key`` was captured (on the CPU: run the
        first time). A second capture of the same key by this runner after
        the engine's warmup boundary is flagged, as the reference flags a
        second compile of one wrapper."""
        n = self._captures.get(key, 0)
        self._captures[key] = n + 1
        family = "spec_window" if key[0] == "spec" else "decode_window"
        self._perf.note_compile(
            family, key, seconds,
            unexpected=n >= 1 and self._perf.warmup_complete)

    def _maybe_cost(self, family: str, packed: np.ndarray, steps: int,
                    positions: int, h_hist: np.ndarray) -> None:
        """The family's one-time analytic cost, at its first window with
        live rows: per step, the weights read once plus the paged
        attention's bytes of every layer, and 2 flops per parameter per
        row position plus the attention's 4 x D per (query head, history
        token) of every layer. ``positions`` is the rows each slot
        forwards per step (1, or k + 1 for a verify step)."""
        live = packed[:, PK_SEQLEN] > 0
        if not live.any() or not self._perf.wants_cost(family):
            return
        spec = self.spec
        hist = np.repeat(h_hist * live, positions)
        per_launch = attention.hist_flash_bytes(hist, spec.num_heads,
                                                self.k_cache)
        rows = int(live.sum()) * positions
        attn_flops = 4 * spec.head_dim * spec.num_heads * int(hist.sum())
        self._perf.set_cost(
            family,
            flops=steps * (2 * spec.num_params() * rows
                           + spec.num_layers * attn_flops),
            bytes_accessed=steps * (self.param_bytes
                                    + spec.num_layers * per_launch))

    def hbm_stats(self) -> dict:
        """The caching allocator's device-memory figures, under the
        reference's field names: ``bytes_in_use`` and ``peak_bytes_in_use``
        are ``torch.cuda.memory_stats`` allocated bytes (current and peak;
        ``memory_allocated()``), ``bytes_limit`` the device's total memory.
        ``{}`` on the CPU, as the reference answers on a backend without
        the API; on the card a failure raises."""
        if self.device.type != "cuda":
            return {}
        stats = torch.cuda.memory_stats(self.device)
        return {"bytes_in_use": int(stats["allocated_bytes.all.current"]),
                "peak_bytes_in_use": int(stats["allocated_bytes.all.peak"]),
                "bytes_limit": int(torch.cuda.get_device_properties(
                    self.device).total_memory)}

    def memory_breakdown(self) -> dict:
        """Params / KV-pool / workspace attribution of device memory from
        the runner's own ledgers (``param_bytes``, ``kv_pool_bytes``).
        ``workspace_bytes`` is everything else the process holds: the
        allocated bytes that are neither weights nor pool, with the window
        graphs' private pool (``graph_pool_bytes``) counted at what it
        reserves rather than at what is allocated in it between replays.
        None on the CPU."""
        hbm = self.hbm_stats()
        in_use = hbm.get("bytes_in_use")
        workspace = None
        if in_use is not None:
            workspace = max(0, in_use - self.param_bytes
                            - self.kv_pool_bytes)
            if self._graph_pool is not None:
                pool = tuple(self._graph_pool)
                segs = [seg for seg in torch.cuda.memory_snapshot()
                        if tuple(seg["segment_pool_id"]) == pool]
                workspace += sum(seg["total_size"] - seg["allocated_size"]
                                 for seg in segs)
        return {"params_bytes": self.param_bytes,
                "kv_pool_bytes": self.kv_pool_bytes,
                "workspace_bytes": workspace}

    def seed_history(self, entries: list[tuple]) -> None:
        """Write prompt tokens into ``hist_dev`` and set ``positions_dev``
        for spec decode (a no-op without it), as the reference's
        ``seed_history``. Entries: (slot, tokens, start_pos, final,
        first_token). A ``final`` entry also writes the chained first token
        at start_pos + len(tokens), ``first_token`` when the host knows it
        (not None) and else ``tokens_dev[slot]``, and sets the slot's
        position there. Rows pad to power-of-two buckets as in the
        reference; every write the reference drops goes to a sink (column
        H of the history, slot max_num_seqs of the positions), so no two
        kept writes share an index. One scatter into each buffer."""
        if self.hist_dev is None or not entries:
            return
        n_max = max(len(t) for _, t, _, _, _ in entries)
        bucket = 64
        while bucket < n_max:
            bucket *= 2
        bp = 1
        while bp < len(entries):
            bp *= 2
        H = self.hist_dev.shape[1] - 1
        toks = np.zeros((bp, bucket + 1), np.int32)
        cols = np.full((bp, bucket + 1), H, np.int64)
        slots = np.zeros(bp, np.int64)
        lens = np.zeros(bp, np.int64)
        first = np.full(bp, -1, np.int32)      # -1: from tokens_dev
        pslot = np.full(bp, self.positions_dev.shape[0] - 1, np.int64)
        pval = np.zeros(bp, np.int32)
        for i, (slot, t, start, final, first_tok) in enumerate(entries):
            n = len(t)
            toks[i, :n] = t
            idx = start + np.arange(n + int(bool(final)))
            cols[i, :len(idx)] = np.where(idx < H, idx, H)
            slots[i], lens[i] = slot, n
            if final:
                pslot[i], pval[i] = slot, start + n
                if first_tok is not None:
                    first[i] = first_tok
        slots_dev = self._upload(slots)
        first_dev = self._upload(first)
        vals = self._upload(toks)
        # Column len of a final row holds its first token.
        vals.scatter_(1, self._upload(lens)[:, None], torch.where(
            first_dev >= 0, first_dev, self.tokens_dev[slots_dev])[:, None])
        self.hist_dev[slots_dev[:, None], self._upload(cols)] = vals
        self.positions_dev[self._upload(pslot)] = self._upload(pval)

    def _spec_outputs(self, key: tuple) -> tuple:
        """Fresh output tensors of one spec window of ``key``: tokens
        [m_outer, B, k+1], emitted and drafts [m_outer, B]."""
        _, m_outer, k, _ = key
        B, dev = self.config.max_num_seqs, self.device
        return (torch.empty((m_outer, B, k + 1), dtype=torch.int32,
                            device=dev),
                torch.empty((m_outer, B), dtype=torch.int32, device=dev),
                torch.empty((m_outer, B), dtype=torch.int32, device=dev))

    def _window_outputs(self, key: tuple) -> tuple:
        """Fresh output tensors of one window of ``key``: tokens [M, B]
        and, for a logprobs program, logprobs and the top values and ids;
        None for those otherwise."""
        B, dev = self.config.max_num_seqs, self.device
        M, logprobs = key[0], key[4]
        toks = torch.empty((M, B), dtype=torch.int32, device=dev)
        if not logprobs:
            return toks, None, None, None
        return (toks, torch.empty((M, B), dtype=torch.float32, device=dev),
                torch.empty((M, B, TOP_LOGPROBS), dtype=torch.float32,
                            device=dev),
                torch.empty((M, B, TOP_LOGPROBS), dtype=torch.int32,
                            device=dev))

    def _lora_of(self, dev: torch.Tensor) -> dict:
        """The forwards' LoRA arguments for a program over the packed
        array ``dev``: the stacks and the rows' PK_ADAPTER slot ids, read
        on the device (none without adapters)."""
        if self.lora is None:
            return {}
        return dict(lora=self.lora, adapter_ids=dev[:, PK_ADAPTER])

    def _window_body(self, key: tuple, dev: torch.Tensor, outs: tuple) -> None:
        """The window program's body (the reference's ``run_window``) for
        ``key``, reading the packed control array ``dev`` on the device
        and writing ``outs`` (``_window_outputs``), ``tokens_dev``, the
        pool, ``counts`` (penalized programs) and the noise step in place.
        It branches on the key only, never on a value of ``dev``."""
        M, _, penalized, seeded, want_lp = key
        toks, lps, top_vs, top_is = outs
        spec, page = self.spec, self.config.page_size
        B = dev.shape[0]
        tokens = torch.where(dev[:, PK_OVERRIDE] > 0, dev[:, PK_TOKEN],
                             self.tokens_dev)
        positions0 = dev[:, PK_POS]
        seq_lens0 = dev[:, PK_SEQLEN]
        cap = dev[:, PK_CAP]
        top_k = dev[:, PK_TOPK]
        temp = dev[:, PK_TEMP].view(torch.float32)
        top_p = dev[:, PK_TOPP].view(torch.float32)
        freq_pen = dev[:, PK_FREQPEN].view(torch.float32)
        pres_pen = dev[:, PK_PRESPEN].view(torch.float32)
        seed_rows = dev[:, PK_SEEDED] > 0 if seeded else None
        lora = self._lora_of(dev)
        page_table = dev[:, PK_PREFIX:].contiguous()
        # The cache-resident history is fixed across the window: the
        # window's own tokens live in kbuf/vbuf until the commit below.
        hist_lens = torch.clamp(seq_lens0 - 1, min=0).to(torch.int32)
        L, nkv, d = spec.num_layers, spec.num_kv_heads, spec.head_dim
        kbuf = torch.zeros((L, nkv, B, M, d), dtype=self.k_cache.dtype,
                           device=self.device)
        vbuf = torch.zeros_like(kbuf)
        rows = torch.arange(B, device=self.device)
        positions = positions0
        for m in range(M):
            # A slot advances while live and below its cap, and freezes
            # at the cap (the host emits LENGTH when it sees it).
            live = (seq_lens0 > 0) & (positions < cap)
            logits, k_new, v_new = decode_window_step(
                self.params, spec, self.k_cache, self.v_cache, kbuf, vbuf, m,
                tokens, positions, page_table, hist_lens,
                attention_impl=attention.paged_window_attention, **lora)
            kbuf[:, :, :, m] = k_new.transpose(1, 2)
            vbuf[:, :, :, m] = v_new.transpose(1, 2)
            if penalized:
                # Subtracted before temperature and top-k.
                logits = apply_penalties(logits, self.counts, freq_pen,
                                         pres_pen)
            # The token being sampled lands at positions + 1.
            noise = self._draw(seed_rows, dev[:, PK_SEED], positions + 1)
            sampled = sample_tokens_per_row(logits, temp, top_k, top_p, noise)
            toks[m] = sampled
            if penalized:
                # Saturating count bump for each live slot's token.
                tok = sampled.long()
                cur = self.counts[rows, tok]
                self.counts[rows, tok] = cur + (live & (cur < 255)).to(
                    torch.uint8)
            if want_lp:
                lps[m], top_vs[m], top_is[m] = logprobs_of(logits, sampled)
            tokens = torch.where(live, sampled, tokens)
            positions = positions + live.to(positions.dtype)
        self.tokens_dev.copy_(tokens)
        # Commit: every (step, slot) entry into its page; frozen and
        # inactive entries land on the scratch page 0.
        m_idx = torch.arange(M, device=self.device)[:, None]
        adv = torch.clamp(torch.minimum(m_idx, (cap - positions0)[None, :]),
                          min=0)
        pos_m = positions0[None, :] + adv                        # [M, B]
        live_m = (seq_lens0[None, :] > 0) & (pos_m < cap[None, :])
        pidx = torch.clamp(pos_m // page, 0, page_table.shape[1] - 1)
        dest = page_table[rows[None, :], pidx.long()]            # [M, B]
        dest = torch.where(live_m, dest, 0)
        off = torch.where(live_m, pos_m % page, 0)
        # kbuf [L,Nkv,B,M,D] -> [L,Nkv,M,B,D] to match [M,B] indices.
        scatter_tokens(self.k_cache, kbuf.transpose(2, 3), dest, off)
        scatter_tokens(self.v_cache, vbuf.transpose(2, 3), dest, off)

    def _spec_body(self, key: tuple, dev: torch.Tensor, outs: tuple) -> None:
        """The spec program's body (the reference's ``run_spec``), reading
        the packed array ``dev`` and writing ``outs``, ``tokens_dev``,
        ``positions_dev``, ``hist_dev``, the pool and the noise step in
        place. Each verify step:

        1. feeds each live slot's chained token at its position (recorded
           in the history: hist[pos] is the token fed);
        2. drafts up to k tokens by bigram lookup: the latest earlier j
           with hist[j:j+2] equal to (hist[pos-1], token), the drafts
           being hist[j+2:j+2+k], valid as a prefix, inside the history
           and below the slot's cap;
        3. forwards the token and its drafts as one [B, k+1] block
           (``decode_window_multi_step`` over ``paged_verify_attention``);
        4. draws one target sample per position, keyed for a seeded row by
           (seed, landing position pos+1+j) and else by (runner, row,
           column) and the noise step; a draft is accepted while the
           sample reproduces it (rejection sampling for a point-mass
           drafter), and the slot emits its a accepted drafts' samples
           and the next, e = a + 1 tokens (0 when frozen or inactive);
        5. appends the emitted positions' K/V to the window buffer and
           their tokens to the history.

        After the steps one scatter commits the buffer's columns < wlen
        into the pool. Writes the reference drops land on sinks: column W
        of the window buffer and column H of the history. It branches on
        the key only."""
        _, m_outer, k, _ = key
        out_t, emit_t, ndraft_t = outs
        spec, page, dv = self.spec, self.config.page_size, self.device
        S, W = k + 1, m_outer * (k + 1)
        B = dev.shape[0]
        hist = self.hist_dev
        H = hist.shape[1] - 1
        override = dev[:, PK_OVERRIDE] > 0
        tokens = torch.where(override, dev[:, PK_TOKEN], self.tokens_dev)
        pos0 = torch.where(override, dev[:, PK_POS], self.positions_dev[:B])
        active = dev[:, PK_SEQLEN] > 0
        cap = dev[:, PK_CAP]
        # Per (row, verify column) sampling: a column takes its row's.
        temp_s = attention.fold_rows(dev[:, PK_TEMP].view(torch.float32), S)
        top_k_s = attention.fold_rows(dev[:, PK_TOPK], S)
        top_p_s = attention.fold_rows(dev[:, PK_TOPP].view(torch.float32), S)
        seeded_s = attention.fold_rows(dev[:, PK_SEEDED] > 0, S)
        seed_s = attention.fold_rows(dev[:, PK_SEED], S)
        lora = self._lora_of(dev)
        page_table = dev[:, PK_PREFIX:].contiguous()
        # The cache-resident history is fixed across the window (pos0):
        # what the window produces lives in the buffer until the commit.
        hist_lens = torch.where(active, pos0, 0)
        L, nkv, d = spec.num_layers, spec.num_kv_heads, spec.head_dim
        kbuf = torch.zeros((L, nkv, B, W + 1, d), dtype=self.k_cache.dtype,
                           device=dv)
        vbuf = torch.zeros_like(kbuf)
        rows = torch.arange(B, device=dv)
        j_s = torch.arange(S, device=dv)
        j_k = j_s[:k]
        jidx = torch.arange(H - 1, device=dv)
        pos = pos0
        wlen = torch.zeros(B, dtype=torch.int32, device=dv)
        for m in range(m_outer):
            live = active & (pos < cap)
            safe = torch.clamp(pos, 0, H - 1).long()
            hist[rows, safe] = torch.where(live, tokens, hist[rows, safe])
            x1 = hist[rows, torch.clamp(pos - 1, 0, H - 1).long()]
            match = ((hist[:, :H - 1] == x1[:, None])
                     & (hist[:, 1:H] == tokens[:, None])
                     & (jidx[None, :] + 1 < pos[:, None]))
            jstar = torch.where(match, jidx[None, :], -1).amax(dim=1)
            found = (jstar >= 0) & (pos >= 1) & live
            didx = jstar[:, None] + 2 + j_k[None, :]                 # [B,k]
            drafts = hist[rows[:, None], torch.clamp(didx, 0, H - 1)]
            dvalid = (found[:, None] & (didx <= pos[:, None])
                      & (pos[:, None] + 1 + j_k[None, :] < cap[:, None]))
            dvalid = torch.cumprod(dvalid.to(torch.int32), dim=1).bool()
            tok_blk = torch.cat([tokens[:, None],
                                 torch.where(dvalid, drafts, 0)], dim=1)
            logits, k_new, v_new = decode_window_multi_step(
                self.params, spec, self.k_cache, self.v_cache,
                kbuf[:, :, :, :W], vbuf[:, :, :, :W], wlen, tok_blk,
                pos[:, None] + j_s[None, :], page_table, hist_lens,
                attention_impl=attention.paged_verify_attention, **lora)
            # Column j's token lands at pos + 1 + j.
            noise = self._draw(seeded_s, seed_s,
                               (pos[:, None] + 1 + j_s[None, :]).reshape(-1))
            out = sample_tokens_per_row(
                logits.reshape(B * S, -1), temp_s, top_k_s, top_p_s,
                noise).reshape(B, S)
            eq = (drafts == out[:, :k]) & dvalid
            a = torch.cumprod(eq.to(torch.int32), dim=1).sum(
                dim=1, dtype=torch.int32)
            e = torch.where(live, a + 1, 0)
            kept = j_s[None, :] < e[:, None]
            cols = torch.where(kept, wlen[:, None] + j_s[None, :], W).long()
            kbuf[:, :, rows[:, None], cols] = k_new.permute(0, 3, 1, 2, 4)
            vbuf[:, :, rows[:, None], cols] = v_new.permute(0, 3, 1, 2, 4)
            hidx = pos[:, None] + 1 + j_s[None, :]
            hist[rows[:, None], torch.where(kept & (hidx < H), hidx,
                                            H).long()] = out
            tokens = torch.where(live, out[rows, a.long()], tokens)
            pos = pos + e
            wlen = wlen + e
            out_t[m] = out
            emit_t[m] = e
            ndraft_t[m] = dvalid.sum(dim=1, dtype=torch.int32)
        self.tokens_dev.copy_(tokens)
        self.positions_dev[:B].copy_(pos)
        # Commit: buffer column c holds position pos0 + c; columns >= wlen
        # land on the scratch page 0.
        c = torch.arange(W, device=dv)[None, :]
        abspos = pos0[:, None] + c
        valid = c < wlen[:, None]
        pidx = torch.clamp(abspos // page, 0, page_table.shape[1] - 1)
        dest = torch.where(valid, torch.gather(page_table, 1, pidx.long()), 0)
        off = torch.where(valid, abspos % page, 0)
        scatter_tokens(self.k_cache, kbuf[:, :, :, :W], dest, off)
        scatter_tokens(self.v_cache, vbuf[:, :, :, :W], dest, off)

    def window_programs(self) -> dict:
        """Programs made, of them captured, their capture seconds and the
        graph pool's bytes (0 before any capture)."""
        return {"programs": len(self._window_cache),
                "captured": sum(p.graph is not None
                                for p in self._window_cache.values()),
                "capture_s": self.capture_seconds,
                "graph_pool_bytes": self.graph_pool_bytes()}

    def graph_pool_bytes(self) -> int:
        """Device memory the window graphs' pool holds (its segments in
        the caching allocator's snapshot)."""
        if self._graph_pool is None:
            return 0
        pool = tuple(self._graph_pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)

    # -- batched LoRA (engine/lora.py) ----------------------------------------
    def set_adapter_slot(self, slot: int, host: dict) -> None:
        """Write one adapter into device slot ``slot`` (the adapter
        store's hot-load, on the engine thread). ``host`` is the whole
        target set ``{key: (A [L, d_in, r], B [L, r, d_out])}`` of bf16
        host tensors: projections an adapter does not target come as
        zeros, so a slot never keeps a previous tenant's deltas.

        The slot is written in place (``copy_`` into ``[:, slot]``), never
        rebound: every window program captured the stacks' addresses. The
        copies queue on the stream behind the windows already dispatched,
        which may still read the slot's old weights for rows whose results
        nobody reads; on the card from page-locked copies, so the host
        does not wait for them."""
        if self.lora is None:
            raise RuntimeError("runner built without max_adapters")
        if not 1 <= slot <= self.config.max_adapters:
            raise ValueError(f"adapter slot {slot} outside "
                             f"[1, {self.config.max_adapters}]")
        if set(host) != set(self.lora):
            raise ValueError(f"adapter targets {sorted(host)} != the "
                             f"runner's {sorted(self.lora)}")
        cuda = self.device.type == "cuda"
        for key, pair in host.items():
            for name, src in zip(("a", "b"), pair):
                dst = self.lora[key][name][:, slot]
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"adapter {key}.{name}: shape "
                                     f"{tuple(src.shape)} != "
                                     f"{tuple(dst.shape)}")
                src = src.to(torch.bfloat16)
                dst.copy_(src.pin_memory() if cuda else src, non_blocking=cuda)

    # -- KV page transfer (disaggregation) ------------------------------------
    def extract_pages_async(self, pages: list[int]):
        """Gather ``pages`` of both pools on the device and start their
        copy to pinned host memory without waiting; returns the handle
        for ``finalize_extract``. Stream order puts the gather before any
        later work that rewrites the pages, so the caller may release
        them at once."""
        self._note_first_use("extract", ("extract", len(pages)))
        idx = self._upload(np.asarray(pages, np.int64))
        if isinstance(self.k_cache, QuantKV):
            dev = (torch.stack([self.k_cache.data[:, :, idx],
                                self.v_cache.data[:, :, idx]]),
                   torch.stack([self.k_cache.scale[:, :, idx],
                                self.v_cache.scale[:, :, idx]]))
        else:
            dev = (torch.stack([self.k_cache[:, :, idx],
                                self.v_cache[:, :, idx]]),)
        if self.device.type != "cuda":
            return dev, None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in dev)
        for h, t in zip(host, dev):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        # The device gather stays referenced until the copy is waited on.
        return host, (event, dev)

    @staticmethod
    def extract_ready(handle) -> bool:
        """Whether an ``extract_pages_async`` handle's host copy is done,
        without waiting (its event's ``query``; always True on the
        CPU)."""
        _, fence = handle
        return fence is None or fence[0].query()

    def finalize_extract(self, handle) -> np.ndarray:
        """The host parcel of an ``extract_pages_async`` handle: bf16 bits
        ``[2, L, Nkv, n, page, D]``, or for an int8 pool the packed
        ``[2, L, Nkv, n, page, D + 4]`` uint8. Waits on the copy's event
        only and touches no device tensor, so the KV plane's thread may
        call it while the engine thread goes on."""
        host, fence = handle
        if fence is not None:
            fence[0].synchronize()
        if len(host) == 2:
            return pack_parcel(host[0].numpy(), host[1].numpy())
        return host[0].view(torch.int16).numpy().view(BF16)

    def extract_pages(self, pages: list[int]) -> np.ndarray:
        """The host parcel of ``pages`` (see ``finalize_extract``)."""
        return self.finalize_extract(self.extract_pages_async(pages))

    def extract_pages_device(self, pages: list[int]):
        """The gather of ``extract_pages_async`` with no host copy, for the
        KV plane's device path: ``(parcel, event)``, the bf16 parcel
        ``[2, L, Nkv, n, page, D]`` on the device and, on the card, an
        interprocess event recorded after the gather (None on the CPU).
        Nothing here waits for the card. A bf16 pool only: an int8 pool's
        parcel is packed on the host."""
        if isinstance(self.k_cache, QuantKV):
            raise ValueError("device parcels come from a bf16 pool")
        self._note_first_use("extract", ("extract", len(pages)))
        idx = self._upload(np.asarray(pages, np.int64))
        parcel = torch.stack([self.k_cache[:, :, idx],
                              self.v_cache[:, :, idx]])
        if self.device.type != "cuda":
            return parcel, None
        event = torch.cuda.Event(interprocess=True)
        event.record()
        return parcel, event

    @staticmethod
    def device_parcel_to_host(handle) -> np.ndarray:
        """bf16 bits of an ``extract_pages_device`` parcel on the host (the
        socket path of a ticket staged for the device path). The copy runs
        on a stream of its own that waits for the gather's event, so the
        KV plane's thread may call this while the engine thread goes on,
        and the wait is for the gather alone."""
        parcel, event = handle
        if event is None:
            return parcel.view(torch.int16).numpy().view(BF16)
        with torch.cuda.device(parcel.device):
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                stream.wait_event(event)
                host = parcel.view(torch.int16).cpu()
        return host.numpy().view(BF16)

    def insert_pages(self, kv, pages: list[int]) -> None:
        """Write a transferred parcel into ``pages`` of this pool. Either
        form goes into either pool, as in the reference: a packed parcel
        into a bf16 pool is dequantized, and a bf16 parcel into an int8
        pool is quantized on the host by ``quantize_np``, so the pool's
        bytes are the reference runner's. ``kv`` may also be a bf16
        tensor of this runner's device (the KV plane's device path): a
        bf16 pool scatters it on the device with the same indices, and an
        int8 pool copies it to the host and quantizes it as above (on the
        device, that is ROADMAP item 20(a))."""
        n = len(pages)
        spec = self.spec
        self._note_first_use("insert", ("insert", n))
        if kv.ndim != 6 or kv.shape[:4] != (2, spec.num_layers,
                                             spec.num_kv_heads, n):
            raise ValueError(
                f"parcel of shape {tuple(kv.shape)} does not fit {n} pages "
                f"of {spec.num_layers} layers x {spec.num_kv_heads} KV heads")
        if torch.is_tensor(kv):
            if (kv.dtype != torch.bfloat16
                    or kv.device.type != self.device.type):
                raise ValueError(f"a device parcel must be bf16 on "
                                 f"{self.device}, not {kv.dtype} on "
                                 f"{kv.device}")
            if isinstance(self.k_cache, QuantKV):
                kv = kv.view(torch.int16).cpu().numpy().view(BF16)
            else:
                if kv.is_cuda:
                    # Made on the plane's stream: the allocator must not
                    # hand its block out again before this stream's
                    # scatter has read it.
                    kv.record_stream(torch.cuda.current_stream(kv.device))
                idx = self._upload(np.asarray(pages, np.int64))
                self.k_cache[:, :, idx] = kv[0]
                self.v_cache[:, :, idx] = kv[1]
                return
        idx = self._upload(np.asarray(pages, np.int64))
        if isinstance(self.k_cache, QuantKV):
            data, scale = (unpack_parcel(kv) if is_packed_parcel(kv)
                           else quantize_np(kv))
            data, scale = self._upload(data), self._upload(scale)
            for i, cache in enumerate((self.k_cache, self.v_cache)):
                cache.data[:, :, idx] = data[i]
                cache.scale[:, :, idx] = scale[i]
            return
        bits = self._upload(parcel_to_bf16(kv).view(np.int16))
        vals = bits.view(torch.bfloat16)
        self.k_cache[:, :, idx] = vals[0]
        self.v_cache[:, :, idx] = vals[1]


class WindowProgram:
    """One decode-window program, the counterpart of one ``_get_window``
    jit of the reference, for its key ``(window, bucket_pages, penalized,
    seeded, logprobs)``. The first four members are the reference's.
    ``logprobs`` is the port's own: the reference computes a window's
    logprobs under ``lax.cond`` inside one program, and a CUDA graph cannot
    branch on a value, so a window with a logprobs row runs a program that
    computes them and any other window one that does not. A speculative
    window's program has the key ``("spec", m_outer, k, bucket_pages)``,
    the reference's ``_get_spec_window`` key.

    On the CPU, ``run`` runs the body eagerly with fresh outputs. On the
    card the first ``run`` captures the body as a CUDA graph (``capture``)
    and every ``run`` uploads the packed array into the program's device
    buffer and replays the graph, whose outputs are the program's static
    buffers (valid until the next replay of any program). A capture that
    fails raises; nothing runs the window eagerly instead."""

    def __init__(self, runner: ModelRunner, key: tuple):
        self.runner = runner
        self.key = key
        spec = key[0] == "spec"
        self.bucket_pages = key[3] if spec else key[1]
        self._outputs = runner._spec_outputs if spec else \
            runner._window_outputs
        self._body = runner._spec_body if spec else runner._window_body
        self.graph = None
        self.packed = None   # device control array the graph reads
        self.outs = None     # static outputs the graph writes
        self.tally = (0, 0)  # kernel launches of one replay (bf16, int8)
        self.ran = False     # the CPU's first run (the perf plane's count)

    def run(self, packed: np.ndarray) -> tuple:
        r = self.runner
        if not r.use_graphs:
            if not self.ran:
                self.ran = True
                r.note_capture(self.key, 0.0)
            return self.run_eager(packed)
        if self.graph is None:
            self.capture()
        self.packed.copy_(r._pinned(packed), non_blocking=True)
        self.graph.replay()
        attention.KERNEL.add_replay(self.tally)
        r.window_replays += 1
        return self.outs

    def run_eager(self, packed: np.ndarray) -> tuple:
        """The body run eagerly on ``packed`` into fresh outputs (the CPU
        path; on the card only checks call it)."""
        outs = self._outputs(self.key)
        self._body(self.key, self.runner._upload(packed), outs)
        return outs

    def capture(self) -> None:
        """Capture the body into a CUDA graph in the runner's pool, on its
        capture stream, in thread-local mode (other threads of the process
        may wait on events meanwhile). The body runs once eagerly first,
        over all-inactive rows: that run is inert (it writes only the
        scratch page 0 and the sinks of ``hist_dev`` and leaves
        ``tokens_dev``, ``positions_dev``, ``hist_dev`` and ``counts`` as
        they are; the noise step it advances is put back), and it makes the
        libraries' one-time set-up happen outside the capture. Neither
        run counts as kernel launches; every replay adds the capture's."""
        r = self.runner
        t0 = time.monotonic()
        b, width = r.config.max_num_seqs, PK_PREFIX + self.bucket_pages
        packed = torch.zeros((b, width), dtype=torch.int32, device=r.device)
        outs = self._outputs(self.key)
        graph = torch.cuda.CUDAGraph()
        with CAPTURE_LOCK:
            if r._graph_pool is None:
                r._graph_pool = torch.cuda.graph_pool_handle()
                r._capture_stream = torch.cuda.Stream(r.device)
            stream = r._capture_stream
            stream.wait_stream(torch.cuda.current_stream(r.device))
            with torch.cuda.stream(stream):
                step = r._noise_step.clone()
                with attention.KERNEL.recording():
                    self._body(self.key, packed, outs)
                r._noise_step.copy_(step)
                with attention.KERNEL.recording() as tally:
                    graph.capture_begin(pool=r._graph_pool,
                                        capture_error_mode="thread_local")
                    try:
                        self._body(self.key, packed, outs)
                    finally:
                        graph.capture_end()
            torch.cuda.current_stream(r.device).wait_stream(stream)
        self.graph, self.packed, self.outs = graph, packed, outs
        self.tally = tuple(tally)
        seconds = time.monotonic() - t0
        r.capture_seconds += seconds
        r.note_capture(self.key, seconds)
        log.info("captured window program %s in %.2fs", self.key, seconds)


def _leaves(tree):
    """Every tensor of a param tree (both of a QTensor's)."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif isinstance(v, QTensor):
            yield from v
        else:
            yield v
