"""GPUEngine: continuous batching over the torch ModelRunner (the core of
``dynamo_tpu.engine.engine.TPUEngine``).

The engine thread owns all device work. Each loop it admits waiting
requests, dispatches at most ``prefill_chunk_tokens`` of chunk work for
long prompts, then decodes in M-step windows: one ``runner.decode_window``
enqueues M steps for every slot with tokens chained on the device. Up to
``pipeline_depth`` windows are in flight; while the device runs them the
host processes the oldest window's tokens, emits them to the streams,
applies stop conditions and prepares the next page tables.

Admission hashes each prompt into chained page-sized blocks
(``llm/tokens.py``) and pins the longest cached prefix
(``PageAllocator.acquire_cached``); the rest is prefilled over that
history. A rest that fits one prefill program joins a batched prefill;
a longer one takes stall-free chunked prefill: page-aligned chunks
dispatched between decode windows, with no host readback until the final
chunk's first token. Pages are registered under their block hashes at
placement and as generated tokens complete blocks, so later requests
(and a preempted request's re-prefill) reuse them. The first token of
every prefill stays on the device and is read back asynchronously.

KV pressure: when the pool is exhausted mid-decode the engine preempts
the youngest slot (or a request still prefilling), releases its pages
and requeues the request to re-prefill from its accumulated tokens.

Disaggregation (``llm/disagg.py``): other threads hand the engine thread
jobs (``run_job``), which it runs between iterations. A prefill worker's
job prefills a prompt and extracts its pages (``prefill_extract``, or
``prefill_extract_staged`` onto the KV plane: one device parcel for its
CUDA IPC path, else streamed one page group per chunk). A decode worker's
``generate_injected`` request carries a parcel (a host parcel, or a
device tensor from the plane's device path): admission inserts it into
fresh pages and the request decodes from the prefill worker's first
token, under the same seeded and penalty rules as a local prefill.
Embeddings (``embed``, the /v1/embeddings backend) are such a job too:
one eager ``runner.embed`` pass between windows, outside admission, the
SLA gate and the cold-token ledger, as in the reference.

KV routing (``llm/kv_router``): after each processed window the engine
drains the allocator's stored and removed block hashes and, with
publishers set, schedules one coroutine on the event loop captured by
``start()`` that publishes them, the load metrics (``ForwardPassMetrics``)
and, when due, the inventory digest. The engine thread never waits on
that loop.

Speculative decoding (``spec_decode="ngram"``): every window is one
``runner.decode_spec_window`` of ``spec_m_outer`` verify steps, each
drafting up to ``spec_k`` tokens from the slot's own history on the device
and emitting the accepted drafts and one more token. Admission writes each
prompt into that history (``runner.seed_history``), and the host walk of a
window (``_process_spec_window``) corrects the dispatch-time worst-case
position by what the device actually emitted. Logprobs and penalties are
refused under it, as in the reference.

Batched LoRA (``max_adapters > 0``): ``register_adapter`` adds an adapter
to the store (``engine/lora.py``); admission resolves a request's adapter
to a resident device slot (hot-loading it on a miss) before it touches any
page, every prefill row and window row carries that slot id, and the slot
is released when the request finishes, is preempted or aborts. An
adapter's KV hashes under the adapter's chain salt (``tokens.chain_salt``),
so its pages are never reused for base requests or another adapter's, and
its KV events name the chain the KV router computes for it.

KV tiers (``host_cache_pages``, ``kv_disk_cache_dir``): a block the
allocator evicts goes through ``evict_hook`` into a buffer that
``_flush_spills`` extracts in one batched device-to-host copy, dispatched
before any later program can rewrite those pages; ``_resolve_spills``
stores the blocks in the host tier once the copy is done, without waiting
for it. The KVBM (``engine/kvbm.py``) demotes LRU blocks ahead of demand
under its watermarks, and admission extends a prefix hit with blocks from
host, disk and peers (``_try_onboard``), uploaded into fresh pages instead
of recomputed. Every tier step is best effort: a failed spill drops its
blocks, a failed upload or peer consult recomputes; each failure is
counted (``spill_failures``, ``onboard_failures``, the KVBM's
``peer_pull_failures``).

Observability (``metrics_registry``, a ``MetricsRegistry`` node): the
phase histograms (queue wait at admission, prefill dispatch to first-token
readback, decode dispatch to host processing), the chunk series and
``decode_stall_seconds``, the gap between consecutive window dispatches
while decode slots are live, measured before each dispatch. The engine
thread records ``engine.queue_wait``, ``engine.prefill``,
``prefill.chunk`` and ``engine.decode`` spans with explicit ids under each
request's trace (``SpanRecorder.add``), one flight-recorder row per
processed window, and a ``preempt`` journal event per preemption. All of
it is host work between device programs: nothing lands inside a captured
window graph and nothing synchronises the stream. ``KvMetricsUpdater``
and ``AdapterMetricsUpdater`` export the KV and adapter telemetry on
their throttle.

SLA admission (``ttft_budget_ms``): a cold-token ledger counts the prompt
tokens waiting (``_waiting_cold``, every put through ``_queue_put``) and
admitted with their first token unresolved (``_cold_inflight``, released at
resolution, preemption and failure); an EWMA of the prefill rate, sampled
over dispatch to first-token readback, turns it into ``estimated_ttft_ms``.
``generate`` refuses an arrival whose projection exceeds budget x
``admission_reject_factor`` (``OverloadedError``, 503 at the front), and
admission defers the queue head (kept at the head) while admitting it
would push the in-flight projection past the budget. The same projection
sets an engine-local brownout level 0..3; at
``brownout_spec_disable_level`` a spec engine dispatches plain windows
(``spec_brownout_windows``). A plain window advances neither the draft
history nor the device positions of its slots, so the engine processes
every in-flight window when the window kind switches and rewrites those
slots' history and position from the host tokens before their next spec
window (``_refresh_stale_history``).

Perf plane (``engine/perf.py``): one roofline sample a processed window
into the process-global registry (``window_s``, as in the reference, runs
from dispatch to the end of the readback, so a window pipelined behind
others carries their wait), the warmup boundary (``mark_ready``), and
``perf_status()``, the worker's ``/debug/perf`` body.

Not ported yet (later slices): multimodal.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import dataclasses
import itertools
import os
import queue
import threading
import time
from typing import AsyncIterator

import numpy as np
import torch

from dynamo_tpu_torch.engine import perf as perf_plane
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.kv_cache import PageAllocator
from dynamo_tpu_torch.engine.kv_host_cache import DiskKVCache, HostKVCache
from dynamo_tpu_torch.engine.kv_quant import (KV_SCALE_BYTES, parcel_to_bf16,
                                              parcel_to_packed)
from dynamo_tpu_torch.engine.kvbm import KvBlockManager
from dynamo_tpu_torch.engine.lora import AdapterStore
from dynamo_tpu_torch.engine.runner import (
    PK_ADAPTER, PK_CAP, PK_FREQPEN, PK_LOGPROB, PK_OVERRIDE, PK_POS, PK_PREFIX,
    PK_PRESPEN, PK_SEED, PK_SEEDED, PK_SEQLEN, PK_TEMP, PK_TOKEN, PK_TOPK,
    PK_TOPP, TOP_LOGPROBS, ModelRunner, PrefillSeq, mask_seed)
from dynamo_tpu_torch.engine.sampler import MAX_TOPK
from dynamo_tpu_torch.llm.kv_router.protocols import (ForwardPassMetrics,
                                                      KvInventoryDigest,
                                                      KvStats,
                                                      SpecDecodeStats,
                                                      WorkerStats,
                                                      kmin_sketch)
from dynamo_tpu_torch.llm.protocols import (FinishReason, LLMEngineOutput,
                                            PreprocessedRequest)
from dynamo_tpu_torch.llm.tokens import TokenBlockSequence, chain_salt
from dynamo_tpu_torch.runtime import flight, journal
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.errors import (AdapterNotFoundError,
                                             InvalidRequestError,
                                             OverloadedError)
from dynamo_tpu_torch.runtime.journal import EventKind
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.tracing import (_LATENCY_BUCKETS, get_recorder,
                                              phase_metrics)

log = get_logger("gpu_engine")

# Longest sleep of an idle engine loop between its periodic duties.
IDLE_WAIT_S = 0.02


class _Readback:
    """Device results copied to pinned host memory without waiting.

    ``.cpu()`` would synchronise the whole stream, including windows
    dispatched after this one, and so drain the pipeline; the copies are
    instead queued behind the producing work and fenced by one event.
    ``tensors`` may hold None entries, which read back as None."""

    def __init__(self, tensors):
        self._event = None
        self._host = []
        for t in tensors:
            if t is not None and t.is_cuda:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                t = host
                if self._event is None:
                    self._event = torch.cuda.Event()
            self._host.append(t)
        if self._event is not None:
            self._event.record()

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def numpy(self) -> list:
        if self._event is not None:
            self._event.synchronize()
        return [None if t is None else t.numpy() for t in self._host]


class _Fence:
    """Marks the device work enqueued between construction and ``close``:
    ``ready`` says whether it finished, ``device_ms`` how long it ran on
    the device. On the CPU the work is done when enqueued."""

    def __init__(self, device: torch.device):
        self._events = None
        if device.type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()

    def close(self) -> "_Fence":
        if self._events is not None:
            self._events[1].record()
        return self

    def ready(self) -> bool:
        return self._events is None or self._events[1].query()

    def wait(self) -> None:
        if self._events is not None:
            self._events[1].synchronize()

    def device_ms(self) -> float | None:
        if self._events is None:
            return None
        return self._events[0].elapsed_time(self._events[1])


@dataclasses.dataclass
class _Request:
    req: PreprocessedRequest
    ctx: Context
    out_q: asyncio.Queue
    loop: asyncio.AbstractEventLoop
    tokens_all: list[int] = dataclasses.field(default_factory=list)
    # Hashed blocks of the tokens whose K/V is in the pool.
    blocks: TokenBlockSequence | None = None
    pages: list[int] = dataclasses.field(default_factory=list)
    generated: int = 0
    slot: int = -1
    epoch: int = 0
    # None = first token still on device (async readback pending).
    last_token: int | None = -1
    reuse_tokens: int = 0  # cached-prefix tokens pinned by the last plan
    enqueue_t: float = dataclasses.field(default_factory=time.monotonic)
    # Upper bound on total sequence length (prompt + max_tokens): dispatch
    # never allocates pages past it.
    len_cap: int = 2**30
    # Stall-free chunked prefill: while True the request owns a slot and
    # pages but is prefilled by scheduled chunk dispatches (decode windows
    # skip the slot). prefill_pos is the next prompt position to dispatch.
    prefilling: bool = False
    prefill_pos: int = 0
    prefill_t0: float = 0.0  # chunked prefill start (engine.prefill span)
    wait_noted: bool = False  # queue wait observed for this queue stint
    # (first token, host parcel) of a remotely prefilled prompt, until
    # admission inserts the parcel.
    injected: tuple | None = None
    # Batched LoRA: the resident slot the request's adapter occupies (0 =
    # base model) and the store reference it holds while admitted.
    adapter_slot: int = 0
    adapter_ref: str | None = None
    # SLA-admission ledger entries: the cold tokens this request adds to
    # the waiting backlog while queued, and to the in-flight backlog from
    # admission until its first token resolves.
    queued_cold: int = 0
    cold_tokens: int = 0

    def push(self, item) -> None:
        self.loop.call_soon_threadsafe(self.out_q.put_nowait, item)


@dataclasses.dataclass
class _Window:
    toks: _Readback | None  # tokens [M,B] + logprobs (None: no rows)
    slots: list             # per slot: (request, epoch, start_pos, cap) or None
    frozen: dict            # slot -> (request, epoch, "requeue" | "oom")
    size: int
    serial: int = 0         # dispatch order (deferred-release fencing)
    t0: float = 0.0         # dispatch time
    spec: bool = False      # a speculative window (tokens, emitted, drafts)


class GPUEngine(AsyncEngine):
    def __init__(self, config: EngineConfig, params: dict | None = None,
                 seed: int = 0, kv_publisher=None, metrics_publisher=None,
                 metrics_registry=None):
        """``params``: a loaded tree (``weights.load_hf_weights`` or
        ``params_from_jax``; bf16 or int8), handed to the runner as it is,
        or None for random weights from ``seed``. ``kv_publisher`` and
        ``metrics_publisher`` (``llm/kv_router/publisher.py``) publish the
        KV events and load metrics; ``inventory_publisher`` is set as an
        attribute before ``start()``. ``metrics_registry`` (a
        ``MetricsRegistry`` node) gets the engine's series; without one
        the engine records spans and flight rows but no metrics."""
        self.config = config
        # The process-global span ring; the histograms need a registry.
        self._recorder = get_recorder()
        self.phase = (phase_metrics(metrics_registry)
                      if metrics_registry is not None else None)
        self.kv_publisher = kv_publisher
        self.metrics_publisher = metrics_publisher
        self.inventory_publisher = None
        self.decode_window = config.resolve_decode_window()
        self.prefill_chunk_tokens = config.resolve_prefill_chunk_tokens()
        self.runner = ModelRunner(config, params=params, seed=seed)
        self.allocator = PageAllocator(self.runner.num_pages, config.page_size)
        # KV tiers (G2 host DRAM, G3 disk behind it): evicted blocks are
        # extracted into them, and prefix hits on them are uploaded.
        self.host_cache = None
        if config.host_cache_pages > 0 or config.kv_disk_cache_dir:
            disk = (DiskKVCache(config.kv_disk_cache_dir,
                                config.disk_cache_pages)
                    if config.kv_disk_cache_dir else None)
            # A disk tier with no G2 capacity still needs a small DRAM
            # front (demotions flow through it).
            self.host_cache = HostKVCache(config.host_cache_pages or 16, disk)
            self.allocator.evict_hook = self._on_evict
        # The placement policy over pool, host, disk and peers; the engine
        # keeps the device work.
        self.kvbm = KvBlockManager(self.allocator, self.host_cache,
                                   config.kvbm_policy())
        self._evict_buffer: list[tuple[int, int]] = []  # (hash, page)
        # Dispatched spill extracts: {"handle", "hashes"}.
        self._pending_spills: list[dict] = []
        self.onboard_blocks = 0    # tier blocks uploaded at admission
        self.g4_blocks = 0         # of which came from peers
        self.spill_failures = 0    # spill extracts or fetches that failed
        self.onboard_failures = 0  # onboard uploads that failed
        # The worker's KV plane server, once it runs one (its stats).
        self.plane = None
        # Multi-tenant LoRA: the store registers adapters and places them
        # in device slots, resolved at admission on the engine thread.
        self.adapters = (AdapterStore(self.runner, config.max_adapters,
                                      config.lora_max_rank)
                         if config.max_adapters > 0 else None)
        b = config.max_num_seqs
        # Slot state (host view; tokens chain on the device between windows).
        self.slot_req: list[_Request | None] = [None] * b
        self.disp_positions = np.zeros(b, np.int64)
        self.disp_seq_lens = np.zeros(b, np.int64)
        self.temperature = np.zeros(b, np.float32)
        self.top_k = np.zeros(b, np.int32)
        self.top_p = np.ones(b, np.float32)
        self.freq_pen = np.zeros(b, np.float32)
        self.pres_pen = np.zeros(b, np.float32)
        self.seeds = np.zeros(b, np.int32)
        self.seeded = np.zeros(b, bool)
        self.adapter_ids = np.zeros(b, np.int32)  # PK_ADAPTER per slot
        self.overrides: dict[int, int] = {}  # slot -> first token next window
        self.waiting: queue.Queue[_Request] = queue.Queue()
        # The queue's cold-token counter is written from the event loop
        # (generate) and the engine thread (admission, requeue).
        self._queue_stats_lock = threading.Lock()
        # SLA-aware admission (config.ttft_budget_ms): the measured
        # end-to-end prefill rate (EWMA over prefill dispatch -> first-token
        # readback, so queueing behind decode windows is priced in) and the
        # cold-token ledger the TTFT projection runs on. The disagg extract
        # jobs (run_job) bypass it, as in the reference.
        self.prefill_rate_tok_s: float | None = None
        self._cold_inflight = 0      # admitted; first token not resolved
        self._waiting_cold = 0       # queued; not admitted
        self.admission_deferred = 0  # times the gate held the head back
        # The queue HEAD the gate deferred: parked here, not at the tail,
        # so later small prompts cannot starve it (strict FIFO).
        self._deferred_head: _Request | None = None
        # Engine-local brownout (_update_brownout): 0..3 from the TTFT
        # projection; at brownout_spec_disable_level a spec engine
        # dispatches plain windows, counted in spec_brownout_windows.
        self.brownout_level = 0
        self.spec_brownout_windows = 0
        # Slots whose on-device draft history and position a plain window
        # left behind (a plain window writes neither): the next spec
        # window rewrites them from the host first.
        self._hist_stale = np.zeros(b, bool)
        # Dispatched-but-unprocessed windows, oldest first.
        self._inflight: collections.deque[_Window] = collections.deque()
        self._dispatch_serial = 0
        # Prefill first tokens awaiting readback:
        # {"handle": _Readback, "rows": [(row, request, slot, epoch)]}.
        self._pending_first: list[dict] = []
        # Pages freed while windows that may still scatter to them are in
        # flight: (serial of the newest dispatched window, pages).
        self._pending_release: list[tuple[int, list[int]]] = []
        # Requests in stall-free chunked prefill, and their dispatched
        # chunks not yet seen complete (oldest first).
        self._prefilling: list[_Request] = []
        self._chunk_inflight: collections.deque[dict] = collections.deque()
        self._running = False
        self._thread: threading.Thread | None = None
        # The event loop the publishers run on (captured by start()).
        self._publish_loop: asyncio.AbstractEventLoop | None = None
        self.windows_dispatched = 0    # windows with device work
        self.preempt_count = 0
        self.prefix_hit_blocks = 0     # cached blocks pinned at admission
        self.prefix_lookup_blocks = 0  # blocks looked up at admission
        # Pages that live slots stalled for at the last window dispatch:
        # admission leaves them free, or a requeued request would take
        # back the pages its preemption freed for them, again and again.
        self._stalled_pages = 0
        self.chunk_tokens_total = 0    # prompt tokens dispatched as chunks
        self.chunk_dispatch_count = 0  # chunk programs dispatched
        # Dispatch -> tokens-on-host seconds of recent windows.
        self.window_seconds: collections.deque[float] = \
            collections.deque(maxlen=4096)
        # Completed chunks: {"request", "start", "tokens", "final",
        # "windows_before" (windows dispatched before the chunk),
        # "device_ms" (None on the CPU)}.
        self.chunk_records: collections.deque[dict] = \
            collections.deque(maxlen=4096)
        # Engine-thread jobs: (fn, concurrent future).
        self._jobs: queue.Queue = queue.Queue()
        # Set where work arrives (a queued request, a job, stop): the idle
        # loop sleeps on it instead of polling, so an idle engine does not
        # take the interpreter lock from a busy one in the same process
        # (a window capture on another engine's thread slowed 2-3x beside
        # a polling one).
        self._wake = threading.Event()
        self.streamed_extracts = 0  # chunk-streamed extracts staged
        self.device_extracts = 0    # device parcels staged (one each)
        self.injected_admissions = 0  # parcels inserted at admission
        self.warmup_seconds = 0.0     # _warmup_window_programs' wall time
        # Speculative decoding: verify steps per window, sized so that a
        # window emits at most M tokens (all drafts accepted) and reads the
        # weights m_outer times. Stats feed SpecDecodeStats.
        self.spec_m_outer = (max(1, self.decode_window
                                 // (config.spec_k + 1))
                             if config.spec_decode else 0)
        self.spec_drafts = 0        # verify steps that had drafts
        self.spec_tokens = 0        # draft tokens proposed
        self.spec_accepted = 0      # draft tokens accepted
        # Verify steps by tokens emitted: index e = 1 (no draft accepted)
        # .. spec_k + 1 (all accepted); index 0 counts frozen steps.
        self.spec_emit_hist = ([0] * (config.spec_k + 2)
                               if config.spec_decode else [])
        # Observability: the chunk and stall series, the KV and adapter
        # exporters, and the flight ring's per-window deltas.
        self.step_count = 0               # windows processed
        self.tokens_generated_total = 0   # decode-window tokens emitted
        self.decode_stall_max_s = 0.0     # widest dispatch gap seen
        self._last_decode_dispatch: float | None = None
        self.m_chunk_tokens = self.m_chunks_inflight = None
        self.m_decode_stall = None
        self.kv_metrics = self.adapter_metrics = None
        if metrics_registry is not None:
            from dynamo_tpu_torch.engine.kv_metrics import (
                AdapterMetricsUpdater, KvMetricsUpdater)
            self.m_chunk_tokens = metrics_registry.counter(
                "prefill_chunk_tokens_total",
                "Prompt tokens dispatched as scheduled prefill chunks")
            self.m_chunks_inflight = metrics_registry.gauge(
                "prefill_chunks_inflight",
                "Prefill chunk programs dispatched but not yet retired")
            self.m_decode_stall = metrics_registry.histogram(
                "decode_stall_seconds",
                "Gap between consecutive decode-window dispatches while "
                "decode slots are active",
                buckets=_LATENCY_BUCKETS)
            for bound in (self.m_chunk_tokens, self.m_chunks_inflight,
                          self.m_decode_stall):
                bound.ensure()
            self.kv_metrics = KvMetricsUpdater(metrics_registry)
            if self.adapters is not None:
                self.adapter_metrics = AdapterMetricsUpdater(
                    metrics_registry)
        self._flight = flight.get_recorder()
        self._flight_chunk_last = 0
        self._flight_stall_last = 0.0
        self._flight_tokens_last = 0
        # Perf plane (engine/perf.py): the per-window roofline samples feed
        # the process-global registry; the exporter turns it into the
        # dynamo_tpu_perf_* series beside the device-memory gauges.
        self._perf = perf_plane.get_registry()
        self._perf_tokens_last = 0
        self._step_floor_ms = config.model.weight_read_step_ms(config.tp,
                                                               config.pp)
        self.perf_metrics = (perf_plane.PerfMetricsUpdater(metrics_registry)
                             if metrics_registry is not None else None)

    # -- lifecycle ------------------------------------------------------------
    def start(self, loop: asyncio.AbstractEventLoop | None = None) -> None:
        """Start the engine thread. ``loop`` is the event loop the
        publishers run on (default: the running loop, if any). With
        ``config.warmup_windows`` the thread first warms the window
        programs (``_warmup_window_programs``); this waits for that and
        raises what it raised, and the engine does not start. A caller on
        an event loop that must keep running passes its loop and calls
        this from an executor."""
        if self._running:
            return
        self._running = True
        if loop is None:
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                loop = None
        self._publish_loop = loop
        ready = threading.Event()
        failure: list[BaseException] = []
        self._thread = threading.Thread(target=self._engine_loop,
                                        args=(ready, failure),
                                        name="gpu-engine", daemon=True)
        self._thread.start()
        ready.wait()
        if failure:
            self._thread.join()
            self._thread = None
            raise RuntimeError("engine start failed: window program warmup "
                               "raised") from failure[0]

    def stop(self) -> None:
        self._running = False
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=30)
            self._thread = None
        while True:  # jobs the loop will never run
            try:
                _, fut = self._jobs.get_nowait()
            except queue.Empty:
                break
            if fut.set_running_or_notify_cancel():
                fut.set_exception(RuntimeError("engine stopped"))

    # -- AsyncEngine ----------------------------------------------------------
    def _validate(self, req: PreprocessedRequest) -> None:
        cfg = self.config
        if not req.token_ids:
            raise ValueError("empty token_ids")
        if cfg.spec_decode:
            # The spec window samples temperature / top-k / top-p / seed
            # as data; it has no logprob taps and no count state.
            s = req.sampling_options
            refused = []
            if s.logprobs is not None:
                refused.append("logprobs")
            if s.frequency_penalty or s.presence_penalty:
                refused.append("frequency/presence penalties")
            if refused:
                raise ValueError(
                    f"speculative decoding ({cfg.spec_decode}) does not "
                    f"support: {', '.join(refused)}. Disable spec_decode or "
                    f"drop these options (temperature/top_k/top_p/seed are "
                    f"supported)")
        if len(req.token_ids) >= cfg.max_model_len:
            raise ValueError(
                f"prompt length {len(req.token_ids)} exceeds max model len "
                f"{cfg.max_model_len}")
        if req.adapter:
            if self.adapters is None:
                raise AdapterNotFoundError(
                    f"adapter {req.adapter!r} requested but this engine "
                    f"serves no adapters (--max-adapters 0)")
            if not self.adapters.registered(req.adapter):
                # Fail fast here; admission resolves the slot.
                raise AdapterNotFoundError(
                    f"adapter {req.adapter!r} is not registered on this "
                    f"worker (serving: {self.adapters.names() or 'none'})")
        if req.mm_embeds:
            raise ValueError("not ported yet: multimodal embeddings "
                             "(ROADMAP item 15)")
        s = req.sampling_options
        if s.logprobs is not None and s.logprobs > TOP_LOGPROBS:
            log.warning("top_logprobs=%d exceeds cap %d; clamping",
                        s.logprobs, TOP_LOGPROBS)
            s.logprobs = TOP_LOGPROBS
        if s.top_k and s.top_k > MAX_TOPK:
            log.warning("top_k=%d exceeds sampler cap %d; clamping",
                        s.top_k, MAX_TOPK)
            s.top_k = MAX_TOPK
        if s.seed is not None and not 0 <= s.seed <= 0x7FFFFFFF:
            log.warning("seed=%s outside the engine's 31-bit seed space; "
                        "using %d", s.seed, mask_seed(s.seed))
        for field in ("frequency_penalty", "presence_penalty"):
            val = getattr(s, field)
            if val is not None and not -2.0 <= val <= 2.0:
                clamped = max(-2.0, min(2.0, val))
                log.warning("%s=%s outside [-2, 2]; clamping to %s",
                            field, val, clamped)
                setattr(s, field, clamped)

    # -- SLA-aware admission ---------------------------------------------------
    def _queue_put(self, r: _Request, cold: int | None = None) -> None:
        """Enqueue for admission, counting the request's cold tokens into
        the waiting backlog (every put site comes through here)."""
        r.queued_cold = len(r.tokens_all) if cold is None else cold
        with self._queue_stats_lock:
            self._waiting_cold += r.queued_cold
        self.waiting.put(r)
        self._wake.set()

    def _queue_pop_accounting(self, r: _Request) -> None:
        with self._queue_stats_lock:
            self._waiting_cold -= r.queued_cold
        r.queued_cold = 0

    def _maybe_reject(self, prompt_tokens: int) -> None:
        """Raise ``OverloadedError`` (503 at the front, which the router
        retries elsewhere) when the projected TTFT through the current
        backlog exceeds budget x reject_factor. An idle engine never
        rejects: with no backlog the TTFT is the request's own prefill."""
        cfg = self.config
        if not (cfg.ttft_budget_ms and cfg.admission_reject_factor):
            return
        backlog = self._cold_inflight + self._waiting_cold
        rate = self.prefill_rate_tok_s
        if backlog <= 0 or not rate:
            return
        projected = (backlog + prompt_tokens) / rate * 1e3
        limit = cfg.ttft_budget_ms * cfg.admission_reject_factor
        if projected > limit:
            raise OverloadedError(
                f"projected TTFT {projected:.0f} ms exceeds "
                f"{limit:.0f} ms ({backlog} cold tokens backlogged at "
                f"{rate:.0f} tok/s)")

    def _prefill_rate_sample(self, tokens: int, elapsed_s: float) -> None:
        if tokens <= 0 or elapsed_s <= 1e-6:
            return
        s = tokens / elapsed_s
        self.prefill_rate_tok_s = (
            s if self.prefill_rate_tok_s is None
            else 0.7 * self.prefill_rate_tok_s + 0.3 * s)

    def estimated_ttft_ms(self, extra_tokens: int = 0) -> float | None:
        """Projected TTFT of a hypothetical arrival from the measured
        prefill rate and the cold-token backlog; None until a prefill has
        calibrated the rate. A chunked prompt's cold tokens stay in the
        ledger from admission to its final chunk's first token, and the
        rate is sampled over the same interval, so the decode windows
        between chunks are priced in."""
        if not self.prefill_rate_tok_s:
            return None
        return ((self._cold_inflight + self._waiting_cold + extra_tokens)
                / self.prefill_rate_tok_s * 1e3)

    def _update_brownout(self) -> None:
        """Pressure level 0..3 from the projected-TTFT / budget ratio, the
        engine-local counterpart of the front limiter's
        ``pressure_level()`` (runtime/overload.py)."""
        cfg = self.config
        projected = (self.estimated_ttft_ms()
                     if cfg.ttft_budget_ms else None)
        if not projected:
            self.brownout_level = 0
            return
        ratio = projected / cfg.ttft_budget_ms
        self.brownout_level = (0 if ratio < 1.0 else
                               1 if ratio < 1.5 else
                               2 if ratio < 2.5 else 3)

    def _use_spec(self) -> bool:
        """Whether the next window is a speculative one: a spec engine
        drops back to plain windows while the brownout level is at or
        above ``brownout_spec_disable_level`` (0 disables the hook)."""
        cfg = self.config
        return bool(cfg.spec_decode) and not (
            cfg.brownout_spec_disable_level
            and self.brownout_level >= cfg.brownout_spec_disable_level)

    async def generate(self, request, context: Context) -> AsyncIterator[dict]:
        """Stream wire dicts (``LLMEngineOutput.to_wire()``) for one
        request, the same items ``TPUEngine.generate`` yields."""
        self.start()
        req = (request if isinstance(request, PreprocessedRequest)
               else PreprocessedRequest.from_wire(request))
        self._validate(req)
        # One item per emit, bounded by max_tokens via len_cap.
        r = _Request(req=req, ctx=context, out_q=asyncio.Queue(),
                     loop=asyncio.get_running_loop(),
                     tokens_all=list(req.token_ids),
                     len_cap=len(req.token_ids)
                     + (req.stop_conditions.max_tokens or 2**30))
        self._maybe_reject(len(req.token_ids))
        self._queue_put(r)
        while True:
            item = await r.out_q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
            if item.get("finish_reason"):
                return

    async def generate_injected(self, request, context: Context,
                                first_token: int,
                                kv) -> AsyncIterator[dict]:
        """Serve a request whose prompt was prefilled REMOTELY: admission
        inserts the parcel ``kv`` (a host parcel, or a bf16 tensor on this
        engine's device from the KV plane's device path) into fresh pages
        and decoding starts at ``first_token``, which is the stream's first
        item. With no free pages the request falls back to a local
        prefill; a failed insert ends the stream with its error."""
        self.start()
        req = (request if isinstance(request, PreprocessedRequest)
               else PreprocessedRequest.from_wire(request))
        self._validate(req)
        r = _Request(req=req, ctx=context, out_q=asyncio.Queue(),
                     loop=asyncio.get_running_loop(),
                     tokens_all=list(req.token_ids),
                     injected=(int(first_token), kv),
                     len_cap=len(req.token_ids)
                     + (req.stop_conditions.max_tokens or 2**30))
        # Admission drops the request's reference once inserted; this
        # frame must not keep a device parcel alive for the whole stream.
        del kv
        # The parcel carries the prompt's K/V: no cold prefill, so the SLA
        # gate and the cold ledger skip it.
        self._queue_put(r, cold=0)
        while True:
            item = await r.out_q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
            if item.get("finish_reason"):
                return

    def handler(self):
        """The endpoint handler that serves ``generate``, ``embed``
        (``{"embed": True, "token_lists", "pooling"}``, answered with one
        ``{"embeddings": [[...], ...]}`` item) and the admin
        ``clear_kv_blocks`` on the request plane
        (``Endpoint.serve_endpoint``)."""
        async def handle(request, context):
            if isinstance(request, dict) and request.get("clear_kv_blocks"):
                yield {"cleared": await self.clear_kv_blocks()}
                return
            if isinstance(request, dict) and request.get("embed"):
                yield {"embeddings": await self.embed(
                    request["token_lists"], request.get("pooling", "last"))}
                return
            async for out in self.generate(request, context):
                yield out

        return handle

    async def embed(self, token_lists: list[list[int]],
                    pooling: str = "last") -> list[list[float]]:
        """Batch embeddings (``runner.embed``), computed on the engine
        thread between windows (the /v1/embeddings backend)."""
        out = await self.run_job(
            lambda: self.runner.embed(token_lists, pooling))
        return [row.tolist() for row in out]

    async def clear_kv_blocks(self) -> int:
        """Admin: drop the reusable (inactive) prefix cache; the host and
        disk tiers flush too. Returns the device pages freed."""
        def job():
            n = self.allocator.clear_inactive()
            if self.host_cache is not None:
                self.host_cache.clear()
            return n
        return await self.run_job(job)

    # -- KV observability -----------------------------------------------------
    @property
    def num_waiting(self) -> int:
        """Requests queued for admission (the deferred head included)."""
        return self.waiting.qsize() + (self._deferred_head is not None)

    def inventory_digest(self) -> KvInventoryDigest:
        """What KV lives here, for the event plane: blocks per tier
        (``g1`` registered on the device, ``g2`` host, ``g3`` disk),
        capacity headroom, and a k-min sketch of every hash this worker
        can serve."""
        hashes = list(self.allocator.cached)
        tier_blocks = {"g1": len(hashes)}
        if self.host_cache is not None:
            host_hashes = self.host_cache.block_hashes()
            tier_blocks["g2"] = len(host_hashes)
            hashes.extend(host_hashes)
            if self.host_cache.disk is not None:
                disk_hashes = self.host_cache.disk.hashes()
                tier_blocks["g3"] = len(disk_hashes)
                hashes.extend(disk_hashes)
        return KvInventoryDigest(
            blocks=len(self.allocator.cached), tier_blocks=tier_blocks,
            pages_total=self.allocator.num_pages,
            pages_free=self.allocator.num_free,
            pages_active=self.allocator.num_active,
            sketch=kmin_sketch(hashes))

    def kv_status(self) -> dict:
        """This worker's KV status (the reference's /debug/kv body):
        allocator counters, tier stats, reuse by tier, the KV plane's and
        the G4 source's stats, the KVBM's status with the engine's tier
        failure counts, the adapter store's status and the current
        digest."""
        return {
            "role": "engine",
            "allocator": self.allocator.stats(),
            "tiers": (self.host_cache.stats()
                      if self.host_cache is not None else {}),
            "reuse": {
                "prefix_hit_blocks": self.prefix_hit_blocks,
                "prefix_lookup_blocks": self.prefix_lookup_blocks,
                "onboard_blocks_host": self.onboard_blocks - self.g4_blocks,
                "onboard_blocks_peer": self.g4_blocks,
            },
            "plane": self.plane.stats() if self.plane is not None else None,
            "remote": (self.remote_source.stats()
                       if self.remote_source is not None else None),
            # The engine's tier failure counts beside the KVBM's
            # peer_pull_failures.
            "kvbm": dict(self.kvbm.status(),
                         spill_failures=self.spill_failures,
                         onboard_failures=self.onboard_failures),
            "adapters": (self.adapters.status()
                         if self.adapters is not None else None),
            "digest": self.inventory_digest().to_wire(),
        }

    def perf_status(self) -> dict:
        """This worker's /debug/perf body (the reference's keys): window
        captures per program family from the process-global registry, the
        live window/roofline series, device memory and the runner's
        params / KV / workspace breakdown. On the card the memory figures
        are the caching allocator's; nothing falls back to the CPU's."""
        expected = self.config.expected_roofline_frac
        raw = os.environ.get("DTPU_EXPECTED_ROOFLINE_FRAC")
        if raw:
            expected = float(raw)
        compiles = self._perf.snapshot()
        status = {
            "role": "engine",
            "compiles": compiles,
            "window": self._perf.window_snapshot(),
            "roofline": {
                "weight_read_step_ms": round(self._step_floor_ms, 4),
                "frac": round(self._perf.roofline_frac, 4),
                "expected_frac": expected,
            },
            "hbm": self.runner.hbm_stats(),
            "memory": self.runner.memory_breakdown(),
        }
        if self.config.spec_decode:
            # Bytes per verified position: the spec program's analytic
            # bytes over its m_outer x (spec_k + 1) positions.
            cost = (compiles["programs"].get("spec_window") or {}).get(
                "cost") or {}
            positions = self.spec_m_outer * (self.config.spec_k + 1)
            vb = cost.get("bytes_accessed")
            status["spec"] = {
                "k": self.config.spec_k,
                "m_outer": self.spec_m_outer,
                "drafts": self.spec_drafts,
                "draft_tokens": self.spec_tokens,
                "accepted_tokens": self.spec_accepted,
                "acceptance_rate": round(
                    self.spec_accepted / self.spec_tokens, 4)
                if self.spec_tokens else None,
                # emit_hist[e] = verify steps that emitted e tokens
                # (0 = dispatched frozen, spec_k + 1 = all drafts landed).
                "emit_hist": list(self.spec_emit_hist),
                "brownout_windows": self.spec_brownout_windows,
                "verify_bytes_per_token": round(vb / positions, 1)
                if vb and positions else None,
                "verify_cost_source": cost.get("source"),
            }
        return status

    def _publish(self) -> None:
        """Drain the allocator's KV events and, when a loop was captured,
        schedule their publication with the load metrics and (when due)
        the inventory digest. Runs on the engine thread; never waits on
        the loop."""
        if self.kv_metrics is not None:
            # /metrics needs no loop (in-process pipelines export too).
            self.kv_metrics.update(self)
        if self.adapter_metrics is not None:
            self.adapter_metrics.update(self.adapters)
        if self.perf_metrics is not None:
            self.perf_metrics.update(self)
        stored, removed = self.allocator.drain_events()
        loop = self._publish_loop
        if loop is None or loop.is_closed():
            return
        digest = None
        if self.inventory_publisher is not None \
                and self.inventory_publisher.due(time.monotonic()):
            digest = self.inventory_digest()
        if (self.kv_publisher is None and self.metrics_publisher is None
                and digest is None):
            return
        active = sum(1 for r in self.slot_req if r is not None)
        waiting = self.num_waiting
        alloc = self.allocator
        metrics = ForwardPassMetrics(
            worker_stats=WorkerStats(
                request_active_slots=active,
                request_total_slots=self.config.max_num_seqs,
                num_requests_waiting=waiting),
            kv_stats=KvStats(
                kv_active_blocks=alloc.num_active,
                kv_total_blocks=alloc.num_pages,
                gpu_cache_usage_perc=alloc.num_active / alloc.num_pages,
                gpu_prefix_cache_hit_rate=(
                    self.prefix_hit_blocks / self.prefix_lookup_blocks
                    if self.prefix_lookup_blocks else 0.0)),
            spec_decode_stats=(SpecDecodeStats(
                num_spec_tokens=self.spec_tokens,
                num_drafts=self.spec_drafts,
                num_accepted_tokens=self.spec_accepted)
                if self.config.spec_decode else None))

        async def do_publish():
            try:
                if self.kv_publisher is not None:
                    if stored:
                        await self.kv_publisher.stored(stored)
                    if removed:
                        await self.kv_publisher.removed(removed)
                if self.metrics_publisher is not None:
                    await self.metrics_publisher.publish(
                        metrics, force=active == 0 and waiting == 0)
                if digest is not None:
                    await self.inventory_publisher.publish(digest)
            except Exception:  # noqa: BLE001
                log.exception("publish failed")

        asyncio.run_coroutine_threadsafe(do_publish(), loop)

    # -- engine-thread jobs (the disaggregation control path) -----------------
    async def run_job(self, fn):
        """Run ``fn`` on the engine thread, which owns all device work,
        between loop iterations; await its result."""
        self.start()
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._jobs.put((fn, fut))
        self._wake.set()
        return await asyncio.wrap_future(fut)

    def _run_jobs(self) -> None:
        while True:
            try:
                fn, fut = self._jobs.get_nowait()
            except queue.Empty:
                return
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except Exception as exc:  # noqa: BLE001 — deliver to the caller
                fut.set_exception(exc)
            # A job registers or drops blocks (a prefill worker's extract,
            # clear_kv_blocks) and a prefill worker runs no windows:
            # publish now, so its events neither wait nor pile up.
            self._publish()

    @staticmethod
    def _reject_adapter_extract(req: PreprocessedRequest) -> None:
        """Disaggregated prefill serves the base model only: the decode
        side keeps adapter requests local, so an adapter reaching a
        prefill worker is a routing fault and fails typed."""
        if req.adapter:
            raise InvalidRequestError(
                f"disaggregated prefill does not serve LoRA adapter "
                f"requests (adapter={req.adapter!r}); the decode worker "
                f"prefills these locally")

    def _extract_request(self, req: PreprocessedRequest):
        """A prefill-only request with its pages planned: (request, plan)
        where plan is a PrefillSeq or "chunked"."""
        self._reject_adapter_extract(req)
        self._validate(req)
        r = _Request(req=req, ctx=Context(), out_q=None,  # type: ignore[arg-type]
                     loop=None, tokens_all=list(req.token_ids))  # type: ignore[arg-type]
        plan = self._plan_prefill(r)
        if plan is None:
            raise RuntimeError("prefill worker KV pool exhausted")
        return r, plan

    def _extract_chunks(self, r: _Request, plan):
        """The prefill programs of an extract, [(start, n_tok, final)]
        from the reused prefix on: the whole rest for a PrefillSeq plan,
        else page-aligned chunks of at most max_prompt_len."""
        prompt_len, start = len(r.tokens_all), r.reuse_tokens
        if plan != "chunked":
            return [(start, prompt_len - start, True)]
        chunks = []
        while start < prompt_len:
            n_tok = min(self.config.max_prompt_len, prompt_len - start)
            chunks.append((start, n_tok, start + n_tok >= prompt_len))
            start += n_tok
        return chunks

    def _prefill_extract_chunk(self, r: _Request, plan, start: int,
                               n_tok: int, final: bool) -> int | None:
        """Dispatch one prefill program of an extract; the final one
        samples and returns the first token (a host read)."""
        seq = (plan if plan != "chunked"
               else self._chunk_seq(r, start, n_tok, final))
        if not final:
            self.runner.prefill_chunk_async(seq)
            return None
        rows = self._count_row_of(r)[None] if any(seq.penalties) else None
        return int(self.runner.prefill_batch([seq], count_rows=rows)[0][0])

    def _register_blocks(self, r: _Request) -> None:
        for idx, h in enumerate(r.blocks.block_hashes):
            self.allocator.register(r.pages[idx], h)

    def prefill_extract(self, req: PreprocessedRequest):
        """ENGINE THREAD ONLY (call through run_job). Prefill a prompt,
        register its blocks for prefix reuse and extract its pages to the
        host. Returns (first_token, parcel, prompt_len)."""
        first_token, handles, prompt_len = self._prefill_for_extract(req, 1)
        return (first_token, self.runner.finalize_extract(handles[0][0]),
                prompt_len)

    def _prefill_for_extract(self, req: PreprocessedRequest, groups: int,
                             device: bool = False):
        """Prefill and dispatch the page gather in up to ``groups`` page
        groups; returns their unresolved extract handles with their page
        counts, so that the copies overlap what the caller does next.
        ``device``: the gathers stay on the device
        (``extract_pages_device``) with no host copy."""
        r, plan = self._extract_request(req)
        try:
            for chunk in self._extract_chunks(r, plan):
                first_token = self._prefill_extract_chunk(r, plan, *chunk)
            self._register_blocks(r)
            n = len(r.pages)
            per = -(-n // min(groups, n))
            extract = (self.runner.extract_pages_device if device
                       else self.runner.extract_pages_async)
            handles = [(extract(r.pages[i:i + per]), len(r.pages[i:i + per]))
                       for i in range(0, n, per)]
        finally:
            # The gather is dispatched: stream order has it read the pages
            # before any later work can rewrite them, so they release now.
            self.allocator.release(r.pages)
            r.pages = []
        return first_token, handles, len(r.tokens_all)

    def _parcel_meta(self, n_pages: int) -> dict:
        spec = self.runner.spec
        shape = [2, spec.num_layers, spec.num_kv_heads, n_pages,
                 self.config.page_size, spec.head_dim]
        if self.runner.quant_kv == "int8":
            shape[-1] += KV_SCALE_BYTES
            return {"shape": shape, "dtype": "uint8"}
        return {"shape": shape, "dtype": "bfloat16"}

    def prefill_extract_staged(self, req: PreprocessedRequest, plane,
                               on_ticket=None):
        """ENGINE THREAD ONLY (call through run_job). Disaggregated prefill
        over the KV plane: prefill, stage the extract with ``plane`` (its
        host copies resolve on the plane's thread when the decode worker
        pulls) and return (first_token, ticket, prompt_len).

        When ``plane`` has its device path (``device_path``) and the pool
        is bf16, the engine prefills, then stages ONE finished device
        parcel (``extract_pages_device``) for a CUDA IPC pull, as the
        reference stages one device array for its ``jax`` path; it does
        not call ``on_ticket``. A packed int8 parcel always takes the
        socket path, as in the reference. Otherwise, with ``on_ticket`` (a
        thread-safe callable) the extract is chunk-streamed: the ticket is
        staged and delivered BEFORE the prefill, one page group per chunk,
        so the decode worker pulls while later chunks compute. Without it
        (the prefill queue) the extract is split into up to 4 page groups,
        so sending one overlaps the next one's copy. The reference also
        stages in one piece after the prefill when device-to-host fetches
        are slow, as over a tunnelled TPU host; a locally attached card
        never is."""
        n = -(-len(req.token_ids) // self.config.page_size)
        meta = self._parcel_meta(n)
        if getattr(plane, "device_path", False) and \
                self.runner.quant_kv != "int8":
            first_token, handles, prompt_len = self._prefill_for_extract(
                req, 1, device=True)
            handle = handles[0][0]
            ticket = plane.stage(
                meta=meta, device_tensor=handle[0], event=handle[1],
                resolve=lambda: self.runner.device_parcel_to_host(handle),
                prompt_len=prompt_len)
            self.device_extracts += 1
            return first_token, ticket, prompt_len
        if on_ticket is not None:
            return self._prefill_extract_streamed(req, plane, meta,
                                                  on_ticket)
        first_token, handles, prompt_len = self._prefill_for_extract(req, 4)
        groups = [(pages, (lambda hh=h: self.runner.finalize_extract(hh)))
                  for h, pages in handles]
        ticket = plane.stage(meta=meta, resolve_groups=groups,
                             prompt_len=prompt_len)
        return first_token, ticket, prompt_len

    # Backstop for a streamed group's resolver: the plane's thread waits
    # for its chunk's extract at most this long (a failed prefill sets the
    # events, so only a wedged engine thread reaches it).
    STREAM_RESOLVE_TIMEOUT_S = 120.0

    def _prefill_extract_streamed(self, req: PreprocessedRequest, plane,
                                  meta: dict, on_ticket):
        """ENGINE THREAD ONLY. Chunk-streamed extract: stage the ticket
        first, with one page group per chunk (and one for a reused
        prefix), each gated on an event its extract dispatch sets; deliver
        it through ``on_ticket``; then run the chunks. A failure marks
        every pending group failed, so the pull errors, and re-raises."""
        r, plan = self._extract_request(req)
        page = self.config.page_size
        prompt_len = len(r.tokens_all)
        chunks = self._extract_chunks(r, plan)
        first_page = r.reuse_tokens // page
        bounds = [(0, first_page)] if first_page else []
        bounds += [(start // page, -(-(start + n_tok) // page))
                   for start, n_tok, _ in chunks]
        state: dict = {"handles": {}, "error": None}
        events = [threading.Event() for _ in bounds]
        timeout_s = self.STREAM_RESOLVE_TIMEOUT_S

        def resolver(idx: int):
            def resolve():
                if not events[idx].wait(timeout=timeout_s):
                    raise RuntimeError(f"streamed extract group {idx} never "
                                       "became ready (prefill wedged?)")
                if state["error"] is not None:
                    raise RuntimeError(
                        f"chunked prefill failed: {state['error']}")
                return self.runner.finalize_extract(state["handles"][idx])
            return resolve

        try:
            groups = [(hi - lo, resolver(i))
                      for i, (lo, hi) in enumerate(bounds)]
            ticket = plane.stage(meta=meta, resolve_groups=groups,
                                 prompt_len=prompt_len)
            self.streamed_extracts += 1
            on_ticket(ticket)

            def extract(gi: int) -> None:
                lo, hi = bounds[gi]
                state["handles"][gi] = self.runner.extract_pages_async(
                    r.pages[lo:hi])
                events[gi].set()

            gi = 0
            if first_page:
                extract(0)
                gi = 1
            for chunk in chunks:
                first_token = self._prefill_extract_chunk(r, plan, *chunk)
                extract(gi)
                gi += 1
            self._register_blocks(r)
            return first_token, ticket, prompt_len
        except BaseException as exc:
            # Pending resolvers fail fast instead of waiting out the
            # backstop.
            state["error"] = f"{type(exc).__name__}: {exc}"
            for ev in events:
                ev.set()
            raise
        finally:
            # Every extract is dispatched (or the parcel has failed):
            # stream order protects the pages.
            self.allocator.release(r.pages)
            r.pages = []

    # -- batched LoRA -----------------------------------------------------------
    def register_adapter(self, name: str, path: str | None = None,
                         weights: dict | None = None) -> None:
        """Register a LoRA adapter by PEFT directory or host weights (host
        work: the device upload happens at its first use, on the engine
        thread). Safe from any thread; ``engine.adapters.pin(name)`` keeps
        it resident."""
        if self.adapters is None:
            raise RuntimeError(
                "engine built without adapters (config.max_adapters=0)")
        self.adapters.register(name, path=path, weights=weights)

    def _acquire_adapter(self, r: _Request) -> bool:
        """Resolve the request's adapter to a resident slot (hot-loading
        on a miss; engine thread; ``_validate`` let in only requests whose
        adapter this engine registered). False after pushing the typed
        error when that fails: an adapter since unknown (404 at the front)
        or every slot held (503)."""
        name = r.req.adapter
        if not name or r.adapter_ref is not None:
            return True
        try:
            r.adapter_slot = self.adapters.acquire(name)
        except Exception as exc:  # noqa: BLE001 — typed errors reach the stream
            r.push(exc)
            return False
        r.adapter_ref = name
        return True

    def _release_adapter(self, r: _Request | None) -> None:
        if r is not None and r.adapter_ref is not None:
            self.adapters.release(r.adapter_ref)
            r.adapter_ref = None
            r.adapter_slot = 0

    # -- engine loop ----------------------------------------------------------
    def _warmup_window_programs(self) -> None:
        """Make the smallest page bucket's window programs before serving
        (captured on the card), then prefill the smallest prefill bucket:
        the counterpart of the reference's warmup. The runner makes a
        program at its key's first use on the engine thread, so without
        this the first requests stall on the captures; larger buckets are
        still made at first use. The work is inert: all-zero packed rows
        are inactive (PK_SEQLEN 0), so the windows write only the scratch
        page 0 and leave ``tokens_dev`` and ``counts`` as they are, and
        the prefill row writes only page 0. A spec engine with a TTFT
        budget also makes the plain programs its brownout falls back to."""
        start = t0 = time.monotonic()
        runner, M = self.runner, self.decode_window
        packed = np.zeros((self.config.max_num_seqs,
                           PK_PREFIX + runner.bucket_pages_for(1)), np.int32)
        cfg = self.config
        plain_keys = list(itertools.product((False, True), repeat=3))
        if cfg.spec_decode:
            # One spec program serves every sampling mix (they are data).
            # Plain windows run beside it only under brownout, and never
            # with penalties or logprobs (refused under spec).
            _Readback(runner.decode_spec_window(
                packed, self.spec_m_outer, cfg.spec_k)).numpy()
            brownout = cfg.ttft_budget_ms and cfg.brownout_spec_disable_level
            plain_keys = ([(False, seeded, False) for seeded in (False, True)]
                          if brownout else [])
        one = np.float32(1.0).view(np.int32)
        for penalized, seeded, logprobs in plain_keys:
            rows = packed.copy()
            rows[0, PK_FREQPEN] = one if penalized else 0
            rows[0, PK_SEEDED] = int(seeded)
            rows[0, PK_LOGPROB] = int(logprobs)
            _Readback(runner.decode_window(rows, M)).numpy()
        stats = runner.window_programs()
        log.info("warmed %d window programs M=%d in %.1fs (%.1fs capturing; "
                 "graph pool %.1f MiB)", stats["programs"], M,
                 time.monotonic() - t0, stats["capture_s"],
                 stats["graph_pool_bytes"] / 2**20)
        t0 = time.monotonic()
        bucket = self.config.prefill_buckets[0]
        seq = PrefillSeq(tokens=np.zeros(min(4, bucket), np.int32),
                         chunk_pages=np.zeros(1, np.int32),  # scratch page
                         sampling=(0.0, 0, 1.0))
        _Readback(self.runner.prefill_batch([seq])).numpy()
        self.warmup_seconds = time.monotonic() - start
        log.info("warmed prefill bucket %d in %.1fs", bucket,
                 time.monotonic() - t0)

    def _engine_loop(self, ready: threading.Event,
                     failure: list[BaseException]) -> None:
        log.info("engine loop starting (slots=%d pages=%d window=%d "
                 "chunk=%d)", self.config.max_num_seqs, self.runner.num_pages,
                 self.decode_window, self.prefill_chunk_tokens)
        try:
            if self.config.warmup_windows:
                self._warmup_window_programs()
        except Exception as exc:  # start() raises it
            log.exception("window program warmup failed")
            failure.append(exc)
            self._running = False
            return
        finally:
            ready.set()
        # The perf plane's warmup boundary: a runner capturing a key again
        # after this is flagged (larger buckets are still captured at first
        # use, and counted).
        self._perf.mark_ready()
        depth = max(1, self.config.pipeline_depth)
        while self._running:
            self._run_jobs()
            self._resolve_ready_first()
            self._resolve_spills()
            self._maintain_kvbm()
            self._retire_chunks()
            try:
                admitted = self._admit()
            except Exception:  # noqa: BLE001 — keep serving
                log.exception("admission failed")
                admitted = False
            # At most prefill_chunk_tokens of chunk work before the decode
            # window, so a long prompt delays live decode slots by about one
            # chunk per window instead of by the whole prompt.
            chunk_dispatched = self._dispatch_prefill_chunks()
            if self._inflight and self._inflight[-1].spec != self._use_spec():
                # A brownout switch of the window kind: each kind's next
                # window needs the host's exact positions and tokens.
                self._drain_windows()
            have_active = any(r is not None and not r.prefilling
                              for r in self.slot_req)
            if not have_active:
                self._stalled_pages = 0  # no decode slot is waiting
                self._last_decode_dispatch = None
            dispatched = False
            if have_active and len(self._inflight) < depth:
                self._note_dispatch_gap()
                try:
                    window = self._dispatch_window()
                except Exception as exc:  # noqa: BLE001 — fail all, keep serving
                    log.exception("decode window dispatch failed")
                    for i, r in enumerate(self.slot_req):
                        if r is not None and not r.prefilling:
                            r.push(RuntimeError(f"engine step failed: {exc}"))
                            self._finish_slot(i, register=False)
                else:
                    if window.toks is None:
                        self._do_process(window)
                    else:
                        self._inflight.append(window)
                        dispatched = True
            # Process the oldest window once the pipe is full (or drain it
            # when nothing new could be dispatched).
            processed = bool(self._inflight) and (
                len(self._inflight) >= depth or not dispatched)
            if processed:
                window = self._inflight.popleft()
                self._do_process(window)
                self.step_count += 1
                self._note_flight(window)
            self._release_ready_pages()
            if processed:
                # After the release, so a worker gone idle reports the
                # pages its last finished requests held as free.
                self._publish()
            if self._inflight or chunk_dispatched:
                continue
            if not have_active and self._chunk_inflight:
                # Prefill-only phase at full chunk depth: wait for the
                # oldest chunk instead of spinning.
                self._retire_chunks(block=True)
            elif self._pending_first:
                self._resolve_ready_first(force=True)
            elif (not admitted and not have_active and not self._prefilling
                  and self._jobs.empty()):
                self._resolve_spills(force=True)
                # Idle: until work arrives, or IDLE_WAIT_S for the
                # periodic duties (spills, the KVBM sweep, queued kills).
                self._wake.wait(IDLE_WAIT_S)
                self._wake.clear()

    # -- KV tiers (G2/G3 offload, onboarding from G2/G3/G4) -------------------
    @property
    def remote_source(self):
        """The G4 tier (``kv_plane.RemoteBlockSource``), set by the worker
        once its KV plane is up; it lives on the KVBM."""
        return self.kvbm.remote_source

    @remote_source.setter
    def remote_source(self, source) -> None:
        self.kvbm.remote_source = source

    def _maintain_kvbm(self) -> None:
        """The watermark sweep, once per loop iteration: its demotions
        queue extracts through the evict hook, and the flush dispatches
        them before any later program can rewrite the freed pages."""
        if self.kvbm.maintain():
            self._flush_spills()

    def _to_local_parcel(self, kv: np.ndarray) -> np.ndarray:
        """A block in this pool's parcel form: packed int8 + scales for an
        int8 pool, bf16 bits otherwise (peers may run the other KV
        dtype)."""
        if self.runner.quant_kv == "int8":
            return parcel_to_packed(kv)
        return parcel_to_bf16(kv)

    def _on_evict(self, block_hash: int, page: int) -> None:
        self._evict_buffer.append((block_hash, page))

    def _flush_spills(self) -> None:
        """Dispatch one batched extract of the pages evicted since the
        last flush. It must run after every allocation and before any
        program that writes pages: stream order then puts the read before
        the overwrite. The host copy resolves in ``_resolve_spills``."""
        if not self._evict_buffer:
            return
        batch, self._evict_buffer = self._evict_buffer, []
        try:
            handle = self.runner.extract_pages_async([p for _, p in batch])
        except Exception:  # noqa: BLE001 — offload is best effort
            log.exception("spill extract failed; blocks dropped from tiers")
            self.spill_failures += 1
            return
        self._pending_spills.append({"handle": handle,
                                     "hashes": [h for h, _ in batch]})

    def _resolve_spills(self, force: bool = False) -> None:
        """Store the spilled blocks whose host copy is done in the host
        tier; with ``force``, wait for every pending copy (the idle
        loop)."""
        for entry in list(self._pending_spills):
            if not (force or self.runner.extract_ready(entry["handle"])):
                continue
            self._pending_spills.remove(entry)
            try:
                kv = self.runner.finalize_extract(entry["handle"])
            except Exception:  # noqa: BLE001
                log.exception("spill fetch failed; blocks dropped")
                self.spill_failures += 1
                continue
            for i, h in enumerate(entry["hashes"]):
                self.kvbm.offload(h, kv[:, :, :, i])

    def _try_onboard(self, r: _Request, hashes: list[int],
                     cached_pages: list[int]) -> tuple[list[int], int, int]:
        """Extend the device prefix hit with consecutive G2/G3 blocks and,
        past those, G4 blocks from peers' host tiers, uploaded into fresh
        pages (registered for sharing) instead of recomputed. Returns
        (pages, tokens, peer tokens)."""
        page = self.config.page_size
        if self.host_cache is None and self.remote_source is None:
            return [], 0, 0
        # Never past the second-to-last block: the last token is always
        # recomputed for its logits, as for a device hit.
        allowed = (len(r.tokens_all) - 1) // page - len(cached_pages)
        if allowed <= 0:
            return [], 0, 0
        blocks, n_peer = self.kvbm.onboard_walk(hashes, len(cached_pages),
                                                allowed,
                                                trace_id=r.ctx.trace_id)
        if not blocks:
            return [], 0, 0
        # Peers (and a disk directory another worker wrote) may hold the
        # other KV dtype: every block in this pool's form.
        blocks = [(h, self._to_local_parcel(kv)) for h, kv in blocks]
        if n_peer:
            self.g4_blocks += n_peer
            if self.host_cache is not None:
                # Peer blocks land in the local G2 too, so the next hit is
                # one hop shorter.
                for h, kv in blocks[len(blocks) - n_peer:]:
                    self.host_cache.put(h, kv, promotion=True)
        pages = self.allocator.allocate(len(blocks))
        if pages is None:
            return [], 0, 0
        self._flush_spills()  # the allocation may itself have evicted
        stacked = np.stack([kv for _, kv in blocks], axis=3)
        try:
            self.runner.insert_pages(stacked, pages)
        except Exception:  # noqa: BLE001 — recompute instead
            log.exception("onboard upload failed; recomputing instead")
            self.onboard_failures += 1
            self.allocator.release(pages)
            return [], 0, 0
        for (h, _), p in zip(blocks, pages):
            self.allocator.register(p, h)
        self.onboard_blocks += len(blocks)
        self.kvbm.note_promoted(len(blocks) - n_peer, n_peer,
                                trace_id=r.ctx.trace_id)
        return pages, len(blocks) * page, n_peer * page

    def _release_ready_pages(self) -> None:
        """Release deferred pages once no in-flight window can still
        scatter to them (windows process in serial order)."""
        if not self._pending_release:
            return
        fence = (self._inflight[0].serial - 1 if self._inflight
                 else self._dispatch_serial)
        keep = []
        for serial, pages in self._pending_release:
            if serial <= fence:
                self.allocator.release(pages)
            else:
                keep.append((serial, pages))
        self._pending_release = keep

    def _resolve_ready_first(self, force: bool = False) -> None:
        for entry in list(self._pending_first):
            if force or entry["handle"].ready():
                self._pending_first.remove(entry)
                self._resolve_first(entry)

    def _force_resolve_first_for(self, slots_needed: set[int]) -> None:
        for entry in list(self._pending_first):
            if any(slot in slots_needed and self.slot_req[slot] is r
                   for _, r, slot, _ in entry["rows"]):
                self._pending_first.remove(entry)
                self._resolve_first(entry)

    def _resolve_first(self, entry: dict) -> None:
        cold = entry.get("cold", 0)
        if cold:
            # The rows' cold tokens leave the ledger, and the dispatch ->
            # readback interval calibrates the projection's rate.
            self._cold_inflight -= cold
            self._prefill_rate_sample(cold, time.monotonic() - entry["t0"])
        try:
            vals, lps, top_vs, top_is = entry["handle"].numpy()
        except Exception as exc:  # noqa: BLE001 — device fault at readback
            log.exception("first-token readback failed")
            for _, r, slot, epoch in entry["rows"]:
                if self.slot_req[slot] is r and r.epoch == epoch:
                    r.push(RuntimeError(f"prefill readback failed: {exc}"))
                    self._finish_slot(slot, register=False)
            return
        t0 = entry.get("t0")
        if t0:
            # Prefill phase: dispatch to first-token readback.
            t1 = time.monotonic()
            if self.phase is not None:
                self.phase.prefill.observe(t1 - t0)
            rec = self._recorder
            if rec.enabled:
                for _, r, slot, epoch in entry["rows"]:
                    if self.slot_req[slot] is r and r.epoch == epoch:
                        rec.add("engine.prefill", r.ctx.trace_id,
                                r.ctx.span_id, t0, t1,
                                attrs={"prompt_tokens":
                                       len(r.req.token_ids),
                                       "reuse_tokens": r.reuse_tokens,
                                       "chunked": bool(
                                           entry.get("chunked"))})
        for row, r, slot, epoch in entry["rows"]:
            if self.slot_req[slot] is not r or r.epoch != epoch:
                continue  # slot reassigned (failure path already notified)
            tok = int(vals[row])
            r.generated += 1
            finish = self._check_finish(r, tok)
            lp_out = None
            k = r.req.sampling_options.logprobs
            if k is not None:
                lp_out = ([float(lps[row])],
                          [[{"token_id": int(top_is[row, j]),
                             "logprob": float(top_vs[row, j])}
                            for j in range(k)]])
            self._emit(r, [tok], finish, lp_out)
            r.last_token = tok
            r.tokens_all.append(tok)
            if finish is not None:
                self._finish_slot(slot, register=True)

    def _do_process(self, w: _Window) -> None:
        try:
            self._process_window(w)
        except Exception as exc:  # noqa: BLE001
            # Host token state has diverged from the device chain: fail
            # every request this window covered.
            log.exception("window processing failed")
            for i, snap in enumerate(w.slots):
                if snap is not None and self.slot_req[i] is snap[0]:
                    snap[0].push(RuntimeError(
                        f"window processing failed: {exc}"))
                    self._finish_slot(i, register=False)

    # -- admission / prefill --------------------------------------------------
    def _admit(self) -> bool:
        cfg = self.config
        self._update_brownout()
        free_slots = [i for i, r in enumerate(self.slot_req) if r is None]
        staged: list[tuple[_Request, int, PrefillSeq]] = []
        while free_slots:
            if self._deferred_head is not None:
                r, self._deferred_head = self._deferred_head, None
            else:
                try:
                    r = self.waiting.get_nowait()
                except queue.Empty:
                    break
            self._queue_pop_accounting(r)
            if r.ctx.is_killed or r.ctx.is_stopped:
                r.push(LLMEngineOutput(
                    token_ids=[],
                    finish_reason=FinishReason.CANCELLED).to_wire())
                continue
            # The adapter first (its hot-load is device work): an unknown
            # one fails here and a slot-starved store answers overloaded,
            # before any page is touched.
            if not self._acquire_adapter(r):
                continue
            if r.injected is not None:
                self._note_queue_wait(r)
                slot = free_slots.pop(0)
                try:
                    if self._admit_injected(r, slot):
                        continue
                except Exception as exc:  # noqa: BLE001
                    log.exception("KV injection failed")
                    r.push(RuntimeError(f"kv injection failed: {exc}"))
                    free_slots.insert(0, slot)
                    self._release_adapter(r)
                    continue
                # No pages for the parcel: prefill the whole prompt here.
                free_slots.insert(0, slot)
                r.injected = None
            if (cfg.ttft_budget_ms and self._cold_inflight > 0
                    and self.prefill_rate_tok_s):
                # SLA gate: admitting this prompt must not push the
                # projected prefill backlog past the TTFT budget. With
                # nothing cold in flight the head always admits (an
                # over-budget single prompt must not starve).
                projected = ((self._cold_inflight + len(r.tokens_all))
                             / self.prefill_rate_tok_s * 1e3)
                if projected > cfg.ttft_budget_ms:
                    # Park at the HEAD (strict FIFO), back in the ledger;
                    # the adapter reference goes so it pins no slot.
                    self._release_adapter(r)
                    r.queued_cold = len(r.tokens_all)
                    with self._queue_stats_lock:
                        self._waiting_cold += r.queued_cold
                    self._deferred_head = r
                    self.admission_deferred += 1
                    break
            self._note_queue_wait(r)
            try:
                plan = self._plan_prefill(r)
            except Exception as exc:  # noqa: BLE001
                log.exception("prefill planning failed")
                r.push(RuntimeError(f"prefill failed: {exc}"))
                self._release_adapter(r)
                continue
            if plan is None:
                # No KV room: put back and stop admitting (the adapter
                # reference goes too, so a queued request pins no slot).
                self._release_adapter(r)
                self._queue_put(r)
                break
            slot = free_slots.pop(0)
            r.cold_tokens = len(r.tokens_all) - r.reuse_tokens
            self._cold_inflight += r.cold_tokens
            if plan == "chunked":
                # The long prompt becomes scheduled chunk work; the slot
                # and every page are held now, and decode windows skip the
                # slot until the final chunk places it.
                r.prefilling = True
                r.prefill_pos = r.reuse_tokens
                r.prefill_t0 = time.monotonic()
                r.slot = slot
                self.slot_req[slot] = r
                self.disp_positions[slot] = 0
                self.disp_seq_lens[slot] = 0
                self.overrides.pop(slot, None)
                self._prefilling.append(r)
                continue
            staged.append((r, slot, plan))
        if not staged:
            return False
        # Batch the staged rows, those with history apart from those
        # without, while the padded batch stays within max_prefill_tokens.
        groups: list[list] = []
        for with_h in (False, True):
            group: list = []
            for item in staged:
                if (item[2].hist_pages is not None) != with_h:
                    continue
                trial = group + [item]
                n_max = max(len(p.tokens) for _, _, p in trial)
                if group and len(trial) * cfg.bucket_for(n_max) \
                        <= cfg.max_prefill_tokens:
                    group = trial
                else:
                    if group:
                        groups.append(group)
                    group = [item]
            if group:
                groups.append(group)
        for group in groups:
            counts = None
            if any(any(p.penalties) for _, _, p in group):
                counts = np.stack([self._count_row_of(r)
                                   for r, _, _ in group])
            try:
                outs = self.runner.prefill_batch(
                    [p for _, _, p in group],
                    slots=[s for _, s, _ in group], count_rows=counts)
            except Exception as exc:  # noqa: BLE001
                log.exception("batched prefill failed")
                for r, _, _ in group:
                    self._cold_inflight -= r.cold_tokens
                    r.cold_tokens = 0
                    self.allocator.release(r.pages)
                    r.pages = []
                    self._release_adapter(r)
                    r.push(RuntimeError(f"prefill failed: {exc}"))
                continue
            rows = []
            for row, (r, slot, _) in enumerate(group):
                self._place_in_slot_pending(r, slot)
                rows.append((row, r, slot, r.epoch))
            if self.config.spec_decode:
                # The whole prompt (a reused prefix and a requeued request's
                # generated tokens too) into the draft history; the first
                # token follows from tokens_dev.
                self.runner.seed_history([
                    (slot, np.asarray(r.tokens_all, np.int32), 0, True, None)
                    for r, slot, _ in group])
            self._pending_first.append({
                "handle": _Readback(outs), "rows": rows,
                "cold": sum(r.cold_tokens for r, _, _ in group),
                "t0": time.monotonic()})
        return True

    def _admit_injected(self, r: _Request, slot: int) -> bool:
        """Place a remotely prefilled request: allocate its pages, insert
        the parcel and start decoding at its first token. False when the
        pool has no room (the caller prefills locally)."""
        page = self.config.page_size
        first_token, kv = r.injected
        prompt = r.tokens_all
        total_pages = -(-len(prompt) // page)
        if kv.shape[3] != total_pages:
            raise ValueError(f"transferred KV has {kv.shape[3]} pages, the "
                             f"prompt needs {total_pages}")
        if self.allocator.num_free - total_pages < self._stalled_pages:
            return False
        pages = self.allocator.allocate(total_pages)
        if pages is None:
            return False
        self._flush_spills()
        try:
            self.runner.insert_pages(kv, pages)
        except BaseException:
            self.allocator.release(pages)
            raise
        r.blocks = TokenBlockSequence(page, prompt,
                                      salt=chain_salt(r.req.adapter))
        r.pages = pages
        r.injected = None
        self.injected_admissions += 1
        if self.config.spec_decode:
            # No local prefill ran: the history's first token comes from
            # the host.
            self.runner.seed_history([(slot, np.asarray(prompt, np.int32),
                                       0, True, int(first_token))])
        self._place_in_slot(r, slot, first_token)
        return True

    def _place_in_slot(self, r: _Request, slot: int, first_token: int) -> None:
        """Occupy a slot with a first token known on the host (an injected
        request): emit it, and let the next window take it as the slot's
        override token."""
        self._place_in_slot_pending(r, slot)
        r.generated += 1
        finish = self._check_finish(r, first_token)
        self._emit(r, [first_token], finish)
        r.last_token = first_token
        r.tokens_all.append(first_token)
        if finish is not None:
            self._finish_slot(slot, register=True)
            return
        if any(self._penalties_of(r)):
            # The count row covers the first token, as a local prefill's
            # bumped row does.
            self.runner.set_count_rows([slot], self._count_row_of(r)[None])
        self.overrides[slot] = first_token

    def _plan_prefill(self, r: _Request):
        """Pin the cached prefix pages and allocate the rest. Returns a
        PrefillSeq (one prefill program), "chunked" (the rest is longer
        than one program takes: scheduled chunks), or None (no KV room)."""
        cfg = self.config
        page = cfg.page_size
        prompt = r.tokens_all
        # An adapter's KV must never alias the base model's or another
        # adapter's: the same tokens through adapter A give other K/V, so
        # its hash chain roots at the adapter's salt, for prefix reuse and
        # KV events alike.
        r.blocks = TokenBlockSequence(page, prompt,
                                      salt=chain_salt(r.req.adapter))
        hashes = r.blocks.block_hashes
        # Exact reproduction for seeded sampling: prefix reuse changes
        # which program computes the tail, and low-bit logit differences
        # flip near-ties under temperature sampling, so the same (prompt,
        # seed) would depend on what is cached. First admission takes the
        # no-reuse path; a preempted request's recompute keeps reuse (the
        # pages it finds are its own run's history).
        s = r.req.sampling_options
        canonical = (s.seed is not None and (s.temperature or 0.0) > 0.0
                     and r.generated == 0)
        cached = [] if canonical else self.allocator.acquire_cached(hashes)
        if len(cached) * page >= len(prompt):
            # Recompute at least the last token, for its logits.
            drop = (len(cached) * page - len(prompt)) // page + 1
            self.allocator.release(cached[len(cached) - drop:])
            cached = cached[:len(cached) - drop]
        self.prefix_lookup_blocks += max(1, len(hashes))
        self.prefix_hit_blocks += len(cached)
        need = -(-len(prompt) // page) - len(cached)
        if self.allocator.num_free - need < self._stalled_pages:
            self.allocator.release(cached)
            return None
        # Extend the hit from the host, disk and peer tiers before
        # recomputing (seeded first admissions take no reuse at all).
        if not canonical:
            onboarded = self._try_onboard(r, hashes, cached)[0]
            cached += onboarded
            need -= len(onboarded)
        reuse = len(cached) * page
        new_pages = self.allocator.allocate(need)
        if new_pages is None:
            self.allocator.release(cached)
            return None
        # Extract what the allocations evicted before the prefill
        # overwrites those pages.
        self._flush_spills()
        r.pages = cached + new_pages
        r.reuse_tokens = reuse
        if len(prompt) - reuse > cfg.max_prompt_len:
            return "chunked"
        return PrefillSeq(
            tokens=np.asarray(prompt[reuse:], np.int32), start_pos=reuse,
            chunk_pages=np.asarray(new_pages, np.int32),
            hist_pages=np.asarray(cached, np.int32) if cached else None,
            sampling=self._sampling_of(r),
            logprobs=s.logprobs is not None,
            penalties=self._penalties_of(r), seed=s.seed,
            adapter_id=r.adapter_slot)

    # -- stall-free chunked prefill -------------------------------------------
    def _chunk_seq(self, r: _Request, start: int, n: int,
                   final: bool) -> PrefillSeq:
        """The chunk row of ``r``'s prompt at [start, start + n). Only the
        final chunk samples, so only it carries sampling, penalties,
        logprobs and seed."""
        page = self.config.page_size
        first_page = start // page
        seq = PrefillSeq(
            tokens=np.asarray(r.tokens_all[start:start + n], np.int32),
            chunk_pages=np.asarray(
                r.pages[first_page:first_page + -(-n // page)], np.int32),
            sampling=(0.0, 0, 1.0), start_pos=start,
            hist_pages=(np.asarray(r.pages[:first_page], np.int32)
                        if first_page else None),
            adapter_id=r.adapter_slot)
        if final:
            s = r.req.sampling_options
            seq.sampling = self._sampling_of(r)
            seq.logprobs = s.logprobs is not None
            seq.penalties = self._penalties_of(r)
            seq.seed = s.seed
        return seq

    def _dispatch_prefill_chunks(self) -> bool:
        """One scheduling pass over the prefilling requests: dispatch at
        most ``prefill_chunk_tokens`` of chunk work, shared oldest-first
        (non-final chunks end on a page boundary). Chunks in flight are
        bounded by pipeline_depth, like decode windows. Returns True when
        anything was dispatched."""
        if not self._prefilling:
            return False
        try:
            return self._dispatch_chunk_pass()
        finally:
            if self.m_chunks_inflight is not None:
                self.m_chunks_inflight.set(len(self._chunk_inflight))

    def _dispatch_chunk_pass(self) -> bool:
        page = self.config.page_size
        depth = max(1, self.config.pipeline_depth)
        max_chunk = self.config.max_prompt_len
        budget = self.prefill_chunk_tokens
        dispatched = False
        queue_snap = sorted(self._prefilling, key=lambda x: x.enqueue_t)
        for idx, r in enumerate(queue_snap):
            if budget < page or len(self._chunk_inflight) >= depth:
                break
            if r.ctx.is_killed or r.ctx.is_stopped:
                self._abort_prefilling(r, finish=FinishReason.CANCELLED)
                continue
            share = max(page, budget // (len(queue_snap) - idx))
            remaining = len(r.tokens_all) - r.prefill_pos
            n = min(share, max_chunk, remaining)
            final = n >= remaining
            if not final:
                n = (n // page) * page
                if n <= 0:
                    continue
            try:
                self._dispatch_one_chunk(r, n, final)
            except Exception as exc:  # noqa: BLE001
                log.exception("chunk prefill dispatch failed")
                self._abort_prefilling(r, error=exc)
                continue
            budget -= n
            dispatched = True
        return dispatched

    def _dispatch_one_chunk(self, r: _Request, n: int, final: bool) -> None:
        start = r.prefill_pos
        seq = self._chunk_seq(r, start, n, final)
        fence = _Fence(self.runner.device)
        record = {"request": r.ctx.id, "start": start, "tokens": n,
                  "final": final, "windows_before": self.windows_dispatched}
        if not final:
            # The chunk's K/V chains on the device; nothing is read back.
            self.runner.prefill_chunk_async(seq)
        else:
            # The final chunk samples the first token into tokens_dev[slot]
            # (decode windows chain from it) and its host value resolves
            # asynchronously like any prefill's.
            counts = (self._count_row_of(r)[None]
                      if any(seq.penalties) else None)
            outs = self.runner.prefill_batch([seq], slots=[r.slot],
                                             count_rows=counts)
            self._prefilling.remove(r)
            r.prefilling = False
            self._place_in_slot_pending(r, r.slot)
            if self.config.spec_decode:
                self.runner.seed_history([(r.slot, np.asarray(
                    r.tokens_all, np.int32), 0, True, None)])
            self._pending_first.append({"handle": _Readback(outs),
                                        "rows": [(0, r, r.slot, r.epoch)],
                                        "cold": r.cold_tokens,
                                        "t0": r.prefill_t0,
                                        "chunked": True})
        self._chunk_inflight.append({"fence": fence.close(),
                                     "record": record, "r": r,
                                     "t0": time.monotonic()})
        r.prefill_pos = start + n
        self.chunk_tokens_total += n
        self.chunk_dispatch_count += 1
        if self.m_chunk_tokens is not None:
            self.m_chunk_tokens.inc(n)

    def _retire_chunks(self, block: bool = False) -> None:
        """Pop completed chunks off the in-flight deque (they complete in
        dispatch order) and record them. With ``block``, wait for the
        oldest first."""
        while self._chunk_inflight:
            entry = self._chunk_inflight[0]
            if not entry["fence"].ready():
                if not block:
                    break
                entry["fence"].wait()
                block = False  # only ever wait for the oldest
            self._chunk_inflight.popleft()
            self.chunk_records.append(
                dict(entry["record"], device_ms=entry["fence"].device_ms()))
            r = entry["r"]
            if self._recorder.enabled:
                self._recorder.add(
                    "prefill.chunk", r.ctx.trace_id, r.ctx.span_id,
                    entry["t0"], time.monotonic(),
                    attrs={"tokens": entry["record"]["tokens"],
                           "start": entry["record"]["start"]})
        if self.m_chunks_inflight is not None:
            self.m_chunks_inflight.set(len(self._chunk_inflight))

    def _abort_prefilling(self, r: _Request,
                          finish: FinishReason | None = None,
                          error: Exception | None = None) -> None:
        """End a request mid-chunked-prefill (cancellation or a dispatch
        failure): free its slot and pages (deferred past in-flight device
        work) and close the stream with the finish reason or error. Its
        chunk pages were never registered."""
        if r in self._prefilling:
            self._prefilling.remove(r)
        r.prefilling = False
        self._cold_inflight -= r.cold_tokens
        r.cold_tokens = 0
        if error is not None:
            r.push(RuntimeError(f"prefill failed: {error}"))
        else:
            r.push(LLMEngineOutput(
                token_ids=[],
                finish_reason=finish or FinishReason.CANCELLED).to_wire())
        self._finish_slot(r.slot, register=True)

    def _preempt_prefilling(self, r: _Request) -> None:
        """KV-pressure victim while still prefilling: drop the remaining
        chunks and requeue the whole request (it re-prefills later)."""
        self._prefilling.remove(r)
        r.prefilling = False
        self._cold_inflight -= r.cold_tokens
        r.cold_tokens = 0
        self._requeue_slot(r.slot)

    @staticmethod
    def _sampling_of(r: _Request) -> tuple[float, int, float]:
        s = r.req.sampling_options
        return (s.temperature or 0.0, s.top_k or 0, s.top_p or 1.0)

    @staticmethod
    def _penalties_of(r: _Request) -> tuple[float, float]:
        s = r.req.sampling_options
        return (s.frequency_penalty or 0.0, s.presence_penalty or 0.0)

    def _count_row_of(self, r: _Request) -> np.ndarray:
        """uint8 [vocab] counts of this request's generated tokens so far
        (penalty state; saturates at 255). tokens_all is authoritative, so
        a preempted request's re-prefill rebuilds its counts."""
        row = np.zeros(self.runner.spec.vocab_size, np.int64)
        gen = r.tokens_all[len(r.req.token_ids):]
        if gen:
            np.add.at(row, np.asarray(gen, np.int64), 1)
        return np.minimum(row, 255).astype(np.uint8)

    def _place_in_slot_pending(self, r: _Request, slot: int) -> None:
        """Occupy a slot whose first token is still on the device (in
        runner.tokens_dev): decode windows chain from it with no override;
        the host value is emitted when the readback resolves. The prompt's
        complete blocks are registered for prefix reuse now: later device
        work reads them after the prefill, in stream order."""
        for idx, h in enumerate(r.blocks.block_hashes):
            self.allocator.register(r.pages[idx], h)
        prompt_len = len(r.tokens_all)
        r.slot = slot
        r.epoch += 1
        r.last_token = None
        self.slot_req[slot] = r
        self.disp_positions[slot] = prompt_len
        self.disp_seq_lens[slot] = prompt_len + 1
        temp, tk, tp = self._sampling_of(r)
        self.temperature[slot] = temp
        self.top_k[slot] = tk
        self.top_p[slot] = tp
        self.freq_pen[slot], self.pres_pen[slot] = self._penalties_of(r)
        seed = r.req.sampling_options.seed
        self.seeded[slot] = seed is not None
        self.seeds[slot] = 0 if seed is None else mask_seed(seed)
        self.adapter_ids[slot] = r.adapter_slot
        self.overrides.pop(slot, None)
        # Placement seeds the slot's draft history and position.
        self._hist_stale[slot] = False

    # -- decode windows -------------------------------------------------------
    def _dispatch_window(self) -> _Window:
        cfg = self.config
        page = cfg.page_size
        M = self.decode_window
        b = cfg.max_num_seqs
        frozen: dict[int, tuple] = {}
        stalled: set[int] = set()
        satisfied: set[int] = set()
        deficits: dict[int, int] = {}
        needed_max = 1
        # Prefilling slots have no token chain yet, and their pages were
        # all allocated at admission.
        live = [i for i, r in enumerate(self.slot_req)
                if r is not None and not r.prefilling]
        n_live = len(live)
        # Allocate pages oldest-request-first (requeued requests keep their
        # original enqueue time, so they age past new arrivals).
        order = sorted(live, key=lambda j: self.slot_req[j].enqueue_t)
        for i in order:
            r = self.slot_req[i]
            if int(self.disp_seq_lens[i]) >= r.len_cap:
                # Every token this request may emit is already produced or
                # covered by an in-flight window.
                satisfied.add(i)
                continue
            last_pos = int(self.disp_positions[i]) + M - 1
            needed = min(last_pos // page + 1, cfg.max_pages_per_seq,
                         (r.len_cap - 1) // page + 1)
            ok = True
            while len(r.pages) < needed:
                new = self.allocator.allocate(1)
                if new is None:
                    ok = False
                    break
                r.pages.extend(new)
            if not ok:
                pending = sum(len(p) for _, p in self._pending_release)
                if (n_live == 1 and not self._prefilling
                        and needed - len(r.pages)
                        > self.allocator.num_free + pending):
                    frozen[i] = (r, r.epoch, "oom")
                else:
                    deficits[i] = needed - len(r.pages)
                    stalled.add(i)
                continue
            needed_max = max(needed_max, len(r.pages))
        if deficits:
            # Preempt the youngest live slots until the pages they free
            # (released after the in-flight windows) cover what older
            # slots need; the oldest slot is never a victim.
            freed = sum(len(p) for _, p in self._pending_release)
            want = sum(deficits.values())
            for j in reversed(order[1:]):
                if freed >= want:
                    break
                if j in frozen or j in satisfied:
                    continue
                r_j = self.slot_req[j]
                want -= deficits.pop(j, 0)
                stalled.discard(j)
                frozen[j] = (r_j, r_j.epoch, "requeue")
                freed += len(r_j.pages)
            if freed < want:
                # Then requests still prefilling, youngest first: their
                # chunk work is recomputable, and cached prefixes make the
                # re-prefill cheap. No in-flight window carries their slots.
                for rp in sorted(self._prefilling,
                                 key=lambda x: x.enqueue_t, reverse=True):
                    if freed >= want:
                        break
                    freed += len(rp.pages)
                    self._preempt_prefilling(rp)
        self._stalled_pages = sum(deficits.values())
        # The page growth above may have evicted: extract before the
        # window writes those pages.
        self._flush_spills()
        active_rows = [i for i in live if i not in frozen
                       and i not in stalled and i not in satisfied]
        # This dispatch's decision supersedes earlier preemption records
        # for slots it keeps.
        for w in self._inflight:
            for i in (*active_rows, *stalled, *satisfied):
                w.frozen.pop(i, None)
        self._dispatch_serial += 1
        if not active_rows:
            return _Window(toks=None, slots=[None] * b, frozen=frozen,
                           size=M, serial=self._dispatch_serial,
                           t0=time.monotonic())
        bucket = self.runner.bucket_pages_for(needed_max)
        packed = np.zeros((b, PK_PREFIX + bucket), np.int32)
        slots: list = [None] * b
        for i in active_rows:
            r = self.slot_req[i]
            tok = self.overrides.pop(i, None)
            if tok is not None:
                packed[i, PK_OVERRIDE] = 1
                packed[i, PK_TOKEN] = tok
            start = int(self.disp_positions[i])
            cap = len(r.pages) * page
            packed[i, PK_POS] = start
            packed[i, PK_SEQLEN] = self.disp_seq_lens[i]
            packed[i, PK_TOPK] = self.top_k[i]
            packed[i, PK_TEMP] = self.temperature[i:i + 1].view(np.int32)[0]
            packed[i, PK_TOPP] = self.top_p[i:i + 1].view(np.int32)[0]
            packed[i, PK_CAP] = cap
            if r.req.sampling_options.logprobs is not None:
                packed[i, PK_LOGPROB] = 1
            packed[i, PK_FREQPEN] = self.freq_pen[i:i + 1].view(np.int32)[0]
            packed[i, PK_PRESPEN] = self.pres_pen[i:i + 1].view(np.int32)[0]
            packed[i, PK_SEED] = self.seeds[i]
            packed[i, PK_SEEDED] = int(self.seeded[i])
            packed[i, PK_ADAPTER] = self.adapter_ids[i]
            packed[i, PK_PREFIX:PK_PREFIX + len(r.pages)] = r.pages
            slots[i] = (r, r.epoch, start, cap)
            adv = min(M, max(0, cap - start))
            self.disp_positions[i] += adv
            self.disp_seq_lens[i] += adv
        t0 = time.monotonic()
        spec = self._use_spec()
        if spec:
            self._refresh_stale_history(active_rows)
            outs = self.runner.decode_spec_window(packed, self.spec_m_outer,
                                                  cfg.spec_k)
        else:
            if cfg.spec_decode:
                # Brownout: a plain window, which advances neither the
                # slots' draft history nor their device positions.
                self.spec_brownout_windows += 1
                self._hist_stale[active_rows] = True
            outs = self.runner.decode_window(packed, M)
        self.windows_dispatched += 1
        return _Window(toks=_Readback(outs), slots=slots, frozen=frozen,
                       size=M, serial=self._dispatch_serial, t0=t0,
                       spec=spec)

    def _refresh_stale_history(self, rows: list[int]) -> None:
        """Before a spec window: rewrite the draft history and position of
        every slot that plain windows advanced since its last spec window
        from the host's tokens (``seed_history``; the position is that of
        the token the window feeds next). The engine loop processes every
        in-flight window before the window kind switches, so the host's
        tokens are complete here."""
        stale = [i for i in rows if self._hist_stale[i]]
        if not stale:
            return
        entries = []
        for i in stale:
            toks = self.slot_req[i].tokens_all
            entries.append((i, np.asarray(toks[:-1], np.int32), 0, True,
                            int(toks[-1])))
        self.runner.seed_history(entries)
        self._hist_stale[stale] = False

    def _drain_windows(self) -> None:
        """Process every in-flight window (a brownout switch of the window
        kind: the next window's host inputs must be exact)."""
        while self._inflight:
            window = self._inflight.popleft()
            self._do_process(window)
            self.step_count += 1
            self._note_flight(window)

    def _process_window(self, w: _Window) -> None:
        page = self.config.page_size
        toks = None
        if w.toks is not None:
            arrays = w.toks.numpy()
            self.window_seconds.append(time.monotonic() - w.t0)
            if self.phase is not None:
                self.phase.decode.observe(time.monotonic() - w.t0)
            if not w.spec:
                toks, lps, top_vs, top_is = arrays
        self._release_ready_pages()
        # The host token chains need every touched slot's first token.
        if self._pending_first:
            need = {i for i, snap in enumerate(w.slots)
                    if snap is not None and snap[0].last_token is None}
            need |= {i for i, (fr, _, _) in w.frozen.items()
                     if fr.last_token is None}
            if need:
                self._force_resolve_first_for(need)
        for i, (fr, fepoch, reason) in w.frozen.items():
            r = self.slot_req[i]
            if r is not fr or r is None or r.epoch != fepoch:
                continue  # slot reassigned since dispatch
            if reason == "oom":
                r.push(RuntimeError(
                    "KV pool exhausted and no other request to preempt"))
                self._finish_slot(i, register=False)
            else:
                self._requeue_slot(i)
        if w.toks is None:
            return
        if w.spec:
            self._process_spec_window(w, *arrays)
            return
        for i, snap in enumerate(w.slots):
            if snap is None:
                continue
            r, epoch, start, cap = snap
            if self.slot_req[i] is not r or r.epoch != epoch:
                continue  # slot reassigned since dispatch
            if r.ctx.is_killed:
                r.push(None)
                self._finish_slot(i, register=True)
                continue
            accepted: list[int] = []
            k = r.req.sampling_options.logprobs
            lp_out = ([], []) if k is not None else None
            finish = None
            inp = r.last_token
            for m in range(w.size):
                if start + m >= cap:
                    # The slot reached its page capacity and froze.
                    finish = FinishReason.LENGTH
                    break
                token = int(toks[m, i])
                r.generated += 1
                # The step's input token now has K/V in the pool: register
                # the page it completes under its chained hash.
                new_block = r.blocks.append(inp)
                if new_block is not None:
                    self.allocator.register(
                        r.pages[len(r.blocks.tokens) // page - 1], new_block)
                accepted.append(token)
                if lp_out is not None:
                    lp_out[0].append(float(lps[m, i]))
                    lp_out[1].append([{"token_id": int(top_is[m, i, j]),
                                       "logprob": float(top_vs[m, i, j])}
                                      for j in range(k)])
                r.tokens_all.append(token)
                inp = token
                finish = self._check_finish(r, token)
                if finish is not None:
                    break
            r.last_token = inp
            if finish is None and r.ctx.is_stopped:
                finish = FinishReason.CANCELLED
            self.tokens_generated_total += len(accepted)
            if self._recorder.enabled and accepted:
                self._recorder.add(
                    "engine.decode", r.ctx.trace_id, r.ctx.span_id,
                    w.t0, time.monotonic(),
                    attrs={"tokens": len(accepted), "window": w.size})
            self._emit(r, accepted, finish, lp_out)
            if finish is not None:
                self._finish_slot(i, register=True)

    def _process_spec_window(self, w: _Window, outs: np.ndarray,
                             emits: np.ndarray, ndrafts: np.ndarray) -> None:
        """Host walk of a speculative window (the reference's
        ``_process_spec_window``): step m of slot i emitted its first
        emits[m, i] tokens of outs[m, i] (0: the slot froze at its cap).
        The host appends them in order under the stop conditions,
        registers each page a token completes, and corrects its
        dispatch-time position, which assumed M tokens, by what the device
        emitted, in either direction."""
        page = self.config.page_size
        steps = outs.shape[0]
        for i, snap in enumerate(w.slots):
            if snap is None:
                continue
            r, epoch, start, cap = snap
            if self.slot_req[i] is not r or r.epoch != epoch:
                continue  # slot reassigned since dispatch
            if r.ctx.is_killed:
                r.push(None)
                self._finish_slot(i, register=True)
                continue
            accepted: list[int] = []
            finish = None
            inp = r.last_token
            pos = start
            for m in range(steps):
                e = int(emits[m, i])
                self.spec_emit_hist[e] += 1
                if e == 0:
                    if pos >= cap:
                        finish = FinishReason.LENGTH
                    break
                nd = int(ndrafts[m, i])
                if nd:
                    self.spec_drafts += 1
                    self.spec_tokens += nd
                    self.spec_accepted += e - 1
                for j in range(e):
                    token = int(outs[m, i, j])
                    r.generated += 1
                    # The fed token now has K/V in the pool: register the
                    # page it completes under its chained hash.
                    new_block = r.blocks.append(inp)
                    if new_block is not None:
                        self.allocator.register(
                            r.pages[len(r.blocks.tokens) // page - 1],
                            new_block)
                    accepted.append(token)
                    r.tokens_all.append(token)
                    inp = token
                    finish = self._check_finish(r, token)
                    if finish is not None:
                        break
                pos += e
                if finish is not None:
                    break
            r.last_token = inp
            if finish is None and r.ctx.is_stopped:
                finish = FinishReason.CANCELLED
            if finish is None:
                # Dispatch assumed min(M, cap - start) tokens; the device's
                # chain may also be ahead of a dispatch-time clamp, so the
                # correction goes both ways.
                delta = min(w.size, max(0, cap - start)) - (pos - start)
                self.disp_positions[i] -= delta
                self.disp_seq_lens[i] -= delta
            self.tokens_generated_total += len(accepted)
            if self._recorder.enabled and accepted:
                self._recorder.add(
                    "engine.decode", r.ctx.trace_id, r.ctx.span_id,
                    w.t0, time.monotonic(),
                    attrs={"tokens": len(accepted), "window": w.size,
                           "spec": True})
            self._emit(r, accepted, finish)
            if finish is not None:
                self._finish_slot(i, register=True)

    def _check_finish(self, r: _Request, token: int) -> FinishReason | None:
        sc = r.req.stop_conditions
        if r.generated >= (sc.max_tokens or 2**30):
            return FinishReason.LENGTH
        if sc.min_tokens and r.generated < sc.min_tokens:
            return None
        if not sc.ignore_eos and token in (r.req.eos_token_ids or []):
            return FinishReason.EOS
        if token in (sc.stop_token_ids or []):
            return FinishReason.STOP
        return None

    def _emit(self, r: _Request, tokens: list[int],
              finish: FinishReason | None = None,
              lp_out: tuple[list, list] | None = None) -> None:
        out = LLMEngineOutput(token_ids=tokens, finish_reason=finish)
        if lp_out is not None:
            out.log_probs, out.top_log_probs = lp_out
        r.push(out.to_wire())

    def _finish_slot(self, slot: int, register: bool) -> None:
        """Free ``slot``. ``register=False`` is the failure path: the
        pages' K/V is suspect, so their prefix-cache entries are dropped
        and no later request reuses them."""
        r = self.slot_req[slot]
        self.slot_req[slot] = None
        self.disp_positions[slot] = 0
        self.disp_seq_lens[slot] = 0
        self.adapter_ids[slot] = 0
        self.overrides.pop(slot, None)
        if r is None:
            return
        self._release_adapter(r)
        r.slot = -1
        r.epoch += 1
        if not register:
            self.allocator.unregister(r.pages)
        # Defer the release until every in-flight window (which may still
        # scatter through the old page table) completes.
        self._pending_release.append((self._dispatch_serial, r.pages))
        r.pages = []

    def _requeue_slot(self, slot: int) -> None:
        """Preempt: free this slot's pages (their prefix-cache entries stay,
        so the re-prefill mostly hits) and requeue the request with its
        accumulated tokens."""
        r = self.slot_req[slot]
        self._finish_slot(slot, register=True)
        if r is None:
            return
        if r.ctx.is_killed or r.ctx.is_stopped:
            r.push(LLMEngineOutput(
                token_ids=[],
                finish_reason=FinishReason.CANCELLED).to_wire())
            return
        self.preempt_count += 1
        r.wait_noted = False  # the next queue stint records its own wait
        log.warning("KV pool exhausted: preempting slot %d (request %s, "
                    "%d tokens so far) and requeueing", slot, r.ctx.id,
                    len(r.tokens_all))
        # An autonomous capacity decision (lock-only emit, no I/O). The
        # reference names a chaos injection as its cause when one drives
        # the pressure; the port has no chaos plane (ROADMAP item 18).
        journal.emit(EventKind.PREEMPT, cause=None,
                     trace_id=r.ctx.trace_id, request=r.ctx.id, slot=slot,
                     tokens=len(r.tokens_all),
                     free_pages=self.allocator.num_free)
        self._queue_put(r)

    # -- observability (engine thread) ----------------------------------------
    def _note_queue_wait(self, r: _Request) -> None:
        """Admission reached: observe how long the request waited (a
        requeued request keeps its first enqueue time, so this is its
        time to a slot)."""
        if r.wait_noted:
            return
        r.wait_noted = True
        now = time.monotonic()
        if self.phase is not None:
            self.phase.queue_wait.observe(now - r.enqueue_t)
        rec = self._recorder
        if rec.enabled:
            rec.add("engine.queue_wait", r.ctx.trace_id, r.ctx.span_id,
                    r.enqueue_t, now)

    def _note_dispatch_gap(self) -> None:
        """Before a window dispatch while decode slots are live: the gap
        since the previous dispatch (decode_stall_seconds), and the
        flight recorder's decode-stall trigger."""
        now = time.monotonic()
        if self._last_decode_dispatch is not None:
            gap = now - self._last_decode_dispatch
            self.decode_stall_max_s = max(self.decode_stall_max_s, gap)
            if self.m_decode_stall is not None:
                self.m_decode_stall.observe(gap)
            self._flight_stall_last = max(self._flight_stall_last, gap)
            if flight.stall_threshold_s and gap >= flight.stall_threshold_s:
                # A decode-stall spike: freeze the ring and write a
                # bundle (throttled by the cooldown).
                flight.trigger(f"decode_stall_{gap:.2f}s")
        self._last_decode_dispatch = now

    def _note_flight(self, w: _Window) -> None:
        """One flight-recorder row per processed decode window (the ring
        skips idle-stable windows itself), and the perf plane's roofline
        sample of the same window, recorded whether or not the ring is
        on. ``window_s`` is the reference's: dispatch to the end of the
        readback, which includes the wait behind the windows ahead of it
        in the pipeline."""
        now = time.monotonic()
        tokens_total = self.tokens_generated_total
        window_tokens = tokens_total - self._perf_tokens_last
        self._perf_tokens_last = tokens_total
        if w.t0 and w.toks is not None:
            self._perf.note_window(
                now - w.t0, window_tokens,
                sum(1 for snap in w.slots if snap is not None),
                w.size, self._step_floor_ms)
        fr = self._flight
        if not fr.enabled:
            return
        chunk_total = self.chunk_tokens_total
        accepted = fr.record(
            now, now - w.t0 if w.t0 else 0.0,
            sum(1 for r in self.slot_req if r is not None),
            self.num_waiting, self.allocator.num_free,
            chunk_total - self._flight_chunk_last,
            len(self._chunk_inflight), self.preempt_count,
            self.brownout_level,
            self._flight_stall_last, self.step_count,
            tokens_total - self._flight_tokens_last)
        if accepted:
            # A frozen ring (a bundle being written) rejects the row: the
            # deltas then land in the first row after it thaws.
            self._flight_chunk_last = chunk_total
            self._flight_stall_last = 0.0
            self._flight_tokens_last = tokens_total
