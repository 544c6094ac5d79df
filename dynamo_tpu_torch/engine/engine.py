"""GPUEngine: continuous batching over the torch ModelRunner (the core of
``dynamo_tpu.engine.engine.TPUEngine``).

The engine thread owns all device work. Each loop it admits waiting
requests (batched whole-prompt prefill onto PageAllocator pages; the
first token stays on the device and is read back asynchronously), then
decodes in M-step windows: one ``runner.decode_window`` enqueues M steps
for every slot with tokens chained on the device. Up to
``pipeline_depth`` windows are in flight; while the device runs them the
host processes the oldest window's tokens, emits them to the streams,
applies stop conditions and prepares the next page tables.

KV pressure: when the pool is exhausted mid-decode the engine preempts
the youngest slot, releases its pages and requeues the request to
re-prefill from its accumulated tokens.

Not ported yet (later slices): prefix reuse and history/chunked prefill
(so every prompt must fit one prefill bucket), penalties, logprobs, spec
decode, LoRA, KV tiers, disaggregation, metrics publishing.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import queue
import threading
import time
from typing import AsyncIterator

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.kv_cache import PageAllocator
from dynamo_tpu_torch.engine.runner import (
    PK_CAP, PK_OVERRIDE, PK_POS, PK_PREFIX, PK_SEED, PK_SEEDED, PK_SEQLEN,
    PK_TEMP, PK_TOKEN, PK_TOPK, PK_TOPP, ModelRunner, PrefillSeq, mask_seed)
from dynamo_tpu_torch.engine.sampler import MAX_TOPK
from dynamo_tpu_torch.llm.protocols import (FinishReason, LLMEngineOutput,
                                            PreprocessedRequest)
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("gpu_engine")


class _Readback:
    """A device result copied to pinned host memory without waiting.

    ``.cpu()`` would synchronise the whole stream, including windows
    dispatched after this one, and so drain the pipeline; the copy is
    instead queued behind the producing work and fenced by an event."""

    def __init__(self, tensor: torch.Tensor):
        if tensor.is_cuda:
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                     pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = tensor
            self._event = None

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


@dataclasses.dataclass
class _Request:
    req: PreprocessedRequest
    ctx: Context
    out_q: asyncio.Queue
    loop: asyncio.AbstractEventLoop
    tokens_all: list[int] = dataclasses.field(default_factory=list)
    pages: list[int] = dataclasses.field(default_factory=list)
    generated: int = 0
    slot: int = -1
    epoch: int = 0
    # None = first token still on device (async readback pending).
    last_token: int | None = -1
    enqueue_t: float = dataclasses.field(default_factory=time.monotonic)
    # Upper bound on total sequence length (prompt + max_tokens): dispatch
    # never allocates pages past it.
    len_cap: int = 2**30

    def push(self, item) -> None:
        self.loop.call_soon_threadsafe(self.out_q.put_nowait, item)


@dataclasses.dataclass
class _Window:
    toks: _Readback | None  # [M,B] tokens (None when no rows dispatched)
    slots: list             # per slot: (request, epoch, start_pos, cap) or None
    frozen: dict            # slot -> (request, epoch, "requeue" | "oom")
    size: int
    serial: int = 0         # dispatch order (deferred-release fencing)
    t0: float = 0.0         # dispatch time


class GPUEngine(AsyncEngine):
    def __init__(self, config: EngineConfig, params: dict | None = None,
                 seed: int = 0):
        self.config = config
        self.decode_window = config.resolve_decode_window()
        self.runner = ModelRunner(config, params=params, seed=seed)
        self.allocator = PageAllocator(self.runner.num_pages, config.page_size)
        b = config.max_num_seqs
        # Slot state (host view; tokens chain on the device between windows).
        self.slot_req: list[_Request | None] = [None] * b
        self.disp_positions = np.zeros(b, np.int64)
        self.disp_seq_lens = np.zeros(b, np.int64)
        self.temperature = np.zeros(b, np.float32)
        self.top_k = np.zeros(b, np.int32)
        self.top_p = np.ones(b, np.float32)
        self.seeds = np.zeros(b, np.int32)
        self.seeded = np.zeros(b, bool)
        self.overrides: dict[int, int] = {}  # slot -> first token next window
        self.waiting: queue.Queue[_Request] = queue.Queue()
        # Dispatched-but-unprocessed windows, oldest first.
        self._inflight: collections.deque[_Window] = collections.deque()
        self._dispatch_serial = 0
        # Prefill first tokens awaiting readback:
        # {"handle": _Readback, "rows": [(row, request, slot, epoch)]}.
        self._pending_first: list[dict] = []
        # Pages freed while windows that may still scatter to them are in
        # flight: (serial of the newest dispatched window, pages).
        self._pending_release: list[tuple[int, list[int]]] = []
        self._running = False
        self._thread: threading.Thread | None = None
        self.windows_dispatched = 0    # windows with device work
        self.preempt_count = 0
        # Dispatch -> tokens-on-host seconds of recent windows.
        self.window_seconds: collections.deque[float] = \
            collections.deque(maxlen=4096)

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._engine_loop,
                                        name="gpu-engine", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=30)
            self._thread = None

    # -- AsyncEngine ----------------------------------------------------------
    def _validate(self, req: PreprocessedRequest) -> None:
        cfg = self.config
        if not req.token_ids:
            raise ValueError("empty token_ids")
        if len(req.token_ids) >= cfg.max_model_len:
            raise ValueError(
                f"prompt length {len(req.token_ids)} exceeds max model len "
                f"{cfg.max_model_len}")
        if len(req.token_ids) > cfg.max_prompt_len:
            raise ValueError(
                f"prompt length {len(req.token_ids)} exceeds the longest "
                f"whole-prompt prefill ({cfg.max_prompt_len}); chunked "
                f"prefill is not ported yet")
        s = req.sampling_options
        unsupported = []
        if s.logprobs is not None:
            unsupported.append("logprobs")
        if s.frequency_penalty or s.presence_penalty:
            unsupported.append("frequency/presence penalties")
        if req.adapter:
            unsupported.append("LoRA adapters")
        if req.mm_embeds:
            unsupported.append("multimodal embeddings")
        if unsupported:
            raise ValueError("not ported yet: " + ", ".join(unsupported))
        if s.top_k and s.top_k > MAX_TOPK:
            log.warning("top_k=%d exceeds sampler cap %d; clamping",
                        s.top_k, MAX_TOPK)
            s.top_k = MAX_TOPK
        if s.seed is not None and not 0 <= s.seed <= 0x7FFFFFFF:
            log.warning("seed=%s outside the engine's 31-bit seed space; "
                        "using %d", s.seed, mask_seed(s.seed))

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
        self.waiting.put(r)
        while True:
            item = await r.out_q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
            if item.get("finish_reason"):
                return

    # -- engine loop ----------------------------------------------------------
    def _engine_loop(self) -> None:
        log.info("engine loop starting (slots=%d pages=%d window=%d)",
                 self.config.max_num_seqs, self.runner.num_pages,
                 self.decode_window)
        depth = max(1, self.config.pipeline_depth)
        while self._running:
            self._resolve_ready_first()
            try:
                admitted = self._admit()
            except Exception:  # noqa: BLE001 — keep serving
                log.exception("admission failed")
                admitted = False
            have_active = any(r is not None for r in self.slot_req)
            dispatched = False
            if have_active and len(self._inflight) < depth:
                try:
                    window = self._dispatch_window()
                except Exception as exc:  # noqa: BLE001 — fail all, keep serving
                    log.exception("decode window dispatch failed")
                    for i, r in enumerate(self.slot_req):
                        if r is not None:
                            r.push(RuntimeError(f"engine step failed: {exc}"))
                            self._finish_slot(i)
                else:
                    if window.toks is None:
                        self._do_process(window)
                    else:
                        self._inflight.append(window)
                        dispatched = True
            # Process the oldest window once the pipe is full (or drain it
            # when nothing new could be dispatched).
            if self._inflight and (len(self._inflight) >= depth
                                   or not dispatched):
                self._do_process(self._inflight.popleft())
            self._release_ready_pages()
            if self._inflight:
                continue
            if self._pending_first:
                self._resolve_ready_first(force=True)
            elif not admitted and not have_active:
                time.sleep(0.002)  # idle

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
        try:
            vals = entry["handle"].numpy()
        except Exception as exc:  # noqa: BLE001 — device fault at readback
            log.exception("first-token readback failed")
            for _, r, slot, epoch in entry["rows"]:
                if self.slot_req[slot] is r and r.epoch == epoch:
                    r.push(RuntimeError(f"prefill readback failed: {exc}"))
                    self._finish_slot(slot)
            return
        for row, r, slot, epoch in entry["rows"]:
            if self.slot_req[slot] is not r or r.epoch != epoch:
                continue  # slot reassigned (failure path already notified)
            tok = int(vals[row])
            r.generated += 1
            finish = self._check_finish(r, tok)
            self._emit(r, [tok], finish)
            r.last_token = tok
            r.tokens_all.append(tok)
            if finish is not None:
                self._finish_slot(slot)

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
                    self._finish_slot(i)

    # -- admission / prefill --------------------------------------------------
    def _admit(self) -> bool:
        cfg = self.config
        free_slots = [i for i, r in enumerate(self.slot_req) if r is None]
        staged: list[tuple[_Request, int, PrefillSeq]] = []
        while free_slots:
            try:
                r = self.waiting.get_nowait()
            except queue.Empty:
                break
            if r.ctx.is_killed or r.ctx.is_stopped:
                r.push(LLMEngineOutput(
                    token_ids=[],
                    finish_reason=FinishReason.CANCELLED).to_wire())
                continue
            try:
                plan = self._plan_prefill(r)
            except Exception as exc:  # noqa: BLE001
                log.exception("prefill planning failed")
                r.push(RuntimeError(f"prefill failed: {exc}"))
                continue
            if plan is None:
                # No KV room: put back and stop admitting.
                self.waiting.put(r)
                break
            staged.append((r, free_slots.pop(0), plan))
        if not staged:
            return False
        # Batch staged prompts while the padded batch stays within
        # max_prefill_tokens (the dense prefill's score tensor grows with
        # rows x bucket^2).
        groups: list[list] = []
        for item in staged:
            trial = (groups[-1] if groups else []) + [item]
            n_max = max(len(p.tokens) for _, _, p in trial)
            if groups and len(trial) * cfg.bucket_for(n_max) \
                    <= cfg.max_prefill_tokens:
                groups[-1] = trial
            else:
                groups.append([item])
        for group in groups:
            try:
                sampled = self.runner.prefill_batch(
                    [p for _, _, p in group],
                    slots=[s for _, s, _ in group])
            except Exception as exc:  # noqa: BLE001
                log.exception("batched prefill failed")
                for r, _, _ in group:
                    self.allocator.release(r.pages)
                    r.pages = []
                    r.push(RuntimeError(f"prefill failed: {exc}"))
                continue
            rows = []
            for row, (r, slot, _) in enumerate(group):
                self._place_in_slot_pending(r, slot)
                rows.append((row, r, slot, r.epoch))
            self._pending_first.append({"handle": _Readback(sampled),
                                        "rows": rows})
        return True

    def _plan_prefill(self, r: _Request) -> PrefillSeq | None:
        """Allocate the prompt's pages. Prefix reuse is off until history
        prefill is ported, so every prompt is prefilled whole."""
        cfg = self.config
        prompt = r.tokens_all
        if len(prompt) > cfg.max_prompt_len:
            # A preempted request whose tokens outgrew one prefill bucket.
            raise ValueError(f"{len(prompt)} tokens exceed the longest "
                             f"whole-prompt prefill ({cfg.max_prompt_len})")
        pages = self.allocator.allocate(-(-len(prompt) // cfg.page_size))
        if pages is None:
            return None
        r.pages = pages
        s = r.req.sampling_options
        return PrefillSeq(tokens=np.asarray(prompt, np.int32),
                          chunk_pages=np.asarray(pages, np.int32),
                          sampling=self._sampling_of(r), seed=s.seed)

    @staticmethod
    def _sampling_of(r: _Request) -> tuple[float, int, float]:
        s = r.req.sampling_options
        return (s.temperature or 0.0, s.top_k or 0, s.top_p or 1.0)

    def _place_in_slot_pending(self, r: _Request, slot: int) -> None:
        """Occupy a slot whose first token is still on the device (in
        runner.tokens_dev): decode windows chain from it with no override;
        the host value is emitted when the readback resolves."""
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
        seed = r.req.sampling_options.seed
        self.seeded[slot] = seed is not None
        self.seeds[slot] = 0 if seed is None else mask_seed(seed)
        self.overrides.pop(slot, None)

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
        live = [i for i, r in enumerate(self.slot_req) if r is not None]
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
                if (n_live == 1 and needed - len(r.pages)
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
            packed[i, PK_SEED] = self.seeds[i]
            packed[i, PK_SEEDED] = int(self.seeded[i])
            packed[i, PK_PREFIX:PK_PREFIX + len(r.pages)] = r.pages
            slots[i] = (r, r.epoch, start, cap)
            adv = min(M, max(0, cap - start))
            self.disp_positions[i] += adv
            self.disp_seq_lens[i] += adv
        t0 = time.monotonic()
        toks = self.runner.decode_window(packed, M)
        self.windows_dispatched += 1
        return _Window(toks=_Readback(toks), slots=slots, frozen=frozen,
                       size=M, serial=self._dispatch_serial, t0=t0)

    def _process_window(self, w: _Window) -> None:
        toks = None
        if w.toks is not None:
            toks = w.toks.numpy()
            self.window_seconds.append(time.monotonic() - w.t0)
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
                self._finish_slot(i)
            else:
                self._requeue_slot(i)
        if toks is None:
            return
        for i, snap in enumerate(w.slots):
            if snap is None:
                continue
            r, epoch, start, cap = snap
            if self.slot_req[i] is not r or r.epoch != epoch:
                continue  # slot reassigned since dispatch
            if r.ctx.is_killed:
                r.push(None)
                self._finish_slot(i)
                continue
            accepted: list[int] = []
            finish = None
            inp = r.last_token
            for m in range(w.size):
                if start + m >= cap:
                    # The slot reached its page capacity and froze.
                    finish = FinishReason.LENGTH
                    break
                token = int(toks[m, i])
                r.generated += 1
                accepted.append(token)
                r.tokens_all.append(token)
                inp = token
                finish = self._check_finish(r, token)
                if finish is not None:
                    break
            r.last_token = inp
            if finish is None and r.ctx.is_stopped:
                finish = FinishReason.CANCELLED
            self._emit(r, accepted, finish)
            if finish is not None:
                self._finish_slot(i)

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
              finish: FinishReason | None = None) -> None:
        r.push(LLMEngineOutput(token_ids=tokens,
                               finish_reason=finish).to_wire())

    def _finish_slot(self, slot: int) -> None:
        r = self.slot_req[slot]
        self.slot_req[slot] = None
        self.disp_positions[slot] = 0
        self.disp_seq_lens[slot] = 0
        self.overrides.pop(slot, None)
        if r is None:
            return
        r.slot = -1
        r.epoch += 1
        # Defer the release until every in-flight window (which may still
        # scatter through the old page table) completes.
        self._pending_release.append((self._dispatch_serial, r.pages))
        r.pages = []

    def _requeue_slot(self, slot: int) -> None:
        """Preempt: free this slot's pages and requeue the request with its
        accumulated tokens (it re-prefills them)."""
        r = self.slot_req[slot]
        self._finish_slot(slot)
        if r is None:
            return
        if r.ctx.is_killed or r.ctx.is_stopped:
            r.push(LLMEngineOutput(
                token_ids=[],
                finish_reason=FinishReason.CANCELLED).to_wire())
            return
        self.preempt_count += 1
        log.warning("KV pool exhausted: preempting slot %d (request %s, "
                    "%d tokens so far) and requeueing", slot, r.ctx.id,
                    len(r.tokens_all))
        self.waiting.put(r)
