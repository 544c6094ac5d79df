"""Engine perf plane: the window-graph capture registry, roofline-attributed
window timing and device-memory telemetry (the counterpart of
``dynamo_tpu.engine.perf``, without JAX).

- ``CompileRegistry``: on the card the counterpart of an XLA compile is the
  capture of a window program (``runner.WindowProgram``) as a CUDA graph;
  its signature is the program key. Families: ``decode_window`` and
  ``spec_window`` for the captured programs (on the CPU, where nothing is
  captured, their first runs), and ``prefill``, ``extract`` and
  ``insert``, which have no program and are counted at the first use of
  each key, with 0 seconds. The families, field names and snapshot bodies
  are the reference's.
- **Unexpected re-captures**: the reference's rule. The same runner
  capturing the same key again after ``mark_ready()`` (the engine's
  warmup boundary) means its program cache was dropped on the serving
  path: it bumps ``perf_unexpected_recompiles_total{program}``, logs the
  reference's warning and emits a ``perf.recompile`` span with
  ``status="warn"``. Judged per runner, so two runners in one process do
  not flag each other's first captures; a new key after ``mark_ready`` is
  counted, never flagged (the warmup makes only the smallest bucket).
- **Cost**: XLA's ``cost_analysis`` has no counterpart here. Each family's
  ``cost`` is an analytic estimate the runner makes at the family's first
  window with live rows: bytes are the weight bytes times the steps plus
  the paged attention's bytes, flops are 2 x params x rows x steps plus
  the attention's, with ``"source": "analytic"``. ``DTPU_PERF_COST=off``
  turns it off, as in the reference.
- ``note_window``: the reference's arithmetic on plain floats, one sample
  per processed decode window (engine thread, no locks), from which the
  registry keeps EWMA step seconds, achieved tok/s and the fraction of the
  weight-read roofline those tokens reached.
- ``PerfMetricsUpdater``: the throttled exporter of the reference's
  ``dynamo_tpu_perf_*`` series (names, help texts and labels), with the
  device-memory gauges from ``runner.hbm_stats()``.
"""

from __future__ import annotations

import os
import threading
import time

from dynamo_tpu_torch.runtime.logging import (generate_span_id,
                                              generate_trace_id, get_logger)

log = get_logger("perf")

#: EWMA smoothing for the per-window series (0.2 = ~5-window memory).
_EWMA = 0.2


class _Program:
    """Plain per-family telemetry (engine-thread writers; snapshot readers
    tolerate torn reads)."""

    __slots__ = ("name", "compiles", "compile_seconds", "unexpected",
                 "sigs", "cost", "last_compile_ts")

    def __init__(self, name: str):
        self.name = name
        self.compiles = 0
        self.compile_seconds = 0.0
        self.unexpected = 0
        self.sigs: dict = {}      # signature key -> capture count
        self.cost: dict | None = None  # one-time analytic estimate
        self.last_compile_ts = 0.0


class CompileRegistry:
    """Process-wide capture registry + per-window perf accumulator."""

    def __init__(self):
        self._lock = threading.Lock()  # capture bookkeeping only (rare)
        self._programs: dict[str, _Program] = {}
        self.warmup_complete = False
        self.warmup_complete_ts = 0.0
        # Per-window series (single engine-thread writer, lock-free).
        self.windows_total = 0
        self.window_seconds_total = 0.0
        self.window_tokens_total = 0
        self.step_seconds = 0.0        # EWMA seconds per decode step
        self.achieved_tok_s = 0.0      # EWMA tokens/s over windows
        self.roofline_frac = 0.0       # EWMA achieved / weight-read roofline

    # -- captures ---------------------------------------------------------------
    def note_compile(self, program: str, key, seconds: float,
                     unexpected: bool | None = None) -> None:
        """One capture (or first use) of ``program`` under ``key``. The
        runner passes ``unexpected`` itself (a second capture of the same
        key by the same runner after ``mark_ready``); left None, the
        registry falls back to key-seen detection, as the reference's."""
        with self._lock:
            prog = self._programs.setdefault(program, _Program(program))
            seen = prog.sigs.get(key, 0)
            prog.sigs[key] = seen + 1
            prog.compiles += 1
            prog.compile_seconds += seconds
            prog.last_compile_ts = time.time()
            if unexpected is None:
                unexpected = key is not None and seen >= 1
            if unexpected:
                prog.unexpected += 1
        if unexpected:
            self._warn_recompile(program, key, seconds)

    def _warn_recompile(self, program: str, key, seconds: float) -> None:
        log.warning(
            "unexpected steady-state recompile: program %s key %r compiled "
            "again (%.3fs) — the jit cache for an already-served shape was "
            "invalidated (dtype/weak-type drift, donation mismatch, or a "
            "shape leak); decode pays XLA time on the hot path", program,
            key, seconds)
        from dynamo_tpu_torch.runtime import tracing
        rec = tracing.get_recorder()
        if rec.enabled:
            now = time.monotonic()
            rec.add("perf.recompile", generate_trace_id(),
                    generate_span_id(), now - seconds, now, status="warn",
                    attrs={"program": program, "key": repr(key),
                           "compile_s": round(seconds, 4)})

    def wants_cost(self, program: str) -> bool:
        """Claim ``program``'s one-time cost estimate: True once per
        family (the caller then calls ``set_cost``), never with
        ``DTPU_PERF_COST=off`` (the reference's other modes all mean the
        analytic estimate here)."""
        if os.environ.get("DTPU_PERF_COST", "").strip().lower() == "off":
            return False
        with self._lock:
            prog = self._programs.setdefault(program, _Program(program))
            if prog.cost is not None:
                return False
            prog.cost = {"pending": True}  # claim before the work
            return True

    def set_cost(self, program: str, flops: float,
                 bytes_accessed: float) -> None:
        with self._lock:
            self._programs[program].cost = {
                "flops": float(flops), "bytes_accessed": float(bytes_accessed),
                "source": "analytic"}

    def mark_ready(self) -> None:
        """Warmup boundary: a runner's second capture of a key after this
        is flagged."""
        self.warmup_complete = True
        self.warmup_complete_ts = time.time()

    # -- roofline-attributed window timing --------------------------------------
    def note_window(self, window_s: float, tokens: int, active: int,
                    steps: int, step_floor_ms: float) -> None:
        """One processed decode window (ENGINE THREAD: plain stores
        only). ``window_s`` is dispatch -> readback-complete time,
        ``tokens`` the tokens it emitted, ``active`` the dispatched slot
        rows, ``step_floor_ms`` the weight-read step floor
        (``ModelSpec.weight_read_step_ms``)."""
        if window_s <= 0 or steps <= 0:
            return
        self.windows_total += 1
        self.window_seconds_total += window_s
        self.window_tokens_total += tokens
        step_s = window_s / steps
        tok_s = tokens / window_s
        if self.windows_total == 1:
            self.step_seconds = step_s
            self.achieved_tok_s = tok_s
        else:
            self.step_seconds += _EWMA * (step_s - self.step_seconds)
            self.achieved_tok_s += _EWMA * (tok_s - self.achieved_tok_s)
        if active > 0 and step_floor_ms > 0:
            roofline_tok_s = active / (step_floor_ms / 1e3)
            frac = min(tok_s / roofline_tok_s, 1.0)
            if self.windows_total == 1:
                self.roofline_frac = frac
            else:
                self.roofline_frac += _EWMA * (frac - self.roofline_frac)

    # -- panes ------------------------------------------------------------------
    @property
    def compiles_total(self) -> int:
        return sum(p.compiles for p in self._programs.values())

    @property
    def unexpected_total(self) -> int:
        return sum(p.unexpected for p in self._programs.values())

    def snapshot(self) -> dict:
        """The /debug/perf "compiles" body."""
        with self._lock:
            programs = {
                name: {
                    "compiles": p.compiles,
                    "compile_seconds": round(p.compile_seconds, 4),
                    "signatures": len(p.sigs),
                    "unexpected_recompiles": p.unexpected,
                    "cost": p.cost,
                    "last_compile_ts": p.last_compile_ts,
                }
                for name, p in sorted(self._programs.items())
            }
        return {
            "programs": programs,
            "compiles_total": sum(v["compiles"] for v in programs.values()),
            "compile_seconds_total": round(
                sum(v["compile_seconds"] for v in programs.values()), 4),
            "unexpected_recompiles_total": sum(
                v["unexpected_recompiles"] for v in programs.values()),
            "warmup_complete": self.warmup_complete,
        }

    def window_snapshot(self) -> dict:
        """The /debug/perf "window" body (EWMA-smoothed live series)."""
        return {
            "windows_total": self.windows_total,
            "window_seconds_total": round(self.window_seconds_total, 4),
            "window_tokens_total": self.window_tokens_total,
            "step_seconds": self.step_seconds,
            "achieved_tok_per_s": round(self.achieved_tok_s, 2),
            "roofline_frac": round(self.roofline_frac, 4),
        }

    def reset(self) -> None:
        """Tests only: drop every program and window sample."""
        with self._lock:
            self._programs.clear()
        self.warmup_complete = False
        self.warmup_complete_ts = 0.0
        self.windows_total = 0
        self.window_seconds_total = 0.0
        self.window_tokens_total = 0
        self.step_seconds = 0.0
        self.achieved_tok_s = 0.0
        self.roofline_frac = 0.0


_REGISTRY = CompileRegistry()


def get_registry() -> CompileRegistry:
    return _REGISTRY


def process_perf_status() -> dict:
    """The /debug/perf body of a process without an engine (a frontend
    over remote workers, a bare status server): the registry is
    process-global, so it still answers."""
    reg = get_registry()
    return {"role": "process", "compiles": reg.snapshot(),
            "window": reg.window_snapshot(), "hbm": {}, "memory": {}}


class PerfMetricsUpdater:
    """dynamo_tpu_perf_* exporter: registry plain numbers -> the metrics
    registry, throttled so the engine thread does not take a metric lock
    per window. Counters export DELTAS, so a registry reset cannot make
    them go backwards. Series, help texts and labels are the
    reference's."""

    def __init__(self, registry, min_interval_s: float = 0.5):
        self.min_interval_s = min_interval_s
        self._next = 0.0
        self._last: dict[tuple, float] = {}
        self.c_compiles = registry.counter(
            "perf_compiles_total", "XLA compiles per jit program family",
            ["program"])
        self.c_compile_seconds = registry.counter(
            "perf_compile_seconds_total", "Wall-clock seconds spent in XLA "
            "compiles per jit program family", ["program"])
        self.c_unexpected = registry.counter(
            "perf_unexpected_recompiles_total", "Compiles of an "
            "already-seen (program, signature) after first use — the "
            "runtime twin of the jit-recompile-hazard lint rule; any "
            "nonzero rate in steady state is a serving-path bug",
            ["program"])
        self.g_step_seconds = registry.gauge(
            "perf_step_seconds", "EWMA seconds per decode step "
            "(window device time / window steps)")
        self.g_achieved = registry.gauge(
            "perf_achieved_tok_per_s", "EWMA decode tokens/s over "
            "dispatched windows (device-time attributed)")
        self.g_roofline = registry.gauge(
            "perf_roofline_frac", "EWMA fraction of the shard's "
            "weight-read roofline achieved by decode windows")
        self.g_hbm_in_use = registry.gauge(
            "perf_hbm_bytes_in_use", "device.memory_stats bytes_in_use "
            "on this worker's first addressable device")
        self.g_hbm_peak = registry.gauge(
            "perf_hbm_peak_bytes", "device.memory_stats "
            "peak_bytes_in_use on this worker's first addressable device")
        self.g_hbm_limit = registry.gauge(
            "perf_hbm_limit_bytes", "device.memory_stats bytes_limit on "
            "this worker's first addressable device")
        self.c_spec_draft_tokens = registry.counter(
            "perf_spec_draft_tokens_total", "Speculative draft tokens "
            "proposed by the on-device n-gram drafter")
        self.c_spec_accepted_tokens = registry.counter(
            "perf_spec_accepted_tokens_total", "Speculative draft tokens "
            "accepted by the fused verify (rejection-sampled for "
            "temperature > 0; exact-match under greedy)")
        self.c_spec_verify_steps = registry.counter(
            "perf_spec_verify_steps_total", "Speculative verify steps by "
            "tokens emitted — the per-window emitted-token histogram "
            "(emitted=1 means no draft accepted; emitted=spec_k+1 means "
            "the whole draft block landed; emitted=0 a frozen slot)",
            ["emitted"])
        self.g_spec_acceptance = registry.gauge(
            "perf_spec_acceptance_rate", "Lifetime accepted/proposed "
            "draft-token ratio of the speculative verify")
        self.c_spec_brownout = registry.counter(
            "perf_spec_brownout_windows_total", "Decode windows where "
            "brownout pressure suspended speculative drafting")
        for bound in (self.g_step_seconds, self.g_achieved, self.g_roofline,
                      self.g_hbm_in_use, self.g_hbm_peak, self.g_hbm_limit):
            bound.ensure()

    def _delta(self, bound, key: tuple, current: float, **labels) -> None:
        prev = self._last.get(key, 0.0)
        if current > prev:
            bound.inc(current - prev, **labels)
        self._last[key] = current

    def update(self, engine, force: bool = False) -> None:
        """``engine`` is a ``GPUEngine`` (``runner.hbm_stats`` and the spec
        counters). Throttled; safe from the engine thread."""
        now = time.monotonic()
        if not force and now < self._next:
            return
        self._next = now + self.min_interval_s
        reg = get_registry()
        with reg._lock:
            per_prog = [(p.name, p.compiles, p.compile_seconds, p.unexpected)
                        for p in reg._programs.values()]
        for name, compiles, seconds, unexpected in per_prog:
            self._delta(self.c_compiles, ("c", name), compiles, program=name)
            self._delta(self.c_compile_seconds, ("s", name), seconds,
                        program=name)
            self._delta(self.c_unexpected, ("u", name), unexpected,
                        program=name)
        self.g_step_seconds.set(reg.step_seconds)
        self.g_achieved.set(reg.achieved_tok_s)
        self.g_roofline.set(reg.roofline_frac)
        hbm = engine.runner.hbm_stats()
        if hbm:
            self.g_hbm_in_use.set(hbm["bytes_in_use"])
            self.g_hbm_peak.set(hbm["peak_bytes_in_use"])
            self.g_hbm_limit.set(hbm["bytes_limit"])
        if engine.spec_emit_hist:
            self._delta(self.c_spec_draft_tokens, ("spec_dt",),
                        engine.spec_tokens)
            self._delta(self.c_spec_accepted_tokens, ("spec_at",),
                        engine.spec_accepted)
            self._delta(self.c_spec_brownout, ("spec_bw",),
                        engine.spec_brownout_windows)
            for e, n in enumerate(engine.spec_emit_hist):
                self._delta(self.c_spec_verify_steps, ("spec_eh", e), n,
                            emitted=str(e))
            if engine.spec_tokens:
                self.g_spec_acceptance.set(
                    engine.spec_accepted / engine.spec_tokens)
