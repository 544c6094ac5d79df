"""SLO plane: declarative targets, sliding-window SLIs, burn-rate alerts.

PR 1 built the observability *mechanics* (spans, phase histograms,
``/debug/traces``); this module answers the two questions a fleet
operator actually asks: "are we inside our SLOs right now, and how fast
are we burning error budget?" — and shapes the answer so the planner
and overload subsystems can consume it as a pressure signal.

Model (SRE-workbook style):

- A **target** names an SLI, a threshold, and an objective fraction,
  e.g. ``ttft``: 99% of requests reach their first token within
  ``ttft_p99_ms``. Each observed event is *good* or *bad* against the
  threshold; the SLI over a window is good/total.
- The **error budget** is ``1 - objective``. The **burn rate** over a
  window is ``bad_fraction / budget``: burn 1.0 spends exactly the
  budget over the SLO period; burn 14.4 exhausts 2% of a 30-day budget
  in one hour.
- **Multi-window alerts**: a ``fast`` page fires when BOTH the 5m and
  1h windows burn above ``fast_burn`` (default 14.4) — urgent and not
  a blip; a ``slow`` ticket fires when both the 6h and 3d windows burn
  above ``slow_burn`` (default 1.0) — slow leak that will exhaust the
  budget. Alerts clear when the short window of the pair recovers.

Determinism: the clock is injectable (``clock=``) and nothing sleeps —
the whole plane is driven by ``observe_*`` calls and evaluated lazily,
so tests walk a fake clock through hours in microseconds.

State is exported three ways: ``dynamo_tpu_slo_*`` gauges on the
metrics registry, the ``/debug/slo`` JSON payload (served by both the
frontend and the per-worker ``SystemStatusServer`` via
``runtime/health.py``), and ``pressure()`` — a compact level 0..3 the
planner/overload loops can poll without parsing alert structures.

Targets come from ``RuntimeConfig.slo`` (``[slo]`` TOML table,
``DTPU_SLO_*`` env). A threshold of 0 disables that target.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable

from dynamo_tpu_torch.runtime import journal
from dynamo_tpu_torch.runtime.journal import EventKind
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("slo")

# Burn-rate windows, seconds (SRE workbook multi-window pairs).
WINDOW_FAST_SHORT = 5 * 60
WINDOW_FAST_LONG = 60 * 60
WINDOW_SLOW_SHORT = 6 * 3600
WINDOW_SLOW_LONG = 3 * 24 * 3600
WINDOWS = {
    "5m": WINDOW_FAST_SHORT,
    "1h": WINDOW_FAST_LONG,
    "6h": WINDOW_SLOW_SHORT,
    "3d": WINDOW_SLOW_LONG,
}


@dataclasses.dataclass
class SloConfig:
    """Declarative SLO targets + alert tuning. All plain scalars so the
    generic DTPU_SLO_<FIELD> env override in runtime/config.py maps 1:1
    (0 disables the individual target)."""

    enabled: bool = True

    # -- targets --------------------------------------------------------------
    # 99% of requests must reach their first token within this budget.
    ttft_p99_ms: float = 0.0
    # 99% of inter-token gaps must stay under this budget.
    itl_p99_ms: float = 0.0
    # Availability: at most this fraction of requests may fail (5xx /
    # internal errors; typed sheds count against goodput, not errors).
    error_rate: float = 0.0
    # Goodput: at least this fraction of all arrivals must complete OK
    # (sheds and failures are both bad events here).
    goodput: float = 0.0

    # -- alert tuning ---------------------------------------------------------
    # Burn-rate thresholds for the fast (5m & 1h) page and the slow
    # (6h & 3d) ticket.
    fast_burn: float = 14.4
    slow_burn: float = 1.0
    # Sliding-window bucket width; also the lazy re-evaluation cadence.
    bucket_s: float = 10.0
    # Minimum events in the short window before an alert may fire: a
    # single bad request on an idle fleet is not a page.
    min_events: int = 10

    # -- per-request accounting (tentpole b; consumed by llm/recorder.py) -----
    # Bounded in-memory ring of accounting records (/debug/requests).
    request_ring: int = 1024
    # Optional JSONL sink for accounting records ("" = in-memory only).
    request_log_path: str = ""

    def targets(self) -> dict[str, tuple[float, float]]:
        """Configured targets: name -> (threshold, objective). Latency
        thresholds are in seconds; rate targets use threshold 0 (the
        good/bad call is made by the caller)."""
        out: dict[str, tuple[float, float]] = {}
        if self.ttft_p99_ms > 0:
            out["ttft"] = (self.ttft_p99_ms / 1e3, 0.99)
        if self.itl_p99_ms > 0:
            out["itl"] = (self.itl_p99_ms / 1e3, 0.99)
        if self.error_rate > 0:
            out["availability"] = (0.0, 1.0 - self.error_rate)
        if self.goodput > 0:
            out["goodput"] = (0.0, self.goodput)
        return out


class _WindowedRatio:
    """Good/total counts in time buckets; windowed sums for SLI/burn."""

    __slots__ = ("_bucket_s", "_horizon_s", "_buckets", "_clock")

    def __init__(self, bucket_s: float, horizon_s: float,
                 clock: Callable[[], float]):
        self._bucket_s = bucket_s
        self._horizon_s = horizon_s
        self._clock = clock
        # deque of [bucket_index, good, total], oldest first.
        self._buckets: collections.deque[list] = collections.deque()

    def observe(self, good: bool) -> None:
        idx = int(self._clock() / self._bucket_s)
        b = self._buckets[-1] if self._buckets else None
        if b is None or b[0] != idx:
            self._prune(idx)
            b = [idx, 0, 0]
            self._buckets.append(b)
        if good:
            b[1] += 1
        b[2] += 1

    def _prune(self, now_idx: int) -> None:
        keep = int(self._horizon_s / self._bucket_s) + 1
        while self._buckets and self._buckets[0][0] < now_idx - keep:
            self._buckets.popleft()

    def window(self, seconds: float) -> tuple[int, int]:
        """(good, total) over the trailing ``seconds``."""
        lo = int((self._clock() - seconds) / self._bucket_s)
        good = total = 0
        for idx, g, t in reversed(self._buckets):
            if idx <= lo:
                break
            good += g
            total += t
        return good, total


@dataclasses.dataclass
class SloPressure:
    """Compact pressure signal for the planner/overload loops.

    level 0 = inside budget everywhere; 1 = some target burning faster
    than sustainable (burn > slow_burn on the fast-short window); 2 = a
    fast page is firing on one target; 3 = pages on several targets (or
    availability paging) — degrade hard / add capacity NOW.
    """

    level: int
    worst_burn: float
    failing: tuple[str, ...]

    def to_wire(self) -> dict:
        return {"level": self.level, "worst_burn": round(self.worst_burn, 3),
                "failing": list(self.failing)}


class SloPlane:
    """Sliding-window SLI computation + multi-window burn-rate alerts
    for the configured targets. Thread-safe: observations come from the
    event loop and (potentially) engine threads."""

    def __init__(self, config: SloConfig | None = None, metrics=None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = config or SloConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self.targets = self.cfg.targets() if self.cfg.enabled else {}
        self._series = {
            name: _WindowedRatio(self.cfg.bucket_s, WINDOW_SLOW_LONG, clock)
            for name in self.targets}
        # target -> {"fast": bool, "slow": bool}
        self.alerts: dict[str, dict[str, bool]] = {
            name: {"fast": False, "slow": False} for name in self.targets}
        self.pages_total = 0  # fast-page rising edges (observability)
        # (target, severity) -> journal ref of the firing event, so the
        # clear names its own fire as the cause.
        self._alert_refs: dict[tuple[str, str], str] = {}
        self._last_eval = -1e18
        self._callbacks: list[Callable[[str, str], None]] = []
        self._m_sli = self._m_burn = self._m_alert = None
        if metrics is not None:
            m = metrics.namespace("slo")
            self._m_sli = m.gauge(
                "slo_sli", "Windowed SLI (good/total) per objective",
                ["objective", "window"])
            self._m_burn = m.gauge(
                "slo_burn_rate",
                "Error-budget burn rate per objective and window",
                ["objective", "window"])
            self._m_alert = m.gauge(
                "slo_alert_active",
                "1 while a burn-rate alert fires (severity=fast|slow)",
                ["objective", "severity"])
            for name in self.targets:
                for w in WINDOWS:
                    self._m_sli.ensure(objective=name, window=w)
                    self._m_burn.ensure(objective=name, window=w)
                for sev in ("fast", "slow"):
                    self._m_alert.ensure(objective=name, severity=sev)

    @property
    def enabled(self) -> bool:
        return bool(self.targets)

    def on_page(self, callback: Callable[[str, str], None]) -> None:
        """Register ``callback(target, severity)`` for alert rising
        edges — the flight recorder hooks this to freeze its ring."""
        self._callbacks.append(callback)

    # -- observations ---------------------------------------------------------
    def observe_ttft(self, seconds: float) -> None:
        self._observe_latency("ttft", seconds)

    def observe_itl(self, seconds: float) -> None:
        self._observe_latency("itl", seconds)

    def _observe_latency(self, name: str, seconds: float) -> None:
        series = self._series.get(name)
        if series is None:
            return
        threshold, _ = self.targets[name]
        with self._lock:
            series.observe(seconds <= threshold)
        self._maybe_evaluate()

    def observe_request(self, ok: bool, shed: bool = False) -> None:
        """One finished arrival. ``ok`` = completed successfully;
        ``shed`` = typed 429/503 rejection (bad for goodput, NOT an
        availability error — shedding is the defense working)."""
        with self._lock:
            avail = self._series.get("availability")
            if avail is not None:
                avail.observe(ok or shed)
            goodput = self._series.get("goodput")
            if goodput is not None:
                goodput.observe(ok)
        self._maybe_evaluate()

    # -- evaluation -----------------------------------------------------------
    def _maybe_evaluate(self) -> None:
        now = self._clock()
        if now - self._last_eval >= self.cfg.bucket_s:
            self.evaluate()

    def burn_rate(self, name: str, window_s: float) -> tuple[float, int]:
        """(burn, events) for one target over one window."""
        _, objective = self.targets[name]
        budget = max(1e-9, 1.0 - objective)
        good, total = self._series[name].window(window_s)
        if total == 0:
            return 0.0, 0
        return ((total - good) / total) / budget, total

    def evaluate(self) -> dict[str, dict[str, bool]]:
        """Recompute burn rates, update alert states + gauges, and fire
        page callbacks on rising edges. Returns the alert map."""
        self._last_eval = self._clock()
        cfg = self.cfg
        with self._lock:
            for name in self.targets:
                burns = {w: self.burn_rate(name, s)
                         for w, s in WINDOWS.items()}
                state = self.alerts[name]
                pairs = (("fast", "5m", "1h", cfg.fast_burn),
                         ("slow", "6h", "3d", cfg.slow_burn))
                for sev, short, long_, threshold in pairs:
                    b_short, n_short = burns[short]
                    b_long, _ = burns[long_]
                    if state[sev]:
                        # Clear when the short window recovers.
                        if b_short < threshold:
                            state[sev] = False
                            log.info("SLO %s %s-burn alert cleared", name,
                                     sev)
                            journal.emit(
                                EventKind.SLO_ALERT_CLEAR,
                                cause=self._alert_refs.pop((name, sev),
                                                           None),
                                objective=name, severity=sev,
                                burn_short=round(b_short, 3))
                    elif (b_short > threshold and b_long > threshold
                          and n_short >= cfg.min_events):
                        state[sev] = True
                        if sev == "fast":
                            self.pages_total += 1
                        log.warning(
                            "SLO %s %s-burn alert FIRING: burn %s=%.1f "
                            "%s=%.1f (threshold %.1f)", name, sev, short,
                            b_short, long_, b_long, threshold)
                        # Cause: the most recent defensive action on
                        # this process — the burn usually IS what the
                        # sheds/breakers/preempts were reacting to.
                        self._alert_refs[(name, sev)] = journal.emit(
                            EventKind.SLO_ALERT_FIRE,
                            cause=journal.recent_ref(
                                EventKind.SHED,
                                EventKind.BREAKER_TRANSITION,
                                EventKind.PREEMPT,
                                EventKind.BROWNOUT_CHANGE),
                            objective=name, severity=sev,
                            burn_short=round(b_short, 3),
                            burn_long=round(b_long, 3),
                            threshold=threshold, events=n_short)
                        for cb in list(self._callbacks):
                            try:
                                cb(name, sev)
                            except Exception:  # noqa: BLE001 — observers only
                                log.exception("SLO page callback failed")
                if self._m_burn is not None:
                    for w, (b, _) in burns.items():
                        self._m_burn.set(b, objective=name, window=w)
                        good, total = self._series[name].window(WINDOWS[w])
                        self._m_sli.set(good / total if total else 1.0,
                                        objective=name, window=w)
                    for sev in ("fast", "slow"):
                        self._m_alert.set(1.0 if state[sev] else 0.0,
                                          objective=name, severity=sev)
        return self.alerts

    def pressure(self) -> SloPressure:
        """Compact 0..3 signal (see SloPressure) for planner/overload."""
        self.evaluate()
        worst = 0.0
        failing: list[str] = []
        paging: list[str] = []
        for name in self.targets:
            burn, _ = self.burn_rate(name, WINDOW_FAST_SHORT)
            worst = max(worst, burn)
            if self.alerts[name]["fast"]:
                paging.append(name)
            elif burn > self.cfg.slow_burn or self.alerts[name]["slow"]:
                failing.append(name)
        if len(paging) >= 2 or "availability" in paging:
            level = 3
        elif paging:
            level = 2
        elif failing:
            level = 1
        else:
            level = 0
        return SloPressure(level, worst, tuple(paging + failing))

    # -- /debug/slo payload ---------------------------------------------------
    def snapshot(self) -> dict:
        self.evaluate()
        targets = {}
        for name, (threshold, objective) in self.targets.items():
            windows = {}
            for w, s in WINDOWS.items():
                good, total = self._series[name].window(s)
                burn, _ = self.burn_rate(name, s)
                windows[w] = {
                    "sli": round(good / total, 6) if total else None,
                    "events": total,
                    "burn": round(burn, 3),
                }
            targets[name] = {
                "threshold_s": threshold if threshold else None,
                "objective": objective,
                "windows": windows,
                "alerts": dict(self.alerts[name]),
            }
        return {
            "enabled": self.enabled,
            "fast_burn_threshold": self.cfg.fast_burn,
            "slow_burn_threshold": self.cfg.slow_burn,
            "pages_total": self.pages_total,
            "targets": targets,
            "pressure": self.pressure().to_wire(),
        }


# -- process-global plane ------------------------------------------------------
#
# Like tracing's module-global recorder: the debug routes (runtime/
# health.py) and the HTTP frontend feed/serve one process-wide plane.
# ``configure()`` is called by the entrypoints (frontend, launcher,
# worker) once the RuntimeConfig is known; before that the default
# plane has no targets and every observe is a cheap no-op.

_PLANE = SloPlane(SloConfig())


def configure(config: SloConfig, metrics=None,
              clock: Callable[[], float] = time.monotonic) -> SloPlane:
    global _PLANE
    _PLANE = SloPlane(config, metrics=metrics, clock=clock)
    if _PLANE.enabled:
        log.info("SLO plane armed: %s",
                 ", ".join(sorted(_PLANE.targets)))
    return _PLANE


def get_plane() -> SloPlane:
    return _PLANE
