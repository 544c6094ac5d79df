"""Engine flight recorder: a fixed-slot ring of per-window engine state,
frozen into a diagnostic bundle when an anomaly fires (copy of
``dynamo_tpu.runtime.flight``).

The engine records one compact row per processed decode window into
preallocated numpy columns: no Python object is created or kept on the
steady path, and idle-stable windows (nothing active, nothing changed)
are skipped. A decode-stall spike (the engine consults
``stall_threshold_s``) or a manual ``POST /debug/flight`` calls
``trigger(reason)`` or ``capture_bundle``: the ring freezes and a
background thread writes one JSON bundle (flight ring, recent spans, a
``/metrics`` snapshot, the journal's recent slice and the config
fingerprint) under ``bundle_dir``. Captures are throttled by
``cooldown_s``. A fast-burn SLO page (``on_slo_page``, registered on the
SLO plane) triggers one too.

Env knobs (read once at import; ``configure()`` overrides):
``DTPU_FLIGHT_CAPACITY`` (ring slots, default 512, 0 disables),
``DTPU_FLIGHT_DIR`` (bundle directory, default ``dtpu-flight`` under
the process's temporary directory, ``TMPDIR``),
``DTPU_FLIGHT_STALL_S`` (decode-stall trigger, default 2.0, 0 disables),
``DTPU_FLIGHT_COOLDOWN_S`` (default 300).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time

import numpy as np

from dynamo_tpu_torch.runtime import journal as journal_mod
from dynamo_tpu_torch.runtime.journal import EventKind
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("flight")

# Ring columns, in record() argument order. "tokens" (decode tokens
# emitted by the window) rides with "dur_s" (dispatch -> readback device
# time) so the perf plane's roofline attribution is replayable from a
# frozen ring, not only from live gauges.
FIELDS = ("t_mono", "dur_s", "active", "waiting", "free_pages",
          "chunk_tokens", "chunks_inflight", "preempts", "brownout",
          "stall_s", "step", "tokens")


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return default if raw in (None, "") else int(raw)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    return default if raw in (None, "") else float(raw)


class FlightRecorder:
    """Fixed-slot ring of per-window records (preallocated numpy
    columns; single engine-thread writer, any-thread readers)."""

    def __init__(self, capacity: int = 512, enabled: bool = True):
        self.capacity = max(1, capacity)
        self.enabled = enabled and capacity > 0
        self._cols = {name: np.zeros(self.capacity, np.float64)
                      for name in FIELDS}
        self._idx = 0
        self._count = 0
        # Preallocated cell, not a Python int: the idle-stable skip
        # path must retain no fresh objects.
        self._skipped = np.zeros(1, np.int64)
        self.frozen = False
        self.frozen_reason = ""
        self._was_idle = False
        # Guards freeze/dump vs. the writer; record() holds it only for
        # the column stores (sub-microsecond, no allocation).
        self._lock = threading.Lock()

    def record(self, t_mono: float, dur_s: float, active: int, waiting: int,
               free_pages: int, chunk_tokens: int, chunks_inflight: int,
               preempts: int, brownout: int, stall_s: float,
               step: int, tokens: int = 0) -> bool:
        """One engine-window row. Idle-stable windows (no active slots,
        no waiters, no chunk work — same as the previous call) are
        skipped without touching the ring. Returns False when the row
        was REJECTED (disabled / frozen mid-capture) so the caller
        keeps accumulating its deltas instead of losing them."""
        if not self.enabled or self.frozen:
            return False
        idle = active == 0 and waiting == 0 and chunks_inflight == 0 \
            and chunk_tokens == 0
        if idle and self._was_idle:
            self._skipped[0] += 1
            return True
        self._was_idle = idle
        with self._lock:
            i = self._idx
            cols = self._cols
            cols["t_mono"][i] = t_mono
            cols["dur_s"][i] = dur_s
            cols["active"][i] = active
            cols["waiting"][i] = waiting
            cols["free_pages"][i] = free_pages
            cols["chunk_tokens"][i] = chunk_tokens
            cols["chunks_inflight"][i] = chunks_inflight
            cols["preempts"][i] = preempts
            cols["brownout"][i] = brownout
            cols["stall_s"][i] = stall_s
            cols["step"][i] = step
            cols["tokens"][i] = tokens
            self._idx = (i + 1) % self.capacity
            if self._count < self.capacity:
                self._count += 1
        return True

    # -- freeze / dump --------------------------------------------------------
    def freeze(self, reason: str) -> bool:
        """Stop overwriting (first freeze wins). Returns True when this
        call did the freezing."""
        with self._lock:
            if self.frozen:
                return False
            self.frozen = True
            self.frozen_reason = reason
            return True

    def thaw(self) -> None:
        with self._lock:
            self.frozen = False
            self.frozen_reason = ""

    def clear(self) -> None:
        """Drop all recorded windows (tests, operator reset)."""
        with self._lock:
            self._idx = 0
            self._count = 0
            self._skipped[0] = 0
            self._was_idle = False

    def dump(self) -> list[dict]:
        """Ring contents oldest-first as dicts (the /debug/flight and
        bundle payload)."""
        with self._lock:
            n = self._count
            start = (self._idx - n) % self.capacity
            order = [(start + k) % self.capacity for k in range(n)]
            rows = []
            for i in order:
                row = {name: float(col[i])
                       for name, col in self._cols.items()}
                for name in ("active", "waiting", "free_pages",
                             "chunk_tokens", "chunks_inflight", "preempts",
                             "brownout", "step", "tokens"):
                    row[name] = int(row[name])
                rows.append(row)
            return rows

    @property
    def skipped_idle(self) -> int:
        return int(self._skipped[0])

    def meta(self) -> dict:
        return {"enabled": self.enabled, "capacity": self.capacity,
                "records": self._count, "skipped_idle": self.skipped_idle,
                "frozen": self.frozen, "frozen_reason": self.frozen_reason}


# -- process-global recorder + anomaly capture ---------------------------------

_RECORDER = FlightRecorder(
    capacity=_env_int("DTPU_FLIGHT_CAPACITY", 512))

#: Decode-stall trigger threshold consulted by the engine loop (0
#: disables the automatic trigger; the manual POST /debug/flight and
#: SLO-page triggers are independent of it).
stall_threshold_s = _env_float("DTPU_FLIGHT_STALL_S", 2.0)

_bundle_dir = os.environ.get(
    "DTPU_FLIGHT_DIR", os.path.join(tempfile.gettempdir(), "dtpu-flight"))
_cooldown_s = _env_float("DTPU_FLIGHT_COOLDOWN_S", 300.0)
_last_trigger_t = -1e18
_trigger_lock = threading.Lock()
_metrics_registry = None
_config_fingerprint: dict = {}
triggers_total = 0


def get_recorder() -> FlightRecorder:
    return _RECORDER


def configure(metrics=None, config_fingerprint: dict | None = None,
              bundle_dir: str | None = None,
              stall_s: float | None = None,
              cooldown_s: float | None = None) -> None:
    """Entrypoint wiring: the metrics registry + config identity that
    go into bundles, and optional knob overrides."""
    global _metrics_registry, _config_fingerprint, _bundle_dir
    global stall_threshold_s, _cooldown_s
    if metrics is not None:
        _metrics_registry = metrics
    if config_fingerprint is not None:
        _config_fingerprint = config_fingerprint
    if bundle_dir is not None:
        _bundle_dir = bundle_dir
    if stall_s is not None:
        stall_threshold_s = stall_s
    if cooldown_s is not None:
        _cooldown_s = cooldown_s


def _fingerprint_payload() -> dict:
    body = json.dumps(_config_fingerprint, sort_keys=True, default=str)
    return {"config": _config_fingerprint,
            "sha256": hashlib.sha256(body.encode()).hexdigest()}


def capture_bundle(reason: str, out_dir: str | None = None) -> str:
    """Write one diagnostic bundle NOW (blocking; call off the loop).
    Returns the bundle path."""
    from dynamo_tpu_torch.runtime import tracing

    out_dir = out_dir or _bundle_dir
    os.makedirs(out_dir, exist_ok=True)
    rec = _RECORDER
    ts = time.time()
    safe_reason = "".join(c if c.isalnum() or c in "-_" else "_"
                          for c in reason)[:64]
    path = os.path.join(out_dir, f"flight-{int(ts)}-{safe_reason}.json")
    span_rec = tracing.get_recorder()
    bundle = {
        "reason": reason,
        "ts": ts,
        "flight": {"meta": rec.meta(), "windows": rec.dump()},
        "spans": span_rec.export_chrome(),
        "metrics": (_metrics_registry.expose().decode()
                    if _metrics_registry is not None else None),
        # The recent decision-plane slice: one bundle is a complete
        # incident artifact — what the engine was doing (flight ring),
        # what requests were doing (spans), and WHY the fleet acted
        # (journal), side by side.
        "journal": journal_mod.get_journal().snapshot(limit=256),
        "config_fingerprint": _fingerprint_payload(),
    }
    with open(path, "w") as fh:
        json.dump(bundle, fh)
    log.warning("flight bundle written: %s (%d windows, reason=%s)",
                path, len(bundle["flight"]["windows"]), reason)
    return path


def trigger(reason: str, clock=time.monotonic) -> bool:
    """Anomaly hook (SLO page, decode-stall spike): freeze the ring and
    write a bundle on a background thread. Throttled by the cooldown;
    returns True when a capture was actually started."""
    global _last_trigger_t, triggers_total
    with _trigger_lock:
        now = clock()
        if now - _last_trigger_t < _cooldown_s:
            return False
        _last_trigger_t = now
        triggers_total += 1
    _RECORDER.freeze(reason)
    # Decision plane: an anomaly capture is itself a fleet decision.
    # Cause: the SLO page that pulled the trigger, else (decode-stall
    # path) the chaos injection that froze the engine, when either is
    # on the recent record.
    journal_mod.emit(
        EventKind.FLIGHT_BUNDLE,
        cause=(journal_mod.recent_ref(EventKind.SLO_ALERT_FIRE)
               if reason.startswith("slo_burn")
               else journal_mod.recent_ref(EventKind.CHAOS_INJECT)),
        reason=reason)

    def _write() -> None:
        try:
            capture_bundle(reason)
        except Exception:  # noqa: BLE001 — diagnostics must never crash serving
            log.exception("flight bundle capture failed")
        finally:
            _RECORDER.thaw()

    threading.Thread(target=_write, name="flight-bundle",
                     daemon=True).start()
    return True


def on_slo_page(target: str, severity: str) -> None:
    """SloPlane.on_page adapter: page-severity alerts freeze + capture
    (the worker and the fronts register it on the SLO plane)."""
    if severity == "fast":
        trigger(f"slo_burn_{target}")
