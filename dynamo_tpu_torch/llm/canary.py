"""Synthetic canary prober: active verification of the serving path (copy
of ``dynamo_tpu.llm.canary`` over the port's ``ModelManager``).

Everything else in the observability stack is passive — a wedged worker
is discovered when USER traffic hits it. The canary closes that hole: a
low-rate background loop sends tiny known-answer greedy requests pinned
per worker (``direct`` routing, the same per-worker selection machinery
admin ops use), checks token-exact output and TTFT against bounds, and
feeds the breaker board — so a sick worker is ejected from selection
*before* user traffic reaches it, and (because ``direct`` bypasses
breaker filtering) keeps being probed while open, closing the breaker
the moment it recovers.

Known-answer: greedy decoding is deterministic, so the first successful
probe's tokens become the model's reference output; every later probe
must match token-exactly (a worker emitting different greedy tokens is
corrupt — wrong weights, bad KV reuse — not just slow).

Canaries are **admission-exempt and invisible to user-facing SLIs**:
they ride the request plane directly, below the HTTP ingress — no
AdaptiveLimiter permit, no SLO ``observe_*`` calls, no RequestLedger
record — so synthetic traffic can never page an operator about itself
or pollute per-tenant accounting.

Decision plane: every failed probe journals a ``canary_fail`` (chained
to the previous failure on the same worker), recovery journals a
``canary_ok`` chained to the failure streak, and the breaker transition
the canary causes carries the probe's ref as its explicit ``cause``.

Exports ``canary_probes_total{worker,outcome}`` and
``canary_ttft_seconds{worker}``. Knobs: ``DTPU_CANARY_<FIELD>`` env /
``--canary*`` frontend flags.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time

from dynamo_tpu_torch.runtime import journal
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.journal import EventKind
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("canary")

#: Probe outcomes (the canary_probes_total label vocabulary).
OUTCOMES = ("ok", "timeout", "error", "mismatch", "slow_ttft")


@dataclasses.dataclass
class CanaryConfig:
    """All plain scalars so the generic ``DTPU_CANARY_<FIELD>`` env
    override in runtime/config.py maps 1:1."""

    enabled: bool = False
    # Seconds between probe sweeps (every worker of every model is
    # probed once per sweep — keep this >> a probe's service time).
    interval_s: float = 15.0
    # The known-answer request: tiny and greedy.
    prompt: str = "The quick brown fox"
    max_tokens: int = 4
    # A first token slower than this fails the probe ("slow_ttft").
    ttft_bound_ms: float = 5000.0
    # Whole-probe deadline; a worker that answers nothing within it is
    # wedged ("timeout") — this is what catches the hung-but-leased
    # worker user traffic would otherwise discover.
    timeout_s: float = 10.0
    # Canary-gated join (autoscaling, docs/RESILIENCE.md
    # "Autoscaling"): a worker that joins holds its breaker on
    # PROBATION — no user traffic at all — until a probe chain passes;
    # the releasing canary_ok is caused by the worker_join event so
    # the admission is one walkable chain on /debug/timeline.
    gate_joins: bool = False
    # How many consecutive ok probes release a probation hold.
    gate_probes: int = 1


def apply_canary_env(cfg: CanaryConfig) -> CanaryConfig:
    """Overlay DTPU_CANARY_* env vars onto ``cfg`` (same mechanism as
    the planner's ReconfigConfig)."""
    from dynamo_tpu_torch.runtime.config import _apply_scalar_env
    _apply_scalar_env("CANARY", cfg)
    return cfg


class CanaryProber:
    """One frontend's canary loop over every served model's workers."""

    def __init__(self, manager, config: CanaryConfig | None = None,
                 metrics=None):
        self.manager = manager
        self.cfg = config or CanaryConfig()
        self._task: asyncio.Task | None = None
        # model -> reference greedy tokens (set by the first ok probe).
        self._expected: dict[str, list[int]] = {}
        # worker id -> consecutive failures / last fail ref / stats.
        self._fails: dict[int, int] = {}
        self._fail_refs: dict[int, str] = {}
        self._stats: dict[int, dict] = {}
        # Canary-gated joins: worker id -> {"join_ref", "ok_streak"}.
        # Membership means the worker's breaker is held on probation.
        self._probation: dict[int, dict] = {}
        self._gate_tasks: set[asyncio.Task] = set()
        self.sweeps = 0
        self._m_probes = self._m_ttft = None
        if metrics is not None:
            m = metrics.namespace("canary")
            self._m_probes = m.counter(
                "canary_probes_total",
                "Synthetic canary probes by worker and outcome",
                ["worker", "outcome"])
            self._m_ttft = m.gauge(
                "canary_ttft_seconds",
                "Latest canary probe TTFT per worker", ["worker"])

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._loop())
            log.info("canary prober armed (every %.1fs, %d tokens, "
                     "ttft bound %.0f ms)", self.cfg.interval_s,
                     self.cfg.max_tokens, self.cfg.ttft_bound_ms)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.cfg.interval_s)
            try:
                await self.sweep()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — probing must never die
                log.exception("canary sweep failed")

    # -- join gating (discovery hooks) ----------------------------------------
    def note_join(self, served, iid: int) -> None:
        """Discovery worker_join hook: with ``gate_joins`` on, hold the
        worker's breaker (probation — routers exclude it, half-open
        probes included) and probe it IMMEDIATELY instead of waiting
        out the sweep interval. The probe that passes releases the
        hold; until then no user request can reach the worker."""
        if not self.cfg.gate_joins or iid in self._probation:
            return
        join_ref = journal.recent_ref(EventKind.WORKER_JOIN)
        self._probation[iid] = {"join_ref": join_ref, "ok_streak": 0}
        served.client.breakers.hold(iid, cause=join_ref)
        log.info("canary: worker %x joined on probation; probing now", iid)
        task = asyncio.get_running_loop().create_task(
            self._gate_probe(served, iid))
        self._gate_tasks.add(task)
        task.add_done_callback(self._gate_tasks.discard)

    def note_leave(self, served, iid: int) -> None:
        """Discovery worker_leave hook: forget the worker's probe state
        (a rejoining worker starts a fresh probation, not an inherited
        failure streak)."""
        self._probation.pop(iid, None)
        self._fails.pop(iid, None)
        self._fail_refs.pop(iid, None)

    async def _gate_probe(self, served, iid: int) -> None:
        try:
            await self.probe(served, iid)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — the sweep loop retries
            log.exception("canary join probe failed")

    async def sweep(self) -> int:
        """Probe every worker of every remotely-served model once.
        Returns the number of probes issued."""
        probes = 0
        for name, served in list(self.manager.models.items()):
            if served.client is None:
                continue  # in-process pipeline: nothing to eject
            for iid in served.client.instance_ids():
                await self.probe(served, iid)
                probes += 1
        self.sweeps += 1
        return probes

    # -- one probe ------------------------------------------------------------
    def _build_request(self, served):
        from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
        tokenizer = served.preprocessor.tokenizer
        req = PreprocessedRequest(
            model=served.entry.model_name,
            token_ids=tokenizer.encode(self.cfg.prompt))
        req.stop_conditions.max_tokens = self.cfg.max_tokens
        # Exact-token determinism: the reference output must not depend
        # on where an eos happens to land.
        req.stop_conditions.ignore_eos = True
        req.sampling_options.temperature = 0.0
        return req

    async def probe(self, served, iid: int) -> str:
        """One pinned probe; returns the outcome. Pins with ``direct``
        routing, which deliberately bypasses breaker filtering — an
        ejected worker keeps being probed, and the probe that succeeds
        is what re-admits it."""
        cfg = self.cfg
        model = served.entry.model_name
        ctx = Context()
        t0 = time.monotonic()
        ttft: float | None = None
        tokens: list[int] = []

        async def consume() -> None:
            nonlocal ttft
            stream = await served.client.direct(
                self._build_request(served).to_wire(), iid, context=ctx)
            async for out in stream:
                if not isinstance(out, dict):
                    continue
                if out.get("token_ids"):
                    if ttft is None:
                        ttft = time.monotonic() - t0
                    tokens.extend(out["token_ids"])
                if out.get("finish_reason"):
                    break

        outcome = "ok"
        detail: dict = {}
        try:
            await asyncio.wait_for(consume(), cfg.timeout_s)
        except asyncio.TimeoutError:
            ctx.kill()  # free the worker-side slot if it ever wakes up
            outcome = "timeout"
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 — any failure is the signal
            outcome = "error"
            detail["error"] = f"{type(exc).__name__}: {exc}"
        else:
            expected = self._expected.get(model)
            if not tokens:
                outcome = "error"
                detail["error"] = "empty stream"
            elif expected is not None and tokens != expected:
                outcome = "mismatch"
                detail["expected"] = expected[:8]
                detail["got"] = tokens[:8]
            elif ttft is not None and ttft * 1000.0 > cfg.ttft_bound_ms:
                outcome = "slow_ttft"
                detail["ttft_ms"] = round(ttft * 1000.0, 1)
            else:
                self._expected.setdefault(model, tokens)
        self._note(served, iid, model, outcome, ttft, detail)
        return outcome

    def _note(self, served, iid: int, model: str, outcome: str,
              ttft: float | None, detail: dict) -> None:
        worker = f"{iid:x}"
        if self._m_probes is not None:
            self._m_probes.inc(worker=worker, outcome=outcome)
        if ttft is not None and self._m_ttft is not None:
            self._m_ttft.set(ttft, worker=worker)
        stat = self._stats.setdefault(iid, {"probes": 0, "ok": 0, "fail": 0})
        stat["probes"] += 1
        stat["last_outcome"] = outcome
        stat["last_ttft_s"] = ttft
        board = served.client.breakers
        if outcome == "ok":
            stat["ok"] += 1
            streak, ref = self._fails.pop(iid, 0), self._fail_refs.pop(
                iid, None)
            stat["consecutive_fails"] = 0
            ok_ref = None
            if streak:
                ok_ref = journal.emit(
                    EventKind.CANARY_OK, cause=ref, worker_id=worker,
                    model=model, recovered_after=streak)
                log.info("canary: worker %s recovered after %d failures",
                         worker, streak)
            gate = self._probation.get(iid)
            if gate is not None:
                gate["ok_streak"] += 1
                if gate["ok_streak"] < max(1, self.cfg.gate_probes):
                    return  # probation holds until the chain completes
                self._probation.pop(iid, None)
                if ok_ref is None:
                    # The admitting event: caused by the join that put
                    # the worker on probation — the last link of the
                    # scale-out chain on /debug/timeline.
                    ok_ref = journal.emit(
                        EventKind.CANARY_OK,
                        cause=ref or gate["join_ref"], worker_id=worker,
                        model=model, admitted=True,
                        probes=gate["ok_streak"])
                log.info("canary: worker %s passed join probation; "
                         "admitting", worker)
            # Only a recovering/held breaker gets the success signal:
            # steady canary TTFTs must not pollute the breaker's latency
            # EWMA (a tiny probe is far faster than real traffic).
            from dynamo_tpu_torch.runtime.overload import CLOSED
            if board.state(iid) != CLOSED:
                board.record_success(iid, ttft, cause=ok_ref)
            return
        stat["fail"] += 1
        self._fails[iid] = self._fails.get(iid, 0) + 1
        stat["consecutive_fails"] = self._fails[iid]
        ref = journal.emit(
            EventKind.CANARY_FAIL, cause=self._fail_refs.get(iid),
            worker_id=worker, model=model, outcome=outcome,
            consecutive=self._fails[iid], **detail)
        self._fail_refs[iid] = ref
        log.warning("canary: worker %s probe failed (%s, %d consecutive)",
                    worker, outcome, self._fails[iid])
        # The breaker transition this causes names the probe explicitly.
        board.record_failure(iid, cause=ref)

    # -- operator surface ------------------------------------------------------
    def status(self) -> dict:
        return {
            "enabled": True,
            "interval_s": self.cfg.interval_s,
            "gate_joins": self.cfg.gate_joins,
            "probation": sorted(f"{iid:x}" for iid in self._probation),
            "sweeps": self.sweeps,
            "workers": {f"{iid:x}": dict(stat)
                        for iid, stat in sorted(self._stats.items())},
        }
