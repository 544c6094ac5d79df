"""SLA admission, engine brownout and the brownout spec fallback of
``GPUEngine`` against ``TPUEngine``, on the CPU at tiny-test.

The admission decisions run on the engine's own methods, driven from the
test thread with the prefill rate pinned (``prefill_rate_tok_s`` set and
its EWMA sample turned off on both engines), so the two engines pass the
same quiescent points:

- the cold-token ledger (waiting and in flight) and ``estimated_ttft_ms``
  after each submission, each admission pass and each first-token
  resolution: equal, exactly (integers, and the same float formula);
- which submissions ``_maybe_reject`` refuses, with the reference's
  message: equal;
- the head-of-line deferral: the same requests admitted in the same
  order, the same deferred head and the same ``admission_deferred``;
- ``_update_brownout``'s level for the same projections: equal.

The spec fallback: a spec-decode engine driven across spec -> plain ->
spec windows (its brownout level scripted by window count) gives greedy
tokens equal to a plain engine's on the same prompts, under the near-tie
rule of ``test_torch_spec_decode.py`` (equal, or a first split at a
verified bf16 near-tie of the dense teacher-forced logits). Without the
repair (the drain at a switch of the window kind, and the history and
position rewritten from the host before the first spec window after
plain ones) the tokens split at clear margins.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch
from conftest import async_test
from test_torch_spec_decode import (ENGINE_KW, SPEC_J, SPEC_KW, SPEC_T,
                                    assert_greedy_equivalent, collect,
                                    params_of, random_prompt,
                                    repetitive_prompt)

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import engine as jeng_mod
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.runtime.context import Context as JContext
from dynamo_tpu.runtime.errors import OverloadedError as JOverloaded
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import engine as teng_mod
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.errors import OverloadedError

torch.set_num_threads(1)

RATE = 2000.0  # pinned prefill rate, tok/s
BUDGET_MS = 100.0
# Slots for every request of the deferral script; pages for all of them.
ADMIT_KW = dict(ENGINE_KW, max_num_seqs=8, num_pages=256,
                max_pages_per_seq=32, prefill_buckets=(32, 64, 128, 256),
                max_prefill_tokens=512)


@pytest.fixture(scope="module")
def weights():
    jparams = jmodel.init_params(SPEC_J, jax.random.key(5))
    return jparams, params_of(jparams)


class Side:
    """One package's engine with the rate pinned, and its request
    factory."""

    def __init__(self, pkg, weights, **kw):
        self.pkg = pkg
        if pkg == "jax":
            self.mod, self.Req, self.Ctx = jeng_mod, JRequest, JContext
            self.engine = jeng_mod.TPUEngine(
                jcfg.EngineConfig(model=SPEC_J, attention_backend="xla",
                                  **kw), params=weights[0])
        else:
            self.mod, self.Req, self.Ctx = teng_mod, PreprocessedRequest, \
                Context
            self.engine = teng_mod.GPUEngine(
                tcfg.EngineConfig(model=SPEC_T, device="cpu", **kw),
                params=weights[1])
        self.engine.prefill_rate_tok_s = RATE
        self.engine._prefill_rate_sample = lambda tokens, elapsed: None
        self.requests = []

    def request(self, n: int, seed: int):
        ids = np.random.default_rng(seed).integers(
            1, SPEC_T.vocab_size, size=n).tolist()
        req = self.Req(model="tiny-test", token_ids=ids)
        req.stop_conditions.max_tokens = 4
        r = self.mod._Request(req=req, ctx=self.Ctx(),
                              out_q=asyncio.Queue(),
                              loop=asyncio.get_running_loop(),
                              tokens_all=list(ids), len_cap=n + 4)
        self.requests.append(r)
        return r

    def ledger(self):
        e = self.engine
        return (e._cold_inflight, e._waiting_cold, e.estimated_ttft_ms(),
                e.admission_deferred,
                None if e._deferred_head is None
                else self.requests.index(e._deferred_head),
                sorted(self.requests.index(r) for r in e.slot_req
                       if r is not None))


async def _admission_trace(side, script):
    trace = []
    for op in script:
        if op[0] == "submit":
            n, seed = op[1], op[2]
            try:
                side.engine._maybe_reject(n)
            except (OverloadedError, JOverloaded) as exc:
                trace.append(("rejected", n, str(exc)))
                continue
            side.engine._queue_put(side.request(n, seed))
        elif op[0] == "admit":
            side.engine._admit()
        elif op[0] == "resolve":
            side.engine._resolve_ready_first(force=True)
        elif op[0] == "inflight":
            side.engine._cold_inflight += op[1]
        trace.append((op, side.ledger()))
    return trace


ADMISSION_SCRIPTS = {
    # Submissions against a backlog: the projection rejects past
    # budget x factor, not before; an idle engine never rejects.
    "reject": (dict(ttft_budget_ms=BUDGET_MS, admission_reject_factor=2.0),
               [("submit", 300, 1), ("submit", 40, 2), ("submit", 200, 3),
                ("inflight", 100), ("submit", 30, 4), ("submit", 160, 5),
                ("admit",), ("submit", 90, 6), ("resolve",),
                ("submit", 90, 7), ("inflight", -100), ("admit",),
                ("resolve",)]),
    # Head-of-line deferral: the head that would push the in-flight
    # projection past the budget waits at the head (FIFO), and admits
    # once the backlog resolves.
    "defer": (dict(ttft_budget_ms=BUDGET_MS),
              [("submit", 150, 1), ("submit", 40, 2), ("submit", 60, 3),
               ("submit", 30, 4), ("admit",), ("admit",), ("resolve",),
               ("admit",), ("resolve",), ("admit",), ("resolve",),
               ("admit",), ("resolve",)]),
    # No budget: nothing is deferred or rejected; the ledger still runs.
    "off": (dict(), [("submit", 150, 1), ("submit", 40, 2), ("admit",),
                     ("resolve",)]),
}


@pytest.mark.parametrize("name", sorted(ADMISSION_SCRIPTS))
@async_test(timeout=240)
async def test_admission_equals_reference(name, weights):
    cfg, script = ADMISSION_SCRIPTS[name]
    sides = [Side(pkg, weights, **ADMIT_KW, **cfg) for pkg in ("jax", "port")]
    try:
        ref, got = [await _admission_trace(s, script) for s in sides]
    finally:
        for s in sides:
            s.engine.stop()
    assert got == ref
    rejected = [t for t in ref if t[0] == "rejected"]
    if name == "reject":
        assert rejected and all("projected TTFT" in t[2] for t in rejected)
    if name == "defer":
        assert ref[-1][1][3] > 0            # admission_deferred
        assert ref[-1][1][:2] == (0, 0)     # the ledger squares
    if name == "off":
        assert not rejected and ref[-1][1][3] == 0


def test_brownout_levels_equal_reference(weights):
    sides = [Side(pkg, weights, **ENGINE_KW, ttft_budget_ms=BUDGET_MS)
             for pkg in ("jax", "port")]
    try:
        for cold in (0, 100, 199, 200, 250, 299, 300, 499, 500, 4000):
            levels = []
            for s in sides:
                s.engine._cold_inflight = cold
                s.engine._update_brownout()
                levels.append(s.engine.brownout_level)
            assert levels[0] == levels[1], cold
        off = [Side(pkg, weights, **ENGINE_KW) for pkg in ("jax", "port")]
        for s in off:
            s.engine._cold_inflight = 10_000
            s.engine._update_brownout()
            assert s.engine.brownout_level == 0
            s.engine.stop()
    finally:
        for s in sides:
            s.engine.stop()


def _scripted_brownout(engine, lo: int, hi: int) -> None:
    """Level 2 while the engine has dispatched [lo, hi) windows, else 0."""
    def update():
        w = engine.windows_dispatched
        engine.brownout_level = 2 if lo <= w < hi else 0
    engine._update_brownout = update


@async_test(timeout=300)
async def test_spec_fallback_keeps_plain_greedy_tokens(weights):
    jparams = weights[0]
    plain = teng_mod.GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                                 **ENGINE_KW),
                               params=weights[1])
    spec = teng_mod.GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                                **ENGINE_KW, **SPEC_KW),
                              params=weights[1])
    try:
        for lo, hi in ((2, 5), (1, 3)):
            _scripted_brownout(spec, spec.windows_dispatched + lo,
                               spec.windows_dispatched + hi)
            prompts = [repetitive_prompt(seed=s) for s in (21, 22, 23)] + [
                random_prompt(30, 14)]
            want = await asyncio.gather(*[collect(plain, p, 40)
                                          for p in prompts])
            d0, b0 = spec.spec_drafts, spec.spec_brownout_windows
            got = await asyncio.gather(*[collect(spec, p, 40)
                                         for p in prompts])
            for p, w, g in zip(prompts, want, got):
                assert assert_greedy_equivalent(jparams, p, w, g) >= 1
            assert spec.spec_brownout_windows - b0 == hi - lo
            # Spec windows ran before and after the plain ones.
            assert spec.spec_drafts > d0
        assert spec.perf_status()["spec"]["brownout_windows"] == \
            spec.spec_brownout_windows
    finally:
        plain.stop()
        spec.stop()
