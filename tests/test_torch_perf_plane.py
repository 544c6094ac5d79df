"""The port's engine perf plane (``dynamo_tpu_torch.engine.perf``,
``ModelRunner.hbm_stats`` / ``memory_breakdown``,
``GPUEngine.perf_status``) against the JAX package's, on the CPU.

- ``note_window``: the same window samples through both registries give
  equal gauges and window snapshots (exact: the same float arithmetic).
- Captures: a second capture of a key by the same runner after
  ``mark_ready()`` is flagged, a new key after it is counted and not
  flagged, and two runners do not flag each other's first captures; the
  snapshot bodies carry the reference's keys.
- ``perf_status()`` of a ``GPUEngine`` has the keys of
  ``TPUEngine.perf_status()`` at tiny-test, its window counters equal the
  engine's own window and token counters, and a spec engine's ``spec``
  section has the reference's keys with an analytic verify cost.
- ``PerfMetricsUpdater``: the series names, label sets and help texts of
  the reference's exporter, and the same deltas.
- On the CPU ``hbm_stats() == {}`` and ``workspace_bytes`` is None.
- The fleet pane sums perf views as the reference's does.
"""

import asyncio

import numpy as np
import pytest
import torch
from conftest import async_test
from test_torch_engine import ENGINE_KW, SPEC_J, SPEC_T

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import perf as jperf
from dynamo_tpu.engine.engine import TPUEngine
from dynamo_tpu.llm.fleet import _aggregate as j_aggregate
from dynamo_tpu.runtime.metrics import MetricsRegistry as JMetrics
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import perf as tperf
from dynamo_tpu_torch.engine import runner as trunner
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.llm.fleet import _aggregate as t_aggregate
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

torch.set_num_threads(1)

SAMPLES = [(0.008, 64, 8, 8, 1.0), (0.008, 32, 8, 8, 1.0),
           (0.0, 0, 0, 0, 1.0), (0.05, 40, 5, 8, 4.79),
           (0.021, 17, 3, 8, 4.79), (0.013, 8, 1, 8, 0.0),
           (0.2, 256, 32, 8, 4.79)]


def test_note_window_gauges_equal_reference():
    t, j = tperf.CompileRegistry(), jperf.CompileRegistry()
    for sample in SAMPLES:
        t.note_window(*sample)
        j.note_window(*sample)
        assert (t.step_seconds, t.achieved_tok_s, t.roofline_frac) == \
            (j.step_seconds, j.achieved_tok_s, j.roofline_frac)
        assert t.window_snapshot() == j.window_snapshot()


def _runner(**kw):
    cfg = tcfg.EngineConfig(model=SPEC_T, device="cpu",
                            **dict(ENGINE_KW, **kw))
    return trunner.ModelRunner(cfg, seed=0)


def test_recapture_after_ready_is_flagged_and_new_keys_are_not(monkeypatch):
    reg = tperf.CompileRegistry()
    monkeypatch.setattr(tperf, "_REGISTRY", reg)
    a, b = _runner(), _runner()
    assert a._perf is reg and b._perf is reg
    key = (8, 8, False, False, False)
    a.note_capture(key, 0.5)            # warmup
    a.note_capture(key, 0.5)            # before ready: never flagged
    reg.mark_ready()
    b.note_capture(key, 0.5)            # another runner's first capture
    a.note_capture((8, 16, False, False, False), 0.25)  # a new key
    snap = reg.snapshot()
    assert snap["unexpected_recompiles_total"] == 0
    assert snap["programs"]["decode_window"]["compiles"] == 4
    a.note_capture(key, 0.75)           # the same runner, again: flagged
    snap = reg.snapshot()
    assert snap["unexpected_recompiles_total"] == 1
    assert snap["programs"]["decode_window"]["signatures"] == 2
    a.note_capture(("spec", 2, 3, 8), 0.1)
    assert "spec_window" in reg.snapshot()["programs"]
    # The bodies are the reference's.
    j = jperf.CompileRegistry()
    j.note_compile("decode_window", key, 0.5)
    assert set(snap) == set(j.snapshot())
    assert set(snap["programs"]["decode_window"]) == \
        set(j.snapshot()["programs"]["decode_window"])


def test_cost_is_analytic_once_and_off_with_the_env(monkeypatch):
    reg = tperf.CompileRegistry()
    monkeypatch.setattr(tperf, "_REGISTRY", reg)
    r = _runner()
    width = trunner.PK_PREFIX + 8
    packed = np.zeros((ENGINE_KW["max_num_seqs"], width), np.int32)
    r._maybe_cost("decode_window", packed, 8, 1, np.zeros(4, np.int64))
    assert reg.snapshot()["programs"] == {}  # no live row: not yet
    packed[0, trunner.PK_SEQLEN] = 33
    packed[0, trunner.PK_PREFIX:trunner.PK_PREFIX + 3] = [1, 2, 3]
    hist = np.array([32, 0, 0, 0])
    r._maybe_cost("decode_window", packed, 8, 1, hist)
    cost = reg.snapshot()["programs"]["decode_window"]["cost"]
    assert cost["source"] == "analytic"
    assert cost["bytes_accessed"] > 8 * r.param_bytes
    assert cost["flops"] >= 8 * 2 * SPEC_T.num_params()
    r._maybe_cost("decode_window", packed * 2, 8, 1, hist * 2)
    assert reg.snapshot()["programs"]["decode_window"]["cost"] == cost
    monkeypatch.setenv("DTPU_PERF_COST", "off")
    r._maybe_cost("spec_window", packed, 2, 4, hist)
    assert "spec_window" not in reg.snapshot()["programs"]


def test_cpu_memory_figures():
    r = _runner()
    assert r.hbm_stats() == {}
    mem = r.memory_breakdown()
    assert mem == {"params_bytes": r.param_bytes,
                   "kv_pool_bytes": r.kv_pool_bytes,
                   "workspace_bytes": None}
    assert mem["params_bytes"] > 0 and mem["kv_pool_bytes"] > 0


def test_metrics_updater_series_equal_reference():
    class Eng:
        def __init__(self, mod, hbm):
            self.runner = type("R", (), {"hbm_stats": lambda s: hbm})()
            self.spec_emit_hist = [1, 4, 2, 1, 0]
            self.spec_tokens, self.spec_accepted = 12, 5
            self.spec_brownout_windows = 3

    out = {}
    for name, mod, metrics in (("port", tperf, MetricsRegistry()),
                               ("jax", jperf, JMetrics())):
        reg = mod.CompileRegistry()
        saved = mod._REGISTRY
        mod._REGISTRY = reg
        try:
            up = mod.PerfMetricsUpdater(metrics, min_interval_s=0.0)
            reg.note_compile("decode_window", (8,), 2.0)
            reg.note_compile("decode_window", (8,), 1.0)  # unexpected
            reg.note_window(0.01, 32, 4, 8, 1.0)
            hbm = {"bytes_in_use": 100, "peak_bytes_in_use": 150,
                   "bytes_limit": 200}
            up.update(Eng(mod, hbm), force=True)
            up.update(Eng(mod, hbm), force=True)   # deltas: nothing new
            up.update(Eng(mod, {}), force=True)    # CPU: gauges untouched
        finally:
            mod._REGISTRY = saved
        text = metrics.expose().decode()
        out[name] = sorted(line for line in text.splitlines()
                           if "perf_" in line and "_created" not in line)
    assert out["port"] == out["jax"]
    assert any(x.startswith("dynamo_tpu_perf_spec_brownout_windows_total")
               and x.endswith(" 3.0") for x in out["port"])


async def _serve(engine, prompts, max_tokens=12):
    async def one(p):
        req = {"model": "m", "token_ids": p,
               "stop_conditions": {"max_tokens": max_tokens,
                                   "ignore_eos": True}}
        n = 0
        async for out in engine.generate(req, Context()):
            n += len(out.get("token_ids", []))
        assert n == max_tokens
    await asyncio.gather(*(one(p) for p in prompts))


@async_test(timeout=180)
async def test_perf_status_has_the_reference_keys():
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, SPEC_T.vocab_size, 24).tolist()
               for _ in range(3)]
    teng = GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                       **ENGINE_KW),
                     metrics_registry=MetricsRegistry())
    jeng = TPUEngine(jcfg.EngineConfig(model=SPEC_J, attention_backend="xla",
                                       **ENGINE_KW))
    spec = GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                       spec_decode="ngram", spec_k=3,
                                       **ENGINE_KW))
    jspec = TPUEngine(jcfg.EngineConfig(model=SPEC_J, attention_backend="xla",
                                        spec_decode="ngram", spec_k=3,
                                        **ENGINE_KW))
    try:
        w0 = tperf.get_registry().window_snapshot()
        await _serve(teng, prompts)
        await _serve(jeng, prompts)
        await _serve(spec, prompts)
        await _serve(jspec, prompts)
        t, j = teng.perf_status(), jeng.perf_status()
        assert set(t) == set(j)
        for key in ("window", "roofline", "memory"):
            assert set(t[key]) == set(j[key]), key
        assert set(t["compiles"]) == set(j["compiles"])
        assert {"prefill", "decode_window"} <= set(
            t["compiles"]["programs"])
        assert t["hbm"] == {} and t["memory"]["workspace_bytes"] is None
        assert 0 <= t["roofline"]["frac"] <= 1
        assert t["roofline"]["weight_read_step_ms"] == pytest.approx(
            SPEC_T.weight_read_step_ms(), abs=1e-4)
        # The window series counts exactly this process's engines' windows
        # and tokens since w0 (the registry is process-global).
        w1 = tperf.get_registry().window_snapshot()
        assert w1["windows_total"] - w0["windows_total"] == \
            teng.step_count + spec.step_count
        assert w1["window_tokens_total"] - w0["window_tokens_total"] == \
            teng.tokens_generated_total + spec.tokens_generated_total
        ts, js = spec.perf_status(), jspec.perf_status()
        assert set(ts) == set(js) and set(ts["spec"]) == set(js["spec"])
        assert ts["spec"]["verify_cost_source"] == "analytic"
        assert ts["spec"]["verify_bytes_per_token"] > 0
        assert ts["spec"]["brownout_windows"] == 0
        assert ts["spec"]["draft_tokens"] == spec.spec_tokens
    finally:
        for eng in (teng, jeng, spec, jspec):
            eng.stop()


def test_fleet_pane_sums_perf_views():
    workers = {
        "a": {"ok": True,
              "kv": {"allocator": {"pages_total": 10, "pages_free": 5,
                                   "pages_active": 5}},
              "perf": {"compiles": {"compiles_total": 7,
                                    "unexpected_recompiles_total": 0}}},
        "b": {"ok": True,
              "kv": {"allocator": {"pages_total": 10, "pages_free": 10,
                                   "pages_active": 0}},
              "perf": {"compiles": {"compiles_total": 3,
                                    "unexpected_recompiles_total": 2}}},
        "c": {"ok": False, "error": "down"},
        "d": {"ok": True, "kv": {}},
    }
    agg = t_aggregate(workers)
    assert agg == j_aggregate(workers)
    assert (agg["compiles_total"], agg["unexpected_recompiles"]) == (10, 2)
