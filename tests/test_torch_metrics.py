"""The port's stdlib metrics registry (``dynamo_tpu_torch.runtime.metrics``)
against the JAX package's (``dynamo_tpu.runtime.metrics`` on
``prometheus_client``): the same registrations and observations give the
same parsed exposition samples, ``*_created`` aside (the port emits
none); the registry's errors and accessors; the KV, adapter, phase,
endpoint and HTTP series of both packages on the same inputs; and the
docs-drift guard: every ``dynamo_tpu_*`` series docs/OBSERVABILITY.md
names is registered by the port or listed in ``NOT_PORTED_SERIES`` with
the ROADMAP item that ports it."""

import math
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
from prometheus_client.parser import text_string_to_metric_families

from dynamo_tpu.engine import kv_metrics as jkv
from dynamo_tpu.runtime import metrics as jm
from dynamo_tpu.runtime import tracing as jtracing
from dynamo_tpu_torch.engine import kv_metrics as tkv
from dynamo_tpu_torch.runtime import metrics as tm
from dynamo_tpu_torch.runtime import tracing as ttracing

ROOT = Path(__file__).resolve().parents[1]


def samples(text: bytes) -> dict:
    """{(sample name, sorted labels): value}, ``*_created`` dropped."""
    out = {}
    for family in text_string_to_metric_families(text.decode()):
        for s in family.samples:
            if s.name.endswith("_created"):
                continue
            out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def families(text: bytes) -> dict:
    """{family name: (type, help)}, ``*_created`` families dropped."""
    return {f.name: (f.type, f.documentation)
            for f in text_string_to_metric_families(text.decode())
            if not f.name.endswith("_created")}


def same(fill) -> tuple[dict, dict]:
    """Run ``fill(registry)`` on a fresh registry of each package and hold
    their expositions equal."""
    j, t = jm.MetricsRegistry(), tm.MetricsRegistry()
    fill(j)
    fill(t)
    jt, tt = j.expose(), t.expose()
    assert samples(tt) == samples(jt)
    assert families(tt) == families(jt)
    return samples(jt), samples(tt)


def _counters(r):
    c = r.namespace("ns").component("gpu").counter(
        "things_total", "Things done", ["route", "status"])
    c.inc(route="chat", status="200")
    c.inc(2.5, route="chat", status="200")
    c.inc(route="chat", status="500")
    c.ensure(route="completions", status="200")
    r.counter("bare_total", "No labels").inc(7)
    r.counter("no_suffix", "Counter without _total").inc()


def _gauges(r):
    g = r.namespace("ns").component("gpu").endpoint("generate").gauge(
        "inflight", "In flight", ["route"])
    g.inc(route="a")
    g.inc(3, route="a")
    g.dec(route="a")
    g.set(-2.5, route="b")
    r.gauge("big", "A large value").set(12345678.5)
    r.gauge("tiny", "A small value").set(1e-9)
    r.gauge("inf", "Infinite").set(math.inf)


def _histograms(r):
    h = r.namespace("ns").histogram("lat_seconds", "Latency", ["model"])
    for v in (0.001, 0.005, 0.3, 2.0, 99.0):
        h.observe(v, model="m")
    h.ensure(model="other")
    b = r.namespace("ns").component("c").histogram(
        "overlap_blocks", "Overlap", ["kind"],
        buckets=[0, 1, 2, 4, 8, 16, 32, 64, 128, 256])
    for v in (0, 0, 3, 300, 64):
        b.observe(v, kind="chosen")
    r.histogram("bytes", "Bytes", buckets=[1 << 12, 1 << 20]).observe(4096)


def _escapes(r):
    c = r.counter("escaped_total", 'Help with a \\ backslash\nand newline',
                  ["v"])
    c.inc(v='quote " backslash \\ newline \n end')


def _phase(r):
    pm = jtracing.phase_metrics if isinstance(r, jm.MetricsRegistry) \
        else ttracing.phase_metrics
    p = pm(r.namespace("dynamo").component("gpu"))
    p.queue_wait.observe(0.02)
    p.prefill.observe(0.3)
    for v in (0.09, 0.11, 0.1):
        p.decode.observe(v)
    p.kv_transfer.observe(0.004, direction="recv")
    p.kv_transfer_bytes.observe(6 << 20, direction="send")


CASES = {"counters": _counters, "gauges": _gauges,
         "histograms": _histograms, "escapes": _escapes, "phase": _phase}


@pytest.mark.parametrize("fill", CASES.values(), ids=CASES.keys())
def test_exposition_samples_equal_the_reference(fill):
    ref, _ = same(fill)
    assert ref


def _without_created(text: bytes) -> list[str]:
    out, skip = [], False
    for line in text.decode().splitlines():
        if line.startswith("# HELP "):
            skip = line.split()[2].endswith("_created")
        if not skip:
            out.append(line)
    return out


@pytest.mark.parametrize("fill", CASES.values(), ids=CASES.keys())
def test_exposition_text_equals_the_reference_but_created(fill):
    j, t = jm.MetricsRegistry(), tm.MetricsRegistry()
    fill(j)
    fill(t)
    assert _without_created(t.expose()) == _without_created(j.expose())


def _fake_engine(step: int):
    """Duck-typed engine state for the KV exporter, moved by ``step``."""
    alloc = {"pages_total": 64, "pages_free": 40 - step,
             "pages_active": 16 + step, "pages_inactive": 8,
             "cached_blocks": 20 + step, "occupancy": (16 + step) / 64,
             "reuse_hit_blocks": 5 * step, "reuse_lookup_blocks": 9 * step,
             "evicted_blocks": step, "cleared_blocks": 0}
    tiers = {"g2_blocks": 3 + step, "g2_bytes": 4096 * (3 + step),
             "g2_hits": step, "g2_misses": 2 * step, "g2_spills_in": step,
             "g2_demotions": step // 2, "g3_blocks": step, "g3_bytes": 0,
             "g3_hits": 0, "g3_misses": step}
    client = SimpleNamespace(transfers=step, pull_seconds_total=0.5 * step,
                             bytes_in=1000 * step)
    return SimpleNamespace(
        allocator=SimpleNamespace(stats=lambda: alloc),
        runner=SimpleNamespace(kv_pool_bytes=1 << 20),
        g4_blocks=step, onboard_blocks=3 * step,
        host_cache=SimpleNamespace(stats=lambda: tiers),
        kvbm=SimpleNamespace(watermark_demotions=2 * step, promotions=step,
                             recompute_fallbacks=step % 2,
                             peer_pull_failures=0, pinned={1, 2}),
        remote_source=SimpleNamespace(fetch_failures=step, client=client),
        plane=SimpleNamespace(bytes_out=500 * step, blocks_served=step))


def test_kv_and_adapter_exporters_match_the_reference():
    def fill(r):
        mod = jkv if isinstance(r, jm.MetricsRegistry) else tkv
        node = r.namespace("dynamo").component("gpu")
        kv = mod.KvMetricsUpdater(node)
        ad = mod.AdapterMetricsUpdater(node)
        for step in (1, 4, 3):  # a restart-like drop must not go backwards
            kv.update(_fake_engine(step), force=True)
            ad.update(SimpleNamespace(
                resident=step, loads_total=2 * step, evictions_total=step,
                miss_total=step, requests_total={"a": step, "b": 1}),
                force=True)
    ref, _ = same(fill)
    key = ("dynamo_tpu_kv_reuse_blocks_total",
           (("dynamo_component", "gpu"), ("dynamo_endpoint", ""),
            ("dynamo_namespace", "dynamo"), ("tier", "hbm")))
    assert ref[key] == 20.0


def test_the_registry_refuses_a_second_shape():
    node = tm.MetricsRegistry().namespace("ns")
    node.counter("thing_total", "things", ["route"])
    with pytest.raises(ValueError, match="labels"):
        node.counter("thing_total", "things", ["route", "status"])
    with pytest.raises(ValueError, match="Counter"):
        node.histogram("thing_total", "things", ["route"])
    node.counter("thing_total", "things", ["route"])  # idempotent


def test_bound_accessors():
    node = tm.MetricsRegistry().namespace("ns")
    h = node.histogram("lat_seconds", "latency")
    assert h.get() == tm.HistogramValue(0, 0.0)
    h.observe(0.25)
    h.observe(0.75)
    assert h.get().count == 2 and abs(h.get().total - 1.0) < 1e-12
    c = node.counter("n_total", "count", ["reason"])
    c.inc(3, reason="a")
    c.inc(reason="b")
    assert c.get(reason="a") == 3.0
    assert c.collect() == {("a",): 3.0, ("b",): 1.0}
    with pytest.raises(ValueError, match="non-negative"):
        c.inc(-1, reason="a")
    with pytest.raises(TypeError):
        h.collect()
    with pytest.raises(TypeError):
        c.set(1.0, reason="a")


def test_an_empty_registry_exposes_nothing():
    assert tm.MetricsRegistry().expose() == jm.MetricsRegistry().expose() \
        == b""


@pytest.mark.parametrize("value", [0.0, 1.0, 0.1, 1e-7, 123456.0,
                                   1234567.0, 12345678.25, 1e22, -3.5,
                                   math.inf, -math.inf, math.nan])
def test_float_formatting_matches_prometheus_client(value):
    from prometheus_client.utils import floatToGoString
    assert tm.format_float(value) == floatToGoString(value)


# -- docs-drift guard ------------------------------------------------------------

_REGISTER_RE = re.compile(
    r"\.(?:counter|gauge|histogram)\(\s*[\"']([a-z0-9_]+)[\"']")
_DOC_NAME_RE = re.compile(r"dynamo_tpu_([a-z0-9_]+)")
_EXPO_SUFFIXES = ("_bucket", "_sum", "_count", "_total")


def _port_registered() -> set:
    names = set()
    for path in (ROOT / "dynamo_tpu_torch").rglob("*.py"):
        names.update(_REGISTER_RE.findall(path.read_text()))
    return names


def test_every_documented_series_is_registered_or_waits_for_its_item():
    registered = _port_registered()
    doc = (ROOT / "docs" / "OBSERVABILITY.md").read_text()
    documented = set(_DOC_NAME_RE.findall(doc))
    assert documented and registered
    unknown = []
    for name in sorted(documented):
        if name.endswith("_"):  # a family, e.g. dynamo_tpu_kv_*
            if not any(r.startswith(name) for r in registered) \
                    and not any(n.startswith(name)
                                for n in tm.NOT_PORTED_SERIES):
                unknown.append(name + "*")
            continue
        candidates = {name} | {name[:-len(s)] for s in _EXPO_SUFFIXES
                               if name.endswith(s)}
        if not candidates & (registered | set(tm.NOT_PORTED_SERIES)):
            unknown.append(name)
    assert not unknown, (
        f"documented in docs/OBSERVABILITY.md but neither registered by "
        f"dynamo_tpu_torch/ nor in NOT_PORTED_SERIES: {unknown}")


def test_the_not_ported_table_names_items_and_holds_no_ported_series():
    registered = _port_registered()
    stale = sorted(set(tm.NOT_PORTED_SERIES) & registered)
    assert not stale, f"registered by the port, still listed: {stale}"
    assert all(re.search(r"ROADMAP item \d+\b", item)
               for item in tm.NOT_PORTED_SERIES.values())
    # The planner's, the role manager's and the standby agent's series
    # (the last the table held) are registered by the port now.
    assert not tm.NOT_PORTED_SERIES
    assert {"autoscale_current_workers", "autoscale_decisions_total",
            "autoscale_join_seconds", "autoscale_standby_pool",
            "autoscale_target_workers", "role_flips_total",
            "standby_join_seconds", "standby_promotions_total",
            "standby_ready", "worker_role"} <= registered
