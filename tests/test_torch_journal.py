"""The port's decision journal (``dynamo_tpu_torch.runtime.journal``) and
flight recorder (``runtime/flight.py``) against the JAX package's: the
same taxonomy; the same emits under a pinned clock give the same events,
refs and snapshots; ``JournalPublisher`` sends the reference's subject
and payload bytes; ``FleetTimeline`` merges the same deltas (restarts,
holes, replays) into the same timeline; a JAX ``TimelineCollector``
merges a port worker's journal and a port collector a JAX worker's, over
both coordinators; a forced preemption emits ``preempt`` with its cause
on both engines; the flight ring's rows, idle skips, freeze and bundles,
and its steady path allocating nothing; the tiers' ``kv_demote`` /
``kv_promote`` events."""

import asyncio
import json
import time
import tracemalloc

import msgpack
import pytest
from conftest import async_test
from test_torch_chunked import CHUNKED, _port, _prompt, _wire
from test_torch_chunked import jparams  # noqa: F401 — a fixture

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine.engine import TPUEngine
from dynamo_tpu.llm import timeline as jtimeline
from dynamo_tpu.runtime import config as jconfig
from dynamo_tpu.runtime import coordinator as jcoord
from dynamo_tpu.runtime import distributed as jdist
from dynamo_tpu.runtime import flight as jflight
from dynamo_tpu.runtime import journal as jj
from dynamo_tpu.runtime.context import Context as JContext
from dynamo_tpu_torch.engine import kvbm as tkvbm
from dynamo_tpu_torch.llm import timeline as ttimeline
from dynamo_tpu_torch.runtime import config as tconfig
from dynamo_tpu_torch.runtime import coordinator as tcoord
from dynamo_tpu_torch.runtime import distributed as tdist
from dynamo_tpu_torch.runtime import flight as tflight
from dynamo_tpu_torch.runtime import journal as tj
from dynamo_tpu_torch.runtime.context import Context as TContext
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.msgpack_lite import packb


def _clock(start=1000.0):
    t = [start]

    def now():
        t[0] += 0.5
        return t[0]
    return now


def test_the_taxonomy_is_the_reference():
    assert tj.EVENT_KINDS == jj.EVENT_KINDS
    assert {k: v for k, v in vars(tj.EventKind).items()
            if not k.startswith("_")} == {
        k: v for k, v in vars(jj.EventKind).items() if not k.startswith("_")}
    assert tj.journal_subject("dynamo") == jj.journal_subject("dynamo")


def _emit_all(mod, journal):
    k = mod.EventKind
    refs = [journal.emit(k.WORKER_JOIN, model="m", instance="a1"),
            journal.emit(k.PREEMPT, trace_id="ab" * 16, request="r1",
                         slot=2, tokens=40, free_pages=0)]
    refs.append(journal.emit(
        k.KV_DEMOTE, blocks=3, tier_from="g1", tier_to="g2",
        cause=journal.recent_ref(k.KV_DEMOTE, k.PREEMPT)))
    refs.append(journal.emit(k.MIGRATION, attempt=1, reason="disconnect",
                             cause=journal.recent_ref(k.CHAOS_INJECT)))
    with pytest.raises(ValueError, match="unknown journal event kind"):
        journal.emit("made_up")
    return refs


def test_emits_and_snapshots_equal_the_reference():
    jr = jj.Journal(capacity=3, worker="w1", clock=_clock())
    tr = tj.Journal(capacity=3, worker="w1", clock=_clock())
    jr.boot = tr.boot = "b00t"
    assert _emit_all(tj, tr) == _emit_all(jj, jr) == [
        "w1#1", "w1#2", "w1#3", "w1#4"]
    assert tr.snapshot() == jr.snapshot()
    assert tr.since(1) == jr.since(1)  # the ring evicted seq 1
    assert tr.recent_ref(tj.EventKind.PREEMPT) == "w1#2"
    off = tj.Journal(capacity=0)
    off.emit(tj.EventKind.SHED, reason="x")
    assert off.events() == [] and off.seq == 1 and not off.enabled


def test_journal_series_match_the_reference():
    from dynamo_tpu.runtime.metrics import MetricsRegistry as JRegistry
    out = {}
    for mod, reg in ((jj, JRegistry()), (tj, MetricsRegistry())):
        journal = mod.Journal(capacity=4, worker="w", metrics=reg)
        journal.emit(mod.EventKind.PREEMPT)
        journal.emit(mod.EventKind.PREEMPT)
        journal.note_dropped(3)
        out[mod] = reg.expose().decode()
    for text in out.values():
        assert 'dynamo_tpu_journal_events_total{dynamo_component="",' \
               'dynamo_endpoint="",dynamo_namespace="journal",' \
               'kind="preempt"} 2.0' in text
        assert "dynamo_tpu_journal_dropped_total" in text


class _Capture:
    def __init__(self):
        self.sent = []

    async def publish(self, subject, payload):
        self.sent.append((subject, payload))


@async_test(timeout=30)
async def test_publisher_sends_the_reference_subject_and_bytes():
    sends = {}
    for mod in (jj, tj):
        journal = mod.Journal(capacity=3, worker="w1", clock=_clock())
        journal.boot = "b00t"
        client = _Capture()
        pub = mod.JournalPublisher(client, "dynamo", "w1", journal=journal,
                                   max_batch=2)
        assert await pub.flush(force=True) == 0  # the empty announcement
        _emit_all(mod, journal)
        await pub.flush()
        journal.emit(mod.EventKind.SHED, reason="queue_full")
        await pub.flush()
        sends[mod] = client.sent
        assert journal.dropped_overflow == 1
    assert [s for s, _ in sends[tj]] == [s for s, _ in sends[jj]] == \
        ["ns.dynamo.journal"] * len(sends[jj])
    for (_, t), (_, j) in zip(sends[tj], sends[jj]):
        assert packb(t) == msgpack.packb(j, use_bin_type=True)


def _deltas():
    """A worker's deltas: a first batch, a replay, a hole, a restart."""
    ev = [{"kind": "preempt", "seq": s, "ts": 100.0 + s, "worker": "w",
           "ref": f"w#{s}", "trace_id": None, "cause": None, "attrs": {}}
          for s in range(1, 8)]
    return [
        {"worker": "w", "boot": "b1", "first_seq": 1, "last_seq": 2,
         "overflow": 0, "events": ev[0:2]},
        {"worker": "w", "boot": "b1", "first_seq": 1, "last_seq": 2,
         "overflow": 0, "events": ev[0:2]},
        {"worker": "w", "boot": "b1", "first_seq": 5, "last_seq": 6,
         "overflow": 2, "events": ev[4:6]},
        {"worker": "w", "boot": "b2", "first_seq": 1, "last_seq": 1,
         "overflow": 0, "events": [dict(ev[0], ts=200.0)]},
        {"worker": "v", "boot": "c1", "first_seq": 1, "last_seq": 0,
         "overflow": 0, "events": []},
    ]


def test_fleet_timeline_merges_like_the_reference():
    snaps = []
    for mod in (jj, tj):
        tl = mod.FleetTimeline(ttl_s=10.0, clock=_clock(), wall_clock=_clock(
            300.0))
        applied = [tl.apply_delta(d) for d in _deltas()]
        snaps.append((applied, tl.snapshot(), tl.prune()))
        local = mod.Journal(capacity=4, worker="front", clock=_clock(150.0))
        local.emit(mod.EventKind.SHED, reason="x")
        snaps.append(mod.merge_timeline(tl.events(), local, limit=5))
    assert snaps[2:] == snaps[:2]
    applied, snap, _ = snaps[2]
    assert applied == [2, 0, 2, 1, 0]
    assert snap["gaps"] == 2 and snap["dropped_stale_seq"] == 2
    assert set(snap["workers"]) == {"w", "v"}


async def _runtime(pkg, url):
    if pkg == "jax":
        return await jdist.DistributedRuntime.from_settings(
            jconfig.RuntimeConfig(coordinator_url=url))
    return await tdist.DistributedRuntime.from_settings(
        tconfig.RuntimeConfig(coordinator_url=url))


@pytest.mark.parametrize("coord_pkg", ["jax", "port"])
@async_test(timeout=60)
async def test_collectors_merge_each_others_workers(coord_pkg):
    """A port worker's and a JAX worker's journals reach a JAX and a port
    TimelineCollector over the coordinator's pub/sub: both collectors
    hold the same merged events and stream fences, with no gap."""
    coord = (jcoord.Coordinator() if coord_pkg == "jax"
             else tcoord.Coordinator("127.0.0.1", 0))
    await coord.start()
    rts = {pkg: await _runtime(pkg, coord.url)
           for pkg in ("jax", "port", "jfront", "tfront")}
    rts["jfront"] = await _runtime("jax", coord.url)
    collectors = {"jax": jtimeline.TimelineCollector(rts["jfront"]),
                  "port": ttimeline.TimelineCollector(rts["tfront"])}
    try:
        for c in collectors.values():
            await c.start()
        journals, pubs = {}, {}
        for pkg, mod in (("jax", jj), ("port", tj)):
            journals[pkg] = mod.Journal(capacity=16, worker=pkg,
                                        clock=_clock())
            pubs[pkg] = mod.JournalPublisher(
                rts[pkg].require_coordinator(), "dynamo", pkg,
                journal=journals[pkg])
            await pubs[pkg].flush(force=True)
            _emit_all(mod, journals[pkg])
            await pubs[pkg].flush()

        def merged(c):
            return len(c.fleet.events()) == 8
        for _ in range(200):
            if all(merged(c) for c in collectors.values()):
                break
            await asyncio.sleep(0.02)
        status = {k: c.timeline_status(limit=0)
                  for k, c in collectors.items()}
        for s in status.values():
            assert s["gaps"] == 0 and s["applied"] == 8
            assert set(s["workers"]) >= {"jax", "port"}
        strip = [{k: v for k, v in e.items()} for e in
                 status["jax"]["events"] if e["worker"] in ("jax", "port")]
        got = [e for e in status["port"]["events"]
               if e["worker"] in ("jax", "port")]
        key = lambda e: (e["worker"], e["seq"])  # noqa: E731
        assert sorted(got, key=key) == sorted(strip, key=key)
        assert {e["ref"] for e in got} >= {"jax#2", "port#2"}
    finally:
        for c in collectors.values():
            await c.stop()
        for rt in rts.values():
            await rt.close()
        await coord.stop()


@async_test(timeout=300)
async def test_forced_preemption_journals_preempt_on_both_engines(
        jparams):  # noqa: F811
    """Three prompts outgrowing a 10-page pool: each engine preempts, and
    every preemption is a ``preempt`` event with the reference's fields,
    the request's trace id and no cause (no chaos plane runs)."""
    kw = dict(CHUNKED, max_num_seqs=3, decode_window=4, pipeline_depth=2,
              num_pages=10)
    prompts = [_prompt(60 + i, 30) for i in range(3)]
    jeng = TPUEngine(jcfg.EngineConfig(model=jcfg.PRESETS["tiny-test"],
                                       attention_backend="xla", **kw),
                     params=jparams)
    teng = _port(jparams, **kw)
    teng.start()
    events = {}
    try:
        for name, eng, mod, ctx_cls in (("jax", jeng, jj, JContext),
                                        ("port", teng, tj, TContext)):
            seq0 = mod.get_journal().seq
            ctxs = [ctx_cls() for _ in prompts]

            async def one(p, ctx, eng=eng):
                async for _ in eng.generate(_wire(p, 40), ctx):
                    pass
            await asyncio.gather(*[one(p, c) for p, c in zip(prompts, ctxs)])
            got = [e for e in mod.get_journal().events()
                   if e["seq"] > seq0 and e["kind"] == "preempt"]
            assert got and len(got) == eng.preempt_count, (name, got)
            assert {e["trace_id"] for e in got} <= {c.trace_id for c in ctxs}
            events[name] = got
    finally:
        jeng.stop()
        teng.stop()
    for e in events["port"] + events["jax"]:
        assert e["cause"] is None
        assert set(e["attrs"]) == {"request", "slot", "tokens",
                                   "free_pages"}


def test_kvbm_journals_demotions_and_promotions_like_the_reference():
    from dynamo_tpu.engine import kvbm as jkvbm
    got = {}
    for mod, jmod in ((tkvbm, tj), (jkvbm, jj)):
        journal = jmod.get_journal()
        seq0 = journal.seq
        alloc = type("A", (), {})()
        alloc.num_pages, alloc.free, alloc.inactive = 10, [0], {1: 1, 2: 2}
        alloc.demote_lru = lambda want, skip=(): list(range(want))
        host = type("H", (), {"get": lambda self, h: None,
                              "put": lambda self, h, kv: None})()
        m = mod.KvBlockManager(alloc, host, mod.KvbmPolicy(
            low_watermark=0.5, high_watermark=0.6))
        assert m.maintain() == 5
        m.maintain()  # throttled: one event per burst
        m.note_promoted(2, 1, trace_id="ab" * 16)
        got[mod] = [(e["kind"], e["attrs"], e["trace_id"])
                    for e in journal.events() if e["seq"] > seq0]
    assert got[tkvbm] == got[jkvbm]
    assert [k for k, _, _ in got[tkvbm]] == ["kv_demote", "kv_promote"]


# -- the flight recorder ---------------------------------------------------------

def _rows(mod, rec):
    for i in range(5):
        rec.record(10.0 + i, 0.1, 3, 1, 40 - i, 16 * i, 1, 0, 0, 0.2, i,
                   tokens=24)
    for i in range(3):  # idle-stable: the second and third are skipped
        rec.record(20.0 + i, 0.0, 0, 0, 50, 0, 0, 0, 0, 0.0, 5 + i)
    return rec.dump(), rec.meta()


def test_flight_ring_matches_the_reference():
    assert tflight.FIELDS == jflight.FIELDS
    ref = _rows(jflight, jflight.FlightRecorder(capacity=4))
    got = _rows(tflight, tflight.FlightRecorder(capacity=4))
    assert got == ref
    assert got[1]["skipped_idle"] == 2 and len(got[0]) == 4
    rec = tflight.FlightRecorder(capacity=4)
    assert rec.freeze("why") and not rec.freeze("again")
    assert rec.record(1.0, 0.1, 1, 0, 1, 0, 0, 0, 0, 0.0, 1) is False
    rec.thaw()
    assert rec.record(1.0, 0.1, 1, 0, 1, 0, 0, 0, 0, 0.0, 1) is True


def test_flight_steady_path_allocates_nothing():
    rec = tflight.FlightRecorder(capacity=64)

    def steady(n):
        for i in range(n):
            rec.record(1.0, 0.0, 0, 0, 50, 0, 0, 0, 0, 0.0, i)

    steady(3)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        steady(5000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    stats = [s for s in after.compare_to(before, "filename")
             if "flight.py" in (s.traceback[0].filename or "")]
    assert sum(s.size_diff for s in stats) <= 0, stats


def test_trigger_writes_a_bundle_that_names_its_reason(tmp_path):
    reg = MetricsRegistry()
    reg.counter("probe_total", "A series in the bundle").inc()
    saved = (tflight._bundle_dir, tflight._cooldown_s,
             tflight._metrics_registry, tflight._last_trigger_t)
    tflight.configure(metrics=reg, config_fingerprint={"a": 1},
                      bundle_dir=str(tmp_path), cooldown_s=300.0)
    tflight._last_trigger_t = -1e18
    try:
        seq0 = tj.get_journal().seq
        assert tflight.trigger("decode_stall_2.50s")
        assert not tflight.trigger("decode_stall_3.00s")  # cooldown
        for _ in range(200):
            files = list(tmp_path.glob("flight-*.json"))
            if files and not tflight.get_recorder().frozen:
                break
            time.sleep(0.01)
        bundle = json.loads(files[0].read_text())
        assert bundle["reason"] == "decode_stall_2.50s"
        assert set(bundle) == {"reason", "ts", "flight", "spans", "metrics",
                               "journal", "config_fingerprint"}
        assert "dynamo_tpu_probe_total" in bundle["metrics"]
        kinds = [e["kind"] for e in tj.get_journal().events()
                 if e["seq"] > seq0]
        assert kinds == ["flight_bundle"]
    finally:
        (tflight._bundle_dir, tflight._cooldown_s,
         tflight._metrics_registry, tflight._last_trigger_t) = saved


def test_bundle_dir_follows_the_process_temp_dir(tmp_path):
    """With no ``DTPU_FLIGHT_DIR`` the bundles go under the process's own
    temporary directory (``TMPDIR``), not a fixed path that two
    checkouts on one machine would share; the variable still overrides."""
    import os
    import subprocess
    import sys
    probe = ("from dynamo_tpu_torch.runtime import flight; "
             "print(flight._bundle_dir)")
    env = {k: v for k, v in os.environ.items() if k != "DTPU_FLIGHT_DIR"}
    env["TMPDIR"] = str(tmp_path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=root,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == str(tmp_path / "dtpu-flight")
    env["DTPU_FLIGHT_DIR"] = str(tmp_path / "elsewhere")
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=root,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == str(tmp_path / "elsewhere")
