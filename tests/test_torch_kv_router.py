"""The port's KV router pieces (``dynamo_tpu_torch.llm.kv_router``) held
against the JAX package's on the same inputs, made from a seed with
numpy:

- the radix tree's ``find_matches`` after every event of a stream, and
  its ``dump_as_events`` at the end (against the reference's Python tree
  and its default tree);
- ``KvScheduler.select`` at temperature 0 over seeded overlaps, metrics
  and ledgers: the same worker and overlap, or the same OverloadedError;
- ``ApproxKvIndexer`` TTL expiry and purge under an injected clock;
- ``kmin_sketch``, ``sketch_overlap`` and ``sketch_prefix_blocks``;
- ``FleetInventory`` and ``DecisionLog`` snapshots;
- every protocol class: the port's ``to_wire`` equals the JAX
  ``to_wire`` (pydantic's ``model_dump``) of the same fields, and each
  side's ``from_wire`` reads the other's dicts.
"""

import types

import numpy as np
import pytest

from dynamo_tpu.llm import kv_router as jkr
from dynamo_tpu.llm.kv_router import fleet as jfleet
from dynamo_tpu.llm.kv_router import indexer as jidx
from dynamo_tpu.llm.kv_router import protocols as jproto
from dynamo_tpu.llm.kv_router import scheduler as jsched
from dynamo_tpu.llm.kv_router import sequence as jseq
from dynamo_tpu.runtime.errors import OverloadedError as JOverloaded
from dynamo_tpu_torch.llm import kv_router as tkr
from dynamo_tpu_torch.llm.kv_router import fleet as tfleet
from dynamo_tpu_torch.llm.kv_router import indexer as tidx
from dynamo_tpu_torch.llm.kv_router import protocols as tproto
from dynamo_tpu_torch.llm.kv_router import scheduler as tsched
from dynamo_tpu_torch.llm.kv_router import sequence as tseq
from dynamo_tpu_torch.runtime.errors import OverloadedError as TOverloaded

SEEDS = [0, 1, 2, 3]
WORKERS = [0x11, 0x2A2A, 0x7F00FF]


def _hashes(rng, n) -> list[int]:
    return [int(h) for h in rng.integers(0, 2**63, n, dtype=np.int64)]


def _chains(rng, n_chains=6, depth=12) -> list[list[int]]:
    """Block-hash chains that share prefixes: each chain forks from a
    random point of an earlier one."""
    chains = [_hashes(rng, depth)]
    for _ in range(n_chains - 1):
        base = chains[rng.integers(len(chains))]
        cut = int(rng.integers(0, depth))
        chains.append(base[:cut] + _hashes(rng, depth - cut))
    return chains


def _event(mod, worker, kind, hashes):
    ev = {"stored": lambda: mod.KvCacheEvent.stored(hashes),
          "removed": lambda: mod.KvCacheEvent.removed(hashes),
          "cleared": lambda: mod.KvCacheEvent.cleared()}[kind]()
    return mod.RouterEvent(worker_id=worker, event=ev)


def _events(rng, chains, n=60):
    out = []
    for _ in range(n):
        worker = WORKERS[rng.integers(len(WORKERS))]
        roll = rng.random()
        chain = chains[rng.integers(len(chains))]
        lo = int(rng.integers(0, len(chain)))
        hi = int(rng.integers(lo, len(chain) + 1))
        if roll < 0.6:
            out.append((worker, "stored", chain[:hi]))
        elif roll < 0.95:
            out.append((worker, "removed", chain[lo:hi]))
        else:
            out.append((worker, "cleared", []))
    return out


def _dump(tree) -> list:
    return sorted((e.to_wire() for e in tree.dump_as_events()),
                  key=lambda d: d["worker_id"])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("jtree", ["PyRadixTree", "RadixTree"])
def test_radix_matches_and_dump(seed, jtree):
    rng = np.random.default_rng(seed)
    chains = _chains(rng)
    ref, port = getattr(jidx, jtree)(), tidx.RadixTree()
    assert tidx.RadixTree is tidx.PyRadixTree
    queries = chains + [c[:4] + _hashes(rng, 3) for c in chains]
    for worker, kind, hashes in _events(rng, chains):
        ref.apply_event(_event(jproto, worker, kind, hashes))
        port.apply_event(_event(tproto, worker, kind, hashes))
        for q in queries:
            assert port.find_matches(q) == ref.find_matches(q), q
        assert port.num_blocks == ref.num_blocks
        assert port.workers() == ref.workers()
    assert _dump(port) == _dump(ref)
    # A new replica fed the dump answers the same.
    replica = tidx.RadixTree()
    for e in port.dump_as_events():
        replica.apply_event(e)
    for q in queries:
        assert replica.find_matches(q) == ref.find_matches(q)
    for w in WORKERS[:1]:
        ref.remove_worker(w)
        port.remove_worker(w)
    assert _dump(port) == _dump(ref)


def _ledger_and_metrics(rng, pkg_seq, pkg_proto, workers):
    seqs = pkg_seq.ActiveSequencesMultiWorker()
    metrics = {}
    for w in workers:
        for i in range(int(rng.integers(0, 4))):
            seqs.add_request(w, f"{w}-{i}", int(rng.integers(0, 40)),
                             int(rng.integers(0, 700)))
            if rng.random() < 0.3:
                seqs.mark_prefill_complete(w, f"{w}-{i}")
        if rng.random() < 0.8:
            total = int(rng.integers(50, 400))
            active = int(rng.integers(0, total))
            metrics[w] = pkg_proto.ForwardPassMetrics(
                worker_id=w,
                kv_stats=pkg_proto.KvStats(kv_active_blocks=active,
                                           kv_total_blocks=total))
    return seqs, metrics


def _select(pkg_sched, pkg_seq, pkg_proto, cfg_kw, seed, workers, blocks,
            overlaps):
    rng = np.random.default_rng(seed)
    seqs, metrics = _ledger_and_metrics(rng, pkg_seq, pkg_proto, workers)
    sched = pkg_sched.KvScheduler(pkg_sched.KvRouterConfig(**cfg_kw), seqs)
    for m in metrics.values():
        sched.update_metrics(m)
    try:
        return sched.select(list(workers), blocks, dict(overlaps))
    except (JOverloaded, TOverloaded) as exc:
        return ("overloaded", str(exc))


@pytest.mark.parametrize("seed", range(12))
def test_scheduler_select_same_worker(seed):
    rng = np.random.default_rng(100 + seed)
    for trial in range(20):
        n = int(rng.integers(1, 5))
        workers = [int(w) for w in rng.choice(2**40, n, replace=False)]
        blocks = int(rng.integers(1, 80))
        overlaps = {w: int(rng.integers(0, blocks + 1)) for w in workers
                    if rng.random() < 0.6}
        cfg_kw = dict(overlap_score_weight=float(rng.choice([0.0, 0.5,
                                                             1.0, 2.0])),
                      block_size=int(rng.choice([16, 32])),
                      busy_threshold=(None if rng.random() < 0.5
                                      else float(rng.uniform(0.1, 1.0))))
        sub = seed * 1000 + trial
        got = _select(tsched, tseq, tproto, cfg_kw, sub, workers, blocks,
                      overlaps)
        want = _select(jsched, jseq, jproto, cfg_kw, sub, workers, blocks,
                       overlaps)
        assert got == want, (cfg_kw, workers, blocks, overlaps)


def test_scheduler_no_workers_is_overloaded():
    sched = tsched.KvScheduler(tsched.KvRouterConfig(),
                               tseq.ActiveSequencesMultiWorker())
    with pytest.raises(TOverloaded, match="no candidate workers"):
        sched.select([], 4, {})


def test_scheduler_ties_go_to_the_first_candidate():
    """The cost of phase 9's wave 1 (64-block prompts on two workers):
    idle 128, one request in flight 256, ties to the first candidate."""
    for pkg_sched, pkg_seq in ((tsched, tseq), (jsched, jseq)):
        seqs = pkg_seq.ActiveSequencesMultiWorker()
        sched = pkg_sched.KvScheduler(pkg_sched.KvRouterConfig(), seqs)
        picks = []
        for i in range(4):
            w, _ = sched.select([7, 9], 64, {})
            seqs.add_request(w, f"r{i}", 64, 1024)
            picks.append(w)
        assert picks == [7, 9, 7, 9]


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("seed", SEEDS)
def test_approx_indexer_ttl_and_purge(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    clock = _Clock()
    for mod in (jidx, tidx):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=clock))
    ref = jidx.ApproxKvIndexer(block_size=4, ttl_s=10.0)
    port = tidx.ApproxKvIndexer(block_size=4, ttl_s=10.0)
    prompts = [rng.integers(0, 500, int(rng.integers(4, 30))).tolist()
               for _ in range(6)]
    prompts += [p[:8] + [1, 2, 3, 4] for p in prompts[:3]]
    for _ in range(40):
        clock.t += float(rng.uniform(0.0, 4.0))
        if rng.random() < 0.5:
            w = WORKERS[rng.integers(len(WORKERS))]
            p = prompts[rng.integers(len(prompts))]
            ref.touch(w, p)
            port.touch(w, p)
        for p in prompts:
            assert port.find_matches_for_tokens(p) == \
                ref.find_matches_for_tokens(p)
        assert port.tree.num_blocks == ref.tree.num_blocks
    clock.t += 11.0
    ref.purge()
    port.purge()
    assert port.tree.num_blocks == ref.tree.num_blocks == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_sketches(seed):
    rng = np.random.default_rng(seed)
    for n_a, n_b in ((0, 5), (10, 10), (40, 200), (300, 300)):
        common = _hashes(rng, min(n_a, n_b) // 2)
        a = common + _hashes(rng, n_a - len(common))
        b = common + _hashes(rng, n_b - len(common))
        # Negative and wide values normalize to 64 bits.
        a += [-int(h) for h in a[:3]] + [2**70 + 5]
        for k in (8, 64):
            assert tproto.kmin_sketch(a, k) == jproto.kmin_sketch(a, k)
        sa, sb = tproto.kmin_sketch(a), tproto.kmin_sketch(b)
        assert tproto.sketch_overlap(sa, sb) == jproto.sketch_overlap(sa, sb)
        for q in (a[:20], common[:30] + b[:3], b, []):
            assert tproto.sketch_prefix_blocks(sa, q) == \
                jproto.sketch_prefix_blocks(sa, q)


def _digests(mod, rng, n=12):
    out = []
    for _ in range(n):
        w = WORKERS[rng.integers(len(WORKERS))]
        total = int(rng.integers(10, 500))
        free = int(rng.integers(0, total))
        out.append(dict(
            worker_id=w, seq=int(rng.integers(1, 6)),
            ts=float(rng.uniform(0, 1e9)),
            blocks=int(rng.integers(0, 300)),
            tier_blocks={"g1": int(rng.integers(0, 300))},
            pages_total=total, pages_free=free,
            pages_active=int(rng.integers(0, total - free + 1)),
            sketch=tproto.kmin_sketch(_hashes(rng, int(rng.integers(0,
                                                                    90))))))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_fleet_inventory_and_decision_log(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    clock = _Clock()
    for mod in (jfleet, tfleet):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=clock))
    ref, port = jfleet.FleetInventory(), tfleet.FleetInventory()
    for d in _digests(None, rng):
        clock.t += float(rng.uniform(0, 12))
        assert port.apply(tproto.KvInventoryDigest(**d)) == \
            ref.apply(jproto.KvInventoryDigest(**d))
        assert port.snapshot() == ref.snapshot()
        probe = d["sketch"][:5] + _hashes(rng, 2)
        assert port.prefix_overlaps(WORKERS, probe) == \
            ref.prefix_overlaps(WORKERS, probe)
    port.remove_worker(WORKERS[0])
    ref.remove_worker(WORKERS[0])
    assert port.snapshot() == ref.snapshot()
    jlog, tlog = jfleet.DecisionLog(capacity=16), tfleet.DecisionLog(
        capacity=16)
    assert tlog.snapshot() == jlog.snapshot()
    for _ in range(40):
        best = int(rng.integers(0, 70))
        args = (WORKERS[rng.integers(len(WORKERS))],
                int(rng.integers(0, best + 1)), best,
                int(rng.integers(1, 80)))
        jlog.note(*args)
        tlog.note(*args)
        assert tlog.snapshot() == jlog.snapshot()
    assert list(tlog._ring) == list(jlog._ring)


def _fields(name, rng):
    h = _hashes(rng, 4)
    return {
        "KvStoredBlock": dict(block_hash=h[0], parent_hash=h[1]),
        "KvCacheEvent": dict(event_id=7, kind="stored", parent_hash=h[0],
                             block_hashes=h),
        "RouterEvent": dict(worker_id=WORKERS[2], event=dict(
            event_id=3, kind="removed", parent_hash=None, block_hashes=h)),
        "WorkerStats": dict(request_active_slots=3, request_total_slots=32,
                            num_requests_waiting=1),
        "KvStats": dict(kv_active_blocks=10, kv_total_blocks=4095,
                        gpu_cache_usage_perc=10 / 4095,
                        gpu_prefix_cache_hit_rate=0.25),
        "SpecDecodeStats": dict(num_spec_tokens=4, num_drafts=9,
                                num_accepted_tokens=20),
        "ForwardPassMetrics": dict(
            worker_id=WORKERS[1],
            worker_stats=dict(request_active_slots=2, request_total_slots=8,
                              num_requests_waiting=0),
            kv_stats=dict(kv_active_blocks=5, kv_total_blocks=63,
                          gpu_cache_usage_perc=5 / 63,
                          gpu_prefix_cache_hit_rate=0.0)),
        "KvInventoryDigest": _digests(None, rng, 1)[0],
    }[name]


def _build(mod, name, fields):
    if name == "RouterEvent":
        return mod.RouterEvent(worker_id=fields["worker_id"],
                               event=mod.KvCacheEvent(**fields["event"]))
    if name == "ForwardPassMetrics":
        return mod.ForwardPassMetrics(
            worker_id=fields["worker_id"],
            worker_stats=mod.WorkerStats(**fields["worker_stats"]),
            kv_stats=mod.KvStats(**fields["kv_stats"]))
    return getattr(mod, name)(**fields)


def _jax_wire(obj) -> dict:
    return obj.to_wire() if hasattr(obj, "to_wire") else obj.model_dump()


def _jax_read(cls, data: dict):
    return (cls.from_wire(data) if hasattr(cls, "from_wire")
            else cls.model_validate(data))


PROTOCOLS = ["KvStoredBlock", "KvCacheEvent", "RouterEvent", "WorkerStats",
             "KvStats", "SpecDecodeStats", "ForwardPassMetrics",
             "KvInventoryDigest"]


@pytest.mark.parametrize("name", PROTOCOLS)
@pytest.mark.parametrize("seed", [0, 1])
def test_wire_dicts_equal(name, seed):
    fields = _fields(name, np.random.default_rng(seed))
    ref, port = _build(jproto, name, fields), _build(tproto, name, fields)
    wire = port.to_wire()
    assert wire == _jax_wire(ref)
    assert list(wire) == list(_jax_wire(ref))  # the same key order
    # Each side reads the other's dicts, unknown keys ignored.
    extra = dict(_jax_wire(ref), future_key=1)
    assert getattr(tproto, name).from_wire(extra) == port
    assert _jax_wire(_jax_read(getattr(jproto, name), dict(
        wire, future_key=1))) == _jax_wire(ref)


def test_wire_defaults_and_none_fields():
    """Defaults and None fields: pydantic's model_dump keeps them except
    where the reference drops them (ForwardPassMetrics: exclude_none)."""
    for name in PROTOCOLS:
        if name in ("KvStoredBlock", "KvCacheEvent", "RouterEvent"):
            continue
        assert getattr(tproto, name)().to_wire() == \
            _jax_wire(getattr(jproto, name)())
    m_t = tproto.ForwardPassMetrics(
        worker_stats=tproto.WorkerStats(data_parallel_rank=2),
        spec_decode_stats=tproto.SpecDecodeStats(num_drafts=1))
    m_j = jproto.ForwardPassMetrics(
        worker_stats=jproto.WorkerStats(data_parallel_rank=2),
        spec_decode_stats=jproto.SpecDecodeStats(num_drafts=1))
    assert m_t.to_wire() == m_j.to_wire()
    assert tproto.ForwardPassMetrics.from_wire(m_j.to_wire()) == m_t
    assert tproto.KvCacheEvent.cleared(4).to_wire() == \
        jproto.KvCacheEvent.cleared(4).model_dump()
    # pydantic reads an int sent for a float field as a float.
    d = tproto.KvInventoryDigest.from_wire({"ts": 5, "blocks": 2})
    assert d.ts == 5.0 and isinstance(d.ts, float)
    assert d.to_wire() == jproto.KvInventoryDigest.from_wire(
        {"ts": 5, "blocks": 2}).to_wire()


def test_subjects_and_exports():
    for fn in ("kv_events_subject", "load_metrics_subject",
               "router_sync_subject", "kv_inventory_subject"):
        assert getattr(tproto, fn)("ns", "gpu") == \
            getattr(jproto, fn)("ns", "gpu")
    assert tproto.SKETCH_K == jproto.SKETCH_K
    assert sorted(tkr.__all__) == sorted(jkr.__all__)
    for name in tkr.__all__:
        assert hasattr(tkr, name)
