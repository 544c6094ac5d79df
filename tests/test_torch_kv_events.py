"""KV events and load metrics of the port's engine, held against the JAX
package's.

- ``PageAllocator``: the port's and the JAX one run the same seeded
  sequences of allocate (with LRU eviction), register (new, replaced and
  duplicate hashes), release, acquire_cached, unregister and
  clear_inactive. Every call returns the same, and ``drain_events()`` and
  ``stats()`` are equal after every operation.
- A tiny-test ``GPUEngine`` on the CPU and a JAX ``TPUEngine`` on the same
  weights serve the same requests one after the other (prefix hits, a
  pool small enough to evict, ``clear_kv_blocks``) with stub publishers:
  the multisets of stored and removed block hashes, the
  ``ForwardPassMetrics`` each builds at quiescence, and
  ``inventory_digest()`` are equal.
"""

import asyncio
import collections

import jax
import numpy as np
import pytest
import torch
from conftest import async_test

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import kv_cache as jkv
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.engine import TPUEngine
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.runtime.context import Context as JContext
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import kv_cache as tkv
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.llm.kv_router.protocols import kmin_sketch
from dynamo_tpu_torch.llm.tokens import compute_block_hashes
from dynamo_tpu_torch.runtime.context import Context as TContext

torch.set_num_threads(1)

SPEC_J = jcfg.PRESETS["tiny-test"]
SPEC_T = tcfg.PRESETS["tiny-test"]
PAGE = 16


def _chain(rng, n):
    return [int(h) for h in rng.integers(0, 2**62, n, dtype=np.int64)]


def _step(alloc, op, args):
    """Apply one operation; returns what it returned and the events and
    stats after it."""
    out = getattr(alloc, op)(*args)
    return out, alloc.drain_events(), alloc.stats()


@pytest.mark.parametrize("seed", range(8))
def test_allocator_events_and_stats_equal(seed):
    rng = np.random.default_rng(seed)
    pools = int(rng.choice([9, 17, 40]))
    ref, port = jkv.PageAllocator(pools, PAGE), tkv.PageAllocator(pools, PAGE)
    chains = [_chain(rng, 8) for _ in range(3)]
    chains += [c[:3] + _chain(rng, 5) for c in chains]
    live: list[list[int]] = []  # page lists of live "sequences"

    def both(op, *args):
        got, want = _step(port, op, args), _step(ref, op, args)
        assert got == want, (op, args)
        return got[0]

    for _ in range(250):
        roll = rng.random()
        if roll < 0.35:
            chain = chains[rng.integers(len(chains))]
            n = int(rng.integers(1, len(chain) + 1))
            cached = both("acquire_cached", chain[:n])
            fresh = both("allocate", n - len(cached))
            if fresh is None:
                both("release", cached)
                continue
            pages = cached + fresh
            for page, h in zip(pages[len(cached):], chain[len(cached):n]):
                both("register", page, h)
            live.append(pages)
        elif roll < 0.6 and live:
            both("release", live.pop(int(rng.integers(len(live)))))
        elif roll < 0.68 and live:
            pages = live.pop(int(rng.integers(len(live))))
            both("unregister", pages)
            both("release", pages)
        elif roll < 0.78 and live:
            # A replaced registration, or a block another page holds.
            pages = live[int(rng.integers(len(live)))]
            page = pages[int(rng.integers(len(pages)))]
            h = (chains[rng.integers(len(chains))][0] if rng.random() < 0.5
                 else _chain(rng, 1)[0])
            both("register", page, h)
        elif roll < 0.85:
            both("clear_inactive")
        else:
            both("allocate", int(rng.integers(0, 4)))
        assert port.num_free == ref.num_free
        assert port.lookup(chains[0]) == ref.lookup(chains[0])
    assert port.stats()["evicted_blocks"] + port.stats()["cleared_blocks"] > 0


class _StubKv:
    def __init__(self):
        self.stored_hashes = collections.Counter()
        self.removed_hashes = collections.Counter()

    async def stored(self, hashes, parent_hash=None):
        self.stored_hashes.update(hashes)

    async def removed(self, hashes):
        self.removed_hashes.update(hashes)


class _StubMetrics:
    def __init__(self):
        self.seen = []

    async def publish(self, metrics, force=False):
        self.seen.append(metrics)


ENGINE_KW = dict(page_size=PAGE, num_pages=24, max_pages_per_seq=16,
                 max_num_seqs=4, prefill_buckets=(32, 64, 128, 256),
                 max_prefill_tokens=64, decode_window=4, pipeline_depth=2)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(
        0, SPEC_T.vocab_size, n).tolist()


async def _serve(engine, prompts, max_tokens):
    out = []
    for p in prompts:
        req = {"model": "tiny-test", "token_ids": p,
               "stop_conditions": {"max_tokens": max_tokens,
                                   "ignore_eos": True}}
        if isinstance(engine, TPUEngine):
            it = engine.generate(JRequest.from_wire(req), JContext())
        else:
            it = engine.generate(req, TContext())
        out.append([t async for item in it for t in item["token_ids"]])
    return out


async def _quiesce(engine):
    """Wait until no slot is live and every deferred page is released."""
    for _ in range(500):
        if (all(r is None for r in engine.slot_req)
                and not engine._pending_release and not engine._inflight):
            return
        await asyncio.sleep(0.01)
    raise AssertionError("engine never went quiet")


async def _drain_loop():
    for _ in range(5):
        await asyncio.sleep(0.02)


@async_test(timeout=240)
async def test_engine_events_metrics_and_digest_equal():
    jparams = jmodel.init_params(SPEC_J, jax.random.key(42))
    stubs = {k: (_StubKv(), _StubMetrics()) for k in ("jax", "port")}
    jeng = TPUEngine(jcfg.EngineConfig(model=SPEC_J, attention_backend="xla",
                                       **ENGINE_KW), params=jparams,
                     kv_publisher=stubs["jax"][0],
                     metrics_publisher=stubs["jax"][1])
    teng = GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                       **ENGINE_KW),
                     params=params_from_jax(jax.tree.map(np.asarray, jparams),
                                            SPEC_T, device="cpu"),
                     kv_publisher=stubs["port"][0],
                     metrics_publisher=stubs["port"][1])
    jeng.start()
    teng.start()
    assert teng._publish_loop is asyncio.get_running_loop()
    # A 64-token system prefix shared by three prompts, two prompts of
    # their own; the 23-page pool evicts inactive pages on the way. Every
    # prompt is one token short of a block, so the first generated token
    # completes a block (registered as the decode step feeds it) and the
    # later ones, whose greedy choice may split at a near tie between the
    # two stacks, complete none.
    system = _prompt(1, 64)
    prompts = ([system + _prompt(10 + i, 31) for i in range(3)]
               + [_prompt(20, 159), _prompt(21, 127), system + [5] * 47])
    assert all(len(p) % PAGE == PAGE - 1 for p in prompts)
    try:
        tokens = {}
        for name, eng in (("jax", jeng), ("port", teng)):
            tokens[name] = await _serve(eng, prompts, 4)
            await _quiesce(eng)
        assert [t[0] for t in tokens["port"]] == \
            [t[0] for t in tokens["jax"]]
        for name, eng in (("jax", jeng), ("port", teng)):
            await eng.clear_kv_blocks()
            await _quiesce(eng)
            # The metrics each builds at quiescence (every deferred page
            # released), published through the same stub.
            eng._publish()
            await _drain_loop()
        (jkv_pub, jm), (tkv_pub, tm) = stubs["jax"], stubs["port"]
        assert tkv_pub.stored_hashes == jkv_pub.stored_hashes
        assert tkv_pub.removed_hashes == jkv_pub.removed_hashes
        # Every stored block was a complete block of a served sequence.
        want = set()
        for p, toks in zip(prompts, tokens["port"]):
            want |= set(compute_block_hashes(p + toks[:-1], PAGE))
        assert set(tkv_pub.stored_hashes) == want
        # Every stored block left again: evicted, or by the clear.
        assert set(tkv_pub.removed_hashes) == want
        assert tm.seen[-1].to_wire() == jm.seen[-1].to_wire()
        assert tm.seen[-1].kv_stats.gpu_prefix_cache_hit_rate > 0
        assert teng.allocator.stats() == jeng.allocator.stats()
        assert teng.allocator.stats()["evicted_blocks"] > 0
        jd, td = jeng.inventory_digest(), teng.inventory_digest()
        assert td.to_wire() == jd.to_wire()
        assert td.blocks == 0 and td.pages_free == td.pages_total
    finally:
        jeng.stop()
        teng.stop()


@async_test(timeout=240)
async def test_engine_digest_and_kv_status_while_cached():
    jparams = jmodel.init_params(SPEC_J, jax.random.key(42))
    kw = dict(ENGINE_KW, num_pages=64)
    jeng = TPUEngine(jcfg.EngineConfig(model=SPEC_J, attention_backend="xla",
                                       **kw), params=jparams)
    teng = GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu", **kw),
                     params=params_from_jax(jax.tree.map(np.asarray, jparams),
                                            SPEC_T, device="cpu"))
    prompts = [_prompt(30, 70), _prompt(30, 70) + [1, 2, 3], _prompt(31, 33)]
    try:
        tokens = {}
        for name, eng in (("jax", jeng), ("port", teng)):
            tokens[name] = await _serve(eng, prompts, 6)
            await _quiesce(eng)
        # No generated token completes a block here.
        assert [t[0] for t in tokens["port"]] == \
            [t[0] for t in tokens["jax"]]
        jd, td = jeng.inventory_digest(), teng.inventory_digest()
        assert td.to_wire() == jd.to_wire()
        assert td.blocks > 0 and td.tier_blocks == {"g1": td.blocks}
        assert td.sketch == kmin_sketch(teng.allocator.cached)
        js, ts = jeng.kv_status(), teng.kv_status()
        assert set(ts) == set(js)
        for key in ("role", "allocator", "reuse", "digest"):
            assert ts[key] == js[key], key
        assert ts["reuse"]["prefix_hit_blocks"] == 4
        # No publisher: the events drain all the same.
        assert not teng.allocator.stored_events
        assert not teng.allocator.removed_events
    finally:
        jeng.stop()
        teng.stop()
