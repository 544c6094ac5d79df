"""KV tiers (G2 host DRAM, G3 disk) and the KVBM policy of the port, held
against the JAX package's.

- ``HostKVCache``/``DiskKVCache``: the same random op sequences (puts,
  promotions, gets) through both packages give equal ``stats()``, equal
  gets bit for bit and the same LRU order of both tiers, on bf16 and
  packed int8 blocks.
- A G3 directory either package wrote is read by the other bit for bit:
  the same file names and the same file bytes.
- ``KvBlockManager`` over both packages' allocators and tiers, the same
  scenario each: hysteresis, a pinned block never demoted, active pages
  never demoted, promote-on-hit order, and ``status()`` consistent with the
  tiers' stats; ``KvbmPolicy``'s default high watermark and its inversion
  check; ``EngineConfig.kvbm_policy`` with its DTPU_KV_WATERMARKS override.
- The engines: the same sequential traffic through ``TPUEngine`` and
  ``GPUEngine`` (G2 with G3 behind it; bf16 and int8 pools) gives equal
  allocator, tier, reuse and KVBM counters and digests; without tiers the
  port's engine extracts nothing and reports G1 only. The first token of every replayed prompt, computed over
  onboarded pages, has the JAX engine's top-5 logprobs within the
  tolerance of ``test_torch_history.py`` (atol 0.1, rtol 0.05); greedy
  ids are compared only at clear margins (a top-2 gap over 0.2).
- The watermark sweep in a running engine demotes and leaves the pool at
  or above its low watermark, and an onboarded page holds the bytes its
  block had before it was evicted.
- Flush before every write: the runner's KV-writing entry points, wrapped,
  find the evict buffer empty at every call, across prefill, chunked
  prefill, window growth, spec windows, injected admission and onboarding.
"""

import asyncio
import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from conftest import async_test

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import kv_cache as jkv
from dynamo_tpu.engine import kv_host_cache as jhc
from dynamo_tpu.engine import kvbm as jkvbm
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.engine import TPUEngine
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.runtime.context import Context as JContext
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import kv_cache as tkv
from dynamo_tpu_torch.engine import kv_host_cache as thc
from dynamo_tpu_torch.engine import kvbm as tkvbm
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.engine.kv_quant import BF16
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.llm.tokens import compute_block_hashes
from dynamo_tpu_torch.runtime.context import Context as TContext

torch.set_num_threads(1)

TOL = dict(atol=0.1, rtol=0.05)
SPEC_J = jcfg.PRESETS["tiny-test"]
SPEC_T = tcfg.PRESETS["tiny-test"]
ENGINE_KW = dict(page_size=16, num_pages=20, max_pages_per_seq=16,
                 max_num_seqs=4, prefill_buckets=(32, 64, 128, 256),
                 max_prefill_tokens=64, decode_window=4, pipeline_depth=2)
# 11 usable pages: 70-token prompts register 4 blocks each and evict.
TRAFFIC_KW = dict(ENGINE_KW, num_pages=12)
PORT_ONLY = ("spill_failures", "onboard_failures")


# -- host and disk tiers -------------------------------------------------------

def _blocks(rng, n: int, packed: bool) -> dict[int, np.ndarray]:
    """n blocks under distinct 64-bit hashes: packed int8 parcels (uint8)
    or bf16 bits (uint16)."""
    out = {}
    while len(out) < n:
        h = int(rng.integers(0, 2**63)) * 2 + int(rng.integers(0, 2))
        shape = (2, 2, 1, 4, 12) if packed else (2, 2, 1, 4, 8)
        out[h] = (rng.integers(0, 256, shape, dtype=np.uint8) if packed
                  else rng.integers(0, 2**16, shape, dtype=np.uint16))
    return out


def _as(pkg: str, bits: np.ndarray) -> np.ndarray:
    """A block as the package holds it: the JAX package's bf16 is
    ml_dtypes', the port's uint16 bits (``kv_quant.BF16``)."""
    if bits.dtype == np.uint16 and pkg == "jax":
        return bits.view(ml_dtypes.bfloat16)
    return bits


def _bits(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr).view(np.uint8)


def _tiers(tmp_path, host_cap: int, disk_cap: int | None) -> dict:
    out = {}
    for pkg, mod in (("jax", jhc), ("port", thc)):
        disk = (mod.DiskKVCache(str(tmp_path / pkg), disk_cap)
                if disk_cap else None)
        out[pkg] = mod.HostKVCache(host_cap, disk)
    return out


@pytest.mark.parametrize("host_cap,disk_cap,packed,seed", [
    (6, None, False, 0), (6, 12, False, 1), (4, 10, True, 2),
    (1, 3, False, 3), (16, 64, True, 4)],
    ids=["g2", "g2-g3", "g2-g3-int8", "tiny", "roomy-int8"])
def test_tier_op_sequences_match_reference(tmp_path, host_cap, disk_cap,
                                           packed, seed):
    rng = np.random.default_rng(seed)
    blocks = _blocks(rng, 24, packed)
    keys = list(blocks)
    tiers = _tiers(tmp_path, host_cap, disk_cap)
    for _ in range(300):
        op = rng.choice(["put", "get", "promote"], p=[0.45, 0.45, 0.1])
        h = keys[int(rng.integers(len(keys)))]
        got = {}
        for pkg, cache in tiers.items():
            if op == "get":
                got[pkg] = cache.get(h)
            else:
                cache.put(h, _as(pkg, blocks[h]), promotion=op == "promote")
        if op == "get":
            assert (got["jax"] is None) == (got["port"] is None)
            if got["port"] is not None:
                assert got["port"].dtype in (np.uint8, BF16)
                assert np.array_equal(_bits(got["jax"]), _bits(got["port"]))
                assert np.array_equal(_bits(got["port"]), _bits(blocks[h]))
        j, t = tiers["jax"], tiers["port"]
        assert t.stats() == j.stats()
        assert t.block_hashes() == j.block_hashes()
        assert t.block_hashes(3) == j.block_hashes(3)
        if disk_cap:
            assert list(t.disk._index) == list(j.disk._index)
            assert t.disk.hashes() == list(j.disk._index)
            assert (h in t.disk) == (h in j.disk)
    for cache in tiers.values():
        cache.clear()
    assert tiers["port"].stats() == tiers["jax"].stats()
    if disk_cap:
        assert not list((tmp_path / "port").iterdir())


def test_host_tier_owns_its_entries():
    """A block put from a view keeps no reference to the view's base (a
    spilled block is a view of its flush's page-locked buffer)."""
    base = np.arange(2 * 2 * 1 * 3 * 4 * 8, dtype=np.uint16).reshape(
        2, 2, 1, 3, 4, 8)
    cache = thc.HostKVCache(4)
    cache.put(7, base[:, :, :, 1])
    entry = cache.get(7)
    assert entry.base is None and entry.flags["C_CONTIGUOUS"]
    base[:] = 0
    assert entry.any()


def test_tier_counters_hold_under_concurrent_threads(tmp_path):
    """The engine thread and the plane's connection threads share the
    tiers: with more threads than cores and a short switch interval, no
    count is lost: every get is one hit or one miss."""
    import sys
    import threading
    rng = np.random.default_rng(11)
    blocks = _blocks(rng, 48, False)
    keys = list(blocks)
    cache = thc.HostKVCache(8, thc.DiskKVCache(str(tmp_path), 1024))
    gets = [0] * 12

    def work(i):
        r = np.random.default_rng(i)
        for _ in range(150):
            h = keys[int(r.integers(len(keys)))]
            if r.random() < 0.5:
                cache.put(h, blocks[h])
            else:
                gets[i] += 1
                got = cache.get(h)
                assert got is None or np.array_equal(got, blocks[h])
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(gets))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    st = cache.stats()
    disk = cache.disk
    # Each get counts once: a DRAM hit, a disk hit (counted by both tiers)
    # or a miss in both.
    assert st["g2_hits"] + st["g2_misses"] == sum(gets)
    assert disk.hits + disk.misses == sum(gets) - (st["g2_hits"] - disk.hits)
    # A promotion inserts only when no other thread put the block first.
    assert st["g2_spills_in"] <= st["g2_puts"] <= \
        st["g2_spills_in"] + disk.hits


@pytest.mark.parametrize("packed", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_disk_directory_reads_bit_for_bit_across_packages(tmp_path, writer,
                                                          packed):
    rng = np.random.default_rng(7)
    blocks = _blocks(rng, 6, packed)
    reader = "port" if writer == "jax" else "jax"
    mods = {"jax": jhc, "port": thc}
    for pkg in ("jax", "port"):
        disk = mods[pkg].DiskKVCache(str(tmp_path / pkg), 16)
        for h, bits in blocks.items():
            disk.put(h, _as(pkg, bits))
    # The same names and the same bytes from both packages.
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(f"{h & (2**64 - 1):016x}.npy" for h in blocks)
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes()
    # The other package reopens the writer's directory.
    disk = mods[reader].DiskKVCache(str(tmp_path / writer), 16)
    assert sorted(disk._index) == sorted(blocks)
    for h, bits in blocks.items():
        got = disk.get(h)
        want_dtype = (np.uint8 if packed else
                      (BF16 if reader == "port" else ml_dtypes.bfloat16))
        assert got.dtype == want_dtype
        assert np.array_equal(_bits(got), _bits(bits))


# -- KVBM ---------------------------------------------------------------------

def _kvbm_pair(num_pages: int, host_cap: int, policy: dict,
               tmp_path=None, disk_cap: int = 0) -> dict:
    """Per package: (allocator, host cache, manager). The evict hook
    offloads the block at once (the engine's spill, without a device)."""
    out = {}
    mods = {"jax": (jkv, jhc, jkvbm), "port": (tkv, thc, tkvbm)}
    for pkg, (kv, hc, bm) in mods.items():
        alloc = kv.PageAllocator(num_pages, 16)
        disk = (hc.DiskKVCache(str(tmp_path / pkg), disk_cap)
                if disk_cap else None)
        host = hc.HostKVCache(host_cap, disk)
        manager = bm.KvBlockManager(alloc, host, bm.KvbmPolicy(**policy))
        alloc.evict_hook = (lambda h, p, m=manager, pk=pkg:
                            m.offload(h, _as(pk, _payload(h))))
        out[pkg] = (alloc, host, manager)
    return out


def _payload(h: int) -> np.ndarray:
    return np.full((2, 1, 1, 4, 8), h % 65521, np.uint16)


def _fill(pair, hashes: list[int], release=True) -> dict:
    """Allocate one page per hash, register it, release it (inactive, in
    this order: the first is the LRU) unless ``release`` is False."""
    pages = {}
    for pkg, (alloc, _, _) in pair.items():
        got = alloc.allocate(len(hashes))
        for p, h in zip(got, hashes):
            alloc.register(p, h)
        if release:
            alloc.release(got)
        pages[pkg] = got
    return pages


def _same(pair) -> None:
    (ja, jh, jm), (ta, th, tm) = pair["jax"], pair["port"]
    assert tm.status() == jm.status()
    assert ta.stats() == ja.stats()
    assert list(ta.inactive) == list(ja.inactive)
    assert sorted(ta.free) == sorted(ja.free)
    assert th.stats() == jh.stats()
    assert th.block_hashes() == jh.block_hashes()
    assert ta.drain_events() == ja.drain_events()


def _sweep(pair) -> list[int]:
    took = [m.maintain() for _, _, m in pair.values()]
    assert took[0] == took[1]
    _same(pair)
    return took[1]


def _scenario_hysteresis(pair, _tmp):
    """Below low the sweep demotes toward high, at most the sweep budget
    at a time, and stops once at or above low; nothing below."""
    _fill(pair, list(range(100, 130)))
    taken = [_sweep(pair) for _ in range(4)]
    assert taken[0] > 0 and taken[-1] == 0
    alloc, _, manager = pair["port"]
    assert manager.free_fraction() >= manager.policy.low_watermark


def _scenario_pinned(pair, _tmp):
    """Pinned inactive blocks are skipped and counted."""
    hashes = list(range(200, 230))
    for _, _, m in pair.values():
        m.pin(hashes[:26])
    _fill(pair, hashes)
    for _ in range(3):
        _sweep(pair)
    alloc, _, manager = pair["port"]
    assert all(h in alloc.cached for h in hashes[:26])
    assert manager.pinned_skips > 0
    for _, _, m in pair.values():
        m.unpin(hashes[:6])
    assert _sweep(pair) > 0


def _scenario_active(pair, _tmp):
    """Active pages (held by a sequence) are never demoted."""
    _fill(pair, list(range(300, 318)))
    _fill(pair, list(range(318, 330)), release=False)
    for _ in range(3):
        _sweep(pair)
    alloc = pair["port"][0]
    assert all(h in alloc.cached for h in range(318, 330))


def _scenario_promote(pair, _tmp):
    """Demoted blocks spill through the host tier to disk; the tier walk
    reads them back in order, promoting disk hits to DRAM."""
    hashes = list(range(400, 430))
    _fill(pair, hashes)
    for _ in range(3):
        _sweep(pair)
    walks = {}
    for pkg, (_, _, m) in pair.items():
        walks[pkg] = m.onboard_walk(hashes, 0, 6)
        m.note_promoted(len(walks[pkg][0]), 0)
    assert [h for h, _ in walks["port"][0]] == [h for h, _ in walks["jax"][0]]
    assert len(walks["port"][0]) == 6 and walks["port"][1] == 0
    for (hj, kj), (ht, kt) in zip(walks["jax"][0], walks["port"][0]):
        assert np.array_equal(_bits(kj), _bits(kt))
    _same(pair)
    # A walk past what the tiers hold ends short: a recompute fallback.
    for _, _, m in pair.values():
        m.onboard_walk([1, 2, 3], 0, 3)
    _same(pair)


def _scenario_status(pair, _tmp):
    """status() agrees with the tiers' own stats."""
    _fill(pair, list(range(500, 530)))
    _sweep(pair)
    alloc, host, manager = pair["port"]
    st = manager.status()
    hs = host.stats()
    assert st["tiers"]["g1"] == {"blocks": len(alloc.cached),
                                 "pages_free": len(alloc.free),
                                 "pages_inactive": len(alloc.inactive),
                                 "capacity": alloc.num_pages}
    assert st["tiers"]["g2"] == {"blocks": hs["g2_blocks"],
                                 "capacity": hs["g2_capacity"]}
    assert st["tiers"]["g3"] == {"blocks": hs["g3_blocks"],
                                 "capacity": hs["g3_capacity"]}
    assert st["watermark_demotions"] == alloc.demoted_blocks
    assert hs["g2_spills_in"] == alloc.demoted_blocks


@pytest.mark.parametrize("scenario,policy", [
    (_scenario_hysteresis, dict(low_watermark=0.25, high_watermark=0.5)),
    (_scenario_pinned, dict(low_watermark=0.3, high_watermark=0.6,
                            max_demotions_per_sweep=4)),
    (_scenario_active, dict(low_watermark=0.4)),
    (_scenario_promote, dict(low_watermark=0.3, high_watermark=0.7)),
    (_scenario_status, dict(low_watermark=0.2, high_watermark=0.3)),
], ids=["hysteresis", "pinned", "active", "promote-on-hit", "status"])
def test_kvbm_scenarios_match_reference(tmp_path, scenario, policy):
    pair = _kvbm_pair(32, 6, policy, tmp_path, disk_cap=64)
    _same(pair)
    scenario(pair, tmp_path)


@pytest.mark.parametrize("kw", [
    dict(), dict(low_watermark=0.2), dict(low_watermark=0.97),
    dict(low_watermark=0.2, high_watermark=0.3),
    dict(low_watermark=0.3, high_watermark=0.2)],
    ids=["off", "low-only", "low-near-1", "both", "inverted"])
def test_kvbm_policy_matches_reference(kw):
    try:
        want = dataclasses.asdict(jkvbm.KvbmPolicy(**kw))
    except ValueError as exc:
        with pytest.raises(ValueError, match="inverted") as got:
            tkvbm.KvbmPolicy(**kw)
        assert str(got.value) == str(exc)
        return
    assert dataclasses.asdict(tkvbm.KvbmPolicy(**kw)) == want


@pytest.mark.parametrize("env", [None, "0.1,0.4", "0.25", "0.1 0.2"])
def test_kvbm_policy_of_the_config_matches_reference(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("DTPU_KV_WATERMARKS", raising=False)
    else:
        monkeypatch.setenv("DTPU_KV_WATERMARKS", env)
    kw = dict(kv_demote_low_watermark=0.2, kv_demote_high_watermark=0.3)
    want = jcfg.EngineConfig(model=SPEC_J, **kw).kvbm_policy()
    got = tcfg.EngineConfig(model=SPEC_T, device="cpu", **kw).kvbm_policy()
    assert (got.low_watermark, got.high_watermark) == (
        want.low_watermark, want.high_watermark)


# -- engines -------------------------------------------------------------------

@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_params(SPEC_J, jax.random.key(42))


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.default_rng(seed).integers(0, SPEC_T.vocab_size,
                                                n).tolist()


def _request(prompt, max_tokens=4, logprobs=5) -> dict:
    return {"model": "tiny-test", "token_ids": list(prompt),
            "stop_conditions": {"max_tokens": max_tokens,
                                "ignore_eos": True},
            "sampling_options": {"logprobs": logprobs}}


async def _serve_one(engine, request) -> list[dict]:
    if isinstance(engine, TPUEngine):
        it = engine.generate(JRequest.from_wire(request), JContext())
    else:
        it = engine.generate(request, TContext())
    return [item async for item in it]


async def _quiesce(engine) -> None:
    """No live slot, no deferred release, no spill in flight."""
    for _ in range(1000):
        if (all(r is None for r in engine.slot_req)
                and not engine._pending_release and not engine._inflight
                and not engine._pending_spills
                and not engine._evict_buffer):
            return
        await asyncio.sleep(0.005)
    raise AssertionError("engine never went quiet")


def _first_top(items: list[dict]) -> list[float]:
    """The first generated token's top-5 logprob values, sorted."""
    return sorted((x["logprob"] for x in items[0]["top_log_probs"][0]),
                  reverse=True)


async def _traffic(engine) -> list[list[dict]]:
    """Five 70-token prompts one after another, then the first two again:
    the 11-page pool (TRAFFIC_KW) evicts every block of the first two
    before their replays, which find them in the tiers (when there are
    any)."""
    prompts = [_prompt(40 + i, 70) for i in range(5)]
    out = []
    for p in prompts + prompts[:2]:
        out.append(await _serve_one(engine, _request(p)))
        await _quiesce(engine)
    return out


def _engines(jparams, quant_kv, tiers: dict, tmp_path):
    kw = dict(TRAFFIC_KW, quant_kv=quant_kv, **tiers)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("kv_disk_cache_dir"):
        jkw["kv_disk_cache_dir"] = str(tmp_path / "jax")
        tkw["kv_disk_cache_dir"] = str(tmp_path / "port")
    jeng = TPUEngine(jcfg.EngineConfig(model=SPEC_J, attention_backend="xla",
                                       **jkw), params=jparams)
    teng = GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu", **tkw),
                     params=params_from_jax(jax.tree.map(np.asarray, jparams),
                                            SPEC_T, device="cpu"))
    return jeng, teng


@pytest.mark.parametrize("quant_kv", [None, "int8"], ids=["bf16", "int8"])
@async_test(timeout=300)
async def test_engine_tier_counters_match_reference(jparams, tmp_path,
                                                    quant_kv):
    """G2 of 4 pages with G3 behind it."""
    tiers = dict(host_cache_pages=4, kv_disk_cache_dir=True,
                 disk_cache_pages=64)
    jeng, teng = _engines(jparams, quant_kv, tiers, tmp_path)
    try:
        got = {"jax": await _traffic(jeng), "port": await _traffic(teng)}
        js, ts = jeng.kv_status(), teng.kv_status()
        for key in ("allocator", "tiers", "reuse", "digest"):
            assert ts[key] == js[key], key
        tkvbm_status = dict(ts["kvbm"])
        assert {k: tkvbm_status.pop(k) for k in PORT_ONLY} == dict.fromkeys(
            PORT_ONLY, 0)
        assert tkvbm_status == js["kvbm"]
        # Every replay onboarded its allowed blocks, (70 - 1) // 16, some
        # of them read back from G3.
        reuse = ts["reuse"]
        assert reuse["onboard_blocks_host"] == 2 * 4, reuse
        assert reuse["prefix_hit_blocks"] == 0, reuse
        assert ts["tiers"]["g3_hits"] > 0
        assert set(ts["digest"]["tier_blocks"]) == {"g1", "g2", "g3"}
        # The replays' first tokens, over onboarded pages in both engines.
        for j_items, t_items in zip(got["jax"][5:], got["port"][5:]):
            jt, tt = _first_top(j_items), _first_top(t_items)
            np.testing.assert_allclose(tt, jt, **TOL)
            if jt[0] - jt[1] > 0.2:
                assert t_items[0]["token_ids"][0] == \
                    j_items[0]["token_ids"][0]
    finally:
        jeng.stop()
        teng.stop()


@async_test(timeout=60)
async def test_engine_without_tiers_is_inert():
    """No tier configured: no evict hook, no extract, no onboarding; the
    status reports G1 only."""
    engine = GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                         **TRAFFIC_KW), seed=0)
    extracts = []
    inner = engine.runner.extract_pages_async
    engine.runner.extract_pages_async = lambda pages: (
        extracts.append(pages), inner(pages))[1]
    try:
        await _traffic(engine)
        status = engine.kv_status()
        assert engine.host_cache is None
        assert engine.allocator.evict_hook is None
        assert engine.allocator.stats()["evicted_blocks"] > 0
        assert extracts == [] and engine._pending_spills == []
        assert status["tiers"] == {} and status["remote"] is None
        assert status["reuse"]["onboard_blocks_host"] == 0
        assert set(status["kvbm"]["tiers"]) == {"g1"}
        assert status["kvbm"]["watermark_demotions"] == 0
        assert status["digest"]["tier_blocks"] == {
            "g1": engine.allocator.stats()["cached_blocks"]}
    finally:
        engine.stop()


def _pool_bytes(engine, pages: list[int]) -> list[np.ndarray]:
    """The port pool's bytes at ``pages`` (values, and scales if int8)."""
    from dynamo_tpu_torch.engine.kv_quant import QuantKV
    runner, out = engine.runner, []
    idx = torch.tensor(pages)
    for cache in (runner.k_cache, runner.v_cache):
        for t in (cache if isinstance(cache, QuantKV) else (cache,)):
            t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            out.append(t[:, :, idx].clone().numpy())
    return out


@pytest.mark.parametrize("quant_kv", [None, "int8"], ids=["bf16", "int8"])
@async_test(timeout=120)
async def test_watermark_sweep_and_bit_identical_onboarding(tmp_path,
                                                            quant_kv):
    """A running engine's sweep demotes below its low watermark and leaves
    the pool at or above it; a block evicted through the tiers comes back
    into the pool with its bytes."""
    cfg = tcfg.EngineConfig(model=SPEC_T, device="cpu", quant_kv=quant_kv,
                            host_cache_pages=4,
                            kv_disk_cache_dir=str(tmp_path),
                            disk_cache_pages=64,
                            kv_demote_low_watermark=0.3,
                            kv_demote_high_watermark=0.5, **ENGINE_KW)
    engine = GPUEngine(cfg, seed=0)
    first = _prompt(60, 70)
    hashes = compute_block_hashes(first, 16)[:4]
    try:
        await _serve_one(engine, _request(first, logprobs=None))
        await _quiesce(engine)
        before = _pool_bytes(engine, engine.allocator.lookup(hashes))
        for i in range(4):
            await _serve_one(engine, _request(_prompt(61 + i, 70),
                                              logprobs=None))
            await _quiesce(engine)
        assert engine.kvbm.watermark_demotions > 0
        assert engine.kvbm.free_fraction() >= 0.3
        assert not engine.allocator.lookup(hashes)
        onboard0 = engine.onboard_blocks
        await _serve_one(engine, _request(first, logprobs=None))
        await _quiesce(engine)
        assert engine.onboard_blocks - onboard0 == 4
        after = _pool_bytes(engine, engine.allocator.lookup(hashes))
        for x, y in zip(before, after):
            assert np.array_equal(x, y)
        status = engine.kv_status()["kvbm"]
        assert (status["spill_failures"], status["onboard_failures"],
                status["peer_pull_failures"]) == (0, 0, 0)
    finally:
        engine.stop()


# -- flush before every write -------------------------------------------------

WRITERS = ("prefill_batch", "prefill_chunk_async", "decode_window",
           "decode_spec_window", "insert_pages")


def _guard(engine) -> tuple[dict, dict]:
    """Wrap the runner's KV-writing entry points: each call asserts that
    no evicted page waits for its extract. Returns the calls per entry,
    and per entry the calls that came right after a flush that extracted
    something (so the guard was tested)."""
    calls = dict.fromkeys(WRITERS, 0)
    after_flush = dict.fromkeys(WRITERS, 0)
    flushed = [False]
    flush = engine._flush_spills

    def flush_spills():
        flushed[0] = flushed[0] or bool(engine._evict_buffer)
        flush()
    engine._flush_spills = flush_spills
    runner = engine.runner
    for name in WRITERS:
        inner = getattr(runner, name)

        def wrapped(*args, _inner=inner, _name=name, **kw):
            assert engine._evict_buffer == [], (
                f"{_name} called with unflushed evictions "
                f"{engine._evict_buffer}")
            calls[_name] += 1
            after_flush[_name] += flushed[0]
            flushed[0] = False
            return _inner(*args, **kw)
        setattr(runner, name, wrapped)
    return calls, after_flush


async def _collect(items) -> list[dict]:
    return [item async for item in items]


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@async_test(timeout=120)
async def test_evict_buffer_is_empty_at_every_kv_write(tmp_path, spec):
    """Two rounds: a remotely prefilled request (injected admission), then
    five prompts at once (one long enough to prefill in chunks) whose
    windows grow their page tables; in the second round the pool is full
    of the first's inactive blocks, so every path allocates by evicting,
    and the replays onboard. Then one replay with every free page held,
    so its onboarding evicts too."""
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
    kw = dict(ENGINE_KW, host_cache_pages=8, kv_disk_cache_dir=str(tmp_path),
              disk_cache_pages=64)
    if spec:
        # With the sweep on, which frees pages ahead of demand.
        kw.update(spec_decode="ngram", spec_k=3, decode_window=8,
                  kv_demote_low_watermark=0.2, kv_demote_high_watermark=0.4)
    engine = GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu", **kw),
                       seed=0)
    source = GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                         **ENGINE_KW), seed=0)
    calls, after_flush = _guard(engine)
    try:
        injected = _prompt(70, 150)
        first, parcel, _ = await source.run_job(
            lambda: source.prefill_extract(PreprocessedRequest.from_wire(
                _request(injected, logprobs=None))))
        prompts = [_prompt(71 + i, n) for i, n in
                   enumerate((70, 150, 40, 70, 60))]
        for _ in range(2):
            out = await _collect(engine.generate_injected(
                _request(injected, max_tokens=8, logprobs=None), TContext(),
                first, parcel))
            assert out[-1]["finish_reason"] == "length"
            await _quiesce(engine)
            for out in await asyncio.gather(*[
                    _serve_one(engine, _request(p, max_tokens=24,
                                                logprobs=None))
                    for p in prompts]):
                assert out[-1]["finish_reason"] == "length"
            await _quiesce(engine)
        # A replay while every free page is held: its onboarding allocates
        # by evicting.
        assert not engine.allocator.lookup(
            compute_block_hashes(prompts[0], 16)[:1])
        held = await engine.run_job(
            lambda: engine.allocator.allocate(len(engine.allocator.free)))
        uploads = after_flush["insert_pages"]
        onboard0 = engine.onboard_blocks
        await _serve_one(engine, _request(prompts[0], logprobs=None))
        await _quiesce(engine)
        await engine.run_job(lambda: engine.allocator.release(held))
        assert engine.onboard_blocks - onboard0 == 4
        assert after_flush["insert_pages"] > uploads
        assert engine.injected_admissions == 2
        assert engine.chunk_dispatch_count > 0
        assert engine.onboard_blocks > 0
        assert engine.host_cache.stats()["g2_spills_in"] > 0
        window = "decode_spec_window" if spec else "decode_window"
        for name in ("prefill_batch", "prefill_chunk_async", window,
                     "insert_pages"):
            assert calls[name] > 0, calls
        for name in ("prefill_batch", window, "insert_pages"):
            assert after_flush[name] > 0, after_flush
    finally:
        engine.stop()
        source.stop()
