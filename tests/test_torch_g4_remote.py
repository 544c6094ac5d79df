"""The G4 peer tier of the port: KV blocks pulled from another worker's
host tiers over the KV plane, held against the JAX package's.

- A worker B with no copy of a prompt's blocks onboards them over G4 from
  worker A's host tier, through ``KvPlaneServer(block_provider=...)`` and
  ``RemoteBlockSource``: port A to port B (B without local tiers, and an
  int8 B, whose pool then holds the blocks quantized), JAX A to port B and
  port A to JAX B (bf16 blocks travel labelled "bfloat16", so each package
  reads the other's). B's pages hold A's bytes.
- A dead peer degrades to recompute with its breaker open; a silent and a
  trickling peer cannot hold the consult past its budget; a consult asks
  a peer for what the budget carries at its measured rate.
- The breaker curve (``policies.G4_PEER_BREAKER``) walks as the JAX
  ``RemoteBlockSource``'s over the same failures, skips while open,
  probes after the cooldown, resets on a success and on ``drop_peer``.
- ``backends.gpu`` workers register ``kvplane/{namespace}/{id:x}`` and
  follow each other's puts and deletes through a coordinator; the worker
  process with ``--host-cache-pages``, ``--kv-disk-cache-dir`` and
  ``--kv-watermarks`` serves and reports g2 and g3 in its digest; the
  three worker flags and the two launcher flags parse as the reference's.
"""

import asyncio
import os
import queue
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
from conftest import async_test

from dynamo_tpu import launch as jlaunch
from dynamo_tpu.backends import tpu as jtpu
from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.engine import TPUEngine
from dynamo_tpu.llm import kv_plane as jplane
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.runtime.context import Context as JContext
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.backends import gpu
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.engine.kv_quant import parcel_to_packed
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.llm import kv_plane as tplane
from dynamo_tpu_torch.llm.kv_router.protocols import kv_inventory_subject
from dynamo_tpu_torch.llm.tokens import compute_block_hashes
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.context import Context as TContext
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC_J = jcfg.PRESETS["tiny-test"]
SPEC_T = tcfg.PRESETS["tiny-test"]
KW = dict(page_size=16, num_pages=32, max_pages_per_seq=16, max_num_seqs=4,
          prefill_buckets=(32, 64, 128), max_prefill_tokens=128,
          decode_window=4, pipeline_depth=2)
PROMPT_LEN = 70
ALLOWED = (PROMPT_LEN - 1) // 16


def _prompt(seed: int) -> list[int]:
    return np.random.default_rng(seed).integers(
        0, SPEC_T.vocab_size, PROMPT_LEN).tolist()


def _request(prompt) -> dict:
    return {"model": "tiny-test", "token_ids": list(prompt),
            "stop_conditions": {"max_tokens": 2, "ignore_eos": True}}


async def _serve(engine, prompt) -> list[int]:
    if isinstance(engine, TPUEngine):
        it = engine.generate(JRequest.from_wire(_request(prompt)), JContext())
    else:
        it = engine.generate(_request(prompt), TContext())
    return [t async for item in it for t in item.get("token_ids", [])]


def _bits(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr).view(np.uint8)


async def _stock(engine, prompt) -> np.ndarray:
    """Serve ``prompt`` on ``engine``, then put its allowed blocks, as
    extracted from its pool, into its host tier. Returns that parcel."""
    await _serve(engine, prompt)
    hashes = compute_block_hashes(prompt, 16)[:ALLOWED]

    def job():
        kv = engine.runner.extract_pages(engine.allocator.lookup(hashes))
        for i, h in enumerate(hashes):
            engine.host_cache.put(h, kv[:, :, :, i])
        return kv
    return await engine.run_job(job)


async def _onboarded(engine, prompt) -> np.ndarray:
    """The pool's parcel of ``prompt``'s allowed blocks on ``engine``."""
    hashes = compute_block_hashes(prompt, 16)[:ALLOWED]
    return await engine.run_job(lambda: engine.runner.extract_pages(
        engine.allocator.lookup(hashes)))


@pytest.fixture(scope="module")
def fleet():
    """Engines on the same seed-42 weights: a JAX worker and a port worker
    with host tiers (each A of one direction, B of the other), a port
    worker without tiers and an int8 one; every tiered worker serves its
    host tier on a plane."""
    jparams = jmodel.init_params(SPEC_J, jax.random.key(42))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), SPEC_T,
                              device="cpu")
    tiers = dict(host_cache_pages=16)
    engines = {
        "jax": TPUEngine(jcfg.EngineConfig(
            model=SPEC_J, attention_backend="xla", **tiers, **KW),
            params=jparams),
        "port": GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                            **tiers, **KW), params=tparams),
        "bare": GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                            **KW), params=tparams),
        "int8": GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                            quant_kv="int8", **KW),
                          params=tparams),
    }
    planes = {
        "jax": jplane.KvPlaneServer(
            block_provider=engines["jax"].host_cache.get,
            use_jax_path=False),
        "port": tplane.KvPlaneServer(
            block_provider=engines["port"].host_cache.get),
    }
    for plane in planes.values():
        plane.start()
    yield engines, planes
    for plane in planes.values():
        plane.close()
    for engine in engines.values():
        engine.stop()


@pytest.mark.parametrize("src,dst,seed", [
    ("port", "bare", 1), ("port", "int8", 2), ("jax", "port", 3),
    ("port", "jax", 4)],
    ids=["port-to-port", "port-to-port-int8", "jax-to-port", "port-to-jax"])
@async_test(timeout=120)
async def test_b_onboards_over_g4_from_a(fleet, src, dst, seed):
    engines, planes = fleet
    a, b = engines[src], engines[dst]
    mod = jplane if dst == "jax" else tplane
    b.remote_source = mod.RemoteBlockSource(budget_s=5.0)
    b.remote_source.peers = [planes[src].address]
    prompt = _prompt(seed)
    try:
        parcel = await _stock(a, prompt)
        g4_0, served0 = b.g4_blocks, planes[src].stats()["blocks_served"]
        await _serve(b, prompt)
        assert b.g4_blocks - g4_0 == ALLOWED
        assert planes[src].stats()["blocks_served"] - served0 == ALLOWED
        assert b.kv_status()["reuse"]["onboard_blocks_peer"] == b.g4_blocks
        got = await _onboarded(b, prompt)
        want = parcel_to_packed(_bits(parcel).view(np.uint16)) \
            if dst == "int8" else parcel
        assert np.array_equal(_bits(got), _bits(want))
        if b.host_cache is not None:
            # Peer blocks also land in B's own G2.
            held = set(b.host_cache.block_hashes())
            assert set(compute_block_hashes(prompt, 16)[:ALLOWED]) <= held
    finally:
        b.remote_source.client.close()
        b.remote_source = None


def _dead_addr() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


@async_test(timeout=60)
async def test_dead_peer_degrades_to_recompute(fleet):
    engines, _ = fleet
    b = engines["bare"]
    src = tplane.RemoteBlockSource()
    src.peers = [_dead_addr()]
    b.remote_source = src
    try:
        g4_0 = b.g4_blocks
        tokens = await _serve(b, _prompt(5))
        assert len(tokens) == 2 and b.g4_blocks == g4_0
        stats = src.stats()
        assert (stats["fetch_failures"], stats["breakers_open"]) == (1, 1)
        assert b.kvbm.peer_pull_failures == 0
        assert b.kvbm.recompute_fallbacks > 0
    finally:
        src.client.close()
        b.remote_source = None


class _BadPeer:
    """A peer that reads a ``blocks`` request and then answers nothing
    ("silent"), or a header for 1 MB and then one byte every 10 ms
    ("trickle")."""

    def __init__(self, mode: str):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.addr = f"127.0.0.1:{self.sock.getsockname()[1]}"
        self.mode, self.stop = mode, threading.Event()
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        from dynamo_tpu_torch.runtime.msgpack_lite import packb
        try:
            conn, _ = self.sock.accept()
        except OSError:
            return
        with conn:
            conn.recv(65536)
            if self.mode == "trickle":
                body = packb({"ok": True, "hashes": [1], "shape": [1 << 20],
                              "dtype": "uint8", "nbytes": 1 << 20})
                conn.sendall(struct.pack(">I", len(body)) + body)
                while not self.stop.wait(0.01):
                    try:
                        conn.sendall(b"x")
                    except OSError:
                        return
            else:
                self.stop.wait(5)

    def close(self):
        self.stop.set()
        self.sock.close()


@pytest.mark.parametrize("mode", ["silent", "trickle"])
def test_slow_peer_is_cut_at_the_budget(mode):
    peer = _BadPeer(mode)
    src = tplane.RemoteBlockSource(budget_s=0.2)
    src.peers = [peer.addr]
    try:
        t0 = time.monotonic()
        assert src.fetch([1, 2, 3], 3) == []
        took = time.monotonic() - t0
        assert took < 0.2 + 0.15, took
        stats = src.stats()
        assert (stats["fetch_failures"], stats["slow_peer_cooldowns"],
                stats["breakers_open"]) == (1, 1, 1)
        # While open, the consult skips it without a round trip.
        assert src.fetch([1], 1) == [] and src.breaker_open_skips == 1
    finally:
        src.client.close()
        peer.close()


def test_consult_asks_what_the_budget_carries(monkeypatch):
    """With the pool's block size known, the first ask is what the budget
    carries at FIRST_RATE_BPS; later asks follow the peer's measured
    seconds a block, fixed costs included, so an answer comes to take
    about BUDGET_FILL of the budget, and a slower answer shrinks the next
    ask at once. Every answer is used. With the block size unknown the
    first ask is the whole run, as the reference's."""
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    fixed, per_block = 0.004, [0.003]
    asks = []

    def fetch(addr, hashes, max_blocks, timeout=None):
        asks.append((len(hashes), max_blocks))
        clock[0] += fixed + per_block[0] * max_blocks
        return list(hashes[:max_blocks]), np.zeros((max_blocks, 2), np.uint16)

    run = list(range(100))
    src = tplane.RemoteBlockSource(budget_s=0.1, block_nbytes=1_000_000)
    src.peers = ["127.0.0.1:1"]
    src.client.fetch_blocks_sync = fetch
    got = [len(src.fetch(run, len(run))) for _ in range(8)]
    fill = src.budget_s * src.BUDGET_FILL
    first = int(fill * src.FIRST_RATE_BPS / src.block_nbytes)
    assert asks[0] == (first, first) and got[0] == first
    assert got == [n for _, n in asks]
    assert abs(got[-1] - (fill - fixed) / per_block[0]) <= 1.5, got
    per_block[0] *= 2
    src.fetch(run, len(run))
    assert len(src.fetch(run, len(run))) <= got[-1] // 2 + 1, asks
    stats = src.stats()
    assert (stats["fetch_failures"], stats["slow_peer_cooldowns"]) == (0, 0)
    assert stats["fetched_blocks"] == sum(n for _, n in asks)
    src.drop_peer("127.0.0.1:1")
    src.peers = ["127.0.0.1:1"]
    asks.clear()
    src.fetch(run, len(run))
    assert asks == [(first, first)]  # the peer's rate left with it

    bare = tplane.RemoteBlockSource(budget_s=0.1)
    bare.peers = ["127.0.0.1:1"]
    bare.client.fetch_blocks_sync = fetch
    asks.clear()
    assert len(bare.fetch(run, 60)) == 60 and asks == [(60, 60)]


def test_breaker_curve_matches_reference(monkeypatch):
    """The same consults through both packages' sources, with a clock that
    jumps past each cooldown: the same cooldowns, streaks and stats."""
    offset = [0.0]
    real = time.monotonic
    monkeypatch.setattr(time, "monotonic", lambda: real() + offset[0])
    alive = tplane.KvPlaneServer()
    alive.start()
    dead = _dead_addr()
    sources = {"jax": jplane.RemoteBlockSource(),
               "port": tplane.RemoteBlockSource()}
    keys = ("peers", "fetched_blocks", "fetch_failures",
            "slow_peer_cooldowns", "breaker_open_skips", "breakers_open")
    try:
        for src in sources.values():
            src.peers = [dead, alive.address]
        trace = {name: [] for name in sources}
        for step in range(9):
            for name, src in sources.items():
                assert src.fetch([1, 2], 2) == []
                now = time.monotonic()
                trace[name].append((
                    round(src._cooldown.get(dead, now) - now),
                    src._fail_streak.get(dead, 0),
                    {k: src.stats()[k] for k in keys}))
            if step % 3 == 2:
                offset[0] += 200.0  # past the longest cooldown
            if step == 5:
                for src in sources.values():
                    src.drop_peer(dead)
                    src.peers = [dead, alive.address]
        assert trace["port"] == trace["jax"]
        assert [t[1] for t in trace["port"]] == [1, 1, 1, 2, 2, 2, 1, 1, 1]
        assert trace["port"][3][0] == 10  # 5 s, then doubled
        assert sources["port"].breaker_policy.delay(20) == 120.0
    finally:
        for src in sources.values():
            src.client.close()
        alive.close()


# -- the worker ----------------------------------------------------------------

@async_test(timeout=90)
async def test_workers_register_and_follow_planes():
    """Two workers' planes through a coordinator, as ``backends.gpu`` runs
    them: each registers ``kvplane/{ns}/{id:x}`` under its lease and sees
    the other; a delete drops the peer (breaker state too), a put adds it
    back."""
    rts, engines, planes = [], [], []
    try:
        for i in range(2):
            rt = await (DistributedRuntime.with_embedded_coordinator(
                RuntimeConfig()) if not rts else
                DistributedRuntime.from_settings(RuntimeConfig(
                    coordinator_url=rts[0].config.coordinator_url)))
            rts.append(rt)
            engine = GPUEngine(tcfg.EngineConfig(
                model=SPEC_T, device="cpu", host_cache_pages=8 * i, **KW),
                seed=0)
            engines.append(engine)
            planes.append(await gpu.start_kv_plane(rt, engine, "tiny-test"))
        (pa, _), (pb, _) = planes
        a, b = engines
        coord = rts[0].require_coordinator()
        items = await coord.kv_get_prefix("kvplane/")
        assert {i["k"]: i["v"] for i in items} == {
            f"kvplane/{rt.config.namespace}/{rt.instance_id:x}":
                {"addr": p.address, "model": "tiny-test"}
            for rt, (p, _) in zip(rts, planes)}
        assert a.plane is pa and b.plane is pb
        assert a.kv_status()["plane"]["addr"] == pa.address
        assert pb.block_provider is not None and pa.block_provider is None
        for engine in engines:
            runner = engine.runner
            assert engine.remote_source.block_nbytes == (
                runner.kv_pool_bytes // runner.num_pages) > 0

        async def until(cond):
            for _ in range(400):
                if cond():
                    return
                await asyncio.sleep(0.01)
            raise AssertionError("watch never caught up")
        await until(lambda: b.remote_source.peers == [pa.address]
                    and a.remote_source.peers == [pb.address])
        key = f"kvplane/{rts[0].config.namespace}/{rts[0].instance_id:x}"
        b.remote_source._fail_streak[pa.address] = 3
        await coord.kv_delete(key)
        await until(lambda: b.remote_source.peers == [])
        assert pa.address not in b.remote_source._fail_streak
        await coord.kv_put(key, {"addr": pa.address, "model": "tiny-test"})
        await until(lambda: b.remote_source.peers == [pa.address])
        await coord.kv_put(key + "0", {"addr": "x:1", "model": "other"})
        await asyncio.sleep(0.05)
        assert b.remote_source.peers == [pa.address]
    finally:
        for engine, (plane, task) in zip(engines, planes):
            await gpu.close_kv_plane(engine, plane, task)
            assert engine.remote_source is None and engine.plane is None
        for engine in engines:
            engine.stop()
        for rt in reversed(rts):
            await rt.close()


@pytest.mark.parametrize("argv", [
    [], ["--host-cache-pages", "64"], ["--kv-disk-cache-dir", "/tmp/x"],
    ["--host-cache-pages", "8", "--kv-disk-cache-dir", "/d",
     "--kv-watermarks", "0.2,0.3"],
    ["--host-cache-pages", "8", "--kv-watermarks", "0.25"],
    ["--kv-watermarks", "0.1 0.4"]],
    ids=lambda v: " ".join(v) or "none")
def test_tier_flags_parse_as_the_reference(argv):
    fields = ("host_cache_pages", "kv_disk_cache_dir", "disk_cache_pages",
              "kv_demote_low_watermark", "kv_demote_high_watermark")
    base = ["--model", "tiny-test"]
    want = jtpu.build_engine_config(jtpu.parse_args(base + argv))
    got = gpu.build_engine_config(gpu.parse_args(base + argv))
    assert {f: getattr(got, f) for f in fields} == \
        {f: getattr(want, f) for f in fields}
    launcher_argv = [a for a in argv if a not in ("--kv-watermarks",)]
    if "--kv-watermarks" in argv:
        i = argv.index("--kv-watermarks")
        launcher_argv = argv[:i] + argv[i + 2:]
    want = jtpu.build_engine_config(jlaunch.parse_args(base + launcher_argv))
    got = launch.build_engine_config(launch.parse_args(base + launcher_argv))
    assert {f: getattr(got, f) for f in fields} == \
        {f: getattr(want, f) for f in fields}


class _Proc:
    def __init__(self, *argv):
        env = dict(os.environ, OMP_NUM_THREADS="1", DTPU_LOG="info")
        self.p = subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT,
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
        self.lines: queue.Queue = queue.Queue()
        threading.Thread(target=lambda: [self.lines.put(x)
                                         for x in self.p.stdout],
                         daemon=True).start()
        self.seen: list[str] = []

    def wait_line(self, text: str, timeout: float = 60) -> str:
        deadline = time.monotonic() + timeout
        while not any(text in line for line in self.seen):
            assert self.p.poll() is None, self.seen[-20:]
            assert time.monotonic() < deadline, self.seen[-20:]
            try:
                self.seen.append(self.lines.get(timeout=0.2))
            except queue.Empty:
                pass
        return next(line for line in self.seen if text in line)


@async_test(timeout=120)
async def test_worker_process_serves_the_tiers(tmp_path):
    """``python -m dynamo_tpu_torch.backends.gpu --num-pages 64
    --host-cache-pages 64 --kv-disk-cache-dir DIR --kv-watermarks 0.2,0.3``
    starts, registers its plane, answers, publishes a digest with g2 and
    g3, and exits 0 on SIGTERM."""
    rt = await DistributedRuntime.with_embedded_coordinator(RuntimeConfig())
    proc = None
    try:
        coord = rt.require_coordinator()
        sub = await coord.subscribe(kv_inventory_subject(
            rt.config.namespace, "gpu"))
        proc = _Proc("dynamo_tpu_torch.backends.gpu", "--model", "tiny-test",
                     "--device", "cpu", "--num-pages", "64",
                     "--host-cache-pages", "64", "--kv-disk-cache-dir",
                     str(tmp_path), "--kv-watermarks", "0.2,0.3",
                     "--coordinator-url", rt.config.coordinator_url)
        await asyncio.get_running_loop().run_in_executor(
            None, proc.wait_line, "GPU_WORKER_READY")
        planes = await coord.kv_get_prefix("kvplane/")
        assert len(planes) == 1 and planes[0]["v"]["model"] == "tiny-test"
        msg = await asyncio.wait_for(sub.messages.get(), 30)
        digest = msg["payload"]
        assert {"g1", "g2", "g3"} <= set(digest["tier_blocks"]), digest
        await sub.cancel()
        proc.p.send_signal(signal.SIGTERM)
        assert await asyncio.get_running_loop().run_in_executor(
            None, proc.p.wait, 30) == 0
    finally:
        if proc is not None and proc.p.poll() is None:
            proc.p.kill()
        await rt.close()
