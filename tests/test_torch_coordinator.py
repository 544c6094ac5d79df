"""The port's coordinator and coordinator client against the JAX package's.

The scenarios of ``tests/test_coordinator.py`` (put/get/delete, atomic
create, lease expiry firing the watch, primary keepalive, watch snapshot
plus events, pub/sub wildcards, the blocking queue pop, the object store)
run on each of the four pairs {JAX ``Coordinator``, port coordinator} x
{JAX ``CoordinatorClient``, port client}. Each scenario records every
return value and every event dict, revisions and lease ids included, and
every pair must record what the all-JAX pair records. ``subject_matches``
is held to the reference's on a table. A coordinator restarted on the same
port: the port client reconnects, re-grants its primary lease, fires
``on_lease_recreated``, puts its registrations back and keeps its watches,
as ``tests/test_coordinator_restart.py`` holds the JAX client.
``RuntimeConfig.from_settings`` reads defaults, TOML and ``DTPU_*``
variables as the reference's does, and refuses the settings the port
lacks.
"""

import asyncio
import dataclasses
import os
import socket

import pytest
from conftest import async_test

from dynamo_tpu.runtime import config as jconfig
from dynamo_tpu.runtime import coordinator as jcoord
from dynamo_tpu.runtime import coordinator_client as jclient
from dynamo_tpu_torch.runtime import config as tconfig
from dynamo_tpu_torch.runtime import coordinator as tcoord
from dynamo_tpu_torch.runtime import coordinator_client as tclient

WAIT_S = 10

COORDS = {"jax": jcoord.Coordinator, "port": tcoord.Coordinator}
CLIENTS = {"jax": jclient.CoordinatorClient,
           "port": tclient.CoordinatorClient}
PAIRS = [(c, k) for c in COORDS for k in CLIENTS]


async def _next(queue):
    return await asyncio.wait_for(queue.get(), WAIT_S)


async def s_put_get_delete(client, connect):
    out = [await client.kv_put("a/b", {"x": 1}),
           await client.kv_get("a/b"),
           await client.kv_put("a/c", [1, 2]),
           await client.kv_put("a/b", {"x": 2}),
           await client.kv_get_prefix("a/"),
           await client.kv_delete("a/b"),
           await client.kv_delete("a/b"),
           await client.kv_get("a/b")]
    await client.kv_put("a/d", None)
    out += [await client.kv_delete_prefix("a/"),
            await client.kv_get_prefix("a/")]
    assert out[1] == {"x": 1} and out[5] is True and out[7] is None
    return out


async def s_create_atomic(client, connect):
    out = [await client.kv_create("k", 1), await client.kv_create("k", 2),
           await client.kv_get("k"),
           await client.kv_create("p", "v", use_primary_lease=True),
           await client.kv_get_prefix("")]
    assert out[:3] == [True, False, 1]
    return out


async def s_lease_expiry(client, connect):
    watcher = await connect()
    try:
        lease = await client.lease_grant(0.5)
        out = [lease,
               await client.kv_put("instances/ns/c/e/1", {"id": 1},
                                   lease_id=lease)]
        watch = await watcher.watch_prefix("instances/")
        out.append(watch.snapshot)
        # No keepalives: the lease expires and its key's delete reaches
        # the watch.
        event = await _next(watch.events)
        out += [event, await client.kv_get("instances/ns/c/e/1")]
        assert event["event"] == "delete"
        other = await client.lease_grant(5.0)
        await client.kv_put("tmp/x", 1, lease_id=other)
        await client.lease_revoke(other)
        out.append(await client.kv_get_prefix("tmp/"))
        return out
    finally:
        await watcher.close()


async def s_primary_keepalive(client, connect):
    out = [client.primary_lease_id,
           await client.kv_put("reg/one", "v", use_primary_lease=True)]
    await asyncio.sleep(1.5)  # > ttl: the keepalive task must refresh it
    out.append(await client.kv_get("reg/one"))
    assert out[-1] == "v"
    return out


async def s_watch_snapshot_events(client, connect):
    await client.kv_put("p/1", "a")
    watch = await client.watch_prefix("p/")
    out = [watch.snapshot]
    await client.kv_put("p/2", "b")
    out.append(await _next(watch.events))
    await client.kv_delete("p/1")
    out.append(await _next(watch.events))
    await client.kv_put("p/2", {"v": [1.5, None, b"\x00"]})
    out.append(await _next(watch.events))
    await watch.cancel()
    await client.kv_put("p/3", "c")
    await asyncio.sleep(0.1)
    out.append(watch.events.qsize())
    assert out[1] == {"event": "put", "key": "p/2", "value": "b"}
    return out


async def s_pubsub_wildcards(client, connect):
    sub = await client.subscribe("ns.test.cp.*.kv_events")
    all_sub = await client.subscribe("ns.test.>")
    await client.publish("ns.test.cp.worker.kv_events", {"n": 1})
    await client.publish("ns.other.cp.worker.kv_events", {"n": 2})
    await client.publish("ns.test.cp.worker.metrics", [3])
    out = [await _next(sub.messages), await _next(all_sub.messages),
           await _next(all_sub.messages)]
    await sub.cancel()
    await client.publish("ns.test.cp.w2.kv_events", {"n": 4})
    out.append(await _next(all_sub.messages))
    await asyncio.sleep(0.1)
    out += [sub.messages.qsize(), all_sub.messages.qsize()]
    assert out[0]["payload"] == {"n": 1} and out[-2:] == [0, 0]
    return out


async def s_queue_blocking_pop(client, connect):
    out = [await client.queue_pop("q")]  # empty, non-blocking
    task = asyncio.create_task(client.queue_pop("q", timeout=5))
    await asyncio.sleep(0.05)
    await client.queue_push("q", {"job": 1})
    out.append(await asyncio.wait_for(task, WAIT_S))
    await client.queue_push("q", "a")
    await client.queue_push("q", "b")
    out += [await client.queue_len("q"), await client.queue_pop("q"),
            await client.queue_pop("q"), await client.queue_pop("q", 0.1)]
    assert out == [None, {"job": 1}, 2, "a", "b", None]
    return out


async def s_object_store(client, connect):
    blob = b"\x00tokenizer-bytes\xff" * 100
    out = [await client.object_put("tokenizers/tok", blob),
           await client.object_get("tokenizers/tok"),
           await client.object_get("missing")]
    assert out[1] == blob and out[2] is None
    return out


SCENARIOS = {f.__name__[2:]: f for f in (
    s_put_get_delete, s_create_atomic, s_lease_expiry, s_primary_keepalive,
    s_watch_snapshot_events, s_pubsub_wildcards, s_queue_blocking_pop,
    s_object_store)}


async def run_scenario(name, coord_kind, client_kind):
    coord = COORDS[coord_kind]("127.0.0.1", 0)
    await coord.start()
    opened = []

    async def connect(ttl=1.0):
        client = await CLIENTS[client_kind].connect("127.0.0.1", coord.port,
                                                    lease_ttl_s=ttl)
        opened.append(client)
        return client

    try:
        client = await connect(1.0)
        return await SCENARIOS[name](client, connect)
    finally:
        for client in opened:
            await client.close()
        await coord.stop()


@pytest.fixture(scope="module")
def reference_records():
    """Each scenario's record on the all-JAX pair, computed once."""
    return {}


@pytest.mark.parametrize("pair", PAIRS, ids=[f"{c}-coord-{k}-client"
                                             for c, k in PAIRS])
@pytest.mark.parametrize("name", list(SCENARIOS))
@async_test(timeout=60)
async def test_scenario_matches_reference(name, pair, reference_records):
    if name not in reference_records:
        reference_records[name] = await run_scenario(name, "jax", "jax")
    assert await run_scenario(name, *pair) == reference_records[name]


SUBJECTS = [("a.b.c", "a.b.c"), ("a.*.c", "a.x.c"), ("a.*.c", "a.x.y"),
            ("a.>", "a.b.c.d"), ("a.b", "a.b.c"), ("a.b.c", "a.b"),
            (">", "x"), ("*", "x.y"), ("a.*", "a"), ("a.*.>", "a.b"),
            ("a.*.>", "a.b.c"), ("", ""), ("a..b", "a..b")]


@pytest.mark.parametrize("pattern,subject", SUBJECTS)
def test_subject_matches_table(pattern, subject):
    assert tcoord.subject_matches(pattern, subject) == \
        jcoord.subject_matches(pattern, subject)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("coord_kind", list(COORDS))
@async_test(timeout=60)
async def test_port_client_survives_coordinator_restart(coord_kind):
    """The port client, its lease, its lease-attached registration (put
    again by an on_lease_recreated callback) and its watch outlive a
    restart of the coordinator on the same port."""
    port = _free_port()
    coord = COORDS[coord_kind]("127.0.0.1", port)
    await coord.start()
    client = await tclient.CoordinatorClient.connect("127.0.0.1", port,
                                                     lease_ttl_s=1.0)
    other = await tclient.CoordinatorClient.connect("127.0.0.1", port,
                                                    lease_ttl_s=1.0)
    leases = []

    async def reregister(lease_id):
        leases.append(lease_id)
        await client.kv_put("instances/ns/c/e/x", {"v": 1},
                            use_primary_lease=True)

    client.on_lease_recreated(reregister)
    coord2 = None
    try:
        await client.kv_put("instances/ns/c/e/x", {"v": 1},
                            use_primary_lease=True)
        watch = await client.watch_prefix("things/")
        await other.kv_put("things/a", 1)
        assert (await _next(watch.events))["key"] == "things/a"
        await coord.stop()
        await asyncio.sleep(0.5)
        coord2 = COORDS[coord_kind]("127.0.0.1", port)
        await coord2.start()
        for _ in range(100):
            if leases:
                break
            await asyncio.sleep(0.1)
        assert leases == [client.primary_lease_id]
        # The registration is back on the new lease, and stays (keepalive).
        assert await client.kv_get("instances/ns/c/e/x") == {"v": 1}
        await asyncio.sleep(1.5)
        assert await client.kv_get("instances/ns/c/e/x") == {"v": 1}
        # The old watch sees the vanished key deleted, then new puts.
        for _ in range(100):
            try:
                await other.kv_put("things/b", 2)
                break
            except ConnectionError:
                await asyncio.sleep(0.1)
        seen = {}
        while seen.get("things/b") != "put":
            ev = await _next(watch.events)
            seen[ev["key"]] = ev["event"]
        assert seen["things/a"] == "delete"
    finally:
        await other.close()
        await client.close()
        if coord2 is not None:
            await coord2.stop()


# -- runtime settings -----------------------------------------------------------

FIELDS = ["coordinator_url", "namespace", "lease_ttl_s", "bind_host",
          "advertise_host", "shutdown_timeout_s", "retire_drain_s",
          "stream_idle_timeout_s", "system_enabled", "system_port"]


def _clear_settings(monkeypatch):
    for key in list(os.environ):
        if key.startswith("DTPU_") and key != "DTPU_LOG":
            monkeypatch.delenv(key)


@pytest.mark.parametrize("env", [
    {},
    {"DTPU_COORDINATOR_URL": "tcp://10.1.2.3:4999", "DTPU_NAMESPACE": "ns",
     "DTPU_LEASE_TTL_S": "2.5", "DTPU_BIND_HOST": "0.0.0.0",
     "DTPU_ADVERTISE_HOST": "10.0.0.7", "DTPU_SHUTDOWN_TIMEOUT_S": "3",
     "DTPU_RETIRE_DRAIN_S": "4", "DTPU_STREAM_IDLE_TIMEOUT_S": "0",
     "DTPU_SYSTEM_ENABLED": "1", "DTPU_SYSTEM_PORT": "9123"},
], ids=["defaults", "env"])
def test_runtime_config_matches_reference(env, monkeypatch, tmp_path):
    _clear_settings(monkeypatch)
    toml = tmp_path / "rt.toml"
    toml.write_text('namespace = "from-toml"\nlease_ttl_s = 7.5\n'
                    'shutdown_timeout_s = 1.25\n')
    for with_toml in (False, True):
        if with_toml:
            monkeypatch.setenv("DTPU_CONFIG_PATH", str(toml))
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        t, j = (tconfig.RuntimeConfig.from_settings(),
                jconfig.RuntimeConfig.from_settings())
        assert [getattr(t, f) for f in FIELDS] == \
            [getattr(j, f) for f in FIELDS]
        assert t.coordinator_addr == j.coordinator_addr


@pytest.mark.parametrize("setting", [
    ("toml", "[overload]\nenabled = false\nqueue_depth = 7\n"),
    ("toml", "[slo]\nttft_p99_ms = 100.0\nrequest_ring = 8\n"),
    ("toml", "static_mode = true\n"),
    ("env", "DTPU_OVERLOAD_ENABLED=0"),
    ("env", "DTPU_SLO_TTFT_P99_MS=250"),
    ("env", "DTPU_STATIC_MODE=1"),
    ("toml", "num_worker_threads = 6\n"),
    ("env", "DTPU_NUM_WORKER_THREADS=2"),
], ids=lambda s: s[1].split("\n")[0])
def test_runtime_settings_layer_as_the_reference(setting, monkeypatch,
                                                  tmp_path):
    """The overload and SLO tables, static mode and thread sizing layer
    TOML <- DTPU_* env into the same values as the reference's."""
    _clear_settings(monkeypatch)
    kind, text = setting
    if kind == "toml":
        toml = tmp_path / "rt.toml"
        toml.write_text(text)
        monkeypatch.setenv("DTPU_CONFIG_PATH", str(toml))
    else:
        name, _, value = text.partition("=")
        monkeypatch.setenv(name, value)
    t, j = (tconfig.RuntimeConfig.from_settings(),
            jconfig.RuntimeConfig.from_settings())
    for field in ("overload", "slo", "static_mode", "num_worker_threads"):
        assert dataclasses.asdict(t)[field] == dataclasses.asdict(j)[field]
    assert dataclasses.asdict(t) != dataclasses.asdict(
        tconfig.RuntimeConfig())
