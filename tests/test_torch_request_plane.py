"""The port's request plane (``runtime/service.py`` ``EndpointServer`` and
``runtime/client.py`` ``EndpointClient``) against the JAX package's, over
a scripted handler.

- Each scenario (ordered data frames ending in ``final``, a handler
  exception, a validation error, ``stop`` and ``kill`` reaching the
  handler's context) runs on the four pairs {JAX server, port server} x
  {JAX client, port client} and must give the port-against-port outputs:
  the same items, the same error class and text, the same server-side
  context state.
- A draining server refuses a new request with ``incomplete`` (checked on
  raw frames, for both servers), and the client maps that token to
  ``StreamIncompleteError``.
- A caller that disconnects kills its in-flight requests on the port
  server.
- A fake server built from raw frames: a skipped sequence number gives
  ``StreamIncompleteError``, a repeated one is dropped, a silent one hits
  the idle timeout; ``wait_for_instances`` with no worker raises
  ``NoInstancesError``; routing covers round_robin, random and direct.
- ``Context.to_wire``/``from_wire`` and ``parse_traceparent`` give the
  reference's ids on a table of W3C headers.
"""

import asyncio
import contextlib
import uuid
from types import SimpleNamespace

import pytest
from conftest import async_test

from dynamo_tpu.runtime import config as jconfig
from dynamo_tpu.runtime import context as jcontext
from dynamo_tpu.runtime import distributed as jdist
from dynamo_tpu.runtime import frame as jframe
from dynamo_tpu_torch.runtime import config as tconfig
from dynamo_tpu_torch.runtime import context as tcontext
from dynamo_tpu_torch.runtime import distributed as tdist
from dynamo_tpu_torch.runtime import frame as tframe
from dynamo_tpu_torch.runtime.component import Instance
from dynamo_tpu_torch.runtime.coordinator import Coordinator
from dynamo_tpu_torch.runtime.errors import (NoInstancesError,
                                             StreamIncompleteError)

WAIT_S = 20
PKGS = {
    "jax": SimpleNamespace(runtime=jdist.DistributedRuntime,
                           config=jconfig.RuntimeConfig,
                           context=jcontext.Context),
    "port": SimpleNamespace(runtime=tdist.DistributedRuntime,
                            config=tconfig.RuntimeConfig,
                            context=tcontext.Context),
}
PAIRS = [(s, c) for s in PKGS for c in PKGS]


class Script:
    """Scripted handler: ``n`` items, then maybe an error, or a hold until
    the context stops. Records how each request ended, server side."""

    def __init__(self):
        self.ended: dict[str, str] = {}

    async def __call__(self, request, ctx):
        tag = request["tag"]
        try:
            for i in range(request.get("n", 0)):
                yield {"i": i, "tag": tag, "v": [i * 0.5, None, "é"],
                       "b": b"\x01\x02"}
            if request.get("raise"):
                raise RuntimeError(f"boom {tag}")
            if request.get("invalid"):
                raise ValueError(f"bad {tag}")
            if request.get("hold"):
                while not ctx.is_stopped:
                    await asyncio.sleep(0.01)
                yield {"stopped": True, "killed": ctx.is_killed}
        finally:
            self.ended[tag] = ("killed" if ctx.is_killed else "stopped"
                               if ctx.is_stopped else "done")


async def _runtime(kind, url, **kw):
    return await PKGS[kind].runtime.from_settings(
        PKGS[kind].config(coordinator_url=url, lease_ttl_s=2.0, **kw))


@contextlib.asynccontextmanager
async def plane(server_kind, client_kind, n_servers=1, coord=None, **kw):
    own = coord is None
    if own:
        coord = Coordinator("127.0.0.1", 0)
        await coord.start()
    rts, servers, scripts, client = [], [], [], None
    try:
        for _ in range(n_servers):
            rt = await _runtime(server_kind, coord.url)
            rts.append(rt)
            scripts.append(Script())
            ep = rt.namespace("test").component("script").endpoint("gen")
            servers.append(await ep.serve_endpoint(scripts[-1]))
        crt = await _runtime(client_kind, coord.url, **kw)
        rts.append(crt)
        client = await crt.namespace("test").component("script").endpoint(
            "gen").client()
        for _ in range(WAIT_S * 20):
            if len(client.instance_ids()) >= n_servers:
                break
            await asyncio.sleep(0.05)
        assert len(client.instance_ids()) >= n_servers
        yield SimpleNamespace(client=client, servers=servers,
                              scripts=scripts, rts=rts, coord=coord,
                              context=PKGS[client_kind].context)
    finally:
        if client is not None:
            await client.close()
        for server in servers:
            await server.shutdown(drain_s=0)
        for rt in rts:
            await rt.close()
        if own:
            await coord.stop()


async def collect(stream_coro, on_item=None):
    """(items, (error class name, text) or None) of one stream."""
    items = []
    try:
        async for item in await stream_coro:
            items.append(item)
            if on_item is not None:
                on_item(item)
    except Exception as exc:  # noqa: BLE001 — the outcome is the record
        return items, (type(exc).__name__, str(exc))
    return items, None


async def sc_ordered(p):
    return await collect(p.client.generate({"tag": "a", "n": 6}))


async def sc_handler_error(p):
    return await collect(p.client.generate({"tag": "b", "n": 2,
                                            "raise": True}))


async def sc_invalid(p):
    return await collect(p.client.generate({"tag": "c", "n": 1,
                                            "invalid": True}))


async def _hold(p, tag, cancel):
    ctx = p.context()
    record = await collect(p.client.generate({"tag": tag, "n": 1,
                                              "hold": True}, ctx),
                           on_item=lambda _: cancel(ctx))
    for _ in range(WAIT_S * 20):
        if tag in p.scripts[0].ended:
            break
        await asyncio.sleep(0.05)
    return record, p.scripts[0].ended.get(tag)


async def sc_stop(p):
    return await _hold(p, "d", lambda ctx: ctx.stop_generating())


async def sc_kill(p):
    return await _hold(p, "e", lambda ctx: ctx.kill())


SCENARIOS = {f.__name__[3:]: f for f in (sc_ordered, sc_handler_error,
                                         sc_invalid, sc_stop, sc_kill)}


@pytest.mark.parametrize("pair", PAIRS, ids=[f"{s}-server-{c}-client"
                                             for s, c in PAIRS])
@pytest.mark.parametrize("name", list(SCENARIOS))
@async_test(timeout=60)
async def test_scenario_matches_port_pair(name, pair):
    records = []
    for server_kind, client_kind in (("port", "port"), pair):
        async with plane(server_kind, client_kind) as p:
            records.append(await SCENARIOS[name](p))
    assert records[1] == records[0]
    if name == "ordered":
        assert [x["i"] for x in records[0][0]] == list(range(6))
    elif name == "handler_error":
        assert records[0][1] == ("EngineError", "RuntimeError: boom b")
    elif name == "invalid":
        assert records[0][1] == ("InvalidRequestError", "bad c")
    elif name == "stop":
        assert records[0] == (([{"i": 0, "tag": "d", "v": [0.0, None, "é"],
                                 "b": b"\x01\x02"},
                                {"stopped": True, "killed": False}], None),
                              "stopped")
    else:
        assert records[0][1] == "killed" and records[0][0][1] is None


async def _raw_request(port, msg):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    await tframe.write_frame(writer, msg)
    return reader, writer


@pytest.mark.parametrize("server_kind", list(PKGS))
@async_test(timeout=60)
async def test_draining_server_refuses_with_incomplete(server_kind):
    async with plane(server_kind, "port") as p:
        server = p.servers[0]
        reader, writer = await _raw_request(
            server.port, {"t": "req", "rid": "r1", "ctx": None,
                          "p": {"tag": "h", "n": 1, "hold": True}})
        first = await asyncio.wait_for(tframe.read_frame(reader), WAIT_S)
        assert first["t"] == "data"  # r1 is in flight
        drain = asyncio.create_task(server.shutdown(drain_s=3.0))
        await asyncio.sleep(0.3)  # draining: the held request keeps it busy
        await tframe.write_frame(writer, {"t": "req", "rid": "r2",
                                          "ctx": None, "p": {"tag": "x"}})
        reply = await asyncio.wait_for(tframe.read_frame(reader), WAIT_S)
        assert reply == {"t": "err", "rid": "r2", "e": "incomplete"}
        # The held stream, killed at the drain deadline, ends typed too.
        reply = await asyncio.wait_for(tframe.read_frame(reader), WAIT_S)
        assert reply == {"t": "err", "rid": "r1", "e": "incomplete"}
        await asyncio.wait_for(drain, WAIT_S)
        writer.close()


@async_test(timeout=60)
async def test_disconnected_caller_kills_its_requests():
    async with plane("port", "port") as p:
        reader, writer = await _raw_request(
            p.servers[0].port, {"t": "req", "rid": "r1", "ctx": None,
                                "p": {"tag": "h", "n": 1, "hold": True}})
        first = await asyncio.wait_for(tframe.read_frame(reader), WAIT_S)
        assert first["t"] == "data" and first["s"] == 0
        writer.close()
        for _ in range(WAIT_S * 20):
            if "h" in p.scripts[0].ended:
                break
            await asyncio.sleep(0.05)
        assert p.scripts[0].ended["h"] == "killed"


@contextlib.asynccontextmanager
async def fake_server(coord, frames_for):
    """A worker made of raw frames, registered under the script endpoint:
    ``frames_for(rid)`` gives the frames it answers each request with
    (None: never answer)."""
    reg = await _runtime("port", coord.url)

    async def handle(reader, writer):
        try:
            while True:
                msg = await tframe.read_frame(reader)
                if msg.get("t") != "req":
                    continue
                for f in frames_for(msg["rid"]) or []:
                    writer.write(jframe.encode_frame(f))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    srv = await asyncio.start_server(handle, "127.0.0.1", 0)
    inst = Instance("test", "script", "gen", reg.instance_id, "127.0.0.1",
                    srv.sockets[0].getsockname()[1])
    await reg.require_coordinator().kv_put(inst.path, inst.to_wire(),
                                           use_primary_lease=True)
    try:
        yield
    finally:
        srv.close()
        await reg.close()


def _data(rid, *seqs):
    return [{"t": "data", "rid": rid, "p": {"s": s}, "s": s} for s in seqs]


@pytest.mark.parametrize("client_kind", list(PKGS))
@async_test(timeout=60)
async def test_sequence_gap_and_duplicate(client_kind):
    coord = Coordinator("127.0.0.1", 0)
    await coord.start()
    try:
        scripts = {"gap": lambda rid: _data(rid, 0, 2) + [
                       {"t": "final", "rid": rid, "s": 3}],
                   "dup": lambda rid: _data(rid, 0, 0, 1, 1, 2) + [
                       {"t": "final", "rid": rid, "s": 3}],
                   "short": lambda rid: _data(rid, 0, 1) + [
                       {"t": "final", "rid": rid, "s": 3}]}
        mode = {}
        async with fake_server(coord, lambda rid: scripts[mode["m"]](rid)):
            async with plane("port", client_kind, n_servers=0,
                             coord=coord) as p:
                await p.client.wait_for_instances(timeout=WAIT_S)
                out = {}
                for m in scripts:
                    mode["m"] = m
                    out[m] = await collect(p.client.generate({}))
        assert out["gap"] == ([{"s": 0}], (
            "StreamIncompleteError", "Stream ended before generation "
            "completed (frame gap: expected #1, got #2)"))
        assert out["dup"] == ([{"s": 0}, {"s": 1}, {"s": 2}], None)
        assert out["short"][1][0] == "StreamIncompleteError"
    finally:
        await coord.stop()


@async_test(timeout=60)
async def test_incomplete_tokens_and_idle_timeout():
    coord = Coordinator("127.0.0.1", 0)
    await coord.start()
    try:
        replies = {"incomplete": "incomplete", "reason": "incomplete:drain",
                   "killed": "killed", "text": "KeyError: 'x'",
                   "invalid": "invalid_request: too long"}
        mode = {}

        def frames(rid):
            if mode["m"] == "silent":
                return None
            return [{"t": "err", "rid": rid, "e": replies[mode["m"]]}]

        async with fake_server(coord, frames):
            async with plane("port", "port", n_servers=0, coord=coord,
                             stream_idle_timeout_s=0.5) as p:
                await p.client.wait_for_instances(timeout=WAIT_S)
                errors = {}
                for m in list(replies) + ["silent"]:
                    mode["m"] = m
                    stream = await p.client.generate({})
                    with pytest.raises(Exception) as err:
                        async for _ in stream:
                            pass
                    errors[m] = err.value
        assert type(errors["incomplete"]) is StreamIncompleteError
        assert errors["incomplete"].reason is None
        assert errors["reason"].reason == "drain"
        assert [type(errors[m]).__name__ for m in ("killed", "text",
                                                   "invalid")] == [
            "EngineError", "EngineError", "InvalidRequestError"]
        assert str(errors["text"]) == "KeyError: 'x'"
        assert type(errors["silent"]) is StreamIncompleteError
        assert "no frames" in str(errors["silent"])
    finally:
        await coord.stop()


@async_test(timeout=60)
async def test_wait_for_instances_without_workers():
    coord = Coordinator("127.0.0.1", 0)
    await coord.start()
    rt = await _runtime("port", coord.url)
    try:
        client = await rt.namespace("test").component("none").endpoint(
            "gen").client()
        with pytest.raises(NoInstancesError):
            await client.wait_for_instances(timeout=0.3)
        with pytest.raises(NoInstancesError):
            await client.generate({"tag": "x"})
        await client.close()
    finally:
        await rt.close()
        await coord.stop()


@async_test(timeout=60)
async def test_routing_modes():
    async with plane("port", "port", n_servers=2) as p:
        ids = p.client.instance_ids()

        async def served_by(**kw):
            tag = uuid.uuid4().hex
            ctx = p.context()
            items, err = await collect(p.client.generate(
                {"tag": tag, "n": 1}, ctx, **kw))
            assert err is None and len(items) == 1
            return int(ctx.values["worker_id"], 16)

        rr = [await served_by() for _ in range(6)]
        assert sorted(set(rr)) == ids and rr[:2] * 3 == rr
        assert {await served_by(mode="random") for _ in range(30)} == set(ids)
        for iid in ids:
            assert await served_by(instance_id=iid) == iid
        with pytest.raises(NoInstancesError):
            await p.client.generate({"tag": "x"}, instance_id=12345)
        # One server leaves: every request goes to the other.
        await p.servers[0].shutdown(drain_s=0)
        left = p.servers[0].instance.instance_id
        for _ in range(WAIT_S * 20):
            if left not in p.client.instance_ids():
                break
            await asyncio.sleep(0.05)
        assert {await served_by() for _ in range(4)} == set(ids) - {left}


TRACEPARENTS = ["00-" + "a" * 32 + "-" + "b" * 16 + "-01",
                "00-" + "a" * 32 + "-" + "b" * 16 + "-00",
                "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
                "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
                "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
                "00-" + "A" * 32 + "-" + "b" * 16 + "-01",
                "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
                "00-abc", "", "  00-" + "c" * 32 + "-" + "d" * 16 + "-01 "]


@pytest.mark.parametrize("header", TRACEPARENTS)
def test_traceparent_parse_matches_reference(header):
    from dynamo_tpu.runtime.logging import parse_traceparent as jparse
    from dynamo_tpu_torch.runtime.logging import parse_traceparent
    assert parse_traceparent(header) == jparse(header)
    ctx = tcontext.Context.from_wire({"id": "r", "traceparent": header})
    ref = jcontext.Context.from_wire({"id": "r", "traceparent": header})
    assert (ctx.id, ctx.parent_span_id) == (ref.id, ref.parent_span_id)
    if ref.parent_span_id is not None:
        assert ctx.trace_id == ref.trace_id


def test_context_wire_round_trip_across_packages():
    ctx = tcontext.Context("req-1")
    wire = ctx.to_wire()
    ref = jcontext.Context("req-1", ctx.trace_id)
    ref.span_id = ctx.span_id
    assert wire == ref.to_wire()
    for back in (tcontext.Context.from_wire(wire),
                 jcontext.Context.from_wire(wire)):
        assert (back.id, back.trace_id, back.parent_span_id) == (
            "req-1", ctx.trace_id, ctx.span_id)
    fresh = tcontext.Context.from_wire(None)
    assert len(fresh.id) == 32 and len(fresh.trace_id) == 32
