"""The KV plane's device path in the port (``llm/kv_plane.py``), on the
CPU through fake exporters, and on the card with CUDA IPC.

- Negotiation: a server without the path (a CPU server probes no CUDA
  device) adds no ``cuda_ipc`` field; a sink takes the device path only
  for a ticket with the field from its own host and another process; a
  ticket without the field, a JAX ticket (``jax_addr``/``jax_uuid``), a
  ticket of its own process or of another host goes over the socket with
  the same bytes, each counted by its reason.
- ``done`` drops the staged entry (a later socket pull of it fails as
  expired); the TTL GC drops staged device tensors and releases their
  exports; a failed open is counted in ``device_pull_failures``, the same
  ticket arrives over the socket with the same bytes, and the source is
  remembered.
- Mixed fleets: the JAX package's ``KvPlaneClient`` pulls a port ticket
  that carries the field, over the socket, with the same bytes.
- Two processes on the CPU: a sink in a spawned process takes the device
  path of a file-backed fake exporter, and the socket for a plain ticket.
- The engine: a device-path prefill stages one tensor after the prefill
  (no page groups, ``on_ticket`` not called), from the handler and the
  queue alike; the decode worker's pool bytes at the parcel's pages equal
  the socket path's; its greedy tokens equal the JAX engine's where the
  reference's top-2 margin exceeds a bf16 ulp (the rule of
  ``tests/test_torch_disagg.py``); a device parcel into an int8 pool
  holds ``quantize_np`` of it.
- On the card (marked ``gpu``; skipped without one): parcels staged by
  this process and pulled by a spawned one over CUDA IPC land bit-exact,
  ``done`` gives the memory back, a pull in the exporting process goes
  over the socket, and with ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments``
  the probe and the sink either work or fall through counted.

JAX is imported inside the tests that compare with it, so the gpu-marked
tests run on the card with ``--noconftest``.
"""

import asyncio
import hashlib
import itertools
import json
import multiprocessing
import os
import subprocess
import sys
import time
import weakref

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.engine.kv_quant import BF16, quantize_np
from dynamo_tpu_torch.llm import disagg as tdisagg
from dynamo_tpu_torch.llm import kv_plane
from dynamo_tpu_torch.llm.kv_plane import KvPlaneClient, KvPlaneServer
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.runtime.context import Context

torch.set_num_threads(1)

SHAPE = (2, 2, 2, 3, 16, 32)  # [2, L, Nkv, n, page, D]
SPEC = tcfg.PRESETS["tiny-test"]
ENGINE_KW = dict(page_size=16, num_pages=128, max_pages_per_seq=16,
                 max_num_seqs=4, prefill_buckets=(32, 64, 128, 256),
                 max_prefill_tokens=64, decode_window=4, pipeline_depth=2)


def _run(coro, timeout: float = 120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _parcel(shape=SHAPE, seed=0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16)


def _bits(t) -> np.ndarray:
    """bf16 bits of a parcel, from a tensor or a host parcel."""
    if torch.is_tensor(t):
        return t.view(torch.int16).cpu().numpy().view(BF16)
    return np.asarray(t).view(BF16)


class FakeIpc:
    """A stand-in for ``kv_plane.CudaIpc`` that passes tensors through a
    registry: ``export`` keeps the tensor under a key (the field says it
    comes from ``pid``, another process by default, on ``host``), ``open``
    clones it, ``release`` records the key."""

    def __init__(self, registry=None, pid=None, host=None,
                 fail_open=False):
        self.registry = {} if registry is None else registry
        self.pid = os.getpid() + 1 if pid is None else pid
        self.host = host
        self.fail_open = fail_open
        self.keys = itertools.count(1)
        self.opens = 0
        self.released = []

    def probe(self):
        return True, "fake exporter"

    def export(self, tensor, event):
        key = next(self.keys)
        self.registry[key] = tensor
        return {"host": self.host or kv_plane.host_identity(),
                "pid": self.pid, "key": key}

    def release(self, field):
        self.released.append(field["key"])

    def open(self, field, shape, dtype):
        self.opens += 1
        if self.fail_open:
            raise RuntimeError("cudaIpcOpenMemHandle: invalid argument")
        t = self.registry[field["key"]]
        assert list(t.shape) == list(shape) and dtype == "bfloat16"
        return t.clone(), 0.0


class FileIpc:
    """A fake exporter that crosses processes on the CPU: ``export``
    writes the tensor's bits into ``directory`` and the field names the
    file; ``open`` reads it; ``release`` removes it. Picklable, so a
    spawned sink can hold one."""

    def __init__(self, directory: str):
        self.directory = directory

    def probe(self):
        return True, "file-backed fake exporter"

    def export(self, tensor, event):
        path = os.path.join(self.directory, f"{os.getpid()}-{id(tensor)}.npy")
        np.save(path, _bits(tensor))
        return {"host": kv_plane.host_identity(), "pid": os.getpid(),
                "path": path}

    def release(self, field):
        os.remove(field["path"])

    def open(self, field, shape, dtype):
        bits = np.load(field["path"])
        assert list(bits.shape) == list(shape) and dtype == "bfloat16"
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16), 0.0


@pytest.fixture
def plane():
    """A started server factory; every server made is closed after."""
    made = []

    def make(**kw):
        s = KvPlaneServer(**kw)
        s.start()
        made.append(s)
        return s
    yield make
    for s in made:
        s.close()


def _stage_device(server, t, prompt_len=7):
    meta = {"shape": list(t.shape), "dtype": "bfloat16"}
    return server.stage(meta=meta, device_tensor=t,
                        resolve=lambda: _bits(t), prompt_len=prompt_len)


def _wait_staged(server, n, timeout=10.0):
    deadline = time.monotonic() + timeout
    while server.stats()["staged"] != n:
        assert time.monotonic() < deadline, server.stats()
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# Negotiation
# ---------------------------------------------------------------------------

def test_cpu_server_adds_no_field(plane):
    """The real probe on a machine without a card: the path is off, and
    a staged device tensor goes out as a socket ticket."""
    server = plane()
    assert not server.device_path
    assert server.device_path_reason == "no CUDA device"
    t = _parcel()
    ticket = _stage_device(server, t)
    assert "cuda_ipc" not in ticket
    client = KvPlaneClient()
    try:
        np.testing.assert_array_equal(client.pull_sync(ticket), _bits(t))
    finally:
        client.close()
    assert client.stats()["socket_reasons"] == {"no device field": 1}
    assert server.stats()["device_stages"] == 0


@pytest.mark.parametrize("case,reason", [
    ("device", None),
    ("no-field", "no device field"),
    ("jax-ticket", "no device field"),
    ("own-pid", "the source is this process"),
    ("other-host", "another host"),
])
def test_sink_takes_the_device_path_only_on_its_host_from_another_process(
        plane, case, reason):
    registry = {}
    fake = FakeIpc(registry,
                   pid=os.getpid() if case == "own-pid" else None,
                   host="elsewhere/0" if case == "other-host" else None)
    server = plane(ipc=fake, use_device_path=case != "no-field"
                   and case != "jax-ticket")
    t = _parcel(seed=3)
    ticket = _stage_device(server, t)
    if case == "jax-ticket":
        ticket.update(jax_addr="127.0.0.1:1", jax_uuid=ticket["id"])
    assert ("cuda_ipc" in ticket) == (case not in ("no-field", "jax-ticket"))
    client = KvPlaneClient(ipc=FakeIpc(registry))
    try:
        out = client.pull_sync(ticket)
    finally:
        client.close()
    np.testing.assert_array_equal(_bits(out), _bits(t))
    st = client.stats()
    if reason is None:
        assert torch.is_tensor(out)
        assert (st["device_pulls"], st["socket_pulls"],
                st["device_bytes_in"]) == (1, 0, t.nbytes)
        assert client.recent[-1][4] == "device"
        _wait_staged(server, 0)   # "done" freed the staged tensor
        assert server.stats()["device_done"] == 1
        assert fake.released == []
    else:
        assert isinstance(out, np.ndarray)
        assert (st["device_pulls"], st["socket_pulls"]) == (0, 1)
        assert st["socket_reasons"] == {reason: 1}
        assert client.recent[-1][4] == "socket"
        _wait_staged(server, 0)   # popped once its last byte was sent
        # A socket pull of an exported ticket hands the sink's count back.
        assert fake.released == ([1] if "cuda_ipc" in ticket else [])


def test_done_drops_the_entry_and_a_later_socket_pull_fails_expired(plane):
    registry = {}
    server = plane(ipc=FakeIpc(registry))
    t = _parcel(seed=4)
    ticket = _stage_device(server, t)
    client = KvPlaneClient(ipc=FakeIpc(registry))
    try:
        assert torch.equal(client.pull_sync(ticket), t)
        _wait_staged(server, 0)
        plain = {k: v for k, v in ticket.items() if k != "cuda_ipc"}
        with pytest.raises(ConnectionError, match="expired"):
            client.pull_sync(plain)
    finally:
        client.close()
    assert client.stats()["pull_failures"] == 1


def test_ttl_gc_drops_staged_device_tensors(plane, monkeypatch):
    fake = FakeIpc()
    server = plane(ipc=fake)
    t = _parcel(seed=5)
    ref = weakref.ref(t)
    ticket = _stage_device(server, t)
    del t
    fake.registry.clear()
    monkeypatch.setattr(kv_plane, "STAGED_TTL_S", 0.0)
    with server._lock:
        server._gc_locked()
    assert server.stats()["staged"] == 0
    assert fake.released == [ticket["cuda_ipc"]["key"]]
    assert ref() is None, "the expired entry still holds its tensor"


def test_failed_open_is_counted_then_socket_and_the_source_remembered(plane):
    registry = {}
    server = plane(ipc=FakeIpc(registry))
    parcels = [_parcel(seed=s) for s in (6, 7)]
    tickets = [_stage_device(server, p) for p in parcels]
    sink = FakeIpc(registry, fail_open=True)
    client = KvPlaneClient(ipc=sink)
    try:
        outs = [client.pull_sync(t) for t in tickets]
    finally:
        client.close()
    for out, p in zip(outs, parcels):
        np.testing.assert_array_equal(out, _bits(p))
    st = client.stats()
    assert sink.opens == 1, "the second ticket tried the failed source again"
    assert (st["device_pull_failures"], st["device_pulls"],
            st["socket_pulls"], st["pull_failures"]) == (1, 0, 2, 0)
    assert st["socket_reasons"] == {
        "the device open failed": 1,
        "a device open from this source failed before": 1}


def test_jax_client_pulls_a_port_device_ticket_over_the_socket(plane):
    from dynamo_tpu.llm import kv_plane as jplane
    server = plane(ipc=FakeIpc())
    t = _parcel(seed=8)
    ticket = _stage_device(server, t)
    assert "cuda_ipc" in ticket
    client = jplane.KvPlaneClient()
    client._use_jax = False  # the CPU's answer, without the probe
    try:
        out = client.pull_sync(ticket)
    finally:
        client.close()
    np.testing.assert_array_equal(out.view(np.uint16), _bits(t))
    _wait_staged(server, 0)   # counted once its last byte was sent
    assert server.stats()["transfers"] == 1


def _sink(conn, tickets, directory):
    """A spawned sink: pulls each ticket and sends back (path, sha256)."""
    client = KvPlaneClient(ipc=FileIpc(directory))
    out = []
    for t in tickets:
        kv = client.pull_sync(t)
        out.append((client.recent[-1][4],
                    hashlib.sha256(_bits(kv).tobytes()).hexdigest()))
    client.close()
    conn.send(out)
    conn.close()


def test_two_processes_on_the_cpu_through_a_file_backed_exporter(
        plane, tmp_path):
    server = plane(ipc=FileIpc(str(tmp_path)))
    parcels = [_parcel(seed=9), _parcel((2, 2, 2, 5, 16, 32), seed=10)]
    tickets = [_stage_device(server, parcels[0]),
               server.stage(kv=_bits(parcels[1]))]
    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=_sink, args=(child, tickets, str(tmp_path)))
    proc.start()
    try:
        assert parent.poll(120), "the sink did not answer"
        got = parent.recv()
    finally:
        proc.join(60)
    assert not proc.is_alive() and proc.exitcode == 0
    want = [hashlib.sha256(_bits(p).tobytes()).hexdigest() for p in parcels]
    assert got == [("device", want[0]), ("socket", want[1])]
    _wait_staged(server, 0)
    assert server.stats()["device_done"] == 1


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _engine(params=None, quant_kv=None) -> GPUEngine:
    return GPUEngine(tcfg.EngineConfig(model=SPEC, device="cpu",
                                       quant_kv=quant_kv, **ENGINE_KW),
                     params=params, seed=0)


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.default_rng(seed).integers(
        0, SPEC.vocab_size, size=n).tolist()


def _wire(prompt, max_tokens) -> dict:
    return {"model": "tiny-test", "token_ids": list(prompt),
            "stop_conditions": {"max_tokens": max_tokens},
            "sampling_options": {}}


class _LocalPrefill:
    """The decode handler's prefill client, calling a prefill handler in
    this process (the request plane is held by test_torch_disagg.py)."""

    def __init__(self, handle):
        self.handle = handle

    async def generate(self, request, context=None, mode=None):
        return self.handle(request, context or Context())


class _StageTap:
    """Records the keyword arguments of every ``plane.stage`` call."""

    def __init__(self, server):
        self.calls = []
        inner = server.stage

        def stage(**kw):
            self.calls.append(kw)
            return inner(**kw)
        server.stage = stage


@pytest.mark.parametrize("via", ["handler", "queue"])
def test_device_prefill_stages_one_tensor_after_the_prefill(plane, via):
    """Over max_prefill_tokens (a chunked prefill): one finished device
    parcel, no page groups, and on_ticket is not called."""
    engine = _engine()
    server = plane(ipc=FakeIpc())
    tap = _StageTap(server)
    called = []
    prompt = _prompt(1, 100)
    try:
        req = PreprocessedRequest.from_wire(_wire(prompt, 4))
        kw = {"on_ticket": called.append} if via == "handler" else {}
        first, ticket, n = _run(engine.run_job(
            lambda: engine.prefill_extract_staged(req, server, **kw)))
        host = _run(engine.run_job(lambda: engine.runner.extract_pages(
            engine.allocator.lookup(_hashes(prompt)))))
    finally:
        engine.stop()
    assert called == [] and n == 100 and isinstance(first, int)
    assert engine.device_extracts == 1 and engine.streamed_extracts == 0
    (call,) = tap.calls
    assert call.get("resolve_groups") is None
    parcel = call["device_tensor"]
    assert tuple(parcel.shape) == (2, SPEC.num_layers, SPEC.num_kv_heads, 7,
                                   16, SPEC.head_dim)
    assert "cuda_ipc" in ticket and ticket["shape"] == list(parcel.shape)
    # The complete blocks of the prompt (6 of 7 pages) are its pool pages,
    # and the socket resolver gives the same bits.
    np.testing.assert_array_equal(_bits(parcel)[:, :, :, :6], host)
    np.testing.assert_array_equal(call["resolve"](), _bits(parcel))


def _hashes(prompt):
    from dynamo_tpu_torch.llm.tokens import compute_block_hashes
    return compute_block_hashes(prompt, ENGINE_KW["page_size"])


def _inserted_pages(engine, out: list):
    """Record the pool bytes of every parcel inserted into ``engine``,
    right after the insert (on the engine thread)."""
    runner, inner = engine.runner, engine.runner.insert_pages

    def insert(kv, pages):
        inner(kv, pages)
        out.append((torch.is_tensor(kv),
                    [t[:, :, pages].clone() for t in (runner.k_cache,
                                                      runner.v_cache)]))
    runner.insert_pages = insert


def test_device_path_pool_bytes_equal_the_socket_path_and_the_reference(
        plane):
    import jax
    from test_torch_disagg import _assert_clear_margins, _tparams

    from dynamo_tpu.engine import config as jcfg
    from dynamo_tpu.engine import model as jmodel
    from dynamo_tpu.engine.engine import TPUEngine
    from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
    from dynamo_tpu.runtime.context import Context as JContext

    jparams = jmodel.init_params(jcfg.PRESETS["tiny-test"],
                                 jax.random.key(45))
    tparams = _tparams(jparams)
    # A prefill engine per path: a prefix hit on a shared one would
    # prefill the second parcel over history, with other roundings.
    p_engines = [_engine(tparams), _engine(tparams)]
    d_engines = [_engine(tparams), _engine(tparams)]
    jeng = TPUEngine(jcfg.EngineConfig(model=jcfg.PRESETS["tiny-test"],
                                       attention_backend="xla", **ENGINE_KW),
                     params=jparams)
    registry = {}
    prompts = [_prompt(2, 40), _prompt(3, 100)]
    inserted = [[], []]
    try:
        results = []
        for p_engine, d_engine, device, rec in zip(
                p_engines, d_engines, (True, False), inserted):
            _inserted_pages(d_engine, rec)
            server = plane(ipc=FakeIpc(registry), use_device_path=device)
            handler = tdisagg.DisaggDecodeHandler(
                d_engine, _LocalPrefill(tdisagg.make_prefill_handler(
                    p_engine, server)),
                tdisagg.DisaggRouterConfig(max_local_prefill_length=8),
                plane_client=KvPlaneClient(ipc=FakeIpc(registry)))

            async def serve(handler=handler):
                out = []
                for p in prompts:
                    toks = []
                    async for item in handler.generate(_wire(p, 8),
                                                       Context()):
                        toks.extend(item.get("token_ids", []))
                    out.append(toks)
                return out
            results.append(_run(serve()))
            st = handler.plane_client.stats()
            assert (handler.remote_prefills, handler.remote_failures) == (2, 0)
            assert (st["device_pulls"], st["socket_pulls"]) == (
                (2, 0) if device else (0, 2))
            handler.plane_client.close()

        async def ref():
            out = []
            for p in prompts:
                toks = []
                async for item in jeng.generate(JRequest.from_wire(
                        _wire(p, 8)), JContext()):
                    toks.extend(item.get("token_ids", []))
                out.append(toks)
            return out
        want = _run(ref(), timeout=300)
    finally:
        for e in (*p_engines, *d_engines, jeng):
            e.stop()
    device, socket_ = inserted
    assert [d[0] for d in device] == [True, True]
    assert [s[0] for s in socket_] == [False, False]
    for (_, a), (_, b) in zip(device, socket_):
        for x, y in zip(a, b):
            assert torch.equal(x.view(torch.int16), y.view(torch.int16))
    assert results[0] == results[1]
    compared = sum(_assert_clear_margins(jparams, p, r, g, None)
                   for p, r, g in zip(prompts, want, results[0]))
    assert compared >= 8


def test_device_parcel_into_an_int8_pool_holds_quantize_np():
    from dynamo_tpu_torch.engine import runner as trunner
    runner = trunner.ModelRunner(tcfg.EngineConfig(
        model=SPEC, device="cpu", quant_kv="int8", **ENGINE_KW))
    parcel = _parcel((2, SPEC.num_layers, SPEC.num_kv_heads, 3, 16,
                      SPEC.head_dim), seed=11)
    pages = [5, 9, 2]
    runner.insert_pages(parcel, pages)
    q, s = quantize_np(_bits(parcel))
    for i, cache in enumerate((runner.k_cache, runner.v_cache)):
        np.testing.assert_array_equal(cache.data[:, :, pages].numpy(), q[i])
        np.testing.assert_array_equal(
            cache.scale[:, :, pages].numpy().view(np.uint32),
            s[i].view(np.uint32))
    with pytest.raises(ValueError, match="must be bf16"):
        runner.insert_pages(parcel.float(), pages)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

_CHILD = r"""
import hashlib, json, sys
import torch
from dynamo_tpu_torch.llm.kv_plane import KvPlaneClient
from dynamo_tpu_torch.runtime.msgpack_lite import unpackb
tickets = unpackb(open(sys.argv[1], "rb").read())
client = KvPlaneClient()
out = []
for t in tickets:
    kv = client.pull_sync(t)
    bits = (kv.view(torch.int16).cpu().numpy() if torch.is_tensor(kv)
            else kv.view("int16"))
    out.append([client.recent[-1][4], hashlib.sha256(bits.tobytes()).hexdigest()])
client.close()
print(json.dumps({"pulls": out, "stats": client.stats()}), flush=True)
"""


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA IPC has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("alloc_conf", [None, "expandable_segments:True"])
def test_two_processes_over_cuda_ipc_on_gpu(tmp_path, alloc_conf):
    """Parcels of llama-3-8b's page shape staged by a source and pulled
    by a second process land bit-exact over the device path and over the
    socket, and "done" gives the source's memory back. Under
    ``expandable_segments`` (set in a source process of its own, before
    CUDA starts) the outcome is printed: the probe refuses, or the pulls
    land over the device path, or a failed open is counted and they land
    over the socket."""
    _card()
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    if alloc_conf is None:
        result = _source(str(tmp_path), env)
    else:
        env["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
        code = ("import json, sys; sys.path.insert(0, 'tests'); "
                "import test_torch_kv_plane_device as t; "
                "print(json.dumps(t._source(sys.argv[1], None)))")
        proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        result = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"cuda ipc, allocator {alloc_conf or 'default'}: "
          f"{json.dumps(result)}")
    if not result["probe"][0]:
        assert alloc_conf and result["probe"][1].startswith("export failed")
        return
    assert result["match"], result
    assert result["memory_back"], result
    paths = [p for p, _ in result["pulls"]]
    assert paths[1::2] == ["socket"] * 3, paths
    failures = result["stats"]["device_pull_failures"]
    if alloc_conf is None or failures == 0:
        assert paths[0::2] == ["device"] * 3, result
    else:
        assert failures == 1 and paths[0::2] == ["socket"] * 3, result


_CHILD = r"""
import hashlib, json, sys
import torch
from dynamo_tpu_torch.llm.kv_plane import KvPlaneClient
from dynamo_tpu_torch.runtime.msgpack_lite import unpackb
with open(sys.argv[1], "rb") as f:
    tickets = unpackb(f.read())
client = KvPlaneClient()
out = []
for t in tickets:
    kv = client.pull_sync(t)
    bits = (kv.view(torch.int16).cpu().numpy() if torch.is_tensor(kv)
            else kv.view("int16"))
    out.append([client.recent[-1][4],
                hashlib.sha256(bits.tobytes()).hexdigest()])
client.close()
print(json.dumps({"pulls": out, "stats": client.stats()}), flush=True)
"""


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA IPC has no CPU mode")


def _source(directory: str, env) -> dict:
    """The source's side: stage parcels of 1, 8 and 64 pages of
    llama-3-8b's page shape, each as a device ticket and a socket ticket,
    have a child process pull them all (``env``: its environment, None
    for this one's), and compare its hashes and this process's memory."""
    from dynamo_tpu_torch.runtime.msgpack_lite import packb
    server = KvPlaneServer()
    server.start()
    try:
        result = {"probe": [server.device_path, server.device_path_reason]}
        if not server.device_path:
            return result
        g = torch.Generator(device="cuda").manual_seed(0)
        base = torch.cuda.memory_allocated()
        tickets, want = [], []
        for n in (1, 8, 64):
            shape = (2, 32, 8, n, 16, 128)
            for device in (True, False):
                t = torch.randn(shape, generator=g, device="cuda").to(
                    torch.bfloat16)
                ev = torch.cuda.Event(interprocess=True)
                ev.record()
                tickets.append(server.stage(
                    meta={"shape": list(shape), "dtype": "bfloat16"},
                    device_tensor=t if device else None, event=ev,
                    resolve=lambda t=t: _bits(t)))
                want.append(hashlib.sha256(_bits(t).tobytes()).hexdigest())
                del t
        # A pull in the exporting process never takes the device path.
        own = KvPlaneClient()
        assert own._device_refusal(tickets[0]) == "the source is this process"
        own.close()
        path = os.path.join(directory, "tickets.bin")
        with open(path, "wb") as f:
            f.write(packb(tickets))
        proc = subprocess.run([sys.executable, "-c", _CHILD, path], env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        _wait_staged(server, 0)
        torch.cuda.synchronize()
        result.update(pulls=child["pulls"], stats=child["stats"],
                      match=[h for _, h in child["pulls"]] == want,
                      memory_back=torch.cuda.memory_allocated() <= base,
                      failed_opens=[line for line in proc.stderr.splitlines()
                                    if "device pull of KV ticket" in line])
    finally:
        server.close()
    return result
