"""The port's KV parcel codec and KV plane against the JAX package's
(``tests/test_kv_plane.py`` mirrored, on the CPU).

- Parcel bytes: ``quantize_np``, ``dequantize_np``, ``pack_parcel``,
  ``unpack_parcel``, ``parcel_to_bf16``, ``parcel_to_packed`` and
  ``kv_to_chunks`` give the JAX package's bytes for the same numpy
  inputs, bf16 and int8 alike (exact: both are the same integer and
  round-to-nearest-even float operations), and either package's chunks
  assemble into the other's parcel.
- The plane (socket path): stage/pull of a parcel, a deferred resolve,
  page groups; a ticket is served exactly once (a consumed or unknown id
  fails, a racing second pull is refused while the first transmits); a
  failed send leaves the ticket staged for a retry; multi-chunk parcels;
  packed parcels; a G4 ``blocks`` request answers empty.
- Mixed: a port client pulls a JAX server's tickets (bf16, packed,
  grouped; a ticket naming a JAX device path is pulled over its socket
  address) and a JAX client pulls the port server's, byte for byte.
- ``collect_prefill_response`` starts the pull when the ticket lands and
  cancels it when the stream dies; inline chunks assemble; a response
  without a first token raises.
"""

import asyncio
import threading

import ml_dtypes
import numpy as np
import pytest
import torch
from conftest import async_test

from dynamo_tpu.engine import kv_quant as jq
from dynamo_tpu.llm import kv_plane as jplane
from dynamo_tpu.llm import kv_transfer as jxfer
from dynamo_tpu_torch.engine import kv_quant as tq
from dynamo_tpu_torch.llm import kv_transfer as txfer
from dynamo_tpu_torch.llm.kv_plane import KvPlaneClient, KvPlaneServer

torch.set_num_threads(1)

SHAPE = (2, 2, 2, 3, 16, 32)  # [2, L, Nkv, n, page, D]


def _rand_f32(shape=SHAPE, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x[0, 0, 0, 0, 0] = 0.0  # an all-zero row: scale 1
    return x


def _bf16_pair(shape=SHAPE, seed=0):
    """The same bf16 values as the JAX package holds them (ml_dtypes) and
    as the port does (uint16 bits)."""
    j = _rand_f32(shape, seed).astype(ml_dtypes.bfloat16)
    return j, j.view(np.uint16).copy()


def _packed(shape=SHAPE, seed=6) -> np.ndarray:
    rng = np.random.default_rng(seed)
    data = rng.integers(-127, 128, size=shape, dtype=np.int8)
    scale = rng.random(shape[:-1]).astype(np.float32)
    return jq.pack_parcel(data, scale)


# ---------------------------------------------------------------------------
# Parcel bytes
# ---------------------------------------------------------------------------

def test_bf16_conversions_match_ml_dtypes():
    x = _rand_f32(seed=1) * np.float32(1e3)
    x.flat[:6] = [np.inf, -np.inf, 1e-40, -0.0, 3.0e38, 1.0 + 2.0 ** -8]
    bits = tq.f32_to_bf16(x)
    assert bits.dtype == tq.BF16
    np.testing.assert_array_equal(
        bits, x.astype(ml_dtypes.bfloat16).view(np.uint16))
    np.testing.assert_array_equal(
        tq.bf16_to_f32(bits), bits.view(ml_dtypes.bfloat16).astype(np.float32))


def test_host_quantizer_bytes_equal_reference():
    j, t = _bf16_pair(seed=2)
    qj, sj = jq.quantize_np(j)
    qt, st = tq.quantize_np(t)
    assert qt.dtype == np.int8 and st.dtype == np.float32
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(st.view(np.uint32), sj.view(np.uint32))
    f = _rand_f32(seed=3)
    np.testing.assert_array_equal(tq.quantize_np(f)[0], jq.quantize_np(f)[0])
    np.testing.assert_array_equal(
        tq.dequantize_np(qt, st),
        jq.dequantize_np(qj, sj).view(np.uint16))


def test_pack_unpack_and_conversions_equal_reference():
    j, t = _bf16_pair(seed=4)
    packed_j = jq.parcel_to_packed(j)
    packed_t = tq.parcel_to_packed(t)
    assert packed_t.dtype == np.uint8
    assert packed_t.shape == SHAPE[:-1] + (SHAPE[-1] + tq.KV_SCALE_BYTES,)
    np.testing.assert_array_equal(packed_t, packed_j)
    data, scale = tq.unpack_parcel(packed_t)
    dj, sj = jq.unpack_parcel(packed_j)
    np.testing.assert_array_equal(data, dj)
    np.testing.assert_array_equal(scale, sj)
    np.testing.assert_array_equal(tq.pack_parcel(data, scale), packed_j)
    np.testing.assert_array_equal(tq.parcel_to_bf16(packed_t),
                                  jq.parcel_to_bf16(packed_j).view(np.uint16))
    assert tq.parcel_to_bf16(t) is t and tq.parcel_to_packed(packed_t) \
        is packed_t
    assert tq.is_packed_parcel(packed_t) and not tq.is_packed_parcel(t)


@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_chunks_equal_reference(form, monkeypatch):
    """kv_to_chunks: the same meta and chunk bytes as the JAX package's
    (with a small chunk size, so a parcel takes several), and each
    package assembles the other's chunks into its own parcel."""
    if form == "bf16":
        j, t = _bf16_pair(shape=(2, 2, 2, 5, 16, 32), seed=5)
    else:
        j = _packed(shape=(2, 2, 2, 5, 16, 32))
        t = j.copy()
    monkeypatch.setattr(jxfer, "CHUNK_BYTES", 4096)
    monkeypatch.setattr(txfer, "CHUNK_BYTES", 4096)
    meta_j, chunks_j = jxfer.kv_to_chunks(j)
    meta_t, chunks_t = txfer.kv_to_chunks(t)
    assert meta_t == meta_j and len(chunks_t) > 1
    assert meta_t["dtype"] == ("bfloat16" if form == "bf16" else "uint8")
    assert chunks_t == chunks_j
    back_t = txfer.kv_from_chunks(meta_j, chunks_j)
    np.testing.assert_array_equal(back_t, t)
    assert back_t.flags.writeable
    back_j = jxfer.kv_from_chunks(meta_t, chunks_t)
    assert back_j.dtype == j.dtype
    np.testing.assert_array_equal(back_j.view(np.uint8), j.view(np.uint8))
    with pytest.raises(ValueError):
        txfer.kv_from_chunks(meta_t, chunks_t[:-1])


# ---------------------------------------------------------------------------
# The plane
# ---------------------------------------------------------------------------

@pytest.fixture
def plane():
    server = KvPlaneServer()
    server.start()
    client = KvPlaneClient()
    yield server, client
    client.close()
    server.close()


async def _poll(predicate, timeout=5.0):
    for _ in range(int(timeout / 0.01)):
        if predicate():
            return
        await asyncio.sleep(0.01)
    assert predicate()


@async_test
async def test_stage_pull_roundtrip(plane):
    server, client = plane
    _, kv = _bf16_pair()
    ticket = server.stage(kv=kv, prompt_len=48)
    assert ticket["prompt_len"] == 48 and ticket["dtype"] == "bfloat16"
    assert ticket["nbytes"] == kv.nbytes
    out = await client.pull(ticket)
    assert out.dtype == tq.BF16
    np.testing.assert_array_equal(out, kv)
    assert client.transfers == 1 and client.bytes_in == kv.nbytes
    await _poll(lambda: server.bytes_out == kv.nbytes)
    assert server.transfers == 1


@async_test
async def test_deferred_resolve_runs_on_pull(plane):
    server, client = plane
    _, kv = _bf16_pair(seed=1)
    calls = []

    def resolve():
        calls.append(threading.current_thread().name)
        return kv

    ticket = server.stage(meta={"shape": list(kv.shape),
                                "dtype": "bfloat16"}, resolve=resolve)
    assert not calls  # staging does not resolve
    out = await client.pull(ticket)
    assert len(calls) == 1 and calls[0] != threading.main_thread().name
    np.testing.assert_array_equal(out, kv)


@async_test
async def test_pull_twice_and_unknown_id_fail(plane):
    server, client = plane
    _, kv = _bf16_pair(seed=2)
    ticket = server.stage(kv=kv)
    await client.pull(ticket)
    with pytest.raises((ConnectionError, OSError), match="expired"):
        await client.pull(ticket)  # served once: consumed
    with pytest.raises((ConnectionError, OSError)):
        await client.pull({**ticket, "id": 999999})
    assert client.pull_failures == 2


@async_test
async def test_concurrent_pulls_serve_exactly_once(plane):
    """A second pull of a ticket while the first transmits is refused,
    so the parcel is sent and counted once."""
    server, client = plane
    _, kv = _bf16_pair(seed=7)
    release = threading.Event()
    calls = []

    def resolve():
        calls.append(1)
        release.wait(timeout=10)  # hold the first pull mid-serve
        return kv

    ticket = server.stage(meta={"shape": list(kv.shape),
                                "dtype": "bfloat16"}, resolve=resolve)
    first = asyncio.ensure_future(client.pull(ticket))
    await _poll(lambda: calls)
    rival = KvPlaneClient()
    try:
        with pytest.raises((ConnectionError, OSError), match="in progress"):
            # One attempt: the retry policy would wait out the first pull.
            await asyncio.get_running_loop().run_in_executor(
                None, rival._pull_socket_once, ticket)
        release.set()
        out = await first
        np.testing.assert_array_equal(out, kv)
    finally:
        release.set()
        rival.close()
    await _poll(lambda: server.bytes_out)
    assert server.transfers == 1 and server.bytes_out == kv.nbytes
    assert calls == [1]


@async_test
async def test_failed_send_restages_ticket(plane):
    """A resolve that fails releases the claim: one transient fault is
    absorbed by the client's own retries (policies.KV_PULL); a lasting
    one exhausts them, and a later client still finds the ticket."""
    server, client = plane
    _, kv = _bf16_pair(seed=8)
    faults = [True]

    def resolve():
        if faults and faults.pop():
            raise RuntimeError("device fault")
        return kv

    meta = {"shape": list(kv.shape), "dtype": "bfloat16"}
    out = await client.pull(server.stage(meta=meta, resolve=resolve))
    np.testing.assert_array_equal(out, kv)
    # 1 + 3 attempts of the first client fail, then two of the second.
    faults2 = [True] * 6

    def resolve2():
        if faults2 and faults2.pop():
            raise RuntimeError("device fault")
        return kv

    ticket = server.stage(meta=meta, resolve=resolve2)
    with pytest.raises((ConnectionError, OSError), match="resolve failed"):
        await client.pull(ticket)
    retry = KvPlaneClient()
    try:
        np.testing.assert_array_equal(await retry.pull(ticket), kv)
    finally:
        retry.close()


@async_test
async def test_failed_group_severs_and_restages(plane):
    """A page group that fails after the header went out severs the
    connection; the ticket stays staged and a retry gets the parcel."""
    server, client = plane
    _, kv = _bf16_pair(shape=(2, 2, 2, 4, 16, 32), seed=9)
    faults = [True]

    def second():
        if faults and faults.pop():
            raise RuntimeError("copy failed")
        return kv[:, :, :, 2:]

    ticket = server.stage(meta={"shape": list(kv.shape),
                                "dtype": "bfloat16"},
                          resolve_groups=[(2, lambda: kv[:, :, :, :2]),
                                          (2, second)])
    out = await client.pull(ticket)  # the retry inside pull() succeeds
    np.testing.assert_array_equal(out, kv)
    assert not faults
    # The server thread counts the transfer after its last group went out,
    # which may be after pull() has returned.
    await _poll(lambda: server.transfers == 1)


@async_test
async def test_large_parcel_multi_chunk(plane):
    server, client = plane
    kv = np.arange(6 << 20, dtype=np.float32).reshape(2, 3 << 20 >> 1, 2)
    out = await client.pull(server.stage(kv=kv))
    np.testing.assert_array_equal(kv, out)


@async_test
async def test_grouped_stage_pull_roundtrip(plane):
    server, client = plane
    _, kv = _bf16_pair(shape=(2, 2, 2, 7, 16, 32), seed=5)
    groups = [(3, lambda: kv[:, :, :, :3]), (3, lambda: kv[:, :, :, 3:6]),
              (1, lambda: kv[:, :, :, 6:])]
    ticket = server.stage(meta={"shape": list(kv.shape),
                                "dtype": "bfloat16"},
                          resolve_groups=groups, prompt_len=112)
    out = await client.pull(ticket)
    np.testing.assert_array_equal(out, kv)
    await _poll(lambda: server.transfers == 1)


@async_test
async def test_quant_parcel_stage_pull_roundtrip(plane):
    """Packed parcels ride the plane as uint8 at (D+4)/(2D) of the bf16
    bytes."""
    server, client = plane
    kv = _packed()
    ticket = server.stage(kv=kv, prompt_len=48)
    assert ticket["dtype"] == "uint8" and ticket["nbytes"] == kv.nbytes
    d = SHAPE[-1]
    assert kv.nbytes / (np.prod(SHAPE) * 2) == (d + 4) / (2 * d)
    out = await client.pull(ticket)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, kv)


@async_test
async def test_blocks_request_answers_empty(plane):
    """The G4 op: the port has no block source yet, so a JAX peer's
    fetch finds nothing."""
    server, _ = plane
    jclient = jplane.KvPlaneClient()
    try:
        hashes, blocks = await jclient.fetch_blocks(server.address, [1, 2])
    finally:
        jclient.close()
    assert hashes == [] and blocks is None
    assert server.block_requests == 1


# ---------------------------------------------------------------------------
# Mixed packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["bf16", "int8", "grouped"])
@async_test
async def test_port_client_pulls_jax_server(form):
    server = jplane.KvPlaneServer(use_jax_path=False)
    server.start()
    client = KvPlaneClient()
    try:
        if form == "int8":
            j = _packed()
            want = j
            ticket = server.stage(kv=j, prompt_len=48)
        else:
            j, want = _bf16_pair(seed=10)
            if form == "grouped":
                groups = [(2, lambda: j[:, :, :, :2]),
                          (1, lambda: j[:, :, :, 2:])]
                ticket = server.stage(
                    meta={"shape": list(j.shape), "dtype": "bfloat16"},
                    resolve_groups=groups, prompt_len=48)
            else:
                ticket = server.stage(kv=j, prompt_len=48)
        # A JAX ticket may name its device path; the port pulls over addr.
        ticket = dict(ticket, jax_addr="127.0.0.1:1", jax_uuid=ticket["id"])
        out = await client.pull(ticket)
        assert out.dtype == want.dtype
        np.testing.assert_array_equal(out, want)
    finally:
        client.close()
        server.close()


@pytest.mark.parametrize("form", ["bf16", "int8", "grouped"])
@async_test
async def test_jax_client_pulls_port_server(form):
    server = KvPlaneServer()
    server.start()
    client = jplane.KvPlaneClient()
    client._use_jax = False
    try:
        if form == "int8":
            t = want = _packed()
            ticket = server.stage(kv=t, prompt_len=48)
        else:
            want, t = _bf16_pair(seed=11)
            if form == "grouped":
                ticket = server.stage(
                    meta={"shape": list(t.shape), "dtype": "bfloat16"},
                    resolve_groups=[(1, lambda: t[:, :, :, :1]),
                                    (2, lambda: t[:, :, :, 1:])])
            else:
                ticket = server.stage(kv=t, prompt_len=48)
        out = await client.pull(ticket)
        assert out.dtype == want.dtype
        np.testing.assert_array_equal(out.view(np.uint8), want.view(np.uint8))
    finally:
        client.close()
        server.close()


@async_test
async def test_collect_pulls_at_the_ticket_and_cancels_on_stream_death():
    """The pull starts the moment the ticket lands, before the first
    token; a stream that dies after it cancels the pull."""
    events = []

    class Client:
        async def pull(self, ticket):
            events.append(("pull", ticket["id"]))
            try:
                await asyncio.sleep(3600)
            except asyncio.CancelledError:
                events.append(("cancelled", ticket["id"]))
                raise

    async def dying():
        yield {"disagg_params": {"ticket": {"id": 7}}}
        await asyncio.sleep(0.05)
        assert events == [("pull", 7)]  # pulling while the stream runs
        raise ConnectionError("stream lost")

    with pytest.raises(ConnectionError):
        await txfer.collect_prefill_response(dying(), plane_client=Client())
    await asyncio.sleep(0)
    assert events == [("pull", 7), ("cancelled", 7)]

    async def inline():
        kv = _bf16_pair(seed=12)[1]
        meta, chunks = txfer.kv_to_chunks(kv)
        yield {"disagg_params": meta}
        for chunk in chunks:
            yield {"disagg_params": {"kv_chunk": chunk}}
        yield {"token_ids": [5]}

    first, kv = await txfer.collect_prefill_response(inline())
    assert first == 5
    np.testing.assert_array_equal(kv, _bf16_pair(seed=12)[1])

    async def no_token():
        yield {"disagg_params": {"shape": [0], "dtype": "uint8",
                                 "n_chunks": 1}}

    with pytest.raises(RuntimeError, match="incomplete"):
        await txfer.collect_prefill_response(no_token())
