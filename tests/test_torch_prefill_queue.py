"""Queue-based prefill dispatch in the port (``tests/test_prefill_queue.py``
mirrored, on the CPU at tiny-test widths).

- A port decode handler with a ``QueuePrefillDispatcher`` and a port
  ``QueuePrefillWorker`` over the coordinator's ``prefillq/<model>``
  queue: greedy and seeded tokens equal the aggregated engine's, and the
  parcel rides the KV plane.
- Queue depth at ``max_queue_depth`` sends the prompt to local prefill
  without enqueueing; a reply that never comes falls back to local
  prefill after ``reply_timeout``; a remote error reply does too.
- Mixed: a JAX ``QueuePrefillWorker`` (``TPUEngine``) serves a port
  dispatcher, and a port queue worker a JAX dispatcher, from one queue
  (the same items, subjects and replies); the decode side's greedy tokens
  equal the JAX aggregated engine's at clear margins.
- The worker CLI takes the queue flags.
"""

import pytest
import torch
from conftest import async_test
from test_torch_disagg import (_agg, _assert_clear_margins, _prompt, _serve,
                               _tparams, _wire, jax_engine, jparams,
                               port_engine, start_stack, stop_stack)

from dynamo_tpu.llm import kv_plane as jplane
from dynamo_tpu.llm import prefill_queue as jqueue
from dynamo_tpu.engine.engine import TPUEngine
from dynamo_tpu_torch.backends import gpu
from dynamo_tpu_torch.llm import prefill_queue as tqueue
from dynamo_tpu_torch.llm.kv_plane import KvPlaneClient

torch.set_num_threads(1)

__all__ = ["jparams"]  # the module fixture, shared with test_torch_disagg


async def start_queue_stack(p_engine, d_engine, max_queue_depth=8,
                            reply_timeout=60.0):
    """The 1P1D stack of ``test_torch_disagg`` rewired for queue dispatch:
    the prefill worker pops the shared queue, the decode handler
    enqueues."""
    s = await start_stack(p_engine, d_engine, plane=True)
    p_pkg = jqueue if isinstance(p_engine, TPUEngine) else tqueue
    d_pkg = jqueue if isinstance(d_engine, TPUEngine) else tqueue
    s.queue_worker = p_pkg.QueuePrefillWorker(
        p_engine, s.p_rt.require_coordinator(), "tiny-test", s.plane,
        poll_timeout=0.2)
    s.queue_worker.start()
    if d_pkg is jqueue:
        plane_client = jplane.KvPlaneClient()
        plane_client._use_jax = False
    else:
        plane_client = KvPlaneClient()
    s.dispatcher = d_pkg.QueuePrefillDispatcher(
        s.d_rt.require_coordinator(), "tiny-test", plane_client,
        max_queue_depth=max_queue_depth, reply_timeout=reply_timeout)
    s.handler.queue_dispatcher = s.dispatcher
    return s


async def stop_queue_stack(s):
    await s.queue_worker.stop()
    s.dispatcher.plane_client.close()
    await stop_stack(s)


@pytest.fixture(scope="module")
def engines(jparams):
    """Port prefill, decode and aggregated engines with the JAX params."""
    tparams = _tparams(jparams)
    out = [port_engine(tparams) for _ in range(3)]
    yield out
    for e in out:
        e.stop()


@async_test(timeout=120)
async def test_queue_dispatch_token_identical(engines):
    p_engine, d_engine, agg = engines
    s = await start_queue_stack(p_engine, d_engine)
    try:
        requests = [_wire(_prompt(40, 24), 10), _wire(_prompt(41, 90), 8),
                    _wire(_prompt(42, 30), 10, temperature=0.9, seed=7)]
        got = [await _serve(s, r) for r in requests]
        assert s.dispatcher.enqueued == 3
        assert s.queue_worker.pulled == 3 and s.queue_worker.failed == 0
        assert (s.handler.remote_prefills, s.handler.remote_failures) == (3, 0)
        assert s.plane.transfers == 3  # every parcel rode the plane
        assert got == [await _agg(agg, r) for r in requests]
    finally:
        await stop_queue_stack(s)


@async_test(timeout=120)
async def test_queue_depth_backpressure_goes_local(engines):
    p_engine, d_engine, _ = engines
    s = await start_queue_stack(p_engine, d_engine, max_queue_depth=2)
    try:
        await s.queue_worker.stop()  # nobody drains the stuffing
        client = s.d_rt.require_coordinator()
        for i in range(2):
            await client.queue_push(tqueue.queue_name("tiny-test"),
                                    {"req": {}, "reply": f"junk{i}"})
        got = await _serve(s, _wire(_prompt(43, 24), 6))
        assert len(got) == 6
        assert (s.dispatcher.backpressured, s.dispatcher.enqueued) == (1, 0)
        assert s.handler.local_prefills == 1
    finally:
        await stop_queue_stack(s)


@async_test(timeout=120)
async def test_queue_reply_timeout_and_error_fall_back_local(engines):
    p_engine, d_engine, _ = engines
    s = await start_queue_stack(p_engine, d_engine, reply_timeout=0.5)
    try:
        await s.queue_worker.stop()  # no worker will ever reply
        assert len(await _serve(s, _wire(_prompt(44, 24), 6))) == 6
        assert s.dispatcher.enqueued == 1 and s.handler.local_prefills == 1
        # A worker that fails the prefill replies with its error.
        stale = await s.p_rt.require_coordinator().queue_pop(
            tqueue.queue_name("tiny-test"), timeout=0.1)
        assert stale is not None  # the timed-out request's item
        s.queue_worker = tqueue.QueuePrefillWorker(
            p_engine, s.p_rt.require_coordinator(), "tiny-test", s.plane,
            poll_timeout=0.2)
        s.queue_worker.start()
        s.dispatcher.reply_timeout = 30.0

        def failing(*args, **kwargs):
            raise RuntimeError("prefill failed")

        p_engine.prefill_extract_staged = failing
        try:
            assert len(await _serve(s, _wire(_prompt(45, 24), 6))) == 6
        finally:
            del p_engine.prefill_extract_staged
        assert s.queue_worker.failed == 1
        assert s.dispatcher.enqueued == 2 and s.handler.local_prefills == 2
    finally:
        await stop_queue_stack(s)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
@async_test(timeout=180)
async def test_mixed_queue_fleet(jparams, direction):
    jeng = jax_engine(jparams)
    teng = port_engine(_tparams(jparams))
    p_engine, d_engine = ((jeng, teng) if direction == "jax-to-port"
                          else (teng, jeng))
    prompts = [_prompt(46 if direction == "jax-to-port" else 47, n)
               for n in (24, 40)]
    s = None
    try:
        ref = [await _agg(jeng, _wire(p, 8)) for p in prompts]
        s = await start_queue_stack(p_engine, d_engine)
        got = [await _serve(s, _wire(p, 8)) for p in prompts]
        assert s.dispatcher.enqueued == 2 and s.queue_worker.pulled == 2
        assert (s.handler.remote_prefills, s.handler.remote_failures) == (2, 0)
        compared = sum(_assert_clear_margins(jparams, p, r, g, None)
                       for p, r, g in zip(prompts, ref, got))
        assert compared >= 8
    finally:
        if s is not None:
            await stop_queue_stack(s)
        jeng.stop()
        teng.stop()


def test_worker_cli_queue_flags():
    args = gpu.parse_args(["--mode", "decode", "--prefill-dispatch", "queue",
                           "--max-prefill-queue-depth", "4"])
    assert (args.prefill_dispatch, args.max_prefill_queue_depth) == ("queue",
                                                                     4)
    args = gpu.parse_args([])
    assert (args.prefill_dispatch, args.max_prefill_queue_depth) == (
        "direct", 8)
