"""GPU worker: serves GPUEngine (counterpart of
``dynamo_tpu.backends.tpu``), aggregated or as one side of disaggregated
prefill and decode.

    python -m dynamo_tpu_torch.backends.gpu --model llama-3-8b --coordinator-url tcp://127.0.0.1:4222
    python -m dynamo_tpu_torch.backends.gpu --model /path/to/checkpoint --quant int8
    python -m dynamo_tpu_torch.backends.gpu --mode prefill --model llama-3-8b
    python -m dynamo_tpu_torch.backends.gpu --mode decode --model llama-3-8b --max-local-prefill-length 512
    python -m dynamo_tpu_torch.backends.gpu --model llama-3-8b --spec-decode ngram --spec-k 3
    python -m dynamo_tpu_torch.backends.gpu --model llama-3-8b --lora a=/path/to/peft_a --lora b=/path/to/peft_b
    python -m dynamo_tpu_torch.backends.gpu --model llama-3-8b --host-cache-pages 4096 --kv-disk-cache-dir /var/kv --kv-watermarks 0.2,0.3
    python -m dynamo_tpu_torch.backends.gpu --model llama-3-8b --standby --num-pages 1024

connects to the coordinator (and fails with its connection error when it
cannot be reached), builds the engine off the event loop so lease
keepalives keep flowing while the weights load, serves
``{namespace}/{component}/{endpoint}`` (``gpu/generate`` by default) on
the request plane, registers the model with ``register_llm`` and prints
``GPU_WORKER_READY mode=<agg|prefill|decode|standby> port=N worker=<hex>
pages=N``. On SIGINT or SIGTERM it deregisters, stops the endpoint and the
engine, prints ``GPU_WORKER_EXIT {json}`` (``exit_counters``: windows and
kernel launches since it began to serve, peak device memory, the KV
plane's and the disaggregation counters), closes the runtime and exits
0; SIGUSR1 prints the same counters as ``GPU_WORKER_COUNTERS {json}``
and the worker serves on (they carry the role, its flips, the window
programs captured and, on the card, the device memory allocated). The
engine runs on ``--device`` (``cuda`` by default; the CPU only under
``--device cpu``). ``--model`` resolves as in
the launcher (``engine/hub.py``: a preset with random weights from
``--seed``, a checkpoint directory, or a hub id in the local HF cache;
nothing is downloaded) and ``--quant int8`` serves int8 weights. The
tokenizer is, as in the reference worker, ``--tokenizer`` first, then the
checkpoint's ``tokenizer.json``, then, for a preset, the repo's test
tokenizer.

``--spec-decode ngram`` serves speculative decoding with ``--spec-k``
drafts a verify step (3 by default), as the reference worker does; the
launcher has no such flag, as the reference's has none.

``--lora NAME=PATH`` (repeatable; a HF PEFT directory) serves a LoRA
adapter on the base model: the engine registers it (``engine/lora.py``),
and an agg or decode worker registers one adapter card per name on its
endpoint (``model_card.register_adapter``), so the OpenAI ``model`` field
NAME reaches this worker with the adapter set. ``--max-adapters`` device
slots (default ``max(4, number of --lora)``) hold resident adapters, the
rest hot-load on demand; ``--max-lora-rank`` (default 8) is the rank
every adapter pads to. A prefill worker advertises no adapter names: the
decode side keeps adapter requests local.

``--tool-call-parser`` and ``--reasoning-parser`` name the parsers
(``llm/parsers.py``) of the registered model and adapter cards, which
every front, the JAX package's too, applies to the model's chat streams.

The reference worker's other flags are refused with the ROADMAP item each
waits for; none is accepted and then ignored.

Observability: the engine's series go to the runtime's metrics registry
under ``{namespace}/{component}``; the worker's journal events carry its
instance id and ride the namespace's journal subject
(``JournalPublisher``) to the frontend's ``/debug/timeline``; flight
bundles carry the runtime config. With ``DTPU_SYSTEM_ENABLED=1`` the
worker also runs the system status server (``runtime/health.py``, port
``DTPU_SYSTEM_PORT``, 0 picks one): ``/health``, ``/live``, ``/metrics``
and the debug routes, ``/debug/kv`` answering ``GPUEngine.kv_status``
and ``/debug/profile`` capturing the card's kernels (the worker runs one
empty profiler session at start: a process's first one records
nothing); it registers the server for the frontend's ``/debug/fleet``
and prints ``GPU_WORKER_STATUS port=N`` before the ready line.

The worker publishes, on its instance id and whatever its role, its KV
events, load metrics and inventory digests
(``llm/kv_router/publisher.py``) for a frontend under ``--router-mode
kv`` and for the planner, as the reference's does, so a worker flipped
to agg or decode is seen at once: the engine is started on the event
loop, which its publishers use, and the digest is republished every two
seconds while idle. A prefill worker registers no model.

``--host-cache-pages N`` gives the engine a G2 host-DRAM tier of N pages
and ``--kv-disk-cache-dir DIR`` a G3 disk tier behind it
(``engine/kv_host_cache.py``): blocks evicted from the device pool are
extracted there, and prefix hits on them are uploaded instead of
recomputed. ``--kv-watermarks low,high`` turns on the KVBM's proactive
demotion (``engine/kvbm.py``; DTPU_KV_WATERMARKS overrides).

Every worker runs a KV plane server (``llm/kv_plane.py``, bound to
``--kv-plane-host``) unless ``--no-kv-plane``: it serves peers' G4 block
fetches from the host tiers, and a prefill worker stages parcels on it.
On the card the plane probes its CUDA IPC device path at start and logs
whether it is on and why; a bf16 prefill worker with it stages each
parcel as one device tensor, which a decode worker on the same host pulls
without a host copy (other sinks pull it over the socket). No flag turns
it on or off, as in the reference.
The worker registers ``kvplane/{namespace}/{instance_id:x}`` under its
primary lease and watches that prefix, so its engine's G4 source
(``RemoteBlockSource``) consults the plane of every other worker of the
same model.

``--mode`` is the launch role: the worker changes role live through
the SetRole protocol (``llm/reconfig.py``). A planner's directive or the
status server's POST /control/role drains the in-flight streams (those
cut migrate, typed ``role_flip``) and rebuilds the serving profile around
the same engine (``make_profile_builder``): no weight reload, and no new
window program, since every worker warms its programs whatever its role.
Every worker also answers scale directives (``llm/standby.py``): a
retire drains it out of the fleet (typed ``scale_in``) and it exits.
``--standby`` loads and warms the engine, then parks deregistered on a
``standby/`` key until a promote directive starts its role manager.

``--mode prefill`` serves ``llm/disagg.make_prefill_handler`` at
``{namespace}/{--prefill-component}/generate`` (``prefill`` by default)
and registers no model; with its KV plane it stages parcels there and
also pops the shared prefill queue (``llm/prefill_queue.py``); with
``--no-kv-plane`` parcels go inline. ``--mode decode`` serves
``DisaggDecodeHandler`` under ``--component`` and registers the model:
prompts longer than
``--max-local-prefill-length`` (or the coordinator's ``disagg/<model>``)
prefill on a prefill worker, found by round robin or, with
``--prefill-dispatch queue``, through the queue under
``--max-prefill-queue-depth``.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import functools
import json
import signal

import torch

from dynamo_tpu_torch.engine import attention
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.llm.disagg import (PREFILL_COMPONENT, PREFILL_ENDPOINT,
                                         DisaggDecodeHandler,
                                         DisaggRouterConfig,
                                         make_prefill_handler)
from dynamo_tpu_torch.llm.kv_plane import KvPlaneServer, RemoteBlockSource
from dynamo_tpu_torch.llm.kv_router.publisher import (KvEventPublisher,
                                                      KvInventoryPublisher,
                                                      WorkerMetricsPublisher)
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.engine.config import EngineConfig, parse_watermarks
from dynamo_tpu_torch.launch import (NO_PREFILL_PROGRAMS,
                                     ONE_ATTENTION, PARALLEL,
                                     add_engine_args, add_lora_args,
                                     add_parser_args,
                                     add_refused_flags, lora_args,
                                     load_engine, load_tokenizer)
from dynamo_tpu_torch.llm.model_card import (ModelRuntimeConfig,
                                             deregister_llm, register_adapter,
                                             register_llm)
from dynamo_tpu_torch.llm.prefill_queue import (QueuePrefillDispatcher,
                                                QueuePrefillWorker)
from dynamo_tpu_torch.llm.reconfig import RoleManager, ServingProfile
from dynamo_tpu_torch.llm.standby import ScaleAgent
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.llm.fleet import register_status_server
from dynamo_tpu_torch.runtime import journal, tracing
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.health import SystemStatusServer
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.retry import Backoff, policies
from dynamo_tpu_torch.runtime.service import EndpointServer

log = get_logger("gpu_worker")


# The reference worker's flags that the port does not serve:
# (flag, what it waits for, add_argument keywords). A value in "allowed"
# is the reference's default, which leaves the feature off.
REFUSED_FLAGS = (
    ("--num-nodes", PARALLEL, {"type": int, "allowed": (1,)}),
    ("--node-rank", PARALLEL, {"type": int, "allowed": (0,)}),
    ("--mh-group", PARALLEL, {"type": str}),
    ("--tp", PARALLEL, {"type": int, "allowed": (1,)}),
    ("--pp", PARALLEL, {"type": int, "allowed": (1,)}),
    ("--sp", PARALLEL, {"type": int, "allowed": (1,)}),
    ("--dp", PARALLEL, {"type": int, "allowed": (1,)}),
    ("--pp-microbatch", PARALLEL, {}),
    ("--ring-attention", PARALLEL, {}),
    ("--attention-backend", ONE_ATTENTION,
     {"type": str, "allowed": ("auto",)}),
    ("--warmup-prefill-ladder", NO_PREFILL_PROGRAMS, {}),
)


def build_engine_config(args: argparse.Namespace) -> EngineConfig:
    """The launcher's engine config (with its LoRA slots and KV tiers)
    with ``warmup_windows`` set (a worker makes the smallest bucket's
    window programs before it serves, as the reference's worker does),
    the worker's speculative decoding, its KVBM watermarks and its SLA
    admission (the reject factor only with a budget, as the reference
    worker sets it)."""
    low, high = parse_watermarks(args.kv_watermarks)
    return dataclasses.replace(launch.build_engine_config(args),
                               warmup_windows=True,
                               spec_decode=args.spec_decode,
                               spec_k=args.spec_k,
                               kv_demote_low_watermark=low,
                               kv_demote_high_watermark=high,
                               ttft_budget_ms=args.ttft_budget_ms,
                               admission_reject_factor=(
                                   args.admission_reject_factor
                                   if args.ttft_budget_ms else 0.0))


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="dynamo_tpu_torch GPU engine worker")
    add_engine_args(parser)
    add_lora_args(parser)
    add_parser_args(parser)
    parser.add_argument("--namespace", default=None)
    parser.add_argument("--component", default="gpu")
    parser.add_argument("--endpoint", default="generate")
    parser.add_argument("--coordinator-url", default=None,
                        help="default: DTPU_COORDINATOR_URL, else "
                             "tcp://127.0.0.1:4222")
    parser.add_argument("--migration-limit", type=int, default=0)
    parser.add_argument("--mode", default="agg",
                        choices=["agg", "prefill", "decode"],
                        help="agg = fully local; prefill = prefill-only "
                             "worker (serves KV parcels); decode = decode "
                             "worker forwarding long prompts to prefill "
                             "workers; the launch role, changed live by "
                             "SetRole directives (llm/reconfig.py)")
    parser.add_argument("--standby", action="store_true",
                        help="park as a pre-warmed standby: weights loaded "
                             "and window programs captured, but "
                             "deregistered, announced on a standby/ lease "
                             "key until a promote directive "
                             "(llm/standby.py)")
    parser.add_argument("--max-local-prefill-length", type=int, default=512,
                        help="decode mode: prompts longer than this prefill "
                             "remotely (dynamic through the coordinator's "
                             "disagg/<model> key)")
    parser.add_argument("--prefill-dispatch", default="direct",
                        choices=["direct", "queue"],
                        help="decode mode: round robin to the prefill "
                             "workers, or the shared coordinator queue "
                             "with depth backpressure")
    parser.add_argument("--max-prefill-queue-depth", type=int, default=8,
                        help="queue dispatch: enqueue only while the queue "
                             "is shallower than this, else prefill locally")
    parser.add_argument("--prefill-component", default=None,
                        help="component the prefill workers serve under "
                             f"(default: {PREFILL_COMPONENT!r})")
    parser.add_argument("--kv-plane-host", default="127.0.0.1",
                        help="address the worker's KV plane binds and "
                             "advertises; peers must reach it")
    parser.add_argument("--kv-watermarks", default=None,
                        help="KVBM proactive demotion watermarks 'low,high' "
                             "as fractions of the device pool's free list "
                             "(engine/kvbm.py): while the free share is "
                             "below low, each engine-loop sweep demotes at "
                             "most 16 LRU inactive blocks to the host tier, "
                             "toward high, so the pool settles just above "
                             "low; needs --host-cache-pages "
                             "(DTPU_KV_WATERMARKS overrides)")
    parser.add_argument("--spec-decode", default=None, choices=["ngram"],
                        help="speculative decoding: 'ngram' = prompt-"
                             "lookup self-drafting verified in-window; "
                             "serves greedy and temperature/top-k/top-p/"
                             "seeded sampling (on-device rejection "
                             "sampling keeps the exact output "
                             "distribution); logprobs and penalties "
                             "are not supported under spec decode")
    parser.add_argument("--spec-k", type=int, default=3,
                        help="drafts verified per speculative step")
    parser.add_argument("--ttft-budget-ms", type=float, default=None,
                        help="SLA-aware admission: defer admitting cold "
                             "prefills while the projected TTFT (measured "
                             "prefill rate x cold-token backlog) exceeds "
                             "this budget; a spec engine falls back to "
                             "plain windows under its brownout")
    parser.add_argument("--admission-reject-factor", type=float, default=2.0,
                        help="with --ttft-budget-ms: reject (503) requests "
                             "whose projected TTFT through the backlog "
                             "exceeds budget x this factor, so the router "
                             "retries another worker; 0 = queue unboundedly")
    parser.add_argument("--no-kv-plane", action="store_true",
                        help="no KV plane: parcels ride the request plane "
                             "inline, a prefill worker does not pop the "
                             "prefill queue, and no G4 peer tier")
    add_refused_flags(parser, REFUSED_FLAGS)
    args = parser.parse_args(argv)
    if args.prefill_dispatch == "queue" and args.no_kv_plane:
        parser.error("--prefill-dispatch queue needs the KV plane (queue "
                     "replies carry plane tickets); drop --no-kv-plane or "
                     "use --prefill-dispatch direct")
    return args


def make_publishers(runtime: DistributedRuntime, component: str = "gpu"
                    ) -> tuple[KvEventPublisher, WorkerMetricsPublisher,
                               KvInventoryPublisher]:
    """The KV event, load metrics and inventory publishers of a worker
    serving under ``component``, on the runtime's instance id."""
    ns, wid = runtime.config.namespace, runtime.instance_id
    return (KvEventPublisher(runtime, ns, component, wid),
            WorkerMetricsPublisher(runtime, ns, component, wid),
            KvInventoryPublisher(runtime, ns, component, wid))


async def serve_engine(runtime: DistributedRuntime, engine: GPUEngine,
                       model_name: str, tokenizer: Tokenizer,
                       component: str = "gpu", endpoint: str = "generate",
                       migration_limit: int = 0,
                       handler=None, adapters=(),
                       tool_call_parser: str | None = None,
                       reasoning_parser: str | None = None) -> EndpointServer:
    """Serve ``handler`` (default ``engine.handler()``; a decode worker's
    is ``DisaggDecodeHandler.handler()``) at
    ``{namespace}/{component}/{endpoint}`` and register the model, and one
    adapter card for each name in ``adapters`` (registered on the engine),
    on the runtime's primary lease; the caller deregisters them
    (``deregister_llm``) and shuts the server down."""
    cfg = engine.config
    ep = runtime.namespace().component(component).endpoint(endpoint)
    # Fast shutdown: in-flight streams end typed "incomplete", so the
    # front's migration re-issues them elsewhere.
    server = await ep.serve_endpoint(handler or engine.handler(),
                                     graceful_shutdown=False)
    card_kw = dict(context_length=cfg.max_model_len,
                   kv_cache_block_size=cfg.page_size,
                   migration_limit=migration_limit,
                   tool_call_parser=tool_call_parser,
                   reasoning_parser=reasoning_parser)

    def runtime_config():
        # expected_roofline_frac: the perf expectation a live
        # perf_roofline_frac is compared with.
        return ModelRuntimeConfig(
            total_kv_blocks=engine.runner.num_pages,
            max_num_seqs=cfg.max_num_seqs,
            extra={"hidden_size": cfg.model.hidden_size,
                   "expected_roofline_frac": cfg.expected_roofline_frac})
    try:
        await register_llm(runtime, ep, model_name, tokenizer,
                           runtime_config=runtime_config(), **card_kw)
        for name in adapters:
            await register_adapter(runtime, ep, name, model_name, tokenizer,
                                   runtime_config=runtime_config(),
                                   **card_kw)
    except BaseException:
        await server.shutdown(drain_s=0)
        raise
    return server


async def start_kv_plane(runtime: DistributedRuntime, engine: GPUEngine,
                         model_name: str, host: str = "127.0.0.1"
                         ) -> tuple[KvPlaneServer, asyncio.Task]:
    """Start the worker's KV plane server (serving G4 block fetches from
    the engine's host tiers, if it has any; with the device path when the
    engine is on the card and the plane's probe passes, which it logs),
    register it as
    ``kvplane/{namespace}/{instance_id:x}`` under the primary lease, give
    the engine a G4 source and watch the other planes of ``model_name``.
    Returns (plane, peer watch task); ``close_kv_plane`` stops them."""
    host_cache = engine.host_cache
    on_card = engine.runner.device.type == "cuda"
    plane = KvPlaneServer(host=host, block_provider=(
        host_cache.get if host_cache is not None else None),
        use_device_path=None if on_card else False)
    log.info("KV plane device path %s: %s",
             "on" if plane.device_path else "off",
             plane.device_path_reason if on_card
             else f"the engine runs on {engine.runner.device}")
    plane.start()
    try:
        coordinator = runtime.require_coordinator()
        prefix = f"kvplane/{runtime.config.namespace}/"
        await coordinator.kv_put(
            f"{prefix}{runtime.instance_id:x}",
            {"addr": plane.address, "model": model_name},
            use_primary_lease=True)
        runner = engine.runner
        source = RemoteBlockSource(
            self_addr=plane.address,
            block_nbytes=runner.kv_pool_bytes // runner.num_pages)
        watch = await coordinator.watch_prefix(prefix)
    except BaseException:
        plane.close()
        raise
    engine.plane = plane
    engine.remote_source = source
    task = asyncio.create_task(_watch_peers(coordinator, prefix, watch,
                                            source, model_name))
    return plane, task


async def _watch_peers(coordinator, prefix: str, watch, source,
                       model_name: str) -> None:
    """Keep ``source.peers`` to the registered planes of ``model_name``
    but its own: a put adds or moves a peer, a delete drops it with its
    breaker state (``drop_peer``). It never dies silently: a frozen list
    would miss new workers and keep consulting dead ones, so a failed
    watch is logged and re-established."""
    peers: dict[str, str] = {}

    def reset(snapshot) -> None:
        peers.clear()
        peers.update({item["k"]: item["v"]["addr"] for item in snapshot
                      if item["v"].get("model") == model_name})
        publish()

    def publish() -> None:
        source.peers = [a for a in peers.values() if a != source.self_addr]

    reset(watch.snapshot)
    backoff = Backoff(policies.COORD_RECONNECT)
    while True:
        try:
            async for event in watch:
                if event["event"] == "put":
                    if event["value"].get("model") == model_name:
                        peers[event["key"]] = event["value"]["addr"]
                else:
                    gone = peers.pop(event["key"], None)
                    if gone is not None:
                        source.drop_peer(gone)
                publish()
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — log and re-watch
            log.exception("kvplane peer watch failed; re-watching")
        await backoff.sleep()
        try:
            watch = await coordinator.watch_prefix(prefix)
            reset(watch.snapshot)
            backoff.reset()
        except (ConnectionError, OSError, RuntimeError):
            log.warning("kvplane peer re-watch failed; will retry")


async def close_kv_plane(engine: GPUEngine, plane: KvPlaneServer,
                         task: asyncio.Task) -> None:
    """Stop the peer watch, close the G4 source's client and the plane."""
    task.cancel()
    try:
        await task
    except asyncio.CancelledError:
        pass
    if engine.remote_source is not None:
        engine.remote_source.client.close()
        engine.remote_source = None
    plane.close()
    engine.plane = None


async def serve_prefill(runtime: DistributedRuntime, engine: GPUEngine,
                        model_name: str, plane: KvPlaneServer | None,
                        component: str = PREFILL_COMPONENT):
    """Serve the prefill handler at ``{namespace}/{component}/generate``
    (no model is registered) and, with a KV plane, pop the shared prefill
    queue. Returns (server, queue worker or None); the caller stops
    both."""
    ep = runtime.namespace().component(component).endpoint(PREFILL_ENDPOINT)
    server = await ep.serve_endpoint(make_prefill_handler(engine, plane),
                                     graceful_shutdown=True)
    queue_worker = None
    if plane is not None:
        queue_worker = QueuePrefillWorker(
            engine, runtime.require_coordinator(), model_name, plane)
        queue_worker.start()
    else:
        log.warning("no KV plane: this prefill worker does not pop the "
                    "prefill queue (queue replies carry plane tickets)")
    return server, queue_worker


async def decode_handler(runtime: DistributedRuntime, engine: GPUEngine,
                         model_name: str, max_local_prefill_length: int = 512,
                         prefill_component: str = PREFILL_COMPONENT,
                         dispatch: str = "direct",
                         max_queue_depth: int = 8) -> DisaggDecodeHandler:
    """The decode worker's handler: a client of the prefill workers'
    endpoint, the watched ``disagg/<model>`` threshold and, with
    ``dispatch="queue"``, the queue dispatcher. ``close_decode_handler``
    releases them."""
    ep = runtime.namespace().component(prefill_component).endpoint(
        PREFILL_ENDPOINT)
    prefill_client = await ep.client()
    config = await DisaggRouterConfig.from_coordinator_with_watch(
        runtime.require_coordinator(), model_name,
        default_max_local=max_local_prefill_length)
    handler = DisaggDecodeHandler(engine, prefill_client, config)
    if dispatch == "queue":
        handler.queue_dispatcher = QueuePrefillDispatcher(
            runtime.require_coordinator(), model_name, handler.plane_client,
            max_queue_depth=max_queue_depth)
    return handler


async def close_decode_handler(handler: DisaggDecodeHandler) -> None:
    await handler.prefill_client.close()
    await handler.config.close()
    handler.plane_client.close()


def make_profile_builder(runtime: DistributedRuntime, args, engine: GPUEngine,
                         tokenizer: Tokenizer, model_name: str,
                         plane: KvPlaneServer | None,
                         decode_handlers: list | None = None):
    """``build(role) -> ServingProfile`` around ONE engine, for
    ``RoleManager`` (the reference worker's profile builder). The engine,
    its weights, pool and window programs, lives outside the profile and
    survives every flip; a profile holds what the role registers and the
    machinery around it: the prefill endpoint and queue worker
    (prefill), the decode handler's prefill client, threshold watch and
    plane client (decode), the model and adapter cards (decode, agg). The
    launch role and a flipped-to role are built by the same code; on the
    card a build first returns the allocator's unused cached blocks to
    the card. Each decode handler built is appended to
    ``decode_handlers`` (the exit counters read them)."""
    prefill_component = args.prefill_component or PREFILL_COMPONENT
    adapter_names = [n for n, _ in lora_args(args)]

    async def build(role: str) -> ServingProfile:
        if engine.runner.device.type == "cuda":
            # A new role allocates other transients than the old one (a
            # prefill worker's chunk activations and staged parcels, a
            # decode worker's inserted parcels), so the blocks the old
            # role cached go back to the card, where the other processes
            # sharing it (co-located workers, a standby waiting to be
            # promoted) can take them. The engine's own tensors and window
            # programs stay.
            torch.cuda.empty_cache()
        prof = ServingProfile(role)
        if role == "prefill":
            server, queue_worker = await serve_prefill(
                runtime, engine, model_name, plane, prefill_component)
            prof.add_server(server)
            if queue_worker is not None:
                # A drain pauses the pulls first: queued prompts go to
                # the peers.
                prof.add_pausable(queue_worker)
                prof.add_closer("prefill-queue", queue_worker.stop)
            return prof
        handler = None
        if role == "decode":
            disagg = await decode_handler(
                runtime, engine, model_name, args.max_local_prefill_length,
                prefill_component, args.prefill_dispatch,
                args.max_prefill_queue_depth)
            if decode_handlers is not None:
                decode_handlers.append(disagg)
            handler = disagg.handler()
            prof.add_closer("decode-handler",
                            lambda: close_decode_handler(disagg))
        server = await serve_engine(runtime, engine, model_name, tokenizer,
                                    args.component, args.endpoint,
                                    args.migration_limit, handler=handler,
                                    adapters=adapter_names,
                                    tool_call_parser=args.tool_call_parser,
                                    reasoning_parser=args.reasoning_parser)
        prof.add_server(server)
        for name in (model_name, *adapter_names):
            prof.add_closer(f"card-{name}",
                            lambda n=name: deregister_llm(runtime, n))
        return prof

    return build


def engine_counters(engine: GPUEngine) -> dict:
    """The engine's windows, replays, kernel launches and window programs
    captured so far."""
    return {"windows": engine.windows_dispatched,
            "window_replays": engine.runner.window_replays,
            "launches": attention.KERNEL.launches,
            "launches_int8": attention.KERNEL.launches_int8,
            "captures": engine.runner.window_programs()["captured"]}


def exit_counters(engine: GPUEngine, base: dict, plane,
                  decode_handlers: list, roles: RoleManager | None = None,
                  scale: ScaleAgent | None = None) -> dict:
    """What a worker prints as it exits (``GPU_WORKER_EXIT``): its
    engine's counters since ``base`` (taken when it began to serve), its
    peak and (on the card) allocated device memory, its KV plane server's
    counters, its role, flips and standby state and, once it has served
    as a decode worker, the disaggregation counters summed over its
    decode handlers and the latest handler's plane client's, with the
    recent pulls ``(ticket, header s, end s, bytes, path)``."""
    now = engine_counters(engine)
    on_card = engine.runner.device.type == "cuda"
    out = {"engine": {k: now[k] - base[k] for k in now} | {
        "window_steps": engine.decode_window,
        "layers": engine.runner.spec.num_layers,
        "injected_admissions": engine.injected_admissions,
        "device_extracts": engine.device_extracts,
        "streamed_extracts": engine.streamed_extracts,
        "peak_bytes": torch.cuda.max_memory_allocated() if on_card else 0,
        "allocated_bytes": torch.cuda.memory_allocated() if on_card else 0}}
    if roles is not None:
        out["role"] = {"role": roles.role, "state": roles.state,
                       "epoch": roles.applied_epoch, "flips": roles.flips,
                       "cut_streams": roles.cut_streams}
    if scale is not None:
        out["scale"] = {"state": scale.state,
                        "promotions": scale.promotions,
                        "join_seconds": scale.join_seconds}
    if plane is not None:
        out["plane_server"] = plane.stats()
    if decode_handlers:
        out["disagg"] = {k: sum(getattr(h, k) for h in decode_handlers)
                         for k in ("remote_prefills", "local_prefills",
                                   "remote_failures")}
        client = decode_handlers[-1].plane_client
        out["plane_client"] = client.stats() | {
            "recent": list(client.recent)}
    return out


async def start_observability(runtime: DistributedRuntime,
                              cfg: RuntimeConfig, engine: GPUEngine,
                              model_name: str, component: str,
                              roles: RoleManager | None = None,
                              scale: ScaleAgent | None = None):
    """The worker's observability plane: the SLO plane (a fast-burn page
    writes a flight bundle), the request ledger, the flight recorder's
    bundle context, the journal's worker identity and its delta
    publisher, and, with ``cfg.system_enabled``, the system status server
    (``/debug/perf`` answering ``engine.perf_status``, ``/control/role``
    and ``/control/scale`` answering ``roles`` and ``scale``) registered
    for the fleet pane. Returns (journal publisher, status server or
    None); the caller stops both."""
    worker = f"{runtime.instance_id:x}"
    launch.init_observability(cfg, runtime.metrics, worker=worker)
    journal_pub = journal.JournalPublisher(runtime.require_coordinator(),
                                           cfg.namespace, worker)
    # An empty first delta announces this worker's stream (its boot id)
    # to the timeline before it has any event to ship.
    await journal_pub.flush(force=True)
    journal_pub.start_periodic()
    status_server = None
    if cfg.system_enabled:
        status_server = SystemStatusServer(
            runtime, host=cfg.bind_host, port=cfg.system_port,
            kv_provider=engine.kv_status,
            cuda=engine.runner.device.type == "cuda",
            perf_provider=engine.perf_status, role_manager=roles,
            scale_agent=scale)
        await status_server.start()
        await register_status_server(
            runtime, status_server.port,
            extra={"backend": "gpu", "component": component,
                   "model": model_name})
        print(f"GPU_WORKER_STATUS port={status_server.port}", flush=True)
    return journal_pub, status_server


async def run(args: argparse.Namespace) -> None:
    cfg = RuntimeConfig.from_settings()
    if args.coordinator_url:
        cfg.coordinator_url = args.coordinator_url
    if args.namespace:
        cfg.namespace = args.namespace
    loop = asyncio.get_running_loop()
    if cfg.system_enabled and args.device == "cuda":
        # /debug/profile's sessions start on this thread; the first one
        # a process runs sets CUPTI up for seconds and records nothing,
        # so pay it here, before the lease exists.
        log.info("profiler prepared in %.1fs", tracing.prepare_profiler())
    runtime = await DistributedRuntime.from_settings(cfg)
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, runtime.shutdown)
    engine = plane = peer_task = roles = scale = None
    inventory_pub = base = journal_pub = status_server = None
    decode_handlers: list[DisaggDecodeHandler] = []
    try:
        engine_cfg = build_engine_config(args)
        ckpt = args.resolved_checkpoint
        tokenizer = load_tokenizer(ckpt, args.tokenizer,
                                   checkpoint_first=False)
        model_name = args.model_name or engine_cfg.model.name
        # Every role publishes (a flip must not leave the worker unseen by
        # the KV router and the planner).
        kv_pub, metrics_pub, inventory_pub = make_publishers(
            runtime, args.component)
        # Engine construction blocks for seconds (weights, KV pool); run it
        # off the event loop so the coordinator lease keepalives flow.
        engine = await loop.run_in_executor(None, functools.partial(
            load_engine, engine_cfg, ckpt, args.seed, start=False,
            kv_publisher=kv_pub, metrics_publisher=metrics_pub,
            metrics_registry=runtime.metrics.namespace(cfg.namespace)
            .component(args.component)))
        engine.inventory_publisher = inventory_pub
        loras = lora_args(args)
        if loras:
            # Host work (parse, transpose, pad); the uploads happen at
            # first use on the engine thread. Off the loop, so large
            # adapters do not stall the lease keepalives.
            await loop.run_in_executor(None, lambda: [
                engine.register_adapter(n, path=p) for n, p in loras])
        # Started for the loop the publishers run on, from an executor:
        # the warmup takes seconds, and the lease keepalives must flow.
        await loop.run_in_executor(None, engine.start, loop)
        base = engine_counters(engine)
        if not args.no_kv_plane:
            plane, peer_task = await start_kv_plane(
                runtime, engine, model_name, args.kv_plane_host)
        extra = {"backend": "gpu", "model": model_name}
        roles = RoleManager(runtime, make_profile_builder(
            runtime, args, engine, tokenizer, model_name, plane,
            decode_handlers), role=args.mode, status_extra=extra)
        # Every worker answers scale directives (a retire drains it out
        # and stops it); a standby parks, warmed and deregistered, until
        # a promote starts its role manager.
        scale = ScaleAgent(runtime, roles, standby=args.standby,
                           status_extra=extra, metrics=runtime.metrics)
        # After the journal's worker identity: the standby_ready event
        # carries this worker's id.
        journal_pub, status_server = await start_observability(
            runtime, cfg, engine, model_name, args.component, roles, scale)
        inventory_pub.start_periodic(engine.inventory_digest)
        if not args.standby:
            await roles.start()
        await scale.start()
        port = (roles.profile.servers[0].port
                if roles.profile and roles.profile.servers else 0)
        mode = "standby" if args.standby else args.mode
        print(f"GPU_WORKER_READY mode={mode} port={port} "
              f"worker={runtime.instance_id:x} "
              f"pages={engine.runner.num_pages}", flush=True)
        log.info("serving %s from an engine on %s", model_name,
                 engine.runner.device)
        log.info("perf plane: weight-read step %.3f ms, expected roofline "
                 "fraction %s", engine._step_floor_ms,
                 engine_cfg.expected_roofline_frac)
        # SIGUSR1 prints the same counters and goes on serving: a phase's
        # share of them is the difference of two readings.
        loop.add_signal_handler(signal.SIGUSR1, lambda: print(
            "GPU_WORKER_COUNTERS " + json.dumps(exit_counters(
                engine, base, plane, decode_handlers, roles, scale)),
            flush=True))
        await runtime.wait_for_shutdown()
    finally:
        for sig in (signal.SIGINT, signal.SIGTERM, signal.SIGUSR1):
            loop.remove_signal_handler(sig)
        if inventory_pub is not None:
            inventory_pub.stop_periodic()
        if journal_pub is not None:
            journal_pub.stop_periodic()
        if status_server is not None:
            await status_server.stop()
        # The role manager owns the serving profile: its endpoint
        # servers, cards and role machinery go down through it, whatever
        # role the worker ended in.
        if scale is not None:
            await scale.stop()
        if roles is not None:
            await roles.stop()
        if plane is not None:
            await close_kv_plane(engine, plane, peer_task)
        if engine is not None:
            engine.stop()
            if base is not None:
                print("GPU_WORKER_EXIT " + json.dumps(exit_counters(
                    engine, base, plane, decode_handlers, roles, scale)),
                    flush=True)
        await runtime.close()


def main(argv=None) -> None:
    asyncio.run(run(parse_args(argv)))


if __name__ == "__main__":
    main()
