"""GPU worker: serves GPUEngine (counterpart of
``dynamo_tpu.backends.tpu``), aggregated or as one side of disaggregated
prefill and decode.

    python -m dynamo_tpu_torch.backends.gpu --model llama-3-8b --coordinator-url tcp://127.0.0.1:4222
    python -m dynamo_tpu_torch.backends.gpu --model /path/to/checkpoint --quant int8
    python -m dynamo_tpu_torch.backends.gpu --mode prefill --model llama-3-8b
    python -m dynamo_tpu_torch.backends.gpu --mode decode --model llama-3-8b --max-local-prefill-length 512
    python -m dynamo_tpu_torch.backends.gpu --model llama-3-8b --spec-decode ngram --spec-k 3
    python -m dynamo_tpu_torch.backends.gpu --model llama-3-8b --lora a=/path/to/peft_a --lora b=/path/to/peft_b

connects to the coordinator (and fails with its connection error when it
cannot be reached), builds the engine off the event loop so lease
keepalives keep flowing while the weights load, serves
``{namespace}/{component}/{endpoint}`` (``gpu/generate`` by default) on
the request plane, registers the model with ``register_llm`` and prints
``GPU_WORKER_READY mode=<agg|prefill|decode> port=N worker=<hex>
pages=N``. On SIGINT or SIGTERM it deregisters, stops the endpoint and the
engine, closes the runtime and exits 0. The engine runs on ``--device`` (``cuda`` by
default; the CPU only under ``--device cpu``). ``--model`` resolves as in
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

The reference worker's other flags are refused with the ROADMAP item each
waits for; none is accepted and then ignored.

In ``agg`` and ``decode`` mode the worker publishes, on its instance id,
its KV events, load metrics and inventory digests
(``llm/kv_router/publisher.py``) for a frontend under ``--router-mode
kv``: the engine is started on the event loop, which its publishers use,
and the digest is republished every two seconds while idle. A prefill
worker registers no model and publishes nothing, as in the reference.

``--mode prefill`` serves ``llm/disagg.make_prefill_handler`` at
``{namespace}/{--prefill-component}/generate`` (``prefill`` by default)
and registers no model; with its KV plane (``llm/kv_plane.py``, bound to
``--kv-plane-host``) it stages parcels there and also pops the shared
prefill queue (``llm/prefill_queue.py``); with ``--no-kv-plane`` parcels
go inline. ``--mode decode`` serves ``DisaggDecodeHandler`` under
``--component`` and registers the model: prompts longer than
``--max-local-prefill-length`` (or the coordinator's ``disagg/<model>``)
prefill on a prefill worker, found by round robin or, with
``--prefill-dispatch queue``, through the queue under
``--max-prefill-queue-depth``. Only a prefill worker starts a KV plane
(the G4 block source that would serve from every worker waits for ROADMAP
item 9), and the ``SetRole`` flips, standby and scale directives of the
reference's role manager wait for the planner's ROADMAP items.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import functools
import signal

from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.llm.disagg import (PREFILL_COMPONENT, PREFILL_ENDPOINT,
                                         DisaggDecodeHandler,
                                         DisaggRouterConfig,
                                         make_prefill_handler)
from dynamo_tpu_torch.llm.kv_plane import KvPlaneServer
from dynamo_tpu_torch.llm.kv_router.publisher import (KvEventPublisher,
                                                      KvInventoryPublisher,
                                                      WorkerMetricsPublisher)
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.launch import (add_engine_args, add_lora_args,
                                     add_refused_flags, lora_args,
                                     load_engine, load_tokenizer)
from dynamo_tpu_torch.llm.model_card import (ModelRuntimeConfig,
                                             deregister_llm, register_adapter,
                                             register_llm)
from dynamo_tpu_torch.llm.prefill_queue import (QueuePrefillDispatcher,
                                                QueuePrefillWorker)
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.service import EndpointServer

log = get_logger("gpu_worker")

_PARALLEL = "ROADMAP item 16 (parallelism across GPUs and nodes)"
_TIERS = "ROADMAP item 9 (host and disk KV tiers)"
_ADMISSION = "ROADMAP item 12 (SLA admission and brownout)"
_PARSERS = "the ROADMAP item of the tool-call and reasoning parsers"

# The reference worker's flags that the port does not serve:
# (flag, what it waits for, add_argument keywords). A value in "allowed"
# is the reference's default, which leaves the feature off.
REFUSED_FLAGS = (
    ("--host-cache-pages", _TIERS, {"type": int, "allowed": (0,)}),
    ("--kv-disk-cache-dir", _TIERS, {"type": str}),
    ("--kv-watermarks", _TIERS, {"type": str}),
    ("--num-nodes", _PARALLEL, {"type": int, "allowed": (1,)}),
    ("--node-rank", _PARALLEL, {"type": int, "allowed": (0,)}),
    ("--mh-group", _PARALLEL, {"type": str}),
    ("--tp", _PARALLEL, {"type": int, "allowed": (1,)}),
    ("--pp", _PARALLEL, {"type": int, "allowed": (1,)}),
    ("--sp", _PARALLEL, {"type": int, "allowed": (1,)}),
    ("--dp", _PARALLEL, {"type": int, "allowed": (1,)}),
    ("--pp-microbatch", _PARALLEL, {}),
    ("--ring-attention", _PARALLEL, {}),
    ("--standby", "the planner's ROADMAP items (standby workers and scale "
                  "directives)", {}),
    ("--tool-call-parser", _PARSERS, {"type": str}),
    ("--reasoning-parser", _PARSERS, {"type": str}),
    ("--ttft-budget-ms", _ADMISSION, {"type": float}),
    ("--admission-reject-factor", _ADMISSION, {"type": float}),
    ("--attention-backend", "no ROADMAP item: the port has one attention "
                            "path, its paged-attention kernel",
     {"type": str, "allowed": ("auto",)}),
    ("--warmup-prefill-ladder", "no ROADMAP item: the port compiles no "
                                "prefill programs", {}),
)


def build_engine_config(args: argparse.Namespace) -> EngineConfig:
    """The launcher's engine config (with its LoRA slots) with
    ``warmup_windows`` set (a worker makes the smallest bucket's window
    programs before it serves, as the reference's worker does) and the
    worker's speculative decoding."""
    return dataclasses.replace(launch.build_engine_config(args),
                               warmup_windows=True,
                               spec_decode=args.spec_decode,
                               spec_k=args.spec_k)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="dynamo_tpu_torch GPU engine worker")
    add_engine_args(parser)
    add_lora_args(parser)
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
                             "workers")
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
                        help="address the prefill worker's KV plane binds "
                             "and advertises; peers must reach it")
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
    parser.add_argument("--no-kv-plane", action="store_true",
                        help="no KV plane: parcels ride the request plane "
                             "inline, and a prefill worker does not pop "
                             "the prefill queue")
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
                       handler=None, adapters=()) -> EndpointServer:
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
                   migration_limit=migration_limit)

    def runtime_config():
        return ModelRuntimeConfig(
            total_kv_blocks=engine.runner.num_pages,
            max_num_seqs=cfg.max_num_seqs,
            extra={"hidden_size": cfg.model.hidden_size})
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


async def run(args: argparse.Namespace) -> None:
    cfg = RuntimeConfig.from_settings()
    if args.coordinator_url:
        cfg.coordinator_url = args.coordinator_url
    if args.namespace:
        cfg.namespace = args.namespace
    loop = asyncio.get_running_loop()
    runtime = await DistributedRuntime.from_settings(cfg)
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, runtime.shutdown)
    engine = server = plane = queue_worker = disagg = inventory_pub = None
    registered: list[str] = []  # model names whose cards we put
    try:
        engine_cfg = build_engine_config(args)
        ckpt = args.resolved_checkpoint
        tokenizer = load_tokenizer(ckpt, args.tokenizer,
                                   checkpoint_first=False)
        model_name = args.model_name or engine_cfg.model.name
        kv_pub = metrics_pub = inventory_pub = None
        if args.mode != "prefill":
            kv_pub, metrics_pub, inventory_pub = make_publishers(
                runtime, args.component)
        # Engine construction blocks for seconds (weights, KV pool); run it
        # off the event loop so the coordinator lease keepalives flow.
        engine = await loop.run_in_executor(None, functools.partial(
            load_engine, engine_cfg, ckpt, args.seed, start=False,
            kv_publisher=kv_pub, metrics_publisher=metrics_pub))
        # Started for the loop the publishers run on, from an executor:
        # the warmup takes seconds, and the lease keepalives must flow.
        engine.inventory_publisher = inventory_pub
        loras = lora_args(args)
        if loras:
            # Host work (parse, transpose, pad); the uploads happen at
            # first use on the engine thread. Off the loop, so large
            # adapters do not stall the lease keepalives.
            await loop.run_in_executor(None, lambda: [
                engine.register_adapter(n, path=p) for n, p in loras])
        await loop.run_in_executor(None, engine.start, loop)
        if inventory_pub is not None:
            inventory_pub.start_periodic(engine.inventory_digest)
        prefill_component = args.prefill_component or PREFILL_COMPONENT
        if args.mode == "prefill":
            if not args.no_kv_plane:
                plane = KvPlaneServer(host=args.kv_plane_host)
                plane.start()
            server, queue_worker = await serve_prefill(
                runtime, engine, model_name, plane, prefill_component)
        else:
            handler = None
            if args.mode == "decode":
                disagg = await decode_handler(
                    runtime, engine, model_name,
                    args.max_local_prefill_length, prefill_component,
                    args.prefill_dispatch, args.max_prefill_queue_depth)
                handler = disagg.handler()
            adapter_names = [n for n, _ in loras]
            server = await serve_engine(runtime, engine, model_name,
                                        tokenizer, args.component,
                                        args.endpoint, args.migration_limit,
                                        handler=handler,
                                        adapters=adapter_names)
            registered = [model_name, *adapter_names]
        print(f"GPU_WORKER_READY mode={args.mode} port={server.port} "
              f"worker={runtime.instance_id:x} "
              f"pages={engine.runner.num_pages}", flush=True)
        log.info("serving %s from an engine on %s", model_name,
                 engine.runner.device)
        await runtime.wait_for_shutdown()
    finally:
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.remove_signal_handler(sig)
        if inventory_pub is not None:
            inventory_pub.stop_periodic()
        for name in registered:
            await deregister_llm(runtime, name)
        if queue_worker is not None:
            await queue_worker.stop()
        if server is not None:
            await server.shutdown()
        if disagg is not None:
            await close_decode_handler(disagg)
        if plane is not None:
            plane.close()
        if engine is not None:
            engine.stop()
        await runtime.close()


def main(argv=None) -> None:
    asyncio.run(run(parse_args(argv)))


if __name__ == "__main__":
    main()
