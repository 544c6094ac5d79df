"""GPU worker: serves GPUEngine as a registered model (the aggregated mode
of ``dynamo_tpu.backends.tpu``).

    python -m dynamo_tpu_torch.backends.gpu --model llama-3-8b --coordinator-url tcp://127.0.0.1:4222
    python -m dynamo_tpu_torch.backends.gpu --model /path/to/checkpoint --quant int8

connects to the coordinator (and fails with its connection error when it
cannot be reached), builds the engine off the event loop so lease
keepalives keep flowing while the weights load, serves
``{namespace}/{component}/{endpoint}`` (``gpu/generate`` by default) on
the request plane, registers the model with ``register_llm`` and prints
``GPU_WORKER_READY mode=agg port=N worker=<hex> pages=N``. On SIGINT or
SIGTERM it deregisters, stops the endpoint and the engine, closes the
runtime and exits 0. The engine runs on ``--device`` (``cuda`` by
default; the CPU only under ``--device cpu``). ``--model`` resolves as in
the launcher (``engine/hub.py``: a preset with random weights from
``--seed``, a checkpoint directory, or a hub id in the local HF cache;
nothing is downloaded) and ``--quant int8`` serves int8 weights. The
tokenizer is, as in the reference worker, ``--tokenizer`` first, then the
checkpoint's ``tokenizer.json``, then, for a preset, the repo's test
tokenizer.

The reference worker's other flags are refused with the ROADMAP item each
waits for; none is accepted and then ignored.
"""

from __future__ import annotations

import argparse
import asyncio
import signal

from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.launch import (add_engine_args, add_refused_flags,
                                     build_engine_config, load_engine,
                                     load_tokenizer)
from dynamo_tpu_torch.llm.model_card import (ModelRuntimeConfig,
                                             deregister_llm, register_llm)
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.service import EndpointServer

log = get_logger("gpu_worker")

_DISAGG = "ROADMAP item 8 (disaggregated prefill and decode, the KV plane)"
_PARALLEL = "ROADMAP item 16 (parallelism across GPUs and nodes)"
_TIERS = "ROADMAP item 9 (host and disk KV tiers)"
_LORA = "ROADMAP item 11 (batched LoRA)"
_SPEC = "ROADMAP item 10 (speculative decode)"
_ADMISSION = "ROADMAP item 12 (SLA admission and brownout)"
_PARSERS = "the ROADMAP item of the tool-call and reasoning parsers"

# The reference worker's flags that the port does not serve:
# (flag, what it waits for, add_argument keywords). A value in "allowed"
# is the reference's default, which leaves the feature off.
REFUSED_FLAGS = (
    ("--mode", _DISAGG, {"type": str, "allowed": ("agg",)}),
    ("--max-local-prefill-length", _DISAGG, {"type": int}),
    ("--prefill-dispatch", _DISAGG, {"type": str}),
    ("--max-prefill-queue-depth", _DISAGG, {"type": int}),
    ("--prefill-component", _DISAGG, {"type": str}),
    ("--kv-plane-host", _DISAGG, {"type": str}),
    ("--no-kv-plane", _DISAGG, {}),
    ("--lora", _LORA, {"type": str}),
    ("--max-adapters", _LORA, {"type": int}),
    ("--max-lora-rank", _LORA, {"type": int}),
    ("--spec-decode", _SPEC, {"type": str}),
    ("--spec-k", _SPEC, {"type": int}),
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


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="dynamo_tpu_torch GPU engine worker (aggregated mode)")
    add_engine_args(parser)
    parser.add_argument("--namespace", default=None)
    parser.add_argument("--component", default="gpu")
    parser.add_argument("--endpoint", default="generate")
    parser.add_argument("--coordinator-url", default=None,
                        help="default: DTPU_COORDINATOR_URL, else "
                             "tcp://127.0.0.1:4222")
    parser.add_argument("--migration-limit", type=int, default=0)
    add_refused_flags(parser, REFUSED_FLAGS)
    return parser.parse_args(argv)


async def serve_engine(runtime: DistributedRuntime, engine: GPUEngine,
                       model_name: str, tokenizer: Tokenizer,
                       component: str = "gpu", endpoint: str = "generate",
                       migration_limit: int = 0) -> EndpointServer:
    """Serve ``engine.handler()`` at ``{namespace}/{component}/{endpoint}``
    and register the model on the runtime's primary lease; the caller
    deregisters and shuts the server down."""
    cfg = engine.config
    ep = runtime.namespace().component(component).endpoint(endpoint)
    # Fast shutdown: in-flight streams end typed "incomplete", so the
    # front's migration re-issues them elsewhere.
    server = await ep.serve_endpoint(engine.handler(),
                                     graceful_shutdown=False)
    try:
        await register_llm(
            runtime, ep, model_name, tokenizer,
            context_length=cfg.max_model_len,
            kv_cache_block_size=cfg.page_size,
            migration_limit=migration_limit,
            runtime_config=ModelRuntimeConfig(
                total_kv_blocks=engine.runner.num_pages,
                max_num_seqs=cfg.max_num_seqs,
                extra={"hidden_size": cfg.model.hidden_size}))
    except BaseException:
        await server.shutdown(drain_s=0)
        raise
    return server


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
    engine = server = None
    try:
        engine_cfg = build_engine_config(args)
        ckpt = args.resolved_checkpoint
        tokenizer = load_tokenizer(ckpt, args.tokenizer,
                                   checkpoint_first=False)
        model_name = args.model_name or engine_cfg.model.name
        # Engine construction blocks for seconds (weights, KV pool); run it
        # off the event loop so the coordinator lease keepalives flow.
        engine = await loop.run_in_executor(None, load_engine, engine_cfg,
                                            ckpt, args.seed)
        server = await serve_engine(runtime, engine, model_name, tokenizer,
                                    args.component, args.endpoint,
                                    args.migration_limit)
        print(f"GPU_WORKER_READY mode=agg port={server.port} "
              f"worker={runtime.instance_id:x} "
              f"pages={engine.runner.num_pages}", flush=True)
        log.info("serving %s from an engine on %s", model_name,
                 engine.runner.device)
        await runtime.wait_for_shutdown()
    finally:
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.remove_signal_handler(sig)
        if server is not None:
            await deregister_llm(runtime, model_name)
            await server.shutdown()
        if engine is not None:
            engine.stop()
        await runtime.close()


def main(argv=None) -> None:
    asyncio.run(run(parse_args(argv)))


if __name__ == "__main__":
    main()
