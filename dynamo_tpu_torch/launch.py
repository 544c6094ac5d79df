"""One-process launcher of the port (counterpart of ``dynamo_tpu.launch``
``in=http out=tpu``, the "dynamo-run equivalent"): the OpenAI HTTP front,
preprocessor, detokenizing backend and GPUEngine in one process, with no
coordinator and no network hop between front and engine.

    python -m dynamo_tpu_torch.launch in=http out=gpu --model llama-3-8b
    python -m dynamo_tpu_torch.launch --model tiny-test --device cpu

The weights are random from ``--seed``; the tokenizer is ``--tokenizer
PATH`` (a ``tokenizer.json``) or the repo's test tokenizer. It prints
``LAUNCH_READY in=http out=gpu port=N`` once it serves, and stops the
front and the engine on SIGINT or SIGTERM. ``build_engine`` assembles
the engine alone (``chip_smoke.py``, ``profile_decode.py``).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import os
import signal
import sys

from dynamo_tpu_torch.engine.config import PRESETS, EngineConfig
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.discovery import ModelManager, ServedModel
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.model_card import (DEFAULT_CHAT_TEMPLATE,
                                             ModelDeploymentCard, ModelEntry)
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.tokenizer import Tokenizer, make_test_tokenizer
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("launch")

# in=/out= values of the reference's launcher that wait for later slices.
NOT_PORTED = {
    "in=text": "the interactive and batch inputs",
    "in=batch": "the interactive and batch inputs",
    "in=grpc": "the KServe gRPC front",
    "out=dyn": "the worker main and request plane",
}


def _auto_or_int(value: str):
    return value if value == "auto" else int(value)


def parse_args(argv=None) -> argparse.Namespace:
    argv = list(sys.argv[1:] if argv is None else argv)
    io = {"in": "http", "out": "gpu"}
    rest = []
    for a in argv:
        if a.startswith("in=") or a.startswith("out="):
            k, v = a.split("=", 1)
            io[k] = v
        else:
            rest.append(a)
    parser = argparse.ArgumentParser(
        description="dynamo_tpu_torch launcher (in=http out=gpu)")
    parser.add_argument("--model", default="tiny-test",
                        choices=sorted(PRESETS))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights")
    parser.add_argument("--num-pages", type=int, default=None)
    parser.add_argument("--max-num-seqs", type=int, default=32)
    parser.add_argument("--page-size", type=int, default=16)
    parser.add_argument("--max-pages-per-seq", type=int, default=512)
    parser.add_argument("--decode-window", default=8, type=_auto_or_int,
                        help="positive int or 'auto'")
    parser.add_argument("--pipeline-depth", type=int, default=4)
    parser.add_argument("--prefill-chunk-tokens", default="auto",
                        type=_auto_or_int,
                        help="stall-free chunked prefill: prompt tokens "
                             "dispatched as prefill chunks per engine-loop "
                             "iteration before the next decode window; "
                             "'auto' sizes it to about one "
                             "DTPU_WINDOW_TARGET_MS window period "
                             "(DTPU_PREFILL_CHUNK_TOKENS overrides)")
    parser.add_argument("--quant-kv", default=None, choices=["int8"],
                        help="store the paged KV pool as int8 with a f32 "
                             "scale per token and head (about 1.9x the "
                             "pages in the same memory)")
    parser.add_argument("--model-name", default=None,
                        help="served model name (default: --model)")
    parser.add_argument("--tokenizer", default=None,
                        help="path of a tokenizer.json (default: the repo's "
                             "test tokenizer)")
    parser.add_argument("--context-length", type=int, default=8192)
    parser.add_argument("--http-host", default="127.0.0.1")
    parser.add_argument("--http-port", type=int, default=8000,
                        help="0 picks a free port")
    args = parser.parse_args(rest)
    for key, value in io.items():
        wait = NOT_PORTED.get(f"{key}={value}")
        if wait:
            parser.error(f"{key}={value} is not ported yet: it waits for "
                         f"the slice that ports {wait}")
    if io["in"] != "http":
        parser.error(f"in= must be http, got {io['in']!r}")
    if io["out"] != "gpu":
        parser.error(f"out= must be gpu, got {io['out']!r}")
    args.input, args.output = io["in"], io["out"]
    return args


def build_engine_config(args) -> EngineConfig:
    return EngineConfig(
        model=PRESETS[args.model], page_size=args.page_size,
        num_pages=args.num_pages, max_pages_per_seq=args.max_pages_per_seq,
        max_num_seqs=args.max_num_seqs, decode_window=args.decode_window,
        pipeline_depth=args.pipeline_depth,
        prefill_chunk_tokens=args.prefill_chunk_tokens, quant_kv=args.quant_kv,
        device=args.device)


def build_engine(args, **overrides) -> GPUEngine:
    """The real engine, in-process, with random weights from args.seed;
    ``overrides`` set EngineConfig fields that have no flag."""
    if args.output != "gpu":
        raise ValueError(f"out={args.output} is not served by the port")
    config = dataclasses.replace(build_engine_config(args), **overrides)
    engine = GPUEngine(config, seed=args.seed)
    engine.start()
    return engine


def build_local_served(args, engine: GPUEngine | None = None
                       ) -> tuple[ServedModel, GPUEngine]:
    """Static pipeline: Preprocessor -> Backend -> GPUEngine, no network.
    ``engine``: a started engine to serve from (default: ``build_engine``
    of ``args``)."""
    tokenizer = (Tokenizer.from_file(args.tokenizer) if args.tokenizer
                 else make_test_tokenizer())
    engine = engine or build_engine(args)
    name = args.model_name or os.path.basename(args.model.rstrip("/"))
    card = ModelDeploymentCard(name=name, chat_template=DEFAULT_CHAT_TEMPLATE,
                               context_length=args.context_length)
    entry = ModelEntry(model_name=name, namespace="local", component="local",
                       endpoint="generate", model_type="chat", card=card)
    backend = Backend(tokenizer, inner=engine)
    return ServedModel(entry, OpenAIPreprocessor(card, tokenizer,
                                                 inner=backend)), engine


async def start_http(args, engine: GPUEngine | None = None
                     ) -> tuple[HttpService, GPUEngine]:
    """Build the served model and start the HTTP front on the running
    event loop; the caller stops both."""
    served, engine = build_local_served(args, engine)
    manager = ModelManager()
    manager.models[served.name] = served
    service = HttpService(manager, host=args.http_host, port=args.http_port)
    try:
        await service.start()
    except BaseException:
        engine.stop()
        raise
    return service, engine


async def run(args) -> None:
    """Serve until SIGINT or SIGTERM, then stop the front and the engine."""
    loop = asyncio.get_running_loop()
    done = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, done.set)
    try:
        service, engine = await start_http(args)
        try:
            print(f"LAUNCH_READY in={args.input} out={args.output} "
                  f"port={service.port}", flush=True)
            log.info("serving %s from an engine on %s", args.model,
                     engine.runner.device)
            await done.wait()
        finally:
            await service.stop()
            engine.stop()
    finally:
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.remove_signal_handler(sig)


def main(argv=None) -> None:
    asyncio.run(run(parse_args(argv)))


if __name__ == "__main__":
    main()
