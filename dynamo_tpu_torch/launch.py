"""Launcher of the port (counterpart of ``dynamo_tpu.launch``, the
"dynamo-run equivalent").

``in=http out=gpu`` runs the OpenAI HTTP front, preprocessor,
detokenizing backend and GPUEngine in one process, with no coordinator and
no network hop between front and engine; ``out=dyn`` runs the same front
over a ``ModelWatcher`` on ``--coordinator-url`` and serves whatever
workers (``python -m dynamo_tpu_torch.backends.gpu``, or the JAX
package's) register there.

    python -m dynamo_tpu_torch.launch in=http out=gpu --model llama-3-8b
    python -m dynamo_tpu_torch.launch --model /path/to/checkpoint --quant int8
    python -m dynamo_tpu_torch.launch --model tiny-test --device cpu
    python -m dynamo_tpu_torch.launch --model llama-3-8b --lora a=/path/to/peft_a
    python -m dynamo_tpu_torch.launch in=http out=dyn --coordinator-url tcp://127.0.0.1:4222

``--model`` is a preset (random weights from ``--seed``), a HF Llama or
Qwen2 checkpoint directory (``config.json`` and ``*.safetensors``), or a
hub id already in the local HF cache (``engine/hub.py``; nothing is
downloaded). ``--quant int8`` serves int8 weights with float32 per-channel
scales. The tokenizer is the checkpoint's own ``tokenizer.json`` (the
reference launcher's choice), else ``--tokenizer PATH`` (a
``tokenizer.json`` or a ``.gguf``), else, for a preset, the repo's test
tokenizer. It prints ``LAUNCH_READY in=http out=<gpu|dyn> port=N`` once
it serves, and stops on SIGINT or SIGTERM. ``--lora NAME=PATH``
(repeatable, ``out=gpu`` only, as in the reference) registers a HF PEFT
adapter on the engine and serves NAME as a model of its own, whose card
binds it to the base model (``served.adapter_served``);
``--max-adapters`` and ``--max-lora-rank`` size the engine's LoRA slots.
``build_engine`` assembles the engine alone (``chip_smoke.py``,
``profile_decode.py``); ``add_engine_args``, ``add_lora_args``,
``build_engine_config`` and ``load_engine`` are shared with the worker
main.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import os
import signal
import sys

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.engine.hub import resolve_model
from dynamo_tpu_torch.engine.runner import check_supported
from dynamo_tpu_torch.engine.weights import load_hf_weights
from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.discovery import (ModelManager, ModelWatcher,
                                            ServedModel)
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.model_card import (DEFAULT_CHAT_TEMPLATE,
                                             ModelDeploymentCard, ModelEntry,
                                             ModelRuntimeConfig)
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.tokenizer import Tokenizer, make_test_tokenizer
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("launch")

# in=/out= values of the reference's launcher that wait for later slices.
NOT_PORTED = {
    "in=text": "the interactive and batch inputs",
    "in=batch": "the interactive and batch inputs",
    "in=grpc": "the KServe gRPC front",
}


def _auto_or_int(value: str):
    return value if value == "auto" else int(value)


class RefusedFlag(argparse.Action):
    """A flag of the reference's entry point that the port does not serve:
    giving it, with a value outside ``allowed``, exits with the ROADMAP
    item it waits for. It is never accepted and then ignored."""

    def __init__(self, option_strings, dest, waits_for: str,
                 allowed=(), **kwargs):
        self.waits_for, self.allowed = waits_for, allowed
        kwargs.setdefault("help", argparse.SUPPRESS)
        super().__init__(option_strings, dest, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        if values not in self.allowed:
            parser.error(f"{option_string} is not ported yet: it waits for "
                         f"{self.waits_for}")
        setattr(namespace, self.dest, values)


def add_refused_flags(parser: argparse.ArgumentParser, flags) -> None:
    """``flags``: (flag, ROADMAP item it waits for, extra add_argument
    keywords) triples; a flag without a ``type`` takes no value."""
    for flag, waits_for, kwargs in flags:
        if "type" not in kwargs:
            kwargs = dict(kwargs, nargs=0)
        parser.add_argument(flag, action=RefusedFlag, waits_for=waits_for,
                            **kwargs)


def add_engine_args(parser: argparse.ArgumentParser) -> None:
    """The engine's flags, shared by the launcher and the worker main."""
    parser.add_argument("--model", default="tiny-test",
                        help="a preset, a HF checkpoint directory or a hub "
                             "id in the local HF cache (never downloaded)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of a preset's random weights")
    parser.add_argument("--quant", default=None, choices=["int8"],
                        help="weight-only int8: int8 weights with a float32 "
                             "scale per output channel, bf16 compute (half "
                             "the weight bytes)")
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
                        help="path of a tokenizer.json or .gguf (default: "
                             "the checkpoint's, or the repo's test tokenizer "
                             "for a preset)")


def add_lora_args(parser: argparse.ArgumentParser) -> None:
    """The LoRA flags, shared by the launcher and the worker main."""
    parser.add_argument("--lora", action="append", default=[],
                        metavar="NAME=PATH",
                        help="serve a LoRA adapter: NAME becomes a served "
                             "model name riding the base model; PATH is a "
                             "HF PEFT directory (adapter_config.json and "
                             "*.safetensors). Repeatable: heterogeneous "
                             "adapters batch into one decode window")
    parser.add_argument("--max-adapters", type=int, default=None,
                        help="resident device adapter slots (default: "
                             "max(4, number of --lora flags)); registered "
                             "adapters beyond them hot-load on demand with "
                             "LRU eviction")
    parser.add_argument("--max-lora-rank", type=int, default=8,
                        help="adapter ranks pad to this maximum so the "
                             "stacks keep fixed shapes (a checkpoint of a "
                             "larger rank is refused)")


def lora_args(args) -> list[tuple[str, str]]:
    """The repeated ``--lora NAME=PATH`` flags as (name, path) pairs."""
    out = []
    for item in getattr(args, "lora", None) or []:
        name, sep, path = str(item).partition("=")
        if not sep or not name or not path:
            raise SystemExit(f"--lora expects NAME=PATH, got {item!r}")
        out.append((name, path))
    return out


def max_adapters_arg(args) -> int:
    """``--max-adapters``, else max(4, number of --lora), else 0."""
    explicit = getattr(args, "max_adapters", None)
    if explicit is not None:
        return explicit
    loras = lora_args(args)
    return max(4, len(loras)) if loras else 0


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
        description="dynamo_tpu_torch launcher (in=http out=gpu|dyn)")
    add_engine_args(parser)
    add_lora_args(parser)
    parser.add_argument("--context-length", type=int, default=8192)
    parser.add_argument("--http-host", default="127.0.0.1")
    parser.add_argument("--http-port", type=int, default=8000,
                        help="0 picks a free port")
    parser.add_argument("--coordinator-url", default=None,
                        help="out=dyn: the coordinator to discover workers "
                             "on (default: DTPU_COORDINATOR_URL, else "
                             "tcp://127.0.0.1:4222)")
    args = parser.parse_args(rest)
    for key, value in io.items():
        wait = NOT_PORTED.get(f"{key}={value}")
        if wait:
            parser.error(f"{key}={value} is not ported yet: it waits for "
                         f"the slice that ports {wait}")
    if io["in"] != "http":
        parser.error(f"in= must be http, got {io['in']!r}")
    if io["out"] not in ("gpu", "dyn"):
        parser.error(f"out= must be gpu or dyn, got {io['out']!r}")
    if args.lora and io["out"] != "gpu":
        parser.error("--lora needs the real engine (out=gpu)")
    args.input, args.output = io["in"], io["out"]
    return args


def build_engine_config(args) -> EngineConfig:
    """Resolve ``--model`` (``hub.resolve_model``; exits naming why when it
    does not resolve) and set ``args.resolved_checkpoint`` to the
    checkpoint directory, or None for a preset."""
    try:
        spec, ckpt = resolve_model(args.model)
    except FileNotFoundError as exc:
        raise SystemExit(str(exc)) from exc
    if args.quant:
        spec = dataclasses.replace(spec, quant=args.quant)
    args.resolved_checkpoint = ckpt
    return EngineConfig(
        model=spec, page_size=args.page_size,
        num_pages=args.num_pages, max_pages_per_seq=args.max_pages_per_seq,
        max_num_seqs=args.max_num_seqs, decode_window=args.decode_window,
        pipeline_depth=args.pipeline_depth,
        prefill_chunk_tokens=args.prefill_chunk_tokens, quant_kv=args.quant_kv,
        max_adapters=max_adapters_arg(args),
        lora_max_rank=getattr(args, "max_lora_rank", 8), device=args.device)


def load_engine(config: EngineConfig, checkpoint: str | None,
                seed: int = 0, start: bool = True, **engine_kw) -> GPUEngine:
    """An engine for ``config``: the checkpoint's weights, or random ones
    from ``seed`` when ``checkpoint`` is None; started unless ``start`` is
    False (a worker starts it on its event loop, which its publishers
    use). ``engine_kw`` go to GPUEngine (the publishers). What the engine
    cannot serve is refused before any weight is read."""
    check_supported(config)
    params = (load_hf_weights(config.model, checkpoint, config.device)
              if checkpoint else None)
    engine = GPUEngine(config, params=params, seed=seed, **engine_kw)
    if start:
        engine.start()
    return engine


def build_engine(args, **overrides) -> GPUEngine:
    """The real engine, in-process: ``--model``'s weights (random from
    ``--seed`` for a preset); ``overrides`` set EngineConfig fields that
    have no flag."""
    if args.output != "gpu":
        raise ValueError(f"out={args.output} is not served by the port")
    config = dataclasses.replace(build_engine_config(args), **overrides)
    return load_engine(config, args.resolved_checkpoint, args.seed)


def load_tokenizer(checkpoint: str | None, path: str | None,
                   checkpoint_first: bool) -> Tokenizer:
    """The served tokenizer. The launcher takes a checkpoint's own
    ``tokenizer.json`` first, then ``--tokenizer`` (``checkpoint_first``);
    the worker main takes ``--tokenizer`` first, as their references do. A
    checkpoint without a ``tokenizer.json`` and no ``--tokenizer`` raises
    FileNotFoundError; only a preset gets the repo's test tokenizer."""
    own = checkpoint and os.path.exists(
        os.path.join(checkpoint, "tokenizer.json"))
    if checkpoint_first and own:
        return Tokenizer.from_pretrained_dir(checkpoint)
    if path:
        return Tokenizer.from_file(path)
    if checkpoint:
        return Tokenizer.from_pretrained_dir(checkpoint)
    return make_test_tokenizer()


def build_local_served(args, engine: GPUEngine | None = None
                       ) -> tuple[ServedModel, GPUEngine]:
    """Static pipeline: Preprocessor -> Backend -> GPUEngine, no network.
    ``engine``: a started engine to serve from (default: ``build_engine``
    of ``args``). With ``--lora`` each adapter registers on the engine
    and its name becomes a ServedModel of its own (in
    ``served.adapter_served``) whose card binds it to the base model, as
    a distributed front resolves discovered adapter cards."""
    config = build_engine_config(args)
    tokenizer = load_tokenizer(args.resolved_checkpoint, args.tokenizer,
                               checkpoint_first=True)
    engine = engine or load_engine(config, args.resolved_checkpoint,
                                   args.seed)
    name = args.model_name or os.path.basename(args.model.rstrip("/"))
    backend = Backend(tokenizer, inner=engine)

    def served_model(model: str, extra: dict) -> ServedModel:
        card = ModelDeploymentCard(
            name=model, chat_template=DEFAULT_CHAT_TEMPLATE,
            context_length=args.context_length,
            runtime_config=ModelRuntimeConfig(extra=extra))
        entry = ModelEntry(model_name=model, namespace="local",
                           component="local", endpoint="generate",
                           model_type="chat", card=card)
        return ServedModel(entry, OpenAIPreprocessor(card, tokenizer,
                                                     inner=backend))

    served = served_model(name, {})
    served.adapter_served = []
    for lname, path in lora_args(args):
        engine.register_adapter(lname, path=path)
        served.adapter_served.append(served_model(
            lname, {"lora_base": name, "adapter": lname}))
    return served, engine


async def start_http(args, engine: GPUEngine | None = None
                     ) -> tuple[HttpService, GPUEngine]:
    """Build the served model and start the HTTP front on the running
    event loop; the caller stops both."""
    served, engine = build_local_served(args, engine)
    manager = ModelManager()
    for model in (served, *served.adapter_served):
        manager.models[model.name] = model
    service = HttpService(manager, host=args.http_host, port=args.http_port)
    try:
        await service.start()
    except BaseException:
        engine.stop()
        raise
    return service, engine


async def start_front(runtime: DistributedRuntime, host: str, port: int,
                      router_mode: str = "round_robin",
                      kv_router_factory=None
                      ) -> tuple[HttpService, ModelWatcher]:
    """The distributed front: an HTTP front over a ModelWatcher of the
    coordinator's models/ prefix (``out=dyn`` and ``python -m
    dynamo_tpu_torch.frontend``); ``kv_router_factory``
    (``llm/kv_router.make_kv_router_factory``) builds the router under
    ``router_mode="kv"``. The caller stops both."""
    manager = ModelManager()
    watcher = ModelWatcher(runtime, manager, router_mode=router_mode,
                           kv_router_factory=kv_router_factory)
    service = HttpService(manager, host=host, port=port)
    try:
        await watcher.start()
        await service.start()
    except BaseException:
        await watcher.stop()
        raise
    return service, watcher


async def start_dyn(args) -> tuple[HttpService, DistributedRuntime,
                                    ModelWatcher]:
    """``out=dyn``: connect to the coordinator and start the front; the
    caller stops all three."""
    cfg = RuntimeConfig.from_settings()
    if args.coordinator_url:
        cfg.coordinator_url = args.coordinator_url
    runtime = await DistributedRuntime.from_settings(cfg)
    try:
        service, watcher = await start_front(runtime, args.http_host,
                                             args.http_port)
    except BaseException:
        await runtime.close()
        raise
    return service, runtime, watcher


async def run(args) -> None:
    """Serve until SIGINT or SIGTERM, then stop the front and what it
    serves from."""
    loop = asyncio.get_running_loop()
    done = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, done.set)
    try:
        if args.output == "dyn":
            service, runtime, watcher = await start_dyn(args)
            serving = ("the models registered at "
                       + runtime.config.coordinator_url)

            async def stop_rest():
                await watcher.stop()
                await runtime.close()
        else:
            service, engine = await start_http(args)
            serving = f"{args.model} from an engine on {engine.runner.device}"

            async def stop_rest():
                engine.stop()
        try:
            print(f"LAUNCH_READY in={args.input} out={args.output} "
                  f"port={service.port}", flush=True)
            log.info("serving %s", serving)
            await done.wait()
        finally:
            await service.stop()
            await stop_rest()
    finally:
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.remove_signal_handler(sig)


def main(argv=None) -> None:
    asyncio.run(run(parse_args(argv)))


if __name__ == "__main__":
    main()
