"""Launcher of the port (counterpart of ``dynamo_tpu.launch``, the
"dynamo-run equivalent").

``in=http out=gpu`` runs the OpenAI HTTP front, preprocessor,
detokenizing backend and GPUEngine in one process, with no coordinator and
no network hop between front and engine; ``out=dyn`` runs the same front
over a ``ModelWatcher`` on ``--coordinator-url`` and serves whatever
workers (``python -m dynamo_tpu_torch.backends.gpu``, or the JAX
package's) register there. ``in=text`` and ``in=batch`` drive the same
one-process pipeline (``out=gpu`` or ``out=mocker``) without a front:
``in=text`` reads one user message a line from stdin and streams the
answer to stdout until an empty line or EOF; ``in=batch`` runs the JSONL
``--input-file`` (``{"prompt": ...}`` or ``{"messages": [...]}`` rows,
optional ``max_tokens`` and ``temperature``) through it,
``--batch-concurrency`` requests at a time (``--batch-max-tokens`` by
default), writes one result row a line in input order to
``--output-file`` (default ``<input>.results.jsonl``; a malformed line or
a failed request gives an error row) and prints one summary JSON line.

    python -m dynamo_tpu_torch.launch in=http out=gpu --model llama-3-8b
    python -m dynamo_tpu_torch.launch --model /path/to/checkpoint --quant int8
    python -m dynamo_tpu_torch.launch --model tiny-test --device cpu
    python -m dynamo_tpu_torch.launch --model llama-3-8b --lora a=/path/to/peft_a
    python -m dynamo_tpu_torch.launch in=http out=dyn --coordinator-url tcp://127.0.0.1:4222
    python -m dynamo_tpu_torch.launch in=http out=mocker --http-port 0
    python -m dynamo_tpu_torch.launch in=text --model tiny-test --device cpu
    python -m dynamo_tpu_torch.launch in=batch --input-file prompts.jsonl --batch-concurrency 4

``--model`` is a preset (random weights from ``--seed``), a HF Llama or
Qwen2 checkpoint directory (``config.json`` and ``*.safetensors``), or a
hub id already in the local HF cache (``engine/hub.py``; nothing is
downloaded). ``out=mocker`` serves the engine simulator
(``llm/mocker.py``, ten times faster than its default timing, with the
test tokenizer), as the reference launcher's ``out=mocker`` does. ``--quant int8`` serves int8 weights with float32 per-channel
scales. The tokenizer is the checkpoint's own ``tokenizer.json`` (the
reference launcher's choice), else ``--tokenizer PATH`` (a
``tokenizer.json`` or a ``.gguf``), else, for a preset, the repo's test
tokenizer. It prints ``LAUNCH_READY in=http out=<gpu|dyn> port=N`` once
it serves (``out=<gpu|dyn|mocker>``), and stops on SIGINT or SIGTERM. Both outputs run the front
behind the overload defense's adaptive limiter (``[overload]`` /
``DTPU_OVERLOAD_*``; ``DTPU_OVERLOAD_ENABLED=0`` turns it off) and arm the
SLO plane and the request ledger (``init_observability``):
``--slo-ttft-p99-ms`` sets the TTFT target and ``--request-log PATH``
appends each request's accounting record to a JSONL file.
``--tool-call-parser`` and ``--reasoning-parser`` name the parsers
(``llm/parsers.py``) on the served models' cards. The reference
launcher's other input and output (``in=grpc``, ``out=echo``) and its
flags that the port does not serve (``REFUSED_FLAGS``) exit naming the
ROADMAP item each waits for; none is accepted and then ignored. ``--lora NAME=PATH``
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
import json
import os
import signal
import sys
import time

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
from dynamo_tpu_torch.llm.protocols import ChatCompletionRequest
from dynamo_tpu_torch.llm.recorder import configure_ledger
from dynamo_tpu_torch.llm.tokenizer import Tokenizer, make_test_tokenizer
from dynamo_tpu_torch.runtime import flight, journal, slo
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.overload import AdaptiveLimiter

log = get_logger("launch")

# What the reference's flags and in=/out= values that the port does not
# serve wait for (the worker main's refusals use the same texts).
PARALLEL = "ROADMAP item 16 (parallelism across GPUs and nodes)"
GRPC = "ROADMAP item 24 (the KServe gRPC front)"
ONE_ATTENTION = ("no ROADMAP item: the port has one attention path, its "
                 "paged-attention kernel")
NO_PREFILL_PROGRAMS = ("no ROADMAP item: the port compiles no prefill "
                       "programs")

NOT_PORTED = {
    "in=grpc": GRPC,
    "out=echo": "no ROADMAP item: the echo engine is copied when a slice "
                "needs it",
}

# The reference launcher's flags that the port does not serve:
# (flag, what it waits for, add_argument keywords). A value in "allowed"
# is the reference's default, which leaves the feature off.
REFUSED_FLAGS = (
    ("--tp", PARALLEL, {"type": int, "allowed": (1,)}),
    ("--dp", PARALLEL, {"type": int, "allowed": (1,)}),
    ("--pp", PARALLEL, {"type": int, "allowed": (1,)}),
    ("--sp", PARALLEL, {"type": int, "allowed": (1,)}),
    ("--attention-backend", ONE_ATTENTION,
     {"type": str, "allowed": ("auto",)}),
    ("--warmup-prefill-ladder", NO_PREFILL_PROGRAMS, {}),
)


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
    parser.add_argument("--host-cache-pages", type=int, default=0,
                        help="G2 host-DRAM KV block cache capacity in pages "
                             "(0 = none): pages evicted from the device "
                             "pool offload here and onboard on prefix hits")
    parser.add_argument("--kv-disk-cache-dir", default=None,
                        help="G3 disk tier directory behind the host cache")
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


def add_parser_args(parser: argparse.ArgumentParser) -> None:
    """The backward-edge parser flags, shared by the launcher and the
    worker main: the names go on the served model cards."""
    parser.add_argument("--tool-call-parser", default=None,
                        help="tool-call format on the backward edge "
                             "(hermes, llama3_json, mistral, nemotron_deci, "
                             "phi4, default)")
    parser.add_argument("--reasoning-parser", default=None,
                        help="think-tag splitting (deepseek_r1, basic)")


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
        description="dynamo_tpu_torch launcher (in=http|text|batch "
                    "out=gpu|dyn|mocker)")
    add_engine_args(parser)
    add_lora_args(parser)
    add_parser_args(parser)
    parser.add_argument("--input-file", default=None,
                        help="in=batch: JSONL of prompts ({'prompt': ...} or "
                             "{'messages': [...]}, optional max_tokens)")
    parser.add_argument("--output-file", default=None,
                        help="in=batch: JSONL results path "
                             "(default <input-file>.results.jsonl)")
    parser.add_argument("--batch-concurrency", type=int, default=8,
                        help="in=batch: max in-flight requests")
    parser.add_argument("--batch-max-tokens", type=int, default=128,
                        help="in=batch: default max_tokens per prompt")
    parser.add_argument("--context-length", type=int, default=8192)
    parser.add_argument("--http-host", default="127.0.0.1")
    parser.add_argument("--http-port", type=int, default=8000,
                        help="0 picks a free port")
    parser.add_argument("--coordinator-url", default=None,
                        help="out=dyn: the coordinator to discover workers "
                             "on (default: DTPU_COORDINATOR_URL, else "
                             "tcp://127.0.0.1:4222)")
    # SLO plane + per-request accounting (runtime/slo.py,
    # llm/recorder.py); the rest via DTPU_SLO_* / [slo] TOML.
    parser.add_argument("--slo-ttft-p99-ms", type=float, default=None,
                        help="TTFT SLO target (99%% of requests)")
    parser.add_argument("--request-log", default=None,
                        help="append per-request accounting records as "
                             "JSONL here")
    add_refused_flags(parser, REFUSED_FLAGS)
    args = parser.parse_args(rest)
    for key, value in io.items():
        wait = NOT_PORTED.get(f"{key}={value}")
        if wait:
            parser.error(f"{key}={value} is not ported yet: it waits for "
                         f"{wait}")
    if io["in"] not in ("http", "text", "batch"):
        parser.error(f"in= must be http|text|batch, got {io['in']!r}")
    if io["in"] == "batch" and not args.input_file:
        parser.error("in=batch requires --input-file")
    if io["out"] not in ("gpu", "dyn", "mocker"):
        parser.error(f"out= must be gpu or dyn or mocker, got {io['out']!r}")
    if io["in"] != "http" and io["out"] == "dyn":
        parser.error(f"in={io['in']} requires a local out= engine")
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
        host_cache_pages=args.host_cache_pages,
        kv_disk_cache_dir=args.kv_disk_cache_dir,
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


def build_engine(args, metrics_registry=None, **overrides) -> GPUEngine:
    """The real engine, in-process: ``--model``'s weights (random from
    ``--seed`` for a preset), its series on ``metrics_registry`` (a
    ``MetricsRegistry`` node) when one is given; ``overrides`` set
    EngineConfig fields that have no flag."""
    if args.output != "gpu":
        raise ValueError(f"out={args.output} is not served by the port")
    config = dataclasses.replace(build_engine_config(args), **overrides)
    return load_engine(config, args.resolved_checkpoint, args.seed,
                       metrics_registry=metrics_registry)


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


def build_local_served(args, engine: GPUEngine | None = None,
                       metrics_registry=None
                       ) -> tuple[ServedModel, GPUEngine]:
    """Static pipeline: Preprocessor -> Backend -> GPUEngine, no network.
    ``engine``: a started engine to serve from (default: ``build_engine``
    of ``args``, with its series on ``metrics_registry``; under
    ``out=mocker`` the simulator, started on the running loop, with the
    test tokenizer). With ``--lora`` each adapter registers on the engine
    and its name becomes a ServedModel of its own (in
    ``served.adapter_served``) whose card binds it to the base model, as
    a distributed front resolves discovered adapter cards."""
    if args.output == "mocker":
        from dynamo_tpu_torch.llm.mocker import MockerConfig, MockerEngine
        engine = MockerEngine(MockerConfig(speedup_ratio=10.0))
        engine.start()
        tokenizer = make_test_tokenizer()
    else:
        config = build_engine_config(args)
        tokenizer = load_tokenizer(args.resolved_checkpoint, args.tokenizer,
                                   checkpoint_first=True)
        engine = engine or load_engine(config, args.resolved_checkpoint,
                                       args.seed,
                                       metrics_registry=metrics_registry)
    name = args.model_name or os.path.basename(args.model.rstrip("/"))
    backend = Backend(tokenizer, inner=engine)

    def served_model(model: str, extra: dict) -> ServedModel:
        card = ModelDeploymentCard(
            name=model, chat_template=DEFAULT_CHAT_TEMPLATE,
            context_length=args.context_length,
            tool_call_parser=args.tool_call_parser,
            reasoning_parser=args.reasoning_parser,
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


def init_observability(cfg: RuntimeConfig, metrics,
                       worker: str | None = None,
                       fingerprint: dict | None = None) -> None:
    """Arm this process's SLO plane (``cfg.slo``, its series on
    ``metrics``), the accounting ledger's ring and JSONL sink, the journal
    (attributed to ``worker`` when given) and the flight recorder's bundle
    context (``fingerprint``, default ``cfg``); a fast-burn SLO page
    freezes the flight ring and writes a bundle. Shared by the launcher,
    the frontend and the worker main."""
    plane = slo.configure(cfg.slo, metrics=metrics)
    configure_ledger(cfg.slo.request_ring, cfg.slo.request_log_path or None)
    if worker is not None:
        journal.configure(worker=worker, metrics=metrics)
    flight.configure(metrics=metrics, config_fingerprint=(
        fingerprint if fingerprint is not None else dataclasses.asdict(cfg)))
    plane.on_page(flight.on_slo_page)


def apply_slo_args(cfg: RuntimeConfig, args) -> None:
    """``--slo-ttft-p99-ms`` and ``--request-log`` onto ``cfg.slo``."""
    if getattr(args, "slo_ttft_p99_ms", None) is not None:
        cfg.slo.ttft_p99_ms = args.slo_ttft_p99_ms
    if getattr(args, "request_log", None) is not None:
        cfg.slo.request_log_path = args.request_log


def make_limiter(cfg: RuntimeConfig, metrics) -> AdaptiveLimiter | None:
    """The front's adaptive limiter of ``cfg.overload``, None when the
    defense is off."""
    return (AdaptiveLimiter(cfg.overload, metrics=metrics)
            if cfg.overload.enabled else None)


def local_pipeline(args, engine: GPUEngine | None = None):
    """``build_local_served`` with this process's observability armed:
    one metrics registry holds, for an engine built here, the engine's
    series (under ``local``/``gpu``, the reference launcher's hierarchy)
    and the front's; the flight recorder's bundles snapshot it. The
    runtime settings are the reference launcher's: the defaults
    (``RuntimeConfig()``) with ``--slo-ttft-p99-ms`` and
    ``--request-log`` on top. Returns (served, engine, metrics, cfg)."""
    metrics = MetricsRegistry()
    served, engine = build_local_served(
        args, engine,
        metrics_registry=metrics.namespace("local").component("gpu"))
    cfg = RuntimeConfig()
    apply_slo_args(cfg, args)
    init_observability(cfg, metrics,
                       fingerprint=dataclasses.asdict(engine.config))
    return served, engine, metrics, cfg


async def start_http(args, engine: GPUEngine | None = None
                     ) -> tuple[HttpService, GPUEngine]:
    """Build the served model (``local_pipeline``) and start the HTTP
    front on the running event loop, behind the default limiter; the
    caller stops both."""
    served, engine, metrics, cfg = local_pipeline(args, engine)
    manager = ModelManager()
    for model in (served, *served.adapter_served):
        manager.models[model.name] = model
    service = HttpService(manager, host=args.http_host, port=args.http_port,
                          metrics=metrics,
                          overload=make_limiter(cfg, metrics))
    try:
        await service.start()
    except BaseException:
        await stop_engine(engine)
        raise
    return service, engine


async def stop_engine(engine) -> None:
    """Stop a GPUEngine (blocking) or the mocker (a coroutine)."""
    res = engine.stop()
    if asyncio.iscoroutine(res):
        await res


async def start_front(runtime: DistributedRuntime, host: str, port: int,
                      router_mode: str = "round_robin",
                      kv_router_factory=None, tls_cert_path=None,
                      tls_key_path=None, timeline_provider=None,
                      overload: AdaptiveLimiter | None = None,
                      watcher_hooks=None
                      ) -> tuple[HttpService, ModelWatcher]:
    """The distributed front: an HTTP front over a ModelWatcher of the
    coordinator's models/ prefix (``out=dyn`` and ``python -m
    dynamo_tpu_torch.frontend``); ``kv_router_factory``
    (``llm/kv_router.make_kv_router_factory``) builds the router under
    ``router_mode="kv"``, the TLS paths serve HTTPS,
    ``timeline_provider`` answers ``/debug/timeline``, ``overload`` admits
    the generate routes and ``watcher_hooks(watcher)`` sets the watcher's
    fleet hooks before it starts (the canary's). The caller stops
    both."""
    manager = ModelManager()
    watcher = ModelWatcher(runtime, manager, router_mode=router_mode,
                           kv_router_factory=kv_router_factory)
    if watcher_hooks is not None:
        watcher_hooks(watcher)
    service = HttpService(manager, host=host, port=port, runtime=runtime,
                          tls_cert_path=tls_cert_path,
                          tls_key_path=tls_key_path, overload=overload)
    service.timeline_provider = timeline_provider
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
    apply_slo_args(cfg, args)
    runtime = await DistributedRuntime.from_settings(cfg)
    try:
        init_observability(cfg, runtime.metrics,
                           worker=f"{runtime.instance_id:x}")
        service, watcher = await start_front(
            runtime, args.http_host, args.http_port,
            overload=make_limiter(cfg, runtime.metrics))
    except BaseException:
        await runtime.close()
        raise
    return service, runtime, watcher


async def run_text_repl(served: ServedModel) -> None:
    """in=text: an interactive prompt loop on stdin, one user message a
    line, each answer streamed to stdout; an empty line or EOF ends it."""
    loop = asyncio.get_running_loop()
    print("dynamo-tpu text console — empty line or EOF exits", flush=True)
    while True:
        line = await loop.run_in_executor(None, sys.stdin.readline)
        if not line or not line.strip():
            return
        req = ChatCompletionRequest.model_validate({
            "model": served.name,
            "messages": [{"role": "user", "content": line.strip()}],
            "max_tokens": 64, "stream": True})
        async for chunk in served.preprocessor.generate(req, Context()):
            for choice in chunk.get("choices", []):
                piece = choice.get("delta", {}).get("content")
                if piece:
                    print(piece, end="", flush=True)
        print(flush=True)


def read_batch(path: str) -> list:
    """in=batch: the JSONL file's jobs, one per non-blank line; a line
    that does not parse is a ``ValueError`` in its place."""
    jobs = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            if not line.strip():
                continue
            try:
                jobs.append(json.loads(line))
            except json.JSONDecodeError as exc:
                jobs.append(ValueError(f"unparseable JSONL line: {exc}"))
    return jobs


async def batch_row(served: ServedModel, args, idx: int, job,
                    sem: asyncio.Semaphore) -> dict:
    """One in=batch job's result row: its text, finish reason, completion
    tokens (from the usage block: text deltas are not one per token),
    elapsed and first-content seconds; an error row for a malformed line
    or a failed request, so the rest of the batch goes on."""
    try:
        if isinstance(job, Exception):
            raise job
        if not isinstance(job, dict):
            raise ValueError(f"line is {type(job).__name__}, "
                             "expected a JSON object")
        messages = job.get("messages") or [
            {"role": "user", "content": job.get("prompt", "")}]
        req = ChatCompletionRequest.model_validate({
            "model": served.name, "messages": messages,
            "max_tokens": int(job.get("max_tokens", args.batch_max_tokens)),
            "temperature": job.get("temperature", 0.0), "stream": True,
            "stream_options": {"include_usage": True}})
        text, n_tokens, finish = [], 0, None
        async with sem:
            t0 = time.monotonic()
            t_first = None
            async for chunk in served.preprocessor.generate(req, Context()):
                usage = chunk.get("usage")
                if usage:
                    n_tokens = usage.get("completion_tokens", n_tokens)
                for choice in chunk.get("choices", []):
                    piece = choice.get("delta", {}).get("content")
                    if piece:
                        if t_first is None:
                            t_first = time.monotonic()
                        text.append(piece)
                    if choice.get("finish_reason"):
                        finish = choice["finish_reason"]
            elapsed = time.monotonic() - t0
        return {"index": idx, "text": "".join(text),
                "finish_reason": finish, "tokens": n_tokens,
                "elapsed_s": round(elapsed, 4),
                "ttft_s": round((t_first or t0) - t0, 4)}
    except Exception as exc:  # noqa: BLE001 — keep the batch going
        return {"index": idx, "error": f"{type(exc).__name__}: {exc}",
                "tokens": 0}


async def run_batch(served: ServedModel, args) -> dict:
    """in=batch: the ``--input-file`` jobs through the pipeline,
    ``--batch-concurrency`` at a time; writes their rows in input order
    to ``--output-file`` (default ``<input>.results.jsonl``) and prints
    and returns the summary."""
    jobs = read_batch(args.input_file)
    out_path = args.output_file or args.input_file + ".results.jsonl"
    sem = asyncio.Semaphore(args.batch_concurrency)
    t0 = time.monotonic()
    results = await asyncio.gather(*[batch_row(served, args, i, job, sem)
                                     for i, job in enumerate(jobs)])
    elapsed = time.monotonic() - t0
    with open(out_path, "w", encoding="utf-8") as fh:
        for row in results:
            fh.write(json.dumps(row) + "\n")
    total_tokens = sum(r["tokens"] for r in results)
    summary = {
        "batch_prompts": len(jobs),
        "errors": sum(1 for r in results if "error" in r),
        "output_tokens": total_tokens, "elapsed_s": round(elapsed, 3),
        "tok_s": round(total_tokens / elapsed, 1) if elapsed else 0.0,
        "results": out_path}
    print(json.dumps(summary), flush=True)
    return summary


async def run_local_input(args) -> None:
    """in=text or in=batch over the one-process pipeline, then stop its
    engine."""
    served, engine, _, _ = local_pipeline(args)
    log.info("in=%s: %s", args.input,
             f"{args.model} from the mocker" if args.output == "mocker" else
             f"{args.model} from an engine on {engine.runner.device}")
    try:
        if args.input == "text":
            await run_text_repl(served)
        else:
            await run_batch(served, args)
    finally:
        await stop_engine(engine)


async def run(args) -> None:
    """Serve until SIGINT or SIGTERM, then stop the front and what it
    serves from (in=text and in=batch: until their input ends)."""
    if args.input != "http":
        await run_local_input(args)
        return
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
            serving = (f"{args.model} from the mocker"
                       if args.output == "mocker" else
                       f"{args.model} from an engine on "
                       f"{engine.runner.device}")

            async def stop_rest():
                await stop_engine(engine)
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
