"""Engine launcher for the port (counterpart of ``dynamo_tpu.launch``'s
``out=tpu`` leg, ``_build_engine``).

``build_engine(args)`` assembles a GPUEngine for ``out=gpu --model
<preset>`` with random weights from ``--seed``. The HTTP front end,
tokenizer and request plane are a later slice, so the engine boundary is
``engine.generate(request_dict, context)``.

    python -m dynamo_tpu_torch.launch out=gpu --model tiny-test --device cpu
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import sys

from dynamo_tpu_torch.engine.config import PRESETS, EngineConfig
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.runtime.context import Context


def _auto_or_int(value: str):
    return value if value == "auto" else int(value)


def parse_args(argv=None) -> argparse.Namespace:
    argv = list(sys.argv[1:] if argv is None else argv)
    out = "gpu"
    rest = []
    for a in argv:
        if a.startswith("out="):
            out = a.split("=", 1)[1]
        else:
            rest.append(a)
    parser = argparse.ArgumentParser(
        description="dynamo_tpu_torch engine launcher (out=gpu)")
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
    parser.add_argument("--prompt", default="1,2,3,4",
                        help="comma-separated token ids for the __main__ "
                             "smoke request")
    parser.add_argument("--max-tokens", type=int, default=16)
    args = parser.parse_args(rest)
    if out != "gpu":
        parser.error(f"out= must be gpu, got {out!r}")
    args.output = out
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


async def _smoke(engine: GPUEngine, args) -> None:
    request = {"model": args.model,
               "token_ids": [int(t) for t in args.prompt.split(",")],
               "stop_conditions": {"max_tokens": args.max_tokens}}
    async for item in engine.generate(request, Context()):
        print(item, flush=True)


def main(argv=None) -> None:
    args = parse_args(argv)
    engine = build_engine(args)
    try:
        asyncio.run(_smoke(engine, args))
    finally:
        engine.stop()


if __name__ == "__main__":
    main()
