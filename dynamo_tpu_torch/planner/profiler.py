"""Profiling sweep (copy of ``dynamo_tpu.planner.profiler``): TTFT, ITL and
throughput over an (ISL, OSL, concurrency) grid, and the per-worker
capacity the planner consumes (``choose_capacity``). ``engine_factory``
builds a fresh engine per point: the mocker (``llm/mocker.py``) for
capacity modelling at any speed, or a ``GPUEngine`` for the card's
numbers.
"""

from __future__ import annotations

import asyncio
import json
import time

import numpy as np

from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("planner.profiler")


def _vocab(engine, default: int = 1000) -> int:
    """Prompt ids are drawn below the engine's vocabulary (a GPUEngine's
    model), or below ``default`` for the mocker, which has none."""
    model = getattr(getattr(engine, "config", None), "model", None)
    return getattr(model, "vocab_size", default)


async def _measure_point(engine, isl: int, osl: int, concurrency: int,
                         vocab: int | None = None) -> dict:
    vocab = vocab or _vocab(engine)
    rng = np.random.default_rng(isl * 7919 + osl * 104729 + concurrency)

    async def one():
        req = PreprocessedRequest(
            model="profile",
            token_ids=rng.integers(0, vocab, size=isl).tolist())
        req.stop_conditions.max_tokens = osl
        req.stop_conditions.ignore_eos = True
        t0 = time.monotonic()
        t_first = None
        n = 0
        async for out in engine.generate(req, Context()):
            got = len(out.get("token_ids", []))
            if got and t_first is None:
                t_first = time.monotonic()
            n += got
            if out.get("finish_reason"):
                break
        t_end = time.monotonic()
        itl = ((t_end - t_first) / max(1, n - 1)) if t_first else 0.0
        return (t_first - t0 if t_first else 0.0), itl, n, t_end - t0

    t0 = time.monotonic()
    results = await asyncio.gather(*[one() for _ in range(concurrency)])
    elapsed = time.monotonic() - t0
    ttfts = sorted(r[0] for r in results)
    itls = sorted(r[1] for r in results)
    total = sum(r[2] for r in results)
    return {
        "isl": isl, "osl": osl, "concurrency": concurrency,
        "ttft_p50_ms": 1e3 * ttfts[len(ttfts) // 2],
        "ttft_p99_ms": 1e3 * ttfts[min(len(ttfts) - 1,
                                       int(len(ttfts) * 0.99))],
        "itl_p50_ms": 1e3 * itls[len(itls) // 2],
        "decode_tok_s": total / elapsed,
        "prefill_tok_s": isl * concurrency / max(1e-9, ttfts[-1]),
    }


async def profile_sweep(engine_factory, grid: list[tuple[int, int, int]],
                        output_path: str | None = None) -> dict:
    """Run the grid; returns {"points": [...]} and optionally writes JSON.

    ``engine_factory() -> engine`` builds a fresh engine per point so KV
    state doesn't leak between configurations.
    """
    points = []
    for isl, osl, conc in grid:
        engine = engine_factory()
        try:
            point = await _measure_point(engine, isl, osl, conc)
        finally:
            stop = getattr(engine, "stop", None)
            if stop is not None:
                res = stop()
                if asyncio.iscoroutine(res):
                    await res
        log.info("profiled isl=%d osl=%d conc=%d: ttft_p99=%.0fms "
                 "decode=%.0f tok/s", isl, osl, conc,
                 point["ttft_p99_ms"], point["decode_tok_s"])
        points.append(point)
    table = {"points": points}
    if output_path:
        def _dump() -> None:
            with open(output_path, "w") as fh:
                json.dump(table, fh, indent=2)

        await asyncio.to_thread(_dump)
    return table


def choose_capacity(table: dict, ttft_sla_ms: float,
                    itl_sla_ms: float) -> dict:
    """Pick the highest-throughput grid point meeting both SLAs
    (profile_sla.py's selection step). Returns the capacity facts the
    planner config consumes."""
    ok = [p for p in table["points"]
          if p["ttft_p99_ms"] <= ttft_sla_ms and p["itl_p50_ms"] <= itl_sla_ms]
    if not ok:
        raise ValueError(
            f"no profiled configuration meets ttft<={ttft_sla_ms}ms and "
            f"itl<={itl_sla_ms}ms; best points: "
            f"{sorted(table['points'], key=lambda p: p['ttft_p99_ms'])[:2]}")
    best = max(ok, key=lambda p: p["decode_tok_s"])
    return {
        "max_concurrency": best["concurrency"],
        "prefill_capacity_tok_s": best["prefill_tok_s"],
        "decode_capacity_tok_s": best["decode_tok_s"],
        "point": best,
    }
