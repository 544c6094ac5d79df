"""Where serving time goes on the card: wall time, device busy time, idle
share and the device time of each kernel, for one round of requests.

    python -m dynamo_tpu_torch.profile_decode
    python3 dynamo_tpu_torch/profile_decode.py [--tree DIR]

Builds the llama-3-8b engine with ``launch.build_engine`` (random weights,
seed 0; ``warmup_windows`` set, as ``backends.gpu`` sets it) and serves
rounds of the traffic ``chip_smoke.py``'s first round serves (prompt
lengths ``PROMPT_LENS``, ``MAX_TOKENS`` each, greedy): ``WARMUP_ROUNDS``
warm-up rounds, a timed round without the profiler (wall, tok/s, TTFT),
then two rounds under ``torch.profiler`` (CPU and CUDA activities): one
with ``max_tokens`` 1, which only prefills, and a full round. Every round
draws fresh prompts of those lengths, so none is served from the prefix
cache and each prefills cold. Then the traffic of ``chip_smoke.py``'s
second round (``round2_requests``: prefix hits, a chunked 6000-token
prompt, penalties, logprobs): ``WARMUP_ROUNDS`` warm-up rounds, a timed
one (tok/s, TTFTs, each chunk's device ms) and one under the profiler.
The window programs made during the measured rounds of each traffic are
counted: each is a capture inside a measured round. Device busy time is the union of the device
events' intervals; the idle share is 1 - busy / profiled wall time. Decode device time per step is the full round's busy
time less the prefill-only round's, over the decode steps. The runner
counts the bytes every paged attention launch must move
(``ModelRunner.attention_bytes``); their time at the HBM rate, over the
kernel's profiled device time in the same round, is its roofline share on
the main path. The pool is bf16 unless ``DTPU_QUANT_KV=int8`` asks for the
int8 pool, whose decode steps run the kernel's int8 variant. Last, on
the stopped engine, one decode window runs alone over ``ALONE_ROWS`` rows
of ``ALONE_HIST`` tokens, ``ALONE_REPS`` times: its host ms from call to
synchronised return and its device ms between two CUDA events. The
window programs (``ModelRunner.window_programs``: made, captured, capture
seconds, graph-pool bytes) are reported where the runner has them.
Prints one JSON line. Runs on a GPU only.

``DIR`` is the root of a checkout of the repo (default: the one holding
this file); its ``dynamo_tpu_torch`` is the one measured, so a parent and
a change are compared on one card by running this script once per
checkout, in the order parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

MODEL = "llama-3-8b"
PROMPT_LENS = (128, 300, 520, 777, 1000, 1200, 1400, 1500)
MAX_TOKENS = 64
# One prefill program takes at most MAX_PREFILL_TOKENS: the first round's
# prompts prefill whole, the second round's 6000-token prompt in chunks.
MAX_PREFILL_TOKENS = 2048
# Second round: four requests open with SHARED_TOKENS of the first round's
# 1200-token prompt (request SHARED_FROM, cached once it has run) and add
# OWN_TOKENS of their own; a penalised request and a seeded sampled one ask
# for LOGPROBS; a LONG_TOKENS prompt comes last. ROUND2_MAX_TOKENS each.
SHARED_FROM = 5
SHARED_TOKENS = 1024
OWN_TOKENS = 200
LONG_TOKENS = 6000
ROUND2_MAX_TOKENS = 32
PENALTIES = {"presence_penalty": 1.5, "frequency_penalty": 0.5}
LOGPROBS = 5
# A decode window run alone: live greedy rows, their history, the runs.
ALONE_ROWS = 8
ALONE_HIST = 1224
ALONE_REPS = 7
# Warm-up rounds of each traffic before the measured ones.
WARMUP_ROUNDS = 2


def round2_requests(spec, shared_source: list[int], rng) -> list[dict]:
    """The second round's seven requests (see the constants above);
    ``shared_source`` is a first-round prompt whose blocks are cached."""
    def rand(n):
        return rng.integers(0, spec.vocab_size, size=n).tolist()

    shared = shared_source[:SHARED_TOKENS]
    prompts = ([shared + rand(OWN_TOKENS) for _ in range(4)]
               + [rand(300), rand(500), rand(LONG_TOKENS)])
    sampling = ([{}] * 4 + [dict(PENALTIES, logprobs=LOGPROBS),
                            {"temperature": 0.8, "seed": 4321,
                             "logprobs": LOGPROBS}, {}])
    return [{"model": spec.name, "token_ids": p,
             "stop_conditions": {"max_tokens": ROUND2_MAX_TOKENS},
             "sampling_options": s} for p, s in zip(prompts, sampling)]


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


async def serve(engine, requests) -> list[dict]:
    """Serve the requests concurrently through ``engine.generate``; per
    request its tokens, logprobs and top logprobs (empty unless asked
    for), finish reason, TTFT and total seconds."""
    from dynamo_tpu_torch.runtime.context import Context

    async def one(req):
        t0 = time.monotonic()
        toks, lps, tops, finish, ttft = [], [], [], None, None
        async for item in engine.generate(req, Context()):
            if ttft is None:
                ttft = time.monotonic() - t0
            toks.extend(item.get("token_ids", []))
            lps.extend(item.get("log_probs", []))
            tops.extend(item.get("top_log_probs", []))
            finish = item.get("finish_reason") or finish
        return {"tokens": toks, "log_probs": lps, "top_log_probs": tops,
                "finish": finish, "ttft_s": ttft,
                "total_s": time.monotonic() - t0}

    return await asyncio.gather(*[one(r) for r in requests])


def _busy_seconds(intervals: list[tuple[float, float]]) -> float:
    busy, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy * 1e-6  # profiler times are microseconds


def _profiled_round(engine, requests):
    """Serve one round under the profiler: (wall s, busy s, device us by
    kernel name)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        asyncio.run(serve(engine, requests))
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    intervals, by_name = [], collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            intervals.append((evt.time_range.start, evt.time_range.end))
            by_name[evt.name] += evt.time_range.elapsed_us()
    if not intervals:
        raise RuntimeError("the profiler recorded no device activity")
    return wall, _busy_seconds(intervals), by_name


def window_alone(engine) -> dict:
    """One decode window run alone on the stopped engine's runner over
    ALONE_ROWS greedy rows of ALONE_HIST tokens in fresh pages, once to
    make its program and ALONE_REPS times measured: host ms from the call
    to the synchronised return, and device ms between CUDA events."""
    from dynamo_tpu_torch.engine import runner as trunner
    runner, cfg, M = engine.runner, engine.config, engine.decode_window
    page = cfg.page_size
    per_row = -(-(ALONE_HIST + M) // page)
    pages = engine.allocator.allocate(ALONE_ROWS * per_row)
    packed = np.zeros((cfg.max_num_seqs,
                       trunner.PK_PREFIX + runner.bucket_pages_for(per_row)),
                      np.int32)
    for i in range(ALONE_ROWS):
        packed[i, trunner.PK_OVERRIDE] = 1
        packed[i, trunner.PK_POS] = ALONE_HIST
        packed[i, trunner.PK_SEQLEN] = ALONE_HIST + 1
        packed[i, trunner.PK_TOPP] = np.float32(1.0).view(np.int32)
        packed[i, trunner.PK_CAP] = per_row * page
        packed[i, trunner.PK_PREFIX:trunner.PK_PREFIX + per_row] = \
            pages[i * per_row:(i + 1) * per_row]
    host, device = [], []
    try:
        runner.decode_window(packed, M)
        for _ in range(ALONE_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            runner.decode_window(packed, M)
            end.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            device.append(start.elapsed_time(end))
    finally:
        engine.allocator.release(pages)
    return {"rows": ALONE_ROWS, "hist": ALONE_HIST, "steps": M,
            "ms_median": sorted(host)[len(host) // 2],
            "device_ms_median": sorted(device)[len(device) // 2],
            "ms": host, "device_ms": device}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path,
                    default=Path(__file__).resolve().parents[1],
                    help="root of the checkout whose engine is measured")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: needs a GPU", file=sys.stderr)
        return 1
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    from dynamo_tpu_torch import launch
    from dynamo_tpu_torch.engine import attention
    from dynamo_tpu_torch.engine.config import DEFAULT_HBM_GBPS
    if not Path(launch.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"dynamo_tpu_torch came from {launch.__file__}, "
                         f"not {tree}: run this file as a script")
    # Warmed as a worker warms it (a tree without window programs has the
    # field and ignores it).
    engine = launch.build_engine(launch.parse_args(
        ["out=gpu", "--model", MODEL, "--seed", "0"]),
        max_prefill_tokens=MAX_PREFILL_TOKENS, warmup_windows=True)
    spec = engine.runner.spec
    rng = np.random.default_rng(0)

    def round_of(max_tokens):
        # Fresh prompts every round: a repeated prompt would be served
        # from the prefix cache, and each round prefills them cold.
        return [{"model": spec.name,
                 "token_ids": rng.integers(0, spec.vocab_size, n).tolist(),
                 "stop_conditions": {"max_tokens": max_tokens}}
                for n in PROMPT_LENS]

    programs = getattr(engine.runner, "window_programs", None)

    def made() -> int:
        return programs()["programs"] if programs else 0

    requests = round_of(MAX_TOKENS)
    try:
        # Warm-up: first-call costs, and the window programs the traffic
        # makes at first use (the arrival order decides which buckets a
        # round's windows take, so one round may not make them all).
        asyncio.run(serve(engine, requests))
        for _ in range(WARMUP_ROUNDS - 1):
            asyncio.run(serve(engine, round_of(MAX_TOKENS)))
        made1 = made()
        t0 = time.monotonic()
        ttfts = sorted(r["ttft_s"] for r in asyncio.run(
            serve(engine, round_of(MAX_TOKENS))))
        timed_wall = time.monotonic() - t0
        windows0 = engine.windows_dispatched
        hits0 = engine.prefix_hit_blocks
        pre_wall, pre_busy, _ = _profiled_round(engine, round_of(1))
        if engine.windows_dispatched != windows0:
            raise RuntimeError("the prefill-only round dispatched decode "
                               "windows")
        launches0 = attention.KERNEL.launches + attention.KERNEL.launches_int8
        bytes0 = engine.runner.attention_bytes
        last = round_of(MAX_TOKENS)
        wall, busy, by_name = _profiled_round(engine, last)
        if engine.prefix_hit_blocks != hits0:
            raise RuntimeError("a profiled round hit the prefix cache")
        windows = engine.windows_dispatched - windows0
        launches = (attention.KERNEL.launches
                    + attention.KERNEL.launches_int8 - launches0)
        attn_bytes = engine.runner.attention_bytes - bytes0
        made1 = made() - made1
        # Second round: warm-up ones, then a timed and a profiled one, each
        # sharing the prefix of the round before's request SHARED_FROM.
        shared = last[SHARED_FROM]["token_ids"]
        for _ in range(WARMUP_ROUNDS):
            asyncio.run(serve(engine, round2_requests(spec, shared, rng)))
        made2 = made()
        chunks0 = len(engine.chunk_records)
        t0 = time.monotonic()
        r2 = asyncio.run(serve(engine, round2_requests(
            spec, shared, rng)))
        r2_timed = time.monotonic() - t0
        r2_chunks = [c["device_ms"]
                     for c in list(engine.chunk_records)[chunks0:]]
        r2_wall, r2_busy, r2_by_name = _profiled_round(
            engine, round2_requests(spec, shared, rng))
        made2 = made() - made2
    finally:
        engine.stop()
    alone = window_alone(engine)
    steps = windows * engine.decode_window
    top = [{"name": name[:90], "device_ms": us / 1e3,
            "share_of_busy": us * 1e-6 / busy}
           for name, us in by_name.most_common(12)]
    # Both kernels of one launch: hist_flash_partial and hist_flash_combine.
    attn_ms = sum(us for name, us in by_name.items()
                  if "hist_flash_" in name) / 1e3
    attn_bound_ms = attn_bytes / (DEFAULT_HBM_GBPS * 1e9) * 1e3
    out = {
        "tree": str(tree),
        "device": torch.cuda.get_device_name(0), "smi": smi_line(),
        "model": spec.name, "kv_pool": engine.runner.quant_kv or "bf16",
        "kv_pages": engine.runner.num_pages, "requests": len(requests),
        "max_tokens": MAX_TOKENS, "prompt_tokens": sum(PROMPT_LENS),
        "timed_round": {"wall_s": timed_wall,
                        "tok_per_s": len(requests) * MAX_TOKENS / timed_wall,
                        "ttft_ms_median": ttfts[len(ttfts) // 2] * 1e3,
                        "ttft_ms_max": ttfts[-1] * 1e3},
        "prefill_only_round": {"wall_s": pre_wall, "device_busy_s": pre_busy},
        "profiled_wall_s": wall, "device_busy_s": busy,
        "device_idle_share": 1 - busy / wall,
        "windows": windows, "decode_steps": steps,
        "kernel_launches": launches,
        "decode_device_ms_per_step": ((busy - pre_busy) * 1e3 / steps
                                      if steps else None),
        "paged_attention_device_ms": attn_ms,
        "paged_attention_ms_per_launch": (attn_ms / launches
                                          if launches else None),
        "paged_attention_bytes": attn_bytes,
        "paged_attention_bound_ms": attn_bound_ms,
        "paged_attention_roofline_share": (attn_bound_ms / attn_ms
                                           if attn_ms else None),
        "top_device_ops": top,
        "round2": {
            "timed_wall_s": r2_timed,
            "tok_per_s": sum(len(r["tokens"]) for r in r2) / r2_timed,
            "ttft_ms": [r["ttft_s"] * 1e3 for r in r2],
            "chunk_device_ms": r2_chunks,
            "profiled_wall_s": r2_wall, "device_busy_s": r2_busy,
            "device_idle_share": 1 - r2_busy / r2_wall,
            "top_device_ops": [
                {"name": name[:90], "device_ms": us / 1e3,
                 "share_of_busy": us * 1e-6 / r2_busy}
                for name, us in r2_by_name.most_common(12)]},
        "window_alone": alone,
        "warmup_s": getattr(engine, "warmup_seconds", None),
        "programs_made_in_measured_rounds": [made1, made2],
        "window_programs": programs() if programs else None,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
