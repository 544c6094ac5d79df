"""Where serving time goes on the card: wall time, device busy time, idle
share and the device time of each kernel, for one round of requests.

    python -m dynamo_tpu_torch.profile_decode

Builds the llama-3-8b engine with ``launch.build_engine`` (random weights,
seed 0) and serves rounds of the traffic ``chip_smoke.py``'s first round
serves (prompt lengths ``PROMPT_LENS``, ``MAX_TOKENS`` each, greedy): one
warm-up round, a timed round without the profiler (wall, tok/s, TTFT),
then two rounds under ``torch.profiler`` (CPU and CUDA activities): one
with ``max_tokens`` 1, which only prefills, and a full round. Every round
draws fresh prompts of those lengths, so none is served from the prefix
cache and each prefills cold. Then the traffic of ``chip_smoke.py``'s
second round (``round2_requests``: prefix hits, a chunked 6000-token
prompt, penalties, logprobs): a warm-up round, a timed one (tok/s, TTFTs,
each chunk's device ms) and one under the profiler. Device busy time is the union of the device
events' intervals; the idle share is 1 - busy / profiled wall time. Decode device time per step is the full round's busy
time less the prefill-only round's, over the decode steps. The runner
counts the bytes every paged attention launch must move
(``ModelRunner.attention_bytes``); their time at the HBM rate, over the
kernel's profiled device time in the same round, is its roofline share on
the main path. The pool is bf16 unless ``DTPU_QUANT_KV=int8`` asks for the
int8 pool, whose decode steps run the kernel's int8 variant. Prints one
JSON line. Runs on a GPU only.
"""

from __future__ import annotations

import asyncio
import collections
import json
import subprocess
import sys
import time

import numpy as np
import torch

from dynamo_tpu_torch import launch
from dynamo_tpu_torch.engine import attention
from dynamo_tpu_torch.engine.config import DEFAULT_HBM_GBPS
from dynamo_tpu_torch.runtime.context import Context

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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_decode: needs a GPU", file=sys.stderr)
        return 1
    engine = launch.build_engine(launch.parse_args(
        ["out=gpu", "--model", MODEL, "--seed", "0"]),
        max_prefill_tokens=MAX_PREFILL_TOKENS)
    spec = engine.runner.spec
    rng = np.random.default_rng(0)

    def round_of(max_tokens):
        # Fresh prompts every round: a repeated prompt would be served
        # from the prefix cache, and each round prefills them cold.
        return [{"model": spec.name,
                 "token_ids": rng.integers(0, spec.vocab_size, n).tolist(),
                 "stop_conditions": {"max_tokens": max_tokens}}
                for n in PROMPT_LENS]

    requests = round_of(MAX_TOKENS)
    try:
        asyncio.run(serve(engine, requests))  # warm-up: first-call costs
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
        # Second round: a warm-up one, then a profiled one, each sharing
        # the prefix of the round before's request SHARED_FROM.
        shared = last[SHARED_FROM]["token_ids"]
        warm = round2_requests(spec, shared, rng)
        asyncio.run(serve(engine, warm))
        chunks0 = len(engine.chunk_records)
        t0 = time.monotonic()
        r2 = asyncio.run(serve(engine, round2_requests(
            spec, warm[0]["token_ids"], rng)))
        r2_timed = time.monotonic() - t0
        r2_chunks = [c["device_ms"]
                     for c in list(engine.chunk_records)[chunks0:]]
        r2_wall, r2_busy, r2_by_name = _profiled_round(
            engine, round2_requests(spec, warm[0]["token_ids"], rng))
    finally:
        engine.stop()
    steps = windows * engine.decode_window
    top = [{"name": name[:90], "device_ms": us / 1e3,
            "share_of_busy": us * 1e-6 / busy}
           for name, us in by_name.most_common(12)]
    # Both kernels of one launch: hist_flash_partial and hist_flash_combine.
    attn_ms = sum(us for name, us in by_name.items()
                  if "hist_flash_" in name) / 1e3
    attn_bound_ms = attn_bytes / (DEFAULT_HBM_GBPS * 1e9) * 1e3
    out = {
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
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
