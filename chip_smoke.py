"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:
1. build: compile the paged decode-attention kernel
   (dynamo_tpu_torch/csrc/paged_attention.cu) with nvcc for sm_90a.
2. kernel: hold the kernel against its plain torch version through both
   wrappers (paged_window_attention, paged_decode_attention) over D in
   {32, 64, 128}, ragged / zero / >8-page histories, MQA and GQA, layer > 0,
   shuffled page tables and window steps m in {0, 3}; then time the kernel,
   its plain version and SDPA over the gathered pages (a yardstick the port
   never calls) at llama-3-8b decode shapes.
3. main path: build the engine with launch.build_engine for llama-3-8b at
   full width (random weights, seed 0), serve 8 concurrent requests through
   GPUEngine.generate, check every request, check that every decode step of
   every layer launched the kernel, and hold teacher-forced decode logits of
   the kernel path against the plain attention path on the card.
The last lines are the kernels' JSON summary, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
import traceback

import numpy as np
import torch

# Kernel vs plain version, same bf16 inputs. Both accumulate in fp32; only
# summation order and exp rounding differ on the history triple. The
# wrappers' outputs are bf16, where one ulp is 2^-7 relative.
TRIPLE_TOL = dict(atol=2e-3, rtol=2e-3)
OUTPUT_TOL = dict(atol=1.6e-2, rtol=1.6e-2)
# Teacher-forced logits, kernel path vs plain path over 32 layers: the
# plain path rounds probabilities to bf16 before PV (2^-8 relative per
# weight) and the two paths' bf16 activations then drift by ulps per layer.
LOGIT_ATOL = 0.25

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12       # dense bf16 tensor cores, H100 SXM data sheet


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Phase 2: kernel against its plain version
# ---------------------------------------------------------------------------

def make_case(gen, d, b, nkv, qpk, hist, L=2, page=16, M=8, extra_pages=3):
    maxp = max(1, max(-(-h // page) for h in hist)) + extra_pages
    npages = b * maxp + 2

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16).cuda()

    # Shuffled page tables; entries past the live pages point anywhere.
    perm = torch.randperm(npages - 1, generator=gen) + 1
    pt = perm[:b * maxp].reshape(b, maxp).to(torch.int32).cuda()
    return dict(q=rnd(b, nkv * qpk, d), kc=rnd(L, nkv, npages, page, d),
                vc=rnd(L, nkv, npages, page, d), pt=pt,
                hl=torch.tensor(hist, dtype=torch.int32).cuda(),
                ks=rnd(b, nkv, d), vs=rnd(b, nkv, d),
                kw=rnd(nkv, b, M, d), vw=rnd(nkv, b, M, d), qpk=qpk)


def check_kernel(attention) -> float:
    """Kernel (CUDA tensors) against the plain version on the same inputs:
    the raw triple against hist_flash_plain on the card, and both wrappers
    against themselves on CPU copies (where they run the plain version).
    Returns the largest absolute error of the normalised triple."""
    gen = torch.Generator().manual_seed(1)
    cases = [
        # (d, b, nkv, qpk, hist, layer, window m)
        (32, 4, 2, 2, [0, 5, 17, 140], 1, 0),        # zero + ragged
        (64, 3, 2, 4, [300, 0, 131], 1, 3),          # > 8 pages, GQA
        (64, 2, 2, 7, [64, 65], 0, 3),               # qwen2.5 grouping
        (128, 4, 8, 4, [0, 33, 1000, 2049], 1, 0),   # llama-3 grouping
        (128, 2, 1, 8, [129, 700], 1, 3),            # MQA
    ]
    worst = 0.0
    for d, b, nkv, qpk, hist, layer, m in cases:
        c = make_case(gen, d, b, nkv, qpk, hist)
        args = (c["q"], c["kc"], c["vc"], layer, c["pt"], c["hl"], qpk)
        acc, l, mx = attention.KERNEL(*args)
        torch.cuda.synchronize()
        acc_p, l_p, mx_p = attention.hist_flash_plain(*args)
        live = torch.tensor(hist, device="cuda") > 0
        out_k = (acc / l.clamp_min(1e-30))[live]
        out_p = (acc_p / l_p.clamp_min(1e-30))[live]
        torch.testing.assert_close(out_k, out_p, **TRIPLE_TOL)
        torch.testing.assert_close(mx[live], mx_p[live], **TRIPLE_TOL)
        if not bool(live.all()):
            empty = ~live
            assert bool((l[empty] == 0).all() and (acc[empty] == 0).all()), \
                "empty history must give l = 0, acc = 0"
        worst = max(worst, float((out_k - out_p).abs().max()))

        cpu = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in c.items()}
        win_k = attention.paged_window_attention(
            c["q"], c["kc"], c["vc"], layer, c["pt"], c["hl"], c["kw"],
            c["vw"], m, c["ks"], c["vs"], qpk)
        win_p = attention.paged_window_attention(
            cpu["q"], cpu["kc"], cpu["vc"], layer, cpu["pt"], cpu["hl"],
            cpu["kw"], cpu["vw"], m, cpu["ks"], cpu["vs"], qpk)
        dec_k = attention.paged_decode_attention(
            c["q"], c["kc"], c["vc"], layer, c["pt"], c["hl"], c["ks"],
            c["vs"], qpk)
        dec_p = attention.paged_decode_attention(
            cpu["q"], cpu["kc"], cpu["vc"], layer, cpu["pt"], cpu["hl"],
            cpu["ks"], cpu["vs"], qpk)
        torch.cuda.synchronize()
        torch.testing.assert_close(win_k.float().cpu(), win_p.float(),
                                   **OUTPUT_TOL)
        torch.testing.assert_close(dec_k.float().cpu(), dec_p.float(),
                                   **OUTPUT_TOL)
        log(f"kernel ok: D={d} B={b} Nkv={nkv} qpk={qpk} hist={hist} "
            f"layer={layer} m={m} max|err|={worst:.3g}")

    # A history longer than its page-table row counts only the row's
    # tokens: the last row's table ends the allocation, so a read past it
    # would leave the table.
    c = make_case(gen, 64, 2, 2, 4, [20, 100], extra_pages=0)
    cap = c["pt"].shape[1] * c["kc"].shape[3]
    c["hl"] = torch.tensor([20, cap + 1000], dtype=torch.int32, device="cuda")
    args = (c["q"], c["kc"], c["vc"], 1, c["pt"], c["hl"], 4)
    acc, l, _ = attention.KERNEL(*args)
    acc_p, l_p, _ = attention.hist_flash_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(acc / l, acc_p / l_p, **TRIPLE_TOL)
    worst = max(worst, float((acc / l - acc_p / l_p).abs().max()))
    log(f"kernel ok: history {cap + 1000} clamped to the row's {cap} tokens")
    return worst


def time_kernel(attention) -> dict:
    """llama-3-8b decode shapes: B=32, Nkv=8, qpk=4, D=128, page 16,
    history 2048 for every row, layer 1 of a 2-layer pool."""
    gen = torch.Generator().manual_seed(2)
    b, nkv, qpk, d, hist, page = 32, 8, 4, 128, 2048, 16
    c = make_case(gen, d, b, nkv, qpk, [hist] * b, page=page, extra_pages=0)
    args = (c["q"], c["kc"], c["vc"], 1, c["pt"], c["hl"], qpk)
    launches = attention.KERNEL.launches
    ms = time_ms(lambda: attention.KERNEL(*args))
    acc, l, mx = attention.KERNEL(*args)
    attention.KERNEL.launches = launches  # timing launches are not counted
    acc_p, l_p, _ = attention.hist_flash_plain(*args)
    out_k, out_p = acc / l, acc_p / l_p
    torch.testing.assert_close(out_k, out_p, **TRIPLE_TOL)
    max_err = float((out_k - out_p).abs().max())
    log(f"kernel ok at the timed shape: max|err|={max_err:.3g}")
    del acc, l, mx, acc_p, l_p, out_k, out_p
    plain_ms = time_ms(lambda: attention.hist_flash_plain(*args))
    # Yardstick: one SDPA call over the same history, gathered beforehand.
    pt = c["pt"].long()
    k = c["kc"][1][:, pt].reshape(nkv, b, hist, d).transpose(0, 1)
    v = c["vc"][1][:, pt].reshape(nkv, b, hist, d).transpose(0, 1)
    k, v = k.contiguous(), v.contiguous()
    q = c["q"][:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(q, k, v, enable_gqa=True))
    bytes_moved = attention.hist_flash_bytes(c["hl"], nkv * qpk, c["kc"])
    flops = 4 * b * hist * nkv * qpk * d              # QK^T and PV
    bound_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    bound_ops = flops / H100_BF16_FLOPS * 1e3
    out = {"shape": f"B={b} Nkv={nkv} qpk={qpk} D={d} hist={hist}",
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
           "bytes": bytes_moved, "flops": flops, "max_abs_err": max_err,
           "achieved_GBps": bytes_moved / (ms * 1e-3) / 1e9}
    for what, key in (("kernel", "ms"), ("plain", "plain_ms"),
                      ("library_sdpa", "library_ms")):
        log(json.dumps({"timing": what, "shape": out["shape"],
                        "ms": out[key]}))
    log(json.dumps({"timing": "paged_attention_hist", **out}))
    return out


# ---------------------------------------------------------------------------
# Phase 3: main path
# ---------------------------------------------------------------------------

def teacher_forced_check(engine, prompt, generated, attention, model) -> float:
    """Prefill ``prompt`` into a private pool, then run one window of
    teacher-forced decode steps over ``generated`` twice on the same
    inputs: through the kernel wrapper and through the plain gather.
    Returns the largest absolute logit difference."""
    runner = engine.runner
    spec, cfg, dev = runner.spec, engine.config, runner.device
    page, M = cfg.page_size, engine.decode_window
    n = len(prompt)
    bucket = cfg.bucket_for(n)
    pages = bucket // page + -(-M // page) + 1
    shape = (spec.num_layers, spec.num_kv_heads, pages + 1, page,
             spec.head_dim)
    kc = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    table = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)[None]
    tok = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    tok[0, :n] = torch.tensor(prompt, dtype=torch.int32)
    pos = torch.clamp(torch.arange(bucket, device=dev), max=n - 1)[None]
    model.prefill_forward(runner.params, spec, kc, vc, tok,
                          pos.to(torch.int32), table[:, :bucket // page],
                          torch.tensor([n], dtype=torch.int32, device=dev))
    hist = torch.tensor([n], dtype=torch.int32, device=dev)
    kbuf = torch.zeros((spec.num_layers, spec.num_kv_heads, 1, M,
                        spec.head_dim), dtype=torch.bfloat16, device=dev)
    vbuf = torch.zeros_like(kbuf)
    worst = 0.0
    for m in range(M):
        # The token fed at step m sits at position n + m.
        args = (runner.params, spec, kc, vc, kbuf, vbuf, m,
                torch.tensor([generated[m]], dtype=torch.int32, device=dev),
                torch.tensor([n + m], dtype=torch.int32, device=dev),
                table, hist)
        lk, k_new, v_new = model.decode_window_step(
            *args, attention_impl=attention.paged_window_attention)
        lp, _, _ = model.decode_window_step(*args)
        kbuf[:, :, :, m] = k_new.transpose(1, 2)
        vbuf[:, :, :, m] = v_new.transpose(1, 2)
        diff = float((lk - lp).abs().max())
        assert torch.isfinite(lk).all() and torch.isfinite(lp).all()
        assert diff <= LOGIT_ATOL, f"step {m}: |logit diff| {diff} > " \
                                   f"{LOGIT_ATOL}"
        worst = max(worst, diff)
    return worst


def main_path(attention, model) -> dict:
    from dynamo_tpu_torch import launch
    from dynamo_tpu_torch.profile_decode import (MAX_TOKENS, MODEL,
                                                 PROMPT_LENS, serve)

    args = launch.parse_args(["out=gpu", "--model", MODEL, "--seed", "0"])
    t0 = time.monotonic()
    engine = launch.build_engine(args)
    setup_s = time.monotonic() - t0
    spec = engine.runner.spec
    log(f"engine: {spec.name} layers={spec.num_layers} "
        f"hidden={spec.hidden_size} pages={engine.runner.num_pages} "
        f"pool={engine.runner.kv_pool_bytes / 2**30:.1f} GiB "
        f"params={engine.runner.param_bytes / 2**30:.1f} GiB "
        f"window={engine.decode_window} setup={setup_s:.1f}s")
    rng = np.random.default_rng(0)
    sampling = [{}] * 6 + [{"temperature": 0.8, "top_p": 0.9},
                           {"temperature": 0.8, "seed": 1234}]
    prompts = [rng.integers(0, spec.vocab_size, size=n).tolist()
               for n in PROMPT_LENS]
    requests = [{"model": spec.name, "token_ids": p,
                 "stop_conditions": {"max_tokens": MAX_TOKENS},
                 "sampling_options": s} for p, s in zip(prompts, sampling)]
    try:
        attention.KERNEL.launches = 0
        windows0 = engine.windows_dispatched
        t0 = time.monotonic()
        results = asyncio.run(serve(engine, requests))
        wall = time.monotonic() - t0
        launches = attention.KERNEL.launches
        windows = engine.windows_dispatched - windows0
        for i, r in enumerate(results):
            assert r["finish"] == "length", (i, r["finish"])
            assert len(r["tokens"]) == MAX_TOKENS, (i, len(r["tokens"]))
            assert all(0 <= t < spec.vocab_size for t in r["tokens"])
        expected = windows * engine.decode_window * spec.num_layers
        assert launches == expected and launches > 0, (launches, expected)
        win_ms = sorted(s * 1e3 for s in engine.window_seconds)
        ttft = sorted(r["ttft_s"] * 1e3 for r in results)
        n_tok = sum(len(r["tokens"]) for r in results)
        stats = {"requests": len(results), "tokens": n_tok,
                 "wall_s": wall, "tok_per_s": n_tok / wall,
                 "ttft_ms_median": ttft[len(ttft) // 2],
                 "ttft_ms_max": ttft[-1], "windows": windows,
                 "window_steps": engine.decode_window,
                 "window_ms_median": win_ms[len(win_ms) // 2],
                 "window_ms_max": win_ms[-1],
                 "kernel_launches": launches}
        log(json.dumps({"main_path": stats}))
    finally:
        engine.stop()
    worst = teacher_forced_check(engine, prompts[0], results[0]["tokens"],
                                 attention, model)
    log(f"teacher-forced logits, kernel vs plain path: max|diff|={worst:.4f}"
        f" (tolerance {LOGIT_ATOL})")
    stats["teacher_forced_max_abs_diff"] = worst
    return stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    try:
        from dynamo_tpu_torch.engine import attention, model
        from dynamo_tpu_torch.profile_decode import smi_line
    except ImportError:
        print("chip_smoke: run from the root of a checkout of the repo "
              "(dynamo_tpu_torch not importable)", file=sys.stderr)
        traceback.print_exc()
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} | {smi}")
    try:
        attention.KERNEL.build()
        log(f"build: {attention.KERNEL.build_seconds:.1f}s")
        for line in attention.KERNEL.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log("  " + line.strip())
        max_err = check_kernel(attention)
        timing = time_kernel(attention)
        torch.cuda.empty_cache()
        stats = main_path(attention, model)
    except Exception:  # noqa: BLE001 — report and fail the run
        traceback.print_exc()
        return 1
    kernel = {"name": "paged_attention_hist", "route": "cuda",
              "source": "dynamo_tpu_torch/csrc/paged_attention.cu",
              "replaces": "dynamo_tpu/engine/attention.py:72",
              "launches": stats["kernel_launches"],
              "max_abs_err": max(max_err, timing["max_abs_err"]),
              "ms": timing["ms"],
              "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
              "bound_by": timing["bound_by"],
              "library_ms": timing["library_ms"]}
    log(json.dumps({"kernels": [kernel]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
