"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:
1. build: compile the paged decode-attention kernel, both entry points
   (paged_attention_hist for a bf16 pool, paged_attention_hist_int8 for an
   int8 pool with per-token scales), from
   dynamo_tpu_torch/csrc/paged_attention.cu with nvcc for sm_90a.
2. kernels: hold each variant against its plain torch version through both
   wrappers (paged_window_attention, paged_decode_attention) over D in
   {32, 64, 128}, ragged / zero / >8-page histories, MQA and GQA, layer > 0,
   shuffled page tables, window steps m in {0, 3} and a history clamped to
   its page-table row; then time each variant, its plain version and a
   yardstick at llama-3-8b decode widths at two shapes, B=32 x 2048 and the
   main path's mid-round histories (8 live rows of 32 slots, a 128-page
   bucket): SDPA over the gathered pages for bf16, and for int8 SDPA over
   pages gathered and dequantized beforehand (no single PyTorch call reads
   int8 pages with per-token scales), as one call over the pages up to the
   longest live history and as one call per live row. The kernel's time is
   its device time by CUDA-graph replay, with its eager and host time per
   call beside it (dynamo_tpu_torch/time_attention.py). The build's report
   gives each kernel's registers, spills and dynamic shared memory, and
   each timing its split count S. Then the sampling noise:
   sampler.gumbel_field on the card equals the CPU's bits over seeded and
   unseeded keys at the llama-3-8b vocabulary, and gumbel_of_bits over
   all 2^24 uniforms. Then the verify route of speculative decoding
   (paged_verify_attention: each entry point launched once over a slot's
   S positions folded into the batch) against its plain version
   (model.paged_verify_attention_plain) on both pools within OUTPUT_TOL:
   ragged and zero histories, 0, some and all window columns valid, S in
   {1, 4}, GQA and MQA, layer > 0; and its times at B=32 x S=4 over
   history 2048 and the main path's mid-round histories (the kernel's
   launch alone and the wrapper by graph replay, the plain version, SDPA
   over the gathered pages), with the bytes its launch moves (each slot's
   pages read S times) beside the bound (read once).
3. main path, bf16 pool: build the engine with launch.build_engine for
   llama-3-8b at full width (random weights, seed 0; one prefill program
   takes at most 2048 tokens), serve 8 concurrent requests through
   GPUEngine.generate, check every request, check that every decode step
   of every layer launched the bf16 kernel, and hold teacher-forced decode
   logits of the kernel path against the plain attention path on the
   card. Then a second round on the same engine: four greedy requests that
   open with 1024 tokens of a round-1 prompt (64 cached pages, prefilled
   over that history), a 6000-token prompt (three chunks of up to 2048,
   the last two over history, between the others' decode windows), a
   request with presence/frequency penalties and logprobs, and a seeded
   sampled one with logprobs, 32 tokens each. Checked: every request
   finishes; the prefix cache served at least 4 x 64 blocks; the long
   prompt took three chunks with a decode window between its first and
   last; every decode step of every layer launched the bf16 kernel; the
   first-token logits of a prefix-hit request and of the long prompt
   against the same prompts prefilled whole; the penalised request's
   tokens and logprobs against a teacher-forced plain path with the same
   penalties. It prints the round's tok/s and TTFTs, the prefix hit
   ratio, each chunk's device ms, peak memory, hashing ms per 1000 tokens
   and a window's ms with and without a logprobs row beside the decode
   device ms a step (torch.profiler). A window replayed from its
   program's CUDA graph equals the same program's body run eagerly on
   the same packed state (greedy tokens equal, chosen and top-5 logprobs
   within 1e-5), and the engine's window programs are printed: made,
   captured, capture seconds, warmup seconds (launch.build_engine leaves
   warmup_windows off, as the reference's launcher does: these programs
   are captured at first use) and graph-pool bytes. The engine is then
   released.
4. main path, int8 pool: the same with --quant-kv int8: every decode step
   of every layer, in both rounds, launches the int8 kernel and never the
   bf16 one; the teacher-forced checks run on int8 pools, and round 1's
   logits stay cosine-close (> 0.99) to the bf16 pool's for the same
   tokens.
5. the OpenAI front at full width: launch.start_http (what ``python -m
   dynamo_tpu_torch.launch in=http`` runs) builds llama-3-8b (bf16 pool,
   seed 0) behind the HTTP front on 127.0.0.1 port 0 in this process. The
   six chat prompts, then the alone chat's, go once through
   engine.generate (their TTFT at the engine boundary) and leave the
   prefix cache; then, from http.client
   threads: /v1/models and /health; six concurrent streamed chats of
   200-1500 rendered tokens (four greedy, one sampled with a seed, one
   with logprobs and 3 alternatives) beside a streamed completion of
   1024 random token ids, 32 tokens each with ignore_eos; one greedy
   chat alone, streamed, then again alone and not streamed; a malformed
   body and an unknown model. Checked: SSE framing and [DONE]; finish
   length and 32 completion tokens; prompt_tokens equal to the port
   tokenizer's count of the rendered template; 32 logprob entries of 3
   alternatives; equal text and usage of the alone pair; 400 and 404
   with the reference's error shape; paged_attention_hist launched
   windows x M x 32 times, the int8 entry 0 times. It prints each
   request's TTFT, median gap between chunks and time per output token
   at the client, the phase's tok/s, and the TTFTs of the six chats and
   of the alone chat through engine.generate. Then ``python -m dynamo_tpu_torch.launch
   in=http out=gpu --model tiny-test --http-port 0`` runs as a
   subprocess: its engine is on cuda without --device, it answers a
   streamed chat and exits 0 on SIGTERM.
6. the distributed main path at full width, before phase 5's engine is
   released: in this process and over TCP on 127.0.0.1, a worker
   DistributedRuntime with an embedded coordinator serves
   engine.handler() on the request plane and registers the model
   (backends.gpu.serve_engine), and a frontend DistributedRuntime runs a
   ModelWatcher behind the HTTP front (launch.start_front). Phase 5's six
   streamed chats and 1024-id completion go again, then its alone chat,
   streamed, each prompt first dropped from the prefix cache. Checked:
   framing and [DONE]; finish length and 32 completion tokens;
   prompt_tokens equal to phase 5's; the alone chat's token ids (read by
   a tap on engine.generate) equal phase 5's alone chat at the engine
   boundary, and its text and usage equal phase 5's; /v1/models through
   discovery; paged_attention_hist launched windows x M x 32 times, the
   int8 entry 0 times. It prints each request's client TTFT and TPOT
   beside phase 5's, the phase's tok/s, its seconds, and the mean us of
   packb + unpackb over the phase's data frames. Then the coordinator,
   ``python -m dynamo_tpu_torch.backends.gpu --model tiny-test`` and
   ``python -m dynamo_tpu_torch.frontend --http-port 0`` run as
   subprocesses: the worker's engine is on cuda without --device, a
   streamed chat is answered, and all three exit 0 on SIGTERM.
7. real checkpoints at full width. a. The seed-0 llama-3-8b tree (the
   preset's weights) is written as a HF checkpoint of the public
   Meta-Llama-3-8B config.json (CKPT_LAYERS layers) in HF names and
   [out, in] layout, bf16, in shards of at most 5 GB, with
   engine/safetensors_lite.save_file into a temporary directory (its free
   space printed first), beside the test tokenizer's tokenizer.json.
   b. launch.build_engine with --model DIR loads it: every leaf equals
   the written one; round 1 is served and checked as in phase 3 (every
   decode step of every layer launches paged_attention_hist); its greedy
   ids equal phase 3's preset engine's, or split only at a near-tie of
   the teacher-forced logits; its teacher-forced logits are within
   LOGIT_ATOL of phase 3's. c. The same with --quant int8: wq and w_down
   of three layers and the embedding, quantized on the card, equal the
   CPU quantizer's q and s bit for bit; the teacher-forced logits have
   cosine > 0.99 to phase 3's bf16 weights'; round 1 is served on a bf16
   pool and again with --quant-kv int8 (the int8 entry only). d. The
   Qwen2.5-0.5B config (tied, qkv bias) is written the same way without a
   tokenizer.json: its int8 weights' prefill logits have cosine > 0.99 to
   its bf16 weights', and ``python -m dynamo_tpu_torch.launch --model DIR
   --quant int8 --tokenizer X.gguf --http-port 0`` (a GGUF of the test
   tokenizer, written by llm/gguf.write_metadata) runs as a subprocess:
   its engine is on cuda without --device, it answers a streamed chat and
   exits 0 on SIGTERM. e. It prints the write and load seconds and load
   GB/s, param bytes and pool pages for bf16 and int8 weights, decode
   device ms per step of a window run alone (torch.profiler), round 1's
   tok/s for each, and the device ms of one int8-weight mm against the
   bf16 matmul at [32, 4096] x [4096, 14336].
8. disaggregated prefill and decode at full width, after phase 7's
   engines are released. Two seed-0 llama-3-8b engines, each built as
   ``backends.gpu --mode prefill|decode`` builds it with DISAGG_PAGES
   pages (8 GiB of bf16 pages each, so both fit the card), serve in this
   process over TCP on 127.0.0.1: a decode worker runtime with an
   embedded coordinator (``backends.gpu.decode_handler`` and
   ``serve_engine``: DisaggDecodeHandler, the model registered), a
   prefill worker runtime (``backends.gpu.serve_prefill``: the prefill
   handler and the prefill-queue worker, with its KvPlaneServer) and a
   frontend runtime (``launch.start_front``). Traffic, from http.client
   threads as streamed completions of token ids with ignore_eos: round
   1's eight prompts (6 greedy, top-p, seeded; 64 tokens each) and round
   2's 6000-token prompt (32 tokens), max_local_prefill_length 512 (the
   128- and 300-token prompts stay local). Four passes, each on a fresh
   stack with both prefix caches first cleared through the decode
   handler's clear_kv_blocks (which fans out to the prefill worker):
   bf16 pools over the KV plane; bf16 pools inline (no plane); the
   decode pool rebuilt as int8 with bf16 parcels quantized on insert;
   the prefill pool rebuilt as int8 too (packed parcels). Checked in
   each: every request finishes at its max_tokens; remote_prefills
   equals the prompts over 512 tokens, remote_failures is 0, each of
   them was admitted with its parcel (no local fallback at admission)
   and the rest prefilled locally; paged_attention_hist (the int8 entry on the
   int8 pool) launched windows x M x 32 times on the decode worker and
   the other entry 0 times, and the prefill worker ran no window; the
   plane pulled every parcel and the long prompt streamed as three page
   groups (128, 128, 119 pages); greedy ids equal phase 3's (bf16 pool)
   or phase 4's (int8 pool) aggregated ids, or split only at a near-tie
   of the teacher-forced logits (the long prompt of the mixed pass,
   whose chunks ran over bf16 history, against the plain path of that
   computation); the seeded request's tokens equal the same request
   served aggregated, alone, by the decode worker's engine; on the card,
   for both pools, a parcel extracted from the prefill pool equals its
   pages (bf16 bits, or pack_parcel of the int8 values and scales) and,
   inserted into free pages of the decode pool and extracted again, is
   bit-exact, with both pools' bytes equal at those pages, and neither
   the extract's dispatch nor the insert synchronizes the card; and the
   int8 pool's pages from bf16 parcels equal quantize_np of the prefill
   pool's pages. It prints, per remote request, the parcel bytes, the
   extract's device ms (gathers and copies to pinned memory), the pull
   ms (its wait for the first page group, and the receive and GB/s
   after it), the insert's device and host ms, TTFT and TPOT at the
   decode worker's handler beside phase 3's (or 4's) engine-boundary
   TTFT of the same prompt, and the client's first chunk (the test
   tokenizer decodes most ids to no text, so few chunks reach the
   client); per pass its tok/s. Then the coordinator, ``python -m
   dynamo_tpu_torch.backends.gpu --mode prefill`` and ``--mode decode
   --max-local-prefill-length 8`` (tiny-test, no --device: each must log
   an engine on cuda) and the frontend run as subprocesses: a streamed
   chat over the threshold is prefilled on the prefill worker and
   answered, and all four exit 0 on SIGTERM.
9. KV-cache-aware routing at full width, after phase 8's engines are
   released. Two seed-0 llama-3-8b engines cut to KV_LAYERS of its 32
   layers (every width kept; the phase compares its two passes with each
   other, never with phase 3), each built as ``backends.gpu`` builds it in
   agg mode with DISAGG_PAGES pages, each behind its own
   worker runtime (the first embeds the coordinator) with its three
   publishers (``backends.gpu.make_publishers``: KV events, load metrics,
   inventory digests; the engine started on the phase's event loop) and
   ``serve_engine``, and a frontend runtime with ``launch.start_front``
   under ``--router-mode kv`` at the reference's defaults. Traffic, from
   http.client threads as streamed completions of token ids with
   ignore_eos: wave 1, four 1024-token prefixes at once (16 tokens, one
   greedy request each); then, once the router's index holds their 256
   blocks, wave 2: sixteen requests at once, four per prefix with their
   own 128-token suffixes (32 tokens; three greedy, the last seeded at
   temperature 0.8), in KV_WAVE2_ROUNDS' order, which alternates between
   the two holders and puts every prefix at two even and two odd places.
   Then the same two waves again on a fresh front under round robin,
   after both prefix caches are cleared with clear_kv_blocks. Checked:
   every request finishes at its max_tokens; wave 1 split 2 and 2; every
   wave-2 decision chose the best overlap, at least 64 blocks, and went to
   the prefix's holder; each worker hit at least 6 x 64 blocks in wave 2
   (three greedy requests on each of its two prefixes: a seeded request
   takes the no-reuse path); the kv pass hit more blocks than the
   round-robin pass; the greedy ids of the two passes are equal or split
   at a near-tie of the teacher-forced logits; paged_attention_hist
   launched windows x M x KV_LAYERS times over both workers in each pass,
   the
   int8 entry 0 times; both workers' load metrics and inventory digests
   reached the router (``kv_status()``). It prints each wave-2 request's
   TTFT and TPOT at the worker's engine boundary under both routers, each
   pass's tok/s and prefix hit blocks, the time from the send of wave 1
   and from its last finish to the index holding its blocks, and the
   phase's seconds. Then the coordinator, two ``python -m
   dynamo_tpu_torch.backends.gpu --model tiny-test`` workers (no
   --device: each must log an engine on cuda) and ``python -m
   dynamo_tpu_torch.frontend --router-mode kv`` run as subprocesses; this
   process subscribes to the kv_events and load_metrics subjects, the
   same streamed chat goes twice, the second reaches the worker whose
   stored events hold the prompt's blocks, and all four exit 0 on
   SIGTERM.
10. speculative decoding at full width, after phase 9's engines are
   released: a seed-0 llama-3-8b engine built as ``python -m
   dynamo_tpu_torch.backends.gpu --spec-decode ngram --spec-k 3`` builds
   it (bf16 pool of DISAGG_PAGES pages, warmup_windows set: its one spec
   program is captured at start) serves 8 concurrent requests of 64
   tokens through GPUEngine.generate: four greedy code-like prompts of
   600-1500 tokens (a block of ids repeated with a few renamed, the
   drafter's best case), two greedy random prompts, one seeded at
   temperature 0.8 and one at 0.8 / top_p 0.9. Checked: every request
   finishes at 64 tokens; every window was a replay of the spec program's
   graph; paged_attention_hist launched windows x m_outer x 32 times (the
   verify route), the int8 entry 0 times; the device accepted at least
   one draft on the code-like prompts; each greedy id is the argmax of
   the teacher-forced plain path's logits over the request's own tokens
   (plain_forced_logits) or sits at a near-tie (top-2 margin within 2 x
   LOGIT_ATOL); two verify blocks at full width (the second over the
   first's K/V in the window buffer) give the same logits through the
   kernel route, the plain route and the single-step plain path within
   LOGIT_ATOL; a spec window replayed from its graph equals its body run
   eagerly on the same state (tokens, emitted counts, drafts, and the
   chained tokens, positions and history after). It prints the round's
   tok/s, TTFT and TPOT, the acceptance rate and the emit histogram, a
   spec window's ms run alone (8 rows x 1224 tokens) and a verify step's
   device ms (torch.profiler) with its top ops beside phase 3's decode
   device ms a step, the spec program's capture seconds and graph-pool
   bytes, and the phase's seconds.
11. batched LoRA at full width, after phase 10's engine is released:
   three HF PEFT adapters for llama-3-8b are written from seeds with the
   port's safetensors writer (a: rank 8 and b: rank 16 on all seven
   targets, c: rank 4 with lora_alpha 12 on the attention projections),
   and a seed-0 llama-3-8b engine is built as ``python -m
   dynamo_tpu_torch.backends.gpu --lora a=... --lora b=... --lora c=...
   --max-adapters 2 --max-lora-rank 16`` builds it (bf16 pool of
   DISAGG_PAGES pages, warmup_windows set). Round A: round 1's 8 prompts
   concurrently, 3 on the base model, 3 on a, 2 on b (six greedy, one at
   temperature 0.8 / top_p 0.9, one seeded). Round B: a request on c,
   which hot-loads into the slot LRU frees (b's) while captured programs
   exist, beside one on a; while both are held a request on b is
   answered OverloadedError, and an unknown name AdapterNotFoundError.
   Checked: every request finishes at 64 tokens and every window was a
   graph replay; paged_attention_hist launched windows x 8 x 32 times
   and the int8 entry 0 times; slot 0 is bit-identical to the base model
   (one decode step's logits with the LoRA stacks and ids 0 equal those
   without, and the same window through a runner built without adapters
   on the same parameter tensors and pool gives the same tokens and
   logprobs); every delta of one eager decode step with rows on slots
   0, 1 and 2 (7 targets x 32 layers, model.lora_delta on the card)
   equals a per-row gather computed here without it (x @ A[id] in fp32,
   rounded to bf16, @ B[id]) within LORA_DELTA_RTOL of the delta's
   largest entry, slot-0 rows exact zeros; the greedy base rows equal
   phase 3's ids or split at a near-tie; each greedy adapter row's id is
   the argmax of the eager teacher-forced plain path through its adapter or sits at a near-tie
   (top-2 margin within 2 x LOGIT_ATOL); after the hot-load, a window
   program captured before it, replayed with rows on a and c, equals its
   body run eagerly (tokens equal, logprobs within 1e-5). It prints the
   round's tok/s, TTFT and TPOT, the decode device ms a step with all 8
   rows on adapters beside the same window on the base runner and phase
   3's (torch.profiler; their difference is the LoRA ops' cost), the ms
   of one hot-load of b (rank 16, about 84 MB host to device), the
   stacks' bytes and the phase's seconds.
In every phase from 3 to 11, each decode window an engine dispatched was
a replay of its program's CUDA graph (the runner's replay count rises by
the windows dispatched), and the warmed engines of phases 8-11 (built as
``backends.gpu`` builds them, warmup_windows set) print their programs
after the warmup and after each pass. The last lines are the seconds of
each group of phases, the script's total seconds, the kernels' JSON
summary, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import sys
import time
import traceback

import numpy as np
import torch

# Kernel vs plain version, same bf16 inputs. Both accumulate in fp32; the
# kernel's tensor-core PV product takes each weight as a bf16 high part
# plus a bf16 remainder (relative error under 2^-16), and summation order
# and exp rounding differ on the history triple. The wrappers' outputs are
# bf16, where one ulp is 2^-7 relative.
TRIPLE_TOL = dict(atol=2e-3, rtol=2e-3)
OUTPUT_TOL = dict(atol=1.6e-2, rtol=1.6e-2)
# The int8 kernel and its plain version both dequantize in fp32; the
# kernel applies each token's scale once to its score and PV weight, the
# plain version to every value, so the same tolerances hold.
# Teacher-forced logits, kernel path vs plain path over 32 layers: the
# plain path rounds probabilities to bf16 before PV (2^-8 relative per
# weight), and over an int8 pool also the dequantized K/V (2^-9 relative
# per value), and the two paths' bf16 activations then drift by ulps per
# layer.
LOGIT_ATOL = 0.25
# int8 pool vs bf16 pool logits for the same tokens: the JAX package's own
# quality gate (tests/test_kv_quant.py).
MIN_COSINE = 0.99

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12       # dense bf16 tensor cores, H100 SXM data sheet


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 2: kernel against its plain version
# ---------------------------------------------------------------------------

def to_cpu(v):
    if isinstance(v, tuple):  # QuantKV
        return type(v)(*(t.cpu() for t in v))
    return v.cpu() if torch.is_tensor(v) else v


def check_kernel(attention, quant: bool) -> float:
    """Kernel (CUDA tensors) against the plain version on the same inputs,
    bf16 or int8 pools: the raw triple against hist_flash_plain on the
    card, and both wrappers against themselves on CPU copies (where they
    run the plain version). Returns the largest absolute error of the
    normalised triple."""
    from dynamo_tpu_torch.time_attention import make_case
    kind = "int8" if quant else "bf16"
    gen = torch.Generator().manual_seed(3 if quant else 1)
    if quant:
        # The quantizer on the card gives the CPU's bits, which the CPU
        # tests hold to the reference's numpy quantizer.
        from dynamo_tpu_torch.engine.kv_quant import kv_quantize
        x = torch.randn((64, 8, 16, 128), generator=gen).to(torch.bfloat16)
        (q_g, s_g), (q_c, s_c) = kv_quantize(x.cuda()), kv_quantize(x)
        assert torch.equal(q_g.cpu(), q_c) and torch.equal(s_g.cpu(), s_c)
        log("int8 quantizer on the card: bit-identical to the CPU's")
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
        c = make_case(gen, d, b, nkv, qpk, hist, quant=quant)
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

        cpu = {k: to_cpu(v) for k, v in c.items()}
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
        log(f"{kind} kernel ok: D={d} B={b} Nkv={nkv} qpk={qpk} "
            f"hist={hist} layer={layer} m={m} max|err|={worst:.3g}")

    # A history longer than its page-table row counts only the row's
    # tokens: the last row's table ends the allocation, so a read past it
    # would leave the table.
    c = make_case(gen, 64, 2, 2, 4, [20, 100], extra_pages=0, quant=quant)
    cap = c["pt"].shape[1] * c["kc"].shape[3]
    c["hl"] = torch.tensor([20, cap + 1000], dtype=torch.int32, device="cuda")
    args = (c["q"], c["kc"], c["vc"], 1, c["pt"], c["hl"], 4)
    acc, l, _ = attention.KERNEL(*args)
    acc_p, l_p, _ = attention.hist_flash_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(acc / l, acc_p / l_p, **TRIPLE_TOL)
    worst = max(worst, float((acc / l - acc_p / l_p).abs().max()))
    log(f"{kind} kernel ok: history {cap + 1000} clamped to the row's {cap} "
        f"tokens")
    return worst


def time_kernel(attention, quant: bool, shape: str) -> dict:
    """Time one variant (bf16 or int8 pool) at llama-3-8b decode widths
    (time_attention.SHAPE), at history 2048 in every row (shape "uniform")
    or the main path's mid-round histories (shape "main"): device time by
    CUDA-graph replay, eager and host time per call, its plain version, and
    SDPA over the same live histories."""
    from dynamo_tpu_torch.engine.kv_quant import gather_pages_folded
    from dynamo_tpu_torch.time_attention import (SHAPE, caller, eager_ms,
                                                 graph_ms, timed_case)
    b, nkv, qpk, d, page, maxp = (SHAPE[k] for k in (
        "b", "nkv", "qpk", "d", "page", "maxp"))
    c, hist, layers = timed_case(quant, shape)
    args = (c["q"], c["kc"], c["vc"], 1, c["pt"], c["hl"], qpk)
    ms = graph_ms(caller(attention.KERNEL, c, layers))
    eager, host = eager_ms(caller(attention.KERNEL, c, layers))
    acc, l, mx = attention.KERNEL(*args)
    acc_p, l_p, _ = attention.hist_flash_plain(*args)
    live = c["hl"] > 0
    out_k, out_p = (acc / l)[live], (acc_p / l_p)[live]
    torch.testing.assert_close(out_k, out_p, **TRIPLE_TOL)
    max_err = float((out_k - out_p).abs().max())
    kind = "int8" if quant else "bf16"
    log(f"{kind} kernel ok at the timed shape {shape}: max|err|={max_err:.3g}")
    del acc, l, mx, acc_p, l_p, out_k, out_p
    plain_ms = graph_ms(caller(attention.hist_flash_plain, c, layers))
    # Yardstick: one SDPA call over the live rows' pages up to the longest
    # live history, gathered (and for int8 dequantized to bf16) beforehand,
    # ragged rows masked; and one SDPA call per live row at its exact
    # length, unmasked, the calls' times summed.
    rows = live.nonzero().flatten()
    span = -(-max(hist) // page)
    pt = c["pt"][rows, :span].long()
    k = gather_pages_folded(c["kc"], 1, pt).transpose(0, 1).contiguous()
    v = gather_pages_folded(c["vc"], 1, pt).transpose(0, 1).contiguous()
    q = c["q"][rows][:, :, None, :]
    mask = None
    if min(hist[i] for i in rows.tolist()) < span * page:
        mask = (torch.arange(span * page, device="cuda")[None, :]
                < c["hl"][rows, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_ms = graph_ms(lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True))
    per_row = [(q[i:i + 1], k[i:i + 1, :, :hist[r]].contiguous(),
                v[i:i + 1, :, :hist[r]].contiguous())
               for i, r in enumerate(rows.tolist())]
    sdpa_rows_ms = graph_ms(lambda: [sdpa(*x, enable_gqa=True)
                                     for x in per_row])
    bytes_moved = attention.hist_flash_bytes(c["hl"], nkv * qpk, c["kc"])
    flops = 4 * sum(hist) * nkv * qpk * d              # QK^T and PV
    bound_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    bound_ops = flops / H100_BF16_FLOPS * 1e3
    pps, splits = attention.split_plan(maxp, page)
    name = "paged_attention_hist_int8" if quant else "paged_attention_hist"
    out = {"shape": f"B={b} Nkv={nkv} qpk={qpk} D={d} page={page} "
                    f"maxp={maxp} hist={hist if shape != 'uniform' else 2048}",
           "splits": splits, "pages_per_split": pps,
           "ms": ms, "eager_ms": eager, "host_ms": host,
           "plain_ms": plain_ms,
           "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
           "bytes": bytes_moved, "flops": flops, "max_abs_err": max_err,
           "achieved_GBps": bytes_moved / (ms * 1e-3) / 1e9,
           "sdpa_gathered_tokens": int(rows.numel()) * span * page,
           "sdpa_per_row_ms": sdpa_rows_ms}
    if quant:
        log("int8 library_ms: null; no single PyTorch call computes "
            "attention over int8 pages with per-token scales. "
            "sdpa_bf16_ms is SDPA over the same pages gathered and "
            "dequantized to bf16 beforehand: a yardstick of scale only")
        out.update(library_ms=None, sdpa_bf16_ms=sdpa_ms)
    else:
        out.update(library_ms=sdpa_ms)
    for what, key in (("kernel", "ms"), ("kernel_eager", "eager_ms"),
                      ("kernel_host", "host_ms"), ("plain", "plain_ms"),
                      ("library_sdpa", "library_ms"),
                      ("sdpa_bf16_yardstick", "sdpa_bf16_ms"),
                      ("sdpa_per_row", "sdpa_per_row_ms")):
        if key in out:
            log(json.dumps({"timing": what, "kernel": name,
                            "shape": out["shape"], "ms": out[key]}))
    log(json.dumps({"timing": name, **out}))
    return out


def check_verify(attention, model, quant: bool) -> float:
    """The speculative verify wrapper (attention.paged_verify_attention:
    one launch of the pool's entry point over a slot's S positions folded
    into the batch, then the window and block columns merged) against its
    plain version (model.paged_verify_attention_plain) on the same card
    inputs, bf16 or int8 pool, within OUTPUT_TOL, over ragged and zero
    histories, window buffers with 0, some and all W columns valid, S in
    {1, 4}, GQA and MQA, layer > 0. Returns the largest absolute error."""
    from dynamo_tpu_torch.time_attention import make_verify_case, verify_args
    kind = "int8" if quant else "bf16"
    gen = torch.Generator().manual_seed(5 if quant else 6)
    cases = [
        # (d, nkv, qpk, hist, S, wlen (W = 8), layer)
        (32, 2, 2, [0, 5, 17, 140], 4, [0, 3, 8, 1], 1),
        (64, 2, 4, [300, 0, 131], 1, [2, 0, 8], 1),
        (128, 1, 8, [129, 700], 4, [8, 0], 1),                 # MQA
        (128, 8, 4, [0, 33, 1000, 2049], 4, [4, 4, 0, 8], 1),  # llama-3
        (128, 8, 4, [2048] * 4, 1, [0, 8, 3, 5], 0),
    ]
    worst = 0.0
    for d, nkv, qpk, hist, s, wlen, layer in cases:
        c = make_verify_case(gen, d, len(hist), nkv, qpk, hist, s, wlen,
                             quant=quant)
        args = verify_args(c, layer)
        before = (attention.KERNEL.launches, attention.KERNEL.launches_int8)
        got = attention.paged_verify_attention(*args)
        want = model.paged_verify_attention_plain(*args)
        torch.cuda.synchronize()
        after = (attention.KERNEL.launches, attention.KERNEL.launches_int8)
        assert after == ((before[0], before[1] + 1) if quant
                         else (before[0] + 1, before[1])), (before, after)
        torch.testing.assert_close(got.float(), want.float(), **OUTPUT_TOL)
        err = float((got.float() - want.float()).abs().max())
        worst = max(worst, err)
        log(f"{kind} verify route ok: D={d} B={len(hist)} Nkv={nkv} "
            f"qpk={qpk} hist={hist} S={s} wlen={wlen} layer={layer} "
            f"max|err|={err:.3g}")
    return worst


def time_verify(attention, model, quant: bool, shape: str) -> dict:
    """The verify route at llama-3-8b widths, B=32 slots x S=4 positions
    with 4 of 8 window columns valid (time_attention.timed_verify_case),
    at history 2048 ("uniform") or the main path's mid-round histories
    ("main"): the kernel's one launch over the 128 folded rows and the
    whole wrapper by CUDA-graph replay (and the wrapper eager and on the
    host), its plain version, and SDPA over the live rows' pages gathered
    beforehand (q [B, Nh, S, D], the history columns only, masked past
    each row's history). ``bytes_s_reads`` is what the launch moves with
    each slot's pages read S times; the bound counts them once."""
    import itertools

    from dynamo_tpu_torch.engine.kv_quant import gather_pages_folded
    from dynamo_tpu_torch.time_attention import (
        SHAPE, VERIFY, eager_ms, graph_ms, timed_verify_case, verify_args,
        verify_caller)
    b, nkv, qpk, d, page = (SHAPE[k] for k in ("b", "nkv", "qpk", "d",
                                               "page"))
    S, nh = VERIFY["s"], SHAPE["nkv"] * SHAPE["qpk"]
    c, hist, layers = timed_verify_case(quant, shape)
    fold = attention.fold_rows
    fq = c["qv"].reshape(b * S, nh, d)
    fpt, fhl = fold(c["pt"], S), fold(c["hl"], S)
    turn = itertools.cycle(layers)
    kernel_ms = graph_ms(lambda: attention.KERNEL(
        fq, c["kc"], c["vc"], next(turn), fpt, fhl, qpk))
    wrapper = verify_caller(attention.paged_verify_attention, c, layers)
    ms = graph_ms(wrapper)
    eager, host = eager_ms(wrapper)
    plain_ms = graph_ms(verify_caller(model.paged_verify_attention_plain, c,
                                      layers))
    got = attention.paged_verify_attention(*verify_args(c, 1))
    want = model.paged_verify_attention_plain(*verify_args(c, 1))
    live = c["hl"] > 0
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               **OUTPUT_TOL)
    max_err = float((got[live].float() - want[live].float()).abs().max())
    rows = live.nonzero().flatten()
    span = -(-max(hist) // page)
    pt = c["pt"][rows, :span].long()
    k = gather_pages_folded(c["kc"], 1, pt).transpose(0, 1).contiguous()
    v = gather_pages_folded(c["vc"], 1, pt).transpose(0, 1).contiguous()
    q = c["qv"][rows].transpose(1, 2).contiguous()
    mask = (torch.arange(span * page, device=q.device)[None, :]
            < c["hl"][rows, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_ms = graph_ms(lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True))
    bytes_s = attention.hist_flash_bytes(fhl, nh, c["kc"])
    bytes_once = attention.hist_flash_bytes(c["hl"], nh * S, c["kc"])
    flops = 4 * sum(hist) * nh * S * d
    bound_bytes = bytes_once / H100_BYTES_PER_S * 1e3
    bound_ops = flops / H100_BF16_FLOPS * 1e3
    name = "paged_attention_hist_int8" if quant else "paged_attention_hist"
    out = {"shape": f"B={b} S={S} W={VERIFY['w']} wlen={VERIFY['wlen']} "
                    f"Nkv={nkv} qpk={qpk} D={d} page={page} "
                    f"maxp={SHAPE['maxp']} "
                    f"hist={hist if shape != 'uniform' else 2048}",
           "kernel_launch_ms": kernel_ms, "ms": ms, "eager_ms": eager,
           "host_ms": host, "plain_ms": plain_ms,
           "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
           "bytes_s_reads": bytes_s, "bytes_once": bytes_once,
           "flops": flops, "max_abs_err": max_err,
           ("library_ms" if not quant else "sdpa_bf16_ms"): sdpa_ms}
    if quant:
        out["library_ms"] = None
    log(json.dumps({"timing": f"{name} verify route", **out}))
    return out


def log_build(attention) -> None:
    """Registers, spills and dynamic shared memory of every kernel, from
    ptxas's report of this build and the library."""
    import re
    name, spills = None, None
    for line in attention.KERNEL.build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"hist_flash_partialILi(\d+)ELb(\d)", m.group(1))
            name = "hist_flash_combine: no dynamic shared memory"
            if k:
                d, quant = int(k.group(1)), k.group(2) == "1"
                name = (f"hist_flash_partial<D={d}, "
                        f"{'int8' if quant else 'bf16'}>: "
                        f"{attention.KERNEL.smem_bytes(d, quant)} bytes of "
                        f"dynamic shared memory")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            log(f"  ptxas {name}, {m.group(1)} registers, {spills} bytes "
                f"of spill stores")
            name = None


# ---------------------------------------------------------------------------
# Phase 3: main path
# ---------------------------------------------------------------------------

def teacher_forced_check(runner, window, prompt, generated, attention, model,
                         quant: bool) -> tuple[float, list]:
    """Prefill ``prompt`` into a private pool (bf16, or int8 with
    ``quant``), then run one window of teacher-forced decode steps over
    ``generated`` twice on the same inputs: through the kernel wrapper and
    through the plain gather. Returns the largest absolute logit
    difference and the kernel path's logits of each step."""
    from dynamo_tpu_torch.engine.kv_quant import QuantKV

    spec, cfg, dev = runner.spec, runner.config, runner.device
    page, M = cfg.page_size, window
    n = len(prompt)
    bucket = cfg.bucket_for(n)
    pages = bucket // page + -(-M // page) + 1
    shape = (spec.num_layers, spec.num_kv_heads, pages + 1, page,
             spec.head_dim)

    def pool():
        if quant:
            return QuantKV(torch.zeros(shape, dtype=torch.int8, device=dev),
                           torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev))
        return torch.zeros(shape, dtype=torch.bfloat16, device=dev)

    kc, vc = pool(), pool()
    table = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)[None]
    tok = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    tok[0, :n] = torch.tensor(prompt, dtype=torch.int32)
    pos = torch.clamp(torch.arange(bucket, device=dev), max=n - 1)[None]
    model.prefill_forward(runner.params, spec, kc, vc, tok,
                          pos.to(torch.int32), table[:, :bucket // page],
                          torch.tensor([n], dtype=torch.int32, device=dev))
    hist = torch.tensor([n], dtype=torch.int32, device=dev)
    kbuf = torch.zeros((spec.num_layers, spec.num_kv_heads, 1, M,
                        spec.head_dim), dtype=kc.dtype, device=dev)
    vbuf = torch.zeros_like(kbuf)
    worst, logits = 0.0, []
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
        logits.append(lk[0])
    return worst, logits


def main_path(attention, model, quant_kv: str | None) -> dict:
    """Serve the 8 requests at full width from a bf16 pool, or from an int8
    pool with ``quant_kv="int8"``; the engine is stopped and released
    before this returns."""
    from dynamo_tpu_torch import launch
    from dynamo_tpu_torch.profile_decode import MAX_PREFILL_TOKENS, MODEL

    argv = ["out=gpu", "--model", MODEL, "--seed", "0"]
    if quant_kv:
        argv += ["--quant-kv", quant_kv]
    kind = quant_kv or "bf16"
    t0 = time.monotonic()
    engine = launch.build_engine(launch.parse_args(argv),
                                 max_prefill_tokens=MAX_PREFILL_TOKENS)
    setup_s = time.monotonic() - t0
    runner = engine.runner
    spec = runner.spec
    pool_bytes = runner.k_cache.nbytes + runner.v_cache.nbytes
    assert runner.kv_pool_bytes == pool_bytes, (runner.kv_pool_bytes,
                                                pool_bytes)
    if quant_kv:
        assert runner.k_cache.data.dtype == torch.int8
        assert runner.kv_pool_bytes == sum(
            t.nbytes for c in (runner.k_cache, runner.v_cache)
            for t in (c.data, c.scale))
    log(f"engine ({kind} pool): {spec.name} layers={spec.num_layers} "
        f"hidden={spec.hidden_size} pages={runner.num_pages} "
        f"pool={runner.kv_pool_bytes / 2**30:.2f} GiB "
        f"params={runner.param_bytes / 2**30:.1f} GiB "
        f"window={engine.decode_window} setup={setup_s:.1f}s")
    prompts = round1_prompts(spec)
    try:
        results, stats = round1(engine, attention, prompts)
        stats = {"pool": kind, **stats}
        log(json.dumps({"main_path": stats}))
        round2 = second_round(engine, attention, prompts)
    finally:
        engine.stop()
    round2.update(round2_plain_checks(engine, model, round2,
                                      quant=bool(quant_kv)))
    round2.update(time_windows(engine))
    round2["decode_step_device_ms"] = decode_step_device_ms(engine)
    win_ms = round2["window_ms_without_logprobs"]
    log(f"decode window alone: {win_ms:.2f} ms a window, "
        f"{win_ms / engine.decode_window:.2f} ms a step, against "
        f"{round2['decode_step_device_ms']:.2f} device ms a step")
    round2["replay_vs_eager_max_abs_logprob_diff"] = replay_check(engine)
    round2["window_programs"] = graph_stats(engine, f"{kind} pool")
    log(json.dumps({"round2": {k: v for k, v in round2.items()
                               if not k.startswith("_")}}))
    stats["round2"] = {k: v for k, v in round2.items()
                       if not k.startswith("_")}
    tf = dict(runner=runner, window=engine.decode_window, prompt=prompts[0],
              generated=results[0]["tokens"], attention=attention,
              model=model)
    worst, logits = teacher_forced_check(quant=bool(quant_kv), **tf)
    log(f"teacher-forced logits on the {kind} pool, kernel vs plain path: "
        f"max|diff|={worst:.4f} (tolerance {LOGIT_ATOL})")
    stats["teacher_forced_max_abs_diff"] = worst
    # Phase 8's reference (and with the bf16 pool phase 7's): the seed-0
    # preset's round 1, its long prompt of round 2 and their tokens, and the
    # teacher-forced logits.
    stats["_round1"] = {"prompts": prompts,
                        "tokens": [r["tokens"] for r in results],
                        "ttft_s": [r["ttft_s"] for r in results],
                        "long_prompt": round2["_prompts"][-1],
                        "long_tokens": round2["_results"][-1]["tokens"],
                        "tf_logits": [lg.cpu() for lg in logits]}
    if quant_kv:
        _, ref = teacher_forced_check(quant=False, **tf)
        cos = min_cosine(logits, ref)
        log(f"teacher-forced logits, int8 pool vs bf16 pool: min cosine "
            f"{cos:.6f} over {len(ref)} steps (gate > {MIN_COSINE})")
        assert cos > MIN_COSINE, cos
        stats["int8_vs_bf16_min_cosine"] = cos
    # Release the engine's weights and pool before the next phase.
    del engine, runner, tf, logits, round2
    gc.collect()
    torch.cuda.empty_cache()
    log(f"released: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
        f"allocated")
    return stats


def round1_prompts(spec) -> list[list[int]]:
    from dynamo_tpu_torch.profile_decode import PROMPT_LENS
    rng = np.random.default_rng(0)
    return [rng.integers(0, spec.vocab_size, size=n).tolist()
            for n in PROMPT_LENS]


def round1(engine, attention, prompts) -> tuple[list, dict]:
    """Serve round 1 (the 8 requests: 6 greedy, one top-p, one seeded) on
    ``engine`` and check it: every request finishes at MAX_TOKENS with ids
    in the vocab, and every decode step of every layer launched the
    paged-attention entry of the engine's pool and never the other.
    Returns the results and the round's numbers."""
    from dynamo_tpu_torch.profile_decode import MAX_TOKENS, serve
    runner = engine.runner
    spec = runner.spec
    sampling = [{}] * 6 + [{"temperature": 0.8, "top_p": 0.9},
                           {"temperature": 0.8, "seed": 1234}]
    requests = [{"model": spec.name, "token_ids": p,
                 "stop_conditions": {"max_tokens": MAX_TOKENS},
                 "sampling_options": s} for p, s in zip(prompts, sampling)]
    attention.KERNEL.launches = 0
    attention.KERNEL.launches_int8 = 0
    windows0 = engine.windows_dispatched
    replays0 = engine.runner.window_replays
    seconds0 = len(engine.window_seconds)
    t0 = time.monotonic()
    results = asyncio.run(serve(engine, requests))
    wall = time.monotonic() - t0
    launches = {"paged_attention_hist": attention.KERNEL.launches,
                "paged_attention_hist_int8": attention.KERNEL.launches_int8}
    windows = engine.windows_dispatched - windows0
    check_replays(engine, replays0, windows)
    for i, r in enumerate(results):
        assert r["finish"] == "length", (i, r["finish"])
        assert len(r["tokens"]) == MAX_TOKENS, (i, len(r["tokens"]))
        assert all(0 <= t < spec.vocab_size for t in r["tokens"])
    expected = windows * engine.decode_window * spec.num_layers
    ran, idle = (("paged_attention_hist_int8", "paged_attention_hist")
                 if runner.quant_kv == "int8" else
                 ("paged_attention_hist", "paged_attention_hist_int8"))
    assert launches[ran] == expected and expected > 0, (launches, expected)
    assert launches[idle] == 0, launches
    win_ms = sorted(s * 1e3 for s in list(engine.window_seconds)[seconds0:])
    ttft = sorted(r["ttft_s"] * 1e3 for r in results)
    n_tok = sum(len(r["tokens"]) for r in results)
    return results, {
        "pages": runner.num_pages, "pool_gib": runner.kv_pool_bytes / 2**30,
        "requests": len(results), "tokens": n_tok, "wall_s": wall,
        "tok_per_s": n_tok / wall, "ttft_ms_median": ttft[len(ttft) // 2],
        "ttft_ms_max": ttft[-1], "windows": windows,
        "window_steps": engine.decode_window,
        "window_ms_median": win_ms[len(win_ms) // 2],
        "window_ms_max": win_ms[-1], "kernel_launches": launches[ran],
        "launches": launches}


def min_cosine(logits, ref) -> float:
    return min(float(torch.nn.functional.cosine_similarity(
        a.float().cpu(), b.float().cpu(), dim=0)) for a, b in zip(logits, ref))


def second_round(engine, attention, round1_prompts) -> dict:
    """Serve the second round on ``engine`` (which served round 1): four
    greedy requests opening with 1024 tokens of round 1's request
    SHARED_FROM (its pages stay registered under their block hashes after
    it finishes) and 200 of their own, a
    penalised greedy request with logprobs, a seeded sampled one with
    logprobs, and a 6000-token greedy prompt submitted last, whose three
    chunks interleave with the others' decode windows. Checks what the
    engine counted; returns the round's numbers and, under keys that
    start with "_", what the plain-path checks need."""
    from dynamo_tpu_torch.llm.tokens import compute_block_hashes
    from dynamo_tpu_torch.profile_decode import (
        LOGPROBS, MAX_PREFILL_TOKENS, ROUND2_MAX_TOKENS, SHARED_FROM,
        SHARED_TOKENS, round2_requests, serve)
    runner, spec = engine.runner, engine.runner.spec
    requests = round2_requests(spec, round1_prompts[SHARED_FROM],
                               np.random.default_rng(1))
    prompts = [r["token_ids"] for r in requests]
    # The first-token logits of every prefill row over history.
    captured = []
    plain_batch = runner.prefill_batch

    def capture(seqs, slots=None, count_rows=None):
        out = plain_batch(seqs, slots=slots, count_rows=count_rows)
        for i, seq in enumerate(seqs):
            if seq.start_pos:
                captured.append((seq.start_pos, seq.tokens.tolist(),
                                 runner.last_prefill_logits[i].clone()))
        return out

    hits0, lookups0 = engine.prefix_hit_blocks, engine.prefix_lookup_blocks
    windows0, chunks0 = engine.windows_dispatched, len(engine.chunk_records)
    replays0 = engine.runner.window_replays
    runner.prefill_batch = capture
    attention.KERNEL.launches = 0
    attention.KERNEL.launches_int8 = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.monotonic()
        results = asyncio.run(serve(engine, requests))
        wall = time.monotonic() - t0
        torch.cuda.synchronize()
        launches = {"paged_attention_hist": attention.KERNEL.launches,
                    "paged_attention_hist_int8":
                        attention.KERNEL.launches_int8}
    finally:
        del runner.prefill_batch
    peak = torch.cuda.max_memory_allocated()
    windows = engine.windows_dispatched - windows0
    check_replays(engine, replays0, windows)
    for i, r in enumerate(results):
        assert r["finish"] == "length", (i, r["finish"])
        assert len(r["tokens"]) == ROUND2_MAX_TOKENS, (i, len(r["tokens"]))
    hits = engine.prefix_hit_blocks - hits0
    lookups = engine.prefix_lookup_blocks - lookups0
    assert hits >= 4 * SHARED_TOKENS // engine.config.page_size, hits
    chunks = list(engine.chunk_records)[chunks0:]
    assert [c["start"] for c in chunks] == [0, MAX_PREFILL_TOKENS,
                                            2 * MAX_PREFILL_TOKENS], chunks
    assert chunks[-1]["final"] and not chunks[0]["final"], chunks
    assert chunks[-1]["windows_before"] > chunks[0]["windows_before"], (
        "no decode window ran between the long prompt's chunks", chunks)
    ran, idle = (("paged_attention_hist_int8", "paged_attention_hist")
                 if runner.quant_kv == "int8" else
                 ("paged_attention_hist", "paged_attention_hist_int8"))
    expected = windows * engine.decode_window * spec.num_layers
    assert launches[ran] == expected and expected > 0, (launches, expected)
    assert launches[idle] == 0, launches
    for r in results[4:6]:
        assert len(r["log_probs"]) == len(r["top_log_probs"]) == \
            ROUND2_MAX_TOKENS
        assert all(len(t) == LOGPROBS for t in r["top_log_probs"])
        assert all(np.isfinite(r["log_probs"]))
    t0 = time.perf_counter()
    for _ in range(3):
        compute_block_hashes(prompts[-1], engine.config.page_size)
    hash_ms = (time.perf_counter() - t0) / 3 / len(prompts[-1]) * 1e3 * 1e3
    ttft = sorted(r["ttft_s"] * 1e3 for r in results)
    n_tok = sum(len(r["tokens"]) for r in results)
    out = {"requests": len(results), "tokens": n_tok, "wall_s": wall,
           "tok_per_s": n_tok / wall, "ttft_ms_median": ttft[len(ttft) // 2],
           "ttft_ms_max": ttft[-1],
           "long_prompt_ttft_ms": results[-1]["ttft_s"] * 1e3,
           "prefix_hit_blocks": hits, "prefix_lookup_blocks": lookups,
           "prefix_hit_ratio": hits / lookups,
           "chunks": len(chunks),
           "chunk_device_ms": [c["device_ms"] for c in chunks],
           "chunk_windows_before": [c["windows_before"] - windows0
                                    for c in chunks],
           "peak_memory_gib": peak / 2**30,
           "hash_ms_per_1000_tokens": hash_ms, "windows": windows,
           "kernel_launches": launches[ran], "launches": launches,
           "_prompts": prompts, "_results": results, "_captured": captured}
    return out


def plain_forced_logits(runner, model, prompt, tokens, quant: bool,
                        slot: int | None = None):
    """The plain path's logits behind each of ``tokens``: the first from a
    whole-prompt prefill of ``prompt`` into a private pool (int8 with
    ``quant``), the others from teacher-forced decode steps fed
    ``tokens[:-1]`` with the plain gather attention; with ``slot``, through
    the runner's LoRA stacks at that slot (eager, no graph)."""
    from dynamo_tpu_torch.engine.kv_quant import QuantKV
    spec, cfg, dev = runner.spec, runner.config, runner.device
    page, n = cfg.page_size, len(prompt)
    bucket = cfg.bucket_for(n)
    steps = len(tokens) - 1
    pages = bucket // page + -(-steps // page) + 1
    shape = (spec.num_layers, spec.num_kv_heads, pages + 1, page,
             spec.head_dim)

    def pool():
        if quant:
            return QuantKV(torch.zeros(shape, dtype=torch.int8, device=dev),
                           torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev))
        return torch.zeros(shape, dtype=torch.bfloat16, device=dev)

    kc, vc = pool(), pool()
    table = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)[None]
    tok = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    tok[0, :n] = torch.tensor(prompt, dtype=torch.int32)
    pos = torch.clamp(torch.arange(bucket, device=dev), max=n - 1)[None]
    lora = {}
    if slot is not None:
        lora = dict(lora=runner.lora, adapter_ids=torch.tensor(
            [slot], dtype=torch.int32, device=dev))
    first, _, _ = model.prefill_forward(
        runner.params, spec, kc, vc, tok, pos.to(torch.int32),
        table[:, :bucket // page],
        torch.tensor([n], dtype=torch.int32, device=dev), **lora)
    out = [first[0]]
    if steps:
        hist = torch.tensor([n], dtype=torch.int32, device=dev)
        kbuf = torch.zeros((spec.num_layers, spec.num_kv_heads, 1, steps,
                            spec.head_dim), dtype=torch.bfloat16, device=dev)
        vbuf = torch.zeros_like(kbuf)
    for m in range(steps):
        logits, k_new, v_new = model.decode_window_step(
            runner.params, spec, kc, vc, kbuf, vbuf, m,
            torch.tensor([tokens[m]], dtype=torch.int32, device=dev),
            torch.tensor([n + m], dtype=torch.int32, device=dev), table,
            hist, **lora)
        kbuf[:, :, :, m] = k_new.transpose(1, 2)
        vbuf[:, :, :, m] = v_new.transpose(1, 2)
        out.append(logits[0])
    return out


def round2_plain_checks(engine, model, round2, quant: bool) -> dict:
    """Hold the second round against the plain path on the card:
    the first-token logits of a prefix-hit request and of the long prompt
    (history prefill, chunks for the long one) against the same prompts
    prefilled whole; the penalised request's tokens against a
    teacher-forced plain path with the same penalties, at clear margins
    (two logits within LOGIT_ATOL can swap only within 2 x LOGIT_ATOL),
    and its logprobs against that path's log_softmax."""
    from dynamo_tpu_torch.profile_decode import (
        LOGPROBS, MAX_PREFILL_TOKENS, PENALTIES, SHARED_TOKENS)
    runner = engine.runner
    prompts, results = round2["_prompts"], round2["_results"]
    out = {}
    for name, start, prompt in (
            ("prefix_hit", SHARED_TOKENS, prompts[0]),
            ("long_prompt", 2 * MAX_PREFILL_TOKENS, prompts[-1])):
        got = [lg for s, toks, lg in round2["_captured"]
               if s == start and toks == prompt[start:]]
        assert len(got) == 1, (name, len(got))
        want = plain_forced_logits(runner, model, prompt, [0], quant)[0]
        diff = float((got[0] - want).abs().max())
        assert torch.isfinite(got[0]).all(), name
        log(f"{name}: first-token logits over history vs whole-prompt "
            f"plain prefill: max|diff|={diff:.4f} (tolerance {LOGIT_ATOL})")
        assert diff <= LOGIT_ATOL, (name, diff)
        out[f"{name}_logit_max_abs_diff"] = diff
    pen = results[4]
    logits = plain_forced_logits(runner, model, prompts[4], pen["tokens"],
                                 quant)
    counts = torch.zeros_like(logits[0])
    agree, lp_diff = 0, 0.0
    for i, (tok, lg) in enumerate(zip(pen["tokens"], logits)):
        lg = (lg - PENALTIES["frequency_penalty"] * counts
              - PENALTIES["presence_penalty"] * (counts > 0))
        top2 = torch.topk(lg, 2).values
        if int(lg.argmax()) == tok:
            agree += 1
        else:
            margin = float(top2[0] - top2[1])
            assert margin <= 2 * LOGIT_ATOL, (
                f"penalised token {i}: {tok} != plain argmax at margin "
                f"{margin}")
        lsm = torch.log_softmax(lg, dim=-1)
        top_v = torch.topk(lsm, LOGPROBS).values.cpu().numpy()
        emitted = [x["logprob"] for x in pen["top_log_probs"][i]]
        lp_diff = max(lp_diff, abs(pen["log_probs"][i] - float(lsm[tok])),
                      float(np.abs(np.asarray(emitted) - top_v).max()))
        counts[tok] += 1
    log(f"penalised request: {agree}/{len(logits)} tokens are the plain "
        f"path's argmax; logprobs and top-{LOGPROBS} within "
        f"{lp_diff:.4f} of its log_softmax (tolerance {LOGIT_ATOL})")
    assert lp_diff <= LOGIT_ATOL, lp_diff
    out.update(penalised_tokens_agree=agree, logprob_max_abs_diff=lp_diff)
    return out


def alone_window(engine, rows: int, hist: int):
    """(packed control array, pages) of one decode window run alone on the
    stopped engine's runner over ``rows`` live greedy rows of ``hist``
    tokens in fresh pages; the caller releases the pages."""
    from dynamo_tpu_torch.engine import runner as trunner
    runner, cfg = engine.runner, engine.config
    page, M = cfg.page_size, engine.decode_window
    per_row = -(-(hist + M) // page)
    pages = engine.allocator.allocate(rows * per_row)
    width = runner.bucket_pages_for(per_row)
    packed = np.zeros((cfg.max_num_seqs, trunner.PK_PREFIX + width),
                      np.int32)
    for i in range(rows):
        packed[i, trunner.PK_OVERRIDE] = 1
        packed[i, trunner.PK_POS] = hist
        packed[i, trunner.PK_SEQLEN] = hist + 1
        packed[i, trunner.PK_TOPP] = np.float32(1.0).view(np.int32)
        packed[i, trunner.PK_CAP] = per_row * page
        packed[i, trunner.PK_PREFIX:trunner.PK_PREFIX + per_row] = \
            pages[i * per_row:(i + 1) * per_row]
    return packed, pages


def time_windows(engine, rows: int = 8, hist: int = 1224,
                 reps: int = 3) -> dict:
    """Device-synchronised ms of one decode window, run alone on the
    stopped engine's runner over ``rows`` live rows of ``hist`` tokens in
    fresh pages, with and without one row asking for logprobs (in turns:
    without, with, with, without)."""
    from dynamo_tpu_torch.engine import runner as trunner
    runner, M = engine.runner, engine.decode_window
    packed, pages = alone_window(engine, rows, hist)
    times = {False: [], True: []}
    try:
        for want_lp in (False, True) + (False, True, True, False) * reps:
            packed[0, trunner.PK_LOGPROB] = int(want_lp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.decode_window(packed, M)
            torch.cuda.synchronize()
            times[want_lp].append((time.perf_counter() - t0) * 1e3)
    finally:
        engine.allocator.release(pages)
    plain, with_lp = (sorted(times[k][1:]) for k in (False, True))
    log(f"decode window alone ({rows} rows x {hist} tokens, M={M}): "
        f"{plain[len(plain) // 2]:.2f} ms without logprobs, "
        f"{with_lp[len(with_lp) // 2]:.2f} ms with one logprobs row")
    return {"window_ms_without_logprobs": plain[len(plain) // 2],
            "window_ms_with_logprobs": with_lp[len(with_lp) // 2],
            "window_ms_samples": {"without_logprobs": times[False],
                                  "with_logprobs": times[True]}}


def check_replays(engine, replays0: int, windows: int) -> None:
    """Every window ``engine`` dispatched since its runner had replayed
    ``replays0`` windows was a CUDA-graph replay: the card has no eager
    window path, so a window that did not replay did not run."""
    replays = engine.runner.window_replays - replays0
    assert replays == windows, (f"{windows} windows dispatched, {replays} "
                                f"replayed")


def graph_stats(engine, label: str) -> dict:
    """The engine's window programs: made, captured, their capture
    seconds, the warmup's seconds (0 without warmup_windows) and the graph
    pool's bytes; logged."""
    stats = dict(engine.runner.window_programs(),
                 warmup_s=engine.warmup_seconds)
    log(f"window programs ({label}): {stats['programs']} made, "
        f"{stats['captured']} captured in {stats['capture_s']:.2f} s; "
        f"warmup {stats['warmup_s']:.2f} s; graph pool "
        f"{stats['graph_pool_bytes']} bytes "
        f"({stats['graph_pool_bytes'] / 2**20:.1f} MiB)")
    return stats


def replay_check(engine, adapter_ids=None) -> float:
    """One window run alone on the stopped engine (alone_window, one row
    asking for logprobs; with ``adapter_ids``, the 8 rows on those LoRA
    slots), replayed from its program's graph and then run through the
    same program's body eagerly on the same packed state (tokens_dev and
    the noise step put back between the two): greedy tokens equal, and
    the chosen and top-5 logprobs within 1e-5 (the same kernels in the
    same order: 0 is expected). Returns the largest logprob
    difference."""
    from dynamo_tpu_torch.engine import runner as trunner
    runner, M = engine.runner, engine.decode_window
    packed, pages = alone_window(engine, 8, 1224)
    packed[1, trunner.PK_LOGPROB] = 1
    if adapter_ids is not None:
        packed[:8, trunner.PK_ADAPTER] = adapter_ids
    key = (M, packed.shape[1] - trunner.PK_PREFIX, False, False, True)
    try:
        tokens = runner.tokens_dev.clone()
        step = runner._noise_step.clone()
        replays0 = runner.window_replays
        replayed = [t.clone() for t in runner.decode_window(packed, M)]
        assert runner.window_replays == replays0 + 1
        runner.tokens_dev.copy_(tokens)
        runner._noise_step.copy_(step)
        eager = runner._window_cache[key].run_eager(packed)
        torch.cuda.synchronize()
    finally:
        engine.allocator.release(pages)
    assert torch.equal(replayed[0], eager[0]), "replay and eager tokens"
    assert torch.equal(replayed[3][..., :5], eager[3][..., :5])
    diff = max(float((replayed[1] - eager[1]).abs().max()),
               float((replayed[2][..., :5] - eager[2][..., :5]).abs().max()))
    log(f"replayed window vs its eager body ({runner.quant_kv or 'bf16'} "
        f"pool, key {key}): tokens equal, max|logprob diff| {diff} "
        f"(tolerance 1e-5)")
    assert diff <= 1e-5, diff
    return diff


def noise_check(vocab: int) -> None:
    """sampler.gumbel_field on the card equals the CPU's bits for seeded
    keys (request seeds at token positions) and unseeded ones (a runner's
    keys at noise steps) over ``vocab`` tokens, and gumbel_of_bits maps
    every one of the 2^24 uniforms to the same fp32 value on both."""
    from dynamo_tpu_torch.engine import sampler
    keys = torch.tensor([0, 1, 1234, 4321, 2**31 - 1, 2**32, 2**32 + 31,
                         2**33 + 7], dtype=torch.int64)
    counters = torch.tensor([0, 1, 1200, 6033, 2**31 - 1, 0, 5, 987654],
                            dtype=torch.int64)
    cpu = sampler.gumbel_field(keys, counters, vocab)
    card = sampler.gumbel_field(keys.cuda(), counters.cuda(), vocab).cpu()
    assert torch.equal(cpu.view(torch.int32), card.view(torch.int32))
    bits = torch.arange(1 << sampler.UNIFORM_BITS, dtype=torch.int64)
    cpu = sampler.gumbel_of_bits(bits)
    card = sampler.gumbel_of_bits(bits.cuda()).cpu()
    assert torch.equal(cpu.view(torch.int32), card.view(torch.int32))
    log(f"gumbel_field: card == CPU bit for bit over {len(keys)} keys x "
        f"{vocab} tokens and all {len(bits)} uniforms")


# ---------------------------------------------------------------------------
# Phase 5: the OpenAI front at full width
# ---------------------------------------------------------------------------

HTTP_MAX_TOKENS = 32
# Words of the test tokenizer's corpus: about one token per word.
WORDS = ("hello world this is a test of the tpu native serving framework "
         "the quick brown fox jumps over lazy dog def main return for in "
         "range").split()
# Words per prompt of the six concurrent chats: 200-1500 tokens rendered.
CHAT_WORDS = (155, 400, 640, 880, 1110, 1330)
SSE_TIMEOUT_S = 600


def chat_body(model: str, rng, n_words: int) -> dict:
    text = " ".join(rng.choice(WORDS, size=n_words))
    return {"model": model, "stream": True, "ignore_eos": True,
            "max_tokens": HTTP_MAX_TOKENS,
            "stream_options": {"include_usage": True},
            "messages": [{"role": "system", "content": "you are a test"},
                         {"role": "user", "content": text}]}


def http_call(port: int, method: str, path: str, body=None) -> dict:
    """One request over http.client. A streamed answer is read line by
    line: its SSE framing is checked (``data: `` events, each followed by
    a blank line, ``data: [DONE]`` last) and each event's arrival time
    kept. Returns status, content type, and the JSON body or the events
    with their seconds since the request was sent."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=SSE_TIMEOUT_S)
    try:
        t0 = time.perf_counter()
        payload = body if isinstance(body, (bytes, type(None))) \
            else json.dumps(body).encode()
        conn.request(method, path, body=payload,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = {"status": resp.status,
               "content_type": resp.getheader("Content-Type")}
        if out["content_type"] != "text/event-stream":
            out["json"] = json.loads(resp.read())
            return out
        events, times, done = [], [], False
        while True:
            line = resp.readline()
            if not line:
                break
            assert not done, f"data after [DONE]: {line!r}"
            assert line.startswith(b"data: ") and line.endswith(b"\n"), line
            assert resp.readline() == b"\n", "an event lacks its blank line"
            data = line[len(b"data: "):-1]
            if data == b"[DONE]":
                done = True
                continue
            events.append(json.loads(data))
            times.append(time.perf_counter() - t0)
        assert done, "the stream did not end in data: [DONE]"
        out.update(events=events, times=times)
        return out
    finally:
        conn.close()


def stream_summary(res: dict) -> dict:
    """Finish reason, usage, text, logprob entries, TTFT, the median gap
    between chunks that carry choices, and the mean time per output token
    after the first (TPOT), of a streamed chat or completion. A chunk
    carries one engine output (a decode window's tokens) only when it has
    text, logprobs or a finish reason: ids outside the test tokenizer's
    vocab decode to no text, so most windows of a plain chat send no
    chunk and the gap median reads whole stretches of windows; TPOT does
    not depend on which windows sent one."""
    finish, usage, text, lps, token_times = None, None, [], [], []
    for event, t in zip(res["events"], res["times"]):
        if event.get("usage"):
            usage = event["usage"]
        for choice in event["choices"]:
            token_times.append(t)
            finish = choice.get("finish_reason") or finish
            text.append(choice.get("text")
                        or choice.get("delta", {}).get("content") or "")
            if choice.get("logprobs"):
                lps.extend(choice["logprobs"].get("content") or [])
    gaps = sorted(b - a for a, b in zip(token_times, token_times[1:]))
    n = usage["completion_tokens"] if usage else 0
    return {"finish": finish, "usage": usage, "text": "".join(text),
            "logprobs": lps, "ttft_ms": token_times[0] * 1e3,
            "chunks": len(token_times),
            "itl_ms_median": gaps[len(gaps) // 2] * 1e3 if gaps else None,
            "tpot_ms": ((token_times[-1] - token_times[0]) / (n - 1) * 1e3
                        if n > 1 else None)}


def forget_prompt(engine, token_ids) -> None:
    """Drop the prefix-cache registrations of ``token_ids``' blocks once the
    engine holds no page, so the next request with them prefills whole
    (a prefix hit computes the tail over history, whose logits differ in
    their low bits and can flip a greedy near-tie)."""
    from dynamo_tpu_torch.llm.tokens import compute_block_hashes
    deadline = time.monotonic() + 60
    while engine.allocator.num_active and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not engine.allocator.num_active, "the engine still holds pages"
    engine.allocator.unregister(engine.allocator.lookup(
        compute_block_hashes(token_ids, engine.config.page_size)))


def http_phase(attention) -> dict:
    """Build the OpenAI front for llama-3-8b (bf16 pool, seed 0) through
    ``launch.start_http``, the function ``python -m dynamo_tpu_torch.launch
    in=http`` runs, on 127.0.0.1 port 0 in this process; drive it with
    http.client and check every answer; the engine is released before this
    returns."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch import launch
    from dynamo_tpu_torch.llm import chat_template
    from dynamo_tpu_torch.llm.protocols import ChatCompletionRequest
    from dynamo_tpu_torch.profile_decode import MODEL, serve

    args = launch.parse_args(["in=http", "out=gpu", "--model", MODEL,
                              "--seed", "0", "--http-port", "0"])
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def on_loop(coro, timeout):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    t0 = time.monotonic()
    service, engine = on_loop(launch.start_http(args), 900)
    setup_s = time.monotonic() - t0
    try:
        port, spec = service.port, engine.runner.spec
        pre = service.manager.get(MODEL).preprocessor
        tok = pre.tokenizer
        log(f"front: {MODEL} at 127.0.0.1:{port}, engine "
            f"{spec.num_layers} layers, pages={engine.runner.num_pages} "
            f"window={engine.decode_window} setup={setup_s:.1f}s")
        rng = np.random.default_rng(5)
        chats = [chat_body(MODEL, rng, n) for n in CHAT_WORDS]
        chats[4].update(temperature=0.8, top_p=0.9, seed=77)
        chats[5].update(logprobs=True, top_logprobs=3)
        prompt_ids = [rng.integers(0, spec.vocab_size, 1024).tolist()]
        comp = {"model": MODEL, "prompt": prompt_ids[0], "stream": True,
                "ignore_eos": True, "max_tokens": HTTP_MAX_TOKENS,
                "stream_options": {"include_usage": True}}
        alone = chat_body(MODEL, rng, 300)
        alone_ids = pre.preprocess_chat(
            ChatCompletionRequest.model_validate(alone)).token_ids
        rendered = [tok.encode(chat_template.render(c["messages"], True))
                    for c in chats]

        # The engine boundary: the six chats' token ids through
        # engine.generate (after a short warm-up request), then the alone
        # chat's, for the front's own cost beside them; their blocks then
        # leave the prefix cache so the HTTP requests prefill them cold too.
        wires = [pre.preprocess_chat(ChatCompletionRequest.model_validate(
            c)).to_wire() for c in chats]
        asyncio.run(serve(engine, [{"model": MODEL, "token_ids": [1] * 16,
                                    "stop_conditions": {"max_tokens": 4}}]))
        engine_side = asyncio.run(serve(engine, wires))
        for ids in rendered:
            forget_prompt(engine, ids)
        alone_engine = asyncio.run(serve(engine, [pre.preprocess_chat(
            ChatCompletionRequest.model_validate(alone)).to_wire()]))[0]
        forget_prompt(engine, alone_ids)
        log(json.dumps({"engine_boundary_ttft_ms": [
            r["ttft_s"] * 1e3 for r in engine_side],
            "engine_boundary_alone_ttft_ms": alone_engine["ttft_s"] * 1e3}))

        attention.KERNEL.launches = 0
        attention.KERNEL.launches_int8 = 0
        windows0 = engine.windows_dispatched
        replays0 = engine.runner.window_replays
        for path in ("/v1/models", "/health"):
            res = http_call(port, "GET", path)
            assert res["status"] == 200, res
        assert [m["id"] for m in http_call(port, "GET", "/v1/models")[
            "json"]["data"]] == [MODEL]
        t0 = time.monotonic()
        with ThreadPoolExecutor(len(chats) + 1) as pool:
            futures = [pool.submit(http_call, port, "POST",
                                   "/v1/chat/completions", c) for c in chats]
            futures.append(pool.submit(http_call, port, "POST",
                                       "/v1/completions", comp))
            results = [f.result(SSE_TIMEOUT_S) for f in futures]
        wall = time.monotonic() - t0
        summaries = []
        for i, res in enumerate(results):
            assert res["status"] == 200, res
            s = stream_summary(res)
            summaries.append(s)
            assert s["finish"] == "length", (i, s["finish"])
            assert s["usage"]["completion_tokens"] == HTTP_MAX_TOKENS, s
            want = rendered[i] if i < len(chats) else prompt_ids[0]
            assert s["usage"]["prompt_tokens"] == len(want), (
                i, s["usage"], len(want))
        lps = summaries[5]["logprobs"]
        assert len(lps) == HTTP_MAX_TOKENS, len(lps)
        assert all(len(e["top_logprobs"]) == 3 for e in lps)
        assert all(np.isfinite(e["logprob"]) for e in lps)

        # One greedy chat alone, streamed, then alone and not streamed.
        streamed = stream_summary(http_call(
            port, "POST", "/v1/chat/completions", alone))
        forget_prompt(engine, alone_ids)
        whole = http_call(port, "POST", "/v1/chat/completions",
                          dict(alone, stream=False))
        assert whole["status"] == 200, whole
        body = whole["json"]
        assert body["choices"][0]["finish_reason"] == "length", body
        assert body["choices"][0]["message"]["content"] == streamed["text"]
        assert body["usage"] == streamed["usage"], (body["usage"],
                                                    streamed["usage"])

        bad = http_call(port, "POST", "/v1/chat/completions", b"{nope")
        missing = http_call(port, "POST", "/v1/chat/completions",
                            dict(alone, model="no-such-model"))
        for res, code, kind in ((bad, 400, "invalid_request_error"),
                                (missing, 404, "model_not_found")):
            assert res["status"] == code, res
            err = res["json"]["error"]
            assert sorted(err) == ["code", "message", "param", "type"], err
            assert err["type"] == kind and err["message"], err
        launches = {"paged_attention_hist": attention.KERNEL.launches,
                    "paged_attention_hist_int8":
                        attention.KERNEL.launches_int8}
        windows = engine.windows_dispatched - windows0
        check_replays(engine, replays0, windows)
        expected = windows * engine.decode_window * spec.num_layers
        assert launches["paged_attention_hist"] == expected > 0, (
            launches, expected)
        assert launches["paged_attention_hist_int8"] == 0, launches
        n_tok = sum(s["usage"]["completion_tokens"] for s in summaries)
        names = [f"chat{i}" for i in range(4)] + [
            "chat_sampled", "chat_logprobs", "completion_1024_ids"]
        for name, s in zip(names, summaries):
            log(json.dumps({"http_request": name,
                            "prompt_tokens": s["usage"]["prompt_tokens"],
                            "ttft_ms": s["ttft_ms"],
                            "itl_ms_median": s["itl_ms_median"],
                            "tpot_ms": s["tpot_ms"], "chunks": s["chunks"]}))
        stats = {"requests": len(summaries), "tokens": n_tok, "wall_s": wall,
                 "tok_per_s": n_tok / wall,
                 "ttft_ms": [s["ttft_ms"] for s in summaries],
                 "itl_ms_median": [s["itl_ms_median"] for s in summaries],
                 "tpot_ms": [s["tpot_ms"] for s in summaries],
                 "engine_boundary_ttft_ms": [r["ttft_s"] * 1e3
                                             for r in engine_side],
                 "alone_ttft_ms": streamed["ttft_ms"],
                 "alone_tpot_ms": streamed["tpot_ms"],
                 "engine_boundary_alone_ttft_ms":
                     alone_engine["ttft_s"] * 1e3,
                 "windows": windows, "window_steps": engine.decode_window,
                 "kernel_launches": launches["paged_attention_hist"],
                 "launches": launches}
        log(json.dumps({"http_phase": stats}))
        traffic = {"chats": chats, "comp": comp, "alone": alone,
                   "rendered": rendered, "prompt_ids": prompt_ids,
                   "alone_ids": alone_ids,
                   "alone_tokens": alone_engine["tokens"],
                   "alone_text": streamed["text"],
                   "summaries": summaries, "alone_summary": streamed,
                   "names": names}
        stats["dist"] = dist_phase(attention, engine, tok, on_loop, traffic)
        stats["window_programs"] = graph_stats(engine, "phases 5-6")
    finally:
        on_loop(service.stop(), 60)
        engine.stop()
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        loop.close()
    del engine, service, pre
    gc.collect()
    torch.cuda.empty_cache()
    log(f"released: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
        f"allocated")
    return stats


def dist_phase(attention, engine, tokenizer, on_loop, traffic) -> dict:
    """Phase 6: the distributed main path at full width, over real TCP on
    127.0.0.1 in this process, from phase 5's llama-3-8b engine. A worker
    DistributedRuntime with an embedded coordinator serves
    ``engine.handler()`` through ``backends.gpu.serve_engine`` (an
    EndpointServer plus ``register_llm``); a frontend DistributedRuntime
    runs ``launch.start_front`` (ModelWatcher + HttpService). Phase 5's
    traffic goes again, each prompt first dropped from the prefix cache:
    the six streamed chats beside the 1024-id completion, then the alone
    greedy chat, streamed. A tap on ``engine.generate`` records each
    engine output (the payload of one data frame) and the alone chat's
    token ids: the OpenAI logprobs entries carry no ids. Checks: framing
    and [DONE]; finish length and 32 completion tokens; prompt_tokens
    equal to phase 5's; the alone chat's ids equal phase 5's alone chat
    at the engine boundary (same engine, prompt, batch of one, cold
    prefix cache); /v1/models through discovery; paged_attention_hist
    launched windows x M x 32 times and the int8 entry 0 times. Prints
    each request's client TTFT and TPOT beside phase 5's, the phase's
    tok/s and the mean us of packb + unpackb over the phase's data
    frames."""
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.backends.gpu import serve_engine
    from dynamo_tpu_torch.launch import start_front
    from dynamo_tpu_torch.llm.model_card import deregister_llm
    from dynamo_tpu_torch.profile_decode import MODEL
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.msgpack_lite import packb, unpackb

    t_phase = time.monotonic()
    outputs, ids_by_prompt = [], {}
    inner = engine.generate

    async def tapped(request, context):
        ids = ids_by_prompt.setdefault(tuple(request["token_ids"]), [])
        async for item in inner(request, context):
            outputs.append(item)
            ids.extend(item.get("token_ids", []))
            yield item

    async def up():
        worker = await DistributedRuntime.with_embedded_coordinator(
            RuntimeConfig())
        server = await serve_engine(worker, engine, MODEL, tokenizer)
        front = await DistributedRuntime.from_settings(
            RuntimeConfig(coordinator_url=worker.config.coordinator_url))
        service, watcher = await start_front(front, "127.0.0.1", 0)
        deadline = time.monotonic() + 60
        while watcher.manager.get(MODEL) is None:
            assert time.monotonic() < deadline, "the model was not discovered"
            await asyncio.sleep(0.02)
        return worker, server, front, service, watcher

    async def down(worker, server, front, service, watcher):
        await service.stop()
        await watcher.stop()
        await front.close()
        await deregister_llm(worker, MODEL)
        await server.shutdown()
        await worker.close()

    chats, comp, alone = traffic["chats"], traffic["comp"], traffic["alone"]
    prompts = traffic["rendered"] + traffic["prompt_ids"]
    for ids in prompts + [traffic["alone_ids"]]:
        forget_prompt(engine, ids)
    stack = on_loop(up(), 120)
    engine.generate = tapped
    try:
        port, spec = stack[3].port, engine.runner.spec
        log(f"distributed: coordinator {stack[0].config.coordinator_url}, "
            f"worker {stack[0].instance_id:x} at "
            f"127.0.0.1:{stack[1].port}, front at 127.0.0.1:{port}")
        attention.KERNEL.launches = 0
        attention.KERNEL.launches_int8 = 0
        windows0 = engine.windows_dispatched
        replays0 = engine.runner.window_replays
        models = http_call(port, "GET", "/v1/models")
        assert models["status"] == 200, models
        assert [m["id"] for m in models["json"]["data"]] == [MODEL], models
        t0 = time.monotonic()
        with ThreadPoolExecutor(len(chats) + 1) as pool:
            futures = [pool.submit(http_call, port, "POST",
                                   "/v1/chat/completions", c) for c in chats]
            futures.append(pool.submit(http_call, port, "POST",
                                       "/v1/completions", comp))
            results = [f.result(SSE_TIMEOUT_S) for f in futures]
        wall = time.monotonic() - t0
        summaries = []
        for i, res in enumerate(results):
            assert res["status"] == 200, res
            s = stream_summary(res)
            summaries.append(s)
            assert s["finish"] == "length", (i, s["finish"])
            assert s["usage"]["completion_tokens"] == HTTP_MAX_TOKENS, s
            assert s["usage"]["prompt_tokens"] == traffic["summaries"][i][
                "usage"]["prompt_tokens"], (i, s["usage"])
        # The alone chat prefills cold, as phase 5's did at the engine
        # boundary.
        for ids in prompts:
            forget_prompt(engine, ids)
        streamed = stream_summary(http_call(
            port, "POST", "/v1/chat/completions", alone))
        assert streamed["finish"] == "length", streamed
        assert streamed["usage"] == traffic["alone_summary"]["usage"], (
            streamed["usage"], traffic["alone_summary"]["usage"])
        alone_ids = ids_by_prompt[tuple(traffic["alone_ids"])]
        assert alone_ids == traffic["alone_tokens"], (
            alone_ids, traffic["alone_tokens"])
        assert streamed["text"] == traffic["alone_text"]
        launches = {"paged_attention_hist": attention.KERNEL.launches,
                    "paged_attention_hist_int8":
                        attention.KERNEL.launches_int8}
        windows = engine.windows_dispatched - windows0
        check_replays(engine, replays0, windows)
        expected = windows * engine.decode_window * spec.num_layers
        assert launches["paged_attention_hist"] == expected > 0, (
            launches, expected)
        assert launches["paged_attention_hist_int8"] == 0, launches
    finally:
        del engine.generate
        on_loop(down(*stack), 120)
    # The codec's cost on this phase's data frames, as the endpoint server
    # builds them.
    frames = [{"t": "data", "rid": "0" * 32, "p": item, "s": i}
              for i, item in enumerate(outputs)]
    t0 = time.perf_counter()
    for frame in frames:
        unpackb(packb(frame))
    codec_us = (time.perf_counter() - t0) / len(frames) * 1e6
    n_tok = sum(s["usage"]["completion_tokens"] for s in summaries)
    for name, s, s5 in zip(traffic["names"], summaries,
                           traffic["summaries"]):
        log(json.dumps({"dist_request": name,
                        "prompt_tokens": s["usage"]["prompt_tokens"],
                        "ttft_ms": s["ttft_ms"], "tpot_ms": s["tpot_ms"],
                        "phase5_ttft_ms": s5["ttft_ms"],
                        "phase5_tpot_ms": s5["tpot_ms"]}))
    stats = {"requests": len(summaries), "tokens": n_tok, "wall_s": wall,
             "tok_per_s": n_tok / wall,
             "ttft_ms": [s["ttft_ms"] for s in summaries],
             "tpot_ms": [s["tpot_ms"] for s in summaries],
             "alone_ttft_ms": streamed["ttft_ms"],
             "alone_tpot_ms": streamed["tpot_ms"],
             "phase5_alone_ttft_ms": traffic["alone_summary"]["ttft_ms"],
             "phase5_alone_tpot_ms": traffic["alone_summary"]["tpot_ms"],
             "data_frames": len(frames),
             "frame_bytes_mean": sum(len(packb(f)) for f in frames)
             / len(frames),
             "codec_us_per_frame": codec_us,
             "windows": windows, "window_steps": engine.decode_window,
             "kernel_launches": launches["paged_attention_hist"],
             "launches": launches,
             "phase_s": time.monotonic() - t_phase}
    log(json.dumps({"dist_phase": stats}))
    return stats


def _spawn(procs: list, *argv):
    """Start ``python -m *argv`` from the checkout's root, its output
    lines collected; appends (process, line queue, lines seen) to
    ``procs`` and returns it."""
    import os
    import queue
    import subprocess
    import threading
    proc = subprocess.Popen(
        [sys.executable, "-m", *argv], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, DTPU_LOG="info"))
    lines: queue.Queue = queue.Queue()
    for pipe in (proc.stdout, proc.stderr):
        threading.Thread(target=lambda p=pipe: [lines.put(x) for x in p],
                         daemon=True).start()
    procs.append((proc, lines, []))
    return procs[-1]


def _wait_line(entry, text, timeout=300) -> str:
    """The first line of a ``_spawn`` process that holds ``text``."""
    import queue
    proc, lines, seen = entry
    t0 = time.monotonic()
    while not any(text in x for x in seen):
        try:
            seen.append(lines.get(timeout=1))
        except queue.Empty:
            assert proc.poll() is None, (proc.returncode, seen[-20:])
            assert time.monotonic() - t0 < timeout, seen[-20:]
    return next(x for x in seen if text in x).strip()


def dist_subprocesses() -> dict:
    """The distributed entry points as subprocesses on the card: ``python
    -m dynamo_tpu_torch.runtime.coordinator --port 0``, ``python -m
    dynamo_tpu_torch.backends.gpu --model tiny-test`` (it must log an
    engine on cuda, no --device given) and ``python -m
    dynamo_tpu_torch.frontend --http-port 0``; one streamed chat is
    answered and all three exit 0 on SIGTERM, the worker first."""
    import signal
    procs = []
    t0 = time.monotonic()
    try:
        coord = _spawn(procs, "dynamo_tpu_torch.runtime.coordinator",
                       "--host", "127.0.0.1", "--port", "0")
        url = "tcp://127.0.0.1:" + _wait_line(
            coord, "COORDINATOR_READY").rsplit("=", 1)[1]
        worker = _spawn(procs, "dynamo_tpu_torch.backends.gpu", "--model",
                        "tiny-test", "--coordinator-url", url)
        front = _spawn(procs, "dynamo_tpu_torch.frontend", "--http-host",
                       "127.0.0.1", "--http-port", "0", "--coordinator-url",
                       url)
        ready = _wait_line(worker, "GPU_WORKER_READY")
        device = _wait_line(worker, "from an engine on")
        assert "from an engine on cuda" in device, device
        port = int(_wait_line(front, "FRONTEND_READY").rsplit("=", 1)[1])
        deadline = time.monotonic() + 60
        while [m["id"] for m in http_call(port, "GET", "/v1/models")[
                "json"]["data"]] != ["tiny-test"]:
            assert time.monotonic() < deadline, "the model was not served"
            time.sleep(0.05)
        ready_s = time.monotonic() - t0
        res = http_call(port, "POST", "/v1/chat/completions", {
            "model": "tiny-test", "stream": True, "max_tokens": 8,
            "ignore_eos": True, "stream_options": {"include_usage": True},
            "messages": [{"role": "user", "content": "hello world"}]})
        s = stream_summary(res)
        assert res["status"] == 200 and s["finish"] == "length", s
        assert s["usage"]["completion_tokens"] == 8, s
        for proc, _, seen in (worker, front, coord):
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=120)
            assert code == 0, (code, seen[-20:])
    finally:
        for proc, _, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    log(f"distributed subprocesses: {ready.strip()}, {device.strip()}, "
        f"serving in {ready_s:.1f}s, answered a streamed chat, all three "
        f"exited 0 on SIGTERM")
    return {"ready_s": ready_s}


def launcher_subprocess(args=("--model", "tiny-test"),
                        model: str = "tiny-test") -> dict:
    """``python -m dynamo_tpu_torch.launch in=http out=gpu --http-port 0``
    with ``args`` as a subprocess: it must log an engine on cuda (no
    --device given), answer one streamed chat for ``model`` and exit 0 on
    SIGTERM."""
    import signal
    procs = []
    t0 = time.monotonic()
    try:
        launcher = _spawn(procs, "dynamo_tpu_torch.launch", "in=http",
                          "out=gpu", "--http-port", "0", *args)
        ready = _wait_line(launcher, "LAUNCH_READY")
        device = _wait_line(launcher, "from an engine on")
        ready_s = time.monotonic() - t0
        assert "from an engine on cuda" in device, device
        port = int(ready.rsplit("=", 1)[1])
        res = http_call(port, "POST", "/v1/chat/completions", {
            "model": model, "stream": True, "max_tokens": 8,
            "ignore_eos": True, "stream_options": {"include_usage": True},
            "messages": [{"role": "user", "content": "hello world"}]})
        s = stream_summary(res)
        assert res["status"] == 200 and s["finish"] == "length", s
        assert s["usage"]["completion_tokens"] == 8, s
        proc, _, seen = launcher
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        assert code == 0, (code, seen[-20:])
    finally:
        for proc, _, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    log(f"launcher subprocess ({' '.join(args)}): {ready}, {device}, "
        f"ready in {ready_s:.1f}s, answered a streamed chat, exited 0 on "
        f"SIGTERM")
    return {"ready_s": ready_s, "usage": s["usage"]}


# ---------------------------------------------------------------------------
# Phase 7: real checkpoints at full width
# ---------------------------------------------------------------------------

# The public config.json values of meta-llama/Meta-Llama-3-8B and of
# Qwen/Qwen2.5-0.5B (the fields ModelSpec.from_hf_config reads).
LLAMA3_8B_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 128256, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "rope_theta": 500000.0, "rms_norm_eps": 1e-05,
    "max_position_embeddings": 8192, "tie_word_embeddings": False,
    "hidden_act": "silu", "torch_dtype": "bfloat16"}
QWEN25_05B_CONFIG = {
    "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2",
    "vocab_size": 151936, "hidden_size": 896, "intermediate_size": 4864,
    "num_hidden_layers": 24, "num_attention_heads": 14,
    "num_key_value_heads": 2, "rope_theta": 1000000.0, "rms_norm_eps": 1e-06,
    "max_position_embeddings": 32768, "tie_word_embeddings": True,
    "hidden_act": "silu", "torch_dtype": "bfloat16"}
# The device phase 7 builds its trees and inputs on (the CPU only when the
# phase is rehearsed at a tiny size).
DEVICE = "cuda"
# Checkpoint shards of at most this many bytes, as HF writes them.
SHARD_BYTES = 5 * 10**9
# Layers of the llama-3-8b layout written to disk: its full depth.
CKPT_LAYERS = 32
# Layers whose int8 q/s are held against the CPU quantizer.
QUANT_CHECK_LAYERS = (0, CKPT_LAYERS // 2, CKPT_LAYERS - 1)


def hf_tensors(params: dict, spec):
    """(HF name, tensor in HF's [out, in] layout) of a port bf16 tree."""
    from dynamo_tpu_torch.engine.weights import HF_LAYER_NAMES
    yield "model.embed_tokens.weight", params["embed"]
    for i in range(spec.num_layers):
        for key, (hf, transposed) in HF_LAYER_NAMES.items():
            if key in params["layers"]:
                t = params["layers"][key][i]
                yield f"model.layers.{i}.{hf}", t.t() if transposed else t
    yield "model.norm.weight", params["final_norm"]
    if "lm_head" in params:
        yield "lm_head.weight", params["lm_head"].t()


def seed0_params(spec):
    """The seed-0 random tree the runner builds for a preset, on the card."""
    from dynamo_tpu_torch.engine.model import init_params
    return init_params(spec, torch.Generator(device=DEVICE).manual_seed(0),
                       DEVICE)


def write_checkpoint(directory: str, config: dict) -> dict:
    """Write the seed-0 tree of ``config`` as a HF checkpoint: config.json
    and bf16 safetensors in HF names and layout, in shards of at most
    SHARD_BYTES. Returns its bytes, files and seconds."""
    import os

    from dynamo_tpu_torch.engine.config import ModelSpec
    from dynamo_tpu_torch.engine.safetensors_lite import save_file
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as fh:
        json.dump(config, fh, indent=2)
    spec = ModelSpec.from_hf_config(directory)
    t0 = time.monotonic()
    params = seed0_params(spec)
    shards, size = [{}], 0
    for name, t in hf_tensors(params, spec):
        n = t.numel() * t.element_size()
        if shards[-1] and size + n > SHARD_BYTES:
            shards.append({})
            size = 0
        shards[-1][name] = t
        size += n
    total = 0
    for i, shard in enumerate(shards):
        path = os.path.join(directory, f"model-{i + 1:05d}-of-"
                                       f"{len(shards):05d}.safetensors")
        save_file(shard, path, metadata={"format": "pt"})
        total += os.path.getsize(path)
    files = len(shards)
    del params, shards
    torch.cuda.empty_cache()
    return {"bytes": total, "files": files,
            "write_s": time.monotonic() - t0}


def check_loaded_equal_written(params: dict, spec) -> None:
    """Every leaf of a loaded bf16 tree equals the seed-0 tree written."""
    want = seed0_params(spec)

    def walk(a, b, path):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}{k}.")
            else:
                assert a[k].dtype == b[k].dtype == torch.bfloat16, path + k
                assert torch.equal(a[k], b[k]), f"{path}{k} differs"
    walk(params, want, "")
    del want
    torch.cuda.empty_cache()


def check_int8_against_cpu(params: dict, spec) -> list[str]:
    """wq and w_down of QUANT_CHECK_LAYERS and the embedding, quantized on
    the card while loading, equal the CPU quantizer's q and s on the same
    bf16 leaves."""
    from dynamo_tpu_torch.engine import quant
    src = seed0_params(spec)
    checked = []
    for key in ("wq", "w_down"):
        for layer in QUANT_CHECK_LAYERS:
            want = quant.quantize_weight(src["layers"][key][layer].cpu())
            got = params["layers"][key]
            assert torch.equal(got.q[layer].cpu(), want.q), (key, layer)
            assert torch.equal(got.s[layer].cpu().view(torch.int32),
                               want.s.view(torch.int32)), (key, layer)
            checked.append(f"{key}[{layer}]")
    want = quant.quantize_embedding(src["embed"].cpu())
    assert torch.equal(params["embed"].q.cpu(), want.q)
    assert torch.equal(params["embed"].s.cpu().view(torch.int32),
                       want.s.view(torch.int32))
    checked.append("embed")
    del src
    torch.cuda.empty_cache()
    return checked


def decode_step_device_ms(engine, rows: int = 8, hist: int = 1224) -> float:
    """Device busy ms per decode step of one window run alone on the
    stopped engine (``rows`` greedy rows of ``hist`` tokens), under
    torch.profiler: the union of the device events' intervals over M."""
    packed, pages = alone_window(engine, rows, hist)
    try:
        return profiled_step_ms(engine.runner, packed,
                                engine.decode_window)[0]
    finally:
        engine.allocator.release(pages)


def profiled_step_ms(runner, packed, window: int) -> tuple[float, list]:
    """Device busy ms per step of one ``window``-step window of
    ``packed`` on ``runner`` (run once unprofiled first), under
    torch.profiler: the union of the device events' intervals over the
    steps; and the top device ops by ms a step."""
    from dynamo_tpu_torch.profile_decode import _busy_seconds
    runner.decode_window(packed, window)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        runner.decode_window(packed, window)
        torch.cuda.synchronize()
    intervals, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            intervals.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    if not intervals:
        raise RuntimeError("the profiler recorded no device activity")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return (_busy_seconds(intervals) * 1e3 / window,
            [(n[:80], t / window) for n, t in top])


def greedy_agree(runner, model, prompts, tokens, ref_tokens,
                 rows=range(6)) -> int:
    """Greedy requests (by default the first 6 of round 1) against the
    reference's tokens: equal, or split only at a near-tie of the
    teacher-forced logits (top-2 margin within 2 x LOGIT_ATOL). Returns
    how many are equal throughout."""
    equal = 0
    for i in rows:
        got, want = tokens[i], ref_tokens[i]
        j = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if j is None:
            equal += 1
            continue
        lg = plain_forced_logits(runner, model, prompts[i], want[:j + 1],
                                 quant=runner.quant_kv == "int8")[-1]
        top2 = torch.topk(lg, 2).values
        margin = float(top2[0] - top2[1])
        assert margin <= 2 * LOGIT_ATOL, (
            f"request {i}: token {j} is {got[j]}, the reference's {want[j]}, "
            f"at margin {margin}")
    return equal


def checkpoint_engine(attention, model, directory, ref, extra=()) -> dict:
    """Build the engine from ``directory`` through launch.build_engine,
    serve round 1 on it, and hold its teacher-forced logits against the
    seed-0 preset's (``ref``, from phase 3). Returns the numbers, and
    under "_engine" the stopped engine, which the caller releases."""
    from dynamo_tpu_torch import launch
    from dynamo_tpu_torch.profile_decode import MAX_PREFILL_TOKENS
    loads = []
    inner = launch.load_hf_weights

    def timed(*args):
        t0 = time.monotonic()
        out = inner(*args)
        torch.cuda.synchronize()
        loads.append(time.monotonic() - t0)
        return out

    argv = ["out=gpu", "--model", directory, *extra]
    launch.load_hf_weights = timed
    try:
        t0 = time.monotonic()
        engine = launch.build_engine(launch.parse_args(argv),
                                     max_prefill_tokens=MAX_PREFILL_TOKENS)
        setup_s = time.monotonic() - t0
    finally:
        launch.load_hf_weights = inner
    runner = engine.runner
    try:
        results, stats = round1(engine, attention, ref["prompts"])
    finally:
        engine.stop()
    tokens = [r["tokens"] for r in results]
    _, logits = teacher_forced_check(
        runner, engine.decode_window, ref["prompts"][0], ref["tokens"][0],
        attention, model, quant=runner.quant_kv == "int8")
    weights = "int8" if runner.spec.quant == "int8" else "bf16"
    # The preset's own weights must give its greedy ids; int8 weights are
    # held by the cosine of their logits and only counted here.
    equal = (greedy_agree(runner, model, ref["prompts"], tokens,
                          ref["tokens"]) if weights == "bf16" else
             sum(tokens[i] == ref["tokens"][i] for i in range(6)))
    stats.update({
        "weights": weights, "pool": runner.quant_kv or "bf16",
        "param_bytes": runner.param_bytes, "load_s": loads[0],
        "load_GBps": runner.param_bytes / loads[0] / 1e9,
        "setup_s": setup_s, "greedy_equal_of_6": equal,
        "tf_max_abs_diff_vs_preset": max(
            float((a.cpu() - b).abs().max())
            for a, b in zip(logits, ref["tf_logits"])),
        "tf_min_cosine_vs_preset": min_cosine(logits, ref["tf_logits"]),
        "decode_step_device_ms": decode_step_device_ms(engine),
        "window_programs": graph_stats(engine, f"checkpoint {argv[2:]}")})
    log(json.dumps({"checkpoint_engine": argv[2:], **stats}))
    stats["_engine"] = engine
    return stats


def release(stats: dict) -> None:
    """Drop a checkpoint engine's weights and pool."""
    del stats["_engine"]
    gc.collect()
    torch.cuda.empty_cache()


def int8_mm_times() -> dict:
    """Device ms of one int8-weight mm (dequantize to bf16, matmul, scale)
    against the bf16 matmul, at the decode shape [32, 4096] x [4096,
    14336], by CUDA-graph replay."""
    from dynamo_tpu_torch.engine import model, quant
    from dynamo_tpu_torch.time_attention import graph_ms
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    x = torch.randn((32, 4096), generator=gen, device=DEVICE).to(
        torch.bfloat16)
    w = torch.randn((4096, 14336), generator=gen, device=DEVICE).to(
        torch.bfloat16)
    qw = quant.quantize_weight(w)
    out = {"int8_mm_ms": graph_ms(lambda: model.mm(x, qw)),
           "bf16_mm_ms": graph_ms(lambda: model.mm(x, w))}
    # Bound: the int8 weight read once (1 byte each) plus x and the output.
    out["int8_mm_bound_ms"] = (w.numel() + 2 * (x.numel() + 32 * 14336)) \
        / H100_BYTES_PER_S * 1e3
    out["bf16_mm_bound_ms"] = 2 * (w.numel() + x.numel() + 32 * 14336) \
        / H100_BYTES_PER_S * 1e3
    del x, w, qw
    torch.cuda.empty_cache()
    return out


def qwen_checks(directory: str, gguf_path: str) -> dict:
    """The Qwen2.5-0.5B layout: its int8 weights (tied head folded into
    the activations) give logits cosine-close to its bf16 weights' on a
    prompt, in process; then the launcher serves it as a subprocess with
    --quant int8 and the GGUF tokenizer."""
    import dataclasses
    import os

    from dynamo_tpu_torch.engine.config import ModelSpec
    from dynamo_tpu_torch.engine.weights import load_hf_weights
    from dynamo_tpu_torch.engine import model
    spec = ModelSpec.from_hf_config(directory)
    prompt = torch.tensor([np.random.default_rng(9).integers(
        0, spec.vocab_size, 256).tolist()], dtype=torch.int32, device=DEVICE)
    shape = (spec.num_layers, spec.num_kv_heads, 17, 16, spec.head_dim)
    logits = []
    for quant in (None, "int8"):
        params = load_hf_weights(dataclasses.replace(spec, quant=quant),
                                 directory, DEVICE)
        kc = torch.zeros(shape, dtype=torch.bfloat16, device=DEVICE)
        lg, _, _ = model.prefill_forward(
            params, spec, kc, torch.zeros_like(kc), prompt,
            torch.arange(256, dtype=torch.int32, device=DEVICE)[None],
            torch.arange(1, 17, dtype=torch.int32, device=DEVICE)[None],
            torch.tensor([256], dtype=torch.int32, device=DEVICE))
        logits.append(lg[0])
        del params, kc
    cos = min_cosine([logits[1]], [logits[0]])
    log(f"qwen2.5-0.5b layout: int8 vs bf16 weights, prefill logits cosine "
        f"{cos:.6f} (gate > {MIN_COSINE})")
    assert cos > MIN_COSINE, cos
    torch.cuda.empty_cache()
    sub = launcher_subprocess(
        ("--model", directory, "--quant", "int8", "--tokenizer", gguf_path),
        os.path.basename(directory))
    return {"int8_vs_bf16_cosine": cos, "launcher_ready_s": sub["ready_s"],
            "launcher_usage": sub["usage"]}


def write_gguf_tokenizer(path: str) -> None:
    """The test tokenizer's vocab and merges as a GGUF file."""
    from dynamo_tpu_torch.llm import gguf
    from dynamo_tpu_torch.llm.tokenizer import make_test_tokenizer
    spec = json.loads(make_test_tokenizer().to_bytes())["model"]
    tokens = [t for t, _ in sorted(spec["vocab"].items(),
                                   key=lambda kv: kv[1])]
    merges = [m if isinstance(m, str) else " ".join(m)
              for m in spec["merges"]]
    gguf.write_metadata(path, {
        "general.architecture": "qwen2", "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.merges": merges,
        "tokenizer.ggml.eos_token_id": spec["vocab"]["<|endoftext|>"]})


def checkpoint_phase(attention, model, ref: dict) -> dict:
    """Phase 7 (see the module docstring)."""
    import os
    import shutil
    import tempfile

    from dynamo_tpu_torch.llm.tokenizer import make_test_tokenizer
    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        usage = shutil.disk_usage(tmp)
        log(f"checkpoint directory {tmp}: {usage.free / 1e9:.2f} GB free of "
            f"{usage.total / 1e9:.2f} GB")
        llama = os.path.join(tmp, "Meta-Llama-3-8B-layout")
        config = dict(LLAMA3_8B_CONFIG, num_hidden_layers=CKPT_LAYERS)
        written = write_checkpoint(llama, config)
        with open(os.path.join(llama, "tokenizer.json"), "wb") as fh:
            fh.write(make_test_tokenizer().to_bytes())
        log(json.dumps({"checkpoint_written": written}))

        bf16 = checkpoint_engine(attention, model, llama, ref)
        runner = bf16["_engine"].runner
        check_loaded_equal_written(runner.params, runner.spec)
        log("loaded llama-3-8b layout: every leaf equals the written one")
        assert bf16["tf_max_abs_diff_vs_preset"] <= LOGIT_ATOL, bf16
        del runner
        release(bf16)

        int8 = checkpoint_engine(attention, model, llama, ref,
                                 ("--quant", "int8"))
        runner = int8["_engine"].runner
        int8["quant_checked"] = check_int8_against_cpu(runner.params,
                                                       runner.spec)
        log(f"int8 q/s on the card equal the CPU quantizer's: "
            f"{int8['quant_checked']}")
        assert int8["tf_min_cosine_vs_preset"] > MIN_COSINE, int8
        del runner
        release(int8)

        int8_kv = checkpoint_engine(attention, model, llama, ref,
                                    ("--quant", "int8", "--quant-kv", "int8"))
        assert int8_kv["tf_min_cosine_vs_preset"] > MIN_COSINE, int8_kv
        release(int8_kv)
        shutil.rmtree(llama)

        qwen = os.path.join(tmp, "Qwen2.5-0.5B-layout")
        qwen_written = write_checkpoint(qwen, QWEN25_05B_CONFIG)
        gguf_path = os.path.join(tmp, "test-tokenizer.gguf")
        write_gguf_tokenizer(gguf_path)
        qwen_stats = qwen_checks(qwen, gguf_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mm = int8_mm_times()
    out = {"written": written, "bf16_weights": bf16, "int8_weights": int8,
           "int8_weights_int8_pool": int8_kv,
           "qwen_written": qwen_written, "qwen": qwen_stats, **mm,
           "phase_s": time.monotonic() - t_phase}
    log(json.dumps({"checkpoint_phase": out}))
    return out


# ---------------------------------------------------------------------------
# Phase 8: disaggregated prefill and decode at full width
# ---------------------------------------------------------------------------

# Pool pages of each of phase 8's two engines: 8 GiB of bf16 pages (2 MiB
# each at llama-3-8b's widths), so two full-width engines fit one card.
DISAGG_PAGES = 4096
# Prompts longer than this prefill on the prefill worker.
DISAGG_MAX_LOCAL = 512


def disagg_engine(mode: str, quant_kv: str | None):
    """An engine built as ``python -m dynamo_tpu_torch.backends.gpu --mode
    MODE`` builds it (seed-0 llama-3-8b, DISAGG_PAGES pages), with phase
    3's prefill program size."""
    import dataclasses

    from dynamo_tpu_torch.backends import gpu
    from dynamo_tpu_torch.launch import load_engine
    from dynamo_tpu_torch.profile_decode import MAX_PREFILL_TOKENS, MODEL
    argv = ["--mode", mode, "--model", MODEL, "--seed", "0", "--device",
            DEVICE, "--num-pages", str(DISAGG_PAGES)]
    if quant_kv:
        argv += ["--quant-kv", quant_kv]
    args = gpu.parse_args(argv)
    config = dataclasses.replace(gpu.build_engine_config(args),
                                 max_prefill_tokens=MAX_PREFILL_TOKENS)
    t0 = time.monotonic()
    engine = load_engine(config, args.resolved_checkpoint, args.seed)
    log(f"{mode} engine ({quant_kv or 'bf16'} pool): pages="
        f"{engine.runner.num_pages} pool="
        f"{engine.runner.kv_pool_bytes / 2**30:.2f} GiB setup="
        f"{time.monotonic() - t0:.1f}s")
    graph_stats(engine, f"{mode} engine after its warmup")
    return engine


def disagg_traffic(spec, ref: dict) -> list[dict]:
    """Round 1's eight prompts (6 greedy, top-p, seeded; 64 tokens each)
    and round 2's 6000-token prompt (32 tokens), as completions of token
    ids."""
    from dynamo_tpu_torch.profile_decode import (MAX_TOKENS, MODEL,
                                                 ROUND2_MAX_TOKENS)
    sampling = [{}] * 6 + [{"temperature": 0.8, "top_p": 0.9},
                           {"temperature": 0.8, "seed": 1234}]
    out = []
    for ids, s, n in zip(ref["prompts"] + [ref["long_prompt"]],
                         sampling + [{}], [MAX_TOKENS] * 8
                         + [ROUND2_MAX_TOKENS]):
        out.append({"model": MODEL, "prompt": ids, "stream": True,
                    "ignore_eos": True, "max_tokens": n,
                    "stream_options": {"include_usage": True}, **s})
    return out


class DisaggProbe:
    """Per remote request (keyed by prompt length): the prefill worker's
    extract device ms (the gathers and their copies to pinned host memory,
    by CUDA events), the plane groups staged, the decode worker's pull
    seconds and bytes and its insert ms; per prompt, the decode handler's
    tokens and the times of its outputs. Wraps methods on the instances
    only, and ``close`` takes every wrapper off again."""

    def __init__(self, p_engine, d_engine):
        self.extracts: dict[int, list] = {}
        self.groups: dict[int, list] = {}
        self.pulls: dict[int, tuple] = {}
        self.inserts: dict[int, list] = {}
        self.tokens: dict[tuple, list] = {}
        self.times: dict[tuple, list] = {}
        self._key = None
        self._wrapped: list = []
        for name in ("prefill_extract", "prefill_extract_staged"):
            self._wrap(p_engine, name, self._keyed(getattr(p_engine, name)))
        runner = p_engine.runner
        inner_extract = runner.extract_pages_async

        def extract(pages):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            handle = inner_extract(pages)
            ev[1].record()
            self.extracts.setdefault(self._key, []).append(ev)
            return handle

        self._wrap(runner, "extract_pages_async", extract)
        d_runner = d_engine.runner
        inner_insert = d_runner.insert_pages

        def insert(kv, pages):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            inner_insert(kv, pages)
            ev[1].record()
            self.inserts[len(pages)] = [ev, time.perf_counter() - t0,
                                        kv.nbytes]

        self._wrap(d_runner, "insert_pages", insert)

    def _wrap(self, obj, name: str, fn) -> None:
        setattr(obj, name, fn)
        self._wrapped.append((obj, name))

    def _keyed(self, inner):
        def job(req, *args, **kwargs):
            self._key = len(req.token_ids)
            return inner(req, *args, **kwargs)
        return job

    def watch_plane(self, plane) -> None:
        inner = plane.stage

        def stage(**kwargs):
            groups = kwargs.get("resolve_groups")
            self.groups[kwargs["prompt_len"]] = [n for n, _ in groups or []]
            return inner(**kwargs)

        self._wrap(plane, "stage", stage)

    def watch_handler(self, handler) -> None:
        client, inner_pull = handler.plane_client, handler.plane_client.pull_sync

        def pull(ticket):
            t0 = time.perf_counter()
            kv = inner_pull(ticket)
            seconds = time.perf_counter() - t0
            _, header_s, end_s, nbytes = next(
                r for r in reversed(client.recent) if r[0] == ticket["id"])
            self.pulls[ticket["prompt_len"]] = (seconds, header_s, end_s,
                                                nbytes)
            return kv

        self._wrap(client, "pull_sync", pull)
        inner_gen = handler.generate

        async def generate(request, context):
            key = tuple(request["token_ids"])
            ids = self.tokens.setdefault(key, [])
            times = self.times.setdefault(key, [time.perf_counter()])
            async for item in inner_gen(request, context):
                ids.extend(item.get("token_ids", []))
                times.append(time.perf_counter())
                yield item

        self._wrap(handler, "generate", generate)

    def close(self) -> None:
        for obj, name in reversed(self._wrapped):
            delattr(obj, name)


def pool_pages(runner, pages) -> list[np.ndarray]:
    """The pool's bytes at ``pages``: K and V values, and for an int8 pool
    their scales, on the host."""
    from dynamo_tpu_torch.engine.kv_quant import QuantKV
    idx = torch.tensor(pages, device=runner.device)
    out = []
    for cache in (runner.k_cache, runner.v_cache):
        for t in (cache if isinstance(cache, QuantKV) else (cache,)):
            t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            out.append(t[:, :, idx].cpu().numpy())
    return out


@contextlib.contextmanager
def no_stream_sync():
    """Any operation in the block that makes the host wait for the card
    (a blocking copy, a stream or device synchronize) raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def pool_pages_check(on_loop, p_engine, d_engine, prompt) -> dict:
    """Extract and insert on the card, each on its engine's thread: the
    prefill pool's pages that hold ``prompt``'s complete blocks
    (registered when it was prefilled) are extracted; the parcel is those
    pages as they are (bf16 bits, or pack_parcel of the int8 values and
    scales); inserted into as many free pages of the decode pool (a pool
    of the same type) and extracted again, it is bit-exact, and the two
    pools' bytes at those pages are equal. Neither the extract's dispatch
    nor the insert waits for the card (``no_stream_sync``), so neither
    stalls the engine thread behind queued work."""
    from dynamo_tpu_torch.engine.kv_quant import pack_parcel
    from dynamo_tpu_torch.llm.tokens import compute_block_hashes
    hashes = compute_block_hashes(prompt, p_engine.config.page_size)

    def src_job():
        runner = p_engine.runner
        pages = p_engine.allocator.lookup(hashes)
        with no_stream_sync():
            handle = runner.extract_pages_async(pages)
        return runner.finalize_extract(handle), pool_pages(runner, pages)

    def dst_job(kv):
        alloc = d_engine.allocator
        pages = alloc.allocate(kv.shape[3])
        assert pages is not None
        try:
            with no_stream_sync():
                d_engine.runner.insert_pages(kv, pages)
            return (d_engine.runner.extract_pages(pages),
                    pool_pages(d_engine.runner, pages))
        finally:
            alloc.release(pages)

    kv, src = on_loop(p_engine.run_job(src_job))
    assert kv.shape[3] >= 8, kv.shape
    want = (pack_parcel(np.stack(src[0::2]), np.stack(src[1::2]))
            if len(src) == 4 else np.stack(src).view(np.uint16))
    assert np.array_equal(kv, want), "the parcel is not the pool's pages"
    back, dst = on_loop(d_engine.run_job(lambda: dst_job(kv)))
    assert np.array_equal(back, kv), "extract after insert is not bit-exact"
    assert all(np.array_equal(a, b) for a, b in zip(src, dst))
    return {"pages": int(kv.shape[3]), "parcel_bytes": int(kv.nbytes),
            "dtype": str(kv.dtype)}


def quantized_insert_check(on_loop, p_engine, d_engine, prompt) -> int:
    """A bf16 parcel inserted into the decode worker's int8 pool holds
    quantize_np of that parcel: the prompt's complete blocks in the
    decode pool against the prefill pool's same blocks, extracted and
    quantized on the host (each engine's part on its own thread).
    Returns the pages compared."""
    from dynamo_tpu_torch.engine.kv_quant import quantize_np
    from dynamo_tpu_torch.llm.tokens import compute_block_hashes
    hashes = compute_block_hashes(prompt, p_engine.config.page_size)
    q, s = quantize_np(on_loop(p_engine.run_job(
        lambda: p_engine.runner.extract_pages(
            p_engine.allocator.lookup(hashes)))))
    k_q, k_s, v_q, v_s = on_loop(d_engine.run_job(
        lambda: pool_pages(d_engine.runner,
                           d_engine.allocator.lookup(hashes))))
    assert q.shape[3] == k_q.shape[2] >= 8, (q.shape, k_q.shape)
    assert np.array_equal(q, np.stack([k_q, v_q]))
    assert np.array_equal(s.view(np.uint32),
                          np.stack([k_s, v_s]).view(np.uint32))
    log(f"bf16 parcels quantized on insert: {q.shape[3]} pages of the int8 "
        f"pool equal quantize_np of the prefill pool's pages")
    return int(q.shape[3])


def disagg_phase(attention, model, refs: dict) -> dict:
    """Phase 8 (see the module docstring)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.backends.gpu import (close_decode_handler,
                                               decode_handler, serve_engine,
                                               serve_prefill)
    from dynamo_tpu_torch.launch import start_front
    from dynamo_tpu_torch.llm.kv_plane import KvPlaneServer
    from dynamo_tpu_torch.llm.model_card import deregister_llm
    from dynamo_tpu_torch.llm.tokenizer import make_test_tokenizer
    from dynamo_tpu_torch.profile_decode import MODEL, serve
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    t_phase = time.monotonic()
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def on_loop(coro, timeout=600):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    tokenizer = make_test_tokenizer()

    async def up(p_engine, d_engine, plane_on: bool, probe):
        decode_rt = await DistributedRuntime.with_embedded_coordinator(
            RuntimeConfig())
        url = decode_rt.config.coordinator_url
        prefill_rt = await DistributedRuntime.from_settings(
            RuntimeConfig(coordinator_url=url))
        plane = None
        if plane_on:
            plane = KvPlaneServer()
            plane.start()
            probe.watch_plane(plane)
        p_server, queue_worker = await serve_prefill(prefill_rt, p_engine,
                                                     MODEL, plane)
        handler = await decode_handler(decode_rt, d_engine, MODEL,
                                       DISAGG_MAX_LOCAL)
        probe.watch_handler(handler)
        await handler.prefill_client.wait_for_instances(60)
        d_server = await serve_engine(decode_rt, d_engine, MODEL, tokenizer,
                                      handler=handler.handler())
        front_rt = await DistributedRuntime.from_settings(
            RuntimeConfig(coordinator_url=url))
        service, watcher = await start_front(front_rt, "127.0.0.1", 0)
        deadline = time.monotonic() + 60
        while watcher.manager.get(MODEL) is None:
            assert time.monotonic() < deadline, "the model was not discovered"
            await asyncio.sleep(0.02)
        return dict(decode_rt=decode_rt, prefill_rt=prefill_rt, plane=plane,
                    p_server=p_server, queue_worker=queue_worker,
                    handler=handler, d_server=d_server, front_rt=front_rt,
                    service=service, watcher=watcher)

    async def down(st):
        await st["service"].stop()
        await st["watcher"].stop()
        await st["front_rt"].close()
        await deregister_llm(st["decode_rt"], MODEL)
        await st["d_server"].shutdown()
        await close_decode_handler(st["handler"])
        if st["queue_worker"] is not None:
            await st["queue_worker"].stop()
        await st["p_server"].shutdown()
        if st["plane"] is not None:
            st["plane"].close()
        await st["prefill_rt"].close()
        await st["decode_rt"].close()

    def run_pass(label, p_engine, d_engine, plane_on, ref) -> dict:
        """One pass of the traffic through a fresh stack on the given
        engines, with both prefix caches cleared first (the decode
        handler's clear_kv_blocks fans out to the prefill worker)."""
        probe = DisaggProbe(p_engine, d_engine)
        st = on_loop(up(p_engine, d_engine, plane_on, probe), 300)
        spec = d_engine.runner.spec
        bodies = disagg_traffic(spec, ref)
        prompts = [b["prompt"] for b in bodies]
        try:
            async def clear():
                return [i async for i in st["handler"].handler()(
                    {"clear_kv_blocks": True}, Context())]
            cleared = on_loop(clear())
            assert len(cleared) == 1 and cleared[0]["cleared"] >= 0, cleared
            assert not p_engine.allocator.inactive
            assert not d_engine.allocator.inactive
            port = st["service"].port
            handler = st["handler"]
            attention.KERNEL.launches = 0
            attention.KERNEL.launches_int8 = 0
            d_windows0 = d_engine.windows_dispatched
            p_windows0 = p_engine.windows_dispatched
            d_replays0 = d_engine.runner.window_replays
            p_replays0 = p_engine.runner.window_replays
            injected0 = d_engine.injected_admissions
            t0 = time.monotonic()
            with ThreadPoolExecutor(len(bodies)) as pool:
                futures = [pool.submit(http_call, port, "POST",
                                       "/v1/completions", b) for b in bodies]
                results = [f.result(SSE_TIMEOUT_S) for f in futures]
            wall = time.monotonic() - t0
            torch.cuda.synchronize()
            launches = {"paged_attention_hist": attention.KERNEL.launches,
                        "paged_attention_hist_int8":
                            attention.KERNEL.launches_int8}
            d_windows = d_engine.windows_dispatched - d_windows0
            assert p_engine.windows_dispatched == p_windows0, (
                "the prefill worker ran decode windows")
            check_replays(d_engine, d_replays0, d_windows)
            check_replays(p_engine, p_replays0, 0)
            graph_stats(d_engine, f"{label}: decode engine")
            summaries = []
            for i, (res, body) in enumerate(zip(results, bodies)):
                assert res["status"] == 200, (i, res)
                s = stream_summary(res)
                summaries.append(s)
                assert s["finish"] == "length", (i, s["finish"])
                assert s["usage"]["completion_tokens"] == body["max_tokens"]
                assert s["usage"]["prompt_tokens"] == len(body["prompt"])
            remote = [len(p) > DISAGG_MAX_LOCAL for p in prompts]
            assert handler.remote_prefills == sum(remote), (
                handler.remote_prefills, sum(remote))
            assert handler.remote_failures == 0, handler.remote_failures
            assert handler.local_prefills == len(prompts) - sum(remote)
            injected = d_engine.injected_admissions - injected0
            assert injected == sum(remote), (
                f"{injected} of {sum(remote)} remote prompts were admitted "
                f"with their parcel: the rest fell back to a local prefill")
            ran, idle = (("paged_attention_hist_int8",
                          "paged_attention_hist")
                         if d_engine.runner.quant_kv == "int8" else
                         ("paged_attention_hist",
                          "paged_attention_hist_int8"))
            expected = d_windows * d_engine.decode_window * spec.num_layers
            assert launches[ran] == expected > 0, (launches, expected)
            assert launches[idle] == 0, launches
            tokens = [probe.tokens[tuple(p)] for p in prompts]
            for i, (t, b) in enumerate(zip(tokens, bodies)):
                assert len(t) == b["max_tokens"], (i, len(t))
            long_len = len(prompts[-1])
            if plane_on:
                page = d_engine.config.page_size
                chunk = p_engine.config.max_prompt_len // page
                n_long = -(-long_len // page)
                want = [chunk, chunk, n_long - 2 * chunk]
                assert probe.groups[long_len] == want, (
                    probe.groups[long_len], want)
                assert st["plane"].transfers == sum(remote)
            rows = []
            for i, p in enumerate(prompts):
                if not remote[i]:
                    continue
                n_pages = -(-len(p) // d_engine.config.page_size)
                ev, insert_host_s, nbytes = probe.inserts[n_pages]
                extract_ms = sum(a.elapsed_time(b)
                                 for a, b in probe.extracts[len(p)])
                # TTFT and TPOT at the decode worker's handler, the
                # boundary of phase 3's TTFT (the test tokenizer decodes
                # most ids to no text, so few chunks reach the client).
                times = probe.times[tuple(p)]
                row = {"pass": label, "prompt_tokens": len(p),
                       "parcel_bytes": nbytes, "extract_ms": extract_ms,
                       "insert_ms": ev[0].elapsed_time(ev[1]),
                       "insert_host_ms": insert_host_s * 1e3,
                       "ttft_ms": (times[1] - times[0]) * 1e3,
                       "tpot_ms": (times[-1] - times[1])
                       / (len(tokens[i]) - 1) * 1e3,
                       "client_first_chunk_ms": summaries[i]["ttft_ms"]}
                if i < len(ref["ttft_s"]):
                    row["aggregated_engine_ttft_ms"] = ref["ttft_s"][i] * 1e3
                if plane_on:
                    # The header waits for the first page group's copy;
                    # GB/s reads the bytes after it (for the long prompt
                    # they include the later chunks' waits).
                    pull_s, header_s, end_s, pull_bytes = probe.pulls[len(p)]
                    assert pull_bytes == nbytes
                    row.update(pull_ms=pull_s * 1e3,
                               pull_wait_ms=header_s * 1e3,
                               pull_recv_ms=(end_s - header_s) * 1e3,
                               pull_GBps=pull_bytes / (end_s - header_s)
                               / 1e9)
                    if len(p) == long_len:
                        row["plane_groups"] = probe.groups[long_len]
                log(json.dumps({"disagg_request": row}))
                rows.append(row)
            n_tok = sum(s["usage"]["completion_tokens"] for s in summaries)
            stats = {"pass": label, "plane": plane_on,
                     "prefill_pool": p_engine.runner.quant_kv or "bf16",
                     "decode_pool": d_engine.runner.quant_kv or "bf16",
                     "requests": len(summaries), "tokens": n_tok,
                     "wall_s": wall, "tok_per_s": n_tok / wall,
                     "remote_prefills": handler.remote_prefills,
                     "remote_failures": handler.remote_failures,
                     "local_prefills": handler.local_prefills,
                     "cleared_pages": cleared[0]["cleared"],
                     "windows": d_windows,
                     "window_steps": d_engine.decode_window,
                     "kernel_launches": launches[ran], "launches": launches,
                     "requests_remote": rows, "_tokens": tokens,
                     "_prompts": prompts, "_bodies": bodies}
            if plane_on and p_engine.runner.quant_kv == d_engine.runner.quant_kv:
                stats["pool_pages_check"] = pool_pages_check(
                    on_loop, p_engine, d_engine, prompts[-2])
                log(f"extract/insert on the card ({label}): "
                    f"{stats['pool_pages_check']}: the parcel is the "
                    f"prefill pool's pages; inserted into the decode pool "
                    f"and extracted again, bit-exact")
            if p_engine.runner.quant_kv != d_engine.runner.quant_kv:
                stats["quantized_insert_pages"] = quantized_insert_check(
                    on_loop, p_engine, d_engine, prompts[-2])
            return stats
        finally:
            on_loop(down(st), 300)
            probe.close()

    def check_tokens(stats, d_engine, ref, mixed: bool = False) -> None:
        """Greedy ids against phase 3's (bf16 pool) or phase 4's (int8
        pool) aggregated ids at clear margins, the long prompt's too. With
        ``mixed`` (bf16 parcels into the int8 pool) the long prompt's
        chunks ran over bf16 history where phase 4's ran over int8
        history, so its tokens are held against the plain path of this
        computation instead (whole-prompt prefill, teacher-forced decode
        over the int8 pool): its argmax, or within 2 x LOGIT_ATOL of it."""
        tokens, prompts = stats["_tokens"], stats["_prompts"]
        runner = d_engine.runner
        equal = greedy_agree(runner, model, prompts[:8], tokens[:8],
                             ref["tokens"])
        stats["greedy_equal_of_6"] = equal
        if mixed:
            logits = plain_forced_logits(runner, model, prompts[-1],
                                         tokens[-1], quant=True)
            agree = 0
            for i, (tok, lg) in enumerate(zip(tokens[-1], logits)):
                gap = float(lg.max() - lg[tok])
                assert gap <= 2 * LOGIT_ATOL, (
                    f"long prompt token {i}: {tok} is {gap} below the "
                    f"plain path's argmax")
                agree += gap == 0.0
            stats["long_prompt_plain_argmax_of_n"] = [agree, len(logits)]
            long_note = (f"long prompt: {agree}/{len(logits)} tokens the "
                         f"plain path's argmax, the rest at a near-tie")
        else:
            long_equal = greedy_agree(runner, model, [prompts[-1]],
                                      [tokens[-1]], [ref["long_tokens"]],
                                      rows=[0])
            stats["long_prompt_equal"] = bool(long_equal)
            long_note = f"{long_equal}/1 long prompt"
        log(f"{stats['pass']}: greedy ids equal the aggregated ones in "
            f"{equal}/6 round-1 requests; {long_note} (others split at a "
            f"near-tie)")

    def seeded_alone(d_engine, stats) -> bool:
        """The seeded request served aggregated, alone, by the decode
        worker's engine (no cache can serve it: seeded requests take the
        no-reuse path) against its disaggregated tokens."""
        body = stats["_bodies"][7]
        req = {"model": MODEL, "token_ids": body["prompt"],
               "stop_conditions": {"max_tokens": body["max_tokens"],
                                   "ignore_eos": True},
               "sampling_options": {"temperature": body["temperature"],
                                    "seed": body["seed"]}}
        agg = asyncio.run(serve(d_engine, [req]))[0]["tokens"]
        assert agg == stats["_tokens"][7], (agg, stats["_tokens"][7])
        return True

    def free() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    passes = []
    try:
        p_engine = disagg_engine("prefill", None)
        d_engine = disagg_engine("decode", None)
        for label, plane_on in (("bf16 plane", True),
                                ("bf16 inline", False)):
            st = run_pass(label, p_engine, d_engine, plane_on, refs["bf16"])
            check_tokens(st, d_engine, refs["bf16"])
            st["seeded_equal"] = seeded_alone(d_engine, st)
            passes.append(st)
        d_engine.stop()
        del d_engine
        free()
        d_engine = disagg_engine("decode", "int8")
        st = run_pass("bf16 parcels into int8 pool", p_engine, d_engine,
                      True, refs["int8"])
        check_tokens(st, d_engine, refs["int8"], mixed=True)
        passes.append(st)
        p_engine.stop()
        del p_engine
        free()
        p_engine = disagg_engine("prefill", "int8")
        st = run_pass("int8 plane", p_engine, d_engine, True, refs["int8"])
        check_tokens(st, d_engine, refs["int8"])
        st["seeded_equal"] = seeded_alone(d_engine, st)
        passes.append(st)
        p_engine.stop()
        d_engine.stop()
        del p_engine, d_engine
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        loop.close()
    free()
    log(f"released: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
        f"allocated")
    sub = disagg_subprocesses()
    out = {"passes": [{k: v for k, v in p.items() if not k.startswith("_")}
                      for p in passes],
           "subprocesses": sub, "phase_s": time.monotonic() - t_phase}
    for p in out["passes"]:
        log(json.dumps({"disagg_pass": {k: v for k, v in p.items()
                                        if k != "requests_remote"}}))
    log(f"phase 8: {out['phase_s']:.1f}s")
    return out


def disagg_subprocesses() -> dict:
    """1P1D as processes on the card: the coordinator, ``python -m
    dynamo_tpu_torch.backends.gpu --mode prefill --model tiny-test`` and
    ``--mode decode --max-local-prefill-length 8`` (each must log an
    engine on cuda, no --device given) and the frontend; a streamed chat
    over the threshold is prefilled on the prefill worker and answered,
    and all four exit 0 on SIGTERM."""
    import signal
    procs = []
    t0 = time.monotonic()
    try:
        coord = _spawn(procs, "dynamo_tpu_torch.runtime.coordinator",
                       "--host", "127.0.0.1", "--port", "0")
        url = "tcp://127.0.0.1:" + _wait_line(
            coord, "COORDINATOR_READY").rsplit("=", 1)[1]
        # Explicit pools: two engines sizing theirs from the free memory at
        # once would both count the same memory.
        common = ("--model", "tiny-test", "--num-pages", "1024",
                  "--coordinator-url", url)
        prefill = _spawn(procs, "dynamo_tpu_torch.backends.gpu", "--mode",
                         "prefill", *common)
        decode = _spawn(procs, "dynamo_tpu_torch.backends.gpu", "--mode",
                        "decode", "--max-local-prefill-length", "8", *common)
        front = _spawn(procs, "dynamo_tpu_torch.frontend", "--http-host",
                       "127.0.0.1", "--http-port", "0", "--coordinator-url",
                       url)
        ready = [_wait_line(w, "GPU_WORKER_READY") for w in (prefill, decode)]
        assert ready[0].startswith("GPU_WORKER_READY mode=prefill"), ready
        assert ready[1].startswith("GPU_WORKER_READY mode=decode"), ready
        for w in (prefill, decode):
            device = _wait_line(w, "from an engine on")
            assert "from an engine on cuda" in device, device
        port = int(_wait_line(front, "FRONTEND_READY").rsplit("=", 1)[1])
        deadline = time.monotonic() + 60
        while [m["id"] for m in http_call(port, "GET", "/v1/models")[
                "json"]["data"]] != ["tiny-test"]:
            assert time.monotonic() < deadline, "the model was not served"
            time.sleep(0.05)
        ready_s = time.monotonic() - t0
        res = http_call(port, "POST", "/v1/chat/completions", {
            "model": "tiny-test", "stream": True, "max_tokens": 8,
            "ignore_eos": True, "stream_options": {"include_usage": True},
            "messages": [{"role": "user",
                          "content": "the quick brown fox jumps"}]})
        s = stream_summary(res)
        assert res["status"] == 200 and s["finish"] == "length", s
        assert s["usage"]["completion_tokens"] == 8, s
        assert s["usage"]["prompt_tokens"] > 8, s
        staged = _wait_line(prefill, "prefill parcel staged")
        for proc, _, seen in (front, decode, prefill, coord):
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=120)
            assert code == 0, (code, seen[-20:])
    finally:
        for proc, _, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    log(f"1P1D subprocesses: {ready[0]}; {ready[1]}; engines on cuda; "
        f"serving in {ready_s:.1f}s; {staged}; answered a streamed chat of "
        f"{s['usage']['prompt_tokens']} prompt tokens; all four exited 0 "
        f"on SIGTERM")
    return {"ready_s": ready_s, "usage": s["usage"]}


# Phase 9: KV-aware routing. Four prefixes of 64 complete blocks each.
KV_PREFIX_TOKENS = 1024
# Phase 9's depth: routing, the index and the prefix cache see no layer
# count, and a quarter of the layers takes a quarter of the graph
# captures' host time (the script's longest waits).
KV_LAYERS = 8
KV_SUFFIX_TOKENS = 128
KV_WAVE1_TOKENS = 16
KV_WAVE2_TOKENS = 32
KV_SEED = 1234
# Wave 2's rounds, as positions in [first holder's 1st, other's 1st,
# first holder's 2nd, other's 2nd]: rounds 0-1 go A,B,A,B and rounds 2-3
# B,A,B,A, so the holders alternate (one repeat where the halves meet)
# and every prefix stands at two even and two odd places of the wave.
KV_WAVE2_ROUNDS = ((0, 1, 2, 3), (0, 1, 2, 3), (1, 0, 3, 2), (1, 0, 3, 2))
# Each prefix's seeded request (temperature 0.8) is its last round.
KV_SEEDED_ROUND = 3


class EngineTap:
    """Per prompt (a tuple of ids), the tokens an engine emitted and the
    times of its outputs, the request's arrival first; wraps ``generate``
    on the instance, and ``close`` takes the wrapper off."""

    def __init__(self, engines):
        self.tokens: dict[tuple, list] = {}
        self.times: dict[tuple, list] = {}
        self.served_by: dict[tuple, int] = {}
        self._engines = engines
        for i, engine in enumerate(engines):
            engine.generate = self._wrap(i, engine.generate)

    def _wrap(self, index, inner):
        async def generate(request, context):
            key = tuple(request["token_ids"])
            self.served_by[key] = index
            ids = self.tokens.setdefault(key, [])
            times = self.times.setdefault(key, [time.perf_counter()])
            async for item in inner(request, context):
                ids.extend(item.get("token_ids", []))
                times.append(time.perf_counter())
                yield item
        return generate

    def close(self) -> None:
        for engine in self._engines:
            del engine.generate


def kv_engine():
    """An engine built as ``python -m dynamo_tpu_torch.backends.gpu``
    builds it in agg mode (seed-0 llama-3-8b at KV_LAYERS layers,
    DISAGG_PAGES pages), not started: the worker starts it on its event
    loop."""
    import dataclasses

    from dynamo_tpu_torch.backends import gpu
    from dynamo_tpu_torch.launch import load_engine
    from dynamo_tpu_torch.profile_decode import MAX_PREFILL_TOKENS, MODEL
    args = gpu.parse_args(["--model", MODEL, "--seed", "0", "--device",
                           DEVICE, "--num-pages", str(DISAGG_PAGES)])
    config = gpu.build_engine_config(args)
    config = dataclasses.replace(
        config, max_prefill_tokens=MAX_PREFILL_TOKENS,
        model=dataclasses.replace(config.model, num_layers=KV_LAYERS))
    t0 = time.monotonic()
    engine = load_engine(config, args.resolved_checkpoint, args.seed,
                         start=False)
    log(f"agg engine: layers={KV_LAYERS} pages={engine.runner.num_pages} "
        f"pool={engine.runner.kv_pool_bytes / 2**30:.2f} GiB "
        f"setup={time.monotonic() - t0:.1f}s")
    return engine


def kv_traffic(spec) -> dict:
    """The four prefixes, wave 1's bodies (one per prefix, greedy) and,
    per prefix and round, wave 2's suffixes."""
    from dynamo_tpu_torch.profile_decode import MODEL
    rng = np.random.default_rng(KV_SEED)
    prefixes = [rng.integers(0, spec.vocab_size,
                             KV_PREFIX_TOKENS).tolist() for _ in range(4)]
    suffixes = [[rng.integers(0, spec.vocab_size,
                              KV_SUFFIX_TOKENS).tolist() for _ in range(4)]
                for _ in range(4)]
    wave1 = [{"model": MODEL, "prompt": p, "stream": True,
              "ignore_eos": True, "max_tokens": KV_WAVE1_TOKENS,
              "stream_options": {"include_usage": True}} for p in prefixes]
    return {"prefixes": prefixes, "suffixes": suffixes, "wave1": wave1}


def kv_wave2(traffic, order: list[int]) -> list[dict]:
    """Wave 2's sixteen bodies: ``order`` lists the prefixes as [first
    holder's 1st, other's 1st, first holder's 2nd, other's 2nd], and each
    round of KV_WAVE2_ROUNDS takes them in its order; a prefix's request
    in KV_SEEDED_ROUND is seeded at temperature 0.8, the others greedy."""
    from dynamo_tpu_torch.profile_decode import MODEL
    bodies = []
    for r, positions in enumerate(KV_WAVE2_ROUNDS):
        for pos in positions:
            p = order[pos]
            body = {"model": MODEL, "stream": True, "ignore_eos": True,
                    "prompt": traffic["prefixes"][p]
                    + traffic["suffixes"][p][r],
                    "max_tokens": KV_WAVE2_TOKENS,
                    "stream_options": {"include_usage": True},
                    "_prefix": p, "_round": r}
            if r == KV_SEEDED_ROUND:
                body.update(temperature=0.8, seed=KV_SEED + p)
            bodies.append(body)
    return bodies


def kv_routing_phase(attention, model) -> dict:
    """Phase 9 (see the module docstring)."""
    import collections
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.backends.gpu import make_publishers, serve_engine
    from dynamo_tpu_torch.launch import start_front
    from dynamo_tpu_torch.llm.kv_router import make_kv_router_factory
    from dynamo_tpu_torch.llm.model_card import deregister_llm
    from dynamo_tpu_torch.llm.tokenizer import make_test_tokenizer
    from dynamo_tpu_torch.llm.tokens import compute_block_hashes
    from dynamo_tpu_torch.profile_decode import MODEL
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    t_phase = time.monotonic()
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def on_loop(coro, timeout=600):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    tokenizer = make_test_tokenizer()

    async def up(engines, mode: str):
        """Two worker runtimes (the first embeds the coordinator), each
        with its engine's three publishers and serve_engine, and a
        frontend runtime with launch.start_front in ``mode``."""
        rts, servers, inventory = [], [], []
        for engine in engines:
            rt = await (DistributedRuntime.with_embedded_coordinator(
                RuntimeConfig()) if not rts else
                DistributedRuntime.from_settings(RuntimeConfig(
                    coordinator_url=rts[0].config.coordinator_url)))
            kv_pub, metrics_pub, inv_pub = make_publishers(rt)
            engine.kv_publisher = kv_pub
            engine.metrics_publisher = metrics_pub
            engine.inventory_publisher = inv_pub
            # For this loop, which the publishers use, from an executor:
            # the warmup takes seconds and the leases must keep flowing.
            await asyncio.get_running_loop().run_in_executor(
                None, engine.start, loop)
            inv_pub.start_periodic(engine.inventory_digest)
            servers.append(await serve_engine(rt, engine, MODEL, tokenizer))
            rts.append(rt)
            inventory.append(inv_pub)
        front_rt = await DistributedRuntime.from_settings(RuntimeConfig(
            coordinator_url=rts[0].config.coordinator_url))
        factory = make_kv_router_factory() if mode == "kv" else None
        service, watcher = await start_front(front_rt, "127.0.0.1", 0, mode,
                                             factory)
        deadline = time.monotonic() + 60
        while (watcher.manager.get(MODEL) is None
               or len(watcher.manager.get(MODEL).client.instance_ids()) < 2):
            assert time.monotonic() < deadline, "workers not discovered"
            await asyncio.sleep(0.02)
        return dict(engines=engines, rts=rts, servers=servers,
                    inventory=inventory, front_rt=front_rt, service=service,
                    watcher=watcher, router=watcher.manager.get(MODEL).router)

    async def down(st):
        await st["service"].stop()
        await st["watcher"].stop()
        await st["front_rt"].close()
        for engine, rt, server, inv in reversed(list(zip(
                st["engines"], st["rts"], st["servers"], st["inventory"]))):
            inv.stop_periodic()
            engine.kv_publisher = engine.metrics_publisher = None
            engine.inventory_publisher = None
            await deregister_llm(rt, MODEL)
            await server.shutdown()
            await rt.close()

    def send(port, bodies) -> tuple[list, float]:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(bodies)) as pool:
            futures = [pool.submit(http_call, port, "POST", "/v1/completions",
                                   {k: v for k, v in b.items()
                                    if not k.startswith("_")})
                       for b in bodies]
            results = [f.result(SSE_TIMEOUT_S) for f in futures]
        for i, (res, b) in enumerate(zip(results, bodies)):
            assert res["status"] == 200, (i, res)
            s = stream_summary(res)
            assert s["finish"] == "length", (i, s["finish"])
            assert s["usage"]["completion_tokens"] == b["max_tokens"], s
            assert s["usage"]["prompt_tokens"] == len(b["prompt"]), s
            res["summary"] = s
            res["end_s"] = t0 + res["times"][-1]
        return results, time.perf_counter() - t0

    def run_pass(mode, engines, traffic, order) -> dict:
        st = on_loop(up(engines, mode), 300)
        tap = EngineTap(engines)
        try:
            worker_of = {rt.instance_id: i for i, rt in enumerate(st["rts"])}
            attention.KERNEL.launches = 0
            attention.KERNEL.launches_int8 = 0
            windows0 = [e.windows_dispatched for e in engines]
            replays0 = [e.runner.window_replays for e in engines]
            hits0 = [e.prefix_hit_blocks for e in engines]
            want = 4 * KV_PREFIX_TOKENS // 16
            index_full: list[float] = []
            stop_poll = threading.Event()

            def poll_index():
                # The moment the router's index first holds all of wave
                # 1's prefix blocks, polled beside the wave (1 ms).
                while not stop_poll.is_set():
                    if st["router"].indexer.tree.num_blocks >= want:
                        index_full.append(time.perf_counter())
                        return
                    time.sleep(0.001)

            poller = threading.Thread(target=poll_index, daemon=True)
            if mode == "kv":
                poller.start()
            t_send = time.perf_counter()
            wave1, wall1 = send(st["service"].port, traffic["wave1"])
            last_finish = max(r["end_s"] for r in wave1)
            # Prefill done: each wave-1 request's first output at the
            # engine boundary (its prefix blocks are registered by then).
            last_prefilled = max(tap.times[tuple(b["prompt"])][1]
                                 for b in traffic["wave1"])
            out = {"mode": mode}
            if mode == "kv":
                router = st["router"]
                poller.join(10)
                stop_poll.set()
                assert index_full, (
                    "the router's index never held wave 1's blocks",
                    router.indexer.tree.num_blocks)
                t_index = index_full[0]
                holders = []
                for p in traffic["prefixes"]:
                    m = router.indexer.tree.find_matches(
                        compute_block_hashes(p, 16))
                    assert sorted(m.values()) == [64], (
                        "a prefix is held by other than one worker", m)
                    holders.append(next(iter(m)))
                split = collections.Counter(holders)
                assert sorted(split.values()) == [2, 2], (
                    "wave 1 did not split 2 and 2", holders)
                first = holders[0]
                a = [p for p, h in enumerate(holders) if h == first]
                b = [p for p, h in enumerate(holders) if h != first]
                order[:] = [a[0], b[0], a[1], b[1]]
                out.update(
                    wave1_holders=[f"{h:x}" for h in holders],
                    event_lag_after_last_finish_ms=(t_index - last_finish)
                    * 1e3,
                    event_lag_after_last_first_token_ms=(
                        t_index - last_prefilled) * 1e3,
                    index_full_after_send_ms=(t_index - t_send) * 1e3)
                log(f"kv wave 1: holders {out['wave1_holders']}; the "
                    f"router's index held all {want} prefix blocks "
                    f"{out['index_full_after_send_ms']:.1f} ms after the "
                    f"send, "
                    f"{out['event_lag_after_last_first_token_ms']:.1f} ms "
                    f"after wave 1's last first token and "
                    f"{out['event_lag_after_last_finish_ms']:.1f} ms after "
                    f"its last finish (negative: before it)")
                decisions0 = router.decisions.decisions
            wave2_bodies = kv_wave2(traffic, order)
            hits_mid = [e.prefix_hit_blocks for e in engines]
            wave2, wall2 = send(st["service"].port, wave2_bodies)
            torch.cuda.synchronize()
            launches = {"paged_attention_hist": attention.KERNEL.launches,
                        "paged_attention_hist_int8":
                            attention.KERNEL.launches_int8}
            windows = [e.windows_dispatched - w0
                       for e, w0 in zip(engines, windows0)]
            for i, (e, r0, w) in enumerate(zip(engines, replays0, windows)):
                check_replays(e, r0, w)
                graph_stats(e, f"{mode} pass: worker {i}")
            spec = engines[0].runner.spec
            expected = sum(windows) * engines[0].decode_window \
                * spec.num_layers
            assert all(w > 0 for w in windows), windows
            assert launches["paged_attention_hist"] == expected, (
                launches, expected)
            assert launches["paged_attention_hist_int8"] == 0, launches
            wave2_hits = [e.prefix_hit_blocks - h
                          for e, h in zip(engines, hits_mid)]
            pass_hits = [e.prefix_hit_blocks - h
                         for e, h in zip(engines, hits0)]
            rows = []
            for body, res in zip(wave2_bodies, wave2):
                key = tuple(body["prompt"])
                times = tap.times[key]
                toks = tap.tokens[key]
                assert len(toks) == body["max_tokens"], (len(toks), body)
                rows.append({
                    "prefix": body["_prefix"], "round": body["_round"],
                    "seeded": "seed" in body,
                    "worker": tap.served_by[key],
                    "ttft_ms": (times[1] - times[0]) * 1e3,
                    "tpot_ms": (times[-1] - times[1]) / (len(toks) - 1) * 1e3,
                    "client_first_chunk_ms": res["summary"]["ttft_ms"]})
            n_tok = sum(r["summary"]["usage"]["completion_tokens"]
                        for r in wave2)
            out.update(
                windows=windows, window_steps=engines[0].decode_window,
                launches=launches, prefix_hit_blocks=pass_hits,
                wave2_hit_blocks=wave2_hits,
                total_hit_blocks=sum(pass_hits),
                wave1_s=wall1, wave2_s=wall2,
                wave2_tok_per_s=n_tok / wall2,
                wave2=rows,
                _tokens=[tap.tokens[tuple(b["prompt"])]
                         for b in wave2_bodies],
                _bodies=wave2_bodies)
            if mode == "kv":
                status = router.kv_status()
                got = status["decisions"]["recent"][-16:]
                assert router.decisions.decisions - decisions0 == 16
                for i, d in enumerate(got):
                    assert d["chosen"] == d["best"] \
                        >= KV_PREFIX_TOKENS // 16, (
                        f"wave 2 decision {i}: worker {d['worker']} chose "
                        f"overlap {d['chosen']} of best {d['best']}", got)
                for i, (row, body) in enumerate(zip(rows, wave2_bodies)):
                    want_worker = worker_of[holders[body["_prefix"]]]
                    assert row["worker"] == want_worker, (
                        f"wave 2 request {i} went to worker {row['worker']}, "
                        f"its prefix is on {want_worker}")
                # The three greedy requests of each of a worker's two
                # prefixes hit 64 blocks; a seeded request takes the
                # no-reuse path by design (engine._plan_prefill).
                for w, h in enumerate(wave2_hits):
                    assert h >= 6 * KV_PREFIX_TOKENS // 16, (w, wave2_hits)
                for wid in worker_of:
                    assert f"{wid:x}" in status["load"], (
                        "no ForwardPassMetrics from", wid, status["load"])
                    assert f"{wid:x}" in status["fleet"]["workers"], (
                        "no inventory digest from", wid)
                out.update(kv_status={k: status[k] for k in (
                    "index", "outcomes", "federation_sources")},
                    decisions=status["decisions"]["cache_aware_rate"])
            for r in rows:
                log(json.dumps({"kv_wave2_request": dict(r, mode=mode)}))
            log(f"{mode} pass: wave 2 {n_tok} tokens in {wall2:.2f}s "
                f"({n_tok / wall2:.1f} tok/s); prefix hit blocks "
                f"{pass_hits} (wave 2 {wave2_hits}); windows {windows}; "
                f"paged_attention_hist launches "
                f"{launches['paged_attention_hist']}")
            return out
        finally:
            tap.close()
            on_loop(down(st), 300)

    passes = {}
    try:
        engines = [kv_engine(), kv_engine()]
        spec = engines[0].runner.spec
        traffic = kv_traffic(spec)
        order: list[int] = []
        passes["kv"] = run_pass("kv", engines, traffic, order)
        for engine in engines:
            cleared = on_loop(engine.clear_kv_blocks())
            assert cleared > 0 and not engine.allocator.inactive, cleared
        passes["round_robin"] = run_pass("round_robin", engines, traffic,
                                         order)
        kv, rr = passes["kv"], passes["round_robin"]
        assert kv["total_hit_blocks"] > rr["total_hit_blocks"], (
            kv["total_hit_blocks"], rr["total_hit_blocks"])
        greedy = [i for i, b in enumerate(kv["_bodies"]) if "seed" not in b]
        prompts = [b["prompt"] for b in kv["_bodies"]]
        equal = greedy_agree(engines[0].runner, model, prompts,
                             kv["_tokens"], rr["_tokens"], rows=greedy)
        kv["greedy_equal_round_robin"] = [equal, len(greedy)]
        seeded = [i for i in range(len(prompts)) if i not in greedy]
        log(f"kv vs round robin: greedy ids equal in {equal}/{len(greedy)} "
            f"wave-2 requests (the rest split at a near-tie); seeded ids "
            f"kv {[kv['_tokens'][i][:8] for i in seeded]} round robin "
            f"{[rr['_tokens'][i][:8] for i in seeded]}")
        for engine in engines:
            engine.stop()
        del engines
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        loop.close()
    gc.collect()
    torch.cuda.empty_cache()
    sub = kv_routing_subprocesses()
    out = {"passes": {k: {x: y for x, y in v.items()
                          if not x.startswith("_")}
                      for k, v in passes.items()},
           "subprocesses": sub, "phase_s": time.monotonic() - t_phase}
    for k, v in out["passes"].items():
        log(json.dumps({"kv_routing_pass": {x: y for x, y in v.items()
                                            if x != "wave2"}}))
    log(f"phase 9: {out['phase_s']:.1f}s")
    return out


def kv_routing_subprocesses() -> dict:
    """KV routing as processes on the card: the coordinator, two ``python
    -m dynamo_tpu_torch.backends.gpu --model tiny-test`` workers (each
    must log an engine on cuda, no --device given) and ``python -m
    dynamo_tpu_torch.frontend --router-mode kv``; this process subscribes
    to the kv_events and load_metrics subjects. The same streamed chat
    goes twice: the second reaches the worker whose stored events hold
    the prompt's blocks (it hits them, and no other worker stores them),
    and all four exit 0 on SIGTERM."""
    import signal

    from dynamo_tpu_torch.llm.kv_router.protocols import (
        ForwardPassMetrics, RouterEvent, kv_events_subject,
        load_metrics_subject)
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.coordinator_client import CoordinatorClient

    procs = []
    t0 = time.monotonic()
    ns = RuntimeConfig.from_settings().namespace
    loop = thread = None
    try:
        coord = _spawn(procs, "dynamo_tpu_torch.runtime.coordinator",
                       "--host", "127.0.0.1", "--port", "0")
        cport = int(_wait_line(coord, "COORDINATOR_READY").rsplit("=", 1)[1])
        url = f"tcp://127.0.0.1:{cport}"
        stored: dict[int, set] = {}
        metrics: dict[int, ForwardPassMetrics] = {}
        loop = asyncio.new_event_loop()

        async def listen():
            client = await CoordinatorClient.connect("127.0.0.1", cport)
            ev = await client.subscribe(kv_events_subject(ns, "gpu"))
            lm = await client.subscribe(load_metrics_subject(ns, "gpu"))

            async def events():
                async for msg in ev:
                    e = RouterEvent.from_wire(msg["payload"])
                    if e.event.kind == "stored":
                        stored.setdefault(e.worker_id, set()).update(
                            e.event.block_hashes)

            async def loads():
                async for msg in lm:
                    m = ForwardPassMetrics.from_wire(msg["payload"])
                    metrics[m.worker_id] = m
            return client, [asyncio.ensure_future(events()),
                            asyncio.ensure_future(loads())]

        import threading
        thread = threading.Thread(target=loop.run_forever, daemon=True)
        thread.start()
        client, tasks = asyncio.run_coroutine_threadsafe(
            listen(), loop).result(60)
        common = ("--model", "tiny-test", "--num-pages", "1024",
                  "--coordinator-url", url)
        workers = [_spawn(procs, "dynamo_tpu_torch.backends.gpu", *common)
                   for _ in range(2)]
        front = _spawn(procs, "dynamo_tpu_torch.frontend", "--router-mode",
                       "kv", "--http-host", "127.0.0.1", "--http-port", "0",
                       "--coordinator-url", url)
        ready = [_wait_line(w, "GPU_WORKER_READY") for w in workers]
        wids = [int(r.split("worker=")[1].split()[0], 16) for r in ready]
        for w in workers:
            device = _wait_line(w, "from an engine on")
            assert "from an engine on cuda" in device, device
        port = int(_wait_line(front, "FRONTEND_READY").rsplit("=", 1)[1])
        deadline = time.monotonic() + 60
        while [m["id"] for m in http_call(port, "GET", "/v1/models")[
                "json"]["data"]] != ["tiny-test"]:
            assert time.monotonic() < deadline, "the model was not served"
            time.sleep(0.05)
        ready_s = time.monotonic() - t0
        body = {"model": "tiny-test", "stream": True, "max_tokens": 8,
                "ignore_eos": True, "stream_options": {"include_usage": True},
                "messages": [{"role": "user", "content": " ".join(
                    WORDS * 3)}]}

        def chat():
            res = http_call(port, "POST", "/v1/chat/completions", body)
            s = stream_summary(res)
            assert res["status"] == 200 and s["finish"] == "length", s
            assert s["usage"]["completion_tokens"] == 8, s
            return s

        first = chat()
        deadline = time.monotonic() + 10
        while not stored:
            assert time.monotonic() < deadline, "no kv event arrived"
            time.sleep(0.01)
        time.sleep(0.5)
        assert len(stored) == 1, stored
        holder, blocks = next(iter(stored.items()))
        assert holder in wids and len(blocks) >= 4, (holder, wids, blocks)
        second = chat()
        deadline = time.monotonic() + 10
        while not (holder in metrics and metrics[
                holder].kv_stats.gpu_prefix_cache_hit_rate > 0):
            assert time.monotonic() < deadline, (
                "the holder's metrics show no prefix hit", metrics)
            time.sleep(0.01)
        time.sleep(0.5)
        others = {w: hs & blocks for w, hs in stored.items() if w != holder}
        assert not any(others.values()), (
            "the second chat's blocks were stored on another worker", others)

        async def unlisten():
            for t in tasks:
                t.cancel()
            await client.close()
        asyncio.run_coroutine_threadsafe(unlisten(), loop).result(30)
        for proc, _, seen in (front, *workers, coord):
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=120)
            assert code == 0, (code, seen[-20:])
    finally:
        if loop is not None:
            loop.call_soon_threadsafe(loop.stop)
            thread.join(30)
        for proc, _, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    hit = metrics[holder].kv_stats.gpu_prefix_cache_hit_rate
    log(f"kv routing subprocesses: {ready[0]}; {ready[1]}; engines on cuda; "
        f"serving in {ready_s:.1f}s; the chat's {len(blocks)} blocks stored "
        f"on {holder:x}, the repeat went there (prefix hit rate {hit:.3f}); "
        f"all four exited 0 on SIGTERM")
    return {"ready_s": ready_s, "blocks": len(blocks),
            "holder_hit_rate": hit, "usage": [first["usage"],
                                              second["usage"]]}


# ---------------------------------------------------------------------------
# Phase 10: speculative decoding at full width
# ---------------------------------------------------------------------------

SPEC_K = 3
# Four greedy code-like prompts (the drafter's best case), two greedy
# random ones, one seeded at temperature 0.8 and one at 0.8 / top_p 0.9.
SPEC_CODE_LENS = (600, 900, 1200, 1500)
SPEC_RANDOM_LENS = (777, 1000)
SPEC_SAMPLED_LENS = (520, 1300)
SPEC_SEED = 4321


def code_like_prompt(rng, vocab: int, n: int) -> list[int]:
    """``n`` ids of a looping, code-like span: a block of 40-120 random ids
    (a function body) repeated, each copy with three ids renamed (its
    identifiers), as document and code completion sends."""
    block = rng.integers(0, vocab, int(rng.integers(40, 121)))
    out: list[int] = []
    while len(out) < n:
        copy = block.copy()
        copy[rng.choice(len(copy), 3, replace=False)] = rng.integers(
            0, vocab, 3)
        out.extend(copy.tolist())
    return out[:n]


def spec_requests(spec) -> tuple[list[dict], list[str]]:
    """Phase 10's eight requests and each one's kind."""
    from dynamo_tpu_torch.profile_decode import MAX_TOKENS
    rng = np.random.default_rng(SPEC_SEED)
    prompts, sampling, kinds = [], [], []
    for n in SPEC_CODE_LENS:
        prompts.append(code_like_prompt(rng, spec.vocab_size, n))
        sampling.append({})
        kinds.append("code")
    for n in SPEC_RANDOM_LENS:
        prompts.append(rng.integers(0, spec.vocab_size, n).tolist())
        sampling.append({})
        kinds.append("random")
    for n, s in zip(SPEC_SAMPLED_LENS, (
            {"temperature": 0.8, "seed": SPEC_SEED},
            {"temperature": 0.8, "top_p": 0.9})):
        prompts.append(code_like_prompt(rng, spec.vocab_size, n))
        sampling.append(s)
        kinds.append("seeded" if "seed" in s else "sampled")
    return ([{"model": spec.name, "token_ids": p,
              "stop_conditions": {"max_tokens": MAX_TOKENS,
                                  "ignore_eos": True},
              "sampling_options": s} for p, s in zip(prompts, sampling)],
            kinds)


def spec_engine():
    """A seed-0 llama-3-8b engine built as ``python -m
    dynamo_tpu_torch.backends.gpu --spec-decode ngram --spec-k 3`` builds
    it (warmup_windows set, DISAGG_PAGES pages, bf16 pool), with phase 3's
    prefill program size; started, so its spec program is captured."""
    import dataclasses

    from dynamo_tpu_torch.backends import gpu
    from dynamo_tpu_torch.launch import load_engine
    from dynamo_tpu_torch.profile_decode import MAX_PREFILL_TOKENS, MODEL
    args = gpu.parse_args(["--model", MODEL, "--seed", "0", "--device",
                           DEVICE, "--num-pages", str(DISAGG_PAGES),
                           "--spec-decode", "ngram",
                           "--spec-k", str(SPEC_K)])
    config = dataclasses.replace(gpu.build_engine_config(args),
                                 max_prefill_tokens=MAX_PREFILL_TOKENS)
    assert config.warmup_windows and config.spec_decode == "ngram", config
    t0 = time.monotonic()
    engine = load_engine(config, args.resolved_checkpoint, args.seed)
    log(f"spec engine: pages={engine.runner.num_pages} m_outer="
        f"{engine.spec_m_outer} k={SPEC_K} setup="
        f"{time.monotonic() - t0:.1f}s")
    return engine


def alone_spec_window(engine, rows: int = 8, hist: int = 1224):
    """(packed array, pages) of one spec window run alone on the stopped
    engine's runner over ``rows`` greedy rows whose history is ``hist``
    ids of a code-like span (seeded into hist_dev), each fed the span's
    next id by override, so the drafter finds its bigrams; the caller
    releases the pages."""
    from dynamo_tpu_torch.engine import runner as trunner
    runner, cfg = engine.runner, engine.config
    page, M = cfg.page_size, engine.decode_window
    per_row = -(-(hist + M) // page)
    pages = engine.allocator.allocate(rows * per_row)
    packed = np.zeros((cfg.max_num_seqs,
                       trunner.PK_PREFIX + runner.bucket_pages_for(per_row)),
                      np.int32)
    rng = np.random.default_rng(SPEC_SEED + 1)
    entries = []
    for i in range(rows):
        span = code_like_prompt(rng, runner.spec.vocab_size, hist + 1)
        entries.append((i, np.asarray(span[:hist], np.int32), 0, False,
                        None))
        packed[i, trunner.PK_OVERRIDE] = 1
        packed[i, trunner.PK_TOKEN] = span[hist]
        packed[i, trunner.PK_POS] = hist
        packed[i, trunner.PK_SEQLEN] = hist + 1
        packed[i, trunner.PK_TOPP] = np.float32(1.0).view(np.int32)
        packed[i, trunner.PK_CAP] = per_row * page
        packed[i, trunner.PK_PREFIX:trunner.PK_PREFIX + per_row] = \
            pages[i * per_row:(i + 1) * per_row]
    runner.seed_history(entries)
    return packed, pages


def time_spec_window(engine, reps: int = 7) -> dict:
    """Host ms (call to synchronised return) and device ms (CUDA events)
    of one spec window run alone (alone_spec_window), after one unmeasured
    run; then the device busy ms of one verify step (torch.profiler: the
    union of the device events over m_outer) and its top ops by device
    time."""
    from dynamo_tpu_torch.profile_decode import _busy_seconds
    runner, k = engine.runner, SPEC_K
    m_outer = engine.spec_m_outer
    packed, pages = alone_spec_window(engine)
    host, device = [], []
    try:
        runner.decode_spec_window(packed, m_outer, k)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            runner.decode_spec_window(packed, m_outer, k)
            end.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            device.append(start.elapsed_time(end))
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            runner.decode_spec_window(packed, m_outer, k)
            torch.cuda.synchronize()
    finally:
        engine.allocator.release(pages)
    intervals, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            intervals.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    if not intervals:
        raise RuntimeError("the profiler recorded no device activity")
    step_ms = _busy_seconds(intervals) * 1e3 / m_outer
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = {"rows": 8, "hist": 1224, "m_outer": m_outer, "k": k,
           "window_ms_median": sorted(host)[len(host) // 2],
           "window_device_ms_median": sorted(device)[len(device) // 2],
           "window_ms": host, "window_device_ms": device,
           "verify_step_device_ms": step_ms,
           "top_ops_device_ms_per_step": [(n[:80], t / m_outer)
                                          for n, t in top]}
    log(f"spec window alone (8 rows x 1224 tokens, m_outer={m_outer}, "
        f"k={k}): {out['window_ms_median']:.2f} ms "
        f"(device {out['window_device_ms_median']:.2f}); verify step "
        f"{step_ms:.2f} device ms")
    return out


def spec_replay_check(engine) -> None:
    """One spec window run alone (alone_spec_window), replayed from its
    program's graph, then its body run eagerly on the same state
    (tokens_dev, positions_dev, hist_dev and the noise step put back):
    tokens, emitted counts and drafts equal, and the chained state after
    both equal; some row drafted."""
    from dynamo_tpu_torch.engine.runner import PK_PREFIX
    runner = engine.runner
    packed, pages = alone_spec_window(engine)
    key = ("spec", engine.spec_m_outer, SPEC_K, packed.shape[1] - PK_PREFIX)
    state = (runner.tokens_dev, runner.positions_dev, runner.hist_dev,
             runner._noise_step)
    try:
        before = [t.clone() for t in state]
        replays0 = runner.window_replays
        replayed = [t.clone() for t in runner.decode_spec_window(
            packed, engine.spec_m_outer, SPEC_K)]
        assert runner.window_replays == replays0 + 1
        after = [t.clone() for t in state]
        for t, b in zip(state, before):
            t.copy_(b)
        eager = runner._window_cache[key].run_eager(packed)
        torch.cuda.synchronize()
    finally:
        engine.allocator.release(pages)
    for name, a, b in zip(("tokens", "emitted", "drafts"), replayed, eager):
        assert torch.equal(a, b), (name, a, b)
    for a, t in zip(after, state):
        assert torch.equal(a, t)
    assert int(replayed[2].sum()) > 0, "no row drafted"
    log(f"replayed spec window vs its eager body (key {key}): tokens, "
        f"emitted counts and drafts equal; emitted per step "
        f"{replayed[1][:, :8].tolist()}")


def verify_forced_check(runner, model, attention, prompt, tokens) -> float:
    """Two verify blocks at full width on a private bf16 pool holding
    ``prompt``: tokens[0:4] at positions n..n+3 with an empty window
    buffer, then tokens[4:8] with the first block's K/V in the buffer
    (wlen 4), each through the kernel route and the plain route (logits
    within LOGIT_ATOL), and both against the single-step teacher-forced
    plain path's logits of the same positions (plain_forced_logits).
    Returns the largest difference."""
    spec, cfg, dev = runner.spec, runner.config, runner.device
    page, n, S = cfg.page_size, len(prompt), SPEC_K + 1
    bucket = cfg.bucket_for(n)
    pages = bucket // page + 2
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
    single = plain_forced_logits(runner, model, prompt, tokens[:2 * S + 1],
                                 quant=False)
    hist = torch.tensor([n], dtype=torch.int32, device=dev)
    kbuf = torch.zeros((spec.num_layers, spec.num_kv_heads, 1, 2 * S,
                        spec.head_dim), dtype=torch.bfloat16, device=dev)
    vbuf = torch.zeros_like(kbuf)
    worst = 0.0
    for blk in range(2):
        args = (runner.params, spec, kc, vc, kbuf, vbuf,
                torch.tensor([blk * S], dtype=torch.int32, device=dev),
                torch.tensor([tokens[blk * S:(blk + 1) * S]],
                             dtype=torch.int32, device=dev),
                (n + blk * S + torch.arange(S, device=dev))[None].to(
                    torch.int32), table, hist)
        lk, k_new, v_new = model.decode_window_multi_step(
            *args, attention_impl=attention.paged_verify_attention)
        lp, _, _ = model.decode_window_multi_step(*args)
        kbuf[:, :, 0, blk * S:(blk + 1) * S] = k_new[:, 0].transpose(1, 2)
        vbuf[:, :, 0, blk * S:(blk + 1) * S] = v_new[:, 0].transpose(1, 2)
        for j in range(S):
            ref = single[blk * S + j + 1]
            for lg in (lk[0, j], lp[0, j]):
                assert torch.isfinite(lg).all()
                worst = max(worst, float((lg - ref).abs().max()))
            worst = max(worst, float((lk[0, j] - lp[0, j]).abs().max()))
    assert worst <= LOGIT_ATOL, worst
    return worst


def spec_phase(attention, model, decode_step_ms: float) -> dict:
    """Phase 10 (see the module docstring)."""
    import collections

    from dynamo_tpu_torch.profile_decode import MAX_TOKENS, serve
    t_phase = time.monotonic()
    engine = spec_engine()
    runner, spec = engine.runner, engine.runner.spec
    warm = graph_stats(engine, "spec engine after its warmup")
    assert list(runner._window_cache) == [
        ("spec", engine.spec_m_outer, SPEC_K, runner.bucket_pages_for(1))], \
        list(runner._window_cache)
    requests, kinds = spec_requests(spec)
    prompts = [r["token_ids"] for r in requests]
    # Verify steps that emitted, tokens they emitted and drafts accepted,
    # on the device, for each request's slot (by prompt).
    steps, emitted, accepted = (collections.Counter() for _ in range(3))
    walk = engine._process_spec_window

    def tap(w, outs, emits, ndrafts):
        for i, snap in enumerate(w.slots):
            if snap is not None:
                key, e = tuple(snap[0].req.token_ids[:32]), emits[:, i]
                steps[key] += int((e > 0).sum())
                emitted[key] += int(e.sum())
                accepted[key] += int((e[ndrafts[:, i] > 0] - 1).clip(
                    min=0).sum())
        return walk(w, outs, emits, ndrafts)

    engine._process_spec_window = tap
    counters0 = (engine.spec_drafts, engine.spec_tokens, engine.spec_accepted,
                 list(engine.spec_emit_hist))
    windows0, replays0 = engine.windows_dispatched, runner.window_replays
    attention.KERNEL.launches = 0
    attention.KERNEL.launches_int8 = 0
    try:
        t0 = time.monotonic()
        results = asyncio.run(serve(engine, requests))
        wall = time.monotonic() - t0
        torch.cuda.synchronize()
        launches = {"paged_attention_hist": attention.KERNEL.launches,
                    "paged_attention_hist_int8":
                        attention.KERNEL.launches_int8}
    finally:
        del engine._process_spec_window
        engine.stop()
    windows = engine.windows_dispatched - windows0
    check_replays(engine, replays0, windows)
    assert all(key[0] == "spec" for key in runner._window_cache), \
        list(runner._window_cache)
    for i, r in enumerate(results):
        assert r["finish"] == "length", (i, r["finish"])
        assert len(r["tokens"]) == MAX_TOKENS, (i, len(r["tokens"]))
        assert all(0 <= t < spec.vocab_size for t in r["tokens"])
    expected = windows * engine.spec_m_outer * spec.num_layers
    assert launches["paged_attention_hist"] == expected and expected > 0, (
        launches, expected)
    assert launches["paged_attention_hist_int8"] == 0, launches
    drafts = engine.spec_drafts - counters0[0]
    draft_tokens = engine.spec_tokens - counters0[1]
    accepted_total = engine.spec_accepted - counters0[2]
    hist = [a - b for a, b in zip(engine.spec_emit_hist, counters0[3])]
    code_accepted = sum(accepted[tuple(p[:32])]
                        for p, kind in zip(prompts, kinds) if kind == "code")
    assert code_accepted > 0, ("no draft accepted on the code-like prompts",
                               dict(accepted))
    # Greedy ids against the teacher-forced plain path's argmax: equal, or
    # at a near-tie (top-2 margin within 2 x LOGIT_ATOL).
    agree, total = 0, 0
    for p, r, kind in zip(prompts, results, kinds):
        if kind not in ("code", "random"):
            continue
        logits = plain_forced_logits(runner, model, p, r["tokens"],
                                     quant=False)
        for j, (tok, lg) in enumerate(zip(r["tokens"], logits)):
            total += 1
            if int(lg.argmax()) == tok:
                agree += 1
                continue
            top2 = torch.topk(lg, 2).values
            margin = float(top2[0] - top2[1])
            assert margin <= 2 * LOGIT_ATOL, (
                f"{kind} request, token {j}: {tok} is not the plain path's "
                f"argmax {int(lg.argmax())} (margin {margin})")
    code = next(i for i, kind in enumerate(kinds) if kind == "code")
    verify_diff = verify_forced_check(runner, model, attention, prompts[code],
                                      results[code]["tokens"])
    log(f"verify blocks at full width, kernel route vs plain route vs "
        f"single-step plain path: max|logit diff| {verify_diff:.4f} "
        f"(tolerance {LOGIT_ATOL})")
    timing = time_spec_window(engine)
    spec_replay_check(engine)
    ttft = sorted(r["ttft_s"] * 1e3 for r in results)
    tpot = sorted((r["total_s"] - r["ttft_s"]) / (len(r["tokens"]) - 1)
                  * 1e3 for r in results)
    n_tok = sum(len(r["tokens"]) for r in results)
    out = {"requests": len(results), "kinds": kinds, "tokens": n_tok,
           "wall_s": wall, "tok_per_s": n_tok / wall,
           "ttft_ms_median": ttft[len(ttft) // 2], "ttft_ms_max": ttft[-1],
           "tpot_ms_median": tpot[len(tpot) // 2], "tpot_ms_max": tpot[-1],
           "windows": windows, "m_outer": engine.spec_m_outer, "k": SPEC_K,
           "launches": launches, "kernel_launches": expected,
           "verify_steps_with_drafts": drafts,
           "draft_tokens": draft_tokens, "accepted_tokens": accepted_total,
           "acceptance_rate": (accepted_total / draft_tokens
                               if draft_tokens else None),
           "emit_hist": hist,
           "by_kind": {k: {name: sum(c[tuple(p[:32])]
                                     for p, kk in zip(prompts, kinds)
                                     if kk == k)
                               for name, c in (("verify_steps", steps),
                                               ("tokens", emitted),
                                               ("accepted", accepted))}
                       for k in sorted(set(kinds))},
           "greedy_tokens_at_plain_argmax": f"{agree}/{total}",
           "verify_forced_max_abs_diff": verify_diff,
           "phase3_decode_step_device_ms": decode_step_ms,
           **timing,
           "program": {k: warm[k] for k in ("capture_s",
                                             "graph_pool_bytes",
                                             "warmup_s")}}
    out["tokens_per_verify_step"] = {
        k: v["tokens"] / v["verify_steps"]
        for k, v in out["by_kind"].items() if v["verify_steps"]}
    log(f"phase 10: {n_tok / wall:.1f} tok/s, TTFT median "
        f"{out['ttft_ms_median']:.0f} ms, TPOT median "
        f"{out['tpot_ms_median']:.2f} ms; acceptance "
        f"{accepted_total}/{draft_tokens}, emit histogram {hist}, tokens "
        f"per verify step {out['tokens_per_verify_step']}; verify "
        f"step {timing['verify_step_device_ms']:.2f} device ms against a "
        f"decode step's {decode_step_ms:.2f} (phase 3)")
    del engine, runner
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.monotonic() - t_phase
    log(json.dumps({"spec_phase": out}))
    log(f"phase 10: {out['phase_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# Phase 11: batched LoRA at full width
# ---------------------------------------------------------------------------

LORA_SEED = 2468
ATTN_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj")
ALL_TARGETS = ATTN_TARGETS + ("gate_proj", "up_proj", "down_proj")
# name -> (rank, lora_alpha, PEFT target modules): a and b on every
# target, c (alpha != r) on attention only.
LORA_ADAPTERS = {"a": (8, 16.0, ALL_TARGETS), "b": (16, 32.0, ALL_TARGETS),
                 "c": (4, 12.0, ATTN_TARGETS)}
LORA_MAX_ADAPTERS = 2
# Slots of the rows of the decode step whose deltas are held to a per-row
# gather, and the bound on |delta - gather| relative to the delta's
# largest entry: the two differ only where a bf16 rounding of u or of the
# output falls the other way (2^-8 of an entry).
LORA_DELTA_IDS = (0, 1, 2, 1, 2, 0, 2, 1)
LORA_DELTA_RTOL = 2e-2
LORA_MAX_RANK = 16
# Round A on round 1's prompts: 3 base, 3 on a, 2 on b; the first six
# greedy, then one at temperature 0.8 / top_p 0.9 and one seeded at 0.8.
LORA_ROUND_A = (None, "a", "b", None, "a", "b", "a", None)
LORA_ROUND_A_SAMPLING = [{}] * 6 + [{"temperature": 0.8, "top_p": 0.9},
                                    {"temperature": 0.8, "seed": 1234}]
# Round B: a fresh prompt on c (hot-loaded into the slot LRU frees) and
# one on a.
LORA_ROUND_B = (("c", 900), ("a", 600))


def write_peft_adapter(directory: str, spec, rank: int, alpha: float,
                       targets, seed: int) -> int:
    """A HF PEFT LoRA adapter for ``spec`` in ``directory``
    (adapter_config.json, and adapter_model.safetensors under PEFT's
    tensor names, written by the port's safetensors_lite): A ~ N(0, 1 /
    d_in) and B ~ N(0, 1 / r) / 4 in bf16 from ``seed``, so each delta is
    about half its projection's output at alpha / r = 2. Returns the
    tensors' bytes."""
    import os

    from dynamo_tpu_torch.engine import safetensors_lite
    os.makedirs(directory)
    with open(os.path.join(directory, "adapter_config.json"), "w") as fh:
        json.dump({"peft_type": "LORA", "r": rank, "lora_alpha": alpha,
                   "target_modules": list(targets)}, fh)
    h, i = spec.hidden_size, spec.intermediate_size
    q, kv = spec.num_heads * spec.head_dim, spec.num_kv_heads * spec.head_dim
    dims = {"q_proj": (h, q), "k_proj": (h, kv), "v_proj": (h, kv),
            "o_proj": (q, h), "gate_proj": (h, i), "up_proj": (h, i),
            "down_proj": (i, h)}
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    tensors = {}
    for li in range(spec.num_layers):
        for mod in targets:
            d_in, d_out = dims[mod]
            block = "self_attn" if mod in ATTN_TARGETS else "mlp"
            base = f"base_model.model.model.layers.{li}.{block}.{mod}"
            tensors[f"{base}.lora_A.weight"] = (torch.randn(
                (rank, d_in), generator=gen, device=DEVICE)
                / d_in ** 0.5).to(torch.bfloat16)
            tensors[f"{base}.lora_B.weight"] = (torch.randn(
                (d_out, rank), generator=gen, device=DEVICE)
                / (4 * rank ** 0.5)).to(torch.bfloat16)
    safetensors_lite.save_file(tensors, os.path.join(
        directory, "adapter_model.safetensors"))
    return sum(t.numel() * t.element_size() for t in tensors.values())


def lora_engine(dirs: dict):
    """A seed-0 llama-3-8b engine built as ``python -m
    dynamo_tpu_torch.backends.gpu --lora a=... --lora b=... --lora c=...
    --max-adapters 2 --max-lora-rank 16`` builds it (bf16 pool of
    DISAGG_PAGES pages, warmup_windows set), with phase 3's prefill
    program size: weights loaded, the adapters registered, then started
    (the warmup captures). Returns it and the registration seconds."""
    import dataclasses

    from dynamo_tpu_torch.backends import gpu
    from dynamo_tpu_torch.launch import load_engine, lora_args
    from dynamo_tpu_torch.profile_decode import MAX_PREFILL_TOKENS, MODEL
    argv = ["--model", MODEL, "--seed", "0", "--device", DEVICE,
            "--num-pages", str(DISAGG_PAGES), "--max-adapters",
            str(LORA_MAX_ADAPTERS), "--max-lora-rank", str(LORA_MAX_RANK)]
    for name, directory in dirs.items():
        argv += ["--lora", f"{name}={directory}"]
    args = gpu.parse_args(argv)
    config = dataclasses.replace(gpu.build_engine_config(args),
                                 max_prefill_tokens=MAX_PREFILL_TOKENS)
    assert config.warmup_windows and (config.max_adapters,
                                      config.lora_max_rank) == (
        LORA_MAX_ADAPTERS, LORA_MAX_RANK), config
    engine = load_engine(config, args.resolved_checkpoint, args.seed,
                         start=False)
    t0 = time.monotonic()
    for name, path in lora_args(args):
        engine.register_adapter(name, path=path)
    register_s = time.monotonic() - t0
    engine.start()
    return engine, register_s


def lora_request(spec, prompt, adapter, sampling=None) -> dict:
    from dynamo_tpu_torch.profile_decode import MAX_TOKENS
    return {"model": spec.name, "token_ids": prompt, "adapter": adapter,
            "stop_conditions": {"max_tokens": MAX_TOKENS},
            "sampling_options": sampling or {}}


def lora_served(engine, attention, run) -> tuple:
    """``run()`` (a coroutine function serving requests on ``engine``)
    with the kernel counts from 0: (its results, wall seconds, launches,
    windows). Checks that every window replayed its graph, every request
    finished at MAX_TOKENS, and every step of every layer launched the
    bf16 entry and never the int8 one."""
    from dynamo_tpu_torch.profile_decode import MAX_TOKENS
    attention.KERNEL.launches = 0
    attention.KERNEL.launches_int8 = 0
    windows0, replays0 = engine.windows_dispatched, engine.runner.window_replays
    t0 = time.monotonic()
    results = asyncio.run(run())
    wall = time.monotonic() - t0
    torch.cuda.synchronize()
    launches = {"paged_attention_hist": attention.KERNEL.launches,
                "paged_attention_hist_int8": attention.KERNEL.launches_int8}
    windows = engine.windows_dispatched - windows0
    check_replays(engine, replays0, windows)
    for i, r in enumerate(results):
        assert r["finish"] == "length", (i, r["finish"])
        assert len(r["tokens"]) == MAX_TOKENS, (i, len(r["tokens"]))
    expected = windows * engine.decode_window * engine.runner.spec.num_layers
    assert launches["paged_attention_hist"] == expected and expected > 0, (
        launches, expected)
    assert launches["paged_attention_hist_int8"] == 0, launches
    return results, wall, launches, windows


def adapter_rows_check(runner, model, prompts, results, adapters,
                       slots) -> str:
    """Each greedy adapter row's ids against the argmax of the
    teacher-forced plain path through its adapter's slot (eager, no
    graph): equal, or at a near-tie (top-2 margin within 2 x
    LOGIT_ATOL)."""
    agree = total = 0
    for p, r, name in zip(prompts, results, adapters):
        if name is None:
            continue
        logits = plain_forced_logits(runner, model, p, r["tokens"],
                                     quant=False, slot=slots[name])
        for j, (tok, lg) in enumerate(zip(r["tokens"], logits)):
            total += 1
            if int(lg.argmax()) == tok:
                agree += 1
                continue
            top2 = torch.topk(lg, 2).values
            margin = float(top2[0] - top2[1])
            assert margin <= 2 * LOGIT_ATOL, (
                f"adapter {name}, token {j}: {tok} is not the plain path's "
                f"argmax {int(lg.argmax())} (margin {margin})")
    return f"{agree}/{total}"


def gathered_delta(x, ll: dict, ids: list[int]) -> torch.Tensor:
    """``x @ A[id] @ B[id]`` row by row, as the reference's gathered
    einsums compute it: u = x A[id] with fp32 accumulation, rounded to
    bf16, then u B[id] in bf16 (no use of model.lora_delta)."""
    rows = []
    for i, sid in enumerate(ids):
        u = (x[i:i + 1].float() @ ll["a"][sid].float()).to(x.dtype)
        rows.append(u @ ll["b"][sid])
    return torch.cat(rows)


def delta_check(runner, model, attention, args) -> dict:
    """Every LoRA delta of one eager decode step (``args`` as
    decode_window_step takes them) with rows on LORA_DELTA_IDS: each call
    of model.lora_delta is recorded with its inputs and held to
    ``gathered_delta`` on the same inputs."""
    ids = list(LORA_DELTA_IDS)
    calls, lora_delta = [], model.lora_delta

    def recording(x, ll, rows):
        out = lora_delta(x, ll, rows)
        calls.append((x, ll, out))
        return out
    model.lora_delta = recording
    try:
        model.decode_window_step(
            *args, attention_impl=attention.paged_window_attention,
            lora=runner.lora, adapter_ids=torch.tensor(
                ids, dtype=torch.int32, device=runner.device))
    finally:
        model.lora_delta = lora_delta
    assert len(calls) == len(runner.lora) * runner.spec.num_layers, len(calls)
    base = torch.tensor([i == 0 for i in ids], device=runner.device)
    worst = 0.0
    for x, ll, out in calls:
        want = gathered_delta(x, ll, ids).float()
        scale = float(want.abs().max())
        err = float((out.float() - want).abs().max())
        assert scale > 0 and err <= LORA_DELTA_RTOL * scale, (err, scale)
        assert not out[base].any(), "a slot-0 row's delta is not zero"
        worst = max(worst, err / scale)
    log(f"LoRA deltas of one decode step (rows on slots {ids}): "
        f"{len(calls)} calls equal a per-row gather within "
        f"{worst:.2e} of each delta's largest entry (bound "
        f"{LORA_DELTA_RTOL}); slot-0 rows zero")
    return {"calls": len(calls), "max_rel_err": worst}


def slot0_check(engine, model, attention) -> dict:
    """Slot 0 against a runner built without adapters on the same
    parameter tensors and the same pool (no second copy of either): one
    decode step of 8 rows (alone_window) through the model with the LoRA
    stacks and ids 0 gives the same logits bit for bit; the same window
    (one logprobs row, all rows on slot 0) replayed from each runner's
    program gives the same tokens, logprobs and top-8. Also times a
    decode step of that window with all 8 rows on adapters (slots 1 and
    2 in turns) against the base runner's (torch.profiler), which is the
    LoRA ops' cost. Returns the numbers and the base runner."""
    import dataclasses

    from dynamo_tpu_torch.engine import runner as trunner
    runner, M = engine.runner, engine.decode_window
    spec, dev = runner.spec, runner.device
    base = trunner.ModelRunner(dataclasses.replace(
        engine.config, max_adapters=0, num_pages=16, warmup_windows=False),
        params=runner.params)
    base.k_cache, base.v_cache = runner.k_cache, runner.v_cache
    packed, pages = alone_window(engine, 8, 1224)
    packed[1, trunner.PK_LOGPROB] = 1
    try:
        # One step through the model, eager, with and without the stacks.
        table = torch.from_numpy(packed[:8, trunner.PK_PREFIX:]).to(dev)
        hist = torch.full((8,), 1224, dtype=torch.int32, device=dev)
        kbuf = torch.zeros((spec.num_layers, spec.num_kv_heads, 8, M,
                            spec.head_dim), dtype=torch.bfloat16, device=dev)
        args = (runner.params, spec, runner.k_cache, runner.v_cache, kbuf,
                torch.zeros_like(kbuf), 0,
                torch.arange(8, dtype=torch.int32, device=dev) * 97
                % spec.vocab_size,
                hist.clone(), table, hist)
        with_lora = model.decode_window_step(
            *args, attention_impl=attention.paged_window_attention,
            lora=runner.lora, adapter_ids=torch.zeros(
                8, dtype=torch.int32, device=dev))
        without = model.decode_window_step(
            *args, attention_impl=attention.paged_window_attention)
        for a, b in zip(with_lora, without):
            assert torch.equal(a, b), "slot 0 is not the base model"
        deltas = delta_check(runner, model, attention, args)
        # The same window through both runners' programs.
        outs = [[t.clone() for t in r.decode_window(packed, M)]
                for r in (runner, base)]
        torch.cuda.synchronize()
        for a, b in zip(*outs):
            assert torch.equal(a, b), "slot-0 window differs from the base"
        # In turns: base, every row on an adapter, base.
        base_ms, _ = profiled_step_ms(base, packed, M)
        packed[:8, trunner.PK_ADAPTER] = [1, 2] * 4
        lora_ms, top = profiled_step_ms(runner, packed, M)
        packed[:, trunner.PK_ADAPTER] = 0
        base_again, _ = profiled_step_ms(base, packed, M)
    finally:
        engine.allocator.release(pages)
    out = {"step_device_ms_8_rows_on_adapters": lora_ms,
           "step_device_ms_base_runner": [base_ms, base_again],
           "lora_ops_device_ms": lora_ms - min(base_ms, base_again),
           "lora_ops_share": (lora_ms - min(base_ms, base_again)) / lora_ms,
           "top_ops_device_ms_per_step": top, "delta_check": deltas}
    log(f"slot 0: one decode step's logits with the LoRA stacks (ids 0) "
        f"and without are equal bit for bit; a window replayed by this "
        f"runner and by a runner without adapters on the same tensors "
        f"gives the same tokens and logprobs. Decode step, 8 rows x 1224 "
        f"tokens: {lora_ms:.3f} device ms with every row on an adapter "
        f"against {base_ms:.3f} / {base_again:.3f} without LoRA "
        f"(LoRA ops {out['lora_ops_device_ms']:.3f} ms, "
        f"{out['lora_ops_share']:.1%})")
    return out


def hot_load_times(engine, reps: int = 3) -> dict:
    """ms of one hot-load of adapter b (rank 16, every target) into a
    free slot: ``AdapterStore.acquire`` from its call until the device
    copies are done (set_adapter_slot: page-locked staging and the host
    to device copies), ``reps`` times, evicting b in between."""
    store = engine.adapters
    full = store._full_weights("b")
    nbytes = sum(t.numel() * t.element_size() for pair in full.values()
                 for t in pair)
    times = []
    for _ in range(reps):
        for name, slot in list(store.status()["resident"].items()):
            if slot == LORA_MAX_ADAPTERS:
                assert store.evict(name), name
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slot = store.acquire("b")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        store.release("b")
        assert slot == LORA_MAX_ADAPTERS, slot
    got = engine.runner.lora["w_down"]["b"][:, slot]
    assert torch.equal(got.cpu(), full["w_down"][1]), "slot content"
    out = {"ms": times, "ms_median": sorted(times)[len(times) // 2],
           "bytes": nbytes}
    log(f"hot-load of b (rank {LORA_MAX_RANK}, {nbytes / 1e6:.1f} MB host "
        f"to device): {out['ms_median']:.2f} ms median of {times}")
    return out


def lora_phase(attention, model, ref: dict, decode_step_ms: float) -> dict:
    """Phase 11 (see the module docstring)."""
    import shutil
    import tempfile

    from dynamo_tpu_torch.profile_decode import MODEL, serve
    from dynamo_tpu_torch.runtime.errors import (AdapterNotFoundError,
                                                 OverloadedError)
    t_phase = time.monotonic()
    from dynamo_tpu_torch.engine.config import PRESETS
    spec = PRESETS[MODEL]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lora_")
    try:
        dirs, written = {}, {}
        for i, (name, (rank, alpha, targets)) in enumerate(
                LORA_ADAPTERS.items()):
            dirs[name] = f"{tmp}/{name}"
            written[name] = write_peft_adapter(dirs[name], spec, rank, alpha,
                                               targets, LORA_SEED + i)
        engine, register_s = lora_engine(dirs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runner = engine.runner
    warm = graph_stats(engine, "LoRA engine after its warmup")
    log(f"LoRA engine: stacks {runner.lora_bytes} bytes "
        f"({runner.lora_bytes / 2**20:.1f} MiB, {LORA_MAX_ADAPTERS + 1} "
        f"slots x rank {LORA_MAX_RANK}); adapters written "
        f"{ {k: v / 1e6 for k, v in written.items()} } MB, registered in "
        f"{register_s:.2f} s")
    prompts = round1_prompts(spec)
    requests = [lora_request(spec, p, a, s) for p, a, s in zip(
        prompts, LORA_ROUND_A, LORA_ROUND_A_SAMPLING)]
    try:
        results, wall, launches_a, windows_a = lora_served(
            engine, attention, lambda: serve(engine, requests))
    finally:
        engine.stop()
    status = engine.adapters.status()
    assert status["resident"] == {"a": 1, "b": 2}, status
    # Slot-0 rows: bit-identical to a runner without adapters (this also
    # captures the logprobs window program that the replay check below
    # replays after round B's hot-load), and the greedy base rows at
    # phase 3's ids or split at a near-tie; the greedy adapter rows at the
    # teacher-forced plain path's argmax through their slots.
    slot0 = slot0_check(engine, model, attention)
    base_rows = [i for i in range(6) if LORA_ROUND_A[i] is None]
    base_equal = greedy_agree(runner, model, prompts,
                              [r["tokens"] for r in results], ref["tokens"],
                              rows=base_rows)
    rows = [i for i in range(6) if LORA_ROUND_A[i] is not None]
    agree_a = adapter_rows_check(
        runner, model, [prompts[i] for i in rows],
        [results[i] for i in rows], [LORA_ROUND_A[i] for i in rows],
        status["resident"])
    # Round B: c hot-loads into the slot LRU frees (b's: a was used last)
    # while a decodes beside it; meanwhile b finds both slots held, and an
    # unknown name is refused.
    rng = np.random.default_rng(LORA_SEED)
    b_prompts = [rng.integers(0, spec.vocab_size, n).tolist()
                 for _, n in LORA_ROUND_B]
    b_requests = [lora_request(spec, p, a) for p, (a, _) in zip(
        b_prompts, LORA_ROUND_B)]
    refused = {}

    async def round_b():
        task = asyncio.ensure_future(serve(engine, b_requests))
        while set(engine.adapters.status()["active_refs"]) != {"a", "c"}:
            assert not task.done(), "round B ended before both were held"
            await asyncio.sleep(0.002)
        for name, exc_type in (("b", OverloadedError),
                               ("nobody", AdapterNotFoundError)):
            try:
                await serve(engine, [lora_request(spec, b_prompts[1],
                                                  name)])
            except exc_type as exc:
                refused[name] = f"{type(exc).__name__}: {exc}"
        return await task

    engine.start()
    try:
        results_b, wall_b, launches_b, windows_b = lora_served(
            engine, attention, round_b)
    finally:
        engine.stop()
    assert set(refused) == {"b", "nobody"}, refused
    status = engine.adapters.status()
    assert status["resident"] == {"a": 1, "c": 2}, status
    assert (status["loads_total"], status["evictions_total"]) == (3, 1), \
        status
    log(f"round B: c hot-loaded into slot 2 (b evicted); refused: "
        f"{refused}")
    agree_b = adapter_rows_check(runner, model, b_prompts, results_b,
                                 [a for a, _ in LORA_ROUND_B],
                                 status["resident"])
    # The program slot0_check captured before the hot-load, replayed with
    # rows on a and c, against its body run eagerly.
    replay_diff = replay_check(engine, adapter_ids=[1, 2] * 4)
    hot = hot_load_times(engine)
    ttft = sorted(r["ttft_s"] * 1e3 for r in results)
    tpot = sorted((r["total_s"] - r["ttft_s"]) / (len(r["tokens"]) - 1)
                  * 1e3 for r in results)
    n_tok = sum(len(r["tokens"]) for r in results)
    out = {"requests": len(results), "adapters": list(LORA_ROUND_A),
           "tokens": n_tok, "wall_s": wall, "tok_per_s": n_tok / wall,
           "ttft_ms_median": ttft[len(ttft) // 2], "ttft_ms_max": ttft[-1],
           "tpot_ms_median": tpot[len(tpot) // 2], "tpot_ms_max": tpot[-1],
           "windows": windows_a, "launches": launches_a,
           "round_b": {"windows": windows_b, "launches": launches_b,
                       "wall_s": wall_b, "refused": refused},
           "launches_total": {k: launches_a[k] + launches_b[k]
                              for k in launches_a},
           "base_rows_equal_phase3": f"{base_equal}/{len(base_rows)}",
           "greedy_at_plain_argmax": {"round_a": agree_a,
                                      "round_b": agree_b},
           "replay_vs_eager_after_hot_load_max_abs_logprob_diff":
               replay_diff,
           "phase3_decode_step_device_ms": decode_step_ms, **slot0,
           "hot_load": hot, "stacks_bytes": runner.lora_bytes,
           "adapter_bytes": written, "register_s": register_s,
           "program": {k: warm[k] for k in ("capture_s", "graph_pool_bytes",
                                             "warmup_s")}}
    log(f"phase 11: {n_tok / wall:.1f} tok/s, TTFT median "
        f"{out['ttft_ms_median']:.0f} ms, TPOT median "
        f"{out['tpot_ms_median']:.2f} ms; base rows equal to phase 3 "
        f"{out['base_rows_equal_phase3']}; greedy adapter ids at the plain "
        f"argmax "
        f"{out['greedy_at_plain_argmax']}; decode step with 8 adapter rows "
        f"{slot0['step_device_ms_8_rows_on_adapters']:.3f} device ms "
        f"against phase 3's {decode_step_ms:.3f}")
    del engine, runner
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.monotonic() - t_phase
    log(json.dumps({"lora_phase": out}))
    log(f"phase 11: {out['phase_s']:.1f}s")
    return out


def kernel_entry(name, variant, timing, main, max_err, stats,
                 http_launches, dist_launches, ckpt_launches,
                 disagg_launches, kv_launches, verify, spec_launches,
                 lora_launches) -> dict:
    """One kernel's summary: times at the B=32 x 2048 shape, and the same
    numbers at the main path's mid-round shape under ``main_shape``;
    launches in round 1, round 2, the HTTP phase, the distributed phase,
    phase 7's round-1 runs on loaded checkpoints, phase 8's passes (on
    the decode worker), phase 9's passes (both workers), phase 10's
    spec round (the verify route) and phase 11's LoRA rounds A and B;
    the verify route's numbers at both
    shapes under ``verify_route`` (``verify``: its check's error and the
    two timings)."""
    return {"name": name, "route": "cuda",
            "source": "dynamo_tpu_torch/csrc/paged_attention.cu",
            "replaces": "dynamo_tpu/engine/attention.py:72",
            "variant": variant, "launches": stats["kernel_launches"],
            "launches_round2": stats["round2"]["kernel_launches"],
            "launches_http": http_launches,
            "launches_dist": dist_launches,
            "launches_checkpoint": ckpt_launches,
            "launches_disagg": disagg_launches,
            "launches_kv_routing": kv_launches,
            "launches_spec": spec_launches,
            "launches_lora": lora_launches,
            "max_abs_err": max(max_err, timing["max_abs_err"],
                               main["max_abs_err"], verify["err"],
                               verify["uniform"]["max_abs_err"],
                               verify["main"]["max_abs_err"]),
            "ms": timing["ms"], "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
            "library_ms": timing["library_ms"],
            "eager_ms": timing["eager_ms"], "host_ms": timing["host_ms"],
            "main_shape": {k: main[k] for k in (
                "ms", "eager_ms", "host_ms", "plain_ms", "bound_ms",
                "bound_by", "splits", "sdpa_per_row_ms")}
            | {"sdpa_ms": main.get("library_ms") or main["sdpa_bf16_ms"]},
            "verify_route": {shape: {k: v for k, v in verify[shape].items()
                                     if k != "shape"}
                             for shape in ("uniform", "main")}}


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
    t_start = time.monotonic()
    seconds, t_last = {}, [t_start]

    def phase_done(label: str) -> None:
        now = time.monotonic()
        seconds[label] = now - t_last[0]
        t_last[0] = now
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} | {smi}")
    try:
        attention.KERNEL.build()
        log(f"build: {attention.KERNEL.build_seconds:.1f}s")
        log_build(attention)
        err_bf16 = check_kernel(attention, quant=False)
        err_int8 = check_kernel(attention, quant=True)
        timing_bf16 = time_kernel(attention, False, "uniform")
        timing_int8 = time_kernel(attention, True, "uniform")
        main_bf16 = time_kernel(attention, False, "main")
        main_int8 = time_kernel(attention, True, "main")
        noise_check(128256)
        verify = {quant: {"err": check_verify(attention, model, quant),
                          **{shape: time_verify(attention, model, quant,
                                                shape)
                             for shape in ("uniform", "main")}}
                  for quant in (False, True)}
        torch.cuda.empty_cache()
        phase_done("1-2 build, kernels")
        stats_bf16 = main_path(attention, model, None)
        stats_int8 = main_path(attention, model, "int8")
        phase_done("3-4 main path")
        stats_http = http_phase(attention)
        launcher_subprocess()
        dist_subprocesses()
        phase_done("5-6 http, dist")
        refs = {"bf16": stats_bf16.pop("_round1"),
                "int8": stats_int8.pop("_round1")}
        ckpt = checkpoint_phase(attention, model, refs["bf16"])
        phase_done("7 checkpoints")
        disagg = disagg_phase(attention, model, refs)
        phase_done("8 disagg")
        kv = kv_routing_phase(attention, model)
        phase_done("9 kv routing")
        spec = spec_phase(attention, model,
                          stats_bf16["round2"]["decode_step_device_ms"])
        phase_done("10 spec decode")
        lora = lora_phase(attention, model, refs["bf16"],
                          stats_bf16["round2"]["decode_step_device_ms"])
        phase_done("11 lora")
    except Exception:  # noqa: BLE001 — report and fail the run
        traceback.print_exc()
        return 1

    def ckpt_launches(kernel):
        return {run: ckpt[run]["launches"][kernel] for run in (
            "bf16_weights", "int8_weights", "int8_weights_int8_pool")}

    def disagg_launches(kernel):
        return {p["pass"]: p["launches"][kernel] for p in disagg["passes"]}

    def kv_launches(kernel):
        return {mode: p["launches"][kernel]
                for mode, p in kv["passes"].items()}

    log(json.dumps({"phase_seconds": seconds}))
    log(f"chip_smoke: {time.monotonic() - t_start:.1f} s in all")
    log(json.dumps({"kernels": [
        kernel_entry("paged_attention_hist", "bf16 pool", timing_bf16,
                     main_bf16, err_bf16, stats_bf16,
                     stats_http["launches"]["paged_attention_hist"],
                     stats_http["dist"]["launches"]["paged_attention_hist"],
                     ckpt_launches("paged_attention_hist"),
                     disagg_launches("paged_attention_hist"),
                     kv_launches("paged_attention_hist"), verify[False],
                     spec["launches"]["paged_attention_hist"],
                     lora["launches_total"]["paged_attention_hist"]),
        kernel_entry("paged_attention_hist_int8",
                     "int8 pool, _decode_kernel(quantized=True)",
                     timing_int8, main_int8, err_int8, stats_int8,
                     stats_http["launches"]["paged_attention_hist_int8"],
                     stats_http["dist"]["launches"][
                         "paged_attention_hist_int8"],
                     ckpt_launches("paged_attention_hist_int8"),
                     disagg_launches("paged_attention_hist_int8"),
                     kv_launches("paged_attention_hist_int8"), verify[True],
                     spec["launches"]["paged_attention_hist_int8"],
                     lora["launches_total"]["paged_attention_hist_int8"])]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
