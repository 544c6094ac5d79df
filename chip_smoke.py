"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line. No
process the script starts outlives it (each dies with it; an exit or a
SIGTERM kills what still runs), and a run that has not ended after
WATCHDOG_S prints every stack, its own and each child's, and exits 1.
Each phase's end prints the seconds so far and the host's memory.
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
   are captured at first use) and graph-pool bytes. The engine carries a
   metrics registry; after round 1 each request's trace holds its
   engine.queue_wait, engine.prefill and engine.decode spans (the decode
   spans carrying every token but the first), the flight ring holds one
   row per processed window (idle-stable windows skipped, the token
   column summing to the decode tokens) and decode_step_seconds counted
   every window. After round 2, round 1's shape on fresh prompts is
   served once to capture its programs, then twice, spans on then off
   in turns (tracing.set_enabled): tok/s and the engine thread's host ms
   per window (dispatch, processing and the flight row, less the wait for
   the window's tokens) of each run, and their means over the runs that
   captured no program, the cost of spans on the card. The engine is then released.
4. main path, int8 pool: the same with --quant-kv int8: every decode step
   of every layer, in both rounds, launches the int8 kernel and never the
   bf16 one; the teacher-forced checks run on int8 pools, and round 1's
   logits stay cosine-close (> 0.99) to the bf16 pool's for the same
   tokens. The observability checks of round 1 run here too.
5. the OpenAI front at full width and CUT_LAYERS of the 32 layers (phases
   5 and 6 compare their results only with each other): launch.start_http
   (what ``python -m dynamo_tpu_torch.launch in=http`` runs) serves a
   llama-3-8b engine (bf16 pool, seed 0, built by launch.load_engine from
   the launcher's config with the depth cut) behind the HTTP front on
   127.0.0.1 port 0 in this process. The
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
   windows x M x CUT_LAYERS times, the int8 entry 0 times. It prints each
   request's TTFT, median gap between chunks and time per output token
   at the client, the phase's tok/s, and the TTFTs of the six chats and
   of the alone chat through engine.generate. Then ``python -m dynamo_tpu_torch.launch
   in=http out=gpu --model tiny-test --http-port 0`` runs as a
   subprocess: its engine is on cuda without --device, it answers a
   streamed chat and exits 0 on SIGTERM.
6. the distributed main path on phase 5's engine, before it is
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
   discovery; paged_attention_hist launched windows x M x CUT_LAYERS
   times, the int8 entry 0 times. It prints each request's client TTFT and TPOT
   beside phase 5's, the phase's tok/s, its seconds, and the mean us of
   packb + unpackb over the phase's data frames. Then the coordinator,
   ``python -m dynamo_tpu_torch.backends.gpu --model tiny-test`` and
   ``python -m dynamo_tpu_torch.frontend --http-port 0`` run as
   subprocesses: the worker's engine is on cuda without --device, a
   streamed chat is answered, and all three exit 0 on SIGTERM.
7. real checkpoints at full width and CUT_LAYERS of the 32 layers (the
   phase compares its checkpoints only with its own preset engine of the
   same depth). a. The seed-0 llama-3-8b preset cut to CUT_LAYERS, built
   with launch.build_engine, serves round 1 (checked as in phase 3): its
   greedy ids and the teacher-forced logits of its first request are the
   reference. Its tree (the preset's weights) is written as a HF
   checkpoint of the public Meta-Llama-3-8B config.json (CUT_LAYERS
   layers) in HF names and [out, in] layout, bf16, in shards of at most
   5 GB, with engine/safetensors_lite.save_file into a temporary
   directory (its free space printed first), beside the test tokenizer's
   tokenizer.json.
   b. launch.build_engine with --model DIR loads it: every leaf equals
   the written one; round 1 is served and checked as in phase 3 (every
   decode step of every layer launches paged_attention_hist); its greedy
   ids equal the preset engine's, or split only at a near-tie of the
   teacher-forced logits; its teacher-forced logits are within
   LOGIT_ATOL of the preset's. c. The same with --quant int8: wq and w_down
   of three layers and the embedding, quantized on the card, equal the
   CPU quantizer's q and s bit for bit; the teacher-forced logits have
   cosine > 0.99 to the preset's bf16 weights'; round 1 is served on a bf16
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
   pages (8 GiB of bf16 pages each, so both fit the card), at full depth
   for the bf16 passes and at CUT_LAYERS for the int8 ones, serve in this
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
   bf16 pools over the KV plane (its socket path: a pull in the process
   that staged a parcel never takes the device path); bf16 pools inline
   (no plane); the
   decode pool rebuilt as int8 with bf16 parcels quantized on insert;
   the prefill pool rebuilt as int8 too (packed parcels). The int8 passes
   compare only with the phase's own reference: both their engines are
   CUT_LAYERS deep, and before them the int8 decode engine serves round
   1's six greedy prompts and the long prompt aggregated. Checked in
   each: every request finishes at its max_tokens; remote_prefills
   equals the prompts over 512 tokens, remote_failures is 0, each of
   them was admitted with its parcel (no local fallback at admission)
   and the rest prefilled locally; paged_attention_hist (the int8 entry on the
   int8 pool) launched windows x M x layers times on the decode worker and
   the other entry 0 times, and the prefill worker ran no window; the
   plane pulled every parcel and the long prompt streamed as three page
   groups (128, 128, 119 pages); greedy ids equal phase 3's (bf16 pool)
   or the int8 reference's aggregated ids, or split only at a near-tie
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
   decode worker's handler beside phase 3's (or the int8 reference's)
   engine-boundary TTFT of the same prompt, and the client's first chunk
   (the test
   tokenizer decodes most ids to no text, so few chunks reach the
   client); per pass its tok/s. For phase 13 it keeps the plane pass's
   traffic, tokens and remote rows. Then the coordinator, ``python -m
   dynamo_tpu_torch.backends.gpu --mode prefill`` and ``--mode decode
   --max-local-prefill-length 8`` (tiny-test, no --device: each must log
   an engine on cuda) and the frontend run as subprocesses: a streamed
   chat over the threshold is prefilled on the prefill worker and
   answered, and all four exit 0 on SIGTERM.
9. KV-cache-aware routing at full width, after phase 8's engines are
   released. Two seed-0 llama-3-8b engines cut to CUT_LAYERS of its 32
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
   launched windows x M x CUT_LAYERS times over both workers in each pass,
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
10. speculative decoding at full width and CUT_LAYERS of the 32 layers
   (the phase compares the engine only with itself), after phase 9's
   engines are released: a seed-0 llama-3-8b engine built as ``python -m
   dynamo_tpu_torch.backends.gpu --spec-decode ngram --spec-k 3`` builds
   it (bf16 pool of DISAGG_PAGES pages, warmup_windows set: its one spec
   program is captured at start) serves 8 concurrent requests of 64
   tokens through GPUEngine.generate: four greedy code-like prompts of
   600-1500 tokens (a block of ids repeated with a few renamed, the
   drafter's best case), two greedy random prompts, one seeded at
   temperature 0.8 and one at 0.8 / top_p 0.9. Checked: every request
   finishes at 64 tokens; every window was a replay of the spec program's
   graph; paged_attention_hist launched windows x m_outer x CUT_LAYERS
   times (the verify route), the int8 entry 0 times; the device accepted at least
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
11. batched LoRA at full width and CUT_LAYERS of the 32 layers (the phase
   compares the engine only with itself), after phase 10's engine is
   released: three HF PEFT adapters for llama-3-8b at that depth are
   written from seeds with the port's safetensors writer (a: rank 8 and
   b: rank 16 on all seven targets, c: rank 4 with lora_alpha 12 on the
   attention projections), and a seed-0 llama-3-8b engine is built as
   ``python -m dynamo_tpu_torch.backends.gpu --lora a=... --lora b=...
   --lora c=... --max-adapters 2 --max-lora-rank 16`` builds it (bf16
   pool of DISAGG_PAGES pages, warmup_windows set). Round A: round 1's 8
   prompts concurrently, 3 on the base model, 3 on a, 2 on b (six greedy,
   one at temperature 0.8 / top_p 0.9, one seeded); then the greedy base
   rows' prompts again, alone on the base model. Round B: a request on c,
   which hot-loads into the slot LRU frees (b's) while captured programs
   exist, beside one on a; while both are held a request on b is
   answered OverloadedError, and an unknown name AdapterNotFoundError.
   Checked: every request finishes at 64 tokens and every window was a
   graph replay; paged_attention_hist launched windows x 8 x CUT_LAYERS
   times and the int8 entry 0 times; slot 0 is bit-identical to the base
   model
   (one decode step's logits with the LoRA stacks and ids 0 equal those
   without, and the same window through a runner built without adapters
   on the same parameter tensors and pool gives the same tokens and
   logprobs); every delta of one eager decode step with rows on slots
   0, 1 and 2 (7 targets x CUT_LAYERS layers, model.lora_delta on the
   card)
   equals a per-row gather computed here without it (x @ A[id] in fp32,
   rounded to bf16, @ B[id]) within LORA_DELTA_RTOL of the delta's
   largest entry, slot-0 rows exact zeros; the greedy base rows equal
   the same prompts served alone or split at a near-tie; each greedy
   adapter row's id is
   the argmax of the eager teacher-forced plain path through its adapter or sits at a near-tie
   (top-2 margin within 2 x LOGIT_ATOL); after the hot-load, a window
   program captured before it, replayed with rows on a and c, equals its
   body run eagerly (tokens equal, logprobs within 1e-5). It prints the
   round's tok/s, TTFT and TPOT, the decode device ms a step with all 8
   rows on adapters beside the same window on the base runner
   (torch.profiler; their difference is the LoRA ops' cost), the ms
   of one hot-load of b (rank 16, about 84 MB host to device), the
   stacks' bytes and the phase's seconds.
12. KV tiers at full width, after phase 11's engine is released: worker
   A is built as ``python -m dynamo_tpu_torch.backends.gpu --num-pages 512
   --host-cache-pages 256 --kv-disk-cache-dir DIR --kv-watermarks
   0.2,0.3`` builds it (seed-0 llama-3-8b, bf16 pool; DIR a temporary
   directory whose free space is printed first, its G3 holding
   TIER_DISK_PAGES pages), worker B is a second engine of 512 pages with
   no local tiers and no warmup on the same parameter tensors, and both
   run their KV plane, registration and peer watch
   (``backends.gpu.start_kv_plane``) on an embedded coordinator. One
   throwaway request a worker captures the programs of the traffic's page
   bucket; its blocks are dropped. Traffic on A, 4 greedy prompts a set,
   16 tokens each: set A (1024 tokens), sets B and C (1536 tokens; they
   evict A's blocks into G2 and G2's overflow into G3), the set-B prompt
   with the most blocks in G2, set A again, and set A once more at once;
   then A clears its G1 and B serves set A, the head of each prompt's
   blocks coming over G4 from A's host tiers: B runs the worker's G4
   budget (0.1 s a consult) and asks A for as many blocks as that budget
   carries at A's measured rate; then B serves a fresh prompt with a
   dead peer address ahead of A. Then decode under eviction pressure:
   the same traffic (a fill round, then TIER_PRESSURE_PROMPTS fresh
   prompts of TIER_PRESSURE_LEN tokens decoding TIER_PRESSURE_TOKENS
   each, which evict the fill's blocks) on B (no local tiers) and on A
   (tiers on). Last, the G2 put's copy alone on A's engine thread, from
   a flush's page-locked buffer and from pageable memory, into fresh,
   reused and newly mapped memory. Checked: every request finishes
   and every window replayed; paged_attention_hist launched windows x 8 x
   32 times in every round and the int8 entry never; the replay onboarded
   every block up to (len - 1) // 16 from the tiers (G3 hits among them)
   and the repeat found them all in G1; the pool bytes of every onboarded
   block, on A and on B, equal the bytes that block had in A's pool
   before it was evicted, with blocks read from G2 and from G3 among
   them; the first-token logits of every replayed prompt, on A and on B,
   against the whole prompt prefilled by the plain path within
   LOGIT_ATOL; the dead peer's breaker opens, its consult stays within
   the G4 budget and the request recomputes; over G4 every consult of B
   got all the blocks it asked for (at least one), within the budget,
   with no failed, slow or skipped consult, and every such block's pool
   bytes equal A's before eviction; the watermark sweep demoted and A
   settles at or above its low watermark; no spill, upload or peer pull
   failed; A's digest reports g2 and g3. A's spill dispatch and
   readiness poll and both workers' onboard uploads run under
   ``no_stream_sync``. It prints, beside the card's name and power
   limit, the spill extract's device and host ms per block, G2 put/get
   us and G3 put/get ms per block, the onboard upload's device ms per
   block, the G4 asks, pulls' ms and GB/s, the TTFT of set A cold,
   onboarded, from G1 and on B over G4, the TPOT of the pressure round
   on A and on B, and the copy's us a block in each of its five forms.
13. the KV plane's device path (CUDA IPC between two processes on the
   card), after phase 12's engines are released. a. This process fills
   a llama-3-8b-shaped bf16 pool ([32, 8, P, 16, 128], from
   PARCEL_SEED) and stages parcels of PARCEL_PAGES (1, 64 and 375) pages,
   gathered from shuffled pages on the card, each twice: a ticket with
   the device field and a socket-only one, on a KvPlaneServer whose probe
   must pass; the gathers, events and staging run under
   ``no_stream_sync``. A spawned process pulls all six into fresh pages
   of its own pool of the same shape. Checked: each device ticket went
   over the device path and each socket ticket over the socket, with no
   failed open; the child's pool bytes at each parcel's pages have the
   sha256 of the source's pages; the sinks' "done" (device) and the
   socket sends free every staged tensor, so this process's allocated
   memory goes back to where it was before staging. It prints per parcel
   the path, bytes, pull ms and GB/s, and the handle open's ms (device)
   or the wait for the first byte (socket). b. 1P1D at full width as
   processes: the coordinator, ``python -m dynamo_tpu_torch.backends.gpu
   --mode prefill --model llama-3-8b --num-pages 4096`` and ``--mode
   decode ... --max-local-prefill-length 512`` (random weights from seed
   0; each must log its plane's device path on) and the frontend. Phase
   8's traffic (round 1's eight prompts of 64 tokens and the 6000-token
   prompt of 32, ignore_eos) goes at once to the decode worker's endpoint
   through the request plane, as the frontend sends it (its token ids
   come back), then a fresh 600-token prompt as a streamed completion of
   token ids through the frontend. Checked: every request finishes at
   its max_tokens; from the workers' GPU_WORKER_EXIT lines, the decode
   worker's device_pulls equal its remote prefills (every prompt over
   512 tokens) with socket_pulls, device_pull_failures and
   remote_failures 0, every remote prompt was admitted with its parcel,
   the prefill worker staged as many device parcels, all freed by "done",
   and ran no window; paged_attention_hist launched windows x M x 32
   times on the decode worker (every window a replay), the int8 entry
   never; the first token of each remote prompt equals phase 8's (the
   unseeded top-p one aside); the greedy ids (rows 0-5 and the long
   prompt, sent with top-2 logprobs) equal phase 8's bf16 plane pass or
   split only where the top-2 margin behind the split, read from this
   chain's logprobs (both chains hold the same tokens up to it), is
   within 2 x LOGIT_ATOL; all four exit 0 on SIGTERM. It prints, per remote request, the parcel
   bytes, pull ms, open ms and GB/s and the client's TTFT and TPOT beside
   phase 8's socket pull ms and GB/s and handler TTFT for the same
   prompt, each worker's peak device memory and the phase's seconds.
14. the observability plane, on phase 13b's fleet before its SIGTERM:
   both workers run with DTPU_SYSTEM_ENABLED=1 (a status server each,
   registered for the fleet pane) and their flight bundles in a temporary
   directory. A chat of OBS_CHAT_WORDS words (a remote prefill) goes
   through the frontend with a traceparent: the frontend's /debug/traces
   holds its http.request (parented to the header's span) and
   router.decide, the decode worker's status server its worker.request
   (parented to http.request's span), engine.queue_wait, engine.decode,
   kv.transfer.recv and kv.plane.pull, the prefill worker's its
   worker.request and kv.transfer.send, all under that trace id. Then
   two rounds of OBS_PROFILE_ROWS completions of OBS_PROFILE_TOKENS
   tokens decode on the decode worker (the first captures every window
   program the second needs), and while the second decodes POST
   /debug/profile captures OBS_PROFILE_MS ms: the answer's mode is "torch" and it counts hist_flash_partial and
   hist_flash_combine launches inside the graph replays, each at least a
   window's (M x 32) and at most M x 32 per window processed during the
   capture plus two. /metrics on the three processes agrees with the
   traffic: the frontend's http_requests_total by route with status
   200, each worker's requests_total, the decode worker's
   request_queue_wait_seconds count equal to its requests, its
   prefill_step_seconds count between 1 and its local prefills, and
   (after the exit) its decode_step_seconds count equal to its windows; it prints
   each scrape's ms. The frontend's /debug/timeline holds the decode
   worker's worker_join (a prefill worker registers no model, so it has
   none) and both workers' journal streams, with no journal_gap;
   /debug/fleet lists both workers; the decode worker's /debug/flight
   has rows, and each bundle the fleet wrote names its reason (a graph
   captured at first use stalls the decode loop past the 2 s trigger:
   decode_stall bundles are expected and reported). The decode worker's
   own counters, printed on SIGUSR1 just before phase 14 and at its exit,
   split its launches between 13b and 14: each share is M x 32 per window
   of that share, and the /metrics window count at phase 14's start
   equals the first reading's windows. Both shares join the kernels
   line.
15. admission and the perf plane at full width and CUT_LAYERS of the 32
   layers (the phase compares its engines only with themselves), after
   phase 13's fleet
   is gone; llama-3-8b engines built as ``backends.gpu`` builds them
   (seed 0, ADM_PAGES pages, warmup_windows set, a metrics registry).
   a. The perf plane: the worker engine serves round 1's shape on fresh
   prompts, then GET /debug/perf on a status server whose provider is
   its perf_status (the worker's wiring). Checked: the window counters
   since the engine was built equal its own windows and tokens; the
   weight-read step is ADM_STEP_MS (1.669 ms: 5.59 GB at 3350 GB/s at
   CUT_LAYERS layers); 0 < frac <= 1;
   the decode_window captures since the engine was built equal its
   runner's captured programs; no unexpected recapture; hbm.bytes_in_use
   equals torch.cuda.memory_allocated() read before and after the GET,
   peak >= in use, the limit is the card's memory; params and KV pool
   bytes are the runner's; workspace >= the graph pool. It prints the
   windows' window_s in all beside their device time between CUDA events
   recorded around each window's enqueue. b. SLA admission: the same
   engine with a TTFT budget of ADM_BUDGET_PROMPTS burst prompts at the
   rate round 1 calibrated and reject factor 2 takes ADM_BURST prompts of
   ADM_BURST_LEN tokens at once. Checked: heads deferred, at least one
   OverloadedError carrying the projection, every admitted request
   finishes, admitted + rejected = sent; it prints each admitted
   request's projected TTFT at submission beside its measured TTFT. c.
   The brownout fallback: a ``--spec-decode ngram`` engine on the same
   weights (a budget given at start, so its warmup also captures the plain
   programs its brownout falls back to), its budget set to one backlog
   prompt at its calibrated rate, decodes code-like rows while a backlog
   of prompts arrives. Checked: the level reached >= 2 and returned to 0,
   plain windows ran under it and spec windows before and after it, every
   window replayed a graph, the bf16 entry launched m_outer x CUT_LAYERS
   per spec window plus M x CUT_LAYERS per plain window, and the greedy rows equal a plain
   engine's on the same prompts or split only at a near-tie (top-2
   margin within 2 x LOGIT_ATOL). d. The front: a port frontend
   (``--overload-max-concurrency 4 --slo-ttft-p99-ms``, the limit at 4
   from the start and a queue of FRONT_QUEUE_DEPTH) over a port worker
   serving the first engine takes FRONT_BURST chats at once, every fourth
   ``x-priority: batch``. Checked: 200s plus 503s and 429s, each shed with
   Retry-After and a typed error, make FRONT_BURST; /metrics shows
   admitted_total, shed_total and concurrency_limit; /debug/slo answers
   200 with the reference's keys and a ttft target. Phase 15 runs bf16
   pools only: its int8 launches are 0 (phases 4, 7, 8 and 12 drive the
   int8 entry).
16. the planner and live role changes, on phase 13b's fleet after phase
   14 (its workers run ``--migration-limit 3`` and ``--tokenizer`` of the
   test tokenizer with an entry ``<tN>`` for every id from 361 up, so a
   chat's ids show in the front's stream; prompts encode as before).
   Every wait, each HTTP call included, has its own bound of ROLE_WAIT_S
   and fails at once naming phase 16, with the process's stacks. b.
   Eight streamed greedy chats of ROLE_TOKENS tokens with top-2
   logprobs go through the frontend as the fleet stands (P prefills, D
   decodes); their tokens are c's reference. The port's
   RoleReconfigurator then writes a SetRole directive on this process's
   lease that flips P to agg. Checked: P's role status reads
   serving/agg at the directive's epoch; the same verb again acks
   duplicate and an older epoch answers 409 with last_outcome
   rejected_stale; P's allocated device memory within 1% across the
   flip (no weight reload) and no window program captured by it; its
   model card registered. a. Then a standby S starts: ``python -m
   dynamo_tpu_torch.backends.gpu --standby --num-pages STANDBY_PAGES``
   (same model and seed), after P's flip has returned P's cached blocks
   to the card; its load and warmup overlap c and e. c. The same chats
   again while POST /control/role flips D to prefill with a
   ROLE_DRAIN_S drain. Checked: every stream finishes with ROLE_TOKENS
   tokens; the front's request ledger has one ok record a chat, at
   least one migrated, every migrated one carrying migration_reason
   role_flip, and their migrations number the streams D's drain cut or
   refused (its role counters' cut_streams, read by SIGUSR1); P's
   paged_attention_hist launches in c (two SIGUSR1 readings) are
   windows x M x 32, each window a replay, the int8 entry never; each
   chat's tokens equal b's or split only where this chain's top-2
   margin is within 2 x LOGIT_ATOL; D serves as prefill. e. ``python -m
   dynamo_tpu_torch.planner --adjustment-interval 0.5`` (its connector
   records, reconfiguration off) runs PLANNER_STEPS steps while four
   chats of PLANNER_CHAT_TOKENS tokens decode on P (they outlast the
   steps), sees a live worker on the gpu component's load metrics and a
   decode demand (active + waiting) above 0 in a step, and exits 0 on
   SIGTERM. d. S parks (GPU_WORKER_READY
   mode=standby, a standby/ key, no model card); a promote directive,
   written as FleetScaler writes it, joins it; chats go through the
   front until the ledger shows one served by S; its
   standby_join_seconds is read off its /metrics; a retire directive
   drains it (scale_in) and it exits 0 with its counters (role and
   scale state retired, launches windows x M x 32). Phase 16's share of P's and D's
   counters (from phase 14's end to their exit) and S's whole count
   obey windows x M x 32 and join the kernels line as launches_roles;
   it prints the flips and their seconds, the migrations by reason, the
   join seconds, each process's peak device memory and its seconds.
   Phase 13b's and 14's checks read the workers' counters as phase 14
   ends (SIGUSR1), since phase 16 changes both roles after.
17. embeddings, in three places (no kernel runs on the embed path: it is
   an eager pass with dense attention, so phase 17 launches neither
   kernel). a. On phase 3's full-depth engine before it is released
   (embed_phase): four greedy chats with top-2 logprobs are served alone,
   then again, each prompt first dropped from the prefix cache, while
   ``engine.embed`` runs over 8 inputs of 1 to 2048 tokens (one token,
   round 1's first six prompts and a 2048-token prompt; a batch of 8 at
   the 2048 bucket) with ``last`` and then ``mean`` pooling. Checked:
   every vector finite with |norm - 1| <= 1e-3; each input embedded
   alone equals its row of the batch at cosine >= 0.999; argmax of the
   lm head over a ``last`` vector equals its chat's greedy first token
   where that token's top-2 margin exceeds 2 x LOGIT_ATOL; the chats
   decoded through the jobs (slots live when each job ran) and their
   tokens equal the chats served alone, or split only where this
   chain's top-2 margin is within 2 x LOGIT_ATOL; every window of the
   run a replay. It prints each job's device ms (CUDA events around
   ``runner.embed`` on the engine thread) and its peak device bytes
   above what was allocated before it. b. On phase 5's front
   (embed_http): ``POST /v1/embeddings`` with a string, a list of two
   strings and 300 token ids; each vector equals ``engine.embed`` of the
   same ids within 1e-3 abs and usage counts the prompt tokens; an empty
   list, an empty string and 8193 ids (over ``context_length``) answer
   400. In phase 6, the string through the distributed front (request
   plane, ``{"embed": True}`` to the worker) equals the front's vector
   within 1e-3 abs. c. In phase 7, on its CUT_LAYERS-deep llama-3-8b
   checkpoint before it is removed (batch_launcher): ``python -m
   dynamo_tpu_torch.launch in=batch out=gpu --model DIR
   --reasoning-parser deepseek_r1 --tool-call-parser hermes
   --batch-concurrency 4`` over a JSONL of 8 prompts and one malformed
   line logs an engine on cuda, exits 0 and writes 9 rows in input
   order: one error row, 8 rows with tokens > 0 and a finish reason; the
   summary line's output_tokens is the rows' sum. Random weights emit no
   think or tool tags, so the parsed chats are held only by the CPU
   tests.
In every phase from 3 to 16, each decode window an engine dispatched was
a replay of its program's CUDA graph (the runner's replay count rises by
the windows dispatched; in phase 13 the decode worker's own count), and the warmed engines of phases 8-11 (built as
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
# The processes this script starts. None may outlive it: each asks the
# kernel for SIGKILL when this process dies (PR_SET_PDEATHSIG, so a
# SIGKILL of this process takes them too), and an exit, a SIGTERM or the
# watchdog kills what still runs. The watchdog ends a run that has not
# ended WATCHDOG_S after it started, inside the harness's 1200 s: it
# prints every thread's stack and each child's last lines, so a hang
# says where it hung, then kills the children and exits 1.
# ---------------------------------------------------------------------------
CHILDREN: list = []  # (process, line queue or None, lines seen)
WATCHDOG_S = 1160
_PRCTL = None


def die_with_parent() -> None:
    """In a child, before anything else: SIGKILL when the parent dies.
    (As a ``preexec_fn`` it runs between fork and exec, so the libc call
    is looked up in the parent, by ``install_guards``.)"""
    if _PRCTL is not None:
        _PRCTL(1, 9)  # PR_SET_PDEATHSIG, SIGKILL


def _alive(proc) -> bool:
    return proc.poll() is None if hasattr(proc, "poll") else proc.is_alive()


def kill_children() -> list:
    """SIGKILL every child still running and reap it; the pids killed."""
    killed = []
    for proc, _, _ in CHILDREN:
        if _alive(proc):
            killed.append(proc.pid)
            proc.kill()
    for proc, _, _ in CHILDREN:
        with contextlib.suppress(Exception):
            if hasattr(proc, "poll"):
                proc.wait(timeout=30)
            else:
                proc.join(30)
    return killed


def host_memory() -> dict:
    """GiB: the host's MemAvailable, this process's resident set, and its
    running children's in all (from /proc)."""
    import os

    def kib(path, key):
        with contextlib.suppress(OSError, StopIteration, ValueError):
            with open(path) as fh:
                line = next(x for x in fh if x.startswith(key))
            return int(line.split()[1])
        return 0
    kids = sum(kib(f"/proc/{p.pid}/status", "VmRSS:") for p, _, _ in
               CHILDREN if _alive(p))
    return {"available_GiB": round(kib("/proc/meminfo", "MemAvailable:")
                                   / 2**20, 2),
            "rss_GiB": round(kib(f"/proc/{os.getpid()}/status", "VmRSS:")
                             / 2**20, 2),
            "children_rss_GiB": round(kids / 2**20, 2)}


def dump_stacks(why: str) -> None:
    """Every thread's stack of this process, then of each running child
    (each has the fault handler on, so a SIGABRT makes it print its
    threads' stacks as it dies), with each child's last lines, to
    stderr."""
    import faulthandler
    import os
    import signal
    print(f"chip_smoke: {why}; every thread's stack and each child's "
          f"last lines follow", file=sys.stderr, flush=True)
    faulthandler.dump_traceback(all_threads=True)
    running = [e for e in CHILDREN if _alive(e[0])]
    for proc, _, _ in running:
        os.kill(proc.pid, signal.SIGABRT)
    time.sleep(3)
    for proc, lines, seen in CHILDREN:
        while lines is not None and not lines.empty():
            seen.append(lines.get_nowait())
        print(f"--- child {proc.pid} {getattr(proc, 'args', '')} (was "
              f"running: {any(proc is e[0] for e in running)}):\n"
              f"{''.join(seen[-60:])}", file=sys.stderr, flush=True)


def _watchdog() -> None:
    import os
    dump_stacks(f"no end after {WATCHDOG_S} s")
    print(f"chip_smoke: killed {kill_children()}", file=sys.stderr,
          flush=True)
    os._exit(1)


def install_guards() -> None:
    """The watchdog, a SIGTERM that kills the children first, and the
    kill at exit (see above)."""
    import atexit
    import ctypes
    import faulthandler
    import os
    import resource
    import signal
    import threading
    global _PRCTL
    _PRCTL = ctypes.CDLL(None, use_errno=True).prctl
    # No core files: the watchdog's SIGABRT of a child is for its stacks.
    resource.setrlimit(resource.RLIMIT_CORE, (0, 0))
    dog = threading.Timer(WATCHDOG_S, _watchdog)
    dog.daemon = True
    dog.start()
    # Should the watchdog's thread not get the interpreter, the C-level
    # dump still comes, and the exit takes the children by their
    # parent-death signal.
    faulthandler.dump_traceback_later(WATCHDOG_S + 15, exit=True)

    def on_term(signum, frame):
        kill_children()
        os._exit(128 + signum)
    signal.signal(signal.SIGTERM, on_term)
    atexit.register(kill_children)


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
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

    argv = ["out=gpu", "--model", MODEL, "--seed", "0"]
    if quant_kv:
        argv += ["--quant-kv", quant_kv]
    kind = quant_kv or "bf16"
    t0 = time.monotonic()
    registry = MetricsRegistry()
    engine = launch.build_engine(
        launch.parse_args(argv),
        metrics_registry=registry.namespace("dynamo").component("gpu"),
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
        obs0 = observe_start(engine)
        results, stats = round1(engine, attention, prompts)
        stats = {"pool": kind, **stats}
        stats["observability"] = observe_check(engine, results,
                                               stats["windows"], obs0)
        log(json.dumps({"main_path": stats}))
        round2 = second_round(engine, attention, prompts)
        if not quant_kv:
            stats["tracing_cost"] = tracing_cost(engine)
            stats["embeddings"] = embed_phase(engine, attention, model,
                                              prompts)
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


# ---------------------------------------------------------------------------
# Phase 17a: embeddings beside live decode at full depth
# ---------------------------------------------------------------------------

EMBED_LONG = 2048  # the longest input: the largest bucket phase 3 serves
EMBED_CHAT_TOKENS = 128
EMBED_COSINE = 0.999


def embed_inputs(spec, prompts) -> list[list[int]]:
    """17a's 8 inputs: one token, round 1's first six prompts and a
    2048-token prompt."""
    rng = np.random.default_rng(17)
    return ([[int(rng.integers(0, spec.vocab_size))]] + prompts[:6]
            + [rng.integers(0, spec.vocab_size, EMBED_LONG).tolist()])


def kernel_launches(attention) -> dict:
    """Both entry points' launch counts so far."""
    return {"paged_attention_hist": attention.KERNEL.launches,
            "paged_attention_hist_int8": attention.KERNEL.launches_int8}


def top2_margins(result) -> list:
    """Each token's top-2 logprob margin (a logit margin) of a served
    request asked for top-2 logprobs."""
    out = []
    for alts in result["top_log_probs"]:
        lp = sorted((a["logprob"] for a in alts), reverse=True)
        out.append(lp[0] - lp[1] if len(lp) > 1 else None)
    return out


def embed_phase(engine, attention, model, prompts) -> dict:
    """Phase 17a (see the module docstring) on phase 3's engine."""
    from dynamo_tpu_torch.profile_decode import MODEL, serve
    t_phase = time.monotonic()
    runner = engine.runner
    spec = runner.spec
    inputs = embed_inputs(spec, prompts)
    chats = [{"model": MODEL, "token_ids": p,
              "stop_conditions": {"max_tokens": EMBED_CHAT_TOKENS,
                                  "ignore_eos": True},
              "sampling_options": {"logprobs": 2}} for p in prompts[:6]]
    for p in prompts[:6]:
        forget_prompt(engine, p)
    alone = asyncio.run(serve(engine, chats))
    for p in prompts[:6]:
        forget_prompt(engine, p)

    # runner.embed timed on the engine thread: CUDA events around it on
    # the engine's stream (after the windows queued before it), its peak
    # above what was allocated before, and the slots live as it ran.
    inner = runner.embed
    jobs = []

    def timed(token_lists, pooling="last"):
        live = sum(r is not None for r in engine.slot_req)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        before = kernel_launches(attention)
        ev[0].record()
        out = inner(token_lists, pooling)
        ev[1].record()
        ev[1].synchronize()
        launches = {k: v - before[k]
                    for k, v in kernel_launches(attention).items()}
        jobs.append({"pooling": pooling, "inputs": len(token_lists),
                     "live_slots": live, "launches": launches,
                     "device_ms": ev[0].elapsed_time(ev[1]),
                     "peak_bytes": torch.cuda.max_memory_allocated() - base})
        return out

    async def with_jobs():
        from dynamo_tpu_torch.runtime.context import Context
        started = [asyncio.Event() for _ in chats]

        async def chat(req, first):
            toks, tops = [], []
            async for item in engine.generate(req, Context()):
                toks.extend(item.get("token_ids", []))
                tops.extend(item.get("top_log_probs", []))
                first.set()
            return {"tokens": toks, "top_log_probs": tops}
        tasks = [asyncio.ensure_future(chat(c, e))
                 for c, e in zip(chats, started)]
        # The jobs go in once every chat has its first tokens.
        await asyncio.wait_for(asyncio.gather(*(e.wait() for e in started)),
                               SSE_TIMEOUT_S)
        vectors = {}
        for pooling in ("last", "mean"):
            vectors[pooling] = await engine.embed(inputs, pooling)
        return vectors, await asyncio.wait_for(asyncio.gather(*tasks),
                                               SSE_TIMEOUT_S)

    windows0 = engine.windows_dispatched
    replays0 = runner.window_replays
    runner.embed = timed
    try:
        vectors, live = asyncio.run(with_jobs())
    finally:
        del runner.embed
    check_replays(engine, replays0, engine.windows_dispatched - windows0)
    # Each job ran while the chats held their slots, and launched no
    # kernel (the embed path is dense attention).
    assert len(jobs) == 2, jobs
    for job in jobs:
        assert job["live_slots"] >= len(chats), jobs
        assert not any(job["launches"].values()), jobs
    # The chats: the same tokens as alone, or a split at a near-tie.
    splits = []
    for i, (got, ref) in enumerate(zip(live, alone)):
        assert len(got["tokens"]) == EMBED_CHAT_TOKENS, (i, len(got["tokens"]))
        j = next((k for k, (a, b) in enumerate(zip(got["tokens"],
                                                   ref["tokens"]))
                  if a != b), None)
        if j is not None:
            margin = top2_margins(got)[j]
            assert margin is not None and margin <= 2 * LOGIT_ATOL, (
                f"chat {i}: token {j} is {got['tokens'][j]}, alone "
                f"{ref['tokens'][j]}, at margin {margin}")
            splits.append({"chat": i, "token": j, "margin": margin})
    # The vectors: finite and unit, each alone equal to its batch row.
    alone_cos, norm_err = {}, 0.0
    for pooling, rows in vectors.items():
        arr = np.asarray(rows, np.float64)
        assert arr.shape == (len(inputs), spec.hidden_size), arr.shape
        assert np.all(np.isfinite(arr)), pooling
        norm_err = max(norm_err, float(np.abs(
            np.linalg.norm(arr, axis=-1) - 1).max()))
        cos = []
        for i, ids in enumerate(inputs):
            one = np.asarray(runner.embed([ids], pooling)[0], np.float64)
            cos.append(float(one @ arr[i] / np.linalg.norm(one)
                             / np.linalg.norm(arr[i])))
        alone_cos[pooling] = cos
        assert min(cos) >= EMBED_COSINE, (pooling, cos)
    assert norm_err <= 1e-3, norm_err
    # argmax of the lm head over a "last" vector (inputs 1-6 are the
    # chats' prompts): the chat's greedy first token where its top-2
    # margin is clear, and one of its top two everywhere.
    heads = model.lm_logits(torch.tensor(
        np.asarray(vectors["last"], np.float32)[1:1 + len(chats)],
        device=runner.device).to(torch.bfloat16), runner.params,
        spec).argmax(-1).tolist()
    head_checks = []
    for i, (head, ref) in enumerate(zip(heads, alone)):
        margin = top2_margins(ref)[0]
        top2 = [a["token_id"] for a in ref["top_log_probs"][0]]
        assert ref["tokens"][0] == top2[0] and head in top2, (i, head, top2)
        if margin > 2 * LOGIT_ATOL:
            assert head == ref["tokens"][0], (i, head, ref["tokens"][0],
                                              margin)
        head_checks.append({"chat": i, "argmax": head,
                            "first_token": ref["tokens"][0],
                            "margin": margin,
                            "clear": margin > 2 * LOGIT_ATOL})
    out = {"inputs": [len(ids) for ids in inputs], "jobs": jobs,
           "max_norm_err": norm_err,
           "min_alone_cosine": {k: min(v) for k, v in alone_cos.items()},
           "lm_head_checks": head_checks, "chat_splits": splits,
           "launches": {k: sum(job["launches"][k] for job in jobs)
                        for k in jobs[0]["launches"]},
           "phase_s": time.monotonic() - t_phase}
    log(json.dumps({"embed_phase": out}))
    return out


def round1_prompts(spec, seed: int = 0) -> list[list[int]]:
    from dynamo_tpu_torch.profile_decode import PROMPT_LENS
    rng = np.random.default_rng(seed)
    return [rng.integers(0, spec.vocab_size, size=n).tolist()
            for n in PROMPT_LENS]


def round1_requests(spec, prompts) -> list[dict]:
    """Round 1's requests over ``prompts``: 6 greedy, one top-p, one
    seeded, MAX_TOKENS each."""
    from dynamo_tpu_torch.profile_decode import MAX_TOKENS
    sampling = [{}] * 6 + [{"temperature": 0.8, "top_p": 0.9},
                           {"temperature": 0.8, "seed": 1234}]
    return [{"model": spec.name, "token_ids": p,
             "stop_conditions": {"max_tokens": MAX_TOKENS},
             "sampling_options": s} for p, s in zip(prompts, sampling)]


def observe_start(engine) -> dict:
    """Before round 1: an empty flight ring, and the engine's processed
    windows and phase histogram counts."""
    from dynamo_tpu_torch.runtime import flight
    flight.get_recorder().clear()
    return {"steps": engine.step_count,
            "decode": engine.phase.decode.get().count,
            "queue_wait": engine.phase.queue_wait.get().count,
            "prefill": engine.phase.prefill.get().count}


def observe_check(engine, results, windows: int, obs0: dict) -> dict:
    """After round 1 (phases 3 and 4): each request's trace holds its
    engine.queue_wait, engine.prefill and engine.decode spans, the decode
    spans carrying every token but the prefill's first; the flight ring
    holds one row per processed window (idle-stable ones skipped), whose
    token column sums to the decode tokens; decode_step_seconds counted
    every window and request_queue_wait_seconds every request."""
    from dynamo_tpu_torch.runtime import flight, tracing
    rec = tracing.get_recorder()
    want = {"engine.queue_wait", "engine.prefill", "engine.decode"}
    decode_tokens = 0
    for i, r in enumerate(results):
        spans = rec.trace(r["trace_id"])
        names = {s.name for s in spans}
        assert want <= names, (i, names)
        got = sum(s.attrs["tokens"] for s in spans
                  if s.name == "engine.decode")
        assert got == len(r["tokens"]) - 1, (i, got, len(r["tokens"]))
        decode_tokens += got
    processed = engine.step_count - obs0["steps"]
    assert processed == windows, (processed, windows)
    fr = flight.get_recorder()
    meta = fr.meta()
    rows = fr.dump()
    assert not meta["frozen"], meta
    assert len(rows) == min(windows - meta["skipped_idle"],
                            fr.capacity), (meta, windows)
    if windows <= fr.capacity:
        assert sum(row["tokens"] for row in rows) == decode_tokens, (
            sum(row["tokens"] for row in rows), decode_tokens)
    counts = {k: getattr(engine.phase, k).get().count - obs0[k]
              for k in ("decode", "queue_wait", "prefill")}
    assert counts["decode"] == windows, (counts, windows)
    assert counts["queue_wait"] == len(results), counts
    assert 1 <= counts["prefill"] <= len(results), counts
    out = {"spans_per_request": len(rec.trace(results[0]["trace_id"])),
           "flight_rows": len(rows), "flight_skipped_idle":
           meta["skipped_idle"], "decode_step_count": counts["decode"],
           "prefill_step_count": counts["prefill"],
           "decode_tokens": decode_tokens}
    log(f"observability: every request's queue_wait/prefill/decode spans "
        f"under its trace; {len(rows)} flight rows + "
        f"{meta['skipped_idle']} idle-stable skipped = {windows} windows; "
        f"decode_step_seconds counted {counts['decode']} windows")
    return out


class HostProbe:
    """The engine thread's host seconds in decode-window dispatch and
    processing (flight row included), less the waits for the window's
    tokens on the host (``_Readback.numpy`` inside the processing)."""

    def __init__(self, engine):
        from dynamo_tpu_torch.engine import engine as teng
        self.engine, self.readback = engine, teng._Readback
        self.seconds = self.wait = 0.0
        self.windows = 0
        self._inside = False

    def __enter__(self):
        eng, probe = self.engine, self
        numpy = self.readback.numpy

        def timed(fn, count: bool = False):
            def run(*a, **k):
                t = time.perf_counter()
                probe._inside = True
                try:
                    return fn(*a, **k)
                finally:
                    probe._inside = False
                    probe.seconds += time.perf_counter() - t
                    probe.windows += count
            return run

        def waited(rb):
            t = time.perf_counter()
            try:
                return numpy(rb)
            finally:
                if probe._inside:
                    probe.wait += time.perf_counter() - t

        self._saved = numpy
        eng._dispatch_window = timed(eng._dispatch_window)
        eng._process_window = timed(eng._process_window, count=True)
        eng._note_flight = timed(eng._note_flight)
        self.readback.numpy = waited
        return self

    def __exit__(self, *exc):
        for name in ("_dispatch_window", "_process_window", "_note_flight"):
            del self.engine.__dict__[name]
        self.readback.numpy = self._saved
        return False

    @property
    def ms_per_window(self) -> float:
        return (self.seconds - self.wait) * 1e3 / max(1, self.windows)


def tracing_cost(engine, pairs: int = 1) -> dict:
    """Round 1's shape on fresh prompts (no prefix hit), served once to
    capture the window programs it reaches, then with spans on and off in
    turns, ``pairs`` times: tok/s and the engine thread's host ms per
    window of each run. A run that still captured a program (the keys a
    round reaches depend on arrival timing) is kept in ``runs`` and left
    out of the means."""
    from dynamo_tpu_torch.profile_decode import serve
    from dynamo_tpu_torch.runtime import tracing
    spec = engine.runner.spec
    asyncio.run(serve(engine, round1_requests(spec,
                                              round1_prompts(spec, 99))))
    runs = []
    for k in range(2 * pairs):
        on = k % 2 == 0
        requests = round1_requests(spec, round1_prompts(spec, 100 + k))
        captured0 = engine.runner.window_programs()["captured"]
        tracing.set_enabled(on)
        try:
            with HostProbe(engine) as probe:
                t0 = time.monotonic()
                results = asyncio.run(serve(engine, requests))
                wall = time.monotonic() - t0
        finally:
            tracing.set_enabled(True)
        n_tok = sum(len(r["tokens"]) for r in results)
        runs.append({"tracing": on, "tok_per_s": n_tok / wall,
                     "wall_s": wall, "windows": probe.windows,
                     "host_ms_per_window": probe.ms_per_window,
                     "captures": engine.runner.window_programs()["captured"]
                     - captured0})
    out = {"runs": runs}
    for on in (True, False):
        sel = [r for r in runs if r["tracing"] is on and not r["captures"]]
        key = "on" if on else "off"
        out[f"clean_runs_{key}"] = len(sel)
        out[f"tok_per_s_{key}"] = (sum(r["tok_per_s"] for r in sel)
                                   / len(sel) if sel else None)
        out[f"host_ms_per_window_{key}"] = (
            sum(r["host_ms_per_window"] for r in sel) / len(sel)
            if sel else None)
    log(json.dumps({"tracing_cost": out}))
    return out


def round1(engine, attention, prompts) -> tuple[list, dict]:
    """Serve round 1 (the 8 requests: 6 greedy, one top-p, one seeded) on
    ``engine`` and check it: every request finishes at MAX_TOKENS with ids
    in the vocab, and every decode step of every layer launched the
    paged-attention entry of the engine's pool and never the other.
    Returns the results and the round's numbers."""
    from dynamo_tpu_torch.profile_decode import MAX_TOKENS, serve
    runner = engine.runner
    spec = runner.spec
    requests = round1_requests(spec, prompts)
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
                 reps: int = 1) -> dict:
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


# Depth of the engines of every phase that compares its results only with
# itself (phases 5-6, 7, the int8 passes of 8, 9, 10, 11 and 15): 8 of
# llama-3-8b's 32 layers, every width kept. A window program's capture
# costs host time in proportion to the layers, and captures are the
# script's longest waits.
CUT_LAYERS = 8


def cut_depth(config):
    """``config`` (an EngineConfig) with its model cut to CUT_LAYERS."""
    import dataclasses
    return dataclasses.replace(config, model=dataclasses.replace(
        config.model, num_layers=CUT_LAYERS))


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


def http_call(port: int, method: str, path: str, body=None,
              headers: dict | None = None,
              timeout: float = SSE_TIMEOUT_S) -> dict:
    """One request over http.client. A streamed answer is read line by
    line: its SSE framing is checked (``data: `` events, each followed by
    a blank line, ``data: [DONE]`` last) and each event's arrival time
    kept. Returns status, content type, and the JSON body (or the text of
    a ``text/plain`` one) or the events with their seconds since the
    request was sent. A read that waits ``timeout`` seconds raises
    TimeoutError."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        payload = body if isinstance(body, (bytes, type(None))) \
            else json.dumps(body).encode()
        conn.request(method, path, body=payload,
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        out = {"status": resp.status,
               "content_type": resp.getheader("Content-Type")}
        if out["content_type"].startswith("text/plain"):
            out["text"] = resp.read().decode()
            return out
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
    """Build the OpenAI front for llama-3-8b (bf16 pool, seed 0, cut to
    CUT_LAYERS layers) through ``launch.start_http``, the function
    ``python -m dynamo_tpu_torch.launch in=http`` runs, on 127.0.0.1 port 0
    in this process; drive it with http.client and check every answer;
    the engine is released before this returns."""
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

    async def start():
        # Phases 5 and 6 compare their results only with each other.
        config = cut_depth(launch.build_engine_config(args))
        engine = launch.load_engine(config, args.resolved_checkpoint,
                                    args.seed)
        return await launch.start_http(args, engine)

    t0 = time.monotonic()
    service, engine = on_loop(start(), 900)
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
        stats["embeddings"] = embed_http(attention, port, engine, tok,
                                         on_loop)
        traffic = {"chats": chats, "comp": comp, "alone": alone,
                   "rendered": rendered, "prompt_ids": prompt_ids,
                   "alone_ids": alone_ids,
                   "alone_tokens": alone_engine["tokens"],
                   "alone_text": streamed["text"],
                   "summaries": summaries, "alone_summary": streamed,
                   "names": names, "embed": stats["embeddings"]}
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


# Phase 17b: /v1/embeddings through the front and the request plane.
EMBED_TEXT = "the quick brown fox jumps over the lazy dog"
EMBED_HTTP_ATOL = 1e-3


def embed_http(attention, port: int, engine, tok, on_loop) -> dict:
    """Phase 17b's front part (see the module docstring) on phase 5's
    front and engine."""
    from dynamo_tpu_torch.profile_decode import MODEL
    t0 = time.monotonic()
    ids = np.random.default_rng(171).integers(
        0, engine.runner.spec.vocab_size, 300).tolist()
    pair = ["hello world", "def main return for in range"]
    cases = [(EMBED_TEXT, [tok.encode(EMBED_TEXT)]),
             (pair, [tok.encode(t) for t in pair]), (ids, [ids])]
    before = kernel_launches(attention)
    worst, text_vector = 0.0, None
    for raw, lists in cases:
        res = http_call(port, "POST", "/v1/embeddings",
                        {"model": MODEL, "input": raw})
        assert res["status"] == 200, res
        body = res["json"]
        assert [d["index"] for d in body["data"]] == list(range(len(lists)))
        total = sum(len(t) for t in lists)
        assert body["usage"] == {"prompt_tokens": total,
                                 "total_tokens": total}, body["usage"]
        got = np.asarray([d["embedding"] for d in body["data"]])
        want = np.asarray(on_loop(engine.embed(lists, "last"), 120))
        err = float(np.abs(got - want).max())
        assert err <= EMBED_HTTP_ATOL, (raw if isinstance(raw, str)
                                        else len(raw), err)
        worst = max(worst, err)
        if raw == EMBED_TEXT:
            text_vector = got[0]
    over = [[1] * (8192 + 1)]  # the launcher's default context_length + 1
    for raw in ([], "", over):
        res = http_call(port, "POST", "/v1/embeddings",
                        {"model": MODEL, "input": raw})
        assert res["status"] == 400, res
        assert res["json"]["error"]["type"] == "invalid_request_error", res
    launches = {k: v - before[k]
                for k, v in kernel_launches(attention).items()}
    assert not any(launches.values()), launches
    out = {"max_abs_err_vs_engine": worst, "launches": launches,
           "seconds": time.monotonic() - t0}
    log(json.dumps({"embed_http": out}))
    return dict(out, _text_vector=text_vector)


def embed_request_plane(attention, port: int, front: dict) -> dict:
    """Phase 17b's request-plane part: the front's string through phase
    6's distributed front (``{"embed": True}`` to the worker) gives the
    front's vector."""
    from dynamo_tpu_torch.profile_decode import MODEL
    t0 = time.monotonic()
    before = kernel_launches(attention)
    res = http_call(port, "POST", "/v1/embeddings",
                    {"model": MODEL, "input": EMBED_TEXT})
    assert res["status"] == 200, res
    got = np.asarray(res["json"]["data"][0]["embedding"])
    err = float(np.abs(got - front.pop("_text_vector")).max())
    assert err <= EMBED_HTTP_ATOL, err
    launches = {k: v - before[k]
                for k, v in kernel_launches(attention).items()}
    assert not any(launches.values()), launches
    out = {"max_abs_err_vs_front": err, "launches": launches,
           "seconds": time.monotonic() - t0}
    log(json.dumps({"embed_request_plane": out}))
    return out


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
        embed = embed_request_plane(attention, port, traffic["embed"])
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
             "launches": launches, "embeddings": embed,
             "phase_s": time.monotonic() - t_phase}
    log(json.dumps({"dist_phase": stats}))
    return stats


def _spawn(procs: list, *argv, env: dict | None = None):
    """Start ``python -m *argv`` from the checkout's root (``env`` added
    to its environment), its output lines collected; appends (process,
    line queue, lines seen) to ``procs`` and returns it. The process is
    one of ``CHILDREN``: it dies with this one."""
    import os
    import queue
    import subprocess
    import threading
    proc = subprocess.Popen(
        [sys.executable, "-m", *argv], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, DTPU_LOG="info", PYTHONFAULTHANDLER="1",
                 **(env or {})),
        preexec_fn=die_with_parent)
    lines: queue.Queue = queue.Queue()
    for pipe in (proc.stdout, proc.stderr):
        threading.Thread(target=lambda p=pipe: [lines.put(x) for x in p],
                         daemon=True).start()
    procs.append((proc, lines, []))
    CHILDREN.append(procs[-1])
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
            if time.monotonic() - t0 >= timeout:
                raise AssertionError(f"no {text!r} after {timeout} s; the "
                                     f"process's stacks and last lines:\n"
                                     + "".join(abort_for_stacks(entry)))
    return next(x for x in seen if text in x).strip()


def abort_for_stacks(entry) -> list:
    """SIGABRT a stuck ``_spawn`` process (its fault handler prints every
    thread's stack as it dies) and return its last lines, the stacks
    among them."""
    import queue
    import signal
    proc, lines, seen = entry
    if proc.poll() is None:
        proc.send_signal(signal.SIGABRT)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        try:
            seen.append(lines.get(timeout=0.5))
        except queue.Empty:
            if proc.poll() is not None:
                break
    return seen[-80:]


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
# Layers whose int8 q/s are held against the CPU quantizer (phase 7 writes
# and loads CUT_LAYERS of them).
QUANT_CHECK_LAYERS = (0, CUT_LAYERS // 2, CUT_LAYERS - 1)


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


def checkpoint_reference(attention, model) -> dict:
    """Phase 7's reference: the seed-0 llama-3-8b preset cut to
    CUT_LAYERS, built as launch.build_engine builds it, serves round 1
    (checked as in phase 3); its prompts, tokens and the teacher-forced
    logits of its first request. The engine is released before this
    returns."""
    import dataclasses

    from dynamo_tpu_torch import launch
    from dynamo_tpu_torch.profile_decode import MAX_PREFILL_TOKENS, MODEL
    args = launch.parse_args(["out=gpu", "--model", MODEL, "--seed", "0"])
    config = dataclasses.replace(cut_depth(launch.build_engine_config(args)),
                                 max_prefill_tokens=MAX_PREFILL_TOKENS)
    engine = launch.load_engine(config, args.resolved_checkpoint, args.seed)
    runner = engine.runner
    prompts = round1_prompts(runner.spec)
    try:
        results, _ = round1(engine, attention, prompts)
    finally:
        engine.stop()
    tokens = [r["tokens"] for r in results]
    _, logits = teacher_forced_check(runner, engine.decode_window,
                                     prompts[0], tokens[0], attention, model,
                                     quant=False)
    ref = {"prompts": prompts, "tokens": tokens,
           "tf_logits": [lg.cpu() for lg in logits]}
    del engine, runner, logits
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def checkpoint_engine(attention, model, directory, ref, extra=()) -> dict:
    """Build the engine from ``directory`` through launch.build_engine,
    serve round 1 on it, and hold its teacher-forced logits against the
    seed-0 preset's (``ref``, checkpoint_reference). Returns the numbers,
    and under "_engine" the stopped engine, which the caller releases."""
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


# Phase 17c: the launcher's in=batch input as a process.
BATCH_PROMPTS = 8
BATCH_MALFORMED_AT = 3  # the malformed line's index among the rows
BATCH_MAX_TOKENS = 16


def batch_launcher(directory: str, tmp: str) -> dict:
    """Phase 17c (see the module docstring): ``python -m
    dynamo_tpu_torch.launch in=batch`` with both parsers named, over the
    checkpoint at ``directory``; the JSONL and its rows in ``tmp``."""
    import os
    from dynamo_tpu_torch.llm.parsers import REASONING_FORMATS, TOOL_FORMATS
    t0 = time.monotonic()
    rng = np.random.default_rng(23)
    lines = [json.dumps({"prompt": " ".join(rng.choice(WORDS, size=n))})
             for n in rng.integers(20, 400, BATCH_PROMPTS)]
    lines.insert(BATCH_MALFORMED_AT, '{"prompt": "unterminated')
    inp = os.path.join(tmp, "batch.jsonl")
    out_path = os.path.join(tmp, "batch-rows.jsonl")
    with open(inp, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")
    assert "deepseek_r1" in REASONING_FORMATS and "hermes" in TOOL_FORMATS
    procs = []
    try:
        entry = _spawn(procs, "dynamo_tpu_torch.launch", "in=batch",
                       "out=gpu", "--model", directory, "--num-pages",
                       "1024", "--input-file", inp, "--output-file",
                       out_path, "--batch-concurrency", "4",
                       "--batch-max-tokens", str(BATCH_MAX_TOKENS),
                       "--reasoning-parser", "deepseek_r1",
                       "--tool-call-parser", "hermes")
        device = _wait_line(entry, "from an engine on", timeout=300)
        assert "from an engine on cuda" in device, device
        summary = json.loads(_wait_line(entry, '"batch_prompts"',
                                        timeout=300))
        proc, _, seen = entry
        code = proc.wait(timeout=120)
        assert code == 0, (code, seen[-20:])
    finally:
        for proc, _, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    with open(out_path, encoding="utf-8") as fh:
        rows = [json.loads(line) for line in fh]
    assert [r["index"] for r in rows] == list(range(BATCH_PROMPTS + 1)), rows
    errors = [r["index"] for r in rows if "error" in r]
    assert errors == [BATCH_MALFORMED_AT], rows
    good = [r for r in rows if "error" not in r]
    assert all(r["tokens"] > 0 and r["finish_reason"] for r in good), good
    assert summary["batch_prompts"] == BATCH_PROMPTS + 1, summary
    assert summary["errors"] == 1, summary
    assert summary["output_tokens"] == sum(r["tokens"] for r in rows), (
        summary, rows)
    out = {"rows": len(rows), "errors": errors,
           "tokens": [r["tokens"] for r in good],
           "finish_reasons": sorted({r["finish_reason"] for r in good}),
           "summary": summary, "seconds": time.monotonic() - t0}
    log(json.dumps({"batch_launcher": out}))
    return out


def checkpoint_phase(attention, model) -> dict:
    """Phase 7 (see the module docstring)."""
    import os
    import shutil
    import tempfile

    from dynamo_tpu_torch.llm.tokenizer import make_test_tokenizer
    t_phase = time.monotonic()
    # The phase compares its checkpoints only with its own preset engine,
    # both CUT_LAYERS deep.
    ref = checkpoint_reference(attention, model)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        usage = shutil.disk_usage(tmp)
        log(f"checkpoint directory {tmp}: {usage.free / 1e9:.2f} GB free of "
            f"{usage.total / 1e9:.2f} GB")
        llama = os.path.join(tmp, "Meta-Llama-3-8B-layout")
        config = dict(LLAMA3_8B_CONFIG, num_hidden_layers=CUT_LAYERS)
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
        batch = batch_launcher(llama, tmp)
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
           "int8_weights_int8_pool": int8_kv, "batch_launcher": batch,
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


def disagg_engine(mode: str, quant_kv: str | None, cut: bool = False):
    """An engine built as ``python -m dynamo_tpu_torch.backends.gpu --mode
    MODE`` builds it (seed-0 llama-3-8b, DISAGG_PAGES pages), with phase
    3's prefill program size; with ``cut``, CUT_LAYERS deep."""
    import dataclasses

    from dynamo_tpu_torch.backends import gpu
    from dynamo_tpu_torch.launch import load_engine
    from dynamo_tpu_torch.profile_decode import MAX_PREFILL_TOKENS, MODEL
    argv = ["--mode", mode, "--model", MODEL, "--seed", "0", "--device",
            DEVICE, "--num-pages", str(DISAGG_PAGES)]
    if quant_kv:
        argv += ["--quant-kv", quant_kv]
    args = gpu.parse_args(argv)
    config = gpu.build_engine_config(args)
    config = dataclasses.replace(cut_depth(config) if cut else config,
                                 max_prefill_tokens=MAX_PREFILL_TOKENS)
    t0 = time.monotonic()
    engine = load_engine(config, args.resolved_checkpoint, args.seed)
    log(f"{mode} engine ({quant_kv or 'bf16'} pool): layers="
        f"{config.model.num_layers} pages="
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


def disagg_reference(engine, ref: dict) -> dict:
    """The int8 passes' reference, as phase 4's holds it: ``ref``'s six
    greedy round-1 prompts and its long prompt served aggregated, at once,
    on ``engine`` (their decode engine, before any pass): the prompts,
    the tokens and TTFTs of the six and the long prompt's tokens."""
    from dynamo_tpu_torch.profile_decode import (MAX_TOKENS, MODEL,
                                                 ROUND2_MAX_TOKENS, serve)

    def request(ids, n):
        return {"model": MODEL, "token_ids": ids,
                "stop_conditions": {"max_tokens": n, "ignore_eos": True},
                "sampling_options": {}}
    out = asyncio.run(serve(engine, [
        request(p, MAX_TOKENS) for p in ref["prompts"][:6]]
        + [request(ref["long_prompt"], ROUND2_MAX_TOKENS)]))
    return {"prompts": ref["prompts"], "long_prompt": ref["long_prompt"],
            "tokens": [r["tokens"] for r in out[:6]],
            "ttft_s": [r["ttft_s"] for r in out[:6]],
            "long_tokens": out[6]["tokens"]}


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
            _, header_s, end_s, nbytes, _ = next(
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
            # The socket path: a pull in the exporting process never takes
            # the device path, and a plane offering it would stage one
            # parcel after the prefill instead of streaming page groups.
            plane = KvPlaneServer(use_device_path=False)
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
        """Greedy ids against phase 3's (bf16 pool) or the int8 reference's
        (disagg_reference) aggregated ids at clear margins, the long
        prompt's too. With ``mixed`` (bf16 parcels into the int8 pool) the
        long prompt's chunks ran over bf16 history where the reference's
        ran over int8 history, so its tokens are held against the plain
        path of this computation instead (whole-prompt prefill,
        teacher-forced decode over the int8 pool): its argmax, or within
        2 x LOGIT_ATOL of it."""
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
            if plane_on:
                # Phase 13 serves this traffic again over the device path.
                plane_pass = {"bodies": st["_bodies"],
                              "tokens": st["_tokens"],
                              "rows": st["requests_remote"]}
            passes.append(st)
        p_engine.stop()
        d_engine.stop()
        del p_engine, d_engine
        free()
        # The int8 passes compare only with the phase's own aggregated
        # reference: their engines are CUT_LAYERS deep.
        p_engine = disagg_engine("prefill", None, cut=True)
        d_engine = disagg_engine("decode", "int8", cut=True)
        ref_int8 = disagg_reference(d_engine, refs["int8"])
        st = run_pass("bf16 parcels into int8 pool", p_engine, d_engine,
                      True, ref_int8)
        check_tokens(st, d_engine, ref_int8, mixed=True)
        passes.append(st)
        p_engine.stop()
        del p_engine
        free()
        p_engine = disagg_engine("prefill", "int8", cut=True)
        st = run_pass("int8 plane", p_engine, d_engine, True, ref_int8)
        check_tokens(st, d_engine, ref_int8)
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
           "subprocesses": sub, "_plane_pass": plane_pass,
           "phase_s": time.monotonic() - t_phase}
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
    builds it in agg mode (seed-0 llama-3-8b at CUT_LAYERS layers,
    DISAGG_PAGES pages), not started: the worker starts it on its event
    loop."""
    import dataclasses

    from dynamo_tpu_torch.backends import gpu
    from dynamo_tpu_torch.launch import load_engine
    from dynamo_tpu_torch.profile_decode import MAX_PREFILL_TOKENS, MODEL
    args = gpu.parse_args(["--model", MODEL, "--seed", "0", "--device",
                           DEVICE, "--num-pages", str(DISAGG_PAGES)])
    config = dataclasses.replace(cut_depth(gpu.build_engine_config(args)),
                                 max_prefill_tokens=MAX_PREFILL_TOKENS)
    t0 = time.monotonic()
    engine = load_engine(config, args.resolved_checkpoint, args.seed,
                         start=False)
    log(f"agg engine: layers={CUT_LAYERS} pages={engine.runner.num_pages} "
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
    """A seed-0 llama-3-8b engine cut to CUT_LAYERS of its 32 layers
    (every width kept), built as ``python -m dynamo_tpu_torch.backends.gpu
    --spec-decode ngram --spec-k 3`` builds it (warmup_windows set,
    DISAGG_PAGES pages, bf16 pool), with phase 3's prefill program size;
    started, so its spec program is captured."""
    import dataclasses

    from dynamo_tpu_torch.backends import gpu
    from dynamo_tpu_torch.launch import load_engine
    from dynamo_tpu_torch.profile_decode import MAX_PREFILL_TOKENS, MODEL
    args = gpu.parse_args(["--model", MODEL, "--seed", "0", "--device",
                           DEVICE, "--num-pages", str(DISAGG_PAGES),
                           "--spec-decode", "ngram",
                           "--spec-k", str(SPEC_K)])
    config = dataclasses.replace(cut_depth(gpu.build_engine_config(args)),
                                 max_prefill_tokens=MAX_PREFILL_TOKENS)
    assert config.warmup_windows and config.spec_decode == "ngram", config
    t0 = time.monotonic()
    engine = load_engine(config, args.resolved_checkpoint, args.seed)
    log(f"spec engine: layers={CUT_LAYERS} pages={engine.runner.num_pages} "
        f"m_outer="
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
    """A seed-0 llama-3-8b engine cut to CUT_LAYERS, built as ``python -m
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
    config = dataclasses.replace(cut_depth(gpu.build_engine_config(args)),
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
    LoRA ops' cost. Returns the numbers."""
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
        base_ms, _ = profiled_step_ms(base, packed, M)
        packed[:8, trunner.PK_ADAPTER] = [1, 2] * 4
        lora_ms, top = profiled_step_ms(runner, packed, M)
        packed[:, trunner.PK_ADAPTER] = 0
    finally:
        engine.allocator.release(pages)
    out = {"step_device_ms_8_rows_on_adapters": lora_ms,
           "step_device_ms_base_runner": base_ms,
           "lora_ops_device_ms": lora_ms - base_ms,
           "lora_ops_share": (lora_ms - base_ms) / lora_ms,
           "top_ops_device_ms_per_step": top, "delta_check": deltas}
    log(f"slot 0: one decode step's logits with the LoRA stacks (ids 0) "
        f"and without are equal bit for bit; a window replayed by this "
        f"runner and by a runner without adapters on the same tensors "
        f"gives the same tokens and logprobs. Decode step, 8 rows x 1224 "
        f"tokens: {lora_ms:.3f} device ms with every row on an adapter "
        f"against {base_ms:.3f} without LoRA "
        f"(LoRA ops {out['lora_ops_device_ms']:.3f} ms, "
        f"{out['lora_ops_share']:.1%})")
    return out


def hot_load_times(engine, reps: int = 1) -> dict:
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


def lora_phase(attention, model) -> dict:
    """Phase 11 (see the module docstring)."""
    import dataclasses
    import shutil
    import tempfile

    from dynamo_tpu_torch.profile_decode import MODEL, serve
    from dynamo_tpu_torch.runtime.errors import (AdapterNotFoundError,
                                                 OverloadedError)
    t_phase = time.monotonic()
    from dynamo_tpu_torch.engine.config import PRESETS
    spec = dataclasses.replace(PRESETS[MODEL], num_layers=CUT_LAYERS)
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
    base_rows = [i for i in range(6) if LORA_ROUND_A[i] is None]
    try:
        results, wall, launches_a, windows_a = lora_served(
            engine, attention, lambda: serve(engine, requests))
        # The greedy base rows' prompts again, alone on the base model:
        # the reference of round A's base rows, which shared their
        # windows with adapter rows.
        alone = asyncio.run(serve(engine, [
            lora_request(spec, prompts[i], None) for i in base_rows]))
    finally:
        engine.stop()
    status = engine.adapters.status()
    assert status["resident"] == {"a": 1, "b": 2}, status
    # Slot-0 rows: bit-identical to a runner without adapters (this also
    # captures the logprobs window program that the replay check below
    # replays after round B's hot-load), and the greedy base rows at the
    # ids served alone or split at a near-tie; the greedy adapter rows at
    # the teacher-forced plain path's argmax through their slots.
    slot0 = slot0_check(engine, model, attention)
    alone_tokens = [None] * len(prompts)
    for i, r in zip(base_rows, alone):
        alone_tokens[i] = r["tokens"]
    base_equal = greedy_agree(runner, model, prompts,
                              [r["tokens"] for r in results], alone_tokens,
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
           "base_rows_equal_alone": f"{base_equal}/{len(base_rows)}",
           "greedy_at_plain_argmax": {"round_a": agree_a,
                                      "round_b": agree_b},
           "replay_vs_eager_after_hot_load_max_abs_logprob_diff":
               replay_diff,
           **slot0,
           "hot_load": hot, "stacks_bytes": runner.lora_bytes,
           "adapter_bytes": written, "register_s": register_s,
           "program": {k: warm[k] for k in ("capture_s", "graph_pool_bytes",
                                             "warmup_s")}}
    log(f"phase 11: {n_tok / wall:.1f} tok/s, TTFT median "
        f"{out['ttft_ms_median']:.0f} ms, TPOT median "
        f"{out['tpot_ms_median']:.2f} ms; base rows equal to the same "
        f"rows alone {out['base_rows_equal_alone']}; greedy adapter ids at "
        f"the plain argmax {out['greedy_at_plain_argmax']}")
    del engine, runner
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.monotonic() - t_phase
    log(json.dumps({"lora_phase": out}))
    log(f"phase 11: {out['phase_s']:.1f}s")
    return out


# -- phase 12: KV tiers ------------------------------------------------------

TIER_PAGES = 512
TIER_HOST_PAGES = 256
# G3 must outlast the replay's own churn: every G3 hit the replay reads is
# promoted into G2, which sends G2's LRU block down to G3, and the
# replay's allocations spill more of set C; at 512 pages G3 drops blocks
# of set A before the replay reaches them (a CPU rehearsal at these page
# counts lost 62 of 252), at 1024 none.
TIER_DISK_PAGES = 1024
TIER_WATERMARKS = "0.2,0.3"
TIER_SETS = (("A", 1024), ("B", 1536), ("C", 1536))
TIER_PROMPTS = 4
TIER_MAX_TOKENS = 16
TIER_SEED = 1357
# Decode under eviction pressure: a fill round, then as many fresh prompts
# of the same shape, which evict the fill's blocks while they prefill and
# decode. Both rounds decode TIER_PRESSURE_TOKENS, so the load round runs
# in page buckets the fill round captured.
TIER_PRESSURE_PROMPTS = 6
TIER_PRESSURE_LEN = 1024
TIER_PRESSURE_TOKENS = 128
TIER_COPY_BLOCKS = 32  # blocks a form of the G2 put's copy is timed over


def tier_engines(disk_dir: str):
    """Worker A as ``python -m dynamo_tpu_torch.backends.gpu --num-pages
    512 --host-cache-pages 256 --kv-disk-cache-dir DIR --kv-watermarks
    0.2,0.3`` builds it (seed-0 llama-3-8b, bf16 pool, phase 3's prefill
    program size; its G3 holds TIER_DISK_PAGES pages), and worker B, an
    engine of the same config without local tiers on A's parameter tensors
    (the same seed-0 weights, without a second copy) and without the
    warmup, whose smallest-bucket programs the phase never runs. Neither
    started."""
    import dataclasses

    from dynamo_tpu_torch.backends import gpu
    from dynamo_tpu_torch.engine.engine import GPUEngine
    from dynamo_tpu_torch.launch import load_engine
    from dynamo_tpu_torch.profile_decode import MAX_PREFILL_TOKENS, MODEL
    args = gpu.parse_args([
        "--model", MODEL, "--seed", "0", "--device", DEVICE,
        "--num-pages", str(TIER_PAGES),
        "--host-cache-pages", str(TIER_HOST_PAGES),
        "--kv-disk-cache-dir", disk_dir, "--kv-watermarks", TIER_WATERMARKS])
    config = dataclasses.replace(gpu.build_engine_config(args),
                                 max_prefill_tokens=MAX_PREFILL_TOKENS,
                                 disk_cache_pages=TIER_DISK_PAGES)
    t0 = time.monotonic()
    a = load_engine(config, args.resolved_checkpoint, args.seed, start=False)
    b = GPUEngine(dataclasses.replace(
        config, host_cache_pages=0, kv_disk_cache_dir=None,
        kv_demote_low_watermark=0.0, kv_demote_high_watermark=0.0,
        warmup_windows=False), params=a.runner.params)
    log(f"tier engines: pages={a.runner.num_pages} each, pool "
        f"{a.runner.kv_pool_bytes / 2**30:.2f} GiB each, A's policy "
        f"{a.kvbm.status()['policy']}, setup={time.monotonic() - t0:.1f}s")
    return a, b


class TierProbe:
    """Timers around the tier paths of workers A and B, set as instance
    attributes before the planes start (``close`` takes them off):

    - A's spill extracts (``runner.extract_pages_async``): CUDA events
      around each and its host seconds, with the pages it took;
    - the onboard uploads of both (``runner.insert_pages``): CUDA events;
    - A's G2 and G3 puts and gets: host seconds, a G2 time only for calls
      that touched no disk file (a put's while G2 fills), a put's own
      time with its G3 write taken out for the others (once G2 is full);
      and per block hash, where A's host tier found it last ("g2" in
      DRAM, "g3" read from its file);
    - B's G4 pulls (``fetch_blocks_sync``: seconds, bytes, blocks, the
      blocks asked for) and
      consults (``RemoteBlockSource.fetch``: seconds, hashes returned);
    - the first-token logits of every prefill row over history.

    A's spill dispatch and readiness poll and both onboard uploads run
    under ``no_stream_sync``: none may wait for the card."""

    def __init__(self, a, b):
        import threading
        self.a, self.b = a, b
        self.spills, self.uploads = [], []
        self.g2 = {"put": [], "get": []}
        # A put's own seconds when it also wrote G2's LRU block to G3 (the
        # G3 write taken out): the steady state once G2 is full.
        self.g2_put_cascading = []
        self.g3 = {"put": [], "get": []}
        self.sources: dict[int, str] = {}
        self.pulls, self.consults = [], []
        self.captured: list[tuple] = []
        self._local = threading.local()
        self._set = []
        ra = a.runner
        self._wrap(ra, "extract_pages_async", self._extract)
        self._wrap(ra, "extract_ready", self._no_sync)
        self._wrap(a, "_flush_spills", self._no_sync)
        for engine in (a, b):
            self._wrap(engine.runner, "insert_pages", self._upload)
            self._wrap(engine.runner, "prefill_batch", self._prefill)
        hc = a.host_cache
        for kind in ("put", "get"):
            self._wrap(hc.disk, kind, self._disk(kind))
            self._wrap(hc, kind, self._host(kind))

    def _wrap(self, obj, name, make) -> None:
        setattr(obj, name, make(getattr(obj, name), obj))
        self._set.append((obj, name))

    def watch_g4(self) -> None:
        """B's G4 source exists once its plane is up."""
        src = self.b.remote_source
        self._wrap(src.client, "fetch_blocks_sync", self._pull)
        self._wrap(src, "fetch", self._consult)

    def close(self) -> None:
        for obj, name in reversed(self._set):
            delattr(obj, name)
        self._set.clear()

    @staticmethod
    def _no_sync(inner, _obj):
        def f(*args, **kw):
            with no_stream_sync():
                return inner(*args, **kw)
        return f

    def _extract(self, inner, _obj):
        def f(pages):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            t0 = time.perf_counter()
            handle = inner(pages)
            host = time.perf_counter() - t0
            ev[1].record()
            self.spills.append((ev, host, len(pages)))
            return handle
        return f

    def _upload(self, inner, runner):
        def f(kv, pages):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            with no_stream_sync():
                inner(kv, pages)
            ev[1].record()
            self.uploads.append((runner is self.a.runner, ev, len(pages)))
        return f

    def _prefill(self, inner, runner):
        def f(seqs, slots=None, count_rows=None):
            out = inner(seqs, slots=slots, count_rows=count_rows)
            for i, seq in enumerate(seqs):
                if seq.start_pos:
                    self.captured.append((
                        runner is self.a.runner, seq.start_pos,
                        seq.tokens.tolist(),
                        runner.last_prefill_logits[i].clone()))
            return out
        return f

    def _disk(self, kind):
        def make(inner, _obj):
            def f(*args, **kw):
                t0 = time.perf_counter()
                out = inner(*args, **kw)
                dt = time.perf_counter() - t0
                self.g3[kind].append(dt)
                self._local.disk = True
                self._local.disk_s = getattr(self._local, "disk_s", 0.0) + dt
                return out
            return f
        return make

    def _host(self, kind):
        def make(inner, _obj):
            def f(*args, **kw):
                local = self._local
                outer = not getattr(local, "depth", 0)
                if outer:
                    local.disk, local.disk_s = False, 0.0
                local.depth = getattr(local, "depth", 0) + 1
                t0 = time.perf_counter()
                try:
                    out = inner(*args, **kw)
                finally:
                    local.depth -= 1
                dt = time.perf_counter() - t0
                if outer:
                    if not local.disk:
                        self.g2[kind].append(dt)
                    elif kind == "put":
                        self.g2_put_cascading.append(dt - local.disk_s)
                    if kind == "get" and out is not None:
                        self.sources[args[0]] = "g3" if local.disk else "g2"
                return out
            return f
        return make

    def _pull(self, inner, _obj):
        def f(addr, hashes, *args, **kw):
            t0 = time.perf_counter()
            found, arr = inner(addr, hashes, *args, **kw)
            self.pulls.append((time.perf_counter() - t0,
                               0 if arr is None else arr.nbytes, len(found),
                               len(hashes)))
            return found, arr
        return f

    def _consult(self, inner, _obj):
        def f(*args, **kw):
            t0 = time.perf_counter()
            out = inner(*args, **kw)
            self.consults.append((time.perf_counter() - t0,
                                  [h for h, _ in out]))
            return out
        return f

    def numbers(self) -> dict:
        """Per-block times, after a synchronize."""
        torch.cuda.synchronize()

        def per_block(rows):
            n = sum(r[-1] for r in rows)
            return (sum(r[0][0].elapsed_time(r[0][1]) for r in rows) / n
                    if n else None)

        def mean(xs, scale):
            return sum(xs) / len(xs) * scale if xs else None
        spill_blocks = sum(n for _, _, n in self.spills)
        ups = {side: [(ev, n) for is_a, ev, n in self.uploads
                      if is_a == (side == "A")] for side in ("A", "B")}
        # GB/s over the pulls that brought blocks.
        pull_s = sum(p[0] for p in self.pulls if p[2])
        pull_b = sum(p[1] for p in self.pulls if p[2])
        return {
            "spill_flushes": len(self.spills), "spill_blocks": spill_blocks,
            "spill_device_ms_per_block": per_block(self.spills),
            "spill_host_ms_per_block": (
                sum(h for _, h, _ in self.spills) / spill_blocks * 1e3
                if spill_blocks else None),
            "g2_put_us_per_block": mean(self.g2["put"], 1e6),
            "g2_get_us_per_block": mean(self.g2["get"], 1e6),
            "g2_put_cascading_us_per_block": mean(self.g2_put_cascading, 1e6),
            "g3_put_ms_per_block": mean(self.g3["put"], 1e3),
            "g3_get_ms_per_block": mean(self.g3["get"], 1e3),
            "g2_samples": {k: len(v) for k, v in self.g2.items()},
            "g2_put_cascading_samples": len(self.g2_put_cascading),
            "g3_samples": {k: len(v) for k, v in self.g3.items()},
            "upload_device_ms_per_block": {
                side: per_block(rows) for side, rows in ups.items()},
            "g4_pulls": len(self.pulls),
            "g4_pull_ms": [p[0] * 1e3 for p in self.pulls],
            "g4_pull_blocks": [p[2] for p in self.pulls],
            "g4_ask_blocks": [p[3] for p in self.pulls],
            "g4_gb_per_s": pull_b / pull_s / 1e9 if pull_s else None,
        }


def tier_round(engine, attention, on_loop, prompts, label: str,
               max_tokens: int = TIER_MAX_TOKENS) -> dict:
    """Serve ``prompts`` concurrently (greedy, ``max_tokens`` each) and
    check them: every request finishes at its length, every window
    replayed its graph, and every decode step of every layer launched
    paged_attention_hist (never the int8 entry)."""
    from dynamo_tpu_torch.profile_decode import MODEL, serve
    spec = engine.runner.spec
    requests = [{"model": MODEL, "token_ids": p,
                 "stop_conditions": {"max_tokens": max_tokens,
                                     "ignore_eos": True},
                 "sampling_options": {}} for p in prompts]
    attention.KERNEL.launches = 0
    attention.KERNEL.launches_int8 = 0
    windows0 = engine.windows_dispatched
    replays0 = engine.runner.window_replays
    t0 = time.monotonic()
    results = on_loop(serve(engine, requests))
    wall = time.monotonic() - t0
    launches = {"paged_attention_hist": attention.KERNEL.launches,
                "paged_attention_hist_int8": attention.KERNEL.launches_int8}
    windows = engine.windows_dispatched - windows0
    check_replays(engine, replays0, windows)
    for i, r in enumerate(results):
        assert r["finish"] == "length", (label, i, r["finish"])
        assert len(r["tokens"]) == max_tokens, (label, i)
        assert all(0 <= t < spec.vocab_size for t in r["tokens"])
    expected = windows * engine.decode_window * spec.num_layers
    assert launches["paged_attention_hist"] == expected > 0, (
        label, launches, expected)
    assert launches["paged_attention_hist_int8"] == 0, (label, launches)

    def median(xs):
        n = len(xs)
        return (xs[n // 2 - 1] + xs[n // 2]) / 2 if n % 2 == 0 \
            else xs[n // 2]
    ttft = sorted(r["ttft_s"] * 1e3 for r in results)
    tpot = sorted((r["total_s"] - r["ttft_s"]) / (max_tokens - 1) * 1e3
                  for r in results)
    return {"label": label, "windows": windows, "wall_s": wall,
            "launches": launches, "ttft_ms": ttft,
            "ttft_ms_median": median(ttft), "tpot_ms": tpot,
            "tpot_ms_median": median(tpot),
            "tok_per_s": len(results) * max_tokens / wall}


def block_bytes(on_loop, engine, hashes) -> dict:
    """The pool's bytes of the pages that hold ``hashes`` (all registered
    on ``engine``), per hash, read on its engine thread."""
    def job():
        pages = engine.allocator.lookup(hashes)
        assert len(pages) == len(hashes), (len(pages), len(hashes))
        arrs = pool_pages(engine.runner, pages)
        return {h: [a[:, :, i].copy() for a in arrs]
                for i, h in enumerate(hashes)}
    return on_loop(engine.run_job(job))


def put_copy_forms(engine) -> dict:
    """The G2 put's copy (``np.array(kv, copy=True)``) alone, on the
    engine's thread: the median us a block over TIER_COPY_BLOCKS blocks
    of one batched extract, in five forms. From the flush's page-locked
    buffer through the strided one-block view ``_resolve_spills`` hands
    the put: into pages newly mapped from the OS (a G2 growing into
    memory the process never touched), into fresh memory (what the put
    does; it may reuse memory the process freed) and into one reused
    buffer; and from pageable contiguous copies of the same blocks, into
    fresh and into reused memory. Fresh copies are kept, as G2 keeps
    them."""
    import mmap
    runner = engine.runner
    pages = list(engine.allocator.cached.values())[:TIER_COPY_BLOCKS]
    assert len(pages) == TIER_COPY_BLOCKS, len(pages)
    # The class's method: the probe's timers stay out of this.
    kv = runner.finalize_extract(
        type(runner).extract_pages_async(runner, pages))
    views = [kv[:, :, :, i] for i in range(len(pages))]
    pageable = [np.array(v) for v in views]
    dst = np.array(views[0])

    def median_us(srcs, copy) -> float:
        times, kept = [], []
        for v in srcs:
            t0 = time.perf_counter()
            kept.append(copy(v))
            times.append(time.perf_counter() - t0)
        times.sort()
        n = len(times)
        return (times[n // 2 - 1] + times[n // 2]) / 2 * 1e6

    def to_new_pages(v):
        buf = mmap.mmap(-1, v.nbytes)
        out = np.frombuffer(buf, v.dtype).reshape(v.shape)
        np.copyto(out, v)
        return out

    return {
        "pinned_strided_to_new_pages": median_us(views, to_new_pages),
        "pinned_strided_to_fresh": median_us(
            views, lambda v: np.array(v, copy=True)),
        "pinned_strided_to_reused": median_us(
            views, lambda v: np.copyto(dst, v)),
        "pageable_contiguous_to_fresh": median_us(
            pageable, lambda v: np.array(v, copy=True)),
        "pageable_contiguous_to_reused": median_us(
            pageable, lambda v: np.copyto(dst, v)),
        "block_bytes": int(views[0].nbytes)}


def tier_phase(attention, model) -> dict:
    """Phase 12 (see the module docstring)."""
    import shutil
    import socket
    import tempfile
    import threading

    from dynamo_tpu_torch.backends.gpu import close_kv_plane, start_kv_plane
    from dynamo_tpu_torch.engine.config import PRESETS
    from dynamo_tpu_torch.llm.tokens import compute_block_hashes
    from dynamo_tpu_torch.profile_decode import MODEL, smi_line
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    t_phase = time.monotonic()
    smi = smi_line()
    spec = PRESETS[MODEL]
    page = 16
    rng = np.random.default_rng(TIER_SEED)
    sets = {name: [rng.integers(0, spec.vocab_size, n).tolist()
                   for _ in range(TIER_PROMPTS)] for name, n in TIER_SETS}
    fresh = rng.integers(0, spec.vocab_size, 1024).tolist()
    warm = rng.integers(0, spec.vocab_size, 1024).tolist()
    allowed = {name: (n - 1) // page for name, n in TIER_SETS}
    hashes = {name: [compute_block_hashes(p, page)[:allowed[name]]
                     for p in sets[name]] for name in ("A", "B")}
    hashes_a = hashes["A"]
    disk_dir = tempfile.mkdtemp(prefix="chip_smoke_g3_")
    log(f"G3 directory {disk_dir}: "
        f"{shutil.disk_usage(disk_dir).free / 2**30:.1f} GiB free")
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def on_loop(coro, timeout=600):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    a, b = tier_engines(disk_dir)
    probe = TierProbe(a, b)
    rts, planes = [], []

    async def up():
        for engine in (a, b):
            rt = await (DistributedRuntime.with_embedded_coordinator(
                RuntimeConfig()) if not rts else
                DistributedRuntime.from_settings(RuntimeConfig(
                    coordinator_url=rts[0].config.coordinator_url)))
            rts.append(rt)
            await asyncio.get_running_loop().run_in_executor(
                None, engine.start, loop)
            planes.append(await start_kv_plane(rt, engine, MODEL))
        deadline = time.monotonic() + 60
        while (b.remote_source.peers != [planes[0][0].address]
               or a.remote_source.peers != [planes[1][0].address]):
            assert time.monotonic() < deadline, "planes not discovered"
            await asyncio.sleep(0.02)

    async def down():
        for engine, (plane, task) in reversed(list(zip((a, b), planes))):
            await close_kv_plane(engine, plane, task)
        for rt in reversed(rts):
            await rt.close()

    def counts(engine) -> dict:
        hc = engine.host_cache.stats() if engine.host_cache else {}
        return {"onboard": engine.onboard_blocks, "g4": engine.g4_blocks,
                "hits": engine.prefix_hit_blocks,
                "g2_hits": hc.get("g2_hits", 0),
                "g3_hits": hc.get("g3_hits", 0)}

    def delta(after, before):
        return {k: after[k] - before[k] for k in after}

    rounds, checks = [], {}
    try:
        on_loop(up())
        graph_stats(a, "tier worker A after its warmup")
        probe.watch_g4()
        log(f"planes: A {planes[0][0].address} B {planes[1][0].address}; "
            f"B's G4 peers {b.remote_source.peers}, budget "
            f"{b.remote_source.budget_s} s")
        # One throwaway request on each worker captures the window programs
        # of the page bucket the traffic runs in (the warmup makes only
        # the smallest bucket's), so no TTFT below holds a capture; then
        # its blocks are dropped, not spilled.
        for engine in (a, b):
            tier_round(engine, attention, on_loop, [warm], "warm")
            on_loop(engine.run_job(engine.allocator.clear_inactive))
        # Sets A and B, each followed by its pool bytes (before anything
        # evicts them), then set C.
        snap = {}
        for name in ("A", "B", "C"):
            rounds.append(tier_round(a, attention, on_loop, sets[name],
                                     f"{name} cold"))
            for hs in hashes.get(name, ()):
                snap.update(block_bytes(on_loop, a, hs))
        on_loop(a.run_job(lambda: a._resolve_spills(force=True)))
        log(f"after set C: G1 {a.allocator.stats()}, tiers "
            f"{a.host_cache.stats()}")
        # G2 holds what was evicted last: set B's blocks. The set-B prompt
        # with the most of its blocks in DRAM, again: blocks from G2.
        in_g2 = set(a.host_cache.block_hashes())
        pick = max(range(TIER_PROMPTS),
                   key=lambda i: sum(h in in_g2 for h in hashes["B"][i]))
        probe.sources.clear()
        probe.captured.clear()
        before = counts(a)
        rounds.append(tier_round(a, attention, on_loop, [sets["B"][pick]],
                                 "one of B from G2"))
        d = delta(counts(a), before)
        g2_sources = dict(probe.sources)
        g2_captured = list(probe.captured)
        assert d["hits"] + d["onboard"] == allowed["B"], d
        assert "g2" in g2_sources.values(), g2_sources
        got = block_bytes(on_loop, a, list(g2_sources))
        for h in g2_sources:
            assert all(np.array_equal(x, y) for x, y in zip(got[h], snap[h])), \
                f"onboarded block {h:x} differs from its evicted bytes"
        checks["g2_replay"] = dict(d, prompt=pick, bit_identical_by_tier={
            t: sum(v == t for v in g2_sources.values()) for t in ("g2", "g3")})
        # The replay of set A: every allowed block from the host tiers.
        probe.sources.clear()
        before = counts(a)
        probe.captured.clear()
        rounds.append(tier_round(a, attention, on_loop, sets["A"],
                                 "A onboarded"))
        d = delta(counts(a), before)
        replay_sources = dict(probe.sources)
        replay_captured = list(probe.captured)
        assert d["onboard"] == TIER_PROMPTS * allowed["A"], d
        assert d["hits"] == 0 and d["g4"] == 0, d
        assert d["g3_hits"] > 0, d
        checks["replay"] = d
        replayed = [h for hs in hashes_a for h in hs]
        got = {}
        for hs in hashes_a:
            got.update(block_bytes(on_loop, a, hs))
        by_src = {"g2": 0, "g3": 0}
        for h in replayed:
            assert all(np.array_equal(x, y) for x, y in zip(got[h], snap[h])), \
                f"onboarded block {h:x} differs from its evicted bytes"
            by_src[replay_sources[h]] += 1
        checks["replay_bit_identical_by_tier"] = by_src
        # One immediate repeat: the same prompts from G1.
        before = counts(a)
        rounds.append(tier_round(a, attention, on_loop, sets["A"],
                                 "A from G1"))
        d = delta(counts(a), before)
        assert d["hits"] == TIER_PROMPTS * allowed["A"], d
        assert d["onboard"] == 0, d
        # After A's traffic: the watermark sweep demoted, and A settles at or above its low
        # watermark (each sweep aims at the high one, at most
        # max_demotions_per_sweep blocks at a time).
        policy = a.kvbm.policy
        deadline = time.monotonic() + 30
        while a.kvbm.free_fraction() < policy.low_watermark:
            assert time.monotonic() < deadline, a.kvbm.status()
            time.sleep(0.05)
        kvbm = a.kvbm.status()
        assert kvbm["watermark_demotions"] > 0, kvbm
        # Worker B serves set A over G4 from A's host tiers, at the
        # worker's budget: each consult asks A for the head of the prompt
        # that the budget carries, and B recomputes the rest.
        on_loop(a.run_job(a.allocator.clear_inactive))
        src = b.remote_source
        probe.sources.clear()
        probe.consults.clear()
        probe.pulls.clear()
        before = counts(b)
        rs0 = src.stats()
        rounds.append(tier_round(b, attention, on_loop, sets["A"],
                                 "A on B over G4"))
        d = delta(counts(b), before)
        rs = {k: src.stats()[k] - rs0[k] for k in (
            "fetch_failures", "slow_peer_cooldowns", "breaker_open_skips")}
        asks = [(p[3], p[2], p[0]) for p in probe.pulls]
        log(f"B's G4 pulls (asked, got, ms): "
            f"{[(n, g, round(t * 1e3, 1)) for n, g, t in asks]}, budget "
            f"{src.budget_s} s | {smi}")
        assert not any(rs.values()), (rs, src.stats())
        assert len(asks) == TIER_PROMPTS, asks
        assert all(g == n >= 1 and t <= src.budget_s for n, g, t in asks), \
            asks
        pulled = [h for _, hs in probe.consults for h in hs]
        assert d["g4"] == d["onboard"] == len(pulled) == sum(
            g for _, g, _ in asks), (d, len(pulled))
        g4_sources = {"g2": 0, "g3": 0}
        for h in pulled:
            g4_sources[probe.sources[h]] += 1
        got = block_bytes(on_loop, b, pulled)
        for h in pulled:
            assert all(np.array_equal(x, y) for x, y in zip(got[h], snap[h])), \
                f"G4 block {h:x} differs from its evicted bytes"
        checks["g4"] = dict(d, pulled=len(pulled), remote=rs,
                            asked=[n for n, _, _ in asks],
                            a_side_sources=g4_sources)
        # First-token logits of every replay row against the whole prompt.
        worst = 0.0
        for rows, runner, prompts in (
                (g2_captured, a.runner, [sets["B"][pick]]),
                (replay_captured, a.runner, sets["A"]),
                ([c for c in probe.captured if not c[0]], b.runner,
                 sets["A"])):
            rows = [c for c in rows if c[1] > 0]
            for p in prompts:
                got_rows = [lg for _, s, toks, lg in rows
                            if toks == p[s:]]
                assert got_rows, "a replay row was not captured"
                want = plain_forced_logits(runner, model, p, [0], False)[0]
                diff = float((got_rows[-1] - want).abs().max())
                assert torch.isfinite(got_rows[-1]).all()
                assert diff <= LOGIT_ATOL, diff
                worst = max(worst, diff)
        checks["first_token_logit_max_abs_diff"] = worst
        # A dead peer ahead of A: its breaker opens, the consult stays in
        # its budget, and a prompt no tier holds recomputes.
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            dead = f"127.0.0.1:{s.getsockname()[1]}"
        src.peers = [dead] + src.peers
        probe.consults.clear()
        fails0 = src.fetch_failures
        rounds.append(tier_round(b, attention, on_loop, [fresh],
                                 "fresh on B, dead peer first"))
        consult_s = max(s for s, _ in probe.consults)
        assert src.fetch_failures == fails0 + 1, src.stats()
        assert src.stats()["breakers_open"] == 1, src.stats()
        assert consult_s <= src.budget_s * 1.5, consult_s
        checks["dead_peer"] = {"consult_ms": consult_s * 1e3,
                               "budget_ms": src.budget_s * 1e3,
                               "breaker": src.stats()}
        src.drop_peer(dead)
        # Decode under eviction pressure, the same traffic on B (no local
        # tiers; first, so A's tiers hold none of it) and on A.
        prng = np.random.default_rng(TIER_SEED + 1)
        fill, load = ([prng.integers(0, spec.vocab_size,
                                     TIER_PRESSURE_LEN).tolist()
                       for _ in range(TIER_PRESSURE_PROMPTS)]
                      for _ in range(2))
        pressure = {}
        for name, engine in (("B", b), ("A", a)):
            on_loop(engine.run_job(engine.allocator.clear_inactive))
            rounds.append(tier_round(engine, attention, on_loop, fill,
                                     f"fill on {name}", TIER_PRESSURE_TOKENS))
            alloc = engine.allocator
            displaced0 = alloc.evicted_blocks + alloc.demoted_blocks
            spills0 = len(probe.spills)
            r = tier_round(engine, attention, on_loop, load,
                           f"pressure on {name}", TIER_PRESSURE_TOKENS)
            rounds.append(r)
            pressure[name] = {
                "tpot_ms_median": r["tpot_ms_median"],
                "tpot_ms": r["tpot_ms"], "ttft_ms_median": r["ttft_ms_median"],
                "tok_per_s": r["tok_per_s"],
                "displaced_blocks": (alloc.evicted_blocks
                                     + alloc.demoted_blocks - displaced0),
                "spill_flushes": len(probe.spills) - spills0,
                "spilled_blocks": sum(n for _, _, n in probe.spills[spills0:])}
        # Both pools gave up the fill's blocks; only A spilled them.
        assert pressure["A"]["displaced_blocks"] > 0, pressure
        assert pressure["B"]["displaced_blocks"] > 0, pressure
        assert pressure["A"]["spilled_blocks"] > 0, pressure
        checks["pressure"] = pressure
        log(f"phase 12 decode under eviction pressure | {smi}: TPOT median "
            f"{pressure['A']['tpot_ms_median']:.2f} ms with tiers (A), "
            f"{pressure['B']['tpot_ms_median']:.2f} ms without (B); "
            f"{json.dumps(pressure)}")
        copy_us = on_loop(a.run_job(lambda: put_copy_forms(a)))
        log(f"phase 12 G2 put copy, us a 2 MiB block (median of "
            f"{TIER_COPY_BLOCKS}) | {smi}: {json.dumps(copy_us)}")
        for engine in (a, b):
            status = engine.kv_status()["kvbm"]
            fails = {k: status[k] for k in ("spill_failures",
                                            "onboard_failures",
                                            "peer_pull_failures")}
            assert not any(fails.values()), fails
        # The dead peer's consult is the only failed one of either worker.
        assert b.kv_status()["remote"]["fetch_failures"] == 1, src.stats()
        assert a.kv_status()["remote"]["fetch_failures"] == 0, \
            a.remote_source.stats()
        status_a = a.kv_status()
        digest = status_a["digest"]["tier_blocks"]
        assert digest.get("g2", 0) > 0 and digest.get("g3", 0) > 0, digest
    finally:
        probe.close()
        try:
            on_loop(down())
        finally:
            a.stop()
            b.stop()
            loop.call_soon_threadsafe(loop.stop)
            thread.join(timeout=10)
    numbers = probe.numbers()
    cold, onboarded, g1 = (rounds[0]["ttft_ms_median"],
                           rounds[4]["ttft_ms_median"],
                           rounds[5]["ttft_ms_median"])
    out = {"rounds": rounds, "checks": checks, "numbers": numbers,
           "tiers": status_a["tiers"], "reuse": status_a["reuse"],
           "kvbm": {k: kvbm[k] for k in (
               "free_fraction", "watermark_demotions", "demotion_sweeps",
               "promotions", "recompute_fallbacks")},
           "digest_tier_blocks": digest,
           "ttft_ms_median": {"A_cold": cold, "A_onboarded": onboarded,
                              "A_from_g1": g1,
                              "A_on_B_g4": rounds[6]["ttft_ms_median"],
                              "fresh_on_B_dead_peer_first":
                                  rounds[7]["ttft_ms_median"],
                              "B_cold": rounds[1]["ttft_ms_median"],
                              "one_of_B_from_g2": rounds[3]["ttft_ms"][0]},
           "launches": {k: sum(r["launches"][k] for r in rounds)
                        for k in rounds[0]["launches"]},
           "pressure": pressure, "put_copy_us": copy_us, "smi": smi}
    log(f"phase 12 tiers | {smi}: spill extract "
        f"{numbers['spill_device_ms_per_block']} device ms and "
        f"{numbers['spill_host_ms_per_block']} host ms per block; G2 put/get "
        f"{numbers['g2_put_us_per_block']}/{numbers['g2_get_us_per_block']} "
        f"us per block (a put once G2 is full, its G3 write taken out: "
        f"{numbers['g2_put_cascading_us_per_block']} us); G3 put/get {numbers['g3_put_ms_per_block']}/"
        f"{numbers['g3_get_ms_per_block']} ms per block; onboard upload "
        f"{numbers['upload_device_ms_per_block']} device ms per block; G4 "
        f"pulls {numbers['g4_pull_ms']} ms for {numbers['g4_pull_blocks']} "
        f"blocks at {numbers['g4_gb_per_s']} GB/s")
    log(f"phase 12 TTFT median | {smi}: set A cold {cold:.1f} ms, "
        f"onboarded {onboarded:.1f} ms, from G1 {g1:.1f} ms, on B over G4 "
        f"{out['ttft_ms_median']['A_on_B_g4']:.1f} ms")
    del a, b, probe
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(disk_dir, ignore_errors=True)
    out["phase_s"] = time.monotonic() - t_phase
    log(json.dumps({"tiers_phase": out}, default=str))
    log(f"phase 12: {out['phase_s']:.1f}s")
    return out


# Phase 13: the KV plane's device path. 13a's parcels, in pages: one page,
# 64 (a 1024-token prompt) and 375 (the 6000-token prompt's).
PARCEL_PAGES = (1, 64, 375)
PARCEL_SEED = 2718
PARCEL_PAGE = 16  # the workers' --page-size
SINK_WAIT_S = 120  # 13a's second process answers in 10-15 s
# 13b: a fresh prompt sent once through the frontend over HTTP.
FLEET_HTTP_PROMPT = 600


def parcel_sink(conn, tickets, pool_shape, device, ipc) -> None:
    """Phase 13a's second process: pull every ticket into fresh pages of
    its own pool of ``pool_shape`` and send back, per ticket, the path
    it took, the sha256 of its pool's bytes at those pages, the pull's
    seconds, the handle open's (device) or the first byte's (socket), and
    its client's counters. ``ipc``: the plane's exporter (None: CUDA
    IPC)."""
    import hashlib

    import ctypes
    import faulthandler

    from dynamo_tpu_torch.llm.kv_plane import KvPlaneClient
    ctypes.CDLL(None).prctl(1, 9)  # PR_SET_PDEATHSIG: die with the script
    faulthandler.enable()  # the watchdog's SIGABRT prints the stacks
    try:
        if device == "cuda":
            torch.cuda.set_device(0)
        client = KvPlaneClient(ipc=ipc)
        k = torch.zeros(pool_shape, dtype=torch.bfloat16, device=device)
        v = torch.zeros_like(k)
        pulls, first = [], 0
        for ticket in tickets:
            n = ticket["shape"][3]
            idx = torch.arange(first, first + n, device=device)
            first += n
            t0 = time.perf_counter()
            kv = client.pull_sync(ticket)
            pull_s = time.perf_counter() - t0
            if not torch.is_tensor(kv):
                kv = torch.from_numpy(kv.view(np.int16)).view(
                    torch.bfloat16).to(device)
            k[:, :, idx] = kv[0]
            v[:, :, idx] = kv[1]
            bits = torch.stack([k[:, :, idx], v[:, :, idx]]).view(
                torch.int16).cpu().numpy()
            _, head_s, end_s, nbytes, path = client.recent[-1]
            pulls.append({"pages": n, "path": path, "bytes": nbytes,
                          "sha256": hashlib.sha256(bits.tobytes()).hexdigest(),
                          "pull_s": pull_s, "head_s": head_s,
                          "end_s": end_s})
        client.close()
        conn.send({"pulls": pulls, "stats": client.stats()})
    except BaseException:
        conn.send({"error": traceback.format_exc()})
        raise
    finally:
        conn.close()


def _page_index(pages, device):
    """A page index on ``device`` without a blocking copy (the runner's
    upload)."""
    idx = torch.tensor(pages, dtype=torch.int64)
    if device == "cuda":
        idx = idx.pin_memory()
    return idx.to(device, non_blocking=True)


def _stage_parcel(server, k, v, pages, device_path: bool):
    """Stage the pool pages ``pages`` as one parcel gathered on the card
    (a device ticket, or a socket-only one), the gather, event and
    staging dispatched under ``no_stream_sync``; returns the ticket and
    the sha256 of the parcel's bytes."""
    import hashlib

    from dynamo_tpu_torch.engine.runner import ModelRunner
    with no_stream_sync():
        idx = _page_index(pages, DEVICE)
        parcel = torch.stack([k[:, :, idx], v[:, :, idx]])
        event = None   # the CPU rehearsal's
        if DEVICE == "cuda":
            event = torch.cuda.Event(interprocess=True)
            event.record()
        handle = (parcel, event)
        ticket = server.stage(
            meta={"shape": list(parcel.shape), "dtype": "bfloat16"},
            device_tensor=parcel if device_path else None, event=event,
            prompt_len=len(pages) * PARCEL_PAGE,
            resolve=lambda: ModelRunner.device_parcel_to_host(handle))
    assert ("cuda_ipc" in ticket) == device_path, ticket.keys()
    return ticket, hashlib.sha256(
        parcel.view(torch.int16).cpu().numpy().tobytes()).hexdigest()


def parcel_check(ipc=None) -> dict:
    """Phase 13a (see the module docstring). ``ipc``: the plane's exporter
    for both processes (None: CUDA IPC; a CPU rehearsal passes a fake)."""
    import multiprocessing
    import os
    import signal

    from dynamo_tpu_torch.engine.config import PRESETS
    from dynamo_tpu_torch.llm.kv_plane import KvPlaneServer
    from dynamo_tpu_torch.profile_decode import MODEL

    t_phase = time.monotonic()
    spec = PRESETS[MODEL]
    total = sum(PARCEL_PAGES)
    shape = (spec.num_layers, spec.num_kv_heads, total + 1, PARCEL_PAGE,
             spec.head_dim)
    gen = torch.Generator(device=DEVICE).manual_seed(PARCEL_SEED)
    k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(
        torch.bfloat16) for _ in range(2))
    # Each parcel's pages in a shuffled order, as a page table holds them.
    order = torch.randperm(total, generator=torch.Generator().manual_seed(
        PARCEL_SEED)).add(1).tolist()
    server = KvPlaneServer(ipc=ipc)
    assert server.device_path, server.device_path_reason
    server.start()
    sink = None
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        tickets, want, first = [], [], 0
        for n in PARCEL_PAGES:
            pages = order[first:first + n]
            first += n
            for device_path in (True, False):
                ticket, sha = _stage_parcel(server, k, v, pages, device_path)
                tickets.append(ticket)
                want.append(sha)
        staged_bytes = torch.cuda.memory_allocated() - base
        ctx = multiprocessing.get_context("spawn")
        here, there = ctx.Pipe()
        sink_shape = shape[:2] + (2 * total,) + shape[3:]
        t0 = time.monotonic()
        sink = ctx.Process(target=parcel_sink, args=(
            there, tickets, sink_shape, DEVICE, ipc))
        sink.start()
        CHILDREN.append((sink, None, []))
        if not here.poll(SINK_WAIT_S):
            # Its fault handler prints its stacks to this stderr.
            os.kill(sink.pid, signal.SIGABRT)
            sink.join(10)
            raise AssertionError(f"the sink process did not answer in "
                                 f"{SINK_WAIT_S} s (its stacks are above)")
        got = here.recv()
        sink_s = time.monotonic() - t0
        assert "error" not in got, got["error"]
        sink.join(60)
        assert sink.exitcode == 0, sink.exitcode
        pulls, stats = got["pulls"], got["stats"]
        assert [p["path"] for p in pulls] == ["device", "socket"] * len(
            PARCEL_PAGES), [p["path"] for p in pulls]
        assert [p["sha256"] for p in pulls] == want, (
            "a parcel's pages differ from the source's")
        assert (stats["device_pulls"], stats["device_pull_failures"],
                stats["socket_pulls"]) == (len(PARCEL_PAGES), 0,
                                           len(PARCEL_PAGES)), stats
        deadline = time.monotonic() + 30
        while server.stats()["staged"]:
            assert time.monotonic() < deadline, server.stats()
            time.sleep(0.01)
        st = server.stats()
        assert st["device_done"] == st["device_stages"] == len(PARCEL_PAGES)
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        assert after <= base, (
            f"{after - base} bytes still allocated after every parcel was "
            f"pulled: a staged tensor outlived its ticket")
    finally:
        if sink is not None and sink.is_alive():
            sink.kill()
            sink.join(30)
        server.close()
    rows = []
    for p in pulls:
        row = {"pages": p["pages"], "path": p["path"], "bytes": p["bytes"],
               "pull_ms": p["pull_s"] * 1e3,
               "GBps": p["bytes"] / p["pull_s"] / 1e9}
        row["open_ms" if p["path"] == "device" else "first_byte_ms"] = (
            p["head_s"] * 1e3)
        rows.append(row)
        log(json.dumps({"parcel_pull": row}))
    out = {"pulls": rows, "staged_bytes": staged_bytes,
           "allocated_after_minus_base": after - base, "sink_s": sink_s,
           "probe": server.device_path_reason,
           "phase_s": time.monotonic() - t_phase}
    log(f"13a: {len(tickets)} parcels of {PARCEL_PAGES} pages pulled by a "
        f"second process, each bit-exact over its path; staged "
        f"{staged_bytes / 2**20:.1f} MiB on the card, all freed after the "
        f"pulls; sink process {sink_s:.1f}s; probe: {out['probe']}")
    del k, v
    torch.cuda.empty_cache()
    return out


async def fleet_traffic(url: str, bodies: list[dict]) -> list[dict]:
    """Phase 8's traffic to the decode worker's endpoint through the
    request plane, as the frontend sends it, all at once, the greedy
    requests with their top-2 logprobs: per request its token ids, the
    top-2 margin behind each (None where no logprobs came: the sampled
    requests, and the first token of a remote prompt, which comes from
    the prefill worker) and the client's TTFT and TPOT."""
    from dynamo_tpu_torch.profile_decode import MODEL
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    rt = await DistributedRuntime.from_settings(
        RuntimeConfig(coordinator_url=url))
    client = await rt.namespace().component("gpu").endpoint(
        "generate").client()
    try:
        await client.wait_for_instances(60)

        async def one(body):
            sampling = {k: body[k] for k in ("temperature", "top_p", "seed")
                        if k in body}
            if "temperature" not in sampling:
                sampling["logprobs"] = 2
            wire = {"model": MODEL, "token_ids": body["prompt"],
                    "stop_conditions": {"max_tokens": body["max_tokens"],
                                        "ignore_eos": True},
                    "sampling_options": sampling}
            t0 = time.perf_counter()
            ids, margins, times = [], [], []
            async for item in await client.generate(wire):
                if item.get("token_ids"):
                    ids.extend(item["token_ids"])
                    tops = item.get("top_log_probs") or [None] * len(
                        item["token_ids"])
                    margins.extend(None if t is None else
                                   t[0]["logprob"] - t[1]["logprob"]
                                   for t in tops)
                    times.append(time.perf_counter() - t0)
            return {"tokens": ids, "margins": margins,
                    "ttft_ms": times[0] * 1e3,
                    "tpot_ms": (times[-1] - times[0]) / (len(ids) - 1) * 1e3}
        return list(await asyncio.gather(*[one(b) for b in bodies]))
    finally:
        await client.close()
        await rt.close()


def _exit_line(entry, timeout=120) -> dict:
    """The ``GPU_WORKER_EXIT`` counters of a ``_spawn`` worker that was
    sent SIGTERM: waits for its exit code 0, then for the line."""
    import queue
    proc, lines, seen = entry
    code = proc.wait(timeout=timeout)
    assert code == 0, (code, seen[-20:])
    deadline = time.monotonic() + 30
    while not any(x.startswith("GPU_WORKER_EXIT ") for x in seen):
        assert time.monotonic() < deadline, seen[-20:]
        try:
            seen.append(lines.get(timeout=1))
        except queue.Empty:
            pass
    line = next(x for x in seen if x.startswith("GPU_WORKER_EXIT "))
    return json.loads(line.split(" ", 1)[1])


def device_fleet(ref: dict) -> dict:
    """Phase 13b (see the module docstring), then phases 14 and 16 on its
    fleet. ``ref``: phase 8's bf16 plane pass (its bodies, tokens and
    remote rows)."""
    import os
    import signal
    import tempfile

    from dynamo_tpu_torch.engine.config import PRESETS
    from dynamo_tpu_torch.profile_decode import MODEL

    t_phase = time.monotonic()
    spec = PRESETS[MODEL]
    flight_dir = tempfile.mkdtemp(prefix="chip-smoke-fleet-")
    status_env = {"DTPU_SYSTEM_ENABLED": "1", "DTPU_FLIGHT_DIR": flight_dir}
    bodies, prompts = ref["bodies"], [b["prompt"] for b in ref["bodies"]]
    remote = [len(p) > DISAGG_MAX_LOCAL for p in prompts]
    http_prompt = np.random.default_rng(PARCEL_SEED).integers(
        0, spec.vocab_size, FLEET_HTTP_PROMPT).tolist()
    procs = []
    try:
        coord = _spawn(procs, "dynamo_tpu_torch.runtime.coordinator",
                       "--host", "127.0.0.1", "--port", "0")
        url = "tcp://127.0.0.1:" + _wait_line(
            coord, "COORDINATOR_READY").rsplit("=", 1)[1]
        # Phase 16's chats read their ids off the front's stream: every id
        # decodes to a text of its own. Its drains migrate what they cut.
        tokenizer = ids_tokenizer(os.path.join(flight_dir, "ids.json"),
                                  spec.vocab_size)
        common = ("--model", MODEL, "--num-pages", str(DISAGG_PAGES),
                  "--coordinator-url", url, "--tokenizer", tokenizer,
                  "--migration-limit", "3")
        if DEVICE == "cpu":
            common += ("--device", "cpu")
        prefill = _spawn(procs, "dynamo_tpu_torch.backends.gpu", "--mode",
                         "prefill", *common, env=status_env)
        decode = _spawn(procs, "dynamo_tpu_torch.backends.gpu", "--mode",
                        "decode", "--max-local-prefill-length",
                        str(DISAGG_MAX_LOCAL), *common, env=status_env)
        front = _spawn(procs, "dynamo_tpu_torch.frontend", "--http-host",
                       "127.0.0.1", "--http-port", "0", "--coordinator-url",
                       url)
        ready = [_wait_line(w, "GPU_WORKER_READY", timeout=600)
                 for w in (prefill, decode)]
        status = [int(_wait_line(w, "GPU_WORKER_STATUS").rsplit("=", 1)[1])
                  for w in (prefill, decode)]
        hexes = [line.split("worker=", 1)[1].split()[0] for line in ready]
        probes = [_wait_line(w, "KV plane device path") for w in (prefill,
                                                                  decode)]
        if DEVICE == "cuda":
            assert all(" device path on: " in p for p in probes), probes
        port = int(_wait_line(front, "FRONTEND_READY").rsplit("=", 1)[1])
        deadline = time.monotonic() + 60
        while [m["id"] for m in http_call(port, "GET", "/v1/models")[
                "json"]["data"]] != [MODEL]:
            assert time.monotonic() < deadline, "the model was not served"
            time.sleep(0.05)
        ready_s = time.monotonic() - t_phase
        t0 = time.monotonic()
        results = asyncio.run(asyncio.wait_for(
            fleet_traffic(url, bodies), SSE_TIMEOUT_S))
        wall = time.monotonic() - t0
        res = http_call(port, "POST", "/v1/completions", {
            "model": MODEL, "prompt": http_prompt, "stream": True,
            "max_tokens": 8, "ignore_eos": True,
            "stream_options": {"include_usage": True}})
        s = stream_summary(res)
        assert res["status"] == 200 and s["finish"] == "length", s
        assert (s["usage"]["prompt_tokens"], s["usage"]["completion_tokens"]
                ) == (FLEET_HTTP_PROMPT, 8), s
        staged = _wait_line(prefill, "prefill parcel staged")
        if DEVICE == "cuda":
            assert "(device path)" in staged, staged
        n_remote = sum(remote) + 1
        # The decode worker's counters as phase 14 begins (SIGUSR1 prints
        # them): its exit counters less these are phase 14's share.
        decode[0].send_signal(signal.SIGUSR1)
        mid = json.loads(_wait_line(decode, "GPU_WORKER_COUNTERS ").split(
            " ", 1)[1])["engine"]
        obs = observability_phase(
            port, status[1], status[0], hexes[1], hexes[0],
            {"decode": len(bodies) + 1, "remote": n_remote,
             "completions": 1}, flight_dir)
        # Both workers' counters as phase 14 ends: 13b's and 14's checks
        # read these, phase 16 the difference to their exit counters.
        d_end, p_end = read_counters(decode), read_counters(prefill)
        roles = roles_phase({"url": url, "front": port, "prefill": prefill,
                             "decode": decode, "status": status,
                             "hexes": (hexes[0], hexes[1]), "procs": procs,
                             "tokenizer": tokenizer, "env": status_env})
        for proc, _, _ in (front, decode, prefill, coord):
            proc.send_signal(signal.SIGTERM)
        d_exit, p_exit = _exit_line(decode), _exit_line(prefill)
        for proc, _, seen in (front, coord):
            code = proc.wait(timeout=120)
            assert code == 0, (code, seen[-20:])
    finally:
        for proc, _, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    # A CPU rehearsal's workers have no device path: its pulls are the
    # socket's. Phase 14 added one remote prefill (its chat) and two
    # rounds of OBS_PROFILE_ROWS local ones.
    path = "device" if DEVICE == "cuda" else "socket"
    all_remote = n_remote + 1
    n_dev = all_remote if path == "device" else 0
    for r, b in zip(results, bodies):
        assert len(r["tokens"]) == b["max_tokens"], (len(r["tokens"]), b)
    dis, client = d_end["disagg"], d_end["plane_client"]
    assert (dis["remote_prefills"], dis["remote_failures"],
            dis["local_prefills"]) == (
        all_remote, 0, len(prompts) + 1 - n_remote + 2 * OBS_PROFILE_ROWS
    ), dis
    assert (client["device_pulls"], client["socket_pulls"],
            client["device_pull_failures"]) == (n_dev, all_remote - n_dev,
                                                0), client
    assert d_end["engine"]["injected_admissions"] == all_remote
    server = p_end["plane_server"]
    assert (server["device_stages"], server["device_done"],
            server["staged"]) == (n_dev, n_dev, 0), server
    assert p_end["engine"]["device_extracts"] == n_dev
    assert p_end["engine"]["windows"] == 0, "the prefill worker decoded"
    eng = d_end["engine"]
    per_window = eng["window_steps"] * eng["layers"]
    # The worker's own counters, split at phase 14's start: 13b's share,
    # phase 14's, and the whole.
    shares = {"13b": {k: mid[k] for k in (
                  "windows", "window_replays", "launches", "launches_int8")},
              "14": {k: eng[k] - mid[k] for k in (
                  "windows", "window_replays", "launches", "launches_int8")},
              "all": eng}
    for name, c in shares.items():
        assert c["windows"] > 0 and c["launches_int8"] == 0, (name, c)
        if DEVICE == "cuda":
            assert c["launches"] == c["windows"] * per_window, (name, c)
            assert c["window_replays"] == c["windows"], (name, c)
    # Phase 14: /metrics counted every window the worker processed, and
    # the profile's kernels are consistent with the windows replayed in
    # its capture (each step of a window launches both kernels once per
    # layer, inside the graph replay).
    assert obs["decode_windows"] == eng["windows"], (obs, eng)
    assert obs["windows_before"] == mid["windows"], (obs, mid)
    prof = obs["profile"]
    if DEVICE == "cuda":
        assert min(prof["hist_flash_partial"],
                   prof["hist_flash_combine"]) >= per_window, prof
        assert prof["hist_flash_partial"] <= (
            prof["windows_during"] + 2) * per_window, prof
        assert abs(prof["hist_flash_partial"]
                   - prof["hist_flash_combine"]) <= per_window, prof
    obs["windows"] = shares["14"]["windows"]
    obs["launches"] = {"paged_attention_hist": shares["14"]["launches"],
                       "paged_attention_hist_int8":
                       shares["14"]["launches_int8"]}
    # Phase 16's share of each worker (from phase 14's end to its exit)
    # and the standby's (its whole life): M x 32 launches a window, each
    # window a replay, the int8 entry never.
    counted = ("windows", "window_replays", "launches", "launches_int8",
               "captures")
    roles["workers"] = {
        "P": {k: p_exit["engine"][k] - p_end["engine"][k] for k in counted},
        "D": {k: d_exit["engine"][k] - d_end["engine"][k] for k in counted},
        "S": {k: roles["standby_engine"][k] for k in counted}}
    for name, c in roles["workers"].items():
        assert c["launches_int8"] == 0, (name, c)
        if DEVICE == "cuda":
            assert c["launches"] == c["windows"] * per_window, (name, c)
            assert c["window_replays"] == c["windows"], (name, c)
    assert roles["workers"]["P"]["windows"] > 0, roles["workers"]
    assert (p_exit["role"]["role"], d_exit["role"]["role"]) == (
        "agg", "prefill"), (p_exit["role"], d_exit["role"])
    roles["peak_GiB"] = {"P": p_exit["engine"]["peak_bytes"] / 2**30,
                         "D": d_exit["engine"]["peak_bytes"] / 2**30,
                         "S": roles["standby_peak_GiB"]}
    roles["launches"] = {
        "paged_attention_hist": sum(c["launches"]
                                    for c in roles["workers"].values()),
        "paged_attention_hist_int8": sum(
            c["launches_int8"] for c in roles["workers"].values())}
    log(json.dumps({"roles_phase": {k: v for k, v in roles.items()
                                    if k != "standby_engine"}}))
    log(f"16: P prefill->agg by the RoleReconfigurator in "
        f"{roles['flips']['P prefill->agg']['seconds']:.2f}s (no reload: "
        f"allocated {roles['p_allocated_bytes']}, no capture), D "
        f"decode->prefill under 8 chats with a {ROLE_DRAIN_S:.0f} s drain in "
        f"{roles['flips']['D decode->prefill']['seconds']:.2f}s, migrations "
        f"{roles['migrations']}, chats equal to 16b's "
        f"{roles['chats_equal_of_8']}/8, splits {roles['splits']}; standby "
        f"joined in {roles['standby_join_seconds']:.3f}s, served and "
        f"retired; planner {len(roles['planner_steps'])} steps; launches "
        f"{ {n: c['launches'] for n, c in roles['workers'].items()} }; "
        f"peak GiB {roles['peak_GiB']}; {roles['phase_s']:.1f}s")
    # The first token of each remote prompt, its prefill worker's sample,
    # equals phase 8's (the unseeded top-p request samples anew). The
    # greedy ids (rows 0-5 and the long prompt) equal phase 8's, or split
    # only at a near-tie: up to the split both chains hold the same
    # tokens, so the margin behind it is read from this chain's own top-2
    # logprobs (ROADMAP's rule for chunked chains).
    greedy = [i for i, b in enumerate(bodies) if "temperature" not in b]
    equal, splits = 0, []
    for i, r in enumerate(results):
        got, want = r["tokens"], ref["tokens"][i]
        if remote[i] and "top_p" not in bodies[i]:
            assert got[0] == want[0], (i, got[0], want[0])
        if i not in greedy:
            continue
        j = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if j is None:
            equal += 1
            continue
        margin = r["margins"][j]
        assert margin is not None and margin <= 2 * LOGIT_ATOL, (
            f"request {i}: token {j} is {got[j]}, phase 8's {want[j]}, at "
            f"margin {margin}")
        splits.append({"request": i, "token": j, "margin": margin})
    per_pages = 2 * spec.num_layers * spec.num_kv_heads * PARCEL_PAGE \
        * spec.head_dim * 2
    pulls = {rec[3] // per_pages: rec
             for rec in client["recent"][:n_remote]}
    assert all(rec[4] == path for rec in pulls.values()), pulls
    phase8 = {row["prompt_tokens"]: row for row in ref["rows"]}
    rows = []
    for i, p in enumerate(prompts):
        if not remote[i]:
            continue
        _, open_s, end_s, nbytes, _ = pulls[-(-len(p) // PARCEL_PAGE)]
        old = phase8[len(p)]
        row = {"prompt_tokens": len(p), "parcel_bytes": nbytes,
               "pull_ms": end_s * 1e3, "open_ms": open_s * 1e3,
               "pull_GBps": nbytes / end_s / 1e9,
               "client_ttft_ms": results[i]["ttft_ms"],
               "client_tpot_ms": results[i]["tpot_ms"],
               "phase8_socket_pull_ms": old["pull_ms"],
               "phase8_socket_pull_GBps": old["pull_GBps"],
               "phase8_handler_ttft_ms": old["ttft_ms"]}
        rows.append(row)
        log(json.dumps({"device_fleet_request": row}))
    n_tok = sum(len(r["tokens"]) for r in results)
    out = {"ready_s": ready_s, "wall_s": wall, "tok_per_s": n_tok / wall,
           "remote_prefills": n_remote, "greedy_equal_of_7": equal,
           "splits": splits, "requests_remote": rows,
           "decode_engine": eng, "prefill_engine": p_exit["engine"],
           "decode_peak_GiB": eng["peak_bytes"] / 2**30,
           "prefill_peak_GiB": p_exit["engine"]["peak_bytes"] / 2**30,
           "launches": {"paged_attention_hist": mid["launches"],
                        "paged_attention_hist_int8": mid["launches_int8"]},
           "windows_13b": mid["windows"],
           "observability": obs, "roles": roles,
           "phase_s": time.monotonic() - t_phase}
    log(f"13b: 1P1D {MODEL} as processes ({ready[0]}; {ready[1]}; serving "
        f"in {ready_s:.1f}s; {probes[0]}); {n_remote} remote prefills all "
        f"over the {path} path ({staged}); greedy ids equal phase 8's in "
        f"{equal}/7, splits at near-ties {splits}; peak memory prefill "
        f"{out['prefill_peak_GiB']:.2f} GiB, decode "
        f"{out['decode_peak_GiB']:.2f} GiB; all four exited 0 on SIGTERM")
    return out


# Phase 14: the trace's chat (a remote prefill: over DISAGG_MAX_LOCAL
# tokens), the profiled round (local prefills) and the capture's length.
OBS_CHAT_WORDS = 880
OBS_TRACE_ID = "0123456789abcdef0123456789abcdef"
OBS_PARENT_ID = "feedfacecafebeef"
OBS_PROFILE_ROWS = 8
OBS_PROFILE_PROMPT = 128
OBS_PROFILE_TOKENS = 384
OBS_PROFILE_MS = 1000


def scrape(port: int) -> tuple[dict, float]:
    """GET /metrics: {(name, frozenset of label pairs): value}, and the
    scrape's ms."""
    import re
    t0 = time.perf_counter()
    res = http_call(port, "GET", "/metrics")
    ms = (time.perf_counter() - t0) * 1e3
    assert res["status"] == 200, res
    label_re = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
    out = {}
    for line in res["text"].splitlines():
        if not line or line.startswith("#"):
            continue
        head, value = line.rsplit(" ", 1)
        name, _, labels = head.partition("{")
        out[(name, frozenset(label_re.findall(labels)))] = float(value)
    return out, ms


def sample_sum(samples: dict, name: str, **labels) -> float:
    """The sum of ``name``'s samples whose labels include ``labels``."""
    want = set(labels.items())
    return sum(v for (n, ls), v in samples.items()
               if n == name and want <= set(ls))


def trace_names(port: int, trace_id: str, want: set, timeout=30.0) -> list:
    """The spans of ``trace_id`` on a process's /debug/traces, polled
    until their names hold ``want``."""
    deadline = time.monotonic() + timeout
    while True:
        res = http_call(port, "GET", f"/debug/traces?trace_id={trace_id}"
                                     "&format=spans")
        spans = res["json"].get("spans", []) if res["status"] == 200 else []
        if want <= {s["name"] for s in spans}:
            return spans
        assert time.monotonic() < deadline, (port, res["status"], spans)
        time.sleep(0.1)


def observability_phase(front: int, decode: int, prefill: int,
                        decode_hex: str, prefill_hex: str, before: dict,
                        flight_dir: str) -> dict:
    """Phase 14 (see the module docstring), against phase 13b's fleet
    before its SIGTERM. ``front`` is the frontend's HTTP port, ``decode``
    and ``prefill`` the workers' status server ports; ``before`` the
    requests phase 13b sent (``decode``: to the decode worker's endpoint,
    ``remote``: of them prefilled remotely, ``completions``: through the
    frontend)."""
    import os
    import threading

    from dynamo_tpu_torch.engine.config import PRESETS
    from dynamo_tpu_torch.profile_decode import MODEL
    t_phase = time.monotonic()
    spec = PRESETS[MODEL]
    base, _ = scrape(decode)
    w0 = sample_sum(base, "dynamo_tpu_decode_step_seconds_count")
    assert w0 > 0, "phase 13b's windows are not on the decode worker"
    # a. One chat through the frontend with a traceparent: its trace
    # crosses the frontend, the decode worker and the prefill worker.
    chat = chat_body(MODEL, np.random.default_rng(PARCEL_SEED),
                     OBS_CHAT_WORDS)
    chat["stream"] = False
    chat.pop("stream_options")
    res = http_call(front, "POST", "/v1/chat/completions", chat, headers={
        "traceparent": f"00-{OBS_TRACE_ID}-{OBS_PARENT_ID}-01"})
    assert res["status"] == 200, res
    f_spans = trace_names(front, OBS_TRACE_ID,
                          {"http.request", "router.decide"})
    d_spans = trace_names(decode, OBS_TRACE_ID, {
        "worker.request", "engine.queue_wait", "engine.decode",
        "kv.transfer.recv", "kv.plane.pull"})
    p_spans = trace_names(prefill, OBS_TRACE_ID,
                          {"worker.request", "kv.transfer.send"})
    http_span = next(x for x in f_spans if x["name"] == "http.request")
    assert http_span["parent_span_id"] == OBS_PARENT_ID, http_span
    worker_span = next(x for x in d_spans if x["name"] == "worker.request")
    assert worker_span["parent_span_id"] == http_span["span_id"], (
        worker_span, http_span)
    assert all(x["trace_id"] == OBS_TRACE_ID
               for x in f_spans + d_spans + p_spans)
    # b. A round decoding on the decode worker (local prefills), profiled
    # for OBS_PROFILE_MS while it decodes. The same round's shape runs
    # once before, so every window program it reaches is captured already
    # (a capture at first use holds the engine thread for seconds).
    def send_round(seed: int):
        rng = np.random.default_rng(seed)
        bodies = [{"model": MODEL, "max_tokens": OBS_PROFILE_TOKENS,
                   "ignore_eos": True, "prompt": rng.integers(
                       0, spec.vocab_size, OBS_PROFILE_PROMPT).tolist()}
                  for _ in range(OBS_PROFILE_ROWS)]
        answers: list = [None] * len(bodies)

        def send(i):
            answers[i] = http_call(front, "POST", "/v1/completions",
                                   bodies[i])
        senders = [threading.Thread(target=send, args=(i,))
                   for i in range(len(bodies))]
        for t in senders:
            t.start()
        return senders, answers

    def finish_round(senders, answers) -> None:
        for t in senders:
            t.join(timeout=SSE_TIMEOUT_S)
        assert all(a is not None and a["status"] == 200 for a in answers), [
            a and (a["status"], a.get("json")) for a in answers]

    finish_round(*send_round(PARCEL_SEED + 1))
    w_warm, _ = scrape(decode)
    w0_round = sample_sum(w_warm, "dynamo_tpu_decode_step_seconds_count")
    senders, answers = send_round(PARCEL_SEED + 2)
    # Wait until the round decodes, then profile.
    deadline = time.monotonic() + 120
    while True:
        now_s, _ = scrape(decode)
        w_start = sample_sum(now_s, "dynamo_tpu_decode_step_seconds_count")
        if w_start >= w0_round + 2:
            break
        assert time.monotonic() < deadline, "the profiled round never decoded"
        time.sleep(0.05)
    out_dir = os.path.join(flight_dir, "profile")
    t0 = time.perf_counter()
    prof = http_call(decode, "POST", "/debug/profile",
                     {"duration_ms": OBS_PROFILE_MS, "out_dir": out_dir})
    profile_call_s = time.perf_counter() - t0
    after_s, _ = scrape(decode)
    w_end = sample_sum(after_s, "dynamo_tpu_decode_step_seconds_count")
    finish_round(senders, answers)
    assert prof["status"] == 200, prof
    body = prof["json"]
    assert body["mode"] == "torch", body
    kernels = body["kernels"]
    partial = sum(k["count"] for n, k in kernels.items()
                  if "hist_flash_partial" in n)
    combine = sum(k["count"] for n, k in kernels.items()
                  if "hist_flash_combine" in n)
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["device_us"])[:8]
    # c. /metrics agrees with the traffic, on all three processes.
    f_m, f_ms = scrape(front)
    d_m, d_ms = scrape(decode)
    p_m, p_ms = scrape(prefill)
    assert sample_sum(f_m, "dynamo_tpu_http_requests_total",
                      route="chat_completions", status="200") == 1, f_m
    assert sample_sum(f_m, "dynamo_tpu_http_requests_total",
                      route="completions", status="200") == \
        before["completions"] + 2 * OBS_PROFILE_ROWS
    d_req = sample_sum(d_m, "dynamo_tpu_requests_total",
                       dynamo_endpoint="generate")
    assert d_req == before["decode"] + 1 + 2 * OBS_PROFILE_ROWS, (
        d_req, before)
    p_req = sample_sum(p_m, "dynamo_tpu_requests_total")
    assert p_req == before["remote"] + 1, (p_req, before)
    assert sample_sum(d_m, "dynamo_tpu_request_errors_total") == 0
    d_windows = sample_sum(d_m, "dynamo_tpu_decode_step_seconds_count")
    d_prefills = sample_sum(d_m, "dynamo_tpu_prefill_step_seconds_count")
    # Every request reached a slot once (nothing is preempted at this
    # pool size); each local prefill batch is one prefill observation.
    d_waits = sample_sum(d_m, "dynamo_tpu_request_queue_wait_seconds_count")
    assert d_waits == d_req, (d_waits, d_req)
    local = before["decode"] - before["remote"] + 2 * OBS_PROFILE_ROWS
    assert 1 <= d_prefills <= local, (d_prefills, local)
    # d. The frontend's merged timeline: the decode worker's worker_join
    # (the frontend emits one per instance of a model; the prefill worker
    # registers none), both workers' journal streams, no gap.
    tl = http_call(front, "GET", "/debug/timeline")["json"]
    kinds = [e["kind"] for e in tl["events"]]
    joins = {e["attrs"].get("instance") for e in tl["events"]
             if e["kind"] == "worker_join"}
    assert decode_hex in joins, (joins, decode_hex)
    assert "journal_gap" not in kinds, tl["events"][-10:]
    assert {decode_hex, prefill_hex} <= set(tl["workers"]), tl["workers"]
    # e. The fleet pane lists both workers.
    fleet = http_call(front, "GET", "/debug/fleet")["json"]
    assert set(fleet["workers"]) == {decode_hex, prefill_hex}, fleet
    assert all(w["ok"] for w in fleet["workers"].values()), fleet
    # f. The decode worker's flight ring has rows; every bundle says why.
    fl = http_call(decode, "GET", "/debug/flight")["json"]
    assert fl["meta"]["records"] > 0 and fl["windows"], fl["meta"]
    bundles = []
    for name in sorted(os.listdir(flight_dir)):
        if name.startswith("flight-") and name.endswith(".json"):
            with open(os.path.join(flight_dir, name)) as fh:
                bundle = json.load(fh)
            assert bundle["reason"], name
            bundles.append({"file": name, "reason": bundle["reason"],
                            "windows": len(bundle["flight"]["windows"])})
    out = {"trace_spans": {"front": len(f_spans), "decode": len(d_spans),
                           "prefill": len(p_spans)},
           "profile": {"trace_bytes": body["trace_bytes"],
                       "wall_s": body["wall_s"],
                       **{k: body.get(k) for k in (
                           "trace_events", "start_s", "stop_s", "export_s",
                           "count_s")},
                       "call_s": profile_call_s,
                       "hist_flash_partial": partial,
                       "hist_flash_combine": combine,
                       "windows_during": w_end - w_start,
                       "top_kernels": [(n, k["count"], k["device_us"])
                                       for n, k in top]},
           "scrape_ms": {"front": f_ms, "decode": d_ms, "prefill": p_ms},
           "decode_windows": d_windows, "decode_prefill_steps": d_prefills,
           "decode_requests": d_req, "prefill_requests": p_req,
           "timeline_events": len(kinds),
           "timeline_kinds": sorted(set(kinds)),
           "flight_records": fl["meta"]["records"],
           "flight_triggers": fl["triggers_total"], "bundles": bundles,
           "windows_before": w0,
           "phase_s": time.monotonic() - t_phase}
    log(json.dumps({"observability_phase": out}))
    log(f"14: one trace over frontend, decode and prefill workers; "
        f"/metrics agree on three processes (scrape ms {f_ms:.2f} / "
        f"{d_ms:.2f} / {p_ms:.2f}); /debug/profile mode torch, "
        f"{partial} hist_flash_partial and {combine} hist_flash_combine "
        f"over {w_end - w_start:.0f} windows, trace {body['trace_bytes']} "
        f"bytes; timeline {len(kinds)} events; fleet of 2; flight bundles "
        f"{[b['reason'] for b in bundles]}")
    return out


# ---------------------------------------------------------------------------
# Phase 16: the planner and live role changes, on phase 13b's fleet
# ---------------------------------------------------------------------------

ROLE_CHAT_WORDS = (480, 520, 560, 600, 640, 680, 720, 760)  # 16b-16c chats
ROLE_TOKENS = 64
ROLE_SEED = 9753
ROLE_DRAIN_S = 1.0
# The standby's pool: 1 GiB of bf16 pages. Beside P and D (peaks of 26.3
# and 24.5 GiB) an H100 80GB has about 18.6 GiB free at phase 16's start;
# S peaks near 16.6 GiB at this size (17.6 GiB with 1024 pages).
STANDBY_PAGES = 512
ROLE_WAIT_S = 120  # every wait of phase 16 fails at once past this
PLANNER_INTERVAL_S = 0.5
PLANNER_STEPS = 3
# 16e's chats decode this many tokens: seconds on P, so the planner's
# steps fall while they decode (64-token chats ended before its first
# step, and its demand read 0).
PLANNER_CHAT_TOKENS = 512


def ids_tokenizer(path: str, vocab: int) -> str:
    """Write the test tokenizer with a vocab entry ``<tN>`` for every id N
    from its own size up to ``vocab``: prompts encode as before (no merge
    makes such an entry), and every id a llama-3-8b worker samples decodes
    to a text of its own, so a stream through the front shows its ids."""
    from dynamo_tpu_torch.llm.tokenizer import TEST_TOKENIZER
    with open(TEST_TOKENIZER) as fh:
        spec = json.load(fh)
    table = spec["model"]["vocab"]
    for i in range(len(table), vocab):
        table[f"<t{i}>"] = i
    with open(path, "w") as fh:
        json.dump(spec, fh)
    return path


def role_wait(entry, what: str, fn, timeout: float = ROLE_WAIT_S):
    """Poll ``fn`` until it returns something truthy; past ``timeout``
    fail at once, naming phase 16 and ``what``, with the stacks of
    ``entry`` (a ``_spawn`` process, or None)."""
    deadline = time.monotonic() + timeout
    while True:
        got = fn()
        if got:
            return got
        if time.monotonic() >= deadline:
            stacks = "".join(abort_for_stacks(entry)) if entry else ""
            raise AssertionError(f"phase 16: {what} not within {timeout} s"
                                 + (f"; stacks and last lines:\n{stacks}"
                                    if stacks else ""))
        time.sleep(0.1)


def read_counters(entry, timeout: float = ROLE_WAIT_S) -> dict:
    """SIGUSR1 a serving worker and return the GPU_WORKER_COUNTERS line it
    prints in answer (not an earlier one)."""
    import queue
    import signal
    proc, lines, seen = entry
    prefix = "GPU_WORKER_COUNTERS "
    before = sum(x.startswith(prefix) for x in seen)
    proc.send_signal(signal.SIGUSR1)
    deadline = time.monotonic() + timeout
    while sum(x.startswith(prefix) for x in seen) <= before:
        assert proc.poll() is None, (proc.returncode, seen[-20:])
        if time.monotonic() >= deadline:
            raise AssertionError(
                "phase 16: no GPU_WORKER_COUNTERS answer; stacks:\n"
                + "".join(abort_for_stacks(entry)))
        try:
            seen.append(lines.get(timeout=0.5))
        except queue.Empty:
            pass
    line = [x for x in seen if x.startswith(prefix)][-1]
    return json.loads(line.split(" ", 1)[1])


def chat_tokens(res: dict) -> dict:
    """A streamed chat's tokens through the front: each token's text (its
    logprob entry's, or, for the one chunk of a token that carries no
    logprobs, the first token of a remote prefill, the chunk's content,
    or None where the stream held its text back: a partial UTF-8 byte)
    and the top-2 margin behind it (None without logprobs). A chunk with
    neither logprobs nor content but a finish reason ends the stream."""
    texts, margins = [], []
    for event in res["events"]:
        for choice in event["choices"]:
            entries = (choice.get("logprobs") or {}).get("content") or []
            content = (choice.get("delta") or {}).get("content") or ""
            if entries:
                for e in entries:
                    texts.append(e["token"])
                    tops = e["top_logprobs"]
                    margins.append(tops[0]["logprob"] - tops[1]["logprob"])
            elif content or not choice.get("finish_reason"):
                texts.append(content or None)
                margins.append(None)
    return {"texts": texts, "margins": margins}


def role_call(port: int, method: str, path: str, body=None) -> dict:
    """``http_call`` bounded by ROLE_WAIT_S: a call that waits longer fails
    at once, naming phase 16."""
    try:
        return http_call(port, method, path, body, timeout=ROLE_WAIT_S)
    except TimeoutError as exc:
        raise AssertionError(f"phase 16: {method} {path} on port {port} "
                             f"not answered within {ROLE_WAIT_S} s") from exc


def role_chats(port: int, bodies: list[dict]) -> list[dict]:
    """Send ``bodies`` through the front at once (a thread each); each
    answer as ``http_call`` returns it."""
    import threading
    answers: list = [None] * len(bodies)

    def send(i):
        answers[i] = http_call(port, "POST", "/v1/chat/completions",
                               bodies[i], timeout=ROLE_WAIT_S)
    threads = [threading.Thread(target=send, args=(i,), daemon=True)
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    return threads, answers


def join_chats(threads, answers, what: str,
               tokens: int = ROLE_TOKENS) -> list[dict]:
    deadline = time.monotonic() + ROLE_WAIT_S
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in threads), (
        f"phase 16: {what} not answered within {ROLE_WAIT_S} s")
    for a in answers:
        assert a is not None, f"phase 16: {what}: a chat failed"
        s = stream_summary(a)
        assert a["status"] == 200 and s["finish"] == "length", (what, s)
        assert s["usage"]["completion_tokens"] == tokens, (what, s)
    return answers


def role_exit(entry, what: str) -> int:
    """The exit code of a ``_spawn`` process that was told to stop,
    waited for at most ROLE_WAIT_S (past it, phase 16 fails naming
    ``what``)."""
    role_wait(entry, what, lambda: entry[0].poll() is not None)
    return entry[0].returncode


def roles_phase(fleet: dict) -> dict:
    """Phase 16 (see the module docstring) on phase 13b's fleet after
    phase 14. ``fleet``: the coordinator's url, the frontend's port, the
    prefill and decode workers' ``_spawn`` entries, status ports and ids,
    the process list the standby joins, the tokenizer file and the
    status servers' environment."""
    import signal

    from dynamo_tpu_torch.planner.capacity import FleetScaler
    from dynamo_tpu_torch.planner.reconfig import RoleReconfigurator
    from dynamo_tpu_torch.profile_decode import MODEL
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    t_phase = time.monotonic()
    url, front = fleet["url"], fleet["front"]
    prefill, decode = fleet["prefill"], fleet["decode"]
    p_status, d_status = fleet["status"]
    p_hex, d_hex = fleet["hexes"]
    census = device_census("phase 16 start")
    loop = LoopThread()
    rt = loop.run(DistributedRuntime.from_settings(
        RuntimeConfig(coordinator_url=url)), timeout=ROLE_WAIT_S)
    client = rt.require_coordinator()
    reconf = RoleReconfigurator(client, rt.config.namespace)
    scaler = FleetScaler(client, rt.config.namespace)
    rng = np.random.default_rng(ROLE_SEED)
    bodies = []
    for n in ROLE_CHAT_WORDS:
        body = chat_body(MODEL, rng, n)
        body.update(max_tokens=ROLE_TOKENS, logprobs=True, top_logprobs=2)
        bodies.append(body)

    def role_of(port):
        return role_call(port, "GET", "/control/role")["json"]

    def on_loop(coro):
        try:
            return loop.run(coro, timeout=ROLE_WAIT_S)
        except TimeoutError as exc:
            raise AssertionError(f"phase 16: a coordinator call not "
                                 f"answered within {ROLE_WAIT_S} s") from exc

    try:
        # 16b. The chats once through the fleet as it stands: P prefills,
        # D decodes. Their tokens are 16c's reference.
        t0 = time.monotonic()
        ref = [chat_tokens(a) for a in join_chats(
            *role_chats(front, bodies), "16b's reference chats")]
        ref_s = time.monotonic() - t0
        assert all(len(r["texts"]) == ROLE_TOKENS for r in ref), [
            len(r["texts"]) for r in ref]
        # The planner's flip: P from prefill to agg, by the port's
        # RoleReconfigurator, on this process's lease.
        p_before = read_counters(prefill)
        fleet_view = on_loop(reconf.fleet())
        assert {s["worker"]: s["role"] for s in fleet_view} == {
            p_hex: "prefill", d_hex: "decode"}, fleet_view
        epoch = reconf._next_epoch(fleet_view,
                                   on_loop(reconf.pending_directives()))
        t0 = time.monotonic()
        on_loop(reconf.issue(p_hex, "agg", epoch))
        status = role_wait(prefill, "P's flip to agg", lambda: (
            lambda s: s if (s["role"], s["state"], s["epoch"]) == (
                "agg", "serving", epoch) else None)(role_of(p_status)))
        p_flip_s = time.monotonic() - t0
        assert status["last_outcome"]["outcome"] == "ok", status
        dup = role_call(p_status, "POST", "/control/role",
                        {"role": "agg", "epoch": epoch})
        assert dup["status"] == 200 and dup["json"]["outcome"] == \
            "duplicate", dup
        stale = role_call(p_status, "POST", "/control/role",
                          {"role": "decode", "epoch": epoch - 1})
        assert stale["status"] == 409, stale
        assert role_of(p_status)["last_outcome"]["outcome"] == \
            "rejected_stale"
        p_after = read_counters(prefill)
        alloc = (p_before["engine"]["allocated_bytes"],
                 p_after["engine"]["allocated_bytes"])
        if DEVICE == "cuda":
            assert abs(alloc[1] - alloc[0]) <= 0.01 * alloc[0], alloc
        assert p_after["engine"]["captures"] == \
            p_before["engine"]["captures"], (p_before, p_after)
        # 16a. The standby starts now that P's flip has returned P's
        # cached blocks to the card; its load and warmup overlap 16c and
        # 16e.
        common = ("--model", MODEL, "--coordinator-url", url, "--tokenizer",
                  fleet["tokenizer"], "--migration-limit", "3")
        if DEVICE == "cpu":
            common += ("--device", "cpu")
        standby = _spawn(fleet["procs"], "dynamo_tpu_torch.backends.gpu",
                         "--standby", "--num-pages", str(STANDBY_PAGES),
                         *common, env=fleet["env"])
        # The model is served on P now too (its card and endpoint).
        role_wait(None, "P's model card", lambda: len(
            [k for k in on_loop(client.kv_get_prefix("models/"))]) >= 2)
        # 16c. The same chats while D flips to prefill over the status
        # server, its drain 1 s: what the drain cuts migrates.
        led0 = role_call(front, "GET", "/debug/requests?limit=1000")[
            "json"]["total"]
        p_c0, d_c0 = read_counters(prefill), read_counters(decode)
        threads, answers = role_chats(front, bodies)
        role_wait(decode, "16c's chats on D", lambda: role_of(d_status)[
            "inflight"] > 0)
        t0 = time.monotonic()
        flip = role_call(d_status, "POST", "/control/role",
                         {"role": "prefill", "epoch": epoch + 1,
                          "drain_s": ROLE_DRAIN_S})
        d_flip_s = time.monotonic() - t0
        assert flip["status"] == 200 and flip["json"]["outcome"] == "ok", \
            flip
        got = [chat_tokens(a) for a in join_chats(threads, answers,
                                                  "16c's chats")]
        p_c1, d_c1 = read_counters(prefill), read_counters(decode)
        records = role_call(front, "GET", "/debug/requests?limit=1000")[
            "json"]
        new = records["records"][:records["total"] - led0]
        assert len(new) == len(bodies) and all(
            r["status"] == "ok" for r in new), new
        # The drain cut streams, and each migrated with the typed reason:
        # the migrations number the streams D sent back.
        migrated = [r for r in new if r["migrations"]]
        by_reason: dict = {}
        for r in migrated:
            by_reason[r["migration_reason"]] = by_reason.get(
                r["migration_reason"], 0) + 1
        assert migrated and set(by_reason) == {"role_flip"}, (
            by_reason, new)
        cut = d_c1["role"]["cut_streams"] - d_c0["role"]["cut_streams"]
        assert sum(r["migrations"] for r in migrated) == cut, (
            [r["migrations"] for r in migrated], cut)
        c = {k: p_c1["engine"][k] - p_c0["engine"][k] for k in (
            "windows", "window_replays", "launches", "launches_int8")}
        per_window = p_c1["engine"]["window_steps"] * \
            p_c1["engine"]["layers"]
        assert c["windows"] > 0 and c["launches_int8"] == 0, c
        if DEVICE == "cuda":
            assert c["launches"] == c["windows"] * per_window, c
            assert c["window_replays"] == c["windows"], c
        # Each chat's tokens equal 16b's or split only at a near-tie (a
        # token whose text the stream held back compares equal).
        equal, splits = 0, []
        for i, (g, r) in enumerate(zip(got, ref)):
            j = next((k for k, (a, b) in enumerate(zip(g["texts"],
                                                       r["texts"]))
                      if a != b and None not in (a, b)), None)
            if j is None:
                equal += 1
                continue
            margin = g["margins"][j]
            assert margin is not None and margin <= 2 * LOGIT_ATOL, (
                f"chat {i}: token {j} is {g['texts'][j]!r}, 16b's "
                f"{r['texts'][j]!r}, at margin {margin}")
            splits.append({"chat": i, "token": j, "margin": margin})
        d_status_after = role_of(d_status)
        assert (d_status_after["role"], d_status_after["state"]) == (
            "prefill", "serving"), d_status_after
        # 16e. The planner as a process, its connector a FakeConnector,
        # reconfiguration off, while a few chats decode on P (S still
        # loads meanwhile).
        t0 = time.monotonic()
        planner = _spawn(fleet["procs"], "dynamo_tpu_torch.planner",
                         "--coordinator-url", url, "--adjustment-interval",
                         str(PLANNER_INTERVAL_S), "--decode-component", "gpu")
        _wait_line(planner, "PLANNER_READY", timeout=ROLE_WAIT_S)
        busy = role_chats(front, [dict(b, max_tokens=PLANNER_CHAT_TOKENS)
                                  for b in bodies[:4]])

        def steps():
            return [json.loads(x.split(" ", 1)[1]) for x in planner[2]
                    if x.startswith("PLANNER_STEP ")]
        role_wait(planner, f"{PLANNER_STEPS} planner steps", lambda: (
            _drain(planner), len(steps()) >= PLANNER_STEPS)[1])
        join_chats(*busy, "16e's chats", PLANNER_CHAT_TOKENS)
        planner[0].send_signal(signal.SIGTERM)
        code = role_exit(planner, "the planner's exit")
        assert code == 0, (code, planner[2][-20:])
        decisions = steps()
        assert all("decode" in d["decisions"] for d in decisions), decisions
        assert max(d["live_workers"]["decode"] for d in decisions) >= 1, \
            decisions
        demand = [d["decisions"]["decode"]["demand"] for d in decisions]
        assert max(demand) > 0, decisions
        planner_s = time.monotonic() - t0
        # 16d. The standby: parked with no card, then promoted as the
        # FleetScaler promotes, serving, retired.
        ready = _wait_line(standby, "GPU_WORKER_READY", timeout=ROLE_WAIT_S)
        assert "mode=standby" in ready, ready
        s_status = int(_wait_line(standby, "GPU_WORKER_STATUS",
                                  timeout=5).rsplit("=", 1)[1])
        s_hex = ready.split("worker=", 1)[1].split()[0]
        parked = on_loop(scaler.standbys())
        assert [s["worker"] for s in parked] == [s_hex], parked
        cards = on_loop(client.kv_get_prefix("models/"))
        assert not any(k["k"].endswith(s_hex) for k in cards), cards
        fleet_view = on_loop(scaler.fleet())
        epoch_s = scaler._next_epoch(fleet_view, on_loop(scaler.pending()),
                                     on_loop(scaler.role_directives()))
        t0 = time.monotonic()
        on_loop(scaler.issue(s_hex, "promote", "agg", epoch_s))
        role_wait(standby, "S's promotion", lambda: role_call(
            s_status, "GET", "/control/scale")["json"]["state"] == "active")
        promote_s = time.monotonic() - t0
        sent_to = []
        small = dict(bodies[0], max_tokens=8, stream=False, logprobs=False)
        small.pop("top_logprobs")
        small.pop("stream_options")

        def landed_on_standby():
            res = role_call(front, "POST", "/v1/chat/completions", small)
            assert res["status"] == 200, res
            last = role_call(front, "GET", "/debug/requests?limit=1")[
                "json"]["records"][0]
            sent_to.append(last["worker_id"])
            return last["worker_id"] == s_hex
        role_wait(standby, "a chat on S", landed_on_standby)
        join_s = sample_sum(scrape(s_status)[0],
                            "dynamo_tpu_standby_join_seconds")
        epoch_r = scaler._next_epoch(on_loop(scaler.fleet()),
                                     on_loop(scaler.pending()),
                                     on_loop(scaler.role_directives()))
        on_loop(scaler.issue(s_hex, "retire", None, epoch_r))
        role_exit(standby, "S's exit after its retire")
        s_exit = _exit_line(standby, timeout=ROLE_WAIT_S)
        assert s_exit["scale"]["state"] == "retired", s_exit
        assert s_exit["role"]["state"] == "retired", s_exit
        s_eng = s_exit["engine"]
        assert s_eng["windows"] > 0 and s_eng["launches_int8"] == 0, s_eng
        if DEVICE == "cuda":
            assert s_eng["launches"] == s_eng["windows"] * per_window, s_eng
            assert s_eng["window_replays"] == s_eng["windows"], s_eng
    finally:
        loop.run(rt.close(), timeout=30)
        loop.close()
    out = {"flips": {"P prefill->agg": {"epoch": epoch, "seconds": p_flip_s,
                                        "drain_s": 0.0},
                     "D decode->prefill": {"epoch": epoch + 1,
                                           "seconds": d_flip_s,
                                           "drain_s": ROLE_DRAIN_S}},
           "p_allocated_bytes": alloc, "reference_s": ref_s,
           "migrations": by_reason, "d_cut_streams": cut,
           "chats_equal_of_8": equal,
           "splits": splits, "p_16c": c, "promote_s": promote_s,
           "standby_join_seconds": join_s, "chats_to_s": len(sent_to),
           "standby_engine": s_eng,
           "standby_peak_GiB": s_eng["peak_bytes"] / 2**30,
           "planner_steps": decisions, "planner_s": planner_s,
           "epochs": {"p": epoch, "d": epoch + 1, "promote": epoch_s,
                      "retire": epoch_r},
           "card_free_GiB_at_start": census["card_free_GiB"],
           "phase_s": time.monotonic() - t_phase}
    return out


def _drain(entry) -> None:
    """Move a ``_spawn`` process's queued lines into its seen list."""
    import queue
    _, lines, seen = entry
    while True:
        try:
            seen.append(lines.get_nowait())
        except queue.Empty:
            return


def device_census(label: str) -> dict:
    """This process's allocated and reserved device memory after a
    collection, and the card's free memory (every process's use counts
    there): what a worker started now can take."""
    gc.collect()
    torch.cuda.empty_cache()
    free, total = (torch.cuda.mem_get_info() if DEVICE == "cuda"
                   else (0, 0))
    out = {"label": label,
           "allocated_GiB": torch.cuda.memory_allocated() / 2**30,
           "reserved_GiB": torch.cuda.memory_reserved() / 2**30,
           "card_free_GiB": free / 2**30, "card_total_GiB": total / 2**30}
    log(json.dumps({"device_memory": out}))
    return out


def device_path_phase(phase8: dict, ipc=None) -> dict:
    """Phase 13 (see the module docstring)."""
    from dynamo_tpu_torch.profile_decode import smi_line
    t_phase = time.monotonic()
    smi = smi_line()
    device_census("phase 13 start")
    parcels = parcel_check(ipc)
    fleet = device_fleet(phase8)
    out = {"parcels": parcels, "fleet": fleet, "smi": smi,
           "launches": fleet["launches"],
           "phase_s": time.monotonic() - t_phase}
    log(json.dumps({"device_path_phase": {
        k: v for k, v in out.items() if k not in ("parcels", "fleet")}
        | {"parcels_s": parcels["phase_s"], "fleet_s": fleet["phase_s"]}}))
    log(f"phase 13: {out['phase_s']:.1f}s ({smi})")
    return out


# ---------------------------------------------------------------------------
# Phase 15: admission and the perf plane at full width
# ---------------------------------------------------------------------------

ADM_PAGES = 4096
ADM_SEED = 8642
ADM_BURST = 16        # 15b: prompts sent at once
ADM_BURST_LEN = 1500  # tokens each
ADM_BURST_TOKENS = 16
ADM_BUDGET_PROMPTS = 4  # 15b's TTFT budget: this many burst prompts
BROWN_DECODE_LENS = (600, 750, 900, 1050)  # 15c: code-like rows decoding
BROWN_DECODE_TOKENS = 256
BROWN_BACKLOG = 8     # 15c: prompts of ADM_BURST_LEN tokens, one token each
BROWN_WARM = 3        # 15c: fresh prompts that calibrate the rate first
FRONT_BURST = 32      # 15d: chats sent at once
FRONT_MAX_CONCURRENCY = 4
FRONT_QUEUE_DEPTH = 8
FRONT_SLO_TTFT_MS = 2000.0
FRONT_TOKENS = 16
# The weight-read step phase 15's engines (CUT_LAYERS deep) must report:
# their bf16 weights (the
# embedding and the head, and per layer attention, MLP and two norms:
# 2,795,573,248 parameters, 5.59 GB) at 3350 GB/s. At 32 layers it is
# 16.06 GB and 4.79 ms.
ADM_STEP_MS = 1.669
SLO_KEYS = {"enabled", "fast_burn_threshold", "slow_burn_threshold",
            "pages_total", "targets", "pressure"}


class LoopThread:
    """An event loop on a thread of its own, for servers the script
    queries synchronously."""

    def __init__(self):
        import threading
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout=600):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


def admission_engine(extra=(), params=None):
    """A seed-0 llama-3-8b engine cut to CUT_LAYERS of its 32 layers
    (every width kept), built as ``python -m
    dynamo_tpu_torch.backends.gpu --num-pages ADM_PAGES`` plus ``extra``
    flags builds it (warmup_windows set), with phase 3's prefill program
    size and a metrics registry; on ``params`` when given (another
    engine's tensors), and started, so its warmup programs are
    captured."""
    import dataclasses

    from dynamo_tpu_torch.backends import gpu
    from dynamo_tpu_torch.engine.engine import GPUEngine
    from dynamo_tpu_torch.profile_decode import MAX_PREFILL_TOKENS, MODEL
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
    args = gpu.parse_args(["--model", MODEL, "--seed", "0", "--device",
                           DEVICE, "--num-pages", str(ADM_PAGES), *extra])
    config = dataclasses.replace(cut_depth(gpu.build_engine_config(args)),
                                 max_prefill_tokens=MAX_PREFILL_TOKENS)
    assert config.warmup_windows, config
    t0 = time.monotonic()
    engine = GPUEngine(config, params=params, seed=args.seed,
                       metrics_registry=MetricsRegistry().namespace(
                           "dynamo").component("gpu"))
    engine.start()
    log(f"phase 15 engine {' '.join(extra) or '(plain)'}: pages="
        f"{engine.runner.num_pages} setup {time.monotonic() - t0:.1f}s "
        f"(warmup {engine.warmup_seconds:.1f}s)")
    return engine


def window_events(runner):
    """Wrap the runner's window entry points to record CUDA events around
    each window's enqueue (the packed upload and the graph replay): the
    device time of the same windows whose ``window_s`` the perf plane
    reads. Returns the list of (start, end) event pairs; ``del
    runner.decode_window, runner.decode_spec_window`` undoes it."""
    pairs = []
    for name in ("decode_window", "decode_spec_window"):
        inner = getattr(runner, name)

        def timed(*a, inner=inner, **kw):
            e0, e1 = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            e0.record()
            out = inner(*a, **kw)
            e1.record()
            pairs.append((e0, e1))
            return out
        setattr(runner, name, timed)
    return pairs


def launches_now(attention) -> dict:
    return {"paged_attention_hist": attention.KERNEL.launches,
            "paged_attention_hist_int8": attention.KERNEL.launches_int8}


def perf_status_check(loop, engine, before: dict, w0: dict,
                      captured: int) -> dict:
    """15a's checks of GET /debug/perf on a status server whose provider
    is ``engine.perf_status`` (the worker's wiring)."""
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.health import SystemStatusServer
    from dynamo_tpu_torch.runtime.http_server import http_get_json

    async def up():
        rt = await DistributedRuntime.detached(RuntimeConfig())
        server = SystemStatusServer(rt, host="127.0.0.1", port=0, cuda=True,
                                    perf_provider=engine.perf_status)
        await server.start()
        return rt, server

    rt, server = loop.run(up())
    try:
        torch.cuda.synchronize()
        alloc0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        status, body = loop.run(http_get_json(
            f"127.0.0.1:{server.port}", "/debug/perf", 30))
        get_ms = (time.perf_counter() - t0) * 1e3
        alloc1 = torch.cuda.memory_allocated()
    finally:
        loop.run(server.stop())
        loop.run(rt.close())
    assert status == 200, (status, body)
    assert set(body) == {"role", "compiles", "window", "roofline", "hbm",
                         "memory"}, sorted(body)
    win, roof, hbm, mem = (body["window"], body["roofline"], body["hbm"],
                           body["memory"])
    windows = win["windows_total"] - w0["windows_total"]
    tokens = win["window_tokens_total"] - w0["window_tokens_total"]
    assert windows == engine.step_count > 0, (windows, engine.step_count)
    assert tokens == engine.tokens_generated_total > 0, (
        tokens, engine.tokens_generated_total)
    assert abs(roof["weight_read_step_ms"] - ADM_STEP_MS) < 0.05, roof
    assert 0 < roof["frac"] <= 1, roof
    programs, prev = body["compiles"]["programs"], before["programs"]
    decode_captures = (programs["decode_window"]["compiles"]
                       - prev.get("decode_window", {}).get("compiles", 0))
    assert decode_captures == captured, (decode_captures, captured)
    assert (body["compiles"]["unexpected_recompiles_total"]
            == before["unexpected_recompiles_total"]), body["compiles"]
    assert programs["decode_window"]["cost"]["source"] == "analytic"
    assert alloc0 == alloc1 == hbm["bytes_in_use"], (
        alloc0, alloc1, hbm["bytes_in_use"])
    assert hbm["peak_bytes_in_use"] >= hbm["bytes_in_use"], hbm
    assert hbm["bytes_limit"] == torch.cuda.get_device_properties(
        0).total_memory, hbm
    pool = engine.runner.graph_pool_bytes()
    assert mem["params_bytes"] == engine.runner.param_bytes, mem
    assert mem["kv_pool_bytes"] == engine.runner.kv_pool_bytes, mem
    assert mem["workspace_bytes"] >= pool > 0, (mem, pool)
    return {"windows": windows, "tokens": tokens, "get_ms": get_ms,
            "window": win, "roofline": roof, "hbm": hbm, "memory": mem,
            "graph_pool_bytes": pool, "decode_window_captures":
                decode_captures,
            "cost": programs["decode_window"]["cost"]}


def perf_plane_check(attention, loop, engine, before: dict,
                     w0: dict) -> dict:
    """15a: round 1's traffic on the warmed worker engine, then
    /debug/perf."""
    from dynamo_tpu_torch.profile_decode import serve
    spec = engine.runner.spec
    prompts = round1_prompts(spec, ADM_SEED)
    pairs = window_events(engine.runner)
    attention.KERNEL.launches = attention.KERNEL.launches_int8 = 0
    replays0 = engine.runner.window_replays
    try:
        t0 = time.monotonic()
        results = asyncio.run(serve(engine, round1_requests(spec, prompts)))
        wall = time.monotonic() - t0
        torch.cuda.synchronize()
        launches = launches_now(attention)
    finally:
        del engine.runner.decode_window, engine.runner.decode_spec_window
    check_replays(engine, replays0, engine.windows_dispatched)
    for i, r in enumerate(results):
        assert r["finish"] == "length" and r["tokens"], (i, r["finish"])
    expected = engine.windows_dispatched * engine.decode_window * \
        spec.num_layers
    assert launches["paged_attention_hist"] == expected > 0, (
        launches, expected)
    assert launches["paged_attention_hist_int8"] == 0, launches
    device_ms = sum(a.elapsed_time(b) for a, b in pairs)
    programs = engine.runner.window_programs()
    out = perf_status_check(loop, engine, before, w0, programs[
        "captured" if engine.runner.use_graphs else "programs"])
    out.update(launches=launches, wall_s=wall, rate_tok_s=(
        engine.prefill_rate_tok_s),
               window_device_ms_total=device_ms,
               window_s_total_ms=out["window"]["window_seconds_total"]
               * 1e3 - w0["window_seconds_total"] * 1e3,
               windows_timed=len(pairs))
    log(f"15a: {out['windows']} windows, {out['tokens']} tokens; window_s "
        f"{out['window_s_total_ms']:.1f} ms in all against "
        f"{device_ms:.1f} device ms (CUDA events, {len(pairs)} windows); "
        f"roofline frac {out['roofline']['frac']} of a "
        f"{out['roofline']['weight_read_step_ms']} ms step; hbm in use "
        f"{out['hbm']['bytes_in_use'] / 2**30:.2f} GiB, workspace "
        f"{out['memory']['workspace_bytes'] / 2**20:.0f} MiB >= graph pool "
        f"{out['graph_pool_bytes'] / 2**20:.0f} MiB; GET {out['get_ms']:.1f}"
        f" ms")
    return out


def sla_check(attention, engine) -> dict:
    """15b: a burst against a TTFT budget of ADM_BUDGET_PROMPTS burst
    prompts at the rate round 1 calibrated, reject factor 2."""
    import dataclasses

    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.errors import OverloadedError
    spec = engine.runner.spec
    rate = engine.prefill_rate_tok_s
    assert rate, "round 1 calibrated no prefill rate"
    budget = ADM_BUDGET_PROMPTS * ADM_BURST_LEN / rate * 1e3
    plain_config = engine.config
    engine.config = dataclasses.replace(
        plain_config, ttft_budget_ms=budget, admission_reject_factor=2.0)
    rng = np.random.default_rng(ADM_SEED + 1)
    prompts = [rng.integers(0, spec.vocab_size, ADM_BURST_LEN).tolist()
               for _ in range(ADM_BURST)]
    deferred0 = engine.admission_deferred
    windows0 = engine.windows_dispatched
    replays0 = engine.runner.window_replays

    async def burst():
        async def one(prompt, projected):
            t0 = time.monotonic()
            req = {"model": spec.name, "token_ids": prompt,
                   "stop_conditions": {"max_tokens": ADM_BURST_TOKENS,
                                       "ignore_eos": True}}
            toks, ttft, finish = [], None, None
            try:
                async for item in engine.generate(req, Context()):
                    if ttft is None:
                        ttft = time.monotonic() - t0
                    toks.extend(item.get("token_ids", []))
                    finish = item.get("finish_reason") or finish
            except OverloadedError as exc:
                return {"rejected": str(exc), "projected_ms": projected}
            return {"tokens": len(toks), "finish": finish,
                    "ttft_ms": ttft * 1e3, "projected_ms": projected}
        tasks = []
        for p in prompts:
            # The projection generate() judges this arrival by.
            tasks.append(asyncio.ensure_future(
                one(p, engine.estimated_ttft_ms(len(p)))))
            await asyncio.sleep(0)
        return await asyncio.gather(*tasks)

    attention.KERNEL.launches = attention.KERNEL.launches_int8 = 0
    try:
        t0 = time.monotonic()
        results = asyncio.run(burst())
        wall = time.monotonic() - t0
        torch.cuda.synchronize()
        launches = launches_now(attention)
    finally:
        engine.config = plain_config
    admitted = [r for r in results if "rejected" not in r]
    rejected = [r for r in results if "rejected" in r]
    assert len(admitted) + len(rejected) == ADM_BURST, results
    assert rejected, "the burst met no projection over budget x factor"
    assert all("projected TTFT" in r["rejected"] for r in rejected), rejected
    for r in admitted:
        assert r["finish"] == "length" and r["tokens"] == ADM_BURST_TOKENS, r
    deferred = engine.admission_deferred - deferred0
    assert deferred > 0, "the SLA gate deferred no head"
    windows = engine.windows_dispatched - windows0
    check_replays(engine, replays0, windows)
    assert launches["paged_attention_hist"] == \
        windows * engine.decode_window * spec.num_layers, (launches, windows)
    out = {"budget_ms": budget, "rate_tok_s": rate, "sent": ADM_BURST,
           "admitted": len(admitted), "rejected": len(rejected),
           "admission_deferred": deferred, "wall_s": wall,
           "launches": launches, "windows": windows,
           "admitted_projected_vs_measured_ms": [
               (round(r["projected_ms"], 1), round(r["ttft_ms"], 1))
               for r in admitted],
           "rejected_projected_ms": [round(r["projected_ms"], 1)
                                     for r in rejected],
           "reject_message": rejected[0]["rejected"]}
    log(f"15b: budget {budget:.1f} ms at {rate:.0f} tok/s; "
        f"{len(admitted)} admitted, {len(rejected)} rejected of "
        f"{ADM_BURST}, {deferred} deferrals; projected vs measured TTFT ms "
        f"{out['admitted_projected_vs_measured_ms']}")
    return out


def brownout_check(attention, model, plain_engine) -> dict:
    """15c: a spec engine (on the plain engine's weights) under a prompt
    backlog that lifts its brownout level to >= 2 and back to 0."""
    import dataclasses
    import threading

    from dynamo_tpu_torch.profile_decode import serve
    spec_engine_ = admission_engine(
        ("--spec-decode", "ngram", "--spec-k", str(SPEC_K),
         "--ttft-budget-ms", "1000", "--admission-reject-factor", "0"),
        params=plain_engine.runner.params)
    engine, spec = spec_engine_, spec_engine_.runner.spec
    try:
        keys = sorted(map(str, engine.runner._window_cache))
        assert any(k.startswith("('spec'") for k in keys) and len(keys) == 3, \
            keys
        rng = np.random.default_rng(ADM_SEED + 2)

        def set_budget() -> float:
            # Half a backlog prompt at the current rate: the backlog's
            # projection is then several budgets whatever the rate does
            # next.
            budget = 0.5 * ADM_BURST_LEN / engine.prefill_rate_tok_s * 1e3
            engine.config = dataclasses.replace(engine.config,
                                                ttft_budget_ms=budget)
            return budget
        # The rate's EWMA converges over a few fresh prompts (its first
        # sample carries the first use of the prefill's shapes).
        for _ in range(BROWN_WARM):
            asyncio.run(serve(engine, [{
                "model": spec.name, "token_ids": rng.integers(
                    0, spec.vocab_size, ADM_BURST_LEN).tolist(),
                "stop_conditions": {"max_tokens": 2, "ignore_eos": True}}]))
        set_budget()
        decode = [{"model": spec.name,
                   "token_ids": code_like_prompt(rng, spec.vocab_size, n),
                   "stop_conditions": {"max_tokens": BROWN_DECODE_TOKENS,
                                       "ignore_eos": True}}
                  for n in BROWN_DECODE_LENS]
        backlog = [{"model": spec.name, "token_ids": rng.integers(
            0, spec.vocab_size, ADM_BURST_LEN).tolist(),
            "stop_conditions": {"max_tokens": 1, "ignore_eos": True}}
            for _ in range(BROWN_BACKLOG)]
        levels, stop = [], threading.Event()

        def watch():
            while not stop.is_set():
                levels.append(engine.brownout_level)
                time.sleep(0.002)
        watcher = threading.Thread(target=watch, daemon=True)
        c0 = (engine.windows_dispatched, engine.spec_brownout_windows,
              sum(engine.spec_emit_hist))
        marks = {}

        async def run():
            dec = asyncio.ensure_future(serve(engine, decode))
            while sum(engine.spec_emit_hist) - c0[2] < 4 * len(decode):
                await asyncio.sleep(0.002)
            marks["before"] = (engine.windows_dispatched,
                               engine.spec_brownout_windows,
                               sum(engine.spec_emit_hist))
            marks["budget"] = set_budget()
            marks["rate"] = engine.prefill_rate_tok_s
            back = await serve(engine, backlog)
            marks["after"] = (engine.windows_dispatched,
                              engine.spec_brownout_windows,
                              sum(engine.spec_emit_hist))
            return await dec, back

        attention.KERNEL.launches = attention.KERNEL.launches_int8 = 0
        replays0 = engine.runner.window_replays
        watcher.start()
        t0 = time.monotonic()
        try:
            got, back = asyncio.run(run())
        finally:
            stop.set()
            watcher.join(5)
        wall = time.monotonic() - t0
        torch.cuda.synchronize()
        launches = launches_now(attention)
        budget, rate = marks["budget"], marks["rate"]
        windows = engine.windows_dispatched - c0[0]
        plain_windows = engine.spec_brownout_windows - c0[1]
        check_replays(engine, replays0, windows)
        for r in got + back:
            assert r["finish"] == "length", r["finish"]
        assert plain_windows > 0, "the backlog brought no plain window"
        assert marks["after"][1] > marks["before"][1]
        assert sum(engine.spec_emit_hist) > marks["after"][2], \
            "no spec window after the backlog cleared"
        assert max(levels) >= 2 and levels[-1] == 0, (max(levels),
                                                      levels[-1])
        expected = ((windows - plain_windows) * engine.spec_m_outer
                    + plain_windows * engine.decode_window) * spec.num_layers
        assert launches["paged_attention_hist"] == expected, (
            launches, expected, windows, plain_windows)
        assert launches["paged_attention_hist_int8"] == 0, launches
        status = engine.perf_status()["spec"]
    finally:
        engine.stop()
    # The same decode prompts on the plain engine (greedy).
    want = asyncio.run(serve(plain_engine, decode))
    equal = greedy_agree(plain_engine.runner, model,
                         [r["token_ids"] for r in decode],
                         [r["tokens"] for r in got],
                         [r["tokens"] for r in want],
                         rows=range(len(decode)))
    out = {"budget_ms": budget, "rate_tok_s": rate, "windows": windows,
           "plain_windows": plain_windows,
           "spec_windows": windows - plain_windows,
           "max_level": max(levels), "level_samples": len(levels),
           "level_ge2_share": sum(lv >= 2 for lv in levels) / len(levels),
           "greedy_rows_equal": f"{equal}/{len(decode)}",
           "launches": launches, "wall_s": wall,
           "verify_bytes_per_token": status["verify_bytes_per_token"],
           "acceptance_rate": status["acceptance_rate"],
           "program_keys": keys}
    log(f"15c: {windows} windows, {plain_windows} plain under brownout "
        f"(max level {max(levels)}), greedy rows equal to the plain "
        f"engine {equal}/{len(decode)}, launches {launches}")
    del engine, spec_engine_
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _front_call(port: int, body: dict, headers: dict) -> tuple:
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/v1/chat/completions",
                     body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json",
                              **headers})
        resp = conn.getresponse()
        return (resp.status, resp.getheader("Retry-After"),
                json.loads(resp.read()))
    finally:
        conn.close()


def front_check(attention, loop, engine) -> dict:
    """15d: a port front with --overload-max-concurrency and
    --slo-ttft-p99-ms over a port worker serving ``engine``."""
    from concurrent.futures import ThreadPoolExecutor

    from dynamo_tpu_torch.backends.gpu import serve_engine
    from dynamo_tpu_torch.frontend import main as frontend_main
    from dynamo_tpu_torch.launch import (init_observability, make_limiter,
                                         start_front)
    from dynamo_tpu_torch.llm.model_card import deregister_llm
    from dynamo_tpu_torch.llm.tokenizer import make_test_tokenizer
    from dynamo_tpu_torch.profile_decode import MODEL
    from dynamo_tpu_torch.runtime import slo
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    args = frontend_main.parse_args([
        "--overload-max-concurrency", str(FRONT_MAX_CONCURRENCY),
        "--slo-ttft-p99-ms", str(FRONT_SLO_TTFT_MS), "--http-port", "0"])

    async def up():
        worker = await DistributedRuntime.with_embedded_coordinator(
            RuntimeConfig())
        server = await serve_engine(worker, engine, MODEL,
                                    make_test_tokenizer())
        cfg = RuntimeConfig(coordinator_url=worker.config.coordinator_url)
        frontend_main.apply_front_args(cfg, args)
        # A limit at its maximum from the start and a short queue: the
        # burst sheds.
        cfg.overload.initial_concurrency = FRONT_MAX_CONCURRENCY
        cfg.overload.queue_depth = FRONT_QUEUE_DEPTH
        front = await DistributedRuntime.from_settings(cfg)
        init_observability(cfg, front.metrics,
                           worker=f"{front.instance_id:x}")
        service, watcher = await start_front(
            front, "127.0.0.1", 0, overload=make_limiter(cfg, front.metrics))
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

    stack = loop.run(up())
    try:
        port = stack[3].port
        rng = np.random.default_rng(ADM_SEED + 3)
        words = WORDS
        bodies = [{"model": MODEL, "stream": False, "ignore_eos": True,
                   "max_tokens": FRONT_TOKENS,
                   "messages": [{"role": "user", "content": " ".join(
                       rng.choice(words, 200 + 20 * i))}]}
                  for i in range(FRONT_BURST)]
        headers = [{"x-priority": "batch"} if i % 4 == 3 else {}
                   for i in range(FRONT_BURST)]
        attention.KERNEL.launches = attention.KERNEL.launches_int8 = 0
        windows0 = engine.windows_dispatched
        replays0 = engine.runner.window_replays
        t0 = time.monotonic()
        with ThreadPoolExecutor(FRONT_BURST) as pool:
            answers = list(pool.map(lambda a: _front_call(port, *a),
                                    zip(bodies, headers)))
        wall = time.monotonic() - t0
        torch.cuda.synchronize()
        launches = launches_now(attention)
        windows = engine.windows_dispatched - windows0
        check_replays(engine, replays0, windows)
        metrics = http_call(port, "GET", "/metrics")["text"]
        slo_body = http_call(port, "GET", "/debug/slo")
    finally:
        loop.run(down(*stack))
        slo.configure(slo.SloConfig())
    by_status = {}
    for status, retry, body in answers:
        by_status[status] = by_status.get(status, 0) + 1
        if status == 200:
            assert body["usage"]["completion_tokens"] == FRONT_TOKENS, body
        else:
            assert status in (429, 503), (status, body)
            assert retry is not None and int(retry) >= 1, (status, retry)
            assert body["error"]["type"] in ("rate_limited", "overloaded"), \
                body
    assert sum(by_status.values()) == FRONT_BURST, by_status
    assert by_status.get(200, 0) > 0, by_status
    for name in ("admitted_total", "shed_total", "concurrency_limit"):
        assert f"dynamo_tpu_{name}" in metrics, name
    assert slo_body["status"] == 200, slo_body
    assert set(slo_body["json"]) == SLO_KEYS, sorted(slo_body["json"])
    assert "ttft" in slo_body["json"]["targets"], slo_body["json"]
    assert launches["paged_attention_hist"] == \
        windows * engine.decode_window * engine.runner.spec.num_layers > 0, (
            launches, windows)
    assert launches["paged_attention_hist_int8"] == 0, launches
    sheds = [line for line in metrics.splitlines()
             if line.startswith("dynamo_tpu_shed_total{")]
    out = {"sent": FRONT_BURST, "by_status": by_status, "wall_s": wall,
           "shed_series": sheds, "windows": windows, "launches": launches,
           "slo_ttft": slo_body["json"]["targets"]["ttft"]["windows"]["5m"],
           "slo_pressure": slo_body["json"]["pressure"]}
    log(f"15d: {by_status} of {FRONT_BURST}; {sheds}; SLO ttft 5m "
        f"{out['slo_ttft']}")
    return out


def admission_phase(attention, model) -> dict:
    """Phase 15 (see the module docstring)."""
    from dynamo_tpu_torch.engine import perf
    from dynamo_tpu_torch.profile_decode import smi_line
    t_phase = time.monotonic()
    smi = smi_line()
    reg = perf.get_registry()
    before, w0 = reg.snapshot(), reg.window_snapshot()
    loop = LoopThread()
    engine = admission_engine()
    try:
        perf_out = perf_plane_check(attention, loop, engine, before, w0)
        t_b = time.monotonic()
        sla = sla_check(attention, engine)
        sla["phase_s"] = time.monotonic() - t_b
        t_c = time.monotonic()
        brown = brownout_check(attention, model, engine)
        brown["phase_s"] = time.monotonic() - t_c
        t_d = time.monotonic()
        front = front_check(attention, loop, engine)
        front["phase_s"] = time.monotonic() - t_d
    finally:
        engine.stop()
        loop.close()
    launches = {k: sum(part["launches"][k]
                       for part in (perf_out, sla, brown, front))
                for k in ("paged_attention_hist",
                          "paged_attention_hist_int8")}
    out = {"perf": perf_out, "sla": sla, "brownout": brown, "front": front,
           "launches": launches, "smi": smi,
           "int8_launches_why": "phase 15's engines are the worker's "
                                "default bf16 pool; phases 4, 7, 8 and 12 "
                                "drive the int8 entry",
           "phase_s": time.monotonic() - t_phase}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps({"admission_phase": out}, default=str))
    log(f"phase 15: {out['phase_s']:.1f}s ({smi})")
    return out


def kernel_entry(name, variant, timing, main, max_err, stats,
                 http_launches, dist_launches, ckpt_launches,
                 disagg_launches, kv_launches, verify, spec_launches,
                 lora_launches, tier_launches, device_launches,
                 obs_launches, admission_launches, roles_launches,
                 embed_launches) -> dict:
    """One kernel's summary: times at the B=32 x 2048 shape, and the same
    numbers at the main path's mid-round shape under ``main_shape``;
    launches in round 1, round 2, the HTTP phase, the distributed phase,
    phase 7's round-1 runs on loaded checkpoints, phase 8's passes (on
    the decode worker), phase 9's passes (both workers), phase 10's
    spec round (the verify route), phase 11's LoRA rounds A and B,
    phase 12's rounds on the tier workers, phase 13b's decode worker
    process until phase 14 begins (the KV plane's device path) and
    phase 14's on that worker, both from the worker's own counters,
    phase 15's (its four parts summed) and phase 16's (the prefill worker
    flipped to agg, the decode worker until its flip, the promoted
    standby) and phase 17's (its embed jobs and /v1/embeddings requests:
    0, the embed path runs neither kernel); the verify route's numbers at both
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
            "launches_tiers": tier_launches,
            "launches_kv_device": device_launches,
            "launches_observability": obs_launches,
            "launches_admission": admission_launches,
            "launches_roles": roles_launches,
            "launches_embeddings": embed_launches,
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
    install_guards()
    t_start = time.monotonic()
    seconds, memory, t_last = {}, {}, [t_start]

    def phase_done(label: str) -> None:
        now = time.monotonic()
        seconds[label] = now - t_last[0]
        t_last[0] = now
        memory[label] = host_memory()
        log(f"phases {label} done at {now - t_start:.1f}s; host memory "
            f"{memory[label]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Flight bundles of this process and of the workers it spawns go to a
    # temporary directory; this process's in-process phases take no
    # automatic decode-stall capture (a frozen ring would drop rows that
    # phases 3 and 4 count), phase 14's workers keep the default trigger.
    import os
    import tempfile

    from dynamo_tpu_torch.runtime import flight
    os.environ["DTPU_FLIGHT_DIR"] = tempfile.mkdtemp(prefix="chip-smoke-")
    flight.configure(bundle_dir=os.environ["DTPU_FLIGHT_DIR"], stall_s=0.0)
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
        ckpt = checkpoint_phase(attention, model)
        phase_done("7 checkpoints")
        disagg = disagg_phase(attention, model, refs)
        phase_done("8 disagg")
        kv = kv_routing_phase(attention, model)
        phase_done("9 kv routing")
        spec = spec_phase(attention, model,
                          stats_bf16["round2"]["decode_step_device_ms"])
        phase_done("10 spec decode")
        lora = lora_phase(attention, model)
        phase_done("11 lora")
        tiers = tier_phase(attention, model)
        phase_done("12 kv tiers")
        device = device_path_phase(disagg.pop("_plane_pass"))
        phase_done("13-14 kv device path, observability")
        seconds["14 observability (inside 13b)"] = \
            device["fleet"]["observability"]["phase_s"]
        seconds["16 roles, planner (inside 13b)"] = \
            device["fleet"]["roles"]["phase_s"]
        admission = admission_phase(attention, model)
        phase_done("15 admission, perf plane")
        embed = {"a": stats_bf16["embeddings"],
                 "b": stats_http["embeddings"],
                 "b_request_plane": stats_http["dist"]["embeddings"],
                 "c": ckpt["batch_launcher"]}
        seconds["17a embeddings (inside 3)"] = embed["a"]["phase_s"]
        seconds["17b /v1/embeddings (inside 5-6)"] = (
            embed["b"]["seconds"] + embed["b_request_plane"]["seconds"])
        seconds["17c in=batch (inside 7)"] = embed["c"]["seconds"]
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

    obs_launches = device["fleet"]["observability"]["launches"]
    roles_launches = device["fleet"]["roles"]["launches"]

    def embed_launches(kernel):
        return sum(embed[part]["launches"][kernel]
                   for part in ("a", "b", "b_request_plane"))
    log(json.dumps({"phase_seconds": seconds}))
    log(json.dumps({"host_memory_after_phases": memory}))
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
                     lora["launches_total"]["paged_attention_hist"],
                     tiers["launches"]["paged_attention_hist"],
                     device["launches"]["paged_attention_hist"],
                     obs_launches["paged_attention_hist"],
                     admission["launches"]["paged_attention_hist"],
                     roles_launches["paged_attention_hist"],
                     embed_launches("paged_attention_hist")),
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
                     lora["launches_total"]["paged_attention_hist_int8"],
                     tiers["launches"]["paged_attention_hist_int8"],
                     device["launches"]["paged_attention_hist_int8"],
                     obs_launches["paged_attention_hist_int8"],
                     admission["launches"]["paged_attention_hist_int8"],
                     roles_launches["paged_attention_hist_int8"],
                     embed_launches("paged_attention_hist_int8"))]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
