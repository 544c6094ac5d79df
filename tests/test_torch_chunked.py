"""GPUEngine (on CPU) with prefix reuse, stall-free chunked prefill,
penalties and logprobs, held against the JAX TPUEngine on the same weights.

The engines take the reference's own chunked-prefill configuration
(``tests/test_chunked_prefill.py``: ``max_prefill_tokens=32``, buckets
(32, 64, 128, 256)), so every prompt longer than 32 tokens, or whose rest
after a prefix-cache hit is, prefills in chunks over history. Token chains
are compared under the ROADMAP rule "greedy tokens only at clear margins":
the margin is that of the logits that chose each token on the path the
chain took (chunks included), read from the engine's own top-2 logprobs;
at a near-tie, within a bf16 ulp, the chains may split, and the comparison
stops there. Chunked against
whole-prompt token identity is not asserted anywhere: the reference's own
test of it fails on this tree.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import async_test

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.engine import TPUEngine
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.runtime.context import Context as JContext
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.runtime.context import Context as TContext

torch.set_num_threads(1)

TOL = dict(atol=0.1, rtol=0.05)
SPEC_J = jcfg.PRESETS["tiny-test"]
SPEC_T = tcfg.PRESETS["tiny-test"]
CHUNKED = dict(page_size=16, num_pages=128, max_pages_per_seq=16,
               max_num_seqs=4, prefill_buckets=(32, 64, 128, 256),
               max_prefill_tokens=32)


@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_params(SPEC_J, jax.random.key(42))


def _port(jparams, **kw):
    return GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu", **kw),
                     params=params_from_jax(jax.tree.map(np.asarray, jparams),
                                            SPEC_T, device="cpu"))


@pytest.fixture(scope="module")
def engines(jparams):
    jeng = TPUEngine(jcfg.EngineConfig(model=SPEC_J, attention_backend="xla",
                                       **CHUNKED), params=jparams)
    teng = _port(jparams, **CHUNKED)
    yield jeng, teng
    jeng.stop()
    teng.stop()


def _prompt(seed: int, n: int) -> list[int]:
    return np.random.default_rng(seed).integers(0, SPEC_T.vocab_size,
                                                 n).tolist()


def _wire(prompt, max_tokens, **sampling):
    return {"model": "tiny-test", "token_ids": list(prompt),
            "stop_conditions": {"max_tokens": max_tokens,
                                "ignore_eos": True},
            "sampling_options": sampling}


async def _items(engine, request):
    ctx = JContext() if isinstance(engine, TPUEngine) else TContext()
    if isinstance(engine, TPUEngine):
        request = JRequest.from_wire(request)
    return [item async for item in engine.generate(request, ctx)]


async def _tokens(engine, request):
    items = await _items(engine, request)
    assert items[-1].get("finish_reason") == "length"
    return [t for it in items for t in it.get("token_ids", [])]


_dense = jax.jit(lambda p, k, v, t, pos, pt, sl: jmodel.prefill_forward(
    p, SPEC_J, k, v, t, pos, pt, sl)[0])


def _dense_logits(jparams, seq) -> np.ndarray:
    """The reference's dense last-position logits after ``seq``."""
    n = len(seq)
    bucket = 32 * -(-n // 32)
    shape = (SPEC_J.num_layers, SPEC_J.num_kv_heads, bucket // 16 + 1, 16,
             SPEC_J.head_dim)
    tok = np.zeros((1, bucket), np.int32)
    tok[0, :n] = seq
    pos = np.minimum(np.arange(bucket), n - 1)[None].astype(np.int32)
    pt = np.arange(1, bucket // 16 + 1, dtype=np.int32)[None]
    return np.asarray(_dense(
        jparams, jnp.zeros(shape, jnp.bfloat16),
        jnp.zeros(shape, jnp.bfloat16), jnp.asarray(tok), jnp.asarray(pos),
        jnp.asarray(pt), jnp.asarray([n], jnp.int32))[0], np.float32)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


async def _chain(engine, prompt, max_tokens, **sampling):
    """Greedy tokens and, for each, the top-2 margin of the logits that
    chose it, from the engine's own top-2 logprobs."""
    items = await _items(engine, _wire(prompt, max_tokens, logprobs=2,
                                       **sampling))
    assert items[-1].get("finish_reason") == "length"
    tops = [x for it in items for x in it["top_log_probs"]]
    return ([t for it in items for t in it["token_ids"]],
            [a[0]["logprob"] - a[1]["logprob"] for a in tops])


def _assert_clear_margin_match(jparams, prompt, want, got) -> int:
    """``got`` equals the chain ``want`` = (tokens, margins) up to their
    first split, where ``want``'s own margin must be within a bf16 ulp
    (margins None: the reference's dense logits give it, for a chain that
    prefilled whole). Returns the number of equal tokens."""
    tokens, margins = want
    assert len(got) == len(tokens)
    for i, (a, b) in enumerate(zip(tokens, got)):
        if a != b:
            top2 = np.sort(_dense_logits(jparams, prompt + tokens[:i]))[-2:]
            margin = top2[1] - top2[0] if margins is None else margins[i]
            assert margin <= _bf16_ulp(top2[1]), (
                f"token {i}: {b} != {a} at a clear margin {margin}")
            return i
    return len(tokens)


@async_test(timeout=300)
async def test_chunked_prefill_greedy_matches_reference(engines, jparams):
    jeng, teng = engines
    chunks0 = teng.chunk_dispatch_count
    equal = 0
    for seed, n in ((5, 150), (15, 97)):
        p = _prompt(seed, n)
        want = await _chain(jeng, p, 8)
        got = await _tokens(teng, _wire(p, 8))
        equal += _assert_clear_margin_match(jparams, p, want, got)
    assert equal >= 8
    # 150 = 4 x 32 + 22 and 97 = 3 x 32 + 1: nine chunk dispatches.
    assert teng.chunk_dispatch_count - chunks0 == 9


@async_test(timeout=300)
async def test_repeated_prompt_hits_prefix_cache(engines, jparams):
    jeng, teng = engines
    p = _prompt(8, 150)
    want = await _chain(jeng, p, 6)
    cold = await _tokens(teng, _wire(p, 6))
    hits, chunk_tokens = teng.prefix_hit_blocks, teng.chunk_tokens_total
    warm = await _tokens(teng, _wire(p, 6))
    # All nine complete blocks were cached; the 6-token rest prefills in
    # one program over that history, under one chunk of work.
    assert teng.prefix_hit_blocks - hits == 9
    assert teng.chunk_tokens_total - chunk_tokens < 32
    for got in (cold, warm):
        assert _assert_clear_margin_match(jparams, p, want, got) >= 3


@async_test(timeout=300)
async def test_decode_window_between_chunks(engines):
    """While a long prompt prefills in chunks, a decoding request keeps
    running: a decode window is dispatched between every two of the long
    prompt's chunk dispatches."""
    _, eng = engines
    events = []
    runner = eng.runner
    orig = (runner.decode_window, runner.prefill_chunk_async,
            runner.prefill_batch)

    def win(packed, window):
        events.append("window")
        return orig[0](packed, window)

    def chunk(seq):
        events.append("chunk")
        return orig[1](seq)

    def batch(seqs, slots=None, count_rows=None):
        if len(seqs) == 1 and seqs[0].start_pos:
            events.append("chunk")  # the final chunk
        return orig[2](seqs, slots=slots, count_rows=count_rows)

    runner.decode_window, runner.prefill_chunk_async, runner.prefill_batch = \
        win, chunk, batch
    try:
        # Submitted together: the short prompt prefills whole and decodes
        # for 25 windows, while the long one prefills 32 tokens a loop.
        d_toks, l_toks = await asyncio.gather(
            _tokens(eng, _wire(_prompt(20, 20), 200)),
            _tokens(eng, _wire(_prompt(21, 160), 4)))
    finally:
        runner.decode_window, runner.prefill_chunk_async, \
            runner.prefill_batch = orig
    assert len(d_toks) == 200 and len(l_toks) == 4
    idx = [i for i, e in enumerate(events) if e == "chunk"]
    assert len(idx) == 5, events  # 4 x 32 + the final 32
    for i, j in zip(idx, idx[1:]):
        assert "window" in events[i + 1:j], events
    assert not eng._prefilling and not eng._chunk_inflight


@async_test(timeout=300)
async def test_seeded_stream_same_with_and_without_cached_prefix(engines):
    """A seeded sampled request streams the same tokens whether or not its
    prompt's blocks are cached (first admission never reuses a prefix);
    a greedy request of the same prompt does reuse them."""
    _, teng = engines
    p = _prompt(30, 120)
    seeded = dict(temperature=0.9, top_p=0.95, seed=77)
    alone = await _tokens(teng, _wire(p, 10, **seeded))
    hits = teng.prefix_hit_blocks
    again = await _tokens(teng, _wire(p, 10, **seeded))
    assert teng.prefix_hit_blocks == hits
    assert again == alone
    await _tokens(teng, _wire(p, 2))
    assert teng.prefix_hit_blocks - hits == 7


@async_test(timeout=300)
async def test_logprob_wire_dicts_match_reference(engines, jparams):
    """The same greedy requests with logprobs (a chunked prompt and a whole
    one) give the reference's wire dicts: the same keys in every item,
    tokens at clear margins, logprobs and top alternatives within the bf16
    logit tolerance."""
    jeng, teng = engines
    for seed, n, k in ((40, 90, 3), (41, 25, 0), (42, 30, 20)):
        p = _prompt(seed, n)
        want = await _items(jeng, _wire(p, 9, logprobs=k))
        got = await _items(teng, _wire(p, 9, logprobs=k))
        assert [set(i) for i in got] == [set(i) for i in want]
        g_tok = [t for i in got for t in i["token_ids"]]
        chain = await _chain(jeng, p, 9)
        assert chain[0] == [t for i in want for t in i["token_ids"]]
        same = _assert_clear_margin_match(jparams, p, chain, g_tok)
        w_lp = [x for i in want for x in i["log_probs"]][:same]
        g_lp = [x for i in got for x in i["log_probs"]][:same]
        np.testing.assert_allclose(g_lp, w_lp, **TOL)
        w_top = [x for i in want for x in i["top_log_probs"]][:same]
        g_top = [x for i in got for x in i["top_log_probs"]][:same]
        for a, b in zip(w_top, g_top):
            assert len(a) == len(b) == min(k, 8)
            np.testing.assert_allclose([x["logprob"] for x in b],
                                       [x["logprob"] for x in a], **TOL)


def _penalty_engine(jparams, **kw):
    return _port(jparams, **dict(
        page_size=16, num_pages=128, max_pages_per_seq=16, max_num_seqs=4,
        prefill_buckets=(32, 64, 128), max_prefill_tokens=64,
        decode_window=8) | kw)


@async_test(timeout=300)
async def test_penalties_change_output_and_revert(jparams):
    """A presence penalty of 2 makes greedy decode emit distinct tokens
    where the unpenalised run repeats; a frequency penalty changes the
    output; both at 0 give the unpenalised tokens again (the count state
    does not leak between requests)."""
    eng = _penalty_engine(jparams)
    try:
        p = list(range(5, 25))
        base = await _tokens(eng, _wire(p, 24))
        assert len(set(base)) < len(base)
        pres = await _tokens(eng, _wire(p, 24, presence_penalty=2.0))
        assert len(set(pres)) == len(pres), pres
        freq = await _tokens(eng, _wire(p, 24, frequency_penalty=1.5))
        assert freq != base
        zero = await _tokens(eng, _wire(p, 24, frequency_penalty=0.0,
                                        presence_penalty=0.0))
        assert zero == base
        clamped = await _tokens(eng, _wire(p, 24, presence_penalty=9.0))
        assert clamped == pres  # clamped to 2.0
    finally:
        eng.stop()


@async_test(timeout=300)
async def test_penalty_counts_rebuilt_after_preemption(jparams):
    """KV pressure preempts, requeues and re-prefills a penalised request:
    its count row is rebuilt from the tokens it generated before, so a
    presence-penalised request still never repeats across the boundary."""
    eng = _penalty_engine(jparams, num_pages=8, max_num_seqs=2,
                          decode_window=4)
    try:
        toks = await asyncio.gather(
            _tokens(eng, _wire(list(range(3, 35)), 40,
                               presence_penalty=2.0)),
            _tokens(eng, _wire(list(range(50, 82)), 40,
                               presence_penalty=2.0)))
        for t in toks:
            assert len(t) == 40 and len(set(t)) == len(t), t
        assert eng.preempt_count >= 1
    finally:
        eng.stop()


@async_test(timeout=300)
async def test_preempted_request_longer_than_a_bucket_finishes(jparams):
    """Three 30-token prompts growing to 70 tokens in a 9-page pool: the
    youngest are preempted once their tokens outgrow the 32-token prefill
    programs, re-admitted through history chunks (over their own cached
    pages where those survived), and every request streams its 40
    tokens; against a pool large enough for all, the chains agree up to a
    near-tie of the reference."""
    kw = dict(CHUNKED, max_num_seqs=3, decode_window=4, pipeline_depth=2)
    prompts = [_prompt(60 + i, 30) for i in range(3)]
    big, small = _port(jparams, **kw), _port(jparams, **dict(kw,
                                                             num_pages=10))
    try:
        want = await asyncio.gather(*[_tokens(big, _wire(p, 40))
                                      for p in prompts])
        got = await asyncio.gather(*[_tokens(small, _wire(p, 40))
                                     for p in prompts])
    finally:
        big.stop()
        small.stop()
    assert small.preempt_count > 0 and big.preempt_count == 0
    assert small.chunk_dispatch_count > 0 == big.chunk_dispatch_count
    for p, w, g in zip(prompts, want, got):
        _assert_clear_margin_match(jparams, p, (w, None), g)


@pytest.mark.parametrize("env", [
    {}, {"DTPU_PREFILL_CHUNK_TOKENS": "48"},
    {"DTPU_PREFILL_CHUNK_TOKENS": "auto"}, {"DTPU_WINDOW_TARGET_MS": "10"},
    {"DTPU_PREFILL_KNEE_TOK": "1024", "DTPU_HBM_GBPS": "2000"}])
def test_chunk_budget_matches_reference(env, monkeypatch):
    """``resolve_prefill_chunk_tokens`` gives the reference's budget for
    every preset, explicit and 'auto' field values and environment
    overrides, and rejects what the reference rejects. The memory rate
    that sizes 'auto' is pinned: its default is the part's own (the
    H100's 3350 GB/s here, the TPU's in the reference)."""
    for name in ("DTPU_PREFILL_CHUNK_TOKENS", "DTPU_WINDOW_TARGET_MS",
                 "DTPU_PREFILL_KNEE_TOK"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("DTPU_HBM_GBPS", str(tcfg.DEFAULT_HBM_GBPS))
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for model in sorted(jcfg.PRESETS):
        for kw in ({}, {"tp": 8}, {"prefill_chunk_tokens": 100},
                   {"prefill_chunk_tokens": 4},
                   {"max_prefill_tokens": 64, "prefill_buckets": (32, 64)}):
            want = jcfg.EngineConfig(model=jcfg.PRESETS[model],
                                     **kw).resolve_prefill_chunk_tokens()
            got = tcfg.EngineConfig(model=tcfg.PRESETS[model],
                                    **kw).resolve_prefill_chunk_tokens()
            assert got == want, (model, kw)
    if "DTPU_PREFILL_CHUNK_TOKENS" not in env:
        for bad in (0, "big"):
            with pytest.raises(ValueError):
                tcfg.EngineConfig(
                    prefill_chunk_tokens=bad).resolve_prefill_chunk_tokens()


def test_launch_prefill_chunk_tokens_flag():
    from dynamo_tpu_torch import launch
    for flag, want in (([], "auto"), (["--prefill-chunk-tokens", "64"], 64),
                       (["--prefill-chunk-tokens", "auto"], "auto")):
        args = launch.parse_args(["out=gpu", "--device", "cpu", *flag])
        assert launch.build_engine_config(args).prefill_chunk_tokens == want


@async_test(timeout=300)
async def test_prefilling_request_preempted_and_requeued(jparams):
    """KV pressure while a long prompt is still prefilling in chunks
    preempts it (decode victims run out first), requeues it, and it
    completes after re-admission; the decoding request streams on."""
    # 12 pages = 11 usable: the decoder grows from 2 pages to 5 while the
    # 128-token prompt (8 pages) prefills 16 tokens an iteration.
    eng = _port(jparams, **dict(CHUNKED, num_pages=12, decode_window=8,
                                prefill_chunk_tokens=16))
    preempted = []
    orig = eng._preempt_prefilling

    def preempt(r):
        preempted.append(r.prefill_pos)
        orig(r)

    eng._preempt_prefilling = preempt
    try:
        # Submitted together: the long prompt holds 8 pages while it
        # prefills, and the decoder's third window needs a fourth page.
        d_toks, l_toks = await asyncio.gather(
            _tokens(eng, _wire(_prompt(30, 30), 40)),
            _tokens(eng, _wire(_prompt(31, 128), 6)))
    finally:
        eng.stop()
    assert len(d_toks) == 40 and len(l_toks) == 6
    assert preempted and 0 < preempted[0] < 128, preempted
    assert not eng._prefilling and not eng._chunk_inflight
