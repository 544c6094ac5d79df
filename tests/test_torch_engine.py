"""GPUEngine (on CPU) serves like the JAX TPUEngine on the same weights.

Four concurrent greedy requests go through both engines' ``generate``.
Token chains are compared under the ROADMAP rule "greedy tokens only at
clear margins": the port must emit the reference's token wherever the
reference's top-2 logit margin at that position exceeds one bf16 ulp of
the top logit. At a near-tie the chains may legitimately split, and the
comparison stops there. Both engines also finish every request with the
same reason and length.

With ``quant_kv="int8"`` both engines keep an int8 pool. The margin is then
read from the reference's own int8-pool logits at that position
(``_ref_int8_logits``: its prefill and decode-window steps replayed over a
``QuantKV`` pool with the window commits in between), since the dense
prefill that gives the bf16 margin never reads the quantized pool.
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
from dynamo_tpu.engine import kv_quant as jq
from dynamo_tpu.engine.engine import TPUEngine
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.runtime.context import Context as JContext
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.runtime.context import Context as TContext
from dynamo_tpu_torch.runtime.errors import AdapterNotFoundError

torch.set_num_threads(1)

ENGINE_KW = dict(page_size=16, num_pages=128, max_pages_per_seq=16,
                 max_num_seqs=4, prefill_buckets=(32, 64, 128, 256),
                 max_prefill_tokens=64, decode_window=4, pipeline_depth=2)
SPEC_J = jcfg.PRESETS["tiny-test"]
SPEC_T = tcfg.PRESETS["tiny-test"]


@pytest.fixture(scope="module")
def engines():
    jparams = jmodel.init_params(SPEC_J, jax.random.key(42))
    jeng = TPUEngine(jcfg.EngineConfig(model=SPEC_J, attention_backend="xla",
                                       **ENGINE_KW), params=jparams)
    teng = GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                       **ENGINE_KW),
                     params=params_from_jax(jax.tree.map(np.asarray, jparams),
                                            SPEC_T, device="cpu"))
    yield jparams, jeng, teng
    jeng.stop()
    teng.stop()


@pytest.fixture(scope="module")
def engines_int8():
    jparams = jmodel.init_params(SPEC_J, jax.random.key(43))
    jeng = TPUEngine(jcfg.EngineConfig(model=SPEC_J, attention_backend="xla",
                                       quant_kv="int8", **ENGINE_KW),
                     params=jparams)
    teng = GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                       quant_kv="int8", **ENGINE_KW),
                     params=params_from_jax(jax.tree.map(np.asarray, jparams),
                                            SPEC_T, device="cpu"))
    yield jparams, jeng, teng
    jeng.stop()
    teng.stop()


async def _collect(engine, request, ctx):
    toks, finish = [], None
    async for out in engine.generate(request, ctx):
        toks.extend(out.get("token_ids", []))
        finish = out.get("finish_reason") or finish
    return toks, finish


def _wire(prompt, max_tokens, **sampling):
    return {"model": "tiny-test", "token_ids": list(prompt),
            "stop_conditions": {"max_tokens": max_tokens},
            "sampling_options": sampling}


_dense = jax.jit(lambda p, k, v, t, pos, pt, sl: jmodel.prefill_forward(
    p, SPEC_J, k, v, t, pos, pt, sl)[0])


def _ref_logits(jparams, seq):
    """The reference's dense last-position logits of ``seq``."""
    n = len(seq)
    bucket = 32 * -(-n // 32)
    shape = (SPEC_J.num_layers, SPEC_J.num_kv_heads, bucket // 16 + 1, 16,
             SPEC_J.head_dim)
    tok = np.zeros((1, bucket), np.int32)
    tok[0, :n] = seq
    pos = np.minimum(np.arange(bucket), n - 1)[None].astype(np.int32)
    pt = np.arange(1, bucket // 16 + 1, dtype=np.int32)[None]
    return np.asarray(_dense(jparams, jnp.zeros(shape, jnp.bfloat16),
                             jnp.zeros(shape, jnp.bfloat16), jnp.asarray(tok),
                             jnp.asarray(pos), jnp.asarray(pt),
                             jnp.asarray([n], jnp.int32))[0], np.float32)


_window_step = jax.jit(
    lambda p, k, v, kb, vb, m, t, pos, pt, hl: jmodel.decode_window_step(
        p, SPEC_J, k, v, kb, vb, m, t, pos, pt, hl))


def _ref_int8_logits(jparams, prompt, gen, M=ENGINE_KW["decode_window"]):
    """The reference's logits behind each token of ``gen`` on an int8 pool:
    gen[0] from the prefill, gen[i] from step (i-1) % M of decode window
    (i-1) // M, whose history is the prompt and the earlier windows'
    committed (quantized) tokens and whose buffer holds this window's."""
    n, page = len(prompt), ENGINE_KW["page_size"]
    L, nkv, d = SPEC_J.num_layers, SPEC_J.num_kv_heads, SPEC_J.head_dim
    pages = ENGINE_KW["max_pages_per_seq"]
    shape = (L, nkv, pages + 1, page, d)
    kc, vc = (jq.QuantKV(jnp.zeros(shape, jnp.int8),
                         jnp.zeros(shape[:-1], jnp.float32))
              for _ in range(2))
    bucket = 32 * -(-n // 32)
    tok = np.zeros((1, bucket), np.int32)
    tok[0, :n] = prompt
    pos = np.minimum(np.arange(bucket), n - 1)[None].astype(np.int32)
    table = np.arange(1, pages + 1, dtype=np.int32)[None]
    logits, kc, vc = jax.jit(
        lambda p, k, v, t, ps, pt, sl: jmodel.prefill_forward(
            p, SPEC_J, k, v, t, ps, pt, sl))(
        jparams, kc, vc, jnp.asarray(tok), jnp.asarray(pos),
        jnp.asarray(table[:, :bucket // page]), jnp.asarray([n], jnp.int32))
    out = [np.asarray(logits[0], np.float32)]
    for w0 in range(0, len(gen) - 1, M):
        kb = jnp.zeros((L, nkv, 1, M, d), jnp.bfloat16)
        vb = jnp.zeros_like(kb)
        for m in range(M):
            logits, kn, vn = _window_step(
                jparams, kc, vc, kb, vb, jnp.asarray(m, jnp.int32),
                jnp.asarray([gen[min(w0 + m, len(gen) - 1)]], jnp.int32),
                jnp.asarray([n + w0 + m], jnp.int32), jnp.asarray(table),
                jnp.asarray([n + w0], jnp.int32))
            kb = kb.at[:, :, :, m].set(kn.transpose(0, 2, 1, 3))
            vb = vb.at[:, :, :, m].set(vn.transpose(0, 2, 1, 3))
            out.append(np.asarray(logits[0], np.float32))
        p = n + w0 + np.arange(M)
        dest = jnp.asarray(table[0, p // page][:, None])
        off = jnp.asarray((p % page)[:, None])
        kc = jq.scatter_tokens(kc, kb.transpose(0, 1, 3, 2, 4), dest, off)
        vc = jq.scatter_tokens(vc, vb.transpose(0, 1, 3, 2, 4), dest, off)
    return out[:len(gen)]


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


@async_test(timeout=300)
async def test_greedy_tokens_match_reference_at_clear_margins(engines):
    await _greedy_at_clear_margins(*engines, lambda jp, p, rt, i:
                                   _ref_logits(jp, p + rt[:i]))


@async_test(timeout=300)
async def test_int8_greedy_tokens_match_reference_at_clear_margins(
        engines_int8):
    """Both engines on int8 pools (``quant_kv="int8"``)."""
    _, _, teng = engines_int8
    assert teng.runner.k_cache.data.dtype == torch.int8
    await _greedy_at_clear_margins(*engines_int8, lambda jp, p, rt, i:
                                   _ref_int8_logits(jp, p, rt[:i + 1])[i])


async def _greedy_at_clear_margins(jparams, jeng, teng, ref_logits):
    """``ref_logits(jparams, prompt, ref_tokens, i)``: the reference's
    logits behind its token i."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, SPEC_J.vocab_size, size=n).tolist()
               for n in (20, 33, 47, 61)]
    max_tokens = 10
    ref = await asyncio.gather(*[
        _collect(jeng, JRequest.from_wire(_wire(p, max_tokens)), JContext())
        for p in prompts])
    got = await asyncio.gather(*[
        _collect(teng, _wire(p, max_tokens), TContext()) for p in prompts])
    compared = 0
    for prompt, (rt, rf), (gt, gf) in zip(prompts, ref, got):
        assert rf == gf == "length"
        assert len(rt) == len(gt) == max_tokens
        for i, (a, b) in enumerate(zip(rt, gt)):
            if a == b:
                compared += 1
                continue
            logits = ref_logits(jparams, prompt, rt, i)
            top2 = np.sort(logits)[-2:]
            margin = float(top2[1] - top2[0])
            assert margin <= _bf16_ulp(top2[1]), (
                f"token {i}: port {b} != reference {a} at a clear margin "
                f"{margin:.4f}")
            break  # a legitimate near-tie split: the chains diverge here
    assert compared >= 20


@async_test(timeout=300)
async def test_seeded_stream_repeats_and_engine_counts(engines):
    """A seeded sampled request gives the same tokens alone and beside
    other traffic; every decode window launched M steps."""
    _, _, teng = engines
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, SPEC_T.vocab_size, size=25).tolist()
    seeded = dict(temperature=0.9, top_p=0.9, seed=1234)
    alone, _ = await _collect(teng, _wire(prompt, 12, **seeded), TContext())
    others = [rng.integers(0, SPEC_T.vocab_size, size=n).tolist()
              for n in (30, 40)]
    results = await asyncio.gather(
        _collect(teng, _wire(others[0], 9, temperature=1.0), TContext()),
        _collect(teng, _wire(prompt, 12, **seeded), TContext()),
        _collect(teng, _wire(others[1], 7), TContext()))
    assert results[1][0] == alone
    assert [len(t) for t, _ in results] == [9, 12, 7]
    assert teng.windows_dispatched >= 1


@async_test(timeout=300)
async def test_stop_conditions_and_validation(engines):
    _, _, teng = engines
    rng = np.random.default_rng(13)
    prompt = rng.integers(0, SPEC_T.vocab_size, size=22).tolist()
    ref, _ = await _collect(teng, _wire(prompt, 8), TContext())
    idx = next((i for i in range(1, len(ref)) if ref[i] not in ref[:i]), 0)
    eos = dict(_wire(prompt, 8), eos_token_ids=[ref[idx]])
    got, finish = await _collect(teng, eos, TContext())
    assert finish == "eos" and got == ref[:idx + 1]
    stop = _wire(prompt, 8)
    stop["stop_conditions"]["stop_token_ids"] = [ref[idx]]
    got, finish = await _collect(teng, stop, TContext())
    assert finish == "stop" and got == ref[:idx + 1]
    # Only max_model_len bounds a prompt; an adapter request to an engine
    # built without LoRA slots is the reference's typed not-found (404 at
    # a front), and multimodal requests are refused until their slice is
    # ported.
    with pytest.raises(ValueError, match="max model len"):
        await _collect(teng, _wire(list(range(256)), 4), TContext())
    with pytest.raises(AdapterNotFoundError, match="serves no adapters"):
        await _collect(teng, dict(_wire(prompt, 4), adapter="a"), TContext())
    with pytest.raises(ValueError, match="not ported yet: multimodal"):
        await _collect(teng, dict(_wire(prompt, 4), mm_embeds=[{"start": 0}]),
                       TContext())


def test_decode_window_counts_attention_bytes_and_checks_rows():
    """The runner adds each window's paged attention bytes on the host
    (every step of every layer reads the same history), and refuses a
    history its page-table row cannot hold."""
    from dynamo_tpu_torch.engine import attention, runner as trunner

    r = trunner.ModelRunner(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                              **ENGINE_KW))
    M, width = 4, 8
    packed = np.zeros((4, trunner.PK_PREFIX + width), np.int32)
    packed[0, trunner.PK_POS] = 19
    packed[0, trunner.PK_SEQLEN] = 20
    packed[0, trunner.PK_CAP] = 32
    packed[0, trunner.PK_PREFIX:trunner.PK_PREFIX + 2] = [1, 2]
    r.decode_window(packed, M)
    per_launch = attention.hist_flash_bytes(np.array([19, 0, 0, 0]),
                                            SPEC_T.num_heads, r.k_cache)
    assert r.attention_bytes == M * SPEC_T.num_layers * per_launch
    packed[0, trunner.PK_SEQLEN] = width * 16 + 2
    with pytest.raises(ValueError, match="page-table row"):
        r.decode_window(packed, M)
    assert r.attention_bytes == M * SPEC_T.num_layers * per_launch


def test_engine_refuses_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        GPUEngine(tcfg.EngineConfig(model=SPEC_T, num_pages=8))


@async_test(timeout=300)
async def test_preemption_requeues_and_finishes():
    """A pool too small for three growing sequences: the engine preempts
    the youngest slots, re-prefills them from their accumulated tokens,
    and every request still streams exactly max_tokens tokens, most of
    them the same tokens as with a pool large enough for all."""
    kw = dict(ENGINE_KW, max_prefill_tokens=256)

    def make(pages):
        return GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                           **dict(kw, num_pages=pages)))

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, SPEC_T.vocab_size, 30).tolist()
               for _ in range(3)]
    big, small = make(64), make(10)
    try:
        want = await asyncio.gather(*[
            _collect(big, _wire(p, 40), TContext()) for p in prompts])
        got = await asyncio.gather(*[
            _collect(small, _wire(p, 40), TContext()) for p in prompts])
    finally:
        big.stop()
        small.stop()
    assert small.preempt_count > 0 and big.preempt_count == 0
    for (wt, wf), (gt, gf) in zip(want, got):
        assert wf == gf == "length" and len(wt) == len(gt) == 40
    # Re-prefilled KV is recomputed by the dense prefill, not the decode
    # path: near-ties may flip late in a chain, not across the board.
    assert sum(wt == gt for (wt, _), (gt, _) in zip(want, got)) >= 2


def test_page_allocator_tracks_reference():
    """The port's PageAllocator copy hands out the same pages as the
    reference's under one random mix of allocate / register / release /
    acquire_cached / unregister, LRU eviction included; page 0 is never
    handed out."""
    from dynamo_tpu.engine.kv_cache import PageAllocator as JAlloc
    from dynamo_tpu_torch.engine.kv_cache import PageAllocator as TAlloc

    rng = np.random.default_rng(21)
    ref, port = JAlloc(24, 16), TAlloc(24, 16)
    held: list[list[int]] = []
    for _ in range(400):
        op = rng.integers(0, 5)
        if op == 0 or not held:
            n = int(rng.integers(1, 6))
            got = port.allocate(n)
            assert got == ref.allocate(n)
            if got is not None:
                assert 0 not in got
                held.append(got)
        elif op == 1:
            pages = held.pop(int(rng.integers(len(held))))
            port.release(pages)
            ref.release(pages)
        elif op == 2:
            page = int(rng.choice(held[int(rng.integers(len(held)))]))
            h = int(rng.integers(0, 12))
            port.register(page, h)
            ref.register(page, h)
        elif op == 3:
            hashes = [int(x) for x in rng.integers(0, 12, size=3)]
            got = port.acquire_cached(hashes)
            assert got == ref.acquire_cached(hashes)
            if got:
                held.append(got)
        else:
            pages = held[int(rng.integers(len(held)))]
            port.unregister(pages)
            ref.unregister(pages)
        assert (port.free, port.refs, dict(port.inactive), port.cached) == \
            (ref.free, ref.refs, dict(ref.inactive), ref.cached)
        assert port.num_free == ref.num_free


def test_wire_dicts_match_reference():
    """The port's protocol dataclasses read and write the reference's wire
    dicts."""
    from dynamo_tpu.llm.protocols import LLMEngineOutput as JOut
    from dynamo_tpu.llm.protocols import FinishReason as JFinish
    from dynamo_tpu_torch.llm.protocols import (FinishReason,
                                                LLMEngineOutput,
                                                PreprocessedRequest)

    ref = JRequest.from_wire(dict(
        _wire([1, 2, 3], 7, temperature=0.5, seed=9),
        eos_token_ids=[2], annotations={"a": 1}))
    wire = ref.to_wire()
    port = PreprocessedRequest.from_wire(wire)
    assert port.to_wire() == wire
    assert port.stop_conditions.max_tokens == 7
    assert port.sampling_options.seed == 9
    out = LLMEngineOutput(token_ids=[4, 5], finish_reason=FinishReason.EOS)
    assert out.to_wire() == JOut(token_ids=[4, 5],
                                 finish_reason=JFinish.EOS).to_wire()
    assert LLMEngineOutput.from_wire(out.to_wire()) == out
