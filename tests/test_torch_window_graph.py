"""Window programs (``runner.WindowProgram``) and the counter-based noise
(``sampler.gumbel_field``) on the CPU, where a program's body runs eagerly.

- The body of each program kind (plain, penalized, logprobs) equals the
  JAX package's ``ModelRunner.decode_window`` on the same weights, pool
  contents and packed array, on a bf16 and an int8 pool: tokens equal
  where the reference's top-2 margin is clear (above 2^-4, a bf16 ulp of
  a logit under 16), logprobs and top-8 values within the bf16 logit
  tolerance (atol 0.1, rtol 0.05) of ``tests/test_torch_penalties.py``.
- One program per key ``(window, bucket_pages, penalized, seeded,
  logprobs)``, made at the key's first use and reused after.
- The warmup is inert: the pool outside the scratch page 0, ``tokens_dev``
  and ``counts`` keep their bytes.
- ``gumbel_field``: a function of (key, counter, token id) only; seeded
  tokens drawn with it follow the softmax target (chi-square at
  p = 1e-3); a seeded request samples a position's token from the same
  field in ``prefill_batch`` and in a window; and it equals a numpy
  transcription of SplitMix64 bit for bit.
- A capture that fails on the card's path raises out of the engine's
  start, and a window never runs eagerly in its place (the capture is
  replaced by a failing one on the CPU, with the runner set to the graph
  path).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine import runner as jrunner
from dynamo_tpu.engine.kv_quant import QuantKV as JQuantKV
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import runner as trunner
from dynamo_tpu_torch.engine import sampler as tsampler
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.engine.kv_quant import QuantKV as TQuantKV
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.runtime.context import Context

torch.set_num_threads(1)

TOL = dict(atol=0.1, rtol=0.05)
CLEAR = 2.0 ** -4
PAGE = 16
KW = dict(page_size=PAGE, num_pages=24, max_pages_per_seq=8, max_num_seqs=4,
          prefill_buckets=(32, 64), max_prefill_tokens=64)
M = 4
WIDTH = 8
SPEC_J = jcfg.PRESETS["tiny-test"]
SPEC_T = tcfg.PRESETS["tiny-test"]
V = SPEC_J.vocab_size


def _f32_bits(x: float) -> int:
    return int(np.float32(x).view(np.int32))


def _tcfg(**kw):
    return tcfg.EngineConfig(model=SPEC_T, device="cpu", **dict(KW, **kw))


@pytest.fixture(scope="module", params=["bf16", "int8"])
def runners(request):
    """A JAX and a port runner on the same weights and random pools."""
    quant = request.param == "int8"
    kw = dict(KW, quant_kv="int8" if quant else None)
    jparams = jmodel.init_params(SPEC_J, jax.random.key(3))
    jr = jrunner.ModelRunner(jcfg.EngineConfig(
        model=SPEC_J, attention_backend="xla", **kw), params=jparams)
    tr = trunner.ModelRunner(
        tcfg.EngineConfig(model=SPEC_T, device="cpu", **kw),
        params=params_from_jax(jax.tree.map(np.asarray, jparams), SPEC_T,
                               device="cpu"))
    rng = np.random.default_rng(9)
    shape = (SPEC_J.num_layers, SPEC_J.num_kv_heads, KW["num_pages"], PAGE,
             SPEC_J.head_dim)
    pools = []
    for jc in (jr.k_cache, jr.v_cache):
        if quant:
            q = rng.integers(-127, 128, shape).astype(np.int8)
            s = rng.uniform(0.01, 0.05, shape[:-1]).astype(np.float32)
            pools.append((JQuantKV(jax.device_put(q, jc.data.sharding),
                                   jax.device_put(s, jc.scale.sharding)),
                          TQuantKV(torch.from_numpy(q), torch.from_numpy(s))))
        else:
            x = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(torch.bfloat16)
            pools.append((jax.device_put(
                jnp.asarray(x.float().numpy(), jnp.bfloat16), jc.sharding),
                x))
    (jr.k_cache, tr.k_cache), (jr.v_cache, tr.v_cache) = pools
    return jr, tr


def _packed(rng, penalized: bool, logprobs: bool) -> np.ndarray:
    """Three live greedy slots over 21-40 tokens of history, each with its
    own pages and first token; slot 3 inactive."""
    packed = np.zeros((4, trunner.PK_PREFIX + WIDTH), np.int32)
    for i, h in enumerate((21, 35, 40)):
        packed[i, trunner.PK_OVERRIDE] = 1
        packed[i, trunner.PK_TOKEN] = rng.integers(0, V)
        packed[i, trunner.PK_POS] = h
        packed[i, trunner.PK_SEQLEN] = h + 1
        packed[i, trunner.PK_TOPP] = _f32_bits(1.0)
        packed[i, trunner.PK_CAP] = WIDTH * PAGE
        packed[i, trunner.PK_LOGPROB] = int(logprobs)
        if penalized:
            packed[i, trunner.PK_FREQPEN] = _f32_bits(0.5 * i)
            packed[i, trunner.PK_PRESPEN] = _f32_bits(0.7)
        packed[i, trunner.PK_PREFIX:] = 1 + 5 * i + np.arange(WIDTH) % 5
    return packed


@pytest.mark.parametrize("kind", ["plain", "penalized", "logprobs"])
def test_program_body_matches_reference_window(runners, kind):
    """The program of each kind, run through its key, against the JAX
    window on the same packed array. The reference runs with every live
    row asking for logprobs (which changes no token) to give the margins
    at which two chains may split."""
    jr, tr = runners
    rng = np.random.default_rng(["plain", "penalized", "logprobs"]
                                .index(kind))
    penalized, logprobs = kind == "penalized", kind == "logprobs"
    packed = _packed(rng, penalized, logprobs)
    if penalized:
        rows = np.zeros((4, V), np.uint8)
        for i in range(3):
            rows[i, rng.choice(V, 25, replace=False)] = rng.integers(1, 4, 25)
        jr.set_count_rows([0, 1, 2, 3], rows)
        tr.set_count_rows([0, 1, 2, 3], rows)
    ref = packed.copy()
    ref[:3, trunner.PK_LOGPROB] = 1
    toks_j, lps_j, tvs_j, tis_j = (np.asarray(a) for a in
                                   jr.decode_window(ref, M))
    prog = tr._get_window(M, WIDTH, penalized, False, logprobs)
    outs = prog.run(packed)
    assert (outs[1] is None) == (not logprobs)
    toks_t = outs[0].numpy()
    compared = 0
    for i in range(3):
        whole = True
        for m in range(M):
            if toks_t[m, i] != toks_j[m, i]:
                assert tvs_j[m, i, 0] - tvs_j[m, i, 1] <= CLEAR, (
                    f"row {i} step {m}: port {toks_t[m, i]} != reference "
                    f"{toks_j[m, i]} at a clear margin")
                whole = False
                break
            if logprobs:
                np.testing.assert_allclose(outs[1][m, i].item(),
                                           lps_j[m, i], **TOL)
                np.testing.assert_allclose(outs[2][m, i].numpy(),
                                           tvs_j[m, i], **TOL)
            compared += 1
        if whole and penalized:
            np.testing.assert_array_equal(tr.counts[i].numpy(),
                                          np.asarray(jr.counts_dev)[i])
    assert compared >= 8, compared


def test_one_program_per_key():
    r = trunner.ModelRunner(_tcfg())
    packed = np.zeros((4, trunner.PK_PREFIX + WIDTH), np.int32)
    packed[0, trunner.PK_SEQLEN] = 1
    packed[0, trunner.PK_CAP] = WIDTH * PAGE
    packed[0, trunner.PK_PREFIX] = 1
    r.decode_window(packed, M)
    r.decode_window(packed, M)
    assert list(r._window_cache) == [(M, WIDTH, False, False, False)]
    plain = r._window_cache[(M, WIDTH, False, False, False)]
    assert r._get_window(M, WIDTH, False, False, False) is plain
    variants = {(M, WIDTH, True, False, False): (trunner.PK_FREQPEN,
                                                 _f32_bits(0.5)),
                (M, WIDTH, False, True, False): (trunner.PK_SEEDED, 1),
                (M, WIDTH, False, False, True): (trunner.PK_LOGPROB, 1)}
    for key, (col, val) in variants.items():
        other = packed.copy()
        other[0, col] = val
        r.decode_window(other, M)
        assert key in r._window_cache and r._window_cache[key] is not plain
    wide = np.zeros((4, trunner.PK_PREFIX + 2 * WIDTH), np.int32)
    r.decode_window(wide, M)
    assert (M, 2 * WIDTH, False, False, False) in r._window_cache
    assert len(r._window_cache) == 5
    assert r.window_replays == 0
    assert r.window_programs()["captured"] == 0


def _randomise_state(runner, rng):
    """Random pool bytes, tokens_dev and count rows."""
    for cache in (runner.k_cache, runner.v_cache):
        if isinstance(cache, TQuantKV):
            cache.data.copy_(torch.from_numpy(rng.integers(
                -127, 128, cache.data.shape).astype(np.int8)))
            cache.scale.copy_(torch.from_numpy(rng.uniform(
                0.01, 0.05, cache.scale.shape).astype(np.float32)))
        else:
            cache.copy_(torch.from_numpy(rng.standard_normal(
                cache.shape).astype(np.float32)))
    runner.tokens_dev.copy_(torch.from_numpy(
        rng.integers(0, V, runner.tokens_dev.shape).astype(np.int32)))
    runner.counts.copy_(torch.from_numpy(
        rng.integers(0, 256, runner.counts.shape).astype(np.uint8)))


def _pool_bytes(runner):
    out = []
    for cache in (runner.k_cache, runner.v_cache):
        for t in ((cache.data, cache.scale) if isinstance(cache, TQuantKV)
                  else (cache,)):
            out.append(t[:, :, 1:].clone())
    return out


@pytest.mark.parametrize("quant_kv", [None, "int8"], ids=["bf16", "int8"])
def test_warmup_is_inert(quant_kv):
    engine = GPUEngine(_tcfg(quant_kv=quant_kv, warmup_windows=True,
                             decode_window=M))
    runner = engine.runner
    _randomise_state(runner, np.random.default_rng(2))
    pool = _pool_bytes(runner)
    tokens, counts = runner.tokens_dev.clone(), runner.counts.clone()
    engine._warmup_window_programs()
    bucket = runner.bucket_pages_for(1)
    assert sorted(runner._window_cache) == sorted(
        (M, bucket, pen, seed, lp) for pen in (False, True)
        for seed in (False, True) for lp in (False, True))
    for before, after in zip(pool, _pool_bytes(runner)):
        assert torch.equal(before, after)
    assert torch.equal(runner.tokens_dev, tokens)
    assert torch.equal(runner.counts, counts)
    assert engine.warmup_seconds > 0


def test_engine_start_warms_then_serves():
    engine = GPUEngine(_tcfg(warmup_windows=True, decode_window=M))

    async def go():
        engine.start()
        try:
            assert len(engine.runner._window_cache) == 8
            req = {"model": SPEC_T.name, "token_ids": list(range(1, 20)),
                   "stop_conditions": {"max_tokens": 6},
                   "sampling_options": {}}
            toks = []
            async for item in engine.generate(req, Context()):
                toks.extend(item.get("token_ids", []))
            return toks
        finally:
            engine.stop()

    assert len(asyncio.run(go())) == 6


def test_failed_capture_raises_out_of_engine_start(monkeypatch):
    def fail(self):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(trunner.WindowProgram, "capture", fail)
    engine = GPUEngine(_tcfg(warmup_windows=True, decode_window=M))
    engine.runner.use_graphs = True  # the card's path, on the CPU
    with pytest.raises(RuntimeError, match="warmup") as info:
        engine.start()
    assert "capture failed" in str(info.value.__cause__)
    assert not engine._running and engine._thread is None
    # No eager window in its place either.
    packed = np.zeros((4, trunner.PK_PREFIX + WIDTH), np.int32)
    with pytest.raises(RuntimeError, match="capture failed"):
        engine.runner.decode_window(packed, M)
    assert engine.runner.window_replays == 0


# ---------------------------------------------------------------------------
# gumbel_field
# ---------------------------------------------------------------------------

def _field(keys, counters, v=V):
    return tsampler.gumbel_field(torch.tensor(keys, dtype=torch.int64),
                                 torch.tensor(counters, dtype=torch.int64), v)


def test_field_is_a_function_of_key_counter_and_token():
    """A row's field depends on its (key, counter) alone, whatever the
    batch, and entry t on neither the batch nor the vocabulary size."""
    keys = [5, 2**31 - 1, 2**32 + 3, 5, 0, 7 * 2**32 + 1]
    counters = [9, 9, 0, 10, 0, 123456]
    whole = _field(keys, counters)
    for i, (k, c) in enumerate(zip(keys, counters)):
        assert torch.equal(_field([k], [c])[0], whole[i])
        assert torch.equal(_field([k], [c], v=V // 3)[0], whole[i, :V // 3])
    rev = _field(keys[::-1], counters[::-1])
    assert torch.equal(rev.flip(0), whole)
    # Distinct (key, counter) pairs give distinct fields.
    assert len({tuple(r.tolist()) for r in whole}) == len(keys)
    assert torch.isfinite(whole).all() and whole.dtype == torch.float32


def _target(logits_row, temp, top_k, top_p):
    scaled = logits_row.astype(np.float64) / temp
    order = np.argsort(-scaled)[:min(64, len(scaled))]
    k = len(order) if top_k <= 0 else min(top_k, len(order))
    order = order[:k]
    p = np.exp(scaled[order] - scaled[order].max())
    p /= p.sum()
    keep = (np.cumsum(p) - p) < top_p
    out = np.zeros(len(scaled))
    out[order[keep]] = p[keep] / p[keep].sum()
    return out


@pytest.mark.parametrize("temp,top_k,top_p", [
    (0.7, 0, 1.0), (1.0, 4, 1.0), (1.0, 0, 0.8), (1.3, 10, 0.95)])
def test_seeded_draws_follow_the_softmax(temp, top_k, top_p):
    """One seeded request's draws at 4000 consecutive positions over the
    same logits: frequencies match the filtered, renormalised softmax at
    p = 1e-3."""
    v, n = 16, 4000
    row = (np.random.default_rng(5).standard_normal(v) * 2).astype(
        np.float32)
    noise = tsampler.gumbel_field(torch.full((n,), 1234),
                                  torch.arange(100, 100 + n), v)
    out = tsampler.sample_tokens_per_row(
        torch.from_numpy(np.tile(row, (n, 1))), torch.full((n,), temp),
        torch.full((n,), top_k), torch.full((n,), top_p), noise).numpy()
    p = _target(row, temp, top_k, top_p)
    counts = np.bincount(out, minlength=v).astype(np.float64)
    assert counts[p == 0].sum() == 0, "token outside the candidate set"
    keep = p > 0
    stat = float(((counts[keep] - n * p[keep]) ** 2 / (n * p[keep])).sum())
    df = int(keep.sum()) - 1
    assert stat < stats.chi2.ppf(0.999, df), (stat, df)


def test_seeded_token_same_from_prefill_and_window():
    """A seeded request's token at position n comes from the field of
    (seed, n) in prefill_batch and in a window, whatever the batch: with
    the final norm zeroed every logit is 0, so the token is the field's
    argmax. With real logits, prefill's token is the sampler's on its own
    logits and that field."""
    seed, n, temp = 99, 20, 0.8
    want = int(_field([seed], [n]).argmax())
    r = trunner.ModelRunner(_tcfg())
    prompt = np.arange(1, n + 1, dtype=np.int32)

    def seq(tokens, pages, s, start=0):
        return trunner.PrefillSeq(tokens=tokens, chunk_pages=np.asarray(pages),
                                  sampling=(temp, 0, 1.0), seed=s,
                                  start_pos=start)

    tok = r.prefill_batch([seq(prompt, [1, 2], seed)])[0]
    noise = _field([seed], [n])
    assert int(tok[0]) == int(tsampler.sample_tokens_per_row(
        r.last_prefill_logits, torch.tensor([temp]), torch.tensor([0]),
        torch.tensor([1.0]), noise)[0])
    r.params["final_norm"] = torch.zeros_like(r.params["final_norm"])
    alone = r.prefill_batch([seq(prompt, [1, 2], seed)])[0]
    batch = r.prefill_batch([seq(prompt[:7], [3], 5),
                             seq(prompt, [1, 2], seed),
                             seq(prompt[:9], [4], None)])[0]
    assert int(alone[0]) == int(batch[1]) == want
    # A window whose slot 2 feeds the prompt's last token (position n - 1)
    # samples position n, beside a seeded and an unseeded slot.
    r.prefill_batch([seq(prompt[:-1], [1, 2], seed)])
    packed = np.zeros((4, trunner.PK_PREFIX + WIDTH), np.int32)
    for i, (s, pos) in enumerate(((7, 30), (None, 12), (seed, n - 1))):
        packed[i, trunner.PK_OVERRIDE] = 1
        packed[i, trunner.PK_TOKEN] = prompt[-1]
        packed[i, trunner.PK_POS] = pos
        packed[i, trunner.PK_SEQLEN] = pos + 1
        packed[i, trunner.PK_TEMP] = _f32_bits(temp)
        packed[i, trunner.PK_TOPP] = _f32_bits(1.0)
        packed[i, trunner.PK_CAP] = WIDTH * PAGE
        packed[i, trunner.PK_SEED] = s or 0
        packed[i, trunner.PK_SEEDED] = int(s is not None)
        packed[i, trunner.PK_PREFIX:] = [1, 2, 5, 6, 7, 8, 9, 10][:WIDTH]
    toks = r.decode_window(packed, M)[0]
    assert int(toks[0, 2]) == want
    # Every later step of the seeded slot is its position's field argmax.
    for m in range(1, M):
        assert int(toks[m, 2]) == int(_field([seed], [n + m]).argmax())


MASK64 = (1 << 64) - 1


def _np_mix64(z):
    z = z ^ (z >> np.uint64(30))
    z = z * np.uint64(0xBF58476D1CE4E5B9)
    z = z ^ (z >> np.uint64(27))
    z = z * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _np_field(keys, counters, v):
    """SplitMix64 in numpy uint64 (wrapping by definition): the 24-bit
    uniforms and the fp32 Gumbel noise."""
    golden = np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        keys = np.asarray([k & MASK64 for k in keys], np.uint64)
        state = _np_mix64(_np_mix64(keys + golden)
                          + np.asarray(counters, np.uint64))
        steps = np.arange(1, v + 1, dtype=np.uint64) * golden
        z = _np_mix64(state[:, None] + steps[None, :])
    bits = z >> np.uint64(40)
    u = (bits.astype(np.float64) + 0.5) * 2.0 ** -24
    return bits, (-np.log(-np.log(u))).astype(np.float32)


def test_field_equals_numpy_splitmix64_bit_for_bit():
    keys = [0, 1, 1234, 2**31 - 1, 2**32, 2**32 + 31, 2**40 + 5, 2**62 + 9]
    counters = [0, 1, 7, 2**31 - 1, 2**32 + 3, 5, 99, 100000]
    bits, want = _np_field(keys, counters, 4096)
    got = _field(keys, counters, 4096)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert bits.min() >= 0 and bits.max() < 1 << 24
    # Every 24-bit uniform maps to the same fp32 Gumbel value in torch and
    # in numpy: the map is exact for all 2^24 inputs.
    g = tsampler.gumbel_of_bits(torch.arange(1 << 24)).numpy()
    un = (np.arange(1 << 24, dtype=np.float64) + 0.5) * 2.0 ** -24
    assert np.array_equal(g.view(np.int32),
                          (-np.log(-np.log(un))).astype(np.float32)
                          .view(np.int32))
