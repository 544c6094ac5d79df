"""Speculative decoding in the port (``spec_decode="ngram"``) against the
JAX package's, on the CPU at tiny-test widths.

The JAX side runs with ``attention_backend="xla"``, as
``tests/test_spec_decode.py`` does: its spec window has no Pallas call.
Weights go from the JAX ``init_params`` tree to the port through
``params_from_jax``. Tolerances:

- ``decode_window_multi_step`` logits within atol 0.1, rtol 0.05 of the
  reference's, and its new K/V within atol 0.05, rtol 0.02: the tolerances
  ``tests/test_torch_model.py`` holds ``decode_window_step`` and the
  prefill's K/V to (bf16 activations rounded at the same places, CPU
  matmuls summed in other orders).
- The kernel route ``paged_verify_attention`` against its plain version
  on the same inputs: atol and rtol 1.6e-2, two bf16 ulps of the bf16
  outputs (the route keeps fp32 history probabilities where the plain
  version rounds them to bf16 before PV), as ``tests/test_torch_kernel.py``
  holds the window wrappers.
- ``seed_history`` and the host-visible state of a spec window (positions,
  history, emitted counts, drafts): exact.
- Greedy tokens: equal, or split at a verified near-tie only: at the first
  difference both tokens are the dense teacher-forced top two within two
  bf16 ulps (the reference's own arbiter, ``tests/test_spec_decode.py``);
  later tokens have other contexts and are not compared.
- Sampled tokens: chi-square against the softmax target at p = 1e-3.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import async_test
from scipy import stats

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine import runner as jrunner
from dynamo_tpu.engine.engine import TPUEngine
from dynamo_tpu.engine.kv_quant import QuantKV as JQuantKV
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.runtime.context import Context as JContext
from dynamo_tpu_torch.backends import gpu
from dynamo_tpu_torch.engine import attention as tattn
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import model as tmodel
from dynamo_tpu_torch.engine import runner as trunner
from dynamo_tpu_torch.engine import sampler as tsampler
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.engine.kv_quant import QuantKV as TQuantKV
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.runtime.context import Context as TContext
from dynamo_tpu_torch.time_attention import make_verify_case, verify_args

torch.set_num_threads(1)

TOL = dict(atol=0.1, rtol=0.05)
KV_TOL = dict(atol=0.05, rtol=0.02)
OUTPUT_TOL = dict(atol=1.6e-2, rtol=1.6e-2)
SPEC_J = jcfg.PRESETS["tiny-test"]
SPEC_T = tcfg.PRESETS["tiny-test"]
V = SPEC_J.vocab_size
PAGE = 16
# The reference test's engine configuration.
ENGINE_KW = dict(page_size=PAGE, num_pages=128, max_pages_per_seq=16,
                 max_num_seqs=4, prefill_buckets=(32, 64, 128, 256),
                 max_prefill_tokens=64, decode_window=8, pipeline_depth=2)
SPEC_KW = dict(spec_decode="ngram", spec_k=3)
RUNNER_KW = dict(page_size=PAGE, num_pages=32, max_pages_per_seq=8,
                 max_num_seqs=4, prefill_buckets=(32, 64),
                 max_prefill_tokens=64, **SPEC_KW)


@pytest.fixture(scope="module")
def weights():
    jparams = jmodel.init_params(SPEC_J, jax.random.key(5))
    return jparams, params_of(jparams)


def params_of(jparams):
    from dynamo_tpu_torch.engine.weights import params_from_jax
    return params_from_jax(jax.tree.map(np.asarray, jparams), SPEC_T,
                           device="cpu")


def repetitive_prompt(n=48, period=6, seed=3):
    """A looping token pattern, the bigram drafter's best case (the
    reference test's prompt)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, V, size=period).tolist()
    return (base * (n // period + 1))[:n]


def random_prompt(n, seed):
    return np.random.default_rng(seed).integers(1, V, size=n).tolist()


_dense = jax.jit(lambda p, k, v, t, pos, pt, sl: jmodel.prefill_forward(
    p, SPEC_J, k, v, t, pos, pt, sl)[0])


def dense_logits(jparams, context):
    """The reference's teacher-forced last-position logits of
    ``context``."""
    n = len(context)
    bucket = 32 * -(-n // 32)
    shape = (SPEC_J.num_layers, SPEC_J.num_kv_heads, bucket // PAGE + 1,
             PAGE, SPEC_J.head_dim)
    tok = np.zeros((1, bucket), np.int32)
    tok[0, :n] = context
    pos = np.minimum(np.arange(bucket), n - 1)[None].astype(np.int32)
    pt = np.arange(1, bucket // PAGE + 1, dtype=np.int32)[None]
    return np.asarray(_dense(jparams, jnp.zeros(shape, jnp.bfloat16),
                             jnp.zeros(shape, jnp.bfloat16), jnp.asarray(tok),
                             jnp.asarray(pos), jnp.asarray(pt),
                             jnp.asarray([n], jnp.int32))[0], np.float32)


def assert_greedy_equivalent(jparams, prompt, ref, got):
    """Equal tokens, or a first split at a verified bf16 near-tie: both
    tokens in the dense top two within two bf16 ulps. Returns the number
    of leading tokens compared equal."""
    for i, (a, b) in enumerate(zip(ref, got)):
        if a == b:
            continue
        lg = dense_logits(jparams, list(prompt) + list(ref[:i]))
        top2 = {int(t) for t in np.argsort(lg)[::-1][:2]}
        ulp = float(np.spacing(np.float32(max(abs(lg[a]), abs(lg[b]))))) \
            * 2 ** 16
        gap = abs(float(lg[a] - lg[b]))
        assert {a, b} <= top2 and gap <= 2 * ulp, (
            f"split at token {i} ({a} vs {b}) is not a bf16 near-tie: "
            f"dense top-2 {sorted(top2)}, gap {gap:.5f}, ulp {ulp:.5f}")
        return i
    assert len(got) == len(ref)
    return len(ref)


def _wire(prompt, max_tokens, **sampling):
    return {"model": "tiny-test", "token_ids": list(prompt),
            "stop_conditions": {"max_tokens": max_tokens,
                                "ignore_eos": True},
            "sampling_options": sampling}


async def collect(engine, prompt, max_tokens, **sampling):
    toks, finish = [], None
    async for out in engine.generate(_wire(prompt, max_tokens, **sampling),
                                     TContext()):
        toks.extend(out.get("token_ids", []))
        finish = out.get("finish_reason") or finish
    assert finish == "length" and len(toks) == max_tokens, (finish, toks)
    return toks


async def collect_ref(engine, prompt, max_tokens):
    req = JRequest(model="tiny-test", token_ids=list(prompt))
    req.stop_conditions.max_tokens = max_tokens
    req.stop_conditions.ignore_eos = True
    toks = []
    async for out in engine.generate(req, JContext()):
        toks.extend(out.get("token_ids", []))
    return toks


def port_engine(weights, **kw):
    return GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                       **dict(ENGINE_KW, **kw)),
                     params=weights[1])


# ---------------------------------------------------------------------------
# (a), (b): the verify forward and its attention
# ---------------------------------------------------------------------------

_multi_step = jax.jit(
    lambda p, k, v, kb, vb, wl, t, pos, pt, hl:
    jmodel.decode_window_multi_step(p, SPEC_J, k, v, kb, vb, wl, t, pos, pt,
                                    hl))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_multi_step_matches_reference(weights, quant):
    """``decode_window_multi_step`` over a ragged paged history (one row
    empty), window buffers of 0 and some valid columns and S=4, through
    both attention routes, against the reference's on the same pool."""
    jparams, tparams = weights
    rng = np.random.default_rng(11 + quant)
    L, nkv, d = SPEC_J.num_layers, SPEC_J.num_kv_heads, SPEC_J.head_dim
    B, S, W, maxp, npages = 3, 4, 8, 6, 20
    shape = (L, nkv, npages, PAGE, d)
    pools = []
    for _ in range(2):
        if quant:
            q = rng.integers(-127, 128, shape).astype(np.int8)
            s = rng.uniform(0.01, 0.05, shape[:-1]).astype(np.float32)
            pools.append((JQuantKV(jnp.asarray(q), jnp.asarray(s)),
                          TQuantKV(torch.from_numpy(q), torch.from_numpy(s))))
        else:
            x = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(torch.bfloat16)
            pools.append((jnp.asarray(x.float().numpy(), jnp.bfloat16), x))
    (jk, tk), (jv, tv) = pools
    buf = torch.from_numpy(rng.standard_normal((2, L, nkv, B, W, d)).astype(
        np.float32)).to(torch.bfloat16)
    jbuf = jnp.asarray(buf.float().numpy(), jnp.bfloat16)
    hist = np.asarray([37, 0, 70], np.int32)
    wlen = np.asarray([0, 3, 5], np.int32)
    table = rng.permutation(np.arange(1, npages))[:B * maxp].reshape(
        B, maxp).astype(np.int32)
    tokens = rng.integers(0, V, (B, S)).astype(np.int32)
    positions = (hist + wlen)[:, None] + np.arange(S, dtype=np.int32)
    jl, jkn, jvn = _multi_step(jparams, jk, jv, jbuf[0], jbuf[1],
                               jnp.asarray(wlen), jnp.asarray(tokens),
                               jnp.asarray(positions), jnp.asarray(table),
                               jnp.asarray(hist))
    for impl in (None, tattn.paged_verify_attention):
        tl, tkn, tvn = tmodel.decode_window_multi_step(
            tparams, SPEC_T, tk, tv, buf[0], buf[1], torch.from_numpy(wlen),
            torch.from_numpy(tokens), torch.from_numpy(positions),
            torch.from_numpy(table), torch.from_numpy(hist),
            attention_impl=impl)
        assert tl.shape == (B, S, V) and tl.dtype == torch.float32
        assert tkn.shape == (L, B, S, nkv, d)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for t, j in ((tkn, jkn), (tvn, jvn)):
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(j, np.float32), **KV_TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("d,nkv,qpk,hist,s,wlen,layer", [
    (32, 2, 2, [0, 5, 17, 140], 4, [0, 3, 8, 1], 1),   # ragged, zero, W
    (64, 2, 4, [300, 0, 131], 1, [2, 0, 8], 0),        # S=1, GQA
    (128, 1, 8, [129, 700], 4, [8, 0], 1),             # MQA
    (128, 8, 4, [0, 33, 1000, 2049], 4, [4, 4, 0, 8], 1),
])
def test_verify_route_matches_plain_on_cpu(d, nkv, qpk, hist, s, wlen, layer,
                                           quant):
    """The kernel route on CPU tensors (the kernel's plain version for the
    history, folded over the S rows) against the einsum version."""
    c = make_verify_case(torch.Generator().manual_seed(d + s), d, len(hist),
                         nkv, qpk, hist, s, wlen, quant=quant, device="cpu")
    args = verify_args(c, layer)
    got = tattn.paged_verify_attention(*args)
    want = tmodel.paged_verify_attention_plain(*args)
    assert got.shape == want.shape == (len(hist), s, nkv * qpk, d)
    torch.testing.assert_close(got.float(), want.float(), **OUTPUT_TOL)


def test_fold_rows_repeats_each_row_contiguously():
    """The kernel route's folded page table and history lengths are
    contiguous copies, a batch of one included (an expand of one row
    reshapes to a stride-0 view, which the kernel refuses)."""
    table = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    for x in (table, table[:1], table[:, 0], table[1:2, 0]):
        got = tattn.fold_rows(x, 4)
        assert got.is_contiguous() and got.stride()[0] > 0
        assert torch.equal(got, x.repeat_interleave(4, dim=0))


# ---------------------------------------------------------------------------
# (c), (d): seed_history and one spec window against the JAX runner
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runners(weights):
    jparams, tparams = weights
    jr = jrunner.ModelRunner(jcfg.EngineConfig(
        model=SPEC_J, attention_backend="xla", **RUNNER_KW), params=jparams)
    tr = trunner.ModelRunner(tcfg.EngineConfig(
        model=SPEC_T, device="cpu", **RUNNER_KW), params=tparams)
    return jr, tr


def _state(jr, tr):
    """(JAX, port) history and positions as numpy, the port's without its
    sinks."""
    H = tr.hist_dev.shape[1] - 1
    B = tr.tokens_dev.shape[0]
    return ((np.asarray(jr.hist_dev), np.asarray(jr.positions_dev)),
            (tr.hist_dev[:, :H].numpy(), tr.positions_dev[:B].numpy()))


def test_seed_history_matches_reference(runners):
    """Final entries from tokens_dev and from a host token, a non-final
    entry at an offset, an entry past the history's end and padding rows:
    hist_dev and positions_dev equal the reference's exactly, twice (the
    second call in the next bucket)."""
    jr, tr = runners
    rng = np.random.default_rng(2)
    H = tr.hist_dev.shape[1] - 1
    assert tr.hist_dev.shape == (4, H + 1) and H == 8 * PAGE
    assert tr.positions_dev.shape == (5,)
    chained = rng.integers(0, V, 4).astype(np.int32)
    jr.tokens_dev = jnp.asarray(chained)
    tr.tokens_dev.copy_(torch.from_numpy(chained))
    batches = [
        [(2, rng.integers(0, V, 40), 0, True, None),
         (0, rng.integers(0, V, 20), 16, False, None),
         (1, rng.integers(0, V, 130), 0, True, 7)],
        [(3, rng.integers(0, V, 100), 0, True, None),
         (0, rng.integers(0, V, 9), 36, True, 5)],
    ]
    for entries in batches:
        entries = [(s, t.astype(np.int32), *rest) for s, t, *rest in entries]
        jr.seed_history(entries)
        tr.seed_history(entries)
        (jh, jp), (th, tp) = _state(jr, tr)
        np.testing.assert_array_equal(th, jh)
        np.testing.assert_array_equal(tp, jp)
    assert tp.tolist() == [45, 130, 40, 100]


def _spec_packed(rows, width):
    packed = np.zeros((4, trunner.PK_PREFIX + width), np.int32)
    for i, (pos, pages) in rows.items():
        packed[i, trunner.PK_POS] = pos
        packed[i, trunner.PK_SEQLEN] = pos + 1
        packed[i, trunner.PK_TOPP] = np.float32(1.0).view(np.int32)
        packed[i, trunner.PK_CAP] = len(pages) * PAGE
        packed[i, trunner.PK_PREFIX:trunner.PK_PREFIX + len(pages)] = pages
    return packed


def test_spec_window_matches_reference(weights, runners):
    """Three greedy slots over repetitive prompts, prefilled and seeded in
    both runners, then three chained spec windows (m_outer 2, k 3): the
    emitted tokens agree under the near-tie rule, and while they agree the
    outputs, emitted counts, drafts, positions and history are the
    reference's exactly; drafts are proposed and accepted."""
    jparams = weights[0]
    jr, tr = runners
    prompts = {0: repetitive_prompt(44, 5, seed=1),
               1: repetitive_prompt(50, 6, seed=3),
               3: repetitive_prompt(38, 4, seed=4)}
    pages = {i: np.arange(1 + 8 * n, 9 + 8 * n, dtype=np.int32)
             for n, i in enumerate(prompts)}
    emitted = {}
    for r, mod in ((jr, jrunner), (tr, trunner)):
        seqs = [mod.PrefillSeq(tokens=np.asarray(p, np.int32),
                               chunk_pages=pages[i][:-(-len(p) // PAGE)],
                               sampling=(0.0, 0, 1.0), start_pos=0,
                               hist_pages=None)
                for i, p in prompts.items()]
        out = r.prefill_batch(seqs, slots=list(prompts))
        first = out["tokens"] if r is jr else out[0]
        emitted[r] = {i: [int(first[n])] for n, i in enumerate(prompts)}
        r.seed_history([(i, np.asarray(p, np.int32), 0, True, None)
                        for i, p in prompts.items()])
    pos = {i: len(p) for i, p in prompts.items()}
    agree = True
    for _ in range(3):
        packed = _spec_packed({i: (pos[i], pages[i]) for i in prompts}, 8)
        jo = [np.asarray(a) for a in jr.decode_spec_window(packed, 2, 3)]
        to = [a.numpy() for a in tr.decode_spec_window(packed, 2, 3)]
        for r, (outs, emits, _) in ((jr, jo), (tr, to)):
            for i in prompts:
                for m in range(2):
                    emitted[r][i] += outs[m, i, :emits[m, i]].tolist()
        for i in prompts:
            pos[i] += 8
        if agree and all(emitted[jr][i] == emitted[tr][i] for i in prompts):
            live = list(prompts)
            for a, b in zip(jo, to):
                np.testing.assert_array_equal(b[:, live], a[:, live])
            (jh, jp), (th, tp) = _state(jr, tr)
            np.testing.assert_array_equal(th, jh)
            np.testing.assert_array_equal(tp, jp)
        else:
            agree = False
    for i, p in prompts.items():
        assert_greedy_equivalent(jparams, p, emitted[jr][i], emitted[tr][i])
    assert sum(len(e) for e in emitted[tr].values()) > 3 * (1 + 3 * 2)


def test_spec_program_key_and_inert_warmup(weights):
    """One program per ("spec", m_outer, k, bucket_pages) key, reused; the
    engine's warmup makes only it and is inert: the pool outside the
    scratch page 0, tokens_dev, positions_dev and hist_dev (outside its
    sinks) keep their values."""
    engine = port_engine(weights, warmup_windows=True, **SPEC_KW)
    r = engine.runner
    rng = np.random.default_rng(6)
    r.k_cache.copy_(torch.from_numpy(rng.standard_normal(
        r.k_cache.shape).astype(np.float32)))
    r.tokens_dev.copy_(torch.from_numpy(rng.integers(0, V, 4).astype(
        np.int32)))
    r.positions_dev.copy_(torch.from_numpy(rng.integers(0, 200, 5).astype(
        np.int32)))
    r.hist_dev.copy_(torch.from_numpy(rng.integers(0, V, r.hist_dev.shape)
                                      .astype(np.int32)))
    H = r.hist_dev.shape[1] - 1
    before = (r.k_cache[:, :, 1:].clone(), r.tokens_dev.clone(),
              r.positions_dev[:4].clone(), r.hist_dev[:, :H].clone())
    engine._warmup_window_programs()
    bucket = r.bucket_pages_for(1)
    assert list(r._window_cache) == [("spec", engine.spec_m_outer, 3,
                                      bucket)]
    assert engine.spec_m_outer == 2
    after = (r.k_cache[:, :, 1:], r.tokens_dev, r.positions_dev[:4],
             r.hist_dev[:, :H])
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    prog = r._get_spec_window(2, 3, bucket)
    assert prog is r._window_cache[("spec", 2, 3, bucket)]
    r.decode_spec_window(np.zeros((4, trunner.PK_PREFIX + bucket), np.int32),
                         2, 3)
    assert len(r._window_cache) == 1


def test_failed_spec_capture_raises_out_of_engine_start(monkeypatch,
                                                        weights):
    """The card's path, on the CPU: a spec program whose capture fails
    raises out of ``engine.start()``, and no window runs eagerly (or as a
    plain window) in its place."""
    def fail(self):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(trunner.WindowProgram, "capture", fail)
    engine = port_engine(weights, warmup_windows=True, **SPEC_KW)
    engine.runner.use_graphs = True
    with pytest.raises(RuntimeError, match="warmup") as info:
        engine.start()
    assert "capture failed" in str(info.value.__cause__)
    assert not engine._running
    packed = np.zeros((4, trunner.PK_PREFIX + 8), np.int32)
    with pytest.raises(RuntimeError, match="capture failed"):
        engine.runner.decode_spec_window(packed, 2, 3)
    assert engine.runner.window_replays == 0


# ---------------------------------------------------------------------------
# (e)-(m): the engine
# ---------------------------------------------------------------------------

class _Metrics:
    """A metrics publisher that keeps the wire dicts it is given."""

    def __init__(self):
        self.seen = []

    async def publish(self, metrics, force=False):
        self.seen.append(metrics.to_wire())


async def _published(pub, want: dict, timeout=10.0):
    """The last spec_decode_stats ``pub`` saw once it equals ``want``'s
    counts (publishes land asynchronously), or the last one seen."""
    deadline = asyncio.get_running_loop().time() + timeout
    while True:
        last = pub.seen[-1].get("spec_decode_stats") if pub.seen else None
        if last == want or asyncio.get_running_loop().time() > deadline:
            return last
        await asyncio.sleep(0.02)


COUNTERS = ("spec_drafts", "spec_tokens", "spec_accepted")


def _counts(engine) -> dict:
    return {c: getattr(engine, c) for c in COUNTERS} | {
        "spec_emit_hist": list(engine.spec_emit_hist)}


def _delta(after: dict, before: dict) -> dict:
    return {k: ([a - b for a, b in zip(v, before[k])] if isinstance(v, list)
                else v - before[k]) for k, v in after.items()}


@async_test(timeout=300)
async def test_engine_spec_greedy_equals_plain_and_reference_stats(weights):
    """(e) Greedy spec output equals the plain engine's, alone and
    batched, on repetitive and random prompts (near-tie rule). On the
    repetitive prompts, each alone, the spec engine's stats (drafts, draft
    tokens, accepted, emit histogram) equal the TPUEngine's wherever the
    two emitted the same tokens throughout (a chain split at a verified
    near-tie drafts from other histories after it); that is at least one
    prompt. (m) The load metrics carry ``spec_decode_stats`` in the JAX
    worker's wire form: the same keys, each engine's own counts, and the
    port's dict parses as the reference's ``ForwardPassMetrics``."""
    from dynamo_tpu.llm.kv_router.protocols import \
        ForwardPassMetrics as JMetrics
    jparams = weights[0]
    jpub, tpub = _Metrics(), _Metrics()
    jeng = TPUEngine(jcfg.EngineConfig(model=SPEC_J, attention_backend="xla",
                                       **ENGINE_KW, **SPEC_KW),
                     params=jparams, metrics_publisher=jpub)
    plain = port_engine(weights)
    spec = GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                       **ENGINE_KW, **SPEC_KW),
                     params=weights[1], metrics_publisher=tpub)
    try:
        same = 0
        for seed in (3, 11, 12, 13):
            prompt = repetitive_prompt(seed=seed)
            j0, t0 = _counts(jeng), _counts(spec)
            ref = await collect_ref(jeng, prompt, 24)
            got = await collect(spec, prompt, 24)
            assert assert_greedy_equivalent(
                jparams, prompt, await collect(plain, prompt, 24), got) == 24
            if assert_greedy_equivalent(jparams, prompt, ref, got) == 24:
                same += 1
                assert _delta(_counts(spec), t0) == _delta(_counts(jeng), j0)
        assert same >= 1
        assert spec.spec_drafts > 0 and spec.spec_accepted > 0
        for pub, eng in ((tpub, spec), (jpub, jeng)):
            wire = {"num_spec_tokens": eng.spec_tokens,
                    "num_drafts": eng.spec_drafts,
                    "num_accepted_tokens": eng.spec_accepted}
            assert await _published(pub, wire) == wire
        assert set(tpub.seen[-1]) == set(jpub.seen[-1]) >= {
            "worker_stats", "kv_stats", "spec_decode_stats"}
        parsed = JMetrics.from_wire(tpub.seen[-1]).spec_decode_stats
        assert (parsed.num_spec_tokens, parsed.num_drafts,
                parsed.num_accepted_tokens) == (
            spec.spec_tokens, spec.spec_drafts, spec.spec_accepted)
        # Random prompts: drafting mostly finds nothing.
        for seed in (9, 10):
            p = random_prompt(40, seed)
            assert_greedy_equivalent(jparams, p, await collect(plain, p, 16),
                                     await collect(spec, p, 16))
        # Batched against each alone and against the plain engine batched:
        # slots share no drafts, buffers or positions. (The plain engine is
        # no more batch-invariant than this at CPU near-ties.)
        prompts = [repetitive_prompt(seed=s) for s in (21, 22, 23)] + [
            random_prompt(30, 14)]
        alone = [await collect(spec, p, 20) for p in prompts]
        batched = await asyncio.gather(*[collect(spec, p, 20)
                                         for p in prompts])
        want = await asyncio.gather(*[collect(plain, p, 20)
                                      for p in prompts])
        for p, a, b, w in zip(prompts, alone, batched, want):
            assert_greedy_equivalent(jparams, p, a, b)
            assert_greedy_equivalent(jparams, p, w, b)
        assert plain.runner.hist_dev is None
        assert all(k[0] == "spec" for k in spec.runner._window_cache)
    finally:
        jeng.stop()
        plain.stop()
        spec.stop()


@async_test(timeout=300)
async def test_seeded_stream_same_with_spec_on_and_off(weights):
    """(f) A seeded request's tokens are the same with spec on and off,
    alone and beside other requests; another seed gives another stream."""
    plain = port_engine(weights)
    spec = port_engine(weights, **SPEC_KW)
    try:
        prompt = repetitive_prompt(seed=7)
        want = await collect(plain, prompt, 20, temperature=0.8, seed=11)
        assert await collect(spec, prompt, 20, temperature=0.8,
                             seed=11) == want
        mixed = await asyncio.gather(
            collect(spec, prompt, 20, temperature=0.8, seed=11),
            collect(spec, repetitive_prompt(seed=8), 20),
            collect(spec, prompt, 20, temperature=0.9, top_p=0.9))
        assert mixed[0] == want
        assert await collect(spec, prompt, 20, temperature=0.8,
                             seed=12) != want
    finally:
        plain.stop()
        spec.stop()


@pytest.mark.parametrize("seeded", [False, True], ids=["unseeded", "seeded"])
@pytest.mark.parametrize("temp,top_k", [(0.7, 0), (1.0, 4)])
def test_rejection_sampler_matches_target_chi_square(temp, top_k, seeded):
    """(g) The verify window's accept rule samples each position from the
    target and accepts a draft iff the sample reproduces it, so every
    emitted token follows the target. Drive the sampler the spec window
    calls over 4000 flattened [B*S] rows of the same logits, with the spec
    window's noise keys: an unseeded window's (the runner's key plus the
    row-and-column index, at one noise step) or a seeded request's (its
    seed at the landing positions pos + 1 + j): frequencies match the
    (top-k filtered) softmax at p = 1e-3."""
    v, n = 16, 4000
    logits = torch.from_numpy(np.tile(np.random.default_rng(0)
                                      .standard_normal(v).astype(np.float32),
                                      (n, 1)))
    if seeded:
        keys = torch.full((n,), 1234, dtype=torch.int64)
        counters = 300 + torch.arange(n)
    else:
        keys = trunner.UNSEEDED_KEY_STRIDE + torch.arange(n)
        counters = torch.full((n,), 17, dtype=torch.int64)
    noise = tsampler.gumbel_field(keys, counters, v)
    out = tsampler.sample_tokens_per_row(
        logits, torch.full((n,), temp), torch.full((n,), top_k),
        torch.ones(n), noise).numpy()
    scaled = logits[0].double().numpy() / temp
    p = np.exp(scaled - scaled.max())
    if top_k:
        p = np.where(p >= np.sort(p)[::-1][top_k - 1], p, 0.0)
    p /= p.sum()
    counts = np.bincount(out, minlength=v).astype(np.float64)
    assert counts[p == 0].sum() == 0, "token outside the nucleus"
    keep = p > 0
    stat = float(((counts[keep] - n * p[keep]) ** 2 / (n * p[keep])).sum())
    df = int(keep.sum()) - 1
    assert stat < stats.chi2.ppf(0.999, df), (stat, df)


@async_test(timeout=120)
async def test_refuses_logprobs_and_penalties_with_reference_message(
        weights):
    """(h) Logprobs and penalties are refused with the reference's own
    message; temperature, top-k, top-p and seed are served."""
    jeng = TPUEngine(jcfg.EngineConfig(model=SPEC_J, attention_backend="xla",
                                       **ENGINE_KW, **SPEC_KW),
                     params=weights[0])
    spec = port_engine(weights, **SPEC_KW)
    try:
        for sampling in ({"logprobs": 1}, {"frequency_penalty": 0.5},
                         {"presence_penalty": 0.3},
                         {"logprobs": 2, "presence_penalty": 0.3}):
            req = _wire(repetitive_prompt(), 4, **sampling)
            with pytest.raises(ValueError) as ref:
                jeng._validate(JRequest.from_wire(req))
            with pytest.raises(ValueError) as got:
                async for _ in spec.generate(req, TContext()):
                    pass
            assert str(got.value) == str(ref.value)
            assert "does not support" in str(got.value)
        toks = await collect(spec, repetitive_prompt(), 8, temperature=0.7,
                             top_k=20, top_p=0.95, seed=3)
        assert all(0 <= t < V for t in toks)
    finally:
        spec.stop()


@async_test(timeout=300)
async def test_prefix_reuse_then_spec_decode(weights):
    """(i) A second request that hits the first one's prefix pages: the
    history is seeded with the whole prompt, and greedy tokens equal the
    plain engine's."""
    jparams = weights[0]
    plain = port_engine(weights)
    spec = port_engine(weights, **SPEC_KW)
    try:
        shared = repetitive_prompt(n=32, seed=21)
        for tail in ([7, 9], [11, 13]):
            p = shared + tail
            assert_greedy_equivalent(jparams, p, await collect(plain, p, 12),
                                     await collect(spec, p, 12))
        assert spec.prefix_hit_blocks > 0
        assert spec.spec_emit_hist[1] > 0
    finally:
        plain.stop()
        spec.stop()


@async_test(timeout=300)
async def test_chunked_prompt_then_spec_decode(weights):
    """(j) A prompt longer than one prefill program: its chunks run
    between the spec windows of a shorter request, its last chunk seeds
    the history, and both requests' greedy tokens equal the plain
    engine's."""
    jparams = weights[0]
    plain = port_engine(weights)
    spec = port_engine(weights, **SPEC_KW)
    try:
        long = repetitive_prompt(n=150, period=7, seed=31)
        short = repetitive_prompt(seed=32)
        want = await asyncio.gather(collect(plain, short, 24),
                                    collect(plain, long, 16))
        got = await asyncio.gather(collect(spec, short, 24),
                                   collect(spec, long, 16))
        assert spec.chunk_dispatch_count >= 3
        for p, w, g in zip((short, long), want, got):
            assert_greedy_equivalent(jparams, p, w, g)
        assert spec.spec_accepted > 0
    finally:
        plain.stop()
        spec.stop()


@async_test(timeout=300)
async def test_preemption_and_requeue_under_spec(weights):
    """(k) A pool too small for three growing sequences: the spec engine
    preempts, re-prefills from the accumulated tokens (reseeding the
    history), and every request still streams max_tokens tokens, most of
    them the same as with a pool large enough for all."""
    def make(pages):
        return port_engine(weights, num_pages=pages, max_prefill_tokens=256,
                           decode_window=4, **SPEC_KW)

    prompts = [repetitive_prompt(30, 5, seed=s) for s in (41, 42, 43)]
    big, small = make(64), make(10)
    try:
        want = await asyncio.gather(*[collect(big, p, 40) for p in prompts])
        got = await asyncio.gather(*[collect(small, p, 40) for p in prompts])
    finally:
        big.stop()
        small.stop()
    assert small.preempt_count > 0 and big.preempt_count == 0
    # Re-prefilled KV is recomputed by the dense prefill, not the decode
    # path: near-ties may flip late in a chain, not across the board.
    assert sum(w == g for w, g in zip(want, got)) >= 2
    assert small.spec_m_outer == 1 and small.spec_emit_hist[1] > 0


@async_test(timeout=300)
async def test_decode_worker_spec_on_injected_parcel(weights):
    """(l) An engine built as ``backends.gpu --mode decode --spec-decode
    ngram`` builds it, fed a prompt's parcel and first token from a prefill
    worker's engine, gives the aggregated spec engine's greedy tokens."""
    jparams = weights[0]

    def worker(*argv):
        args = gpu.parse_args(["--model", "tiny-test", "--device", "cpu",
                               "--num-pages", "64", *argv])
        config = gpu.build_engine_config(args)
        return config, GPUEngine(config, params=weights[1])

    prompt = repetitive_prompt(n=45, period=6, seed=51)
    _, prefill = worker("--mode", "prefill")
    cfg, decode = worker("--mode", "decode", "--spec-decode", "ngram")
    _, agg = worker("--spec-decode", "ngram", "--spec-k", "3")
    assert (cfg.spec_decode, cfg.spec_k, cfg.warmup_windows) == (
        "ngram", 3, True)
    try:
        req = PreprocessedRequest.from_wire(_wire(prompt, 20))
        first, kv, _ = await prefill.run_job(
            lambda: prefill.prefill_extract(req))
        want = await collect(agg, prompt, 20)
        got = []
        async for out in decode.generate_injected(_wire(prompt, 20),
                                                  TContext(), first, kv):
            got.extend(out.get("token_ids", []))
        assert got[0] == first
        assert decode.injected_admissions == 1
        assert_greedy_equivalent(jparams, prompt, want, got)
        assert decode.spec_drafts > 0
    finally:
        prefill.stop()
        decode.stop()
        agg.stop()

