"""Weight-only int8 (``--quant int8``): the port's ``engine/quant.py`` and
the model, runner and engine on QTensor weights, against the JAX package.

- The quantizers give the JAX numpy functions' q and s bit for bit, on
  random weights and on the edge cases of ``tests/test_quant.py`` (zero
  rows and channels, near-subnormal and float32-max magnitudes), stacked
  [L, in, out] weights quantized a layer at a time, and the embedding in
  row blocks.
- ``params_from_jax`` carries the JAX quantized tree across unchanged
  (int8 q, float32 s), checked against ``param_shapes``.
- Logits on the same int8 weights: prefill and teacher-forced
  decode-window steps (``test_torch_model``'s helpers) and the runners'
  prefill logits within the bf16 tolerance of ``test_torch_model`` (atol
  0.1, rtol 0.05): both packages dequantize the same int8 codes to bf16
  and scale in fp32, so only their bf16 activations' rounding and
  summation order differ, as for bf16 weights. The int8 logits keep the
  reference's quality gate against the bf16 weights' (cosine > 0.99,
  greedy agreement on 3 of 4 prompts, ``tests/test_quant.py``).
- The engine serves with int8 weights, alone and with an int8 KV pool;
  the runner counts q and s in ``param_bytes``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from conftest import async_test

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine import quant as jq
from dynamo_tpu.engine import runner as jrunner
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import model as tmodel
from dynamo_tpu_torch.engine import quant as tq
from dynamo_tpu_torch.engine import runner as trunner
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.runtime.context import Context
from test_torch_model import TINY_QWEN, TOL, _prefill_both, _teacher_forced

torch.set_num_threads(1)

PAGE = 16
FMAX = np.finfo(np.float32).max


def _bits(a) -> np.ndarray:
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_qt_equal(j, t, what=""):
    np.testing.assert_array_equal(_bits(t.q), _bits(j.q), err_msg=what)
    np.testing.assert_array_equal(_bits(t.s), _bits(j.s), err_msg=what)
    assert t.q.dtype == torch.int8 and t.s.dtype == torch.float32


def _weight_cases():
    rng = np.random.default_rng(0)
    zero = np.zeros((8, 6), np.float32)
    zero[:, :3] = np.linspace(-1, 1, 24).reshape(8, 3)
    zero[0, :] = 0.0
    big = np.zeros((4, 3), np.float32)
    big[0, 0], big[1, 1], big[2, 2] = FMAX, -FMAX, FMAX / 2
    return {
        "random": rng.standard_normal((64, 48)).astype(np.float32),
        "stacked": rng.standard_normal((3, 40, 24)).astype(np.float32),
        "zero_rows_and_columns": zero,
        "near_subnormal": (rng.standard_normal((32, 8)) * 1e-38
                           ).astype(np.float32),
        "subnormal": np.full((4, 2), np.float32(1e-45)),
        "max_magnitude": big,
        "bf16_values": torch.randn(5, 64, 32, generator=torch.Generator()
                                   .manual_seed(1)).to(torch.bfloat16),
    }


@pytest.mark.parametrize("case", list(_weight_cases()))
def test_quantize_weight_bit_equal(case):
    w = _weight_cases()[case]
    tw = w if torch.is_tensor(w) else torch.from_numpy(w)
    jw = w.float().numpy() if torch.is_tensor(w) else w
    _assert_qt_equal(jq.quantize_weight(jw), tq.quantize_weight(tw), case)


def _embedding_cases():
    rng = np.random.default_rng(1)
    edge = np.zeros((6, 4), np.float32)
    edge[1, 0] = FMAX
    edge[2, 1] = np.float32(1e-38)
    rows = rng.standard_normal((tq.EMBED_ROW_BLOCK * 2 + 37, 8)).astype(
        np.float32)
    rows[-1, 3] = 40.0  # the channel's absmax sits in the last row block
    return {"edge_cases": edge, "row_blocks": rows,
            "random": rng.standard_normal((100, 16)).astype(np.float32)}


@pytest.mark.parametrize("case", list(_embedding_cases()))
def test_quantize_embedding_bit_equal(case):
    w = _embedding_cases()[case]
    _assert_qt_equal(jq.quantize_embedding(w),
                     tq.quantize_embedding(torch.from_numpy(w)), case)


def test_safe_scale_guards_like_the_reference():
    amax = np.asarray([[0.0, 1e-45, 1.0, FMAX, np.nextafter(FMAX, 0)]],
                      np.float32)
    got = tq._safe_scale(torch.from_numpy(amax))
    np.testing.assert_array_equal(_bits(got), _bits(jq._safe_scale(amax)))
    assert torch.isfinite(got * 127.0).all()


@pytest.fixture(scope="module", params=["tiny-test", "tiny-qwen"])
def trees(request):
    """(jspec, tspec, JAX bf16 params, JAX int8 params, port int8 params
    carried by params_from_jax, port bf16 params)."""
    if request.param == "tiny-test":
        jspec, tspec = jcfg.PRESETS["tiny-test"], tcfg.PRESETS["tiny-test"]
    else:
        jspec, tspec = jcfg.ModelSpec(**TINY_QWEN), tcfg.ModelSpec(**TINY_QWEN)
    jparams = jax.tree.map(np.asarray, jmodel.init_params(
        jspec, jax.random.key(5)))
    jquant = jq.quantize_params(jparams)
    tquant = params_from_jax(jquant, tspec, device="cpu")
    tbf16 = params_from_jax(jparams, tspec, device="cpu")
    return jspec, tspec, jparams, jquant, tquant, tbf16


def _walk(jtree, ttree, path=""):
    assert set(jtree) == set(ttree), path
    for key, jv in jtree.items():
        if isinstance(jv, dict):
            yield from _walk(jv, ttree[key], f"{path}{key}.")
        else:
            yield f"{path}{key}", jv, ttree[key]


def test_quantize_params_bit_equal(trees):
    """The port's quantize_params over the bf16 tree equals the JAX one's
    on every leaf; norms and biases stay bf16."""
    _, _, jparams, jquant, _, tbf16 = trees
    got = tq.quantize_params(tbf16)
    for name, jv, tv in _walk(jquant, got):
        if isinstance(jv, jq.QTensor):
            assert isinstance(tv, tq.QTensor), name
            _assert_qt_equal(jv, tv, name)
        else:
            assert tv.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(tv.float().numpy(),
                                          jv.astype(np.float32), name)
    assert not isinstance(tbf16["embed"], tq.QTensor)  # input unchanged


def test_params_from_jax_carries_int8_trees(trees):
    jspec, tspec, _, jquant, tquant, _ = trees
    shapes = tmodel.param_shapes(tspec, quantized=True)
    for name, jv, tv in _walk(jquant, tquant):
        if isinstance(jv, jq.QTensor):
            _assert_qt_equal(jv, tv, name)
    assert tuple(tquant["embed"].s.shape) == shapes["embed"].s
    assert tuple(tquant["layers"]["w_down"].q.shape) == \
        shapes["layers"]["w_down"].q
    bad = dict(jquant, layers=dict(jquant["layers"]))
    bad["layers"]["wq"] = jq.QTensor(bad["layers"]["wq"].q[:, :-1],
                                     bad["layers"]["wq"].s)
    with pytest.raises(ValueError, match="wq.q"):
        params_from_jax(bad, tspec, device="cpu")


def _setup(trees):
    jspec, tspec, _, jquant, tquant, _ = trees
    return jspec, tspec, jquant, tquant


def test_int8_prefill_logits_match_reference(trees):
    rng = np.random.default_rng(0)
    vocab = trees[0].vocab_size
    prompts = [rng.integers(0, vocab, size=n).tolist() for n in (18, 31)]
    (jl, _, _), (tl, _, _), _ = _prefill_both(_setup(trees), prompts)
    np.testing.assert_allclose(tl, jl, **TOL)


@pytest.mark.parametrize("quant_kv", [False, True], ids=["bf16-pool",
                                                          "int8-pool"])
def test_int8_window_logits_match_reference(trees, quant_kv):
    """Teacher-forced decode-window steps on int8 weights, both packages,
    kernel and plain attention paths; cosine > 0.99 to the bf16
    weights' logits for the same tokens."""
    jspec, tspec, jparams, jquant, tquant, tbf16 = trees
    got = _teacher_forced(_setup(trees), fp32=False, tol=TOL, quant=quant_kv)
    ref = _teacher_forced((jspec, tspec, jparams, tbf16), fp32=False,
                          tol=TOL, quant=quant_kv)
    for m, (a, b) in enumerate(zip(got, ref)):
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                 * np.linalg.norm(b, axis=-1))
        assert cos.min() > 0.99, f"step {m}: int8 weights diverged ({cos})"


def _runner_config(pkg, spec, quant, quant_kv=None):
    kw = dict(model=dataclasses.replace(spec, quant=quant), page_size=PAGE,
              num_pages=64, max_pages_per_seq=16, max_num_seqs=4,
              prefill_buckets=(32, 64), max_prefill_tokens=64,
              quant_kv=quant_kv)
    if pkg is jcfg:
        return jcfg.EngineConfig(attention_backend="xla", **kw)
    return tcfg.EngineConfig(device="cpu", **kw)


def test_int8_runner_logits_match_reference_and_bf16():
    """Runners on the same JAX init: the port's int8 runner (which
    quantizes the bf16 tree it is given) against the JAX int8 runner
    within TOL, and against the port's bf16 runner by the reference's
    quality gate."""
    jspec, tspec = jcfg.PRESETS["tiny-test"], tcfg.PRESETS["tiny-test"]
    jparams = jmodel.init_params(jspec, jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jparams)
    jr = jrunner.ModelRunner(_runner_config(jcfg, jspec, "int8"),
                             params=jparams)
    t8 = trunner.ModelRunner(_runner_config(tcfg, tspec, "int8"),
                             params=params_from_jax(np_params, tspec, "cpu"))
    t16 = trunner.ModelRunner(_runner_config(tcfg, tspec, None),
                              params=params_from_jax(np_params, tspec, "cpu"))
    assert isinstance(t8.params["layers"]["wq"], tq.QTensor)
    agree = 0
    for seed in range(4):
        prompt = np.random.default_rng(seed).integers(
            0, tspec.vocab_size, size=32).astype(np.int32)
        out = []
        for r, mod in ((jr, jrunner), (t8, trunner), (t16, trunner)):
            res = r.prefill_batch([mod.PrefillSeq(
                tokens=prompt, start_pos=0, hist_pages=None,
                chunk_pages=np.asarray([1, 2], np.int32),
                sampling=(0.0, 0, 1.0))])
            # The port returns (tokens, logprobs...), the reference tokens.
            toks = res[0] if isinstance(res, tuple) else res
            logits = r.last_prefill_logits[0]
            out.append((int(np.asarray(toks)[0]),
                        np.asarray(logits.float() if torch.is_tensor(logits)
                                   else logits, np.float32)))
        (_, lj), (t8_tok, l8), (t16_tok, l16) = out
        np.testing.assert_allclose(l8, lj, **TOL)
        cos = float(np.dot(l8, l16) / (np.linalg.norm(l8)
                                       * np.linalg.norm(l16)))
        assert cos > 0.99, f"seed {seed}: int8 weights diverged ({cos})"
        agree += int(t8_tok == t16_tok)
    assert agree >= 3, f"greedy top-1 agreed only {agree}/4 times"


def test_runner_counts_q_and_s_and_sizes_after_quantizing(monkeypatch):
    """param_bytes is q plus s; on the card the bf16 tree is gone and the
    allocator's cache emptied before the pool reads the free memory."""
    spec = tcfg.PRESETS["tiny-test"]
    r16 = trunner.ModelRunner(_runner_config(tcfg, spec, None))
    r8 = trunner.ModelRunner(_runner_config(tcfg, spec, "int8"))
    q_bytes = sum(v.q.numel() + 4 * v.s.numel()
                  for v in (r8.params["embed"], r8.params["lm_head"],
                            *(r8.params["layers"][k]
                              for k in tq.QUANT_LAYER_KEYS
                              if k in r8.params["layers"])))
    rest = sum(t.numel() * 2 for t in (r8.params["final_norm"],
                                       r8.params["layers"]["input_norm"],
                                       r8.params["layers"]["post_attn_norm"]))
    assert r8.param_bytes == q_bytes + rest
    assert r8.param_bytes < 0.6 * r16.param_bytes
    assert tq.weight_dtype_bytes("int8") == 1.0
    assert tq.weight_dtype_bytes(None) == 2.0
    calls = []
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: calls.append("empty"))
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (calls.append("free"),
                                             (8 << 30, 80 << 30))[1])
    cfg = _runner_config(tcfg, tcfg.PRESETS["llama-3-8b"], "int8")
    ns = type("NS", (), {})()
    ns.config = dataclasses.replace(cfg, num_pages=None)
    ns.device = torch.device("cuda")
    trunner.ModelRunner._sized_pages(ns)
    assert calls == ["empty", "free"]


def test_unsupported_weight_quantization_is_refused():
    spec = dataclasses.replace(tcfg.PRESETS["tiny-test"], quant="int4")
    with pytest.raises(ValueError, match="weight quantization 'int4'"):
        trunner.ModelRunner(_runner_config(tcfg, spec, "int4"))


async def _serve(engine, n_requests=2, max_tokens=6):
    import asyncio
    spec = engine.config.model

    async def one(i):
        prompt = np.random.default_rng(i).integers(
            0, spec.vocab_size, size=20 + 7 * i).tolist()
        toks, finish = [], None
        async for out in engine.generate(
                {"model": "m", "token_ids": prompt,
                 "stop_conditions": {"max_tokens": max_tokens}},
                Context()):
            toks.extend(out.get("token_ids", []))
            finish = out.get("finish_reason") or finish
        return toks, finish

    return await asyncio.gather(*(one(i) for i in range(n_requests)))


@pytest.mark.parametrize("quant_kv", [None, "int8"], ids=["bf16-pool",
                                                           "int8-pool"])
@async_test
async def test_engine_serves_int8_weights(quant_kv):
    cfg = _runner_config(tcfg, tcfg.PRESETS["tiny-test"], "int8", quant_kv)
    engine = GPUEngine(dataclasses.replace(cfg, decode_window=4,
                                           pipeline_depth=2))
    try:
        assert isinstance(engine.runner.params["embed"], tq.QTensor)
        assert (engine.runner.quant_kv == "int8") == (quant_kv == "int8")
        for toks, finish in await _serve(engine):
            assert finish == "length" and len(toks) == 6
    finally:
        engine.stop()
