"""Port model forwards == the JAX package's, on the same weights.

The JAX ``init_params`` tree goes to the port through ``params_from_jax``;
both packages then prefill the same prompts and run teacher-forced
decode-window steps over their paged pools, twice:

- bf16, as served: logits within atol 0.1, rtol 0.05. Both packages keep
  bf16 activations and round at the same places, but their CPU matmuls sum
  in different orders, so activations can differ by a bf16 ulp (2^-8
  relative) per op; over 2 layers that reaches a few hundredths on logits
  of magnitude ~1-3 (the reference's own paged-vs-dense test allows 0.15).
- fp32: the same weights cast to fp32 on both sides, with the reference
  model's fixed bf16 casts read as fp32 (``_F32Numpy``), so no bf16
  rounding hides a small systematic difference. Only fp32 summation order
  differs (~1e-6 relative per op): logits within atol 1e-4, rtol 1e-4.
- int8 pools (``QuantKV``, ``--quant-kv int8``): the bf16 tolerance. Both
  packages quantize the same way (bit-identical on the same input); a K/V
  value that differs by a bf16 ulp between the packages can move its int8
  code by one step (1/127 of the row's absmax), small beside the bf16
  noise above. The written pools, dequantized, agree within the bf16
  pools' K tolerance (atol 0.05, rtol 0.02) plus one int8 step of the
  row; the scales (absmax / 127) within that rtol. The int8 logits keep
  the reference's own quality gate against bf16 pools: cosine > 0.99
  (tests/test_kv_quant.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.kv_quant import QuantKV as JQuantKV
from dynamo_tpu_torch.engine import attention as port_attn
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import model as tmodel
from dynamo_tpu_torch.engine.kv_quant import QuantKV as TQuantKV
from dynamo_tpu_torch.engine.weights import params_from_jax

torch.set_num_threads(1)

TOL = dict(atol=0.1, rtol=0.05)
TOL_FP32 = dict(atol=1e-4, rtol=1e-4)
PAGE = 16

TINY_QWEN = dict(name="tiny-qwen", vocab_size=256, hidden_size=256,
                 intermediate_size=512, num_layers=2, num_heads=4,
                 num_kv_heads=2, qkv_bias=True, tie_word_embeddings=True,
                 rope_theta=1000000.0)


def test_presets_match_reference():
    assert set(tcfg.PRESETS) == set(jcfg.PRESETS)
    for name, spec in jcfg.PRESETS.items():
        assert dataclasses.asdict(tcfg.PRESETS[name]) == \
            dataclasses.asdict(spec), name
    port_fields = {f.name for f in dataclasses.fields(tcfg.EngineConfig)}
    ref_fields = {f.name for f in dataclasses.fields(jcfg.EngineConfig)}
    assert port_fields - ref_fields == {"device"}
    assert ref_fields <= port_fields


def _specs(kind):
    if kind == "tiny-test":
        return jcfg.PRESETS["tiny-test"], tcfg.PRESETS["tiny-test"]
    return jcfg.ModelSpec(**TINY_QWEN), tcfg.ModelSpec(**TINY_QWEN)


@pytest.fixture(scope="module", params=["tiny-test", "tiny-qwen"])
def setup(request):
    jspec, tspec = _specs(request.param)
    jparams = jmodel.init_params(jspec, jax.random.key(42))
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(np_params, tspec, device="cpu")
    return jspec, tspec, jparams, tparams


class _F32Numpy:
    """``jax.numpy`` with ``bfloat16`` read as ``float32``. Put in place of
    the reference model module's ``jnp``, it turns that module's fixed bf16
    casts (embedding rows, projection outputs, attention probabilities)
    into fp32, so the reference runs end to end in fp32."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def _tree_float(tree):
    return {k: _tree_float(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


@pytest.fixture
def setup_fp32(setup, monkeypatch):
    monkeypatch.setattr(jmodel, "jnp", _F32Numpy())
    jspec, tspec, jparams, tparams = setup
    return (jspec, tspec,
            jax.tree.map(lambda a: a.astype(jnp.float32), jparams),
            _tree_float(tparams))


def test_params_from_jax_is_exact(setup):
    jspec, tspec, jparams, tparams = setup
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat_j:
        t = tparams
        for p in path:
            t = t[p.key]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))


def test_init_params_distribution():
    """Same distribution and scales as the reference init."""
    spec = tcfg.PRESETS["tiny-test"]
    p = tmodel.init_params(spec, torch.Generator().manual_seed(0), "cpu")
    shapes = jmodel.param_shapes(jcfg.PRESETS["tiny-test"])
    assert p["layers"]["input_norm"].eq(1).all()
    assert p["final_norm"].eq(1).all()
    for key in ("wq", "w_gate", "w_down"):
        w = p["layers"][key].float()
        assert tuple(w.shape) == shapes["layers"][key]
        fan_in = w.shape[-2]
        assert abs(w.std().item() * fan_in ** 0.5 - 1.0) < 0.05, key
    assert abs(p["lm_head"].float().std().item() * 128 ** 0.5 - 1) < 0.05


def _pools(shape, fp32=False, quant=False):
    """Zero (JAX, port) K or V pools: bf16, fp32 or int8 QuantKV."""
    if quant:
        return (JQuantKV(jnp.zeros(shape, jnp.int8),
                         jnp.zeros(shape[:-1], jnp.float32)),
                TQuantKV(torch.zeros(shape, dtype=torch.int8),
                         torch.zeros(shape[:-1], dtype=torch.float32)))
    jdt, tdt = ((jnp.float32, torch.float32) if fp32
                else (jnp.bfloat16, torch.bfloat16))
    return jnp.zeros(shape, jdt), torch.zeros(shape, dtype=tdt)


def _prefill_both(setup, prompts, bucket=32, fp32=False, quant=False):
    jspec, tspec, jparams, tparams = setup
    b = len(prompts)
    npages = 2 + b * (bucket // PAGE) + 8
    shape = (jspec.num_layers, jspec.num_kv_heads, npages, PAGE,
             jspec.head_dim)
    tok = np.zeros((b, bucket), np.int32)
    pos = np.zeros((b, bucket), np.int32)
    lens = np.zeros(b, np.int32)
    table = np.zeros((b, bucket // PAGE), np.int32)
    for i, p in enumerate(prompts):
        n = len(p)
        tok[i, :n] = p
        pos[i] = np.minimum(np.arange(bucket), n - 1)
        lens[i] = n
        table[i] = 1 + i * (bucket // PAGE) + np.arange(bucket // PAGE)
    (jk0, kc), (jv0, vc) = (_pools(shape, fp32, quant),
                            _pools(shape, fp32, quant))
    jl, jk, jv = jax.jit(lambda p, k, v, t, ps, pt, sl: jmodel.prefill_forward(
        p, jspec, k, v, t, ps, pt, sl))(
        jparams, jk0, jv0, jnp.asarray(tok), jnp.asarray(pos),
        jnp.asarray(table), jnp.asarray(lens))
    tl, _, _ = tmodel.prefill_forward(
        tparams, tspec, kc, vc, torch.from_numpy(tok), torch.from_numpy(pos),
        torch.from_numpy(table), torch.from_numpy(lens))
    return (np.asarray(jl, np.float32), jk, jv), (tl.numpy(), kc, vc), table


def test_prefill_logits_and_cache_match(setup):
    rng = np.random.default_rng(0)
    vocab = setup[0].vocab_size
    prompts = [rng.integers(0, vocab, size=n).tolist() for n in (18, 31)]
    (jl, jk, _), (tl, kc, _), _ = _prefill_both(setup, prompts)
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(kc.float().numpy(), np.asarray(jk, np.float32),
                               atol=0.05, rtol=0.02)


def test_prefill_logits_match_fp32(setup_fp32):
    rng = np.random.default_rng(0)
    vocab = setup_fp32[0].vocab_size
    prompts = [rng.integers(0, vocab, size=n).tolist() for n in (18, 31)]
    (jl, jk, _), (tl, kc, _), _ = _prefill_both(setup_fp32, prompts,
                                                fp32=True)
    np.testing.assert_allclose(tl, jl, **TOL_FP32)
    np.testing.assert_allclose(kc.numpy(), np.asarray(jk), **TOL_FP32)


def test_prefill_logits_and_cache_match_int8(setup):
    """Prefill into int8 pools: the scatter quantizes in both packages."""
    rng = np.random.default_rng(0)
    vocab = setup[0].vocab_size
    prompts = [rng.integers(0, vocab, size=n).tolist() for n in (18, 31)]
    (jl, jk, _), (tl, kc, _), table = _prefill_both(setup, prompts,
                                                    quant=True)
    np.testing.assert_allclose(tl, jl, **TOL)
    live = table.reshape(-1)
    s_t = kc.scale[:, :, live].numpy()
    s_j = np.asarray(jk.scale)[:, :, live]
    np.testing.assert_allclose(s_t, s_j, rtol=0.02)
    deq_t = kc.data[:, :, live].numpy() * s_t[..., None]
    deq_j = np.asarray(jk.data)[:, :, live] * s_j[..., None]
    bound = 0.05 + 0.02 * np.abs(deq_j) + s_j[..., None]
    assert np.all(np.abs(deq_t - deq_j) <= bound)


def test_teacher_forced_window_logits_match(setup):
    """Three teacher-forced steps of one window: history in the pool,
    earlier window steps in the buffers, the current token as self."""
    _teacher_forced(setup, fp32=False, tol=TOL)


def test_teacher_forced_window_logits_match_int8(setup):
    """The same over int8 pools; the int8 logits stay cosine-close to the
    bf16 pool's (the reference's quality gate)."""
    got = _teacher_forced(setup, fp32=False, tol=TOL, quant=True)
    bf16 = _teacher_forced(setup, fp32=False, tol=TOL)
    for m, (a, b) in enumerate(zip(got, bf16)):
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                 * np.linalg.norm(b, axis=-1))
        assert cos.min() > 0.99, f"step {m}: int8-pool logits diverged ({cos})"


def test_teacher_forced_window_logits_match_fp32(setup_fp32):
    _teacher_forced(setup_fp32, fp32=True, tol=TOL_FP32)


def _teacher_forced(setup, fp32, tol, quant=False):
    """Returns the port's kernel-path logits of each step."""
    jspec, tspec, jparams, tparams = setup
    jdt, tdt = ((jnp.float32, torch.float32) if fp32
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(1)
    vocab = jspec.vocab_size
    prompts = [rng.integers(0, vocab, size=n).tolist() for n in (18, 27)]
    forced = rng.integers(0, vocab, size=(3, 2)).astype(np.int32)
    (_, jk, jv), (_, kc, vc), table = _prefill_both(setup, prompts,
                                                    fp32=fp32, quant=quant)
    b, M = 2, 3
    L, nkv, d = jspec.num_layers, jspec.num_kv_heads, jspec.head_dim
    maxp = 4
    pt = np.zeros((b, maxp), np.int32)
    pt[:, :table.shape[1]] = table
    hist = np.asarray([len(p) for p in prompts], np.int32)
    step_j = jax.jit(lambda p, k, v, kb, vb, m, t, ps, pt_, hl:
                     jmodel.decode_window_step(p, jspec, k, v, kb, vb, m, t,
                                               ps, pt_, hl))
    jkb = jnp.zeros((L, nkv, b, M, d), jdt)
    jvb = jnp.zeros_like(jkb)
    tkb = torch.zeros((L, nkv, b, M, d), dtype=tdt)
    tvb = torch.zeros_like(tkb)
    out = []
    for m in range(M):
        positions = hist + m
        jl, jkn, jvn = step_j(jparams, jk, jv, jkb, jvb,
                              jnp.asarray(m, jnp.int32),
                              jnp.asarray(forced[m]), jnp.asarray(positions),
                              jnp.asarray(pt), jnp.asarray(hist))
        jkb = jkb.at[:, :, :, m].set(jkn.transpose(0, 2, 1, 3))
        jvb = jvb.at[:, :, :, m].set(jvn.transpose(0, 2, 1, 3))
        args = (tparams, tspec, kc, vc, tkb, tvb, m,
                torch.from_numpy(forced[m]), torch.from_numpy(positions),
                torch.from_numpy(pt), torch.from_numpy(hist))
        tl, tkn, tvn = tmodel.decode_window_step(
            *args, attention_impl=port_attn.paged_window_attention)
        tl_plain, _, _ = tmodel.decode_window_step(*args)
        tkb[:, :, :, m] = tkn.transpose(1, 2)
        tvb[:, :, :, m] = tvn.transpose(1, 2)
        ref = np.asarray(jl, np.float32)
        np.testing.assert_allclose(tl.numpy(), ref, **tol,
                                   err_msg=f"kernel path, step {m}")
        np.testing.assert_allclose(tl_plain.numpy(), ref, **tol,
                                   err_msg=f"plain path, step {m}")
        out.append(tl.numpy())
    return out
