"""The port's int8 KV pool (``--quant-kv int8``) against the JAX package's.

- The quantizer is bit-identical to the reference's ``quantize_np`` and
  ``kv_quantize`` on the same inputs, .5 ties and all-zero rows included;
  the dequantizer gives the same bf16 bits.
- The pool writes (``scatter_pages``, ``scatter_tokens``) leave the same
  bytes in the pool, and ``gather_pages_folded`` reads back the same bf16
  values, as the reference functions after the same writes.
- The port's runner writes its int8 pool like the reference runner on the
  same weights: dequantized values within the bf16 pools' K tolerance of
  tests/test_torch_model.py (atol 0.05, rtol 0.02) plus one int8 step,
  scales within that rtol, and the same first tokens where the
  reference's top-2 margin exceeds a bf16 ulp.
- Capacity and accounting: at one free-memory figure the int8 pool holds
  2D/(D+4) times the bf16 pages; ``kv_pool_bytes`` is the pool's real
  bytes; the paged attention byte count charges D+4 bytes per int8 row.
- The knobs: ``--quant-kv int8``, ``DTPU_QUANT_KV`` both ways, and a
  refused mode.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import kv_quant as jq
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine.runner import ModelRunner as JRunner
from dynamo_tpu.engine.runner import PrefillSeq as JSeq
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.engine import attention
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import kv_quant as tq
from dynamo_tpu_torch.engine.runner import ModelRunner as TRunner
from dynamo_tpu_torch.engine.runner import PrefillSeq as TSeq
from dynamo_tpu_torch.engine.weights import params_from_jax

torch.set_num_threads(1)

PAGE = 16


def _tie_rows(d: int) -> np.ndarray:
    """Rows whose x / s land exactly on .5: absmax 127 gives s = 1 and
    absmax 254 gives s = 2, so the values below are exact ties."""
    rows = np.zeros((3, d), np.float32)
    rows[0, :8] = [127, 2.5, -3.5, 0.5, 1.5, -0.5, -2.5, 126.5]
    rows[1, :4] = [254, 5, 7, -1]             # / 2 -> 2.5, 3.5, -0.5
    return rows                               # row 2 stays all zero


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_bit_identical_to_reference(dtype):
    rng = np.random.default_rng(0)
    d = 32
    x = rng.standard_normal((2, 3, 5, PAGE, d)).astype(np.float32) * 3
    x[0, 0, 0, :3] = _tie_rows(d)
    x[1, 2, 4] = 0.0                          # a whole zero page
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
        xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    else:
        xt = torch.from_numpy(x)
    q_np, s_np = jq.quantize_np(x)
    q_j, s_j = jq.kv_quantize(jnp.asarray(x))
    q_t, s_t = tq.kv_quantize(xt)
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), q_np)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy().view(np.uint32),
                                  s_np.view(np.uint32))
    np.testing.assert_array_equal(s_t.numpy().view(np.uint32),
                                  np.asarray(s_j).view(np.uint32))
    # Half to even, as np.rint: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0, 1.5 -> 2.
    assert q_t[0, 0, 0, 0, :8].tolist() == [127, 2, -4, 0, 2, 0, -2, 126]
    assert q_t[0, 0, 0, 1, :4].tolist() == [127, 2, 4, 0]
    assert s_t[0, 0, 0, 0] == 1.0 and s_t[0, 0, 0, 1] == 2.0
    # All-zero rows: codes 0, scale 1.
    assert (q_t[0, 0, 0, 2] == 0).all() and s_t[0, 0, 0, 2] == 1.0
    assert (q_t[1, 2, 4] == 0).all() and (s_t[1, 2, 4] == 1.0).all()


def test_kv_dequantize_bit_identical_to_reference():
    rng = np.random.default_rng(1)
    q = rng.integers(-127, 128, size=(4, PAGE, 64), dtype=np.int8)
    s = (rng.random((4, PAGE)) * 0.1).astype(np.float32)
    got = tq.kv_dequantize(torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == torch.bfloat16
    bits = got.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(
        bits, np.asarray(jq.kv_dequantize(jnp.asarray(q), jnp.asarray(s)))
        .view(np.uint16))
    np.testing.assert_array_equal(
        bits, jq.dequantize_np(q, s).view(np.uint16))


def _bf16_values(rng, shape):
    return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_scatter_and_gather_match_reference(quant):
    """The prefill page scatter, then a decode-window token commit, then a
    history gather at layer 1: same pool bytes, same gathered bf16."""
    rng = np.random.default_rng(2)
    L, nkv, P, d = 2, 2, 10, 32
    shape = (L, nkv, P, PAGE, d)
    if quant:
        jpool = jq.QuantKV(jnp.zeros(shape, jnp.int8),
                           jnp.zeros(shape[:-1], jnp.float32))
        tpool = tq.QuantKV(torch.zeros(shape, dtype=torch.int8),
                           torch.zeros(shape[:-1], dtype=torch.float32))
    else:
        jpool = jnp.zeros(shape, jnp.bfloat16)
        tpool = torch.zeros(shape, dtype=torch.bfloat16)

    def to_t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    blocks = _bf16_values(rng, (L, nkv, 3, PAGE, d))
    pages = np.array([4, 1, 7], np.int32)
    jpool = jq.scatter_pages(jpool, jnp.asarray(blocks), jnp.asarray(pages))
    tq.scatter_pages(tpool, to_t(blocks), torch.from_numpy(pages))
    # A window commit [M=3, B=2]: distinct (page, offset) pairs.
    vals = _bf16_values(rng, (L, nkv, 3, 2, d))
    dest = np.array([[1, 8], [1, 8], [2, 8]], np.int32)
    off = np.array([[5, 0], [6, 1], [0, 2]], np.int32)
    jpool = jq.scatter_tokens(jpool, jnp.asarray(vals), jnp.asarray(dest),
                              jnp.asarray(off))
    tq.scatter_tokens(tpool, to_t(vals), torch.from_numpy(dest),
                      torch.from_numpy(off))
    if quant:
        np.testing.assert_array_equal(tpool.data.numpy(),
                                      np.asarray(jpool.data))
        np.testing.assert_array_equal(tpool.scale.numpy(),
                                      np.asarray(jpool.scale))
    else:
        np.testing.assert_array_equal(tpool.float().numpy(),
                                      np.asarray(jpool, np.float32))
    table = np.array([[4, 1, 2], [7, 8, 0]], np.int32)
    got = tq.gather_pages_folded(tpool, 1, torch.from_numpy(table))
    ref = jq.gather_pages_folded(jpool, 1, jnp.asarray(table))
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))


def test_quant_kv_value_dtype_and_bytes():
    pool = tq.QuantKV(torch.zeros((2, 2, 4, PAGE, 64), dtype=torch.int8),
                      torch.zeros((2, 2, 4, PAGE), dtype=torch.float32))
    assert tq.is_quantized(pool) and not tq.is_quantized(pool.data)
    assert pool.dtype == torch.bfloat16
    assert pool.shape == pool.data.shape
    assert pool.nbytes == pool.data.nbytes + pool.scale.nbytes


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def test_runner_int8_pool_and_first_tokens_match_reference():
    """Both runners prefill the same prompts into int8 pools on the same
    weights: the pools agree (see the module note) and the first tokens
    are the reference's wherever its top-2 margin is clear."""
    jspec = jcfg.PRESETS["tiny-test"]
    tspec = tcfg.PRESETS["tiny-test"]
    jparams = jmodel.init_params(jspec, jax.random.key(7))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tspec,
                              device="cpu")
    kw = dict(page_size=PAGE, num_pages=16, max_pages_per_seq=8,
              max_num_seqs=4, prefill_buckets=(32, 64),
              max_prefill_tokens=128, quant_kv="int8")
    jr = JRunner(jcfg.EngineConfig(model=jspec, attention_backend="xla",
                                   **kw), params=jparams)
    tr = TRunner(tcfg.EngineConfig(model=tspec, device="cpu", **kw),
                 params=tparams)
    rng = np.random.default_rng(3)
    lens, pages = (20, 33, 47), ([1, 2], [3, 4, 5], [6, 7, 8])
    prompts = [rng.integers(0, jspec.vocab_size, n).astype(np.int32)
               for n in lens]
    jt = np.asarray(jr.prefill_batch([
        JSeq(tokens=p, start_pos=0, chunk_pages=np.asarray(pg, np.int32),
             hist_pages=None, sampling=(0.0, 0, 1.0))
        for p, pg in zip(prompts, pages)]))
    tt = tr.prefill_batch([
        TSeq(tokens=p, chunk_pages=np.asarray(pg, np.int32),
             sampling=(0.0, 0, 1.0))
        for p, pg in zip(prompts, pages)])[0].numpy()
    logits = np.asarray(jr.last_prefill_logits, np.float32)
    compared = 0
    for i in range(len(prompts)):
        top2 = np.sort(logits[i])[-2:]
        if top2[1] - top2[0] > _bf16_ulp(top2[1]):
            assert tt[i] == jt[i], (i, tt[i], jt[i])
            compared += 1
    assert compared >= 2
    live = np.concatenate(pages)
    for jpool, tpool in ((jr.k_cache, tr.k_cache), (jr.v_cache, tr.v_cache)):
        assert isinstance(tpool, tq.QuantKV)
        s_t = tpool.scale[:, :, live].numpy()
        s_j = np.asarray(jpool.scale)[:, :, live]
        np.testing.assert_allclose(s_t, s_j, rtol=0.02)
        deq_t = tpool.data[:, :, live].numpy() * s_t[..., None]
        deq_j = np.asarray(jpool.data)[:, :, live] * s_j[..., None]
        bound = 0.05 + 0.02 * np.abs(deq_j) + s_j[..., None]
        assert np.all(np.abs(deq_t - deq_j) <= bound)
    # Pages nobody wrote stay zero.
    assert not tr.k_cache.data[:, :, 9:].any()
    assert not tr.k_cache.scale[:, :, 9:].any()


def _runner_cfg(quant_kv, **kw):
    base = dict(model=tcfg.PRESETS["tiny-test"], device="cpu", num_pages=64,
                page_size=PAGE, max_num_seqs=4, quant_kv=quant_kv)
    base.update(kw)
    return tcfg.EngineConfig(**base)


def test_capacity_pages_scale_2d_over_d_plus_4(monkeypatch):
    """Same free device memory, same model: the int8 pool sizes
    2D/(D+4) times the bf16 pages (1.94x at head_dim 128)."""
    spec = tcfg.PRESETS["llama-3-8b"]
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (40 << 30, 80 << 30))

    def pages(quant_kv):
        cfg = tcfg.EngineConfig(model=spec, quant_kv=quant_kv)
        ns = SimpleNamespace(config=cfg, device=torch.device("cuda"))
        TRunner._sized_pages(ns)
        return ns.num_pages

    ratio = pages("int8") / pages(None)
    expected = 2 * spec.head_dim / (spec.head_dim + tq.KV_SCALE_BYTES)
    assert abs(ratio - expected) < 1e-3, (ratio, expected)
    d, layers, nkv = spec.head_dim, spec.num_layers, spec.num_kv_heads
    assert (tcfg.EngineConfig(model=spec, quant_kv="int8").kv_token_bytes()
            == 2 * layers * nkv * (d + tq.KV_SCALE_BYTES))
    assert (tcfg.EngineConfig(model=spec).kv_token_bytes()
            == spec.kv_bytes_per_token())


def test_kv_pool_bytes_are_data_plus_scales():
    a = TRunner(_runner_cfg(None))
    b = TRunner(_runner_cfg("int8"))
    assert a.kv_pool_bytes == a.k_cache.nbytes + a.v_cache.nbytes
    assert b.kv_pool_bytes == sum(t.nbytes for pool in (b.k_cache, b.v_cache)
                                  for t in (pool.data, pool.scale))
    d = tcfg.PRESETS["tiny-test"].head_dim
    assert b.kv_pool_bytes / a.kv_pool_bytes == (d + 4) / (2 * d)
    assert b.k_cache.data.dtype == torch.int8
    assert b.k_cache.scale.shape == b.k_cache.data.shape[:-1]


def test_attention_bytes_charge_d_plus_4_per_int8_row():
    """Every launch reads each live K and V row once: D int8 values and
    a 4-byte scale, against 2D bytes in bf16; q is bf16 either way."""
    a = TRunner(_runner_cfg(None))
    b = TRunner(_runner_cfg("int8"))
    spec = tcfg.PRESETS["tiny-test"]
    hist = np.array([19, 0, 40, 3])
    nkv, d, nh = spec.num_kv_heads, spec.head_dim, spec.num_heads
    rest = 4 * nh * d * 2 + (2 + 0 + 3 + 1) * 4 + 4 * 4 + 4 * nh * (d + 2) * 4
    assert (attention.hist_flash_bytes(hist, nh, a.k_cache)
            == 2 * 62 * nkv * 2 * d + rest)
    assert (attention.hist_flash_bytes(hist, nh, b.k_cache)
            == 2 * 62 * nkv * (d + 4) + rest)


def test_quant_kv_flag_and_env_override(monkeypatch):
    monkeypatch.delenv("DTPU_QUANT_KV", raising=False)
    args = launch.parse_args(["out=gpu", "--model", "tiny-test",
                              "--quant-kv", "int8"])
    assert args.quant_kv == "int8"
    cfg = launch.build_engine_config(args)
    assert cfg.quant_kv == "int8" and cfg.resolve_quant_kv() == "int8"
    plain = launch.build_engine_config(launch.parse_args(["out=gpu"]))
    assert plain.quant_kv is None and plain.resolve_quant_kv() is None
    with pytest.raises(SystemExit):
        launch.parse_args(["out=gpu", "--quant-kv", "fp4"])
    # DTPU_QUANT_KV wins in both directions.
    monkeypatch.setenv("DTPU_QUANT_KV", "int8")
    assert plain.resolve_quant_kv() == "int8"
    assert isinstance(TRunner(_runner_cfg(None)).k_cache, tq.QuantKV)
    monkeypatch.setenv("DTPU_QUANT_KV", "none")
    assert cfg.resolve_quant_kv() is None
    assert TRunner(_runner_cfg("int8")).k_cache.dtype == torch.bfloat16
    assert not isinstance(TRunner(_runner_cfg("int8")).k_cache, tq.QuantKV)


def test_invalid_quant_kv_rejected():
    with pytest.raises(ValueError, match="quant_kv"):
        TRunner(_runner_cfg("fp4"))


def test_int8_weights_still_refused():
    """int8 weights compose with the int8 pool; a weight quantization
    other than int8 is still refused."""
    import dataclasses

    spec = dataclasses.replace(tcfg.PRESETS["tiny-test"], quant="int8")
    runner = TRunner(_runner_cfg("int8", model=spec))
    assert runner.params["embed"].q.dtype == torch.int8
    assert runner.k_cache.data.dtype == torch.int8
    spec = dataclasses.replace(spec, quant="int4")
    with pytest.raises(ValueError, match="weight quantization 'int4'"):
        TRunner(_runner_cfg("int8", model=spec))
