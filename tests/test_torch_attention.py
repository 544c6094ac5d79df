"""Port paged decode attention == the JAX package's, on the same inputs.

The port's wrappers (``dynamo_tpu_torch.engine.attention``) run their
kernel's plain torch version on CPU tensors; they are held against the
JAX Pallas kernel (run in Pallas interpret mode, as
tests/test_attention_pallas.py runs it) and against the JAX XLA gather
path. The port's plain gather (``dynamo_tpu_torch.engine.model``) is held
against the XLA gather it copies. Cases follow test_attention_pallas.py:
ragged and long ragged lengths with zero history, layer 0/1 of the stacked
cache, MQA, GQA, shuffled page tables, window steps m in {0, 3}.

Tolerances:
- wrapper vs Pallas / XLA: atol = rtol = 0.03, the Pallas-vs-XLA bound of
  test_attention_pallas.py. The port's history path keeps probabilities in
  fp32 where XLA casts them to bf16 before the PV product (relative error
  2^-8 per weight) and both outputs are bf16 (one ulp is 2^-7 at |x| ~ 1).
- plain gather vs XLA gather (same algorithm, bf16 probabilities on both
  sides): atol = rtol = 0.02, one bf16 ulp of the outputs plus summation
  order.

The int8 cases quantize the same bf16 pools with the reference's
``quantize_np`` into ``QuantKV`` pools for both packages and keep the same
tolerances. The wrapper's plain version dequantizes in fp32 as the Pallas
kernel does, so it differs from Pallas only in summation order; the plain
gather dequantizes to bf16 as the XLA gather does (``kv_dequantize``).
Both stay well inside the reference's own Pallas-vs-XLA int8 gate, 0.05
(tests/test_kv_quant.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.attention import (_hist_flash_pallas,
                                         paged_decode_attention_pallas,
                                         paged_window_attention_pallas)
from dynamo_tpu.engine.kv_quant import QuantKV as JQuantKV
from dynamo_tpu.engine.kv_quant import quantize_np
from dynamo_tpu.engine.model import (paged_decode_attention_xla,
                                     paged_window_attention_xla)
from dynamo_tpu_torch.engine import attention as port_attn
from dynamo_tpu_torch.engine import model as port_model
from dynamo_tpu_torch.engine.kv_quant import QuantKV as TQuantKV

torch.set_num_threads(1)

TOL = dict(atol=0.03, rtol=0.03)
PLAIN_TOL = dict(atol=0.02, rtol=0.02)


def _case(d, b, nkv, qpk, maxp, hist, seed=0, page=16, L=2, M=8):
    """bf16-representable float32 inputs shared by both packages."""
    rng = np.random.default_rng(seed)
    nh = nkv * qpk
    npages = maxp * b + 2

    def bf(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)

    pt = np.zeros((b, maxp), np.int32)
    for i in range(b):
        pt[i] = rng.permutation(np.arange(1, npages - 1))[:maxp]
    return dict(q=bf((b, nh, d)), kc=bf((L, nkv, npages, page, d)),
                vc=bf((L, nkv, npages, page, d)), ks=bf((b, nkv, d)),
                vs=bf((b, nkv, d)), kw=bf((nkv, b, M, d)),
                vw=bf((nkv, b, M, d)), pt=pt,
                hl=np.asarray(hist, np.int32), qpk=qpk)


def _quantized(c):
    """The case with its K/V pools as int8 + per-token scales (the
    reference's numpy quantizer)."""
    return dict(c, kc=quantize_np(c["kc"]), vc=quantize_np(c["vc"]))


def _jax(c, name):
    if isinstance(c[name], tuple):
        return JQuantKV(*(jnp.asarray(a) for a in c[name]))
    return jnp.asarray(c[name],
                       jnp.int32 if name in ("pt", "hl") else jnp.bfloat16)


def _torch(c, name):
    if isinstance(c[name], tuple):
        return TQuantKV(*(torch.from_numpy(a) for a in c[name]))
    t = torch.from_numpy(c[name])
    return t if name in ("pt", "hl") else t.to(torch.bfloat16)


def _port_decode(c, layer):
    T = {k: _torch(c, k) for k in ("q", "kc", "vc", "pt", "hl", "ks", "vs")}
    args_t = (T["q"], T["kc"], T["vc"], layer, T["pt"], T["hl"], T["ks"],
              T["vs"], c["qpk"])
    return args_t, port_attn.paged_decode_attention(*args_t).float().numpy()


def _run_decode(c, layer):
    J = {k: _jax(c, k) for k in ("q", "kc", "vc", "pt", "hl", "ks", "vs")}
    ly = jnp.asarray(layer, jnp.int32)
    args_j = (J["q"], J["kc"], J["vc"], ly, J["pt"], J["hl"], J["ks"],
              J["vs"], c["qpk"])
    args_t, port = _port_decode(c, layer)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return {"xla": f32(paged_decode_attention_xla(*args_j)),
            "pallas": (f32(paged_decode_attention_pallas(*args_j))
                       if c["q"].shape[-1] in (64, 128) else None),
            "port": port,
            "port_plain":
                port_model.paged_decode_attention(*args_t).float().numpy()}


def _check(out):
    np.testing.assert_allclose(out["port"], out["xla"], **TOL)
    np.testing.assert_allclose(out["port_plain"], out["xla"], **PLAIN_TOL)
    if out["pallas"] is not None:
        np.testing.assert_allclose(out["port"], out["pallas"], **TOL)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_port_decode_matches_jax(d):
    _check(_run_decode(_case(d, b=4, nkv=2, qpk=4, maxp=8,
                             hist=[5, 17, 64, 128]), layer=1))


@pytest.mark.parametrize("d", [64, 128])
def test_port_decode_matches_jax_long_ragged(d):
    """Zero history, chunk-crossing and non-page-aligned lengths."""
    _check(_run_decode(_case(d, b=4, nkv=2, qpk=2, maxp=32,
                             hist=[0, 129, 300, 511], seed=3), layer=1))


@pytest.mark.parametrize("layer", [0, 1])
def test_port_layer_indexing(layer):
    c = _case(64, b=2, nkv=2, qpk=2, maxp=4, hist=[30, 61], seed=4)
    out = _run_decode(c, layer)
    _check(out)
    _, other = _port_decode(c, 1 - layer)
    assert np.max(np.abs(out["port"] - other)) > 0.01


def test_port_mqa_single_group():
    """One kv head, eight query heads."""
    _check(_run_decode(_case(64, b=2, nkv=1, qpk=8, maxp=8, hist=[33, 90],
                             seed=5), layer=1))


@pytest.mark.parametrize("m", [0, 3])
@pytest.mark.parametrize("d", [32, 64])
def test_port_window_matches_jax(m, d):
    """History + in-window buffer columns j < m + the self column."""
    _check_window(_case(d, b=4, nkv=2, qpk=2, maxp=8, hist=[0, 30, 64, 127],
                        seed=7), m, d)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_port_int8_decode_matches_jax(d):
    """int8 pool: ragged histories, one of them empty, at layer 1."""
    _check(_run_decode(_quantized(_case(d, b=4, nkv=2, qpk=4, maxp=8,
                                        hist=[0, 17, 64, 128], seed=8)),
                       layer=1))


def test_port_int8_decode_matches_jax_long_ragged():
    """int8 pool: chunk-crossing and non-page-aligned lengths, layer 0."""
    _check(_run_decode(_quantized(_case(128, b=3, nkv=2, qpk=2, maxp=32,
                                        hist=[129, 300, 511], seed=9)),
                       layer=0))


def test_port_int8_mqa_single_group():
    _check(_run_decode(_quantized(_case(64, b=2, nkv=1, qpk=8, maxp=8,
                                        hist=[33, 90], seed=10)), layer=1))


@pytest.mark.parametrize("m", [0, 3])
def test_port_int8_window_matches_jax(m):
    _check_window(_quantized(_case(64, b=4, nkv=2, qpk=2, maxp=8,
                                   hist=[0, 30, 64, 127], seed=11)), m, 64)


def _check_window(c, m, d):
    names = ("q", "kc", "vc", "pt", "hl", "kw", "vw", "ks", "vs")
    J = {k: _jax(c, k) for k in names}
    T = {k: _torch(c, k) for k in names}
    args_j = (J["q"], J["kc"], J["vc"], jnp.asarray(1, jnp.int32), J["pt"],
              J["hl"], J["kw"], J["vw"], jnp.asarray(m, jnp.int32), J["ks"],
              J["vs"], 2)
    args_t = (T["q"], T["kc"], T["vc"], 1, T["pt"], T["hl"], T["kw"],
              T["vw"], m, T["ks"], T["vs"], 2)
    ref = np.asarray(paged_window_attention_xla(*args_j), np.float32)
    port = port_attn.paged_window_attention(*args_t).float().numpy()
    plain = port_model.paged_window_attention(*args_t).float().numpy()
    np.testing.assert_allclose(port, ref, **TOL)
    np.testing.assert_allclose(plain, ref, **PLAIN_TOL)
    if d == 64:
        pal = np.asarray(paged_window_attention_pallas(*args_j), np.float32)
        np.testing.assert_allclose(port, pal, **TOL)


# ---------------------------------------------------------------------------
# Split-K: the kernel's split plan, replayed in plain torch.
#
# hist_flash_split_plain cuts each row's clamped history into the splits of
# attention.split_plan, runs the plain history triple over each split's
# pages, and merges the live splits as the kernel's combine step does. It is
# held to the unsplit plain version (both fp32 from the same bf16 or int8
# inputs, only summation order differs: atol = rtol = 1e-5 on the
# normalised output and m) and to the JAX Pallas kernel in interpret mode
# (fp32 on the same inputs: atol = rtol = 1e-4).
# ---------------------------------------------------------------------------

def hist_flash_split_plain(q, k_cache, v_cache, layer, page_table, hist_lens,
                           q_per_kv, pps, splits):
    """Plain split-then-merge flash triple (acc, l, m), as the kernel
    computes it: split s covers pages [s*pps, (s+1)*pps) of each row."""
    b, _, d = q.shape
    nkv, page = k_cache.shape[1], k_cache.shape[3]
    maxp = page_table.shape[1]
    span = pps * page
    hist = torch.clamp(hist_lens.long(), max=maxp * page)
    parts = []
    for s in range(splits):
        h_s = torch.clamp(hist - s * span, 0, span).to(torch.int32)
        parts.append(port_attn.hist_flash_plain(
            q, k_cache, v_cache, layer,
            page_table[:, s * pps:(s + 1) * pps].contiguous(), h_s,
            q_per_kv))
    acc = torch.zeros((b, nkv, q_per_kv, d))
    l = torch.zeros((b, nkv, q_per_kv, 1))
    m = torch.full((b, nkv, q_per_kv, 1), port_attn.NEG_INF)
    for i in range(b):
        live = -(-int(hist[i]) // span)          # splits with history
        if live == 0:
            continue
        ms = torch.stack([parts[s][2][i] for s in range(live)])
        m[i] = ms.max(dim=0).values
        w = torch.exp(ms - m[i])
        l[i] = (torch.stack([parts[s][1][i] for s in range(live)]) * w).sum(0)
        acc[i] = (torch.stack([parts[s][0][i] for s in range(live)])
                  * w).sum(0)
    return acc, l, m


def _split_inputs(c, hist):
    T = {k: _torch(c, k) for k in ("q", "kc", "vc", "pt")}
    return (T["q"], T["kc"], T["vc"], 1, T["pt"],
            torch.tensor(hist, dtype=torch.int32), c["qpk"])


def _normalised(acc, l):
    return acc / torch.clamp(l, min=1e-30)


SPLIT_CASES = {
    # (d, b, nkv, qpk, maxp, page, hist): zero, ragged, histories ending on
    # a split boundary (256 tokens), splits wholly past the history, and one
    # history clamped to its row.
    "ragged_zero_clamped": (64, 4, 2, 4, 32, 16, [0, 64, 133, 700]),
    "boundaries": (128, 3, 1, 8, 48, 16, [512, 256, 17]),
    "page8": (32, 3, 2, 2, 64, 8, [256, 391, 0]),
}


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_merge_matches_unsplit_plain(name, quant):
    d, b, nkv, qpk, maxp, page, hist = SPLIT_CASES[name]
    c = _case(d, b, nkv, qpk, maxp, hist, seed=21, page=page)
    c = _quantized(c) if quant else c
    args = _split_inputs(c, hist)
    pps, splits = port_attn.split_plan(maxp, page)
    assert splits > 1
    acc, l, m = hist_flash_split_plain(*args, pps, splits)
    acc_p, l_p, m_p = port_attn.hist_flash_plain(*args)
    live = torch.tensor(hist) > 0
    torch.testing.assert_close(_normalised(acc, l)[live],
                               _normalised(acc_p, l_p)[live],
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(m, m_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, l_p, atol=1e-5, rtol=1e-5)
    assert torch.all(acc[~live] == 0) and torch.all(l[~live] == 0)
    assert torch.all(m[~live] == port_attn.NEG_INF)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", ["boundaries", "ragged_zero_clamped"])
def test_split_merge_matches_jax_pallas(name, quant):
    """The same split-then-merge triple against _hist_flash_pallas
    (interpret mode on the CPU), given the clamped histories the kernel
    uses (the Pallas kernel itself assumes hist <= maxp * page)."""
    d, b, nkv, qpk, maxp, page, hist = SPLIT_CASES[name]
    c = _case(d, b, nkv, qpk, maxp, hist, seed=22, page=page)
    c = _quantized(c) if quant else c
    args = _split_inputs(c, hist)
    pps, splits = port_attn.split_plan(maxp, page)
    acc, l, m = hist_flash_split_plain(*args, pps, splits)
    clamped = np.minimum(np.asarray(hist, np.int32), maxp * page)
    J = {k: _jax(c, k) for k in ("q", "kc", "vc", "pt")}
    num_j, l_j, m_j = (torch.from_numpy(np.array(x, np.float32))
                       for x in _hist_flash_pallas(
                           J["q"], J["kc"], J["vc"],
                           jnp.asarray(1, jnp.int32), J["pt"],
                           jnp.asarray(clamped), qpk))
    live = torch.tensor(hist) > 0
    torch.testing.assert_close(_normalised(acc, l)[live],
                               _normalised(num_j, l_j)[live],
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(m[live], m_j[live], atol=1e-4, rtol=1e-4)
