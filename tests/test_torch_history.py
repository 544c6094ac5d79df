"""History (chunk) prefill: the port's ``model.prefill_with_history`` ==
the JAX package's ``runner._prefill_with_history`` on the same weights,
pool contents and chunk/history tables.

Two rows, each a chunk that attends to its own tokens causally and to
2-3 pages of history already in the pool (random contents from a numpy
seed, the same in both packages), are prefilled by both packages. Held:

- bf16, as served: last-position logits within atol 0.1, rtol 0.05 and the
  written chunk pages within atol 0.05, rtol 0.02 (``test_torch_model.py``
  gives the reasons); the history pages are left as they were.
- fp32: weights and pools in fp32 and the reference's fixed bf16 casts
  read as fp32 (its probabilities included), so only fp32 summation order
  differs: atol 1e-4, rtol 1e-4.
- int8 pools (``QuantKV``): the bf16 tolerance for the logits and the
  dequantized pages within one int8 step. Where the two packages computed
  bit-equal bf16 K/V (layer 0, whose K/V never read the pool, taken from
  the bf16 runs), the port's int8 codes and scales are byte-equal to the
  JAX package's codec (``quantize_np``) on those values. The JAX package's
  own pool can differ from its codec there by one step in a few codes: its
  XLA program may quantize V before rounding it to bf16 (XLA's excess
  precision on the CPU), so that comparison stays within one step.

Within the port, a prompt prefilled in three chunks (two with history)
gives the whole-prompt prefill's logits and pages within the bf16
tolerance, and query blocks (which bound the score transient on the card)
give the unblocked attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine import runner as jrunner
from dynamo_tpu.engine.kv_quant import QuantKV as JQuantKV
from dynamo_tpu.engine.kv_quant import quantize_np
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import model as tmodel
from dynamo_tpu_torch.engine.kv_quant import QuantKV as TQuantKV
from dynamo_tpu_torch.engine.weights import params_from_jax

torch.set_num_threads(1)

TOL = dict(atol=0.1, rtol=0.05)
TOL_FP32 = dict(atol=1e-4, rtol=1e-4)
KV_TOL = dict(atol=0.05, rtol=0.02)
PAGE = 16
NPAGES = 12
TINY_QWEN = dict(name="tiny-qwen", vocab_size=256, hidden_size=256,
                 intermediate_size=512, num_layers=2, num_heads=4,
                 num_kv_heads=2, qkv_bias=True, tie_word_embeddings=True,
                 rope_theta=1000000.0)
# Per row: (history pages, chunk length, chunk pages).
ROWS = [([3, 7], 20, [1, 2]), ([9, 4, 10], 31, [5, 6])]


@pytest.fixture(scope="module", params=["tiny-test", "tiny-qwen"])
def setup(request):
    if request.param == "tiny-test":
        jspec, tspec = jcfg.PRESETS["tiny-test"], tcfg.PRESETS["tiny-test"]
    else:
        jspec, tspec = jcfg.ModelSpec(**TINY_QWEN), tcfg.ModelSpec(**TINY_QWEN)
    jparams = jmodel.init_params(jspec, jax.random.key(42))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tspec,
                              device="cpu")
    return jspec, tspec, jparams, tparams


def _pool(rng, shape, kind):
    """A (JAX, port) pool with the same random contents: bf16, fp32 or
    int8 codes with positive scales."""
    if kind == "int8":
        q = rng.integers(-127, 128, shape).astype(np.int8)
        s = rng.uniform(0.005, 0.03, shape[:-1]).astype(np.float32)
        return (JQuantKV(jnp.asarray(q), jnp.asarray(s)),
                TQuantKV(torch.from_numpy(q.copy()),
                         torch.from_numpy(s.copy())))
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    if kind == "fp32":
        return jnp.asarray(x), torch.from_numpy(x.copy())
    t = torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _inputs(vocab, bucket=32):
    rng = np.random.default_rng(5)
    b = len(ROWS)
    tok = np.zeros((b, bucket), np.int32)
    pos = np.zeros((b, bucket), np.int32)
    table = np.zeros((b, bucket // PAGE), np.int32)
    htable = np.zeros((b, 4), np.int32)
    lens = np.zeros(b, np.int32)
    hlens = np.zeros(b, np.int32)
    for i, (hist, n, chunk) in enumerate(ROWS):
        start = len(hist) * PAGE
        tok[i, :n] = rng.integers(0, vocab, n)
        pos[i] = start + np.minimum(np.arange(bucket), n - 1)
        table[i, :len(chunk)] = chunk
        htable[i, :len(hist)] = hist
        lens[i], hlens[i] = n, start
    return tok, pos, table, lens, htable, hlens


def _run_both(setup, kind):
    jspec, tspec, jparams, tparams = setup
    if kind == "fp32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
        tparams = jax.tree.map(lambda t: t.float(), tparams)
    shape = (jspec.num_layers, jspec.num_kv_heads, NPAGES, PAGE,
             jspec.head_dim)
    rng = np.random.default_rng(17)
    (jk, tk), (jv, tv) = _pool(rng, shape, kind), _pool(rng, shape, kind)
    args = _inputs(jspec.vocab_size)
    fn = jax.jit(lambda p, k, v, *a: jrunner._prefill_with_history(
        p, jspec, k, v, *a, None))
    jl, jk, jv = fn(jparams, jk, jv, *map(jnp.asarray, args))
    tk_before = jax.tree.map(torch.clone, tk)
    tl, tk, tv = tmodel.prefill_with_history(
        tparams, tspec, tk, tv, *map(torch.from_numpy, args))
    return (np.asarray(jl, np.float32), jk, jv), (tl.float().numpy(), tk,
                                                  tv), tk_before


CHUNK_PAGES = [p for _, _, chunk in ROWS for p in chunk]
HIST_PAGES = [p for hist, _, _ in ROWS for p in hist]


def test_history_prefill_matches_reference_bf16(setup):
    (jl, jk, jv), (tl, tk, tv), before = _run_both(setup, "bf16")
    np.testing.assert_allclose(tl, jl, **TOL)
    for jc, tc in ((jk, tk), (jv, tv)):
        np.testing.assert_allclose(tc[:, :, CHUNK_PAGES].float().numpy(),
                                   np.asarray(jc[:, :, CHUNK_PAGES],
                                              np.float32), **KV_TOL)
    assert torch.equal(tk[:, :, HIST_PAGES], before[:, :, HIST_PAGES])


def test_history_prefill_matches_reference_fp32(setup, monkeypatch):
    # The reference model's and its history function's bf16 casts
    # (probabilities, embeddings, projections) read as fp32.
    monkeypatch.setattr(jnp, "bfloat16", jnp.float32)
    (jl, jk, jv), (tl, tk, tv), _ = _run_both(setup, "fp32")
    np.testing.assert_allclose(tl, jl, **TOL_FP32)
    for jc, tc in ((jk, tk), (jv, tv)):
        np.testing.assert_allclose(tc[:, :, CHUNK_PAGES].numpy(),
                                   np.asarray(jc[:, :, CHUNK_PAGES]),
                                   **TOL_FP32)


def test_history_prefill_matches_reference_int8(setup):
    (jl, jk, jv), (tl, tk, tv), before = _run_both(setup, "int8")
    (_, jk16, jv16), (_, tk16, tv16), _ = _run_both(setup, "bf16")
    np.testing.assert_allclose(tl, jl, **TOL)
    exact = 0
    for jc, tc, j16, t16 in ((jk, tk, jk16, tk16), (jv, tv, jv16, tv16)):
        s_t = tc.scale[:, :, CHUNK_PAGES].numpy()
        s_j = np.asarray(jc.scale)[:, :, CHUNK_PAGES]
        q_t = tc.data[:, :, CHUNK_PAGES].numpy()
        q_j = np.asarray(jc.data)[:, :, CHUNK_PAGES]
        np.testing.assert_allclose(s_t, s_j, rtol=0.02)
        deq_t = q_t * s_t[..., None]
        deq_j = q_j * s_j[..., None]
        bound = 0.05 + 0.02 * np.abs(deq_j) + s_j[..., None]
        assert np.all(np.abs(deq_t - deq_j) <= bound)
        # Layer 0: on rows both packages computed bit-equal, the port
        # writes the JAX package's codec bytes.
        vals = np.asarray(j16[0][:, CHUNK_PAGES], np.float32)
        same = np.all(t16[0][:, CHUNK_PAGES].float().numpy() == vals,
                      axis=-1)
        q_np, s_np = quantize_np(vals)
        np.testing.assert_array_equal(q_t[0][same], q_np[same])
        np.testing.assert_array_equal(s_t[0][same].view(np.uint32),
                                      s_np[same].view(np.uint32))
        exact += int(same.sum())
    assert exact > 0
    assert torch.equal(tk.data[:, :, HIST_PAGES],
                       before.data[:, :, HIST_PAGES])


def test_three_chunks_match_whole_prompt(setup):
    """Chunks of 32, 32 and 16 tokens (the last two over history) against
    one whole-prompt prefill of the same 80 tokens, in the port."""
    _, tspec, _, tparams = setup
    rng = np.random.default_rng(9)
    n = 80
    prompt = rng.integers(0, tspec.vocab_size, n).astype(np.int32)
    shape = (tspec.num_layers, tspec.num_kv_heads, 16, PAGE, tspec.head_dim)

    def run(pool, tok, start, pages, hist_pages):
        bucket = 32 * -(-len(tok) // 32)
        t = np.zeros((1, bucket), np.int32)
        t[0, :len(tok)] = tok
        pos = start + np.minimum(np.arange(bucket), len(tok) - 1)[None]
        table = np.zeros((1, bucket // PAGE), np.int32)
        table[0, :len(pages)] = pages
        args = [torch.from_numpy(a) for a in (
            t, pos.astype(np.int32), table,
            np.asarray([len(tok)], np.int32))]
        if hist_pages:
            return tmodel.prefill_with_history(
                tparams, tspec, *pool, *args,
                torch.tensor([hist_pages], dtype=torch.int32),
                torch.tensor([start], dtype=torch.int32))[0]
        return tmodel.prefill_forward(tparams, tspec, *pool, *args)[0]

    whole = [torch.zeros(shape, dtype=torch.bfloat16) for _ in range(2)]
    want = run(whole, prompt, 0, [1, 2, 3, 4, 5], None)
    chunked = [torch.zeros(shape, dtype=torch.bfloat16) for _ in range(2)]
    run(chunked, prompt[:32], 0, [1, 2], None)
    run(chunked, prompt[32:64], 32, [3, 4], [1, 2])
    got = run(chunked, prompt[64:], 64, [5], [1, 2, 3, 4])
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    for a, b in zip(chunked, whole):
        np.testing.assert_allclose(a[:, :, 1:6].float().numpy(),
                                   b[:, :, 1:6].float().numpy(), **KV_TOL)


@pytest.mark.parametrize("with_history", [False, True])
def test_query_blocks_give_the_unblocked_attention(with_history):
    g = torch.Generator().manual_seed(0)
    b, s, nkv, qpk, d, h = 2, 24, 2, 3, 32, 40
    q = torch.randn((b, s, nkv * qpk, d), generator=g)
    k, v = (torch.randn((b, s, nkv, d), generator=g) for _ in range(2))
    pos = torch.arange(s)[None].repeat(b, 1) + 40
    valid = torch.arange(s)[None, :] < torch.tensor([[24], [17]])
    hist = {}
    if with_history:
        hist = dict(k_hist=torch.randn((nkv, b, h, d), generator=g),
                    v_hist=torch.randn((nkv, b, h, d), generator=g),
                    hist_lens=torch.tensor([40, 23]))
    whole = tmodel.causal_attention(q, k, v, pos, valid, qpk, **hist)
    blocked = tmodel.causal_attention(q, k, v, pos, valid, qpk, q_block=5,
                                      **hist)
    np.testing.assert_allclose(blocked.numpy(), whole.numpy(), **TOL_FP32)
