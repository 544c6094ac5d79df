"""Penalties and logprobs: the port's ModelRunner against the JAX package's
on the same weights, pool contents, packed control array and count rows.

``decode_window``: one M-step window over three greedy slots with history
in the pool (random contents from a numpy seed), a frequency/presence-
penalised slot asking for logprobs, an unpenalised slot asking for
logprobs, and a slot whose negative penalties favour tokens it has seen
255 times (so the count bump must saturate). ``prefill_batch``: the same
penalties through ``count_rows``, with and without history rows. Held, on
a bf16 and an int8 pool:

- tokens equal wherever the reference's top-2 margin (its top-8 logprobs
  differ by the logits' margin) is clear: above 2^-4, a bf16 ulp of a
  logit under 16 in magnitude. At a near-tie the chains may legitimately
  split, and a row is compared up to where they do;
- the chosen-token logprob and the top-8 values within the bf16 logit
  tolerance (atol 0.1, rtol 0.05), and the id at each rank equal where
  its value is clearly apart from both neighbours' (ranks 1-7);
- the penalised prefill logits within that tolerance;
- the count state after the window and after the prefill byte-equal to
  the reference's on every row whose tokens were all compared.
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
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import runner as trunner
from dynamo_tpu_torch.engine.kv_quant import QuantKV as TQuantKV
from dynamo_tpu_torch.engine.weights import params_from_jax

torch.set_num_threads(1)

TOL = dict(atol=0.1, rtol=0.05)
CLEAR = 2.0 ** -4
PAGE = 16
KW = dict(page_size=PAGE, num_pages=24, max_pages_per_seq=8, max_num_seqs=4,
          prefill_buckets=(32, 64), max_prefill_tokens=64)
M = 4
SPEC_J = jcfg.PRESETS["tiny-test"]
SPEC_T = tcfg.PRESETS["tiny-test"]
V = SPEC_J.vocab_size


@pytest.fixture(scope="module", params=["bf16", "int8"])
def runners(request):
    quant = request.param == "int8"
    kw = dict(KW, quant_kv="int8" if quant else None)
    jparams = jmodel.init_params(SPEC_J, jax.random.key(3))
    jr = jrunner.ModelRunner(jcfg.EngineConfig(
        model=SPEC_J, attention_backend="xla", **kw), params=jparams)
    tr = trunner.ModelRunner(
        tcfg.EngineConfig(model=SPEC_T, device="cpu", **kw),
        params=params_from_jax(jax.tree.map(np.asarray, jparams), SPEC_T,
                               device="cpu"))
    rng = np.random.default_rng(8)
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


def _f32_bits(x: float) -> int:
    return int(np.float32(x).view(np.int32))


def _count_rows(rng):
    rows = np.zeros((4, V), np.uint8)
    for i in range(3):
        rows[i, rng.choice(V, 25, replace=False)] = rng.integers(1, 4, 25)
    rows[2, rng.choice(V, 6, replace=False)] = 255
    return rows


# (frequency, presence, logprobs) per slot; slot 3 inactive.
SLOTS = [(0.5, 0.7, True), (0.0, 0.0, True), (-0.01, -2.0, False)]


def _compare_step(lp_j, tv_j, ti_j, lp_t, tv_t, ti_t, tok_j, tok_t):
    """One row of one step: True while the chains agree; False where they
    split, which only a near-tie may cause."""
    if tok_t != tok_j:
        assert tv_j[0] - tv_j[1] <= CLEAR, (
            f"port {tok_t} != reference {tok_j} at a clear margin")
        return False
    np.testing.assert_allclose(lp_t, lp_j, **TOL)
    np.testing.assert_allclose(tv_t, tv_j, **TOL)
    # Rank j's id is fixed when it is clearly apart from ranks j - 1 and
    # j + 1 (the last rank's neighbour below is not returned).
    apart = np.concatenate([[True], np.diff(-tv_j) > CLEAR])
    for j in range(len(ti_j) - 1):
        if apart[j] and apart[j + 1]:
            assert ti_t[j] == ti_j[j], (j, ti_t, ti_j)
    return True


def test_penalised_window_and_logprobs_match_reference(runners):
    jr, tr = runners
    rng = np.random.default_rng(4)
    width = 8
    packed = np.zeros((4, trunner.PK_PREFIX + width), np.int32)
    hists = (21, 35, 40)
    for i, ((fp, pp, lp), h) in enumerate(zip(SLOTS, hists)):
        packed[i, trunner.PK_OVERRIDE] = 1
        packed[i, trunner.PK_TOKEN] = rng.integers(0, V)
        packed[i, trunner.PK_POS] = h
        packed[i, trunner.PK_SEQLEN] = h + 1
        packed[i, trunner.PK_TOPP] = _f32_bits(1.0)
        packed[i, trunner.PK_CAP] = width * PAGE
        packed[i, trunner.PK_LOGPROB] = int(lp)
        packed[i, trunner.PK_FREQPEN] = _f32_bits(fp)
        packed[i, trunner.PK_PRESPEN] = _f32_bits(pp)
        packed[i, trunner.PK_PREFIX:] = 1 + 5 * i + np.arange(width) % 5
    rows = _count_rows(rng)
    jr.set_count_rows([0, 1, 2, 3], rows)
    tr.set_count_rows([0, 1, 2, 3], rows)
    toks_j, lps_j, tvs_j, tis_j = (np.asarray(a) for a in
                                   jr.decode_window(packed.copy(), M))
    toks_t, lps_t, tvs_t, tis_t = (a.numpy() for a in
                                   tr.decode_window(packed.copy(), M))
    compared = 0
    for i in range(3):
        whole_row = True
        for m in range(M):
            if not _compare_step(lps_j[m, i], tvs_j[m, i], tis_j[m, i],
                                 lps_t[m, i], tvs_t[m, i], tis_t[m, i],
                                 toks_j[m, i], toks_t[m, i]):
                whole_row = False
                break
            compared += 1
        if whole_row:
            np.testing.assert_array_equal(tr.counts[i].numpy(),
                                          np.asarray(jr.counts_dev)[i])
    assert compared >= 8
    # The negative penalties pick saturated tokens, which stay at 255.
    assert (rows[2, toks_t[:, 2]] == 255).any()
    assert tr.counts[2, torch.from_numpy(toks_t[:, 2]).long()].eq(
        255).any()


def test_window_without_logprobs_or_penalties_skips_both(runners):
    _, tr = runners
    packed = np.zeros((4, trunner.PK_PREFIX + 8), np.int32)
    packed[0, trunner.PK_SEQLEN] = 1
    packed[0, trunner.PK_CAP] = 8 * PAGE
    packed[0, trunner.PK_PREFIX] = 1
    before = tr.counts.clone()
    toks, lps, top_v, top_i = tr.decode_window(packed, M)
    assert toks.shape == (M, 4) and lps is top_v is top_i is None
    assert torch.equal(tr.counts, before)


def test_penalised_prefill_and_logprobs_match_reference(runners):
    jr, tr = runners
    rng = np.random.default_rng(6)
    rows = _count_rows(rng)[:3]
    # Two fresh rows (pages 1-2, 3-4) and one over three pages of history.
    specs = [(0, [1, 2], None, 30), (0, [3, 4], None, 17),
             (48, [9, 10], [5, 6, 7], 20)]
    seqs_j, seqs_t = [], []
    compared = 0
    for (start, pages, hist, n), (fp, pp, lp) in zip(specs, SLOTS):
        tok = rng.integers(0, V, n).astype(np.int32)
        common = dict(tokens=tok, start_pos=start,
                      chunk_pages=np.asarray(pages, np.int32),
                      hist_pages=(None if hist is None
                                  else np.asarray(hist, np.int32)),
                      sampling=(0.0, 0, 1.0), logprobs=lp, penalties=(fp, pp))
        seqs_j.append(jrunner.PrefillSeq(**common))
        seqs_t.append(trunner.PrefillSeq(**common))
    for group in ([0, 1], [2]):
        slots = [i + 1 for i in group]
        out_j = jr.prefill_batch([seqs_j[i] for i in group], slots=slots,
                                 count_rows=rows[group])
        out_t = tr.prefill_batch([seqs_t[i] for i in group], slots=slots,
                                 count_rows=rows[group])
        logits_j = np.asarray(jr.last_prefill_logits, np.float32)
        np.testing.assert_allclose(tr.last_prefill_logits.numpy(),
                                   logits_j[:len(group)], **TOL)
        tok_j = np.asarray(out_j["tokens"])
        tok_t, lp_t, tv_t, ti_t = out_t
        for row, slot in enumerate(slots):
            if tok_t[row] != tok_j[row]:
                top2 = np.sort(logits_j[row])[-2:]
                assert top2[1] - top2[0] <= CLEAR, (row, tok_t, tok_j)
                continue
            if SLOTS[group[row]][2]:
                _compare_step(*(np.asarray(out_j[k])[row]
                                for k in ("lp", "top_v", "top_i")),
                              *(a[row].numpy() for a in (lp_t, tv_t, ti_t)),
                              tok_j[row], tok_t[row])
            np.testing.assert_array_equal(tr.counts[slot].numpy(),
                                          np.asarray(jr.counts_dev)[slot])
            compared += 1
    assert compared >= 2
