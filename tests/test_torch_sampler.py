"""Port sampler == the JAX package's sampling rule.

The port's counter-based noise cannot reproduce JAX's threefry bits, so
the two samplers are held to each other where the rule is deterministic
(greedy; which tokens a filtered draw can pick) and to the softmax target
by chi-square where it is random. Seeded noise is held within the port:
the same seed and position give the same draw, whatever the other rows
hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from dynamo_tpu.engine import sampler as jsampler
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import sampler as tsampler
from dynamo_tpu_torch.engine.runner import ModelRunner

torch.set_num_threads(1)


def _field(b, v, key=0, counter=0):
    """Noise of b rows keyed key, key + 1, ... at one counter."""
    return tsampler.gumbel_field(torch.arange(key, key + b),
                                 torch.full((b,), counter), v)


def _rows(n, v, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, v)) * 2).astype(np.float32)


def test_greedy_equals_jax_greedy():
    logits = _rows(16, 300)
    temp = np.zeros(16, np.float32)
    top_k = np.asarray([0, 5] * 8, np.int32)
    top_p = np.asarray([1.0, 0.9] * 8, np.float32)
    want = np.asarray(jsampler.sample_tokens(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p), jax.random.key(0)))
    args = (torch.from_numpy(logits), torch.from_numpy(temp),
            torch.from_numpy(top_k), torch.from_numpy(top_p))
    got_none = tsampler.sample_tokens_per_row(*args, None)
    got_noise = tsampler.sample_tokens_per_row(*args, _field(16, 300))
    np.testing.assert_array_equal(got_none.numpy(), want)
    np.testing.assert_array_equal(got_noise.numpy(), want)
    assert got_none.dtype == torch.int32


@pytest.mark.parametrize("temp,top_k,top_p", [
    (1.0, 0, 0.9), (0.7, 5, 1.0), (1.0, 10, 0.5), (1.3, 0, 1.0),
    (0.5, 100, 0.95)])
def test_candidate_set_equals_jax_rule(monkeypatch, temp, top_k, top_p):
    """Row j's noise is a spike on token j: the draw is j exactly when j
    is a candidate, else the best candidate. Both samplers get the same
    spikes (the JAX one through a patched gumbel that reads the row index
    from its key), so equal draws mean equal candidate sets, including the
    top-64 prefilter (V = 100)."""
    v = 100
    logits = np.tile(_rows(1, v, seed=3), (v, 1))

    def spike_gumbel(key, shape, dtype=jnp.float32):
        idx = jax.random.key_data(key)[1]
        return jnp.where(jnp.arange(shape[0]) == idx, 1e4, 0.0).astype(dtype)

    monkeypatch.setattr(jax.random, "gumbel", spike_gumbel)
    keys = jax.random.wrap_key_data(
        jnp.stack([jnp.zeros(v, jnp.uint32), jnp.arange(v, dtype=jnp.uint32)],
                  axis=1))
    cols = (np.full(v, temp, np.float32), np.full(v, top_k, np.int32),
            np.full(v, top_p, np.float32))
    want = np.asarray(jsampler.sample_tokens_per_row(
        jnp.asarray(logits), *map(jnp.asarray, cols), keys))
    noise = torch.where(torch.eye(v, dtype=torch.bool), 1e4, 0.0)
    got = tsampler.sample_tokens_per_row(
        torch.from_numpy(logits), *map(torch.from_numpy, cols), noise)
    np.testing.assert_array_equal(got.numpy(), want)
    cand = int((want == np.arange(v)).sum())
    filtered = top_k > 0 or top_p < 1.0
    assert (1 <= cand <= 64) if filtered else cand == v


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
    (0.7, 0, 1.0), (1.0, 4, 1.0), (1.0, 0, 0.8)])
def test_chi_square_against_softmax(temp, top_k, top_p):
    """4000 draws of one row: emitted frequencies match the (filtered,
    renormalised) softmax at p = 1e-3."""
    v, n = 16, 4000
    row = _rows(1, v, seed=5)[0]
    logits = torch.from_numpy(np.tile(row, (n, 1)))
    out = tsampler.sample_tokens_per_row(
        logits, torch.full((n,), temp), torch.full((n,), top_k),
        torch.full((n,), top_p), _field(n, v, key=7)).numpy()
    p = _target(row, temp, top_k, top_p)
    counts = np.bincount(out, minlength=v).astype(np.float64)
    assert counts[p == 0].sum() == 0, "token outside the candidate set"
    keep = p > 0
    stat = float(((counts[keep] - n * p[keep]) ** 2 / (n * p[keep])).sum())
    df = int(keep.sum()) - 1
    assert stat < stats.chi2.ppf(0.999, df), (stat, df)


def test_row_draw_independent_of_other_rows():
    """A row's token depends only on its own logits and noise field."""
    v = 50
    base = _rows(1, v, seed=8)[0]
    noise_row = _field(1, v, key=3)[0]
    outs = []
    for others in range(3):
        b = 2 + others
        logits = torch.from_numpy(_rows(b, v, seed=20 + others))
        logits[1] = torch.from_numpy(base)
        noise = _field(b, v, key=10 * others)
        noise[1] = noise_row
        temp = torch.rand(b, generator=torch.Generator().manual_seed(others))
        temp[1] = 0.9
        top_k = torch.full((b,), others * 3, dtype=torch.int32)
        top_k[1] = 0
        top_p = torch.ones(b)
        top_p[1] = 0.95
        outs.append(int(tsampler.sample_tokens_per_row(
            logits, temp, top_k, top_p, noise)[1]))
    assert len(set(outs)) == 1


def test_seeded_noise_is_a_function_of_seed_and_position():
    """gumbel_field keyed by (seed, position): same (seed, position) ->
    the same field, whatever the batch; a new position -> a new field; and
    the runner's prefill noise draws nothing when no row samples."""
    def field(seeds, positions):
        return tsampler.gumbel_field(torch.tensor(seeds),
                                     torch.tensor(positions), 361)

    one = field([7], [20])
    many = field([3, 7, 7], [20, 20, 21])
    again = field([7], [20])
    later = field([7], [21])
    torch.testing.assert_close(one[0], many[1], rtol=0, atol=0)
    torch.testing.assert_close(one, again, rtol=0, atol=0)
    torch.testing.assert_close(later[0], many[2], rtol=0, atol=0)
    assert not torch.equal(one, later)
    cfg = tcfg.EngineConfig(model=tcfg.PRESETS["tiny-test"], num_pages=8,
                            max_num_seqs=4, device="cpu")
    runner = ModelRunner(cfg)
    assert runner._noise(np.array([False, False]), np.zeros(2),
                         np.zeros(2, bool), np.zeros(2)) is None
