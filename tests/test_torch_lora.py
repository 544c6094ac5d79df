"""Batched multi-tenant LoRA in the port (``engine/lora.py``,
``model.lora_delta``, ``runner.set_adapter_slot``,
``weights.load_lora_weights``) against the JAX package, on the CPU at
tiny-test widths.

Against the reference, on the same inputs made from numpy seeds:
- ``lora_delta`` for 2D and 3D inputs over a mixed slot batch, within
  DELTA_TOL (slot-0 rows exact zeros);
- ``load_lora_weights`` on one PEFT directory: bit-equal stacks (the
  transposes, the alpha/r fold into B, the zero padding) from F32 and BF16
  files, and the same rank-too-big refusal;
- ``AdapterStore``: LRU, pin, refcount, overload and not-found, as
  ``tests/test_lora.py`` holds the reference's;
- a mixed prefill batch (slots 0/1/2) and a logprobs window over it
  against the JAX runner with the same params and adapters, on bf16 and
  int8 pools: logits within TOL, greedy tokens equal where the
  reference's top-2 margin is clear (CLEAR).

Within the port: slot 0 is bit-identical to a runner without adapters; a
mixed batch equals its requests run one by one (greedy and seeded);
chunked prefill with an adapter against the whole prompt (logits within
TOL); spec windows with adapters against plain windows (greedy, split
only at a verified near-tie); salted hash chains (no page shared between
base and adapter or two adapters, reuse within one adapter, KV-event
hashes equal ``TPUEngine``'s); ``set_adapter_slot`` keeps every stack's
address and a program made before a hot-load runs the new weights.

An independent golden: a random-init HF Llama wrapped by ``peft`` with
non-zero B, saved by ``save_pretrained``; the port's logits with that
adapter against the PEFT model's (fp32) within GOLDEN_TOL.
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import safetensors.numpy
import torch
from conftest import async_test
from test_torch_engine import ENGINE_KW, SPEC_J, SPEC_T
from test_torch_kv_events import _drain_loop, _quiesce, _StubKv

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import lora as jlora
from dynamo_tpu.engine import model as jmodel
from dynamo_tpu.engine import runner as jrunner
from dynamo_tpu.engine import weights as jweights
from dynamo_tpu.engine.engine import TPUEngine
from dynamo_tpu.llm.protocols import PreprocessedRequest as JRequest
from dynamo_tpu.runtime import errors as jerrors
from dynamo_tpu.runtime.context import Context as JContext
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import model as tmodel
from dynamo_tpu_torch.engine import runner as trunner
from dynamo_tpu_torch.engine import safetensors_lite as sl
from dynamo_tpu_torch.engine.engine import GPUEngine
from dynamo_tpu_torch.engine.lora import AdapterStore
from dynamo_tpu_torch.engine.weights import (load_hf_weights,
                                             load_lora_weights,
                                             params_from_jax)
from dynamo_tpu_torch.llm.tokens import chain_salt, compute_block_hashes
from dynamo_tpu_torch.runtime import errors as terrors
from dynamo_tpu_torch.runtime.context import Context as TContext
from dynamo_tpu_torch.runtime.errors import (AdapterNotFoundError,
                                             OverloadedError)

torch.set_num_threads(1)

# lora_delta vs the reference: both round u to bf16 and the output to
# bf16; a sum that lands near a bf16 rounding boundary may round one ulp
# apart (2^-8 relative), on deltas of order 1.
DELTA_TOL = dict(atol=2e-2, rtol=2e-2)
# Logits, port vs reference, over two bf16 layers (the repo's model TOL).
TOL = dict(atol=0.1, rtol=0.05)
# A greedy split between the packages is allowed only where the
# reference's top-2 logprob margin is within this.
CLEAR = 2.0 ** -4
PAGE = 16
V = SPEC_T.vocab_size
L = SPEC_T.num_layers
SHAPES = tcfg.EngineConfig(model=SPEC_T).lora_target_shapes()
RUNNER_KW = dict(page_size=PAGE, num_pages=40, max_pages_per_seq=8,
                 max_num_seqs=4, prefill_buckets=(32, 64, 128),
                 max_prefill_tokens=128, decode_window=4)


def rnd_adapter(seed: int, rank: int = 8, max_rank: int = 8,
                scale: float = 0.2, targets=None) -> dict:
    """Host stacks {key: (A [L, d_in, max_rank], B [L, max_rank, d_out])}
    as ml_dtypes bf16 (the reference store's form), rank columns
    non-zero."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, (din, dout) in SHAPES.items():
        if targets is not None and key not in targets:
            continue
        a = np.zeros((L, din, max_rank), np.float32)
        b = np.zeros((L, max_rank, dout), np.float32)
        a[..., :rank] = rng.standard_normal((L, din, rank)) * scale
        b[:, :rank] = rng.standard_normal((L, rank, dout)) * scale
        out[key] = (a.astype(ml_dtypes.bfloat16), b.astype(ml_dtypes.bfloat16))
    return out


def to_torch(host: dict) -> dict:
    return {k: tuple(torch.from_numpy(np.asarray(x).view(np.uint16).copy())
                     .view(torch.bfloat16) for x in pair)
            for k, pair in host.items()}


def full(host: dict, max_rank: int = 8) -> dict:
    """Every target, zeros where ``host`` has none (the store's upload)."""
    out = {}
    for key, (din, dout) in SHAPES.items():
        out[key] = host.get(key, (
            np.zeros((L, din, max_rank), ml_dtypes.bfloat16),
            np.zeros((L, max_rank, dout), ml_dtypes.bfloat16)))
    return out


ADAPTERS = {1: rnd_adapter(1), 2: rnd_adapter(2, rank=4)}


# -- lora_delta ----------------------------------------------------------------

@pytest.mark.parametrize("ndim", [2, 3])
def test_lora_delta_matches_reference(ndim):
    rng = np.random.default_rng(ndim)
    s, h, r, d = 3, 128, 8, 96
    a = (rng.standard_normal((s, h, r)) * 0.2).astype(ml_dtypes.bfloat16)
    b = (rng.standard_normal((s, r, d)) * 0.2).astype(ml_dtypes.bfloat16)
    a[0], b[0] = 0, 0  # slot 0: the base model
    ids = np.array([0, 2, 1, 2, 0], np.int32)
    shape = (5, h) if ndim == 2 else (5, 3, h)
    x = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    ref = np.asarray(jmodel.lora_delta(
        jnp.asarray(x), {"a": jnp.asarray(a), "b": jnp.asarray(b)},
        jnp.asarray(ids)), np.float32)

    def t(arr):
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    got = tmodel.lora_delta(t(x), {"a": t(a), "b": t(b)},
                            torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, ref, **DELTA_TOL)
    assert not got[ids == 0].any()
    assert np.abs(got[ids != 0]).max() > 0.5


# -- load_lora_weights ---------------------------------------------------------

def make_peft_dir(path, rank=4, alpha=12.0, layers=(0, 1),
                  targets=("q_proj", "v_proj", "down_proj"), seed=0,
                  dtype=np.float32):
    """A minimal HF PEFT directory: adapter_config.json and
    adapter_model.safetensors under PEFT's tensor names."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "adapter_config.json").write_text(json.dumps(
        {"r": rank, "lora_alpha": alpha, "target_modules": list(targets)}))
    h, i = SPEC_T.hidden_size, SPEC_T.intermediate_size
    nh, nkv, hd = SPEC_T.num_heads, SPEC_T.num_kv_heads, SPEC_T.head_dim
    dims = {"q_proj": (h, nh * hd), "k_proj": (h, nkv * hd),
            "v_proj": (h, nkv * hd), "o_proj": (nh * hd, h),
            "gate_proj": (h, i), "up_proj": (h, i), "down_proj": (i, h)}
    rng = np.random.default_rng(seed)
    tensors = {}
    for li in layers:
        for mod in targets:
            din, dout = dims[mod]
            block = "mlp" if mod in ("gate_proj", "up_proj",
                                     "down_proj") else "self_attn"
            base = f"base_model.model.model.layers.{li}.{block}.{mod}"
            tensors[f"{base}.lora_A.weight"] = rng.standard_normal(
                (rank, din)).astype(dtype)
            tensors[f"{base}.lora_B.weight"] = rng.standard_normal(
                (dout, rank)).astype(dtype)
    safetensors.numpy.save_file(tensors,
                                str(path / "adapter_model.safetensors"))
    return str(path)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["F32", "BF16"])
def test_load_lora_weights_bit_equal_reference(tmp_path, dtype):
    d = make_peft_dir(tmp_path / "peft", layers=(1,), dtype=dtype)
    ref = jweights.load_lora_weights(SPEC_J, d, max_rank=8)
    got = load_lora_weights(SPEC_T, d, max_rank=8)
    assert sorted(got) == sorted(ref) == ["w_down", "wq", "wv"]
    for key, (ra, rb) in ref.items():
        ga, gb = got[key]
        for r_, g in ((ra, ga), (rb, gb)):
            assert g.dtype == torch.bfloat16 and tuple(g.shape) == r_.shape
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy().view(np.uint16),
                np.asarray(r_).view(np.uint16), key)
        # Layer 0 is not in the checkpoint; the rank pads to 8.
        assert not ga[0].float().any() and not ga[1, :, 4:].float().any()
        # alpha / r = 3 folded into B.
        src = safetensors.numpy.load_file(
            d + "/adapter_model.safetensors")
        mod = {"wq": "self_attn.q_proj", "wv": "self_attn.v_proj",
               "w_down": "mlp.down_proj"}[key]
        b_src = src[f"base_model.model.model.layers.1.{mod}.lora_B.weight"]
        np.testing.assert_array_equal(
            gb[1, :4].float().numpy(),
            (b_src.astype(np.float32).T * np.float32(3.0)).astype(
                ml_dtypes.bfloat16).astype(np.float32))


def test_load_lora_rank_too_big_refused_like_reference(tmp_path):
    d = make_peft_dir(tmp_path / "big", rank=16, seed=1)
    with pytest.raises(ValueError, match="exceeds lora_max_rank") as ref:
        jweights.load_lora_weights(SPEC_J, d, max_rank=8)
    with pytest.raises(ValueError, match="exceeds lora_max_rank") as got:
        load_lora_weights(SPEC_T, d, max_rank=8)
    assert str(got.value) == str(ref.value)


def test_load_lora_weights_reads_port_written_files(tmp_path):
    """The card's own writer (``safetensors_lite.save_file``) makes a PEFT
    directory both loaders read to the same bits."""
    d = tmp_path / "written"
    d.mkdir()
    (d / "adapter_config.json").write_text(json.dumps(
        {"r": 2, "lora_alpha": 5.0}))
    rng = np.random.default_rng(4)
    base = "base_model.model.model.layers.0.mlp.gate_proj"
    tensors = {
        f"{base}.lora_A.weight": torch.from_numpy(rng.standard_normal(
            (2, SPEC_T.hidden_size)).astype(np.float32)).to(torch.bfloat16),
        f"{base}.lora_B.weight": torch.from_numpy(rng.standard_normal(
            (SPEC_T.intermediate_size, 2)).astype(np.float32)).to(
                torch.bfloat16)}
    sl.save_file(tensors, str(d / "adapter_model.safetensors"))
    ref = jweights.load_lora_weights(SPEC_J, str(d), max_rank=4)
    got = load_lora_weights(SPEC_T, str(d), max_rank=4)
    for x, y in zip(got["w_gate"], ref["w_gate"]):
        np.testing.assert_array_equal(
            x.view(torch.int16).numpy().view(np.uint16),
            np.asarray(y).view(np.uint16))


# -- AdapterStore --------------------------------------------------------------

def _store_pair(max_adapters=1, rank=4):
    jr = jrunner.ModelRunner(jcfg.EngineConfig(
        model=SPEC_J, attention_backend="xla", max_adapters=max_adapters,
        lora_max_rank=rank, **RUNNER_KW))
    tr = trunner.ModelRunner(tcfg.EngineConfig(
        model=SPEC_T, device="cpu", max_adapters=max_adapters,
        lora_max_rank=rank, **RUNNER_KW))
    return (jlora.AdapterStore(jr, max_adapters, rank),
            AdapterStore(tr, max_adapters, rank))


def test_register_validates_shapes_like_reference():
    stores = _store_pair()
    bad = {"wq": (np.zeros((L, SPEC_T.hidden_size, 8), ml_dtypes.bfloat16),
                  np.zeros((L, 8, SPEC_T.num_heads * SPEC_T.head_dim),
                           ml_dtypes.bfloat16))}
    for store in stores:
        with pytest.raises(ValueError, match="shapes"):
            store.register("bad", weights=bad)
        with pytest.raises(ValueError, match="not a LoRA target"):
            store.register("bad2", weights={"embed": bad["wq"]})
        with pytest.raises(ValueError, match="non-empty"):
            store.register("", weights=bad)


def _drive(store, errors):
    """The reference test's LRU / pin / refcount sequence; returns what
    each step gave, with errors as their class names."""
    seen = []

    def step(fn, *args):
        try:
            seen.append(fn(*args))
        except (errors.AdapterNotFoundError, errors.OverloadedError) as exc:
            seen.append(type(exc).__name__)

    for i, name in enumerate(("a", "b", "c")):
        store.register(name, weights=rnd_adapter(i, rank=3, max_rank=4))
    step(store.acquire, "nope")
    step(store.acquire, "a")
    step(store.acquire, "b")          # a is held: overloaded, not evicted
    store.release("a")
    step(store.acquire, "b")          # LRU-evicts a
    store.release("b")
    store.pin("b")
    step(store.acquire, "c")          # pinned b is exempt
    store.unpin("b")
    step(store.acquire, "c")
    store.release("c")
    step(store.acquire, "c")          # resident: a hit
    store.release("c")
    step(store.evict, "c")
    step(store.evict, "c")
    step(store.pin, "nope")
    status = store.status()
    return seen, status


def test_store_lru_pin_refcount_match_reference():
    jstore, tstore = _store_pair()
    jseen, jstatus = _drive(jstore, jerrors)
    tseen, tstatus = _drive(tstore, terrors)
    assert tseen == jseen == ["AdapterNotFoundError", 1,
                              "OverloadedError", 1, "OverloadedError", 1,
                              1, True, False, "AdapterNotFoundError"]
    assert tstatus == jstatus
    assert tstatus["loads_total"] == 3 and tstatus["evictions_total"] == 3
    assert tstore.resident == 0
    # The overload carries the reference's retry hint.
    tstore.acquire("a")
    with pytest.raises(OverloadedError) as exc:
        tstore.acquire("b")
    assert exc.value.retry_after_s == 1.0


def test_store_uploads_in_place_and_zero_fills_untargeted():
    """A hot-load writes the slot of every target in place (the addresses
    the window graphs captured stay): an attention-only adapter that
    replaces a full one leaves zeros in the MLP targets."""
    _, store = _store_pair(rank=8)
    runner = store.runner
    ptrs = {(k, n): t.data_ptr() for k, ab in runner.lora.items()
            for n, t in ab.items()}
    store.register("full", weights=to_torch(ADAPTERS[1]))
    store.register("attn", weights=to_torch(rnd_adapter(
        5, targets=("wq", "wk", "wv", "wo"))))
    assert store.acquire("full") == 1
    np.testing.assert_array_equal(
        runner.lora["w_up"]["b"][:, 1].float().numpy(),
        np.asarray(ADAPTERS[1]["w_up"][1], np.float32))
    store.release("full")
    assert store.acquire("attn") == 1
    assert not runner.lora["w_up"]["b"][:, 1].float().any()
    assert runner.lora["wq"]["a"][:, 1].float().any()
    assert not runner.lora["wq"]["a"][:, 0].float().any()
    assert ptrs == {(k, n): t.data_ptr() for k, ab in runner.lora.items()
                    for n, t in ab.items()}


# -- the runner against the reference ------------------------------------------

@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_params(SPEC_J, jax.random.key(21))


def tparams_of(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), SPEC_T,
                           device="cpu")


@pytest.fixture(scope="module", params=["bf16", "int8"])
def runners(request, jparams):
    """A JAX and a port runner on the same weights, each with adapters
    ADAPTERS[1] (rank 8) and ADAPTERS[2] (rank 4) in slots 1 and 2."""
    kw = dict(RUNNER_KW, max_adapters=2, lora_max_rank=8,
              quant_kv="int8" if request.param == "int8" else None)
    jr = jrunner.ModelRunner(jcfg.EngineConfig(
        model=SPEC_J, attention_backend="xla", **kw), params=jparams)
    tr = trunner.ModelRunner(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                               **kw),
                             params=tparams_of(jparams))
    for slot, host in ADAPTERS.items():
        jr.set_adapter_slot(slot, full(host))
        tr.set_adapter_slot(slot, to_torch(full(host)))
    return jr, tr


def _mixed_seqs(prefill_cls, lens=(20, 27, 31), ids=(0, 1, 2)):
    rng = np.random.default_rng(8)
    seqs, first = [], 1
    for n, a in zip(lens, ids):
        pages = -(-n // PAGE)
        seqs.append(prefill_cls(
            tokens=rng.integers(1, V, n).astype(np.int32),
            chunk_pages=np.arange(first, first + pages, dtype=np.int32),
            start_pos=0, hist_pages=None, sampling=(0.0, 0, 1.0),
            adapter_id=a))
        first += 4
    return seqs


def test_mixed_prefill_and_window_match_reference(runners):
    jr, tr = runners
    jseqs = _mixed_seqs(jrunner.PrefillSeq)
    tseqs = _mixed_seqs(trunner.PrefillSeq)
    jr.prefill_batch(jseqs, slots=[0, 1, 2])
    tr.prefill_batch(tseqs, slots=[0, 1, 2])
    ref = np.asarray(jr.last_prefill_logits, np.float32)[:3]
    got = tr.last_prefill_logits.numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    # The adapters move the logits well past the tolerance.
    assert np.abs(ref[1] - ref[0]).max() > 1.0
    # A window over the same rows, every row teacher-forced to the same
    # first token and asking for logprobs.
    rng = np.random.default_rng(12)
    packed = np.zeros((4, trunner.PK_PREFIX + 8), np.int32)
    for i, s in enumerate(tseqs):
        n = len(s.tokens)
        packed[i, trunner.PK_OVERRIDE] = 1
        packed[i, trunner.PK_TOKEN] = rng.integers(1, V)
        packed[i, trunner.PK_POS] = n
        packed[i, trunner.PK_SEQLEN] = n + 1
        packed[i, trunner.PK_TOPP] = np.float32(1.0).view(np.int32)
        packed[i, trunner.PK_CAP] = 4 * PAGE
        packed[i, trunner.PK_LOGPROB] = 1
        packed[i, trunner.PK_ADAPTER] = s.adapter_id
        packed[i, trunner.PK_PREFIX:trunner.PK_PREFIX + 4] = \
            1 + 4 * i + np.arange(4)
    toks_j, lps_j, tvs_j, _ = (np.asarray(a) for a in
                               jr.decode_window(packed, 4))
    toks_t, lps_t, tvs_t, _ = tr.decode_window(packed, 4)
    compared = 0
    for i in range(3):
        for m in range(4):
            if toks_t[m, i] != toks_j[m, i]:
                assert tvs_j[m, i, 0] - tvs_j[m, i, 1] <= CLEAR, (i, m)
                break
            np.testing.assert_allclose(lps_t[m, i].item(), lps_j[m, i],
                                       **TOL)
            np.testing.assert_allclose(tvs_t[m, i].numpy(), tvs_j[m, i],
                                       **TOL)
            compared += 1
    assert compared >= 8, compared


# -- within the port -----------------------------------------------------------

def _tconfig(**kw):
    return tcfg.EngineConfig(model=SPEC_T, device="cpu",
                             **dict(RUNNER_KW, **kw))


@pytest.mark.parametrize("quant_kv", [None, "int8"], ids=["bf16", "int8"])
def test_slot0_bit_identical_to_runner_without_adapters(jparams, quant_kv):
    params = tparams_of(jparams)
    base = trunner.ModelRunner(_tconfig(quant_kv=quant_kv), params=params)
    lr = trunner.ModelRunner(_tconfig(quant_kv=quant_kv, max_adapters=2,
                                      lora_max_rank=8), params=params)
    for slot, host in ADAPTERS.items():
        lr.set_adapter_slot(slot, to_torch(full(host)))
    seqs = _mixed_seqs(trunner.PrefillSeq, ids=(0, 0, 0))
    t0 = base.prefill_batch(seqs, slots=[0, 1, 2])[0]
    t1 = lr.prefill_batch(seqs, slots=[0, 1, 2])[0]
    assert torch.equal(t0, t1)
    assert torch.equal(base.last_prefill_logits, lr.last_prefill_logits)
    packed = np.zeros((4, trunner.PK_PREFIX + 8), np.int32)
    for i, s in enumerate(seqs):
        n = len(s.tokens)
        packed[i, trunner.PK_POS] = n
        packed[i, trunner.PK_SEQLEN] = n + 1
        packed[i, trunner.PK_TOPP] = np.float32(1.0).view(np.int32)
        packed[i, trunner.PK_CAP] = 4 * PAGE
        packed[i, trunner.PK_LOGPROB] = 1
        packed[i, trunner.PK_PREFIX:trunner.PK_PREFIX + 4] = \
            1 + 4 * i + np.arange(4)
    for a, b in zip(base.decode_window(packed, 4),
                    lr.decode_window(packed, 4)):
        assert torch.equal(a, b)
    for pool in ("k_cache", "v_cache"):
        x, y = getattr(base, pool), getattr(lr, pool)
        for u, v in zip(x if quant_kv else [x], y if quant_kv else [y]):
            assert torch.equal(u, v)


def test_window_rows_refuse_slots_the_runner_lacks():
    runner = trunner.ModelRunner(_tconfig(max_adapters=2, lora_max_rank=4))
    packed = np.zeros((4, trunner.PK_PREFIX + 8), np.int32)
    packed[0, trunner.PK_ADAPTER] = 3
    with pytest.raises(ValueError, match=r"outside \[0, 2\]"):
        runner.decode_window(packed, 4)
    plain = trunner.ModelRunner(_tconfig())
    packed[0, trunner.PK_ADAPTER] = 1
    with pytest.raises(ValueError, match=r"outside \[0, 0\]"):
        plain.decode_window(packed, 4)
    with pytest.raises(RuntimeError, match="without max_adapters"):
        plain.set_adapter_slot(1, to_torch(full(ADAPTERS[1])))
    with pytest.raises(ValueError, match="outside"):
        runner.set_adapter_slot(0, to_torch(full(ADAPTERS[1], 4)))


def test_chunked_prefill_with_adapter_matches_whole(jparams):
    """A 100-token prompt on slot 1: one whole prefill against a 64-token
    chunk then a 36-token chunk over its history (the with-history
    program threads the adapter id); last-position logits within TOL,
    and both far from the base model's."""
    params = tparams_of(jparams)
    runner = trunner.ModelRunner(_tconfig(max_adapters=1, lora_max_rank=8),
                                 params=params)
    runner.set_adapter_slot(1, to_torch(full(ADAPTERS[1])))
    prompt = np.random.default_rng(11).integers(1, V, 100).astype(np.int32)
    whole = trunner.PrefillSeq(tokens=prompt, sampling=(0.0, 0, 1.0),
                               chunk_pages=np.arange(1, 8, dtype=np.int32),
                               adapter_id=1)
    runner.prefill_batch([whole])
    ref = runner.last_prefill_logits.clone()
    pages = np.arange(10, 17, dtype=np.int32)
    runner.prefill_chunk_async(trunner.PrefillSeq(
        tokens=prompt[:64], sampling=(0.0, 0, 1.0), chunk_pages=pages[:4],
        adapter_id=1))
    runner.prefill_batch([trunner.PrefillSeq(
        tokens=prompt[64:], sampling=(0.0, 0, 1.0), start_pos=64,
        chunk_pages=pages[4:], hist_pages=pages[:4], adapter_id=1)])
    np.testing.assert_allclose(runner.last_prefill_logits.numpy(),
                               ref.numpy(), **TOL)
    runner.prefill_batch([trunner.PrefillSeq(
        tokens=prompt, sampling=(0.0, 0, 1.0),
        chunk_pages=np.arange(20, 27, dtype=np.int32))])
    assert (runner.last_prefill_logits - ref).abs().max() > 1.0


def test_program_made_before_a_hot_load_runs_the_new_weights(jparams):
    """A window program run on slot 1 holding adapter 1, then adapter 2
    hot-loaded into slot 1 through the store: the same program object
    (``run_eager``, the body a graph replays) gives adapter 2's window,
    the one a runner that held adapter 2 from the start gives."""
    params = tparams_of(jparams)

    def runner_with(weights):
        r = trunner.ModelRunner(_tconfig(max_adapters=1, lora_max_rank=8),
                                params=params)
        store = AdapterStore(r, 1, 8)
        for name, host in weights:
            store.register(name, weights=to_torch(host))
        return r, store

    seqs = _mixed_seqs(trunner.PrefillSeq, lens=(20, 27), ids=(1, 1))
    packed = np.zeros((4, trunner.PK_PREFIX + 8), np.int32)
    for i, s in enumerate(seqs):
        n = len(s.tokens)
        packed[i, trunner.PK_OVERRIDE] = 1
        packed[i, trunner.PK_TOKEN] = 7 + i
        packed[i, trunner.PK_POS] = n
        packed[i, trunner.PK_SEQLEN] = n + 1
        packed[i, trunner.PK_TOPP] = np.float32(1.0).view(np.int32)
        packed[i, trunner.PK_CAP] = 4 * PAGE
        packed[i, trunner.PK_LOGPROB] = 1
        packed[i, trunner.PK_ADAPTER] = 1
        packed[i, trunner.PK_PREFIX:trunner.PK_PREFIX + 4] = \
            1 + 4 * i + np.arange(4)
    runner, store = runner_with([("one", ADAPTERS[1]), ("two", ADAPTERS[2])])
    assert store.acquire("one") == 1
    runner.prefill_batch(seqs)
    prog = runner._get_window(4, 8, False, False, True)
    before = prog.run_eager(packed)
    store.release("one")
    ptrs = [t.data_ptr() for ab in runner.lora.values() for t in ab.values()]
    assert store.acquire("two") == 1
    assert ptrs == [t.data_ptr() for ab in runner.lora.values()
                    for t in ab.values()]
    after = prog.run_eager(packed)
    fresh, fstore = runner_with([("two", ADAPTERS[2])])
    assert fstore.acquire("two") == 1
    # The same pool content: adapter 1's prefill K/V in both runners.
    fresh.k_cache.copy_(runner.k_cache)
    fresh.v_cache.copy_(runner.v_cache)
    want = fresh._get_window(4, 8, False, False, True).run_eager(packed)
    assert not torch.equal(before[1], after[1])
    for a, b in zip(after, want):
        assert torch.equal(a, b)


# -- engines -------------------------------------------------------------------

def _wire(prompt, max_tokens, adapter=None, **sampling):
    return {"model": "tiny-test", "token_ids": list(prompt),
            "stop_conditions": {"max_tokens": max_tokens,
                                "ignore_eos": True},
            "sampling_options": sampling, "adapter": adapter}


async def collect(engine, prompt, max_tokens, adapter=None, **sampling):
    toks, finish = [], None
    async for out in engine.generate(_wire(prompt, max_tokens, adapter,
                                           **sampling), TContext()):
        toks.extend(out.get("token_ids", []))
        finish = out.get("finish_reason") or finish
    assert finish == "length" and len(toks) == max_tokens, (finish, toks)
    return toks


def lora_engine(params, max_adapters=2, adapters=ADAPTERS, **kw):
    eng = GPUEngine(tcfg.EngineConfig(
        model=SPEC_T, device="cpu", max_adapters=max_adapters,
        lora_max_rank=8, **dict(ENGINE_KW, **kw)), params=params)
    eng.register_adapter("tenant-a", weights=to_torch(adapters[1]))
    eng.register_adapter("tenant-b", weights=to_torch(adapters[2]))
    return eng


async def released(engine) -> dict:
    """The adapter store's status once no request holds an adapter: a
    stream ends with its last item, and the engine thread releases the
    request's slot just after it."""
    for _ in range(500):
        status = engine.adapters.status()
        if not status["active_refs"]:
            return status
        await asyncio.sleep(0.01)
    raise AssertionError(f"adapters still held: {status['active_refs']}")


def prompt_of(n=24, seed=5):
    return np.random.default_rng(seed).integers(1, V, n).tolist()


@async_test(timeout=240)
async def test_mixed_batch_equals_requests_one_by_one(jparams):
    params = tparams_of(jparams)
    seq_eng, bat_eng = lora_engine(params), lora_engine(params)
    plain = GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                        **ENGINE_KW), params=params)
    prompt = prompt_of()
    try:
        sa = await collect(seq_eng, prompt, 12, "tenant-a")
        sb = await collect(seq_eng, prompt, 12, "tenant-b")
        s0 = await collect(seq_eng, prompt, 12)
        assert s0 == await collect(plain, prompt, 12)
        assert sa != s0 and sb != s0 and sa != sb
        got = await asyncio.gather(
            collect(bat_eng, prompt, 12, "tenant-a"),
            collect(bat_eng, prompt, 12, "tenant-b"),
            collect(bat_eng, prompt, 12))
        assert got == [sa, sb, s0]
        # Seeded rows: the same stream alone and beside other adapters.
        za = await collect(seq_eng, prompt, 10, "tenant-a", seed=7,
                           temperature=0.8)
        q1, _, q3 = await asyncio.gather(
            collect(bat_eng, prompt, 10, "tenant-a", seed=7,
                    temperature=0.8),
            collect(bat_eng, prompt, 10, "tenant-b"),
            collect(bat_eng, prompt, 10, "tenant-a", seed=7,
                    temperature=0.8))
        assert q1 == za and q3 == za
        status = await released(bat_eng)
        assert status == bat_eng.kv_status()["adapters"]
        assert status["resident"] == {"tenant-a": 1, "tenant-b": 2}
        assert status["requests_total"] == {"tenant-a": 3, "tenant-b": 2}
    finally:
        seq_eng.stop()
        bat_eng.stop()
        plain.stop()


@async_test(timeout=240)
async def test_unknown_adapter_and_every_slot_held(jparams):
    params = tparams_of(jparams)
    eng = lora_engine(params, max_adapters=1)
    plain = GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu",
                                        **ENGINE_KW), params=params)
    prompt = prompt_of()
    try:
        with pytest.raises(AdapterNotFoundError, match="not registered"):
            await collect(eng, prompt, 4, "missing")
        with pytest.raises(AdapterNotFoundError, match="serves no adapters"):
            await collect(plain, prompt, 4, "tenant-a")
        # tenant-a holds the one slot while it decodes: tenant-b cannot
        # hot-load and is answered overloaded, before any page is taken.
        held = asyncio.create_task(collect(eng, prompt, 120, "tenant-a"))
        while not eng.kv_status()["adapters"]["active_refs"]:
            await asyncio.sleep(0.01)
        with pytest.raises(OverloadedError, match="adapter slots"):
            await collect(eng, prompt, 4, "tenant-b")
        await held
        assert await collect(eng, prompt, 4, "tenant-b")
        assert (await released(eng))["evictions_total"] == 1
    finally:
        eng.stop()
        plain.stop()


@async_test(timeout=240)
async def test_spec_windows_with_adapters_match_plain_windows(jparams):
    """Greedy chains of spec windows against plain windows, both through
    each adapter. The adapters are milder than ADAPTERS (scale 0.1), so
    these random weights still loop and the drafter finds drafts to
    verify through the adapter."""
    params = tparams_of(jparams)
    mild = {1: rnd_adapter(7, scale=0.1), 2: rnd_adapter(8, rank=4,
                                                         scale=0.1)}
    plain = lora_engine(params, adapters=mild)
    spec = lora_engine(params, adapters=mild, spec_decode="ngram", spec_k=3)
    base = list(np.random.default_rng(3).integers(1, V, 6))
    prompts = [(base * 8)[:48], prompt_of(30, 9)]
    try:
        for adapter in ("tenant-a", "tenant-b"):
            refs = await asyncio.gather(*(collect(plain, p, 16, adapter)
                                          for p in prompts))
            gots = await asyncio.gather(*(collect(spec, p, 16, adapter)
                                          for p in prompts))
            for p, ref, got in zip(prompts, refs, gots):
                assert_greedy_equivalent(plain.runner, adapter, p, ref, got)
        assert spec.spec_drafts > 0 and spec.spec_accepted > 0
    finally:
        plain.stop()
        spec.stop()


def lora_dense_logits(runner, slot, context):
    """The port's last-position logits of ``context`` through adapter
    ``slot`` of ``runner``, prefilled whole on a private pool."""
    n = len(context)
    bucket = 32 * -(-n // 32)
    spec = runner.spec
    shape = (spec.num_layers, spec.num_kv_heads, bucket // PAGE + 1, PAGE,
             spec.head_dim)
    kc = torch.zeros(shape, dtype=torch.bfloat16)
    vc = torch.zeros_like(kc)
    tok = torch.zeros((1, bucket), dtype=torch.int32)
    tok[0, :n] = torch.tensor(context, dtype=torch.int32)
    pos = torch.clamp(torch.arange(bucket), max=n - 1)[None].to(torch.int32)
    pt = torch.arange(1, bucket // PAGE + 1, dtype=torch.int32)[None]
    return tmodel.prefill_forward(
        runner.params, spec, kc, vc, tok, pos, pt,
        torch.tensor([n], dtype=torch.int32), lora=runner.lora,
        adapter_ids=torch.tensor([slot], dtype=torch.int32))[0][0].numpy()


def assert_greedy_equivalent(runner, adapter, prompt, ref, got):
    """Equal tokens, or a first split at a near-tie of the adapter's
    dense logits: both tokens in the top two within two bf16 ulps."""
    slot = {"tenant-a": 1, "tenant-b": 2}[adapter]
    for i, (a, b) in enumerate(zip(ref, got)):
        if a == b:
            continue
        lg = lora_dense_logits(runner, slot, list(prompt) + list(ref[:i]))
        top2 = {int(t) for t in np.argsort(lg)[::-1][:2]}
        ulp = float(np.spacing(np.float32(max(abs(lg[a]), abs(lg[b]))))) \
            * 2 ** 16
        assert {a, b} <= top2 and abs(float(lg[a] - lg[b])) <= 2 * ulp, (
            f"split at token {i} ({a} vs {b}) is not a near-tie")
        return
    assert len(got) == len(ref)


@async_test(timeout=240)
async def test_salted_chains_keep_adapter_kv_apart(jparams):
    toks = list(range(1, 1 + 3 * PAGE))
    base_h = compute_block_hashes(toks, PAGE)
    a_h = compute_block_hashes(toks, PAGE, salt=chain_salt("tenant-a"))
    b_h = compute_block_hashes(toks, PAGE, salt=chain_salt("tenant-b"))
    assert not (set(base_h) & set(a_h)) and not (set(a_h) & set(b_h))
    eng = lora_engine(tparams_of(jparams))
    prompt = prompt_of(3 * PAGE + 4, seed=13)
    pages = {}

    def tap(r, slot):
        # The pages of the prompt's three complete blocks.
        pages.setdefault(r.req.adapter, []).append(set(r.pages[:3]))
        return inner(r, slot)
    inner = eng._place_in_slot_pending
    eng._place_in_slot_pending = tap
    try:
        first = await collect(eng, prompt, 4, "tenant-a")
        hits = eng.prefix_hit_blocks
        assert await collect(eng, prompt, 4, "tenant-a") == first
        assert eng.prefix_hit_blocks == hits + 3
        await collect(eng, prompt, 4)
        await collect(eng, prompt, 4, "tenant-b")
        assert eng.prefix_hit_blocks == hits + 3
        # The second tenant-a request read the first one's block pages;
        # the base request and tenant-b's hold blocks of their own (the
        # cached ones stay registered, so no fresh allocation takes them).
        a1, a2 = pages["tenant-a"]
        assert a1 == a2
        assert not (pages[None][0] & a1) and not (pages["tenant-b"][0] & a1)
        assert not (pages[None][0] & pages["tenant-b"][0])
    finally:
        eng.stop()


@async_test(timeout=240)
async def test_kv_event_hashes_equal_reference_for_adapter_requests(jparams):
    """The same adapter and base requests through TPUEngine and GPUEngine
    with stub KV publishers: the stored hashes are the same, and each is
    the salted chain of its request's prompt."""
    stubs = {"jax": _StubKv(), "port": _StubKv()}
    kw = dict(ENGINE_KW, max_adapters=2, lora_max_rank=8)
    jeng = TPUEngine(jcfg.EngineConfig(model=SPEC_J, attention_backend="xla",
                                       **kw), params=jparams,
                     kv_publisher=stubs["jax"])
    teng = GPUEngine(tcfg.EngineConfig(model=SPEC_T, device="cpu", **kw),
                     params=tparams_of(jparams), kv_publisher=stubs["port"])
    for name, slot in (("tenant-a", 1), ("tenant-b", 2)):
        jeng.register_adapter(name, weights=ADAPTERS[slot])
        teng.register_adapter(name, weights=to_torch(ADAPTERS[slot]))
    jeng.start()
    teng.start()
    # One token short of whole blocks: max_tokens 1 completes none.
    prompts = [(prompt_of(47, seed=s), a) for s, a in
               ((1, "tenant-a"), (1, None), (1, "tenant-b"),
                (2, "tenant-b"))]
    try:
        for eng in (jeng, teng):
            for p, adapter in prompts:
                if eng is jeng:
                    req = JRequest.from_wire(_wire(p, 1, adapter))
                    async for _ in eng.generate(req, JContext()):
                        pass
                else:
                    await collect(eng, p, 1, adapter)
            await _quiesce(eng)
            eng._publish()
            await _drain_loop()
        assert stubs["port"].stored_hashes == stubs["jax"].stored_hashes
        want = [h for p, a in prompts
                for h in compute_block_hashes(p, PAGE, salt=chain_salt(a))]
        assert sorted(stubs["port"].stored_hashes) == sorted(want)
        assert len(set(want)) == 4 * 2
    finally:
        jeng.stop()
        teng.stop()


# -- an independent golden: PEFT -----------------------------------------------

# Port (bf16 weights and activations) against the PEFT model in fp32: the
# repo's logits tolerance, relative to the logits' scale.
GOLDEN_TOL = dict(atol=0.05, rtol=0.05)


def test_logits_with_adapter_match_peft(tmp_path):
    peft = pytest.importorskip("peft")
    import transformers
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(
        vocab_size=384, hidden_size=128, intermediate_size=352,
        num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
        max_position_embeddings=512, rope_theta=10000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=False, attention_bias=False)
    model = transformers.LlamaForCausalLM(cfg).eval()
    base_dir, adapter_dir = tmp_path / "base", tmp_path / "adapter"
    model.save_pretrained(base_dir, safe_serialization=True)
    lcfg = peft.LoraConfig(
        r=8, lora_alpha=24, init_lora_weights=False,
        target_modules=["q_proj", "k_proj", "v_proj", "o_proj",
                        "gate_proj", "up_proj", "down_proj"])
    pmodel = peft.get_peft_model(model, lcfg).eval()
    pmodel.save_pretrained(adapter_dir)
    spec = tcfg.ModelSpec.from_hf_config(str(base_dir))
    runner = trunner.ModelRunner(
        tcfg.EngineConfig(model=spec, device="cpu", max_adapters=1,
                          lora_max_rank=8, **RUNNER_KW),
        params=load_hf_weights(spec, str(base_dir), "cpu"))
    store = AdapterStore(runner, 1, 8)
    store.register("peft", path=str(adapter_dir))
    assert store.acquire("peft") == 1
    rng = np.random.default_rng(6)
    for n in (5, 17, 40):
        prompt = rng.integers(0, 384, n).tolist()
        with torch.no_grad():
            ref = pmodel(torch.tensor([prompt])).logits[0, -1].float()
            with pmodel.disable_adapter():
                base = pmodel(torch.tensor([prompt])).logits[0, -1].float()
        got = lora_dense_logits(runner, 1, prompt)
        scale = float(ref.abs().max())
        np.testing.assert_allclose(got / scale, ref.numpy() / scale,
                                   **GOLDEN_TOL)
        # The adapter moves the logits by more than the tolerance.
        assert float((ref - base).abs().max()) > 4 * GOLDEN_TOL["atol"] * scale
