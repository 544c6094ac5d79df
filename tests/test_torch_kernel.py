"""The paged attention kernel's wrapper, its plain version, and (on a GPU)
the CUDA kernel against that plain version, for bf16 and int8 pools.

This file imports neither jax nor dynamo_tpu, so it also runs on a machine
with the card and no JAX:

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernel.py

The gpu-marked tests skip without a card: a CUDA kernel has no CPU mode.
They include speculative decoding's verify route (the kernel over a
slot's folded verify rows, against its einsum version) and its window
program (a graph replay against the eager body).
Tolerance on the card: kernel and plain version accumulate in fp32 from the
same bf16 inputs. The kernel's score products are exact (bf16 x bf16 in
fp32), and it carries each PV weight as a bf16 high part plus a bf16
remainder (relative error under 2^-16); the rest is summation order and exp
rounding, so the normalised history output agrees to 1e-3 and the bf16
wrapper outputs to two bf16 ulps (1.6e-2 relative). The int8 kernel and its plain version
both dequantize in fp32 (the kernel folds each token's scale into its
score and PV weight, the plain version multiplies it into every value),
so the same tolerances hold.
"""

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine import attention
from dynamo_tpu_torch.engine.kv_quant import QuantKV, kv_quantize

torch.set_num_threads(1)


def _case(d, b, nkv, qpk, hist, seed=0, page=16, L=2, M=8, extra=3,
          device="cpu"):
    rng = np.random.default_rng(seed)
    maxp = max(-(-h // page) for h in hist) + extra
    npages = b * maxp + 2

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16).to(device)

    pt = rng.permutation(np.arange(1, npages))[:b * maxp].reshape(b, maxp)
    return dict(q=bf(b, nkv * qpk, d), kc=bf(L, nkv, npages, page, d),
                vc=bf(L, nkv, npages, page, d),
                pt=torch.from_numpy(pt.astype(np.int32)).to(device),
                hl=torch.tensor(hist, dtype=torch.int32, device=device),
                ks=bf(b, nkv, d), vs=bf(b, nkv, d), kw=bf(nkv, b, M, d),
                vw=bf(nkv, b, M, d), qpk=qpk)


def _hist_args(c, layer=1):
    return (c["q"], c["kc"], c["vc"], layer, c["pt"], c["hl"], c["qpk"])


def _int8(c):
    """The case with its K/V pools quantized to int8 + per-token scales."""
    return dict(c, kc=QuantKV(*kv_quantize(c["kc"])),
                vc=QuantKV(*kv_quantize(c["vc"])))


def _counts():
    return attention.KERNEL.launches, attention.KERNEL.launches_int8


def _to_cpu(v):
    if isinstance(v, QuantKV):
        return QuantKV(v.data.cpu(), v.scale.cpu())
    return v.cpu() if torch.is_tensor(v) else v


def test_plain_int8_history_dequantizes_in_fp32():
    """The int8 plain version is the plain version over the pool
    dequantized in fp32 (not rounded to bf16), as the TPU kernel reads it;
    page-table tails and empty histories behave as for bf16."""
    c = _int8(_case(64, b=3, nkv=2, qpk=4, hist=[0, 20, 70], seed=3))
    got = attention.hist_flash_plain(*_hist_args(c))
    fp32 = dict(c, kc=c["kc"].data.float() * c["kc"].scale[..., None],
                vc=c["vc"].data.float() * c["vc"].scale[..., None])
    torch.testing.assert_close(got, attention.hist_flash_plain(
        *_hist_args(fp32)), rtol=0, atol=0)
    pt2 = c["pt"].clone()
    pt2[0] = 0
    pt2[1, 2:] = 0
    torch.testing.assert_close(got, attention.hist_flash_plain(
        *_hist_args(dict(c, pt=pt2))), rtol=0, atol=0)
    assert torch.all(got[2][0] == attention.NEG_INF)


def test_plain_history_triple_ignores_page_table_tail():
    """Entries past ceil(hist/page) may be page 0 or stale: the history
    triple must not change when they do. An empty history gives the
    harmless triple (m = -1e30, l = 0, acc = 0)."""
    c = _case(32, b=3, nkv=2, qpk=2, hist=[0, 20, 33], seed=9)
    a1, l1, m1 = attention.hist_flash_plain(*_hist_args(c))
    pt2 = c["pt"].clone()
    pt2[0] = 0
    pt2[1, 2:] = 0
    pt2[2, 3:] = pt2[2, 3:].flip(0)
    c2 = dict(c, pt=pt2)
    a2, l2, m2 = attention.hist_flash_plain(*_hist_args(c2))
    torch.testing.assert_close((a1, l1, m1), (a2, l2, m2), rtol=0, atol=0)
    assert torch.all(m1[0] == attention.NEG_INF)
    assert torch.all(l1[0] == 0) and torch.all(a1[0] == 0)


def _over_long(c, page=16, over=40):
    """The case with its last row's history past its page-table row."""
    cap = c["pt"].shape[1] * page
    hl = c["hl"].clone()
    hl[-1] = cap + over
    return dict(c, hl=hl), cap


def test_plain_history_clamps_to_page_table_row():
    """A history longer than the page table's row counts only the row's
    maxp * page tokens, as the kernel clamps it."""
    c = _case(32, b=2, nkv=2, qpk=2, hist=[20, 33], seed=5, extra=0)
    over, cap = _over_long(c)
    at_cap = dict(c, hl=torch.tensor([20, cap], dtype=torch.int32))
    torch.testing.assert_close(attention.hist_flash_plain(*_hist_args(over)),
                               attention.hist_flash_plain(*_hist_args(at_cap)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("page", [8, 16, 32, 64, 256, 512])
@pytest.mark.parametrize("maxp", [1, 7, 8, 128, 512])
def test_split_plan_covers_every_page_once(maxp, page):
    """S >= 1 splits of pps pages cover the page-table row exactly once,
    each split holds SPLIT_TOKENS tokens (or one page, where a page is
    larger), and only shapes go in: plain ints, no tensor, so no device
    read."""
    pps, splits = attention.split_plan(maxp, page)
    assert type(pps) is int and type(splits) is int
    assert pps >= 1 and splits >= 1
    covered = [p for s in range(splits)
               for p in range(s * pps, min((s + 1) * pps, maxp))]
    assert covered == list(range(maxp))
    assert (splits - 1) * pps < maxp  # no split lies past the row
    assert pps * page == max(attention.SPLIT_TOKENS, page)


def test_split_plan_on_the_main_path_shape():
    """A 128-page bucket of 16-token pages: 256-token splits, 8 of them,
    whatever the histories (which the plan never sees)."""
    assert attention.split_plan(128, 16) == (16, 8)


def test_kernel_wrapper_raises_instead_of_falling_back():
    c = _case(32, b=2, nkv=2, qpk=2, hist=[3, 9])
    before = attention.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        attention.KERNEL(*_hist_args(c))
    assert attention.KERNEL.launches == before


def test_int8_kernel_wrapper_raises_instead_of_falling_back():
    c = _int8(_case(32, b=2, nkv=2, qpk=2, hist=[3, 9]))
    before = _counts()
    with pytest.raises(ValueError, match="CUDA"):
        attention.KERNEL(*_hist_args(c))
    with pytest.raises(ValueError, match="both"):
        attention.KERNEL(*_hist_args(dict(c, vc=c["vc"].data)))
    assert _counts() == before


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("d,nkv,qpk,hist,layer,m", [
    (32, 2, 2, [0, 5, 17, 140], 1, 0),
    (64, 2, 4, [300, 0, 131], 1, 3),
    (64, 2, 7, [64, 65], 0, 3),
    (128, 8, 4, [0, 33, 1000, 2049], 1, 0),
    (128, 1, 8, [129, 700], 1, 3),
    # Split-K: several splits, histories ending on split boundaries (256
    # tokens) and splits wholly past a history.
    (128, 8, 4, [256, 512, 0, 1024], 1, 3),
    # A 16,384-token row beside empty rows.
    (128, 8, 4, [16384, 0, 0], 1, 0),
    # B=1, at each head dim.
    (32, 4, 1, [777], 0, 3),
    (64, 2, 4, [1], 1, 0),
    (128, 8, 4, [4097], 1, 3),
    # qpk in {1, 4, 7, 8} at D in {32, 64, 128}.
    (32, 2, 8, [90, 0, 301], 1, 3),
    (32, 2, 7, [64, 200], 0, 0),
    (64, 1, 1, [33, 1500], 1, 3),
    (64, 2, 8, [300, 257], 1, 0),
    (128, 4, 1, [5, 0, 640], 0, 3),
    (128, 2, 7, [2000, 63], 1, 0),
])
def test_kernel_matches_plain_on_gpu(d, nkv, qpk, hist, layer, m, quant):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    c = _case(d, b=len(hist), nkv=nkv, qpk=qpk, hist=hist, seed=11,
              device="cuda")
    c = _int8(c) if quant else c
    args = _hist_args(c, layer)
    bf16, int8 = _counts()
    acc, l, mx = attention.KERNEL(*args)
    torch.cuda.synchronize()
    assert _counts() == ((bf16, int8 + 1) if quant else (bf16 + 1, int8))
    acc_p, l_p, mx_p = attention.hist_flash_plain(*args)
    live = c["hl"] > 0
    torch.testing.assert_close((acc / l.clamp_min(1e-30))[live],
                               (acc_p / l_p.clamp_min(1e-30))[live],
                               atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(mx[live], mx_p[live], atol=1e-3, rtol=1e-3)
    assert bool((l[~live] == 0).all() and (acc[~live] == 0).all())
    cpu = {k: _to_cpu(v) for k, v in c.items()}
    for wrapper, names in (
            (attention.paged_window_attention,
             ("q", "kc", "vc", layer, "pt", "hl", "kw", "vw", m, "ks", "vs",
              "qpk")),
            (attention.paged_decode_attention,
             ("q", "kc", "vc", layer, "pt", "hl", "ks", "vs", "qpk"))):
        on_gpu = wrapper(*[c[n] if isinstance(n, str) else n for n in names])
        plain = wrapper(*[cpu[n] if isinstance(n, str) else n
                          for n in names])
        torch.testing.assert_close(on_gpu.float().cpu(), plain.float(),
                                   atol=1.6e-2, rtol=1.6e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_kernel_clamps_history_to_page_table_row_on_gpu(quant):
    """The last row's table ends the allocation: a read past the row would
    leave it. The kernel clamps the history to the row's tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    c = _case(64, b=2, nkv=2, qpk=4, hist=[20, 100], seed=13, extra=0,
              device="cuda")
    over, _ = _over_long(_int8(c) if quant else c, over=1000)
    args = _hist_args(over)
    acc, l, _ = attention.KERNEL(*args)
    torch.cuda.synchronize()
    acc_p, l_p, _ = attention.hist_flash_plain(*args)
    torch.testing.assert_close(acc / l, acc_p / l_p, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
def test_kernel_rejects_bad_inputs_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    c = _case(64, b=2, nkv=2, qpk=2, hist=[3, 9], device="cuda")
    bad = [
        dict(c, q=c["q"].float()),                       # dtype
        dict(c, pt=c["pt"].long()),                      # index dtype
        dict(c, q=c["q"].transpose(0, 1)),               # shape/contiguity
        dict(c, qpk=16, q=c["q"].repeat(1, 8, 1)),       # q_per_kv > 8
    ]
    before = attention.KERNEL.launches
    for case in bad:
        with pytest.raises(ValueError):
            attention.KERNEL(*_hist_args(case))
    with pytest.raises(ValueError, match="layer"):
        attention.KERNEL(*_hist_args(c, layer=2))
    assert attention.KERNEL.launches == before


@pytest.mark.gpu
def test_int8_kernel_rejects_bad_inputs_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    c = _int8(_case(64, b=2, nkv=2, qpk=2, hist=[3, 9], device="cuda"))
    kc = c["kc"]
    data16 = torch.empty(kc.data.numel() + 1, dtype=torch.int8,
                         device="cuda")[1:].view(kc.data.shape)
    data16.copy_(kc.data)
    bad = [
        dict(c, kc=QuantKV(kc.data, kc.scale.double())),          # scale dtype
        dict(c, kc=QuantKV(kc.data.to(torch.uint8), kc.scale)),   # data dtype
        dict(c, kc=QuantKV(kc.data, kc.scale[..., :-1].contiguous())),
        dict(c, kc=QuantKV(kc.data, kc.scale.transpose(0, 1)      # strides
                           .contiguous().transpose(0, 1))),
        dict(c, kc=QuantKV(data16, kc.scale)),                    # alignment
        dict(c, kc=QuantKV(kc.data.cpu(), kc.scale)),             # device
        dict(c, vc=c["vc"].data),                                 # mixed
    ]
    before = _counts()
    for case in bad:
        with pytest.raises(ValueError):
            attention.KERNEL(*_hist_args(case))
    assert _counts() == before


@pytest.mark.gpu
def test_kv_quantize_on_gpu_is_bit_identical_to_cpu():
    """The quantizer on the card gives the CPU's bits (which the CPU tests
    hold to the reference's numpy quantizer): true divisions, round half
    to even, .5 ties and all-zero rows included."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal((64, 8, 16, 128)).astype(
        np.float32) * 3)
    x[0, 0, 0, :8] = torch.tensor([127, 2.5, -3.5, 0.5, 1.5, -0.5, -2.5,
                                   126.5])
    x[0, 0, 1] = 0
    for xt in (x, x.to(torch.bfloat16)):
        q_c, s_c = kv_quantize(xt)
        q_g, s_g = kv_quantize(xt.cuda())
        assert torch.equal(q_g.cpu(), q_c)
        assert torch.equal(s_g.cpu().view(torch.int32), s_c.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("quant_kv", [None, "int8"], ids=["bf16", "int8"])
def test_window_graph_replay_equals_eager_body_on_gpu(quant_kv):
    """A window program replayed from its CUDA graph equals its body run
    eagerly on the same state (greedy tokens equal; the chosen and top-5
    logprobs within 1e-5, where the same kernels in the same order give
    0), and every replay counts M x L launches of the pool's entry point
    and none of the other."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from dynamo_tpu_torch.engine import config as tcfg
    from dynamo_tpu_torch.engine import runner as trunner
    spec = tcfg.PRESETS["tiny-test"]
    M, B, page = 4, 4, 16
    r = trunner.ModelRunner(tcfg.EngineConfig(
        model=spec, num_pages=64, max_num_seqs=B, max_pages_per_seq=16,
        prefill_buckets=(64, 128), max_prefill_tokens=128, quant_kv=quant_kv,
        device="cuda"))
    rng = np.random.default_rng(21)
    lens = (40, 77, 100)
    seqs = [trunner.PrefillSeq(
        tokens=rng.integers(0, spec.vocab_size, n).astype(np.int32),
        chunk_pages=np.arange(1 + 8 * i, 1 + 8 * i + -(-n // page)),
        sampling=(0.0, 0, 1.0)) for i, n in enumerate(lens)]
    r.prefill_batch(seqs, slots=[0, 1, 2])
    width = r.bucket_pages_for(8)
    packed = np.zeros((B, trunner.PK_PREFIX + width), np.int32)
    for i, n in enumerate(lens):
        packed[i, trunner.PK_POS] = n
        packed[i, trunner.PK_SEQLEN] = n + 1
        packed[i, trunner.PK_TOPP] = np.float32(1.0).view(np.int32)
        packed[i, trunner.PK_CAP] = 8 * page
        packed[i, trunner.PK_PREFIX:trunner.PK_PREFIX + 8] = \
            np.arange(1 + 8 * i, 9 + 8 * i)
    packed[1, trunner.PK_LOGPROB] = 1
    tokens, step = r.tokens_dev.clone(), r._noise_step.clone()
    prog = r._get_window(M, width, False, False, True)
    replayed = [t.clone() for t in prog.run(packed)]
    assert prog.graph is not None and r.window_replays == 1
    r.tokens_dev.copy_(tokens)
    r._noise_step.copy_(step)
    eager = prog.run_eager(packed)
    torch.cuda.synchronize()
    assert torch.equal(replayed[0], eager[0]), (replayed[0], eager[0])
    diff = max(float((replayed[1] - eager[1]).abs().max()),
               float((replayed[2][..., :5] - eager[2][..., :5]).abs().max()))
    print(f"replay vs eager body: max |logprob diff| {diff}")
    assert diff <= 1e-5, diff
    assert torch.equal(replayed[3][..., :5], eager[3][..., :5])
    attention.KERNEL.launches = attention.KERNEL.launches_int8 = 0
    for _ in range(3):
        prog.run(packed)
    torch.cuda.synchronize()
    want = 3 * M * spec.num_layers
    assert _counts() == ((0, want) if quant_kv else (want, 0)), _counts()


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("d,nkv,qpk,hist,s,wlen,layer", [
    (32, 2, 2, [0, 5, 17, 140], 4, [0, 3, 8, 1], 1),   # ragged, zero, W
    (64, 2, 4, [300, 0, 131], 1, [2, 0, 8], 0),        # S=1, GQA
    (128, 1, 8, [129, 700], 4, [8, 0], 1),             # MQA
    (128, 8, 4, [0, 33, 1000, 2049], 4, [4, 4, 0, 8], 1),
])
def test_verify_route_matches_plain_on_gpu(d, nkv, qpk, hist, s, wlen, layer,
                                           quant):
    """The speculative verify wrapper on the card (one kernel launch over
    the B*S folded rows) against its einsum version on CPU copies of the
    same inputs, within two bf16 ulps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from dynamo_tpu_torch.engine.model import paged_verify_attention_plain
    from dynamo_tpu_torch.time_attention import make_verify_case, verify_args
    c = make_verify_case(torch.Generator().manual_seed(d + s), d, len(hist),
                         nkv, qpk, hist, s, wlen, quant=quant)
    bf16, int8 = _counts()
    got = attention.paged_verify_attention(*verify_args(c, layer))
    torch.cuda.synchronize()
    assert _counts() == ((bf16, int8 + 1) if quant else (bf16 + 1, int8))
    want = paged_verify_attention_plain(*verify_args(
        {k: _to_cpu(v) for k, v in c.items()}, layer))
    torch.testing.assert_close(got.float().cpu(), want.float(),
                               atol=1.6e-2, rtol=1.6e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("quant_kv", [None, "int8"], ids=["bf16", "int8"])
def test_spec_window_graph_replay_equals_eager_body_on_gpu(quant_kv):
    """A speculative window program replayed from its CUDA graph equals its
    body run eagerly on the same state (tokens_dev, positions_dev, hist_dev
    and the noise step put back): tokens, emitted counts and drafts equal,
    the chained state too, and every replay counts m_outer x L launches of
    the pool's entry point and none of the other."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from dynamo_tpu_torch.engine import config as tcfg
    from dynamo_tpu_torch.engine import runner as trunner
    spec = tcfg.PRESETS["tiny-test"]
    B, page, m_outer, k = 4, 16, 2, 3
    r = trunner.ModelRunner(tcfg.EngineConfig(
        model=spec, num_pages=64, max_num_seqs=B, max_pages_per_seq=16,
        prefill_buckets=(64, 128), max_prefill_tokens=128, quant_kv=quant_kv,
        spec_decode="ngram", spec_k=k, device="cuda"))
    rng = np.random.default_rng(22)
    lens = (40, 77, 100)
    prompts = [np.tile(rng.integers(0, spec.vocab_size, 5), 30)[:n]
               .astype(np.int32) for n in lens]
    r.prefill_batch([trunner.PrefillSeq(
        tokens=p, chunk_pages=np.arange(1 + 8 * i, 1 + 8 * i + -(-n // page)),
        sampling=(0.0, 0, 1.0)) for i, (p, n) in enumerate(zip(prompts,
                                                                lens))],
        slots=[0, 1, 2])
    r.seed_history([(i, p, 0, True, None) for i, p in enumerate(prompts)])
    width = r.bucket_pages_for(8)
    packed = np.zeros((B, trunner.PK_PREFIX + width), np.int32)
    for i, n in enumerate(lens):
        packed[i, trunner.PK_POS] = n
        packed[i, trunner.PK_SEQLEN] = n + 1
        packed[i, trunner.PK_TEMP] = np.float32(0.7 * (i == 2)).view(
            np.int32)
        packed[i, trunner.PK_TOPP] = np.float32(1.0).view(np.int32)
        packed[i, trunner.PK_CAP] = 8 * page
        packed[i, trunner.PK_SEED] = 9
        packed[i, trunner.PK_SEEDED] = int(i == 2)
        packed[i, trunner.PK_PREFIX:trunner.PK_PREFIX + 8] = \
            np.arange(1 + 8 * i, 9 + 8 * i)
    state = (r.tokens_dev, r.positions_dev, r.hist_dev, r._noise_step)
    before = [t.clone() for t in state]
    prog = r._get_spec_window(m_outer, k, width)
    replayed = [t.clone() for t in prog.run(packed)]
    after = [t.clone() for t in state]
    assert prog.graph is not None and r.window_replays == 1
    for t, b in zip(state, before):
        t.copy_(b)
    eager = prog.run_eager(packed)
    torch.cuda.synchronize()
    for a, b in zip(replayed, eager):
        assert torch.equal(a, b), (a, b)
    for a, t in zip(after, state):
        assert torch.equal(a, t)
    assert int(replayed[1][:, :3].min()) >= 1
    attention.KERNEL.launches = attention.KERNEL.launches_int8 = 0
    for _ in range(3):
        prog.run(packed)
    torch.cuda.synchronize()
    want = 3 * m_outer * spec.num_layers
    assert _counts() == ((0, want) if quant_kv else (want, 0)), _counts()


@pytest.mark.gpu
@pytest.mark.parametrize("quant_kv", [None, "int8"], ids=["bf16", "int8"])
def test_lora_window_graph_after_a_hot_load_equals_eager_body_on_gpu(
        quant_kv):
    """A window program with rows on LoRA slots 0, 1 and 2, captured,
    then adapter 2 hot-loaded into slot 1 through the store (an in-place
    write, no stack rebound): the replay equals the body run eagerly on
    the same state (tokens equal, chosen and top-5 logprobs within 1e-5)
    and differs from the replay before the hot-load on the slot-1 row
    only."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from dynamo_tpu_torch.engine import config as tcfg
    from dynamo_tpu_torch.engine import runner as trunner
    from dynamo_tpu_torch.engine.lora import AdapterStore
    spec = tcfg.PRESETS["tiny-test"]
    M, B, page, rank = 4, 4, 16, 8
    cfg = tcfg.EngineConfig(
        model=spec, num_pages=64, max_num_seqs=B, max_pages_per_seq=16,
        prefill_buckets=(64, 128), max_prefill_tokens=128, quant_kv=quant_kv,
        max_adapters=2, lora_max_rank=rank, device="cuda")
    r = trunner.ModelRunner(cfg)
    gen = torch.Generator().manual_seed(5)

    def adapter():
        return {k: (torch.randn((spec.num_layers, i, rank), generator=gen)
                    .mul(0.2).to(torch.bfloat16),
                    torch.randn((spec.num_layers, rank, o), generator=gen)
                    .mul(0.2).to(torch.bfloat16))
                for k, (i, o) in cfg.lora_target_shapes().items()}
    store = AdapterStore(r, 2, rank)
    for name in ("one", "two", "three"):
        store.register(name, weights=adapter())
    assert (store.acquire("one"), store.acquire("two")) == (1, 2)
    rng = np.random.default_rng(23)
    lens = (40, 77, 100)
    seqs = [trunner.PrefillSeq(
        tokens=rng.integers(0, spec.vocab_size, n).astype(np.int32),
        chunk_pages=np.arange(1 + 8 * i, 1 + 8 * i + -(-n // page)),
        sampling=(0.0, 0, 1.0), adapter_id=i) for i, n in enumerate(lens)]
    r.prefill_batch(seqs, slots=[0, 1, 2])
    width = r.bucket_pages_for(8)
    packed = np.zeros((B, trunner.PK_PREFIX + width), np.int32)
    for i, n in enumerate(lens):
        packed[i, trunner.PK_OVERRIDE] = 1
        packed[i, trunner.PK_TOKEN] = 11 + i
        packed[i, trunner.PK_POS] = n
        packed[i, trunner.PK_SEQLEN] = n + 1
        packed[i, trunner.PK_TOPP] = np.float32(1.0).view(np.int32)
        packed[i, trunner.PK_CAP] = 8 * page
        packed[i, trunner.PK_LOGPROB] = 1
        packed[i, trunner.PK_ADAPTER] = i
        packed[i, trunner.PK_PREFIX:trunner.PK_PREFIX + 8] = \
            np.arange(1 + 8 * i, 9 + 8 * i)
    prog = r._get_window(M, width, False, False, True)
    first = [t.clone() for t in prog.run(packed)]
    ptrs = [t.data_ptr() for ab in r.lora.values() for t in ab.values()]
    store.release("one")
    assert store.acquire("three") == 1  # LRU: "one" leaves slot 1
    assert ptrs == [t.data_ptr() for ab in r.lora.values()
                    for t in ab.values()]
    step = r._noise_step.clone()
    replayed = [t.clone() for t in prog.run(packed)]
    assert r.window_replays == 2
    r._noise_step.copy_(step)
    eager = prog.run_eager(packed)
    torch.cuda.synchronize()
    assert torch.equal(replayed[0], eager[0]), (replayed[0], eager[0])
    diff = max(float((replayed[1] - eager[1]).abs().max()),
               float((replayed[2][..., :5] - eager[2][..., :5]).abs().max()))
    print(f"LoRA replay after a hot-load vs eager body: max |logprob diff| "
          f"{diff}")
    assert diff <= 1e-5, diff
    assert torch.equal(replayed[3][..., :5], eager[3][..., :5])
    # Slots 0 and 2 did not change: their rows replay as before.
    for row in (0, 2):
        assert torch.equal(replayed[1][:, row], first[1][:, row]), row
    assert not torch.equal(replayed[1][:, 1], first[1][:, 1])


# lora_delta's tolerance in test_torch_lora.py (its CPU branch against the
# reference): a bf16 rounding of u or of the output may fall one ulp apart.
LORA_DELTA_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("s,h,r,d,n", [(3, 128, 8, 96, 5),
                                       (3, 4096, 16, 1024, 8)],
                         ids=["small", "llama"])
def test_lora_delta_on_gpu_matches_cpu_branch(ndim, s, h, r, d, n):
    """The card's branch of ``model.lora_delta`` (bmm with an fp32
    output) against its CPU branch, which test_torch_lora.py holds to the
    reference, on the same bf16 inputs with mixed slots, within that
    test's tolerance; slot-0 rows are exact zeros on the card too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's branch runs only there")
    from dynamo_tpu_torch.engine import model
    g = torch.Generator().manual_seed(ndim * 100 + h)
    a = (torch.randn((s, h, r), generator=g) * 0.2).to(torch.bfloat16)
    b = (torch.randn((s, r, d), generator=g) * 0.2).to(torch.bfloat16)
    a[0], b[0] = 0, 0
    ids = torch.tensor([(i * 2 + 1) % s for i in range(n)], dtype=torch.int32)
    ids[0] = 0
    shape = (n, h) if ndim == 2 else (n, 3, h)
    x = torch.randn(shape, generator=g).to(torch.bfloat16)
    want = model.lora_delta(x, {"a": a, "b": b}, ids)
    got = model.lora_delta(x.cuda(), {"a": a.cuda(), "b": b.cuda()},
                            ids.cuda())
    assert got.is_cuda and got.dtype == torch.bfloat16
    got = got.cpu()
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **LORA_DELTA_TOL)
    base = (ids == 0).numpy()
    assert not got.float().numpy()[base].any()
    assert np.abs(got.float().numpy()[~base]).max() > 0.5


@pytest.mark.gpu
def test_spec_brownout_switch_keeps_the_plain_path_on_gpu():
    """A spec-decode engine on the card whose brownout level is scripted
    by window count (spec, then plain windows, then spec again on the
    same slots: the verify route and the plain window over one pool)
    gives the greedy tokens of a plain engine on the same prompts; at a
    first split both tokens are the plain path's teacher-forced top two
    within two bf16 ulps of its logits (the file's tolerance), and every
    kind of window ran on the bf16 entry point."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the window graphs and the kernel "
                    "have no CPU mode")
    import asyncio

    from dynamo_tpu_torch.engine import config as tcfg
    from dynamo_tpu_torch.engine import runner as trunner
    from dynamo_tpu_torch.engine.engine import GPUEngine
    from dynamo_tpu_torch.runtime.context import Context
    spec = tcfg.PRESETS["tiny-test"]
    kw = dict(model=spec, num_pages=256, max_num_seqs=4, max_pages_per_seq=16,
              prefill_buckets=(64, 128), max_prefill_tokens=256,
              decode_window=8, pipeline_depth=2, device="cuda")
    plain = GPUEngine(tcfg.EngineConfig(**kw), seed=3)
    eng = GPUEngine(tcfg.EngineConfig(spec_decode="ngram", spec_k=3, **kw),
                    params=plain.runner.params, seed=3)

    def update():
        eng.brownout_level = 2 if 2 <= eng.windows_dispatched < 5 else 0
    eng._update_brownout = update
    rng = np.random.default_rng(31)
    prompts = [np.tile(rng.integers(1, spec.vocab_size, 6), 10)[:48].tolist()
               for _ in range(3)] + [rng.integers(1, spec.vocab_size,
                                                  30).tolist()]

    async def run(engine):
        async def one(p):
            req = {"model": "m", "token_ids": p,
                   "stop_conditions": {"max_tokens": 40, "ignore_eos": True}}
            toks = []
            async for out in engine.generate(req, Context()):
                toks.extend(out.get("token_ids", []))
            return toks
        return await asyncio.gather(*(one(p) for p in prompts))

    try:
        want = asyncio.run(run(plain))
        attention.KERNEL.launches = attention.KERNEL.launches_int8 = 0
        got = asyncio.run(run(eng))
        assert eng.spec_brownout_windows == 3 and eng.spec_drafts > 0
        assert _counts()[0] > 0 and _counts()[1] == 0
        r = plain.runner
        for p, w, g in zip(prompts, want, got):
            split = next((i for i, (a, b) in enumerate(zip(w, g)) if a != b),
                         None)
            if split is None:
                continue
            ctx = np.asarray(p + w[:split], np.int32)
            n = len(ctx)
            r.prefill_batch([trunner.PrefillSeq(
                tokens=ctx, chunk_pages=np.arange(200, 200 + -(-n // 16)),
                sampling=(0.0, 0, 1.0))])
            lg = r.last_prefill_logits[0].float().cpu().numpy()
            top2 = set(np.argsort(lg)[::-1][:2].tolist())
            a, b = w[split], g[split]
            ulp = float(np.spacing(np.float32(max(abs(lg[a]), abs(lg[b]))))
                        ) * 2 ** 16
            assert {a, b} <= top2 and abs(lg[a] - lg[b]) <= 2 * ulp, (
                split, a, b)
    finally:
        plain.stop()
        eng.stop()


@pytest.mark.gpu
def test_flipped_engine_window_graph_replay_equals_eager_body_on_gpu():
    """A worker's GPUEngine (tiny-test, window programs warmed) flipped
    agg -> prefill -> decode -> agg through ``backends.gpu``'s profiles and
    a RoleManager on an embedded coordinator keeps its weights (the same
    tensors at the same addresses, allocated memory within 1%) and makes
    no program; afterwards a window program of its runner, replayed from
    its graph, equals its body run eagerly on the same state (greedy
    tokens equal, logprobs within 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    import asyncio

    from dynamo_tpu_torch import launch
    from dynamo_tpu_torch.backends import gpu
    from dynamo_tpu_torch.engine import runner as trunner
    from dynamo_tpu_torch.llm.reconfig import RoleManager
    from dynamo_tpu_torch.llm.tokenizer import make_test_tokenizer
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    args = gpu.parse_args(["--model", "tiny-test", "--num-pages", "256",
                           "--no-kv-plane"])

    async def flips():
        rt = await DistributedRuntime.with_embedded_coordinator(
            RuntimeConfig(namespace="flip"))
        engine = launch.load_engine(gpu.build_engine_config(args), None, 0,
                                    start=False)
        engine.start(asyncio.get_running_loop())
        params = [t for t in engine.runner.params.values()
                  if isinstance(t, torch.Tensor)]
        ptrs = [t.data_ptr() for t in params]
        before = (torch.cuda.memory_allocated(),
                  engine.runner.window_programs())
        mgr = RoleManager(rt, gpu.make_profile_builder(
            rt, args, engine, make_test_tokenizer(), "tiny-test", None, []),
            role="agg", drain_s=0.1)
        await mgr.start()
        outcomes = [(await mgr.set_role(role, epoch))["outcome"]
                    for epoch, role in enumerate(
                        ("prefill", "decode", "agg"), 1)]
        after = (torch.cuda.memory_allocated(),
                 engine.runner.window_programs())
        await mgr.stop()
        engine.stop()
        await rt.close()
        return engine, params, ptrs, before, after, outcomes

    engine, params, ptrs, before, after, outcomes = asyncio.run(flips())
    assert outcomes == ["ok", "ok", "ok"]
    assert [t.data_ptr() for t in params] == ptrs
    assert abs(after[0] - before[0]) <= 0.01 * before[0], (before, after)
    assert after[1]["programs"] == before[1]["programs"] == 8
    assert after[1]["captured"] == before[1]["captured"]
    r, spec, page = engine.runner, engine.runner.spec, 16
    M, B = engine.decode_window, engine.config.max_num_seqs
    rng = np.random.default_rng(23)
    lens = (40, 77, 100)
    seqs = [trunner.PrefillSeq(
        tokens=rng.integers(0, spec.vocab_size, n).astype(np.int32),
        chunk_pages=np.arange(1 + 8 * i, 1 + 8 * i + -(-n // page)),
        sampling=(0.0, 0, 1.0)) for i, n in enumerate(lens)]
    r.prefill_batch(seqs, slots=[0, 1, 2])
    width = r.bucket_pages_for(8)
    packed = np.zeros((B, trunner.PK_PREFIX + width), np.int32)
    for i, n in enumerate(lens):
        packed[i, trunner.PK_POS] = n
        packed[i, trunner.PK_SEQLEN] = n + 1
        packed[i, trunner.PK_TOPP] = np.float32(1.0).view(np.int32)
        packed[i, trunner.PK_CAP] = 8 * page
        packed[i, trunner.PK_PREFIX:trunner.PK_PREFIX + 8] = \
            np.arange(1 + 8 * i, 9 + 8 * i)
    packed[1, trunner.PK_LOGPROB] = 1
    tokens, step = r.tokens_dev.clone(), r._noise_step.clone()
    prog = r._get_window(M, width, False, False, True)
    assert prog.graph is not None  # warmed before the flips
    replays = r.window_replays
    replayed = [t.clone() for t in prog.run(packed)]
    assert r.window_replays == replays + 1
    r.tokens_dev.copy_(tokens)
    r._noise_step.copy_(step)
    eager = prog.run_eager(packed)
    torch.cuda.synchronize()
    assert torch.equal(replayed[0], eager[0]), (replayed[0], eager[0])
    diff = max(float((replayed[1] - eager[1]).abs().max()),
               float((replayed[2][..., :5] - eager[2][..., :5]).abs().max()))
    assert diff <= 1e-5, diff
