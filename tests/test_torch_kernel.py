"""The paged attention kernel's wrapper, its plain version, and (on a GPU)
the CUDA kernel against that plain version.

This file imports neither jax nor dynamo_tpu, so it also runs on a machine
with the card and no JAX:

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernel.py

The gpu-marked tests skip without a card: a CUDA kernel has no CPU mode.
Tolerance on the card: kernel and plain version accumulate in fp32 from the
same bf16 inputs; only summation order and exp rounding differ, so the
normalised history output agrees to 1e-3 and the bf16 wrapper outputs to
two bf16 ulps (1.6e-2 relative).
"""

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine import attention

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


def test_kernel_wrapper_raises_instead_of_falling_back():
    c = _case(32, b=2, nkv=2, qpk=2, hist=[3, 9])
    before = attention.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        attention.KERNEL(*_hist_args(c))
    assert attention.KERNEL.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("d,nkv,qpk,hist,layer,m", [
    (32, 2, 2, [0, 5, 17, 140], 1, 0),
    (64, 2, 4, [300, 0, 131], 1, 3),
    (64, 2, 7, [64, 65], 0, 3),
    (128, 8, 4, [0, 33, 1000, 2049], 1, 0),
    (128, 1, 8, [129, 700], 1, 3),
])
def test_kernel_matches_plain_on_gpu(d, nkv, qpk, hist, layer, m):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    c = _case(d, b=len(hist), nkv=nkv, qpk=qpk, hist=hist, seed=11,
              device="cuda")
    args = _hist_args(c, layer)
    before = attention.KERNEL.launches
    acc, l, mx = attention.KERNEL(*args)
    torch.cuda.synchronize()
    assert attention.KERNEL.launches == before + 1
    acc_p, l_p, mx_p = attention.hist_flash_plain(*args)
    live = c["hl"] > 0
    torch.testing.assert_close((acc / l.clamp_min(1e-30))[live],
                               (acc_p / l_p.clamp_min(1e-30))[live],
                               atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(mx[live], mx_p[live], atol=1e-3, rtol=1e-3)
    assert bool((l[~live] == 0).all() and (acc[~live] == 0).all())
    cpu = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in c.items()}
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
def test_kernel_clamps_history_to_page_table_row_on_gpu():
    """The last row's table ends the allocation: a read past the row would
    leave it. The kernel clamps the history to the row's tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    c = _case(64, b=2, nkv=2, qpk=4, hist=[20, 100], seed=13, extra=0,
              device="cuda")
    over, _ = _over_long(c, over=1000)
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
