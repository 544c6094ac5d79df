"""Time the paged attention kernel's wrapper on the card, three ways, at
llama-3-8b decode widths (Nkv=8, qpk=4, D=128, page 16, B=32 slots, a
128-page bucket), bf16 and int8 pools, at two shapes: history 2048 in
every row ("uniform") and the main path's mid-round histories ("main": 8
live rows at their prompt plus 31 generated tokens, the rest empty).
The verify wrapper of speculative decode (``paged_verify_attention``: 4
positions a slot folded into one kernel launch, a window buffer of 8
columns) is timed at the same two shapes.

    python3 dynamo_tpu_torch/time_attention.py [--tree DIR]

- ``graph_ms``: device time per call, from calls captured in one CUDA graph
  and replayed, so the wrapper's host time is not counted;
- ``eager_ms``: per call of back-to-back eager calls between two CUDA
  events, which is what a decode step pays where the host is slower than
  the device;
- ``host_ms``: the wrapper's host time per call, by the host clock over
  the same kind of loop.

``DIR`` is the root of a checkout of the repo (default: the one holding
this file). Its ``dynamo_tpu_torch`` is imported and its kernel built into
``DIR/build``, so that two checkouts, a parent and a change, are compared
on one card by running this once per checkout, in the order parent,
change, change, parent. Prints one JSON line per (pool, shape) and the
card's name and power limit. ``chip_smoke.py`` uses its case maker and
timers. Runs on a GPU only.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

import torch

SHAPE = dict(b=32, nkv=8, qpk=4, d=128, page=16, maxp=128)


def make_case(gen, d, b, nkv, qpk, hist, L=2, page=16, M=8, extra_pages=3,
              quant=False, maxp=None, device="cuda"):
    """Random bf16 (or int8-quantized) pools on ``device`` (the card by
    default), a shuffled page table (entries past the live pages point
    anywhere), q, the window buffer and the current token's K/V, from the
    torch generator ``gen``."""
    if maxp is None:
        maxp = max(1, max(-(-h // page) for h in hist)) + extra_pages
    npages = b * maxp + 2

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16).to(device)

    perm = torch.randperm(npages - 1, generator=gen) + 1
    pt = perm[:b * maxp].reshape(b, maxp).to(torch.int32).to(device)
    kc, vc = rnd(L, nkv, npages, page, d), rnd(L, nkv, npages, page, d)
    if quant:
        from dynamo_tpu_torch.engine.kv_quant import QuantKV, kv_quantize
        kc, vc = QuantKV(*kv_quantize(kc)), QuantKV(*kv_quantize(vc))
    return dict(q=rnd(b, nkv * qpk, d), kc=kc, vc=vc, pt=pt,
                hl=torch.tensor(hist, dtype=torch.int32).to(device),
                ks=rnd(b, nkv, d), vs=rnd(b, nkv, d),
                kw=rnd(nkv, b, M, d), vw=rnd(nkv, b, M, d), qpk=qpk)


def make_verify_case(gen, d, b, nkv, qpk, hist, s, wlen, w=8, **kw):
    """``make_case`` with a speculative verify block: q [B,S,Nh,D] under
    "qv", the window buffer of ``w`` columns with ``wlen`` [B] valid under
    "kw"/"vw" and "wl", and the block's own K/V [B,S,Nkv,D] under
    "kb"/"vb"."""
    c = make_case(gen, d, b, nkv, qpk, hist, M=w, **kw)
    dev = c["pt"].device

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)

    c.update(qv=rnd(b, s, nkv * qpk, d), kb=rnd(b, s, nkv, d),
             vb=rnd(b, s, nkv, d),
             wl=torch.tensor(wlen, dtype=torch.int32, device=dev))
    return c


def verify_args(c, layer: int = 1) -> tuple:
    """The arguments of ``paged_verify_attention`` (and its plain version)
    for a ``make_verify_case`` case."""
    return (c["qv"], c["kc"], c["vc"], layer, c["pt"], c["hl"], c["kw"],
            c["vw"], c["wl"], c["kb"], c["vb"], c["qpk"])


# The verify block of speculative decode on the main path: k = 3 drafts
# (S = 4 positions a slot), M = 8 so m_outer = 2 steps and a window buffer
# of 8 columns, timed at the second step with one full step in the buffer.
VERIFY = dict(s=4, w=8, wlen=4)


def timed_verify_case(quant: bool, shape: str):
    """The verify case of one timed shape (as ``timed_case``): B=32 slots x
    S=4 positions over history 2048 in every row ("uniform") or the main
    path's mid-round histories ("main")."""
    s = SHAPE
    hist, layers = (([2048] * s["b"], [1]) if shape == "uniform"
                    else (main_shape_hist(s["b"]), [0, 1, 2, 3]))
    wlen = [VERIFY["wlen"] if h else 0 for h in hist]
    c = make_verify_case(torch.Generator().manual_seed(4), s["d"], s["b"],
                         s["nkv"], s["qpk"], hist, VERIFY["s"], wlen,
                         w=VERIFY["w"], L=max(layers) + 1, page=s["page"],
                         quant=quant, maxp=s["maxp"])
    return c, hist, layers


def verify_caller(fn, c, layers):
    """A call of the verify wrapper ``fn`` on the case, each call on the
    next of ``layers``."""
    turn = itertools.cycle(layers)
    return lambda: fn(*verify_args(c, next(turn)))


def main_shape_hist(b: int = 32) -> list[int]:
    """Histories of the main path's 32 slots in the middle of its round:
    the 8 live rows at their prompt plus 31 generated tokens, the rest
    empty."""
    from dynamo_tpu_torch.profile_decode import MAX_TOKENS, PROMPT_LENS
    live = [n + MAX_TOKENS // 2 - 1 for n in PROMPT_LENS]
    return live + [0] * (b - len(live))


def timed_case(quant: bool, shape: str):
    """The case of one timed shape, and its layers: the main path reads a
    layer's pages once per step, after 31 other layers have passed through
    the 50 MB L2. One layer of B=32 x 2048 (268 MB) is larger than L2; the
    main shape's (36 MB) is not, so its calls cycle through 4 layers."""
    s = SHAPE
    hist, layers = (([2048] * s["b"], [1]) if shape == "uniform"
                    else (main_shape_hist(s["b"]), [0, 1, 2, 3]))
    c = make_case(torch.Generator().manual_seed(2), s["d"], s["b"],
                  s["nkv"], s["qpk"], hist, L=max(layers) + 1,
                  page=s["page"], quant=quant, maxp=s["maxp"])
    return c, hist, layers


def caller(fn, c, layers):
    """A call of ``fn`` on the case, each call on the next of ``layers``."""
    turn = itertools.cycle(layers)
    return lambda: fn(c["q"], c["kc"], c["vc"], next(turn), c["pt"],
                      c["hl"], c["qpk"])


def graph_ms(fn, iters: int = 20, warmup: int = 3, replays: int = 3) -> float:
    """Device ms of one call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, so the host time between launches is not
    counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def eager_ms(fn, iters: int = 60, warmup: int = 3) -> tuple[float, float]:
    """(eager ms, host ms) per call of ``fn`` over ``iters`` back-to-back
    calls: between two CUDA events on the stream, and by the host clock
    from the first call to the last one's return (no wait for the
    device)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host * 1e3 / iters


def wrapper_times(attention, quant: bool, shape: str) -> dict:
    """graph_ms, eager_ms and host_ms of ``attention.KERNEL`` at one timed
    shape."""
    c, _, layers = timed_case(quant, shape)
    fn = caller(attention.KERNEL, c, layers)
    g = graph_ms(fn)
    e, h = eager_ms(fn)
    return {"graph_ms": g, "eager_ms": e, "host_ms": h}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path,
                    default=Path(__file__).resolve().parents[1],
                    help="root of the checkout whose wrapper is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 1
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    from dynamo_tpu_torch.engine import attention
    from dynamo_tpu_torch.profile_decode import smi_line
    assert Path(attention.__file__).resolve().is_relative_to(tree), \
        attention.__file__
    attention.KERNEL.build()
    for quant, shape in itertools.product((False, True), ("main", "uniform")):
        out = wrapper_times(attention, quant, shape)
        print(json.dumps({"tree": str(tree), "pool": "int8" if quant
                          else "bf16", "shape": shape, **out}), flush=True)
        c, _, layers = timed_verify_case(quant, shape)
        fn = verify_caller(attention.paged_verify_attention, c, layers)
        e, h = eager_ms(fn)
        print(json.dumps({"tree": str(tree), "pool": "int8" if quant
                          else "bf16", "shape": shape,
                          "wrapper": "paged_verify_attention",
                          "graph_ms": graph_ms(fn), "eager_ms": e,
                          "host_ms": h}), flush=True)
    print(smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
