"""Paged decode attention: the hand-written Hopper kernel, its plain torch
version, and the two wrappers the decode path calls.

The kernel (``csrc/paged_attention.cu``) replaces the TPU kernel
``dynamo_tpu/engine/attention.py::_decode_kernel`` in both its variants:
it reads the live history pages of one layer of the stacked
``[L, Nkv, P, page, D]`` pool and returns the flash triple (unnormalised
acc, l, m). It runs split-K over pages: a partial kernel per (sequence,
kv-head, split) writes fp32 partial triples into scratch this module
allocates, and a combine kernel merges them; ``split_plan`` picks the
split from shapes alone, so ``hist_lens`` is never read back. One C call
per entry point launches both kernels. A bf16 pool goes to the entry point
``paged_attention_hist``; an int8 pool (``QuantKV``: int8 values and f32
per-token scales) to ``paged_attention_hist_int8``. The wrappers then
flash-merge the in-window buffer columns ``j < m`` and the current token's
column in torch (``_merge_extra``), as the JAX wrappers do. The verify
wrapper of speculative decode (``paged_verify_attention``) runs the same
kernel with a slot's S verify positions folded into its batch.

Which version runs follows the tensors: CPU tensors take the plain
version (that is what the CPU tests run), CUDA tensors launch the kernel
or raise. There is no fallback between the two. The kernel is compiled
with ``nvcc`` for ``sm_90a`` into ``build/`` at first use and loaded with
ctypes; nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from dynamo_tpu_torch.engine.kv_quant import KV_SCALE_BYTES, QuantKV

NEG_INF = -1e30
MAX_QPK = 8
HEAD_DIMS = (32, 64, 128)
SPLIT_TOKENS = 256      # history tokens per split

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "paged_attention.cu"
BUILD_DIR = _PKG.parent / "build"
LIBRARY = BUILD_DIR / "libpaged_attention.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "paged attention kernel cannot be built")
    return path


def split_plan(maxp: int, page_size: int) -> tuple[int, int]:
    """Pages per split ``pps`` and split count ``S`` for a page table of
    ``maxp`` entries per row (the runner's power-of-two page bucket): split
    ``s`` covers pages ``[s * pps, (s + 1) * pps)``, and the S splits cover
    every page exactly once. Shapes only, never the histories: a split holds
    SPLIT_TOKENS tokens, or one page where a page is larger."""
    pps = max(1, SPLIT_TOKENS // page_size)
    return pps, -(-maxp // pps)


class PagedAttentionKernel:
    """The compiled kernel and its launch counts, one per entry point.

    ``launches`` (bf16 pool, ``paged_attention_hist``) and
    ``launches_int8`` (int8 pool, ``paged_attention_hist_int8``) each go up
    by one for every launch of that entry point and nowhere else, so a
    caller can zero them, drive a path, and read how many times that path
    ran each variant. Under a CUDA graph capture the wrapper's call only
    records the launch: the capturing thread wraps the capture in
    ``recording()``, which collects its calls in a tally instead of the
    counts, and adds the tally to the counts on every replay with
    ``add_replay``."""

    def __init__(self):
        self.launches = 0
        self.launches_int8 = 0
        self._lib = None
        self._local = threading.local()
        self.build_log = ""
        self.build_seconds = 0.0

    @contextlib.contextmanager
    def recording(self):
        """Within this block, this thread's calls go to the yielded tally
        ``[bf16, int8]`` and not to the counts (other threads' calls still
        count)."""
        tally = [0, 0]
        outer = getattr(self._local, "tally", None)
        self._local.tally = tally
        try:
            yield tally
        finally:
            self._local.tally = outer

    def add_replay(self, tally) -> None:
        """Count the launches one replay of a captured graph makes."""
        self.launches += tally[0]
        self.launches_int8 += tally[1]

    def build(self) -> None:
        """Compile the source (if the library is missing or older than it)
        and load the library."""
        if self._lib is not None:
            return
        t0 = time.monotonic()
        if (not LIBRARY.exists()
                or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime):
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = LIBRARY.with_name(f".{LIBRARY.name}.{os.getpid()}")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{self.build_log}")
            os.replace(tmp, LIBRARY)
        lib = ctypes.CDLL(str(LIBRARY))
        fn = lib.paged_attention_hist
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.paged_attention_hist_int8
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.paged_attention_smem_bytes
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
        self._lib = lib
        self.build_seconds = time.monotonic() - t0

    def __call__(self, q, k_cache, v_cache, layer: int, page_table,
                 hist_lens, q_per_kv: int):
        """Flash triple over the cache-resident history of CUDA tensors:
        (acc [B,Nkv,qpk,D], l [B,Nkv,qpk,1], m [B,Nkv,qpk,1]), fp32.
        k_cache/v_cache are both bf16 tensors or both ``QuantKV``."""
        quant = isinstance(k_cache, QuantKV)
        _check(isinstance(v_cache, QuantKV) == quant,
               "k_cache and v_cache must both be bf16 or both int8")
        if quant:
            k_data, v_data = k_cache.data, v_cache.data
            scales = [("k_cache.scale", k_cache.scale),
                      ("v_cache.scale", v_cache.scale)]
        else:
            k_data, v_data, scales = k_cache, v_cache, []
        b, nh, d = q.shape
        L, nkv, num_pages, page, d_cache = k_data.shape
        qpk = int(q_per_kv)
        tensors = [("q", q), ("k_cache", k_data), ("v_cache", v_data),
                   *scales, ("page_table", page_table),
                   ("hist_lens", hist_lens)]
        _check(all(t.is_cuda for _, t in tensors),
               "all inputs must be CUDA tensors")
        _check(len({t.device for _, t in tensors}) == 1,
               "all inputs must be on one device")
        _check(q.dtype == torch.bfloat16, "q must be bfloat16")
        if quant:
            _check(k_data.dtype == v_data.dtype == torch.int8,
                   "int8 cache data must be int8")
            _check(all(s.dtype == torch.float32 for _, s in scales),
                   "int8 cache scales must be float32")
            _check(all(s.shape == k_data.shape[:-1] for _, s in scales),
                   f"int8 cache scales must have shape "
                   f"{tuple(k_data.shape[:-1])}")
        else:
            _check(k_data.dtype == v_data.dtype == torch.bfloat16,
                   "q and the caches must be bfloat16")
        _check(page_table.dtype == hist_lens.dtype == torch.int32,
               "page_table and hist_lens must be int32")
        _check(d in HEAD_DIMS and d_cache == d,
               f"head_dim {d} (cache {d_cache}) not in {HEAD_DIMS}")
        _check(1 <= qpk <= MAX_QPK and nh == nkv * qpk,
               f"{nh} query heads / {nkv} kv heads / q_per_kv {qpk} "
               f"unsupported (q_per_kv <= {MAX_QPK})")
        _check(v_data.shape == k_data.shape, "k/v cache shapes differ")
        _check(page_table.dim() == 2 and page_table.shape[0] == b
               and hist_lens.shape == (b,), "page_table/hist_lens shape")
        _check(0 <= layer < L, f"layer {layer} outside [0, {L})")
        for name, t in tensors:
            _check(t.is_contiguous(), f"{name} must be contiguous")
        for name, t in tensors[:3]:
            _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
        for name, t in scales:
            _check(t.data_ptr() % 4 == 0, f"{name} must be 4-byte aligned")
        self.build()
        maxp = page_table.shape[1]
        pps, splits = split_plan(maxp, page)
        # One allocation: the returned triple, then the partial triples'
        # scratch (part_acc [B,Nkv,S,qpk,D], part_m, part_l [B,Nkv,S,qpk]).
        n = b * nkv * qpk
        buf = torch.empty(n * (d + 2) * (1 + splits), dtype=torch.float32,
                          device=q.device)
        acc = buf[:n * d].view(b, nkv, qpk, d)
        m = buf[n * d:n * (d + 1)].view(b, nkv, qpk, 1)
        l = buf[n * (d + 1):n * (d + 2)].view(b, nkv, qpk, 1)
        part_acc = buf.data_ptr() + 4 * n * (d + 2)
        part_m = part_acc + 4 * n * splits * d
        part_l = part_m + 4 * n * splits
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ints = (b, nkv, qpk, num_pages, page, d, maxp, int(layer), pps,
                splits, stream)
        outs = (page_table.data_ptr(), hist_lens.data_ptr(), acc.data_ptr(),
                m.data_ptr(), l.data_ptr(), part_acc, part_m, part_l)
        if quant:
            name = "paged_attention_hist_int8"
            err = self._lib.paged_attention_hist_int8(
                q.data_ptr(), k_data.data_ptr(), v_data.data_ptr(),
                k_cache.scale.data_ptr(), v_cache.scale.data_ptr(), *outs,
                *ints)
        else:
            name = "paged_attention_hist"
            err = self._lib.paged_attention_hist(
                q.data_ptr(), k_data.data_ptr(), v_data.data_ptr(), *outs,
                *ints)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        tally = getattr(self._local, "tally", None)
        if tally is not None:
            tally[int(quant)] += 1
        elif quant:
            self.launches_int8 += 1
        else:
            self.launches += 1
        return acc, l, m

    def smem_bytes(self, head_dim: int, quant: bool) -> int:
        """Dynamic shared memory of one partial-kernel block, in bytes."""
        self.build()
        return self._lib.paged_attention_smem_bytes(head_dim, int(quant))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged attention kernel: {msg}")


KERNEL = PagedAttentionKernel()


def _gather_fp32(cache, layer: int, pt: torch.Tensor) -> torch.Tensor:
    """Pages ``pt`` [B, maxP] of one layer as fp32 [Nkv, B, maxP*page, D];
    an int8 pool is dequantized in fp32, as the TPU kernel does."""
    b, maxp = pt.shape
    nkv, page, d = cache.shape[1], cache.shape[3], cache.shape[4]
    if isinstance(cache, QuantKV):
        out = (cache.data[layer][:, pt].float()
               * cache.scale[layer][:, pt][..., None])
    else:
        out = cache[layer][:, pt].float()
    return out.reshape(nkv, b, maxp * page, d)


def hist_flash_plain(q, k_cache, v_cache, layer: int, page_table,
                     hist_lens, q_per_kv: int):
    """Plain torch version of the kernel: the same flash triple, from a
    gather of every page-table entry (masked past hist_lens), bf16 or int8
    pool. A row with no history gives m = NEG_INF, l = 0, acc = 0, as the
    kernel does."""
    b, nh, d = q.shape
    nkv, page = k_cache.shape[1], k_cache.shape[3]
    maxp = page_table.shape[1]
    qpk = int(q_per_kv)
    pt = page_table.long()
    k = _gather_fp32(k_cache, layer, pt)
    v = _gather_fp32(v_cache, layer, pt)
    qg = q.reshape(b, nkv, qpk, d).float()
    s = torch.einsum("bngd,nbld->bngl", qg, k) / (d ** 0.5)
    valid = (torch.arange(maxp * page, device=q.device)[None, :]
             < hist_lens.long()[:, None])[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bngl,nbld->bngd", p, v)
    return acc, l, m


def hist_flash_bytes(hist_lens, num_heads: int, k_cache) -> int:
    """Bytes one kernel launch must move, each once: the live K and V rows
    (bf16, or int8 values plus their f32 scale), q [B, num_heads, D] in
    bf16, the page-table entries of the live pages, hist_lens and the fp32
    triple. ``hist_lens`` is a host array or a tensor (a device tensor is
    read back, which waits for the device)."""
    h = torch.as_tensor(hist_lens).long().cpu()
    b = h.numel()
    nkv, page, d = k_cache.shape[1], k_cache.shape[3], k_cache.shape[4]
    row = d + KV_SCALE_BYTES if isinstance(k_cache, QuantKV) else 2 * d
    live_pages = int(((h + page - 1) // page).sum())
    return (2 * int(h.sum()) * nkv * row + b * num_heads * d * 2
            + live_pages * 4 + b * 4 + b * num_heads * (d + 2) * 4)


def hist_flash(q, k_cache, v_cache, layer: int, page_table, hist_lens,
               q_per_kv: int):
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if q.device.type == "cpu":
        return hist_flash_plain(q, k_cache, v_cache, layer, page_table,
                                hist_lens, q_per_kv)
    return KERNEL(q, k_cache, v_cache, layer, page_table, hist_lens,
                  q_per_kv)


def _merge_extra(q, num, l_star, m_s, k_extra, v_extra, s_mask, q_per_kv):
    """Flash-merge the history triple with explicit extra columns (window
    buffer tokens and/or the current token). k_extra/v_extra [b,nkv,J,d];
    s_mask broadcastable to [b,nkv,qpk,J] bool (True = valid)."""
    b, nh, d = q.shape
    nkv = k_extra.shape[1]
    qg = q.reshape(b, nkv, q_per_kv, d).float()
    s = torch.einsum("bngd,bnjd->bngj", qg, k_extra.float()) / (d ** 0.5)
    s = torch.where(s_mask, s, NEG_INF)
    m_b = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m_b)
    l_b = p.sum(dim=-1, keepdim=True)
    acc_b = torch.einsum("bngj,bnjd->bngd", p, v_extra.float())
    m_t = torch.maximum(m_s, m_b)
    w_h = torch.exp(m_s - m_t)
    w_b = torch.exp(m_b - m_t)
    out = ((num * w_h + acc_b * w_b)
           / torch.clamp(l_star * w_h + l_b * w_b, min=1e-30))
    return out.to(q.dtype).reshape(b, nh, d)


def paged_decode_attention(q, k_cache, v_cache, layer: int, page_table,
                           hist_lens, k_self, v_self, q_per_kv: int):
    """Counterpart of ``paged_decode_attention_pallas``: q [B,Nh,D];
    k_cache/v_cache the full stacked pool [L,Nkv,P,page,D]; layer an int;
    page_table [B,maxP] int32; hist_lens [B] int32 (cache-resident
    tokens); k_self/v_self [B,Nkv,D], the new token's K/V, merged as one
    extra column. Returns [B,Nh,D]."""
    num, l_star, m_s = hist_flash(q, k_cache, v_cache, layer, page_table,
                                  hist_lens, q_per_kv)
    mask = torch.ones((1, 1, 1, 1), dtype=torch.bool, device=q.device)
    return _merge_extra(q, num, l_star, m_s, k_self[:, :, None, :],
                        v_self[:, :, None, :], mask, q_per_kv)


def paged_window_attention(q, k_cache, v_cache, layer: int, page_table,
                           hist_lens, k_win, v_win, m: int, k_self, v_self,
                           q_per_kv: int):
    """Counterpart of ``paged_window_attention_pallas``: the history
    kernel plus the in-window buffer k_win/v_win [Nkv,B,M,D] (cols j < m
    valid) and the current token's column."""
    b = q.shape[0]
    M = k_win.shape[2]
    num, l_star, m_s = hist_flash(q, k_cache, v_cache, layer, page_table,
                                  hist_lens, q_per_kv)
    k_extra = torch.cat([k_win.transpose(0, 1), k_self[:, :, None, :]], dim=2)
    v_extra = torch.cat([v_win.transpose(0, 1), v_self[:, :, None, :]], dim=2)
    col_mask = (torch.arange(M + 1, device=q.device) < m) \
        | (torch.arange(M + 1, device=q.device) == M)
    return _merge_extra(q, num, l_star, m_s, k_extra, v_extra,
                        col_mask[None, None, None, :], q_per_kv)


def fold_rows(x: torch.Tensor, s: int) -> torch.Tensor:
    """Each row of ``x`` [B, ...] repeated ``s`` times, as a contiguous
    [B*s, ...] (row b*s + j is x[b]; the kernel takes contiguous tables):
    an expand and a copy, with no host sync."""
    return x[:, None].expand(x.shape[0], s, *x.shape[1:]).reshape(
        x.shape[0] * s, *x.shape[1:]).contiguous()


def paged_verify_attention(q, k_cache, v_cache, layer: int, page_table,
                           hist_lens, k_win, v_win, wlen, k_blk, v_blk,
                           q_per_kv: int):
    """Attention of a speculative verify block, the kernel route: q
    [B,S,Nh,D] for S positions per slot; the paged history page_table
    [B,maxP] up to hist_lens [B] (cache-resident tokens, the same for every
    position of a slot); this window's earlier columns k_win/v_win
    [Nkv,B,W,D] (cols < wlen [B] valid); the block's own k_blk/v_blk
    [B,S,Nkv,D], causal within the block. Returns [B,S,Nh,D].

    The S verify rows fold into the kernel's batch: one launch over B*S
    rows, each row's page-table row and history length repeated, so each
    slot's pages are read S times. The window and block columns then merge
    as extra columns (``_merge_extra``)."""
    b, s, nh, d = q.shape
    w = k_win.shape[2]
    qf = q.reshape(b * s, nh, d)
    num, l_star, m_s = hist_flash(qf, k_cache, v_cache, layer,
                                  fold_rows(page_table, s),
                                  fold_rows(hist_lens, s), q_per_kv)
    k_extra = torch.cat([k_win.transpose(0, 1), k_blk.transpose(1, 2)], dim=2)
    v_extra = torch.cat([v_win.transpose(0, 1), v_blk.transpose(1, 2)], dim=2)
    cols = torch.arange(w + s, device=q.device)
    row_j = torch.arange(s, device=q.device)
    # Row (b, j): window cols < wlen[b], block col w + t for t <= j.
    win_ok = (cols[None, :] < wlen.long()[:, None])[:, None, :]   # [B,1,W+S]
    blk_ok = ((cols[None, :] >= w)
              & (cols[None, :] - w <= row_j[:, None]))[None]       # [1,S,W+S]
    mask = (win_ok | blk_ok).reshape(b * s, 1, 1, w + s)
    out = _merge_extra(qf, num, l_star, m_s, fold_rows(k_extra, s),
                       fold_rows(v_extra, s), mask, q_per_kv)
    return out.reshape(b, s, nh, d)
