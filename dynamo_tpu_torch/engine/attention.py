"""Paged decode attention: the hand-written Hopper kernel, its plain torch
version, and the two wrappers the decode path calls.

The kernel (``csrc/paged_attention.cu``) replaces the TPU kernel
``dynamo_tpu/engine/attention.py::_decode_kernel``: one thread block per
(sequence, kv-head) reads the live history pages of one layer of the
stacked ``[L, Nkv, P, page, D]`` pool and returns the flash triple
(unnormalised acc, l, m). The wrappers then flash-merge the in-window
buffer columns ``j < m`` and the current token's column in torch
(``_merge_extra``), as the JAX wrappers do.

Which version runs follows the tensors: CPU tensors take the plain
version (that is what the CPU tests run), CUDA tensors launch the kernel
or raise. There is no fallback between the two. The kernel is compiled
with ``nvcc`` for ``sm_90a`` into ``build/`` at first use and loaded with
ctypes; nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

NEG_INF = -1e30
MAX_QPK = 8
HEAD_DIMS = (32, 64, 128)

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


class PagedAttentionKernel:
    """The compiled kernel and its launch count.

    ``launches`` goes up by one for every kernel launch and nowhere else,
    so a caller can zero it, drive a path, and read how many times that
    path ran the kernel."""

    def __init__(self):
        self.launches = 0
        self._lib = None
        self.build_log = ""
        self.build_seconds = 0.0

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
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        self._lib = lib
        self.build_seconds = time.monotonic() - t0

    def __call__(self, q, k_cache, v_cache, layer: int, page_table,
                 hist_lens, q_per_kv: int):
        """Flash triple over the cache-resident history of CUDA tensors:
        (acc [B,Nkv,qpk,D], l [B,Nkv,qpk,1], m [B,Nkv,qpk,1]), fp32."""
        b, nh, d = q.shape
        L, nkv, num_pages, page, d_cache = k_cache.shape
        qpk = int(q_per_kv)
        _check(q.is_cuda and k_cache.is_cuda and v_cache.is_cuda
               and page_table.is_cuda and hist_lens.is_cuda,
               "all inputs must be CUDA tensors")
        _check(len({t.device for t in (q, k_cache, v_cache, page_table,
                                       hist_lens)}) == 1,
               "all inputs must be on one device")
        _check(q.dtype == k_cache.dtype == v_cache.dtype == torch.bfloat16,
               "q and the caches must be bfloat16")
        _check(page_table.dtype == hist_lens.dtype == torch.int32,
               "page_table and hist_lens must be int32")
        _check(d in HEAD_DIMS and d_cache == d,
               f"head_dim {d} (cache {d_cache}) not in {HEAD_DIMS}")
        _check(1 <= qpk <= MAX_QPK and nh == nkv * qpk,
               f"{nh} query heads / {nkv} kv heads / q_per_kv {qpk} "
               f"unsupported (q_per_kv <= {MAX_QPK})")
        _check(v_cache.shape == k_cache.shape, "k/v cache shapes differ")
        _check(page_table.dim() == 2 and page_table.shape[0] == b
               and hist_lens.shape == (b,), "page_table/hist_lens shape")
        _check(0 <= layer < L, f"layer {layer} outside [0, {L})")
        for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                        ("page_table", page_table),
                        ("hist_lens", hist_lens)):
            _check(t.is_contiguous(), f"{name} must be contiguous")
        for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
            _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
        self.build()
        acc = torch.empty((b, nkv, qpk, d), dtype=torch.float32,
                          device=q.device)
        m = torch.empty((b, nkv, qpk, 1), dtype=torch.float32,
                        device=q.device)
        l = torch.empty_like(m)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = self._lib.paged_attention_hist(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            page_table.data_ptr(), hist_lens.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), b, nkv, qpk, num_pages, page,
            d, page_table.shape[1], int(layer), stream)
        if err != 0:
            raise RuntimeError(f"paged_attention_hist launch failed: "
                               f"cudaError {err}")
        self.launches += 1
        return acc, l, m


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged attention kernel: {msg}")


KERNEL = PagedAttentionKernel()


def hist_flash_plain(q, k_cache, v_cache, layer: int, page_table,
                     hist_lens, q_per_kv: int):
    """Plain torch version of the kernel: the same flash triple, from a
    gather of every page-table entry (masked past hist_lens). A row with
    no history gives m = NEG_INF, l = 0, acc = 0, as the kernel does."""
    b, nh, d = q.shape
    L, nkv, _, page, _ = k_cache.shape
    maxp = page_table.shape[1]
    qpk = int(q_per_kv)
    pt = page_table.long()
    k = k_cache[layer][:, pt].reshape(nkv, b, maxp * page, d).float()
    v = v_cache[layer][:, pt].reshape(nkv, b, maxp * page, d).float()
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
    """Bytes one kernel launch must move, each once: the live K and V rows,
    q [B, num_heads, D] in the cache's dtype, the page-table entries of the
    live pages, hist_lens and the fp32 triple. ``hist_lens`` is a host
    array or a tensor (a device tensor is read back, which waits for the
    device)."""
    h = torch.as_tensor(hist_lens).long().cpu()
    b = h.numel()
    nkv, page, d = k_cache.shape[1], k_cache.shape[3], k_cache.shape[4]
    es = k_cache.element_size()
    live_pages = int(((h + page - 1) // page).sum())
    return (2 * int(h.sum()) * nkv * d * es + b * num_heads * d * es
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
