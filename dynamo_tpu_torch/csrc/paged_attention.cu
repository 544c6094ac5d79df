// Paged decode attention over the cache-resident history, for Hopper (sm_90a).
//
// Replaces dynamo_tpu/engine/attention.py::_decode_kernel (driven there by
// _hist_flash_pallas) in both its variants: the bf16 pool
// (paged_attention_hist) and the int8 pool with per-token f32 scales,
// _decode_kernel(quantized=True) (paged_attention_hist_int8). For each
// (sequence, kv-head) it walks the sequence's page table over its hist_len
// cached tokens and runs an online softmax for the q_per_kv query heads that
// share the kv head. It returns the TPU kernel's flash triple: unnormalised
// acc [B, Nkv, qpk, D] and m, l [B, Nkv, qpk] in fp32. The caller merges the
// in-window columns and the current token's column in torch
// (attention.py::_merge_extra).
//
// Bound: device-memory bytes. Every live K and V row is read once: 2 *
// hist_len * D * 2 bytes per (sequence, kv-head) for bf16 and 2 * hist_len *
// (D + 4) for int8. At B=32, Nkv=8, D=128 and history 2048 that is, with q,
// the page ids and the outputs, 269 MB or 0.0804 ms at the H100's 3.35 TB/s
// (bf16), and 139 MB or 0.0416 ms (int8). The arithmetic is 4 * qpk flops
// per bf16 byte, far under the ~295 flops/byte where the H100's bf16 tensor
// cores would become the limit. The time is therefore set by how many bytes
// are in flight and how little latency each chunk adds; the design:
//
// 1. Split-K over pages (flash-decoding). A partial kernel runs one block
//    per (sequence, kv-head, split); split s covers pages [s*pps, (s+1)*pps)
//    of the row (pps and the split count S come from the wrapper's
//    split_plan, from shapes only, so hist_lens is never read on the host).
//    A few live rows then still give hundreds of blocks on 132 SMs, and no
//    block walks a long history serially. A split past its row's history
//    writes the empty triple and exits. The partial triples go to fp32
//    scratch the wrapper allocates; a combine kernel, one block per
//    (sequence, kv-head), flash-merges the live splits into the outputs.
// 2. An asynchronous ring. Each block stages 64-token chunks of K and V
//    (and, for int8, each token's two scales) with cp.async into a ring of
//    kStages chunk buffers: kStages - 1 chunks are in flight while one is
//    computed, and the only block barrier per chunk is the ring's own. The
//    split's page-table entries are read once, into shared memory. Rows are
//    padded by 16 bytes so that ldmatrix reads them without bank conflicts.
//    Tokens past the history are zero-filled by the copy (src-size 0), not
//    read.
// 3. Tensor-core dots: mma.sync.m16n8k16 with bf16 inputs and fp32
//    accumulation. Each of the 4 warps owns 16 tokens of a chunk and keeps
//    its own m, l and acc in registers; the warps are merged once, at the end
//    of the split. Scores S = Q K^T take the qpk <= 8 query heads as the M
//    rows (K rows through ldmatrix); q is not pre-scaled, so the products of
//    bf16 values are exact and the fp32 score is scaled by 1/sqrt(D). For
//    O += P V (V through ldmatrix.trans) each PV weight is split into a bf16
//    high part and a bf16 remainder, which fill the M rows 0-7 and 8-15 of
//    one product: the weights keep ~16 significant bits at no extra mma,
//    where rows 8-15 would otherwise be padding.
// 4. int8: values in -127..127 are exact in bf16. Each warp converts its 16
//    int8 K and V rows of the chunk into a warp-private bf16 tile, then runs
//    the bf16 path's ldmatrix/mma code on it. The scales fold per token as
//    in the TPU kernel's fp32 dequantise-then-dot, rounded differently by a
//    few fp32 ulps: score_t = k_scale[t] * (q . k_t) / sqrt(D), the PV weight
//    of token t is p_t * v_scale[t], and l sums the bare p_t.
//
// Why mma.sync and not wgmma: wgmma takes 64-row tiles, and a kv-head has at
// most 8 query rows; the products are a small share of the time, which the
// bytes and their latency set.
//
// Against the five things that set the time of a one-block-per-(sequence,
// kv-head) walk: too few blocks for a few live rows (split-K), loads that do
// not overlap compute (the ring), block barriers between phases (per-warp
// softmax state, one barrier per chunk), one shuffle reduction per (token,
// head) score and a serial per-element PV loop (tensor-core dots for both).
//
// Offsets into the stacked [L, Nkv, P, page, D] pool and its [L, Nkv, P,
// page] scales are int64: a full-size pool holds more than 2^31 elements.
// The layer is an index into that pool; nothing is sliced or copied. A
// history longer than its page-table row is clamped to the row's maxp * page
// tokens. Masked scores are -1e30, and a masked token's weight is set to 0
// by a select, so neither stale nor zero-filled rows reach the sums. A row
// with no history returns m = -1e30, l = 0, acc = 0, which the merge weights
// to zero.
//
// Not done here: int8 rows converted in registers straight into mma
// fragments (the shared-memory tile costs the int8 variant time per byte);
// the window and self columns are still merged in torch, and the decode
// step around the kernel is eager PyTorch launched from Python (CUDA graphs
// around the window are host-side work for a later change).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpTokens = 16;                   // one mma k-step of PV
constexpr int kChunk = kWarps * kWarpTokens;      // tokens staged per stage
constexpr int kStages = 2;                        // ring depth
constexpr int kMaxQpk = 8;                        // query heads per kv head
constexpr int kMaxSplitPages = 256;               // page ids staged per split
constexpr int kPad = 16;                          // bytes added to each row
constexpr float kNegInf = -1e30f;

template <bool kQuant>
using Elem = std::conditional_t<kQuant, int8_t, __nv_bfloat16>;

// Shared-memory layout of the partial kernel, in bytes.
template <int D, bool kQuant>
struct Smem {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(Elem<kQuant>)) + kPad;
  static constexpr int kTileRowBytes = D * 2 + kPad;  // bf16 rows (ldmatrix)
  static constexpr int kStageBytes = 2 * kChunk * kRowBytes;  // K then V
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kScales = kQuant ? kStages * 2 * kChunk * 4 : 0;
  static constexpr int kPages = kMaxSplitPages * 4;
  // int8: each warp's bf16 K and V tiles of its 16 tokens.
  static constexpr int kTiles = kQuant ? kWarps * 2 * kWarpTokens * kTileRowBytes : 0;
  static constexpr int kScaleOff = kRing;
  static constexpr int kPageOff = kScaleOff + kScales;
  static constexpr int kTileOff = kPageOff + kPages;
  static constexpr int kTotal = kTileOff + kTiles;
  // The end-of-split merge reuses the ring: m, l and acc of every warp.
  static constexpr int kMerge = (2 * kWarps * kMaxQpk + kWarps * kMaxQpk * D) * 4;
  static_assert(kMerge <= kRing, "merge buffers must fit in the ring");
  static_assert(kRowBytes % 16 == 0 && kTileRowBytes % 16 == 0, "16-byte rows");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes < 16 zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b for one m16n8k16 tile, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// 16 int8 values -> 16 bf16 values, exactly (|x| <= 128) and without the
// slow int-to-float conversion: the byte u = x + 128 becomes the low byte of
// the float 2^23 + u, one subtraction leaves x, and an integer that small is
// a bf16 already, so its float's upper half is its bf16.
__device__ __forceinline__ void int8x16_to_bf16(const uint4& in, uint4 (&out)[2]) {
  const uint32_t* x = reinterpret_cast<const uint32_t*>(&in);
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = x[i] ^ 0x80808080u;  // each byte + 128
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + j)) - 8388736.f;
    o[2 * i] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u);
    o[2 * i + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u);
  }
}

// Grid (B, Nkv, S). Block (b, h, s) writes the flash triple of the tokens of
// row b's pages [s*pps, (s+1)*pps) that lie in its clamped history into
// part_acc [B, Nkv, S, qpk, D] and part_m, part_l [B, Nkv, S, qpk].
template <int D, bool kQuant>
__global__ void __launch_bounds__(kThreads)
hist_flash_partial(const __nv_bfloat16* __restrict__ q,  // [B, Nkv*qpk, D]
                   const Elem<kQuant>* __restrict__ k_cache,
                   const Elem<kQuant>* __restrict__ v_cache,
                   const float* __restrict__ k_scale,  // [L, Nkv, P, page] (int8)
                   const float* __restrict__ v_scale,
                   const int* __restrict__ page_table,  // [B, maxp]
                   const int* __restrict__ hist_lens,   // [B]
                   float* __restrict__ part_acc, float* __restrict__ part_m,
                   float* __restrict__ part_l, int nkv, int qpk, int num_pages,
                   int page_size, int maxp, int layer, int pps) {
  using T = Elem<kQuant>;
  using L = Smem<D, kQuant>;
  constexpr int kVec = 16 / sizeof(T);         // values per 16-byte copy
  constexpr int kRowVecs = D / kVec;           // copies per token row
  constexpr int kCopies = kChunk * kRowVecs / kThreads;  // per thread, K (and V)
  constexpr int kKSteps = D / 16;              // mma k-steps of Q K^T
  constexpr int kDTiles = D / 8;               // mma n-tiles of P V
  static_assert(kCopies >= 1 && kCopies * kThreads == kChunk * kRowVecs, "copy split");
  static_assert(kThreads == 2 * kChunk, "one scale copy per thread");

  extern __shared__ __align__(16) unsigned char smem[];
  int* page_ids = reinterpret_cast<int*>(smem + L::kPageOff);

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // query head (mma row) of this lane
  const int c4 = lane & 3;  // lane within its row's group of 4
  const int splits = gridDim.z;

  const int hist = min(hist_lens[b], maxp * page_size);
  const int split_tokens = pps * page_size;
  const int t0 = s * split_tokens;
  const int t_end = min(hist, t0 + split_tokens);
  const int64_t part = (static_cast<int64_t>(b) * nkv + h) * splits + s;

  if (t0 >= t_end) {  // past the history: the empty triple
    for (int o = tid; o < qpk * D; o += kThreads) part_acc[part * qpk * D + o] = 0.f;
    if (tid < qpk) {
      part_m[part * qpk + tid] = kNegInf;
      part_l[part * qpk + tid] = 0.f;
    }
    return;
  }

  // The split's live page ids, read once.
  const int live_pages = (t_end - t0 + page_size - 1) / page_size;
  const int* pt = page_table + static_cast<int64_t>(b) * maxp + static_cast<int64_t>(s) * pps;
  for (int i = tid; i < live_pages; i += kThreads) page_ids[i] = pt[i];
  __syncthreads();

  const int64_t head_pages = (static_cast<int64_t>(layer) * nkv + h) * num_pages;
  const int n_chunks = (t_end - t0 + kChunk - 1) / kChunk;

  // Stage chunk c (tokens t0 + c*kChunk ...) into ring stage st.
  auto stage_chunk = [&](int c, int st) {
    unsigned char* kst = smem + st * L::kStageBytes;
    unsigned char* vst = kst + kChunk * L::kRowBytes;
    const int c0 = t0 + c * kChunk;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int idx = tid + i * kThreads;
      const int t = idx / kRowVecs;
      const int col = idx % kRowVecs;
      const int tok = c0 + t;
      int64_t off = 0;
      int bytes = 0;
      if (tok < t_end) {
        const int rel = tok - t0;
        const int64_t pid = page_ids[rel / page_size];
        off = ((head_pages + pid) * page_size + rel % page_size) * D + col * kVec;
        bytes = 16;
      }
      cp_async16(kst + t * L::kRowBytes + col * 16, k_cache + off, bytes);
      cp_async16(vst + t * L::kRowBytes + col * 16, v_cache + off, bytes);
    }
    if constexpr (kQuant) {
      // Threads [0, kChunk) copy the chunk's K scales, the rest its V scales.
      float* sc = reinterpret_cast<float*>(smem + L::kScaleOff) + st * 2 * kChunk;
      const int t = tid % kChunk;
      const int tok = c0 + t;
      int64_t off = 0;
      int bytes = 0;
      if (tok < t_end) {
        const int rel = tok - t0;
        off = (head_pages + page_ids[rel / page_size]) * page_size + rel % page_size;
        bytes = 4;
      }
      cp_async4(sc + tid, (tid < kChunk ? k_scale : v_scale) + off, bytes);
    }
  };

  // This lane's query row as mma A fragments; rows 8-15 are zero.
  uint32_t qa[kKSteps][2];
  {
    const __nv_bfloat16* qh = q + ((static_cast<int64_t>(b) * nkv + h) * qpk + g) * D;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      if (g < qpk) {
        qa[kk][0] = *reinterpret_cast<const uint32_t*>(qh + kk * 16 + 2 * c4);
        qa[kk][1] = *reinterpret_cast<const uint32_t*>(qh + kk * 16 + 8 + 2 * c4);
      } else {
        qa[kk][0] = 0u;
        qa[kk][1] = 0u;
      }
    }
  }
  const float inv_sqrt_d = rsqrtf(static_cast<float>(D));

  // Per-warp softmax state of row g: m is uniform over the row's 4 lanes,
  // l is this lane's share. o[n][0..1] are row g's P_hi V sums and o[n][2..3]
  // its P_lo V sums, at d = 8n + 2*c4 + {0, 1}.
  float m_run = kNegInf;
  float l_run = 0.f;
  float o[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_chunks) stage_chunk(st, st);
    cp_async_commit();
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c is visible; stage (c - 1) % kStages is free
    if (c + kStages - 1 < n_chunks) stage_chunk(c + kStages - 1, (c + kStages - 1) % kStages);
    cp_async_commit();

    const int st = c % kStages;
    const int wt0 = t0 + c * kChunk + warp * kWarpTokens;  // this warp's first token
    if (wt0 >= t_end) continue;  // warp-uniform: no live token in this slice
    const unsigned char* kst = smem + st * L::kStageBytes + warp * kWarpTokens * L::kRowBytes;
    const unsigned char* vst = kst + kChunk * L::kRowBytes;
    int row_bytes = L::kRowBytes;
    if constexpr (kQuant) {
      // Convert this warp's 16 K and V rows to bf16 tiles.
      unsigned char* kt = smem + L::kTileOff + warp * 2 * kWarpTokens * L::kTileRowBytes;
      unsigned char* vt = kt + kWarpTokens * L::kTileRowBytes;
      constexpr int kRowIn = D / 16;  // 16-byte int8 vectors per row
#pragma unroll
      for (int i = lane; i < kWarpTokens * kRowIn; i += 32) {
        const int t = i / kRowIn;
        const int col = i % kRowIn;
        uint4 kb[2], vb[2];
        int8x16_to_bf16(*reinterpret_cast<const uint4*>(kst + t * L::kRowBytes + col * 16), kb);
        int8x16_to_bf16(*reinterpret_cast<const uint4*>(vst + t * L::kRowBytes + col * 16), vb);
        uint4* kd = reinterpret_cast<uint4*>(kt + t * L::kTileRowBytes + col * 32);
        uint4* vd = reinterpret_cast<uint4*>(vt + t * L::kTileRowBytes + col * 32);
        kd[0] = kb[0];
        kd[1] = kb[1];
        vd[0] = vb[0];
        vd[1] = vb[1];
      }
      __syncwarp();
      kst = kt;
      vst = vt;
      row_bytes = L::kTileRowBytes;
    }

    // Scores of row g against the warp's tokens 8j + 2*c4 + {0, 1}.
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    {
      const int mat = lane >> 3;
      const unsigned char* kp =
          kst + ((mat >> 1) * 8 + (lane & 7)) * row_bytes + (mat & 1) * 16;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kp + kk * 32);
        const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
        mma_bf16(sc[0], a, kb[0], kb[1]);
        mma_bf16(sc[1], a, kb[2], kb[3]);
      }
    }

    // Online softmax over the slice; w is the PV weight (p, or p * v_scale).
    const float* ks_s = nullptr;
    const float* vs_s = nullptr;
    if constexpr (kQuant) {
      ks_s = reinterpret_cast<const float*>(smem + L::kScaleOff) + st * 2 * kChunk +
             warp * kWarpTokens;
      vs_s = ks_s + kChunk;
    }
    float sv[4];
    bool valid[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = 8 * j + 2 * c4 + e;  // token within the warp's slice
        valid[2 * j + e] = wt0 + t < t_end;
        float x = sc[j][e] * inv_sqrt_d;
        if constexpr (kQuant) x *= ks_s[t];
        sv[2 * j + e] = valid[2 * j + e] ? x : kNegInf;
      }
    }
    float mx = fmaxf(fmaxf(sv[0], sv[1]), fmaxf(sv[2], sv[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = __expf(m_run - m_new);
    float w[4];
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = valid[i] ? __expf(sv[i] - m_new) : 0.f;
      psum += p;
      w[i] = p;
      if constexpr (kQuant) w[i] = valid[i] ? p * vs_s[8 * (i >> 1) + 2 * c4 + (i & 1)] : 0.f;
    }
    l_run = l_run * alpha + psum;
    m_run = m_new;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      o[n][0] *= alpha;
      o[n][1] *= alpha;
      o[n][2] *= alpha;
      o[n][3] *= alpha;
    }

    // A fragment of P: rows 0-7 the weights' bf16 high parts, rows 8-15 the
    // bf16 remainders, at k = tokens 2*c4 + {0, 1} and 8 + 2*c4 + {0, 1}.
    uint32_t pa[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const __nv_bfloat16 h0 = __float2bfloat16_rn(w[2 * j]);
      const __nv_bfloat16 h1 = __float2bfloat16_rn(w[2 * j + 1]);
      const __nv_bfloat16 r0 = __float2bfloat16_rn(w[2 * j] - __bfloat162float(h0));
      const __nv_bfloat16 r1 = __float2bfloat16_rn(w[2 * j + 1] - __bfloat162float(h1));
      pa[2 * j] = pack_bf16(h0, h1);
      pa[2 * j + 1] = pack_bf16(r0, r1);
    }
    {
      const int mat = lane >> 3;
      const unsigned char* vp =
          vst + ((mat & 1) * 8 + (lane & 7)) * row_bytes + (mat >> 1) * 16;
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vp + dp * 32);
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // Merge the warps once, in shared memory (the ring is free after this).
  cp_async_wait<0>();
  __syncthreads();
  float* red_m = reinterpret_cast<float*>(smem);   // [kWarps][kMaxQpk]
  float* red_l = red_m + kWarps * kMaxQpk;          // [kWarps][kMaxQpk]
  float* red_acc = red_l + kWarps * kMaxQpk;        // [kWarps][kMaxQpk][D]
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  if (c4 == 0) {
    red_m[warp * kMaxQpk + g] = m_run;
    red_l[warp * kMaxQpk + g] = l_run;
  }
  float* ra = red_acc + (warp * kMaxQpk + g) * D + 2 * c4;
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    *reinterpret_cast<float2*>(ra + 8 * n) = make_float2(o[n][0] + o[n][2], o[n][1] + o[n][3]);
  }
  __syncthreads();
  for (int idx = tid; idx < qpk * D; idx += kThreads) {
    const int gg = idx / D;
    const int d = idx % D;
    float mm = kNegInf;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) mm = fmaxf(mm, red_m[ww * kMaxQpk + gg]);
    float a = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww)
      a += red_acc[(ww * kMaxQpk + gg) * D + d] * __expf(red_m[ww * kMaxQpk + gg] - mm);
    part_acc[part * qpk * D + idx] = a;
    if (d == 0) {
      float ls = 0.f;
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww)
        ls += red_l[ww * kMaxQpk + gg] * __expf(red_m[ww * kMaxQpk + gg] - mm);
      part_m[part * qpk + gg] = mm;
      part_l[part * qpk + gg] = ls;
    }
  }
}

// Grid (B, Nkv). Flash-merges the live splits of (b, h) into the outputs:
// acc unnormalised against the final m, and m, l. A row with no history
// gets m = -1e30, l = 0, acc = 0.
__global__ void __launch_bounds__(kThreads)
hist_flash_combine(const float* __restrict__ part_acc, const float* __restrict__ part_m,
                   const float* __restrict__ part_l, const int* __restrict__ hist_lens,
                   float* __restrict__ acc_out, float* __restrict__ m_out,
                   float* __restrict__ l_out, int nkv, int qpk, int head_dim,
                   int page_size, int maxp, int pps, int splits) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int hist = min(hist_lens[b], maxp * page_size);
  const int split_tokens = pps * page_size;
  const int live = min(splits, (hist + split_tokens - 1) / split_tokens);
  const int64_t row = (static_cast<int64_t>(b) * nkv + h) * qpk;  // output row of head 0
  const int64_t part0 = (static_cast<int64_t>(b) * nkv + h) * splits;
  for (int idx = threadIdx.x; idx < qpk * head_dim; idx += blockDim.x) {
    const int g = idx / head_dim;
    float mm = kNegInf;
    for (int s = 0; s < live; ++s) mm = fmaxf(mm, part_m[(part0 + s) * qpk + g]);
    float a = 0.f;
    float l = 0.f;
    for (int s = 0; s < live; ++s) {
      const int64_t p = (part0 + s) * qpk + g;
      const float wgt = __expf(part_m[p] - mm);
      a += part_acc[(part0 + s) * qpk * head_dim + idx] * wgt;
      l += part_l[p] * wgt;
    }
    acc_out[row * head_dim + idx] = a;
    if (idx % head_dim == 0) {
      m_out[row + g] = mm;
      l_out[row + g] = l;
    }
  }
}

template <int D, bool kQuant>
cudaError_t launch_d(dim3 grid, cudaStream_t st, const __nv_bfloat16* q, const void* k_cache,
                     const void* v_cache, const float* k_scale, const float* v_scale,
                     const int* page_table, const int* hist_lens, float* part_acc,
                     float* part_m, float* part_l, int nkv, int qpk, int num_pages,
                     int page_size, int maxp, int layer, int pps) {
  constexpr int kBytes = Smem<D, kQuant>::kTotal;
  static const cudaError_t attr = cudaFuncSetAttribute(
      hist_flash_partial<D, kQuant>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return attr;
  hist_flash_partial<D, kQuant><<<grid, kThreads, kBytes, st>>>(
      q, static_cast<const Elem<kQuant>*>(k_cache), static_cast<const Elem<kQuant>*>(v_cache),
      k_scale, v_scale, page_table, hist_lens, part_acc, part_m, part_l, nkv, qpk, num_pages,
      page_size, maxp, layer, pps);
  return cudaGetLastError();
}

template <bool kQuant>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
           const void* v_scale, const void* page_table, const void* hist_lens, void* acc,
           void* m, void* l, void* part_acc, void* part_m, void* part_l, int batch, int nkv,
           int qpk, int num_pages, int page_size, int head_dim, int maxp, int layer, int pps,
           int splits, void* stream) {
  if (batch < 1 || nkv < 1 || qpk < 1 || qpk > kMaxQpk || page_size < 1 || maxp < 1 ||
      nkv > 65535 || pps < 1 || pps > kMaxSplitPages || splits < 1 || splits > 65535 ||
      static_cast<int64_t>(splits) * pps < maxp ||
      static_cast<int64_t>(splits - 1) * pps >= maxp)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(batch, nkv, splits);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* ptb = static_cast<const int*>(page_table);
  const auto* hl = static_cast<const int*>(hist_lens);
  auto* pa = static_cast<float*>(part_acc);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  cudaError_t err;
  switch (head_dim) {
    case 32:
      err = launch_d<32, kQuant>(grid, st, qb, k_cache, v_cache, ks, vs, ptb, hl, pa, pm, pl,
                                 nkv, qpk, num_pages, page_size, maxp, layer, pps);
      break;
    case 64:
      err = launch_d<64, kQuant>(grid, st, qb, k_cache, v_cache, ks, vs, ptb, hl, pa, pm, pl,
                                 nkv, qpk, num_pages, page_size, maxp, layer, pps);
      break;
    case 128:
      err = launch_d<128, kQuant>(grid, st, qb, k_cache, v_cache, ks, vs, ptb, hl, pa, pm, pl,
                                  nkv, qpk, num_pages, page_size, maxp, layer, pps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  hist_flash_combine<<<dim3(batch, nkv), kThreads, 0, st>>>(
      pa, pm, pl, hl, static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
      nkv, qpk, head_dim, page_size, maxp, pps, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes). Each entry point launches the partial and
// the combine kernel on `stream`, does not synchronise, allocates nothing,
// and returns the first non-zero cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for an unsupported shape. part_acc [B, Nkv, S, qpk,
// D], part_m and part_l [B, Nkv, S, qpk] are fp32 scratch of the caller;
// pps is pages per split, S = splits = ceil(maxp / pps).

// Dynamic shared memory of the partial kernel for one head dim and pool
// (quant 0: bf16, 1: int8), in bytes; 0 for an unsupported head dim.
extern "C" int paged_attention_smem_bytes(int head_dim, int quant) {
  switch (head_dim * 2 + (quant ? 1 : 0)) {
    case 64: return Smem<32, false>::kTotal;
    case 65: return Smem<32, true>::kTotal;
    case 128: return Smem<64, false>::kTotal;
    case 129: return Smem<64, true>::kTotal;
    case 256: return Smem<128, false>::kTotal;
    case 257: return Smem<128, true>::kTotal;
    default: return 0;
  }
}

// bf16 pool: k_cache/v_cache bf16 [L, Nkv, P, page, D].
extern "C" int paged_attention_hist(const void* q, const void* k_cache, const void* v_cache,
                                    const void* page_table, const void* hist_lens, void* acc,
                                    void* m, void* l, void* part_acc, void* part_m,
                                    void* part_l, int batch, int nkv, int qpk, int num_pages,
                                    int page_size, int head_dim, int maxp, int layer, int pps,
                                    int splits, void* stream) {
  return launch<false>(q, k_cache, v_cache, nullptr, nullptr, page_table, hist_lens, acc, m, l,
                       part_acc, part_m, part_l, batch, nkv, qpk, num_pages, page_size,
                       head_dim, maxp, layer, pps, splits, stream);
}

// int8 pool: k_cache/v_cache int8 [L, Nkv, P, page, D] with f32 per-token
// scales k_scale/v_scale [L, Nkv, P, page].
extern "C" int paged_attention_hist_int8(const void* q, const void* k_cache,
                                         const void* v_cache, const void* k_scale,
                                         const void* v_scale, const void* page_table,
                                         const void* hist_lens, void* acc, void* m, void* l,
                                         void* part_acc, void* part_m, void* part_l, int batch,
                                         int nkv, int qpk, int num_pages, int page_size,
                                         int head_dim, int maxp, int layer, int pps,
                                         int splits, void* stream) {
  return launch<true>(q, k_cache, v_cache, k_scale, v_scale, page_table, hist_lens, acc, m, l,
                      part_acc, part_m, part_l, batch, nkv, qpk, num_pages, page_size,
                      head_dim, maxp, layer, pps, splits, stream);
}
