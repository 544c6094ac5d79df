// Paged decode attention over the cache-resident history, for Hopper (sm_90a).
//
// Replaces dynamo_tpu/engine/attention.py::_decode_kernel (driven there by
// _hist_flash_pallas) in both its variants: the bf16 pool
// (paged_attention_hist) and the int8 pool with per-token scales,
// _decode_kernel(quantized=True) (paged_attention_hist_int8). One thread
// block per (sequence, kv-head) walks the sequence's page table over its
// hist_len cached tokens and runs an online softmax for the q_per_kv query
// heads that share the kv head. It returns the same flash triple as the TPU
// kernel: unnormalised acc [B, Nkv, qpk, D] and m, l [B, Nkv, qpk] in fp32.
// The caller merges the in-window columns and the current token's column in
// torch (attention.py::_merge_extra).
//
// Bound: device-memory bytes. Every live K and V row of the history is read
// once: 2 * hist_len * D * 2 bytes per (sequence, kv-head) for bf16, and
// 2 * hist_len * (D + 4) for int8 (the values plus one f32 scale per token).
// The arithmetic is 4 * qpk flops per bf16 byte, far under the ~295
// flops/byte where the H100's bf16 tensor cores would become the limit. The
// design therefore only aims to read each live row once, with 16-byte
// coalesced loads:
//   - only the ceil(hist_len / page) leading page-table entries are read; the
//     tail of the table may be page 0 or stale; hist_len is clamped to
//     maxp * page, the row's capacity;
//   - a chunk of kChunk tokens of K and V is staged in shared memory, loaded
//     with all of a thread's 16-byte loads in flight before any is stored
//     (8 bf16 or 16 int8 values per load); for int8 the chunk's 64 K and 64 V
//     scales are staged beside the rows;
//   - scores: one warp per token, lanes split D, fp32 dot + warp reduction;
//   - PV: each thread owns output (head, d) elements and reads V rows from
//     shared memory across the chunk.
// int8: the rows stay int8 in shared memory (16 KB at D=128, where an fp32
// dequantised chunk would need 64 KB, over the 48 KB of static shared
// memory). The scales fold into per-token scalars instead of dequantising
// every element: score_t = k_scale[t] * sum_d q_d * k[t, d], and the PV
// weight of token t is p_t * v_scale[t]. In exact arithmetic this is the
// TPU kernel's fp32 dequantise-then-dot; in fp32 the scale multiplies once
// after the dot instead of once per element, so the two round differently
// by a few fp32 ulps of each score and weight.
// Offsets into the stacked [L, Nkv, P, page, D] pool and its [L, Nkv, P,
// page] scales are int64: a full-size pool holds more than 2^31 elements.
// The layer is an index into that pool; no layer is ever sliced or copied.
// Masked scores are -1e30, not -inf, so exp(m - m) never becomes NaN. A row
// with no history returns m = -1e30, l = 0, acc = 0, which the merge weights
// to zero.
//
// Not done here (later PRs): split-K over pages for short batches
// (flash-decoding), cp.async/TMA staging with a ring of buffers, and
// tensor-core dots (wgmma) for the score and PV products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // history tokens staged per iteration
constexpr int kMaxQpk = 8;  // query heads per kv head
constexpr float kNegInf = -1e30f;

// E consecutive pool values starting at p, as floats (E in {1, 2, 4}).
template <int E>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p, float* out) {
  if constexpr (E == 1) {
    out[0] = __bfloat162float(*p);
  } else if constexpr (E == 2) {
    float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = f.x;
    out[1] = f.y;
  } else {
    static_assert(E == 4, "E must be 1, 2 or 4");
    uint2 u = *reinterpret_cast<const uint2*>(p);
    float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    out[0] = a.x;
    out[1] = a.y;
    out[2] = b.x;
    out[3] = b.y;
  }
}

template <int E>
__device__ __forceinline__ void load_vals(const int8_t* p, float* out) {
  if constexpr (E == 1) {
    out[0] = static_cast<float>(*p);
  } else if constexpr (E == 2) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    out[0] = static_cast<float>(c.x);
    out[1] = static_cast<float>(c.y);
  } else {
    static_assert(E == 4, "E must be 1, 2 or 4");
    const char4 c = *reinterpret_cast<const char4*>(p);
    out[0] = static_cast<float>(c.x);
    out[1] = static_cast<float>(c.y);
    out[2] = static_cast<float>(c.z);
    out[3] = static_cast<float>(c.w);
  }
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// kQuant selects the pool: bf16 values, or int8 values with f32 scales
// (k_scale/v_scale, ignored and null for bf16).
template <int D, bool kQuant>
__global__ void __launch_bounds__(kThreads)
hist_flash_kernel(const __nv_bfloat16* __restrict__ q,  // [B, Nkv*qpk, D]
                  const std::conditional_t<kQuant, int8_t, __nv_bfloat16>* __restrict__ k_cache,
                  const std::conditional_t<kQuant, int8_t, __nv_bfloat16>* __restrict__ v_cache,
                  const float* __restrict__ k_scale,  // [L, Nkv, P, page]
                  const float* __restrict__ v_scale,
                  const int* __restrict__ page_table,  // [B, maxp]
                  const int* __restrict__ hist_lens,   // [B]
                  float* __restrict__ acc_out,         // [B, Nkv, qpk, D]
                  float* __restrict__ m_out,           // [B, Nkv, qpk]
                  float* __restrict__ l_out,           // [B, Nkv, qpk]
                  int nkv, int qpk, int num_pages, int page_size, int maxp,
                  int layer) {
  using T = std::conditional_t<kQuant, int8_t, __nv_bfloat16>;
  constexpr int E = D / 32;                      // elements per lane in a dot
  constexpr int kVec = 16 / sizeof(T);           // values per 16-byte load
  constexpr int kRowVecs = D / kVec;             // 16-byte loads per token row
  constexpr int kLoads = kChunk * kRowVecs / kThreads;
  constexpr int kOuts = kMaxQpk * D / kThreads;  // (head, d) outputs per thread
  constexpr int kGroupsPerWarp = kMaxQpk / kWarps;
  static_assert(kLoads >= 1 && kLoads * kThreads == kChunk * kRowVecs,
                "chunk/thread split");
  static_assert(kOuts * kThreads == kMaxQpk * D, "output/thread split");
  static_assert(kChunk == 64, "softmax phase reads two scores per lane");
  static_assert(kThreads == 2 * kChunk, "one scale load per thread");

  __shared__ __align__(16) T k_s[kChunk * D];
  __shared__ __align__(16) T v_s[kChunk * D];
  __shared__ float ks_s[kQuant ? kChunk : 1];
  __shared__ float vs_s[kQuant ? kChunk : 1];
  __shared__ float p_s[kMaxQpk][kChunk];
  __shared__ float alpha_s[kMaxQpk];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // A history longer than the page table's row is clamped to the row's
  // capacity, so no read runs past the row into the next one.
  const int hist = min(hist_lens[b], maxp * page_size);
  const float scale = rsqrtf(static_cast<float>(D));

  // This kv head's query heads, pre-scaled: lane holds [lane*E, lane*E + E).
  float qr[kMaxQpk][E];
  const __nv_bfloat16* qh = q + (static_cast<int64_t>(b) * nkv + h) * qpk * D;
#pragma unroll
  for (int g = 0; g < kMaxQpk; ++g) {
    if (g < qpk) {
      load_vals<E>(qh + static_cast<int64_t>(g) * D + lane * E, qr[g]);
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] = 0.f;
    }
  }

  float m_run[kGroupsPerWarp];
  float l_run[kGroupsPerWarp];
#pragma unroll
  for (int i = 0; i < kGroupsPerWarp; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
  }
  float acc[kOuts];
#pragma unroll
  for (int i = 0; i < kOuts; ++i) acc[i] = 0.f;

  const int64_t head_base =
      (static_cast<int64_t>(layer) * nkv + h) * num_pages;  // in pages
  const int* pt = page_table + static_cast<int64_t>(b) * maxp;

  for (int c0 = 0; c0 < hist; c0 += kChunk) {
    const int n_valid = min(kChunk, hist - c0);

    // Stage K and V rows [c0, c0 + kChunk) in shared memory.
    uint4 kreg[kLoads];
    uint4 vreg[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kThreads;
      const int t = idx / kRowVecs;
      const int col = idx % kRowVecs;
      if (t < n_valid) {
        const int tok = c0 + t;
        const int64_t pid = pt[tok / page_size];
        const int64_t off =
            ((head_base + pid) * page_size + tok % page_size) * D + col * kVec;
        kreg[i] = *reinterpret_cast<const uint4*>(k_cache + off);
        vreg[i] = *reinterpret_cast<const uint4*>(v_cache + off);
      } else {
        kreg[i] = make_uint4(0u, 0u, 0u, 0u);
        vreg[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    // int8: threads [0, kChunk) fetch the chunk's K scales, the rest its V
    // scales, one token each.
    float sreg = 0.f;
    if constexpr (kQuant) {
      const int t = tid % kChunk;
      if (t < n_valid) {
        const int tok = c0 + t;
        const int64_t pid = pt[tok / page_size];
        const int64_t off = (head_base + pid) * page_size + tok % page_size;
        sreg = tid < kChunk ? k_scale[off] : v_scale[off];
      }
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kThreads;
      reinterpret_cast<uint4*>(k_s)[idx] = kreg[i];
      reinterpret_cast<uint4*>(v_s)[idx] = vreg[i];
    }
    if constexpr (kQuant) {
      if (tid < kChunk) {
        ks_s[tid] = sreg;
      } else {
        vs_s[tid - kChunk] = sreg;
      }
    }
    __syncthreads();

    // Scores: warp per token, lanes split D.
    for (int t = warp; t < kChunk; t += kWarps) {
      float kv[E];
      load_vals<E>(k_s + t * D + lane * E, kv);
#pragma unroll
      for (int g = 0; g < kMaxQpk; ++g) {
        if (g < qpk) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) s += qr[g][e] * kv[e];
          s = warp_sum(s);
          if constexpr (kQuant) s *= ks_s[t];
          if (lane == 0) p_s[g][t] = t < n_valid ? s : kNegInf;
        }
      }
    }
    __syncthreads();

    // Online softmax: warp w owns heads w, w + kWarps. For int8 the stored
    // PV weight carries the token's V scale; l sums the bare probabilities.
#pragma unroll
    for (int i = 0; i < kGroupsPerWarp; ++i) {
      const int g = warp + i * kWarps;
      if (g < qpk) {
        const float s0 = p_s[g][lane];
        const float s1 = p_s[g][lane + 32];
        const float m_new = fmaxf(m_run[i], warp_max(fmaxf(s0, s1)));
        float p0 = expf(s0 - m_new);
        float p1 = expf(s1 - m_new);
        const float alpha = expf(m_run[i] - m_new);
        l_run[i] = l_run[i] * alpha + warp_sum(p0 + p1);
        m_run[i] = m_new;
        if constexpr (kQuant) {
          p0 *= vs_s[lane];
          p1 *= vs_s[lane + 32];
        }
        p_s[g][lane] = p0;
        p_s[g][lane + 32] = p1;
        if (lane == 0) alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over the chunk's valid rows.
#pragma unroll
    for (int i = 0; i < kOuts; ++i) {
      const int o = tid + i * kThreads;
      const int g = o / D;
      const int d = o % D;
      if (g < qpk) {
        float a = acc[i] * alpha_s[g];
        for (int t = 0; t < n_valid; ++t)
          a += p_s[g][t] * to_float(v_s[t * D + d]);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  const int64_t row = (static_cast<int64_t>(b) * nkv + h) * qpk;
#pragma unroll
  for (int i = 0; i < kOuts; ++i) {
    const int o = tid + i * kThreads;
    if (o < qpk * D) acc_out[row * D + o] = acc[i];
  }
#pragma unroll
  for (int i = 0; i < kGroupsPerWarp; ++i) {
    const int g = warp + i * kWarps;
    if (g < qpk && lane == 0) {
      m_out[row + g] = m_run[i];
      l_out[row + g] = l_run[i];
    }
  }
}

template <bool kQuant>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const void* k_scale, const void* v_scale, const void* page_table,
           const void* hist_lens, void* acc, void* m, void* l, int batch,
           int nkv, int qpk, int num_pages, int page_size, int head_dim,
           int maxp, int layer, void* stream) {
  using T = std::conditional_t<kQuant, int8_t, __nv_bfloat16>;
  if (batch < 1 || nkv < 1 || qpk < 1 || qpk > kMaxQpk || page_size < 1 ||
      maxp < 1 || nkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(batch, nkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kc = static_cast<const T*>(k_cache);
  const auto* vc = static_cast<const T*>(v_cache);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* ptb = static_cast<const int*>(page_table);
  const auto* hl = static_cast<const int*>(hist_lens);
  auto* ao = static_cast<float*>(acc);
  auto* mo = static_cast<float*>(m);
  auto* lo = static_cast<float*>(l);
  switch (head_dim) {
    case 32:
      hist_flash_kernel<32, kQuant><<<grid, kThreads, 0, s>>>(
          qb, kc, vc, ks, vs, ptb, hl, ao, mo, lo, nkv, qpk, num_pages, page_size, maxp, layer);
      break;
    case 64:
      hist_flash_kernel<64, kQuant><<<grid, kThreads, 0, s>>>(
          qb, kc, vc, ks, vs, ptb, hl, ao, mo, lo, nkv, qpk, num_pages, page_size, maxp, layer);
      break;
    case 128:
      hist_flash_kernel<128, kQuant><<<grid, kThreads, 0, s>>>(
          qb, kc, vc, ks, vs, ptb, hl, ao, mo, lo, nkv, qpk, num_pages, page_size, maxp, layer);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes). Each entry point launches on `stream`,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for an
// unsupported shape.

// bf16 pool: k_cache/v_cache bf16 [L, Nkv, P, page, D].
extern "C" int paged_attention_hist(const void* q, const void* k_cache,
                                    const void* v_cache, const void* page_table,
                                    const void* hist_lens, void* acc, void* m,
                                    void* l, int batch, int nkv, int qpk,
                                    int num_pages, int page_size, int head_dim,
                                    int maxp, int layer, void* stream) {
  return launch<false>(q, k_cache, v_cache, nullptr, nullptr, page_table,
                       hist_lens, acc, m, l, batch, nkv, qpk, num_pages,
                       page_size, head_dim, maxp, layer, stream);
}

// int8 pool: k_cache/v_cache int8 [L, Nkv, P, page, D] with f32 per-token
// scales k_scale/v_scale [L, Nkv, P, page].
extern "C" int paged_attention_hist_int8(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* hist_lens, void* acc, void* m, void* l, int batch, int nkv,
    int qpk, int num_pages, int page_size, int head_dim, int maxp, int layer,
    void* stream) {
  return launch<true>(q, k_cache, v_cache, k_scale, v_scale, page_table,
                      hist_lens, acc, m, l, batch, nkv, qpk, num_pages,
                      page_size, head_dim, maxp, layer, stream);
}
