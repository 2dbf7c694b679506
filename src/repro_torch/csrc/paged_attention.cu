// Paged flash-decode attention for Hopper (sm_90a): split-K over the page
// axis with a log-sum-exp merge.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_decode_attention (`_kernel`, pallas_call at paged_attention.py:201).
// Computes what that kernel and the plain version src/repro_torch/kernels/
// ref.py::paged_decode_attention compute: one decode query per slot attends
// to its KV directly through the page table.  Query head h reads KV head
// h / group; position t of slot b lives at (table[b, t / ps], t % ps);
// logits are taken in f32 with `scale`, then softcap * tanh(x / softcap)
// when softcap > 0; the live positions are pos < len, pos < P * ps and,
// with a window, pos > len - 1 - window; the softmax is online in f32;
// int8 / fp8-e4m3 page blocks are multiplied by their (page, KV head) scale
// as they are fetched; an empty slot returns zeros; the output has q's
// dtype.  With an lse pointer it also writes the (B, Hkv, group) f32
// log-sum-exp m + log(max(l, 1e-30)) of the Pallas kernel's return_lse
// (about -1e30 for a slot with no live position).
//
// What bounds it on the H100: the bytes of the live positions' K and V, read
// once, 2 * sum_b len_b * Hkv * D * itemsize at 3.35 TB/s (plus q, out, the
// table and the lengths).  At llama2-7b's decode step (8 slots of 128-507
// positions, Hkv 32, D 128, bf16) that is 12.6 us per launch; at tinyllama's
// (lengths 9-95, Hkv 4, D 64) 0.15 us, where a launch's latency is the cost.
// A group of at most 8 query rows per KV head gives 2-16 flops per byte:
// no use for tensor cores, so the design aims at bytes in flight and
// balance.
//
// What the design does about it:
// * The page axis is split across blocks.  The grid is (KV head x row
//   slice, slot, page chunk), the chunk slowest; a chunk is a fixed number
//   of pages that the wrapper chooses from ps, P, B * Hkv and D
//   (kernels/paged_attention.py::split_plan), never from the lengths, so a
//   launch never waits on the host and captures in a CUDA graph.  A chunk
//   wholly past the slot's length or below its window returns at once, so
//   ragged slots spread over many blocks and the longest slot no longer
//   sets the time.
// * Inside a block every warp works at any group size: the 4 warps split
//   the chunk's positions; within a warp, LPR = D / EPL lanes share one
//   position's row, each lane holding EPL elements (32 bytes of the row in
//   a block of one query row; 16 of bf16 or f32 and 8 of int8 / fp8 in a
//   block of 8 rows), so a warp covers 32 / LPR positions per step.  Each
//   q.k is a shuffle reduction over the LPR lanes, and every query row of
//   the group (up to 8 per block, in registers) reuses the fetched K row.
//   Each lane copies its own K and V pieces with cp.async into a ring of
//   steps in shared memory (4 steps, or 2 of 32-byte pieces), so that many
//   steps of rows are in flight while one computes, at no register cost.
//   Each lane group runs its own online softmax in registers, straight-line
//   over the rows (the rescale is e^0 = 1 unless the max grows); no
//   __syncthreads per page.  The lane groups merge by shuffles and the
//   warps through shared memory (reusing the ring), once, at the end of
//   the chunk.
// * The chunks of one (slot, KV head, row slice) merge by log-sum-exp: each
//   writes (m, l, acc) to an f32 workspace, and the last block to finish
//   (a __threadfence and an atomic counter, which the launcher zeroes with
//   a cudaMemsetAsync on the launch's stream before every launch, so the
//   counters carry nothing from one call or graph replay to the next) reads
//   them in chunk order -- the same result bit for bit from run to run --
//   and writes out = sum_c e^(m_c - M) acc_c / max(sum_c e^(m_c - M) l_c,
//   1e-30) with M = max_c m_c.  A slot with one live chunk writes its
//   output directly.  One kernel launch per call, after the counters'
//   memset (none when a slot's table is one chunk).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kMaxChunks = 64;   // chunks per slot (kernels/paged_attention.py MAX_CHUNKS)

enum DType { kF32 = 0, kBF16 = 1, kInt8 = 2, kFP8 = 3 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(BYTES)
                 : "memory");
  }
}
// "memory": no shared-memory read moves above a wait, nor below a copy
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// EPL elements of one pool row as raw words: 8, 16 or 32 bytes, copied
// global -> shared with cp.async and read back by the lane that copied them.
template <typename KVT, int EPL>
struct Row {
  static constexpr int kBytes = EPL * (int)sizeof(KVT);
  static_assert(kBytes == 8 || kBytes == 16 || kBytes == 32, "8, 16 or 32 bytes per lane");
  static constexpr int kDepth = kBytes == 32 ? 2 : 4;   // steps in flight per lane
  uint32_t w[kBytes / 4];

  __device__ __forceinline__ static void copy(void* dst, const KVT* src) {
    if constexpr (kBytes == 32) {
      cp_async<16>(dst, src);
      cp_async<16>(static_cast<char*>(dst) + 16, reinterpret_cast<const char*>(src) + 16);
    } else {
      cp_async<kBytes>(dst, src);
    }
  }
  __device__ __forceinline__ void read(const void* p) {
    if constexpr (kBytes == 8) {
      const uint2 u = *static_cast<const uint2*>(p);
      w[0] = u.x;
      w[1] = u.y;
    } else {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i) {
        const uint4 u = static_cast<const uint4*>(p)[i];
        w[4 * i] = u.x;
        w[4 * i + 1] = u.y;
        w[4 * i + 2] = u.z;
        w[4 * i + 3] = u.w;
      }
    }
  }
  // to f32, times the page's scale when the pool is quantized
  __device__ __forceinline__ void to_f32(float (&f)[EPL], bool scaled, float sc) const {
    if constexpr (sizeof(KVT) == 4) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) f[e] = __uint_as_float(w[e]);
    } else if constexpr (sizeof(KVT) == 2) {
#pragma unroll
      for (int e = 0; e < EPL / 2; ++e) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        f[2 * e] = x.x;
        f[2 * e + 1] = x.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const uint8_t byte = (w[e / 4] >> (8 * (e % 4))) & 0xffu;
        if constexpr (std::is_same<KVT, int8_t>::value) {
          f[e] = (float)(int8_t)byte;
        } else {
          __nv_fp8_e4m3 x;
          x.__x = byte;
          f[e] = float(x);
        }
      }
    }
    if (scaled) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) f[e] = f[e] * sc;
    }
  }
};

template <typename KVT, int EPL>
constexpr size_t ring_bytes() {
  return (size_t)Row<KVT, EPL>::kDepth * kThreads * (2 * EPL * sizeof(KVT) + 2 * sizeof(float));
}

// Shared memory of one block: the cp.async ring while the chunk streams,
// then (reusing it) the warps' partial sums for their merge.
template <typename KVT, int EPL, int G>
size_t smem_bytes(int D) {
  const size_t merge = sizeof(float) * ((size_t)kWarps * G * D + 2 * kWarps * G);
  const size_t ring = ring_bytes<KVT, EPL>();
  return merge > ring ? merge : ring;
}

// G query rows per block (1, or 8 for any group of 2-8 and each slice of 8
// of a larger group); EPL elements of a row per lane.
template <typename QT, typename KVT, int EPL, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ kp,
                    const KVT* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ lens, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, QT* __restrict__ out,
                    float* __restrict__ lse, float* __restrict__ ws, int* __restrict__ counters,
                    int Hkv, int group, int D, int ps, int P, int chunk_pages, int window,
                    float scale, float softcap) {
  using RowT = Row<KVT, EPL>;
  constexpr int kRow = RowT::kBytes;
  constexpr int kDepth = RowT::kDepth;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring: [slot][K, V][thread] rows, then [slot][K, V][thread] scales
  unsigned char* ring = smem_raw;
  float* ring_sc = reinterpret_cast<float*>(smem_raw + (size_t)kDepth * 2 * kThreads * kRow);
  // after the loop: the warps' partials
  float* acc_s = reinterpret_cast<float*>(smem_raw);   // [kWarps][G][D]
  float* m_s = acc_s + kWarps * G * D;                 // [kWarps][G]
  float* l_s = m_s + kWarps * G;                       // [kWarps][G]
  __shared__ float w_s[kWarps][G], row_m_s[G], row_l_s[G];
  __shared__ float cw_s[G][kMaxChunks], cl_s[G][kMaxChunks];
  __shared__ int last_s;

  const int c = blockIdx.z, b = blockIdx.y;
  const int n_slices = (group + G - 1) / G;
  const int h = blockIdx.x / n_slices, slice = blockIdx.x % n_slices;
  const int g0 = slice * G, ng = min(G, group - g0);
  const int Hq = Hkv * group;
  const int n_chunks = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row0 = (size_t)b * Hq + (size_t)h * group + g0;   // first q / out row

  // lanes: LPR share one position's row, RPW positions per warp step
  const int lpr = D / EPL, rpw = 32 / lpr;
  const int sub = lane / lpr, e0 = (lane % lpr) * EPL;

  // the chunk's first page id is read beside the slot's length, not after it
  const int page0 = c * chunk_pages;
  const int pid0 = table[(size_t)b * P + page0];
  const int len = lens[b];
  const int hi = min(len, P * ps);
  const int lo = window >= 0 ? min(max(0, len - window), hi) : 0;
  const int cpos = chunk_pages * ps;
  const int c_lo = lo / cpos, c_hi = (hi + cpos - 1) / cpos;
  const int n_live = hi > lo ? c_hi - c_lo : 0;
  float* lse_row = lse ? lse + ((size_t)b * Hkv + h) * group + g0 : nullptr;
  // the workspace: acc [row][chunk][D], then (m, l) [row][chunk][2]
  float* ws_acc = ws + row0 * n_chunks * (size_t)D;
  float* ws_ml = ws + (size_t)gridDim.y * Hq * n_chunks * D + row0 * n_chunks * 2;

  if (n_live == 0) {   // an empty slot: zeros, and lse = -1e30 + log(1e-30)
    if (c == 0) {
      for (int i = tid; i < ng * D; i += kThreads) out[row0 * D + i] = from_float<QT>(0.f);
      if (lse_row && tid < ng) lse_row[tid] = kNegInf + logf(1e-30f);
    }
    return;
  }
  if (c < c_lo || c >= c_hi) return;
  const int p_lo = max(lo, c * cpos), p_hi = min(hi, (c + 1) * cpos);

  float qr[G][EPL], acc[G][EPL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[g][e] = g < ng ? to_float(q[(row0 + g) * D + e0 + e]) : 0.f;
      acc[g][e] = 0.f;
    }
  }

  // Stream the chunk through a ring of kDepth steps per lane: the row a
  // lane consumes was copied kDepth steps earlier, by the lane itself, so
  // no barrier is needed; every issue commits one cp.async group (empty
  // past the chunk), and waiting for all but kDepth - 1 groups lands the
  // oldest.
  const bool quant = k_scale != nullptr;
  const int step = kWarps * rpw;
  auto slot_row = [&](int slot, int kv) {
    return ring + ((size_t)(slot * 2 + kv) * kThreads + tid) * kRow;
  };
  auto slot_sc = [&](int slot, int kv) {
    return ring_sc + (size_t)(slot * 2 + kv) * kThreads + tid;
  };
  auto issue = [&](int pos, int slot) {
    if (pos < p_hi) {
      const int page = pos / ps;
      const int pid = page == page0 ? pid0 : table[(size_t)b * P + page];
      const size_t off = (((size_t)pid * ps + (pos - page * ps)) * Hkv + h) * D + e0;
      RowT::copy(slot_row(slot, 0), kp + off);
      RowT::copy(slot_row(slot, 1), vp + off);
      if (quant) {
        cp_async<4>(slot_sc(slot, 0), k_scale + (size_t)pid * Hkv + h);
        cp_async<4>(slot_sc(slot, 1), v_scale + (size_t)pid * Hkv + h);
      }
    }
    cp_async_commit();
  };
  const int first = p_lo + warp * rpw + sub;
#pragma unroll
  for (int i = 0; i < kDepth; ++i) issue(first + i * step, i);

  for (int base = p_lo + warp * rpw; base < p_hi; base += kDepth * step) {
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      if (base + i * step >= p_hi) break;   // this warp's rows are done
      const int pos = base + i * step + sub;
      const bool valid = pos < p_hi;
      cp_async_wait<kDepth - 1>();
      RowT kr, vr;
      kr.read(slot_row(i, 0));
      vr.read(slot_row(i, 1));
      float kf[EPL], vf[EPL];
      kr.to_f32(kf, quant, quant ? *slot_sc(i, 0) : 1.f);
      vr.to_f32(vf, quant, quant ? *slot_sc(i, 1) : 1.f);
#pragma unroll
      for (int e = 0; e < EPL; ++e) {   // a lane past the chunk holds a stale slot
        kf[e] = valid ? kf[e] : 0.f;
        vf[e] = valid ? vf[e] : 0.f;
      }
      // all G rows, straight-line (rows past the group hold zero q and are
      // never written out)
      float logit[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[g][e], kf[e], dot);
        for (int o = lpr / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        logit[g] = dot * scale;
      }
      if (softcap > 0.f) {
#pragma unroll
        for (int g = 0; g < G; ++g) logit[g] = softcap * tanhf(logit[g] / softcap);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        // online softmax: the rescale is e^0 = 1 unless the max grows
        const float m_new = valid ? fmaxf(m[g], logit[g]) : m[g];
        const float corr = expf(m[g] - m_new);
        const float p = valid ? expf(logit[g] - m_new) : 0.f;
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e] * corr);
        m[g] = m_new;
      }
      issue(pos + kDepth * step, i);   // the slot's rows are used: refill it
    }
  }
  cp_async_wait<0>();

  // merge the warp's lane groups (same elements, other positions)
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= ng) break;
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mm = fmaxf(m[g], mo);
      const float c1 = expf(m[g] - mm), c2 = expf(mo - mm);
      l[g] = l[g] * c1 + lo_ * c2;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * c1 + ao * c2;
      }
      m[g] = mm;
    }
  }
  __syncthreads();   // every warp is done with the ring, which acc_s reuses
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= ng) break;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc_s[(warp * G + g) * D + e0 + e] = acc[g][e];
      if (lane == 0) {
        m_s[warp * G + g] = m[g];
        l_s[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps, in warp order: the chunk's (m, l, acc); each row's
  // weights e^(m_w - M) first, once
  if (tid < ng) {
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, m_s[w * G + tid]);
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float cw = expf(m_s[w * G + tid] - mm);
      ll += l_s[w * G + tid] * cw;
      w_s[w][tid] = cw;
    }
    row_m_s[tid] = mm;
    row_l_s[tid] = ll;
  }
  __syncthreads();
  const bool direct = n_live == 1;
  const int D4 = D / 4;
  for (int i = tid; i < ng * D4; i += kThreads) {   // four columns per item
    const int g = i / D4, d = (i - g * D4) * 4;
    float4 aa = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float4 a = *reinterpret_cast<const float4*>(acc_s + (w * G + g) * D + d);
      const float cw = w_s[w][g];
      aa.x += a.x * cw;
      aa.y += a.y * cw;
      aa.z += a.z * cw;
      aa.w += a.w * cw;
    }
    if (direct) {
      const float den = fmaxf(row_l_s[g], 1e-30f);
      QT* o = out + (row0 + g) * D + d;
      o[0] = from_float<QT>(aa.x / den);
      o[1] = from_float<QT>(aa.y / den);
      o[2] = from_float<QT>(aa.z / den);
      o[3] = from_float<QT>(aa.w / den);
      if (lse_row && d == 0) lse_row[g] = row_m_s[g] + logf(den);
    } else {
      *reinterpret_cast<float4*>(ws_acc + ((size_t)g * n_chunks + c) * D + d) = aa;
      if (d == 0) {
        ws_ml[((size_t)g * n_chunks + c) * 2] = row_m_s[g];
        ws_ml[((size_t)g * n_chunks + c) * 2 + 1] = row_l_s[g];
      }
    }
  }
  if (direct) return;

  // the last of the slot's live chunks to finish merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = counters + ((size_t)b * Hkv + h) * n_slices + slice;
    const int done = atomicAdd(cnt, 1);
    last_s = done == n_live - 1;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // per row, a warp loads the chunks' (m_c, l_c) at once, takes M = max_c
  // m_c and keeps the weights e^(m_c - M) and e^(m_c - M) l_c
  for (int g = warp; g < ng; g += kWarps) {
    const float* ml = ws_ml + ((size_t)g * n_chunks + c_lo) * 2;
    float mc[kMaxChunks / 32], lc[kMaxChunks / 32];
    float mm = kNegInf;
#pragma unroll
    for (int k = 0; k < kMaxChunks / 32; ++k) {
      const int j = lane + 32 * k;
      const float2 x = j < n_live ? __ldcg(reinterpret_cast<const float2*>(ml) + j)
                                  : make_float2(kNegInf, 0.f);
      mc[k] = x.x;
      lc[k] = x.y;
      mm = fmaxf(mm, mc[k]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, o));
#pragma unroll
    for (int k = 0; k < kMaxChunks / 32; ++k) {
      const int j = lane + 32 * k;
      if (j < n_live) {
        const float cw = expf(mc[k] - mm);
        cw_s[g][j] = cw;
        cl_s[g][j] = cw * lc[k];
      }
    }
    if (lane == 0) row_m_s[g] = mm;
  }
  __syncthreads();
  // then every (row, four columns) sums the chunks in chunk order:
  // out = sum_c e^(m_c - M) acc_c / max(sum_c e^(m_c - M) l_c, 1e-30)
  for (int i = tid; i < ng * D4; i += kThreads) {
    const int g = i / D4, d = (i - g * D4) * 4;
    const float* parts = ws_acc + ((size_t)g * n_chunks + c_lo) * D + d;
    float ll = 0.f;
    float4 aa = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int j = 0; j < n_live; ++j) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(parts + (size_t)j * D));
      const float cw = cw_s[g][j];
      ll += cl_s[g][j];
      aa.x += a.x * cw;
      aa.y += a.y * cw;
      aa.z += a.z * cw;
      aa.w += a.w * cw;
    }
    const float den = fmaxf(ll, 1e-30f);
    QT* o = out + (row0 + g) * D + d;
    o[0] = from_float<QT>(aa.x / den);
    o[1] = from_float<QT>(aa.y / den);
    o[2] = from_float<QT>(aa.z / den);
    o[3] = from_float<QT>(aa.w / den);
    if (lse_row && d == 0) lse_row[g] = row_m_s[g] + logf(den);
  }
}

template <typename QT, typename KVT, int EPL, int G>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* table,
                   const int* lens, const float* ks, const float* vs, void* out, float* lse,
                   float* ws, int* counters, int B, int Hkv, int group, int D, int ps, int P,
                   int chunk_pages, int n_chunks, int window, float scale, float softcap,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<KVT, EPL, G>(D);
  // the chunk index is the slowest axis: blocks start in index order, so
  // the low chunks, which every live slot has, go first, and the blocks of
  // chunks past the short slots' lengths come last and return at once
  dim3 grid(Hkv * ((group + G - 1) / G), B, n_chunks);
  paged_decode_kernel<QT, KVT, EPL, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(kp), static_cast<const KVT*>(vp),
      table, lens, ks, vs, static_cast<QT*>(out), lse, ws, counters, Hkv, group, D, ps, P,
      chunk_pages, window, scale, softcap);
  return cudaGetLastError();
}

// The (pool type, elements per lane, rows per block) the wrapper picks
// (kernels/paged_attention.py::lane_elements): a block of one query row
// takes 32 bytes of a row per lane, a block of 8 rows 16 (8 for int8 /
// fp8; 32 for an f32 pool at D 256).
template <typename QT>
cudaError_t launch_kv(int kv_dtype, int epl, int rows, const void* q, const void* kp,
                      const void* vp, const int* table, const int* lens, const float* ks,
                      const float* vs, void* out, float* lse, float* ws, int* counters, int B,
                      int Hkv, int group, int D, int ps, int P, int chunk_pages, int n_chunks,
                      int window, float scale, float softcap, cudaStream_t s) {
#define PAGED_ARGS                                                                          \
  q, kp, vp, table, lens, ks, vs, out, lse, ws, counters, B, Hkv, group, D, ps, P,       \
      chunk_pages, n_chunks, window, scale, softcap, s
  if (rows == 1) {
    if (kv_dtype == kF32 && epl == 8) return launch<QT, float, 8, 1>(PAGED_ARGS);
    if (kv_dtype == kBF16 && epl == 16) return launch<QT, __nv_bfloat16, 16, 1>(PAGED_ARGS);
    if (kv_dtype == kInt8 && epl == 16) return launch<QT, int8_t, 16, 1>(PAGED_ARGS);
    if (kv_dtype == kFP8 && epl == 16) return launch<QT, __nv_fp8_e4m3, 16, 1>(PAGED_ARGS);
  } else if (rows == 8) {
    if (kv_dtype == kF32 && epl == 4) return launch<QT, float, 4, 8>(PAGED_ARGS);
    if (kv_dtype == kF32 && epl == 8) return launch<QT, float, 8, 8>(PAGED_ARGS);
    if (kv_dtype == kBF16 && epl == 8) return launch<QT, __nv_bfloat16, 8, 8>(PAGED_ARGS);
    if (kv_dtype == kInt8 && epl == 8) return launch<QT, int8_t, 8, 8>(PAGED_ARGS);
    if (kv_dtype == kFP8 && epl == 8) return launch<QT, __nv_fp8_e4m3, 8, 8>(PAGED_ARGS);
  }
#undef PAGED_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, Hkv*group, 1, D) and out in q_dtype (0 = f32, 1 = bf16); pools
// (num_pages, ps, Hkv, D) in kv_dtype (0 f32, 1 bf16, 2 int8, 3 fp8 e4m3),
// 16-byte aligned; table (B, P) int32; lens (B,) int32; k_scale / v_scale
// (num_pages, Hkv) f32 or null; lse (B, Hkv, group) f32 or null; ws an f32
// workspace of B * Hkv * group * n_chunks * (D + 2); counters B * Hkv *
// ceil(group / rows) int32, zeroed here before the launch; D / epl a
// power of two up to 32 (kernels/paged_attention.py::lane_elements);
// rows 1 or 8 (query rows per block); n_chunks * chunk_pages >= P and
// n_chunks <= 64; window
// < 0 means none; softcap <= 0 means none.  All contiguous.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* lens, const void* k_scale, const void* v_scale, void* out, void* lse,
    void* ws, void* counters, int B, int Hkv, int group, int D, int ps, int P,
    int chunk_pages, int n_chunks, int epl, int rows, int window, float scale, float softcap,
    int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* l = static_cast<const int*>(lens);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* ls = static_cast<float*>(lse);
  float* w = static_cast<float*>(ws);
  int* cn = static_cast<int*>(counters);
  const int lpr = epl > 0 ? D / epl : 0;
  if (lpr < 1 || lpr > 32 || (lpr & (lpr - 1)) || lpr * epl != D) return (int)cudaErrorInvalidValue;
  if (n_chunks < 1 || n_chunks > kMaxChunks || (long)n_chunks * chunk_pages < P)
    return (int)cudaErrorInvalidValue;
  if (rows != 1 && rows != 8) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (n_chunks > 1) {   // one chunk per slot writes its output directly
    const int n_slices = (group + rows - 1) / rows;
    e = cudaMemsetAsync(cn, 0, sizeof(int) * (size_t)B * Hkv * n_slices, s);
    if (e != cudaSuccess) return (int)e;
  }
  if (q_dtype == kF32) {
    e = launch_kv<float>(kv_dtype, epl, rows, q, k_pool, v_pool, t, l, ks, vs, out, ls, w, cn,
                         B, Hkv, group, D, ps, P, chunk_pages, n_chunks, window, scale, softcap,
                         s);
  } else if (q_dtype == kBF16) {
    e = launch_kv<__nv_bfloat16>(kv_dtype, epl, rows, q, k_pool, v_pool, t, l, ks, vs, out, ls,
                                 w, cn, B, Hkv, group, D, ps, P, chunk_pages, n_chunks, window,
                                 scale, softcap, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return (int)e;
}
