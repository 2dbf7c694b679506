// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_decode_attention (`_kernel`, pallas_call at paged_attention.py:201).
// Computes what that kernel and the oracle src/repro/kernels/ref.py::
// paged_decode_attention compute: one decode query per slot attends to its KV
// directly through the page table.  Query head h reads KV head h // group;
// position t of slot b lives at (table[b, t / ps], t % ps); logits are taken
// in f32 with `scale`, then softcap * tanh(x / softcap) when softcap > 0; the
// mask is pos < len and, with a window, pos > len - 1 - window; the softmax is
// online in f32; int8 / fp8-e4m3 page blocks are multiplied by their
// (page, kv head) scale as they are fetched; an empty slot returns zeros; the
// output has q's dtype.
//
// What bounds it on the H100: the KV bytes of the live pages, read once,
// 2 * sum_b ceil(len_b / ps) * ps * Hkv * D * itemsize at 3.35 TB/s -- well
// under a microsecond at serving sizes, so in practice one launch is the cost.
//
// What the design does about it: one block per (slot, KV head); the TPU's
// sequential page grid axis becomes a loop inside the block that walks only
// the pages the slot needs -- from the first page that reaches into the
// window to ceil(len / ps) -- instead of every table column.  Each page's K
// and V blocks are staged (dequantized to f32) in shared memory once and
// serve all `group` query rows of the KV head.  Warps own query rows; lanes
// own positions for the logits and head-dim entries for the value sum.
// Limit: only B * Hkv blocks (32 at 8 slots of tinyllama) on 132 SMs;
// splitting the page loop across blocks with an LSE merge is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // positions staged per step (one per lane)
constexpr float kNegInf = -1e30f;

enum DType { kF32 = 0, kBF16 = 1, kInt8 = 2, kFP8 = 3 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 v) { return float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename QT, typename KVT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ kp,
                    const KVT* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ lens, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, QT* __restrict__ out, int Hkv,
                    int group, int D, int ps, int P, int window, float scale,
                    float softcap) {
  extern __shared__ float sm[];
  const int ts_max = min(ps, kTile);
  float* q_s = sm;                        // [group][D]
  float* acc_s = q_s + group * D;         // [group][D]
  float* m_s = acc_s + group * D;         // [group]
  float* l_s = m_s + group;               // [group]
  float* p_s = l_s + group;               // [kWarps][32]
  float* k_s = p_s + kWarps * 32;         // [ts_max][D + 1] (padded: no bank conflicts)
  float* v_s = k_s + ts_max * (D + 1);    // [ts_max][D]

  const int b = blockIdx.x, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Hq = Hkv * group;
  const size_t q_off = ((size_t)b * Hq + (size_t)h * group) * D;

  for (int i = threadIdx.x; i < group * D; i += kThreads) {
    q_s[i] = to_float(q[q_off + i]);
    acc_s[i] = 0.f;
  }
  for (int i = threadIdx.x; i < group; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  const int len = lens[b];
  int p_end = (len + ps - 1) / ps;
  if (p_end > P) p_end = P;
  int p_beg = 0;
  if (window >= 0) p_beg = max(0, len - window) / ps;  // first page inside the window
  __syncthreads();

  for (int p = p_beg; p < p_end; ++p) {
    const int pid = table[(size_t)b * P + p];
    const float ksc = k_scale ? k_scale[(size_t)pid * Hkv + h] : 1.f;
    const float vsc = v_scale ? v_scale[(size_t)pid * Hkv + h] : 1.f;
    for (int t0 = 0; t0 < ps; t0 += ts_max) {
      const int ts = min(ts_max, ps - t0);
      for (int i = threadIdx.x; i < ts * D; i += kThreads) {
        const int s = i / D, d = i - s * D;
        const size_t off = (((size_t)pid * ps + t0 + s) * Hkv + h) * D + d;
        float kv = to_float(kp[off]);
        float vv = to_float(vp[off]);
        if (k_scale) kv = kv * ksc;
        if (v_scale) vv = vv * vsc;
        k_s[s * (D + 1) + d] = kv;
        v_s[s * D + d] = vv;
      }
      __syncthreads();
      const int pos = p * ps + t0 + lane;
      const bool valid = lane < ts && pos < len && (window < 0 || pos > len - 1 - window);
      for (int g = warp; g < group; g += kWarps) {
        float logit = kNegInf;
        if (lane < ts) {
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot += q_s[g * D + d] * k_s[lane * (D + 1) + d];
          logit = dot * scale;
          if (softcap > 0.f) logit = softcap * tanhf(logit / softcap);
        }
        if (!valid) logit = kNegInf;
        float mx = logit;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, mx);
        const float pe = valid ? expf(logit - m_new) : 0.f;
        const float corr = expf(m_prev - m_new);
        float psum = pe;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
        p_s[warp * 32 + lane] = pe;
        __syncwarp();
        for (int d = lane; d < D; d += 32) {
          float a = acc_s[g * D + d] * corr;
          for (int s = 0; s < ts; ++s) a += p_s[warp * 32 + s] * v_s[s * D + d];
          acc_s[g * D + d] = a;
        }
        __syncwarp();
        if (lane == 0) {
          m_s[g] = m_new;
          l_s[g] = l_s[g] * corr + psum;
        }
        __syncwarp();
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < group * D; i += kThreads) {
    const int g = i / D;
    out[q_off + i] = from_float<QT>(acc_s[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename QT, typename KVT>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* table,
                   const int* lens, const float* ks, const float* vs, void* out, int B,
                   int Hkv, int group, int D, int ps, int P, int window, float scale,
                   float softcap, cudaStream_t stream) {
  const int ts_max = ps < kTile ? ps : kTile;
  const size_t smem =
      sizeof(float) * ((size_t)2 * group * D + 2 * group + kWarps * 32 +
                       (size_t)ts_max * (D + 1) + (size_t)ts_max * D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_kernel<QT, KVT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B, Hkv);
  paged_decode_kernel<QT, KVT><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(kp), static_cast<const KVT*>(vp),
      table, lens, ks, vs, static_cast<QT*>(out), Hkv, group, D, ps, P, window, scale,
      softcap);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_kv(int kv_dtype, const void* q, const void* kp, const void* vp,
                      const int* table, const int* lens, const float* ks, const float* vs,
                      void* out, int B, int Hkv, int group, int D, int ps, int P,
                      int window, float scale, float softcap, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      return launch<QT, float>(q, kp, vp, table, lens, ks, vs, out, B, Hkv, group, D, ps,
                               P, window, scale, softcap, stream);
    case kBF16:
      return launch<QT, __nv_bfloat16>(q, kp, vp, table, lens, ks, vs, out, B, Hkv, group,
                                       D, ps, P, window, scale, softcap, stream);
    case kInt8:
      return launch<QT, int8_t>(q, kp, vp, table, lens, ks, vs, out, B, Hkv, group, D, ps,
                                P, window, scale, softcap, stream);
    case kFP8:
      return launch<QT, __nv_fp8_e4m3>(q, kp, vp, table, lens, ks, vs, out, B, Hkv, group,
                                       D, ps, P, window, scale, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hkv*group, 1, D) and out in q_dtype (0 = f32, 1 = bf16); pools
// (num_pages, ps, Hkv, D) in kv_dtype (0 f32, 1 bf16, 2 int8, 3 fp8 e4m3);
// table (B, P) int32; lens (B,) int32; k_scale / v_scale (num_pages, Hkv) f32
// or null; window < 0 means none; softcap <= 0 means none.  All contiguous.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_decode_attention_launch(const void* q, const void* k_pool,
                                             const void* v_pool, const void* table,
                                             const void* lens, const void* k_scale,
                                             const void* v_scale, void* out, int B,
                                             int Hkv, int group, int D, int ps, int P,
                                             int window, float scale, float softcap,
                                             int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* l = static_cast<const int*>(lens);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaError_t e;
  if (q_dtype == kF32) {
    e = launch_kv<float>(kv_dtype, q, k_pool, v_pool, t, l, ks, vs, out, B, Hkv, group, D,
                         ps, P, window, scale, softcap, s);
  } else if (q_dtype == kBF16) {
    e = launch_kv<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, t, l, ks, vs, out, B, Hkv,
                                 group, D, ps, P, window, scale, softcap, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return (int)e;
}
