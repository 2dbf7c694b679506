// Flash attention (forward) for Hopper (sm_90a): the prefill attention.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (`_kernel`, pallas_call at flash_attention.py:111).
// Computes what that kernel and the plain version src/repro_torch/kernels/
// ref.py::flash_attention compute: q (B, Hq, Tq, D) attends to k, v
// (B, Hkv, Tk, D); query head h reads KV head h / group (no K/V repeat);
// logits q.k in f32 times `scale`, then softcap * tanh(x / softcap) when
// softcap > 0; the mask is kpos < Tk, causal kpos <= qpos and, with a
// window, kpos > qpos - window, where qpos = row + kv_offset; an online
// softmax in f32 with the softmax weights p kept in f32 for the p.V product
// and an f32 accumulator; the output is acc / max(l, 1e-30), rounded once to
// q's dtype (__float2bfloat16_rn for bf16).  Ragged Tq and Tk are masked
// here; the TPU kernel padded them to its blocks.
//
// What bounds it on the H100, per launch: max(bytes / 3.35 TB/s,
// flops / 989 TFLOP/s) with bytes = itemsize * (2 * B * Hq * Tq +
// 2 * B * Hkv * Tk) * D (q and out, k and v, each once) and flops =
// 4 * B * Hq * D * (visible q-k pairs).  At llama2-7b's prefill of 512
// tokens (Hq = Hkv = 32, D = 128, bf16) that is 16.8 MB (5.0 us) against
// 2.15 GFLOP (2.2 us): byte-bound at 5.0 us.
//
// What the design does about it: nothing yet -- it is the simple design
// that is right.  One block per (64-row query tile, query head, batch row)
// keeps its q tile in shared memory; a loop over 64-key K/V tiles takes the
// place of the TPU's sequential KV grid axis, and its bounds skip the
// tiles that causality or the window mask wholly (flash_attention.py:44-52
// turned into loop bounds).  Each of the 8 warps owns 8 query rows: for
// q.k the lanes split the tile's keys (one full-D dot per lane and row),
// the warp takes max and sum with shuffles and updates m, l and the
// correction; for p.V the lanes split D (4 columns per lane at D = 128)
// with the accumulator in registers.  Everything runs in f32 on the CUDA
// cores, whose 67 TFLOP/s cap this design about 15x above the bf16
// tensor-core bound (32 us per launch at the size above, before any
// shared-memory limit).  A tensor-core redesign (mma.sync / wgmma on bf16
// operands) has to decide what to do with p, which this function keeps in
// f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockQ = 64;                       // query rows per block
constexpr int kRowsPerWarp = kBlockQ / kWarps;    // 8
constexpr int kBlockK = 64;                       // keys per staged tile
constexpr int kKeysPerLane = kBlockK / 32;        // 2
constexpr float kNegInf = -1e30f;

enum DType { kF32 = 0, kBF16 = 1 };

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

// C = accumulator columns per lane: D <= 32 * C.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Hq, int Hkv,
                       int Tq, int Tk, int D, int causal, int window, int kv_offset,
                       float scale, float softcap) {
  extern __shared__ float sm[];
  float* q_s = sm;                                 // [kBlockQ][D]
  float* k_s = q_s + kBlockQ * D;                  // [kBlockK][D + 1] (padded: no bank conflicts)
  float* v_s = k_s + kBlockK * (D + 1);            // [kBlockK][D]
  float* p_s = v_s + kBlockK * D;                  // [kWarps][kRowsPerWarp][kBlockK]

  const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hk = h / (Hq / Hkv);
  const int nq = min(kBlockQ, Tq - q0);
  const size_t q_base = (((size_t)b * Hq + h) * Tq + q0) * D;
  const size_t kv_base = ((size_t)b * Hkv + hk) * (size_t)Tk * D;

  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    q_s[i] = i / D < nq ? to_float(q[q_base + i]) : 0.f;
  }
  // The tiles this query tile can see: causality ends them at the last
  // row's position, the window starts them at the first row's reach.
  int k_end = Tk;
  if (causal) k_end = min(k_end, q0 + nq - 1 + kv_offset + 1);
  int k_beg = 0;
  if (window >= 0) k_beg = max(0, q0 + kv_offset - window + 1);
  const int t_beg = k_beg / kBlockK;
  const int t_end = k_end > 0 ? (k_end + kBlockK - 1) / kBlockK : 0;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][C];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }
  float* pw = p_s + warp * kRowsPerWarp * kBlockK;
  const int row0 = warp * kRowsPerWarp;

  for (int t = t_beg; t < t_end; ++t) {
    const int k0 = t * kBlockK;
    const int nk = min(kBlockK, Tk - k0);
    __syncthreads();                 // the previous tile is consumed; q_s is written
    for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
      const int s = i / D, d = i - s * D;
      float kv = 0.f, vv = 0.f;
      if (s < nk) {
        const size_t off = kv_base + (size_t)k0 * D + i;
        kv = to_float(k[off]);
        vv = to_float(v[off]);
      }
      k_s[s * (D + 1) + d] = kv;
      v_s[i] = vv;
    }
    __syncthreads();

    // q.k: lane owns keys lane + 32 * j of the tile, for all 8 rows.
    float x[kRowsPerWarp][kKeysPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) x[r][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kd[kKeysPerLane];
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) kd[j] = k_s[(lane + 32 * j) * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float qd = q_s[(row0 + r) * D + d];
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j) x[r][j] = fmaf(qd, kd[j], x[r][j]);
      }
    }

    // Online softmax per row; p goes to the warp's slice of shared memory.
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + r;
      const int qpos = q0 + row + kv_offset;
      bool valid[kKeysPerLane];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        const int key = lane + 32 * j;
        const int kpos = k0 + key;
        bool ok = key < nk && row < nq;
        if (causal) ok = ok && kpos <= qpos;
        if (window >= 0) ok = ok && kpos > qpos - window;
        float logit = x[r][j] * scale;
        if (softcap > 0.f) logit = softcap * tanhf(logit / softcap);
        valid[j] = ok;
        x[r][j] = logit;
        if (ok) mx = fmaxf(mx, logit);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        const float p = valid[j] ? expf(x[r][j] - m_new) : 0.f;
        pw[r * kBlockK + lane + 32 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[r] = l[r] * corr + psum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= corr;
    }
    __syncwarp();

    // p.V: lane owns columns lane + 32 * c.
    for (int s = 0; s < nk; ++s) {
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? v_s[s * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = pw[r * kBlockK + s];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= nq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = lane + 32 * c;
      if (d < D) out[q_base + (size_t)row * D + d] = from_float<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int C>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Hq,
                   int Hkv, int Tq, int Tk, int D, int causal, int window, int kv_offset,
                   float scale, float softcap, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBlockQ * D + (size_t)kBlockK * (D + 1) + (size_t)kBlockK * D +
                       (size_t)kWarps * kRowsPerWarp * kBlockK);
  // Raise the dynamic shared-memory limit once per instantiation and size
  // (not on every launch, so launches can be captured in a CUDA graph).
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  dim3 grid((Tq + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_attention_kernel<T, C><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Hq, Hkv, Tq, Tk, D, causal, window, kv_offset, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, int B, int Hq,
                     int Hkv, int Tq, int Tk, int D, int causal, int window, int kv_offset,
                     float scale, float softcap, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 1>(q, k, v, out, B, Hq, Hkv, Tq, Tk, D, causal, window, kv_offset, scale,
                        softcap, stream);
  if (D <= 64)
    return launch<T, 2>(q, k, v, out, B, Hq, Hkv, Tq, Tk, D, causal, window, kv_offset, scale,
                        softcap, stream);
  if (D <= 128)
    return launch<T, 4>(q, k, v, out, B, Hq, Hkv, Tq, Tk, D, causal, window, kv_offset, scale,
                        softcap, stream);
  if (D <= 256)
    return launch<T, 8>(q, k, v, out, B, Hq, Hkv, Tq, Tk, D, causal, window, kv_offset, scale,
                        softcap, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, Hq, Tq, D), k and v (B, Hkv, Tk, D) and out (B, Hq, Tq, D), all
// contiguous in one dtype (0 = f32, 1 = bf16); Hq % Hkv == 0; D a multiple
// of 16 up to 256; causal 0/1; window < 0 means none; softcap <= 0 means
// none; kv_offset >= 0.  Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int Hq, int Hkv, int Tq, int Tk, int D,
                                      int causal, int window, int kv_offset, float scale,
                                      float softcap, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == kF32) {
    e = launch_d<float>(q, k, v, out, B, Hq, Hkv, Tq, Tk, D, causal, window, kv_offset, scale,
                        softcap, s);
  } else if (dtype == kBF16) {
    e = launch_d<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Tq, Tk, D, causal, window,
                                kv_offset, scale, softcap, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return (int)e;
}
