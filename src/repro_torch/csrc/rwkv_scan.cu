// RWKV6 (Finch) WKV recurrence for Hopper (sm_90a): the whole-sequence pass
// of the rwkv family's forward.
//
// Replaces the TPU kernel src/repro/kernels/rwkv_scan.py::rwkv6_scan
// (`_kernel`, pallas_call at rwkv_scan.py:63).  Computes what that kernel
// and the plain version src/repro_torch/kernels/ref.py::rwkv6_scan compute,
// from a zero initial state:
//
//   out_t = r_t (S_{t-1} + diag(u) k_t v_t^T)      (a row vector, (D,))
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T           ((D, D), k-dim x v-dim)
//
// r, k, v, w (B, H, T, D) in one dtype (f32 or bf16), u (H, D) f32; out
// (B, H, T, D) in r's dtype (rounded once, __float2bfloat16_rn for bf16) and
// the final state (B, H, D, D) in f32.  Any T >= 1: the TPU kernel needed T
// to be a multiple of its 256-step time block.
//
// Numerics: every elementwise product and sum of the state update and of
// S + u * (k v) is rounded once (__fmul_rn / __fadd_rn, never contracted to
// an FMA), in the plain version's order, so the carried state is the plain
// version's bit for bit; only out_t's sum over the k-dim runs in another
// order (sequential FMAs here, a batched product there).
//
// What bounds it on the H100, per launch: max(bytes / 3.35 TB/s,
// flops / 67 TFLOP/s) with bytes = itemsize * 5 * B * H * T * D (r, k, v, w
// read once, out written once) + 4 * B * H * D * D (the final state) and
// flops = 5 * D * D per (b, h, t) on the f32 CUDA cores, what the function
// needs: 3 D^2 for the update w S + k v, 2 D^2 for sum_i r_i S_ij, and O(D)
// for v_j sum_i r_i u_i k_i.  (This kernel does 7 D^2: it forms u (k v) and
// S + u (k v) per element, the plain version's order.)  At the forward shape
// of rwkv6-7b (B 4, H 64, T 512, D 64, bf16) that is 88.1 MB (26.3 us)
// against 2.68 GFLOP (40.1 us): bound by operations, 40.1 us.
//
// What the design does about it: nothing yet -- it is the simple design that
// is right.  One block per (b, h) with D threads; thread j owns column j of
// S (D f32 registers), so the recurrence needs no communication between
// threads.  The sequential time axis of the TPU grid becomes a loop inside
// the block: kSteps time steps of r, k, v and w at a time are staged as f32
// in shared memory with coalesced loads (thread j loads element j of every
// step), then every thread walks the steps, reading the staged row vectors
// as broadcasts.  B * H blocks of D threads leave most of each SM's issue
// slots idle at the forward shape (256 blocks of 64 threads on 132 SMs), and
// out_t's 64-term sum is one dependent FMA chain per thread: a redesign
// (several heads per block, the chunked tensor-core form of
// ref.rwkv6_scan_chunked) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 32;   // time steps staged in shared memory at a time

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

template <typename T, int D>
__global__ void __launch_bounds__(D)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const float* __restrict__ u, T* __restrict__ out,
                  float* __restrict__ state, int H, int T_len) {
  __shared__ __align__(16) float r_s[kSteps][D];
  __shared__ __align__(16) float k_s[kSteps][D];
  __shared__ __align__(16) float v_s[kSteps][D];
  __shared__ __align__(16) float w_s[kSteps][D];
  __shared__ __align__(16) float u_s[D];

  const int bh = blockIdx.x;
  const int h = bh % H;
  const int j = threadIdx.x;
  const size_t base = (size_t)bh * T_len * D;

  u_s[j] = u[(size_t)h * D + j];
  float S[D];
#pragma unroll
  for (int i = 0; i < D; ++i) S[i] = 0.f;

  for (int t0 = 0; t0 < T_len; t0 += kSteps) {
    const int n = min(kSteps, T_len - t0);
    __syncthreads();                 // the previous steps are consumed
    for (int s = 0; s < n; ++s) {
      const size_t off = base + (size_t)(t0 + s) * D + j;
      r_s[s][j] = to_float(r[off]);
      k_s[s][j] = to_float(k[off]);
      v_s[s][j] = to_float(v[off]);
      w_s[s][j] = to_float(w[off]);
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const float vj = v_s[s][j];
      const float4* r4 = reinterpret_cast<const float4*>(r_s[s]);
      const float4* k4 = reinterpret_cast<const float4*>(k_s[s]);
      const float4* w4 = reinterpret_cast<const float4*>(w_s[s]);
      const float4* u4 = reinterpret_cast<const float4*>(u_s);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < D / 4; ++q) {
        const float4 rq = r4[q], kq = k4[q], wq = w4[q], uq = u4[q];
        const float rr[4] = {rq.x, rq.y, rq.z, rq.w};
        const float kk[4] = {kq.x, kq.y, kq.z, kq.w};
        const float ww[4] = {wq.x, wq.y, wq.z, wq.w};
        const float uu[4] = {uq.x, uq.y, uq.z, uq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          const float kv = __fmul_rn(kk[e], vj);
          acc = fmaf(rr[e], __fadd_rn(S[i], __fmul_rn(uu[e], kv)), acc);
          S[i] = __fadd_rn(__fmul_rn(ww[e], S[i]), kv);
        }
      }
      out[base + (size_t)(t0 + s) * D + j] = from_float<T>(acc);
    }
  }
  float* st = state + (size_t)bh * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i) st[(size_t)i * D + j] = S[i];
}

template <typename T, int D>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const float* u, void* out, float* state, int B, int H, int T_len,
                   cudaStream_t stream) {
  rwkv6_scan_kernel<T, D><<<B * H, D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, static_cast<T*>(out), state, H, T_len);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* r, const void* k, const void* v, const void* w,
                     const float* u, void* out, float* state, int B, int H, int T_len,
                     int D, cudaStream_t stream) {
  if (D == 16) return launch<T, 16>(r, k, v, w, u, out, state, B, H, T_len, stream);
  if (D == 32) return launch<T, 32>(r, k, v, w, u, out, state, B, H, T_len, stream);
  if (D == 64) return launch<T, 64>(r, k, v, w, u, out, state, B, H, T_len, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// r, k, v, w (B, H, T, D) contiguous in one dtype (0 = f32, 1 = bf16), u
// (H, D) f32, out (B, H, T, D) in that dtype and state (B, H, D, D) f32,
// all contiguous; D in {16, 32, 64}; B, H, T >= 1.  Returns the cudaError_t
// of the launch (0 = success).
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v, const void* w,
                                 const float* u, void* out, float* state, int B, int H,
                                 int T, int D, int dtype, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (dtype == kF32) {
    e = launch_d<float>(r, k, v, w, u, out, state, B, H, T, D, s);
  } else if (dtype == kBF16) {
    e = launch_d<__nv_bfloat16>(r, k, v, w, u, out, state, B, H, T, D, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return (int)e;
}
