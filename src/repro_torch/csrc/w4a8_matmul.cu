// W4A8 matmul for Hopper (sm_90a): int8 activations x INT4 weight codes.
//
// Replaces the TPU kernel src/repro/kernels/w4a8_matmul.py::w4a8_matmul
// (`_kernel`, pallas_call at w4a8_matmul.py:69).  Computes what the oracle
// src/repro/kernels/ref.py::w4a8_matmul computes:
//
//     out[m, n] = bf16( (float(sum_k qx[m,k] * codes[k,n]) * x_scale[m]) * w_scale[n] )
//
// with the sum in exact int32 (never f32 partial sums, unlike the TPU kernel's
// per-K-tile f32 adds) and one round-to-nearest-even to bf16, so the result is
// bit-identical to the plain PyTorch version on the card.
//
// What bounds it on the H100: at decode M (1..8 slots) the work is reading
// every code byte once, K*N bytes at 3.35 TB/s (w1: 11.5 MB -> 3.4 us).  The
// activation row block is tiny and stays in shared memory.
//
// What the design does about it: each thread owns 4 adjacent output columns
// and reads their 4 codes of one K row as one 32-bit load, so a warp reads 128
// contiguous bytes per row.  The 8 warps of a block split the block's K slice
// row by row and reduce their int32 partials through shared-memory atomics.
// K is further split over blockIdx.y so a skinny (small N) matrix still puts
// ~2 blocks on each of the 132 SMs; the slices meet in an int32 workspace
// through global atomicAdd, which is exact and order-independent, so the
// result stays deterministic.  A second small kernel applies the scales.
// Limit: the int32 multiply-adds run on the CUDA cores (~33 TOP/s), so from
// M ~ 4 the kernel turns compute-bound; dp4a over a K-packed layout or s8
// mma/wgmma is the redesign that lifts it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kColsPerBlock = 128;   // 32 lanes x 4 columns

template <int MT>
__global__ void __launch_bounds__(kThreads)
w4a8_accum_kernel(const int8_t* __restrict__ qx, const int8_t* __restrict__ codes,
                  int32_t* __restrict__ acc_out, int M, int N, int K, int kslice,
                  int vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xs = reinterpret_cast<int8_t*>(smem);                   // [MT][kslice]
  int32_t* red = reinterpret_cast<int32_t*>(
      smem + ((MT * kslice + 15) / 16) * 16);                      // [MT][128]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kColsPerBlock + lane * 4;
  const int kbeg = blockIdx.y * kslice;
  const int klen = min(K, kbeg + kslice) - kbeg;
  if (klen <= 0) return;  // uniform over the block

  for (int m0 = 0; m0 < M; m0 += MT) {
    const int mt = min(MT, M - m0);
    // stage this M tile's K slice of qx (rows past M are zero)
    for (int i = threadIdx.x; i < MT * klen; i += kThreads) {
      const int r = i / klen, c = i - r * klen;
      xs[r * kslice + c] = r < mt ? qx[(size_t)(m0 + r) * K + kbeg + c] : int8_t(0);
    }
    for (int i = threadIdx.x; i < MT * kColsPerBlock; i += kThreads) red[i] = 0;
    __syncthreads();

    int acc[MT][4];
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0;
    }
    for (int k = warp; k < klen; k += kWarps) {
      const int8_t* row = codes + (size_t)(kbeg + k) * N;
      int c0, c1, c2, c3;
      if (vec4 && n0 + 3 < N) {
        const int packed = __ldg(reinterpret_cast<const int*>(row + n0));
        c0 = static_cast<signed char>(packed);   // sign-extend each byte
        c1 = static_cast<signed char>(packed >> 8);
        c2 = static_cast<signed char>(packed >> 16);
        c3 = static_cast<signed char>(packed >> 24);
      } else {
        c0 = n0 < N ? row[n0] : 0;
        c1 = n0 + 1 < N ? row[n0 + 1] : 0;
        c2 = n0 + 2 < N ? row[n0 + 2] : 0;
        c3 = n0 + 3 < N ? row[n0 + 3] : 0;
      }
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const int a = xs[r * kslice + k];
        acc[r][0] += a * c0;
        acc[r][1] += a * c1;
        acc[r][2] += a * c2;
        acc[r][3] += a * c3;
      }
    }
    // reduce the warps' partials in shared memory, then one global atomic
    // per (row, column) for this block's K slice
#pragma unroll
    for (int r = 0; r < MT; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) atomicAdd(&red[r * kColsPerBlock + lane * 4 + j], acc[r][j]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < mt * kColsPerBlock; i += kThreads) {
      const int r = i / kColsPerBlock, c = i - r * kColsPerBlock;
      const int n = blockIdx.x * kColsPerBlock + c;
      if (n < N) atomicAdd(&acc_out[(size_t)(m0 + r) * N + n], red[i]);
    }
    __syncthreads();
  }
}

template <typename OutT>
__device__ __forceinline__ OutT from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void w4a8_epilogue_kernel(const int32_t* __restrict__ acc,
                                     const float* __restrict__ x_scale,
                                     const float* __restrict__ w_scale,
                                     OutT* __restrict__ out, int M, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int m = (int)(i / N), n = (int)(i - (size_t)m * N);
  // two separate multiplies in this order (no add, so no FMA contraction)
  const float v = (__int2float_rn(acc[i]) * x_scale[m]) * w_scale[n];
  out[i] = from_float<OutT>(v);
}

template <int MT>
cudaError_t launch_accum(const int8_t* qx, const int8_t* codes, int32_t* acc, int M,
                         int N, int K, int kslice, int ksplit, int vec4,
                         cudaStream_t stream) {
  const size_t smem = ((MT * kslice + 15) / 16) * 16 + MT * kColsPerBlock * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(w4a8_accum_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((N + kColsPerBlock - 1) / kColsPerBlock, ksplit);
  w4a8_accum_kernel<MT><<<grid, kThreads, smem, stream>>>(qx, codes, acc, M, N, K,
                                                          kslice, vec4);
  return cudaGetLastError();
}

}  // namespace

// qx (M,K) int8, x_scale (M,1) f32, codes (K,N) int8, w_scale (N,) f32, all
// contiguous; acc (M,N) int32 zero-filled workspace; out (M,N) bf16
// (out_f32 = 0) or f32 (out_f32 = 1).  m_tile in {1,2,4,8}.  Returns the
// cudaError_t of the launches (0 = success).
extern "C" int w4a8_matmul_launch(const void* qx, const void* x_scale, const void* codes,
                                  const void* w_scale, void* acc, void* out, int M,
                                  int N, int K, int m_tile, int kslice, int ksplit,
                                  int vec4, int out_f32, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(qx);
  const int8_t* w = static_cast<const int8_t*>(codes);
  int32_t* ws = static_cast<int32_t*>(acc);
  cudaError_t e;
  switch (m_tile) {
    case 1: e = launch_accum<1>(a, w, ws, M, N, K, kslice, ksplit, vec4, s); break;
    case 2: e = launch_accum<2>(a, w, ws, M, N, K, kslice, ksplit, vec4, s); break;
    case 4: e = launch_accum<4>(a, w, ws, M, N, K, kslice, ksplit, vec4, s); break;
    case 8: e = launch_accum<8>(a, w, ws, M, N, K, kslice, ksplit, vec4, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)M * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  const float* xsc = static_cast<const float*>(x_scale);
  const float* wsc = static_cast<const float*>(w_scale);
  if (out_f32) {
    w4a8_epilogue_kernel<float><<<blocks, threads, 0, s>>>(ws, xsc, wsc,
                                                           static_cast<float*>(out), M, N);
  } else {
    w4a8_epilogue_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        ws, xsc, wsc, static_cast<__nv_bfloat16*>(out), M, N);
  }
  return (int)cudaGetLastError();
}
