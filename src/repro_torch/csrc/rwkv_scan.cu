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
// Numerics: every product and sum of the state update is rounded once
// (__fmul_rn / __fadd_rn, never contracted to an FMA) in the plain
// version's order, w_i S_ij + k_i v_j, so the final state is the plain
// version's bit for bit; each of out's terms is formed as the plain version
// forms it, r_i (S_ij + u_i (k_i v_j)), and only their sum over the k-dim
// runs in another order (FMAs over a thread's 8 rows, then the row groups
// added in order), which ref.rwkv6_scan_order_bound covers.
//
// What bounds it on the H100, per launch: max(bytes / 3.35 TB/s,
// flops / 67 TFLOP/s) with bytes = itemsize * 5 * B * H * T * D (r, k, v, w
// read once, out written once) + 4 * B * H * D * D (the final state) and
// flops = 5 * D * D per (b, h, t) on the f32 CUDA cores, what the function
// needs: 3 D^2 for the update w S + k v, 2 D^2 for sum_i r_i S_ij, and O(D)
// for v_j sum_i r_i u_i k_i.  At the forward shape of rwkv6-7b (B 4, H 64,
// T 512, D 64, bf16) that is 88.1 MB (26.3 us) against 2.68 GFLOP
// (40.1 us): bound by operations.  This kernel issues 6 f32 instructions per
// state element and step (the plain version's order), so filling every f32
// lane of the card would take ~96 us.
//
// What the design does about it: the serial time axis stays a loop inside a
// block, and the parallel work around it is cut finer than one block per
// (b, h), so that the card has enough warps to hide each step's latency.
//  * Column j of the state evolves alone (S[:, j] and out_j need only column
//    j and the row vectors r, k, w, u), so a block takes kCols = 32 columns
//    of one (b, h) (all D when D < 32): grid (B * H, D / 32), 512 blocks at
//    the forward shape, 128 at B 1.  r, k and w are read again by the
//    D / 32 blocks of a head, from L2.
//  * The D rows of the k-dim are split over G = D / 8 row groups of 16
//    threads (2 * D threads per block at D 64): each thread holds an 8 x 2
//    tile of the state (8 rows, 2 columns) and u for its rows in registers,
//    so every row value it reads from shared memory serves two columns, and
//    a step is 16 independent updates and two 8-long FMA chains; the loop
//    body interleaves two steps.  The G partial sums of each out_j are
//    written to shared memory and added in a fixed order once per staged
//    chunk of kSteps steps, not once per step.
//  * Chunks of r, k, w and the block's columns of v are staged with
//    cp.async, the next chunk in flight while the current one is consumed;
//    bf16 chunks are widened to f32 once per chunk by the whole block, 8
//    values per 16-byte load, not by every thread at every use.
// The f32 issue slots and the shared-memory reads of the row vectors (each
// 16-byte read feeds 8 state elements) are what is left.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 16;      // time steps per staged chunk
constexpr int kRows = 8;        // state rows (k-dim) per thread
constexpr int kColsPerThread = 2;  // read and written as one float2
constexpr int kColsMax = 32;    // state columns (v-dim) per block, at most
constexpr int kInFlight = 2;    // time steps a thread's loop body interleaves

// The cut of a (b, h) for head dim D: kCols columns per block, taken by
// kCols / 2 column pairs x D / 8 row groups of threads.
template <int D>
struct Cut {
  static constexpr int kCols = D < kColsMax ? D : kColsMax;
  static constexpr int kPairs = kCols / kColsPerThread;
  static constexpr int kGroups = D / kRows;
  static constexpr int kThreads = kPairs * kGroups;
};

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One staged chunk: r, k, w (kSteps, D) and the block's columns of v.
template <typename E, int D>
struct Chunk {
  E r[kSteps][D];
  E k[kSteps][D];
  E w[kSteps][D];
  E v[kSteps][Cut<D>::kCols];
};

// Start the copies of n steps from element offset `off` (b, h, t0) into c:
// r, k and w are n * D contiguous elements each, v the block's kCols
// columns of each step.
template <typename T, int D>
__device__ __forceinline__ void stage(Chunk<T, D>& c, const T* __restrict__ r,
                                      const T* __restrict__ k, const T* __restrict__ v,
                                      const T* __restrict__ w, size_t off, int j0, int n) {
  constexpr int P = 16 / sizeof(T);               // elements per 16-byte copy
  constexpr int kCols = Cut<D>::kCols, kStride = Cut<D>::kThreads * P;
  for (int e = threadIdx.x * P; e < n * D; e += kStride) {
    cp_async16(&c.r[0][0] + e, r + off + e);
    cp_async16(&c.k[0][0] + e, k + off + e);
    cp_async16(&c.w[0][0] + e, w + off + e);
  }
  for (int e = threadIdx.x * P; e < n * kCols; e += kStride)
    cp_async16(&c.v[0][0] + e, v + off + (size_t)(e / kCols) * D + j0 + e % kCols);
}

// bf16 -> f32 of n live steps of a staged chunk, 8 values per 16-byte load
__device__ __forceinline__ void widen8(const __nv_bfloat16* from, float* to) {
  const uint4 x = *reinterpret_cast<const uint4*>(from);
  const unsigned xs[4] = {x.x, x.y, x.z, x.w};
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {                   // a bf16 is a float's top half
    f[2 * i] = __uint_as_float(xs[i] << 16);
    f[2 * i + 1] = __uint_as_float(xs[i] & 0xFFFF0000u);
  }
  reinterpret_cast<float4*>(to)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(to)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

template <int D>
__device__ __forceinline__ void widen(const Chunk<__nv_bfloat16, D>& src,
                                      Chunk<float, D>& dst, int n) {
  constexpr int kStride = Cut<D>::kThreads * 8;
  for (int e = threadIdx.x * 8; e < n * D; e += kStride) {
    widen8(&src.r[0][0] + e, &dst.r[0][0] + e);
    widen8(&src.k[0][0] + e, &dst.k[0][0] + e);
    widen8(&src.w[0][0] + e, &dst.w[0][0] + e);
  }
  for (int e = threadIdx.x * 8; e < n * Cut<D>::kCols; e += kStride)
    widen8(&src.v[0][0] + e, &dst.v[0][0] + e);
}

// out's partials, one row of G * kCols per step; +16 puts consecutive steps
// on other banks
template <int D>
using Partials = float[kSteps][Cut<D>::kGroups * Cut<D>::kCols + 16];

template <typename T, int D>
struct Smem {                                     // bf16: raw copies, widened once
  Chunk<T, D> raw[2];
  Chunk<float, D> wide;
  Partials<D> part;
};

template <int D>
struct Smem<float, D> {                           // f32: consumed as copied
  Chunk<float, D> raw[2];
  Partials<D> part;
};

// One time step for a thread's 8 rows x kColsPerThread columns: out's
// partial sums and the state update, each product and sum rounded as the
// plain version rounds it.
template <int D>
__device__ __forceinline__ void step(const Chunk<float, D>& c, int s, int i0, int col,
                                     const float (&uu)[kRows],
                                     float (&S)[kRows][kColsPerThread], float* part) {
  const float2 v2 = *reinterpret_cast<const float2*>(&c.v[s][col]);
  const float vj[kColsPerThread] = {v2.x, v2.y};
  const float4* r4 = reinterpret_cast<const float4*>(&c.r[s][i0]);
  const float4* k4 = reinterpret_cast<const float4*>(&c.k[s][i0]);
  const float4* w4 = reinterpret_cast<const float4*>(&c.w[s][i0]);
  float acc[kColsPerThread];
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) acc[j] = 0.f;
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q) {
    const float4 rq = r4[q], kq = k4[q], wq = w4[q];
    const float rr[4] = {rq.x, rq.y, rq.z, rq.w};
    const float kk[4] = {kq.x, kq.y, kq.z, kq.w};
    const float ww[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * q + e;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float kv = __fmul_rn(kk[e], vj[j]);
        acc[j] = fmaf(rr[e], __fadd_rn(S[i][j], __fmul_rn(uu[i], kv)), acc[j]);
        S[i][j] = __fadd_rn(__fmul_rn(ww[e], S[i][j]), kv);
      }
    }
  }
  *reinterpret_cast<float2*>(part) = make_float2(acc[0], acc[1]);
}

template <typename T, int D>
__global__ void __launch_bounds__(Cut<D>::kThreads)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const float* __restrict__ u, T* __restrict__ out,
                  float* __restrict__ state, int H, int T_len) {
  using C = Cut<D>;
  constexpr bool kF32In = sizeof(T) == 4;         // f32 input: consumed as copied
  __shared__ __align__(16) Smem<T, D> sm;

  const int bh = blockIdx.x;
  const int h = bh % H;
  const int j0 = blockIdx.y * C::kCols;
  const int pair = threadIdx.x % C::kPairs, g = threadIdx.x / C::kPairs;
  const int col = pair * kColsPerThread, i0 = g * kRows;
  const size_t base = (size_t)bh * T_len * D;

  float S[kRows][kColsPerThread], uu[kRows];
#pragma unroll
  for (int e = 0; e < kRows; ++e) {
    uu[e] = u[(size_t)h * D + i0 + e];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) S[e][j] = 0.f;
  }

  // out for the n steps of chunk c from its partials: the row groups' sums
  // added in group order
  auto combine = [&](int c, int n) {
    for (int o = threadIdx.x; o < n * C::kCols; o += C::kThreads) {
      const int s = o / C::kCols, j = o % C::kCols;
      float sum = sm.part[s][j];
#pragma unroll
      for (int q = 1; q < C::kGroups; ++q) sum += sm.part[s][q * C::kCols + j];
      out[base + (size_t)(c * kSteps + s) * D + j0 + j] = from_float<T>(sum);
    }
  };

  const int n_chunks = (T_len + kSteps - 1) / kSteps;
  stage<T, D>(sm.raw[0], r, k, v, w, base, j0, min(kSteps, T_len));
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kSteps, n = min(kSteps, T_len - t0);
    cp_async_wait<0>();                           // chunk c's copies of this thread
    __syncthreads();        // ... and of every thread; chunk c - 1 is consumed
    if (c + 1 < n_chunks)   // into the buffer chunk c - 1 was read from
      stage<T, D>(sm.raw[(c + 1) & 1], r, k, v, w, base + (size_t)(t0 + kSteps) * D, j0,
                  min(kSteps, T_len - t0 - kSteps));
    cp_async_commit();
    if (c > 0) combine(c - 1, kSteps);
    const Chunk<float, D>* cur;
    if constexpr (kF32In) {
      cur = &sm.raw[c & 1];
    } else {
      widen<D>(sm.raw[c & 1], sm.wide, n);
      cur = &sm.wide;
    }
    __syncthreads();        // the widened chunk is in; chunk c - 1's out is read
    int s = 0;
    for (; s + kInFlight <= n; s += kInFlight) {  // kInFlight steps interleaved
#pragma unroll
      for (int q = 0; q < kInFlight; ++q)
        step<D>(*cur, s + q, i0, col, uu, S, &sm.part[s + q][g * C::kCols + col]);
    }
    for (; s < n; ++s) step<D>(*cur, s, i0, col, uu, S, &sm.part[s][g * C::kCols + col]);
  }
  __syncthreads();
  combine(n_chunks - 1, T_len - (n_chunks - 1) * kSteps);
  float* st = state + (size_t)bh * D * D + (size_t)i0 * D + j0 + col;
#pragma unroll
  for (int e = 0; e < kRows; ++e)
    *reinterpret_cast<float2*>(st + (size_t)e * D) = make_float2(S[e][0], S[e][1]);
}

template <typename T, int D>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const float* u, void* out, float* state, int B, int H, int T_len,
                   cudaStream_t stream) {
  const dim3 grid(B * H, D / Cut<D>::kCols);
  rwkv6_scan_kernel<T, D><<<grid, Cut<D>::kThreads, 0, stream>>>(
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

// r, k, v, w (B, H, T, D) contiguous and 16-byte aligned in one dtype (0 =
// f32, 1 = bf16), u (H, D) f32, out (B, H, T, D) in that dtype and state
// (B, H, D, D) f32, all contiguous; D in {16, 32, 64}; B, H, T >= 1.
// Returns the cudaError_t of the launch (0 = success).
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
