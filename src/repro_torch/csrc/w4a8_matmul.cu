// W4A8 matmul for Hopper (sm_90a): int8 activations x INT4 weight codes on
// the int8 tensor cores, from the codes packed two per byte.
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
// every weight code once.  Packed two per byte that is K*N/2 bytes at
// 3.35 TB/s (tinyllama's w1: 5.8 MB -> 1.7 us); the activations (M*K bytes)
// and the output are small.  At this M most launches are so small that the
// fixed cost of a launch and of the first DRAM round trip sets what is left.
//
// What the design does about it:
//  * The weights are the A operand (N fills the MMA's 16 rows) and the <= 8
//    activation rows the B operand (the n = 8 side): mma.sync m16n8k32
//    .s32.s8.s8 sums exactly in int32.  A product over k does not depend on
//    the order of k, so the kernel takes each (16 n x 64 k) tile's k in the
//    order that makes every operand one 16-byte load per lane: lane
//    (g, t) = (lane / 4, lane % 4) reads activation row g's bytes
//    k0 + 16t .. k0 + 16t + 15 straight from qx (words x, y feed the first
//    MMA's B fragment, z, w the second), and the weights come in the same
//    order in the kernel's own layout, made once when the model's device
//    weights are built (kernels/w4a8_matmul.py::pack_codes): two codes per
//    byte, K padded to 64 and N to 16 with zero codes, byte b of word j of
//    the lane holding code(row g, k0 + 16t + 4j + b) in its low nibble and
//    code(row g + 8, same k) in its high nibble.
//  * A nibble becomes a byte by moving it to the byte's high half,
//    (w << 4) & 0xF0F0F0F0 or w & 0xF0F0F0F0, which is 16 * code as a
//    signed byte; the int32 sum is then 16 * acc, exact while |16 * acc| <
//    2^31 (the wrapper caps K at 65,536), and one arithmetic shift recovers
//    acc.
//  * Each thread streams both of its operands, tile by tile, through a
//    private ring of kRing cp.async stages in shared memory (the
//    activations' copies zero-fill rows past M and k past K), so the copies
//    need no registers and no barrier, and no block waits to stage its
//    activations before its first MMA.
//  * Work split, from shapes only (kernels/w4a8_matmul.py::launch_plan):
//    each warp owns one 16-row n tile and a K range; a block's 8 warps are
//    wn n tiles x wk K ranges; the ck blocks of a thread-block cluster split
//    K further.  The int32 partials meet in shared memory, then across the
//    cluster through distributed shared memory: each block stores its sums
//    into the block that finishes those outputs, and one cluster barrier
//    later every block finishes its share from its own shared memory.  One
//    launch per call, no global workspace, no atomics, no memset.
//  * The scales of a thread's outputs are loaded before the weight stream,
//    so their DRAM latency is hidden; the epilogue waits on nothing but the
//    cluster barrier.
//  * The scales are applied in registers, (float(acc) * x_scale) * w_scale
//    with two rounded multiplies (no FMA contraction, no fast math).
// Activation rows past 8 go to more blocks along gridDim.z, each reading the
// weights again; decode never has more than 8.  What is left at tinyllama's
// shapes is a few microseconds per launch of fixed cost (the launch, the
// first DRAM round trip, the cluster barrier and the output's write), which
// only fewer launches remove; each warp also reads its activations again
// from L2 for every n tile, as many bytes as the packed weights at M 8
// (PERF.md).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;             // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kTileN = 16;            // weight rows (output columns) per warp tile
constexpr int kTileK = 64;            // K of one packed tile: two k32 MMAs
constexpr int kTileM = 8;             // activation rows: the MMA's n = 8 side
constexpr int kRing = 4;              // cp.async stages per thread
constexpr int kRingBytes = kRing * 2 * kThreads * 16;  // weights + activations
constexpr int kOuts = kWarps * kTileM * kTileN;      // a block's partials, at most
constexpr int kOutsPerThread = kOuts / kThreads;
constexpr int kRedBytes = kOuts * 4;
constexpr int kRecvBytes = (kOuts + 16) * 4;         // [ck][share] from the cluster
constexpr int kSmem = kRingBytes + kRedBytes + kRecvBytes;   // 41 KB: no opt-in

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

// 16-byte copy of src_bytes <= 16 bytes, zeros after them (the masked M and
// K edges)
__device__ __forceinline__ void cp_async16z(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename OutT>
__device__ __forceinline__ OutT from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ int split_begin(int split, int splits, int k_tiles) {
  return (int)((long long)split * k_tiles / splits);
}

// Row g of this M tile, bytes k .. k + 15 of qx, zeros past M and K, by
// plain loads (the path for K % 16 != 0 or an unaligned qx).
__device__ __forceinline__ uint4 load_act(const int8_t* __restrict__ qx, int row, int M,
                                          int K, int k) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
  if (row < M) {
    const int8_t* src = qx + (size_t)row * K;
    for (int b = 0; b < 16 && k + b < K; ++b)
      w[b >> 2] |= (unsigned)(uint8_t)src[k + b] << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// grid (ceil(n_tiles / wn), ck, ceil(M / 8)), cluster (1, ck, 1), kThreads.
// Dynamic shared memory: the ring [kRing][weights, activations][kThreads]
// of 16 bytes, the warps' partials [wk][8][wn * 16] int32 and the
// cluster's sums for this block's share of the outputs [ck][share] int32.
// vec16: K % 16 == 0 and qx 16-byte aligned (the activations ride the ring).
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
w4a8_mma_kernel(const int8_t* __restrict__ qx, const float* __restrict__ x_scale,
                const uint4* __restrict__ packed, const float* __restrict__ w_scale,
                OutT* __restrict__ out, int M, int N, int K, int wn, int wk,
                int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);
  int32_t* red = reinterpret_cast<int32_t*>(smem + kRingBytes);
  int32_t* recv = reinterpret_cast<int32_t*>(smem + kRingBytes + kRedBytes);

  cg::cluster_group cluster = cg::this_cluster();
  const int ck = (int)gridDim.y;       // the cluster spans gridDim.y
  const int rank = (int)blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int w_n = warp % wn, w_k = warp / wn;
  const int n_tiles = (N + kTileN - 1) / kTileN;
  const int k_tiles = (K + kTileK - 1) / kTileK;
  const int splits = wk * ck;
  const int n_tile = blockIdx.x * wn + w_n;
  const int kt0 = split_begin(rank * wk + w_k, splits, k_tiles);
  const int kt1 = split_begin(rank * wk + w_k + 1, splits, k_tiles);
  const int m0 = blockIdx.z * kTileM;
  const int n_steps = n_tile < n_tiles ? kt1 - kt0 : 0;
  const int ldr = wn * kTileN;
  const int outs = kTileM * ldr;                  // this block's (m, n) outputs
  const int share = (outs + ck - 1) / ck;         // those each rank finishes
  const int o_begin = rank * share, o_end = min(outs, o_begin + share);

  // the scales of the outputs this thread finishes, loaded now so that their
  // latency hides behind the weight stream
  float xsv[kOutsPerThread], wsv[kOutsPerThread];
#pragma unroll
  for (int j = 0; j < kOutsPerThread; ++j) {
    const int o = o_begin + threadIdx.x + j * kThreads;
    const int m = m0 + o / ldr, n = blockIdx.x * ldr + o % ldr;
    const bool ok = o < o_end && m < M && n < N;
    xsv[j] = ok ? x_scale[m] : 0.f;
    wsv[j] = ok ? w_scale[n] : 0.f;
  }

  // the lane's operands of tile kt0 + i: weights from the packed layout,
  // activations from row g of this M tile, bytes 64 (kt0 + i) + 16t ..
  const uint4* wsrc = packed + ((size_t)n_tile * k_tiles + kt0) * 32 + lane;
  const int row = m0 + g;
  const int8_t* xsrc = qx + (size_t)(row < M ? row : 0) * K + kt0 * kTileK + 16 * t;
  const int x_left = row < M ? K - kt0 * kTileK - 16 * t : 0;   // bytes to K
  uint4* wslot = ring + threadIdx.x;
  uint4* xslot = ring + kThreads + threadIdx.x;
  auto fetch = [&](int i) {
    const int slot = (i % kRing) * 2 * kThreads;
    cp_async16(wslot + slot, wsrc + (size_t)i * 32);
    if (vec16) {
      const int bytes = min(16, max(0, x_left - i * kTileK));
      cp_async16z(xslot + slot, bytes ? xsrc + i * kTileK : qx, bytes);
    }
  };
#pragma unroll
  for (int s = 0; s < kRing; ++s) {
    if (s < n_steps) fetch(s);
    cp_async_commit();
  }

  int acc[4] = {0, 0, 0, 0};
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<kRing - 1>();           // tile i has landed
    const int slot = (i % kRing) * 2 * kThreads;
    const uint4 p = wslot[slot];
    const uint4 xb = vec16 ? xslot[slot]
                           : load_act(qx, row, M, K, (kt0 + i) * kTileK + 16 * t);
    mma_s8(acc, (p.x << 4) & 0xF0F0F0F0u, p.x & 0xF0F0F0F0u, (p.y << 4) & 0xF0F0F0F0u,
           p.y & 0xF0F0F0F0u, xb.x, xb.y);
    mma_s8(acc, (p.z << 4) & 0xF0F0F0F0u, p.z & 0xF0F0F0F0u, (p.w << 4) & 0xF0F0F0F0u,
           p.w & 0xF0F0F0F0u, xb.z, xb.w);
    // refill the slot just read: the MMAs above consumed its registers, and
    // a warp issues in order, so the loads have returned before these copies
    if (i + kRing < n_steps) fetch(i + kRing);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // partials: C[n = g (+8)][m = 2t (+1)] of the warp's tile
  int32_t* mine = red + w_k * outs + w_n * kTileN + g;
  mine[(2 * t) * ldr] = acc[0];
  mine[(2 * t + 1) * ldr] = acc[1];
  mine[(2 * t) * ldr + 8] = acc[2];
  mine[(2 * t + 1) * ldr + 8] = acc[3];
  __syncthreads();
  // the block's sum over its wk K ranges, stored into the shared memory of
  // the rank that finishes that output (remote stores, no remote loads)
  for (int o = threadIdx.x; o < outs; o += kThreads) {
    int s = red[o];
    for (int j = 1; j < wk; ++j) s += red[j * outs + o];
    const int owner = o / share;
    cluster.map_shared_rank(recv, owner)[rank * share + o - owner * share] = s;
  }
  cluster.sync();                         // every rank's sums have landed

  // this block's share of the outputs: the ck sums in rank order, then the
  // scales; nothing is read from a peer after the barrier
#pragma unroll
  for (int j = 0; j < kOutsPerThread; ++j) {
    const int o = o_begin + threadIdx.x + j * kThreads;
    const int m = m0 + o / ldr, n = blockIdx.x * ldr + o % ldr;
    if (o < o_end && m < M && n < N) {
      int s = 0;
      for (int r = 0; r < ck; ++r) s += recv[r * share + o - o_begin];
      const float v = __fmul_rn(__fmul_rn(__int2float_rn(s >> 4), xsv[j]), wsv[j]);
      out[(size_t)m * N + n] = from_float<OutT>(v);
    }
  }
}

template <typename OutT>
cudaError_t launch(const int8_t* qx, const float* x_scale, const uint4* packed,
                   const float* w_scale, OutT* out, int M, int N, int K, int wn, int wk,
                   int ck, int vec16, cudaStream_t stream) {
  static_assert(kSmem <= 48 * 1024, "above 48 KB a launch needs the opt-in attribute");
  const int n_tiles = (N + kTileN - 1) / kTileN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_tiles + wn - 1) / wn, ck, (M + kTileM - 1) / kTileM);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = ck;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, w4a8_mma_kernel<OutT>, qx, x_scale, packed, w_scale, out,
                            M, N, K, wn, wk, vec16);
}

}  // namespace

// qx (M,K) int8, x_scale (M,1) f32, packed: the codes in pack_codes' layout
// (ceil(N/16), ceil(K/64), 32, 16) uint8, w_scale (N,) f32, all contiguous;
// out (M,N) bf16 (out_f32 = 0) or f32 (out_f32 = 1).  wn * wk = 8, 1 <= ck
// <= 8; vec16 = 1 when K % 16 == 0 and qx is 16-byte aligned.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int w4a8_matmul_launch(const void* qx, const void* x_scale, const void* packed,
                                  const void* w_scale, void* out, int M, int N, int K,
                                  int wn, int wk, int ck, int vec16, int out_f32,
                                  void* stream) {
  if (M < 1 || N < 1 || K < 1 || wn * wk != kWarps || ck < 1 || ck > 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(qx);
  const float* xs = static_cast<const float*>(x_scale);
  const uint4* w = static_cast<const uint4*>(packed);
  const float* ws = static_cast<const float*>(w_scale);
  cudaError_t e;
  if (out_f32) {
    e = launch<float>(a, xs, w, ws, static_cast<float*>(out), M, N, K, wn, wk, ck, vec16,
                      s);
  } else {
    e = launch<__nv_bfloat16>(a, xs, w, ws, static_cast<__nv_bfloat16*>(out), M, N, K, wn,
                              wk, ck, vec16, s);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
