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
// 2.15 GFLOP (2.2 us): byte-bound at 5.0 us, with the tensor cores needed
// to stay near it (the same flops on the CUDA cores' 67 TFLOP/s take 32 us).
//
// Two bodies; the wrapper (kernels/flash_attention.py::body) picks one from
// dtype and D, and nothing falls back from one to the other.
//
// * Tensor-core body (bf16, D in {16, 32, 48, 64, 128}: every head dim of a
//   config in either package, 16, 64 and 128, and the card tests' 48; bf16 at
//   any other D is refused).  A FlashAttention-2 forward.  One block of 4
//   warps per (64-row query tile, query head, batch row); each warp owns 16
//   query rows.  Both products run as mma.sync.m16n8k16 bf16 -> f32 fed by
//   ldmatrix: q.k^T with the warp's q fragments held in registers for the
//   whole K loop (a bf16 x bf16 product is exact in f32, so only the order
//   of the sum differs from the plain version); p.V with p taken from the
//   score accumulators and re-packed in registers.  p stays f32 as the
//   Pallas kernel keeps it: p.V is two bf16 MMAs into one f32 accumulator,
//   p_hi = bf16(p) and p_lo = bf16(p - p_hi), leaving at most ~2^-18 of
//   relative error per weight (a single rounding of p would be 2^-9, the
//   JAX package's other backend).  K and V tiles of 64 keys stream through
//   a double-buffered cp.async ring of 16-byte copies, the next tile's copy
//   in flight while the current one computes; shared-memory rows are padded
//   by 16 bytes so that ldmatrix's eight row addresses hit distinct banks.
//   Row max and sum are quad shuffles in the fragment layout; the element
//   masks (causal, window, ragged Tq/Tk, kv_offset) apply to the score
//   fragments only on tiles that need them, and the loop bounds skip the
//   tiles that causality or the window mask wholly.  The query-tile index
//   is the grid's slow axis and runs backwards, so the heaviest causal
//   tiles start first.  Shared memory: (64 + 4 * 64) rows of D + 8 bf16
//   (87 KB at D = 128, two blocks per SM).
//
// * CUDA-core body (f32 at any D; no path of the port runs f32 on the
//   card): the f32 design of the first port.  One block of 8 warps per
//   64-row query tile; each warp owns 8 rows, the lanes split the keys for
//   q.k and the head dim for p.V; everything in f32 on the CUDA cores,
//   capped by their 67 TFLOP/s.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
__device__ __forceinline__ float minus_inf() { return __int_as_float(0xff800000); }

enum DType { kF32 = 0, kBF16 = 1 };
enum Body { kCudaCore = 0, kTensorCore = 1 };

// The key range [k_beg, k_end) a query tile of rows [q0, q0 + nq) can see:
// causality ends it at the last row's position, the window starts it at the
// first row's reach.
__device__ __forceinline__ void visible_keys(int q0, int nq, int Tk, int causal, int window,
                                             int kv_offset, int& k_beg, int& k_end) {
  k_end = Tk;
  if (causal) k_end = min(k_end, q0 + nq - 1 + kv_offset + 1);
  k_beg = 0;
  if (window >= 0) k_beg = max(0, q0 + kv_offset - window + 1);
}

// ------------------------------------------------------------ tensor cores
namespace tc {

constexpr int kThreads = 128;    // 4 warps, 16 query rows each
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kPad = 8;          // bf16 per smem row: 16 bytes, no ldmatrix bank conflicts
constexpr int kStages = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with pred false the 16 bytes are zero-filled
// and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 -> one register of two bf16 (the lower column in the low half),
// rounded to nearest even: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                          int Hq, int Hkv, int Tq, int Tk, int causal, int window,
                          int kv_offset, float scale, float softcap) {
  constexpr int kStride = D + kPad;   // bf16 per smem row
  constexpr int kChunks = D / 8;      // 16-byte chunks per row
  constexpr int kKSteps = D / 16;     // k-steps of q.k
  constexpr int kDTiles = D / 8;      // 8-column tiles of the output
  static_assert(D % 16 == 0 && D <= 128, "tensor-core body: D a multiple of 16 up to 128");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [kBlockQ][kStride]
  __nv_bfloat16* k_s = q_s + kBlockQ * kStride;                      // [kStages][kBlockK][kStride]
  __nv_bfloat16* v_s = k_s + kStages * kBlockK * kStride;            // [kStages][kBlockK][kStride]

  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;   // heaviest causal tiles first
  const int nq = min(kBlockQ, Tq - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = h / (Hq / Hkv);
  const __nv_bfloat16* qg = q + (((size_t)b * Hq + h) * Tq + q0) * D;
  const __nv_bfloat16* kg = k + ((size_t)b * Hkv + hk) * (size_t)Tk * D;
  const __nv_bfloat16* vg = v + ((size_t)b * Hkv + hk) * (size_t)Tk * D;
  __nv_bfloat16* og = out + (((size_t)b * Hq + h) * Tq + q0) * D;

  int k_beg, k_end;
  visible_keys(q0, nq, Tk, causal, window, kv_offset, k_beg, k_end);
  const int t_beg = k_beg / kBlockK;
  const int t_end = k_end > k_beg ? (k_end + kBlockK - 1) / kBlockK : t_beg;

  // rows past Tq and keys past Tk are zero-filled: finite, and masked below
  for (int i = tid; i < kBlockQ * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < nq;
    cp_async16(smem_addr(q_s + r * kStride + c * 8), ok ? qg + (size_t)r * D + c * 8 : qg, ok);
  }
  auto load_kv = [&](int t, int stage) {
    const int k0 = t * kBlockK;
    __nv_bfloat16* ks = k_s + stage * kBlockK * kStride;
    __nv_bfloat16* vs = v_s + stage * kBlockK * kStride;
    for (int i = tid; i < kBlockK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool ok = k0 + r < Tk;
      const size_t off = ok ? (size_t)(k0 + r) * D + c * 8 : 0;
      cp_async16(smem_addr(ks + r * kStride + c * 8), kg + off, ok);
      cp_async16(smem_addr(vs + r * kStride + c * 8), vg + off, ok);
    }
  };
  if (t_beg < t_end) load_kv(t_beg, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // the warp's 16 q rows as A fragments, for the whole K loop
  const int wrow = warp * 16;
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const int r = wrow + (lane & 7) + ((lane >> 3) & 1) * 8;
    ldmatrix_x4(qf[ks], smem_addr(q_s + r * kStride + ks * 16 + (lane >> 4) * 8));
  }

  // this thread's fragment rows (tile-relative) and their query positions
  const int g = lane >> 2, tig = lane & 3;
  const int qpos[2] = {q0 + wrow + g + kv_offset, q0 + wrow + g + 8 + kv_offset};
  float o[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int t = t_beg; t < t_end; ++t) {
    const int stage = (t - t_beg) & 1;
    if (t + 1 < t_end) load_kv(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile t has landed
    __syncthreads();
    const __nv_bfloat16* ks_ = k_s + stage * kBlockK * kStride;
    const __nv_bfloat16* vs_ = v_s + stage * kBlockK * kStride;
    const int k0 = t * kBlockK;

    // s = q.k^T: 8 key tiles of 8, accumulated over D in steps of 16
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        const int key = np * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(bf, smem_addr(ks_ + key * kStride + ks * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], qf[ks], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[ks], bf[2], bf[3]);
      }
    }

    // Logits, then the masks: a masked element becomes -inf, which the max
    // ignores and exp turns into p = 0.  Each step is one straight-line
    // pass over the 32 fragment elements (the branches are uniform and sit
    // outside the passes, so the compiler can interleave the elements).
    if (softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = softcap * tanhf(s[j][e] * scale / softcap);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale;
    }
    // Does any element of this tile need a mask?  (Rows past Tq hold zero
    // q and are never stored, so they need none.)
    const bool edge = k0 + kBlockK > Tk ||
                      (causal && k0 + kBlockK - 1 > q0 + kv_offset) ||
                      (window >= 0 && k0 <= q0 + nq - 1 + kv_offset - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + j * 8 + tig * 2 + (e & 1);
          const int qp = qpos[e >> 1];
          bool ok = kpos < Tk;
          if (causal) ok = ok && kpos <= qp;
          if (window >= 0) ok = ok && kpos > qp - window;
          s[j][e] = ok ? s[j][e] : minus_inf();
        }
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_run[e >> 1]);
        s[j][e] = p;
        psum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l_run[r] = l_run[r] * corr[r] + psum[r];
    }
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // o += p.V, keys in steps of 16: p's A fragment is the score
    // accumulators of key tiles 2 kk and 2 kk + 1, split hi + lo
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_pack(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pack(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pack(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pack(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, smem_addr(vs_ + key * kStride + dp * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * dp], ph, bf[0], bf[1]);
        mma_bf16(o[2 * dp], pl, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], ph, bf[2], bf[3]);
        mma_bf16(o[2 * dp + 1], pl, bf[2], bf[3]);
      }
    }
    __syncthreads();   // this stage is consumed before the next copy lands in it
  }

  const float den[2] = {fmaxf(l_run[0], 1e-30f), fmaxf(l_run[1], 1e-30f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    if (row >= nq) continue;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      const __nv_bfloat162 pair =
          __floats2bfloat162_rn(o[j][2 * r] / den[r], o[j][2 * r + 1] / den[r]);
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row * D + j * 8 + tig * 2) = pair;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Hq,
                   int Hkv, int Tq, int Tk, int causal, int window, int kv_offset, float scale,
                   float softcap, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(kBlockQ + 2 * kStages * kBlockK) *
                      (D + kPad);
  // Raise the dynamic shared-memory limit once per instantiation (not on
  // every launch, so launches can be captured in a CUDA graph).
  static bool smem_set = false;
  if (smem > 48 * 1024 && !smem_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_attention_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  dim3 grid(B * Hq, (Tq + kBlockQ - 1) / kBlockQ);
  flash_attention_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Hq, Hkv, Tq, Tk,
      causal, window, kv_offset, scale, softcap);
  return cudaGetLastError();
}

cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, int B, int Hq,
                     int Hkv, int Tq, int Tk, int D, int causal, int window, int kv_offset,
                     float scale, float softcap, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<16>(q, k, v, out, B, Hq, Hkv, Tq, Tk, causal, window, kv_offset, scale,
                        softcap, s);
    case 32:
      return launch<32>(q, k, v, out, B, Hq, Hkv, Tq, Tk, causal, window, kv_offset, scale,
                        softcap, s);
    case 48:
      return launch<48>(q, k, v, out, B, Hq, Hkv, Tq, Tk, causal, window, kv_offset, scale,
                        softcap, s);
    case 64:
      return launch<64>(q, k, v, out, B, Hq, Hkv, Tq, Tk, causal, window, kv_offset, scale,
                        softcap, s);
    case 128:
      return launch<128>(q, k, v, out, B, Hq, Hkv, Tq, Tk, causal, window, kv_offset, scale,
                         softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ------------------------------------------------------------- CUDA cores
namespace core {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockQ = 64;                       // query rows per block
constexpr int kRowsPerWarp = kBlockQ / kWarps;    // 8
constexpr int kBlockK = 64;                       // keys per staged tile
constexpr int kKeysPerLane = kBlockK / 32;        // 2

// C = accumulator columns per lane: D <= 32 * C.
template <int C>
__global__ void __launch_bounds__(kThreads)
flash_attention_core_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ out, int Hq, int Hkv,
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
    q_s[i] = i / D < nq ? q[q_base + i] : 0.f;
  }
  int k_beg, k_end;
  visible_keys(q0, nq, Tk, causal, window, kv_offset, k_beg, k_end);
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
        kv = k[off];
        vv = v[off];
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
      if (d < D) out[q_base + (size_t)row * D + d] = acc[r][c] / denom;
    }
  }
}

template <int C>
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
    cudaError_t e = cudaFuncSetAttribute(flash_attention_core_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  dim3 grid((Tq + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_attention_core_kernel<C><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Hq, Hkv, Tq, Tk, D, causal, window, kv_offset, scale, softcap);
  return cudaGetLastError();
}

// f32: every D up to 256.
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, int B, int Hq,
                       int Hkv, int Tq, int Tk, int D, int causal, int window, int kv_offset,
                       float scale, float softcap, cudaStream_t s) {
  if (D <= 32)
    return launch<1>(q, k, v, out, B, Hq, Hkv, Tq, Tk, D, causal, window, kv_offset,
                     scale, softcap, s);
  if (D <= 64)
    return launch<2>(q, k, v, out, B, Hq, Hkv, Tq, Tk, D, causal, window, kv_offset,
                     scale, softcap, s);
  if (D <= 128)
    return launch<4>(q, k, v, out, B, Hq, Hkv, Tq, Tk, D, causal, window, kv_offset,
                     scale, softcap, s);
  if (D <= 256)
    return launch<8>(q, k, v, out, B, Hq, Hkv, Tq, Tk, D, causal, window, kv_offset,
                     scale, softcap, s);
  return cudaErrorInvalidValue;
}

}  // namespace core

}  // namespace

// q (B, Hq, Tq, D), k and v (B, Hkv, Tk, D) and out (B, Hq, Tq, D), all
// contiguous in one dtype (0 = f32, 1 = bf16) and 16-byte aligned; Hq % Hkv
// == 0; D a multiple of 16 up to 256; causal 0/1; window < 0 means none;
// softcap <= 0 means none; kv_offset >= 0.  body 1 = tensor cores (bf16,
// D in {16, 32, 48, 64, 128}), 0 = CUDA cores (f32 at any D); any other
// (body, dtype, D) is refused.  Returns the cudaError_t of the launch (0 =
// success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int Hq, int Hkv, int Tq, int Tk, int D,
                                      int causal, int window, int kv_offset, float scale,
                                      float softcap, int dtype, int body, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (body == kTensorCore && dtype == kBF16) {
    e = tc::launch_d(q, k, v, out, B, Hq, Hkv, Tq, Tk, D, causal, window, kv_offset, scale,
                     softcap, s);
  } else if (body == kCudaCore && dtype == kF32) {
    e = core::launch_f32(q, k, v, out, B, Hq, Hkv, Tq, Tk, D, causal, window, kv_offset, scale,
                         softcap, s);
  }
  return (int)e;
}
