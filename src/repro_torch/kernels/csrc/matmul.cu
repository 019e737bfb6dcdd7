// Hand-written Hopper (sm_90a) matmul kernels of the port.
//
// Replaces the TPU kernels in repro/kernels/matmul.py:
//   * matmul       (pallas_call at matmul.py:90; bodies _mm_kernel:41,
//                   _mm_bias_kernel:54, _epilogue:25): y = act(x @ w + b)
//   * gated_matmul (pallas_call at matmul.py:132; body :115):
//                   y = act(x @ w1) * (x @ w1b), one staged x tile feeding
//                   two fp32 accumulators; for training it also writes the
//                   fp32 products x @ w1 and x @ w1b, which the SwiGLU
//                   backward (swiglu_bwd.cu) reads;
// and repro/kernels/ring_matmul.py:
//   * _tile_mm_call (pallas_call at ring_matmul.py:225, reached through
//                   _tile_mm_raw:236 and the tile_matmul:268 custom_vjp):
//                   the same tile loop with an out_dtype option, whose
//                   backward (_tile_mm_bwd:285) runs dx = g w^T and
//                   dw = x^T g through the loop again.  hk_tile_matmul takes
//                   the three layouts those products need, NN (x w), NT
//                   (g w^T, and the tied head x table^T) and TN (x^T g), by
//                   reading the transposed operand in place: no operand is
//                   ever copied to another layout.
// act is none, relu2, tanh-GELU or SiLU; sums are fp32 and the output is
// stored in the input dtype (fp32 or bf16), or in fp32 for the tile matmul
// when asked (the head logits of the training loss).  Each operand's stored
// row length must be a multiple of 8 (16-byte vector loads) for matmul and
// gated_matmul; the tile matmul takes any extent.  Everything else is free:
// ragged edges are masked here, unlike the Pallas kernel which asserts
// divisibility.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16):
//   * decode (M = number of slots, 4) is weight-byte bound: every weight
//     byte is read once per step, about 1.19 GB for qwen3-0.6b in bf16,
//     so about 0.36 ms per step at the memory rate.
//   * prefill, training (M = 2048 tokens per microbatch, and the dw
//     products with M = d_in, K = 2048) and head matmuls are near the FLOP
//     bound (2*M*K*N operations against (M*K + K*N + M*N) * 2 bytes; the
//     training head 2048 x 1024 x 152064 is 0.64 TFLOP, 0.65 ms at peak,
//     and writes 1.25 GB of fp32 logits, 0.37 ms at the memory rate).
//
// Five paths; the wrapper (kernels/matmul.py, mm_impl) picks one from the
// dtype, the shapes and the strides alone, never from whether a launch failed:
//   * wgmma (namespace wg below): bf16 with M > 16 in matmul and gated_matmul,
//     every bf16 tile matmul whose operands TMA can address (stored rows,
//     leading dims and bases on 16 bytes).  Persistent blocks, a producer warp
//     feeding a ring of TMA stages, two consumer warpgroups on wgmma with fp32
//     accumulators in registers, the epilogue (bias, act, bf16 or fp32) stored
//     straight from them; the tile width (128 or 256) and a split of K over an
//     fp32 workspace come from the wrapper's wg_plan so that small products
//     still fill the 132 SMs.  The gated form (mm_gated) stages one x tile and
//     both weights' tiles a stage and keeps two accumulators.  Only this path
//     reaches the tensor cores' full rate.
//   * gemv (namespace gv): bf16 with M <= 16 (decode), plain and gated.  Bound
//     by the weight bytes: TMA streams 128-column weight panels through a ring
//     of stages, x is staged once a block, mma.sync m16n8k16 (x as A, rows past
//     M zero) keeps the arithmetic off the CUDA cores, and a K split is summed
//     in split order inside the same launch.
//   * wmma (mm_tc_bf16): bf16 operands TMA cannot address (the ring
//     backward's ragged dw products, stored rows off 8 elements, read element
//     by element): BK = 32 tiles staged through shared memory with register
//     prefetch, WMMA m16n16k16 (mma.sync), a fraction of the peak.  Kept for
//     the gated matmul too, where the card's tests and chip_smoke.py time it
//     against wgmma.
//   * skinny (M <= 16, fp32 decode, and bf16 when asked, to time against gemv):
//     streams w once with coalesced vector loads and splits K over blocks; the
//     split partials are fp32 and summed in a fixed order by a second kernel,
//     so results are deterministic.
//   * simt: fp32 operands (64x64 tiles, 4x4 outputs per thread): fp32 is the
//     checking dtype, held to 2e-4, which only fp32 sums of exact products
//     meet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "wg.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

enum { ACT_NONE = 0, ACT_RELU2 = 1, ACT_GELU = 2, ACT_SILU = 3 };
enum { DT_F32 = 0, DT_BF16 = 1 };
// the paths, as kernels/matmul.py::IMPLS numbers them
enum { IMPL_WGMMA = 0, IMPL_WMMA = 1, IMPL_SIMT = 2, IMPL_SKINNY = 3, IMPL_GEMV = 4 };

__device__ __forceinline__ float apply_act(float y, int act) {
  switch (act) {
    case ACT_RELU2: {
      float r = fmaxf(y, 0.f);
      return r * r;
    }
    case ACT_GELU: {  // tanh approximation, as jax.nn.gelu computes by default
      const float c = 0.7978845608028654f;  // sqrt(2/pi)
      return 0.5f * y * (1.f + tanhf(c * (y + 0.044715f * y * y * y)));
    }
    case ACT_SILU:
      return y / (1.f + expf(-y));
    default:
      return y;
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

// The shared epilogue: bias then act (plain) or act(a) * b (gated); the
// gated kernel also writes its fp32 products a and b when asked (training
// keeps them for the SwiGLU backward).
template <typename TO, typename TI, bool GATED>
__device__ __forceinline__ void store_out(TO* out, size_t idx, float a, float b,
                                          const TI* bias, int n, int act, float* a_out,
                                          float* b_out) {
  float y;
  if (GATED) {
    y = apply_act(a, act) * b;
    if (a_out != nullptr) {
      a_out[idx] = a;
      b_out[idx] = b;
    }
  } else {
    if (bias != nullptr) a += to_f(bias[n]);
    y = apply_act(a, act);
  }
  out[idx] = from_f<TO>(y);
}

// ---------------------------------------------------------------------------
// The wmma path (bf16 operands TMA cannot address; the gated matmul when
// asked): one BM x BN output tile per block, warps laid out WARPS_M x WARPS_N, each owning FM x FN WMMA fragments.  Two tile
// shapes: 128x128 (8 warps) when that grid fills the card twice over, else
// 64x64 (4 warps) so that mid-size products still spread over the SMs.  The
// next K step's tiles are loaded into registers while the tensor cores work
// on the current one (register double buffering).
//
// Operands keep their own layouts in shared memory: A is x [M,K] row-major
// (leading dim lda) or, with TA, stored [K,M] (x^T read in place: the dw
// product x^T g); B is w [K,N] row-major or, with TB, stored [N,K] (w^T read
// in place: g w^T and the tied head x table^T).  WMMA loads the fragments
// with the matching row/col-major layout, so nothing is transposed in
// memory.  Every 16-byte vector lies along the stored rows.  When a stored
// row length (K, M, N or K), a leading dim or an operand's address is off
// 16 bytes (`vec` false; the tile matmul's ragged products in the ring
// backward), the same 8-element vectors are gathered element by element
// and masked at the row's end.
// ---------------------------------------------------------------------------
namespace tc {
constexpr int BK = 32;
}  // namespace tc

// 8 bf16 from p, those at or past `avail` zero (a vector at a ragged edge)
__device__ __forceinline__ uint4 load8_masked(const bf16* p, int avail) {
  unsigned int u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned int lo = 2 * i < avail ? __bfloat16_as_ushort(p[2 * i]) : 0u;
    const unsigned int hi = 2 * i + 1 < avail ? __bfloat16_as_ushort(p[2 * i + 1]) : 0u;
    u[i] = lo | (hi << 16);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool GATED, bool TA, bool TB, typename TO>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
mm_tc_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
           const bf16* __restrict__ wb, const bf16* __restrict__ bias,
           TO* __restrict__ out, float* __restrict__ a_out, float* __restrict__ b_out,
           int M, int N, int K, long long lda, long long ldb, int act, bool vec) {
  using tc::BK;
  constexpr int THREADS = WARPS_M * WARPS_N * 32;
  constexpr int A_COLS = TA ? BM : BK, A_ROWS = TA ? BK : BM, LDA = A_COLS + 8;
  constexpr int B_COLS = TB ? BK : BN, B_ROWS = TB ? BN : BK, LDB = B_COLS + 8;
  constexpr int FM = BM / WARPS_M / 16, FN = BN / WARPS_N / 16;
  constexpr int A_VEC = BM * BK / 8 / THREADS, B_VEC = BK * BN / 8 / THREADS;
  static_assert(A_VEC * THREADS * 8 == BM * BK && B_VEC * THREADS * 8 == BK * BN, "tiles");
  using ALayout = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
  using BLayout = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
  __shared__ __align__(32) bf16 As[A_ROWS * LDA];
  __shared__ __align__(32) bf16 Bs[B_ROWS * LDB];
  __shared__ __align__(32) bf16 Bbs[GATED ? B_ROWS * LDB : 16];
  __shared__ __align__(32) float Cs[WARPS_M * WARPS_N][GATED ? 512 : 256];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN], accb[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::fill_fragment(acc[i][j], 0.f);
      if (GATED) wmma::fill_fragment(accb[i][j], 0.f);
    }

  // 8 bf16 (16 bytes) per vector along a stored row, zero past the edges
  uint4 ra[A_VEC], rb[B_VEC], rbb[B_VEC];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int v = 0; v < A_VEC; ++v) {
      const int i = tid + v * THREADS, r = i / (A_COLS / 8), c = (i % (A_COLS / 8)) * 8;
      const int gr = (TA ? k0 : m0) + r, gc = (TA ? m0 : k0) + c;
      const int cols = TA ? M : K;
      const bool in = (TA ? gr < K : gr < M) && gc < cols;
      ra[v] = make_uint4(0, 0, 0, 0);
      if (in) {
        const bf16* p = x + (size_t)gr * lda + gc;
        ra[v] = vec ? *reinterpret_cast<const uint4*>(p) : load8_masked(p, cols - gc);
      }
    }
#pragma unroll
    for (int v = 0; v < B_VEC; ++v) {
      const int i = tid + v * THREADS, r = i / (B_COLS / 8), c = (i % (B_COLS / 8)) * 8;
      const int gr = (TB ? n0 : k0) + r, gc = (TB ? k0 : n0) + c;
      const int cols = TB ? K : N;
      const bool in = (TB ? gr < N : gr < K) && gc < cols;
      rb[v] = make_uint4(0, 0, 0, 0);
      rbb[v] = make_uint4(0, 0, 0, 0);
      if (in) {
        const size_t off = (size_t)gr * ldb + gc;
        const int avail = cols - gc;
        rb[v] = vec ? *reinterpret_cast<const uint4*>(w + off) : load8_masked(w + off, avail);
        if (GATED)
          rbb[v] = vec ? *reinterpret_cast<const uint4*>(wb + off) : load8_masked(wb + off, avail);
      }
    }
  };

  load_tiles(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int v = 0; v < A_VEC; ++v) {
      const int i = tid + v * THREADS;
      *reinterpret_cast<uint4*>(As + (i / (A_COLS / 8)) * LDA + (i % (A_COLS / 8)) * 8) = ra[v];
    }
#pragma unroll
    for (int v = 0; v < B_VEC; ++v) {
      const int i = tid + v * THREADS, off = (i / (B_COLS / 8)) * LDB + (i % (B_COLS / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + off) = rb[v];
      if (GATED) *reinterpret_cast<uint4*>(Bbs + off) = rbb[v];
    }
    __syncthreads();
    if (k0 + BK < K) load_tiles(k0 + BK);  // in flight during the MMAs below
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb;
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int mo = wm * FM * 16 + i * 16;
        wmma::load_matrix_sync(fa[i], TA ? As + kk * LDA + mo : As + mo * LDA + kk, LDA);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int no = wn * FN * 16 + j * 16, boff = TB ? no * LDB + kk : kk * LDB + no;
        wmma::load_matrix_sync(fb, Bs + boff, LDB);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        if (GATED) {
          wmma::load_matrix_sync(fb, Bbs + boff, LDB);
#pragma unroll
          for (int i = 0; i < FM; ++i) wmma::mma_sync(accb[i][j], fa[i], fb, accb[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: each fragment goes through this warp's shared staging area
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      if (GATED) wmma::store_matrix_sync(cs + 256, accb[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + (wm * FM + i) * 16 + (e >> 4);
        const int n = n0 + (wn * FN + j) * 16 + (e & 15);
        if (m < M && n < N)
          store_out<TO, bf16, GATED>(out, (size_t)m * N + n, cs[e], GATED ? cs[256 + e] : 0.f,
                                     bias, n, act, a_out, b_out);
      }
      __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// fp32 SIMT path, M > 16: 64x64 tile per block, 4x4 outputs per thread.
// TA / TB read x^T / w^T in place as the tensor-core path does; the loads
// walk the stored rows so neighbouring threads read neighbouring addresses.
// ---------------------------------------------------------------------------
template <bool GATED, bool TA, bool TB>
__global__ void __launch_bounds__(256)
mm_simt_f32(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ wb, const float* __restrict__ bias,
            float* __restrict__ out, float* __restrict__ a_out, float* __restrict__ b_out,
            int M, int N, int K, long long lda, long long ldb, int act) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ float As[BK][BM + 4];  // x tile, k-major
  __shared__ float Bs[BK][BN];
  __shared__ float Bbs[GATED ? BK : 1][BN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {}, accb[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += 256) {
      const int r = TA ? i % BM : i / BK, c = TA ? i / BM : i % BK;  // (m, k) in the tile
      const bool in = m0 + r < M && k0 + c < K;
      As[c][r] = in ? x[TA ? (size_t)(k0 + c) * lda + m0 + r : (size_t)(m0 + r) * lda + k0 + c]
                    : 0.f;
    }
    for (int i = tid; i < BK * BN; i += 256) {
      const int r = TB ? i % BK : i / BN, c = TB ? i / BK : i % BN;  // (k, n) in the tile
      const bool in = k0 + r < K && n0 + c < N;
      const size_t off = TB ? (size_t)(n0 + c) * ldb + k0 + r : (size_t)(k0 + r) * ldb + n0 + c;
      Bs[r][c] = in ? w[off] : 0.f;
      if (GATED) Bbs[r][c] = in ? wb[off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = Bs[kk][tx * 4 + j];
        if (GATED) bb[j] = Bbs[kk][tx * 4 + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] += a[i] * b[j];
          if (GATED) accb[i][j] += a[i] * bb[j];
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < M && n < N)
        store_out<float, float, GATED>(out, (size_t)m * N + n, acc[i][j], accb[i][j], bias, n,
                                       act, a_out, b_out);
    }
}

// ---------------------------------------------------------------------------
// Skinny path, M <= 16 (fp32 decode; bf16 only when asked, to time it against
// the gemv path): a block owns 64 columns and one K chunk;
// thread (rg, cg) streams rows rg, rg+16, ... of its chunk, 4 columns each.
// Partial sums go to an fp32 workspace [splits, M, N] (twice for gated).
// ---------------------------------------------------------------------------
namespace sk {
constexpr int BN = 64, COLS = 4, CG = BN / COLS, THREADS = 256, RG = THREADS / CG;
constexpr int XK = 128, MAXM = 16, WARPS = THREADS / 32;
}  // namespace sk

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

template <typename T, bool GATED>
__global__ void __launch_bounds__(sk::THREADS)
mm_skinny(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ wb,
          float* __restrict__ part, int M, int N, int K, int kchunk) {
  using namespace sk;
  __shared__ float xs[MAXM][XK];
  __shared__ float red[WARPS][MAXM * BN];
  const int tid = threadIdx.x, cg = tid % CG, rg = tid / CG;
  const int warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN, ncol = n0 + cg * COLS;
  const bool col_ok = ncol < N;  // N % 4 == 0: a column group is all in or all out
  const int kb = blockIdx.y * kchunk, ke = min(K, kb + kchunk);
  float acc[MAXM][COLS] = {}, accb[MAXM][COLS] = {};

  for (int kt = kb; kt < ke; kt += XK) {
    for (int i = tid; i < MAXM * XK; i += THREADS) {
      const int m = i / XK, c = i % XK;
      xs[m][c] = (m < M && kt + c < ke) ? to_f(x[(size_t)m * K + kt + c]) : 0.f;
    }
    __syncthreads();
    const int kend = min(XK, ke - kt);
    if (col_ok) {
#pragma unroll 4
      for (int kk = rg; kk < kend; kk += RG) {
        float wv[COLS], wbv[COLS];
        const size_t off = (size_t)(kt + kk) * N + ncol;
        load4(w + off, wv);
        if (GATED) load4(wb + off, wbv);
#pragma unroll
        for (int m = 0; m < MAXM; ++m) {
          if (m < M) {
            const float xv = xs[m][kk];
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
              acc[m][j] += xv * wv[j];
              if (GATED) accb[m][j] += xv * wbv[j];
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // reduce the 16 row groups: the two in a warp by shuffle, the 8 warps
  // through shared memory, in a fixed order
  for (int pass = 0; pass < (GATED ? 2 : 1); ++pass) {
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m < M) {
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          float v = pass ? accb[m][j] : acc[m][j];
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 16) red[warp][m * BN + cg * COLS + j] = v;
        }
      }
    }
    __syncthreads();
    float* dst = part + (size_t)(pass * gridDim.y + blockIdx.y) * M * N;
    for (int i = tid; i < M * BN; i += THREADS) {
      const int m = i / BN, c = i % BN;
      if (n0 + c < N) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < WARPS; ++q) s += red[q][i];
        dst[(size_t)m * N + n0 + c] = s;
      }
    }
    __syncthreads();
  }
}

template <typename T, bool GATED>
__global__ void __launch_bounds__(256)
mm_splitk_epilogue(const float* __restrict__ part, const T* __restrict__ bias,
                   T* __restrict__ out, float* __restrict__ a_out, float* __restrict__ b_out,
                   int M, int N, int splits, int act) {
  const size_t MN = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int s = 0; s < splits; ++s) {
      a += part[s * MN + i];
      if (GATED) b += part[(splits + s) * MN + i];
    }
    store_out<T, T, GATED>(out, i, a, b, bias, (int)(i % N), act, a_out, b_out);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores through wgmma, operands staged by TMA (M > 16 in
// matmul, every size in the tile matmul, whenever TMA can address both
// operands: stored rows, leading dims and bases on 16 bytes).
//
// Persistent blocks: one per SM (or one per work unit when there are fewer),
// each walking the work units blockIdx.x, blockIdx.x + gridDim.x, ...  A unit
// is a BM x BN output tile and one of `splits` ranges of K.  Tiles are taken
// m fastest within bands of GM row tiles, so the blocks of one wave share a
// few B column bands (the tied head's 311 MB table is read about once).
//
// A block is three warpgroups.  The producer (warpgroup 0, one thread
// working, its registers given up with setmaxnreg) keeps TMA loads in flight
// into a ring of NST shared-memory stages of BK = 64, each stage a full and
// an empty mbarrier.  Each stage holds the A tile (BM rows x 64 of K, 128-byte
// rows in the 128-byte swizzle) and the B tile.  The two consumer
// warpgroups each own 64 rows of the tile and issue wgmma m64nBNk16 over
// them, fp32 accumulators in registers; a stage is released once the
// products that read it have completed (one wgmma group stays in flight
// across the next stage's wait).
//
// Layouts, read in place (`wgmma`'s transpose bits, one descriptor form):
//   A [M,K] row-major (NN, NT): K-major, one 64 x 128 box of 128 rows;
//   A stored [K,M] (TN):        MN-major, two boxes of 64 (M) x 64 (K);
//   B stored [N,K] (NT):        K-major, one 64 x BN box;
//   B [K,N] row-major (NN, TN): MN-major, BN / 64 boxes of 64 (N) x 64 (K).
// Boxes past the edges read zeros, which masks ragged M, N and K on the load
// side; the epilogue masks the stores.  With splits > 1 each unit writes its
// fp32 partial sum to `part` [splits, M, N] and sum_splits adds the splits in
// a fixed order, so the result does not depend on timing (no atomics).
//
// The gated form (mm_gated, NN only, BN = 128): a stage holds the x tile and
// the tiles of both weights (16 + 2 x 16 KB, four stages in 192 KB); each
// consumer issues two m64n128k16 products a k16 step from the same A
// descriptor into two accumulators of 64 fp32 (128 registers, as the plain
// 256-wide tile holds), and the epilogue stores act(a) * b, and a and b in
// fp32 when the training path keeps them, from the registers.  Split
// partials are [2, splits, M, N]: a's splits, then b's.
//
// The tile geometry and the main loop's two halves (load_unit, mma_unit) live
// in wg.cuh, shared with the ring kernels' tensor-core route (ring_matmul.cu).
// ---------------------------------------------------------------------------
namespace wg {
using namespace hopper;
// The body of mm and mm_gated.  GATED: B is w1 (bmap) and w1b (bmap2), NN only.
template <int BN, bool TA, bool TB, typename TO, bool GATED>
__device__ __forceinline__ void mm_body(const CUtensorMap* amap, const CUtensorMap* bmap,
                                        const CUtensorMap* bmap2, TO* __restrict__ out,
                                        float* __restrict__ part, const bf16* __restrict__ bias,
                                        float* __restrict__ a_out, float* __restrict__ b_out,
                                        int M, int N, int K, int splits, int act) {
  using T = Tile<BN, GATED>;
  static_assert(!GATED || (BN == 128 && !TA && !TB), "the gated tile is NN, 128 wide");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::NST * T::STAGE);
  uint64_t* empty = full + T::NST;
  const int mt = (M + BM - 1) / BM, nt = (N + BN - 1) / BN, kbt = (K + BK - 1) / BK;
  const int kper = (kbt + splits - 1) / splits, units = mt * nt * splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::NST; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 2);  // one arrival from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const auto wait = [](uint64_t* b, int parity) { bar_wait(b, parity); };
  if (threadIdx.x < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_at<BN>(u, mt, nt, splits, kper, kbt);
        load_unit<BN, TA, TB, GATED>(ring, full, empty, amap, bmap, bmap2, w.m0, w.n0, w.kb0,
                                     w.kb1, it, wait);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = threadIdx.x / 128 - 1, t = threadIdx.x % 128, lane = t % 32;
  float acc[BN / 2], accb[BN / 2];  // accb: the gated form's x w1b (unused, and dropped, otherwise)
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit_at<BN>(u, mt, nt, splits, kper, kbt);
    mma_unit<BN, TA, TB, GATED>(ring, full, empty, acc, accb, w.kb0, w.kb1, c, t, it, wait);

    // epilogue from the registers: thread t holds rows r, r + 8 and the column pairs
    // 8i + 2 (lane % 4) + {0, 1} of its warpgroup's 64 x BN accumulator(s)
    const int r0 = w.m0 + c * 64 + (t / 32) * 16 + lane / 4;
    const int c0 = w.n0 + 2 * (lane % 4);
    const bool pairs = (N & 1) == 0;  // an even row length keeps each pair 2-element aligned
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + 8 * h;
      if (m >= M) continue;
      const size_t row = (size_t)m * N;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int n = c0 + 8 * i;
        if (n >= N) continue;
        float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
        if constexpr (GATED) {  // N is even: every pair is whole
          const float b0 = accb[4 * i + 2 * h], b1 = accb[4 * i + 2 * h + 1];
          if (part != nullptr) {
            float* p = part + (size_t)w.split * M * N + row + n;
            store2(p, v0, v1);
            store2(p + (size_t)splits * M * N, b0, b1);
            continue;
          }
          if (a_out != nullptr) {
            store2(a_out + row + n, v0, v1);
            store2(b_out + row + n, b0, b1);
          }
          store2(out + row + n, apply_act(v0, act) * b0, apply_act(v1, act) * b1);
        } else {
          if (part != nullptr) {
            float* p = part + (size_t)w.split * M * N + row + n;
            if (pairs) {
              store2(p, v0, v1);
            } else {
              p[0] = v0;
              if (n + 1 < N) p[1] = v1;
            }
            continue;
          }
          if (bias != nullptr) {
            v0 += __bfloat162float(bias[n]);
            if (n + 1 < N) v1 += __bfloat162float(bias[n + 1]);
          }
          v0 = apply_act(v0, act);
          v1 = apply_act(v1, act);
          if (pairs) {
            store2(out + row + n, v0, v1);
          } else {
            out[row + n] = from_f<TO>(v0);
            if (n + 1 < N) out[row + n + 1] = from_f<TO>(v1);
          }
        }
      }
    }
  }
}

template <int BN, bool TA, bool TB, typename TO>
__global__ void __launch_bounds__(THREADS, 1)
mm(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
   TO* __restrict__ out, float* __restrict__ part, const bf16* __restrict__ bias, int M, int N,
   int K, int splits, int act) {
  mm_body<BN, TA, TB, TO, false>(&amap, &bmap, &bmap, out, part, bias, nullptr, nullptr, M, N, K,
                                 splits, act);
}

// y = act(x w1) * (x w1b), bf16 [M, N]; a_out / b_out (fp32, both or neither) keep x w1 and x w1b.
// N is even (the wrapper keeps it on 8 elements), so every column pair is stored whole.
__global__ void __launch_bounds__(THREADS, 1)
mm_gated(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
         const __grid_constant__ CUtensorMap bmap2, bf16* __restrict__ out,
         float* __restrict__ part, float* __restrict__ a_out, float* __restrict__ b_out, int M,
         int N, int K, int splits, int act) {
  mm_body<128, false, false, bf16, true>(&amap, &bmap, &bmap2, out, part, nullptr, a_out, b_out,
                                         M, N, K, splits, act);
}

// The splits' fp32 partials added in split order, then the epilogue: act(sum + bias) (plain), or
// act(a) * b with a's partials [0, splits) and b's [splits, 2 splits) (gated).
template <typename TO, bool GATED>
__global__ void __launch_bounds__(256)
sum_splits(const float* __restrict__ part, const bf16* __restrict__ bias, TO* __restrict__ out,
           float* __restrict__ a_out, float* __restrict__ b_out, int M, int N, int splits,
           int act) {
  const size_t MN = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int s = 0; s < splits; ++s) {
      a += part[s * MN + i];
      if (GATED) b += part[(splits + s) * MN + i];
    }
    store_out<TO, bf16, GATED>(out, i, a, b, bias, (int)(i % N), act, a_out, b_out);
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
namespace wg {

static int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

static int sum_blocks(size_t MN) {
  return (int)((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
}

static int grid_for(long long units) { return (int)(units < sm_count() ? units : sm_count()); }

template <int BN, bool TA, bool TB, typename TO>
static void launch_tile(const CUtensorMap& am, const CUtensorMap& bm, TO* out, float* part,
                        const bf16* bias, int M, int N, int K, int splits, int act,
                        cudaStream_t st) {
  constexpr size_t smem = Tile<BN>::SMEM;
  cudaFuncSetAttribute(mm<BN, TA, TB, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const int grid = grid_for((long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN) * splits);
  mm<BN, TA, TB, TO><<<grid, THREADS, smem, st>>>(am, bm, out, part, bias, M, N, K, splits, act);
}

// out [M, N] = act(A B + bias) on the wgmma path; bn (128 or 256) and splits come from the
// wrapper's plan (kernels/matmul.py, wg_plan), ws holds splits * M * N floats when splits > 1.
// A map cuTensorMapEncodeTiled refuses (an address or leading dim off 16 bytes) returns
// cudaErrorInvalidValue: nothing falls back to another path.
template <bool TA, bool TB, typename TO>
static int launch(const bf16* a, const bf16* b, TO* out, float* ws, const bf16* bias, int M,
                  int N, int K, long long lda, long long ldb, int act, int bn, int splits,
                  cudaStream_t st) {
  if ((bn != 128 && bn != 256) || splits < 1 || M < 1 || N < 1 || K < 1 ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap am, bm;
  if (!map2d(&am, a, TA ? M : K, TA ? K : M, lda, TA ? 64 : BM) ||
      !map2d(&bm, b, TB ? K : N, TB ? N : K, ldb, TB ? bn : 64))
    return (int)cudaErrorInvalidValue;
  float* part = splits > 1 ? ws : nullptr;
  if (bn == 256)
    launch_tile<256, TA, TB, TO>(am, bm, out, part, bias, M, N, K, splits, act, st);
  else
    launch_tile<128, TA, TB, TO>(am, bm, out, part, bias, M, N, K, splits, act, st);
  if (splits > 1)
    sum_splits<TO, false><<<sum_blocks((size_t)M * N), 256, 0, st>>>(ws, bias, out, nullptr,
                                                                     nullptr, M, N, splits, act);
  return (int)cudaGetLastError();
}

// y [M, N] = act(x w1) * (x w1b) on the wgmma path, x [M, K] and w1, w1b [K, N] row-major;
// bn (128) and splits from the wrapper's plan (wg_plan with gated set), ws holds
// 2 * splits * M * N floats when splits > 1.  a_out / b_out: the kept fp32 products, or null.
static int launch_gated(const bf16* x, const bf16* w1, const bf16* w1b, bf16* out, float* ws,
                        float* a_out, float* b_out, int M, int N, int K, int act, int bn,
                        int splits, cudaStream_t st) {
  if (bn != 128 || splits < 1 || M < 1 || N < 1 || K < 1 || N % 2 ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap am, bm, bm2;
  if (!map2d(&am, x, K, M, K, BM) || !map2d(&bm, w1, N, K, N, 64) ||
      !map2d(&bm2, w1b, N, K, N, 64))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = Tile<128, true>::SMEM;
  cudaFuncSetAttribute(mm_gated, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int grid = grid_for((long long)((M + BM - 1) / BM) * ((N + 127) / 128) * splits);
  mm_gated<<<grid, THREADS, smem, st>>>(am, bm, bm2, out, splits > 1 ? ws : nullptr, a_out,
                                        b_out, M, N, K, splits, act);
  if (splits > 1)
    sum_splits<bf16, true><<<sum_blocks((size_t)M * N), 256, 0, st>>>(ws, nullptr, out, a_out,
                                                                      b_out, M, N, splits, act);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// The decode path (gemv): bf16 x [M, K] with M <= 16 (the serving slots) times
// w [K, N], plain (bias, act) or gated (act(x w1) * (x w1b), one staged x feeding
// both weights).  Replaces the same pallas_calls as the paths above, at decode
// shapes.
//
// Bound: the weight bytes.  Each is read once (the head's 311 MB is 93 us at
// 3.35 TB/s); x and the output are a few KB.  So the design keeps many weight
// bytes in flight and everything else off the critical path:
//   * a block owns a panel of BN = 128 columns (two 64-column TMA boxes, the
//     128-byte swizzle) and one range of K; one thread keeps NST stages of
//     BK = 64 rows in flight by TMA (64 KB plain, 96 KB gated), refilled as the
//     block releases each, so a few blocks an SM hold 100-200 KB in flight;
//   * x's M rows of the block's K range are staged once, in bf16, rows 16 bytes
//     longer than the range so that ldmatrix reads them without bank conflicts;
//   * the products run on mma.sync m16n8k16, x as the A operand (lanes of rows
//     past M point ldmatrix at 16 zero bytes), the weight panel as B
//     (ldmatrix.trans out of the swizzled stage), fp32 accumulators: the CUDA
//     cores only stage x and run the epilogue, so M = 16 keeps pace with the
//     bytes as M = 4 does;
//   * where the column panels alone cannot fill the 132 SMs, K is split over
//     the blocks of a thread-block cluster (gridDim.y, up to 8): each leaves its
//     fp32 partial in its own shared memory, and after a cluster barrier the
//     cluster's threads add the panel's partials in split order over distributed
//     shared memory and run the epilogue: one launch, no workspace in device
//     memory, no atomics, and two calls agree bit for bit.
// Four warps a block, each owning 32 columns of the panel: per k16 step one
// ldmatrix of x, two ldmatrix.trans of each weight and four mma.sync each.
// ---------------------------------------------------------------------------
namespace gv {
using namespace hopper;

constexpr int BN = 128, BK = 64, THREADS = 128, MAXM = 16;
constexpr int MAXSPLITS = 8;              // a portable cluster
constexpr int BOX = 64 * BK * 2;          // one 64-column box of BK 128-byte rows, 8 KB
constexpr int W_BYTES = BN * BK * 2;      // one weight's share of a stage, 16 KB

template <bool GATED>
struct Ring {
  static constexpr int STAGE = (GATED ? 2 : 1) * W_BYTES;
  static constexpr int NST = GATED ? 3 : 4;
  // the ring (1 KB aligned), then x's rows, 16 zero bytes and the stages' mbarriers
  static size_t smem(int M, int pitch) {
    return 1024 + (size_t)NST * STAGE + (size_t)M * pitch * 2 + 16 + NST * 8;
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}
// two floats at this block's shared address `addr` in the shared memory of cluster block `rank`
__device__ __forceinline__ float2 ld_cluster(uint32_t addr, int rank) {
  uint32_t remote;
  float2 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(remote) : "memory");
  return v;
}
// d [16 x 8] += a [16 x 16] b [16 x 8], bf16 in, fp32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four n8 tiles of one weight's 16 x 32 slice of a k16 step: `st` is the warp's 64-column box of
// the stage, `row` the stored row this lane addresses, `chunk` its first 16-byte chunk.
__device__ __forceinline__ void mma4(float (&acc)[4][4], const uint32_t (&a)[4], uint32_t st,
                                     int row, int chunk) {
  uint32_t b[2][4];
  const uint32_t r = st + row * 128;
  ldsm_x4_t(b[0], r + ((chunk ^ (row & 7)) << 4));
  ldsm_x4_t(b[1], r + (((chunk + 2) ^ (row & 7)) << 4));
  mma(acc[0], a, b[0][0], b[0][1]);
  mma(acc[1], a, b[0][2], b[0][3]);
  mma(acc[2], a, b[1][0], b[1][1]);
  mma(acc[3], a, b[1][2], b[1][3]);
}

// The outputs at columns n, n + 1 of a row (at `idx`; N is even) from fp32 sums: act(v + bias)
// (plain) or act(v) * vb (gated, with v and vb kept in fp32 when a_out is set).
template <bool GATED>
__device__ __forceinline__ void put_pair(bf16* out, size_t idx, int n, float v0, float v1,
                                         float b0, float b1, const bf16* bias, int act,
                                         float* a_out, float* b_out) {
  if (GATED) {
    if (a_out != nullptr) {
      wg::store2(a_out + idx, v0, v1);
      wg::store2(b_out + idx, b0, b1);
    }
    wg::store2(out + idx, apply_act(v0, act) * b0, apply_act(v1, act) * b1);
  } else {
    if (bias != nullptr) {
      v0 += __bfloat162float(bias[n]);
      v1 += __bfloat162float(bias[n + 1]);
    }
    wg::store2(out + idx, apply_act(v0, act), apply_act(v1, act));
  }
}

template <bool GATED>
__global__ void __launch_bounds__(THREADS)
gemv(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap wbmap,
     const bf16* __restrict__ x, const bf16* __restrict__ bias, bf16* __restrict__ out,
     float* __restrict__ a_out, float* __restrict__ b_out, int M, int N, int K, int kper,
     int act) {
  using R = Ring<GATED>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int splits = gridDim.y, split = blockIdx.y, n0 = blockIdx.x * BN;
  const int kbt = (K + BK - 1) / BK, kb0 = split * kper, nk = min(kbt, kb0 + kper) - kb0;
  const int pitch = kper * BK + 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1k(smem_raw);
  bf16* xs = reinterpret_cast<bf16*>(ring + R::NST * R::STAGE);
  uint4* zero = reinterpret_cast<uint4*>(xs + (size_t)M * pitch);
  uint64_t* full = reinterpret_cast<uint64_t*>(zero + 1);

  const CUtensorMap* wm = &wmap;
  const CUtensorMap* wbm = &wbmap;
  auto load_stage = [&](int i) {  // k-block kb0 + i into stage i % NST
    const int s = i % R::NST, k = (kb0 + i) * BK;
    uint8_t* st = ring + s * R::STAGE;
    bar_expect(&full[s], R::STAGE);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j) {
      tma_load(st + j * BOX, wm, &full[s], n0 + 64 * j, k);
      if (GATED) tma_load(st + W_BYTES + j * BOX, wbm, &full[s], n0 + 64 * j, k);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < R::NST; ++s) bar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(nk, R::NST); ++i) load_stage(i);
    *zero = make_uint4(0, 0, 0, 0);
  }
  // x's rows of this K range, zeros past K (K % 8 == 0: a vector is all in or all out)
  const int vrow = nk * BK / 8;
  for (int i = tid; i < M * vrow; i += THREADS) {
    const int m = i / vrow, c = (i % vrow) * 8, k = kb0 * BK + c;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (k < K) v = *reinterpret_cast<const uint4*>(x + (size_t)m * K + k);
    *reinterpret_cast<uint4*>(xs + m * pitch + c) = v;
  }
  __syncthreads();

  // A: lane l addresses row 8 ((l >> 3) & 1) + (l & 7) at k offset 8 (l >> 4) of each k16 step
  // (the zero chunk for rows past M); B: stored row (l & 7) + 8 ((l >> 3) & 1) of the step,
  // 16-byte chunks 4 (warp & 1) + (l >> 4) and 2 further of box warp >> 1
  const int am = ((lane >> 3) & 1) * 8 + (lane & 7);
  const uint32_t a_base = am < M ? saddr(xs + am * pitch + (lane >> 4) * 8) : saddr(zero);
  const uint32_t a_step = am < M ? 32 : 0;  // bytes per k16 step
  const int brow = (lane & 7) + ((lane >> 3) & 1) * 8, chunk = (warp & 1) * 4 + (lane >> 4);
  float acc[4][4] = {}, accb[4][4] = {};
  for (int i = 0; i < nk; ++i) {
    const int s = i % R::NST;
    bar_wait(&full[s], (i / R::NST) & 1);
    const uint32_t st = saddr(ring + s * R::STAGE) + (warp >> 1) * BOX;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, a_base + (i * (BK / 16) + kk) * a_step);
      mma4(acc, a, st, kk * 16 + brow, chunk);
      if (GATED) mma4(accb, a, st + W_BYTES, kk * 16 + brow, chunk);
    }
    __syncthreads();  // every warp is done with stage s: refill it
    if (tid == 0 && i + R::NST < nk) load_stage(i + R::NST);
  }

  // thread (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 at columns 2t, 2t + 1 of each
  // n8 tile j: acc[j][2h + e] is row g + 8h, column 32 warp + 8j + 2t + e of the panel
  const int g = lane >> 2, cn = warp * 32 + 2 * (lane & 3);
  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = g + 8 * h, n = n0 + cn + 8 * j;
        if (m >= M || n >= N) continue;  // N % 8 == 0: column n + 1 is in too
        put_pair<GATED>(out, (size_t)m * N + n, n, acc[j][2 * h], acc[j][2 * h + 1],
                        accb[j][2 * h], accb[j][2 * h + 1], bias, act, a_out, b_out);
      }
    return;
  }
  // K split over the blocks of a cluster (rank = split): each leaves its fp32 partial
  // [a; b] x [M, BN] in its (now idle) ring; then the cluster's threads share the panel's
  // column pairs, each adding one pair's partials in rank order over distributed shared memory
  float* ps = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = g + 8 * h;
      if (m >= M) continue;
      *reinterpret_cast<float2*>(ps + m * BN + cn + 8 * j) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      if (GATED)
        *reinterpret_cast<float2*>(ps + (M + m) * BN + cn + 8 * j) =
            make_float2(accb[j][2 * h], accb[j][2 * h + 1]);
    }
  cluster_sync();
  for (int p = split * THREADS + tid; p < M * (BN / 2); p += splits * THREADS) {
    const int m = p / (BN / 2), c = 2 * (p % (BN / 2)), n = n0 + c;
    if (n >= N) continue;
    const uint32_t la = saddr(ps + m * BN + c), lb = saddr(ps + (M + m) * BN + c);
    float2 va[MAXSPLITS], vb[MAXSPLITS];
#pragma unroll
    for (int q = 0; q < MAXSPLITS; ++q) {  // every load in flight, then the sums in order
      if (q >= splits) break;
      va[q] = ld_cluster(la, q);
      if (GATED) vb[q] = ld_cluster(lb, q);
    }
    float2 sa = make_float2(0.f, 0.f), sb = make_float2(0.f, 0.f);
#pragma unroll
    for (int q = 0; q < MAXSPLITS; ++q) {
      if (q >= splits) break;
      sa.x += va[q].x;
      sa.y += va[q].y;
      if (GATED) {
        sb.x += vb[q].x;
        sb.y += vb[q].y;
      }
    }
    put_pair<GATED>(out, (size_t)m * N + n, n, sa.x, sa.y, sb.x, sb.y, bias, act, a_out, b_out);
  }
  cluster_sync();  // no block leaves while another still reads its partial
}

// y [M, N] on the gemv path (M <= 16, bf16, x [M, K] and w, wb [K, N] row-major, K and N
// multiples of 8).  splits (1 to MAXSPLITS) from the wrapper's plan (kernels/matmul.py,
// gemv_plan): the blocks of one panel's splits form a cluster.
template <bool GATED>
static int launch(const bf16* x, const bf16* w, const bf16* wb, const bf16* bias, bf16* out,
                  float* a_out, float* b_out, int M, int N, int K, int act, int splits,
                  cudaStream_t st) {
  if (M < 1 || M > MAXM || N < 8 || K < 8 || N % 8 || K % 8 || splits < 1 ||
      splits > MAXSPLITS)
    return (int)cudaErrorInvalidValue;
  const int kbt = (K + BK - 1) / BK, kper = (kbt + splits - 1) / splits;
  if ((splits - 1) * kper >= kbt) return (int)cudaErrorInvalidValue;  // an empty split
  const size_t smem = Ring<GATED>::smem(M, kper * BK + 8);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // the plan splits K further first
  CUtensorMap wm, wbm;
  if (!wg::map2d(&wm, w, N, K, N, BK) || (GATED && !wg::map2d(&wbm, wb, N, K, N, BK)))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(gemv<GATED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // all of the SM's memory to shared, so that as many blocks as fit stream at once
  cudaFuncSetAttribute(gemv<GATED>, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = splits;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gemv<GATED>, wm, GATED ? wbm : wm, x, bias,
                                             out, a_out, b_out, M, N, K, kper, act);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace gv

// The tensor-core path for any layout and output type, by grid size.
template <bool GATED, bool TA, bool TB, typename TO>
static void launch_tc(const bf16* x, const bf16* w, const bf16* wb, const bf16* bias, TO* out,
                      float* a_out, float* b_out, int M, int N, int K, long long lda,
                      long long ldb, int act, cudaStream_t st) {
  // 16-byte vectors need every stored row, leading dim and base on 8 elements
  const bool vec = ((TA ? M : K) % 8 | (TB ? K : N) % 8 | lda % 8 | ldb % 8 |
                    (long long)(((uintptr_t)x | (uintptr_t)w | (uintptr_t)wb) % 16)) == 0;
  dim3 big((N + 127) / 128, (M + 127) / 128);
  if (big.x * big.y >= 2 * 132) {  // two waves of 128x128 tiles on 132 SMs
    mm_tc_bf16<128, 128, 4, 2, GATED, TA, TB, TO><<<big, 256, 0, st>>>(
        x, w, wb, bias, out, a_out, b_out, M, N, K, lda, ldb, act, vec);
  } else {
    dim3 grid((N + 63) / 64, (M + 63) / 64);
    mm_tc_bf16<64, 64, 2, 2, GATED, TA, TB, TO><<<grid, 128, 0, st>>>(
        x, w, wb, bias, out, a_out, b_out, M, N, K, lda, ldb, act, vec);
  }
}

template <bool GATED, bool TA, bool TB>
static void launch_simt(const float* x, const float* w, const float* wb, const float* bias,
                        float* out, float* a_out, float* b_out, int M, int N, int K,
                        long long lda, long long ldb, int act, cudaStream_t st) {
  dim3 grid((N + 63) / 64, (M + 63) / 64);
  mm_simt_f32<GATED, TA, TB><<<grid, 256, 0, st>>>(x, w, wb, bias, out, a_out, b_out, M, N, K,
                                                   lda, ldb, act);
}

// One plain or gated product on the path `impl`: gemv (bf16) or skinny for M <= 16, simt for
// fp32 operands, wgmma or wmma for bf16.  A path that does not take these operands returns
// cudaErrorInvalidValue.  ws: the fp32 workspace of a K split on the skinny or wgmma path.
template <typename T, bool GATED>
static int launch_mm(const void* x, const void* w, const void* wb, const void* bias,
                     void* out, void* ws, float* a_out, float* b_out, int M, int N, int K,
                     int act, int splits, int impl, int bn, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* wbp = static_cast<const T*>(wb);
  const T* bp = static_cast<const T*>(bias);
  T* op = static_cast<T*>(out);
  float* wsp = static_cast<float*>(ws);
  constexpr bool BF = std::is_same<T, bf16>::value;
  if (impl == IMPL_SKINNY) {
    if (M > sk::MAXM || splits < 1) return (int)cudaErrorInvalidValue;
    const int kchunk = (K + splits - 1) / splits;
    dim3 grid((N + sk::BN - 1) / sk::BN, splits);
    mm_skinny<T, GATED><<<grid, sk::THREADS, 0, st>>>(xp, wp, wbp, wsp, M, N, K, kchunk);
    const size_t MN = (size_t)M * N;
    const int blocks = (int)((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
    mm_splitk_epilogue<T, GATED><<<blocks, 256, 0, st>>>(wsp, bp, op, a_out, b_out, M, N, splits,
                                                         act);
  } else if constexpr (BF) {
    if (impl == IMPL_GEMV)
      return gv::launch<GATED>(xp, wp, wbp, bp, op, a_out, b_out, M, N, K, act, splits, st);
    if (impl == IMPL_WGMMA)
      return GATED ? wg::launch_gated(xp, wp, wbp, op, wsp, a_out, b_out, M, N, K, act, bn,
                                      splits, st)
                   : wg::launch<false, false, bf16>(xp, wp, op, wsp, bp, M, N, K, K, N, act, bn,
                                                    splits, st);
    if (impl != IMPL_WMMA) return (int)cudaErrorInvalidValue;
    launch_tc<GATED, false, false, bf16>(xp, wp, wbp, bp, op, a_out, b_out, M, N, K, K, N, act,
                                         st);
  } else {
    if (impl != IMPL_SIMT) return (int)cudaErrorInvalidValue;
    launch_simt<GATED, false, false>(xp, wp, wbp, bp, op, a_out, b_out, M, N, K, K, N, act, st);
  }
  return (int)cudaGetLastError();
}

// The tile matmul's bf16 operands on the path `impl` (wgmma or wmma), output TO.
template <bool TA, bool TB, typename TO>
static int tile_layout(const bf16* a, const bf16* b, TO* out, float* ws, int M, int N, int K,
                       long long lda, long long ldb, int impl, int bn, int splits,
                       cudaStream_t st) {
  if (impl == IMPL_WGMMA)
    return wg::launch<TA, TB, TO>(a, b, out, ws, nullptr, M, N, K, lda, ldb, ACT_NONE, bn,
                                  splits, st);
  if (impl != IMPL_WMMA) return (int)cudaErrorInvalidValue;
  launch_tc<false, TA, TB, TO>(a, b, nullptr, nullptr, out, nullptr, nullptr, M, N, K, lda, ldb,
                               ACT_NONE, st);
  return (int)cudaGetLastError();
}

template <typename TO>
static int tile_bf16(const void* a, const void* b, void* out, void* ws, int M, int N, int K,
                     long long lda, long long ldb, int ta, int tb, int impl, int bn, int splits,
                     cudaStream_t st) {
  const bf16* ap = static_cast<const bf16*>(a);
  const bf16* bp = static_cast<const bf16*>(b);
  TO* op = static_cast<TO*>(out);
  float* wsp = static_cast<float*>(ws);
  if (ta)
    return tile_layout<true, false, TO>(ap, bp, op, wsp, M, N, K, lda, ldb, impl, bn, splits, st);
  if (tb)
    return tile_layout<false, true, TO>(ap, bp, op, wsp, M, N, K, lda, ldb, impl, bn, splits, st);
  return tile_layout<false, false, TO>(ap, bp, op, wsp, M, N, K, lda, ldb, impl, bn, splits, st);
}

extern "C" {

// y = act(x @ w + bias) on the path `impl` (IMPL_*); bias may be null.  ws: the fp32
// workspace, splits * M * N floats, for a K split on the skinny or wgmma path (bn and splits:
// kernels/matmul.py, plan; the gemv path splits K within a cluster and needs none).  Returns a
// cudaError_t.
int hk_matmul(const void* x, const void* w, const void* bias, void* out, void* ws, int M, int N,
              int K, int act, int dtype, int splits, int impl, int bn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch_mm<bf16, false>(x, w, nullptr, bias, out, ws, nullptr, nullptr, M, N, K, act,
                                  splits, impl, bn, st);
  return launch_mm<float, false>(x, w, nullptr, bias, out, ws, nullptr, nullptr, M, N, K, act,
                                 splits, impl, bn, st);
}

// y = act(x @ w1) * (x @ w1b) on the path `impl`, as hk_matmul's; ws holds 2 * splits * M * N
// floats when the path splits K.  a_out / b_out (fp32 [M, N], both or neither) receive x @ w1
// and x @ w1b.
int hk_gated_matmul(const void* x, const void* w1, const void* w1b, void* out, void* ws,
                    void* a_out, void* b_out, int M, int N, int K, int act, int dtype,
                    int splits, int impl, int bn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ao = static_cast<float*>(a_out);
  float* bo = static_cast<float*>(b_out);
  if ((ao == nullptr) != (bo == nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16)
    return launch_mm<bf16, true>(x, w1, w1b, nullptr, out, ws, ao, bo, M, N, K, act, splits,
                                 impl, bn, st);
  return launch_mm<float, true>(x, w1, w1b, nullptr, out, ws, ao, bo, M, N, K, act, splits,
                                impl, bn, st);
}

// The tile matmul: out [M, N] = A @ B with fp32 sums, no epilogue.
// A is [M, K] row-major with leading dim lda, or (ta) stored [K, M]; B is
// [K, N] row-major with leading dim ldb, or (tb) stored [N, K].  ta and tb
// together are refused.  dtype is the operands' (fp32 or bf16), out_dtype
// the output's (the operands' or fp32; fp32 operands give fp32 only).  fp32
// operands take the SIMT path; bf16 ones `impl`, wgmma (bn, splits and the
// workspace ws as hk_matmul's) or wmma.
int hk_tile_matmul(const void* a, const void* b, void* out, void* ws, int M, int N, int K,
                   long long lda, long long ldb, int ta, int tb, int dtype, int out_dtype,
                   int impl, int bn, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ta && tb) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32) {
    if (out_dtype != DT_F32 || impl != IMPL_SIMT) return (int)cudaErrorInvalidValue;
    const float* ap = static_cast<const float*>(a);
    const float* bp = static_cast<const float*>(b);
    float* op = static_cast<float*>(out);
    if (ta)
      launch_simt<false, true, false>(ap, bp, nullptr, nullptr, op, nullptr, nullptr, M, N, K,
                                      lda, ldb, ACT_NONE, st);
    else if (tb)
      launch_simt<false, false, true>(ap, bp, nullptr, nullptr, op, nullptr, nullptr, M, N, K,
                                      lda, ldb, ACT_NONE, st);
    else
      launch_simt<false, false, false>(ap, bp, nullptr, nullptr, op, nullptr, nullptr, M, N, K,
                                       lda, ldb, ACT_NONE, st);
    return (int)cudaGetLastError();
  }
  if (out_dtype == DT_F32)
    return tile_bf16<float>(a, b, out, ws, M, N, K, lda, ldb, ta, tb, impl, bn, splits, st);
  return tile_bf16<bf16>(a, b, out, ws, M, N, K, lda, ldb, ta, tb, impl, bn, splits, st);
}

const char* hk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
