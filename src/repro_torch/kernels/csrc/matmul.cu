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
// gated_matmul; the tile matmul takes any extent (element loads where a
// vector is off 16 bytes).  Everything else is free: ragged edges are
// masked here, unlike the Pallas kernel which asserts divisibility.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16):
//   * decode (M = number of slots, 4) is weight-byte bound: every weight
//     byte is read once per step, about 1.19 GB for qwen3-0.6b in bf16,
//     so about 0.36 ms per step at the memory rate.  The skinny path below
//     (M <= 16) streams w once with coalesced vector loads and splits K
//     over blocks so that enough loads are in flight to cover the card;
//     the split partials are fp32 and summed in a fixed order by the
//     epilogue kernel, so results are deterministic.
//   * prefill, training (M = 2048 tokens per microbatch, and the dw
//     products with M = d_in, K = 2048) and head matmuls are near the FLOP
//     bound (2*M*K*N operations against (M*K + K*N + M*N) * 2 bytes; the
//     training head 2048 x 1024 x 152064 is 0.64 TFLOP, 0.65 ms at peak).
//     The tensor-core path below stages bf16 tiles (K step 32) through
//     shared memory in each operand's own layout, prefetching the next step
//     into registers, and runs WMMA m16n16k16 with fp32 accumulators; it is
//     the simple route to the tensor cores (no wgmma, no TMA, no
//     multi-stage pipeline yet), so it reaches a fraction of the peak.
//   * fp32 with M > 16 runs a plain SIMT tiled kernel (64x64 tiles, 4x4
//     outputs per thread): fp32 is the checking dtype, not the serving or
//     training one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

enum { ACT_NONE = 0, ACT_RELU2 = 1, ACT_GELU = 2, ACT_SILU = 3 };
enum { DT_F32 = 0, DT_BF16 = 1 };

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
// bf16 tensor-core path, M > 16: one BM x BN output tile per block, warps
// laid out WARPS_M x WARPS_N, each owning FM x FN WMMA fragments.  Two tile
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
// Skinny path, M <= 16 (decode): a block owns 64 columns and one K chunk;
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
// host side
// ---------------------------------------------------------------------------
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

template <typename T, bool GATED>
static int launch_mm(const void* x, const void* w, const void* wb, const void* bias,
                     void* out, void* ws, float* a_out, float* b_out, int M, int N, int K,
                     int act, int splits, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* wbp = static_cast<const T*>(wb);
  const T* bp = static_cast<const T*>(bias);
  T* op = static_cast<T*>(out);
  if (M <= sk::MAXM) {
    const int kchunk = (K + splits - 1) / splits;
    dim3 grid((N + sk::BN - 1) / sk::BN, splits);
    mm_skinny<T, GATED><<<grid, sk::THREADS, 0, st>>>(xp, wp, wbp, static_cast<float*>(ws),
                                                      M, N, K, kchunk);
    const size_t MN = (size_t)M * N;
    const int blocks = (int)((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
    mm_splitk_epilogue<T, GATED><<<blocks, 256, 0, st>>>(static_cast<const float*>(ws), bp, op,
                                                         a_out, b_out, M, N, splits, act);
  } else if constexpr (std::is_same<T, bf16>::value) {
    launch_tc<GATED, false, false, bf16>(xp, wp, wbp, bp, op, a_out, b_out, M, N, K, K, N, act,
                                         st);
  } else {
    launch_simt<GATED, false, false>(xp, wp, wbp, bp, op, a_out, b_out, M, N, K, K, N, act, st);
  }
  return (int)cudaGetLastError();
}

extern "C" {

// y = act(x @ w + bias); bias may be null.  ws: fp32 workspace of
// splits*M*N floats when M <= 16, else unused.  Returns a cudaError_t.
int hk_matmul(const void* x, const void* w, const void* bias, void* out, void* ws,
              int M, int N, int K, int act, int dtype, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16)
    return launch_mm<bf16, false>(x, w, nullptr, bias, out, ws, nullptr, nullptr, M, N, K, act,
                                  splits, st);
  return launch_mm<float, false>(x, w, nullptr, bias, out, ws, nullptr, nullptr, M, N, K, act,
                                 splits, st);
}

// y = act(x @ w1) * (x @ w1b).  ws: 2*splits*M*N floats when M <= 16.
// a_out / b_out (fp32 [M, N], both or neither) receive x @ w1 and x @ w1b.
int hk_gated_matmul(const void* x, const void* w1, const void* w1b, void* out, void* ws,
                    void* a_out, void* b_out, int M, int N, int K, int act, int dtype,
                    int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ao = static_cast<float*>(a_out);
  float* bo = static_cast<float*>(b_out);
  if ((ao == nullptr) != (bo == nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16)
    return launch_mm<bf16, true>(x, w1, w1b, nullptr, out, ws, ao, bo, M, N, K, act, splits, st);
  return launch_mm<float, true>(x, w1, w1b, nullptr, out, ws, ao, bo, M, N, K, act, splits, st);
}

// The tile matmul: out [M, N] = A @ B with fp32 sums, no epilogue.
// A is [M, K] row-major with leading dim lda, or (ta) stored [K, M]; B is
// [K, N] row-major with leading dim ldb, or (tb) stored [N, K].  ta and tb
// together are refused.  dtype is the operands' (fp32 or bf16), out_dtype
// the output's (the operands' or fp32; fp32 operands give fp32 only).
int hk_tile_matmul(const void* a, const void* b, void* out, int M, int N, int K, long long lda,
                   long long ldb, int ta, int tb, int dtype, int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ta && tb) return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32) {
    if (out_dtype != DT_F32) return (int)cudaErrorInvalidValue;
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
  const bf16* ap = static_cast<const bf16*>(a);
  const bf16* bp = static_cast<const bf16*>(b);
  if (out_dtype == DT_F32) {
    float* op = static_cast<float*>(out);
    if (ta)
      launch_tc<false, true, false, float>(ap, bp, nullptr, nullptr, op, nullptr, nullptr, M, N,
                                           K, lda, ldb, ACT_NONE, st);
    else if (tb)
      launch_tc<false, false, true, float>(ap, bp, nullptr, nullptr, op, nullptr, nullptr, M, N,
                                           K, lda, ldb, ACT_NONE, st);
    else
      launch_tc<false, false, false, float>(ap, bp, nullptr, nullptr, op, nullptr, nullptr, M,
                                            N, K, lda, ldb, ACT_NONE, st);
  } else {
    bf16* op = static_cast<bf16*>(out);
    if (ta)
      launch_tc<false, true, false, bf16>(ap, bp, nullptr, nullptr, op, nullptr, nullptr, M, N,
                                          K, lda, ldb, ACT_NONE, st);
    else if (tb)
      launch_tc<false, false, true, bf16>(ap, bp, nullptr, nullptr, op, nullptr, nullptr, M, N,
                                          K, lda, ldb, ACT_NONE, st);
    else
      launch_tc<false, false, false, bf16>(ap, bp, nullptr, nullptr, op, nullptr, nullptr, M, N,
                                           K, lda, ldb, ACT_NONE, st);
  }
  return (int)cudaGetLastError();
}

const char* hk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
