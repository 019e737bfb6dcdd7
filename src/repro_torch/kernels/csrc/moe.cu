// Hand-written Hopper (sm_90a) kernels of the MoE's experts.
//
// No pallas_call computes the experts: in repro/models/mlp.py::_moe_local they are einsums
// over the dispatched rows and a scatter-add (mlp.py:110-132).  These kernels replace them:
//   * grouped_gated (mlp.py:115-121): h_e = act(xd_e w1_e) * (xd_e w1b_e) for every expert e
//     of xd [E, C, H], w1 and w1b [E, H, F], in one launch; fp32 sums, the gate in fp32, one
//     cast to bf16 (or fp32);
//   * grouped_mm (mlp.py:126, and :115 for a non-gated expert): y_e = act(h_e w_e) for every
//     expert, h [E, C, K], w [E, K, N], in one launch;
//   * combine (mlp.py:127-132): y[t] = sum_j gate[t, j] yd[slot_of[t, j]] over token t's valid
//     assignments (slot_of -1: dropped), one block per token, the products and the sum in fp32
//     in j order, one cast.  No atomics: JAX scatter-adds, and an index_add_ on the card
//     would add in an order that changes from run to run; this sum is the same every run, and
//     bit for bit the plain version's (kernels/ref.py, moe_combine_plain).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): the expert weights.  At
// granite-moe-3b-a800m's widths (E 40, H 1536, F 512) a layer's experts are 189 MB of bf16,
// read once per step whatever C is; the products at C = 128 (a 512-token prefill) are 16
// GFLOP, 16 us at the peak against 38 us for the up-projection's 126 MB.  So every route
// streams each expert's weights once, and a step's experts are one launch per product (a
// launch per expert would be 80 a layer, each paying the host's 20-60 us).
//
// Three routes for the products; kernels/moe.py (grouped_impl) picks one from the dtype and C:
//   * wgmma (bf16, C > 16: prefill): wg::mm's persistent loop (wg.cuh's Tile, mma_unit) with the
//     expert as a third coordinate of the work unit.  A unit is one expert's 128 x 128 output
//     tile over the whole of K; the producer loads it through 3-D TMA maps ([E, C, K] and
//     [E, K, N]), so a box never reads across an expert's rows: TMA zero-fills rows past C
//     and k past K.  Units go expert-major, m fastest within an expert.  No K split.
//   * gemv (bf16, C <= 16: decode): matmul.cuh's gv::gemv, row 1/2's decode kernel, with
//     the expert as gridDim.z: each block streams one 128-column panel of one expert's
//     weights by TMA through a ring of stages, the expert's C rows of x staged once,
//     mma.sync m16n8k16, K split over the blocks of a cluster and summed in rank order over
//     distributed shared memory.
//   * simt (fp32, the checking dtype): matmul.cuh's mm_simt_f32, row 1's 64 x 64 SIMT tile,
//     with the expert as gridDim.z, held to 2e-4.
// Operands are contiguous, 16-byte aligned, K and N multiples of 8 (the wrapper checks).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "matmul.cuh"
#include "wg.cuh"

// the routes, as kernels/moe.py::IMPLS numbers them
enum { IMPL_WGMMA = 0, IMPL_GEMV = 1, IMPL_SIMT = 2 };

namespace moe {
using namespace hopper;

template <bool GATED>
__device__ __forceinline__ float epilogue(float a, float b, int act) {
  return GATED ? apply_act(a, act) * b : apply_act(a, act);
}

// ---------------------------------------------------------------------------
// wgmma route
// ---------------------------------------------------------------------------
constexpr int WBN = 128;  // output tile width: 128 (the gated tile's; two accumulators fill it)

// wg::load_unit for a K-major A and an MN-major B (and B2, gated) of expert e: k-blocks
// [0, kbt) of rows m0.. of A [E, C, K] and columns n0.. of B [E, K, N] into the next stages.
template <bool GATED, typename Wait>
__device__ __forceinline__ void load_unit3(uint8_t* ring, uint64_t* full, uint64_t* empty,
                                           const CUtensorMap* amap, const CUtensorMap* bmap,
                                           const CUtensorMap* bmap2, int e, int m0, int n0,
                                           int kbt, int& it, Wait wait) {
  using T = wg::Tile<WBN, GATED>;
  for (int kb = 0; kb < kbt; ++kb, ++it) {
    const int s = it % T::NST;
    if (it >= T::NST) wait(&empty[s], (it / T::NST - 1) & 1);
    uint8_t* as = ring + s * T::STAGE;
    uint8_t* bs = as + wg::A_BYTES;
    bar_expect(&full[s], T::STAGE);  // every box's bytes, zero-filled edges included
    tma_load(as, amap, &full[s], kb * wg::BK, m0, e);
#pragma unroll
    for (int j = 0; j < WBN / 64; ++j) {
      tma_load(bs + j * wg::BOX, bmap, &full[s], n0 + 64 * j, kb * wg::BK, e);
      if (GATED) tma_load(bs + T::B_BYTES + j * wg::BOX, bmap2, &full[s], n0 + 64 * j,
                           kb * wg::BK, e);
    }
  }
}

// out [E, C, N] = act(A_e B_e) (* A_e B2_e, gated) for every expert; a block walks the units
// blockIdx.x, blockIdx.x + gridDim.x, ...: a producer warpgroup (one thread) and two consumer
// warpgroups of 64 rows each, as wg::mm.
template <bool GATED>
__global__ void __launch_bounds__(wg::THREADS, 1)
grouped_wgmma(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
              const __grid_constant__ CUtensorMap bmap2, bf16* __restrict__ out, int E, int C,
              int N, int K, int act) {
  using T = wg::Tile<WBN, GATED>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::NST * T::STAGE);
  uint64_t* empty = full + T::NST;
  const int mt = (C + wg::BM - 1) / wg::BM, nt = (N + WBN - 1) / WBN;
  const int kbt = (K + wg::BK - 1) / wg::BK, per = mt * nt, units = E * per;

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
        const int e = u / per, r = u % per;
        load_unit3<GATED>(ring, full, empty, &amap, &bmap, &bmap2, e, (r % mt) * wg::BM,
                          (r / mt) * WBN, kbt, it, wait);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = threadIdx.x / 128 - 1, t = threadIdx.x % 128, lane = t % 32;
  float acc[WBN / 2], accb[WBN / 2];  // accb: the gated form's A B2 (unused otherwise)
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int e = u / per, r = u % per, m0 = (r % mt) * wg::BM, n0 = (r / mt) * WBN;
    wg::mma_unit<WBN, false, false, GATED>(ring, full, empty, acc, accb, 0, kbt, c, t, it,
                                           wait);
    // thread t holds rows r0, r0 + 8 and the column pairs 8i + 2 (lane % 4) + {0, 1} of its
    // warpgroup's 64 x 128 accumulator(s); N % 8 == 0, so every pair is whole
    const int r0 = m0 + c * 64 + (t / 32) * 16 + lane / 4;
    const int c0 = n0 + 2 * (lane % 4);
    bf16* oe = out + (size_t)e * C * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + 8 * h;
      if (m >= C) continue;
#pragma unroll
      for (int i = 0; i < WBN / 8; ++i) {
        const int n = c0 + 8 * i;
        if (n >= N) continue;
        const int q = 4 * i + 2 * h;
        wg::store2(oe + (size_t)m * N + n, epilogue<GATED>(acc[q], accb[q], act),
                   epilogue<GATED>(acc[q + 1], accb[q + 1], act));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the combine: one block per token, each thread a column pair at a time
// ---------------------------------------------------------------------------
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__global__ void __launch_bounds__(256)
combine(const T* __restrict__ yd, const float* __restrict__ gate,
        const int* __restrict__ slot_of, T* __restrict__ out, int k, int H) {
  const int t = blockIdx.x;
  const float* g = gate + (size_t)t * k;
  const int* so = slot_of + (size_t)t * k;
  for (int h = 2 * threadIdx.x; h < H; h += 2 * blockDim.x) {
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < k; ++j) {
      const int s = __ldg(so + j);
      if (s < 0) continue;  // a dropped assignment
      const float gj = __ldg(g + j);
      const float2 v = load2(yd + (size_t)s * H + h);
      // the plain version's rounding: the product, then the sum, each in fp32 (no FMA)
      a0 = __fadd_rn(a0, __fmul_rn(gj, v.x));
      a1 = __fadd_rn(a1, __fmul_rn(gj, v.y));
    }
    wg::store2(out + (size_t)t * H + h, a0, a1);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

static int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <bool GATED>
static int launch_wgmma(const bf16* x, const bf16* w, const bf16* wb, bf16* out, int E, int C,
                        int K, int N, int act, cudaStream_t st) {
  CUtensorMap am, bm, bm2;
  if (!wg::map3d(&am, x, K, C, E, wg::BM) || !wg::map3d(&bm, w, N, K, E, 64) ||
      (GATED && !wg::map3d(&bm2, wb, N, K, E, 64)))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = wg::Tile<WBN, GATED>::SMEM;
  cudaFuncSetAttribute(grouped_wgmma<GATED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const long long units =
      (long long)E * ((C + wg::BM - 1) / wg::BM) * ((N + WBN - 1) / WBN);
  if (units > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(units < sm_count() ? units : sm_count());
  grouped_wgmma<GATED><<<grid, wg::THREADS, smem, st>>>(am, bm, GATED ? bm2 : bm, out, E, C, N,
                                                        K, act);
  return (int)cudaGetLastError();
}

template <bool GATED>
static int launch_grouped(const void* x, const void* w, const void* wb, void* out, int E, int C,
                          int K, int N, int act, int dtype, int impl, int splits,
                          cudaStream_t st) {
  if (E < 1 || C < 1 || K < 8 || N < 8 || K % 8 || N % 8 || E > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32) {
    if (impl != IMPL_SIMT) return (int)cudaErrorInvalidValue;
    dim3 grid((N + 63) / 64, (C + 63) / 64, E);
    mm_simt_f32<GATED, false, false><<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(wb), nullptr, static_cast<float*>(out), nullptr, nullptr, C,
        N, K, K, N, act);
    return (int)cudaGetLastError();
  }
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* wbp = static_cast<const bf16*>(wb);
  bf16* op = static_cast<bf16*>(out);
  if (impl == IMPL_WGMMA) return launch_wgmma<GATED>(xp, wp, wbp, op, E, C, K, N, act, st);
  if (impl == IMPL_GEMV)
    return gv::launch<GATED>(xp, wp, wbp, nullptr, op, nullptr, nullptr, E, C, N, K, act, splits,
                             st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace moe

extern "C" {

// out [E, C, N] = act(x_e w_e) for every expert e, or, with wb non-null, act(x_e w_e) *
// (x_e wb_e): x [E, C, K], w and wb [E, K, N], contiguous, in dtype (DT_*), on the route `impl`
// (IMPL_*; splits: the gemv route's K split, kernels/moe.py's plan).  Returns a cudaError_t;
// a route that does not take the operands returns cudaErrorInvalidValue.
int hk_moe_grouped(const void* x, const void* w, const void* wb, void* out, int E, int C, int K,
                   int N, int act, int dtype, int impl, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wb != nullptr)
    return moe::launch_grouped<true>(x, w, wb, out, E, C, K, N, act, dtype, impl, splits, st);
  return moe::launch_grouped<false>(x, w, wb, out, E, C, K, N, act, dtype, impl, splits, st);
}

// out [T, H] = the gated sum of each token's expert rows: yd [rows, H] (fp32 or bf16, H even),
// gate fp32 [T, k], slot_of int32 [T, k] with entries in [-1, rows).
int hk_moe_combine(const void* yd, const void* gate, const void* slot_of, void* out, int T,
                   int k, int H, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || k < 1 || H < 2 || H % 2) return (int)cudaErrorInvalidValue;
  const int threads = H / 2 < 256 ? ((H / 2 + 31) / 32) * 32 : 256;
  if (dtype == DT_BF16)
    moe::combine<bf16><<<T, threads, 0, st>>>(static_cast<const bf16*>(yd),
                                              static_cast<const float*>(gate),
                                              static_cast<const int*>(slot_of),
                                              static_cast<bf16*>(out), k, H);
  else
    moe::combine<float><<<T, threads, 0, st>>>(static_cast<const float*>(yd),
                                               static_cast<const float*>(gate),
                                               static_cast<const int*>(slot_of),
                                               static_cast<float*>(out), k, H);
  return (int)cudaGetLastError();
}

const char* hk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
