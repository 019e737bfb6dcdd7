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
//     bit for bit the plain version's (kernels/ref.py, moe_combine_plain).  With unit gates it
//     is also the dispatch gather's backward, dx[t] = sum_j dxd[slot_of[t, j]] (mlp.py:110's
//     x[tok_of_slot], differentiated by JAX as a scatter-add).
// And for training, the derivatives JAX takes of the same einsums (jax.value_and_grad):
//   * the grouped products in the two other layouts: NT, dx_e = g_e w_e^T with w [E, K, N]
//     read as its transpose in place, and TN, dw_e = x_e^T g_e, contracted over the expert's C
//     rows; and the gated form's `keep_ab`, which also writes the fp32 products a = xd_e w1_e
//     and b = xd_e w1b_e for swiglu_bwd.cu;
//   * combine_bwd: the combine's derivative, dyd[s] = gate[t, j] dy[t] and dgate[t, j] =
//     dy[t] . yd[s], one block per token, no atomics (each slot has one assignment).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): the expert weights.  At
// granite-moe-3b-a800m's widths (E 40, H 1536, F 512) a layer's experts are 189 MB of bf16,
// read once per step whatever C is; the products at C = 128 (a 512-token prefill) are 16
// GFLOP, 16 us at the peak against 38 us for the up-projection's 126 MB.  So every route
// streams each expert's weights once, and a step's experts are one launch per product (a
// launch per expert would be 80 a layer, each paying the host's 20-60 us).  A training
// microbatch of 2048 tokens gives C = 512: ~97 GFLOP of products forward and ~193 backward a
// layer (98 and 195 us at the peak), against ~360 MB of weights and rows forward (107 us):
// there the products and the bytes bound about equally.
//
// Three routes for the products; kernels/moe.py (grouped_impl) picks one from the dtype, C and
// whether a gradient is needed:
//   * wgmma (bf16: C > 16, and any C in training): wg::mm's persistent loop (wg.cuh's Tile,
//     load_unit, mma_unit) with the expert as a third coordinate of the work unit.  A unit is
//     one expert's 128 x 128 output tile over the whole of K; the producer loads it through
//     3-D TMA maps ([E, rows, cols] stacks, boxes of one expert), so a box never reads across
//     an expert's rows: TMA zero-fills rows past C and k past K (TN's partial k-block of C
//     rows included).  Units go expert-major, m fastest within an expert.  No K split.  The
//     NT and TN layouts use wgmma's transpose bits as hk_tile_matmul does.
//   * gemv (bf16, C <= 16, serving only: NN, no kept products): matmul.cuh's gv::gemv, row
//     1/2's decode kernel, with the expert as gridDim.z: each block streams one 128-column
//     panel of one expert's weights by TMA through a ring of stages, the expert's C rows of x
//     staged once, mma.sync m16n8k16, K split over the blocks of a cluster and summed in rank
//     order over distributed shared memory.
//   * simt (fp32, the checking dtype): matmul.cuh's mm_simt_f32, row 1's 64 x 64 SIMT tile,
//     in every layout, with the expert as gridDim.z, held to 2e-4.
// Operands are contiguous and 16-byte aligned; N and each stored row (K, or TN's M) are
// multiples of 8 (the wrapper checks).

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

// out [E, M, N] = act(A_e B_e) (* A_e B2_e, gated) for every expert, A_e [M, K] read K-major
// or (TA) MN-major from a stored [K, M], B_e [K, N] read MN-major or (TB) K-major from a stored
// [N, K]; a_out / b_out (gated, or null) keep the fp32 products.  A block walks the units
// blockIdx.x, blockIdx.x + gridDim.x, ...: a producer warpgroup (one thread) loading through
// wg::load_unit with the expert as the 3-D maps' third coordinate, and two consumer
// warpgroups of 64 rows each, as wg::mm.
template <bool GATED, bool TA, bool TB>
__global__ void __launch_bounds__(wg::THREADS, 1)
grouped_wgmma(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
              const __grid_constant__ CUtensorMap bmap2, bf16* __restrict__ out,
              float* __restrict__ a_out, float* __restrict__ b_out, int E, int M, int N, int K,
              int act) {
  static_assert(!GATED || (!TA && !TB), "the gated product is NN");
  using T = wg::Tile<WBN, GATED>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::NST * T::STAGE);
  uint64_t* empty = full + T::NST;
  const int mt = (M + wg::BM - 1) / wg::BM, nt = (N + WBN - 1) / WBN;
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
        wg::load_unit<WBN, TA, TB, GATED>(ring, full, empty, &amap, &bmap, &bmap2,
                                          (r % mt) * wg::BM, (r / mt) * WBN, 0, kbt, it, wait,
                                          wg::A_BYTES, 0, e);
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
    wg::mma_unit<WBN, TA, TB, GATED>(ring, full, empty, acc, accb, 0, kbt, c, t, it, wait);
    // thread t holds rows r0, r0 + 8 and the column pairs 8i + 2 (lane % 4) + {0, 1} of its
    // warpgroup's 64 x 128 accumulator(s); N % 8 == 0, so every pair is whole
    const int r0 = m0 + c * 64 + (t / 32) * 16 + lane / 4;
    const int c0 = n0 + 2 * (lane % 4);
    const size_t eo = (size_t)e * M * N;  // the expert's first output
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int i = 0; i < WBN / 8; ++i) {
        const int n = c0 + 8 * i;
        if (n >= N) continue;
        const int q = 4 * i + 2 * h;
        const size_t o = eo + (size_t)m * N + n;
        if (GATED && a_out != nullptr) {
          wg::store2(a_out + o, acc[q], acc[q + 1]);
          wg::store2(b_out + o, accb[q], accb[q + 1]);
        }
        wg::store2(out + o, epilogue<GATED>(acc[q], accb[q], act),
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
// the combine's backward: one block per token, and zeroing blocks for the empty slots
// ---------------------------------------------------------------------------
// Blocks [0, T): token t, for each of its k assignments j with s = slot_of[t, j] >= 0,
// dyd[s] = gate[t, j] dy[t] (one fp32 product, one cast: the plain version's bits) and
// dgate[t, j] = sum_h dy[t, h] yd[s, h] in fp32: each thread's column pairs in h order, then
// the warps' shuffle tree and the warps' sums in warp order, the same every run; a dropped
// assignment's dgate is 0.  Each slot belongs to one assignment, so every row of dyd has one
// writer and no atomics are needed.  Blocks [T, gridDim.x): the rows r of slots no assignment
// took (slot_tok[r] >= T k), zeroed, r strided by the zeroing blocks' count.
template <typename T>
__global__ void __launch_bounds__(256)
combine_bwd(const T* __restrict__ dy, const T* __restrict__ yd, const float* __restrict__ gate,
            const int* __restrict__ slot_of, const int* __restrict__ slot_tok,
            T* __restrict__ dyd, float* __restrict__ dgate, int Tn, int k, int rows, int H) {
  __shared__ float red[8];
  if (blockIdx.x >= Tn) {
    const int zb = blockIdx.x - Tn, nz = gridDim.x - Tn;
    for (int r = zb; r < rows; r += nz) {
      if (__ldg(slot_tok + r) < Tn * k) continue;
      for (int h = 2 * threadIdx.x; h < H; h += 2 * blockDim.x)
        wg::store2(dyd + (size_t)r * H + h, 0.f, 0.f);
    }
    return;
  }
  const int t = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const T* dyt = dy + (size_t)t * H;
  for (int j = 0; j < k; ++j) {
    const int s = __ldg(slot_of + (size_t)t * k + j);
    if (s < 0) {  // a dropped assignment (the branch is the block's)
      if (threadIdx.x == 0) dgate[(size_t)t * k + j] = 0.f;
      continue;
    }
    const float gj = __ldg(gate + (size_t)t * k + j);
    const T* ys = yd + (size_t)s * H;
    float acc = 0.f;
    for (int h = 2 * threadIdx.x; h < H; h += 2 * blockDim.x) {
      const float2 d = load2(dyt + h), v = load2(ys + h);
      wg::store2(dyd + (size_t)s * H + h, __fmul_rn(gj, d.x), __fmul_rn(gj, d.y));
      acc = fmaf(d.x, v.x, acc);
      acc = fmaf(d.y, v.y, acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) red[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int w = 0; w < warps; ++w) sum += red[w];
      dgate[(size_t)t * k + j] = sum;
    }
    __syncthreads();
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

// the layouts of a grouped product, as kernels/moe.py::LAYOUTS numbers them: out_e [M, N] =
// A_e B_e over K with A stored [M, K] and B [K, N] (NN, the forward), B stored [N, K] (NT,
// dx = g w^T), or A stored [K, M] (TN, dw = x^T g)
enum { LAYOUT_NN = 0, LAYOUT_NT = 1, LAYOUT_TN = 2 };

template <bool GATED, bool TA, bool TB>
static int launch_wgmma(const bf16* x, const bf16* w, const bf16* wb, bf16* out, float* a_out,
                        float* b_out, int E, int M, int K, int N, int act, cudaStream_t st) {
  CUtensorMap am, bm, bm2;
  const bool maps =
      (TA ? wg::map3d(&am, x, M, K, E, 64) : wg::map3d(&am, x, K, M, E, wg::BM)) &&
      (TB ? wg::map3d(&bm, w, K, N, E, WBN) : wg::map3d(&bm, w, N, K, E, 64)) &&
      (!GATED || wg::map3d(&bm2, wb, N, K, E, 64));
  if (!maps) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = wg::Tile<WBN, GATED>::SMEM;
  cudaFuncSetAttribute(grouped_wgmma<GATED, TA, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const long long units =
      (long long)E * ((M + wg::BM - 1) / wg::BM) * ((N + WBN - 1) / WBN);
  if (units > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(units < sm_count() ? units : sm_count());
  grouped_wgmma<GATED, TA, TB><<<grid, wg::THREADS, smem, st>>>(
      am, bm, GATED ? bm2 : bm, out, a_out, b_out, E, M, N, K, act);
  return (int)cudaGetLastError();
}

template <bool GATED, bool TA, bool TB>
static int launch_simt(const float* x, const float* w, const float* wb, float* out,
                       float* a_out, float* b_out, int E, int M, int K, int N, int act,
                       cudaStream_t st) {
  dim3 grid((N + 63) / 64, (M + 63) / 64, E);
  mm_simt_f32<GATED, TA, TB><<<grid, 256, 0, st>>>(x, w, wb, nullptr, out, a_out, b_out, M, N, K,
                                                   TA ? M : K, TB ? K : N, act);
  return (int)cudaGetLastError();
}

template <bool GATED>
static int launch_grouped(const void* x, const void* w, const void* wb, void* out, float* a_out,
                          float* b_out, int E, int M, int K, int N, int act, int dtype, int impl,
                          int splits, int layout, cudaStream_t st) {
  if (E < 1 || M < 1 || K < 1 || N < 8 || N % 8 || E > 65535 || layout < 0 || layout > 2)
    return (int)cudaErrorInvalidValue;
  // the stored rows TMA and the gemv read, on 16 bytes: N, and K (NN, NT) or M (TN)
  if ((layout == LAYOUT_TN ? M : K) % 8) return (int)cudaErrorInvalidValue;
  if (GATED && layout != LAYOUT_NN) return (int)cudaErrorInvalidValue;
  if ((a_out == nullptr) != (b_out == nullptr) || (!GATED && a_out != nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == DT_F32) {
    if (impl != IMPL_SIMT) return (int)cudaErrorInvalidValue;
    const float* xp = static_cast<const float*>(x);
    const float* wp = static_cast<const float*>(w);
    const float* wbp = static_cast<const float*>(wb);
    float* op = static_cast<float*>(out);
    if (layout == LAYOUT_NT)
      return launch_simt<false, false, true>(xp, wp, wbp, op, a_out, b_out, E, M, K, N, act, st);
    if (layout == LAYOUT_TN)
      return launch_simt<false, true, false>(xp, wp, wbp, op, a_out, b_out, E, M, K, N, act, st);
    return launch_simt<GATED, false, false>(xp, wp, wbp, op, a_out, b_out, E, M, K, N, act, st);
  }
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* wbp = static_cast<const bf16*>(wb);
  bf16* op = static_cast<bf16*>(out);
  if (impl == IMPL_WGMMA) {
    if (layout == LAYOUT_NT)
      return launch_wgmma<false, false, true>(xp, wp, wbp, op, a_out, b_out, E, M, K, N, act,
                                              st);
    if (layout == LAYOUT_TN)
      return launch_wgmma<false, true, false>(xp, wp, wbp, op, a_out, b_out, E, M, K, N, act,
                                              st);
    return launch_wgmma<GATED, false, false>(xp, wp, wbp, op, a_out, b_out, E, M, K, N, act, st);
  }
  if (impl == IMPL_GEMV && layout == LAYOUT_NN && a_out == nullptr)
    return gv::launch<GATED>(xp, wp, wbp, nullptr, op, nullptr, nullptr, E, M, N, K, act, splits,
                             st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace moe

extern "C" {

// out [E, M, N] = act(A_e B_e) for every expert e, or, with wb non-null, act(A_e B_e) *
// (A_e wb_e): contiguous operands in dtype (DT_*), laid out as `layout` (LAYOUT_*: A = x
// [E, M, K] or, TN, x [E, K, M]; B = w [E, K, N] or, NT, w [E, N, K]; the gated form NN only),
// on the route `impl` (IMPL_*; splits: the gemv route's K split, kernels/moe.py's plan).
// a_out / b_out (fp32 [E, M, N], both or neither, gated only; wgmma or simt) keep the products
// A_e w_e and A_e wb_e for the backward.  Returns a cudaError_t; a route that does not take
// the operands returns cudaErrorInvalidValue.
int hk_moe_grouped(const void* x, const void* w, const void* wb, void* out, void* a_out,
                   void* b_out, int E, int M, int K, int N, int act, int dtype, int impl,
                   int splits, int layout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ao = static_cast<float*>(a_out);
  float* bo = static_cast<float*>(b_out);
  if (wb != nullptr)
    return moe::launch_grouped<true>(x, w, wb, out, ao, bo, E, M, K, N, act, dtype, impl, splits,
                                     layout, st);
  return moe::launch_grouped<false>(x, w, wb, out, ao, bo, E, M, K, N, act, dtype, impl, splits,
                                    layout, st);
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

// The combine's backward: dyd [rows, H] (rows = E C, in dy's dtype) and dgate fp32 [T, k]
// from dy [T, H] and yd [rows, H] (fp32 or bf16, H even), gate fp32 [T, k], slot_of int32
// [T, k] (entries in [-1, rows)) and slot_tok int32 [rows] (each slot's assignment t k + j, or
// at least T k where the slot is empty).
int hk_moe_combine_bwd(const void* dy, const void* yd, const void* gate, const void* slot_of,
                       const void* slot_tok, void* dyd, void* dgate, int T, int k, int rows,
                       int H, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || k < 1 || rows < 1 || H < 2 || H % 2) return (int)cudaErrorInvalidValue;
  const int threads = H / 2 < 256 ? ((H / 2 + 31) / 32) * 32 : 256;
  const int zero_blocks = rows < 2 * moe::sm_count() ? rows : 2 * moe::sm_count();
  const int grid = T + zero_blocks;
  const int* so = static_cast<const int*>(slot_of);
  const int* stk = static_cast<const int*>(slot_tok);
  const float* g = static_cast<const float*>(gate);
  float* dg = static_cast<float*>(dgate);
  if (dtype == DT_BF16)
    moe::combine_bwd<bf16><<<grid, threads, 0, st>>>(
        static_cast<const bf16*>(dy), static_cast<const bf16*>(yd), g, so, stk,
        static_cast<bf16*>(dyd), dg, T, k, rows, H);
  else
    moe::combine_bwd<float><<<grid, threads, 0, st>>>(
        static_cast<const float*>(dy), static_cast<const float*>(yd), g, so, stk,
        static_cast<float*>(dyd), dg, T, k, rows, H);
  return (int)cudaGetLastError();
}

const char* hk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
