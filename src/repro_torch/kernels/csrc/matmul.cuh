// The matmul kernels that matmul.cu and moe.cu both launch: the epilogue
// (activations, bias, the gated form), the fp32 SIMT tile and the decode
// path's gemv.  matmul.cu runs them on one product (gridDim.z = 1); moe.cu
// on every expert of a grouped product in one launch, the expert being
// blockIdx.z over contiguous x [E, M, K], w [E, K, N] and out [E, M, N]
// (expert e's operands start e M K, e K N and e M N elements in).  For one
// product the expert offsets are 0, so rows 1 and 2 compute exactly what
// they did before the expert coordinate was added.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wg.cuh"

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
// fp32 SIMT path, M > 16: 64x64 tile per block, 4x4 outputs per thread.
// TA / TB read x^T / w^T in place as the tensor-core path does; the loads
// walk the stored rows so neighbouring threads read neighbouring addresses.
// blockIdx.z is the expert (contiguous operands; gridDim.z = 1 for one product).
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
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, e = blockIdx.z;
  x += (size_t)e * M * K;
  w += (size_t)e * K * N;
  if (GATED) wb += (size_t)e * K * N;
  const size_t eo = (size_t)e * M * N;  // the expert's first output
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
        store_out<float, float, GATED>(out, eo + (size_t)m * N + n, acc[i][j], accb[i][j], bias,
                                       n, act, a_out, b_out);
    }
}

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
//   * the expert of a grouped product is gridDim.z, its weights a 3-D map
//     [E, K, N] (E = 1 for one product), x and the output offset by expert;
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
  const int splits = gridDim.y, split = blockIdx.y, n0 = blockIdx.x * BN, e = blockIdx.z;
  const int kbt = (K + BK - 1) / BK, kb0 = split * kper, nk = min(kbt, kb0 + kper) - kb0;
  const int pitch = kper * BK + 8;
  x += (size_t)e * M * K;
  const size_t eo = (size_t)e * M * N;  // the expert's first output
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1k(smem_raw);
  bf16* xs = reinterpret_cast<bf16*>(ring + R::NST * R::STAGE);
  uint4* zero = reinterpret_cast<uint4*>(xs + (size_t)M * pitch);
  uint64_t* full = reinterpret_cast<uint64_t*>(zero + 1);

  const CUtensorMap* wm = &wmap;
  const CUtensorMap* wbm = &wbmap;
  auto load_stage = [&](int i) {  // k-block kb0 + i of expert e into stage i % NST
    const int s = i % R::NST, k = (kb0 + i) * BK;
    uint8_t* st = ring + s * R::STAGE;
    bar_expect(&full[s], R::STAGE);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j) {
      tma_load(st + j * BOX, wm, &full[s], n0 + 64 * j, k, e);
      if (GATED) tma_load(st + W_BYTES + j * BOX, wbm, &full[s], n0 + 64 * j, k, e);
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
        put_pair<GATED>(out, eo + (size_t)m * N + n, n, acc[j][2 * h], acc[j][2 * h + 1],
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
    put_pair<GATED>(out, eo + (size_t)m * N + n, n, sa.x, sa.y, sb.x, sb.y, bias, act, a_out,
                    b_out);
  }
  cluster_sync();  // no block leaves while another still reads its partial
}

// y [E, M, N] on the gemv path (M <= 16, bf16, x [E, M, K] and w, wb [E, K, N] contiguous, K
// and N multiples of 8; E = 1 for one product; bias, one row for every expert).  splits (1 to
// MAXSPLITS) from the wrapper's plan (kernels/matmul.py, gemv_plan): the blocks of one panel's
// splits form a cluster.
template <bool GATED>
static int launch(const bf16* x, const bf16* w, const bf16* wb, const bf16* bias, bf16* out,
                  float* a_out, float* b_out, int E, int M, int N, int K, int act, int splits,
                  cudaStream_t st) {
  if (E < 1 || E > 65535 || M < 1 || M > MAXM || N < 8 || K < 8 || N % 8 || K % 8 ||
      splits < 1 || splits > MAXSPLITS)
    return (int)cudaErrorInvalidValue;
  const int kbt = (K + BK - 1) / BK, kper = (kbt + splits - 1) / splits;
  if ((splits - 1) * kper >= kbt) return (int)cudaErrorInvalidValue;  // an empty split
  const size_t smem = Ring<GATED>::smem(M, kper * BK + 8);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // the plan splits K further first
  CUtensorMap wm, wbm;
  if (!wg::map3d(&wm, w, N, K, E, BK) || (GATED && !wg::map3d(&wbm, wb, N, K, E, BK)))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(gemv<GATED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // all of the SM's memory to shared, so that as many blocks as fit stream at once
  cudaFuncSetAttribute(gemv<GATED>, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, splits, E);
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
