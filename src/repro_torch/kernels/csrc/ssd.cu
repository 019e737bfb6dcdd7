// Hand-written Hopper (sm_90a) Mamba2 SSD chunked-scan kernels of the port.
//
// Replaces the TPU kernel repro/kernels/ssd.py::ssd (pallas_call at
// ssd.py:88, body _ssd_kernel:26), the prefill scan of every mamba layer.
// Per (batch, head) the chunks of Q positions run in order with an fp32
// state h [dh, ds] carried between them.  With cum the inclusive cumsum of
// dA = dt * A inside the chunk (A < 0, so cum falls):
//     L[i][j]  = exp(cum_i - cum_j) for j <= i, else 0
//     y        = (C B^T o L)(x dt) + exp(cum) (C h^T)
//     h       <- h exp(cum_last) + (x o exp(cum_last - cum) dt)^T B
// Both kernels also take the optional fp32 initial state and write the fp32
// final state, which the model's ssd_chunked returns and the serving pool
// keeps.  The output y is in x's dtype, without the D skip; every sum is fp32.
//
// What differs from the Pallas kernel (both kernels):
//  * Ragged length: S need not be a multiple of Q.  Positions >= S read as
//    dt = 0 and x = B = C = 0 (decay 1, no input) without touching memory
//    past the end, so the final state is the state after the last token.
//  * Overflow: cum reaches -300 and below inside one chunk at mamba2's
//    A = -(1..24), so exp(cum_i) * exp(-cum_j) would overflow fp32; the
//    kernels form cum_i - cum_j first, on the lower triangle only (every
//    exponent is <= 0), as _segsum does.
//  * Groups: B and C are read at group head / (nh / g) in place (no repeat),
//    and x, B, C are read through (batch, position) strides, so the model
//    hands over its slices of the conv output without a copy.
//
// Bound on an H100 SXM, mamba2-130m prefill of 512 tokens at batch 1, per
// layer: it moves about 5 MB (x and y 1.6 MB each in bf16, B and C, dt,
// the fp32 states in and out) and needs 0.71 GFLOP (the lower triangles of
// C B^T and of the scores times x, C h^T and the state update, per chunk
// and head): 1.5 us by bytes in bf16 (0.7 us at the bf16 tensor-core
// rate), 10.6 us by operations on the fp32 units in fp32.
//
// Two routes; the wrapper (kernels/ssd.py, ssd_impl) picks one:
//
// * tc::ssd, bf16 on the tensor cores (mamba2's dh 64 and ds 128, any chunk
//   up to 128).  In the SSD algorithm only the carry of h [dh, ds] from
//   chunk to chunk is sequential: the scores, the chunk's own part of y and
//   its contribution to the state need no other chunk.  So one block owns
//   one chunk of one (batch, head) and the chunks of a head run in
//   parallel: they form a thread-block cluster of up to 8 (longer S loops
//   over the cluster's blocks in rounds), and h passes from block to block
//   through distributed shared memory.  A block's two warpgroups each own
//   64 rows of a 128-row chunk (warpgroup 0 alone for chunks of up to 64):
//     - x, B and C arrive by TMA (rows past S zero-filled) into bf16 tiles
//       in the 128-byte swizzle that wgmma reads, and the initial state by
//       cp.async, all issued at entry; dt and cum by a warp scan meanwhile;
//     - scores C B^T by wgmma (C and B K-major, fp32 accumulators), only the
//       64-column tiles at or below the diagonal (warpgroup 0 one, warpgroup
//       1 two); while they run, the chunk's state contribution (x o w)^T B,
//       w = exp(cum_last - cum) dt, is issued with x o w an MN-major A
//       operand in shared memory and B an MN-major B operand (warpgroup w
//       owns the 64 state columns w);
//     - mask, exp(cum_i - cum_j) and dt_j applied to the scores in
//       registers, then y_diag = S x with the scores as the register A
//       operand and x read MN-major (attention's P V step);
//     - then the carry: wait for h_{c-1} (the initial state for c = 0), write
//       h_c = exp(cum_last) h_{c-1} + states_c over it, and copy it whole
//       into the next block's shared memory with one cp.async.bulk that
//       completes a transaction on that block's mbarrier (after the last
//       chunk, store it row by row as the final state);
//     - y_off = exp(cum_i) C h_{c-1}^T by wgmma, and y through shared memory
//       into row-wise stores.
//   A hop of the carry costs ~2 us (the copy ~1.1, the block's own work
//   ~0.95; tools/ssd_phases.py), so the chain of chunks sets the time once
//   S passes two chunks (PERF.md).
//   Precision: y is bf16, held at 2e-2; the final state is fp32, held at
//   2e-4, and every later decode step compounds it.  One bf16 rounding of
//   x o w misses the state's bound by over 12x, and one of the scores (not
//   normalised, unlike attention's P) or of h misses y's on a few elements
//   in a million (tools/ssd_precision.py, on the CPU emulation
//   ref.ssd_tc_emulated).  So each fp32 operand (the scores, x o w, h) is
//   split into bf16 hi + lo and multiplied twice into one fp32 accumulator
//   (error ~2^-16): 112 m64n64k16 products a 128-row chunk, ~2 us of one
//   SM's tensor cores.  No atomics: the result is the same bit for bit
//   from call to call.
// * ssd_scan, fp32 FMAs (SIMT): fp32 inputs, held to 2e-4, and the shapes
//   tc::ssd does not take.  The TPU kept h in a VMEM scratch across a
//   sequential grid axis; here one block owns a (batch, head, slice of P =
//   16 of the dh rows of h) and loops over the chunks itself, keeping its
//   slice of h in shared memory.  The rows of h are independent, so the
//   slices are exact, and the launch fills dh / 16 times more blocks
//   (mamba2-130m at batch 1: 24 heads x 4 slices = 96 blocks).  The K = dh
//   / 16 blocks of a head form a thread block cluster: each computes every
//   K-th row of the [Q, Q] scores and stores it into the shared memory of
//   all K, so a head's scores are computed once.  It runs every product as
//   fp32 FMAs from shared memory, the scores as (8 / K) x 8 register tiles
//   per thread over the full 128-row tile (the upper triangle is computed
//   and dropped), with one block of 8 warps per SM.
//   Shared memory per block (fp32): x slice [Q][16], h slice [ds][16],
//   B^T and C^T [ds][ldq], the scores [Q][ldq], cum, dt and the end decays
//   [Q]; ldq = Q + 1 or Q + 2 is odd, so walks down a column are free of
//   bank conflicts.  At Q = ds = 128 that is 216 KB, under the 227 KB a
//   block may opt into: one block per SM.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

typedef __nv_bfloat16 bf16;

enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr int THREADS = 256;
constexpr int P = 16;          // rows of h (of dh) one block owns
constexpr int MAX_Q = 128;
constexpr int MAX_DS = 128;
constexpr int SLACK = 128;     // floats past the end: the score tiles' guarded-off reads

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

struct SsdArgs {
  const void* x;        // [b, S, nh, dh] through (sxb, sxt), heads dh apart, dh contiguous
  const float* dt;      // [b, S, nh] contiguous
  const float* A;       // [nh]
  const void* B;        // [b, S, g, ds] through (sbb, sbt), groups ds apart
  const void* C;        // [b, S, g, ds] through (scb, sct)
  const float* h0;      // [b, nh, dh, ds] contiguous, or null (zeros)
  void* y;              // [b, S, nh, dh] contiguous, x's dtype
  float* hT;            // [b, nh, dh, ds] contiguous
  int S, nh, dh, g, ds, Q;
  long long sxb, sxt, sbb, sbt, scb, sct;
};

// Stage rows [t0, t0 + Qv) of an operand of `cols` elements a row (row
// stride st) into shared memory as fp32, element (i, n) at dst[n * sn + i * si];
// rows Qv..Q-1 are zeros.  The loads are 16-byte vectors (the wrapper keeps
// rows and their starts on 16 bytes), eight a thread issued before any
// store, so a chunk's loads are in flight together.  Consecutive threads
// take consecutive rows, which keeps the transposed stores (sn = ldq odd,
// si = 1) free of bank conflicts.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int sn, int si, const T* src, long long st,
                                      int t0, int Qv, int Q, int cols) {
  constexpr int V = sizeof(uint4) / sizeof(T);
  const int total = Q * (cols / V);
  for (int base = 0; base < total; base += 8 * THREADS) {
    uint4 buf[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int o = base + k * THREADS + threadIdx.x;
      const int i = o % Q, v = o / Q;
      buf[k] = (o < total && i < Qv)
                   ? *reinterpret_cast<const uint4*>(src + (long long)(t0 + i) * st + v * V)
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int o = base + k * THREADS + threadIdx.x;
      if (o >= total) break;
      const int i = o % Q, n0 = (o / Q) * V;
      const T* e = reinterpret_cast<const T*>(&buf[k]);
#pragma unroll
      for (int q = 0; q < V; ++q) dst[(n0 + q) * sn + i * si] = to_f(e[q]);
    }
  }
}

__host__ __device__ inline int odd_ld(int Q) { return Q + 1 + (Q & 1); }

__host__ inline size_t smem_bytes(int Q, int ds) {
  const int ldq = odd_ld(Q);
  return sizeof(float) * ((size_t)Q * P + (size_t)ds * P + 2 * (size_t)ds * ldq +
                          (size_t)Q * ldq + 3 * (size_t)Q + SLACK);
}

// R = 8 / K row tiles of 16 a thread, for a cluster of K = dh / 16 blocks
template <typename T, int R>
__global__ void __launch_bounds__(THREADS) ssd_scan(SsdArgs a) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [Q][P]
  const int Q = a.Q, ds = a.ds, S = a.S;
  const int ldq = odd_ld(Q);
  float* hs = xs + Q * P;                        // [ds][P]  h slice, transposed
  float* Bt = hs + ds * P;                       // [ds][ldq]
  float* Ct = Bt + ds * ldq;                     // [ds][ldq]
  float* Ss = Ct + ds * ldq;                     // [Q][ldq] scores o L, times dt_j
  float* cum = Ss + Q * ldq;                     // [Q]
  float* dts = cum + Q;                          // [Q]
  float* wdec = dts + Q;                         // [Q] exp(cum_last - cum_j) dt_j

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d0 = blockIdx.x * P, h = blockIdx.y, b = blockIdx.z;
  // the K blocks of a head form a cluster: block `rank` computes every K-th
  // row of the scores and stores it into the shared memory of all K
  constexpr int K = 8 / R;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  float* peers[K];
#pragma unroll
  for (int k = 0; k < K; ++k) peers[k] = cluster.map_shared_rank(Ss, k);
  const int grp = h / (a.nh / a.g);
  const float Ah = a.A[h];
  const T* xp = static_cast<const T*>(a.x) + b * a.sxb + (long long)h * a.dh + d0;
  const T* Bp = static_cast<const T*>(a.B) + b * a.sbb + (long long)grp * ds;
  const T* Cp = static_cast<const T*>(a.C) + b * a.scb + (long long)grp * ds;
  const float* dtp = a.dt + (long long)b * S * a.nh + h;
  T* yp = static_cast<T*>(a.y) + ((long long)b * S * a.nh + h) * a.dh + d0;
  const long long hoff = (((long long)b * a.nh + h) * a.dh + d0) * ds;

  // the carried state: global [p][n] (n contiguous) -> shared [n][p]
  for (int o = tid; o < ds * P; o += THREADS) {
    const int n = o % ds, p = o / ds;
    hs[n * P + p] = a.h0 ? a.h0[hoff + (long long)p * ds + n] : 0.f;
  }

  const int ty = tid >> 4, tx = tid & 15;        // score tile: rows ty + 16r, cols tx + 16c
  for (int t0 = 0; t0 < S; t0 += Q) {
    const int Qv = min(Q, S - t0);               // real positions in this chunk

    // dt and the inclusive cumsum of dt * A: warp 0, 4 positions a lane
    if (warp == 0) {
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = lane * 4 + k;
        const float d = i < Qv ? dtp[(long long)(t0 + i) * a.nh] : 0.f;
        if (i < Q) dts[i] = d;
        run += d * Ah;
        v[k] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += up;
      }
      const float excl = tot - run;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = lane * 4 + k;
        if (i < Q) cum[i] = v[k] + excl;
      }
    }
    // x slice, B and C of the chunk (B and C transposed); zeros past the end
    stage<T>(xs, 1, P, xp, a.sxt, t0, Qv, Q, P);
    stage<T>(Bt, ldq, 1, Bp, a.sbt, t0, Qv, Q, ds);
    stage<T>(Ct, ldq, 1, Cp, a.sct, t0, Qv, Q, ds);
    cluster.sync();                              // and every peer is done with its scores

    // scores: S[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j on j <= i, for
    // this block's rows i = K (ty + 16 r) + rank.  Rows and columns past Q
    // read past their row (into the next array or the slack) and are never
    // stored.
    for (int i = tid; i < Q; i += THREADS) wdec[i] = expf(cum[Q - 1] - cum[i]) * dts[i];
    {
      float acc[R][8];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll 2
      for (int n = 0; n < ds; ++n) {
        const float* cr = Ct + n * ldq + K * ty + rank;
        const float* br = Bt + n * ldq + tx;
        float cv[R], bv[8];
#pragma unroll
        for (int r = 0; r < R; ++r) cv[r] = cr[16 * K * r];
#pragma unroll
        for (int c = 0; c < 8; ++c) bv[c] = br[16 * c];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = K * (ty + 16 * r) + rank;
        if (i >= Q) continue;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = tx + 16 * c;
          if (j >= Q) continue;
          const float v = j <= i ? acc[r][c] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
#pragma unroll
          for (int k = 0; k < K; ++k) peers[k][i * ldq + j] = v;
        }
      }
    }
    cluster.sync();                              // every block holds all Q rows

    // y[i][p] = sum_{j<=i} S[i][j] x[j][p] + exp(cum_i) sum_n C[i][n] h[p][n]:
    // a thread owns one row and 8 of the P columns
    {
      const int i = tid & (MAX_Q - 1), p0 = (tid >> 7) * 8;
      if (i < Qv) {
        float yv[8], off[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) yv[k] = off[k] = 0.f;
        const float* srow = Ss + i * ldq;
#pragma unroll 4
        for (int j = 0; j <= i; ++j) {
          const float s = srow[j];
          const float4 xa = *reinterpret_cast<const float4*>(xs + j * P + p0);
          const float4 xb = *reinterpret_cast<const float4*>(xs + j * P + p0 + 4);
          yv[0] = fmaf(s, xa.x, yv[0]); yv[1] = fmaf(s, xa.y, yv[1]);
          yv[2] = fmaf(s, xa.z, yv[2]); yv[3] = fmaf(s, xa.w, yv[3]);
          yv[4] = fmaf(s, xb.x, yv[4]); yv[5] = fmaf(s, xb.y, yv[5]);
          yv[6] = fmaf(s, xb.z, yv[6]); yv[7] = fmaf(s, xb.w, yv[7]);
        }
#pragma unroll 4
        for (int n = 0; n < ds; ++n) {
          const float cv = Ct[n * ldq + i];
          const float4 ha = *reinterpret_cast<const float4*>(hs + n * P + p0);
          const float4 hb = *reinterpret_cast<const float4*>(hs + n * P + p0 + 4);
          off[0] = fmaf(cv, ha.x, off[0]); off[1] = fmaf(cv, ha.y, off[1]);
          off[2] = fmaf(cv, ha.z, off[2]); off[3] = fmaf(cv, ha.w, off[3]);
          off[4] = fmaf(cv, hb.x, off[4]); off[5] = fmaf(cv, hb.y, off[5]);
          off[6] = fmaf(cv, hb.z, off[6]); off[7] = fmaf(cv, hb.w, off[7]);
        }
        const float e = expf(cum[i]);
        T* yrow = yp + (long long)(t0 + i) * a.nh * a.dh + p0;
#pragma unroll
        for (int k = 0; k < 8; ++k) yrow[k] = from_f<T>(yv[k] + e * off[k]);
      }
    }
    __syncthreads();                             // y read h; the update overwrites it

    // h[p][n] <- h[p][n] exp(cum_last) + sum_j x[j][p] wdec_j B[j][n]:
    // a thread owns one n and 8 of the P rows
    {
      const float decay = expf(cum[Q - 1]);
      for (int o = tid; o < 2 * ds; o += THREADS) {
        const int n = o % ds, p0 = (o / ds) * 8;
        float hv[8];
        float4* hrow = reinterpret_cast<float4*>(hs + n * P + p0);
        const float4 ha = hrow[0], hb = hrow[1];
        hv[0] = ha.x * decay; hv[1] = ha.y * decay; hv[2] = ha.z * decay; hv[3] = ha.w * decay;
        hv[4] = hb.x * decay; hv[5] = hb.y * decay; hv[6] = hb.z * decay; hv[7] = hb.w * decay;
        const float* brow = Bt + n * ldq;
#pragma unroll 4
        for (int j = 0; j < Qv; ++j) {
          const float w = brow[j] * wdec[j];
          const float4 xa = *reinterpret_cast<const float4*>(xs + j * P + p0);
          const float4 xb = *reinterpret_cast<const float4*>(xs + j * P + p0 + 4);
          hv[0] = fmaf(xa.x, w, hv[0]); hv[1] = fmaf(xa.y, w, hv[1]);
          hv[2] = fmaf(xa.z, w, hv[2]); hv[3] = fmaf(xa.w, w, hv[3]);
          hv[4] = fmaf(xb.x, w, hv[4]); hv[5] = fmaf(xb.y, w, hv[5]);
          hv[6] = fmaf(xb.z, w, hv[6]); hv[7] = fmaf(xb.w, w, hv[7]);
        }
        hrow[0] = make_float4(hv[0], hv[1], hv[2], hv[3]);
        hrow[1] = make_float4(hv[4], hv[5], hv[6], hv[7]);
      }
    }
    __syncthreads();
  }

  for (int o = tid; o < ds * P; o += THREADS) {
    const int n = o % ds, p = o / ds;
    a.hT[hoff + (long long)p * ds + n] = hs[n * P + p];
  }
}

template <typename T, int R>
static int launch(const SsdArgs& a, int batch, cudaStream_t st) {
  static bool opted = false;                     // once, before any graph capture
  if (!opted) {
    cudaError_t e = cudaFuncSetAttribute(ssd_scan<T, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(MAX_Q, MAX_DS));
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.dh / P, a.nh, batch);     // a cluster of dh / 16 blocks per head
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(a.Q, a.ds);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.dh / P;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, ssd_scan<T, R>, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T>
static int launch_k(const SsdArgs& a, int batch, cudaStream_t st) {
  switch (a.dh / P) {
    case 1: return launch<T, 8>(a, batch, st);
    case 2: return launch<T, 4>(a, batch, st);
    case 4: return launch<T, 2>(a, batch, st);
    default: return launch<T, 1>(a, batch, st);   // dh = 128
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: one block per chunk, the chunks of a head a
// cluster, the state carried through distributed shared memory
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int DH = 64;            // rows of h (mamba2's head dim)
constexpr int DS = 128;           // columns of h (mamba2's state dim)
constexpr int THREADS = 256;      // two warpgroups
constexpr int MAX_CLUSTER = 8;    // chunks of a head in flight at once (the portable cluster)
constexpr int HLD = DS + 8;       // fp32 row stride of the received state: float2 accesses of
                                  // a half-warp (4 rows x 4 column pairs) hit 32 distinct banks

struct Args {
  const float* dt;  // [b, S, nh] contiguous
  const float* A;   // [nh]
  const float* h0;  // [b, nh, DH, DS] contiguous, or null (zeros)
  bf16* y;          // [b, S, nh, DH] contiguous
  float* hT;        // [b, nh, DH, DS] contiguous
  int S, nh, g, Q, nchunks;
};

// Byte offsets in shared memory (from a 1024-aligned base) for chunks of QT rows.  The bf16
// tiles are 128-byte rows in the 128-byte swizzle, a 64-column half of ds after the other.
template <int QT>
struct Smem {
  static constexpr int X = 0;                      // x [QT][64]
  static constexpr int B = X + QT * 128;           // B [2][QT][64]
  static constexpr int C = B + 2 * QT * 128;       // C [2][QT][64]
  static constexpr int XWH = C + 2 * QT * 128;     // x o w, hi and lo [QT][64]
  static constexpr int XWL = XWH + QT * 128;
  static constexpr int HH = XWL + QT * 128;        // h_{c-1}, hi and lo [2][64 rows][64]
  static constexpr int HL = HH + 2 * DH * 128;
  static constexpr int RECV = HL + 2 * DH * 128;   // h_{c-1} received, then h_c: fp32 [DH][HLD]
  static constexpr int VEC = RECV + DH * HLD * 4;  // cum, exp(cum), w, dt: fp32 [4][128]
  static constexpr int BAR = VEC + 4 * 128 * 4;    // the load's and the carry's mbarriers
  static constexpr int BYTES = 1024 + BAR + 16;    // with the alignment slack
};

// (a, b) as bf16 hi + lo pairs: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the shared::cluster address of a local shared address in block `rank` of the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// bytes of this block's shared memory into a peer's (dst and bar from mapa) by the copy
// engine; they complete a transaction on the peer's mbarrier
__device__ __forceinline__ void copy_to_peer(uint32_t dst, const void* src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst), "r"(saddr(src)), "r"(bytes), "r"(bar) : "memory");
}
// wait for the phase of the given parity at cluster scope (the bytes of a peer's copy);
// traps after SPIN_CYCLES, as bar_wait does
__device__ __forceinline__ void wait_cluster(uint64_t* b, int parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(saddr(b)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > SPIN_CYCLES) __trap();
  }
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void proxy_fence() {  // generic-proxy writes visible to wgmma, TMA
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(saddr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// 2^x, about 2 ulp: the decays of the scores, which reach y (held at 2e-2) only
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float LOG2E = 1.4426950408889634f;

// One warpgroup's part of a chunk before the carry: its NT score tiles (the 64 rows of
// warpgroup NT - 1 against column tiles 0 .. NT - 1, those at or below the diagonal; NT = 0: no
// rows) are issued first; `middle` (x o w and the state products, which both warpgroups share)
// runs while they compute; then S[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j on j <= i
// (columns past the chunk have dt 0), split into bf16 hi + lo register operands, and
// y_diag = S x into acc.  Returns with every product done.
template <int QT, int NT, typename Middle>
__device__ __forceinline__ void diag(float (&acc)[32], uint32_t cs, uint32_t bs, uint32_t xs,
                                     const float* cum, const float* dts, int ra, int cb,
                                     Middle&& middle) {
  constexpr int HALF = QT * 128;  // bytes of one 64-column half of B or C
  constexpr int R0 = 64 * (NT > 0 ? NT - 1 : 0);
  float sc[NT > 0 ? NT : 1][32];
  if constexpr (NT > 0) {
#pragma unroll
    for (int t = 0; t < NT; ++t) zero(sc[t]);
    wg_fence();
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int k = 0; k < DS / 16; ++k) {
        const uint32_t off = (k / 4) * HALF + (k % 4) * 32;
        wgmma_ss_n64(sc[t], desc(cs + off + R0 * 128, 16), desc(bs + off + t * 64 * 128, 16),
                     1);
      }
    wg_commit();
  }
  middle();  // commits one more group: the state products
  if constexpr (NT > 0) {
    wg_wait<1>();  // the scores (the older group) are done
#pragma unroll
    for (int t = 0; t < NT; ++t) keep(sc[t]);
    const float ci[2] = {cum[R0 + ra], cum[R0 + ra + 8]};
    uint32_t fh[NT][16], fl[NT][16];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int j0 = 64 * t + 8 * i + cb;
        const float cj[2] = {cum[j0], cum[j0 + 1]}, dj[2] = {dts[j0], dts[j0 + 1]};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = R0 + ra + 8 * h;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = j0 + e <= row ? sc[t][4 * i + 2 * h + e] * ex2((ci[h] - cj[e]) * LOG2E) * dj[e]
                                 : 0.f;
          split2(v[0], v[1], fh[t][2 * i + h], fl[t][2 * i + h]);
        }
      }
    wg_fence();
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dx = desc(xs + (64 * t + 16 * kk) * 128, QT * 128);
        wgmma_rs_n64(acc, &fh[t][4 * kk], dx);
        wgmma_rs_n64(acc, &fl[t][4 * kk], dx);
      }
    wg_commit();
    wg_wait<0>();
    keep(acc);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      keep(fh[t]);
      keep(fl[t]);
    }
  } else {
    wg_wait<0>();
  }
}

// One block per (chunk slot of the cluster, head, batch); the K = gridDim.x blocks of a head
// form a cluster and block r takes chunks r, r + K, ... in rounds.  Warpgroup w: rows 64w ..
// 64w + 63 of the chunk (when QT > 64w) and state columns 64w .. 64w + 63.
template <int QT>
__global__ void __launch_bounds__(THREADS, 1)
ssd(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap bmap,
    const __grid_constant__ CUtensorMap cmap, Args a) {
  using L = Smem<QT>;
  constexpr int HALF = QT * 128;
  constexpr int STATE_BYTES = DH * HLD * 4;  // h as the carry moves it, row padding included
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1k(smem_raw);
  float* recv = reinterpret_cast<float*>(base + L::RECV);
  float* cum = reinterpret_cast<float*>(base + L::VEC);
  float* ecum = cum + 128;  // exp(cum_i)
  float* wdec = ecum + 128;  // exp(cum_last - cum_j) dt_j
  float* dts = wdec + 128;
  uint64_t* load_bar = reinterpret_cast<uint64_t*>(base + L::BAR);
  uint64_t* recv_bar = load_bar + 1;

  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int K = gridDim.x, rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (a.nh / a.g);
  const float Ah = a.A[h];
  const float* dtp = a.dt + (long long)b * a.S * a.nh + h;
  const long long hoff = ((long long)b * a.nh + h) * DH * DS;
  // this thread's accumulator elements q = 4i + 2hh + e of an m64n64 tile: row ra + 8hh,
  // column 8i + cb + e; as a state element, h[p = ra + 8hh][n = 64wg + 8i + cb + e]
  const int ra = 16 * ((tid >> 5) & 3) + (lane >> 2), cb = 2 * (lane & 3);
  const uint32_t xs = saddr(base + L::X), bs = saddr(base + L::B), cs = saddr(base + L::C);
  const uint32_t next = rank + 1 < K ? rank + 1 : 0;
  const uint32_t recv_next = mapa(saddr(recv), next), bar_next = mapa(saddr(recv_bar), next);

  if (tid == 0) {
    bar_init(load_bar, 1);
    bar_init(recv_bar, 1);  // this block's expect_tx; the bytes come from the previous chunk
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the cluster's barriers exist before any remote arrival (the fence above orders their
  // init): arrive now, wait before the carry
  cluster_arrive();
  __syncthreads();

  int nrecv = 0;
  for (int c = rank, round = 0; c < a.nchunks; c += K, ++round) {
    const int t0 = c * a.Q, Qv = min(a.Q, a.S - t0);
    if (round > 0) {  // the last round's products and reads of the tiles are done
      proxy_fence();
      __syncthreads();
    }
    if (tid == 0) {
      bar_expect(load_bar, 5 * HALF);
      tma_load(base + L::X, &xmap, load_bar, 0, t0, h, b);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        tma_load(base + L::B + hf * HALF, &bmap, load_bar, 64 * hf, t0, grp, b);
        tma_load(base + L::C + hf * HALF, &cmap, load_bar, 64 * hf, t0, grp, b);
      }
      if (c > 0) bar_expect(recv_bar, STATE_BYTES);  // h_{c-1}, sent by the previous chunk
    }
    if (c == 0 && a.h0 != nullptr) {  // the initial state into recv, each thread its elements
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = ra + 8 * hh, n = 64 * wg + 8 * i + cb;
          cp_async8(recv + p * HLD + n, a.h0 + hoff + p * DS + n);
        }
    }
    // dt, the inclusive cumsum of dt * A and the per-position factors: warp 4, 4 positions a
    // lane (positions past the chunk have dt = 0, so cum[127] is cum_last)
    if (tid >= 128 && tid < 160) {
      float v[4], run = 0.f, d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = lane * 4 + k;
        d[k] = i < Qv ? dtp[(long long)(t0 + i) * a.nh] : 0.f;
        run += d[k] * Ah;
        v[k] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += up;
      }
      const float excl = tot - run;
      const float last = __shfl_sync(0xffffffffu, tot, 31);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = lane * 4 + k;
        const float ck = v[k] + excl;
        cum[i] = ck;
        ecum[i] = expf(ck);
        wdec[i] = expf(last - ck) * d[k];
        dts[i] = d[k];
      }
    }
    __syncthreads();
    bar_wait(load_bar, round & 1);

    // the chunk's own part of y, and meanwhile its state contribution, columns 64wg ..:
    // (x o w)^T B over the chunk's rows, x o w as bf16 hi + lo in x's swizzled layout (a
    // 16-byte slot s holds row s / 8)
    float acc[32], st[32];
    zero(acc);
    zero(st);
    auto middle = [&]() {
      for (int s = tid; s < QT * 8; s += THREADS) {
        const uint4 v = *reinterpret_cast<const uint4*>(base + L::X + s * 16);
        const float w = wdec[s >> 3];
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&v);
        uint4 hi, lo;
        uint32_t* ph = reinterpret_cast<uint32_t*>(&hi);
        uint32_t* pl = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = __bfloat1622float2(p2[q]);
          split2(f.x * w, f.y * w, ph[q], pl[q]);
        }
        *reinterpret_cast<uint4*>(base + L::XWH + s * 16) = hi;
        *reinterpret_cast<uint4*>(base + L::XWL + s * 16) = lo;
      }
      proxy_fence();
      __syncthreads();
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        const uint64_t db = desc(bs + wg * HALF + kk * 2048, HALF);
        wgmma_ss_n64<1, 1>(st, desc(saddr(base + L::XWH) + kk * 2048, HALF), db, 1);
        wgmma_ss_n64<1, 1>(st, desc(saddr(base + L::XWL) + kk * 2048, HALF), db, 1);
      }
      wg_commit();
    };
    if (wg == 0)
      diag<QT, 1>(acc, cs, bs, xs, cum, dts, ra, cb, middle);
    else
      diag<QT, QT / 32 - 2>(acc, cs, bs, xs, cum, dts, ra, cb, middle);  // 0 or 2 tiles
    keep(st);

    // the carry: h_c = exp(cum_last) h_{c-1} + states_c, each thread over the elements of
    // h_{c-1} it read, then copied whole into the next chunk's block (or, after the last
    // chunk, stored row by row as the final state); h_{c-1} as bf16 hi + lo for y_off
    if (round == 0) cluster_wait();
    const bool last_chunk = c == a.nchunks - 1;
    const float decay = expf(cum[127]);
    float hp[32];
    if (c > 0 || a.h0 != nullptr) {
      if (c > 0)
        wait_cluster(recv_bar, nrecv++ & 1);
      else
        cp_async_wait();
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = ra + 8 * hh, n = 64 * wg + 8 * i + cb;
          const float2 v = *reinterpret_cast<const float2*>(recv + p * HLD + n);
          hp[4 * i + 2 * hh] = v.x;
          hp[4 * i + 2 * hh + 1] = v.y;
        }
    } else {
      zero(hp);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = 4 * i + 2 * hh, p = ra + 8 * hh, n = 64 * wg + 8 * i + cb;
        const float v0 = fmaf(decay, hp[q], st[q]), v1 = fmaf(decay, hp[q + 1], st[q + 1]);
        *reinterpret_cast<float2*>(recv + p * HLD + n) = make_float2(v0, v1);
      }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = 4 * i + 2 * hh, p = ra + 8 * hh, col = 8 * i + cb;
        // h's row p, columns 64wg + col, in the swizzled [2][64][64] layout
        const int off = wg * DH * 128 + p * 128 + ((((col >> 3) ^ (p & 7))) << 4) + 2 * (col & 7);
        uint32_t hi, lo;
        split2(hp[q], hp[q + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(base + L::HH + off) = hi;
        *reinterpret_cast<uint32_t*>(base + L::HL + off) = lo;
      }
    proxy_fence();
    __syncthreads();
    // a later message into recv follows this copy's arrival along the chain, so its reads of
    // recv are done by then
    if (!last_chunk && tid == 0) copy_to_peer(recv_next, recv, STATE_BYTES, bar_next);
    if (last_chunk)
      for (int o = tid; o < DH * DS / 4; o += THREADS) {
        const int p = o / (DS / 4), n = 4 * (o % (DS / 4));
        *reinterpret_cast<float4*>(a.hT + hoff + p * DS + n) =
            *reinterpret_cast<const float4*>(recv + p * HLD + n);
      }

    // y = y_diag + exp(cum_i) C_i . h_{c-1}^T, rows of the chunk only
    if (64 * wg < QT) {
      float off[32];
      zero(off);
      wg_fence();
#pragma unroll
      for (int k = 0; k < DS / 16; ++k) {
        const uint64_t da = desc(cs + (k / 4) * HALF + wg * 64 * 128 + (k % 4) * 32, 16);
        const uint32_t hk = (k / 4) * DH * 128 + (k % 4) * 32;
        wgmma_ss_n64(off, da, desc(saddr(base + L::HH) + hk, 16), 1);
        wgmma_ss_n64(off, da, desc(saddr(base + L::HL) + hk, 16), 1);
      }
      wg_commit();
      wg_wait<0>();
      keep(off);
      // the warpgroup's 64 rows of y through shared memory (x o w's tile, free by now; 128-byte
      // rows, swizzled so the pair stores are free of bank conflicts), then row by row
      uint8_t* ys = base + L::XWH;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 64 * wg + ra + 8 * hh;
        const float e = ecum[r];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(ys + r * 128 + ((j ^ (r & 7)) << 4) + 2 * cb) =
              __floats2bfloat162_rn(fmaf(e, off[4 * j + 2 * hh], acc[4 * j + 2 * hh]),
                                    fmaf(e, off[4 * j + 2 * hh + 1], acc[4 * j + 2 * hh + 1]));
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup's rows
      for (int o = tid & 127; o < 64 * 8; o += 128) {
        const int r = 64 * wg + (o >> 3), ch = o & 7;
        if (r < Qv)
          *reinterpret_cast<uint4*>(a.y + (((long long)b * a.S + t0 + r) * a.nh + h) * DH +
                                    8 * ch) =
              *reinterpret_cast<const uint4*>(ys + r * 128 + ((ch ^ (r & 7)) << 4));
      }
    }
  }
  // no block leaves while a peer may still write into its shared memory
  cluster_arrive();
  cluster_wait();
}

template <int QT>
static int launch(const void* x, const void* B, const void* C, const Args& a, int batch,
                  long long sxb, long long sxt, long long sbb, long long sbt, long long scb,
                  long long sct, cudaStream_t stream) {
  CUtensorMap xm, bm, cm;
  if (!tensor_map(&xm, x, DH, a.S, a.nh, batch, sxb, DH, sxt, QT) ||
      !tensor_map(&bm, B, DS, a.S, a.g, batch, sbb, DS, sbt, QT) ||
      !tensor_map(&cm, C, DS, a.S, a.g, batch, scb, DS, sct, QT))
    return (int)cudaErrorInvalidValue;
  static bool opted = false;  // once, before any graph capture
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(ssd<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Smem<QT>::BYTES);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  const int K = a.nchunks < MAX_CLUSTER ? a.nchunks : MAX_CLUSTER;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K, a.nh, batch);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Smem<QT>::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = K;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, ssd<QT>, xm, bm, cm, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace tc

extern "C" {

// x, B, C in the compute dtype (fp32 or bf16) through their (batch,
// position) element strides; dt [b,S,nh], A [nh], h0 and hT [b,nh,dh,ds]
// fp32 and contiguous (h0 may be null); y [b,S,nh,dh] contiguous.
// 1 <= Q <= 128, ds a multiple of 8 up to 128, dh 16, 32, 64 or 128, nh
// a multiple of g; x, B and C, and every row they start, lie on 16 bytes.
// Returns a cudaError_t.
int hk_ssd(const void* x, const void* dt, const void* A, const void* B, const void* C,
           const void* h0, void* y, void* hT, int batch, int S, int nh, int dh, int g,
           int ds, int Q, long long sxb, long long sxt, long long sbb, long long sbt,
           long long scb, long long sct, int dtype, void* stream) {
  if (Q < 1 || Q > MAX_Q || ds < 8 || ds > MAX_DS || ds % 8 || g < 1 || nh % g ||
      (dh != 16 && dh != 32 && dh != 64 && dh != 128))
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || S <= 0 || nh <= 0) return 0;
  SsdArgs a{x, static_cast<const float*>(dt), static_cast<const float*>(A), B, C,
            static_cast<const float*>(h0), y, static_cast<float*>(hT),
            S, nh, dh, g, ds, Q, sxb, sxt, sbb, sbt, scb, sct};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == DT_BF16 ? launch_k<bf16>(a, batch, st) : launch_k<float>(a, batch, st);
}

// The bf16 tensor-core route: x, B, C bf16 as for hk_ssd; dh 64, ds 128, 1 <= Q <= 128,
// nh a multiple of g; every stride but the last dims' on 16 bytes (the TMA maps).  Returns a
// cudaError_t (cudaErrorInvalidValue for a shape it does not take or a layout TMA refuses).
int hk_ssd_tc(const void* x, const void* dt, const void* A, const void* B, const void* C,
              const void* h0, void* y, void* hT, int batch, int S, int nh, int dh, int g,
              int ds, int Q, long long sxb, long long sxt, long long sbb, long long sbt,
              long long scb, long long sct, void* stream) {
  if (Q < 1 || Q > MAX_Q || dh != tc::DH || ds != tc::DS || g < 1 || nh % g)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || S <= 0 || nh <= 0) return 0;
  const tc::Args a{static_cast<const float*>(dt), static_cast<const float*>(A),
                   static_cast<const float*>(h0), static_cast<bf16*>(y), static_cast<float*>(hT),
                   S, nh, g, Q, (S + Q - 1) / Q};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return Q <= 64 ? tc::launch<64>(x, B, C, a, batch, sxb, sxt, sbb, sbt, scb, sct, st)
                 : tc::launch<128>(x, B, C, a, batch, sxb, sxt, sbb, sbt, scb, sct, st);
}

const char* hk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
