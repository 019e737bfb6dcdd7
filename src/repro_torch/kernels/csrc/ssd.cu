// Hand-written Hopper (sm_90a) Mamba2 SSD chunked-scan kernel of the port.
//
// Replaces the TPU kernel repro/kernels/ssd.py::ssd (pallas_call at
// ssd.py:88, body _ssd_kernel:26), the prefill scan of every mamba layer.
// Per (batch, head) the chunks of Q positions run in order with an fp32
// state h [dh, ds] carried between them.  With cum the inclusive cumsum of
// dA = dt * A inside the chunk (A < 0, so cum falls):
//     L[i][j]  = exp(cum_i - cum_j) for j <= i, else 0
//     y        = (C B^T o L)(x dt) + exp(cum) (C h^T)
//     h       <- h exp(cum_last) + (x o exp(cum_last - cum) dt)^T B
// It also takes the optional fp32 initial state and writes the fp32 final
// state, which the model's ssd_chunked returns and the serving pool keeps.
// The output y is in x's dtype, without the D skip; every sum is fp32.
//
// What differs from the Pallas kernel:
//  * The TPU kept h in a VMEM scratch across a sequential grid axis.  Here
//    one block owns a (batch, head, slice of P = 16 of the dh rows of h) and
//    loops over the chunks itself, keeping its slice of h in shared memory.
//    The rows of h are independent, so the slices are exact, and the launch
//    fills dh / 16 times more blocks (mamba2-130m at batch 1: 24 heads x 4
//    slices = 96 blocks).  The K = dh / 16 blocks of a head form a thread
//    block cluster: each computes every K-th row of the [Q, Q] scores and
//    stores it into the shared memory of all K, so a head's scores are
//    computed once.
//  * Ragged length: S need not be a multiple of Q.  Positions >= S read as
//    dt = 0 and x = B = C = 0 (decay 1, no input) without touching memory
//    past the end, so the final state is the state after the last token.
//  * Overflow: cum reaches -300 and below inside one chunk at mamba2's
//    A = -(1..24), so exp(cum_i) * exp(-cum_j) would overflow; the kernel
//    forms cum_i - cum_j first, on the lower triangle only (every exponent
//    is <= 0), as _segsum does.
//  * Groups: B and C are read at group head / (nh / g) in place (no repeat),
//    and x, B, C are read through (batch, position) strides, so the model
//    hands over its slices of the conv output without a copy.
//
// Bound on an H100 SXM, mamba2-130m prefill of 512 tokens at batch 1, per
// layer: it moves about 5 MB (x and y 1.6 MB each in bf16, B and C, dt,
// the fp32 states in and out) and needs 0.71 GFLOP (the lower triangles of
// C B^T and of the scores times x, C h^T and the state update, per chunk
// and head): 1.5 us by bytes in bf16 (0.7 us at the bf16 tensor-core
// rate), 10.6 us by operations on the fp32 units in fp32.  This first
// kernel runs every product as fp32 SIMT FMAs from shared memory, the
// scores as (8 / K) x 8 register tiles per thread over the full 128-row
// tile (a chunk shorter than 128 does the same score work, and the upper
// triangle is computed and dropped).  With one block of 8 warps per SM
// its loops wait on shared-memory loads, and it runs far above its bound
// (PERF.md has its times); tensor-core scores on bf16 B and C and more
// warps per SM are later work.
//
// Shared memory per block (fp32): x slice [Q][16], h slice [ds][16],
// B^T and C^T [ds][ldq], the scores [Q][ldq], cum, dt and the end decays
// [Q]; ldq = Q + 1 or Q + 2 is odd, so walks down a column are free of
// bank conflicts.  At Q = ds = 128 that is 216 KB, under the 227 KB a
// block may opt into: one block per SM.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

const char* hk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
