// Hand-written Hopper (sm_90a) flash-attention kernels of the port:
// the forward, and the backward that training needs.
//
// The forward replaces the TPU kernel
// repro/kernels/flash_attention.py::flash_attention (pallas_call at
// flash_attention.py:84, body _flash_kernel:25): online-softmax attention
// with running max, denominator and accumulator in fp32, GQA without
// repeating K/V (q-head h reads kv-head h // g), and KV tiles that are
// fully masked skipped.  The mask is the one the model path uses
// (models/attention.py::_sdpa), not the Pallas kernel's top-left one: key
// kpos is visible to query qpos of batch row b when
//     kpos <= q_off[b] + qpos   (causal)   and   kpos < kv_len[b].
// Prefill passes q_off = the slot's length before the prompt; decode
// passes q_off = length and kv_len = length + 1, which is the grouped
// decode mask of _sdpa_grouped_decode.  Masked scores are -1e30 as in
// attention.py:21, so a row with no visible key (kv_len[b] = 0: key 0 is
// causally visible to every query, so this is the only way a row empties)
// gets the uniform average of v over all Sk keys, as _sdpa's softmax gives
// it.  On request the forward also writes each row's log-sum-exp
// (fp32 [B, nh, Sq]) for the backward.
//
// The backward has no Pallas counterpart (the JAX package differentiates
// _sdpa with XLA); it is FA2's: D = rowsum(dO * O), then per KV tile
// P = exp(s * scale - LSE) is recomputed from the saved LSE, and
// dV += P^T dO, dS = P * (dO V^T - D), dK += dS^T Q * scale,
// dQ += dS K * scale.  Its contract is the training mask: causal or not,
// q_off 0, no kv_len, Sq == Sk.  It is deterministic: one kernel owns a
// KV tile and loops over every query row that sees it (all g q-heads of
// the kv-head, so the GQA sum needs no atomics), and a second kernel owns
// a row tile and loops over its KV tiles for dQ.
//
// Layout: q [B, nh, Sq, dk], k [B, nkv, Sk, dk], v [B, nkv, Sk, dv], o and
// dO [B, nh, Sq, dv], the gradients like their inputs, each given by
// element strides (batch, head, position) with the head dim contiguous, so
// the model hands over its [B, S, heads, d] tensors without a transpose.
// The SIMT kernels take dk = dv = 64 or 128; the tensor-core ones (dk, dv)
// = (64, 64), (128, 128) or MLA's (96, 64) (q and k at dn + dr = 64 + 32,
// v at 64), which runs natively: no column of its products is padding.
//
// Bound on an H100 SXM: decode (Sq = 1) reads each slot's K/V once,
// kv_len * nkv * dh * 2 tensors * 2 bytes per layer, and is byte bound;
// prefill at a 512-token prompt does 4 * pairs * nh * dh operations (the
// visible (query, key) pairs) and the backward 10 * pairs * nh * dh (the two
// score products again, and dV, dK, dQ).  At the training case (B 4,
// 16/8 heads, dh 128, S 512) the bytes bound both: 7.5 and 15 us at
// 3.35 TB/s against 4.3 and 10.9 us of operations at 989 TFLOP/s.
//
// Two paths.  The wrapper (kernels/flash_attention.py, forward_impl and
// backward_impl) picks one from the shapes:
//
// * bf16 on the tensor cores (namespace tc: the forward when the Sq * g
//   rows of a (batch, kv-head) fill at least one 64-row tile, and every
//   bf16 backward).  One consumer warpgroup runs wgmma (m64, bf16 in, fp32
//   accumulators in registers) and one producer warp keeps TMA copies of
//   64-key K/V tiles in flight into a ring of two shared-memory stages
//   (mbarriers for full and empty), 128-byte swizzled as the wgmma
//   descriptors read them.  Forward: one block per (64 rows, kv-head,
//   batch), rows as above so the g q-heads of a kv-head share each K/V
//   tile, Q gathered through the strides into shared memory once (g need
//   not divide the tile).  S = Q K^T from shared memory; the online
//   softmax in fp32 registers, in log2 units, a row's max reduced across
//   the 4 threads that hold it; P rounded to bf16 in registers and fed as
//   the register A operand of O += P V, V read as an MN-major B operand;
//   the mask only on tiles that straddle a limit, tiles past it skipped.
//   A d-wide operand is laid down in ceil(d / 64) halves of 64 columns
//   (128-byte rows): at dk 96 the second half holds columns 64..95, TMA
//   fills the rest of its box with zeros (the map's inner extent is 96, so
//   no global byte is read for them), and the products run over the 96
//   columns only: S = Q K^T in dk / 16 = 6 k-steps, O += P V at N = dv = 64,
//   dQ += dS K and dK += dS^T Q at N = 96 (m64n96k16; the MN-major B reads
//   its second half's first 32 columns).  Keeping 128-byte halves costs the
//   shared memory of 32 unused columns (66.6 KB a forward block, two still
//   fit an SM) and keeps one swizzle, one descriptor form and one TMA box.
//   Backward: flash_bwd_dot for D, then a dK/dV kernel (one block per 64
//   keys, K and V held in shared memory, the producer streaming 32-row
//   tiles of Q and dO of every q-head of the group from the causal start:
//   S^T = K Q^T, dP^T = V dO^T, dV += P^T dO and dK += dS^T Q with P^T and
//   dS^T as register A operands) and a dQ kernel (the forward's blocks:
//   S, dP = dO V^T, dQ += dS K).  Each block owns its outputs, so the
//   backward has no atomics and is deterministic.
// * fp32 FMAs (the SIMT kernels below): fp32 inputs, held to 2e-4, which a
//   bf16 or TF32 product cannot meet; and the decode and short-prefill
//   forward, byte bound, whose few rows (4 slots x 2) would fill 8 of a
//   wgmma's 64 and which keeps the flash-decoding key split.  One block per
//   (batch, kv-head, tile of 16 rows); K/V tiles of 32 keys staged in shared
//   memory as fp32 with 16-byte loads, 8 threads own a row and reduce its
//   max and sum with warp shuffles.  When that grid is too small to fill
//   the card (decode: batch x kv-heads blocks), the keys are also split
//   over blocks and a second kernel merges the partial softmax states.
//   Their backward is the same FA2 split as the tensor cores' (a dK/dV and
//   a dQ kernel), on 16-row and 32-key tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

enum { DT_F32 = 0, DT_BF16 = 1 };

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 16, BK = 32, THREADS = 128, TPR = THREADS / BQ;  // threads per row

// 16-byte vector loads (every stride but dh's is a multiple of the vector)
__device__ __forceinline__ void load_vec(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load_vec(const bf16* p, float* o) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// Keys are split over ``nsplit`` blocks of ``chunk`` keys (a multiple of BK)
// when the (batch, kv-head, row-tile) grid alone is too small to fill the
// card, as in decode.  With nsplit > 1 a block writes its unnormalised
// accumulator, running max and denominator to ``part`` and flash_combine
// merges them; with nsplit == 1 it writes the output directly.
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, const int* __restrict__ q_off, const int* __restrict__ kv_len,
          int nh, int nkv, int Sq, int Sk, Strides st, int causal, float scale,
          int nsplit, int chunk, float* __restrict__ part, float* __restrict__ lse) {
  constexpr int DPT = DH / TPR, KPT = BK / TPR, VEC = 16 / sizeof(T);
  __shared__ float Qs[BQ][DH + 4];
  __shared__ float Ks[BK][DH + 1];
  __shared__ float Vs[BK][DH];
  __shared__ float Ps[BQ][BK + 1];

  const int tid = threadIdx.x, row = tid / TPR, sub = tid % TPR;
  const int split = blockIdx.x % nsplit, b = blockIdx.z, kvh = blockIdx.y, g = nh / nkv;
  const int rows_total = Sq * g, R0 = (blockIdx.x / nsplit) * BQ, R = R0 + row;
  const int qi = R / g, h = kvh * g + R % g;
  const int qoff = q_off != nullptr ? q_off[b] : 0;
  const int klen = kv_len != nullptr ? min(kv_len[b], Sk) : Sk;
  const int qpos = qoff + qi;
  // kv_len 0 empties every row of the block: all Sk keys then count, with
  // equal scores, which is the uniform average _sdpa's -1e30 fill gives
  const bool empty = klen <= 0;
  // KV tiles past both limits of the tile's last row are skipped
  int kend = empty ? Sk : klen;
  if (causal && !empty) kend = min(kend, qoff + min(Sq - 1, (R0 + BQ - 1) / g) + 1);
  const int kbeg = split * chunk;
  kend = min(kend, kbeg + chunk);

  for (int i = tid; i < BQ * DH / VEC; i += THREADS) {
    const int r = i / (DH / VEC), d = (i % (DH / VEC)) * VEC, Rr = R0 + r;
    float val[VEC] = {};
    if (Rr < rows_total)
      load_vec(q + b * st.qb + (kvh * g + Rr % g) * st.qh + (Rr / g) * st.qs + d, val);
#pragma unroll
    for (int e = 0; e < VEC; ++e) Qs[r][d + e] = val[e];
  }

  float m_i = NEG_INF, l_i = 0.f, acc[DPT];
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) acc[dd] = 0.f;

  const T* kbase = k + b * st.kb + kvh * st.kh;
  const T* vbase = v + b * st.vb + kvh * st.vh;
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();  // Q staged / previous tile consumed
    for (int i = tid; i < BK * DH / VEC; i += THREADS) {
      const int j = i / (DH / VEC), d = (i % (DH / VEC)) * VEC, kp = k0 + j;
      float kv[VEC] = {}, vv[VEC] = {};
      if (kp < Sk) {
        load_vec(kbase + kp * st.ks + d, kv);
        load_vec(vbase + kp * st.vs + d, vv);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Ks[j][d + e] = kv[e];
        Vs[j][d + e] = vv[e];
      }
    }
    __syncthreads();

    float s[KPT], mloc = NEG_INF;
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      const int j = sub + t * TPR, kp = k0 + j;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) dot += Qs[row][d] * Ks[j][d];
      const bool vis = empty ? kp < Sk : kp < klen && (!causal || kp <= qpos);
      s[t] = vis ? (empty ? 0.f : dot * scale) : NEG_INF;
      mloc = fmaxf(mloc, s[t]);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, off));
    const float m_new = fmaxf(m_i, mloc);
    const float alpha = expf(m_i - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      const float p = expf(s[t] - m_new);
      lsum += p;
      Ps[row][sub + t * TPR] = p;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    l_i = l_i * alpha + lsum;
    m_i = m_new;
    __syncwarp();  // a row's 8 threads share one warp
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      const int d = sub + dd * TPR;
      float a = acc[dd] * alpha;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) a += Ps[row][j] * Vs[j][d];
      acc[dd] = a;
    }
  }

  if (R >= rows_total) return;
  if (nsplit > 1) {
    float* pp = part + ((((size_t)b * nkv + kvh) * rows_total + R) * nsplit + split) * (DH + 2);
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) pp[sub + dd * TPR] = acc[dd];
    if (sub == 0) {
      pp[DH] = m_i;
      pp[DH + 1] = l_i;
    }
    return;
  }
  if (lse != nullptr && sub == 0) lse[((size_t)b * nh + h) * Sq + qi] = m_i + logf(l_i);
  T* orow = o + b * st.ob + h * st.oh + qi * st.os;
  const float inv = 1.f / fmaxf(l_i, 1e-30f);
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) {
    const int d = sub + dd * TPR;
    orow[d] = from_f<T>(l_i > 0.f ? acc[dd] * inv : 0.f);
  }
}

// One block per (row, kv-head, batch), one thread per dh element: merge the
// splits' partial softmax states into the output.
template <typename T, int DH>
__global__ void __launch_bounds__(DH)
flash_combine(const float* __restrict__ part, T* __restrict__ o, int nh, int nkv, int Sq,
              int nsplit, Strides st) {
  const int R = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int g = nh / nkv, rows_total = Sq * g;
  const float* pp = part + (((size_t)b * nkv + kvh) * rows_total + R) * nsplit * (DH + 2);
  float m = NEG_INF;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, pp[s * (DH + 2) + DH]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(pp[s * (DH + 2) + DH] - m);
    l += pp[s * (DH + 2) + DH + 1] * w;
    a += pp[s * (DH + 2) + d] * w;
  }
  const int qi = R / g, h = kvh * g + R % g;
  o[b * st.ob + h * st.oh + qi * st.os + d] = from_f<T>(l > 0.f ? a / l : 0.f);
}

template <typename T, int DH>
static void launch_dh(const void* q, const void* k, const void* v, void* o, const int* q_off,
                      const int* kv_len, int B, int nh, int nkv, int Sq, int Sk,
                      const Strides& st, int causal, float scale, int nsplit, float* part,
                      float* lse, cudaStream_t stream) {
  const int rows_total = Sq * (nh / nkv), tiles = (Sk + BK - 1) / BK;
  const int chunk = (tiles + nsplit - 1) / nsplit * BK;
  dim3 grid((rows_total + BQ - 1) / BQ * nsplit, nkv, B);
  T* op = static_cast<T*>(o);
  flash_fwd<T, DH><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), op, q_off,
      kv_len, nh, nkv, Sq, Sk, st, causal, scale, nsplit, chunk, part, lse);
  if (nsplit > 1)
    flash_combine<T, DH><<<dim3(rows_total, nkv, B), DH, 0, stream>>>(part, op, nh, nkv, Sq,
                                                                       nsplit, st);
}

template <typename T>
static void launch(const void* q, const void* k, const void* v, void* o, const int* q_off,
                   const int* kv_len, int B, int nh, int nkv, int Sq, int Sk, int dh,
                   const Strides& st, int causal, float scale, int nsplit, float* part,
                   float* lse, cudaStream_t stream) {
  if (dh == 64)
    launch_dh<T, 64>(q, k, v, o, q_off, kv_len, B, nh, nkv, Sq, Sk, st, causal, scale, nsplit,
                     part, lse, stream);
  else
    launch_dh<T, 128>(q, k, v, o, q_off, kv_len, B, nh, nkv, Sq, Sk, st, causal, scale, nsplit,
                      part, lse, stream);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
struct BwdStrides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;      // inputs and O
  long long gb, gh, gs;                                            // dO
  long long dqb, dqh, dqs, dkb, dkh, dks, dvb, dvh, dvs;           // gradients
};

// D[b, h, i] = sum_d dO * O over O's DH columns (the tensor cores' dv): LPR = DH / VEC lanes
// own a row, 16 bytes of it each, so every load is 16 bytes wide and a warp reads 32 / LPR
// rows; 8 warps, ROWS rows a block.
template <typename T, int DH>
struct BwdDot {
  static constexpr int VEC = 16 / sizeof(T), LPR = DH / VEC, ROWS = 8 * (32 / LPR);
};

template <typename T, int DH>
__global__ void __launch_bounds__(256)
flash_bwd_dot(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ D,
              int B, int nh, int Sq, BwdStrides st) {
  constexpr int VEC = BwdDot<T, DH>::VEC, LPR = BwdDot<T, DH>::LPR;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * BwdDot<T, DH>::ROWS + threadIdx.x / LPR;
  const bool live = row < (long long)B * nh * Sq;
  float acc = 0.f;
  if (live) {
    const int i = row % Sq, h = (row / Sq) % nh, b = row / ((long long)Sq * nh);
    const int d = (lane % LPR) * VEC;
    float ov[VEC], gv[VEC];
    load_vec(o + b * st.ob + h * st.oh + i * st.os + d, ov);
    load_vec(dout + b * st.gb + h * st.gh + i * st.gs + d, gv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc += ov[e] * gv[e];
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && lane % LPR == 0) D[row] = acc;
}

template <typename T, int DH>
static void launch_dot(const T* o, const T* dout, float* D, int B, int nh, int Sq,
                       const BwdStrides& st, cudaStream_t stream) {
  const long long rows = (long long)B * nh * Sq;
  constexpr int R = BwdDot<T, DH>::ROWS;
  flash_bwd_dot<T, DH><<<(unsigned)((rows + R - 1) / R), 256, 0, stream>>>(o, dout, D, B, nh,
                                                                            Sq, st);
}

// dK, dV: one block per (KV tile of BK keys, kv-head, batch); it loops over
// the tiles of BQ rows that see its keys (row = query position x q-head of
// the group, as in the forward), so dK and dV are summed over the group in
// the block.  Shared memory (dynamic): K, V as [BK][DH+1] fp32; Q, dO as
// [BQ][DH]; P and dS as [BQ][BK+1]; LSE and D of the rows.
constexpr int BWD_THREADS = 128;

template <int DH>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * BK * (DH + 1) + 2 * BQ * DH + 2 * BQ * (BK + 1) + 2 * BQ);
}

template <typename T, int DH>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ D, T* __restrict__ dk, T* __restrict__ dv, int nh,
               int nkv, int Sq, int Sk, BwdStrides st, int causal, float scale) {
  constexpr int VEC = 16 / sizeof(T), JPT = BK * DH / BWD_THREADS;  // keys per thread
  extern __shared__ float smem[];
  float* Ks = smem;                         // [BK][DH+1]
  float* Vs = Ks + BK * (DH + 1);           // [BK][DH+1]
  float* Qs = Vs + BK * (DH + 1);           // [BQ][DH]
  float* Gs = Qs + BQ * DH;                 // [BQ][DH]   dO
  float* Ps = Gs + BQ * DH;                 // [BQ][BK+1]
  float* Ss = Ps + BQ * (BK + 1);           // [BQ][BK+1] dS
  float* Ls = Ss + BQ * (BK + 1);           // [BQ]
  float* Ds = Ls + BQ;                      // [BQ]

  const int tid = threadIdx.x, b = blockIdx.z, kvh = blockIdx.y, g = nh / nkv;
  const int k0 = blockIdx.x * BK, rows_total = Sq * g;
  const T* kbase = k + b * st.kb + kvh * st.kh;
  const T* vbase = v + b * st.vb + kvh * st.vh;
  for (int i = tid; i < BK * DH / VEC; i += BWD_THREADS) {
    const int j = i / (DH / VEC), d = (i % (DH / VEC)) * VEC, kp = k0 + j;
    float kv[VEC] = {}, vv[VEC] = {};
    if (kp < Sk) {
      load_vec(kbase + kp * st.ks + d, kv);
      load_vec(vbase + kp * st.vs + d, vv);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      Ks[j * (DH + 1) + d + e] = kv[e];
      Vs[j * (DH + 1) + d + e] = vv[e];
    }
  }

  const int dcol = tid % DH, jbase = (tid / DH) * JPT;
  float dk_acc[JPT], dv_acc[JPT];
#pragma unroll
  for (int jj = 0; jj < JPT; ++jj) dk_acc[jj] = dv_acc[jj] = 0.f;

  // rows whose query can see a key of this tile: qi >= k0 under the mask
  const int r_begin = causal ? (min(k0, Sq) * g) / BQ * BQ : 0;
  for (int R0 = r_begin; R0 < rows_total; R0 += BQ) {
    __syncthreads();  // K/V staged / previous tile consumed
    for (int i = tid; i < BQ * DH / VEC; i += BWD_THREADS) {
      const int r = i / (DH / VEC), d = (i % (DH / VEC)) * VEC, R = R0 + r;
      float qv[VEC] = {}, gv[VEC] = {};
      if (R < rows_total) {
        const int qi = R / g, h = kvh * g + R % g;
        load_vec(q + b * st.qb + h * st.qh + qi * st.qs + d, qv);
        load_vec(dout + b * st.gb + h * st.gh + qi * st.gs + d, gv);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Qs[r * DH + d + e] = qv[e];
        Gs[r * DH + d + e] = gv[e];
      }
    }
    if (tid < BQ) {
      const int R = R0 + tid;
      float l = 0.f, dd = 0.f;
      if (R < rows_total) {
        const size_t ri = ((size_t)b * nh + kvh * g + R % g) * Sq + R / g;
        l = lse[ri];
        dd = D[ri];
      }
      Ls[tid] = l;
      Ds[tid] = dd;
    }
    __syncthreads();
    // P and dS for the BQ x BK tile: a warp shares one row, a lane one key
    for (int e = tid; e < BQ * BK; e += BWD_THREADS) {
      const int r = e / BK, j = e % BK, R = R0 + r, kp = k0 + j;
      float sqk = 0.f, sgv = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        sqk += Qs[r * DH + d] * Ks[j * (DH + 1) + d];
        sgv += Gs[r * DH + d] * Vs[j * (DH + 1) + d];
      }
      const bool vis = R < rows_total && kp < Sk && (!causal || kp <= R / g);
      const float p = vis ? expf(sqk * scale - Ls[r]) : 0.f;
      Ps[r * (BK + 1) + j] = p;
      Ss[r * (BK + 1) + j] = p * (sgv - Ds[r]);
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      const float gq = Gs[r * DH + dcol], qq = Qs[r * DH + dcol];
#pragma unroll
      for (int jj = 0; jj < JPT; ++jj) {
        dv_acc[jj] += Ps[r * (BK + 1) + jbase + jj] * gq;
        dk_acc[jj] += Ss[r * (BK + 1) + jbase + jj] * qq;
      }
    }
  }
#pragma unroll
  for (int jj = 0; jj < JPT; ++jj) {
    const int kp = k0 + jbase + jj;
    if (kp < Sk) {
      dk[b * st.dkb + kvh * st.dkh + kp * st.dks + dcol] = from_f<T>(dk_acc[jj] * scale);
      dv[b * st.dvb + kvh * st.dvh + kp * st.dvs + dcol] = from_f<T>(dv_acc[jj]);
    }
  }
}

// dQ: one block per (tile of BQ rows, kv-head, batch), as the forward; 8
// threads own a row.  Shared memory (dynamic): Q, dO as [BQ][DH+4]; K, V as
// [BK][DH+1]; dS as [BQ][BK+1].
template <int DH>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * BQ * (DH + 4) + 2 * BK * (DH + 1) + BQ * (BK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ D, T* __restrict__ dq, int nh, int nkv, int Sq, int Sk,
             BwdStrides st, int causal, float scale) {
  constexpr int DPT = DH / TPR, KPT = BK / TPR, VEC = 16 / sizeof(T);
  extern __shared__ float smem[];
  float* Qs = smem;                         // [BQ][DH+4]
  float* Gs = Qs + BQ * (DH + 4);           // [BQ][DH+4]
  float* Ks = Gs + BQ * (DH + 4);           // [BK][DH+1]
  float* Vs = Ks + BK * (DH + 1);           // [BK][DH+1]
  float* Ss = Vs + BK * (DH + 1);           // [BQ][BK+1]

  const int tid = threadIdx.x, row = tid / TPR, sub = tid % TPR;
  const int b = blockIdx.z, kvh = blockIdx.y, g = nh / nkv;
  const int rows_total = Sq * g, R0 = blockIdx.x * BQ, R = R0 + row;
  const int qi = R / g, h = kvh * g + R % g;
  int kend = Sk;
  if (causal) kend = min(kend, min(Sq - 1, (R0 + BQ - 1) / g) + 1);

  for (int i = tid; i < BQ * DH / VEC; i += THREADS) {
    const int r = i / (DH / VEC), d = (i % (DH / VEC)) * VEC, Rr = R0 + r;
    float qv[VEC] = {}, gv[VEC] = {};
    if (Rr < rows_total) {
      const int qr = Rr / g, hr = kvh * g + Rr % g;
      load_vec(q + b * st.qb + hr * st.qh + qr * st.qs + d, qv);
      load_vec(dout + b * st.gb + hr * st.gh + qr * st.gs + d, gv);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      Qs[r * (DH + 4) + d + e] = qv[e];
      Gs[r * (DH + 4) + d + e] = gv[e];
    }
  }
  float lrow = 0.f, drow = 0.f;
  if (R < rows_total) {
    const size_t ri = ((size_t)b * nh + h) * Sq + qi;
    lrow = lse[ri];
    drow = D[ri];
  }
  float acc[DPT];
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) acc[dd] = 0.f;

  const T* kbase = k + b * st.kb + kvh * st.kh;
  const T* vbase = v + b * st.vb + kvh * st.vh;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // Q/dO staged / previous tile consumed
    for (int i = tid; i < BK * DH / VEC; i += THREADS) {
      const int j = i / (DH / VEC), d = (i % (DH / VEC)) * VEC, kp = k0 + j;
      float kv[VEC] = {}, vv[VEC] = {};
      if (kp < Sk) {
        load_vec(kbase + kp * st.ks + d, kv);
        load_vec(vbase + kp * st.vs + d, vv);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Ks[j * (DH + 1) + d + e] = kv[e];
        Vs[j * (DH + 1) + d + e] = vv[e];
      }
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      const int j = sub + t * TPR, kp = k0 + j;
      float sqk = 0.f, sgv = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        sqk += Qs[row * (DH + 4) + d] * Ks[j * (DH + 1) + d];
        sgv += Gs[row * (DH + 4) + d] * Vs[j * (DH + 1) + d];
      }
      const bool vis = R < rows_total && kp < Sk && (!causal || kp <= qi);
      const float p = vis ? expf(sqk * scale - lrow) : 0.f;
      Ss[row * (BK + 1) + j] = p * (sgv - drow);
    }
    __syncwarp();  // a row's 8 threads share one warp
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      const int d = sub + dd * TPR;
      float a = acc[dd];
#pragma unroll 8
      for (int j = 0; j < BK; ++j) a += Ss[row * (BK + 1) + j] * Ks[j * (DH + 1) + d];
      acc[dd] = a;
    }
  }
  if (R >= rows_total) return;
  T* drow_out = dq + b * st.dqb + h * st.dqh + qi * st.dqs;
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd) drow_out[sub + dd * TPR] = from_f<T>(acc[dd] * scale);
}

template <typename T, int DH>
static int launch_bwd_dh(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* D, void* dq, void* dk,
                         void* dv, int B, int nh, int nkv, int Sq, int Sk, const BwdStrides& st,
                         int causal, float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(dout);
  launch_dot<T, DH>(static_cast<const T*>(o), gp, D, B, nh, Sq, st, stream);
  constexpr size_t s_kv = dkdv_smem<DH>(), s_q = dq_smem<DH>();
  cudaFuncSetAttribute(flash_bwd_dkdv<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s_kv);
  cudaFuncSetAttribute(flash_bwd_dq<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)s_q);
  flash_bwd_dkdv<T, DH><<<dim3((Sk + BK - 1) / BK, nkv, B), BWD_THREADS, s_kv, stream>>>(
      qp, kp, vp, gp, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), nh, nkv, Sq, Sk, st,
      causal, scale);
  const int rows_total = Sq * (nh / nkv);
  flash_bwd_dq<T, DH><<<dim3((rows_total + BQ - 1) / BQ, nkv, B), THREADS, s_q, stream>>>(
      qp, kp, vp, gp, lse, D, static_cast<T*>(dq), nh, nkv, Sq, Sk, st, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma, with K/V (and the backward's Q/dO) staged
// by TMA into a ring of shared-memory stages that a producer warp fills
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int BM = 64;        // rows of a forward or dQ block: the wgmma's M, one warpgroup
constexpr int BN = 64;        // keys of a K/V tile
constexpr int BMB = 32;       // query rows of one dK/dV iteration (the wgmma's N there)
constexpr int NST = 2;        // stages of the ring
constexpr int THREADS = 160;  // one consumer warpgroup (128) + one producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Bytes of ROWS rows of a D-wide operand: ceil(D / 64) halves of ROWS x 128 bytes (at D 96 the
// second half's columns 96..127 are TMA's zero fill or never written, and never read).
template <int D, int ROWS>
__host__ __device__ constexpr int tile_bytes() { return (D + 63) / 64 * ROWS * 128; }

// ROWS positions from s0 of one (batch, head) of a D-wide map, as tile_bytes<D, ROWS>()
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* b,
                                         int s0, int h, int bb) {
#pragma unroll
  for (int hf = 0; hf < (D + 63) / 64; ++hf)
    tma_load(dst + hf * ROWS * 128, map, b, hf * 64, s0, h, bb);
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 96] += A[64 x 16] B[16 x 96]: A (bf16 pairs) in registers, B MN-major in shared
// memory (its first 64-column half, then 32 columns of the second, lbo bytes on)
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x N] += A[64 x 16] B[16 x N], N = 64, 96 or 128; lbo: the distance of B's halves
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t* a, uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t* a, uint64_t db) {
  wgmma_rs_n96(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t* a, uint64_t db) {
  wgmma_rs_n128(d, a, db);
}

// The accumulator of an m64nN product (thread: rows r, r + 8; columns 8i + 2(lane % 4) + {0, 1})
// as the register A operand of the next product over those N columns: k-step kk takes
// a[4kk .. 4kk + 3], the pairs of columns 16kk .. 16kk + 15, rounded to bf16.
template <int N>
__device__ __forceinline__ void to_frag(const float (&s)[N / 2], uint32_t (&a)[N / 4]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    __nv_bfloat162 v = __floats2bfloat162_rn(s[2 * j], s[2 * j + 1]);
    a[j] = *reinterpret_cast<uint32_t*>(&v);
  }
}

// S (+)= A B^T over D columns, A and B K-major tiles of ROWS_A and ROWS_B rows: D / 16 k-steps,
// the 4 of a 64-column half 32 bytes apart, the halves ROWS x 128 bytes apart.
template <int D, int ROWS_A, int ROWS_B, int N>
__device__ __forceinline__ void mma_kmajor(float (&s)[N / 2], uint32_t a, uint32_t b) {
  static_assert(N == 32 || N == 64, "the score products are m64n32 or m64n64");
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    const uint64_t da = desc(a + (k / 4) * ROWS_A * 128 + (k % 4) * 32, 16);
    const uint64_t db = desc(b + (k / 4) * ROWS_B * 128 + (k % 4) * 32, 16);
    if constexpr (N == 64) wgmma_ss_n64(s, da, db, k);
    else wgmma_ss_n32(s, da, db, k);
  }
}

// Rows R0 .. R0 + 63 of a block (row R = query R / g, q-head kvh g + R % g, read through the
// strides) of a D-wide tensor into tile_bytes<D, BM>() in the 128-byte swizzle; rows past
// rows_total are 0.
template <int D>
__device__ __forceinline__ void load_rows(uint8_t* dst, const bf16* t, long long sb, long long sh,
                                          long long ss, int b, int kvh, int g, int R0,
                                          int rows_total, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks of a row (12 at D 96)
  for (int i = tid; i < BM * CH; i += 128) {
    const int r = i / CH, cc = i % CH, R = R0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (R < rows_total)
      val = *reinterpret_cast<const uint4*>(t + b * sb + (long long)(kvh * g + R % g) * sh +
                                            (long long)(R / g) * ss + cc * 8);
    *reinterpret_cast<uint4*>(dst + (cc / 8) * BM * 128 + r * 128 + (((cc % 8) ^ (r & 7)) << 4)) =
        val;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
}

__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); }

// The K/V producer of a forward or dQ block: tiles 0 .. ntiles - 1 of (b, kvh) into the ring,
// a stage K (DK wide) then V (DV wide).
template <int DK, int DV>
__device__ __forceinline__ void produce_kv(uint8_t* KV, uint64_t* full, uint64_t* empty,
                                           const CUtensorMap* kmap, const CUtensorMap* vmap,
                                           int ntiles, int kvh, int b) {
  constexpr int KT = tile_bytes<DK, BN>(), ST = KT + tile_bytes<DV, BN>();
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % NST;
    if (t >= NST) bar_wait(&empty[s], (t / NST - 1) & 1);
    bar_expect(&full[s], ST);
    tma_tile<DK, BN>(KV + s * ST, kmap, &full[s], t * BN, kvh, b);
    tma_tile<DV, BN>(KV + s * ST + KT, vmap, &full[s], t * BN, kvh, b);
  }
}

// Forward: one block per (tile of 64 rows, kv-head, batch), rows as in the SIMT kernel;
// heavier (later) causal tiles are scheduled first.
template <int DK, int DV>
__global__ void __launch_bounds__(THREADS, 2)
fwd(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const bf16* __restrict__ q, bf16* __restrict__ o, const int* __restrict__ q_off,
    const int* __restrict__ kv_len, int nh, int nkv, int Sq, int Sk, Strides st, int causal,
    float scale, float* __restrict__ lse) {
  constexpr int KT = tile_bytes<DK, BN>(), ST = KT + tile_bytes<DV, BN>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1k(smem_raw);
  uint8_t* KV = Qs + tile_bytes<DK, BM>();  // stage s: K at KV + s ST, V KT after it
  uint64_t* full = reinterpret_cast<uint64_t*>(KV + NST * ST);
  uint64_t* empty = full + NST;

  const int tid = threadIdx.x, b = blockIdx.z, kvh = blockIdx.y, g = nh / nkv;
  const int rows_total = Sq * g, R0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int qoff = q_off != nullptr ? q_off[b] : 0;
  const int klen = kv_len != nullptr ? min(kv_len[b], Sk) : Sk;
  const bool none = klen <= 0;  // no visible key: all Sk keys count, as in the SIMT kernel
  int kend = none ? Sk : klen;
  if (causal && !none) kend = min(kend, qoff + min(Sq - 1, (R0 + BM - 1) / g) + 1);
  const int ntiles = (kend + BN - 1) / BN;

  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= 128) {  // the producer warp
    if (tid == 128) produce_kv<DK, DV>(KV, full, empty, &kmap, &vmap, ntiles, kvh, b);
    return;
  }

  load_rows<DK>(Qs, q, st.qb, st.qh, st.qs, b, kvh, g, R0, rows_total, tid);
  consumers_sync();
  const int lane = tid % 32, ra = (tid / 32) * 16 + lane / 4, cb = 2 * (lane % 4);
  const int qp[2] = {qoff + (R0 + ra) / g, qoff + (R0 + ra + 8) / g};
  const int qfirst = qoff + R0 / g;
  const float sl2 = scale * LOG2E;  // scores in log2 units
  const uint32_t qaddr = saddr(Qs);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[DV / 2];
  zero(acc);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % NST, k0 = t * BN;
    const uint32_t kaddr = saddr(KV + s * ST), vaddr = kaddr + KT;
    float sc[BN / 2];
    zero(sc);
    bar_wait(&full[s], (t / NST) & 1);
    wg_fence();
    mma_kmajor<DK, BM, BN, BN>(sc, qaddr, kaddr);
    wg_commit();
    wg_wait<0>();
    keep(sc);

    // the mask only on a tile that straddles a limit
    const bool straddle = none ? k0 + BN > Sk
                               : (k0 + BN > klen || (causal && k0 + BN - 1 > qfirst));
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = none ? 0.f : sc[4 * i + 2 * h + e] * sl2;
          if (straddle) {
            const int kp = k0 + 8 * i + cb + e;
            if (!(none ? kp < Sk : kp < klen && (!causal || kp <= qp[h]))) x = NEG_INF;
          }
          sc[4 * i + 2 * h + e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];  // this thread's part of the row sum; reduced at the end
    }
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sc[4 * i + 2 * h + e] - m[h]);
          l[h] += p;
          sc[4 * i + 2 * h + e] = p;
        }
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[4 * i + j] *= alpha[j / 2];
    uint32_t pf[BN / 4];
    to_frag<BN>(sc, pf);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<DV>(acc, &pf[4 * kk], desc(vaddr + kk * 2048, BN * 128));
    wg_commit();
    wg_wait<0>();
    keep(acc);
    keep(pf);
    if (tid == 0) bar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int R = R0 + ra + 8 * h;
    if (R >= rows_total) continue;
    const int qi = R / g, hh = kvh * g + R % g;
    bf16* orow = o + b * st.ob + (long long)hh * st.oh + (long long)qi * st.os;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + cb) =
          __floats2bfloat162_rn(acc[4 * i + 2 * h] * inv, acc[4 * i + 2 * h + 1] * inv);
    if (lse != nullptr && lane % 4 == 0)
      lse[((long long)b * nh + hh) * Sq + qi] = m[h] * LN2 + logf(l[h]);
  }
}

// dQ: one block per (tile of 64 rows, kv-head, batch), as the forward; loops over the K/V
// tiles its rows see: S = Q K^T (over dk), dP = dO V^T (over dv), dS = P (dP - D),
// dQ += dS K (N = dk).
template <int DK, int DV>
__global__ void __launch_bounds__(THREADS, 2)
bwd_dq(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
       const bf16* __restrict__ q, const bf16* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ D, bf16* __restrict__ dq, int nh, int nkv, int Sq, int Sk,
       BwdStrides st, int causal, float scale) {
  constexpr int KT = tile_bytes<DK, BN>(), ST = KT + tile_bytes<DV, BN>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1k(smem_raw);
  uint8_t* Gs = Qs + tile_bytes<DK, BM>();
  uint8_t* KV = Gs + tile_bytes<DV, BM>();
  uint64_t* full = reinterpret_cast<uint64_t*>(KV + NST * ST);
  uint64_t* empty = full + NST;

  const int tid = threadIdx.x, b = blockIdx.z, kvh = blockIdx.y, g = nh / nkv;
  const int rows_total = Sq * g, R0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int kend = causal ? min(Sk, min(Sq - 1, (R0 + BM - 1) / g) + 1) : Sk;
  const int ntiles = (kend + BN - 1) / BN;

  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= 128) {
    if (tid == 128) produce_kv<DK, DV>(KV, full, empty, &kmap, &vmap, ntiles, kvh, b);
    return;
  }

  load_rows<DK>(Qs, q, st.qb, st.qh, st.qs, b, kvh, g, R0, rows_total, tid);
  load_rows<DV>(Gs, dout, st.gb, st.gh, st.gs, b, kvh, g, R0, rows_total, tid);
  consumers_sync();
  const int lane = tid % 32, ra = (tid / 32) * 16 + lane / 4, cb = 2 * (lane % 4);
  int qp[2];
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = R0 + ra + 8 * h;
    qp[h] = R < rows_total ? R / g : -1;  // -1: a padding row sees no key
    const long long ri = ((long long)b * nh + kvh * g + R % g) * Sq + R / g;
    l2[h] = R < rows_total ? lse[ri] * LOG2E : 0.f;
    dd[h] = R < rows_total ? D[ri] : 0.f;
  }
  const float sl2 = scale * LOG2E;
  const uint32_t qaddr = saddr(Qs), gaddr = saddr(Gs);
  float acc[DK / 2];
  zero(acc);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % NST, k0 = t * BN;
    const uint32_t kaddr = saddr(KV + s * ST), vaddr = kaddr + KT;
    float sc[BN / 2], dp[BN / 2];
    zero(sc);
    zero(dp);
    bar_wait(&full[s], (t / NST) & 1);
    wg_fence();
    mma_kmajor<DK, BM, BN, BN>(sc, qaddr, kaddr);
    mma_kmajor<DV, BM, BN, BN>(dp, gaddr, vaddr);
    wg_commit();
    wg_wait<0>();
    keep(sc);
    keep(dp);
    const bool straddle =
        k0 + BN > Sk || R0 + BM > rows_total || (causal && k0 + BN - 1 > R0 / g);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * i + 2 * h + e, kp = k0 + 8 * i + cb + e;
          float p = exp2f(sc[x] * sl2 - l2[h]);
          if (straddle && !(kp < Sk && qp[h] >= 0 && (!causal || kp <= qp[h]))) p = 0.f;
          sc[x] = p * (dp[x] - dd[h]);
        }
    uint32_t df[BN / 4];
    to_frag<BN>(sc, df);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<DK>(acc, &df[4 * kk], desc(kaddr + kk * 2048, BN * 128));
    wg_commit();
    wg_wait<0>();
    keep(acc);
    keep(df);
    if (tid == 0) bar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = R0 + ra + 8 * h;
    if (R >= rows_total) continue;
    bf16* row = dq + b * st.dqb + (long long)(kvh * g + R % g) * st.dqh + (long long)(R / g) * st.dqs;
#pragma unroll
    for (int i = 0; i < DK / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * i + cb) =
          __floats2bfloat162_rn(acc[4 * i + 2 * h] * scale, acc[4 * i + 2 * h + 1] * scale);
  }
}

// dK, dV: one block per (tile of 64 keys, kv-head, batch).  K and V stay in shared memory;
// the producer streams tiles of 32 query positions of each q-head of the group from the
// causal start (Q and dO by TMA), and the products run transposed so the keys are the
// wgmma's M: S^T = K Q^T (over dk), P^T = exp(S^T scale - LSE), dV += P^T dO (N = dv),
// dP^T = V dO^T (over dv), dS^T = P^T (dP^T - D), dK += dS^T Q (N = dk).  No atomics: the
// block owns its keys.
template <int DK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
         const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap gmap,
         const float* __restrict__ lse, const float* __restrict__ D, bf16* __restrict__ dk,
         bf16* __restrict__ dv, int nh, int nkv, int Sq, int Sk, BwdStrides st, int causal,
         float scale) {
  constexpr int KT = tile_bytes<DK, BN>(), VT = tile_bytes<DV, BN>();   // 64 keys
  constexpr int QT = tile_bytes<DK, BMB>(), RT = QT + tile_bytes<DV, BMB>();  // 32 rows
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1k(smem_raw);
  uint8_t* Vs = Ks + KT;
  uint8_t* RS = Vs + VT;  // stage s: Q at RS + s RT, dO QT after it
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(RS + NST * RT);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + NST;

  const int tid = threadIdx.x, b = blockIdx.z, kvh = blockIdx.y, g = nh / nkv;
  const int k0 = blockIdx.x * BN;
  const int qstart = causal ? min(k0, Sq) / BMB * BMB : 0;
  const int per_head = (Sq - qstart + BMB - 1) / BMB, n_it = g * per_head;

  if (tid == 0) {
    bar_init(kvbar, 1);
    for (int s = 0; s < NST; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= 128) {
    if (tid == 128) {
      bar_expect(kvbar, KT + VT);
      tma_tile<DK, BN>(Ks, &kmap, kvbar, k0, kvh, b);
      tma_tile<DV, BN>(Vs, &vmap, kvbar, k0, kvh, b);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % NST, h = kvh * g + it / per_head;
        const int qi0 = qstart + (it % per_head) * BMB;
        if (it >= NST) bar_wait(&empty[s], (it / NST - 1) & 1);
        bar_expect(&full[s], RT);
        tma_tile<DK, BMB>(RS + s * RT, &qmap, &full[s], qi0, h, b);
        tma_tile<DV, BMB>(RS + s * RT + QT, &gmap, &full[s], qi0, h, b);
      }
    }
    return;
  }

  const int lane = tid % 32, ra = (tid / 32) * 16 + lane / 4, cb = 2 * (lane % 4);
  const int kp[2] = {k0 + ra, k0 + ra + 8};
  const float sl2 = scale * LOG2E;
  const uint32_t kaddr = saddr(Ks), vaddr = saddr(Vs);
  float dka[DK / 2], dva[DV / 2];
  zero(dka);
  zero(dva);
  bar_wait(kvbar, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % NST, h = kvh * g + it / per_head;
    const int qi0 = qstart + (it % per_head) * BMB;
    // LSE (log2 units) and D of this thread's 8 query columns
    float l2[BMB / 8][2], dd[BMB / 8][2];
#pragma unroll
    for (int i = 0; i < BMB / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = qi0 + 8 * i + cb + e;
        const long long ri = ((long long)b * nh + h) * Sq + qi;
        l2[i][e] = qi < Sq ? lse[ri] * LOG2E : 0.f;
        dd[i][e] = qi < Sq ? D[ri] : 0.f;
      }
    const uint32_t qaddr = saddr(RS + s * RT), gaddr = qaddr + QT;
    float sc[BMB / 2], dp[BMB / 2];
    zero(sc);
    zero(dp);
    bar_wait(&full[s], (it / NST) & 1);
    wg_fence();
    mma_kmajor<DK, BN, BMB, BMB>(sc, kaddr, qaddr);
    mma_kmajor<DV, BN, BMB, BMB>(dp, vaddr, gaddr);
    wg_commit();
    wg_wait<0>();
    keep(sc);
    keep(dp);
    const bool straddle = qi0 + BMB > Sq || k0 + BN > Sk || (causal && k0 + BN - 1 > qi0);
#pragma unroll
    for (int i = 0; i < BMB / 8; ++i)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * i + 2 * h2 + e, qi = qi0 + 8 * i + cb + e;
          float p = exp2f(sc[x] * sl2 - l2[i][e]);
          if (straddle && !(qi < Sq && kp[h2] < Sk && (!causal || kp[h2] <= qi))) p = 0.f;
          sc[x] = p;
          dp[x] = p * (dp[x] - dd[i][e]);
        }
    uint32_t pf[BMB / 4], df[BMB / 4];
    to_frag<BMB>(sc, pf);
    to_frag<BMB>(dp, df);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BMB / 16; ++kk)
      wgmma_rs<DV>(dva, &pf[4 * kk], desc(gaddr + kk * 2048, BMB * 128));
#pragma unroll
    for (int kk = 0; kk < BMB / 16; ++kk)
      wgmma_rs<DK>(dka, &df[4 * kk], desc(qaddr + kk * 2048, BMB * 128));
    wg_commit();
    wg_wait<0>();
    keep(dva);
    keep(dka);
    keep(pf);
    keep(df);
    if (tid == 0) bar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kp[h] >= Sk) continue;
    bf16* krow = dk + b * st.dkb + (long long)kvh * st.dkh + (long long)kp[h] * st.dks;
    bf16* vrow = dv + b * st.dvb + (long long)kvh * st.dvh + (long long)kp[h] * st.dvs;
#pragma unroll
    for (int i = 0; i < DK / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * i + cb) =
          __floats2bfloat162_rn(dka[4 * i + 2 * h] * scale, dka[4 * i + 2 * h + 1] * scale);
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * i + cb) =
          __floats2bfloat162_rn(dva[4 * i + 2 * h], dva[4 * i + 2 * h + 1]);
  }
}

// ---- host side ----

template <int DK, int DV>
constexpr size_t fwd_smem() {
  return 1024 + tile_bytes<DK, BM>() + NST * (tile_bytes<DK, BN>() + tile_bytes<DV, BN>()) +
         2 * NST * 8;
}
template <int DK, int DV>
constexpr size_t dq_smem() {
  return 1024 + tile_bytes<DK, BM>() + tile_bytes<DV, BM>() +
         NST * (tile_bytes<DK, BN>() + tile_bytes<DV, BN>()) + 2 * NST * 8;
}
template <int DK, int DV>
constexpr size_t dkdv_smem() {
  return 1024 + tile_bytes<DK, BN>() + tile_bytes<DV, BN>() +
         NST * (tile_bytes<DK, BMB>() + tile_bytes<DV, BMB>()) + (1 + 2 * NST) * 8;
}
// two forward and two dQ blocks share an SM (228 KB, 1 KB of it reserved a block) at every
// instantiated (dk, dv): __launch_bounds__(THREADS, 2)
constexpr bool two_fit(size_t smem) { return 2 * (smem + 1024) <= 233472; }
static_assert(two_fit(fwd_smem<128, 128>()) && two_fit(dq_smem<128, 128>()) &&
              two_fit(fwd_smem<96, 64>()) && two_fit(dq_smem<96, 64>()), "two blocks an SM");

template <int DK, int DV>
static int launch_fwd(const void* q, const void* k, const void* v, void* o, const int* q_off,
                      const int* kv_len, int B, int nh, int nkv, int Sq, int Sk,
                      const Strides& st, int causal, float scale, float* lse,
                      cudaStream_t stream) {
  CUtensorMap km, vm;
  if (!tensor_map(&km, k, DK, Sk, nkv, B, st.kb, st.kh, st.ks, BN) ||
      !tensor_map(&vm, v, DV, Sk, nkv, B, st.vb, st.vh, st.vs, BN))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = fwd_smem<DK, DV>();
  cudaFuncSetAttribute(fwd<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((Sq * (nh / nkv) + BM - 1) / BM, nkv, B);
  fwd<DK, DV><<<grid, THREADS, smem, stream>>>(km, vm, static_cast<const bf16*>(q),
                                                 static_cast<bf16*>(o), q_off, kv_len, nh, nkv,
                                                 Sq, Sk, st, causal, scale, lse);
  return (int)cudaGetLastError();
}

template <int DK, int DV>
static int launch_bwd(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* D, void* dq, void* dk, void* dv,
                      int B, int nh, int nkv, int Sq, int Sk, const BwdStrides& st, int causal,
                      float scale, cudaStream_t stream) {
  CUtensorMap km, vm, qm, gm;
  if (!tensor_map(&km, k, DK, Sk, nkv, B, st.kb, st.kh, st.ks, BN) ||
      !tensor_map(&vm, v, DV, Sk, nkv, B, st.vb, st.vh, st.vs, BN) ||
      !tensor_map(&qm, q, DK, Sq, nh, B, st.qb, st.qh, st.qs, BMB) ||
      !tensor_map(&gm, dout, DV, Sq, nh, B, st.gb, st.gh, st.gs, BMB))
    return (int)cudaErrorInvalidValue;
  launch_dot<bf16, DV>(static_cast<const bf16*>(o), static_cast<const bf16*>(dout), D, B, nh,
                       Sq, st, stream);
  constexpr size_t s_kv = dkdv_smem<DK, DV>(), s_q = dq_smem<DK, DV>();
  cudaFuncSetAttribute(bwd_dkdv<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s_kv);
  cudaFuncSetAttribute(bwd_dq<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s_q);
  bwd_dkdv<DK, DV><<<dim3((Sk + BN - 1) / BN, nkv, B), THREADS, s_kv, stream>>>(
      km, vm, qm, gm, lse, D, static_cast<bf16*>(dk), static_cast<bf16*>(dv), nh, nkv, Sq, Sk,
      st, causal, scale);
  bwd_dq<DK, DV><<<dim3((Sq * (nh / nkv) + BM - 1) / BM, nkv, B), THREADS, s_q, stream>>>(
      km, vm, static_cast<const bf16*>(q), static_cast<const bf16*>(dout), lse, D,
      static_cast<bf16*>(dq), nh, nkv, Sq, Sk, st, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

extern "C" {

// q_off / kv_len: int32 [B] on the device, or null (0 / Sk).  Strides are
// in elements.  nsplit > 1 splits the keys over blocks and needs ``part``:
// B * nkv * Sq * (nh / nkv) * nsplit * (dh + 2) floats.  lse: fp32
// [B, nh, Sq] for each row's log-sum-exp, or null; it needs nsplit == 1.
// Returns a cudaError_t (cudaErrorInvalidValue for a dh the kernel does
// not take).
int hk_flash_attention(const void* q, const void* k, const void* v, void* o,
                       const void* q_off, const void* kv_len, int B, int nh, int nkv,
                       int Sq, int Sk, int dh, long long qb, long long qh, long long qs,
                       long long kb, long long kh, long long ks, long long vb, long long vh,
                       long long vs, long long ob, long long oh, long long os, int causal,
                       float scale, int nsplit, void* part, void* lse, int dtype,
                       void* stream) {
  if (dh != 64 && dh != 128) return (int)cudaErrorInvalidValue;
  if (nsplit < 1 || (nsplit > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  if (lse != nullptr && nsplit != 1) return (int)cudaErrorInvalidValue;
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qo = static_cast<const int*>(q_off);
  const int* kl = static_cast<const int*>(kv_len);
  float* pp = static_cast<float*>(part);
  float* lp = static_cast<float*>(lse);
  if (dtype == DT_BF16)
    launch<bf16>(q, k, v, o, qo, kl, B, nh, nkv, Sq, Sk, dh, st, causal, scale, nsplit, pp, lp,
                 s);
  else
    launch<float>(q, k, v, o, qo, kl, B, nh, nkv, Sq, Sk, dh, st, causal, scale, nsplit, pp, lp,
                  s);
  return (int)cudaGetLastError();
}

// The backward under the training mask (q_off 0, no kv_len, Sq == Sk).
// strides: 24 element strides (batch, head, position) of q, k, v, o, dO,
// dq, dk, dv in that order, on the host.  lse: the forward's fp32
// [B, nh, Sq]; D: fp32 scratch of B * nh * Sq floats.  dq, dk, dv are
// written in the input dtype.  Returns a cudaError_t.
int hk_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const void* lse, void* D, void* dq, void* dk,
                           void* dv, int B, int nh, int nkv, int Sq, int Sk, int dh,
                           const long long* strides, int causal, float scale, int dtype,
                           void* stream) {
  if (dh != 64 && dh != 128) return (int)cudaErrorInvalidValue;
  if (Sq != Sk || nh % nkv) return (int)cudaErrorInvalidValue;
  const long long* t = strides;
  const BwdStrides st{t[0],  t[1],  t[2],  t[3],  t[4],  t[5],  t[6],  t[7],
                      t[8],  t[9],  t[10], t[11], t[12], t[13], t[14], t[15],
                      t[16], t[17], t[18], t[19], t[20], t[21], t[22], t[23]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  float* Dp = static_cast<float*>(D);
  if (dtype == DT_BF16)
    return dh == 64 ? launch_bwd_dh<bf16, 64>(q, k, v, o, dout, lp, Dp, dq, dk, dv, B, nh, nkv,
                                               Sq, Sk, st, causal, scale, s)
                    : launch_bwd_dh<bf16, 128>(q, k, v, o, dout, lp, Dp, dq, dk, dv, B, nh, nkv,
                                                Sq, Sk, st, causal, scale, s);
  return dh == 64 ? launch_bwd_dh<float, 64>(q, k, v, o, dout, lp, Dp, dq, dk, dv, B, nh, nkv,
                                              Sq, Sk, st, causal, scale, s)
                  : launch_bwd_dh<float, 128>(q, k, v, o, dout, lp, Dp, dq, dk, dv, B, nh, nkv,
                                               Sq, Sk, st, causal, scale, s);
}

// The bf16 tensor-core forward (wgmma; K/V by TMA): the contract of hk_flash_attention
// without the key split, with q and k at dk and v and o at dv: (dk, dv) = (64, 64),
// (96, 64) or (128, 128).  Returns a cudaError_t (cudaErrorInvalidValue for dims it does not
// take or a layout TMA refuses).
int hk_flash_attention_tc(const void* q, const void* k, const void* v, void* o,
                          const void* q_off, const void* kv_len, int B, int nh, int nkv, int Sq,
                          int Sk, int dk, int dv, long long qb, long long qh, long long qs,
                          long long kb, long long kh, long long ks, long long vb, long long vh,
                          long long vs, long long ob, long long oh, long long os, int causal,
                          float scale, void* lse, void* stream) {
  if (nh % nkv) return (int)cudaErrorInvalidValue;
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qo = static_cast<const int*>(q_off);
  const int* kl = static_cast<const int*>(kv_len);
  float* lp = static_cast<float*>(lse);
  if (dk == 64 && dv == 64)
    return tc::launch_fwd<64, 64>(q, k, v, o, qo, kl, B, nh, nkv, Sq, Sk, st, causal, scale, lp,
                                  s);
  if (dk == 96 && dv == 64)
    return tc::launch_fwd<96, 64>(q, k, v, o, qo, kl, B, nh, nkv, Sq, Sk, st, causal, scale, lp,
                                  s);
  if (dk == 128 && dv == 128)
    return tc::launch_fwd<128, 128>(q, k, v, o, qo, kl, B, nh, nkv, Sq, Sk, st, causal, scale,
                                    lp, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 tensor-core backward: the contract of hk_flash_attention_bwd at the forward's
// (dk, dv) = (dim_k, dim_v): dq and dk at dk, o, dO and dv at dv.
int hk_flash_attention_bwd_tc(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* D, void* dq, void* dk,
                              void* dv, int B, int nh, int nkv, int Sq, int Sk, int dim_k,
                              int dim_v, const long long* strides, int causal, float scale,
                              void* stream) {
  if (Sq != Sk || nh % nkv) return (int)cudaErrorInvalidValue;
  const long long* t = strides;
  const BwdStrides st{t[0],  t[1],  t[2],  t[3],  t[4],  t[5],  t[6],  t[7],
                      t[8],  t[9],  t[10], t[11], t[12], t[13], t[14], t[15],
                      t[16], t[17], t[18], t[19], t[20], t[21], t[22], t[23]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lse);
  float* Dp = static_cast<float*>(D);
  if (dim_k == 64 && dim_v == 64)
    return tc::launch_bwd<64, 64>(q, k, v, o, dout, lp, Dp, dq, dk, dv, B, nh, nkv, Sq, Sk, st,
                                  causal, scale, s);
  if (dim_k == 96 && dim_v == 64)
    return tc::launch_bwd<96, 64>(q, k, v, o, dout, lp, Dp, dq, dk, dv, B, nh, nkv, Sq, Sk, st,
                                  causal, scale, s);
  if (dim_k == 128 && dim_v == 128)
    return tc::launch_bwd<128, 128>(q, k, v, o, dout, lp, Dp, dq, dk, dv, B, nh, nkv, Sq, Sk,
                                    st, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* hk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
