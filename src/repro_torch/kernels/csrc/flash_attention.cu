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
// Layout: q [B, nh, Sq, dh], k/v [B, nkv, Sk, dh], o, dO and the gradients
// like their inputs, each given by element strides (batch, head, position)
// with dh contiguous, so the model hands over its [B, S, heads, dh]
// tensors without a transpose.  dh is 64 or 128; fp32 or bf16 in, the
// outputs in the input dtype.
//
// Bound on an H100 SXM: decode (Sq = 1) reads each slot's K/V once,
// kv_len * nkv * dh * 2 tensors * 2 bytes per layer, and is byte bound;
// prefill at a 512-token prompt does 4 * Sq * kv * nh * dh operations
// (half of them under the causal mask skipped) and is operation bound, as
// is the backward (10 * pairs * nh * dh operations: the two score
// products again, and dV, dK, dQ).  The design: one block per (batch,
// kv-head, tile of 16 "rows"), where a row is one (query position, q-head
// of the group) pair, so the g q-heads sharing a kv-head read each K/V
// tile once; decode fills g rows of the tile instead of one.  K/V tiles of
// 32 keys are staged in shared memory as fp32 with 16-byte loads, scores
// and the products are fp32 SIMT FMAs (no tensor cores yet: a later PR
// moves them onto mma), 8 threads own a row and reduce its max and sum
// with warp shuffles.  When that grid is too small to fill the card
// (decode: batch x kv-heads blocks), the keys are also split over blocks
// and a second kernel merges the partial softmax states (flash-decoding).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

// D[b, h, i] = sum_d dO * O: one warp per row, 8 rows per block.
template <typename T, int DH>
__global__ void __launch_bounds__(256)
flash_bwd_dot(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ D,
              int B, int nh, int Sq, BwdStrides st) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * 8 + warp;
  if (row >= (long long)B * nh * Sq) return;
  const int i = row % Sq, h = (row / Sq) % nh, b = row / ((long long)Sq * nh);
  const T* orow = o + b * st.ob + h * st.oh + i * st.os;
  const T* grow = dout + b * st.gb + h * st.gh + i * st.gs;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < DH; d += 32) acc += to_f(orow[d]) * to_f(grow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[row] = acc;
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
  const long long rows = (long long)B * nh * Sq;
  flash_bwd_dot<T, DH><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), gp, D, B, nh, Sq, st);
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

const char* hk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
