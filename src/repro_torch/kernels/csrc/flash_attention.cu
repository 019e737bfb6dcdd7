// Hand-written Hopper (sm_90a) flash-attention forward kernel of the port.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (pallas_call at flash_attention.py:84, body _flash_kernel:25): online-
// softmax attention with running max, denominator and accumulator in fp32,
// GQA without repeating K/V (q-head h reads kv-head h // g), and KV tiles
// that are fully masked skipped.  The mask is the one the model path uses
// (models/attention.py::_sdpa), not the Pallas kernel's top-left one: key
// kpos is visible to query qpos of batch row b when
//     kpos <= q_off[b] + qpos   (causal)   and   kpos < kv_len[b].
// Prefill passes q_off = the slot's length before the prompt; decode
// passes q_off = length and kv_len = length + 1, which is the grouped
// decode mask of _sdpa_grouped_decode.  Masked scores are -1e30 as in
// attention.py:21.  A row with no visible key is outside the contract
// (the model never builds one); the kernel writes 0 there.
//
// Layout: q [B, nh, Sq, dh], k/v [B, nkv, Sk, dh], o like q, each given by
// element strides (batch, head, position) with dh contiguous, so the model
// hands over its [B, S, heads, dh] tensors without a transpose.  dh is 64
// or 128; fp32 or bf16 in, the output in the input dtype.
//
// Bound on an H100 SXM: decode (Sq = 1) reads each slot's K/V once,
// kv_len * nkv * dh * 2 tensors * 2 bytes per layer, and is byte bound;
// prefill at a 512-token prompt does 4 * Sq * kv * nh * dh operations
// (half of them under the causal mask skipped) and is operation bound.
// The design: one block per (batch, kv-head, tile of 16 "rows"), where a
// row is one (query position, q-head of the group) pair, so the g q-heads
// sharing a kv-head read each K/V tile once; decode fills g rows of the
// tile instead of one.  K/V tiles of 32 keys are staged in shared memory
// as fp32 with 16-byte loads, scores and the P @ V product are fp32 SIMT
// FMAs (no tensor cores yet: a later PR moves QK^T and PV onto mma), 8
// threads own a row and reduce its max and sum with warp shuffles.  When
// that grid is too small to fill the card (decode: batch x kv-heads
// blocks), the keys are also split over blocks and a second kernel merges
// the partial softmax states (flash-decoding).

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
          int nsplit, int chunk, float* __restrict__ part) {
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
  // KV tiles past both limits of the tile's last row are skipped
  int kend = klen;
  if (causal) kend = min(kend, qoff + min(Sq - 1, (R0 + BQ - 1) / g) + 1);
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
      const bool vis = kp < klen && (!causal || kp <= qpos);
      s[t] = vis ? dot * scale : NEG_INF;
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
                      cudaStream_t stream) {
  const int rows_total = Sq * (nh / nkv), tiles = (Sk + BK - 1) / BK;
  const int chunk = (tiles + nsplit - 1) / nsplit * BK;
  dim3 grid((rows_total + BQ - 1) / BQ * nsplit, nkv, B);
  T* op = static_cast<T*>(o);
  flash_fwd<T, DH><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), op, q_off,
      kv_len, nh, nkv, Sq, Sk, st, causal, scale, nsplit, chunk, part);
  if (nsplit > 1)
    flash_combine<T, DH><<<dim3(rows_total, nkv, B), DH, 0, stream>>>(part, op, nh, nkv, Sq,
                                                                       nsplit, st);
}

template <typename T>
static void launch(const void* q, const void* k, const void* v, void* o, const int* q_off,
                   const int* kv_len, int B, int nh, int nkv, int Sq, int Sk, int dh,
                   const Strides& st, int causal, float scale, int nsplit, float* part,
                   cudaStream_t stream) {
  if (dh == 64)
    launch_dh<T, 64>(q, k, v, o, q_off, kv_len, B, nh, nkv, Sq, Sk, st, causal, scale, nsplit,
                     part, stream);
  else
    launch_dh<T, 128>(q, k, v, o, q_off, kv_len, B, nh, nkv, Sq, Sk, st, causal, scale, nsplit,
                      part, stream);
}

extern "C" {

// q_off / kv_len: int32 [B] on the device, or null (0 / Sk).  Strides are
// in elements.  nsplit > 1 splits the keys over blocks and needs ``part``:
// B * nkv * Sq * (nh / nkv) * nsplit * (dh + 2) floats.  Returns a
// cudaError_t (cudaErrorInvalidValue for a dh the kernel does not take).
int hk_flash_attention(const void* q, const void* k, const void* v, void* o,
                       const void* q_off, const void* kv_len, int B, int nh, int nkv,
                       int Sq, int Sk, int dh, long long qb, long long qh, long long qs,
                       long long kb, long long kh, long long ks, long long vb, long long vh,
                       long long vs, long long ob, long long oh, long long os, int causal,
                       float scale, int nsplit, void* part, int dtype, void* stream) {
  if (dh != 64 && dh != 128) return (int)cudaErrorInvalidValue;
  if (nsplit < 1 || (nsplit > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qo = static_cast<const int*>(q_off);
  const int* kl = static_cast<const int*>(kv_len);
  float* pp = static_cast<float*>(part);
  if (dtype == DT_BF16)
    launch<bf16>(q, k, v, o, qo, kl, B, nh, nkv, Sq, Sk, dh, st, causal, scale, nsplit, pp, s);
  else
    launch<float>(q, k, v, o, qo, kl, B, nh, nkv, Sq, Sk, dh, st, causal, scale, nsplit, pp, s);
  return (int)cudaGetLastError();
}

const char* hk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
