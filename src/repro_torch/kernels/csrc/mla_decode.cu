// Hand-written Hopper (sm_90a) kernel of the port: the absorbed decode of
// multi-head latent attention (MLA, minicpm3-4b).
//
// It replaces the einsums of the JAX package's decode form of apply_mla
// (repro/models/attention.py:511-523), which have no pallas_call of their
// own: the same function as the flash-attention forward (row 3), softmax
// attention of nh query heads against ONE latent kv head that they all
// share, with a key of DK = L + R = 256 + 32 and a value of L = 256:
//     s[h, t] = (q_lat[h] . c_kv[t] + q_rope[h] . k_rope[t]) * scale
//     s[h, t] = -1e30 where t >= kv_len[b]
//     o_lat[h] = softmax_t(s[h]) . c_kv            (fp32 out)
// A row with kv_len 0 sees no key: every score is -1e30, so it averages
// all T rows of c_kv, as the JAX softmax does.
//
// Layout: q_lat [B, nh, L], q_rope [B, nh, R], c_kv [B, T, L], k_rope
// [B, T, R], each by element strides (batch, head or position) with its
// last dim contiguous, so the gathered cache goes in without a
// concatenation; kv_len int32 [B]; o_lat fp32 [B, nh, L] contiguous.
// fp32 or bf16 inputs, any T; nh up to 64.
//
// SIMT, fp32 FMAs.  One block per (key split, batch row): it stages every
// query head's [q_lat | q_rope] row in shared memory once, then walks its
// keys in tiles of 32, each latent row read ONCE for all nh heads (the
// point of the absorbed form).  Each staging issues all of a thread's
// 16-byte loads before its first store, so their latencies overlap.  Per
// tile: the [c_kv | k_rope] rows are staged as fp32 (rows padded to 292
// floats, so the 16-byte loads of 8 lanes on 8 keys hit distinct banks); a warp owns heads w, w + 8, ...,
// a lane one key, and computes their scores; the running max and sum of
// each head live in that warp's registers (shuffle reductions over the
// 32 keys); the probabilities go to shared memory.  Then a thread owns 4
// latent dims of the heads g, g + 4, ... (g = tid / 64): it rescales its
// accumulators by each head's alpha and adds p[t, h] * c_kv[t, dims],
// 16 FMAs per two 16-byte loads.  When batch x splits would not fill the
// card twice, the keys are split over blocks, each writing its
// unnormalised accumulator with its max and sum, and a second kernel
// merges them (the flash-decoding combine of flash_attention.cu).
//
// Bound on an H100 SXM: decode reads each slot's visible latent rows once,
// kv_len * (L + R) * 2 bytes per layer in bf16, and does 2 * kv_len * nh *
// (DK + L) operations; a tensor-core design is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

enum { DT_F32 = 0, DT_BF16 = 1 };

namespace mla {

constexpr int L = 256, R = 32, DK = L + R;  // latent (value) dims, rope dims, key dims
constexpr int BT = 32;                      // keys per tile: one per lane
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int HMAX = 64;                    // query heads a block takes
constexpr int KP = DK + 4;                  // a staged key row, padded (floats)
constexpr int HG = THREADS / (L / 4);       // head groups of the output mapping (4)
constexpr int HPG = HMAX / HG;              // heads a group holds at most (16)
constexpr int HPW = HMAX / WARPS;           // heads a warp scores at most (8)
constexpr int PART = L + 4;                 // a split's partial row: acc, max, sum, pad
constexpr float NEG_INF = -1e30f;

// 16 bytes of T widened to fp32
template <typename T>
__device__ __forceinline__ void widen(const uint4& v, float* o);
template <>
__device__ __forceinline__ void widen<float>(const uint4& v, float* o) {
  o[0] = __uint_as_float(v.x);
  o[1] = __uint_as_float(v.y);
  o[2] = __uint_as_float(v.z);
  o[3] = __uint_as_float(v.w);
}
template <>
__device__ __forceinline__ void widen<bf16>(const uint4& v, float* o) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// Rows [a | b] (a L wide, b R wide, row strides as, bs) into shared memory
// as fp32 rows ``pitch`` floats apart: every 16-byte load of the block is
// issued before the first store, so their latencies overlap.  Rows from
// ``valid`` to ``rows`` stage zeros (keys past T).
template <typename T, int MAXROWS>
__device__ __forceinline__ void stage(float* dst, int pitch, int rows, int valid, const T* a,
                                      long long as, const T* b, long long bs) {
  constexpr int VEC = 16 / sizeof(T), PER = DK / VEC;
  constexpr int N = (MAXROWS * PER + THREADS - 1) / THREADS;
  uint4 raw[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int i = threadIdx.x + u * THREADS, r = i / PER, d = (i % PER) * VEC;
    raw[u] = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && r < valid)
      raw[u] = d < L ? *reinterpret_cast<const uint4*>(a + r * as + d)
                     : *reinterpret_cast<const uint4*>(b + r * bs + (d - L));
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int i = threadIdx.x + u * THREADS, r = i / PER, d = (i % PER) * VEC;
    if (r < rows) {
      float v[VEC];
      widen<T>(raw[u], v);
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(dst + r * pitch + d + e) =
            make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
    }
  }
}

struct Args {
  const void *q_lat, *q_rope, *c_kv, *k_rope;
  const int* kv_len;
  float *o, *part;
  int nh, T, nsplit, chunk;
  long long qlb, qlh, qrb, qrh, cb, ct, rb, rt;  // element strides
  float scale;
};

__host__ __device__ constexpr size_t smem_floats(int nh) {
  return (size_t)nh * DK + BT * KP + BT * HG * HPG + 3 * HMAX;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) decode(const Args a) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [nh][DK]
  float* Ks = Qs + (size_t)a.nh * DK;            // [BT][KP]
  float* Ps = Ks + BT * KP;                      // [BT][HG][HPG]: head h at (h % HG, h / HG)
  float* alpha_s = Ps + BT * HG * HPG;           // [HMAX]
  float* m_s = alpha_s + HMAX;
  float* l_s = m_s + HMAX;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, b = blockIdx.y, nh = a.nh;
  const int klen = min(a.kv_len[b], a.T);
  // kv_len 0: every key counts with the same score, the uniform average
  const bool empty = klen <= 0;
  const int kbeg = split * a.chunk;
  const int kend = min(empty ? a.T : klen, kbeg + a.chunk);

  const T* ql = static_cast<const T*>(a.q_lat) + b * a.qlb;
  const T* qr = static_cast<const T*>(a.q_rope) + b * a.qrb;
  const T* ck = static_cast<const T*>(a.c_kv) + b * a.cb;
  const T* kr = static_cast<const T*>(a.k_rope) + b * a.rb;

  if (kbeg < kend) stage<T, HMAX>(Qs, DK, nh, nh, ql, a.qlh, qr, a.qrh);  // else no key here
  for (int i = tid; i < BT * HG * HPG; i += THREADS) Ps[i] = 0.f;  // heads >= nh stay 0

  // score mapping: warp w scores heads w + WARPS * j for its lane's key
  const int nsj = (nh - warp + WARPS - 1) / WARPS;
  float m_run[HPW], l_run[HPW];
#pragma unroll
  for (int j = 0; j < HPW; ++j) {
    m_run[j] = NEG_INF;
    l_run[j] = 0.f;
  }
  // output mapping: dims dq .. dq + 3 of heads hg + HG * j
  const int hg = tid / (L / 4), dq = (tid % (L / 4)) * 4;
  const int nj = (nh - hg + HG - 1) / HG;
  float4 acc[HPG];
#pragma unroll
  for (int j = 0; j < HPG; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = kbeg; k0 < kend; k0 += BT) {
    __syncthreads();  // Q staged / the previous tile consumed
    stage<T, BT>(Ks, KP, BT, a.T - k0, ck + k0 * a.ct, a.ct, kr + k0 * a.rt, a.rt);
    __syncthreads();

    float s[HPW];
#pragma unroll
    for (int j = 0; j < HPW; ++j) s[j] = 0.f;
    const float* krow = Ks + lane * KP;
    for (int d = 0; d < DK; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int j = 0; j < HPW; ++j) {
        if (j < nsj) {
          const float4 q4 = *reinterpret_cast<const float4*>(Qs + (warp + WARPS * j) * DK + d);
          s[j] += q4.x * k4.x + q4.y * k4.y + q4.z * k4.z + q4.w * k4.w;
        }
      }
    }
    // keys past kend are masked; the tile's first key is always visible
    const bool vis = k0 + lane < kend;
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      if (j < nsj) {
        const int h = warp + WARPS * j;
        const float sc = vis ? (empty ? 0.f : s[j] * a.scale) : NEG_INF;
        float mx = sc;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_run[j], mx);
        const float p = expf(sc - m_new);
        float sum = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float alpha = expf(m_run[j] - m_new);
        l_run[j] = l_run[j] * alpha + sum;
        m_run[j] = m_new;
        Ps[lane * (HG * HPG) + (h % HG) * HPG + h / HG] = p;
        if (lane == 0) alpha_s[h] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < HPG; ++j) {
      if (j < nj) {
        const float al = alpha_s[hg + HG * j];
        acc[j].x *= al;
        acc[j].y *= al;
        acc[j].z *= al;
        acc[j].w *= al;
      }
    }
    for (int t = 0; t < BT; ++t) {
      const float4 c = *reinterpret_cast<const float4*>(Ks + t * KP + dq);
      const float* prow = Ps + t * (HG * HPG) + hg * HPG;
#pragma unroll
      for (int j4 = 0; j4 < HPG; j4 += 4) {
        if (j4 < nj) {
          const float4 p = *reinterpret_cast<const float4*>(prow + j4);
          const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[j4 + e].x += pv[e] * c.x;
            acc[j4 + e].y += pv[e] * c.y;
            acc[j4 + e].z += pv[e] * c.z;
            acc[j4 + e].w += pv[e] * c.w;
          }
        }
      }
    }
  }

  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      if (j < nsj) {
        m_s[warp + WARPS * j] = m_run[j];
        l_s[warp + WARPS * j] = l_run[j];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < HPG; ++j) {
    if (j < nj) {
      const int h = hg + HG * j;
      if (a.nsplit > 1) {
        float* pp = a.part + (((size_t)b * nh + h) * a.nsplit + split) * PART;
        *reinterpret_cast<float4*>(pp + dq) = acc[j];
        if (dq == 0) {
          pp[L] = m_s[h];
          pp[L + 1] = l_s[h];
        }
      } else {
        const float l = l_s[h], inv = l > 0.f ? 1.f / l : 0.f;
        *reinterpret_cast<float4*>(a.o + ((size_t)b * nh + h) * L + dq) =
            make_float4(acc[j].x * inv, acc[j].y * inv, acc[j].z * inv, acc[j].w * inv);
      }
    }
  }
}

// One block per (head, batch row), one thread per latent dim: merge the
// splits' partial softmax states.
__global__ void __launch_bounds__(L) combine(const float* __restrict__ part, float* __restrict__ o,
                                            int nh, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const float* pp = part + ((size_t)b * nh + h) * nsplit * PART;
  float m = NEG_INF;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, pp[s * PART + L]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(pp[s * PART + L] - m);
    l += pp[s * PART + L + 1] * w;
    acc += pp[s * PART + d] * w;
  }
  o[((size_t)b * nh + h) * L + d] = l > 0.f ? acc / l : 0.f;
}

template <typename T>
static int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_floats(a.nh) * sizeof(float);
  cudaFuncSetAttribute(decode<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  decode<T><<<dim3(a.nsplit, B), THREADS, smem, stream>>>(a);
  if (a.nsplit > 1) combine<<<dim3(a.nh, B), L, 0, stream>>>(a.part, a.o, a.nh, a.nsplit);
  return (int)cudaGetLastError();
}

}  // namespace mla

extern "C" {

// o_lat (fp32 [B, nh, L], contiguous) of the absorbed MLA decode.  Strides
// are in elements; kv_len is int32 [B] on the device.  nsplit > 1 splits
// the keys over blocks and needs ``part``: B * nh * nsplit * (L + 4)
// floats.  Returns a cudaError_t (cudaErrorInvalidValue for dims the
// kernel does not take).
int hk_mla_decode(const void* q_lat, const void* q_rope, const void* c_kv, const void* k_rope,
                  const void* kv_len, void* o, int B, int nh, int T, int L, int R,
                  long long qlb, long long qlh, long long qrb, long long qrh, long long cb,
                  long long ct, long long rb, long long rt, float scale, int nsplit, void* part,
                  int dtype, void* stream) {
  if (L != mla::L || R != mla::R || nh < 1 || nh > mla::HMAX || T < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  if (nsplit < 1 || (nsplit > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  const int tiles = (T + mla::BT - 1) / mla::BT;
  const mla::Args a{q_lat, q_rope, c_kv, k_rope, static_cast<const int*>(kv_len),
                    static_cast<float*>(o), static_cast<float*>(part), nh, T, nsplit,
                    (tiles + nsplit - 1) / nsplit * mla::BT, qlb, qlh, qrb, qrh, cb, ct, rb, rt,
                    scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == DT_BF16 ? mla::launch<bf16>(a, B, s) : mla::launch<float>(a, B, s);
}

const char* hk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
