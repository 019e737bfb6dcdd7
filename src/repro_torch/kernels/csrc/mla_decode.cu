// Hand-written Hopper (sm_90a) kernels of the port: the absorbed decode of
// multi-head latent attention (MLA, minicpm3-4b).
//
// They replace no pallas_call: the JAX package's decode form of apply_mla
// (repro/models/attention.py:511-523) is plain einsums.  The function is
// row 3's (flash attention) with one latent kv head that all nh query heads
// share, a key of DK = L + R = 256 + 32 and a value of L = 256:
//     s[h, t] = (q_lat[h] . c_kv[t] + q_rope[h] . k_rope[t]) * scale
//     s[h, t] = -1e30 where t >= kv_len[b]
//     o_lat[h] = softmax_t(s[h]) . c_kv            (fp32 out)
// A row with kv_len 0 sees no key: every score is -1e30, so it averages
// all T rows of c_kv, as the JAX softmax does.
//
// Layout: q_lat [B, nh, L], q_rope [B, nh, R], c_kv [B, T, L], k_rope
// [B, T, R], each by element strides (batch, head or position) with its
// last dim contiguous, so the gathered cache goes in without a
// concatenation (c_kv and k_rope may be two tensors); kv_len int32 [B];
// o_lat fp32 [B, nh, L] contiguous.  nh up to 64, any T.
//
// Bound on an H100 SXM: decode reads each slot's visible latent rows once,
// kv_len * (L + R) * 2 bytes per layer in bf16 (a few hundred KB at the
// serving tick: ~0.2 us at 3.35 TB/s), and does 2 * kv_len * nh * (DK + L)
// operations, far less of the tensor cores' rate.  So the bytes bound it,
// and one launch takes several times that bound: what the kernel has to
// cut is latency, the chain of dependent steps from the first load to the
// last store.  Both routes split the keys over blocks (flash decoding: each
// block writes its unnormalised accumulator, max and sum, and mla::combine
// merges them), so a row's chain is one or two key tiles long; the combine
// is launched programmatically (its launch overlaps the decode's run) and
// issues the loads of 8 splits at once.
//
// * bf16 on the tensor cores (mla::decode_wgmma, the route for every bf16
//   launch TMA can address).  One block per (key split, batch row): all nh
//   query heads are the 64 rows of one wgmma (rows past nh zero), staged
//   once as [q_lat | q_rope] in shared memory, 128-byte swizzled.  A
//   producer warp loads 64-key tiles by TMA into a ring of NST stages, a
//   stage the four 64-column halves of the c_kv tile and the k_rope tile
//   (its box 64 wide over a 32-wide map: TMA zero-fills columns 32..63, and
//   no product reads them) under one mbarrier; keys past T read as 0 and
//   are masked.  One consumer warpgroup computes S = Q K^T with m64n64k16
//   wgmma, 18 k-steps over DK 288, K-major from the staged tile; the online
//   softmax in fp32 registers, in log2 units (as tc::fwd); then O += P V
//   with V the same tile's c_kv halves read MN-major: each latent tile
//   leaves device memory once and feeds both products, the point of the
//   absorbed form.  P is the register A operand, split into two bf16
//   halves (hi = bf16(p), lo = bf16(p - hi)) each multiplied into the same
//   fp32 accumulators by two m64n128k16 products, so P V keeps the fp32
//   bound (one bf16 P adds ~2^-9 relative a term); O, 64 x 256 fp32, is 128
//   registers a thread.  Per tile that is 18 + 16 wgmma, where the SIMT
//   route runs a chain of dependent fp32 FMAs and shared loads.
// * SIMT, fp32 FMAs (mla::decode: fp32 inputs, held to 2e-4, which a bf16
//   product cannot meet; and any bf16 layout TMA refuses).  One block per
//   (key split, batch row): it stages every query head's [q_lat | q_rope]
//   row in shared memory once, then walks its keys in tiles of 32, each
//   latent row read ONCE for all nh heads.  Each staging issues all of a
//   thread's 16-byte loads before its first store, so their latencies
//   overlap.  Per tile: the [c_kv | k_rope] rows are staged as fp32 (rows
//   padded to 292 floats, so the 16-byte loads of 8 lanes on 8 keys hit
//   distinct banks); a warp owns heads w, w + 8, ..., a lane one key, and
//   computes their scores; the running max and sum of each head live in
//   that warp's registers (shuffle reductions over the 32 keys); the
//   probabilities go to shared memory.  Then a thread owns 4 latent dims
//   of the heads g, g + 4, ... (g = tid / 64): it rescales its
//   accumulators by each head's alpha and adds p[t, h] * c_kv[t, dims], 16
//   FMAs per two 16-byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// Let the combine that follows a decode launch be scheduled now (it waits in
// griddepcontrol.wait until this grid's writes are visible).
__device__ __forceinline__ void release_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
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

  release_dependents();
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
// splits' partial softmax states, CMB splits at a time (their loads issued
// together, then one online merge), so a merge of n splits waits on
// ceil(n / CMB) loads in turn, not 2n.
constexpr int CMB = 8;
__global__ void __launch_bounds__(L) combine(const float* __restrict__ part, float* __restrict__ o,
                                            int nh, int nsplit) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the decode's partials are visible
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const float* pp = part + ((size_t)b * nh + h) * nsplit * PART;
  float m = NEG_INF, l = 0.f, acc = 0.f;
  for (int s0 = 0; s0 < nsplit; s0 += CMB) {
    float ms[CMB], ls[CMB], as[CMB];
#pragma unroll
    for (int i = 0; i < CMB; ++i) {
      const bool in = s0 + i < nsplit;
      const float* q = pp + (size_t)(s0 + i) * PART;
      ms[i] = in ? q[L] : NEG_INF;
      ls[i] = in ? q[L + 1] : 0.f;
      as[i] = in ? q[d] : 0.f;
    }
    float mx = m;
#pragma unroll
    for (int i = 0; i < CMB; ++i) mx = fmaxf(mx, ms[i]);
    const float r = expf(m - mx);  // rescale what the earlier chunks merged
    l *= r;
    acc *= r;
#pragma unroll
    for (int i = 0; i < CMB; ++i) {
      const float w = expf(ms[i] - mx);
      l += ls[i] * w;
      acc += as[i] * w;
    }
    m = mx;
  }
  o[((size_t)b * nh + h) * L + d] = l > 0.f ? acc / l : 0.f;
}

// The combine of a split launch, launched programmatically after the decode on the same
// stream, so its launch latency overlaps the decode's run.
static void launch_combine(const Args& a, int B, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nh, B);
  cfg.blockDim = dim3(L);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, combine, static_cast<const float*>(a.part), a.o, a.nh, a.nsplit);
}

template <typename T>
static int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_floats(a.nh) * sizeof(float);
  cudaFuncSetAttribute(decode<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  decode<T><<<dim3(a.nsplit, B), THREADS, smem, stream>>>(a);
  if (a.nsplit > 1) launch_combine(a, B, stream);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: 64 query rows against 64-key tiles staged by TMA
// ---------------------------------------------------------------------------
using namespace hopper;

constexpr int TBN = 64;                 // keys of a tile (the S product's N)
constexpr int TBM = 64;                 // query rows of a block (one wgmma's M): heads
constexpr int HALVES = 5;               // 64-column halves of a row: c_kv 4, k_rope 1
constexpr int HALF = TBN * 128;         // bytes of one half of a tile (== of Q's)
constexpr int TST = HALVES * HALF;      // bytes of a stage
constexpr int NST = 3;                  // stages of the ring
constexpr int TC_THREADS = 160;         // one consumer warpgroup + one producer warp
constexpr size_t TC_SMEM = 1024 + HALVES * TBM * 128 + NST * TST + 2 * NST * 8;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
static_assert(TBM == TBN && TC_SMEM <= 232448, "Q's halves are a tile's; one block fits");

__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); }

// Q = [q_lat | q_rope] of every head of row b into HALVES halves of TBM x 128 bytes in the
// 128-byte swizzle (row r = head r; rows past nh and the rope half's columns 32..63 are 0):
// all of a thread's 16-byte loads are issued before its first store.
__device__ __forceinline__ void stage_q(uint8_t* dst, const bf16* ql, long long qlh,
                                        const bf16* qr, long long qrh, int nh, int tid) {
  constexpr int CH = HALVES * 8, N = TBM * CH / 128;  // 16-byte chunks of a row; per thread
  uint4 raw[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int i = tid + u * 128, r = i / CH, cc = i % CH;
    raw[u] = make_uint4(0u, 0u, 0u, 0u);
    if (r < nh && cc < (L + R) / 8)
      raw[u] = cc < L / 8 ? *reinterpret_cast<const uint4*>(ql + r * qlh + cc * 8)
                          : *reinterpret_cast<const uint4*>(qr + r * qrh + (cc - L / 8) * 8);
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int i = tid + u * 128, r = i / CH, cc = i % CH;
    *reinterpret_cast<uint4*>(dst + (cc / 8) * HALF + r * 128 + (((cc % 8) ^ (r & 7)) << 4)) =
        raw[u];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
}

__global__ void __launch_bounds__(TC_THREADS, 1)
decode_wgmma(const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap rmap,
             const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1k(smem_raw);
  uint8_t* KV = Qs + HALVES * HALF;  // stage s at KV + s TST: c_kv halves 0..3, k_rope half 4
  uint64_t* full = reinterpret_cast<uint64_t*>(KV + NST * TST);
  uint64_t* empty = full + NST;

  release_dependents();
  const int tid = threadIdx.x, split = blockIdx.x, b = blockIdx.y, nh = a.nh;
  const int klen = min(a.kv_len[b], a.T);
  const bool none = klen <= 0;  // kv_len 0: every key counts with score 0
  const int kbeg = split * a.chunk;
  const int kend = min(none ? a.T : klen, kbeg + a.chunk);
  const int ntiles = kbeg < kend ? (kend - kbeg + TBN - 1) / TBN : 0;

  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= 128) {  // the producer warp: a tile's four c_kv boxes and its k_rope box
    if (tid == 128)
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % NST, k0 = kbeg + t * TBN;
        if (t >= NST) bar_wait(&empty[s], (t / NST - 1) & 1);
        bar_expect(&full[s], TST);
#pragma unroll
        for (int hf = 0; hf < L / 64; ++hf)
          tma_load(KV + s * TST + hf * HALF, &cmap, &full[s], hf * 64, k0, 0, b);
        tma_load(KV + s * TST + (L / 64) * HALF, &rmap, &full[s], 0, k0, 0, b);
      }
    return;
  }

  if (ntiles > 0)
    stage_q(Qs, static_cast<const bf16*>(a.q_lat) + b * a.qlb, a.qlh,
            static_cast<const bf16*>(a.q_rope) + b * a.qrb, a.qrh, nh, tid);
  consumers_sync();
  // this thread's rows (heads) ra and ra + 8; its columns 8i + cb, 8i + cb + 1 of each product
  const int lane = tid % 32, ra = (tid / 32) * 16 + lane / 4, cb = 2 * (lane % 4);
  const float sl2 = a.scale * LOG2E;  // scores in log2 units
  const uint32_t qaddr = saddr(Qs);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc0[64], acc1[64];  // latent 0..127, 128..
  zero(acc0);
  zero(acc1);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % NST, k0 = kbeg + t * TBN;
    const uint32_t kaddr = saddr(KV + s * TST);
    float sc[TBN / 2];
    zero(sc);
    bar_wait(&full[s], (t / NST) & 1);
    wg_fence();
#pragma unroll
    for (int k = 0; k < (L + R) / 16; ++k)  // 18 k-steps: 16 over c_kv, 2 over k_rope
      wgmma_ss_n64(sc, desc(qaddr + (k / 4) * HALF + (k % 4) * 32, 16),
                   desc(kaddr + (k / 4) * HALF + (k % 4) * 32, 16), k);
    wg_commit();
    wg_wait<0>();
    keep(sc);

    const bool straddle = k0 + TBN > kend;  // only the split's last tile holds masked keys
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < TBN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = none ? 0.f : sc[4 * i + 2 * h + e] * sl2;
          if (straddle && k0 + 8 * i + cb + e >= kend) x = NEG_INF;
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
    for (int i = 0; i < TBN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sc[4 * i + 2 * h + e] - m[h]);
          l[h] += p;
          sc[4 * i + 2 * h + e] = p;
        }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc0[i] *= alpha[(i % 4) / 2];
      acc1[i] *= alpha[(i % 4) / 2];
    }
    // P as the register A operand in two bf16 halves: hi = bf16(p), lo = bf16(p - hi)
    uint32_t ph[TBN / 4], pl[TBN / 4];
#pragma unroll
    for (int j = 0; j < TBN / 4; ++j) {
      __nv_bfloat162 hi = __floats2bfloat162_rn(sc[2 * j], sc[2 * j + 1]);
      const float2 hf = __bfloat1622float2(hi);
      __nv_bfloat162 lo = __floats2bfloat162_rn(sc[2 * j] - hf.x, sc[2 * j + 1] - hf.y);
      ph[j] = *reinterpret_cast<uint32_t*>(&hi);
      pl[j] = *reinterpret_cast<uint32_t*>(&lo);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TBN / 16; ++kk) {  // V = the tile's c_kv halves, MN-major
      const uint64_t d0 = desc(kaddr + kk * 2048, HALF);
      const uint64_t d1 = desc(kaddr + 2 * HALF + kk * 2048, HALF);
      wgmma_rs_n128(acc0, &ph[4 * kk], d0);
      wgmma_rs_n128(acc1, &ph[4 * kk], d1);
      wgmma_rs_n128(acc0, &pl[4 * kk], d0);
      wgmma_rs_n128(acc1, &pl[4 * kk], d1);
    }
    wg_commit();
    wg_wait<0>();
    keep(acc0);
    keep(acc1);
    keep(ph);
    keep(pl);
    if (tid == 0) bar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int hh = ra + 8 * h;
    if (hh >= nh) continue;
    float* row;
    float inv = 1.f;
    if (a.nsplit > 1) {  // the partial state, its max in natural units as mla::combine reads it
      row = a.part + (((size_t)b * nh + hh) * a.nsplit + split) * PART;
      if (lane % 4 == 0) {
        row[L] = m[h] * LN2;
        row[L + 1] = l[h];
      }
    } else {
      row = a.o + ((size_t)b * nh + hh) * L;
      inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      *reinterpret_cast<float2*>(row + 8 * i + cb) =
          make_float2(acc0[4 * i + 2 * h] * inv, acc0[4 * i + 2 * h + 1] * inv);
      *reinterpret_cast<float2*>(row + 128 + 8 * i + cb) =
          make_float2(acc1[4 * i + 2 * h] * inv, acc1[4 * i + 2 * h + 1] * inv);
    }
  }
}

// c_kv and k_rope as 4-D TMA maps (latent or rope columns, T positions, one head, B rows), a
// box 64 columns x TBN keys; then the decode and, with a key split, the combine.
static int launch_tc(const Args& a, int B, cudaStream_t stream) {
  CUtensorMap cm, rm;
  if (!tensor_map(&cm, a.c_kv, L, a.T, 1, B, a.cb, a.ct, a.ct, TBN) ||
      !tensor_map(&rm, a.k_rope, R, a.T, 1, B, a.rb, a.rt, a.rt, TBN))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(decode_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TC_SMEM);
  decode_wgmma<<<dim3(a.nsplit, B), TC_THREADS, TC_SMEM, stream>>>(cm, rm, a);
  if (a.nsplit > 1) launch_combine(a, B, stream);
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

// The bf16 tensor-core route (mla::decode_wgmma): the contract of hk_mla_decode for bf16,
// with the keys split over nsplit blocks of whole 64-key tiles.  c_kv and k_rope are read by
// TMA: their addresses and strides must be 16-byte multiples (cudaErrorInvalidValue for a
// layout cuTensorMapEncodeTiled refuses).
int hk_mla_decode_tc(const void* q_lat, const void* q_rope, const void* c_kv, const void* k_rope,
                     const void* kv_len, void* o, int B, int nh, int T, int L, int R,
                     long long qlb, long long qlh, long long qrb, long long qrh, long long cb,
                     long long ct, long long rb, long long rt, float scale, int nsplit,
                     void* part, void* stream) {
  if (L != mla::L || R != mla::R || nh < 1 || nh > mla::TBM || T < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  if (nsplit < 1 || (nsplit > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
  const int tiles = (T + mla::TBN - 1) / mla::TBN;
  const mla::Args a{q_lat, q_rope, c_kv, k_rope, static_cast<const int*>(kv_len),
                    static_cast<float*>(o), static_cast<float*>(part), nh, T, nsplit,
                    (tiles + nsplit - 1) / nsplit * mla::TBN, qlb, qlh, qrb, qrh, cb, ct, rb, rt,
                    scale};
  return mla::launch_tc(a, B, static_cast<cudaStream_t>(stream));
}

const char* hk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
