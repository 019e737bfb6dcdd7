// Hand-written Hopper (sm_90a) ring collective-matmul kernels of the port.
//
// Replaces the TPU kernels in repro/kernels/ring_matmul.py, each of which
// runs a whole ring collective inside one pallas_call with remote DMA
// between neighbouring chips:
//   * _ag_matmul_tpu (pallas_call at :896, def :746): x [b,t,h] circulates
//     over the n ranks of one grid axis; at step s this rank multiplies the
//     shard of rank (me - s) mod n by its local w [h,o] into that rank's
//     slot of out [b, n*t, o]                         -> hk_ring_ag_matmul
//   * _matmul_rs_tpu (pallas_call at :1118, def :916; the gated pair
//     _matmul_rs_pair_tpu:1308 runs it over [w1 | w1b]): x [b,t,h] @ w
//     [h,o] reduce-scattered over tokens (out [b, t/n, o]) or columns (out
//     [b, t, o/n]) by a per-destination accumulator that circulates and
//     gains this rank's contribution at every step    -> hk_ring_matmul_rs
//   * _ag_matmul_contract_tpu (pallas_call at :1290, def :1135): x
//     [b,t,h_loc] circulates; w [n*h_loc, o] row block picked by the
//     shard's source rank; an fp32 accumulator spans the steps
//                                                     -> hk_ring_ag_matmul_contract
// Every product sums in fp32; outputs are stored in the input dtype (the
// contracted ring may store fp32), as the Pallas kernels do.
//
// The int8 wire (comm_dtype="int8", the same three pallas_call sites with
// `quant` set: _ag_matmul_tpu :766/:864, _matmul_rs_tpu :955/:1033-1064,
// _ag_matmul_contract_tpu :1154/:1251) moves, per hop, an int8 payload and
// one fp32 scale per row (per row half for the gated pair) under the same
// landed/credit handshake: one copy writes both into the slot, one release
// publishes them.
//   * hk_ring_ag_matmul_int8 / hk_ring_ag_matmul_contract_int8: the shard is
//     quantized once, by a kernel of its own (quant_pair, a warp a row) on
//     the stream just before the ring kernel, on every route, and circulates
//     unchanged; a tile of an arriving shard dequantizes (q * scale, fp32,
//     then the input dtype) on its way into the product (the tile loop as it
//     loads; the wgmma route in registers between TMA and wgmma, wg.cuh); this
//     rank's own shard is used as it is (the emulated ring's step 0); the
//     contracted ring's fp32 accumulator never quantizes.
//   * hk_ring_matmul_rs_int8: the accumulator changes every hop and its row
//     scale needs the whole row, so each step folds dequant(arriving) + this
//     step's tile, each rounded to the input dtype, into a full-width buffer,
//     then a grid-wide barrier (every block is resident) lets the blocks
//     quantize whole rows into the right neighbour's slot, on both routes.
//     Only the hop is int8; the buffer, the fp32 tiles and the output are not.
// Quantization is core/quant.quant_int8's: scale = max|x| / 127 by an IEEE
// division (1 for a zero row), rint (half to even), clipped to +-127 (one
// function, quant_rows, a warp a row, for the pair and the RS's hops alike, on
// every route); build.py passes no fast-math flag, and the dequantizing product
// is __fmul_rn so it is never contracted into an FMA.
//
// The ring protocol.  The ranks are processes on one or more cards; each
// owns a symmetric buffer (hk_sym_alloc) that every peer maps through its
// CUDA IPC handle (hk_sym_open).  Per grid axis the buffer holds two
// receive slots and two 64-bit counters: `landed` (hops that have landed in
// this rank's slots, set by the left neighbour) and `credit` (hops of this
// rank's that the right neighbour has finished reading).  Hop h of an axis
// (a host-side count that every rank of the ring advances alike, n - 1 per
// call) moves one shard into the right neighbour's slot h % 2.  Before
// writing it a rank waits until credit >= h - 1 (the right neighbour has
// released the slot's previous contents, hop h - 2); after writing, the
// last of its blocks to finish stores landed = h + 1 into the right
// neighbour with st.release.sys.  A rank that needs hop h spins with
// ld.acquire.sys until landed >= h + 1, and once every block has read the
// slot (and forwarded it) stores credit = h + 1 into its left neighbour.
// The counters only grow, so back-to-back calls need no host reset.  This
// is the TPU kernel's handshake (barrier semaphore, per-slot DMA
// semaphores, a capacity credit to the left neighbour) with flags in
// device memory in place of semaphores.  A block that spins would block
// the blocks behind it, so the grid is at most one block per SM (all
// resident) and each block loops over the output tiles.  Every wait gives
// up after a timeout with a trap, so a lost peer fails the launch instead
// of hanging the card.
//
// Bound on an H100 SXM: per call 2 * rows * h * o * n FLOPs at 989 TFLOP/s
// bf16 against the operand, output and hop bytes at 3.35 TB/s (an int8 hop:
// the payload plus 4 bytes of scale per row).
//
// Two product loops.  Every ring kernel, on either wire, whose bf16 operands
// TMA can address takes the tensor cores (route wgmma, namespace ringtc below:
// wg::mm's TMA-fed wgmma main loop, wg.cuh).  Every other launch runs the
// simple tile loop (64 x 64 output tiles, a K step of 32 through shared
// memory, WMMA m16n16k16 for bf16 (route wmma) and SIMT fp32 (route simt),
// masked edges, any extent).  The wrapper
// (kernels/ring_matmul.py, ring_impl) picks the route from the dtype, shapes
// and strides alone.  Every host entry takes a block cap: 0 keeps one block an
// SM at most (the process ring); a loopback ring of n streams in one process
// passes its share of the card, so that all n grids are resident at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "wg.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef unsigned long long u64;

enum { DT_F32 = 0, DT_BF16 = 1 };
// the routes of AG-matmul and matmul-RS, as kernels/ring_matmul.py::IMPLS numbers them
enum { RING_WGMMA = 0, RING_WMMA = 1, RING_SIMT = 2 };

namespace {

constexpr int TBM = 64, TBN = 64, TBK = 32, THREADS = 256;
constexpr int LDA = TBK + 8, LDB = TBN + 8, LDC = TBN + 4;
constexpr int MAX_STEPS = 16;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// loads that bypass L1: slots are rewritten by other processes while a
// kernel runs, and an SM's L1 is not coherent with those writes
template <typename T> __device__ __forceinline__ T ldcg(const T* p);
template <> __device__ __forceinline__ float ldcg<float>(const float* p) { return __ldcg(p); }
template <> __device__ __forceinline__ bf16 ldcg<bf16>(const bf16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ u64 now_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct Ring {
  u64* my_landed;
  u64* right_landed;
  u64* my_credit;
  u64* left_credit;
  char* my_slot[2];
  char* right_slot[2];
  unsigned int* counters;  // 2 per step, then 1 per step (grid barriers); zeroed per launch
  u64 hop0;
  int n, me;
  u64 timeout_ns;
};

// one thread spins, then the block proceeds (called by every thread)
__device__ void wait_geq(const u64* p, u64 target, u64 timeout_ns) {
  if (threadIdx.x == 0) {
    const u64 t0 = now_ns();
    while (ld_acquire(p) < target) {
      __nanosleep(200);
      if (now_ns() - t0 > timeout_ns) __trap();  // a lost peer: fail, do not hang
    }
    __threadfence();
  }
  __syncthreads();
}

// every thread's writes are fenced, then one count per block; true in the
// last block to arrive (called by every thread)
__device__ bool arrive_last(unsigned int* counter) {
  __shared__ bool last;
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int old = atomicAdd(counter, 1u);
    last = old == gridDim.x - 1;
    if (last) __threadfence_system();
  }
  __syncthreads();
  return last;
}

// threads tid, tid + stride, ... copy a shard into a peer's slot (read around
// L1); a thread keeps COPY_DEPTH 16-byte loads in flight before it stores, so
// a hop's copy is not one memory latency per vector
constexpr int COPY_DEPTH = 8;
__device__ void copy_part(void* dst, const void* src, long long bytes, long long tid,
                          long long stride) {
  if ((((uintptr_t)dst | (uintptr_t)src | (uintptr_t)bytes) & 15) == 0) {
    uint4* __restrict__ d = reinterpret_cast<uint4*>(dst);
    const uint4* __restrict__ s = reinterpret_cast<const uint4*>(src);
    const long long n = bytes / 16;
    long long i = tid;
    for (; i + (COPY_DEPTH - 1) * stride < n; i += COPY_DEPTH * stride) {
      uint4 v[COPY_DEPTH];
#pragma unroll
      for (int j = 0; j < COPY_DEPTH; ++j) v[j] = __ldcg(s + i + j * stride);
#pragma unroll
      for (int j = 0; j < COPY_DEPTH; ++j) d[i + j * stride] = v[j];
    }
    for (; i < n; i += stride) d[i] = __ldcg(s + i);
  } else {
    unsigned short* d = reinterpret_cast<unsigned short*>(dst);
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    for (long long i = tid; i < bytes / 2; i += stride) d[i] = __ldcg(s + i);
  }
}

// the grid copies a shard into a peer's slot
__device__ void grid_copy(void* dst, const void* src, long long bytes) {
  copy_part(dst, src, bytes, (long long)blockIdx.x * blockDim.x + threadIdx.x,
            (long long)gridDim.x * blockDim.x);
}

// row r of an operand lies at (r / R) * bstride + (r % R) * ld elements:
// a batch of R-row blocks (a token chunk of every batch row)
struct Rows {
  long long bstride;
  int R, ld;
  __device__ __forceinline__ long long off(int r) const {
    return (long long)(r / R) * bstride + (long long)(r % R) * ld;
  }
};

// A loaders: element (r, k) of the left operand in the compute dtype
template <typename T>
struct LoadRows {                 // a T operand whose rows lie as `ra` says
  const T* a;
  Rows ra;
  __device__ __forceinline__ T operator()(int r, int k) const { return ldcg(a + ra.off(r) + k); }
};
template <typename T>
struct LoadDequant {              // an int8 payload [rows, ld] and its fp32 row scales
  const signed char* q;
  const float* scale;
  int ld;
  __device__ __forceinline__ T operator()(int r, int k) const {
    // one fp32 product, never contracted into an FMA, then the compute dtype
    return from_f<T>(__fmul_rn((float)__ldcg(q + (long long)r * ld + k), __ldcg(scale + r)));
  }
};

// C = A[m0:m0+64, :K] @ B[:K, n0:n0+64] in fp32; epi(r, c, v) for every
// in-range element.  A through the loader `la`, B row-major with leading dim ldb.
template <typename T, typename LoadA, typename Epi>
__device__ void tile_product(LoadA la, const T* b, long long ldb, int M, int N, int K, int m0,
                             int n0, unsigned char* smem, Epi epi) {
  float* Cs = reinterpret_cast<float*>(smem);
  unsigned char* ops = smem + TBM * LDC * sizeof(float);
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, bf16>::value) {
    bf16* As = reinterpret_cast<bf16*>(ops);
    bf16* Bs = As + TBM * LDA;
    const int warp = tid / 32, wm = warp / 2, wn = warp % 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int k0 = 0; k0 < K; k0 += TBK) {
      for (int i = tid; i < TBM * TBK; i += THREADS) {
        const int r = i / TBK, c = i % TBK;
        As[r * LDA + c] = (m0 + r < M && k0 + c < K) ? la(m0 + r, k0 + c) : __float2bfloat16(0.f);
      }
      for (int i = tid; i < TBK * TBN; i += THREADS) {
        const int r = i / TBN, c = i % TBN;
        Bs[r * LDB + c] = (k0 + r < K && n0 + c < N) ? ldcg(b + (long long)(k0 + r) * ldb + n0 + c)
                                                     : __float2bfloat16(0.f);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, As + (16 * wm) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Bs + kk * LDB + 32 * wn + 16 * j, LDB);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (16 * wm) * LDC + 32 * wn + 16 * j, acc[j], LDC,
                              wmma::mem_row_major);
  } else {
    float* As = reinterpret_cast<float*>(ops);      // [TBM][TBK + 1]
    float* Bs = As + TBM * (TBK + 1);               // [TBK][TBN + 1]
    const int tr = tid / 16, tc = tid % 16;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += TBK) {
      for (int i = tid; i < TBM * TBK; i += THREADS) {
        const int r = i / TBK, c = i % TBK;
        As[r * (TBK + 1) + c] = (m0 + r < M && k0 + c < K) ? la(m0 + r, k0 + c) : 0.f;
      }
      for (int i = tid; i < TBK * TBN; i += THREADS) {
        const int r = i / TBN, c = i % TBN;
        Bs[r * (TBN + 1) + c] =
            (k0 + r < K && n0 + c < N) ? ldcg(b + (long long)(k0 + r) * ldb + n0 + c) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < TBK; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[(tr * 4 + i) * (TBK + 1) + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[k * (TBN + 1) + tc * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(tr * 4 + i) * LDC + tc * 4 + j] = acc[i][j];
  }
  __syncthreads();
  for (int i = tid; i < TBM * TBN; i += THREADS) {
    const int r = i / TBN, c = i % TBN;
    if (m0 + r < M && n0 + c < N) epi(m0 + r, n0 + c, Cs[r * LDC + c]);
  }
  __syncthreads();
}

constexpr int SMEM_BYTES = TBM * LDC * 4 + (TBM * (TBK + 1) + TBK * (TBN + 1)) * 4;
static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory");
static_assert((TBM * LDA + TBK * LDB) * 2 <= (TBM * (TBK + 1) + TBK * (TBN + 1)) * 4, "smem");

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// the shard that circulates at step s: x itself, or the slot of hop hop0+s-1
template <typename T>
__device__ const T* step_input(const T* x, const Ring& rg, int s) {
  if (s == 0) return x;
  const u64 hin = rg.hop0 + s - 1;
  wait_geq(rg.my_landed, hin + 1, rg.timeout_ns);
  return reinterpret_cast<const T*>(rg.my_slot[hin & 1]);
}

// forward the current shard to the right neighbour (hop hop0+s)
__device__ void forward_shard(const void* cur, long long bytes, const Ring& rg, int s) {
  const u64 h = rg.hop0 + s;
  if (h >= 2) wait_geq(rg.my_credit, h - 1, rg.timeout_ns);
  grid_copy(rg.right_slot[h & 1], cur, bytes);
  if (arrive_last(&rg.counters[2 * s]) && threadIdx.x == 0) st_release(rg.right_landed, h + 1);
}

// every block has read the slot of hop hop0+s-1: credit the left neighbour
__device__ void release_slot(const Ring& rg, int s) {
  if (arrive_last(&rg.counters[2 * s + 1]) && threadIdx.x == 0)
    st_release(rg.left_credit, rg.hop0 + s);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ring_ag_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, Ring rg,
                   int b, int t, int h, int o) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int M = b * t, tn = cdiv(o, TBN), ntiles = cdiv(M, TBM) * tn;
  const Rows ra{(long long)t * h, t, h};
  for (int s = 0; s < rg.n; ++s) {
    const int src = (rg.me - s + rg.n) % rg.n;
    const T* cur = step_input(x, rg, s);
    if (s < rg.n - 1) forward_shard(cur, (long long)M * h * sizeof(T), rg, s);
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      tile_product<T>(LoadRows<T>{cur, ra}, w, o, M, o, h, (tile / tn) * TBM, (tile % tn) * TBN,
                      smem, [&](int r, int c, float v) {
                        const long long row = (long long)(r / t) * rg.n * t + (long long)src * t + r % t;
                        out[row * o + c] = from_f<T>(v);
                      });
    }
    if (s > 0) release_slot(rg, s);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ring_rs_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, Ring rg,
                   int b, int t, int h, int o, int scatter_last) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int n = rg.n;
  const int chunk = scatter_last ? o / n : t / n;
  const int M = scatter_last ? b * t : b * chunk, N = scatter_last ? chunk : o;
  const Rows ra{(long long)t * h, scatter_last ? t : chunk, h};
  const int tn = cdiv(N, TBN), ntiles = cdiv(M, TBM) * tn;
  for (int s = 0; s < n; ++s) {
    const int dest = (rg.me + n - 1 - s) % n;
    const T* in = s > 0 ? step_input(x, rg, s) : nullptr;     // the arriving accumulator
    T* dst = out;
    if (s < n - 1) {
      const u64 hout = rg.hop0 + s;
      if (hout >= 2) wait_geq(rg.my_credit, hout - 1, rg.timeout_ns);
      dst = reinterpret_cast<T*>(rg.right_slot[hout & 1]);
    }
    const T* a = scatter_last ? x : x + (long long)dest * chunk * h;
    const T* bw = scatter_last ? w + (long long)dest * chunk : w;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      tile_product<T>(LoadRows<T>{a, ra}, bw, o, M, N, h, (tile / tn) * TBM, (tile % tn) * TBN,
                      smem,
                      [&](int r, int c, float v) {
                        const long long i = (long long)r * N + c;
                        float acc = to_f<T>(from_f<T>(v));   // the contribution, stored
                        if (in) acc = to_f<T>(ldcg(in + i)) + acc;
                        dst[i] = from_f<T>(acc);
                      });
    }
    if (s < n - 1 && arrive_last(&rg.counters[2 * s]) && threadIdx.x == 0)
      st_release(rg.right_landed, rg.hop0 + s + 1);
    if (s > 0) release_slot(rg, s);
  }
}

template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS)
    ring_contract_kernel(const T* __restrict__ x, const T* __restrict__ w, TO* __restrict__ out,
                         float* __restrict__ acc, Ring rg, int m, int hl, int o) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int n = rg.n, tn = cdiv(o, TBN), ntiles = cdiv(m, TBM) * tn;
  const Rows ra{0, 0x7fffffff, hl};
  for (int s = 0; s < n; ++s) {
    const int src = (rg.me - s + n) % n;
    const T* cur = step_input(x, rg, s);
    if (s < n - 1) forward_shard(cur, (long long)m * hl * sizeof(T), rg, s);
    const T* ws = w + (long long)src * hl * o;
    const bool first = s == 0, last = s == n - 1;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      tile_product<T>(LoadRows<T>{cur, ra}, ws, o, m, o, hl, (tile / tn) * TBM, (tile % tn) * TBN,
                      smem,
                      [&](int r, int c, float v) {
                        const long long i = (long long)r * o + c;
                        const float a = first ? v : acc[i] + v;
                        if (last) out[i] = from_f<TO>(a);
                        else acc[i] = a;
                      });
    }
    if (s > 0) release_slot(rg, s);
  }
}

// ---------------------------------------------------------------------------
// the int8 wire (comm_dtype="int8"): a hop moves the pair (int8 payload, fp32
// scale per row segment) instead of the shard; one copy and one release
// publish both, so a receiver never reads new scales with an old payload
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ long long align16(long long v) { return (v + 15) & ~15LL; }

// bytes of the pair of a [rows, cols] shard with `nseg` scales a row: the
// payload, then the scales, each padded to 16 bytes
__host__ __device__ __forceinline__ long long qpair_bytes(long long rows, long long cols,
                                                          int nseg) {
  return align16(rows * cols) + align16(4 * rows * nseg);
}

__device__ __forceinline__ unsigned int ld_acquire_gpu(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the grid arrives before any goes on, by one thread after a barrier of the
// threads whose writes it publishes; sound because every block is resident (one an SM, or the
// loopback's cap).  `counter` is zeroed before the launch.
__device__ __forceinline__ void grid_sync(unsigned int* counter, u64 timeout_ns) {
  __threadfence();
  atomicAdd(counter, 1u);
  const u64 t0 = now_ns();
  while (ld_acquire_gpu(counter) < gridDim.x) {
    __nanosleep(100);
    if (now_ns() - t0 > timeout_ns) __trap();
  }
  __threadfence();
}

// grid_sync called by every thread of the block
__device__ void grid_barrier(unsigned int* counter, u64 timeout_ns) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) grid_sync(counter, timeout_ns);
  __syncthreads();
}

__device__ __forceinline__ signed char quant1(float v, float sc) {
  return (signed char)fminf(fmaxf(rintf(v / sc), -127.f), 127.f);  // an IEEE division
}

// eight bf16 values quantized by `sc` and stored as eight int8 at q
__device__ __forceinline__ void quant8(const uint4& p, float sc, signed char* q) {
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&p);
  uint32_t word[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(v[j]);
    word[j / 2] |= ((uint32_t)(uint8_t)quant1(f.x, sc) << (16 * (j % 2))) |
                   ((uint32_t)(uint8_t)quant1(f.y, sc) << (16 * (j % 2) + 8));
  }
  *reinterpret_cast<uint2*>(q) = make_uint2(word[0], word[1]);
}

// Quantize rows of src [M, N] into the pair at q / scale, a warp a row: warp `wid` of the
// `nw` taking part quantizes rows wid, wid + nw, ...  Per row segment ([0, split), [split,
// N); one segment when split is 0) scale = max|x| / 127 (1 for a zero segment) and q =
// rint(x / scale) clipped to 127, as core/quant.quant_int8 (a max is exact in any order, so
// the integers do not depend on who takes part).  src was written by other blocks: read
// around L1, twice (its max, then its quantization): a bf16 row whose segments lie on 16 bytes
// 8 elements a lane, any other one element a lane.
template <typename T>
__device__ void quant_rows(const T* src, int M, int N, int split, signed char* q, float* scale,
                           int wid, int nw) {
  const int lane = threadIdx.x % 32, nseg = split > 0 ? 2 : 1;
  bool vec = false;
  if constexpr (std::is_same<T, bf16>::value)
    vec = N % 8 == 0 && split % 8 == 0 && ((uintptr_t)src & 15) == 0 && ((uintptr_t)q & 7) == 0;
  for (int r = wid; r < M; r += nw) {
    const T* row = src + (long long)r * N;
    signed char* qr = q + (long long)r * N;
    for (int g = 0; g < nseg; ++g) {
      const int c0 = g == 0 ? 0 : split, c1 = nseg == 2 && g == 0 ? split : N;
      float m = 0.f;
      if (vec) {
        for (int c = c0 + 8 * lane; c < c1; c += 256) {
          const uint4 p = __ldcg(reinterpret_cast<const uint4*>(row + c));
          const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&p);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(v[j]);
            m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
          }
        }
      } else {
        for (int c = c0 + lane; c < c1; c += 32) m = fmaxf(m, fabsf(to_f<T>(ldcg(row + c))));
      }
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float sc = m > 0.f ? m / 127.f : 1.f;      // an IEEE division, as in PyTorch
      if (vec) {
        for (int c = c0 + 8 * lane; c < c1; c += 256)
          quant8(__ldcg(reinterpret_cast<const uint4*>(row + c)), sc, qr + c);
      } else {
        for (int c = c0 + lane; c < c1; c += 32) qr[c] = quant1(to_f<T>(ldcg(row + c)), sc);
      }
      if (lane == 0) scale[(long long)r * nseg + g] = sc;
    }
  }
}

// The int8 AG kernels' pair: x [M, h] quantized into `pair` (the payload, then an fp32
// scale a row at align16(M h)), a warp a row, on the stream before the ring kernel that
// circulates it.
constexpr int WARPS = THREADS / 32;
template <typename T>
__global__ void __launch_bounds__(THREADS)
    quant_pair(const T* __restrict__ x, unsigned char* __restrict__ pair, int M, int h) {
  quant_rows<T>(x, M, h, 0, reinterpret_cast<signed char*>(pair),
                reinterpret_cast<float*>(pair + align16((long long)M * h)),
                blockIdx.x * WARPS + threadIdx.x / 32, gridDim.x * WARPS);
}

// AG-matmul over the int8 wire: x [b,t,h] is this rank's own shard, used as
// it is at step 0; `pair` is x quantized once (quant_pair, before the ring
// kernel), which is what circulates.  A tile of an arriving shard dequantizes as it loads.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ring_ag_int8_kernel(const T* __restrict__ x, const unsigned char* __restrict__ pair,
                        const T* __restrict__ w, T* __restrict__ out, Ring rg, int b, int t,
                        int h, int o) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int M = b * t, tn = cdiv(o, TBN), ntiles = cdiv(M, TBM) * tn;
  const Rows ra{(long long)t * h, t, h};
  const long long bytes = qpair_bytes(M, h, 1), soff = align16((long long)M * h);
  for (int s = 0; s < rg.n; ++s) {
    const int src = (rg.me - s + rg.n) % rg.n;
    const unsigned char* cur = step_input(pair, rg, s);
    if (s < rg.n - 1) forward_shard(cur, bytes, rg, s);
    auto epi = [&](int r, int c, float v) {
      const long long row = (long long)(r / t) * rg.n * t + (long long)src * t + r % t;
      out[row * o + c] = from_f<T>(v);
    };
    const LoadDequant<T> deq{reinterpret_cast<const signed char*>(cur),
                             reinterpret_cast<const float*>(cur + soff), h};
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int m0 = (tile / tn) * TBM, n0 = (tile % tn) * TBN;
      if (s == 0) tile_product<T>(LoadRows<T>{x, ra}, w, o, M, o, h, m0, n0, smem, epi);
      else tile_product<T>(deq, w, o, M, o, h, m0, n0, smem, epi);
    }
    if (s > 0) release_slot(rg, s);
  }
}

// matmul-RS over the int8 wire.  The accumulator changes at every hop, and
// a row's scale needs the whole row: every step folds dequant(arriving
// pair) + this step's tile, each rounded to T, into a full-width T buffer
// (out and work in turn, the last step's being out); a grid-wide barrier
// then lets the blocks quantize whole rows of it straight into the right
// neighbour's slot.  Two buffers: a block that is still quantizing step s's
// rows reads a buffer that nobody folds into before the barrier of step s+1.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ring_rs_int8_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                        T* __restrict__ work, Ring rg, int b, int t, int h, int o,
                        int scatter_last, int split) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int n = rg.n;
  const int chunk = scatter_last ? o / n : t / n;
  const int M = scatter_last ? b * t : b * chunk, N = scatter_last ? chunk : o;
  const Rows ra{(long long)t * h, scatter_last ? t : chunk, h};
  const int tn = cdiv(N, TBN), ntiles = cdiv(M, TBM) * tn;
  const int nseg = split > 0 ? 2 : 1;
  const long long soff = align16((long long)M * N);
  for (int s = 0; s < n; ++s) {
    const int dest = (rg.me + n - 1 - s) % n;
    const unsigned char* in = s > 0 ? step_input<unsigned char>(nullptr, rg, s) : nullptr;
    const signed char* inq = reinterpret_cast<const signed char*>(in);
    const float* ins = in ? reinterpret_cast<const float*>(in + soff) : nullptr;
    T* acc = ((n - 1 - s) & 1) ? work : out;
    const T* a = scatter_last ? x : x + (long long)dest * chunk * h;
    const T* bw = scatter_last ? w + (long long)dest * chunk : w;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      tile_product<T>(LoadRows<T>{a, ra}, bw, o, M, N, h, (tile / tn) * TBM, (tile % tn) * TBN,
                      smem, [&](int r, int c, float v) {
                        const long long i = (long long)r * N + c;
                        float y = to_f<T>(from_f<T>(v));       // the contribution, stored
                        if (in) {                               // + the arriving accumulator
                          const int g = split > 0 && c >= split;
                          const float sc = __ldcg(ins + (long long)r * nseg + g);
                          y = to_f<T>(from_f<T>(__fmul_rn((float)__ldcg(inq + i), sc))) + y;
                        }
                        acc[i] = from_f<T>(y);
                      });
    }
    if (s < n - 1) {
      grid_barrier(&rg.counters[2 * MAX_STEPS + s], rg.timeout_ns);
      if (s > 0) release_slot(rg, s);
      const u64 hout = rg.hop0 + s;
      if (hout >= 2) wait_geq(rg.my_credit, hout - 1, rg.timeout_ns);
      unsigned char* dst = reinterpret_cast<unsigned char*>(rg.right_slot[hout & 1]);
      quant_rows<T>(acc, M, N, split, reinterpret_cast<signed char*>(dst),
                    reinterpret_cast<float*>(dst + soff), blockIdx.x * WARPS + threadIdx.x / 32,
                    gridDim.x * WARPS);
      if (arrive_last(&rg.counters[2 * s]) && threadIdx.x == 0)
        st_release(rg.right_landed, hout + 1);
    } else if (s > 0) {
      release_slot(rg, s);
    }
  }
}

// the contracted AG-matmul over the int8 wire: as ring_ag_int8_kernel, with
// the fp32 accumulator across steps (never quantized)
template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS)
    ring_contract_int8_kernel(const T* __restrict__ x, const unsigned char* __restrict__ pair,
                              const T* __restrict__ w, TO* __restrict__ out,
                              float* __restrict__ acc, Ring rg, int m, int hl, int o) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  const int n = rg.n, tn = cdiv(o, TBN), ntiles = cdiv(m, TBM) * tn;
  const Rows ra{0, 0x7fffffff, hl};
  const long long bytes = qpair_bytes(m, hl, 1), soff = align16((long long)m * hl);
  for (int s = 0; s < n; ++s) {
    const int src = (rg.me - s + n) % n;
    const unsigned char* cur = step_input(pair, rg, s);
    if (s < n - 1) forward_shard(cur, bytes, rg, s);
    const T* ws = w + (long long)src * hl * o;
    const bool first = s == 0, last = s == n - 1;
    auto epi = [&](int r, int c, float v) {
      const long long i = (long long)r * o + c;
      const float a = first ? v : acc[i] + v;
      if (last) out[i] = from_f<TO>(a);
      else acc[i] = a;
    };
    const LoadDequant<T> deq{reinterpret_cast<const signed char*>(cur),
                             reinterpret_cast<const float*>(cur + soff), hl};
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int m0 = (tile / tn) * TBM, n0 = (tile % tn) * TBN;
      if (first) tile_product<T>(LoadRows<T>{x, ra}, ws, o, m, o, hl, m0, n0, smem, epi);
      else tile_product<T>(deq, ws, o, m, o, hl, m0, n0, smem, epi);
    }
    if (s > 0) release_slot(rg, s);
  }
}

__global__ void pingpong_kernel(u64* my_flag, u64* peer_flag, int rounds, int role, u64 base,
                                u64 timeout_ns, long long* elapsed_ns) {
  const u64 t0 = now_ns();
  for (int r = 0; r < rounds; ++r) {
    const u64 ping = base + 2 * r + 1, pong = base + 2 * r + 2;
    if (role == 0) {
      st_release(peer_flag, ping);
      const u64 ts = now_ns();
      while (ld_acquire(my_flag) < pong)
        if (now_ns() - ts > timeout_ns) __trap();
    } else {
      const u64 ts = now_ns();
      while (ld_acquire(my_flag) < ping)
        if (now_ns() - ts > timeout_ns) __trap();
      st_release(peer_flag, pong);
    }
  }
  *elapsed_ns = (long long)(now_ns() - t0);
}

int sm_count() {
  int dev = 0, n = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// the host array of ring arguments: my_landed, right_landed, my_credit,
// left_credit, my_slot0, my_slot1, right_slot0, right_slot1, counters,
// hop0, n, me, timeout_ns
Ring unpack(const u64* a) {
  Ring r;
  r.my_landed = reinterpret_cast<u64*>(a[0]);
  r.right_landed = reinterpret_cast<u64*>(a[1]);
  r.my_credit = reinterpret_cast<u64*>(a[2]);
  r.left_credit = reinterpret_cast<u64*>(a[3]);
  r.my_slot[0] = reinterpret_cast<char*>(a[4]);
  r.my_slot[1] = reinterpret_cast<char*>(a[5]);
  r.right_slot[0] = reinterpret_cast<char*>(a[6]);
  r.right_slot[1] = reinterpret_cast<char*>(a[7]);
  r.counters = reinterpret_cast<unsigned int*>(a[8]);
  r.hop0 = a[9];
  r.n = (int)a[10];
  r.me = (int)a[11];
  r.timeout_ns = a[12];
  return r;
}

int grid_for(int tiles) {
  const int g = tiles < sm_count() ? tiles : sm_count();
  return g > 0 ? g : 1;
}

int grid_cap(int tiles, int blocks) {
  if (blocks <= 0) return grid_for(tiles);
  return tiles < 1 ? 1 : (tiles < blocks ? tiles : blocks);
}

}  // namespace

// ---------------------------------------------------------------------------
// AG-matmul, matmul-RS and the contracted AG-matmul, on the bf16 wire and the int8 wire, in
// bf16 on Hopper's tensor cores (route wgmma).
//
// The product of every ring step is wg::mm's main loop (wg.cuh): persistent
// blocks of three warpgroups, 128 x 128 output tiles (BN 128: 64 fp32
// accumulators a consumer thread, so no register reallocation is needed), a
// ring of six 32 KB stages of 64-deep k-blocks that one producer thread fills
// by TMA (128-byte swizzle, edges read as zeros), two consumer warpgroups on
// wgmma m64n128k16, the epilogue staged in shared memory and stored a 16-byte
// chunk of a row at a time (epilogue below).
// A step's work units are its output tiles; the stage ring and its phases run
// on across the steps.  The ring protocol is the WMMA kernels' (above), with
// each part of it moved to the warps that need it:
//   * ag_wgmma: the producer waits for hop hop0+s-1 to land (an acquire load),
//     then fence.proxy.async.global, because the peer wrote the slot with
//     generic stores and TMA reads it through the async proxy; step s's A map
//     is x's (s = 0) or the slot's (the two slots' maps are encoded once per
//     address and shape on the host).  Warps 1-3 of the producer warpgroup
//     forward the shard to the right neighbour's slot (generic 16-byte stores,
//     so the peer's protocol is unchanged) while the consumers multiply, and
//     their last block to finish publishes `landed`.  The left neighbour gets
//     its credit once every block's copy warps are done with the slot and
//     every block's consumers have waited for its last TMA loads of it (their
//     `full` mbarriers): loads that completed, not loads that were issued.
//     Row r of a step lands at (r / t) n t + src t + r % t of out.
//   * ag_wgmma<true> (the int8 wire): the same block.  What circulates is the
//     pair (int8 payload, then an fp32 scale a row), which quant_pair
//     writes from x just before, as on the tile loop; the copy warps forward
//     it as they forward a bf16 shard; step 0 multiplies x itself through x's bf16 map.  At a step
//     s >= 1 the producer TMA-loads the slot's payload as int8 boxes of 128
//     rows x 64 bytes (8 KB, in the stage's A region; the stage's `full`
//     barrier expects their bytes), and each consumer warpgroup dequantizes
//     its 64 rows straight into wgmma's A fragment in registers (wg.cuh,
//     mma_unit_q) and runs the m64n128k16 product with A from registers and B
//     from the stage.  Register A needs no bf16 copy of the tile: six 32 KB
//     stages and the epilogue's staging stay as they are (230,528 bytes, one
//     block an SM), where a bf16 copy beside the int8 box would have cut the
//     ring to four stages.  The row scales are read once a unit, around L1,
//     after the unit's first stage has landed; both consumer warpgroups meet
//     before the credit, which covers their scale reads.
//   * contract_wgmma<Q8>: step s multiplies the shard of rank me - s by w's
//     row block of that rank, one map of w [n hl, o] read src hl rows on.  On
//     the bf16 wire (Q8 false) the shard is x or the slot's bf16 shard, which
//     the copy warps forward as ag_wgmma's do; on the int8 wire x at step 0,
//     then the arriving pair through the dequantizing stage.  A block that
//     owns at most one output tile keeps its 64 fp32 sums a thread in
//     registers across all n steps and stores once; otherwise each step adds
//     its sums into an fp32 buffer in device memory, as the tile loop does.
//   * rs_wgmma: the producer needs no flag (A is x, B is w).  The consumers
//     run each step's main loop first and wait for `landed` (the arriving
//     accumulator) and `credit` (the right neighbour's slot is free) only
//     before the step's first epilogue, so a hop's latency hides behind the
//     step's products.  The epilogue keeps the WMMA kernel's arithmetic bit for
//     bit: the contribution rounded to bf16, plus the arriving bf16 partial in
//     fp32, rounded once, into the right neighbour's slot (or out at the last
//     step); over tokens, A's 128-row box stays inside the destination chunk
//     (the route takes chunk % 128 == 0).
//   * rs_int8_wgmma (the int8 wire): rs_wgmma's producer, main loop and wait
//     for `landed` after the step's first main loop.  The fold is the tile
//     loop's arithmetic: bf16(bf16(q s) + bf16(contribution)), the product by
//     __fmul_rn and the sum in fp32, rounded once, from an 8-byte read of the
//     arriving payload per 16-byte output chunk and the row segment's scale,
//     into a full-width bf16 buffer (work and out in turn; out at the last
//     step).  After the step's folds a grid barrier; then the credit for the
//     right neighbour's slot, and the consumer warps and the producer
//     warpgroup's idle warps 1-3 quantize whole rows of the buffer into it,
//     a warp a row (quant_rows); the last block publishes `landed`.  The left
//     neighbour's credit follows the barrier (every block's folds, the last
//     reads of the arriving pair, are done).
// Every wait (flags and mbarriers) traps after the ring's spin timeout.  The
// flags' loads, stores and fences take the .gpu scope when every peer lies on
// this card (peers_local: the loopback ring, rank processes sharing a card) and
// .sys otherwise; a block publishes its writes with one fence, by the thread
// that counts its arrival after a barrier of the writers.  One block an SM
// (230,528 bytes of shared memory), so the grid is resident whenever it is at
// most the SM count, or the caller's block cap.
// ---------------------------------------------------------------------------
namespace ringtc {
using namespace hopper;

constexpr int BM = wg::BM, BK = wg::BK, BN = 128, THREADS = wg::THREADS;
using Tl = wg::Tile<BN>;
// a consumer warpgroup's 64 x BN bf16 tile, staged for the epilogue's coalesced stores
constexpr int EPI_BYTES = 64 * BN * 2;
constexpr int EPI_OFFSET = (Tl::NST * Tl::STAGE + 2 * Tl::NST * 8 + 127) / 128 * 128;
constexpr size_t SMEM = 1024 + EPI_OFFSET + 2 * EPI_BYTES;
static_assert(SMEM <= 232448, "shared memory of a block");
constexpr int COPY_THREADS = 96;                      // warps 1-3: the forward copy
constexpr int QUANT_WARPS = 11;                       // rs_int8_wgmma: all but the producer's
// named barriers (0 is __syncthreads): the consumers, the copy warps, each consumer warpgroup
// (3 and 4), the quantizing warps
enum { BAR_CONSUMERS = 1, BAR_COPY = 2, BAR_WG = 3, BAR_QUANT = 5 };

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The flags' memory scope: .gpu when every peer of the ring lies on this card
// (the loopback ring, or rank processes sharing one card), else .sys.  The
// system scope costs the loopback ring of two ~25% of a call.
__device__ __forceinline__ u64 acquire(const u64* p, bool local) {
  if (!local) return ld_acquire(p);
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void release(u64* p, u64 v, bool local) {
  if (local)
    asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
  else
    st_release(p, v);
}
__device__ __forceinline__ void fence(bool local) {
  if (local)
    __threadfence();
  else
    __threadfence_system();
}

// one thread spins until *p >= target (trap after timeout_ns)
__device__ __forceinline__ void spin_geq(const u64* p, u64 target, u64 timeout_ns, bool local) {
  const u64 t0 = now_ns();
  while (acquire(p, local) < target) {
    __nanosleep(100);
    if (now_ns() - t0 > timeout_ns) __trap();
  }
  __threadfence();
}

// one count of this block toward `target` arrivals, by one thread after a barrier of the
// threads whose writes it publishes (the barrier orders their writes before its fence, as
// a grid barrier does); true in the last arrival
__device__ __forceinline__ bool arrive_one(unsigned int* counter, unsigned int target,
                                           bool local) {
  fence(local);
  const bool last = atomicAdd(counter, 1u) == target - 1;
  if (last) fence(local);
  return last;
}

// an mbarrier wait that traps after the ring's timeout (a stage may wait on a peer)
struct RingWait {
  u64 timeout_ns;
  __device__ __forceinline__ void operator()(uint64_t* b, int parity) const {
    if (bar_try(b, parity)) return;
    const u64 t0 = now_ns();
    while (!bar_try(b, parity))
      if (now_ns() - t0 > timeout_ns) __trap();
  }
};

__device__ __forceinline__ void init_stages(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < Tl::NST; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 2);  // one arrival from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The epilogue of consumer warpgroup c's 64 rows of a tile (first row m0, first column
// n0) from its fp32 sums: each sum rounded to bf16 into the warpgroup's staging buffer
// (64 rows of 16-byte chunks, a row's chunks XOR-swizzled by the row so that neither
// phase has bank conflicts), then a 16-byte chunk a thread, row by row: the chunk of row
// m (m0 + m < M) at column col (n0.. < N, N a multiple of 8), eight bf16 values, goes
// through fold(m, col, chunk), which adds the arriving row's values in place (or
// nothing), to dst(m) + col.  The stores of a warp cover whole 256-byte row segments
// where the register layout would scatter 4-byte pairs over eight rows.
template <typename Dst, typename Fold>
__device__ __forceinline__ void epilogue(const float (&acc)[BN / 2], uint8_t* buf, int c, int tt,
                                         int m0, int n0, int M, int N, Dst dst, Fold fold) {
  const int lane = tt % 32, r0 = (tt / 32) * 16 + lane / 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(buf + r * (BN * 2) + ((i ^ (r & 7)) << 4) +
                                         (lane % 4) * 4) =
          __floats2bfloat162_rn(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
  }
  named_sync(BAR_WG + c, 128);
  constexpr int CHUNKS = BN / 8;                      // 16-byte chunks a row
#pragma unroll 4
  for (int k = tt; k < 64 * CHUNKS; k += 128) {
    const int r = k / CHUNKS, ch = k % CHUNKS, m = m0 + r, col = n0 + 8 * ch;
    if (m >= M || col >= N) continue;
    uint4 v = *reinterpret_cast<const uint4*>(buf + r * (BN * 2) + ((ch ^ (r & 7)) << 4));
    fold(m, col, v);
    *reinterpret_cast<uint4*>(dst(m) + col) = v;
  }
  named_sync(BAR_WG + c, 128);                        // the buffer is free again
}

// the epilogue's folds: nothing arrives (AG-matmul), the bf16 wire's arriving partial, or the
// int8 wire's pair; each added in fp32 to the stored contribution and rounded once
struct NoFold {
  __device__ __forceinline__ void operator()(int, int, uint4&) const {}
};
struct FoldBf16 {                 // the arriving [., N] bf16 rows at `in` (none: nullptr)
  const bf16* in;
  int N;
  __device__ __forceinline__ void operator()(int m, int col, uint4& v) const {
    if (in == nullptr) return;
    const uint4 p = __ldcg(reinterpret_cast<const uint4*>(in + (long long)m * N + col));
    const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&p);
    __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fa = __bfloat1622float2(a[j]), fy = __bfloat1622float2(y[j]);
      y[j] = __floats2bfloat162_rn(fa.x + fy.x, fa.y + fy.y);
    }
  }
};
struct FoldQ8 {                   // the arriving pair: int8 [., N] at q, nseg scales a row
  const signed char* q;           // (none: nullptr)
  const float* scale;
  int N, split, nseg;
  __device__ __forceinline__ void operator()(int m, int col, uint4& v) const {
    if (q == nullptr) return;
    const uint2 p = __ldcg(reinterpret_cast<const uint2*>(q + (long long)m * N + col));
    const float sc = __ldcg(scale + (long long)m * nseg + (split > 0 && col >= split));
    const signed char* qa = reinterpret_cast<const signed char*>(&p);
    __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // bf16(q s) from one fp32 product, never contracted into an FMA, as the tile loop's
      const float a0 = __bfloat162float(__float2bfloat16(__fmul_rn((float)qa[2 * j], sc)));
      const float a1 = __bfloat162float(__float2bfloat16(__fmul_rn((float)qa[2 * j + 1], sc)));
      const float2 fy = __bfloat1622float2(y[j]);
      y[j] = __floats2bfloat162_rn(a0 + fy.x, a1 + fy.y);
    }
  }
};

// The epilogue of consumer warpgroup c's 64 rows of a tile straight from its fp32 sums, two
// neighbouring columns a call: f(m, col, v0, v1) for row m0 + .. < M and col < N (N even).
template <typename F>
__device__ __forceinline__ void epilogue_pairs(const float (&acc)[BN / 2], int tt, int m0, int n0,
                                               int M, int N, F f) {
  const int lane = tt % 32, r0 = m0 + (tt / 32) * 16 + lane / 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = r0 + 8 * hh;
    if (m >= M) continue;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * (lane % 4);
      if (col < N) f(m, col, acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
    }
  }
}

// The producer's wait for hop hop0+s-1 and the A map of step s: x's (s = 0) or the slot's;
// the peer wrote the slot with generic stores and TMA reads it through the async proxy.
__device__ __forceinline__ const CUtensorMap* step_map(const Ring& rg, int s, bool local,
                                                       const CUtensorMap* xmap,
                                                       const CUtensorMap* smap0,
                                                       const CUtensorMap* smap1) {
  if (s == 0) return xmap;
  const u64 hin = rg.hop0 + s - 1;
  spin_geq(rg.my_landed, hin + 1, rg.timeout_ns, local);
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  return (hin & 1) ? smap1 : smap0;
}

// Warps 1-3 of an AG kernel's producer warpgroup: forward each step's shard (`own`, this
// rank's own, at step 0: x, or on the int8 wire its pair; then the slot of hop hop0+s-1),
// `bytes` of it, to the right neighbour's slot, the last block publishing `landed`; and count
// this block's copy done with each arriving slot toward the left neighbour's credit.
__device__ __forceinline__ void copy_warps(const void* own, long long bytes, const Ring& rg,
                                           bool local) {
  const int ct = threadIdx.x - 32;
  for (int s = 0; s < rg.n; ++s) {
    const char* cur = reinterpret_cast<const char*>(own);
    if (s > 0) {
      const u64 hin = rg.hop0 + s - 1;
      if (ct == 0) spin_geq(rg.my_landed, hin + 1, rg.timeout_ns, local);
      cur = rg.my_slot[hin & 1];
    }
    if (s < rg.n - 1) {
      const u64 hout = rg.hop0 + s;
      if (ct == 0 && hout >= 2) spin_geq(rg.my_credit, hout - 1, rg.timeout_ns, local);
      named_sync(BAR_COPY, COPY_THREADS);
      copy_part(rg.right_slot[hout & 1], cur, bytes, (long long)blockIdx.x * COPY_THREADS + ct,
                (long long)gridDim.x * COPY_THREADS);
      named_sync(BAR_COPY, COPY_THREADS);
      if (ct == 0 && arrive_one(&rg.counters[2 * s], gridDim.x, local))
        release(rg.right_landed, hout + 1, local);
    }
    // this block's copy warps are done with the slot of hop hop0+s-1
    if (s > 0 && ct == 0 && arrive_one(&rg.counters[2 * s + 1], 2 * gridDim.x, local))
      release(rg.left_credit, rg.hop0 + s, local);
  }
}

// The consumers' half of the left neighbour's credit after step s > 0: every TMA load of the
// slot in this block has completed (the consumers waited for each one's mbarrier) and, on the
// int8 wire (`q8`), both warpgroups have read their row scales from it.
__device__ __forceinline__ void consumers_done(const Ring& rg, int s, bool q8, bool local) {
  if (s == 0) return;
  if (q8) named_sync(BAR_CONSUMERS, 256);
  if (threadIdx.x == 128 && arrive_one(&rg.counters[2 * s + 1], 2 * gridDim.x, local))
    release(rg.left_credit, rg.hop0 + s, local);
}

// The AG-matmul; Q8: over the int8 wire, where `shard` is the pair (x quantized once) that
// circulates, the steps s >= 1 take their A through the dequantizing stage (wg.cuh), and step
// 0 multiplies x itself; else `shard` is x.
template <bool Q8>
__global__ void __launch_bounds__(THREADS, 1)
ag_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap smap0,
         const __grid_constant__ CUtensorMap smap1, const __grid_constant__ CUtensorMap wmap,
         const void* __restrict__ shard, bf16* __restrict__ out, Ring rg, int b, int t, int h,
         int o, int local) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Tl::NST * Tl::STAGE);
  uint64_t* empty = full + Tl::NST;
  const int n = rg.n, M = b * t;
  const int mt = cdiv(M, BM), nt = cdiv(o, BN), kbt = cdiv(h, BK), units = mt * nt;
  const RingWait wait{rg.timeout_ns};
  init_stages(full, empty);

  if (threadIdx.x < 128) {
    if (threadIdx.x == 0) {  // the producer
      int it = 0;
      for (int s = 0; s < n; ++s) {
        const CUtensorMap* am = step_map(rg, s, local, &xmap, &smap0, &smap1);
        const int ab = Q8 && s > 0 ? wg::A8_BYTES : wg::A_BYTES;
        for (int u = blockIdx.x; u < units; u += gridDim.x) {
          const wg::Unit w = wg::unit_at<BN>(u, mt, nt, 1, kbt, kbt);
          wg::load_unit<BN, false, false, false>(ring, full, empty, am, &wmap, &wmap, w.m0, w.n0,
                                                0, kbt, it, wait, ab);
        }
      }
    } else if (threadIdx.x >= 32) {
      copy_warps(shard, Q8 ? qpair_bytes(M, h, 1) : (long long)M * h * sizeof(bf16), rg, local);
    }
    return;
  }

  const int c = threadIdx.x / 128 - 1, tt = threadIdx.x % 128;
  uint8_t* buf = ring + EPI_OFFSET + c * EPI_BYTES;
  float acc[BN / 2], accb[BN / 2];  // accb: unused (the gated form's)
  int it = 0;
  for (int s = 0; s < n; ++s) {
    const int src = (rg.me - s + n) % n;
    // the arriving pair's row scales follow its payload
    const float* scale = reinterpret_cast<const float*>(
        rg.my_slot[(rg.hop0 + s - 1) & 1] + align16((long long)M * h));
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const wg::Unit w = wg::unit_at<BN>(u, mt, nt, 1, kbt, kbt);
      if (Q8 && s > 0)
        wg::mma_unit_q(ring, full, empty, acc, scale + w.m0, M - w.m0, 0, kbt, c, tt, it, wait);
      else
        wg::mma_unit<BN, false, false, false>(ring, full, empty, acc, accb, 0, kbt, c, tt, it,
                                              wait);
      // row m of the step lands at (m / t) n t + src t + m % t of out
      epilogue(acc, buf, c, tt, w.m0 + c * 64, w.n0, M, o,
               [&](int m) { return out + ((long long)(m / t) * n * t + (long long)src * t +
                                          m % t) * o; },
               NoFold{});
    }
    consumers_done(rg, s, Q8, local);
  }
}

// The contracted AG-matmul: `shard` circulates, x [m, hl] itself on the bf16 wire, or on the
// int8 wire (Q8) the pair (x quantized once); step s multiplies the shard of rank src = me - s
// (x at s = 0; then the slot's bf16 shard, or the arriving pair through the dequantizing
// stage) by w's row block [src hl, (src + 1) hl), one TMA map of w [n hl, o] read `src hl`
// rows on.  A block that owns at most one unit (units <= the grid) keeps its fp32 sums in
// registers across all n steps and stores once, after the last; otherwise each step's sums
// go through the fp32 `accg` [m, o] in device memory, added in fp32 as the tile loop does.
// The output is bf16 (staged, from the registers) or fp32 (`out_f32`, two columns a store).
template <bool Q8>
__global__ void __launch_bounds__(THREADS, 1)
contract_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap smap0,
               const __grid_constant__ CUtensorMap smap1, const __grid_constant__ CUtensorMap wmap,
               const void* __restrict__ shard, void* __restrict__ out, float* __restrict__ accg,
               Ring rg, int m, int hl, int o, int out_f32, int local) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Tl::NST * Tl::STAGE);
  uint64_t* empty = full + Tl::NST;
  const int n = rg.n;
  const int mt = cdiv(m, BM), nt = cdiv(o, BN), kbt = cdiv(hl, BK), units = mt * nt;
  const bool regs = units <= (int)gridDim.x;
  const RingWait wait{rg.timeout_ns};
  init_stages(full, empty);

  if (threadIdx.x < 128) {
    if (threadIdx.x == 0) {  // the producer
      int it = 0;
      for (int s = 0; s < n; ++s) {
        const int src = (rg.me - s + n) % n;
        const CUtensorMap* am = step_map(rg, s, local, &xmap, &smap0, &smap1);
        for (int u = blockIdx.x; u < units; u += gridDim.x) {
          const wg::Unit w = wg::unit_at<BN>(u, mt, nt, 1, kbt, kbt);
          wg::load_unit<BN, false, false, false>(ring, full, empty, am, &wmap, &wmap, w.m0, w.n0,
                                                0, kbt, it, wait,
                                                Q8 && s > 0 ? wg::A8_BYTES : wg::A_BYTES, src * hl);
        }
      }
    } else if (threadIdx.x >= 32) {
      copy_warps(shard, Q8 ? qpair_bytes(m, hl, 1) : (long long)m * hl * sizeof(bf16), rg, local);
    }
    return;
  }

  const int c = threadIdx.x / 128 - 1, tt = threadIdx.x % 128;
  uint8_t* buf = ring + EPI_OFFSET + c * EPI_BYTES;
  float acc[BN / 2], accb[BN / 2];  // accb: unused (the gated form's)
  int it = 0;
  for (int s = 0; s < n; ++s) {
    const float* scale = reinterpret_cast<const float*>(
        rg.my_slot[(rg.hop0 + s - 1) & 1] + align16((long long)m * hl));
    const bool fresh = s == 0 || !regs, last = s == n - 1;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const wg::Unit w = wg::unit_at<BN>(u, mt, nt, 1, kbt, kbt);
      if (Q8 && s > 0)
        wg::mma_unit_q(ring, full, empty, acc, scale + w.m0, m - w.m0, 0, kbt, c, tt, it, wait,
                       fresh);
      else
        wg::mma_unit<BN, false, false, false>(ring, full, empty, acc, accb, 0, kbt, c, tt, it,
                                              wait, fresh);
      if (regs && !last) continue;                    // the sums stay in registers
      const int m0 = w.m0 + c * 64;
      if (regs && !out_f32) {
        epilogue(acc, buf, c, tt, m0, w.n0, m, o,
                 [&](int r) { return reinterpret_cast<bf16*>(out) + (long long)r * o; },
                 NoFold{});
        continue;
      }
      epilogue_pairs(acc, tt, m0, w.n0, m, o, [&](int r, int col, float v0, float v1) {
        const long long i = (long long)r * o + col;
        if (!regs && s > 0) {                         // this thread's own sums of step s - 1
          const float2 a = *reinterpret_cast<const float2*>(accg + i);
          v0 = a.x + v0;
          v1 = a.y + v1;
        }
        if (!last)
          wg::store2(accg + i, v0, v1);
        else if (out_f32)
          wg::store2(reinterpret_cast<float*>(out) + i, v0, v1);
        else
          wg::store2(reinterpret_cast<bf16*>(out) + i, v0, v1);
      });
    }
    consumers_done(rg, s, Q8, local);
  }
}

// The matmul-RS kernels' producer thread: A is x's rows of the step's destination, B w's
// columns; no flag (x and w are this rank's own).
__device__ __forceinline__ void rs_producer(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                            uint8_t* ring, uint64_t* full, uint64_t* empty,
                                            const Ring& rg, int t, int chunk, int scatter_last,
                                            int mt, int nt, int kbt, const RingWait& wait) {
  const int n = rg.n, units = mt * nt;
  int it = 0;
  for (int s = 0; s < n; ++s) {
    const int dest = (rg.me + n - 1 - s) % n;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const wg::Unit w = wg::unit_at<BN>(u, mt, nt, 1, kbt, kbt);
      const int arow = scatter_last ? w.m0 : (w.m0 / chunk) * t + dest * chunk + w.m0 % chunk;
      const int bcol = scatter_last ? dest * chunk + w.n0 : w.n0;
      wg::load_unit<BN, false, false, false>(ring, full, empty, xmap, wmap, wmap, arow, bcol, 0,
                                            kbt, it, wait);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
rs_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
         bf16* __restrict__ out, Ring rg, int b, int t, int h, int o, int scatter_last,
         int local) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Tl::NST * Tl::STAGE);
  uint64_t* empty = full + Tl::NST;
  const int n = rg.n;
  const int chunk = scatter_last ? o / n : t / n;
  const int M = scatter_last ? b * t : b * chunk, N = scatter_last ? chunk : o;
  const int mt = cdiv(M, BM), nt = cdiv(N, BN), kbt = cdiv(h, BK), units = mt * nt;
  const RingWait wait{rg.timeout_ns};
  init_stages(full, empty);

  if (threadIdx.x < 128) {
    if (threadIdx.x == 0) {  // the producer: A is x's rows of the step, B w's columns
      rs_producer(&xmap, &wmap, ring, full, empty, rg, t, chunk, scatter_last, mt, nt, kbt, wait);
    }
    return;
  }

  const int c = threadIdx.x / 128 - 1, tt = threadIdx.x % 128;
  uint8_t* buf = ring + EPI_OFFSET + c * EPI_BYTES;
  float acc[BN / 2], accb[BN / 2];
  int it = 0;
  for (int s = 0; s < n; ++s) {
    const bf16* in = s > 0 ? reinterpret_cast<const bf16*>(rg.my_slot[(rg.hop0 + s - 1) & 1])
                           : nullptr;  // the arriving accumulator
    const u64 hout = rg.hop0 + s;
    bf16* dst = s < n - 1 ? reinterpret_cast<bf16*>(rg.right_slot[hout & 1]) : out;
    bool waited = false;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const wg::Unit w = wg::unit_at<BN>(u, mt, nt, 1, kbt, kbt);
      wg::mma_unit<BN, false, false, false>(ring, full, empty, acc, accb, 0, kbt, c, tt, it,
                                            wait);
      if (!waited) {  // only the epilogue needs the hop: wait after the first main loop
        if (threadIdx.x == 128) {
          if (s > 0) spin_geq(rg.my_landed, hout, rg.timeout_ns, local);
          if (s < n - 1 && hout >= 2) spin_geq(rg.my_credit, hout - 1, rg.timeout_ns, local);
        }
        named_sync(BAR_CONSUMERS, 256);
        waited = true;
      }
      // the contribution, stored in bf16; then the arriving partial added in fp32
      epilogue(acc, buf, c, tt, w.m0 + c * 64, w.n0, M, N,
               [&](int m) { return dst + (long long)m * N; }, FoldBf16{in, N});
    }
    // every block has written its tiles of the hop and read its tiles of the arriving one
    named_sync(BAR_CONSUMERS, 256);
    if (threadIdx.x == 128 && arrive_one(&rg.counters[2 * s], gridDim.x, local)) {
      if (s < n - 1) release(rg.right_landed, hout + 1, local);
      if (s > 0) release(rg.left_credit, hout, local);
    }
  }
}

// The matmul-RS over the int8 wire: rs_wgmma's producer and main loop; each step's fold
// (FoldQ8: the arriving pair dequantized and added to the stored contribution) goes into a
// full-width bf16 buffer, `work` and `out` in turn, out at the last step.  Before each hop a
// grid barrier, then every warp but the producer's quantizes whole rows of the buffer into
// the right neighbour's slot (quant_rows: the payload, then nseg fp32 scales a row at
// align16(M N)).  Two buffers: step s + 2 folds into the buffer that step s's rows were
// quantized from only after the barrier of step s + 1, which every block reaches after its
// share of step s's quantization.
__global__ void __launch_bounds__(THREADS, 1)
rs_int8_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
              bf16* __restrict__ out, bf16* __restrict__ work, Ring rg, int b, int t, int h,
              int o, int scatter_last, int split, int local) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Tl::NST * Tl::STAGE);
  uint64_t* empty = full + Tl::NST;
  const int n = rg.n;
  const int chunk = scatter_last ? o / n : t / n;
  const int M = scatter_last ? b * t : b * chunk, N = scatter_last ? chunk : o;
  const int mt = cdiv(M, BM), nt = cdiv(N, BN), kbt = cdiv(h, BK), units = mt * nt;
  const int nseg = split > 0 ? 2 : 1;
  const long long soff = align16((long long)M * N);
  const RingWait wait{rg.timeout_ns};
  init_stages(full, empty);
  // the hop of step s: the rows of its buffer quantized into the right neighbour's slot, a
  // warp a row over the grid's quantizing warps
  auto requant = [&](int s) {
    signed char* q = reinterpret_cast<signed char*>(rg.right_slot[(rg.hop0 + s) & 1]);
    quant_rows<bf16>(((n - 1 - s) & 1) ? work : out, M, N, split, q,
                     reinterpret_cast<float*>(q + soff),
                     blockIdx.x * QUANT_WARPS + threadIdx.x / 32 - 1, gridDim.x * QUANT_WARPS);
  };

  if (threadIdx.x < 128) {
    if (threadIdx.x == 0) {  // the producer: A is x's rows of the step, B w's columns
      rs_producer(&xmap, &wmap, ring, full, empty, rg, t, chunk, scatter_last, mt, nt, kbt, wait);
    } else if (threadIdx.x >= 32) {  // warps 1-3 quantize beside the consumers
      for (int s = 0; s < n - 1; ++s) {
        named_sync(BAR_QUANT, 32 * QUANT_WARPS);
        requant(s);
        named_sync(BAR_QUANT, 32 * QUANT_WARPS);
      }
    }
    return;
  }

  const int c = threadIdx.x / 128 - 1, tt = threadIdx.x % 128;
  uint8_t* buf = ring + EPI_OFFSET + c * EPI_BYTES;
  float acc[BN / 2], accb[BN / 2];
  int it = 0;
  for (int s = 0; s < n; ++s) {
    const unsigned char* in =
        s > 0 ? reinterpret_cast<const unsigned char*>(rg.my_slot[(rg.hop0 + s - 1) & 1])
              : nullptr;  // the arriving pair
    const FoldQ8 fold{reinterpret_cast<const signed char*>(in),
                      in ? reinterpret_cast<const float*>(in + soff) : nullptr, N, split, nseg};
    const u64 hout = rg.hop0 + s;
    bf16* dst = ((n - 1 - s) & 1) ? work : out;
    bool waited = false;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const wg::Unit w = wg::unit_at<BN>(u, mt, nt, 1, kbt, kbt);
      wg::mma_unit<BN, false, false, false>(ring, full, empty, acc, accb, 0, kbt, c, tt, it,
                                            wait);
      if (!waited) {  // only the fold needs the hop: wait after the first main loop
        if (threadIdx.x == 128 && s > 0) spin_geq(rg.my_landed, hout, rg.timeout_ns, local);
        named_sync(BAR_CONSUMERS, 256);
        waited = true;
      }
      epilogue(acc, buf, c, tt, w.m0 + c * 64, w.n0, M, N,
               [&](int m) { return dst + (long long)m * N; }, fold);
    }
    named_sync(BAR_CONSUMERS, 256);  // this block's folds of step s are in the buffer
    if (s == n - 1) {                // every block has read the arriving pair: the credit
      if (threadIdx.x == 128 && arrive_one(&rg.counters[2 * s], gridDim.x, local))
        release(rg.left_credit, hout, local);
      break;
    }
    if (threadIdx.x == 128) {
      grid_sync(&rg.counters[2 * MAX_STEPS + s], rg.timeout_ns);
      // every block's folds, the last reads of the arriving pair, are done; then wait until
      // the right neighbour's slot is free
      if (s > 0 && blockIdx.x == 0) release(rg.left_credit, hout, local);
      if (hout >= 2) spin_geq(rg.my_credit, hout - 1, rg.timeout_ns, local);
    }
    named_sync(BAR_QUANT, 32 * QUANT_WARPS);
    requant(s);
    named_sync(BAR_QUANT, 32 * QUANT_WARPS);  // this block's rows of the hop are written
    if (threadIdx.x == 128 && arrive_one(&rg.counters[2 * s], gridDim.x, local))
      release(rg.right_landed, hout + 1, local);
  }
}

// the encoded TMA maps of the receive slots, by address, shape, element type (bf16, or the
// int8 wire's payload: `u8`) and box: a slot's address is fixed for the buffer's life, so each
// is encoded once.  One slot carries the bf16 wire's shard and the int8 wire's pair in turn
// (the same ring, the same [outer, inner] block), so the type is part of the key.
static bool slot_map(CUtensorMap* m, const void* base, long long inner, long long outer, bool u8,
                     int box_outer) {
  struct Entry {
    const void* base;
    long long inner, outer;
    bool u8;
    int box_outer;
    CUtensorMap map;
  };
  constexpr int CAP = 64;
  static Entry cache[CAP];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.base == base && e.inner == inner && e.outer == outer && e.u8 == u8 &&
        e.box_outer == box_outer) {
      *m = e.map;
      return true;
    }
  }
  if (!wg::map2d(m, base, inner, outer, inner, box_outer, u8)) return false;
  Entry& e = cache[used < CAP ? used++ : next++ % CAP];
  e.base = base;
  e.inner = inner;
  e.outer = outer;
  e.u8 = u8;
  e.box_outer = box_outer;
  e.map = *m;
  return true;
}

// whether the ring's peers (the right neighbour's flags and slots, the left one's credit)
// lie on this card, by the pointers' attributes, kept per address (asked once, so never
// while a CUDA graph captures the launch)
static bool peers_local(const Ring& r) {
  struct Entry {
    const void* right;
    const void* left;
    bool local;
  };
  constexpr int CAP = 64;
  static Entry cache[CAP];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].right == r.right_landed && cache[i].left == r.left_credit) return cache[i].local;
  int dev = 0;
  cudaGetDevice(&dev);
  bool local = true;
  for (const void* p : {(const void*)r.right_landed, (const void*)r.left_credit}) {
    cudaPointerAttributes a;
    if (cudaPointerGetAttributes(&a, p) != cudaSuccess || a.device != dev) {
      cudaGetLastError();
      local = false;
    }
  }
  Entry& e = cache[used < CAP ? used++ : next++ % CAP];
  e.right = r.right_landed;
  e.left = r.left_credit;
  e.local = local;
  return local;
}

// the AG-matmul; `pair` given: over the int8 wire (the payload's rows on 16 bytes, h % 16 ==
// 0), the pair quant_pair wrote from x
static int launch_ag(const bf16* x, void* pair, const bf16* w, bf16* out, const Ring& r, int b,
                     int t, int h, int o, int blocks, cudaStream_t st) {
  const bool q8 = pair != nullptr;
  if (o % 8 || (q8 && h % 16)) return (int)cudaErrorInvalidValue;  // 16-byte chunks of a row
  const long long M = (long long)b * t;
  CUtensorMap xm, s0, s1, wm;
  if (!wg::map2d(&xm, x, h, M, h, BM) || !slot_map(&s0, r.my_slot[0], h, M, q8, BM) ||
      !slot_map(&s1, r.my_slot[1], h, M, q8, BM) || !wg::map2d(&wm, w, o, h, o, 64))
    return (int)cudaErrorInvalidValue;
  auto kernel = q8 ? ag_wgmma<true> : ag_wgmma<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  const int units = cdiv((int)M, BM) * cdiv(o, BN);
  kernel<<<grid_cap(units, blocks), THREADS, SMEM, st>>>(
      xm, s0, s1, wm, q8 ? (const void*)pair : (const void*)x, out, r, b, t, h, o,
      peers_local(r));
  return (int)cudaGetLastError();
}

// the contracted AG-matmul; `pair` given: over the int8 wire (hl % 16 == 0), the pair
// quant_pair wrote from x; out bf16 or fp32 (`out_f32`)
static int launch_contract(const bf16* x, void* pair, const bf16* w, void* out, float* acc,
                           const Ring& r, int m, int hl, int o, int out_f32, int blocks,
                           cudaStream_t st) {
  const bool q8 = pair != nullptr;
  if (o % 8 || hl % (q8 ? 16 : 8)) return (int)cudaErrorInvalidValue;
  CUtensorMap xm, s0, s1, wm;
  if (!wg::map2d(&xm, x, hl, m, hl, BM) || !slot_map(&s0, r.my_slot[0], hl, m, q8, BM) ||
      !slot_map(&s1, r.my_slot[1], hl, m, q8, BM) ||
      !wg::map2d(&wm, w, o, (long long)r.n * hl, o, 64))
    return (int)cudaErrorInvalidValue;
  auto kernel = q8 ? contract_wgmma<true> : contract_wgmma<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  const int units = cdiv(m, BM) * cdiv(o, BN);
  kernel<<<grid_cap(units, blocks), THREADS, SMEM, st>>>(
      xm, s0, s1, wm, q8 ? (const void*)pair : (const void*)x, out, acc, r, m, hl, o, out_f32,
      peers_local(r));
  return (int)cudaGetLastError();
}

static int launch_rs(const bf16* x, const bf16* w, bf16* out, const Ring& r, int b, int t, int h,
                     int o, int scatter_last, int blocks, cudaStream_t st) {
  const int chunk = scatter_last ? o / r.n : t / r.n;
  const int M = scatter_last ? b * t : b * chunk, N = scatter_last ? chunk : o;
  if (!scatter_last && chunk % BM) return (int)cudaErrorInvalidValue;  // a box crosses a chunk
  if (N % 8) return (int)cudaErrorInvalidValue;                  // 16-byte chunks of a row
  CUtensorMap xm, wm;
  if (!wg::map2d(&xm, x, h, (long long)b * t, h, BM) || !wg::map2d(&wm, w, o, h, o, 64))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(rs_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  const int units = cdiv(M, BM) * cdiv(N, BN);
  rs_wgmma<<<grid_cap(units, blocks), THREADS, SMEM, st>>>(xm, wm, out, r, b, t, h, o,
                                                           scatter_last, peers_local(r));
  return (int)cudaGetLastError();
}

// the matmul-RS over the int8 wire: as launch_rs, and the gated pair's second segment on 8
// columns (a 16-byte output chunk takes one scale); `work` is a second buffer of out's shape
static int launch_rs_int8(const bf16* x, const bf16* w, bf16* out, bf16* work, const Ring& r,
                          int b, int t, int h, int o, int scatter_last, int split, int blocks,
                          cudaStream_t st) {
  const int chunk = scatter_last ? o / r.n : t / r.n;
  const int M = scatter_last ? b * t : b * chunk, N = scatter_last ? chunk : o;
  if (!scatter_last && chunk % BM) return (int)cudaErrorInvalidValue;  // a box crosses a chunk
  if (N % 8 || split % 8) return (int)cudaErrorInvalidValue;     // 16-byte chunks of a row
  CUtensorMap xm, wm;
  if (!wg::map2d(&xm, x, h, (long long)b * t, h, BM) || !wg::map2d(&wm, w, o, h, o, 64))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(rs_int8_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  const int units = cdiv(M, BM) * cdiv(N, BN);
  rs_int8_wgmma<<<grid_cap(units, blocks), THREADS, SMEM, st>>>(
      xm, wm, out, work, r, b, t, h, o, scatter_last, split, peers_local(r));
  return (int)cudaGetLastError();
}

}  // namespace ringtc

namespace {

// blocks of `kernel` that one SM holds at once
template <typename K>
int occupancy_of(K kernel, int threads, size_t smem, int* per_sm) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
}

// the block count of a tile-loop launch, or the error of a route that does not take the dtype
int tile_route(int impl, int dtype) {
  return impl == (dtype == DT_BF16 ? RING_WMMA : RING_SIMT) ? 0 : (int)cudaErrorInvalidValue;
}

// x [M, h] quantized into the int8 pair at `pair` on `st`, before an int8 AG kernel on any route
int launch_quant_pair(const void* x, void* pair, int M, int h, int dtype, cudaStream_t st) {
  unsigned char* p = (unsigned char*)pair;
  if (dtype == DT_BF16)
    quant_pair<bf16><<<cdiv(M, WARPS), THREADS, 0, st>>>((const bf16*)x, p, M, h);
  else
    quant_pair<float><<<cdiv(M, WARPS), THREADS, 0, st>>>((const float*)x, p, M, h);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* hk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// this library's runtime keeps its own current device: the rank's card
int hk_set_device(int dev) { return (int)cudaSetDevice(dev); }

// one symmetric buffer: allocated, zeroed, and its IPC handle (64 bytes)
int hk_sym_alloc(long long bytes, void** ptr, unsigned char* handle) {
  cudaError_t e = cudaMalloc(ptr, (size_t)bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemset(*ptr, 0, (size_t)bytes);
  if (e != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  e = cudaIpcGetMemHandle(&h, *ptr);
  if (e != cudaSuccess) return (int)e;
  for (int i = 0; i < (int)sizeof(h); ++i) handle[i] = reinterpret_cast<unsigned char*>(&h)[i];
  return (int)cudaDeviceSynchronize();
}

int hk_sym_open(const unsigned char* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  for (int i = 0; i < (int)sizeof(h); ++i) reinterpret_cast<unsigned char*>(&h)[i] = handle[i];
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int hk_sym_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

int hk_sym_free(void* ptr) { return (int)cudaFree(ptr); }

int hk_pingpong(void* my_flag, void* peer_flag, int rounds, int role, unsigned long long base,
                unsigned long long timeout_ns, void* elapsed_ns, void* stream) {
  pingpong_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (u64*)my_flag, (u64*)peer_flag, rounds, role, base, timeout_ns, (long long*)elapsed_ns);
  return (int)cudaGetLastError();
}

// AG-matmul on the route `impl` (RING_*: wgmma for bf16 operands TMA can
// address, the tile loop otherwise: wmma for bf16, simt for fp32).  `blocks`
// caps the grid (0: one block an SM at most, the process ring; the loopback
// ring passes its share of the card so that every rank's grid is resident).
int hk_ring_ag_matmul(const void* x, const void* w, void* out, const unsigned long long* ring,
                      int b, int t, int h, int o, int dtype, int impl, int blocks, void* stream) {
  const Ring rg = unpack(ring);
  if (rg.n < 2 || rg.n > MAX_STEPS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (impl == RING_WGMMA)
    return dtype == DT_BF16 ? ringtc::launch_ag((const bf16*)x, nullptr, (const bf16*)w,
                                                (bf16*)out, rg, b, t, h, o, blocks, st)
                            : (int)cudaErrorInvalidValue;
  if (tile_route(impl, dtype)) return (int)cudaErrorInvalidValue;
  const int g = grid_cap(cdiv(b * t, TBM) * cdiv(o, TBN), blocks);
  if (dtype == DT_BF16)
    ring_ag_kernel<bf16><<<g, THREADS, 0, st>>>((const bf16*)x, (const bf16*)w, (bf16*)out, rg,
                                               b, t, h, o);
  else
    ring_ag_kernel<float><<<g, THREADS, 0, st>>>((const float*)x, (const float*)w, (float*)out,
                                                rg, b, t, h, o);
  return (int)cudaGetLastError();
}

// matmul-RS on the route `impl`, as hk_ring_ag_matmul's; the wgmma route
// over tokens takes chunks of whole 128-row boxes and even row lengths.
int hk_ring_matmul_rs(const void* x, const void* w, void* out, const unsigned long long* ring,
                      int b, int t, int h, int o, int scatter_last, int dtype, int impl,
                      int blocks, void* stream) {
  const Ring rg = unpack(ring);
  if (rg.n < 2 || rg.n > MAX_STEPS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (impl == RING_WGMMA)
    return dtype == DT_BF16 ? ringtc::launch_rs((const bf16*)x, (const bf16*)w, (bf16*)out, rg,
                                                b, t, h, o, scatter_last, blocks, st)
                            : (int)cudaErrorInvalidValue;
  if (tile_route(impl, dtype)) return (int)cudaErrorInvalidValue;
  const int chunk = scatter_last ? o / rg.n : t / rg.n;
  const int M = scatter_last ? b * t : b * chunk, N = scatter_last ? chunk : o;
  const int g = grid_cap(cdiv(M, TBM) * cdiv(N, TBN), blocks);
  if (dtype == DT_BF16)
    ring_rs_kernel<bf16><<<g, THREADS, 0, st>>>((const bf16*)x, (const bf16*)w, (bf16*)out, rg,
                                               b, t, h, o, scatter_last);
  else
    ring_rs_kernel<float><<<g, THREADS, 0, st>>>((const float*)x, (const float*)w, (float*)out,
                                                rg, b, t, h, o, scatter_last);
  return (int)cudaGetLastError();
}

// the contracted AG-matmul on the route `impl`, as hk_ring_ag_matmul's (wgmma: bf16 TMA can
// address, the sums in registers where a block owns at most one tile); out bf16 or fp32
int hk_ring_ag_matmul_contract(const void* x, const void* w, void* out, void* acc,
                               const unsigned long long* ring, int m, int hl, int o, int dtype,
                               int out_dtype, int impl, int blocks, void* stream) {
  const Ring rg = unpack(ring);
  if (rg.n < 2 || rg.n > MAX_STEPS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (impl == RING_WGMMA)
    return dtype == DT_BF16 ? ringtc::launch_contract((const bf16*)x, nullptr, (const bf16*)w,
                                                      out, (float*)acc, rg, m, hl, o,
                                                      out_dtype == DT_F32, blocks, st)
                            : (int)cudaErrorInvalidValue;
  if (tile_route(impl, dtype)) return (int)cudaErrorInvalidValue;
  const int g = grid_cap(cdiv(m, TBM) * cdiv(o, TBN), blocks);
  if (dtype == DT_BF16 && out_dtype == DT_BF16)
    ring_contract_kernel<bf16, bf16><<<g, THREADS, 0, st>>>(
        (const bf16*)x, (const bf16*)w, (bf16*)out, (float*)acc, rg, m, hl, o);
  else if (dtype == DT_BF16)
    ring_contract_kernel<bf16, float><<<g, THREADS, 0, st>>>(
        (const bf16*)x, (const bf16*)w, (float*)out, (float*)acc, rg, m, hl, o);
  else
    ring_contract_kernel<float, float><<<g, THREADS, 0, st>>>(
        (const float*)x, (const float*)w, (float*)out, (float*)acc, rg, m, hl, o);
  return (int)cudaGetLastError();
}

// the AG-matmul over the int8 wire on the route `impl`, as hk_ring_ag_matmul's (wgmma: bf16
// with the payload's rows on 16 bytes); `pair` (qpair_bytes(b t, h, 1), scratch) takes x
// quantized once by quant_pair, on every route, and the ring circulates it
int hk_ring_ag_matmul_int8(const void* x, void* pair, const void* w, void* out,
                           const unsigned long long* ring, int b, int t, int h, int o, int dtype,
                           int impl, int blocks, void* stream) {
  const Ring rg = unpack(ring);
  if (rg.n < 2 || rg.n > MAX_STEPS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned char* p = (const unsigned char*)pair;
  if (const int e = launch_quant_pair(x, pair, b * t, h, dtype, st)) return e;
  if (impl == RING_WGMMA)
    return dtype == DT_BF16 ? ringtc::launch_ag((const bf16*)x, pair, (const bf16*)w,
                                                (bf16*)out, rg, b, t, h, o, blocks, st)
                            : (int)cudaErrorInvalidValue;
  if (tile_route(impl, dtype)) return (int)cudaErrorInvalidValue;
  const int g = grid_cap(cdiv(b * t, TBM) * cdiv(o, TBN), blocks);
  if (dtype == DT_BF16)
    ring_ag_int8_kernel<bf16><<<g, THREADS, 0, st>>>((const bf16*)x, p, (const bf16*)w,
                                                    (bf16*)out, rg, b, t, h, o);
  else
    ring_ag_int8_kernel<float><<<g, THREADS, 0, st>>>((const float*)x, p, (const float*)w,
                                                     (float*)out, rg, b, t, h, o);
  return (int)cudaGetLastError();
}

// the matmul-RS over the int8 wire on the route `impl`, as hk_ring_matmul_rs's (wgmma: the
// gated pair's `split` on 8 columns too); `work` is a second buffer of out's shape.  The grid
// barrier of both routes needs every block resident: `blocks` (or one an SM) keeps it so
int hk_ring_matmul_rs_int8(const void* x, const void* w, void* out, void* work,
                           const unsigned long long* ring, int b, int t, int h, int o,
                           int scatter_last, int split, int dtype, int impl, int blocks,
                           void* stream) {
  const Ring rg = unpack(ring);
  if (rg.n < 2 || rg.n > MAX_STEPS) return (int)cudaErrorInvalidValue;
  const int chunk = scatter_last ? o / rg.n : t / rg.n;
  const int M = scatter_last ? b * t : b * chunk, N = scatter_last ? chunk : o;
  if (split < 0 || split >= N) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (impl == RING_WGMMA)
    return dtype == DT_BF16 ? ringtc::launch_rs_int8((const bf16*)x, (const bf16*)w, (bf16*)out,
                                                     (bf16*)work, rg, b, t, h, o, scatter_last,
                                                     split, blocks, st)
                            : (int)cudaErrorInvalidValue;
  if (tile_route(impl, dtype)) return (int)cudaErrorInvalidValue;
  const int g = grid_cap(cdiv(M, TBM) * cdiv(N, TBN), blocks);
  if (dtype == DT_BF16)
    ring_rs_int8_kernel<bf16><<<g, THREADS, 0, st>>>((const bf16*)x, (const bf16*)w, (bf16*)out,
                                                    (bf16*)work, rg, b, t, h, o, scatter_last,
                                                    split);
  else
    ring_rs_int8_kernel<float><<<g, THREADS, 0, st>>>((const float*)x, (const float*)w,
                                                     (float*)out, (float*)work, rg, b, t, h, o,
                                                     scatter_last, split);
  return (int)cudaGetLastError();
}

// the contracted AG-matmul over the int8 wire on the route `impl`, as hk_ring_ag_matmul_int8's
int hk_ring_ag_matmul_contract_int8(const void* x, void* pair, const void* w, void* out,
                                    void* acc, const unsigned long long* ring, int m, int hl,
                                    int o, int dtype, int out_dtype, int impl, int blocks,
                                    void* stream) {
  const Ring rg = unpack(ring);
  if (rg.n < 2 || rg.n > MAX_STEPS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned char* p = (const unsigned char*)pair;
  if (const int e = launch_quant_pair(x, pair, m, hl, dtype, st)) return e;
  if (impl == RING_WGMMA)
    return dtype == DT_BF16 ? ringtc::launch_contract((const bf16*)x, pair, (const bf16*)w, out,
                                                      (float*)acc, rg, m, hl, o,
                                                      out_dtype == DT_F32, blocks, st)
                            : (int)cudaErrorInvalidValue;
  if (tile_route(impl, dtype)) return (int)cudaErrorInvalidValue;
  const int g = grid_cap(cdiv(m, TBM) * cdiv(o, TBN), blocks);
  if (dtype == DT_BF16 && out_dtype == DT_BF16)
    ring_contract_int8_kernel<bf16, bf16><<<g, THREADS, 0, st>>>(
        (const bf16*)x, p, (const bf16*)w, (bf16*)out, (float*)acc, rg, m, hl, o);
  else if (dtype == DT_BF16)
    ring_contract_int8_kernel<bf16, float><<<g, THREADS, 0, st>>>(
        (const bf16*)x, p, (const bf16*)w, (float*)out, (float*)acc, rg, m, hl, o);
  else
    ring_contract_int8_kernel<float, float><<<g, THREADS, 0, st>>>(
        (const float*)x, p, (const float*)w, (float*)out, (float*)acc, rg, m, hl, o);
  return (int)cudaGetLastError();
}

// Blocks of one ring kernel that an SM holds at once (*per_sm) and the SM count
// (*sms), for the kernel a launch would take: kernel 0 AG-matmul, 1 matmul-RS,
// 2 the contracted AG-matmul, 3-5 their int8 variants; dtype and out_dtype as the
// launch's, impl the route.
int hk_ring_occupancy(int kernel, int dtype, int out_dtype, int impl, int* per_sm, int* sms) {
  *sms = sm_count();
  const bool bf = dtype == DT_BF16, obf = out_dtype == DT_BF16;
  if (impl == RING_WGMMA && bf) {
    constexpr int th = ringtc::THREADS;
    constexpr size_t sm = ringtc::SMEM;
    switch (kernel) {
      case 0: return occupancy_of(ringtc::ag_wgmma<false>, th, sm, per_sm);
      case 1: return occupancy_of(ringtc::rs_wgmma, th, sm, per_sm);
      case 2: return occupancy_of(ringtc::contract_wgmma<false>, th, sm, per_sm);
      case 3: return occupancy_of(ringtc::ag_wgmma<true>, th, sm, per_sm);
      case 4: return occupancy_of(ringtc::rs_int8_wgmma, th, sm, per_sm);
      case 5: return occupancy_of(ringtc::contract_wgmma<true>, th, sm, per_sm);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (kernel) {
    case 0:
      return bf ? occupancy_of(ring_ag_kernel<bf16>, THREADS, 0, per_sm)
                : occupancy_of(ring_ag_kernel<float>, THREADS, 0, per_sm);
    case 1:
      return bf ? occupancy_of(ring_rs_kernel<bf16>, THREADS, 0, per_sm)
                : occupancy_of(ring_rs_kernel<float>, THREADS, 0, per_sm);
    case 2:
      return bf ? (obf ? occupancy_of(ring_contract_kernel<bf16, bf16>, THREADS, 0, per_sm)
                       : occupancy_of(ring_contract_kernel<bf16, float>, THREADS, 0, per_sm))
                : occupancy_of(ring_contract_kernel<float, float>, THREADS, 0, per_sm);
    case 3:
      return bf ? occupancy_of(ring_ag_int8_kernel<bf16>, THREADS, 0, per_sm)
                : occupancy_of(ring_ag_int8_kernel<float>, THREADS, 0, per_sm);
    case 4:
      return bf ? occupancy_of(ring_rs_int8_kernel<bf16>, THREADS, 0, per_sm)
                : occupancy_of(ring_rs_int8_kernel<float>, THREADS, 0, per_sm);
    case 5:
      return bf ? (obf ? occupancy_of(ring_contract_int8_kernel<bf16, bf16>, THREADS, 0, per_sm)
                       : occupancy_of(ring_contract_int8_kernel<bf16, float>, THREADS, 0, per_sm))
                : occupancy_of(ring_contract_int8_kernel<float, float>, THREADS, 0, per_sm);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
