// The wgmma product loop shared by matmul.cu's wg::mm (and wg::mm_gated) and
// ring_matmul.cu's tensor-core ring kernels: the tile geometry (BM x BN output
// tiles, 64-deep k-blocks of 128-byte swizzled rows), the work units, the
// m64n128 / m64n256 products, and the two halves of the main loop, one per
// role of a warp-specialised block (matmul.cu's wgmma section says how they
// fit together):
//   * load_unit: the producer thread's TMA loads of one unit's k-blocks into
//     the ring of stages, each stage's `full` mbarrier expecting its bytes
//     (a bf16 A box, or an int8 one of half the bytes);
//   * mma_unit: a consumer warpgroup's wgmma over the same k-blocks into its
//     fp32 accumulators (zeroed first, or summed on), releasing each stage
//     (`empty`) once its products are done;
//   * mma_unit_q: the same over stages whose A is an int8 box with one fp32
//     scale a row: the dequantizing stage between TMA and wgmma (below).
// They take the mbarrier wait as an argument: wg::mm waits with hopper's trap
// after ~15 s, the ring kernels with their own spin timeout, since their stages
// may wait on a peer.  Also the host's 2-D TMA maps of a bf16 and an int8 matrix, and
// the 3-D map of a stack of bf16 matrices (the experts of matmul.cuh's gemv and moe.cu).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace wg {
using namespace hopper;
using bf16 = __nv_bfloat16;


constexpr int BM = 128, BK = 64, GM = 16, THREADS = 384;
constexpr int A_BYTES = BM * BK * 2;  // 16 KB
constexpr int A8_BYTES = BM * BK;     // an int8 A box of 128 rows of 64 bytes, 8 KB
constexpr int BOX = 64 * 128;         // one 64-row box of 128-byte rows, 8 KB

template <int BN, bool GATED = false>
struct Tile {
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE = A_BYTES + (GATED ? 2 : 1) * B_BYTES;
  static constexpr int NST = GATED || BN == 256 ? 4 : 6;  // 192 KB of stages each way
  static constexpr size_t SMEM = 1024 + (size_t)NST * STAGE + 2 * NST * 8;
};

struct Unit {
  int m0, n0, kb0, kb1, split;
};

// Work unit u: its tile's first row and column, its range of k-blocks and its split.
template <int BN>
__device__ __forceinline__ Unit unit_at(int u, int mt, int nt, int splits, int kper, int kbt) {
  Unit w;
  w.split = u % splits;
  const int tile = u / splits, band = GM * nt;
  const int g = tile / band, r = tile % band, gm = min(GM, mt - g * GM);
  w.m0 = (g * GM + r % gm) * BM;
  w.n0 = (r / gm) * BN;
  w.kb0 = w.split * kper;
  w.kb1 = min(kbt, w.kb0 + kper);
  return w;
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], both from shared memory; acc 0 overwrites D.
// TA and TB are the instruction's transpose bits: 1 for an MN-major A, 0 for a K-major B.
template <int TA, int TB>
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], both from shared memory; acc 0 overwrites D.
// TA and TB are the instruction's transpose bits: 1 for an MN-major A, 0 for a K-major B.
template <int TA, int TB>
__device__ __forceinline__ void mma_n256(float (&d)[128], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da, uint64_t db, int acc);
template <>
__device__ __forceinline__ void mma<128, 0, 0>(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  mma_n128<0, 1>(d, da, db, acc);
}
template <>
__device__ __forceinline__ void mma<128, 0, 1>(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  mma_n128<0, 0>(d, da, db, acc);
}
template <>
__device__ __forceinline__ void mma<128, 1, 0>(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  mma_n128<1, 1>(d, da, db, acc);
}
template <>
__device__ __forceinline__ void mma<256, 0, 0>(float (&d)[128], uint64_t da, uint64_t db, int acc) {
  mma_n256<0, 1>(d, da, db, acc);
}
template <>
__device__ __forceinline__ void mma<256, 0, 1>(float (&d)[128], uint64_t da, uint64_t db, int acc) {
  mma_n256<0, 0>(d, da, db, acc);
}
template <>
__device__ __forceinline__ void mma<256, 1, 0>(float (&d)[128], uint64_t da, uint64_t db, int acc) {
  mma_n256<1, 1>(d, da, db, acc);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The producer's loads of one unit: k-blocks [kb0, kb1) of the A tile whose first row (or,
// for an MN-major A, first column) is `arow` and of the B tile whose first column is `bcol`,
// into the next stages of the ring; `it` counts stages over every unit the block has loaded.
// `a_bytes` is the A box's size: A_BYTES (bf16) or A8_BYTES (a K-major int8 box through
// map2d(..., u8), in the first half of the stage's A region); B's k-blocks start `bk0` rows on.
template <int BN, bool TA, bool TB, bool GATED, typename Wait>
__device__ __forceinline__ void load_unit(uint8_t* ring, uint64_t* full, uint64_t* empty,
                                          const CUtensorMap* amap, const CUtensorMap* bmap,
                                          const CUtensorMap* bmap2, int arow, int bcol, int kb0,
                                          int kb1, int& it, Wait wait, int a_bytes = A_BYTES,
                                          int bk0 = 0) {
  using T = Tile<BN, GATED>;
  for (int kb = kb0; kb < kb1; ++kb, ++it) {
    const int s = it % T::NST;
    if (it >= T::NST) wait(&empty[s], (it / T::NST - 1) & 1);
    uint8_t* as = ring + s * T::STAGE;
    uint8_t* bs = as + A_BYTES;
    bar_expect(&full[s], T::STAGE - A_BYTES + a_bytes);  // every box's bytes, edges included
    if (TA) {
      tma_load(as, amap, &full[s], arow, kb * BK);
      tma_load(as + BOX, amap, &full[s], arow + 64, kb * BK);
    } else {
      tma_load(as, amap, &full[s], kb * BK, arow);
    }
    if (TB) {
      tma_load(bs, bmap, &full[s], bk0 + kb * BK, bcol);
    } else {
#pragma unroll
      for (int j = 0; j < BN / 64; ++j) {
        tma_load(bs + j * BOX, bmap, &full[s], bcol + 64 * j, bk0 + kb * BK);
        if (GATED)
          tma_load(bs + T::B_BYTES + j * BOX, bmap2, &full[s], bcol + 64 * j, bk0 + kb * BK);
      }
    }
  }
}

// Consumer warpgroup c's products of one unit (k-blocks [kb0, kb1)) into acc (and, gated, accb),
// overwritten (or, `fresh` false, summed onto what they hold); `t` is the thread's index in its
// warpgroup and `it` counts stages as load_unit's.  A stage is released once the products that
// read it have completed (one wgmma group stays in flight across the next stage's wait); on
// return every product is done and every stage the unit used is released.
template <int BN, bool TA, bool TB, bool GATED, typename Wait>
__device__ __forceinline__ void mma_unit(uint8_t* ring, uint64_t* full, uint64_t* empty,
                                         float (&acc)[BN / 2], float (&accb)[BN / 2], int kb0,
                                         int kb1, int c, int t, int& it, Wait wait,
                                         bool fresh = true) {
  using T = Tile<BN, GATED>;
  if (fresh) {
    zero(acc);
    if (GATED) zero(accb);
  }
  int prev = -1;
  for (int kb = kb0; kb < kb1; ++kb, ++it) {
    const int s = it % T::NST;
    wait(&full[s], (it / T::NST) & 1);
    // this warpgroup's 64 rows of A: rows 64c.. of a K-major tile, or box c of an MN-major one
    const uint32_t a = saddr(ring + s * T::STAGE) + c * BOX;
    const uint32_t b = saddr(ring + s * T::STAGE + A_BYTES);
    wg_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) {
      const uint64_t da = TA ? desc(a + k * 2048, BOX) : desc(a + k * 32, 16);
      mma<BN, TA, TB>(acc, da, TB ? desc(b + k * 32, 16) : desc(b + k * 2048, BOX), 1);
      if constexpr (GATED) mma<BN, TA, TB>(accb, da, desc(b + T::B_BYTES + k * 2048, BOX), 1);
    }
    wg_commit();
    wg_wait<1>();  // the previous stage's products are done: release it
    if (prev >= 0 && t == 0) bar_arrive(&empty[prev]);
    prev = s;
  }
  wg_wait<0>();
  keep(acc);
  if (GATED) keep(accb);
  if (prev >= 0 && t == 0) bar_arrive(&empty[prev]);
}

// ---- the dequantizing stage ----
//
// An int8 A stage holds a box of 128 rows of 64 k-bytes (one k-block), 64-byte swizzled: the
// 16-byte chunk j of row r lies at chunk j ^ (r >> 1 & 3), so the loads below, eight rows of a
// warp on two words each, fall on 16 distinct banks.  Each consumer thread turns its share of
// its warpgroup's 64 rows straight into wgmma's A fragment, in registers: thread (warp w, lane
// l) holds rows r = 16 w + l / 4 and r + 8, k pairs 2 (l % 4) and 2 (l % 4) + 8 of each 16-deep
// k-step, register 4 j + i of k-step j being (row r, low pair), (r + 8, low), (r, high),
// (r + 8, high).  Every value is bf16(q * scale) with one fp32 product, never an FMA (the tile
// loop's and core/quant.dequant_int8's rounding); q reaches fp32 exactly through its biased
// byte in a float's mantissa (2^23 + q + 128) less 2^23 + 128.  No bf16 copy of the tile is
// stored: wgmma reads A from the registers and B from the stage.

// bytes `sel` and `sel` + 1 (of 0..3) of the sign-flipped word x as q, each times `scale`,
// packed into one bf16 pair (the lower k in the low half)
__device__ __forceinline__ uint32_t dequant2(uint32_t x, uint32_t sel, float scale) {
  const float a = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7540u | sel)) - 8388736.f;
  const float b = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7540u | (sel + 1))) - 8388736.f;
  const __nv_bfloat162 v = __floats2bfloat162_rn(__fmul_rn(a, scale), __fmul_rn(b, scale));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// warpgroup c's A fragments of the k-block in the int8 box at `box` (its 64 rows start at row
// 64 c), this thread's two rows scaled by s0 and s1
__device__ __forceinline__ void dequant_frags(const uint8_t* box, uint32_t (&f)[BK / 4], int c,
                                              int t, float s0, float s1) {
  const int l = t % 32, g = l / 4, swz = (g >> 1) & 3;
  const uint8_t* r0 = box + (c * 64 + (t / 32) * 16 + g) * BK + 4 * ((l % 4) >> 1);
  const uint8_t* r1 = r0 + 8 * BK;
  const uint32_t sel = 2 * (l % 2);
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    const int off = (j ^ swz) * 16;
    f[4 * j + 0] = dequant2(*reinterpret_cast<const uint32_t*>(r0 + off) ^ 0x80808080u, sel, s0);
    f[4 * j + 1] = dequant2(*reinterpret_cast<const uint32_t*>(r1 + off) ^ 0x80808080u, sel, s1);
    f[4 * j + 2] =
        dequant2(*reinterpret_cast<const uint32_t*>(r0 + off + 8) ^ 0x80808080u, sel, s0);
    f[4 * j + 3] =
        dequant2(*reinterpret_cast<const uint32_t*>(r1 + off + 8) ^ 0x80808080u, sel, s1);
  }
}

// mma_unit (BN 128, K-major A, MN-major B) over stages whose A is an int8 box: row r of the
// unit's A is scaled by scale[r], read (around L1: a peer wrote them) once the unit's first
// stage has landed; rows at or past `rows` read as zero.  Each stage's fragments stay live
// until the products that read them complete, so two sets alternate.
template <typename Wait>
__device__ __forceinline__ void mma_unit_q(uint8_t* ring, uint64_t* full, uint64_t* empty,
                                           float (&acc)[64], const float* scale, int rows,
                                           int kb0, int kb1, int c, int t, int& it, Wait wait,
                                           bool fresh = true) {
  using T = Tile<128>;
  if (fresh) zero(acc);
  const int r = c * 64 + (t / 32) * 16 + (t % 32) / 4;
  float s0 = 0.f, s1 = 0.f;
  uint32_t fa[BK / 4], fb[BK / 4];
  int prev = -1;
  auto kblock = [&](int kb, uint32_t (&f)[BK / 4], uint32_t (&other)[BK / 4]) {
    const int s = it % T::NST;
    wait(&full[s], (it / T::NST) & 1);
    if (kb == kb0) {
      s0 = r < rows ? __ldcg(scale + r) : 0.f;
      s1 = r + 8 < rows ? __ldcg(scale + r + 8) : 0.f;
    }
    dequant_frags(ring + s * T::STAGE, f, c, t, s0, s1);
    const uint32_t b = saddr(ring + s * T::STAGE + A_BYTES);
    wg_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) wgmma_rs_n128(acc, &f[4 * k], desc(b + k * 2048, BOX));
    wg_commit();
    wg_wait<1>();  // the previous stage's products are done: its fragments and stage are free
    keep(other);
    if (prev >= 0 && t == 0) bar_arrive(&empty[prev]);
    prev = s;
    ++it;
  };
  for (int kb = kb0; kb < kb1; kb += 2) {
    kblock(kb, fa, fb);
    if (kb + 1 < kb1) kblock(kb + 1, fb, fa);
  }
  wg_wait<0>();
  keep(acc);
  keep(fa);
  keep(fb);
  if (prev >= 0 && t == 0) bar_arrive(&empty[prev]);
}

// ---- host side ----

// A bf16 matrix of `outer` rows of `inner` elements, rows `ld` elements apart, as a 2-D
// TMA map with a box of 64 x box_outer, 128-byte swizzled; elements past the dims read 0.
// `u8`: an int8 matrix instead (`ld` bytes apart, a multiple of 16), its 64-byte box rows
// 64-byte swizzled (the dequantizing stage's layout).
static bool map2d(CUtensorMap* m, const void* base, long long inner, long long outer,
                  long long ld, int box_outer, bool u8 = false) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * (u8 ? 1 : 2)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return fn(m, u8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            u8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A contiguous bf16 [experts, outer, inner] tensor as a 3-D TMA map whose box is 64 x
// box_outer of one expert, 128-byte swizzled; elements past inner or outer read 0, so a box
// never reads across an expert's rows (experts = 1: one matrix).
static bool map3d(CUtensorMap* m, const void* base, long long inner, long long outer,
                  long long experts, int box_outer) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer, (cuuint64_t)experts};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2, (cuuint64_t)(outer * inner) * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_outer, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg
