// Hand-written Hopper (sm_90a) SwiGLU backward kernel of the port.
//
// The derivative of the gated FFN's epilogue, h = act(a) * b with
// a = x @ w1 and b = x @ w1b, as repro/kernels/matmul.py::gated_matmul
// (pallas_call at matmul.py:132, body :115) computes it: the TPU kernel has
// no backward, so this is the elementwise half of its derivative.  Given
// the incoming gradient g (compute dtype) and the fp32 products a and b
// that the forward gated-matmul kernel wrote, it writes
//     dA = g * b * act'(a)      dB = g * act(a)
// in the compute dtype, with all arithmetic in fp32 and one rounding at
// the store (a and b stay fp32 until then, as in the Pallas epilogue).
// act is SiLU (SwiGLU) or tanh-GELU (GeGLU).  The rest of the gated
// backward is four tile-matmul products (matmul.cu): dx = dA w1^T + dB w1b^T
// and dw1 = x^T dA, dw1b = x^T dB.
//
// Bound on an H100 SXM: pure bytes.  Per element it reads g (2 bytes in
// bf16) and a, b (4 + 4) and writes dA, dB (2 + 2): 14 bytes against ~20
// operations, so at qwen3-0.6b's training shape (2048 tokens x d_ff 3072)
// 88 MB, about 26 us at 3.35 TB/s.  The design is one fused pass with a
// grid-stride loop of 4 elements per thread in 16-byte (fp32) and 8-byte
// (bf16) vectors when the length allows, so every byte moves once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

enum { ACT_GELU = 2, ACT_SILU = 3 };
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// act(a) and act'(a)
__device__ __forceinline__ void act_and_grad(float a, int act, float* f, float* df) {
  if (act == ACT_GELU) {  // tanh approximation, as jax.nn.gelu computes by default
    const float c = 0.7978845608028654f;  // sqrt(2/pi)
    const float u = c * (a + 0.044715f * a * a * a);
    const float t = tanhf(u);
    *f = 0.5f * a * (1.f + t);
    *df = 0.5f * (1.f + t) + 0.5f * a * (1.f - t * t) * c * (1.f + 3.f * 0.044715f * a * a);
  } else {  // SiLU
    const float s = 1.f / (1.f + expf(-a));
    *f = a * s;
    *df = s * (1.f + a * (1.f - s));
  }
}

template <typename T>
__device__ __forceinline__ void one(const T* g, const float* a, const float* b, T* da, T* db,
                                    size_t i, int act) {
  float f, df;
  act_and_grad(a[i], act, &f, &df);
  const float gv = to_f(g[i]);
  da[i] = from_f<T>(gv * b[i] * df);
  db[i] = from_f<T>(gv * f);
}

template <typename T>
__global__ void __launch_bounds__(256)
swiglu_bwd(const T* __restrict__ g, const float* __restrict__ a, const float* __restrict__ b,
           T* __restrict__ da, T* __restrict__ db, size_t n, int act) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t n4 = n / 4;
  for (size_t v = (size_t)blockIdx.x * blockDim.x + threadIdx.x; v < n4; v += stride) {
    const float4 av = reinterpret_cast<const float4*>(a)[v];
    const float4 bv = reinterpret_cast<const float4*>(b)[v];
    const float as[4] = {av.x, av.y, av.z, av.w}, bs[4] = {bv.x, bv.y, bv.z, bv.w};
    float gs[4];
    if constexpr (sizeof(T) == 2) {
      const uint2 gv = reinterpret_cast<const uint2*>(g)[v];
      const float2 g0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gv.x));
      const float2 g1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gv.y));
      gs[0] = g0.x; gs[1] = g0.y; gs[2] = g1.x; gs[3] = g1.y;
    } else {
      const float4 gv = reinterpret_cast<const float4*>(g)[v];
      gs[0] = gv.x; gs[1] = gv.y; gs[2] = gv.z; gs[3] = gv.w;
    }
    T ra[4], rb[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float f, df;
      act_and_grad(as[e], act, &f, &df);
      ra[e] = from_f<T>(gs[e] * bs[e] * df);
      rb[e] = from_f<T>(gs[e] * f);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      da[4 * v + e] = ra[e];
      db[4 * v + e] = rb[e];
    }
  }
  // the tail past the last full vector
  const size_t t = 4 * n4 + (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) one(g, a, b, da, db, t, act);
}

extern "C" {

// g, da, db: n elements of the compute dtype; a, b: n fp32.  Every pointer
// 16-byte aligned.  act: 2 (tanh-GELU) or 3 (SiLU).  Returns a cudaError_t.
int hk_swiglu_bwd(const void* g, const void* a, const void* b, void* da, void* db,
                  long long n, int act, int dtype, void* stream) {
  if (act != ACT_GELU && act != ACT_SILU) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long vecs = n / 4 > 0 ? n / 4 : 1;
  const int blocks = (int)((vecs + 255) / 256 < 4 * 132 * 8 ? (vecs + 255) / 256 : 4 * 132 * 8);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  if (dtype == DT_BF16)
    swiglu_bwd<bf16><<<blocks, 256, 0, st>>>(static_cast<const bf16*>(g), ap, bp,
                                             static_cast<bf16*>(da), static_cast<bf16*>(db),
                                             (size_t)n, act);
  else
    swiglu_bwd<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(g), ap, bp,
                                              static_cast<float*>(da), static_cast<float*>(db),
                                              (size_t)n, act);
  return (int)cudaGetLastError();
}

const char* hk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
