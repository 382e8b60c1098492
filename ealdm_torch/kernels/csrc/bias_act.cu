// Fused bias + activation + gain + clamp for sm_90a.
//
// Replaces: ealdm_tpu/ops/bias_act.py `_pallas_kernel` (via
// `_bias_act_pallas_2d`), wrapped by `bias_act`. Computes, per element,
//   y = clamp(act(x + b[c]) * gain, -clamp, clamp)
// in fp32 and stores y in the input type (float32, bfloat16 or float16), for
// the nine activations of `activation_funcs` (codes below). The bias may lie
// on any dim: the wrapper passes that dim's size C and its stride `inner` in
// a dense tensor, so an element at memory offset i has channel
// (i / inner) % C. The Pallas kernel takes only a channel-last bias with
// C % 128 == 0; this one takes every shape and dim.
//
// Bound on this card: bytes. One read of x and one write of y, a few
// operations per element (e.g. 50.3 MB for [48,32,32,256] bf16 at 3.35 TB/s).
//
// Design: a grid-stride loop over 16-byte vectors (4 float32 or 8 16-bit
// values), so every load and store is one 128-bit access by neighbouring
// threads on neighbouring addresses. A vector's first channel takes one
// division; the rest follow by counting. Elements past the last whole vector,
// or all of them when x or y is not 16-byte aligned, take a scalar loop.
// 32-bit indices unless the tensor has 2^31 elements or more.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

constexpr int NT = 256;
constexpr int MAX_BLOCKS = 4096;

// Activation codes, in the order of `activation_funcs`.
enum ActKind { LINEAR, RELU, LRELU, TANH, SIGMOID, ELU, SELU, SOFTPLUS, SWISH, NUM_ACTS };

struct Act {
  int kind;
  float alpha, gain, clamp;  // clamp < 0: none
};

// The plain version's formulas (ops/bias_act.py `bias_act_plain`).
__device__ __forceinline__ float activate(float x, const Act& a) {
  switch (a.kind) {
    case RELU: x = fmaxf(x, 0.f); break;
    case LRELU: x = x >= 0.f ? x : x * a.alpha; break;
    case TANH: x = tanhf(x); break;
    case SIGMOID: x = 1.f / (1.f + expf(-x)); break;
    case ELU: x = x > 0.f ? x : expm1f(x); break;
    case SELU:
      x = 1.0507009873554805f * (x > 0.f ? x : 1.6732632423543772f * expm1f(x));
      break;
    case SOFTPLUS: x = x > 20.f ? x : log1pf(expf(x)); break;
    case SWISH: x = x * (1.f / (1.f + expf(-x))); break;
    default: break;  // LINEAR
  }
  if (a.gain != 1.f) x *= a.gain;
  if (a.clamp >= 0.f) x = fminf(fmaxf(x, -a.clamp), a.clamp);
  return x;
}

template <typename T, typename I>
__global__ void __launch_bounds__(NT)
bias_act_kernel(const T* __restrict__ x, const float* __restrict__ b,
                T* __restrict__ y, I n, I nvec, I C, I inner, Act a) {
  constexpr int V = 16 / sizeof(T);
  const I stride = (I)gridDim.x * NT;
  const I tid = (I)blockIdx.x * NT + threadIdx.x;
  for (I v = tid; v < nvec; v += stride) {
    const I i0 = v * V;
    const uint4 raw = *reinterpret_cast<const uint4*>(x + i0);
    const T* in = reinterpret_cast<const T*>(&raw);
    alignas(16) T out[V];
    I c = 0, r = 0;
    if (b) {
      const I q = i0 / inner;
      r = i0 - q * inner;
      c = q % C;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float val = to_f32(in[j]);
      if (b) {
        val += b[c];
        if (++r == inner) {
          r = 0;
          if (++c == C) c = 0;
        }
      }
      out[j] = from_f32<T>(activate(val, a));
    }
    *reinterpret_cast<uint4*>(y + i0) = *reinterpret_cast<const uint4*>(out);
  }
  for (I i = nvec * V + tid; i < n; i += stride) {
    float val = to_f32(x[i]);
    if (b) val += b[(i / inner) % C];
    y[i] = from_f32<T>(activate(val, a));
  }
}

template <typename T, typename I>
cudaError_t launch(const void* x, const float* b, void* y, long long n,
                   long long C, long long inner, Act a, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const long long nvec = aligned ? n / V : 0;
  const long long work = nvec > 0 ? nvec : n;
  const long long blocks = (work + NT - 1) / NT;
  const int grid = (int)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
  bias_act_kernel<T, I><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), b, static_cast<T*>(y), (I)n, (I)nvec, (I)C,
      (I)inner, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_any(const void* x, const float* b, void* y, long long n,
                       long long C, long long inner, Act a, cudaStream_t stream) {
  if (n < (1LL << 31) - 16)
    return launch<T, uint32_t>(x, b, y, n, C, inner, a, stream);
  return launch<T, unsigned long long>(x, b, y, n, C, inner, a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. x and y: n elements, dense,
// with the same strides. b: fp32 [C], or null for no bias; the bias dim has
// size C and stride `inner` (elements). act: code of ActKind. clamp < 0
// means none. Returns the cudaError_t of the launch.
extern "C" int ealdm_bias_act(const void* x, const void* b, void* y, int dtype,
                              long long n, long long C, long long inner,
                              int act, float alpha, float gain, float clamp,
                              void* stream) {
  if (n <= 0 || C <= 0 || inner <= 0 || act < 0 || act >= NUM_ACTS)
    return (int)cudaErrorInvalidValue;
  const Act a{act, alpha, gain, clamp};
  const float* bp = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_any<float>(x, bp, y, n, C, inner, a, s);
  if (dtype == 1) return (int)launch_any<__nv_bfloat16>(x, bp, y, n, C, inner, a, s);
  if (dtype == 2) return (int)launch_any<__half>(x, bp, y, n, C, inner, a, s);
  return (int)cudaErrorInvalidValue;
}
