// Activations of the GELU-cost and MLP-ablation probes (probe_gelu.cu,
// probe_mlp.cu), beside the production tanh-GELU of gelu.cuh, and the tanh
// form of the GELU with its derivative. Each takes the f32 pre-activation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gelu.cuh"

namespace svt {

// (gelu(x), gelu'(x)) from one tanhf, as fused_mlp.py::_gelu_and_grad writes
// it: the form the TPU kernels and the first CUDA MLP backward computed (the
// Hopper backward takes them from one exponential, gelu.cuh).
__device__ __forceinline__ void gelu_and_grad_tanh(float x, float& h, float& dh) {
  const float x2 = x * x;
  const float th = tanhf(GELU_C * (x + GELU_A * x * x2));
  const float half_1pt = 0.5f * (1.f + th);
  const float du = GELU_C * (1.f + 3.f * GELU_A * x2);
  h = x * half_1pt;
  dh = half_1pt + 0.5f * x * (1.f - th * th) * du;
}

// GELU through the Abramowitz & Stegun 7.1.26 erf (|error| < 1.5e-7), in f32,
// as scripts/ablate_mlp_kernel.py::_erf_gelu: the TPU kernels' erf-GELU
// before they moved to tanh.
__device__ __forceinline__ float erf_gelu(float x) {
  const float z = x * 0.7071067811865476f;
  const float az = fabsf(z);
  const float t = 1.f / (1.f + 0.3275911f * az);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float erf_abs = 1.f - poly * expf(-az * az);
  const float erf = z > 0.f ? erf_abs : (z < 0.f ? -erf_abs : 0.f);
  return 0.5f * x * (1.f + erf);
}

// The same formula in bf16 arithmetic on a pair, the script's "gelu_bf16":
// the pre-activations rounded to bf16, then every operation a packed bf16x2
// instruction rounding to bf16 (its constants bf16 too; exp is the card's
// bf16 approximation), as JAX evaluates the formula on a bf16 array.
__device__ __forceinline__ __nv_bfloat162 erf_gelu_bf16(__nv_bfloat162 x) {
  const auto k = [](float v) { return __float2bfloat162_rn(v); };
  const __nv_bfloat162 one = k(1.f), zero = k(0.f);
  const __nv_bfloat162 z = __hmul2(x, k(0.7071067811865476f));
  const __nv_bfloat162 az = __habs2(z);
  const __nv_bfloat162 t = __h2div(one, __hadd2(one, __hmul2(k(0.3275911f), az)));
  __nv_bfloat162 p = __hmul2(t, k(1.061405429f));
  p = __hmul2(t, __hadd2(k(-1.453152027f), p));
  p = __hmul2(t, __hadd2(k(1.421413741f), p));
  p = __hmul2(t, __hadd2(k(-0.284496736f), p));
  p = __hmul2(t, __hadd2(k(0.254829592f), p));
  const __nv_bfloat162 erf_abs = __hsub2(one, __hmul2(p, h2exp(__hneg2(__hmul2(az, az)))));
  const __nv_bfloat162 sign = __hsub2(__hgt2(z, zero), __hlt2(z, zero));
  return __hmul2(__hmul2(k(0.5f), x), __hadd2(one, __hmul2(sign, erf_abs)));
}

}  // namespace svt

// The activations the MLP body (mlp_body.cuh) takes as its Act parameter,
// besides its default GeluTanh.
struct ErfF32 {  // the script's "full"
  static __device__ __forceinline__ float2 apply(float a, float b) {
    return make_float2(svt::erf_gelu(a), svt::erf_gelu(b));
  }
};
struct Relu {
  static __device__ __forceinline__ float2 apply(float a, float b) {
    return make_float2(fmaxf(a, 0.f), fmaxf(b, 0.f));
  }
};
struct ErfBf16 {  // the script's "gelu_bf16"
  static __device__ __forceinline__ float2 apply(float a, float b) {
    return __bfloat1622float2(svt::erf_gelu_bf16(__floats2bfloat162_rn(a, b)));
  }
};
struct NoAct {  // the script's "matmul_only": h is only rounded to bf16
  static __device__ __forceinline__ float2 apply(float a, float b) {
    return make_float2(a, b);
  }
};
