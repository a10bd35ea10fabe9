// The tanh-approximate GELU, its derivative and bf16 rounding, shared by the
// MLP kernels' bodies (mma_bf16.cuh's users) and the MLP backward
// (ln_mlp_bwd.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace svt {

constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float GELU_A = 0.044715f;

// tanh-approximate GELU, as spine_vision_tpu/ops/fused_mlp.py::_tanh_gelu.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float u = GELU_C * (x + GELU_A * x * x * x);
  return 0.5f * x * (1.f + tanhf(u));
}

// (gelu(x), gelu'(x)) from one exponential, as fused_mlp.py::_gelu_and_grad.
// With e = exp(2u), r = 1 / (1 + e) and p = e r: 0.5 (1 + tanh u) = p and
// 0.5 (1 - tanh u) = r, so gelu = x p and gelu' = p + 2 x p r du, with no
// 1 - tanh^2 to cancel. __expf and the fast reciprocal keep each within about
// 1e-6 of its value, far inside a bf16 step, at a fraction of tanhf's
// instructions (u is capped at 15, where p is 1 in f32).
__device__ __forceinline__ void gelu_and_grad(float x, float& h, float& dh) {
  const float x2 = x * x;
  const float u = fminf(GELU_C * (x + GELU_A * x * x2), 15.f);
  const float e = __expf(2.f * u);
  const float r = __fdividef(1.f, 1.f + e);
  const float p = e * r;
  const float du = GELU_C * (1.f + 3.f * GELU_A * x2);
  h = x * p;
  dh = p + 2.f * x * p * r * du;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

}  // namespace svt
