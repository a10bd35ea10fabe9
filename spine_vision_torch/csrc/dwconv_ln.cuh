// Channel helpers of the depthwise 7x7 conv and LayerNorm kernels, NHWC: the
// filter's size, the widths the stencil kernels are built for, f32 loads and
// stores of a channel pair, a warp's sum, the channel pairs a lane owns and
// one token's LayerNorm statistics held in a warp's registers.
//
// Included by dw_stage.cuh (the stencils on shared-memory halos: #2, #3, #4
// and #10's ends), wg_gemm.cuh (and through it #1's prologue in
// convnext_block.cu, #7's LayerNorm rows in row_mlp.cu and the MLP backward)
// and mlp_body.cuh. All math is f32, as in the TPU kernels
// (spine_vision_tpu/ops/dwconv.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace svt {

constexpr int KS = 7;
constexpr int PAD = 3;

// The widths the stencil kernels are built for (ops/dwconv.py::KERNEL_WIDTHS):
// every ConvNeXt v1/v2 stage width. X(C) is expanded for each.
#define SVT_DW_WIDTHS(X)                                                            \
  X(96) X(128) X(192) X(256) X(352) X(384) X(512) X(704) X(768) X(1024) X(1408) \
  X(1536) X(2048) X(2816)

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Channel pairs each lane owns for width C.
template <int C>
struct Lanes {
  static_assert(C % 8 == 0, "channel width must be a multiple of 8");
  static constexpr int NP = (C / 2 + 31) / 32;
  static __device__ __forceinline__ bool valid(int p) {
    return (C / 2) % 32 == 0 || p < C / 2;
  }
};

// One token's channels v (lane-owned pairs) minus their mean mu over the C
// channels, in place; returns rstd = 1 / sqrt(var + eps), var the mean of the
// centred squares.
template <int C>
__device__ __forceinline__ float centre_rstd(float (&v)[Lanes<C>::NP][2], float eps,
                                             int lane, float& mu) {
  constexpr int NP = Lanes<C>::NP;
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < NP; ++q)
    if (Lanes<C>::valid(lane + 32 * q)) s += v[q][0] + v[q][1];
  mu = warp_sum(s) * (1.f / C);
  float s2 = 0.f;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    if (Lanes<C>::valid(lane + 32 * q)) {
      v[q][0] -= mu;
      v[q][1] -= mu;
      s2 += v[q][0] * v[q][0] + v[q][1] * v[q][1];
    }
  }
  return rsqrtf(warp_sum(s2) * (1.f / C) + eps);
}

}  // namespace svt
