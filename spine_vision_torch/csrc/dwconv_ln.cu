// Fused depthwise 7x7 conv + bias + channel LayerNorm, NHWC, for Hopper.
//
// Replaces spine_vision_tpu/ops/dwconv.py::_dw_ln_pallas (_make_dw_ln_kernel).
// On the main path it runs the three ConvNeXt-base blocks at C = 1024, 16x16,
// 16 images: 4096 tokens, 8.4 MB in and out in bf16. The op is bound by bytes
// (about 2 * 49 * C flops per token against 4 * C bytes): its floor on an
// H100 is the activation read plus write over 3.35 TB/s. Design: 8 warps a
// block, each carrying up to four tokens so every filter row it loads serves
// all of them; each tap is a coalesced read of a channel row, neighbouring
// tokens share their halo through L1/L2, so device memory sees x about once. The per-token LayerNorm is a warp
// reduction held in registers, so the conv output never leaves the SM.
#include "dwconv_ln.cuh"

namespace {

template <typename T, int C>
__global__ void __launch_bounds__(256) dw_ln_kernel(
    const T* __restrict__ x, const T* __restrict__ k,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ beta, T* __restrict__ out, int B, int H, int W,
    float eps) {
  constexpr int NP = svt::Lanes<C>::NP;
  constexpr int TB = svt::TokensPerWarp<C>::value;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long M = (long long)B * H * W;
  const long long tok0 = ((long long)blockIdx.x * 8 + warp) * TB;
  if (tok0 >= M) return;
  int b[TB], h[TB], w[TB];
  bool ok[TB];
  T* none[TB];
#pragma unroll
  for (int i = 0; i < TB; ++i) {
    svt::token_coords(tok0 + i, M, H, W, b[i], h[i], w[i], ok[i]);
    none[i] = nullptr;
  }
  float y[TB][NP][2];
  svt::dw_ln_tokens<T, C, TB, false>(x, k, bias, scale, beta, b, h, w, ok, H,
                                     W, eps, lane, y, none);
#pragma unroll
  for (int i = 0; i < TB; ++i) {
    if (!ok[i]) continue;
    T* op = out + (tok0 + i) * C;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      if (svt::Lanes<C>::valid(p)) svt::store2(op + 2 * p, y[i][q][0], y[i][q][1]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* k, const void* bias, const void* scale,
           const void* beta, void* out, int B, int H, int W, int C, float eps,
           cudaStream_t stream) {
  const long long tokens = (long long)B * H * W;
#define SVT_DW_LN_CASE(CC)                                                   \
  case CC:                                                                   \
    dw_ln_kernel<T, CC><<<(unsigned)((tokens + 8 * svt::TokensPerWarp<CC>::value - 1) / \
                              (8 * svt::TokensPerWarp<CC>::value)),          \
                          256, 0, stream>>>(                                 \
        (const T*)x, (const T*)k, (const float*)bias, (const float*)scale,   \
        (const float*)beta, (T*)out, B, H, W, eps);                          \
    break;
  switch (C) {
    SVT_DW_WIDTHS(SVT_DW_LN_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SVT_DW_LN_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = f32 (x, k and out share it; bias/scale/beta are f32).
// Returns the cudaError_t of the launch.
extern "C" int svt_dw_ln_forward(const void* x, const void* k, const void* bias,
                                 const void* scale, const void* beta, void* out,
                                 int dtype, int B, int H, int W, int C,
                                 float eps, void* stream) {
  if (B * H * W == 0) return 0;
  if (dtype == 0)
    return launch<__nv_bfloat16>(x, k, bias, scale, beta, out, B, H, W, C, eps,
                                 (cudaStream_t)stream);
  if (dtype == 1)
    return launch<float>(x, k, bias, scale, beta, out, B, H, W, C, eps,
                         (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
