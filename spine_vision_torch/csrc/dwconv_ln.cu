// Fused depthwise 7x7 conv + bias + channel LayerNorm, NHWC, for Hopper.
//
// Replaces spine_vision_tpu/ops/dwconv.py::_dw_ln_pallas (_make_dw_ln_kernel).
// It runs the three ConvNeXt-base blocks of C = 1024 at inference (16 images
// at 16x16) and, in the all-kernel training mode, every block's forward at
// C = 1024 and the backward's recompute of y at C <= 512 (32 images).
//
// Bound. The conv does 98 f32 operations a channel of a token and the
// LayerNorm about 8 against 4 bytes in bf16 (x read, y written): on an H100
// (67 TFLOP/s f32, 3.35 TB/s) operations bound it, so each x element must come
// from shared memory, not from L1/L2 once for each of its 49 taps.
//
// Design: #4's statistics kernel S with a y epilogue. A CTA takes a PH x 8
// tile of one image at full C; the halo streams through two shared-memory
// slots in 64-channel chunks (cp.async, zeros outside the image and past C)
// and the f32 conv plus bias goes to a shared tile [PH * 8, C]
// (dw_stage.cuh's conv_tile, S's own prologue). Then a warp takes a token (its
// tile column, row by row): the mean, the mean of the centred squares, rstd,
// and y = (a - mean) * rstd * scale + beta, written once in x's dtype. PH is
// the largest of 8, 4, 2, 1 that leaves room for two CTAs a multiprocessor
// (dws::Stats).
#include "dw_stage.cuh"

namespace {

// y over a PH x 8 tile of one image; tokens outside the image are computed
// on zeros and never stored.
template <typename T, int C>
__global__ void __launch_bounds__(dws::Stats<T, C>::NT, 2) dw_ln_tile(
    const T* __restrict__ x, const T* __restrict__ k, const float* __restrict__ bias,
    const float* __restrict__ scale, const float* __restrict__ beta, T* __restrict__ out, int H,
    int W, int tiles_h, int tiles_w, float eps) {
  using G = dws::Stats<T, C>;
  constexpr int NP = svt::Lanes<C>::NP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sT = reinterpret_cast<float*>(smem_raw);
  T* ring = reinterpret_cast<T*>(smem_raw + G::T_BYTES);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tw = blockIdx.x % tiles_w;
  const int th = (blockIdx.x / tiles_w) % tiles_h;
  const int b = blockIdx.x / (tiles_w * tiles_h);
  const int h0 = th * G::PH, w0 = tw * G::TW;
  const int wcol = w0 + warp;  // this warp's image column

  dws::conv_tile<T, C>(sT, ring, x, k, bias, b, h0, w0, H, W);

  for (int r = 0; r < G::PH; ++r) {
    const int hh = h0 + r;
    if (hh >= H || wcol >= W) continue;  // uniform over the warp
    const float* arow = sT + (r * G::TW + warp) * C;
    float v[NP][2];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      v[q][0] = v[q][1] = 0.f;
      if (svt::Lanes<C>::valid(p)) {
        const float2 a = svt::load2(arow + 2 * p);
        v[q][0] = a.x;
        v[q][1] = a.y;
      }
    }
    float mu;
    const float rstd = svt::centre_rstd<C>(v, eps, lane, mu);  // v now a - mu
    T* op = out + (((size_t)b * H + hh) * W + wcol) * C;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      if (!svt::Lanes<C>::valid(p)) continue;
      const float2 sv = svt::load2(scale + 2 * p);
      const float2 bv = svt::load2(beta + 2 * p);
      svt::store2(op + 2 * p, v[q][0] * rstd * sv.x + bv.x, v[q][1] * rstd * sv.y + bv.y);
    }
  }
}

template <typename T, int C>
int launch_tile(const void* x, const void* k, const void* bias, const void* scale,
                const void* beta, void* out, int B, int H, int W, float eps, cudaStream_t s) {
  using G = dws::Stats<T, C>;
  int err;
  if ((err = dws::smem_attr(dw_ln_tile<T, C>, G::BYTES))) return err;
  const int tiles_h = (H + G::PH - 1) / G::PH, tiles_w = (W + G::TW - 1) / G::TW;
  dw_ln_tile<T, C><<<(unsigned)((long long)B * tiles_h * tiles_w), G::NT, G::BYTES, s>>>(
      (const T*)x, (const T*)k, (const float*)bias, (const float*)scale, (const float*)beta,
      (T*)out, H, W, tiles_h, tiles_w, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* k, const void* bias, const void* scale,
           const void* beta, void* out, int B, int H, int W, int C, float eps,
           cudaStream_t s) {
#define SVT_DW_LN_CASE(CC) \
  case CC:                 \
    return launch_tile<T, CC>(x, k, bias, scale, beta, out, B, H, W, eps, s);
  switch (C) {
    SVT_DW_WIDTHS(SVT_DW_LN_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SVT_DW_LN_CASE
}

}  // namespace

// dtype: 0 = bf16, 1 = f32 (x, k and out share it; bias/scale/beta are f32).
// Returns the cudaError_t of the launch.
extern "C" int svt_dw_ln_forward(const void* x, const void* k, const void* bias,
                                 const void* scale, const void* beta, void* out,
                                 int dtype, int B, int H, int W, int C,
                                 float eps, void* stream) {
  if ((long long)B * H * W == 0) return 0;
  if (B < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<__nv_bfloat16>(x, k, bias, scale, beta, out, B, H, W, C, eps,
                                 (cudaStream_t)stream);
  if (dtype == 1)
    return launch<float>(x, k, bias, scale, beta, out, B, H, W, C, eps,
                         (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
