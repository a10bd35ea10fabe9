// Depthwise 7x7 conv + bias + channel LayerNorm of NHWC tokens, by one warp.
//
// Shared by dwconv_ln.cu (the whole op), convnext_block.cu (its prologue) and
// dwconv_bwd.cu (the plain stencil, and the LayerNorm statistics of the
// backward).
// Lane `l` owns the channel pairs p = l + 32*q, so every tap is one coalesced
// read of the token's channel row; the 7x7 halo comes through L1/L2. A warp
// carries a few tokens at once so each filter row serves all of them. All
// math is f32, as in the TPU kernels (spine_vision_tpu/ops/dwconv.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Tokens a warp carries at once: each tap's filter row is loaded once for
// all of them, and their loads interleave. Fewer at wide C, for registers.
template <int C>
struct TokensPerWarp {
  static constexpr int value = C <= 512 ? 4 : (C <= 1024 ? 2 : 1);
};

// For TB tokens (b[i], h[i], w[i]) of one warp, with ok[i] false for a token
// past the end: y[i] = dwconv7x7(x)[b, h, w, :] in f32 (zeros past the end).
// With KEEP_CENTRE, x[b, h, w, :] (the residual) is copied to centre[i].
template <typename T, int C, int TB, bool KEEP_CENTRE>
__device__ __forceinline__ void dw_tokens(
    const T* __restrict__ x, const T* __restrict__ k, const int (&b)[TB],
    const int (&h)[TB], const int (&w)[TB], const bool (&ok)[TB], int H, int W,
    int lane, float (&y)[TB][Lanes<C>::NP][2], T* const (&centre)[TB]) {
  static_assert(!KEEP_CENTRE || sizeof(T) == 2, "the residual copy is for bf16");
  constexpr int NP = Lanes<C>::NP;
#pragma unroll
  for (int i = 0; i < TB; ++i)
#pragma unroll
    for (int q = 0; q < NP; ++q) y[i][q][0] = y[i][q][1] = 0.f;

  for (int dy = 0; dy < KS; ++dy) {
    for (int dx = 0; dx < KS; ++dx) {
      const T* kp = k + (dy * KS + dx) * C;
      float2 kv[NP];
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const int p = lane + 32 * q;
        kv[q] = Lanes<C>::valid(p) ? load2(kp + 2 * p) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < TB; ++i) {
        const int hh = h[i] + dy - PAD;
        const int ww = w[i] + dx - PAD;
        if (!ok[i] || hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
        const T* xp = x + ((size_t)(b[i] * H + hh) * W + ww) * C;
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          const int p = lane + 32 * q;
          if (Lanes<C>::valid(p)) {
            const float2 xv = load2(xp + 2 * p);
            y[i][q][0] = fmaf(xv.x, kv[q].x, y[i][q][0]);
            y[i][q][1] = fmaf(xv.y, kv[q].y, y[i][q][1]);
            if (KEEP_CENTRE && dy == PAD && dx == PAD)
              *reinterpret_cast<uint32_t*>(centre[i] + 2 * p) =
                  *reinterpret_cast<const uint32_t*>(xp + 2 * p);
          }
        }
      }
    }
  }
}

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

// For TB tokens of one warp (as dw_tokens):
// y[i] = LN(dwconv7x7(x)[b, h, w, :] + bias) * scale + beta.
// With EMIT_T, t = dwconv7x7(x) + bias is rounded to T, written to trow[i]
// (for each token in range) and the LayerNorm reads the rounded t.
template <typename T, int C, int TB, bool KEEP_CENTRE, bool EMIT_T = false>
__device__ __forceinline__ void dw_ln_tokens(
    const T* __restrict__ x, const T* __restrict__ k,
    const float* __restrict__ bias, const float* __restrict__ scale,
    const float* __restrict__ beta, const int (&b)[TB], const int (&h)[TB],
    const int (&w)[TB], const bool (&ok)[TB], int H, int W, float eps,
    int lane, float (&y)[TB][Lanes<C>::NP][2], T* const (&centre)[TB],
    T* const* trow = nullptr) {
  constexpr int NP = Lanes<C>::NP;
  dw_tokens<T, C, TB, KEEP_CENTRE>(x, k, b, h, w, ok, H, W, lane, y, centre);
#pragma unroll
  for (int i = 0; i < TB; ++i) {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      if (Lanes<C>::valid(p)) {
        const float2 bv = load2(bias + 2 * p);
        y[i][q][0] += bv.x;
        y[i][q][1] += bv.y;
        if constexpr (EMIT_T) {
          static_assert(!EMIT_T || sizeof(T) == 2, "t is emitted in bf16");
          const __nv_bfloat162 tv = __floats2bfloat162_rn(y[i][q][0], y[i][q][1]);
          if (ok[i]) *reinterpret_cast<__nv_bfloat162*>(trow[i] + 2 * p) = tv;
          const float2 tf = __bfloat1622float2(tv);
          y[i][q][0] = tf.x;
          y[i][q][1] = tf.y;
        }
      }
    }
    float mu;
    const float rstd = centre_rstd<C>(y[i], eps, lane, mu);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      if (Lanes<C>::valid(p)) {
        const float2 sv = load2(scale + 2 * p);
        const float2 bv = load2(beta + 2 * p);
        y[i][q][0] = y[i][q][0] * rstd * sv.x + bv.x;
        y[i][q][1] = y[i][q][1] * rstd * sv.y + bv.y;
      }
    }
  }
}

// Flat token index -> (b, h, w); ok is false past the last token.
__device__ __forceinline__ void token_coords(long long tok, long long M, int H,
                                             int W, int& b, int& h, int& w,
                                             bool& ok) {
  ok = tok < M;
  const long long t = ok ? tok : 0;
  w = (int)(t % W);
  const long long r = t / W;
  h = (int)(r % H);
  b = (int)(r / H);
}

}  // namespace svt
