// Whole ConvNeXt v1 block backward, NHWC bf16, for Hopper: from x and the
// gradient g of out = x + gamma * (W2 . gelu_tanh(W1 . y + b1) + b2), with
// u = dwconv7x7(x) + b_dw and y = LN(u) * ln_scale + ln_bias,
//   g_u (the conv output's gradient, bf16), dk [49, C], ddwb, dln_scale,
//   dln_bias, dW1, db1, dW2, db2, dgamma (f32).
// The caller adds dx = g + dwconv7x7(g_u, flipped k) (the stencil of
// dwconv_bwd.cu), as the JAX package adds it in XLA.
//
// Replaces spine_vision_tpu/ops/block_train.py::_block_train_bwd_pallas
// (_make_bwd_kernel), with its rounding points: u is recomputed in f32 and
// not rounded; y, h, g * gamma, the hidden gradient and g enter the products
// in bf16; db1 sums the unrounded f32 hidden gradient; the LayerNorm
// backward runs in f32; g_u is written in bf16, and dk = sum x_halo * g_u and
// ddwb = sum g_u take the unrounded f32 g_u.
//
// Bound: the five bf16 products of the MLP backward, 40 * M * C^2 flops (the
// stencil recompute and the tap sums add 196 * M * C f32 operations, a
// fifth of that time at C = 128 and less above), so the tensor cores bound it.
//
// Design. The TPU kernel keeps a halo tile of x, the f32 LayerNorm state and
// every parameter gradient resident in VMEM and walks tiles in grid order.
// Here the MLP backward's stages (ln_mlp_bwd.cuh) already stream their
// operands through shared memory, so the f32 u and g_u go through device
// memory (4 * M * C bytes each way, about a tenth of the products' time at
// C = 128):
//   1. conv_bias_f32: u = dwconv7x7(x) + b_dw in f32 (dwconv_ln.cuh's
//      stencil, a warp per few tokens).
//   2. mlp_bwd<true, true> (ln_mlp_bwd.cuh): the LN+MLP backward's stages
//      reading the f32 u: y and g * gamma, the wgmma products for the hidden,
//      g_y and the weight gradients, and the LayerNorm backward, which writes
//      g_u in bf16 and in f32; the column sums of the per-tile rows (db1,
//      dln_scale, dln_bias, db2).
//   3. tap_sums: dk and ddwb, a CTA per 64 channels and a run of image rows;
//      warp dy owns filter row dy, each lane a channel pair, and for 7 tokens
//      along W at a time a thread loads the 13 x values of its row once for
//      its 7 taps. Per-CTA partials go to a workspace row, and colsum
//      (reduce.cuh) adds the rows in a fixed order.
// Every sum has one order, so two runs agree bit for bit.
#include "ln_mlp_bwd.cuh"

namespace {

using svt::KS;
using svt::PAD;

constexpr int NTAP = KS * KS + 1;  // a tap_sums workspace row: dk (49 taps), ddwb
constexpr int CG = 64;             // channels a tap_sums CTA: a pair a lane
constexpr int TG = 7;              // tokens along W a tap_sums step
constexpr int NXR = TG + KS - 1;   // x values of a filter row for TG tokens

// u = dwconv7x7(x) + bias, in f32.
template <int C>
__global__ void __launch_bounds__(256) conv_bias_f32(const bf16* __restrict__ x,
                                                     const bf16* __restrict__ k,
                                                     const float* __restrict__ bias,
                                                     float* __restrict__ u, int B, int H,
                                                     int W) {
  constexpr int NP = Lanes<C>::NP;
  constexpr int TB = svt::TokensPerWarp<C>::value;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long M = (long long)B * H * W;
  const long long tok0 = ((long long)blockIdx.x * 8 + warp) * TB;
  if (tok0 >= M) return;
  int b[TB], h[TB], w[TB];
  bool ok[TB];
  bf16* none[TB];
#pragma unroll
  for (int i = 0; i < TB; ++i) {
    svt::token_coords(tok0 + i, M, H, W, b[i], h[i], w[i], ok[i]);
    none[i] = nullptr;
  }
  float y[TB][NP][2];
  svt::dw_tokens<bf16, C, TB, false>(x, k, b, h, w, ok, H, W, lane, y, none);
#pragma unroll
  for (int i = 0; i < TB; ++i) {
    if (!ok[i]) continue;
    float* up = u + (tok0 + i) * C;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      if (!Lanes<C>::valid(p)) continue;
      const float2 bv = svt::load2(bias + 2 * p);
      svt::store2(up + 2 * p, y[i][q][0] + bv.x, y[i][q][1] + bv.y);
    }
  }
}

// dk[dy * 7 + dx][c] = sum over tokens (h, w) of x[h + dy - 3][w + dx - 3][c]
// * gu[h][w][c] and ddwb[c] = sum gu[h][w][c], over rows [r0, r1) of the
// B * H image rows and channels [64 * blockIdx.x, + 64): this CTA's row of
// part.
__global__ void __launch_bounds__(KS * 32) tap_sums(const bf16* __restrict__ x,
                                                    const float* __restrict__ gu,
                                                    float* __restrict__ part, int B, int H,
                                                    int W, int C, int rows_per_cta) {
  const int dy = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * CG + 2 * lane;
  const bool cok = c < C;  // C is even: c + 1 < C too
  const long long rows = (long long)B * H;
  const long long r0 = (long long)blockIdx.y * rows_per_cta;
  const long long r1 = rows < r0 + rows_per_cta ? rows : r0 + rows_per_cta;
  const float2 zero = make_float2(0.f, 0.f);
  float dk[KS][2];
#pragma unroll
  for (int dx = 0; dx < KS; ++dx) dk[dx][0] = dk[dx][1] = 0.f;
  float2 sb = zero;

  for (long long r = r0; r < r1; ++r) {
    const int h = (int)(r % H);
    const int hh = h + dy - PAD;
    const bool rok = cok && hh >= 0 && hh < H;
    const bf16* xrow = x + ((rok ? r - h + hh : 0) * W) * (long long)C + c;  // image row hh
    const float* grow = gu + r * W * (long long)C + c;
    for (int w0 = 0; w0 < W; w0 += TG) {
      float2 gv[TG];
#pragma unroll
      for (int j = 0; j < TG; ++j)
        gv[j] = (cok && w0 + j < W) ? svt::load2(grow + (long long)(w0 + j) * C) : zero;
      if (dy == 0) {  // one warp sums ddwb
#pragma unroll
        for (int j = 0; j < TG; ++j) {
          sb.x += gv[j].x;
          sb.y += gv[j].y;
        }
      }
      if (!rok) continue;  // filter row dy falls outside the image
      float2 xr[NXR];
#pragma unroll
      for (int i = 0; i < NXR; ++i) {
        const int ww = w0 - PAD + i;
        xr[i] = (ww >= 0 && ww < W) ? svt::load2(xrow + (long long)ww * C) : zero;
      }
#pragma unroll
      for (int j = 0; j < TG; ++j) {
#pragma unroll
        for (int dx = 0; dx < KS; ++dx) {
          dk[dx][0] = fmaf(xr[j + dx].x, gv[j].x, dk[dx][0]);
          dk[dx][1] = fmaf(xr[j + dx].y, gv[j].y, dk[dx][1]);
        }
      }
    }
  }
  if (!cok) return;
  float* out = part + (size_t)blockIdx.y * NTAP * C;
#pragma unroll
  for (int dx = 0; dx < KS; ++dx)
    svt::store2(out + (size_t)(dy * KS + dx) * C + c, dk[dx][0], dk[dx][1]);
  if (dy == 0) svt::store2(out + (size_t)(KS * KS) * C + c, sb.x, sb.y);
}

int launch_conv(const void* x, const void* k, const void* bias, void* u, int B, int H,
                int W, int C, cudaStream_t s) {
  const long long tokens = (long long)B * H * W;
#define SVT_CONV_CASE(CC)                                                                \
  case CC:                                                                               \
    conv_bias_f32<CC><<<(unsigned)((tokens + 8 * svt::TokensPerWarp<CC>::value - 1) /    \
                                   (8 * svt::TokensPerWarp<CC>::value)),                 \
                        256, 0, s>>>((const bf16*)x, (const bf16*)k, (const float*)bias, \
                                     (float*)u, B, H, W);                                \
    break;
  switch (C) {
    SVT_CONV_CASE(96)
    SVT_CONV_CASE(128)
    SVT_CONV_CASE(192)
    SVT_CONV_CASE(256)
    SVT_CONV_CASE(384)
    SVT_CONV_CASE(512)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SVT_CONV_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// x, g, gu [B, H, W, C] and k [49, C] bf16; weights bf16 in both layouts (w1t
// [4C, C] and w1 [C, 4C], w2t [C, 4C] and w2 [4C, C]); bias, ls, lb, b1, b2,
// gamma f32. Outputs: gu (bf16); small f32 [8C] = db1 (4C), dln_scale,
// dln_bias, db2, sum g; dw1t [4C, C], dw2t [C, 4C], dgamma [C] and taps
// [50 * C] = dk (49 taps of C), ddwb, f32. Scratch from the caller: u, gu32
// and gy (f32 [M, C]), y and gg ([M, C] bf16), stats (f32 [M, 2]), h, gh
// ([M, 4C] bf16), part f32 [ceil(M / 64), 8C], ws f32 [splits, 4C, C] (ks
// tokens a split), tpart f32 [ceil(B * H / rows_per_cta), 50 * C]. Returns the
// first cudaError_t of its launches.
extern "C" int svt_block_train_bwd(
    const void* x, const void* k, const void* bias, const void* ls, const void* lb,
    const void* w1t, const void* w1, const void* b1, const void* w2t, const void* w2,
    const void* b2, const void* gamma, const void* g, void* gu, void* small, void* dw1t,
    void* dw2t, void* dgamma, void* taps, void* u, void* gu32, void* y, void* gg, void* stats,
    void* h, void* gh, void* gy, void* part, void* ws, void* tpart, int B, int H, int W, int C,
    int splits, long long ks, int rows_per_cta, float eps, void* stream) {
  const long long M = (long long)B * H * W;
  if (M == 0 || rows_per_cta <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = launch_conv(x, k, bias, u, B, H, W, C, s);
  if (err) return err;
  const MlpBwd a{u, (const bf16*)g, (const bf16*)w1t, (const bf16*)w1, (const bf16*)w2t,
                 (const bf16*)w2, (const float*)ls, (const float*)lb, (const float*)b1,
                 (const float*)b2, (const float*)gamma, (bf16*)gu, (float*)gu32, (float*)small,
                 (float*)dw1t, (float*)dw2t, (float*)dgamma, (bf16*)y, (bf16*)gg, (bf16*)h,
                 (bf16*)gh, (float*)stats, (float*)gy, (float*)part, (float*)ws, M, ks, C,
                 splits, eps};
  err = mlp_bwd<true, true>(a, s);
  if (err) return err;
  const long long P = ((long long)B * H + rows_per_cta - 1) / rows_per_cta;
  tap_sums<<<dim3((unsigned)((C + CG - 1) / CG), (unsigned)P), KS * 32, 0, s>>>(
      (const bf16*)x, (const float*)gu32, (float*)tpart, B, H, W, C, rows_per_cta);
  if ((err = (int)cudaGetLastError())) return err;
  svt::colsum<<<(unsigned)((NTAP * C + 31) / 32), dim3(32, 32), 0, s>>>(
      (const float*)tpart, P, NTAP * C, (float*)taps);
  return (int)cudaGetLastError();
}
