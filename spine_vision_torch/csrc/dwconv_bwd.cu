// Backward of the fused depthwise 7x7 conv + bias + channel LayerNorm
// (dwconv_ln.cu), and the plain 7x7 depthwise stencil, NHWC, for Hopper.
//
// Replaces spine_vision_tpu/ops/dwconv.py::_dw_ln_bwd_pallas
// (_make_dw_ln_bwd_kernel) and depthwise_conv7x7 (_make_dw_kernel). With
// a = dwconv7x7(x) + bias, yhat = (a - mean) * rstd over the channels and the
// gradient g of y = yhat * scale + beta, all in f32:
//   da     = rstd * (g*scale - mean(g*scale) - yhat * mean(g*scale*yhat)),
//   dk     = sum over tokens of x_halo[tap] * da,   dbias = sum da,
//   dscale = sum g * yhat,                          dbeta = sum g,
// the sums over the unrounded da, which is then written in x's dtype. dx is
// the stencil on da with the spatially flipped filter; the caller launches it
// (svt_dwconv7x7).
//
// Bound: the conv recompute and dk each do 2 * 49 f32 flops a channel of a
// token, the LayerNorm statistics and backward about 17 more (213 * M * C),
// against 6 * M * C bytes in bf16 (x and g read, da written), so on an H100
// (67 TFLOP/s f32, 3.35 TB/s) f32 operations bound it; the stencil alone
// (98 * M * C flops, 4 * M * C bytes) too.
//
// Design. The TPU adds every tile's parameter gradients into one resident
// output block in grid order; a CUDA grid runs in parallel, so:
//   1. dw_ln_stats, a warp per few tokens with dwconv_ln.cuh's stencil and
//      shuffle LayerNorm over whole channel rows: per token mu, rstd,
//      mean(g*scale) and mean(g*scale*yhat), 16 bytes.
//   2. dw_ln_bwd_tile, a CTA per 64 channels and a run of image rows: warp dy
//      owns filter row dy, each lane a channel pair. For 7 tokens along W at a
//      time a thread loads the 13 x values of its filter row once and uses
//      them twice: for its row's share of the conv (the 7 shares are added
//      through shared memory in a fixed order) and, once da is known, for its
//      7 taps of dk. Warp j finalises token j: da from the statistics, written
//      in x's dtype. Every sum runs in one thread's registers in token order,
//      and the CTA writes its partials (49 taps, dbias, dscale, dbeta) to its
//      own row of a workspace.
//   3. colsum (reduce.cuh) adds the rows in a fixed order, so two runs agree
//      bit for bit; there are no float atomics.
// The conv is recomputed twice (step 1 needs whole channel rows, step 2
// channel tiles): about 1.5 times the bound's flops. The channel count is a
// runtime argument of step 2; step 1 and the stencil take the widths
// dwconv_ln.cu is built for.
#include "dwconv_ln.cuh"
#include "reduce.cuh"

namespace {

using svt::KS;
using svt::PAD;

constexpr int NSUM = KS * KS + 3;  // a workspace row: dk (49 taps), dbias, dscale, dbeta
constexpr int CG = 64;             // channels a tile CTA: a pair a lane
constexpr int TG = 7;              // tokens along W a step: one a warp at the finalise
constexpr int NXR = TG + KS - 1;   // x values of a filter row for TG tokens

// The plain stencil: out = dwconv7x7(x), summed in f32, rounded to T.
template <typename T, int C>
__global__ void __launch_bounds__(256) dw7_kernel(const T* __restrict__ x,
                                                  const T* __restrict__ k,
                                                  T* __restrict__ out, int B, int H,
                                                  int W) {
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
  svt::dw_tokens<T, C, TB, false>(x, k, b, h, w, ok, H, W, lane, y, none);
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

// Step 1: per token (mu, rstd, mean(g*scale), mean(g*scale*yhat)).
template <typename T, int C>
__global__ void __launch_bounds__(256) dw_ln_stats(
    const T* __restrict__ x, const T* __restrict__ k, const float* __restrict__ bias,
    const float* __restrict__ scale, const T* __restrict__ g,
    float4* __restrict__ stats, int B, int H, int W, float eps) {
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
  float a[TB][NP][2];
  svt::dw_tokens<T, C, TB, false>(x, k, b, h, w, ok, H, W, lane, a, none);
#pragma unroll
  for (int i = 0; i < TB; ++i) {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      if (svt::Lanes<C>::valid(p)) {
        const float2 bv = svt::load2(bias + 2 * p);
        a[i][q][0] += bv.x;
        a[i][q][1] += bv.y;
      }
    }
    float mu;
    const float rstd = svt::centre_rstd<C>(a[i], eps, lane, mu);
    float s1 = 0.f, s2 = 0.f;
    if (ok[i]) {  // uniform over the warp
      const T* gp = g + (tok0 + i) * C;
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const int p = lane + 32 * q;
        if (!svt::Lanes<C>::valid(p)) continue;
        const float2 gv = svt::load2(gp + 2 * p);
        const float2 sv = svt::load2(scale + 2 * p);
        const float d0 = gv.x * sv.x, d1 = gv.y * sv.y;
        s1 += d0 + d1;
        s2 += d0 * (a[i][q][0] * rstd) + d1 * (a[i][q][1] * rstd);
      }
    }
    s1 = svt::warp_sum(s1);
    s2 = svt::warp_sum(s2);
    if (ok[i] && lane == 0)
      stats[tok0 + i] = make_float4(mu, rstd, s1 * (1.f / C), s2 * (1.f / C));
  }
}

// Step 2: da and this CTA's partial parameter sums over rows [r0, r1) of the
// B * H image rows and channels [64 * blockIdx.x, + 64).
template <typename T>
__global__ void __launch_bounds__(KS * 32) dw_ln_bwd_tile(
    const T* __restrict__ x, const T* __restrict__ k, const float* __restrict__ bias,
    const float* __restrict__ scale, const T* __restrict__ g,
    const float4* __restrict__ stats, T* __restrict__ da, float* __restrict__ part,
    int B, int H, int W, int C, int rows_per_cta) {
  static_assert(TG == KS, "warp j finalises token j");
  __shared__ float2 s_conv[KS][TG][32];  // [filter row][token][pair]
  __shared__ float2 s_da[TG][32];
  __shared__ float2 s_sum[KS][3][32];    // [warp][dbias, dscale, dbeta][pair]
  const int dy = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * CG + 2 * lane;
  const bool cok = c < C;  // C is even: c + 1 < C too
  const long long rows = (long long)B * H;
  const long long r0 = (long long)blockIdx.y * rows_per_cta;
  const long long r1 = rows < r0 + rows_per_cta ? rows : r0 + rows_per_cta;

  const float2 zero = make_float2(0.f, 0.f);
  float2 kr[KS];
#pragma unroll
  for (int dx = 0; dx < KS; ++dx) kr[dx] = cok ? svt::load2(k + (dy * KS + dx) * C + c) : zero;
  const float2 bv = cok ? svt::load2(bias + c) : zero;
  const float2 sv = cok ? svt::load2(scale + c) : zero;
  float dk[KS][2];
#pragma unroll
  for (int dx = 0; dx < KS; ++dx) dk[dx][0] = dk[dx][1] = 0.f;
  float2 sb = zero, ss = zero, sg = zero;

  for (long long r = r0; r < r1; ++r) {
    const int h = (int)(r % H);
    const int hh = h + dy - PAD;
    const bool rok = cok && hh >= 0 && hh < H;
    const T* xrow = x + ((rok ? r - h + hh : 0) * W) * (long long)C + c;  // image row hh
    for (int w0 = 0; w0 < W; w0 += TG) {
      float2 xr[NXR];
#pragma unroll
      for (int i = 0; i < NXR; ++i) {
        const int ww = w0 - PAD + i;
        xr[i] = (rok && ww >= 0 && ww < W) ? svt::load2(xrow + (long long)ww * C) : zero;
      }
      // This filter row's share of the conv, for each of the TG tokens.
#pragma unroll
      for (int j = 0; j < TG; ++j) {
        float2 p = zero;
#pragma unroll
        for (int dx = 0; dx < KS; ++dx) {
          p.x = fmaf(xr[j + dx].x, kr[dx].x, p.x);
          p.y = fmaf(xr[j + dx].y, kr[dx].y, p.y);
        }
        s_conv[dy][j][lane] = p;
      }
      __syncthreads();
      // Warp dy finalises token w0 + dy.
      float2 d = zero;
      const int wt = w0 + dy;
      if (cok && wt < W) {
        const long long tok = r * W + wt;
        const float4 st = stats[tok];  // mu, rstd, mean(g*scale), mean(g*scale*yhat)
        float2 a = zero;
#pragma unroll
        for (int rr = 0; rr < KS; ++rr) {
          a.x += s_conv[rr][dy][lane].x;
          a.y += s_conv[rr][dy][lane].y;
        }
        a.x += bv.x;
        a.y += bv.y;
        const float2 gv = svt::load2(g + tok * C + c);
        const float y0 = (a.x - st.x) * st.y, y1 = (a.y - st.x) * st.y;
        d.x = st.y * (gv.x * sv.x - st.z - y0 * st.w);
        d.y = st.y * (gv.y * sv.y - st.z - y1 * st.w);
        svt::store2(da + tok * C + c, d.x, d.y);
        sb.x += d.x;
        sb.y += d.y;
        ss.x += gv.x * y0;
        ss.y += gv.y * y1;
        sg.x += gv.x;
        sg.y += gv.y;
      }
      s_da[dy][lane] = d;
      __syncthreads();
      // dk[dy][dx] += x[h + dy - 3][w + dx - 3] * da[h][w] for the TG tokens.
#pragma unroll
      for (int j = 0; j < TG; ++j) {
        const float2 dj = s_da[j][lane];
#pragma unroll
        for (int dx = 0; dx < KS; ++dx) {
          dk[dx][0] = fmaf(xr[j + dx].x, dj.x, dk[dx][0]);
          dk[dx][1] = fmaf(xr[j + dx].y, dj.y, dk[dx][1]);
        }
      }
    }
  }

  float* out = part + (size_t)blockIdx.y * NSUM * C;
  if (cok) {
#pragma unroll
    for (int dx = 0; dx < KS; ++dx)
      svt::store2(out + (size_t)(dy * KS + dx) * C + c, dk[dx][0], dk[dx][1]);
  }
  s_sum[dy][0][lane] = sb;
  s_sum[dy][1][lane] = ss;
  s_sum[dy][2][lane] = sg;
  __syncthreads();
  if (dy < 3 && cok) {
    float2 tot = zero;
#pragma unroll
    for (int rr = 0; rr < KS; ++rr) {
      tot.x += s_sum[rr][dy][lane].x;
      tot.y += s_sum[rr][dy][lane].y;
    }
    svt::store2(out + (size_t)(KS * KS + dy) * C + c, tot.x, tot.y);
  }
}

template <typename T>
int launch_dw7(const void* x, const void* k, void* out, int B, int H, int W, int C,
               cudaStream_t s) {
  const long long tokens = (long long)B * H * W;
#define SVT_DW7_CASE(CC)                                                            \
  case CC:                                                                          \
    dw7_kernel<T, CC><<<(unsigned)((tokens + 8 * svt::TokensPerWarp<CC>::value - 1) / \
                                   (8 * svt::TokensPerWarp<CC>::value)),            \
                        256, 0, s>>>((const T*)x, (const T*)k, (T*)out, B, H, W);   \
    break;
  switch (C) {
    SVT_DW_WIDTHS(SVT_DW7_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SVT_DW7_CASE
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* k, const void* bias, const void* scale,
               const void* g, void* stats, void* da, void* part, void* sums, int B,
               int H, int W, int C, int rows_per_cta, float eps, cudaStream_t s) {
  const long long tokens = (long long)B * H * W;
#define SVT_STATS_CASE(CC)                                                           \
  case CC:                                                                           \
    dw_ln_stats<T, CC><<<(unsigned)((tokens + 8 * svt::TokensPerWarp<CC>::value - 1) / \
                                    (8 * svt::TokensPerWarp<CC>::value)),            \
                         256, 0, s>>>((const T*)x, (const T*)k, (const float*)bias,  \
                                      (const float*)scale, (const T*)g,              \
                                      (float4*)stats, B, H, W, eps);                 \
    break;
  switch (C) {
    SVT_DW_WIDTHS(SVT_STATS_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SVT_STATS_CASE
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long P = ((long long)B * H + rows_per_cta - 1) / rows_per_cta;
  dw_ln_bwd_tile<T><<<dim3((unsigned)((C + CG - 1) / CG), (unsigned)P), KS * 32, 0, s>>>(
      (const T*)x, (const T*)k, (const float*)bias, (const float*)scale, (const T*)g,
      (const float4*)stats, (T*)da, (float*)part, B, H, W, C, rows_per_cta);
  if ((err = (int)cudaGetLastError())) return err;
  svt::colsum<<<(unsigned)((NSUM * C + 31) / 32), dim3(32, 32), 0, s>>>(
      (const float*)part, P, NSUM * C, (float*)sums);
  return (int)cudaGetLastError();
}

}  // namespace

// The stencil: out = dwconv7x7(x) with the tap-major [49, C] filter k.
// dtype: 0 = bf16, 1 = f32 (x, k and out share it). Returns the cudaError_t
// of the launch.
extern "C" int svt_dwconv7x7(const void* x, const void* k, void* out, int dtype, int B,
                             int H, int W, int C, void* stream) {
  if ((long long)B * H * W == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_dw7<__nv_bfloat16>(x, k, out, B, H, W, C, s);
  if (dtype == 1) return launch_dw7<float>(x, k, out, B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}

// The backward of dwconv + bias + LayerNorm but dx: x, k [49, C], g and da in
// the dtype (0 = bf16, 1 = f32); bias and scale f32 [C]. Scratch from the
// caller: stats f32 [B * H * W, 4], part f32 [ceil(B * H / rows_per_cta),
// 52 * C]. sums (f32 [52 * C]) receives dk [49, C], dbias, dscale, dbeta.
// Returns the first cudaError_t of its launches.
extern "C" int svt_dw_ln_bwd(const void* x, const void* k, const void* bias,
                             const void* scale, const void* g, void* stats, void* da,
                             void* part, void* sums, int dtype, int B, int H, int W,
                             int C, int rows_per_cta, float eps, void* stream) {
  if ((long long)B * H * W == 0 || rows_per_cta <= 0 || C % 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd<__nv_bfloat16>(x, k, bias, scale, g, stats, da, part, sums, B, H,
                                     W, C, rows_per_cta, eps, s);
  if (dtype == 1)
    return launch_bwd<float>(x, k, bias, scale, g, stats, da, part, sums, B, H, W, C,
                             rows_per_cta, eps, s);
  return (int)cudaErrorInvalidValue;
}
