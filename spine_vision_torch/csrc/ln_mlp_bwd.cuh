// The kernels of the MLP + LayerScale backward, with or without the LayerNorm
// before it (ln_mlp_bwd.cu, where the design is described), shared with the
// whole-block backward (block_train_bwd.cu):
//   bwd_rows     (stage A) the row prologue: y = LN(t), g * gamma, per-tile sums;
//   wg_gemm      (stages B, C, D, wg_gemm.cuh) a warp-specialized wgmma product
//                fed by TMA through an mbarrier ring, with the epilogue of each
//                stage;
//   ln_rows_bwd  (stage L) the LayerNorm backward from the f32 g_y;
//   reduce_rows  the fixed-order sum of stage D's token splits;
// and mlp_bwd, which runs them in order. Each library that includes this gets
// its own copy.
//
// The f32 forms (T = float: the JAX kernels run in f32) run the same stages
// with every activation in f32 and the products on wg_gemm.cuh's 3xTF32
// path (stage B's two products in one unit, stage D's token splits as
// bf16's, stages B and C split over K where their tiles would leave SMs
// idle): g_hpre, g_y and dt are f32, the weight and bias gradients f32 sums
// in the same fixed orders.
#pragma once

#include "reduce.cuh"
#include "wg_gemm.cuh"

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using svt::Lanes;

constexpr float LN_EPS = 1e-6f;  // fused_mlp.py::_LN_EPS

// Row kernels (stages A and L): 64 tokens a CTA, 8 a warp; a per-tile sums
// row of the workspace `part` belongs to each 64 tokens.
constexpr int TOK = PART_TOK;
constexpr int ROW_THREADS = 256;
constexpr int ROW_WARPS = ROW_THREADS / 32;

// Each warp's per-channel sums v (lane-owned channel pairs) -> one row of
// dst, added over the warps in a fixed order. Every thread must call it.
template <int C>
__device__ __forceinline__ void warp_rows_to(float* red, const float (&v)[Lanes<C>::NP][2],
                                             int warp, int lane, float* __restrict__ dst) {
#pragma unroll
  for (int q = 0; q < Lanes<C>::NP; ++q) {
    const int p = lane + 32 * q;
    if (Lanes<C>::valid(p)) svt::store2(red + warp * C + 2 * p, v[q][0], v[q][1]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += ROW_THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < ROW_WARPS; ++w) s += red[w * C + c];
    dst[c] = s;
  }
  __syncthreads();
}

// Stage A. part rows: [db1 (4C) | dln_scale | dln_bias | db2 | sum g], 8C
// floats a 64-token tile; this writes db2 and sum g (and, without the
// LayerNorm, zeros for its two rows). With LN, y = LN(t) goes to y_out (T)
// and each token's mean and rstd to stats; without it, t is y itself. With
// U32 (the whole-block backward) t is the unrounded f32 conv output.
template <typename T, int C, bool LN, bool U32>
__global__ void __launch_bounds__(ROW_THREADS) bwd_rows(
    const typename std::conditional<U32, float, T>::type* __restrict__ t,
    const T* __restrict__ gout, const float* __restrict__ ls, const float* __restrict__ lb,
    const float* __restrict__ gamma, T* __restrict__ y_out, T* __restrict__ gg,
    float* __restrict__ stats, float* __restrict__ part, long long M, float eps) {
  static_assert(LN || !U32, "the f32 input is the LayerNorm form's");
  constexpr int NP = Lanes<C>::NP;
  __shared__ float red[ROW_WARPS * C];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tok0 = (long long)blockIdx.x * TOK;
  float* mypart = part + (size_t)blockIdx.x * (8 * C);

  float cdb2[NP][2], cgs[NP][2];
#pragma unroll
  for (int q = 0; q < NP; ++q) cdb2[q][0] = cdb2[q][1] = cgs[q][0] = cgs[q][1] = 0.f;
  for (int i = 0; i < TOK / ROW_WARPS; ++i) {
    const long long tok = tok0 + warp * (TOK / ROW_WARPS) + i;
    if (tok >= M) break;  // warp-uniform
    float tv[NP][2], gv[NP][2];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      tv[q][0] = tv[q][1] = gv[q][0] = gv[q][1] = 0.f;
      if (Lanes<C>::valid(p)) {
        const float2 a = svt::load2(t + tok * C + 2 * p);
        const float2 b = svt::load2(gout + tok * C + 2 * p);
        tv[q][0] = a.x; tv[q][1] = a.y;
        gv[q][0] = b.x; gv[q][1] = b.y;
        s += a.x + a.y;
      }
    }
    float mu = 0.f, rstd = 1.f;
    if constexpr (LN) {
      mu = svt::warp_sum(s) * (1.f / C);
      float s2 = 0.f;
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const int p = lane + 32 * q;
        if (Lanes<C>::valid(p)) {
          const float d0 = tv[q][0] - mu, d1 = tv[q][1] - mu;
          s2 += d0 * d0 + d1 * d1;
        }
      }
      rstd = rsqrtf(svt::warp_sum(s2) * (1.f / C) + eps);
      if (lane == 0) svt::store2(stats + 2 * tok, mu, rstd);
    }
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      if (!Lanes<C>::valid(p)) continue;
      if constexpr (LN) {
        const float2 sv = svt::load2(ls + 2 * p), bv = svt::load2(lb + 2 * p);
        svt::store2(y_out + tok * C + 2 * p, (tv[q][0] - mu) * rstd * sv.x + bv.x,
                    (tv[q][1] - mu) * rstd * sv.y + bv.y);
      }
      const float2 gm = svt::load2(gamma + 2 * p);
      const float m0 = gv[q][0] * gm.x, m1 = gv[q][1] * gm.y;
      svt::store2(gg + tok * C + 2 * p, m0, m1);
      cdb2[q][0] += m0; cdb2[q][1] += m1;
      cgs[q][0] += gv[q][0]; cgs[q][1] += gv[q][1];
    }
  }
  warp_rows_to<C>(red, cdb2, warp, lane, mypart + 6 * C);
  warp_rows_to<C>(red, cgs, warp, lane, mypart + 7 * C);
  if constexpr (!LN)
    for (int c = threadIdx.x; c < 2 * C; c += ROW_THREADS) mypart[4 * C + c] = 0.f;
}

// Stage L: the LayerNorm backward a row per warp step, dt = rstd * (dyh -
// mean(dyh) - yhat * mean(dyh * yhat)) with dyh = g_y * ln_scale, from the
// f32 g_y; dt in T (and, with U32, in f32 to gu32); the part rows
// dln_scale = sum g_y * yhat and dln_bias = sum g_y.
template <typename T, int C, bool U32>
__global__ void __launch_bounds__(ROW_THREADS) ln_rows_bwd(
    const typename std::conditional<U32, float, T>::type* __restrict__ t,
    const float* __restrict__ gy, const float* __restrict__ stats,
    const float* __restrict__ ls, T* __restrict__ dt, float* __restrict__ gu32,
    float* __restrict__ part, long long M) {
  constexpr int NP = Lanes<C>::NP;
  __shared__ float red[ROW_WARPS * C];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tok0 = (long long)blockIdx.x * TOK;
  float cls[NP][2], clb[NP][2];
#pragma unroll
  for (int q = 0; q < NP; ++q) cls[q][0] = cls[q][1] = clb[q][0] = clb[q][1] = 0.f;
  for (int i = 0; i < TOK / ROW_WARPS; ++i) {
    const long long tok = tok0 + warp * (TOK / ROW_WARPS) + i;
    if (tok >= M) break;  // warp-uniform
    const float2 st = svt::load2(stats + 2 * tok);
    const float mu = st.x, rstd = st.y;
    float yh[NP][2], dy[NP][2];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      yh[q][0] = yh[q][1] = dy[q][0] = dy[q][1] = 0.f;
      if (!Lanes<C>::valid(p)) continue;
      const float2 tv = svt::load2(t + tok * C + 2 * p);
      const float2 g = svt::load2(gy + tok * C + 2 * p);
      const float2 sv = svt::load2(ls + 2 * p);
      yh[q][0] = (tv.x - mu) * rstd;
      yh[q][1] = (tv.y - mu) * rstd;
      dy[q][0] = g.x * sv.x;
      dy[q][1] = g.y * sv.y;
      s1 += dy[q][0] + dy[q][1];
      s2 += dy[q][0] * yh[q][0] + dy[q][1] * yh[q][1];
      cls[q][0] += g.x * yh[q][0];
      cls[q][1] += g.y * yh[q][1];
      clb[q][0] += g.x;
      clb[q][1] += g.y;
    }
    const float mean1 = svt::warp_sum(s1) * (1.f / C);
    const float mean2 = svt::warp_sum(s2) * (1.f / C);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      if (!Lanes<C>::valid(p)) continue;
      const float d0 = rstd * (dy[q][0] - mean1 - yh[q][0] * mean2);
      const float d1 = rstd * (dy[q][1] - mean1 - yh[q][1] * mean2);
      svt::store2(dt + tok * C + 2 * p, d0, d1);
      if constexpr (U32) svt::store2(gu32 + tok * C + 2 * p, d0, d1);
    }
  }
  float* mypart = part + (size_t)blockIdx.x * (8 * C);
  warp_rows_to<C>(red, cls, warp, lane, mypart + 4 * C);
  warp_rows_to<C>(red, clb, warp, lane, mypart + 5 * C);
}

__device__ __forceinline__ float w_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float w_f32(float v) { return v; }

// out[r][c] = scale[r] * sum over splits (in order) of ws[s][r][c]; with w
// (of the weights' type W), also dgamma[r] = sum_c w[r][c] * (that sum) +
// gsum[r] * b2[r]. A row a CTA.
template <typename W>
__global__ void __launch_bounds__(256) reduce_rows(
    const float* __restrict__ ws, int splits, int N1, int N2,
    const float* __restrict__ scale, const W* __restrict__ w,
    const float* __restrict__ gsum, const float* __restrict__ b2,
    float* __restrict__ out, float* __restrict__ dgamma) {
  __shared__ float part[8];
  const int r = blockIdx.x;
  const float sc = scale ? scale[r] : 1.f;
  float dot = 0.f;
  for (int c = threadIdx.x; c < N2; c += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += ws[((size_t)k * N1 + r) * N2 + c];
    if (w) dot += w_f32(w[(size_t)r * N2 + c]) * s;
    out[(size_t)r * N2 + c] = s * sc;
  }
  if (w == nullptr) return;  // uniform over the CTA
  dot = svt::warp_sum(dot);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = dot;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += part[i];
    dgamma[r] = s + gsum[r] * b2[r];
  }
}

// Everything a backward call reads, writes and uses as scratch (ops/fused_mlp.py
// allocates it). t is T, or f32 with U32; every other activation is T [M, C]
// or [M, 4C]; y aliases t without the LayerNorm.
template <typename T>
struct MlpBwd {
  const void* t;
  const T *g, *w1t, *w1, *w2t, *w2;
  const float *ls, *lb, *b1, *b2, *gamma;
  T* dt;
  float *gu32, *small, *dw1t, *dw2t, *dgamma;
  T *y, *gg, *h, *gh;
  float *stats, *gy, *part, *ws;
  long long M, ks;
  int C, splits;
  float eps;
  KPlan kp;  // f32: stages B and C's K splits (their partials in ws)
};

// Stages B, C and D's products on the 3xTF32 path (wg_gemm.cuh's
// product_f32), as the wgmma stages below compute them, B and C over a.kp's
// K splits; L between C and D as there.
template <int C, bool LN, bool U32>
int mlp_bwd_f32(const MlpBwd<float>& a, const float* y, long long row_tiles, cudaStream_t s) {
  const long long M = a.M;
  const int H4 = 4 * C;
  int err;
  {  // B: h_pre = y . W1, g_h = (g * gamma) . W2^T; their epilogue
    EpiT<float> e{};
    e.b1 = a.b1;
    e.h = a.h;
    e.gh = a.gh;
    e.part = a.part;
    e.ws = a.ws;
    e.C = C;
    if ((err = product_f32<2, false, EPI_HIDDEN>(y, a.gg, a.w1t, a.w2, M, C, H4, a.kp.s1,
                                                 a.kp.k1, e, s)))
      return err;
  }
  {  // C: g_y = g_hpre . W1^T: dy, or g_y for stage L
    EpiT<float> e{};
    e.dy = a.dt;
    e.gy = a.gy;
    e.ws = a.ws;
    e.C = C;
    err = LN ? product_f32<1, false, EPI_GY>(a.gh, nullptr, a.w1, nullptr, M, H4, C, a.kp.s2,
                                             a.kp.k2, e, s)
             : product_f32<1, false, EPI_DY>(a.gh, nullptr, a.w1, nullptr, M, H4, C, a.kp.s2,
                                             a.kp.k2, e, s);
    if (err) return err;
  }
  if constexpr (LN) {  // L
    ln_rows_bwd<float, C, U32><<<(unsigned)row_tiles, ROW_THREADS, 0, s>>>(
        static_cast<const float*>(a.t), a.gy, a.stats, a.ls, a.dt, a.gu32, a.part, M);
    if ((err = (int)cudaGetLastError())) return err;
  }
  // D: the per-tile rows -> small; dW1^T = g_hpre^T . y and A^T = g^T . h
  // over token splits (token-major operands), each reduced in split order.
  svt::colsum<<<(unsigned)((8 * C + 31) / 32), dim3(32, 32), 0, s>>>(a.part, row_tiles, 8 * C,
                                                                     a.small);
  if ((err = (int)cudaGetLastError())) return err;
  EpiT<float> e{};
  e.ws = a.ws;
  e.C = C;
  if ((err = product_f32<1, true, EPI_WS>(a.gh, nullptr, y, nullptr, H4, M, C, a.splits, a.ks, e,
                                          s)))
    return err;
  reduce_rows<float><<<H4, 256, 0, s>>>(a.ws, a.splits, H4, C, nullptr, nullptr, nullptr,
                                        nullptr, a.dw1t, nullptr);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = product_f32<1, true, EPI_WS>(a.g, nullptr, a.h, nullptr, C, M, H4, a.splits, a.ks, e,
                                          s)))
    return err;
  // dW2 = gamma * A^T; dgamma = sum_j W2 * A^T + (sum g) * b2.
  reduce_rows<float><<<C, 256, 0, s>>>(a.ws, a.splits, C, H4, a.gamma, a.w2t, a.small + 7 * C,
                                       a.b2, a.dw2t, a.dgamma);
  return (int)cudaGetLastError();
}

// Stages B, C, L and D of the bf16 form: wgmma products fed by TMA.
template <int C, bool LN, bool U32>
int mlp_bwd_wg(const MlpBwd<bf16>& a, const bf16* y, long long row_tiles, cudaStream_t s) {
  using TT = typename std::conditional<U32, float, bf16>::type;
  const long long M = a.M;
  const int H4 = 4 * C;
  const int tiles_m = (int)((M + BM - 1) / BM);
  int err;
  {  // B: h_pre = y . W1, g_h = (g * gamma) . W2^T; their epilogue
    CUtensorMap m[4];
    if ((err = hop::make_map(&m[0], y, M, C, C, BM)) ||
        (err = hop::make_map(&m[1], a.gg, M, C, C, BM)) ||
        (err = hop::make_map(&m[2], a.w1t, H4, C, C, BN)) ||
        (err = hop::make_map(&m[3], a.w2, H4, C, C, BN)))
      return err;
    const Gemm g{M, C, C, H4, tiles_m, H4 / BN, 1};
    Epi e{};
    e.b1 = a.b1;
    e.h = a.h;
    e.gh = a.gh;
    e.part = a.part;
    e.C = C;
    if ((err = launch_gemm<bf16, 2, 2, false, EPI_HIDDEN>(m, g, e, s))) return err;
  }
  {  // C: g_y = g_hpre . W1^T: dy (bf16), or the f32 g_y for stage L
    constexpr int NB = C % 256 == 0 ? 2 : 1;
    CUtensorMap m[4];
    if ((err = hop::make_map(&m[0], a.gh, M, H4, H4, BM)) ||
        (err = hop::make_map(&m[2], a.w1, C, H4, H4, BN)))
      return err;
    m[1] = m[0];
    m[3] = m[2];
    const Gemm g{M, H4, H4, C, tiles_m, (C + NB * BN - 1) / (NB * BN), 1};
    Epi e{};
    e.dy = a.dt;
    e.gy = a.gy;
    e.C = C;
    if constexpr (LN)
      err = launch_gemm<bf16, 1, NB, false, EPI_GY>(m, g, e, s);
    else
      err = launch_gemm<bf16, 1, NB, false, EPI_DY>(m, g, e, s);
    if (err) return err;
  }
  if constexpr (LN) {  // L
    ln_rows_bwd<bf16, C, U32><<<(unsigned)row_tiles, ROW_THREADS, 0, s>>>(
        static_cast<const TT*>(a.t), a.gy, a.stats, a.ls, a.dt, a.gu32, a.part, M);
    if ((err = (int)cudaGetLastError())) return err;
  }
  {
    // D: the per-tile rows -> small, then dW1^T = g_hpre^T . y and A^T =
    // g^T . h over token splits, each reduced in split order.
    svt::colsum<<<(unsigned)((8 * C + 31) / 32), dim3(32, 32), 0, s>>>(a.part, row_tiles, 8 * C,
                                                                       a.small);
    if ((err = (int)cudaGetLastError())) return err;
    CUtensorMap m[4];
    if ((err = hop::make_map(&m[0], a.gh, M, H4, H4, 64)) ||
        (err = hop::make_map(&m[2], y, M, C, C, 64)))
      return err;
    m[1] = m[0];
    m[3] = m[2];
    Epi e{};
    e.ws = a.ws;
    e.C = C;
    const Gemm g1{H4, M, a.ks, C, H4 / BM, (C + BN - 1) / BN, a.splits};
    if ((err = launch_gemm<bf16, 1, 1, true, EPI_WS>(m, g1, e, s))) return err;
    reduce_rows<bf16><<<H4, 256, 0, s>>>(a.ws, a.splits, H4, C, nullptr, nullptr, nullptr,
                                         nullptr, a.dw1t, nullptr);
    if ((err = (int)cudaGetLastError())) return err;
    if ((err = hop::make_map(&m[0], a.g, M, C, C, 64)) ||
        (err = hop::make_map(&m[2], a.h, M, H4, H4, 64)))
      return err;
    m[1] = m[0];
    m[3] = m[2];
    const Gemm g2{C, M, a.ks, H4, (C + BM - 1) / BM, H4 / BN, a.splits};
    if ((err = launch_gemm<bf16, 1, 1, true, EPI_WS>(m, g2, e, s))) return err;
    // dW2 = gamma * A^T; dgamma = sum_j W2 * A^T + (sum g) * b2.
    reduce_rows<bf16><<<C, 256, 0, s>>>(a.ws, a.splits, C, H4, a.gamma, a.w2t, a.small + 7 * C,
                                        a.b2, a.dw2t, a.dgamma);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
}

template <typename T, int C, bool LN, bool U32>
int mlp_bwd_c(const MlpBwd<T>& a, cudaStream_t s) {
  using TT = typename std::conditional<U32, float, T>::type;
  const long long M = a.M;
  const long long row_tiles = (M + TOK - 1) / TOK;
  const T* y = LN ? a.y : static_cast<const T*>(a.t);
  bwd_rows<T, C, LN, U32><<<(unsigned)row_tiles, ROW_THREADS, 0, s>>>(
      static_cast<const TT*>(a.t), a.g, a.ls, a.lb, a.gamma, a.y, a.gg, a.stats, a.part, M,
      a.eps);
  if (const int err = (int)cudaGetLastError()) return err;
  if constexpr (std::is_same<T, float>::value)
    return mlp_bwd_f32<C, LN, U32>(a, y, row_tiles, s);
  else
    return mlp_bwd_wg<C, LN, U32>(a, y, row_tiles, s);
}

// One backward call, its stages in order. Each split of stage D must hold at
// least one token: ks a multiple of BK, (splits - 1) * ks < M <= splits * ks.
template <typename T, bool LN, bool U32 = false>
int mlp_bwd(const MlpBwd<T>& a, cudaStream_t s) {
  if (a.M <= 0 || a.M > 0x7fffffffLL || a.ks <= 0 || a.ks % BK || a.splits <= 0 ||
      (a.splits - 1) * a.ks >= a.M || a.splits * a.ks < a.M)
    return (int)cudaErrorInvalidValue;
#define SVT_MLP_BWD_CASE(CC) \
  case CC:                   \
    return mlp_bwd_c<T, CC, LN, U32>(a, s);
  switch (a.C) {
    SVT_MLP_BWD_CASE(96)
    SVT_MLP_BWD_CASE(128)
    SVT_MLP_BWD_CASE(192)
    SVT_MLP_BWD_CASE(256)
    SVT_MLP_BWD_CASE(384)
    SVT_MLP_BWD_CASE(512)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SVT_MLP_BWD_CASE
}

}  // namespace
