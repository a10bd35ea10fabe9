// Backward of the ConvNeXt block's LayerNorm + MLP + LayerScale, NHWC bf16,
// for Hopper. Given t (the rounded conv output the forward's LayerNorm read)
// and g (the gradient of the block output), with y = LN(t), h = gelu_tanh(
// y . W1 + b1) and out = x + gamma * (h . W2 + b2):
//   dt, dln_scale, dln_bias, dW1, db1, dW2, db2, dgamma.
//
// Replaces spine_vision_tpu/ops/fused_mlp.py::_ln_mlp_bwd_pallas_resident
// (C = 512, weights resident, hidden chunked by a loop) and
// _ln_mlp_bwd_pallas (C = 128, 256, a (token, hidden-chunk) grid): the same
// function, laid out differently in the TPU's VMEM. The rounding points are
// the TPU kernels': y, h, g * gamma, the hidden gradient and g enter the
// products in bf16; db1 sums the unrounded f32 hidden gradient; the GELU
// derivative and the LayerNorm backward run in f32; dt is written in bf16 and
// every parameter gradient is f32.
//
// It runs five bf16 products per token (y . W1 again, (g * gamma) . W2^T,
// g_hpre . W1^T, y^T . g_hpre, h^T . g): 40 * M * C^2 flops against about
// 6 * M * C bytes of activations, so the tensor cores bound it.
//
// Design. The TPU adds every token tile's weight gradients into one resident
// output block, in grid order. A CUDA grid runs in parallel, and per CTA the
// [4C, C] f32 weight gradients do not fit, so the work is split in two:
//   A. ln_mlp_bwd_tokens, one CTA per 64 tokens: LayerNorm again, then over
//      hidden chunks of HC the two products with K = C give the hidden
//      pre-activation and its gradient; h and the rounded hidden gradient go
//      to device memory (bf16), and g_y += g_hpre . W1c^T accumulates in
//      registers, so a token's whole hidden is summed inside one CTA before
//      the LayerNorm backward writes dt. Per-channel sums (db1, dln_scale,
//      dln_bias, db2, sum g) go to a per-tile row of a workspace.
//   B. token_gemm computes y^T . g_hpre and g^T . h with K = tokens, split
//      over tokens into an f32 workspace; reduce_rows adds the splits in a
//      fixed order (and applies gamma, and forms dgamma); colsum adds the
//      per-tile rows in a fixed order. Every sum has one order, so the result
//      is the same from run to run.
// Products are mma.sync m16n8k16 with ldmatrix loads (transposed for the
// token-major operands of B); weight chunks stream in with cp.async. Not yet
// here: wgmma, TMA, keeping h and g_hpre out of device memory.
#include "dwconv_ln.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using svt::Lanes;

constexpr int TOK = 64;
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr float LN_EPS = 1e-6f;  // fused_mlp.py::_LN_EPS

// Hidden chunk: 16 at the widest widths, so one CTA's shared memory holds it.
template <int C>
struct Hc {
  static constexpr int value = C > 384 ? 16 : 32;
};

template <int C>
struct TLayout {  // offsets in bf16 elements, then bytes for the f32 areas
  static constexpr int HC = Hc<C>::value;
  static constexpr int LDY = C + 8;
  static constexpr int LDH = HC + 8;
  static constexpr int LDGY = C + 4;      // f32 g_y rows, over Y and G
  static constexpr int Y = 0;             // y (bf16) [TOK][LDY]
  static constexpr int G = Y + TOK * LDY; // g * gamma (bf16) [TOK][LDY]
  static constexpr int W1 = G + TOK * LDY;    // W1 chunk rows [HC][LDY]
  static constexpr int W2 = W1 + HC * LDY;    // W2 chunk rows [HC][LDY]
  static constexpr int W1T = W2 + HC * LDY;   // W1 chunk columns [C][LDH]
  static constexpr int GH = W1T + C * LDH;    // hidden gradient [TOK][LDH]
  static constexpr int END = GH + TOK * LDH;
  static constexpr size_t RED = (size_t)END * 2;               // f32 [NWARPS][C]
  static constexpr size_t STATS = RED + (size_t)NWARPS * C * 4;  // mean, rstd
  static constexpr size_t DB1 = STATS + 2 * TOK * 4;            // f32 [4][HC]
  static constexpr size_t BYTES = DB1 + 4 * HC * 4;
  static_assert(TOK * LDGY * 4 <= 2 * TOK * LDY * 2, "g_y overlays y and g");
};

// Warp grid of g_y += g_hpre . W1c^T, as the forward's second product.
template <int C>
struct Grid2 {
  static constexpr int WN = (C / 8) % NWARPS == 0 ? NWARPS : NWARPS / 2;
  static constexpr int WM = NWARPS / WN;
  static constexpr int MT = (TOK / 16) / WM;
  static constexpr int NTW = (C / 8) / WN;
  static_assert((C / 8) % WN == 0 && (TOK / 16) % WM == 0, "bad warp grid");
};

template <int C>
__device__ __forceinline__ void load_rows(bf16* sW1, bf16* sW2,
                                          const bf16* __restrict__ w1t,
                                          const bf16* __restrict__ w2, int c0) {
  constexpr int HC = Hc<C>::value, ROW = C / 8, LDY = C + 8;
  for (int v = threadIdx.x; v < HC * ROW; v += NTHREADS) {
    const int n = v / ROW, kk = (v % ROW) * 8;
    svt::cp_async16(sW1 + n * LDY + kk, w1t + (size_t)(c0 + n) * C + kk);
    svt::cp_async16(sW2 + n * LDY + kk, w2 + (size_t)(c0 + n) * C + kk);
  }
}

template <int C>
__device__ __forceinline__ void load_cols(bf16* sW1T, const bf16* __restrict__ w1,
                                          int c0) {
  constexpr int HC = Hc<C>::value, ROW = HC / 8, LDH = HC + 8;
  for (int v = threadIdx.x; v < C * ROW; v += NTHREADS) {
    const int c = v / ROW, kk = (v % ROW) * 8;
    svt::cp_async16(sW1T + c * LDH + kk, w1 + (size_t)c * (4 * C) + c0 + kk);
  }
}

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
  for (int c = threadIdx.x; c < C; c += NTHREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += red[w * C + c];
    dst[c] = s;
  }
  __syncthreads();
}

// part rows: [db1 (4C) | dln_scale | dln_bias | db2 | sum g], 8C floats.
template <int C>
__global__ void __launch_bounds__(NTHREADS, 1) ln_mlp_bwd_tokens(
    const bf16* __restrict__ t, const bf16* __restrict__ gout,
    const float* __restrict__ ls, const float* __restrict__ lb,
    const bf16* __restrict__ w1t, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2,
    const float* __restrict__ gamma, bf16* __restrict__ dt,
    bf16* __restrict__ y_out, bf16* __restrict__ h_out,
    bf16* __restrict__ gh_out, float* __restrict__ part, long long M) {
  using L = TLayout<C>;
  using G2 = Grid2<C>;
  constexpr int HC = L::HC;
  constexpr int LDY = L::LDY, LDH = L::LDH, LDGY = L::LDGY;
  constexpr int NP = Lanes<C>::NP;
  constexpr int NCHUNK = 4 * C / HC;
  constexpr int NT = HC / 16;  // 8-wide column tiles a warp owns in the first products
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  bf16* sY = sm + L::Y;
  bf16* sG = sm + L::G;
  bf16* sW1 = sm + L::W1;
  bf16* sW2 = sm + L::W2;
  bf16* sW1T = sm + L::W1T;
  bf16* sGH = sm + L::GH;
  float* sGy = reinterpret_cast<float*>(smem_raw);  // after the chunk loop
  float* red = reinterpret_cast<float*>(smem_raw + L::RED);
  float* sMu = reinterpret_cast<float*>(smem_raw + L::STATS);
  float* sRstd = sMu + TOK;
  float* sDb1 = reinterpret_cast<float*>(smem_raw + L::DB1);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const long long tok0 = (long long)blockIdx.x * TOK;
  float* mypart = part + (size_t)blockIdx.x * (8 * C);

  // The first weight chunk streams in while the prologue runs.
  load_rows<C>(sW1, sW2, w1t, w2, 0);
  load_cols<C>(sW1T, w1, 0);
  svt::cp_async_commit();

  // 1. y = LN(t) -> bf16; g * gamma -> bf16; per-channel db2 and sum g.
  float cdb2[NP][2], cgs[NP][2];
#pragma unroll
  for (int q = 0; q < NP; ++q) cdb2[q][0] = cdb2[q][1] = cgs[q][0] = cgs[q][1] = 0.f;
  for (int i = 0; i < TOK / NWARPS; ++i) {
    const int r = warp * (TOK / NWARPS) + i;
    const long long tok = tok0 + r;
    const bool ok = tok < M;
    float tv[NP][2], gv[NP][2];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      tv[q][0] = tv[q][1] = gv[q][0] = gv[q][1] = 0.f;
      if (ok && Lanes<C>::valid(p)) {
        const float2 a = svt::load2(t + tok * C + 2 * p);
        const float2 b = svt::load2(gout + tok * C + 2 * p);
        tv[q][0] = a.x; tv[q][1] = a.y;
        gv[q][0] = b.x; gv[q][1] = b.y;
        s += a.x + a.y;
      }
    }
    const float mu = svt::warp_sum(s) * (1.f / C);
    float s2 = 0.f;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      if (Lanes<C>::valid(p)) {
        const float d0 = tv[q][0] - mu, d1 = tv[q][1] - mu;
        s2 += d0 * d0 + d1 * d1;
      }
    }
    const float rstd = rsqrtf(svt::warp_sum(s2) * (1.f / C) + LN_EPS);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      if (!Lanes<C>::valid(p)) continue;
      float y0 = 0.f, y1 = 0.f;
      if (ok) {
        const float2 sv = svt::load2(ls + 2 * p), bv = svt::load2(lb + 2 * p);
        y0 = (tv[q][0] - mu) * rstd * sv.x + bv.x;
        y1 = (tv[q][1] - mu) * rstd * sv.y + bv.y;
        svt::store2(y_out + tok * C + 2 * p, y0, y1);
      }
      svt::store2(sY + r * LDY + 2 * p, y0, y1);
      const float2 gm = svt::load2(gamma + 2 * p);
      const float m0 = gv[q][0] * gm.x, m1 = gv[q][1] * gm.y;
      svt::store2(sG + r * LDY + 2 * p, m0, m1);
      cdb2[q][0] += m0; cdb2[q][1] += m1;
      cgs[q][0] += gv[q][0]; cgs[q][1] += gv[q][1];
    }
    if (lane == 0) {
      sMu[r] = mu;
      sRstd[r] = rstd;
    }
  }
  warp_rows_to<C>(red, cdb2, warp, lane, mypart + 6 * C);
  warp_rows_to<C>(red, cgs, warp, lane, mypart + 7 * C);

  // 2. Hidden chunks. First products (K = C): each warp owns rows m1..m1+15
  // and columns n1..n1+HC/2 of both h_pre and g_h.
  const int m1 = (warp & 3) * 16;
  const int n1 = (warp >> 2) * (HC / 2);
  const int wm = warp / G2::WN;
  const int wn = warp % G2::WN;
  float acc[G2::MT][G2::NTW][4];
#pragma unroll
  for (int mi = 0; mi < G2::MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < G2::NTW; ++nj)
      acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.f;

  for (int ch = 0; ch < NCHUNK; ++ch) {
    const int c0 = ch * HC;
    svt::cp_async_wait_all();
    __syncthreads();

    float hacc[NT][4], gacc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      hacc[j][0] = hacc[j][1] = hacc[j][2] = hacc[j][3] =
          gacc[j][0] = gacc[j][1] = gacc[j][2] = gacc[j][3] = 0.f;
#pragma unroll 4
    for (int k0 = 0; k0 < C; k0 += 16) {
      uint32_t ay[4], ag[4];
      svt::load_a(ay, sY, LDY, m1, k0, lane);
      svt::load_a(ag, sG, LDY, m1, k0, lane);
      if constexpr (NT == 2) {
        uint32_t b[4];
        svt::load_b2(b, sW1, LDY, n1, k0, lane);
        svt::mma(hacc[0], ay, b[0], b[1]);
        svt::mma(hacc[1], ay, b[2], b[3]);
        svt::load_b2(b, sW2, LDY, n1, k0, lane);
        svt::mma(gacc[0], ag, b[0], b[1]);
        svt::mma(gacc[1], ag, b[2], b[3]);
      } else {
        uint32_t b[2];
        svt::load_b1(b, sW1, LDY, n1, k0, lane);
        svt::mma(hacc[0], ay, b[0], b[1]);
        svt::load_b1(b, sW2, LDY, n1, k0, lane);
        svt::mma(gacc[0], ag, b[0], b[1]);
      }
    }

    // h = gelu(h_pre + b1) and g_hpre = g_h * gelu'(h_pre + b1), in f32.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n1 + 8 * j + 2 * tq;
      const float bb0 = b1[c0 + col], bb1 = b1[c0 + col + 1];
      float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m1 + g + 8 * half;
        float h0, h1, d0, d1;
        svt::gelu_and_grad(hacc[j][2 * half] + bb0, h0, d0);
        svt::gelu_and_grad(hacc[j][2 * half + 1] + bb1, h1, d1);
        const float f0 = gacc[j][2 * half] * d0;
        const float f1 = gacc[j][2 * half + 1] * d1;
        svt::store2(sGH + row * LDH + col, f0, f1);
        const long long tok = tok0 + row;
        if (tok < M) {
          svt::store2(h_out + tok * (4 * C) + c0 + col, h0, h1);
          svt::store2(gh_out + tok * (4 * C) + c0 + col, f0, f1);
        }
        cs0 += f0;
        cs1 += f1;
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        cs0 += __shfl_xor_sync(0xffffffffu, cs0, o);
        cs1 += __shfl_xor_sync(0xffffffffu, cs1, o);
      }
      if (g == 0) {
        sDb1[(warp & 3) * HC + col] = cs0;
        sDb1[(warp & 3) * HC + col + 1] = cs1;
      }
    }
    __syncthreads();  // sGH and sDb1 complete; sW1, sW2 free
    if (threadIdx.x < HC)
      mypart[c0 + threadIdx.x] = sDb1[threadIdx.x] + sDb1[HC + threadIdx.x] +
                                 sDb1[2 * HC + threadIdx.x] + sDb1[3 * HC + threadIdx.x];
    if (ch + 1 < NCHUNK) load_rows<C>(sW1, sW2, w1t, w2, c0 + HC);
    svt::cp_async_commit();

    // g_y[64, C] += g_hpre . W1c^T (K = HC)
#pragma unroll
    for (int k0 = 0; k0 < HC; k0 += 16) {
      uint32_t a[G2::MT][4];
#pragma unroll
      for (int mi = 0; mi < G2::MT; ++mi)
        svt::load_a(a[mi], sGH, LDH, (wm * G2::MT + mi) * 16, k0, lane);
#pragma unroll
      for (int nj = 0; nj + 1 < G2::NTW; nj += 2) {
        uint32_t b[4];
        svt::load_b2(b, sW1T, LDH, (wn * G2::NTW + nj) * 8, k0, lane);
#pragma unroll
        for (int mi = 0; mi < G2::MT; ++mi) {
          svt::mma(acc[mi][nj], a[mi], b[0], b[1]);
          svt::mma(acc[mi][nj + 1], a[mi], b[2], b[3]);
        }
      }
      if (G2::NTW % 2) {
        uint32_t b[2];
        svt::load_b1(b, sW1T, LDH, (wn * G2::NTW + G2::NTW - 1) * 8, k0, lane);
#pragma unroll
        for (int mi = 0; mi < G2::MT; ++mi)
          svt::mma(acc[mi][G2::NTW - 1], a[mi], b[0], b[1]);
      }
    }
    __syncthreads();  // every warp is done with sW1T, sGH and sDb1
    if (ch + 1 < NCHUNK) load_cols<C>(sW1T, w1, c0 + HC);
    svt::cp_async_commit();
  }
  svt::cp_async_wait_all();

  // 3. g_y to shared memory (f32, over y and g), then the LayerNorm backward
  // a row per warp step: dt = rstd * (dyh - mean(dyh) - yhat * mean(dyh *
  // yhat)), dyh = g_y * ln_scale.
#pragma unroll
  for (int nj = 0; nj < G2::NTW; ++nj) {
    const int col = (wn * G2::NTW + nj) * 8 + 2 * tq;
#pragma unroll
    for (int mi = 0; mi < G2::MT; ++mi) {
      const int r0 = (wm * G2::MT + mi) * 16 + g;
      svt::store2(sGy + r0 * LDGY + col, acc[mi][nj][0], acc[mi][nj][1]);
      svt::store2(sGy + (r0 + 8) * LDGY + col, acc[mi][nj][2], acc[mi][nj][3]);
    }
  }
  __syncthreads();
  float cls[NP][2], clb[NP][2];
#pragma unroll
  for (int q = 0; q < NP; ++q) cls[q][0] = cls[q][1] = clb[q][0] = clb[q][1] = 0.f;
  for (int i = 0; i < TOK / NWARPS; ++i) {
    const int r = warp * (TOK / NWARPS) + i;
    const long long tok = tok0 + r;
    if (tok >= M) continue;  // warp-uniform
    const float mu = sMu[r], rstd = sRstd[r];
    float yh[NP][2], dy[NP][2];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      yh[q][0] = yh[q][1] = dy[q][0] = dy[q][1] = 0.f;
      if (!Lanes<C>::valid(p)) continue;
      const float2 tv = svt::load2(t + tok * C + 2 * p);
      const float2 gy = svt::load2(sGy + r * LDGY + 2 * p);
      const float2 sv = svt::load2(ls + 2 * p);
      yh[q][0] = (tv.x - mu) * rstd;
      yh[q][1] = (tv.y - mu) * rstd;
      dy[q][0] = gy.x * sv.x;
      dy[q][1] = gy.y * sv.y;
      s1 += dy[q][0] + dy[q][1];
      s2 += dy[q][0] * yh[q][0] + dy[q][1] * yh[q][1];
      cls[q][0] += gy.x * yh[q][0];
      cls[q][1] += gy.y * yh[q][1];
      clb[q][0] += gy.x;
      clb[q][1] += gy.y;
    }
    const float mean1 = svt::warp_sum(s1) * (1.f / C);
    const float mean2 = svt::warp_sum(s2) * (1.f / C);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      if (!Lanes<C>::valid(p)) continue;
      svt::store2(dt + tok * C + 2 * p,
                  rstd * (dy[q][0] - mean1 - yh[q][0] * mean2),
                  rstd * (dy[q][1] - mean1 - yh[q][1] * mean2));
    }
  }
  warp_rows_to<C>(red, cls, warp, lane, mypart + 4 * C);
  warp_rows_to<C>(red, clb, warp, lane, mypart + 5 * C);
}

// ws[split][n1][n2] = sum over the split's tokens of A[t][n1] * B[t][n2]
// (A, B token-major bf16): a 64 x 64 output tile a CTA, 32 tokens a step.
constexpr int BM = 64, BN = 64, BK = 32;

__global__ void __launch_bounds__(256) token_gemm(
    const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
    float* __restrict__ ws, int N1, int N2, long long M, long long ks) {
  __shared__ __align__(16) bf16 sA[2][BK][BM + 8];
  __shared__ __align__(16) bf16 sB[2][BK][BN + 8];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int n1t = blockIdx.x * BM, n2t = blockIdx.y * BN;
  const long long t_begin = (long long)blockIdx.z * ks;
  const long long t_end = M < t_begin + ks ? M : t_begin + ks;
  const int wm = warp & 3;   // 16 rows of n1 a warp
  const int wn = warp >> 2;  // 32 columns of n2 a warp
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int lr = threadIdx.x >> 3;       // token row of this thread's vector
  const int lv = (threadIdx.x & 7) * 8;  // its column offset
  auto load = [&](int buf, long long tb) {
    const long long tok = tb + lr;
    const bool ok = tok < t_end;
    if (ok && n1t + lv < N1)
      svt::cp_async16(&sA[buf][lr][lv], A + tok * lda + n1t + lv);
    else
      *reinterpret_cast<uint4*>(&sA[buf][lr][lv]) = make_uint4(0, 0, 0, 0);
    if (ok && n2t + lv < N2)
      svt::cp_async16(&sB[buf][lr][lv], B + tok * ldb + n2t + lv);
    else
      *reinterpret_cast<uint4*>(&sB[buf][lr][lv]) = make_uint4(0, 0, 0, 0);
  };

  const long long span = t_end > t_begin ? t_end - t_begin : 0;
  const int steps = (int)((span + BK - 1) / BK);
  if (steps > 0) load(0, t_begin);
  svt::cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load(buf ^ 1, t_begin + (long long)(s + 1) * BK);
    svt::cp_async_commit();
    svt::cp_async_wait_1();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4];
      svt::load_a_trans(a, &sA[buf][0][0], BM + 8, wm * 16, kk, lane);
#pragma unroll
      for (int nn = 0; nn < 32; nn += 16) {
        uint32_t b[4];
        svt::load_b2_trans(b, &sB[buf][0][0], BN + 8, wn * 32 + nn, kk, lane);
        svt::mma(acc[nn / 8], a, b[0], b[1]);
        svt::mma(acc[nn / 8 + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  float* out = ws + (size_t)blockIdx.z * N1 * N2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n2t + wn * 32 + j * 8 + 2 * tq;
    const int r = n1t + wm * 16 + g;
    if (c >= N2) continue;
    if (r < N1) svt::store2(out + (size_t)r * N2 + c, acc[j][0], acc[j][1]);
    if (r + 8 < N1) svt::store2(out + (size_t)(r + 8) * N2 + c, acc[j][2], acc[j][3]);
  }
}

// out[r][c] = scale[r] * sum over splits (in order) of ws[s][r][c]; with w,
// also dgamma[r] = sum_c w[r][c] * (that sum) + gsum[r] * b2[r]. A row a CTA.
__global__ void __launch_bounds__(256) reduce_rows(
    const float* __restrict__ ws, int splits, int N1, int N2,
    const float* __restrict__ scale, const bf16* __restrict__ w,
    const float* __restrict__ gsum, const float* __restrict__ b2,
    float* __restrict__ out, float* __restrict__ dgamma) {
  __shared__ float part[8];
  const int r = blockIdx.x;
  const float sc = scale ? scale[r] : 1.f;
  float dot = 0.f;
  for (int c = threadIdx.x; c < N2; c += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += ws[((size_t)k * N1 + r) * N2 + c];
    if (w) dot += __bfloat162float(w[(size_t)r * N2 + c]) * s;
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

// out[c] = sum over p (in a fixed order) of in[p][c].
__global__ void __launch_bounds__(1024) colsum(const float* __restrict__ in,
                                               long long P, int N,
                                               float* __restrict__ out) {
  __shared__ float sm[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < N)
    for (long long p = threadIdx.y; p < P; p += 32) s += in[p * N + c];
  sm[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < N) {
    float total = 0.f;
    for (int y = 0; y < 32; ++y) total += sm[y][threadIdx.x];
    out[c] = total;
  }
}

template <int C>
int launch_tokens(const void* t, const void* g, const void* ls, const void* lb,
                  const void* w1t, const void* w1, const void* b1, const void* w2,
                  const void* gamma, void* dt, void* y, void* h, void* gh,
                  void* part, long long M, cudaStream_t s) {
  const size_t smem = TLayout<C>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      ln_mlp_bwd_tokens<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((M + TOK - 1) / TOK);
  ln_mlp_bwd_tokens<C><<<grid, NTHREADS, smem, s>>>(
      (const bf16*)t, (const bf16*)g, (const float*)ls, (const float*)lb,
      (const bf16*)w1t, (const bf16*)w1, (const float*)b1, (const bf16*)w2,
      (const float*)gamma, (bf16*)dt, (bf16*)y, (bf16*)h, (bf16*)gh,
      (float*)part, M);
  return (int)cudaGetLastError();
}

}  // namespace

// All activations [M, C] or [M, 4C] bf16, token-major. Weights bf16 in both
// layouts: w1t [4C, C] and w1 [C, 4C], w2t [C, 4C] and w2 [4C, C]; ls, lb,
// b1, b2, gamma f32. Outputs: dt [M, C] bf16; small f32 [8C] = db1 (4C),
// dln_scale, dln_bias, db2, sum g; dw1t [4C, C], dw2t [C, 4C], dgamma [C]
// f32. Scratch from the caller: y, h, gh ([M, C], [M, 4C], [M, 4C] bf16),
// part f32 [ceil(M / 64), 8C], ws f32 [splits, 4C, C]. Returns the first
// cudaError_t of its launches.
extern "C" int svt_ln_mlp_bwd(
    const void* t, const void* g, const void* ls, const void* lb,
    const void* w1t, const void* w1, const void* b1, const void* w2t,
    const void* w2, const void* b2, const void* gamma, void* dt, void* small,
    void* dw1t, void* dw2t, void* dgamma, void* y, void* h, void* gh,
    void* part, void* ws, long long M, int C, int splits, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
#define SVT_LN_MLP_BWD_CASE(CC)                                                  \
  case CC:                                                                       \
    err = launch_tokens<CC>(t, g, ls, lb, w1t, w1, b1, w2, gamma, dt, y, h, gh,  \
                            part, M, s);                                         \
    break;
  switch (C) {
    SVT_LN_MLP_BWD_CASE(96)
    SVT_LN_MLP_BWD_CASE(128)
    SVT_LN_MLP_BWD_CASE(192)
    SVT_LN_MLP_BWD_CASE(256)
    SVT_LN_MLP_BWD_CASE(384)
    SVT_LN_MLP_BWD_CASE(512)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SVT_LN_MLP_BWD_CASE
  if (err) return err;
  const long long tiles = (M + TOK - 1) / TOK;
  float* sm = (float*)small;
  colsum<<<(unsigned)((8 * C + 31) / 32), dim3(32, 32), 0, s>>>(
      (const float*)part, tiles, 8 * C, sm);
  if ((err = (int)cudaGetLastError())) return err;

  const long long per = (M + splits - 1) / splits;
  const long long ks = (per + BK - 1) / BK * BK;
  const int H4 = 4 * C;
  // dW1 in the [4C, C] layout: sum_t g_hpre[t][j] * y[t][c].
  token_gemm<<<dim3((H4 + BM - 1) / BM, (C + BN - 1) / BN, splits), 256, 0, s>>>(
      (const bf16*)gh, H4, (const bf16*)y, C, (float*)ws, H4, C, M, ks);
  if ((err = (int)cudaGetLastError())) return err;
  reduce_rows<<<H4, 256, 0, s>>>((const float*)ws, splits, H4, C, nullptr,
                                 nullptr, nullptr, nullptr, (float*)dw1t, nullptr);
  if ((err = (int)cudaGetLastError())) return err;
  // a^T in the [C, 4C] layout: sum_t g[t][c] * h[t][j]; dW2 = gamma * a^T,
  // dgamma = sum_j W2 * a^T + (sum g) * b2.
  token_gemm<<<dim3((C + BM - 1) / BM, (H4 + BN - 1) / BN, splits), 256, 0, s>>>(
      (const bf16*)g, C, (const bf16*)h, H4, (float*)ws, C, H4, M, ks);
  if ((err = (int)cudaGetLastError())) return err;
  reduce_rows<<<C, 256, 0, s>>>((const float*)ws, splits, C, H4,
                                (const float*)gamma, (const bf16*)w2t, sm + 7 * C,
                                (const float*)b2, (float*)dw2t, (float*)dgamma);
  return (int)cudaGetLastError();
}
