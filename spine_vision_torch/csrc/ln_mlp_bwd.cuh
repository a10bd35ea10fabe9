// The kernels of the MLP + LayerScale backward, with or without the LayerNorm
// before it (ln_mlp_bwd.cu, where the design is described), shared with the
// whole-block backward (block_train_bwd.cu):
//   bwd_rows     (stage A) the row prologue: y = LN(t), g * gamma, per-tile sums;
//   wg_gemm      (stages B, C, D) a warp-specialized wgmma product fed by TMA
//                through an mbarrier ring, with the epilogue of each stage;
//   ln_rows_bwd  (stage L) the LayerNorm backward from the f32 g_y;
//   reduce_rows  the fixed-order sum of stage D's token splits;
// and mlp_bwd, which runs them in order. Each library that includes this gets
// its own copy.
#pragma once

#include "dwconv_ln.cuh"
#include "gelu.cuh"
#include "hopper.cuh"
#include "reduce.cuh"

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using svt::Lanes;

constexpr float LN_EPS = 1e-6f;  // fused_mlp.py::_LN_EPS

// Row kernels (stages A and L): 64 tokens a CTA, 8 a warp; a per-tile sums
// row of the workspace `part` belongs to each 64 tokens.
constexpr int TOK = 64;
constexpr int ROW_THREADS = 256;
constexpr int ROW_WARPS = ROW_THREADS / 32;

// Products (stages B, C, D): an output tile of 128 rows, 64 a consumer
// warpgroup, by NB x 128 columns; K in slices of 64 (one 128-byte swizzle row
// of bf16), each slice a ring stage.
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int GEMM_THREADS = 384;        // consumer warpgroups 0, 1; producer 2
constexpr int TILE_BYTES = 128 * BK * 2;  // a 128 x 64 bf16 operand tile
constexpr int RING_BYTES = 200 * 1024;    // the ring's stages share this

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
// LayerNorm, zeros for its two rows). With LN, y = LN(t) goes to y_out (bf16)
// and each token's mean and rstd to stats; without it, t is y itself. With
// U32 (the whole-block backward) t is the unrounded f32 conv output.
template <int C, bool LN, bool U32>
__global__ void __launch_bounds__(ROW_THREADS) bwd_rows(
    const typename std::conditional<U32, float, bf16>::type* __restrict__ t,
    const bf16* __restrict__ gout, const float* __restrict__ ls, const float* __restrict__ lb,
    const float* __restrict__ gamma, bf16* __restrict__ y_out, bf16* __restrict__ gg,
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
// f32 g_y; dt in bf16 (and, with U32, in f32 to gu32); the part rows
// dln_scale = sum g_y * yhat and dln_bias = sum g_y.
template <int C, bool U32>
__global__ void __launch_bounds__(ROW_THREADS) ln_rows_bwd(
    const typename std::conditional<U32, float, bf16>::type* __restrict__ t,
    const float* __restrict__ gy, const float* __restrict__ stats,
    const float* __restrict__ ls, bf16* __restrict__ dt, float* __restrict__ gu32,
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

// ---- Stages B, C, D: warp-specialized products ----

// A product's tile space: out [rows, cols] = sum over k < K of A[row][k] *
// B[col][k], in tiles of BM rows by wg_gemm's TILE_N columns, K cut into
// `splits` ranges of ks (a multiple of BK) for stage D; a unit of work is one
// (tile, split).
struct Gemm {
  long long rows, k, ks;
  int cols, tiles_m, tiles_n, splits;
};

// What the epilogues write: stage B h and g_hpre (bf16, [M, 4C]) and db1's
// per-tile row of part; stage C dy (bf16) or g_y (f32), [M, C]; stage D the
// f32 split workspace ws [splits, rows, cols].
struct Epi {
  const float* b1;
  bf16* h;
  bf16* gh;
  float* part;
  bf16* dy;
  float* gy;
  float* ws;
  int C;
};
enum { EPI_HIDDEN, EPI_DY, EPI_GY, EPI_WS };

struct Unit {
  int tm, tn, nk;
  long long split, k0;
};

__device__ __forceinline__ Unit unit_of(const Gemm& g, long long u) {
  Unit t;
  t.tn = (int)(u % g.tiles_n);
  u /= g.tiles_n;
  t.tm = (int)(u % g.tiles_m);
  t.split = u / g.tiles_m;
  t.k0 = t.split * g.ks;
  const long long k1 = g.k < t.k0 + g.ks ? g.k : t.k0 + g.ks;
  t.nk = (int)((k1 - t.k0 + BK - 1) / BK);
  return t;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void store16(bf16* p, const uint32_t (&v)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
}
// Lane tq of a quad holds v[q], a value of 8-column group q; afterwards it
// holds group tq's values of lanes 0..3, in lane (column) order. Two butterfly
// rounds: with lane tq ^ 1, each keeps the values bound for lanes of its own
// bit 0 and trades the others; then the same with lane tq ^ 2 for bit 1.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int tq) {
  const bool b0 = tq & 1, b1 = tq & 2;
  uint32_t u[2][2];  // [bit 1 of the lane it is bound for][bit 0 of its source lane]
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t mine = b0 ? v[2 * k + 1] : v[2 * k];
    const uint32_t got = __shfl_xor_sync(0xffffffffu, b0 ? v[2 * k] : v[2 * k + 1], 1);
    u[k][0] = b0 ? got : mine;
    u[k][1] = b0 ? mine : got;
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint32_t mine = b1 ? u[1][s] : u[0][s];
    const uint32_t got = __shfl_xor_sync(0xffffffffu, b1 ? u[0][s] : u[1][s], 2);
    v[s] = b1 ? got : mine;
    v[2 + s] = b1 ? mine : got;
  }
}

template <int NA, int NB>
constexpr size_t gemm_smem_bytes() {
  constexpr int STAGE = (NA + NB) * TILE_BYTES;
  constexpr int S = RING_BYTES / STAGE;
  return 1024 + (size_t)S * STAGE + 2 * S * sizeof(uint64_t) + 2 * 4 * BN * sizeof(float);
}

// A persistent CTA walks units blockIdx.x, + gridDim.x, ... Warpgroup 2's
// first thread is the producer: for every K slice of every unit it waits for
// a free ring stage, then TMA-loads NA A tiles and NB B tiles into it. The
// consumer warpgroups 0 and 1 own rows 0-63 and 64-127 of the tile: they wait
// for a full stage, start its wgmma products (4 K steps of 16), wait for them
// and release the stage; after a unit's last slice, its epilogue.
//   NA = 2 (stage B): accumulator i is A_i . B_i (two products, one tile).
//   NA = 1 (C, D): accumulator i is A . B_i, columns i * BN of the tile.
//   MN: both operands token-major (stage D, K = tokens): 64 x 64 boxes,
//   transposed descriptors; otherwise K-major boxes of 128 rows x 64.
// Maps: a0 (a1) the A operands, b0 (b1) the B operands (b1 only with NA = 2).
template <int NA, int NB, bool MN, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 1) wg_gemm(
    const __grid_constant__ CUtensorMap a0, const __grid_constant__ CUtensorMap a1,
    const __grid_constant__ CUtensorMap b0, const __grid_constant__ CUtensorMap b1,
    const Gemm g, const Epi e) {
  static_assert(NA == 1 || NA == NB, "two products pair A_i with B_i");
  constexpr int STAGE = (NA + NB) * TILE_BYTES;
  constexpr int S = RING_BYTES / STAGE;
  constexpr int TILE_N = NA == 2 ? BN : NB * BN;  // the output tile's columns
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * STAGE);
  uint64_t* empty = full + S;
  float* red = reinterpret_cast<float*>(empty + S);  // [2 warpgroups][4 warps][BN]

  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hop::bar_init(&full[s], 1);
      hop::bar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    hop::bar_init_fence();
  }
  __syncthreads();
  const long long units = (long long)g.tiles_m * g.tiles_n * g.splits;

  if (wg == 2) {
    hop::setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * 128) {
      hop::prefetch_map(&a0);
      hop::prefetch_map(&b0);
      if (NA == 2) {
        hop::prefetch_map(&a1);
        hop::prefetch_map(&b1);
      }
      int s = 0;
      uint32_t phase = 0;
      for (long long u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit t = unit_of(g, u);
        const int m0 = t.tm * BM;
        const int n0 = t.tn * TILE_N;
        for (int kb = 0; kb < t.nk; ++kb) {
          hop::bar_wait(&empty[s], phase ^ 1);
          unsigned char* st = ring + s * STAGE;
          hop::bar_expect_tx(&full[s], STAGE);
          const int k = (int)(t.k0 + (long long)kb * BK);
#pragma unroll
          for (int i = 0; i < NA; ++i) {
            const CUtensorMap* am = i == 0 ? &a0 : &a1;
            if constexpr (MN) {
              hop::tma_load(st + i * TILE_BYTES, am, &full[s], m0, k);
              hop::tma_load(st + i * TILE_BYTES + TILE_BYTES / 2, am, &full[s], m0 + 64, k);
            } else {
              hop::tma_load(st + i * TILE_BYTES, am, &full[s], k, m0);
            }
          }
#pragma unroll
          for (int i = 0; i < NB; ++i) {
            const CUtensorMap* bm = (NA == 2 && i == 1) ? &b1 : &b0;
            const int n = NA == 2 ? n0 : n0 + i * BN;
            unsigned char* dst = st + (NA + i) * TILE_BYTES;
            if constexpr (MN) {
              hop::tma_load(dst, bm, &full[s], n, k);
              hop::tma_load(dst + TILE_BYTES / 2, bm, &full[s], n + 64, k);
            } else {
              hop::tma_load(dst, bm, &full[s], k, n);
            }
          }
          if (++s == S) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  hop::setmaxnreg_inc<232>();
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float acc[NB][64];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[i][j] = 0.f;
  int s = 0;
  uint32_t phase = 0;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit t = unit_of(g, u);
    for (int kb = 0; kb < t.nk; ++kb) {
      hop::bar_wait(&full[s], phase);
      const unsigned char* st = ring + s * STAGE;
#pragma unroll
      for (int i = 0; i < NB; ++i) hop::keep(acc[i]);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const unsigned char* ta = st + (NA == 1 ? 0 : i) * TILE_BYTES + wg * (TILE_BYTES / 2);
          const unsigned char* tb = st + (NA + i) * TILE_BYTES;
          const int scale = (kb | kk) != 0;
          if constexpr (MN)
            hop::wgmma128<1, 1>(acc[i], hop::desc(ta + kk * 2048, TILE_BYTES / 2, 1024),
                                hop::desc(tb + kk * 2048, TILE_BYTES / 2, 1024), scale);
          else
            hop::wgmma128<0, 0>(acc[i], hop::desc(ta + kk * 32, 16, 1024),
                                hop::desc(tb + kk * 32, 16, 1024), scale);
        }
      }
      hop::wg_commit();
#pragma unroll
      for (int i = 0; i < NB; ++i) hop::keep(acc[i]);
      hop::wg_wait<0>();
#pragma unroll
      for (int i = 0; i < NB; ++i) hop::keep(acc[i]);
      if ((threadIdx.x & 127) == 0) hop::bar_arrive(&empty[s]);
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }

    // Epilogue: this thread's rows r and r + 8, columns c and c + 1 of each
    // 8-column group j.
    const long long r = (long long)t.tm * BM + wg * 64 + warp * 16 + gq;
    if constexpr (EPI == EPI_HIDDEN) {
      // h = gelu(h_pre + b1) and g_hpre = g_h * gelu'(h_pre + b1) in f32,
      // both stored in bf16; db1's per-tile row from the unrounded g_hpre.
      const int H4 = g.cols;
      float* wred = red + wg * 4 * BN;
#pragma unroll
      for (int jq = 0; jq < BN / 32; ++jq) {  // four 8-column groups at a time
        uint32_t hv[2][4], fv[2][4];           // [row r, r + 8][group]
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 4 * jq + q;
          const float2 bb = svt::load2(e.b1 + t.tn * BN + 8 * j + 2 * tq);
          float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float h0, h1, d0, d1;
            svt::gelu_and_grad(acc[0][4 * j + 2 * half] + bb.x, h0, d0);
            svt::gelu_and_grad(acc[0][4 * j + 2 * half + 1] + bb.y, h1, d1);
            const float f0 = acc[1][4 * j + 2 * half] * d0;
            const float f1 = acc[1][4 * j + 2 * half + 1] * d1;
            hv[half][q] = pack_bf16(h0, h1);
            fv[half][q] = pack_bf16(f0, f1);
            if (r + 8 * half < g.rows) {
              cs0 += f0;
              cs1 += f1;
            }
          }
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            cs0 += __shfl_xor_sync(0xffffffffu, cs0, o);
            cs1 += __shfl_xor_sync(0xffffffffu, cs1, o);
          }
          if (gq == 0) {
            wred[warp * BN + 8 * j + 2 * tq] = cs0;
            wred[warp * BN + 8 * j + 2 * tq + 1] = cs1;
          }
        }
        // A quad holds 32 columns of rows r and r + 8 in 4-byte pairs; after
        // the transpose lane tq holds group 4 jq + tq whole, one 16-byte store.
        const int c8 = t.tn * BN + 8 * (4 * jq + tq);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          quad_transpose(hv[half], tq);
          quad_transpose(fv[half], tq);
          const long long row = r + 8 * half;
          if (row < g.rows) {
            store16(e.h + row * H4 + c8, hv[half]);
            store16(e.gh + row * H4 + c8, fv[half]);
          }
        }
      }
      hop::named_sync(1 + wg, 128);
      const long long tok0 = (long long)t.tm * BM + wg * 64;  // this warpgroup's 64 tokens
      if (tok0 < g.rows) {
        const int c = threadIdx.x & 127;
        e.part[(tok0 / TOK) * (8LL * e.C) + t.tn * BN + c] =
            wred[c] + wred[BN + c] + wred[2 * BN + c] + wred[3 * BN + c];
      }
      hop::named_sync(1 + wg, 128);  // wred is free for the next unit
    } else {
#pragma unroll
      for (int i = 0; i < NB; ++i) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = t.tn * TILE_N + i * BN + 8 * j + 2 * tq;
          if (c >= g.cols) continue;  // cols is even, so c + 1 < cols too
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const long long row = r + 8 * half;
            if (row >= g.rows) continue;
            const float v0 = acc[i][4 * j + 2 * half], v1 = acc[i][4 * j + 2 * half + 1];
            if constexpr (EPI == EPI_DY)
              svt::store2(e.dy + row * g.cols + c, v0, v1);
            else if constexpr (EPI == EPI_GY)
              svt::store2(e.gy + row * g.cols + c, v0, v1);
            else
              svt::store2(e.ws + (t.split * g.rows + row) * g.cols + c, v0, v1);
          }
        }
      }
    }
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

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// The maps of a product. K-major: A [rows, K] and B [cols, K] in boxes of 128
// rows. MN-major: A [K, rows] and B [K, cols] (token-major) in 64 x 64 boxes.
template <int NA, int NB, bool MN, int EPI>
int launch_gemm(const CUtensorMap (&m)[4], const Gemm& g, const Epi& e, cudaStream_t s) {
  constexpr size_t smem = gemm_smem_bytes<NA, NB>();
  const cudaError_t err = cudaFuncSetAttribute(
      wg_gemm<NA, NB, MN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long units = (long long)g.tiles_m * g.tiles_n * g.splits;
  const unsigned grid = (unsigned)(units < sm_count() ? units : sm_count());
  wg_gemm<NA, NB, MN, EPI><<<grid, GEMM_THREADS, smem, s>>>(m[0], m[1], m[2], m[3], g, e);
  return (int)cudaGetLastError();
}

// Everything a backward call reads, writes and uses as scratch (ops/fused_mlp.py
// allocates it). t is bf16, or f32 with U32; every other activation is bf16
// [M, C] or [M, 4C]; y aliases t without the LayerNorm.
struct MlpBwd {
  const void* t;
  const bf16 *g, *w1t, *w1, *w2t, *w2;
  const float *ls, *lb, *b1, *b2, *gamma;
  bf16* dt;
  float *gu32, *small, *dw1t, *dw2t, *dgamma;
  bf16 *y, *gg, *h, *gh;
  float *stats, *gy, *part, *ws;
  long long M, ks;
  int C, splits;
  float eps;
};

template <int C, bool LN, bool U32>
int mlp_bwd_c(const MlpBwd& a, cudaStream_t s) {
  using TT = typename std::conditional<U32, float, bf16>::type;
  const long long M = a.M;
  const long long row_tiles = (M + TOK - 1) / TOK;
  const bf16* y = LN ? a.y : static_cast<const bf16*>(a.t);
  const int H4 = 4 * C;
  const int tiles_m = (int)((M + BM - 1) / BM);
  int err;
  bwd_rows<C, LN, U32><<<(unsigned)row_tiles, ROW_THREADS, 0, s>>>(
      static_cast<const TT*>(a.t), a.g, a.ls, a.lb, a.gamma, a.y, a.gg, a.stats, a.part, M,
      a.eps);
  if ((err = (int)cudaGetLastError())) return err;
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
    if ((err = launch_gemm<2, 2, false, EPI_HIDDEN>(m, g, e, s))) return err;
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
      err = launch_gemm<1, NB, false, EPI_GY>(m, g, e, s);
    else
      err = launch_gemm<1, NB, false, EPI_DY>(m, g, e, s);
    if (err) return err;
  }
  if constexpr (LN) {  // L
    ln_rows_bwd<C, U32><<<(unsigned)row_tiles, ROW_THREADS, 0, s>>>(
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
    if ((err = launch_gemm<1, 1, true, EPI_WS>(m, g1, e, s))) return err;
    reduce_rows<<<H4, 256, 0, s>>>(a.ws, a.splits, H4, C, nullptr, nullptr, nullptr, nullptr,
                                   a.dw1t, nullptr);
    if ((err = (int)cudaGetLastError())) return err;
    if ((err = hop::make_map(&m[0], a.g, M, C, C, 64)) ||
        (err = hop::make_map(&m[2], a.h, M, H4, H4, 64)))
      return err;
    m[1] = m[0];
    m[3] = m[2];
    const Gemm g2{C, M, a.ks, H4, (C + BM - 1) / BM, H4 / BN, a.splits};
    if ((err = launch_gemm<1, 1, true, EPI_WS>(m, g2, e, s))) return err;
    // dW2 = gamma * A^T; dgamma = sum_j W2 * A^T + (sum g) * b2.
    reduce_rows<<<C, 256, 0, s>>>(a.ws, a.splits, C, H4, a.gamma, a.w2t, a.small + 7 * C, a.b2,
                                  a.dw2t, a.dgamma);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
}

// One backward call, its stages in order. Each split of stage D must hold at
// least one token: ks a multiple of BK, (splits - 1) * ks < M <= splits * ks.
template <bool LN, bool U32 = false>
int mlp_bwd(const MlpBwd& a, cudaStream_t s) {
  if (a.M <= 0 || a.M > 0x7fffffffLL || a.ks <= 0 || a.ks % BK || a.splits <= 0 ||
      (a.splits - 1) * a.ks >= a.M || a.splits * a.ks < a.M)
    return (int)cudaErrorInvalidValue;
#define SVT_MLP_BWD_CASE(CC) \
  case CC:                   \
    return mlp_bwd_c<CC, LN, U32>(a, s);
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
