// f32_gemm: the f32 product core of the ConvNeXt kernels' f32 forms (#1, #5,
// #7 and the MLP backward of #6, #8/#9 and #10), with the epilogues of
// wg_gemm.cuh's products:
//   the MLP forwards: F1's h = gelu_tanh(y . W1 + b1) (EPI_GELU) and F2's
//     out = (h . W2 + b2) * gamma + x (EPI_OUT) or h . W2 + b2 (EPI_BIAS);
//   the MLP backward: stage B's hidden epilogue (EPI_HIDDEN: h, g_hpre and
//     db1's per-64-token rows), stage C's dy or g_y (EPI_DY, EPI_GY), stage
//     D's split workspace (EPI_WS).
// The element math is wg_gemm.cuh's (svt::gelu_tanh, svt::gelu_and_grad);
// the fragments differ (a thread's 8 x 8 block here, wgmma's register layout
// there), so each core walks its own.
//
// Operands and sums are f32, products f32 FFMA: the JAX kernels in f32 run
// f32 products (no TF32), and the plain versions run with TF32 off. One pass
// of TF32 tensor-core products keeps about three decimal digits, outside the
// f32 forms' 1e-4 bound, so this core is SIMT. Bound: the H100's 67 TFLOP/s
// f32 rate (an MLP's 16 * M * C^2 flops against 8 * M * C bytes a side).
//
// Design: a CTA computes a 128 x 128 output tile with 256 threads, each an
// 8 x 8 block (rows ty * 4 + {0..3} and 64 + ty * 4 + {0..3}, columns
// tx * 4 + {0..3} and 64 + tx * 4 + {0..3}: a warp's B reads are 256
// contiguous bytes, its A reads two broadcasts). K walks in slices of 8,
// double-buffered in shared memory: slice k + 1 is loaded from device memory
// into registers (one 16-byte load an operand a thread) while slice k is
// multiplied, then stored to the other buffer; one barrier a slice. Both
// buffers hold [k][m] (and [k][n]): a K-major operand ([rows, K], the
// forwards' and stages B and C's) is transposed as it is stored, an
// MN-major one ([K, rows], stage D's token-major operands) is stored as it
// is. One CTA a unit (tile, split); no atomics, so two runs agree bit for
// bit.
#pragma once

#include "wg_gemm.cuh"

namespace {

namespace f32g {

constexpr int TM = 128;  // a tile's rows and columns
constexpr int TK = 8;    // K a slice
constexpr int THREADS = 256;
constexpr int LD = TM + 4;  // a shared row: the pad puts a transposed store's two K halves apart

// What the f32 epilogues read and write (wg_gemm.cuh's Epi, in f32).
struct EpiF {
  const float* b1;
  float* h;
  float* gh;
  float* part;
  float* dy;
  float* gy;
  float* ws;
  int C;
  const float* b2;
  const float* gamma;
  const float* x;
  float* out;
};

// The operands: A_i [rows, K] and B_i [cols, K] (K-major), or A_i [K, rows]
// and B_i [K, cols] (MN); a second pair only with NA = 2 (stage B).
struct Ops {
  const float* a[2];
  const float* b[2];
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// This thread's share of a slice of one operand: rows (or columns) [r0, r0
// + 128) by K [k0, k0 + 8), zeros past `rows` or past `kend`. K-major: one
// row and 4 consecutive k; MN: one k and 4 consecutive rows.
template <bool MN>
__device__ __forceinline__ float4 fetch(const float* __restrict__ p, long long rows, long long ld,
                                        long long r0, long long k0, long long kend) {
  const int t = threadIdx.x;
  if constexpr (MN) {
    const long long k = k0 + (t >> 5), r = r0 + (t & 31) * 4;
    if (k < kend && r < rows) return ld4(p + k * ld + r);
  } else {
    const long long r = r0 + (t >> 1), k = k0 + (t & 1) * 4;
    if (r < rows && k < kend) return ld4(p + r * ld + k);
  }
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// The fetched share into a [TK][LD] buffer.
template <bool MN>
__device__ __forceinline__ void put(float* s, const float4 v) {
  const int t = threadIdx.x;
  if constexpr (MN) {
    st4(s + (t >> 5) * LD + (t & 31) * 4, v.x, v.y, v.z, v.w);
  } else {
    const int r = t >> 1, k = (t & 1) * 4;
    s[k * LD + r] = v.x;
    s[(k + 1) * LD + r] = v.y;
    s[(k + 2) * LD + r] = v.z;
    s[(k + 3) * LD + r] = v.w;
  }
}

// One unit: blockIdx.x = (split * tiles_m + tm) * tiles_n + tn, as
// wg_gemm.cuh's unit_of. out[row][col] = sum over k in the split of A[row][k]
// * B[col][k] (NA = 2: two sums, A_0 . B_0 and A_1 . B_1), then the
// epilogue EPI.
template <int NA, bool MN, int EPI>
__global__ void __launch_bounds__(THREADS) f32_gemm(const Ops op, const Gemm g, const EpiF e) {
  static_assert(NA == 1 || EPI == EPI_HIDDEN, "two products are stage B's");
  __shared__ __align__(16) float sA[2][NA][TK * LD];
  __shared__ __align__(16) float sB[2][NA][TK * LD];

  long long u = blockIdx.x;
  const int tn = (int)(u % g.tiles_n);
  u /= g.tiles_n;
  const int tm = (int)(u % g.tiles_m);
  const long long split = u / g.tiles_m;
  const long long m0 = (long long)tm * TM, n0 = (long long)tn * TM;
  const long long kbeg = split * g.ks;
  const long long kend = g.k < kbeg + g.ks ? g.k : kbeg + g.ks;
  const int nk = (int)((kend - kbeg + TK - 1) / TK);
  const long long lda = MN ? g.rows : g.k, ldb = MN ? g.cols : g.k;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[NA][8][8];
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][r][c] = 0.f;

  float4 va[NA], vb[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    va[i] = fetch<MN>(op.a[i], g.rows, lda, m0, kbeg, kend);
    vb[i] = fetch<MN>(op.b[i], g.cols, ldb, n0, kbeg, kend);
    put<MN>(sA[0][i], va[i]);
    put<MN>(sB[0][i], vb[i]);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        va[i] = fetch<MN>(op.a[i], g.rows, lda, m0, kbeg + (long long)(kt + 1) * TK, kend);
        vb[i] = fetch<MN>(op.b[i], g.cols, ldb, n0, kbeg + (long long)(kt + 1) * TK, kend);
      }
    }
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const float* a = sA[buf][i] + kk * LD;
        const float* b = sB[buf][i] + kk * LD;
        const float4 a0 = ld4(a + ty * 4), a1 = ld4(a + 64 + ty * 4);
        const float4 b0 = ld4(b + tx * 4), b1 = ld4(b + 64 + tx * 4);
        const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][r][c] = fmaf(ar[r], br[c], acc[i][r][c]);
      }
    }
    if (more) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        put<MN>(sA[buf ^ 1][i], va[i]);
        put<MN>(sB[buf ^ 1][i], vb[i]);
      }
    }
    __syncthreads();  // the stores are visible; buf is free for slice kt + 2
  }

  // Epilogue: row r of the thread's block is m0 + rrow(r), column c n0 +
  // ccol(c); columns go in float4 groups (cols is a multiple of 4, so a
  // group is whole inside or outside it).
  auto rrow = [&](int r) { return m0 + (r < 4 ? ty * 4 + r : 64 + ty * 4 + r - 4); };
  auto ccol = [&](int q) { return n0 + (q == 0 ? tx * 4 : 64 + tx * 4); };
  if constexpr (EPI == EPI_HIDDEN) {
    // h = gelu(h_pre + b1) and g_hpre = g_h * gelu'(h_pre + b1) in f32;
    // db1's per-64-token rows from g_hpre, summed over each half's rows in
    // a fixed order (this thread's 4 rows, then the 16 ty in order).
    float cs[2][8];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const long long c = ccol(q);
      const float4 bb = ld4(e.b1 + c);
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int j = 0; j < 4; ++j) cs[half][4 * q + j] = 0.f;
#pragma unroll
        for (int r4 = 0; r4 < 4; ++r4) {
          const int r = 4 * half + r4;
          const long long row = rrow(r);
          float hv[4], fv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float d;
            svt::gelu_and_grad(acc[0][r][4 * q + j] + bv[j], hv[j], d);
            fv[j] = acc[NA - 1][r][4 * q + j] * d;
          }
          if (row < g.rows) {
            st4(e.h + row * g.cols + c, hv[0], hv[1], hv[2], hv[3]);
            st4(e.gh + row * g.cols + c, fv[0], fv[1], fv[2], fv[3]);
#pragma unroll
            for (int j = 0; j < 4; ++j) cs[half][4 * q + j] += fv[j];
          }
        }
      }
    }
    float* red = &sA[0][0][0];  // [2 halves][16 ty][128 columns]; the slices are done
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        st4(red + (half * 16 + ty) * TM + q * 64 + tx * 4, cs[half][4 * q], cs[half][4 * q + 1],
            cs[half][4 * q + 2], cs[half][4 * q + 3]);
    __syncthreads();
    const int half = threadIdx.x >> 7, col = threadIdx.x & 127;
    const long long tok0 = m0 + 64 * half;
    if (tok0 < g.rows) {
      float s = 0.f;
      for (int y = 0; y < 16; ++y) s += red[(half * 16 + y) * TM + col];
      e.part[(tok0 / PART_TOK) * (8LL * e.C) + n0 + col] = s;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const long long c = ccol(q);
      if (c >= g.cols) continue;
      float4 bb = make_float4(0.f, 0.f, 0.f, 0.f), gm = bb;
      if constexpr (EPI == EPI_GELU) bb = ld4(e.b1 + c);
      if constexpr (EPI == EPI_OUT || EPI == EPI_BIAS) bb = ld4(e.b2 + c);
      if constexpr (EPI == EPI_OUT) gm = ld4(e.gamma + c);
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w}, gv[4] = {gm.x, gm.y, gm.z, gm.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const long long row = rrow(r);
        if (row >= g.rows) continue;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = acc[0][r][4 * q + j];
        const long long at = row * g.cols + c;
        if constexpr (EPI == EPI_GELU) {
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = svt::gelu_tanh(v[j] + bv[j]);
          st4(e.h + at, v[0], v[1], v[2], v[3]);
        } else if constexpr (EPI == EPI_OUT) {
          const float4 xv = ld4(e.x + at);
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = (v[j] + bv[j]) * gv[j] + xr[j];
          st4(e.out + at, v[0], v[1], v[2], v[3]);
        } else if constexpr (EPI == EPI_BIAS) {
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] += bv[j];
          st4(e.out + at, v[0], v[1], v[2], v[3]);
        } else if constexpr (EPI == EPI_DY) {
          st4(e.dy + at, v[0], v[1], v[2], v[3]);
        } else if constexpr (EPI == EPI_GY) {
          st4(e.gy + at, v[0], v[1], v[2], v[3]);
        } else {
          st4(e.ws + split * g.rows * g.cols + at, v[0], v[1], v[2], v[3]);
        }
      }
    }
  }
}

// One launch: a CTA a unit (tile, split).
template <int NA, bool MN, int EPI>
int launch(const Ops& op, const Gemm& g, const EpiF& e, cudaStream_t s) {
  const long long units = (long long)g.tiles_m * g.tiles_n * g.splits;
  if (units <= 0 || units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  f32_gemm<NA, MN, EPI><<<(unsigned)units, THREADS, 0, s>>>(op, g, e);
  return (int)cudaGetLastError();
}

// The tiles of a product's rows or columns.
inline int tiles(long long n) { return (int)((n + TM - 1) / TM); }

// The MLP forward's two products over M token rows of width C in f32 (the
// f32 counterpart of wg_gemm.cuh's mlp_products):
//   F1 f32_gemm<1, false, EPI_GELU>: h = gelu_tanh(y . W1^T + b1) [M, 4C];
//   F2 f32_gemm<1, false, EPI2>: out from h . W2^T and e2 (EPI_OUT: b2,
//      gamma, the residual e2.x and out; EPI_BIAS: b2 and out).
// y [M, C], w1t [4C, C], w2t [C, 4C] and h, 16-byte aligned.
template <int C, int EPI2>
int mlp_products(const float* y, const float* w1t, const float* b1, const float* w2t, float* h,
                 long long M, EpiF e2, cudaStream_t s) {
  static_assert(EPI2 == EPI_OUT || EPI2 == EPI_BIAS, "F2 writes the MLP's output");
  constexpr int H4 = 4 * C;
  int err;
  {  // F1
    const Ops op{{y, nullptr}, {w1t, nullptr}};
    const Gemm g{M, C, C, H4, tiles(M), tiles(H4), 1};
    EpiF e{};
    e.b1 = b1;
    e.h = h;
    e.C = C;
    if ((err = launch<1, false, EPI_GELU>(op, g, e, s))) return err;
  }
  const Ops op{{h, nullptr}, {w2t, nullptr}};
  const Gemm g{M, H4, H4, C, tiles(M), tiles(C), 1};
  e2.C = C;
  return launch<1, false, EPI2>(op, g, e2, s);
}

}  // namespace f32g

}  // namespace
