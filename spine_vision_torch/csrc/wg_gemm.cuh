// wg_gemm: a warp-specialized wgmma product fed by TMA through an mbarrier
// ring (hopper.cuh), with the epilogue of each product that uses it:
//   the MLP backward (ln_mlp_bwd.cuh): stage B's hidden epilogue, stage C's
//     dy or g_y, stage D's split workspace;
//   the MLP forwards (mlp_products, below: the block forward of
//     convnext_block.cu and the row forms of row_mlp.cu): F1's h =
//     gelu_tanh(y . W1 + b1) and F2's out = (h . W2 + b2) * gamma + x, or
//     without gamma and x, h . W2 + b2 (the row form #5 without its tail).
// Each epilogue is its own instantiation (`if constexpr`), so adding one
// leaves the others' code as it was. Each library that includes this gets its
// own copy.
#pragma once

#include "dwconv_ln.cuh"
#include "gelu.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Tokens a row of the backward's per-tile sums workspace `part` covers (the
// row kernels' tile, ln_mlp_bwd.cuh); stage B's epilogue writes db1's rows.
constexpr int PART_TOK = 64;

// An output tile of 128 rows, 64 a consumer warpgroup, by NB x 128 columns;
// K in slices of 64 (one 128-byte swizzle row of bf16), each slice a ring
// stage.
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int GEMM_THREADS = 384;        // consumer warpgroups 0, 1; producer 2
constexpr int TILE_BYTES = 128 * BK * 2;  // a 128 x 64 bf16 operand tile
constexpr int RING_BYTES = 200 * 1024;    // the ring's stages share this

// A product's tile space: out [rows, cols] = sum over k < K of A[row][k] *
// B[col][k], in tiles of BM rows by wg_gemm's TILE_N columns, K cut into
// `splits` ranges of ks (a multiple of BK) for stage D; a unit of work is one
// (tile, split).
struct Gemm {
  long long rows, k, ks;
  int cols, tiles_m, tiles_n, splits;
};

// What the epilogues read and write. The backward: stage B h and g_hpre
// (bf16, [M, 4C]) and db1's per-tile row of part; stage C dy (bf16) or g_y
// (f32), [M, C]; stage D the f32 split workspace ws [splits, rows, cols]. The
// MLP forwards: F1 h (bf16 [M, 4C]) from b1; F2 out (bf16 [M, C]) from b2
// and, in EPI_OUT, gamma and the residual x (bf16 [M, C]). The forward's
// fields come last, so the backward's kernels read their parameters where
// they did.
struct Epi {
  const float* b1;
  bf16* h;
  bf16* gh;
  float* part;
  bf16* dy;
  float* gy;
  float* ws;
  int C;
  const float* b2;
  const float* gamma;
  const bf16* x;
  bf16* out;
};
enum { EPI_HIDDEN, EPI_DY, EPI_GY, EPI_WS, EPI_GELU, EPI_OUT, EPI_BIAS };

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
__device__ __forceinline__ void load16(uint32_t (&v)[4], const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
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
  // Its own name: the dynamic shared memory declarations of one library are
  // one symbol, whose alignment would otherwise mix with the other kernels'.
  extern __shared__ unsigned char gemm_smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gemm_smem) + 1023) & ~static_cast<uintptr_t>(1023));
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
        e.part[(tok0 / PART_TOK) * (8LL * e.C) + t.tn * BN + c] =
            wred[c] + wred[BN + c] + wred[2 * BN + c] + wred[3 * BN + c];
      }
      hop::named_sync(1 + wg, 128);  // wred is free for the next unit
    } else if constexpr (EPI == EPI_GELU) {
      // F1: h = gelu_tanh(acc + b1) in f32, stored in bf16 through the quad
      // transpose as stage B's h. cols (4C) is a multiple of TILE_N.
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int n0 = t.tn * TILE_N + i * BN;
#pragma unroll
        for (int jq = 0; jq < BN / 32; ++jq) {
          uint32_t hv[2][4];  // [row r, r + 8][group]
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = 4 * jq + q;
            const float2 bb = svt::load2(e.b1 + n0 + 8 * j + 2 * tq);
#pragma unroll
            for (int half = 0; half < 2; ++half)
              hv[half][q] = pack_bf16(svt::gelu_tanh(acc[i][4 * j + 2 * half] + bb.x),
                                      svt::gelu_tanh(acc[i][4 * j + 2 * half + 1] + bb.y));
          }
          const int c8 = n0 + 8 * (4 * jq + tq);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            quad_transpose(hv[half], tq);
            const long long row = r + 8 * half;
            if (row < g.rows) store16(e.h + row * g.cols + c8, hv[half]);
          }
        }
      }
    } else if constexpr (EPI == EPI_OUT || EPI == EPI_BIAS) {
      // F2: out = (acc + b2) * gamma + x (EPI_OUT) or acc + b2 (EPI_BIAS) in
      // f32, rounded once to bf16. x and out move as 16-byte groups: lane tq
      // loads group 4 jq + tq of its row, the quad transpose (its own
      // inverse) hands each lane its column pairs, and the results go back
      // the same way. Groups past cols (C = 96 and 192 end inside a tile;
      // cols is a multiple of 8) and rows past the last token are neither
      // read nor stored.
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int n0 = t.tn * TILE_N + i * BN;
#pragma unroll
        for (int jq = 0; jq < BN / 32; ++jq) {
          const int c8 = n0 + 8 * (4 * jq + tq);
          uint32_t xv[2][4];  // [row r, r + 8][group]
          if constexpr (EPI == EPI_OUT) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const long long row = r + 8 * half;
              if (row < g.rows && c8 < g.cols)
                load16(xv[half], e.x + row * g.cols + c8);
              else
                xv[half][0] = xv[half][1] = xv[half][2] = xv[half][3] = 0u;
              quad_transpose(xv[half], tq);
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = n0 + 8 * (4 * jq + q) + 2 * tq;
            const int j = 4 * jq + q;
            if constexpr (EPI == EPI_OUT) {
              float2 bb = make_float2(0.f, 0.f), gm = make_float2(0.f, 0.f);
              if (c < g.cols) {
                bb = svt::load2(e.b2 + c);
                gm = svt::load2(e.gamma + c);
              }
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const float2 xf = unpack_bf16(xv[half][q]);
                xv[half][q] = pack_bf16((acc[i][4 * j + 2 * half] + bb.x) * gm.x + xf.x,
                                        (acc[i][4 * j + 2 * half + 1] + bb.y) * gm.y + xf.y);
              }
            } else {
              const float2 bb = c < g.cols ? svt::load2(e.b2 + c) : make_float2(0.f, 0.f);
#pragma unroll
              for (int half = 0; half < 2; ++half)
                xv[half][q] = pack_bf16(acc[i][4 * j + 2 * half] + bb.x,
                                        acc[i][4 * j + 2 * half + 1] + bb.y);
            }
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            quad_transpose(xv[half], tq);
            const long long row = r + 8 * half;
            if (row < g.rows && c8 < g.cols) store16(e.out + row * g.cols + c8, xv[half]);
          }
        }
      }
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

// The MLP forward's two products over M token rows of width C, as the block
// forward and the row forms launch them:
//   F1 wg_gemm<1, NB, false, EPI_GELU>: h = gelu_tanh(y . W1^T + b1) into the
//      caller's h [M, 4C]; K = C (96 is zero-filled to 128 by TMA);
//   F2 wg_gemm<1, NB, false, EPI2>: out from h . W2^T and e2 (EPI_OUT: b2,
//      gamma, the residual e2.x and out; EPI_BIAS: b2 and out); K = 4C.
// y, w1t [4C, C], w2t [C, 4C] and h are bf16 and 16-byte aligned. Returns the
// first cudaError_t.
template <int C, int EPI2>
int mlp_products(const bf16* y, const bf16* w1t, const float* b1, const bf16* w2t, bf16* h,
                 long long M, Epi e2, cudaStream_t s) {
  static_assert(EPI2 == EPI_OUT || EPI2 == EPI_BIAS, "F2 writes the MLP's output");
  constexpr int H4 = 4 * C;
  const int tiles_m = (int)((M + BM - 1) / BM);
  int err;
  {  // F1
    constexpr int NB = H4 % (2 * BN) == 0 ? 2 : 1;
    CUtensorMap m[4];
    if ((err = hop::make_map(&m[0], y, M, C, C, BM)) ||
        (err = hop::make_map(&m[2], w1t, H4, C, C, BN)))
      return err;
    m[1] = m[0];
    m[3] = m[2];
    const Gemm g{M, C, C, H4, tiles_m, H4 / (NB * BN), 1};
    Epi e{};
    e.b1 = b1;
    e.h = h;
    e.C = C;
    if ((err = launch_gemm<1, NB, false, EPI_GELU>(m, g, e, s))) return err;
  }
  {  // F2
    constexpr int NB = C % (2 * BN) == 0 ? 2 : 1;
    CUtensorMap m[4];
    if ((err = hop::make_map(&m[0], h, M, H4, H4, BM)) ||
        (err = hop::make_map(&m[2], w2t, C, H4, H4, BN)))
      return err;
    m[1] = m[0];
    m[3] = m[2];
    const Gemm g{M, H4, H4, C, tiles_m, (C + NB * BN - 1) / (NB * BN), 1};
    e2.C = C;
    if ((err = launch_gemm<1, NB, false, EPI2>(m, g, e2, s))) return err;
  }
  return 0;
}

}  // namespace
