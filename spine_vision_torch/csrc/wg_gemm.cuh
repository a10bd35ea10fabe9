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
//
// The f32 element path (T = float) is the one f32 product core: the f32
// forms' products of #1 (convnext_block.py:194), #5 (fused_mlp.py:147), #7
// (:586), #6 (:325), #8/#9 (:930, :1050) and the middle of #10
// (block_train.py:313). The JAX kernels run f32 products in f32, and one
// TF32 product keeps about three decimal digits, so it runs 3xTF32: each f32
// operand x is split into x_hi = tf32(x) and x_lo = tf32(x - x_hi)
// (hopper.cuh, split_tf32), and each K step of 8 sums a_lo . b_hi + a_hi .
// b_lo + a_hi . b_hi (small ones first) into the f32 accumulators, within
// about 2^-21 of the f32 product a term. Bound: 3 * 2 * M * N * K TF32 flops
// at 495 TFLOP/s (2.5x the 67 TFLOP/s of f32 FFMA). TF32 wgmma reads only
// K-major operands from shared memory (no transpose flag), so:
//   A (64 rows a consumer warpgroup) is read from its raw tile as
//     mma.m16n8k8's register fragment and split in registers, K-major
//     (swizzled) or token-major (stage D) alike;
//   B is split by the producer warpgroup's other three warps (the
//     splitters) as it lands: a K-major tile in place (hi over the raw
//     tile, lo beside it), a token-major one (stage D's) transposed into the
//     K-major 128-byte swizzle as it is split.
// Each element is split once for each CTA that loads it. A stage is K = 32
// (one 128-byte swizzle row of f32): raw A, B hi and B lo (and stage D's raw
// B), 48 KB for a 128 x 128 tile, 96 KB for stage B's four operands, two
// to four stages in the ring. The accumulators have bf16's fragment layout,
// so the epilogues are bf16's, storing float. A product whose tiles would
// leave SMs idle is split over K (ops/fused_mlp.py::k_splits): its partials
// go to a workspace and split_reduce sums them in split order and applies
// the epilogue; no atomics, so two runs agree bit for bit.
#pragma once

#include "dwconv_ln.cuh"
#include "gelu.cuh"
#include "hopper.cuh"

#include <type_traits>

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
constexpr int BK32 = 32;                  // f32 K a ring stage: one 128-byte swizzle row
constexpr int GEMM_THREADS = 384;        // consumer warpgroups 0, 1; producer 2
constexpr int TILE_BYTES = 128 * BK * 2;  // a 128 x 64 bf16 operand tile
constexpr int RING_BYTES = 200 * 1024;    // the ring's stages share this
constexpr int SPLITTERS = 96;             // f32: warps 1-3 of the producer warpgroup
static_assert(TILE_BYTES == 128 * BK32 * 4, "an f32 tile is 128 x 32");

// A product's tile space: out [rows, cols] = sum over k < K of A[row][k] *
// B[col][k], in tiles of BM rows by wg_gemm's TILE_N columns, K cut into
// `splits` ranges of ks (a multiple of BK) for stage D and the f32 K splits;
// a unit of work is one (tile, split).
struct Gemm {
  long long rows, k, ks;
  int cols, tiles_m, tiles_n, splits;
};

// What the epilogues read and write, activations in T (bf16 or f32). The
// backward: stage B h and g_hpre ([M, 4C]) and db1's per-tile row of part;
// stage C dy (T) or g_y (f32), [M, C]; stage D the f32 split workspace ws
// [splits, rows, cols] (f32 K splits too: [NA][splits, rows, cols]). The MLP
// forwards: F1 h ([M, 4C]) from b1; F2 out ([M, C]) from b2 and, in EPI_OUT,
// gamma and the residual x ([M, C]). The forward's fields come last, so the
// backward's kernels read their parameters where they did.
template <typename T>
struct EpiT {
  const float* b1;
  T* h;
  T* gh;
  float* part;
  T* dy;
  float* gy;
  float* ws;
  int C;
  const float* b2;
  const float* gamma;
  const T* x;
  T* out;
};
using Epi = EpiT<bf16>;
enum { EPI_HIDDEN, EPI_DY, EPI_GY, EPI_WS, EPI_GELU, EPI_OUT, EPI_BIAS };

// The K plans of an f32 call's two K-major products (F1 and F2, or stages B
// and C): each `splits` ranges of ks, from ops/fused_mlp.py::k_splits.
struct KPlan {
  int s1;
  long long k1;
  int s2;
  long long k2;
};
// A C interface's plan argument, {s1, k1, s2, k2}; null (bf16) is no split.
inline KPlan kplan(const long long* p) {
  return p ? KPlan{(int)p[0], p[1], (int)p[2], p[3]} : KPlan{1, 0, 1, 0};
}

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
// The same in the f32 path's K slices of 32.
__device__ __forceinline__ Unit unit_of32(const Gemm& g, long long u) {
  Unit t = unit_of(g, u);
  const long long k1 = g.k < t.k0 + g.ks ? g.k : t.k0 + g.ks;
  t.nk = (int)((k1 - t.k0 + BK32 - 1) / BK32);
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

// A ring stage: bf16 NA A and NB B tiles; f32 NA raw A tiles, NB B hi and
// NB B lo tiles (and, token-major, NB raw B tiles).
template <typename T, int NA, int NB, bool MN>
__host__ __device__ constexpr int gemm_stage_bytes() {
  return std::is_same<T, float>::value ? (NA + 2 * NB + (MN ? NB : 0)) * TILE_BYTES
                                       : (NA + NB) * TILE_BYTES;
}

// The ring, its barriers (full and empty; f32 also `loaded`, the TMA's) and
// the epilogue's column sums.
template <typename T, int NA, int NB, bool MN>
constexpr size_t gemm_smem_bytes() {
  constexpr int STAGE = gemm_stage_bytes<T, NA, NB, MN>();
  constexpr int S = RING_BYTES / STAGE;
  constexpr int BARS = std::is_same<T, float>::value ? 3 : 2;
  return 1024 + (size_t)S * STAGE + BARS * S * sizeof(uint64_t) + 2 * 4 * BN * sizeof(float);
}

// ---- the f32 path: 3xTF32 ----

// Whether wg_gemm<T, ...> is the f32 path: a variable template, not a
// constexpr local of the kernel, whose presence renumbers two of the ring's
// registers in the bf16 instances' PTX and so moves their SASS.
template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;

// The f32 producer (warpgroup 2's first thread): every K slice of 32 of every
// unit, once its stage is free, TMA-loads raw: A into slot i < NA, B into
// its hi slot (K-major) or its raw slot (token-major), completing on
// loaded[s]. K-major boxes are 128 rows x 32 (the 128-byte swizzle),
// token-major ones 32 K rows x 128 (no swizzle).
template <int NA, bool MN, int S, int STAGE>
__device__ __forceinline__ void produce_f32(const CUtensorMap& a0, const CUtensorMap& a1,
                                            const CUtensorMap& b0, const CUtensorMap& b1,
                                            const Gemm& g, unsigned char* ring, uint64_t* loaded,
                                            uint64_t* empty) {
  constexpr int NB = NA;
  hop::prefetch_map(&a0);
  hop::prefetch_map(&b0);
  if (NA == 2) {
    hop::prefetch_map(&a1);
    hop::prefetch_map(&b1);
  }
  const long long units = (long long)g.tiles_m * g.tiles_n * g.splits;
  int s = 0;
  uint32_t phase = 0;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit t = unit_of32(g, u);
    const int m0 = t.tm * BM, n0 = t.tn * BN;
    for (int kb = 0; kb < t.nk; ++kb) {
      hop::bar_wait(&empty[s], phase ^ 1);
      unsigned char* st = ring + s * STAGE;
      hop::bar_expect_tx(&loaded[s], (NA + NB) * TILE_BYTES);
      const int k = (int)(t.k0 + (long long)kb * BK32);
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const CUtensorMap* am = i == 0 ? &a0 : &a1;
        const CUtensorMap* bm = i == 0 ? &b0 : &b1;
        if constexpr (MN) {
          hop::tma_load(st + i * TILE_BYTES, am, &loaded[s], m0, k);
          hop::tma_load(st + (NA + 2 * NB + i) * TILE_BYTES, bm, &loaded[s], n0, k);
        } else {
          hop::tma_load(st + i * TILE_BYTES, am, &loaded[s], k, m0);
          hop::tma_load(st + (NA + i) * TILE_BYTES, bm, &loaded[s], k, n0);
        }
      }
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
  }
}

// The splitters (warps 1-3 of warpgroup 2, `sid` 0-95): once a slice has
// landed, each B tile into hi and lo in the K-major 128-byte swizzle
// ([128 n][32 k], 16-byte chunk q of row n at q ^ (n % 8)), then a proxy
// fence, their barrier and one arrival on full[s]. K-major: in place, a
// float4 at a time. Token-major: 4 K rows of one column n from the raw [32
// k][128 n] tile (a warp's loads on consecutive n), one float4 to each.
template <int NA, bool MN, int S, int STAGE>
__device__ __forceinline__ void split_b(const Gemm& g, unsigned char* ring, uint64_t* loaded,
                                        uint64_t* full, int sid) {
  constexpr int NB = NA;
  const long long units = (long long)g.tiles_m * g.tiles_n * g.splits;
  int s = 0;
  uint32_t phase = 0;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit t = unit_of32(g, u);
    for (int kb = 0; kb < t.nk; ++kb) {
      hop::bar_wait(&loaded[s], phase);
      unsigned char* st = ring + s * STAGE;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        uint4* hi = reinterpret_cast<uint4*>(st + (NA + i) * TILE_BYTES);
        uint4* lo = reinterpret_cast<uint4*>(st + (NA + NB + i) * TILE_BYTES);
        for (int q = sid; q < TILE_BYTES / 16; q += SPLITTERS) {
          float v[4];
          int at = q;
          if constexpr (MN) {
            const float* raw = reinterpret_cast<const float*>(st + (NA + 2 * NB + i) * TILE_BYTES);
            const int n = q & 127, kq = q >> 7;
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = raw[(4 * kq + j) * 128 + n];
            at = n * 8 + (kq ^ (n & 7));
          } else {
            const float4 w = *reinterpret_cast<const float4*>(hi + q);
            v[0] = w.x;
            v[1] = w.y;
            v[2] = w.z;
            v[3] = w.w;
          }
          uint32_t h[4], l[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) hop::split_tf32(v[j], h[j], l[j]);
          hi[at] = make_uint4(h[0], h[1], h[2], h[3]);
          lo[at] = make_uint4(l[0], l[1], l[2], l[3]);
        }
      }
      hop::fence_proxy_async();
      hop::named_sync(3, SPLITTERS);
      if (sid == 0) hop::bar_arrive(&full[s]);
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
  }
}

// One f32 slice's wgmma products into d (K steps of 8: lo . hi, hi . lo,
// hi . hi on B's hi and lo tiles), d overwritten unless `add`; waits for
// them.
template <int NA>
__device__ __forceinline__ void slice_tf32(float (&d)[NA][64], const uint32_t (&ah)[NA][4][4],
                                           const uint32_t (&al)[NA][4][4],
                                           const unsigned char* st, bool add) {
  constexpr int NB = NA;
#pragma unroll
  for (int i = 0; i < NB; ++i) hop::keep(d[i]);
  hop::wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const uint64_t bh = hop::desc(st + (NA + i) * TILE_BYTES + kk * 32, 16, 1024);
      const uint64_t bl = hop::desc(st + (NA + NB + i) * TILE_BYTES + kk * 32, 16, 1024);
      hop::wgmma128_tf32(d[i], al[i][kk], bh, kk != 0 || add);
      hop::wgmma128_tf32(d[i], ah[i][kk], bl, 1);
      hop::wgmma128_tf32(d[i], ah[i][kk], bh, 1);
    }
  }
  hop::wg_commit();
#pragma unroll
  for (int i = 0; i < NB; ++i) hop::keep(d[i]);
  hop::wg_wait<0>();
#pragma unroll
  for (int i = 0; i < NB; ++i) hop::keep(d[i]);
}

// A consumer warpgroup's products of one f32 slice: its A rows (thread rows
// r and r + 8, K columns tq and tq + 4 of each step of 8) from the raw tile
// (K-major, swizzled: float r * 32 + ((k / 4) ^ (r % 8)) * 4 + k % 4;
// token-major: k * 128 + r), split in registers; then for each K step the
// three TF32 products lo . hi, hi . lo, hi . hi on B's hi and lo tiles. The
// tensor core adds into its accumulator without rounding to nearest, so a
// long chain of adds drifts (1.2e-4 of max |dW1| over stage D's 16384-token
// splits, measured on an H100): with NA = 1 each slice's 12 products start
// a fresh wgmma accumulator d, which is then added into acc in f32 (round
// to nearest), as SIMT sums would; stage B (NA = 2, K = C <= 512: 192 adds
// at most) accumulates in acc itself, which its registers require. The
// first slice of a unit (`first`) overwrites acc.
template <int NA, bool MN, int STAGE>
__device__ __forceinline__ void consume_f32(float (&acc)[NA][64], const unsigned char* st, int r,
                                            int tq, bool first) {
  constexpr int NB = NA;
  constexpr bool PROMOTE = NA == 1;
  uint32_t ah[NA][4][4], al[NA][4][4];  // [operand][K step][fragment register]
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const float* ta = reinterpret_cast<const float*>(st + i * TILE_BYTES);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = r + 8 * (q & 1), k = 8 * kk + tq + 4 * (q >> 1);
        const float v = MN ? ta[k * 128 + row]
                           : ta[row * 32 + (((k >> 2) ^ (row & 7)) << 2) + (k & 3)];
        hop::split_tf32(v, ah[i][kk][q], al[i][kk][q]);
      }
  }
  if constexpr (PROMOTE) {
    float d[NB][64];
    slice_tf32<NA>(d, ah, al, st, false);
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[i][j] = first ? d[i][j] : acc[i][j] + d[i][j];
  } else {
    slice_tf32<NA>(acc, ah, al, st, !first);
  }
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
// T = float: the 3xTF32 path (above): K slices of 32 land raw on `loaded`;
// the splitters split B and arrive on `full`; the consumers split their A
// rows in registers. NB = NA: tiles of 128 x 128.
template <typename T, int NA, int NB, bool MN, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 1) wg_gemm(
    const __grid_constant__ CUtensorMap a0, const __grid_constant__ CUtensorMap a1,
    const __grid_constant__ CUtensorMap b0, const __grid_constant__ CUtensorMap b1,
    const Gemm g, const EpiT<T> e) {
  static_assert(NA == 1 || NA == NB, "two products pair A_i with B_i");
  static_assert(!kF32<T> || NA == NB, "an f32 tile is 128 x 128");
  constexpr int STAGE = gemm_stage_bytes<T, NA, NB, MN>();
  constexpr int S = RING_BYTES / STAGE;
  constexpr int TILE_N = NA == 2 ? BN : NB * BN;  // the output tile's columns
  // Its own name: the dynamic shared memory declarations of one library are
  // one symbol, whose alignment would otherwise mix with the other kernels'.
  extern __shared__ unsigned char gemm_smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gemm_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * STAGE);
  uint64_t* empty = full + S;
  // [2 warpgroups][4 warps][BN], after f32's third barrier array
  float* red = reinterpret_cast<float*>(empty + (kF32<T> ? 2 * S : S));

  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hop::bar_init(&full[s], 1);
      hop::bar_init(&empty[s], 2);  // one arrival a consumer warpgroup
      if constexpr (kF32<T>) hop::bar_init(&empty[S + s], 1);  // `loaded`
    }
    hop::bar_init_fence();
  }
  __syncthreads();
  const long long units = (long long)g.tiles_m * g.tiles_n * g.splits;

  if constexpr (kF32<T>) {
    uint64_t* loaded = empty + S;  // the raw tiles' TMA transactions
    if (wg == 2) {
      hop::setmaxnreg_dec<40>();
      if (threadIdx.x == 2 * 128)
        produce_f32<NA, MN, S, STAGE>(a0, a1, b0, b1, g, ring, loaded, empty);
      else if (threadIdx.x >= 2 * 128 + 32)
        split_b<NA, MN, S, STAGE>(g, ring, loaded, full, threadIdx.x - (2 * 128 + 32));
      return;
    }
  }
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
    const Unit t = kF32<T> ? unit_of32(g, u) : unit_of(g, u);
    for (int kb = 0; kb < t.nk; ++kb) {
      hop::bar_wait(&full[s], phase);
      if constexpr (kF32<T>) {
        hop::bar_wait(&empty[S + s], phase);  // `loaded`: the raw A tiles, read here
        consume_f32<NA, MN, STAGE>(acc, ring + s * STAGE, wg * 64 + warp * 16 + gq, tq,
                                   kb == 0);
        if ((threadIdx.x & 127) == 0) hop::bar_arrive(&empty[s]);
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
        continue;
      }
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
            if constexpr (kF32<T>) {  // f32: each pair stored as it is formed
              const long long row = r + 8 * half;
              const int c = t.tn * BN + 8 * j + 2 * tq;
              if (row < g.rows) {
                svt::store2(e.h + row * H4 + c, h0, h1);
                svt::store2(e.gh + row * H4 + c, f0, f1);
              }
            } else {
            hv[half][q] = pack_bf16(h0, h1);
            fv[half][q] = pack_bf16(f0, f1);
            }
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
        if constexpr (!kF32<T>) {
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
              if constexpr (kF32<T>) {
                const long long row = r + 8 * half;
                if (row < g.rows)
                  svt::store2(e.h + row * g.cols + n0 + 8 * j + 2 * tq,
                              svt::gelu_tanh(acc[i][4 * j + 2 * half] + bb.x),
                              svt::gelu_tanh(acc[i][4 * j + 2 * half + 1] + bb.y));
              } else
              hv[half][q] = pack_bf16(svt::gelu_tanh(acc[i][4 * j + 2 * half] + bb.x),
                                      svt::gelu_tanh(acc[i][4 * j + 2 * half + 1] + bb.y));
          }
          if constexpr (!kF32<T>) {
          const int c8 = n0 + 8 * (4 * jq + tq);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            quad_transpose(hv[half], tq);
            const long long row = r + 8 * half;
            if (row < g.rows) store16(e.h + row * g.cols + c8, hv[half]);
          }
          }
        }
      }
    } else if constexpr (kF32<T> && (EPI == EPI_OUT || EPI == EPI_BIAS)) {
      // F2 in f32: out = (acc + b2) * gamma + x or acc + b2, a column pair
      // at a time (cols is a multiple of 8).
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = t.tn * TILE_N + 8 * j + 2 * tq;
        if (c >= g.cols) continue;
        const float2 bb = svt::load2(e.b2 + c);
        float2 gm = make_float2(0.f, 0.f);
        if constexpr (EPI == EPI_OUT) gm = svt::load2(e.gamma + c);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long row = r + 8 * half;
          if (row >= g.rows) continue;
          float v0 = acc[0][4 * j + 2 * half] + bb.x, v1 = acc[0][4 * j + 2 * half + 1] + bb.y;
          if constexpr (EPI == EPI_OUT) {
            const float2 xv = svt::load2(e.x + row * g.cols + c);
            v0 = v0 * gm.x + xv.x;
            v1 = v1 * gm.y + xv.y;
          }
          svt::store2(e.out + row * g.cols + c, v0, v1);
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
    } else if constexpr (NA == 2) {
      // Stage B's f32 K-split partials: accumulator i to plane i of ws
      // ([2][splits, rows, cols]).
      static_assert(kF32<T> && EPI == EPI_WS, "stage B's two products: its epilogue or its partials");
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        float* plane = e.ws + (long long)i * g.splits * g.rows * g.cols;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = t.tn * BN + 8 * j + 2 * tq;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const long long row = r + 8 * half;
            if (row < g.rows)
              svt::store2(plane + (t.split * g.rows + row) * g.cols + c, acc[i][4 * j + 2 * half],
                          acc[i][4 * j + 2 * half + 1]);
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
// rows. MN-major: A [K, rows] and B [K, cols] (token-major) in 64 x 64 boxes
// (f32: 32 x 128).
template <typename T, int NA, int NB, bool MN, int EPI>
int launch_gemm(const CUtensorMap (&m)[4], const Gemm& g, const EpiT<T>& e, cudaStream_t s) {
  constexpr size_t smem = gemm_smem_bytes<T, NA, NB, MN>();
  const cudaError_t err = cudaFuncSetAttribute(
      wg_gemm<T, NA, NB, MN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long units = (long long)g.tiles_m * g.tiles_n * g.splits;
  const unsigned grid = (unsigned)(units < sm_count() ? units : sm_count());
  wg_gemm<T, NA, NB, MN, EPI><<<grid, GEMM_THREADS, smem, s>>>(m[0], m[1], m[2], m[3], g, e);
  return (int)cudaGetLastError();
}

// The f32 K splits' reduction: the EPI epilogue of the sum over splits, in
// split order, of ws [NACC][splits, rows, cols] (NACC 2: stage B's h_pre and
// g_h), with wg_gemm's f32 epilogue math. A CTA a tile of 16 RPT tokens x
// 64 columns, thread (rg, cg) rows RPT rg .. RPT rg + RPT - 1 and columns
// 4 cg .. 4 cg + 3 (cols is a multiple of 4). EPI_HIDDEN takes 64 tokens (a
// row of part) and adds each column's g_hpre over them (each thread's rows,
// then the 16 rg in order) into its row of part; the other epilogues take
// 16, for more CTAs at the few tokens where splits are planned.
template <int NACC, int EPI>
__global__ void __launch_bounds__(256) split_reduce(const Gemm g, const EpiT<float> e) {
  static_assert(NACC == 1 || EPI == EPI_HIDDEN, "two planes are stage B's");
  constexpr int RPT = EPI == EPI_HIDDEN ? PART_TOK / 16 : 1;
  __shared__ float red[16][64];
  const int cg = threadIdx.x & 15, rg = threadIdx.x >> 4;
  const long long row0 = (long long)blockIdx.y * 16 * RPT;
  const int c = blockIdx.x * 64 + 4 * cg;
  const long long plane = (long long)g.splits * g.rows * g.cols;
  float cs[4] = {0.f, 0.f, 0.f, 0.f};
  if (c < g.cols) {
    float bb[4] = {0.f, 0.f, 0.f, 0.f}, gm[4] = {0.f, 0.f, 0.f, 0.f};
    const float* bias = EPI == EPI_GELU || EPI == EPI_HIDDEN ? e.b1 : e.b2;
    if (EPI == EPI_GELU || EPI == EPI_HIDDEN || EPI == EPI_OUT || EPI == EPI_BIAS)
      for (int j = 0; j < 4; ++j) bb[j] = bias[c + j];
    if (EPI == EPI_OUT)
      for (int j = 0; j < 4; ++j) gm[j] = e.gamma[c + j];
    for (int i = 0; i < RPT; ++i) {
      const long long row = row0 + RPT * rg + i;
      if (row >= g.rows) break;
      const long long at = row * g.cols + c;
      float v[NACC][4];
#pragma unroll
      for (int p = 0; p < NACC; ++p) {
        v[p][0] = v[p][1] = v[p][2] = v[p][3] = 0.f;
#pragma unroll 4
        for (int sp = 0; sp < g.splits; ++sp) {
          const float4 w =
              *reinterpret_cast<const float4*>(e.ws + p * plane + sp * g.rows * g.cols + at);
          v[p][0] += w.x;
          v[p][1] += w.y;
          v[p][2] += w.z;
          v[p][3] += w.w;
        }
      }
      float o[4], f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (EPI == EPI_HIDDEN) {
          float d;
          svt::gelu_and_grad(v[0][j] + bb[j], o[j], d);
          f[j] = v[NACC - 1][j] * d;
          cs[j] += f[j];
        } else if constexpr (EPI == EPI_GELU) {
          o[j] = svt::gelu_tanh(v[0][j] + bb[j]);
        } else if constexpr (EPI == EPI_OUT) {
          o[j] = (v[0][j] + bb[j]) * gm[j] + e.x[at + j];
        } else if constexpr (EPI == EPI_BIAS) {
          o[j] = v[0][j] + bb[j];
        } else {
          o[j] = v[0][j];
        }
      }
      float* dst = EPI == EPI_HIDDEN || EPI == EPI_GELU ? e.h
                   : EPI == EPI_DY                       ? e.dy
                   : EPI == EPI_GY                       ? e.gy
                                                         : e.out;
      *reinterpret_cast<float4*>(dst + at) = make_float4(o[0], o[1], o[2], o[3]);
      if constexpr (EPI == EPI_HIDDEN)
        *reinterpret_cast<float4*>(e.gh + at) = make_float4(f[0], f[1], f[2], f[3]);
    }
  }
  if constexpr (EPI == EPI_HIDDEN) {
#pragma unroll
    for (int j = 0; j < 4; ++j) red[rg][4 * cg + j] = cs[j];
    __syncthreads();
    const int col = blockIdx.x * 64 + threadIdx.x;
    if (threadIdx.x < 64 && col < g.cols && row0 < g.rows) {
      float sum = 0.f;
      for (int y = 0; y < 16; ++y) sum += red[y][threadIdx.x];
      e.part[(row0 / PART_TOK) * (8LL * e.C) + col] = sum;
    }
  }
}

// Whether `splits` ranges of ks (a multiple of BK) cover K once, each
// non-empty.
inline bool plan_ok(int splits, long long ks, long long k) {
  return splits >= 1 && ks > 0 && ks % BK == 0 && (long long)(splits - 1) * ks < k &&
         (long long)splits * ks >= k;
}

// One f32 product on the 3xTF32 path, out = A . B^T over K: K-major A [rows,
// K] and B [cols, K], or token-major (MN) A [K, rows] and B [K, cols]; NA = 2
// pairs A_i with B_i in one tile (stage B). EPI_WS writes the `splits`
// ranges' partials to e.ws (stage D); any other EPI with splits > 1 writes
// them there and split_reduce applies EPI. Pointers 16-byte aligned.
template <int NA, bool MN, int EPI>
int product_f32(const float* a0, const float* a1, const float* b0, const float* b1,
                long long rows, long long k, int cols, int splits, long long ks,
                const EpiT<float>& e, cudaStream_t s) {
  if (!plan_ok(splits, ks, k) || rows <= 0 || rows > 0x7fffffffLL || k > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto map = [&](CUtensorMap* m, const float* p, long long n) {
    return MN ? hop::make_map_f32(m, p, k, n, n, BK32, BM, false)
              : hop::make_map_f32(m, p, n, k, k, BM, BK32, true);
  };
  CUtensorMap m[4];
  int err;
  if ((err = map(&m[0], a0, rows)) || (err = map(&m[2], b0, cols))) return err;
  if (NA == 2) {
    if ((err = map(&m[1], a1, rows)) || (err = map(&m[3], b1, cols))) return err;
  } else {
    m[1] = m[0];
    m[3] = m[2];
  }
  const Gemm g{rows, k, ks, cols, (int)((rows + BM - 1) / BM), (cols + BN - 1) / BN, splits};
  if constexpr (EPI == EPI_WS) {
    return launch_gemm<float, NA, NA, MN, EPI_WS>(m, g, e, s);
  } else {
    if (splits == 1) return launch_gemm<float, NA, NA, MN, EPI>(m, g, e, s);
    if ((err = launch_gemm<float, NA, NA, MN, EPI_WS>(m, g, e, s))) return err;
    constexpr int TR = EPI == EPI_HIDDEN ? PART_TOK : 16;  // split_reduce's tokens a CTA
    split_reduce<NA, EPI><<<dim3((unsigned)((cols + 63) / 64), (unsigned)((rows + TR - 1) / TR)),
                            256, 0, s>>>(g, e);
    return (int)cudaGetLastError();
  }
}

// The MLP forward's two products in f32 (the f32 forms of #1, #5 and #7):
// F1 h = gelu_tanh(y . W1^T + b1) [M, 4C] and F2 out from h . W2^T and e2
// (EPI_OUT or EPI_BIAS), each over its plan's K splits, the partials in ws.
template <int C, int EPI2>
int mlp_products_f32(const float* y, const float* w1t, const float* b1, const float* w2t,
                     float* h, long long M, EpiT<float> e2, float* ws, const KPlan& p,
                     cudaStream_t s) {
  static_assert(EPI2 == EPI_OUT || EPI2 == EPI_BIAS, "F2 writes the MLP's output");
  constexpr int H4 = 4 * C;
  EpiT<float> e1{};
  e1.b1 = b1;
  e1.h = h;
  e1.ws = ws;
  e1.C = C;
  if (const int err = product_f32<1, false, EPI_GELU>(y, nullptr, w1t, nullptr, M, C, H4, p.s1,
                                                      p.k1, e1, s))
    return err;
  e2.ws = ws;
  e2.C = C;
  return product_f32<1, false, EPI2>(h, nullptr, w2t, nullptr, M, H4, C, p.s2, p.k2, e2, s);
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
    if ((err = launch_gemm<bf16, 1, NB, false, EPI_GELU>(m, g, e, s))) return err;
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
    if ((err = launch_gemm<bf16, 1, NB, false, EPI2>(m, g, e2, s))) return err;
  }
  return 0;
}

}  // namespace
