// Shared-memory staging for the depthwise stencils of dwconv_bwd.cu: cp.async
// copies of an x box (rows x columns x a 64-channel slab) into shared memory,
// zeros outside the image and past C, and the tile geometry of the stencil #3
// and of the backward's statistics (S) and tile (T) kernels. Only
// dwconv_bwd.cu includes this; ops/dwconv.py (stencil_geometry,
// bwd_geometry) mirrors the geometry.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "dwconv_ln.cuh"

namespace dws {

using svt::KS;
using svt::PAD;

constexpr int CS = 64;               // channels a slab: a pair a lane
constexpr int SMEM_SM = 233472;      // shared memory of an H100 multiprocessor
constexpr int SMEM_CTA = 232448;     // the most one CTA may ask for
constexpr int SMEM_RESERVED = 1024;  // held back for each resident CTA

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Channels [c0, c0 + CS) of x at image rows [y0, y0 + R) and columns
// [x0, x0 + Q) of image b into dst [R][Q][CS]: zeros outside the image and
// past C (the copies of 16 bytes never straddle C, a multiple of 8). The
// CTA's NT threads share the copies; the caller commits them.
template <typename T, int R, int Q, int NT>
__device__ __forceinline__ void load_box(T* dst, const T* __restrict__ x, int b, int y0,
                                         int x0, int c0, int H, int W, int C) {
  constexpr int EV = 16 / (int)sizeof(T);  // elements a copy
  constexpr int V = CS / EV;               // copies a position
  for (int v = threadIdx.x; v < R * Q * V; v += NT) {
    const int pos = v / V, e = (v % V) * EV;
    const int hh = y0 + pos / Q, ww = x0 + pos % Q, cv = c0 + e;
    const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W && cv < C;
    const T* src = in ? x + (((size_t)b * H + hh) * W + ww) * C + cv : x;
    cp_async16(dst + pos * CS + e, src, in ? 16 : 0);
  }
}

// The stencil #3: a unit is a TH x TW tile of one image on one slab. A warp
// takes a tile column, a lane a channel pair; two halo slots and the slab's
// filter in f32.
template <typename T>
struct Stencil {
  static constexpr int TH = sizeof(T) == 2 ? 16 : 8;
  static constexpr int TW = 8;
  static constexpr int NT = 32 * TW;
  static constexpr int HR = TH + 2 * PAD, HW = TW + 2 * PAD;
  static constexpr int HALO = HR * HW * CS;  // elements a slot
  static constexpr size_t BYTES = 2 * (size_t)HALO * sizeof(T) + KS * KS * CS * sizeof(float);
};

// S, the statistics: a PH x 8 tile of one image at full C. Its f32 conv
// tile and two halo slots; PH the largest of 8, 4, 2, 1 that leaves room for
// two CTAs a multiprocessor, else for one.
template <typename T, int C>
constexpr size_t stats_bytes(int ph) {
  return (size_t)ph * 8 * C * sizeof(float) +
         2 * (size_t)(ph + 2 * PAD) * (8 + 2 * PAD) * CS * sizeof(T);
}
template <typename T, int C>
constexpr int stats_rows() {
  for (int ph = 8; ph >= 1; ph /= 2)
    if (2 * (stats_bytes<T, C>(ph) + SMEM_RESERVED) <= (size_t)SMEM_SM) return ph;
  for (int ph = 8; ph >= 1; ph /= 2)
    if (stats_bytes<T, C>(ph) <= (size_t)SMEM_CTA) return ph;
  return 0;
}
template <typename T, int C>
struct Stats {
  static constexpr int TW = 8;
  static constexpr int NT = 32 * TW;
  static constexpr int PH = stats_rows<T, C>();
  static_assert(PH > 0, "the statistics tile does not fit in shared memory");
  static constexpr int HR = PH + 2 * PAD, HW = TW + 2 * PAD;
  static constexpr int HALO = HR * HW * CS;
  static constexpr int NCH = (C + CS - 1) / CS;
  static constexpr size_t T_BYTES = (size_t)PH * TW * C * sizeof(float);
  static constexpr size_t BYTES = stats_bytes<T, C>(PH);
};

// T, the tile: one slab over a run of image rows of a strip of SW columns.
// Warp dy owns filter row dy. A ring of RING x rows (the 7 an output row
// needs, the next one landing, and one being fetched), the 7 warps' shares
// of the conv of a row [KS][SW][CS] and the row's da [SW][CS], in f32.
template <typename T, int SW>
struct Tile {
  static constexpr int NT = 32 * KS;
  static constexpr int RING = KS + 2;
  static constexpr int RW = SW + 2 * PAD;  // positions a ring row
  static constexpr int ROW = RW * CS;      // elements a ring row
  static constexpr size_t RING_BYTES = (size_t)RING * ROW * sizeof(T);
  static constexpr size_t P_BYTES = (size_t)KS * SW * CS * sizeof(float);
  static constexpr size_t BYTES = RING_BYTES + P_BYTES + (size_t)SW * CS * sizeof(float);
};

// T's strip width: 16 columns for images at most 16 wide, else 32.
inline int strip_width(int W) { return W <= 16 ? 16 : 32; }

}  // namespace dws
