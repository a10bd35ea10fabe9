// The depthwise 7x7 stencils on shared-memory halos: cp.async copies of a box
// (rows x columns x a 64-channel slab) into shared memory, zeros outside the
// image and past C; the stencil #3 (dw_stencil), which #10's conv recompute
// shares through its f32-and-bias epilogue; the conv of a full-C tile
// (conv_tile), shared by #4's statistics S and #2; and the tile geometry of
// each. Included by dwconv_bwd.cu (#3, #4), dwconv_ln.cu (#2) and
// block_train_bwd.cu (#10's ends); ops/dwconv.py (stencil_geometry,
// stats_geometry, bwd_geometry) and ops/block_train.py (tap_geometry) mirror
// the geometry.
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

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

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
// filter in f32. TH follows x's type.
template <typename T>
struct Stencil {
  static constexpr int TH = sizeof(T) == 2 ? 16 : 8;
  static constexpr int TW = 8;
  static constexpr int NT = 32 * TW;
  static constexpr int HR = TH + 2 * PAD, HW = TW + 2 * PAD;
  static constexpr int HALO = HR * HW * CS;  // elements a slot
  static constexpr size_t BYTES = 2 * (size_t)HALO * sizeof(T) + KS * KS * CS * sizeof(float);
};

// S and #2: a PH x 8 tile of one image at full C. Its f32 conv tile and two
// halo slots; PH the largest of 8, 4, 2, 1 that leaves room for two CTAs a
// multiprocessor, else for one.
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

// #10's tap sums: T's x ring (x's type T) and a ring of GSLOTS f32 g_u rows
// [SW][CS] (the row summed, the next one landing, one being fetched); no
// conv shares.
template <typename T, int SW>
struct Taps {
  using X = Tile<T, SW>;
  static constexpr int NT = X::NT;
  static constexpr int GSLOTS = 3;
  static constexpr int GROW = SW * CS;  // elements a g_u row
  static constexpr size_t BYTES = X::RING_BYTES + (size_t)GSLOTS * GROW * sizeof(float);
};

// T's and the tap sums' strip width: 16 columns for images at most 16 wide,
// else 32.
inline int strip_width(int W) { return W <= 16 ? 16 : 32; }

// The conv of a PH x 8 tile at rows [h0, h0 + PH) and columns [w0, w0 + 8)
// of image b at full C, plus bias, in f32 into sT [PH * 8][C] (the token of
// tile row r and column w at r * 8 + w): the halo streams through ring's two
// slots in 64-channel chunks, warp w (the tile column) a lane a channel pair.
// Tokens outside the image are computed on zeros. On return sT is whole and
// the ring is free.
template <typename T, int C>
__device__ __forceinline__ void conv_tile(float* sT, T* ring, const T* __restrict__ x,
                                          const T* __restrict__ k,
                                          const float* __restrict__ bias, int b, int h0, int w0,
                                          int H, int W) {
  using G = Stats<T, C>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  load_box<T, G::HR, G::HW, G::NT>(ring, x, b, h0 - PAD, w0 - PAD, 0, H, W, C);
  commit();
  for (int ch = 0; ch < G::NCH; ++ch) {
    if (ch + 1 < G::NCH)
      load_box<T, G::HR, G::HW, G::NT>(ring + ((ch + 1) & 1) * G::HALO, x, b, h0 - PAD,
                                       w0 - PAD, (ch + 1) * CS, H, W, C);
    commit();
    wait<1>();  // this chunk has landed (the next may be in flight)
    __syncthreads();
    const T* slot = ring + (ch & 1) * G::HALO;
    const int c = ch * CS + 2 * lane;  // this lane's channel pair
    if (c < C) {
      float2 acc[G::PH];
#pragma unroll
      for (int r = 0; r < G::PH; ++r) acc[r] = make_float2(0.f, 0.f);
#pragma unroll
      for (int dx = 0; dx < KS; ++dx) {
        float2 kv[KS];
#pragma unroll
        for (int dy = 0; dy < KS; ++dy) kv[dy] = svt::load2(k + (dy * KS + dx) * C + c);
#pragma unroll
        for (int ih = 0; ih < G::HR; ++ih) {
          const float2 xv = svt::load2(slot + (ih * G::HW + warp + dx) * CS + 2 * lane);
#pragma unroll
          for (int r = 0; r < G::PH; ++r) {
            const int dy = ih - r;
            if (dy < 0 || dy >= KS) continue;
            acc[r].x = fmaf(xv.x, kv[dy].x, acc[r].x);
            acc[r].y = fmaf(xv.y, kv[dy].y, acc[r].y);
          }
        }
      }
      const float2 bv = svt::load2(bias + c);
#pragma unroll
      for (int r = 0; r < G::PH; ++r)
        svt::store2(sT + (r * G::TW + warp) * C + c, acc[r].x + bv.x, acc[r].y + bv.y);
    }
    __syncthreads();  // the slot is free for chunk ch + 2; after the last, sT is whole
  }
}

namespace {  // a kernel of each library that includes this

// The stencil: out = dwconv7x7(x) (+ bias, with BIAS), summed in f32,
// rounded once to O (T for #3; f32 for #10's u, which is never rounded). Unit
// u is (slab, image, tile row, tile column), slab-major; CTA i takes units
// [i * units / grid, (i + 1) * units / grid).
template <typename T, typename O, bool BIAS>
__global__ void __launch_bounds__(Stencil<T>::NT, sizeof(T) == 2 ? 2 : 1)
    dw_stencil(const T* __restrict__ x, const T* __restrict__ k, const float* __restrict__ bias,
               O* __restrict__ out, int B, int H, int W, int C, int tiles_h, int tiles_w,
               long long units) {
  using G = Stencil<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* sK = reinterpret_cast<float*>(smem_raw + 2 * G::HALO * sizeof(T));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long u0 = (long long)blockIdx.x * units / gridDim.x;
  const long long u1 = (long long)(blockIdx.x + 1) * units / gridDim.x;
  const long long per_slab = (long long)B * tiles_h * tiles_w;
  auto coords = [&](long long u, int& s, int& b, int& h0, int& w0) {
    s = (int)(u / per_slab);
    const long long r = u % per_slab;
    w0 = (int)(r % tiles_w) * G::TW;
    h0 = (int)((r / tiles_w) % tiles_h) * G::TH;
    b = (int)(r / ((long long)tiles_w * tiles_h));
  };

  int s, b, h0, w0;
  if (u0 < u1) {
    coords(u0, s, b, h0, w0);
    load_box<T, G::HR, G::HW, G::NT>(ring, x, b, h0 - PAD, w0 - PAD, s * CS, H, W, C);
  }
  commit();
  int kslab = -1;
  for (long long u = u0; u < u1; ++u) {
    const int slot = (int)((u - u0) & 1);
    coords(u, s, b, h0, w0);
    if (u + 1 < u1) {
      int s1, b1, h1, w1;
      coords(u + 1, s1, b1, h1, w1);
      load_box<T, G::HR, G::HW, G::NT>(ring + (slot ^ 1) * G::HALO, x, b1, h1 - PAD, w1 - PAD,
                                       s1 * CS, H, W, C);
    }
    commit();
    wait<1>();  // this unit's halo has landed (the next may be in flight)
    __syncthreads();
    if (s != kslab) {  // uniform over the CTA; the last unit's reads are done
      for (int i = threadIdx.x; i < KS * KS * CS; i += G::NT) {
        const int c = s * CS + i % CS;
        sK[i] = c < C ? to_f32(k[(size_t)(i / CS) * C + c]) : 0.f;
      }
      kslab = s;
      __syncthreads();
    }
    const int c = s * CS + 2 * lane;  // this lane's channel pair
    if (c < C) {
      const T* sl = ring + slot * G::HALO;
      float2 acc[G::TH];
#pragma unroll
      for (int r = 0; r < G::TH; ++r) acc[r] = make_float2(0.f, 0.f);
#pragma unroll
      for (int dx = 0; dx < KS; ++dx) {
        float2 kv[KS];
#pragma unroll
        for (int dy = 0; dy < KS; ++dy) kv[dy] = svt::load2(sK + (dy * KS + dx) * CS + 2 * lane);
#pragma unroll
        for (int ih = 0; ih < G::HR; ++ih) {
          const float2 xv = svt::load2(sl + (ih * G::HW + warp + dx) * CS + 2 * lane);
#pragma unroll
          for (int r = 0; r < G::TH; ++r) {
            const int dy = ih - r;
            if (dy < 0 || dy >= KS) continue;
            acc[r].x = fmaf(xv.x, kv[dy].x, acc[r].x);
            acc[r].y = fmaf(xv.y, kv[dy].y, acc[r].y);
          }
        }
      }
      if constexpr (BIAS) {
        const float2 bv = svt::load2(bias + c);
#pragma unroll
        for (int r = 0; r < G::TH; ++r) {
          acc[r].x += bv.x;
          acc[r].y += bv.y;
        }
      }
      const int w = w0 + warp;
      if (w < W) {
#pragma unroll
        for (int r = 0; r < G::TH; ++r)
          if (h0 + r < H)
            svt::store2(out + (((size_t)b * H + h0 + r) * W + w) * C + c, acc[r].x, acc[r].y);
      }
    }
    __syncthreads();  // the slot is free for the unit after next
  }
}

template <typename K>
int smem_attr(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)bytes);
}

// Launch the stencil on persistent CTAs: as many as fit on the card at once,
// at most one a unit. bias is read only with BIAS.
template <typename T, typename O, bool BIAS>
int launch_stencil(const void* x, const void* k, const void* bias, void* out, int B, int H,
                   int W, int C, cudaStream_t s) {
  using G = Stencil<T>;
  auto kernel = dw_stencil<T, O, BIAS>;
  int err, dev, sms, per_sm;
  if ((err = smem_attr(kernel, G::BYTES))) return err;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, G::NT,
                                                                G::BYTES)))
    return err;
  const int tiles_h = (H + G::TH - 1) / G::TH, tiles_w = (W + G::TW - 1) / G::TW;
  const long long units = (long long)((C + CS - 1) / CS) * B * tiles_h * tiles_w;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = (unsigned)(units < most ? units : most);
  kernel<<<grid, G::NT, G::BYTES, s>>>((const T*)x, (const T*)k, (const float*)bias, (O*)out, B,
                                       H, W, C, tiles_h, tiles_w, units);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dws
