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
// Bound. The stencil does 98 f32 operations a channel of a token against 4
// bytes (bf16 x read, out written); the backward recomputes the conv twice
// (98 each), sums dk (98) and does the LayerNorm's statistics and backward
// (about 18) against 6 bytes. On an H100 (67 TFLOP/s f32, 3.35 TB/s) f32
// operations bound all of them, so each x element must come from shared
// memory, not from L1/L2 once for each of its 49 taps, and each value read
// must serve several products.
//
// Design. Every kernel stages x through shared memory with cp.async, zeros
// outside the image and past C (dw_stage.cuh):
//   dw_stencil (#3, in dw_stage.cuh, which #10's conv recompute shares
//     through an f32-and-bias epilogue): a unit is a TH x 8 tile of one image on a 64-channel
//     slab; persistent CTAs walk contiguous runs of units, slab-major, with a
//     two-slot halo ring, so the next unit's halo lands while this one
//     computes. A warp takes a tile column, a lane a channel pair; each halo
//     value read serves up to 7 outputs of the column (sliding accumulators
//     down the rows). The slab's filter sits in shared memory in f32, loaded
//     when a CTA's run enters a slab.
//   dw_bwd_stats (S): a PH x 8 tile of one image at full C. The halo streams
//     through two slots in 64-channel chunks; the f32 conv plus bias goes to
//     a shared tile [PH * 8, C] (dw_stage.cuh's conv_tile, which #2 shares
//     with a y epilogue); then a warp a token takes mu and rstd (the
//     mean, then the mean of the centred squares), reads its g row and
//     writes (mu, rstd, mean(g*scale), mean(g*scale*yhat)), 16 bytes.
//   dw_bwd_tile (T): a CTA takes a 64-channel slab over a run of rows of one
//     image in a strip of SW columns; warp dy owns filter row dy. The x rows
//     it needs sit in a ring of 9: each output row brings in one new row,
//     fetched a row ahead. A row: each warp adds its filter row's share of
//     the conv of every strip token (a sliding window along the row, from
//     shared memory) into a shared [7][SW] tile; the CTA synchronises; warps
//     take the row's tokens in turn, add the 7 shares in a fixed order, form
//     da from the statistics and g (loaded before the row's first pass, so
//     that their latency hides behind it), write da once in x's dtype and
//     keep it in f32 for dk; the CTA synchronises; each warp adds x * da
//     into its 7 taps. Two barriers a row. dk, dbias, dscale and dbeta are summed in
//     registers in token order, and the CTA writes its own workspace row.
//   colsum (reduce.cuh) adds the rows in a fixed order, so two runs agree
//     bit for bit; there are no float atomics.
// C is a runtime argument of the stencil and of T (a ragged last slab is
// masked); S takes the widths of SVT_DW_WIDTHS.
#include "dw_stage.cuh"
#include "dwconv_ln.cuh"
#include "reduce.cuh"

namespace {

using dws::CS;
using svt::KS;
using svt::PAD;

constexpr int NSUM = KS * KS + 3;  // a workspace row: dk (49 taps), dbias, dscale, dbeta

// S: per token (mu, rstd, mean(g*scale), mean(g*scale*yhat)) over a PH x 8
// tile of one image. Tokens outside the image are computed on zeros and
// never stored.
template <typename T, int C>
__global__ void __launch_bounds__(dws::Stats<T, C>::NT, 2) dw_bwd_stats(
    const T* __restrict__ x, const T* __restrict__ k, const float* __restrict__ bias,
    const float* __restrict__ scale, const T* __restrict__ g, float4* __restrict__ stats,
    int H, int W, int tiles_h, int tiles_w, float eps) {
  using G = dws::Stats<T, C>;
  constexpr int NP = svt::Lanes<C>::NP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sT = reinterpret_cast<float*>(smem_raw);
  T* ring = reinterpret_cast<T*>(smem_raw + G::T_BYTES);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tw = blockIdx.x % tiles_w;
  const int th = (blockIdx.x / tiles_w) % tiles_h;
  const int b = blockIdx.x / (tiles_w * tiles_h);
  const int h0 = th * G::PH, w0 = tw * G::TW;
  const int wcol = w0 + warp;  // this warp's image column

  dws::conv_tile<T, C>(sT, ring, x, k, bias, b, h0, w0, H, W);

  // A warp a token (the tile column `warp`): the statistics of a's row.
  for (int r = 0; r < G::PH; ++r) {
    const int hh = h0 + r;
    if (hh >= H || wcol >= W) continue;  // uniform over the warp
    const float* arow = sT + (r * G::TW + warp) * C;
    float v[NP][2];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      v[q][0] = v[q][1] = 0.f;
      if (svt::Lanes<C>::valid(p)) {
        const float2 a = svt::load2(arow + 2 * p);
        v[q][0] = a.x;
        v[q][1] = a.y;
      }
    }
    float mu;
    const float rstd = svt::centre_rstd<C>(v, eps, lane, mu);  // v now a - mu
    const size_t tok = ((size_t)b * H + hh) * W + wcol;
    const T* gp = g + tok * C;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      if (!svt::Lanes<C>::valid(p)) continue;
      const float2 gv = svt::load2(gp + 2 * p);
      const float2 sv = svt::load2(scale + 2 * p);
      const float d0 = gv.x * sv.x, d1 = gv.y * sv.y;
      s1 += d0 + d1;
      s2 += d0 * (v[q][0] * rstd) + d1 * (v[q][1] * rstd);
    }
    s1 = svt::warp_sum(s1);
    s2 = svt::warp_sum(s2);
    if (lane == 0) stats[tok] = make_float4(mu, rstd, s1 * (1.f / C), s2 * (1.f / C));
  }
}

// T: da and this CTA's partial parameter sums over rows [h0, h1) of image b,
// columns [w0, w0 + SW) and channels [64 * slab, + 64). blockIdx.x is
// part * slabs + slab, part = (b * runs + run) * strips + strip: the
// workspace row the CTA writes.
template <typename T, int SW>
__global__ void __launch_bounds__(dws::Tile<T, SW>::NT, 2) dw_bwd_tile(
    const T* __restrict__ x, const T* __restrict__ k, const float* __restrict__ bias,
    const float* __restrict__ scale, const T* __restrict__ g,
    const float4* __restrict__ stats, T* __restrict__ da, float* __restrict__ part, int H,
    int W, int C, int rows_per_run, int runs, int strips, int slabs) {
  using G = dws::Tile<T, SW>;
  constexpr int CH = 16;               // tokens a step of the sliding window
  constexpr int NX = CH + KS - 1;      // x values of a filter row for CH tokens
  static_assert(SW % CH == 0, "the strip is whole steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* sP = reinterpret_cast<float*>(smem_raw + G::RING_BYTES);  // [KS][SW][CS]
  float* sDa = sP + KS * SW * CS;                                   // [SW][CS]
  const int dy = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slab = blockIdx.x % slabs;
  const int p = blockIdx.x / slabs;
  const int strip = p % strips;
  const int run = (p / strips) % runs;
  const int b = p / (strips * runs);
  const int w0 = strip * SW, h0 = run * rows_per_run;
  const int h1 = H < h0 + rows_per_run ? H : h0 + rows_per_run;
  const int c = slab * CS + 2 * lane;
  const bool cok = c < C;  // C is even: c + 1 < C too

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

  // Ring slot j % RING holds x row h0 - PAD + j. Rows h0 - 3 .. h0 + 3, then
  // row h0 + 4 in a group of its own.
#pragma unroll 1
  for (int j = 0; j < KS; ++j)
    dws::load_box<T, 1, G::RW, G::NT>(ring + j * G::ROW, x, b, h0 - PAD + j, w0 - PAD,
                                      slab * CS, H, W, C);
  dws::commit();
  dws::load_box<T, 1, G::RW, G::NT>(ring + KS * G::ROW, x, b, h0 + KS - PAD, w0 - PAD,
                                    slab * CS, H, W, C);
  dws::commit();
  dws::wait<1>();
  __syncthreads();

  constexpr int NF = (SW + KS - 1) / KS;  // tokens a warp finalises a row
  for (int h = h0; h < h1; ++h) {
    const int j0 = h - h0;  // x row h + dy - PAD is in slot (j0 + dy) % RING
    // g and the statistics of the tokens this warp finalises, loaded before
    // pass 1 so that their latency hides behind it.
    float2 gq[NF];
    float4 sq[NF];
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int wt = w0 + dy + KS * i;
      gq[i] = zero;
      sq[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (cok && dy + KS * i < SW && wt < W) {
        const size_t tok = ((size_t)b * H + h) * W + wt;
        sq[i] = stats[tok];
        gq[i] = svt::load2(g + tok * C + c);
      }
    }
    const T* xrow = ring + ((j0 + dy) % G::RING) * G::ROW + 2 * lane;
    // 1. This filter row's share of the conv of every strip token.
#pragma unroll
    for (int s0 = 0; s0 < SW; s0 += CH) {
      float2 xv[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) xv[i] = svt::load2(xrow + (s0 + i) * CS);
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        float2 acc = zero;
#pragma unroll
        for (int dx = 0; dx < KS; ++dx) {
          acc.x = fmaf(xv[j + dx].x, kr[dx].x, acc.x);
          acc.y = fmaf(xv[j + dx].y, kr[dx].y, acc.y);
        }
        svt::store2(sP + (dy * SW + s0 + j) * CS + 2 * lane, acc.x, acc.y);
      }
    }
    __syncthreads();
    // Fetch x row h + 5 into the slot of row h - 4, which row h - 1 read last.
    if (h + KS - PAD + 1 < h1 + PAD)
      dws::load_box<T, 1, G::RW, G::NT>(ring + ((j0 + KS + 1) % G::RING) * G::ROW, x, b,
                                        h + KS - PAD + 1, w0 - PAD, slab * CS, H, W, C);
    dws::commit();
    // 2. Warp dy finalises tokens dy, dy + 7, ...: da from the statistics.
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int w = dy + KS * i;
      if (w >= SW) break;
      const int wt = w0 + w;
      float2 d = zero;
      if (cok && wt < W) {
        float2 a = zero;
#pragma unroll
        for (int r = 0; r < KS; ++r) {
          const float2 pr = svt::load2(sP + (r * SW + w) * CS + 2 * lane);
          a.x += pr.x;
          a.y += pr.y;
        }
        a.x += bv.x;
        a.y += bv.y;
        const size_t tok = ((size_t)b * H + h) * W + wt;
        const float4 st = sq[i];  // mu, rstd, mean(g*scale), mean(g*scale*yhat)
        const float2 gv = gq[i];
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
      svt::store2(sDa + w * CS + 2 * lane, d.x, d.y);
    }
    dws::wait<1>();  // row h + 4 has landed (row h + 5 may be in flight)
    __syncthreads();
    // 3. dk[dy][dx] += x[h + dy - 3][w + dx - 3] * da[h][w] over the strip.
#pragma unroll
    for (int s0 = 0; s0 < SW; s0 += CH) {
      float2 xv[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) xv[i] = svt::load2(xrow + (s0 + i) * CS);
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float2 dj = svt::load2(sDa + (s0 + j) * CS + 2 * lane);
#pragma unroll
        for (int dx = 0; dx < KS; ++dx) {
          dk[dx][0] = fmaf(xv[j + dx].x, dj.x, dk[dx][0]);
          dk[dx][1] = fmaf(xv[j + dx].y, dj.y, dk[dx][1]);
        }
      }
    }
  }

  float* out = part + (size_t)p * NSUM * C;
  if (cok) {
#pragma unroll
    for (int dx = 0; dx < KS; ++dx)
      svt::store2(out + (size_t)(dy * KS + dx) * C + c, dk[dx][0], dk[dx][1]);
  }
  __syncthreads();  // sP is free: the warps' sums go there, [KS][3][CS]
  svt::store2(sP + (dy * 3 + 0) * CS + 2 * lane, sb.x, sb.y);
  svt::store2(sP + (dy * 3 + 1) * CS + 2 * lane, ss.x, ss.y);
  svt::store2(sP + (dy * 3 + 2) * CS + 2 * lane, sg.x, sg.y);
  __syncthreads();
  if (dy < 3 && cok) {
    float2 tot = zero;
#pragma unroll
    for (int r = 0; r < KS; ++r) {
      const float2 v = svt::load2(sP + (r * 3 + dy) * CS + 2 * lane);
      tot.x += v.x;
      tot.y += v.y;
    }
    svt::store2(out + (size_t)(KS * KS + dy) * C + c, tot.x, tot.y);
  }
}

using dws::smem_attr;

template <typename T, int C>
int launch_stats(const void* x, const void* k, const void* bias, const void* scale,
                 const void* g, void* stats, int B, int H, int W, float eps, cudaStream_t s) {
  using G = dws::Stats<T, C>;
  int err;
  if ((err = smem_attr(dw_bwd_stats<T, C>, G::BYTES))) return err;
  const int tiles_h = (H + G::PH - 1) / G::PH, tiles_w = (W + G::TW - 1) / G::TW;
  dw_bwd_stats<T, C><<<(unsigned)((long long)B * tiles_h * tiles_w), G::NT, G::BYTES, s>>>(
      (const T*)x, (const T*)k, (const float*)bias, (const float*)scale, (const T*)g,
      (float4*)stats, H, W, tiles_h, tiles_w, eps);
  return (int)cudaGetLastError();
}

template <typename T, int SW>
int launch_tile(const void* x, const void* k, const void* bias, const void* scale,
                const void* g, const void* stats, void* da, void* part, int B, int H, int W,
                int C, int rows_per_run, cudaStream_t s) {
  using G = dws::Tile<T, SW>;
  int err;
  if ((err = smem_attr(dw_bwd_tile<T, SW>, G::BYTES))) return err;
  const int runs = (H + rows_per_run - 1) / rows_per_run;
  const int strips = (W + SW - 1) / SW;
  const int slabs = (C + CS - 1) / CS;
  const long long ctas = (long long)B * runs * strips * slabs;
  dw_bwd_tile<T, SW><<<(unsigned)ctas, G::NT, G::BYTES, s>>>(
      (const T*)x, (const T*)k, (const float*)bias, (const float*)scale, (const T*)g,
      (const float4*)stats, (T*)da, (float*)part, H, W, C, rows_per_run, runs, strips, slabs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* k, const void* bias, const void* scale,
               const void* g, void* stats, void* da, void* part, void* sums, int B, int H,
               int W, int C, int rows_per_run, float eps, cudaStream_t s) {
  int err;
#define SVT_STATS_CASE(CC)                                                               \
  case CC:                                                                               \
    err = launch_stats<T, CC>(x, k, bias, scale, g, stats, B, H, W, eps, s);             \
    break;
  switch (C) {
    SVT_DW_WIDTHS(SVT_STATS_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SVT_STATS_CASE
  if (err) return err;
  err = dws::strip_width(W) == 16
            ? launch_tile<T, 16>(x, k, bias, scale, g, stats, da, part, B, H, W, C,
                                 rows_per_run, s)
            : launch_tile<T, 32>(x, k, bias, scale, g, stats, da, part, B, H, W, C,
                                 rows_per_run, s);
  if (err) return err;
  const long long P = (long long)B * ((H + rows_per_run - 1) / rows_per_run) *
                      ((W + dws::strip_width(W) - 1) / dws::strip_width(W));
  svt::colsum<<<(unsigned)((NSUM * C + 31) / 32), dim3(32, 32), 0, s>>>(
      (const float*)part, P, NSUM * C, (float*)sums);
  return (int)cudaGetLastError();
}

}  // namespace

// The stencil: out = dwconv7x7(x) with the tap-major [49, C] filter k.
// dtype: 0 = bf16, 1 = f32 (x, k and out share it); C even. Returns the
// cudaError_t of the launch.
extern "C" int svt_dwconv7x7(const void* x, const void* k, void* out, int dtype, int B, int H,
                             int W, int C, void* stream) {
  if ((long long)B * H * W == 0) return 0;
  if (B < 0 || H < 0 || W < 0 || C <= 0 || C % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dws::launch_stencil<__nv_bfloat16, __nv_bfloat16, false>(x, k, nullptr, out, B, H, W,
                                                                    C, s);
  if (dtype == 1)
    return dws::launch_stencil<float, float, false>(x, k, nullptr, out, B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}

// The backward of dwconv + bias + LayerNorm but dx: x, k [49, C], g and da in
// the dtype (0 = bf16, 1 = f32); bias and scale f32 [C]. T's CTAs walk runs
// of rows_per_run image rows in strips of 16 columns (W <= 16) or 32.
// Scratch from the caller: stats f32 [B * H * W, 4], part f32 [B * runs *
// strips, 52 * C] (runs = ceil(H / rows_per_run), strips = ceil(W / strip)).
// sums (f32 [52 * C]) receives dk [49, C], dbias, dscale, dbeta. Returns the
// first cudaError_t of its launches.
extern "C" int svt_dw_ln_bwd(const void* x, const void* k, const void* bias,
                             const void* scale, const void* g, void* stats, void* da,
                             void* part, void* sums, int dtype, int B, int H, int W, int C,
                             int rows_per_run, float eps, void* stream) {
  if ((long long)B * H * W == 0 || B < 0 || H < 0 || W < 0 || rows_per_run <= 0 || C % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd<__nv_bfloat16>(x, k, bias, scale, g, stats, da, part, sums, B, H, W, C,
                                     rows_per_run, eps, s);
  if (dtype == 1)
    return launch_bwd<float>(x, k, bias, scale, g, stats, da, part, sums, B, H, W, C,
                             rows_per_run, eps, s);
  return (int)cudaErrorInvalidValue;
}
