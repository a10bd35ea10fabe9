// Whole ConvNeXt v1 block backward, NHWC bf16 or f32, for Hopper: from x and the
// gradient g of out = x + gamma * (W2 . gelu_tanh(W1 . y + b1) + b2), with
// u = dwconv7x7(x) + b_dw and y = LN(u) * ln_scale + ln_bias,
//   g_u (the conv output's gradient, in x's type), dk [49, C], ddwb, dln_scale,
//   dln_bias, dW1, db1, dW2, db2, dgamma (f32).
// The caller adds dx = g + dwconv7x7(g_u, flipped k) (the stencil of
// dwconv_bwd.cu), as the JAX package adds it in XLA.
//
// Replaces spine_vision_tpu/ops/block_train.py::_block_train_bwd_pallas
// (_make_bwd_kernel), with its rounding points: u is recomputed in f32 and
// not rounded; y, h, g * gamma, the hidden gradient and g enter the products
// in bf16; db1 sums the unrounded f32 hidden gradient; the LayerNorm
// backward runs in f32; g_u is written in bf16, and dk = sum x_halo * g_u and
// ddwb = sum g_u take the unrounded f32 g_u.
//
// Bound: the five bf16 products of the MLP backward, 40 * M * C^2 flops, so
// the tensor cores bound the whole. Its two ends each move 6 bytes a channel
// of a token (bf16 x; f32 u written or g_u read) against 98 f32 operations,
// so bytes bound each of them (at 3.35 TB/s and 67 TFLOP/s f32).
//
// Design. The TPU kernel keeps a halo tile of x, the f32 LayerNorm state and
// every parameter gradient resident in VMEM and walks tiles in grid order.
// Here the MLP backward's stages (ln_mlp_bwd.cuh) already stream their
// operands through shared memory, so the f32 u and g_u go through device
// memory (4 * M * C bytes each way). Both ends stage x in shared memory
// (dw_stage.cuh):
//   1. u = dwconv7x7(x) + b_dw in f32: the stencil #3 (dws::dw_stencil,
//      persistent CTAs on 16 x 8 halo tiles of a 64-channel slab) with its
//      f32-and-bias epilogue.
//   2. mlp_bwd<true, true> (ln_mlp_bwd.cuh): the LN+MLP backward's stages
//      reading the f32 u: y and g * gamma, the wgmma products for the hidden,
//      g_y and the weight gradients, and the LayerNorm backward, which writes
//      g_u in bf16 and in f32; the column sums of the per-tile rows (db1,
//      dln_scale, dln_bias, db2).
//   3. tap_sums: dk and ddwb, #4's tile T without its conv pass and
//      LayerNorm. A CTA takes a 64-channel slab over a run of rows of one
//      image in a strip of SW columns; the x rows it needs sit in a ring of 9
//      and the f32 g_u rows in a ring of 3, each filled with cp.async two rows
//      ahead, so each g_u value crosses device memory once and each x row once
//      a run. Warp dy owns filter row dy and, for each output row, adds x *
//      g_u into its 7 taps over the strip's tokens in order (a sliding window
//      along the row, from shared memory); warp 0 also sums ddwb. One barrier
//      a row. Each CTA writes its own workspace row, and colsum (reduce.cuh)
//      adds the rows in a fixed order.
// Every sum has one order, so two runs agree bit for bit.
//
// The f32 form (the JAX kernel run in f32) is the same three steps with x,
// the filter, g and g_u in f32: the recompute dws::dw_stencil<float, float,
// true>, the MLP backward's f32 stages (ln_mlp_bwd.cuh on wg_gemm.cuh's
// 3xTF32 path) and tap_sums<float, SW> over an f32 x ring; its bound is the
// TF32 rate (3 * 40 * M * C^2 flops at 495 TFLOP/s).
#include "dw_stage.cuh"
#include "ln_mlp_bwd.cuh"

namespace {

using dws::CS;
using svt::KS;
using svt::PAD;

constexpr int NTAP = KS * KS + 1;  // a tap_sums workspace row: dk (49 taps), ddwb

// dk[dy * 7 + dx][c] = sum over tokens (h, w) of x[h + dy - 3][w + dx - 3][c]
// * gu[h][w][c] and ddwb[c] = sum gu[h][w][c], over rows [h0, h1) of image b,
// columns [w0, w0 + SW) and channels [64 * slab, + 64). blockIdx.x is
// part * slabs + slab, part = (b * runs + run) * strips + strip: the
// workspace row the CTA writes.
template <typename T, int SW>
__global__ void __launch_bounds__(dws::Taps<T, SW>::NT, 3) tap_sums(
    const T* __restrict__ x, const float* __restrict__ gu, float* __restrict__ part, int H,
    int W, int C, int rows_per_run, int runs, int strips, int slabs) {
  using G = dws::Taps<T, SW>;
  using X = typename G::X;
  constexpr int CH = 16;           // tokens a step of the sliding window
  constexpr int NX = CH + KS - 1;  // x values of a filter row for CH tokens
  static_assert(SW % CH == 0, "the strip is whole steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* sG = reinterpret_cast<float*>(smem_raw + X::RING_BYTES);  // [GSLOTS][SW][CS]
  const int dy = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slab = blockIdx.x % slabs;
  const int p = blockIdx.x / slabs;
  const int strip = p % strips;
  const int run = (p / strips) % runs;
  const int b = p / (strips * runs);
  const int w0 = strip * SW, h0 = run * rows_per_run, c0 = slab * CS;
  const int h1 = H < h0 + rows_per_run ? H : h0 + rows_per_run;
  const int c = c0 + 2 * lane;

  float dk[KS][2];
#pragma unroll
  for (int dx = 0; dx < KS; ++dx) dk[dx][0] = dk[dx][1] = 0.f;
  float2 sb = make_float2(0.f, 0.f);

  // x ring slot j % RING holds x row h0 - PAD + j, g_u slot j % GSLOTS g_u
  // row h0 + j. The group of output row h brings x row h + 3 and g_u row h:
  // row h0's brings x rows h0 - 3 .. h0 + 3.
#pragma unroll 1
  for (int j = 0; j < KS; ++j)
    dws::load_box<T, 1, X::RW, G::NT>(ring + j * X::ROW, x, b, h0 - PAD + j, w0 - PAD, c0, H,
                                      W, C);
  dws::load_box<float, 1, SW, G::NT>(sG, gu, b, h0, w0, c0, H, W, C);
  dws::commit();
  if (h0 + 1 < h1) {
    dws::load_box<T, 1, X::RW, G::NT>(ring + KS * X::ROW, x, b, h0 + 1 + PAD, w0 - PAD, c0,
                                      H, W, C);
    dws::load_box<float, 1, SW, G::NT>(sG + G::GROW, gu, b, h0 + 1, w0, c0, H, W, C);
  }
  dws::commit();

  for (int h = h0; h < h1; ++h) {
    const int j0 = h - h0;
    dws::wait<1>();   // row h's group has landed (row h + 1's may be in flight)
    __syncthreads();  // and every warp is done with row h - 1
    // Row h + 2's group, into the slots of x row h - 4 and g_u row h - 1,
    // which row h - 1 read last.
    if (h + 2 < h1) {
      dws::load_box<T, 1, X::RW, G::NT>(ring + ((j0 + KS + 1) % X::RING) * X::ROW, x, b,
                                        h + 2 + PAD, w0 - PAD, c0, H, W, C);
      dws::load_box<float, 1, SW, G::NT>(sG + ((j0 + 2) % G::GSLOTS) * G::GROW, gu, b, h + 2,
                                         w0, c0, H, W, C);
    }
    dws::commit();
    // dk[dy][dx] += x[h + dy - 3][w + dx - 3] * gu[h][w] over the strip.
    const T* xrow = ring + ((j0 + dy) % X::RING) * X::ROW + 2 * lane;
    const float* grow = sG + (j0 % G::GSLOTS) * G::GROW + 2 * lane;
#pragma unroll
    for (int s0 = 0; s0 < SW; s0 += CH) {
      float2 xv[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) xv[i] = svt::load2(xrow + (s0 + i) * CS);
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const float2 gj = svt::load2(grow + (s0 + j) * CS);
        if (dy == 0) {
          sb.x += gj.x;
          sb.y += gj.y;
        }
#pragma unroll
        for (int dx = 0; dx < KS; ++dx) {
          dk[dx][0] = fmaf(xv[j + dx].x, gj.x, dk[dx][0]);
          dk[dx][1] = fmaf(xv[j + dx].y, gj.y, dk[dx][1]);
        }
      }
    }
  }
  if (c >= C) return;  // C is even: c + 1 < C too
  float* out = part + (size_t)p * NTAP * C;
#pragma unroll
  for (int dx = 0; dx < KS; ++dx)
    svt::store2(out + (size_t)(dy * KS + dx) * C + c, dk[dx][0], dk[dx][1]);
  if (dy == 0) svt::store2(out + (size_t)(KS * KS) * C + c, sb.x, sb.y);
}

template <typename T, int SW>
int launch_taps(const void* x, const void* gu, void* part, int B, int H, int W, int C,
                int rows_per_run, cudaStream_t s) {
  using G = dws::Taps<T, SW>;
  int err;
  if ((err = dws::smem_attr(tap_sums<T, SW>, G::BYTES))) return err;
  const int runs = (H + rows_per_run - 1) / rows_per_run;
  const int strips = (W + SW - 1) / SW;
  const int slabs = (C + CS - 1) / CS;
  const long long ctas = (long long)B * runs * strips * slabs;
  tap_sums<T, SW><<<(unsigned)ctas, G::NT, G::BYTES, s>>>((const T*)x, (const float*)gu,
                                                          (float*)part, H, W, C, rows_per_run,
                                                          runs, strips, slabs);
  return (int)cudaGetLastError();
}

// The three steps in x's type T.
template <typename T>
int block_bwd(const void* x, const void* k, const void* bias, const void* ls, const void* lb,
              const void* w1t, const void* w1, const void* b1, const void* w2t, const void* w2,
              const void* b2, const void* gamma, const void* g, void* gu, void* small, void* dw1t,
              void* dw2t, void* dgamma, void* taps, void* u, void* gu32, void* y, void* gg,
              void* stats, void* h, void* gh, void* gy, void* part, void* ws, void* tpart, int B,
              int H, int W, int C, int splits, long long ks, const long long* plan,
              int rows_per_run, float eps, cudaStream_t s) {
  const long long M = (long long)B * H * W;
  int err = dws::launch_stencil<T, float, true>(x, k, bias, u, B, H, W, C, s);
  if (err) return err;
  const MlpBwd<T> a{u, (const T*)g, (const T*)w1t, (const T*)w1, (const T*)w2t, (const T*)w2,
                    (const float*)ls, (const float*)lb, (const float*)b1, (const float*)b2,
                    (const float*)gamma, (T*)gu, (float*)gu32, (float*)small, (float*)dw1t,
                    (float*)dw2t, (float*)dgamma, (T*)y, (T*)gg, (T*)h, (T*)gh, (float*)stats,
                    (float*)gy, (float*)part, (float*)ws, M, ks, C, splits, eps, kplan(plan)};
  err = mlp_bwd<T, true, true>(a, s);
  if (err) return err;
  const int sw = dws::strip_width(W);
  err = sw == 16 ? launch_taps<T, 16>(x, gu32, tpart, B, H, W, C, rows_per_run, s)
                 : launch_taps<T, 32>(x, gu32, tpart, B, H, W, C, rows_per_run, s);
  if (err) return err;
  const long long P = (long long)B * ((H + rows_per_run - 1) / rows_per_run) * ((W + sw - 1) / sw);
  svt::colsum<<<(unsigned)((NTAP * C + 31) / 32), dim3(32, 32), 0, s>>>(
      (const float*)tpart, P, NTAP * C, (float*)taps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, g, gu [B, H, W, C] and k [49, C] of one type (dtype 0: bf16, 1: f32);
// weights of that type in both layouts (w1t [4C, C] and w1 [C, 4C], w2t [C,
// 4C] and w2 [4C, C]); bias, ls, lb, b1, b2, gamma f32. Outputs: gu (x's
// type); small f32 [8C] = db1 (4C), dln_scale,
// dln_bias, db2, sum g; dw1t [4C, C], dw2t [C, 4C], dgamma [C] and taps
// [50 * C] = dk (49 taps of C), ddwb, f32. Scratch from the caller: u, gu32
// and gy (f32 [M, C]), y and gg ([M, C] x's type), stats (f32 [M, 2]), h, gh
// ([M, 4C] x's type), part f32 [ceil(M / 64), 8C], ws f32 [splits, 4C, C] (ks
// tokens a split), tpart f32 [B * runs * strips, 50 * C]: the tap sums walk
// runs of rows_per_run image rows (runs = ceil(H / rows_per_run)) in strips
// of 16 columns (W <= 16) or 32 (strips = ceil(W / strip)). C is one of 96,
// 128, 192, 256, 384, 512. f32 also takes plan, the K splits of the MLP
// backward's stages B and C (as svt_ln_mlp_bwd's; null in bf16). Returns the
// first cudaError_t of its launches.
extern "C" int svt_block_train_bwd(
    const void* x, const void* k, const void* bias, const void* ls, const void* lb,
    const void* w1t, const void* w1, const void* b1, const void* w2t, const void* w2,
    const void* b2, const void* gamma, const void* g, void* gu, void* small, void* dw1t,
    void* dw2t, void* dgamma, void* taps, void* u, void* gu32, void* y, void* gg, void* stats,
    void* h, void* gh, void* gy, void* part, void* ws, void* tpart, int dtype, int B, int H,
    int W, int C, int splits, long long ks, const long long* plan, int rows_per_run, float eps,
    void* stream) {
  const long long M = (long long)B * H * W;
  if (M == 0 || B < 0 || H < 0 || W < 0 || rows_per_run <= 0) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 96: case 128: case 192: case 256: case 384: case 512:
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return block_bwd<bf16>(x, k, bias, ls, lb, w1t, w1, b1, w2t, w2, b2, gamma, g, gu, small,
                           dw1t, dw2t, dgamma, taps, u, gu32, y, gg, stats, h, gh, gy, part, ws,
                           tpart, B, H, W, C, splits, ks, nullptr, rows_per_run, eps, s);
  if (dtype == 1)
    return block_bwd<float>(x, k, bias, ls, lb, w1t, w1, b1, w2t, w2, b2, gamma, g, gu, small,
                            dw1t, dw2t, dgamma, taps, u, gu32, y, gg, stats, h, gh, gy, part, ws,
                            tpart, B, H, W, C, splits, ks, plan, rows_per_run, eps, s);
  return (int)cudaErrorInvalidValue;
}
