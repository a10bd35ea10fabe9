// Whole ConvNeXt v1 block forward in one launch, NHWC bf16, for Hopper:
//   out = x + gamma * (W2 . gelu_tanh(W1 . LN(dwconv7x7(x) + b_dw) + b1) + b2)
//
// Replaces spine_vision_tpu/ops/convnext_block.py::_block_pallas
// (_make_block_kernel) in both forms. With emit_conv (the hybrid training
// block, ops/block_train.py) it also writes t = dwconv7x7(x) + b_dw rounded
// to bf16, and its LayerNorm reads the rounded t, as the TPU kernel's
// emit_conv form does; the inference form is compiled without it. On the
// inference path it runs 33 of
// ConvNeXt-base's 36 blocks (16 images; C = 128 at 128x128, 256 at 64x64,
// 512 at 32x32). Each block does 4 * M * C * 4C flops in its two products
// against 4 * M * C bytes of activation traffic: 500 to 2000 flops a byte, far
// above the H100's ~295, so it is bound by the tensor cores, not by memory.
//
// Design: a CTA takes TOK = 64 consecutive tokens.
//   1. Eight warps compute dwconv + bias + LayerNorm per token in f32
//      (dwconv_ln.cuh), round y to bf16 into shared memory, and keep the
//      token's own input row (the conv window's centre tap) in shared memory
//      as the residual: x is read from device memory once.
//   2. The 4C hidden is walked in chunks of HC = 32: h = gelu_tanh(y . W1c +
//      b1) is rounded to bf16 into shared memory, and acc[64, C] += h . W2c
//      accumulates in f32 registers (a 64 x 64 tile a warp at C = 512). Both
//      products are mma.sync m16n8k16 bf16 -> f32 with ldmatrix operand
//      loads. The hidden never reaches device memory.
//   3. Epilogue (acc + b2) * gamma + x in f32, rounded to bf16, staged through
//      shared memory so the single write of the output is coalesced.
// Weight chunks stream in with cp.async, each overlapping the other product:
// the next W1 chunk loads during h . W2c, the next W2 chunk during y . W1c
// (the first pair during the stencil). Weights are read in the layout
// nn.Linear keeps ([out, in]), so each staged row is contiguous along the
// reduction axis. Shared memory rows carry 8 bf16 of padding, which keeps
// ldmatrix free of bank conflicts. Not yet here: wgmma, TMA, a persistent
// schedule; at C = 512 one CTA fills an SM's shared memory.
#include "dwconv_ln.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TOK = 64;
constexpr int HC = 32;
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;

template <int C>
struct Layout {
  static constexpr int LDY = C + 8;   // y, x residual, W1 chunk rows
  static constexpr int LDH = HC + 8;  // hidden, W2 chunk rows
  static constexpr int Y = 0;
  static constexpr int X = Y + TOK * LDY;
  static constexpr int W1 = X + TOK * LDY;
  static constexpr int W2 = W1 + HC * LDY;
  static constexpr int HID = W2 + C * LDH;
  static constexpr int END = HID + TOK * LDH;
  static constexpr size_t BYTES = (size_t)END * sizeof(bf16);
};

using svt::cp_async16;
using svt::cp_async_commit;
using svt::cp_async_wait_1;
using svt::gelu_tanh;
using svt::load_a;
using svt::load_b1;
using svt::load_b2;
using svt::mma;

// Warp grid of the second product and the epilogue: WM x WN warps, each
// owning MT row tiles of 16 and NTW column tiles of 8 (64 x 64 at C = 512).
template <int C>
struct Grid2 {
  static constexpr int WN = (C / 8) % NWARPS == 0 ? NWARPS : NWARPS / 2;
  static constexpr int WM = NWARPS / WN;
  static constexpr int MT = (TOK / 16) / WM;
  static constexpr int NTW = (C / 8) / WN;
  static_assert((C / 8) % WN == 0 && (TOK / 16) % WM == 0, "bad warp grid");
};

template <int C>
__device__ __forceinline__ void load_w1(bf16* sW1, const bf16* __restrict__ w1t,
                                        int c0) {
  constexpr int ROW = C / 8;  // 16-byte vectors per row
  for (int v = threadIdx.x; v < HC * ROW; v += NTHREADS) {
    const int n = v / ROW, kk = (v % ROW) * 8;
    cp_async16(sW1 + n * Layout<C>::LDY + kk, w1t + (size_t)(c0 + n) * C + kk);
  }
}

template <int C>
__device__ __forceinline__ void load_w2(bf16* sW2, const bf16* __restrict__ w2t,
                                        int c0) {
  constexpr int ROW = HC / 8;
  for (int v = threadIdx.x; v < C * ROW; v += NTHREADS) {
    const int c = v / ROW, kk = (v % ROW) * 8;
    cp_async16(sW2 + c * Layout<C>::LDH + kk, w2t + (size_t)c * (4 * C) + c0 + kk);
  }
}

template <int C, bool EMIT>
__global__ void __launch_bounds__(NTHREADS, 1) block_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ k,
    const float* __restrict__ dw_bias, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, const bf16* __restrict__ w1t,
    const float* __restrict__ b1, const bf16* __restrict__ w2t,
    const float* __restrict__ b2, const float* __restrict__ gamma,
    bf16* __restrict__ out, bf16* __restrict__ t_out, int B, int H, int W,
    float eps) {
  using L = Layout<C>;
  using G = Grid2<C>;
  constexpr int NP = svt::Lanes<C>::NP;
  constexpr int NCHUNK = 4 * C / HC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* sY = smem + L::Y;
  bf16* sX = smem + L::X;
  bf16* sW1 = smem + L::W1;
  bf16* sW2 = smem + L::W2;
  bf16* sH = smem + L::HID;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long M = (long long)B * H * W;
  const long long tok0 = (long long)blockIdx.x * TOK;

  // The first weight chunk streams in while the stencil runs.
  load_w1<C>(sW1, w1t, 0);
  cp_async_commit();
  load_w2<C>(sW2, w2t, 0);
  cp_async_commit();

  // 1. dwconv + bias + LayerNorm -> sY (bf16), centre tap -> sX. A warp
  // takes its TOK / NWARPS tokens TB at a time.
  constexpr int TB = svt::TokensPerWarp<C>::value;
  static_assert((TOK / NWARPS) % TB == 0, "tokens per warp");
  for (int i0 = 0; i0 < TOK / NWARPS; i0 += TB) {
    const int r0 = warp * (TOK / NWARPS) + i0;
    int b[TB], h[TB], w[TB];
    bool ok[TB];
    bf16* xrows[TB];
    bf16* trows[TB];
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      svt::token_coords(tok0 + r0 + i, M, H, W, b[i], h[i], w[i], ok[i]);
      xrows[i] = sX + (r0 + i) * L::LDY;
      trows[i] = EMIT ? t_out + (tok0 + r0 + i) * C : nullptr;
    }
    float y[TB][NP][2];
    svt::dw_ln_tokens<bf16, C, TB, true, EMIT>(x, k, dw_bias, ln_scale, ln_bias,
                                               b, h, w, ok, H, W, eps, lane, y,
                                               xrows, trows);
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      bf16* yrow = sY + (r0 + i) * L::LDY;
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const int p = lane + 32 * q;
        if (!svt::Lanes<C>::valid(p)) continue;
        if (ok[i]) {
          svt::store2(yrow + 2 * p, y[i][q][0], y[i][q][1]);
        } else {  // past the last token: zeros, never stored
          svt::store2(yrow + 2 * p, 0.f, 0.f);
          svt::store2(xrows[i] + 2 * p, 0.f, 0.f);
        }
      }
    }
  }

  // 2. MLP over hidden chunks. The W1 chunk for the next step loads during
  // this step's second product, the W2 chunk during the next first product.
  const int m1 = (warp & 3) * 16;   // first product: 16 rows x 16 hidden
  const int n1 = (warp >> 2) * 16;
  const int wm = warp / G::WN;      // second product: MT x NTW tiles
  const int wn = warp % G::WN;
  float acc[G::MT][G::NTW][4];
#pragma unroll
  for (int mi = 0; mi < G::MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < G::NTW; ++nj)
      acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.f;

  for (int ch = 0; ch < NCHUNK; ++ch) {
    const int c0 = ch * HC;
    cp_async_wait_1();  // this chunk's W1 has landed (W2 may be in flight)
    __syncthreads();

    // h[64, HC] = y . W1c: two accumulator sets over alternate k-steps keep
    // four independent mma chains per warp.
    float hacc[2][2][4];
#pragma unroll
    for (int kp = 0; kp < 2; ++kp)
#pragma unroll
      for (int j = 0; j < 2; ++j) hacc[kp][j][0] = hacc[kp][j][1] = hacc[kp][j][2] = hacc[kp][j][3] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < C; k0 += 32) {
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        uint32_t a[4], b[4];
        load_a(a, sY, L::LDY, m1, k0 + 16 * kp, lane);
        load_b2(b, sW1, L::LDY, n1, k0 + 16 * kp, lane);
        mma(hacc[kp][0], a, b[0], b[1]);
        mma(hacc[kp][1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with sW1 (and with last step's sH)
    if (ch + 1 < NCHUNK) load_w1<C>(sW1, w1t, c0 + HC);
    cp_async_commit();

#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n1 + 8 * j + 2 * t;
      const float bb0 = b1[c0 + col];
      const float bb1 = b1[c0 + col + 1];
      svt::store2(sH + (m1 + g) * L::LDH + col,
                  gelu_tanh(hacc[0][j][0] + hacc[1][j][0] + bb0),
                  gelu_tanh(hacc[0][j][1] + hacc[1][j][1] + bb1));
      svt::store2(sH + (m1 + g + 8) * L::LDH + col,
                  gelu_tanh(hacc[0][j][2] + hacc[1][j][2] + bb0),
                  gelu_tanh(hacc[0][j][3] + hacc[1][j][3] + bb1));
    }
    cp_async_wait_1();  // this chunk's W2 has landed (next W1 may be in flight)
    __syncthreads();

    // acc[64, C] += h . W2c
#pragma unroll
    for (int k0 = 0; k0 < HC; k0 += 16) {
      uint32_t a[G::MT][4];
#pragma unroll
      for (int mi = 0; mi < G::MT; ++mi)
        load_a(a[mi], sH, L::LDH, (wm * G::MT + mi) * 16, k0, lane);
#pragma unroll
      for (int nj = 0; nj + 1 < G::NTW; nj += 2) {
        uint32_t b[4];
        load_b2(b, sW2, L::LDH, (wn * G::NTW + nj) * 8, k0, lane);
#pragma unroll
        for (int mi = 0; mi < G::MT; ++mi) {
          mma(acc[mi][nj], a[mi], b[0], b[1]);
          mma(acc[mi][nj + 1], a[mi], b[2], b[3]);
        }
      }
      if (G::NTW % 2) {
        uint32_t b[2];
        load_b1(b, sW2, L::LDH, (wn * G::NTW + G::NTW - 1) * 8, k0, lane);
#pragma unroll
        for (int mi = 0; mi < G::MT; ++mi) mma(acc[mi][G::NTW - 1], a[mi], b[0], b[1]);
      }
    }
    __syncthreads();  // every warp is done with sW2
    if (ch + 1 < NCHUNK) load_w2<C>(sW2, w2t, c0 + HC);
    cp_async_commit();
  }

  // 3. (acc + b2) * gamma + x in f32 -> bf16 into sY, then a coalesced store.
#pragma unroll
  for (int nj = 0; nj < G::NTW; ++nj) {
    const int col = (wn * G::NTW + nj) * 8 + 2 * t;
    const float bb0 = b2[col], bb1 = b2[col + 1];
    const float g0 = gamma[col], g1 = gamma[col + 1];
#pragma unroll
    for (int mi = 0; mi < G::MT; ++mi) {
      const int r0 = (wm * G::MT + mi) * 16 + g;
      const float2 x0 = svt::load2(sX + r0 * L::LDY + col);
      const float2 x1 = svt::load2(sX + (r0 + 8) * L::LDY + col);
      svt::store2(sY + r0 * L::LDY + col, (acc[mi][nj][0] + bb0) * g0 + x0.x,
                  (acc[mi][nj][1] + bb1) * g1 + x0.y);
      svt::store2(sY + (r0 + 8) * L::LDY + col, (acc[mi][nj][2] + bb0) * g0 + x1.x,
                  (acc[mi][nj][3] + bb1) * g1 + x1.y);
    }
  }
  __syncthreads();
  constexpr int ROWO = C / 8;
  for (int v = threadIdx.x; v < TOK * ROWO; v += NTHREADS) {
    const int r = v / ROWO;
    const int kk = (v % ROWO) * 8;
    const long long tok = tok0 + r;
    if (tok < M)
      *reinterpret_cast<uint4*>(out + tok * C + kk) =
          *reinterpret_cast<const uint4*>(sY + r * L::LDY + kk);
  }
}

template <int C, bool EMIT>
int launch_form(const void* x, const void* k, const void* dw_bias,
           const void* ln_scale, const void* ln_bias, const void* w1t,
           const void* b1, const void* w2t, const void* b2, const void* gamma,
           void* out, void* t, int B, int H, int W, float eps,
           cudaStream_t stream) {
  const size_t smem = Layout<C>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      block_kernel<C, EMIT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tokens = (long long)B * H * W;
  const dim3 grid((unsigned)((tokens + TOK - 1) / TOK));
  block_kernel<C, EMIT><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)k, (const float*)dw_bias,
      (const float*)ln_scale, (const float*)ln_bias, (const bf16*)w1t,
      (const float*)b1, (const bf16*)w2t, (const float*)b2,
      (const float*)gamma, (bf16*)out, (bf16*)t, B, H, W, eps);
  return (int)cudaGetLastError();
}

template <int C>
int launch(const void* x, const void* k, const void* dw_bias,
           const void* ln_scale, const void* ln_bias, const void* w1t,
           const void* b1, const void* w2t, const void* b2, const void* gamma,
           void* out, void* t, int B, int H, int W, float eps,
           cudaStream_t stream) {
  if (t == nullptr)
    return launch_form<C, false>(x, k, dw_bias, ln_scale, ln_bias, w1t, b1, w2t,
                                 b2, gamma, out, t, B, H, W, eps, stream);
  return launch_form<C, true>(x, k, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2,
                              gamma, out, t, B, H, W, eps, stream);
}

}  // namespace

// x, k [49, C], w1t [4C, C], w2t [C, 4C], out and t are bf16; the rest f32.
// t (the rounded conv output, [B, H, W, C]) may be null: the inference form.
// Returns the cudaError_t of the launch.
extern "C" int svt_convnext_block_forward(
    const void* x, const void* k, const void* dw_bias, const void* ln_scale,
    const void* ln_bias, const void* w1t, const void* b1, const void* w2t,
    const void* b2, const void* gamma, void* out, void* t, int B, int H, int W,
    int C, float eps, void* stream) {
  if (B * H * W == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define SVT_BLOCK_CASE(CC)                                                    \
  case CC:                                                                    \
    return launch<CC>(x, k, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2,     \
                      gamma, out, t, B, H, W, eps, s);
  switch (C) {
    SVT_BLOCK_CASE(96)
    SVT_BLOCK_CASE(128)
    SVT_BLOCK_CASE(192)
    SVT_BLOCK_CASE(256)
    SVT_BLOCK_CASE(384)
    SVT_BLOCK_CASE(512)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SVT_BLOCK_CASE
}
