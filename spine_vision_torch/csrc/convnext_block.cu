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
//
// The same MLP body (mlp_tail) behind two other prologues, row_mlp_kernel,
// both in mlp_body.cuh, replaces the TPU's token-tiled MLP kernels of
// spine_vision_tpu/ops/fused_mlp.py:
//   LN (svt_ln_mlp_forward): _ln_mlp_pallas (_ln_mlp_tail_kernel), out =
//     res + gamma * (W2 . gelu_tanh(W1 . LN(t) + b1) + b2); a warp takes a
//     token row of t, LayerNorms it in f32 and rounds y to bf16;
//   copy (svt_mlp_forward): _pallas_mlp (_mlp_tail_kernel, _mlp_kernel), the
//     MLP of the y row as it is, with the tail (gamma, res) or without it
//     (acc + b2, rounded once).
// The rows (and the residual) arrive by cp.async ahead of the first weight
// chunks. Both do the block's 16 * M * C^2 flops against 6 * M * C bytes, so
// the tensor cores bound them as they bound the block.
#include "mlp_body.cuh"

namespace {

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
  constexpr int NP = svt::Lanes<C>::NP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* sY = smem + L::Y;
  bf16* sX = smem + L::X;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long M = (long long)B * H * W;
  const long long tok0 = (long long)blockIdx.x * TOK;

  // The first weight chunk streams in while the stencil runs.
  load_w1<C>(smem + L::W1, w1t, 0);
  cp_async_commit();
  load_w2<C>(smem + L::W2, w2t, 0);
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

  mlp_tail<C, true>(smem, w1t, b1, w2t, b2, gamma, out, tok0, M);
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

// The three row forms: 0 = LN with tail (#7), 1 = tail (#5), 2 = no tail (#5).
template <int C>
int launch_row_form(int form, const void* x, const void* res, const void* ln_scale,
                    const void* ln_bias, const void* w1t, const void* b1,
                    const void* w2t, const void* b2, const void* gamma, void* out,
                    long long M, float eps, cudaStream_t s) {
  if (form == 0)
    return launch_rows<C, true, true>(x, res, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma,
                                      out, M, eps, s);
  if (form == 1)
    return launch_rows<C, false, true>(x, res, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma,
                                       out, M, eps, s);
  return launch_rows<C, false, false>(x, res, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma,
                                      out, M, eps, s);
}

int row_forward(int form, const void* x, const void* res, const void* ln_scale,
                const void* ln_bias, const void* w1t, const void* b1, const void* w2t,
                const void* b2, const void* gamma, void* out, long long M, int C,
                float eps, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define SVT_ROW_CASE(CC)                                                              \
  case CC:                                                                            \
    return launch_row_form<CC>(form, x, res, ln_scale, ln_bias, w1t, b1, w2t, b2,     \
                               gamma, out, M, eps, s);
  switch (C) {
    SVT_ROW_CASE(96)
    SVT_ROW_CASE(128)
    SVT_ROW_CASE(192)
    SVT_ROW_CASE(256)
    SVT_ROW_CASE(384)
    SVT_ROW_CASE(512)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SVT_ROW_CASE
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

// out = res + gamma * (W2 . gelu_tanh(W1 . LN(x) + b1) + b2) over M token rows
// of width C: x, res, w1t [4C, C], w2t [C, 4C] and out bf16, the rest f32.
// Returns the cudaError_t of the launch.
extern "C" int svt_ln_mlp_forward(const void* x, const void* res, const void* ln_scale,
                                  const void* ln_bias, const void* w1t, const void* b1,
                                  const void* w2t, const void* b2, const void* gamma,
                                  void* out, long long M, int C, float eps, void* stream) {
  return row_forward(0, x, res, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, out, M, C, eps,
                     stream);
}

// out = res + gamma * (W2 . gelu_tanh(W1 . x + b1) + b2), or with res null
// W2 . gelu_tanh(W1 . x + b1) + b2 (gamma not read), over M token rows of
// width C; dtypes as svt_ln_mlp_forward. Returns the cudaError_t of the launch.
extern "C" int svt_mlp_forward(const void* x, const void* res, const void* w1t,
                               const void* b1, const void* w2t, const void* b2,
                               const void* gamma, void* out, long long M, int C,
                               void* stream) {
  return row_forward(res ? 1 : 2, x, res, nullptr, nullptr, w1t, b1, w2t, b2, gamma, out, M,
                     C, 0.f, stream);
}
