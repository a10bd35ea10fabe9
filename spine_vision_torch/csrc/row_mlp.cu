// The MLP of token rows, NHWC bf16: row_mlp_kernel of mlp_body.cuh in the forms
// that replace the TPU's token-tiled MLP kernels of
// spine_vision_tpu/ops/fused_mlp.py:
//   LN (svt_ln_mlp_forward): _ln_mlp_pallas (_ln_mlp_tail_kernel), out =
//     res + gamma * (W2 . gelu_tanh(W1 . LN(t) + b1) + b2); a warp takes a
//     token row of t, LayerNorms it in f32 and rounds y to bf16;
//   copy (svt_mlp_forward): _pallas_mlp (_mlp_tail_kernel, _mlp_kernel), the
//     MLP of the y row as it is, with the tail (gamma, res) or without it
//     (acc + b2, rounded once).
// They walk the hidden in chunks of 32 on mma.sync, a 64-token tile a CTA.
// The rows (and the residual) arrive by cp.async ahead of the first weight
// chunks. Both do the block's 16 * M * C^2 flops against 6 * M * C bytes, so
// the tensor cores bound them as they bound the block.
//
// They build as a library of their own: compiled beside wg_gemm.cuh's
// products (the block forward, convnext_block.cu), the copy form with its
// tail came out with other SASS.
#include "mlp_body.cuh"

namespace {

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
