// Backward of the ConvNeXt block's LayerNorm + MLP + LayerScale, NHWC bf16,
// for Hopper. Given t (the rounded conv output the forward's LayerNorm read)
// and g (the gradient of the block output), with y = LN(t), h = gelu_tanh(
// y . W1 + b1) and out = x + gamma * (h . W2 + b2):
//   dt, dln_scale, dln_bias, dW1, db1, dW2, db2, dgamma.
//
// Replaces spine_vision_tpu/ops/fused_mlp.py::_ln_mlp_bwd_pallas_resident
// (C = 512, weights resident, hidden chunked by a loop) and
// _ln_mlp_bwd_pallas (C = 128, 256, a (token, hidden-chunk) grid): the same
// function, laid out differently in the TPU's VMEM. The rounding points are
// the TPU kernels': y, h, g * gamma, the hidden gradient and g enter the
// products in bf16; db1 sums the unrounded f32 hidden gradient; the GELU
// derivative and the LayerNorm backward run in f32; dt is written in bf16 and
// every parameter gradient is f32.
//
// It runs five bf16 products per token (y . W1 again, (g * gamma) . W2^T,
// g_hpre . W1^T, y^T . g_hpre, h^T . g): 40 * M * C^2 flops against about
// 6 * M * C bytes of activations, so the tensor cores bound it.
//
// Design. The TPU adds every token tile's weight gradients into one resident
// output block, in grid order. A CUDA grid runs in parallel, and per CTA the
// [4C, C] f32 weight gradients do not fit, so the work is split in two:
//   A. ln_mlp_bwd_tokens, one CTA per 64 tokens: LayerNorm again, then over
//      hidden chunks of HC the two products with K = C give the hidden
//      pre-activation and its gradient; h and the rounded hidden gradient go
//      to device memory (bf16), and g_y += g_hpre . W1c^T accumulates in
//      registers, so a token's whole hidden is summed inside one CTA before
//      the LayerNorm backward writes dt. Per-channel sums (db1, dln_scale,
//      dln_bias, db2, sum g) go to a per-tile row of a workspace.
//   B. token_gemm computes y^T . g_hpre and g^T . h with K = tokens, split
//      over tokens into an f32 workspace; reduce_rows adds the splits in a
//      fixed order (and applies gamma, and forms dgamma); colsum adds the
//      per-tile rows in a fixed order. Every sum has one order, so the result
//      is the same from run to run.
// Products are mma.sync m16n8k16 with ldmatrix loads (transposed for the
// token-major operands of B); weight chunks stream in with cp.async. Not yet
// here: wgmma, TMA, keeping h and g_hpre out of device memory.
//
// The same kernels without the LayerNorm (svt_mlp_bwd, the template flag LN =
// false) are the backward of the MLP + LayerScale alone from its input y:
// dy, dW1, db1, dW2, db2, dgamma. That replaces
// spine_vision_tpu/ops/fused_mlp.py::_mlp_bwd_pallas, the MLP half of the
// all-kernel block's backward (ops/convnext_block.py::convnext_block_fused):
// the per-token kernel reads y directly and writes dy = g_y rounded to bf16,
// and the weight-gradient products read y itself. Its bound is the same
// 40 * M * C^2 flops.
#include "ln_mlp_bwd.cuh"

// All activations [M, C] or [M, 4C] bf16, token-major. Weights bf16 in both
// layouts: w1t [4C, C] and w1 [C, 4C], w2t [C, 4C] and w2 [4C, C]; ls, lb,
// b1, b2, gamma f32. Outputs: dt [M, C] bf16; small f32 [8C] = db1 (4C),
// dln_scale, dln_bias, db2, sum g; dw1t [4C, C], dw2t [C, 4C], dgamma [C]
// f32. Scratch from the caller: y, h, gh ([M, C], [M, 4C], [M, 4C] bf16),
// part f32 [ceil(M / 64), 8C], ws f32 [splits, 4C, C]. Returns the first
// cudaError_t of its launches.
extern "C" int svt_ln_mlp_bwd(
    const void* t, const void* g, const void* ls, const void* lb,
    const void* w1t, const void* w1, const void* b1, const void* w2t,
    const void* w2, const void* b2, const void* gamma, void* dt, void* small,
    void* dw1t, void* dw2t, void* dgamma, void* y, void* h, void* gh,
    void* part, void* ws, long long M, int C, int splits, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_any<true>(t, g, ls, lb, w1t, w1, b1, w2, gamma, dt, y, h, gh,
                                   part, M, C, s);
  if (err) return err;
  return weight_grads(y, g, w2t, b2, gamma, small, dw1t, dw2t, dgamma, h, gh, part,
                      ws, M, C, splits, s);
}

// The MLP + LayerScale backward from its input y [M, C] bf16: dy [M, C] bf16
// and, as svt_ln_mlp_bwd, small (db1, zeros, zeros, db2, sum g), dw1t, dw2t,
// dgamma; the scratch without y. Returns the first cudaError_t of its
// launches.
extern "C" int svt_mlp_bwd(
    const void* y, const void* g, const void* w1t, const void* w1, const void* b1,
    const void* w2t, const void* w2, const void* b2, const void* gamma, void* dy,
    void* small, void* dw1t, void* dw2t, void* dgamma, void* h, void* gh,
    void* part, void* ws, long long M, int C, int splits, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_any<false>(y, g, nullptr, nullptr, w1t, w1, b1, w2, gamma, dy,
                                    nullptr, h, gh, part, M, C, s);
  if (err) return err;
  return weight_grads(y, g, w2t, b2, gamma, small, dw1t, dw2t, dgamma, h, gh, part,
                      ws, M, C, splits, s);
}
