// Backward of the ConvNeXt block's LayerNorm + MLP + LayerScale, NHWC bf16 or
// f32, for Hopper. Given t (the rounded conv output the forward's LayerNorm read)
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
// derivative and the LayerNorm backward run in f32 (g_y reaches it in f32);
// dt is written in bf16 and every parameter gradient is f32.
//
// It runs five bf16 products per token (y . W1 again, (g * gamma) . W2^T,
// g_hpre . W1^T, y^T . g_hpre, g^T . h): 40 * M * C^2 flops against about
// 6 * M * C bytes of activations, so the tensor cores bound it.
//
// Design (ln_mlp_bwd.cuh). The TPU adds every token tile's weight gradients
// into one resident output block, in grid order, and keeps h and the hidden
// gradient in VMEM. Here every product is a warpgroup product (wgmma) whose
// operands TMA streams in K slices of 64 through a ring of shared-memory
// stages guarded by mbarriers (hopper.cuh): a producer warp keeps the ring
// full while two consumer warpgroups each take 64 rows of a 128-row tile, and
// a persistent CTA an SM walks the tiles, so one tile's epilogue overlaps the
// next one's loads. The work goes in stages, each its own kernel:
//   A. bwd_rows: y = LN(t) (bf16, with each token's mean and rstd) and
//      g * gamma (bf16); per-64-token rows of db2 and sum g.
//   B. wg_gemm<2, 2>: h_pre = y . W1 and g_h = (g * gamma) . W2^T into two
//      accumulators of one 128 x 128 tile (K = C); the epilogue adds b1,
//      forms h and g_hpre = g_h * gelu'(h_pre) in f32, stores both in bf16
//      and writes db1's per-64-token row from the unrounded g_hpre.
//   C. wg_gemm<1, NB>: g_y = g_hpre . W1^T (K = 4C), tiles of 128 x 128 NB;
//      without the LayerNorm it stores dy in bf16, with it g_y in f32.
//   L. ln_rows_bwd: the LayerNorm backward a token a warp step, dt in bf16,
//      per-64-token rows of dln_scale and dln_bias.
//   D. colsum adds the per-tile rows in a fixed order; wg_gemm<1, 1, MN>
//      computes dW1^T = g_hpre^T . y and A^T = g^T . h (K = tokens, both
//      operands token-major: MN-major descriptors), the tokens cut into
//      splits so that the output tiles fill the card; reduce_rows adds the
//      splits in order (and forms dW2 = gamma * A^T and dgamma).
// No atomics: every cross-CTA sum has one order, so two runs agree bit for
// bit. h and g_hpre still go through device memory (about 20 * M * C bytes).
//
// The same kernels without the LayerNorm (svt_mlp_bwd, LN = false) are the
// backward of the MLP + LayerScale alone from its input y: dy, dW1, db1, dW2,
// db2, dgamma. That replaces spine_vision_tpu/ops/fused_mlp.py::
// _mlp_bwd_pallas, the MLP half of the all-kernel block's backward
// (ops/convnext_block.py::convnext_block_fused). Its bound is the same
// 40 * M * C^2 flops.
#include "ln_mlp_bwd.cuh"

namespace {

// One call in the activations' type T: the LN form with ls, else the MLP's.
template <typename T>
int bwd_call(const void* t, const void* g, const void* ls, const void* lb, const void* w1t,
             const void* w1, const void* b1, const void* w2t, const void* w2, const void* b2,
             const void* gamma, void* dt, void* small, void* dw1t, void* dw2t, void* dgamma,
             void* y, void* gg, void* stats, void* h, void* gh, void* gy, void* part, void* ws,
             long long M, int C, int splits, long long ks, const long long* plan,
             cudaStream_t s) {
  const MlpBwd<T> a{t, (const T*)g, (const T*)w1t, (const T*)w1, (const T*)w2t, (const T*)w2,
                    (const float*)ls, (const float*)lb, (const float*)b1, (const float*)b2,
                    (const float*)gamma, (T*)dt, nullptr, (float*)small, (float*)dw1t,
                    (float*)dw2t, (float*)dgamma, (T*)y, (T*)gg, (T*)h, (T*)gh, (float*)stats,
                    (float*)gy, (float*)part, (float*)ws, M, ks, C, splits, LN_EPS,
                    kplan(plan)};
  return ls ? mlp_bwd<T, true>(a, s) : mlp_bwd<T, false>(a, s);
}

int bwd_typed(int dtype, const void* t, const void* g, const void* ls, const void* lb,
              const void* w1t, const void* w1, const void* b1, const void* w2t, const void* w2,
              const void* b2, const void* gamma, void* dt, void* small, void* dw1t, void* dw2t,
              void* dgamma, void* y, void* gg, void* stats, void* h, void* gh, void* gy,
              void* part, void* ws, long long M, int C, int splits, long long ks,
              const long long* plan, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return bwd_call<bf16>(t, g, ls, lb, w1t, w1, b1, w2t, w2, b2, gamma, dt, small, dw1t, dw2t,
                          dgamma, y, gg, stats, h, gh, gy, part, ws, M, C, splits, ks, nullptr,
                          s);
  if (dtype == 1)
    return bwd_call<float>(t, g, ls, lb, w1t, w1, b1, w2t, w2, b2, gamma, dt, small, dw1t, dw2t,
                           dgamma, y, gg, stats, h, gh, gy, part, ws, M, C, splits, ks, plan, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// All activations [M, C] or [M, 4C] of one type (dtype 0: bf16, 1: f32),
// token-major. Weights of that type in both layouts: w1t [4C, C] and w1 [C,
// 4C], w2t [C, 4C] and w2 [4C, C]; ls, lb, b1, b2, gamma f32. Outputs: dt
// [M, C] (the activations' type); small f32 [8C] = db1 (4C), dln_scale,
// dln_bias, db2, sum g; dw1t [4C, C], dw2t [C, 4C], dgamma [C] f32. Scratch
// from the caller: y, gg ([M, C]), stats (f32 [M, 2]), h, gh ([M, 4C]), gy
// (f32 [M, C]), part f32 [ceil(M / 64), 8C], ws f32 [splits, 4C, C]; stage
// D's token splits hold ks tokens each (a multiple of 64). f32 also takes
// plan = {splits, ks} of stage B's K (C) then of stage C's (4C), from
// ops/fused_mlp.py::bwd_geometry, whose partials share ws (which then holds
// the largest of the three); bf16 ignores it (null). Returns the first
// cudaError_t of its launches.
extern "C" int svt_ln_mlp_bwd(
    const void* t, const void* g, const void* ls, const void* lb, const void* w1t,
    const void* w1, const void* b1, const void* w2t, const void* w2, const void* b2,
    const void* gamma, void* dt, void* small, void* dw1t, void* dw2t, void* dgamma, void* y,
    void* gg, void* stats, void* h, void* gh, void* gy, void* part, void* ws, int dtype,
    long long M, int C, int splits, long long ks, const long long* plan, void* stream) {
  if (!ls || !lb) return (int)cudaErrorInvalidValue;
  return bwd_typed(dtype, t, g, ls, lb, w1t, w1, b1, w2t, w2, b2, gamma, dt, small, dw1t, dw2t,
                   dgamma, y, gg, stats, h, gh, gy, part, ws, M, C, splits, ks, plan, stream);
}

// The MLP + LayerScale backward from its input y [M, C]: dy [M, C] (y's type)
// and, as svt_ln_mlp_bwd, small (db1, zeros, zeros, db2, sum g), dw1t, dw2t,
// dgamma; the scratch without y, stats and gy. Returns the first cudaError_t
// of its launches.
extern "C" int svt_mlp_bwd(
    const void* y, const void* g, const void* w1t, const void* w1, const void* b1,
    const void* w2t, const void* w2, const void* b2, const void* gamma, void* dy, void* small,
    void* dw1t, void* dw2t, void* dgamma, void* gg, void* h, void* gh, void* part, void* ws,
    int dtype, long long M, int C, int splits, long long ks, const long long* plan,
    void* stream) {
  return bwd_typed(dtype, y, g, nullptr, nullptr, w1t, w1, b1, w2t, w2, b2, gamma, dy, small,
                   dw1t, dw2t, dgamma, nullptr, gg, nullptr, h, gh, nullptr, part, ws, M, C,
                   splits, ks, plan, stream);
}
