// The MLP of token rows, NHWC bf16, for Hopper: the forms that replace the
// TPU's token-tiled MLP kernels of spine_vision_tpu/ops/fused_mlp.py:
//   LN (svt_ln_mlp_forward): _ln_mlp_pallas (_ln_mlp_tail_kernel), out =
//     res + gamma * (W2 . gelu_tanh(W1 . LN(x) + b1) + b2), three launches;
//   copy (svt_mlp_forward): _pallas_mlp (_mlp_tail_kernel, _mlp_kernel), the
//     MLP of the x rows as they are, with the tail (gamma, res) or without it
//     (h . W2 + b2, rounded once), two launches.
// The launches:
//   L  mlp_ln_rows (LN only): a warp takes TPW token rows of x, LayerNorms each
//      in f32 (mean, then the mean of centred squares) and writes y in bf16,
//      [M, C]: a streaming pass, read M * C and write M * C bf16;
//   F1 wg_gemm<1, NB, false, EPI_GELU> (wg_gemm.cuh's mlp_products): h =
//      gelu_tanh(y . W1^T + b1) in bf16, [M, 4C]; the copy form's y is x;
//   F2 wg_gemm<1, NB, false, EPI_OUT>: out = (h . W2^T + b2) * gamma + res,
//      or EPI_BIAS (no tail): out = h . W2^T + b2; f32, rounded once.
// F1 and F2 are the block forward's products (convnext_block.cu): a
// persistent CTA an SM, operands fed by TMA through an mbarrier ring, two
// consumer warpgroups on wgmma. A call does 16 * M * C^2 flops against 22 (#5)
// to 26 (#7) * M * C bytes once y and h cross device memory, so the tensor
// cores bound it at C = 512 and the bytes at C <= 256; at the two-image
// shapes of #5's path (M = 128 at C = 512) reading the 4 MB of weights does.
// The rounding points are the plain versions' (ops/fused_mlp.py): y and h in
// bf16, bias, GELU and tail in f32, the output rounded once. The caller
// allocates y and h. No atomics: every output element has one writer, so two
// runs agree bit for bit.
#include "wg_gemm.cuh"

namespace {

constexpr int LN_THREADS = 256;

// L's geometry (ops/fused_mlp.py, row_geometry): TPW consecutive tokens a
// warp, their loads issued together; fewer at C = 512 for registers.
template <int C>
struct LnRows {
  static constexpr int TPW = C <= 256 ? 4 : 2;
  static constexpr int TOKS = LN_THREADS / 32 * TPW;  // tokens a CTA
};

// L: y = LN(x) * ln_scale + ln_bias over the rows of x in f32, rounded once
// to bf16 (ops/fused_mlp.py::ln_rows_reference); a lane owns the channel pairs
// 32 q + lane.
template <int C>
__global__ void __launch_bounds__(LN_THREADS) mlp_ln_rows(
    const bf16* __restrict__ x, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, bf16* __restrict__ y, long long M, float eps) {
  using L = LnRows<C>;
  constexpr int NP = svt::Lanes<C>::NP;
  const int lane = threadIdx.x & 31;
  const long long tok0 = (long long)blockIdx.x * L::TOKS + (threadIdx.x >> 5) * L::TPW;
  float v[L::TPW][NP][2];
#pragma unroll
  for (int i = 0; i < L::TPW; ++i) {
    const long long tok = tok0 + i;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      v[i][q][0] = v[i][q][1] = 0.f;
      if (tok < M && svt::Lanes<C>::valid(p)) {
        const float2 a = svt::load2(x + tok * C + 2 * p);
        v[i][q][0] = a.x;
        v[i][q][1] = a.y;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < L::TPW; ++i) {
    const long long tok = tok0 + i;
    if (tok >= M) break;  // uniform over the warp
    float mu;
    const float rstd = svt::centre_rstd<C>(v[i], eps, lane, mu);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      if (!svt::Lanes<C>::valid(p)) continue;
      const float2 sv = svt::load2(ln_scale + 2 * p);
      const float2 bv = svt::load2(ln_bias + 2 * p);
      svt::store2(y + tok * C + 2 * p, v[i][q][0] * rstd * sv.x + bv.x,
                  v[i][q][1] * rstd * sv.y + bv.y);
    }
  }
}

// Everything a row call reads and writes. ln_scale null: the copy form (no
// L, y is x); res null: no tail (gamma not read). y (LN only) [M, C] and h
// [M, 4C] are the caller's scratch.
struct RowFwd {
  const bf16 *x, *res;
  const float *ln_scale, *ln_bias;
  const bf16* w1t;
  const float* b1;
  const bf16* w2t;
  const float *b2, *gamma;
  bf16 *out, *y, *h;
  long long M;
  float eps;
};

template <int C>
int row_forward(const RowFwd& a, cudaStream_t s) {
  const bf16* y = a.x;
  if (a.ln_scale) {  // L
    using L = LnRows<C>;
    mlp_ln_rows<C><<<(unsigned)((a.M + L::TOKS - 1) / L::TOKS), LN_THREADS, 0, s>>>(
        a.x, a.ln_scale, a.ln_bias, a.y, a.M, a.eps);
    if (const int err = (int)cudaGetLastError()) return err;
    y = a.y;
  }
  Epi e{};
  e.b2 = a.b2;
  e.out = a.out;
  if (!a.res) return mlp_products<C, EPI_BIAS>(y, a.w1t, a.b1, a.w2t, a.h, a.M, e, s);
  e.gamma = a.gamma;
  e.x = a.res;
  return mlp_products<C, EPI_OUT>(y, a.w1t, a.b1, a.w2t, a.h, a.M, e, s);
}

int row_dispatch(const RowFwd& a, int C, void* stream) {
  if (a.M == 0) return 0;
  if (a.M < 0 || a.M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;  // TMA's 32-bit rows
  cudaStream_t s = (cudaStream_t)stream;
#define SVT_ROW_CASE(CC) \
  case CC:               \
    return row_forward<CC>(a, s);
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
// of width C: x, res, w1t [4C, C], w2t [C, 4C], out and the scratch y [M, C]
// and h [M, 4C] bf16, the rest f32. Returns the first cudaError_t of the
// three launches.
extern "C" int svt_ln_mlp_forward(const void* x, const void* res, const void* ln_scale,
                                  const void* ln_bias, const void* w1t, const void* b1,
                                  const void* w2t, const void* b2, const void* gamma,
                                  void* out, void* y, void* h, long long M, int C, float eps,
                                  void* stream) {
  const RowFwd a{(const bf16*)x, (const bf16*)res, (const float*)ln_scale,
                 (const float*)ln_bias, (const bf16*)w1t, (const float*)b1, (const bf16*)w2t,
                 (const float*)b2, (const float*)gamma, (bf16*)out, (bf16*)y, (bf16*)h, M, eps};
  if (!ln_scale || !ln_bias || !res || !gamma || !y) return (int)cudaErrorInvalidValue;
  return row_dispatch(a, C, stream);
}

// out = res + gamma * (W2 . gelu_tanh(W1 . x + b1) + b2), or with res null
// W2 . gelu_tanh(W1 . x + b1) + b2 (gamma not read), over M token rows of
// width C; dtypes as svt_ln_mlp_forward, h [M, 4C] the scratch. Returns the
// first cudaError_t of the two launches.
extern "C" int svt_mlp_forward(const void* x, const void* res, const void* w1t,
                               const void* b1, const void* w2t, const void* b2,
                               const void* gamma, void* out, void* h, long long M, int C,
                               void* stream) {
  const RowFwd a{(const bf16*)x, (const bf16*)res, nullptr, nullptr, (const bf16*)w1t,
                 (const float*)b1, (const bf16*)w2t, (const float*)b2, (const float*)gamma,
                 (bf16*)out, nullptr, (bf16*)h, M, 0.f};
  if (res && !gamma) return (int)cudaErrorInvalidValue;
  return row_dispatch(a, C, stream);
}
