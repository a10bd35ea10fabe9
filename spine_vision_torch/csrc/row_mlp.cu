// The MLP of token rows, NHWC bf16 or f32, for Hopper: the forms that replace the
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
//
// The f32 forms (the JAX kernels run in f32) are L in f32, mlp_ln_rows<float,
// C> (y in f32), then F1 and F2 on wg_gemm.cuh's 3xTF32 path
// (mlp_products_f32), h in f32 [M, 4C] as the TPU kernels store h in the
// input's dtype; bound by the TF32 rate (3 * 16 * M * C^2 flops at 495
// TFLOP/s). At #5's two-image shapes (M = 128 at C = 512: F2's 4 tiles of
// 128 x 128) each product is split over K (the caller's plan) so that its
// units fill the card, the partials summed in split order by split_reduce.
#include "wg_gemm.cuh"

#include <type_traits>

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
// to T (ops/fused_mlp.py::ln_rows_reference); a lane owns the channel pairs
// 32 q + lane.
template <typename T, int C>
__global__ void __launch_bounds__(LN_THREADS) mlp_ln_rows(
    const T* __restrict__ x, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, T* __restrict__ y, long long M, float eps) {
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

// Everything a row call reads and writes, in x's type T. ln_scale null: the
// copy form (no L, y is x); res null: no tail (gamma not read). y (LN only)
// [M, C] and h [M, 4C] are the caller's scratch; f32 also the K splits' plan
// and their f32 partials' workspace ws (null where nothing is split).
template <typename T>
struct RowFwd {
  const T *x, *res;
  const float *ln_scale, *ln_bias;
  const T* w1t;
  const float* b1;
  const T* w2t;
  const float *b2, *gamma;
  T *out, *y, *h;
  float* ws;
  KPlan kp;
  long long M;
  float eps;
};

// F1 and F2 on the type's path of wg_gemm.cuh: bf16 wgmma, or 3xTF32.
template <typename T, int C, int EPI2>
int products(const T* y, const RowFwd<T>& a, EpiT<T> e, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value)
    return mlp_products_f32<C, EPI2>(y, a.w1t, a.b1, a.w2t, a.h, a.M, e, a.ws, a.kp, s);
  else
    return mlp_products<C, EPI2>(y, a.w1t, a.b1, a.w2t, a.h, a.M, e, s);
}

template <typename T, int C>
int row_forward(const RowFwd<T>& a, cudaStream_t s) {
  const T* y = a.x;
  if (a.ln_scale) {  // L
    using L = LnRows<C>;
    mlp_ln_rows<T, C><<<(unsigned)((a.M + L::TOKS - 1) / L::TOKS), LN_THREADS, 0, s>>>(
        a.x, a.ln_scale, a.ln_bias, a.y, a.M, a.eps);
    if (const int err = (int)cudaGetLastError()) return err;
    y = a.y;
  }
  EpiT<T> e{};
  e.b2 = a.b2;
  e.out = a.out;
  if (!a.res) return products<T, C, EPI_BIAS>(y, a, e, s);
  e.gamma = a.gamma;
  e.x = a.res;
  return products<T, C, EPI_OUT>(y, a, e, s);
}

template <typename T>
int row_dispatch(const RowFwd<T>& a, int C, void* stream) {
  if (a.M == 0) return 0;
  if (a.M < 0 || a.M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;  // TMA's 32-bit rows
  cudaStream_t s = (cudaStream_t)stream;
#define SVT_ROW_CASE(CC) \
  case CC:               \
    return row_forward<T, CC>(a, s);
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

template <typename T>
int row_call(const void* x, const void* res, const void* ln_scale, const void* ln_bias,
             const void* w1t, const void* b1, const void* w2t, const void* b2,
             const void* gamma, void* out, void* y, void* h, void* ws, const long long* plan,
             long long M, int C, float eps, void* stream) {
  const RowFwd<T> a{(const T*)x, (const T*)res, (const float*)ln_scale, (const float*)ln_bias,
                    (const T*)w1t, (const float*)b1, (const T*)w2t, (const float*)b2,
                    (const float*)gamma, (T*)out, (T*)y, (T*)h, (float*)ws, kplan(plan), M,
                    eps};
  return row_dispatch(a, C, stream);
}

int row_typed(int dtype, const void* x, const void* res, const void* ln_scale,
              const void* ln_bias, const void* w1t, const void* b1, const void* w2t,
              const void* b2, const void* gamma, void* out, void* y, void* h, void* ws,
              const long long* plan, long long M, int C, float eps, void* stream) {
  if (dtype == 0)
    return row_call<bf16>(x, res, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, out, y, h, nullptr,
                          nullptr, M, C, eps, stream);
  if (dtype == 1)
    return row_call<float>(x, res, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, out, y, h, ws,
                           plan, M, C, eps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// out = res + gamma * (W2 . gelu_tanh(W1 . LN(x) + b1) + b2) over M token rows
// of width C: x, res, w1t [4C, C], w2t [C, 4C], out and the scratch y [M, C]
// and h [M, 4C] of one type (dtype 0: bf16, 1: f32), the rest f32. f32 also
// takes plan = {splits, ks} of F1's K (C) then of F2's (4C), from
// ops/fused_mlp.py::product_geometry, and ws, the f32 workspace of the split
// products' partials (null where neither is split); bf16 ignores both.
// Returns the first cudaError_t of its launches.
extern "C" int svt_ln_mlp_forward(const void* x, const void* res, const void* ln_scale,
                                  const void* ln_bias, const void* w1t, const void* b1,
                                  const void* w2t, const void* b2, const void* gamma,
                                  void* out, void* y, void* h, void* ws, const long long* plan,
                                  int dtype, long long M, int C, float eps, void* stream) {
  if (!ln_scale || !ln_bias || !res || !gamma || !y) return (int)cudaErrorInvalidValue;
  return row_typed(dtype, x, res, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, out, y, h, ws,
                   plan, M, C, eps, stream);
}

// out = res + gamma * (W2 . gelu_tanh(W1 . x + b1) + b2), or with res null
// W2 . gelu_tanh(W1 . x + b1) + b2 (gamma not read), over M token rows of
// width C; dtypes, ws and plan as svt_ln_mlp_forward's, h [M, 4C] the
// scratch. Returns the first cudaError_t of its launches.
extern "C" int svt_mlp_forward(const void* x, const void* res, const void* w1t,
                               const void* b1, const void* w2t, const void* b2,
                               const void* gamma, void* out, void* h, void* ws,
                               const long long* plan, int dtype, long long M, int C,
                               void* stream) {
  if (res && !gamma) return (int)cudaErrorInvalidValue;
  return row_typed(dtype, x, res, nullptr, nullptr, w1t, b1, w2t, b2, gamma, out, nullptr, h, ws,
                   plan, M, C, 0.f, stream);
}
