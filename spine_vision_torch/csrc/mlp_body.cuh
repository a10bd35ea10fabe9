// The ConvNeXt block's MLP body on 64-token tiles, shared by the block forward
// and the row MLP forwards (convnext_block.cu) and the MLP ablation probe
// (probe_mlp.cu): mlp_tail, the row prologue (row_mlp_kernel) and its launch.
//
// The hidden activation is a template parameter, Act, applied to each pair of
// pre-activations h = y . W1c + b1 before they are rounded to bf16 into shared
// memory. GeluTanh, the default, is what the production kernels compile to;
// the ablation probe instantiates the others (probe_act.cuh). Each library
// that includes this gets its own copy.
#pragma once

#include "dwconv_ln.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TOK = 64;
constexpr int HC = 32;
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;

// tanh-approximate GELU, the block MLP's activation.
struct GeluTanh {
  static __device__ __forceinline__ float2 apply(float a, float b) {
    return make_float2(svt::gelu_tanh(a), svt::gelu_tanh(b));
  }
};

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

// The coalesced write of a CTA's 64 output rows, staged in sY.
template <int C>
__device__ __forceinline__ void store_rows(const bf16* sY, bf16* __restrict__ out,
                                           long long tok0, long long M) {
  constexpr int ROWO = C / 8;
  for (int v = threadIdx.x; v < TOK * ROWO; v += NTHREADS) {
    const int r = v / ROWO;
    const int kk = (v % ROWO) * 8;
    const long long tok = tok0 + r;
    if (tok < M)
      *reinterpret_cast<uint4*>(out + tok * C + kk) =
          *reinterpret_cast<const uint4*>(sY + r * Layout<C>::LDY + kk);
  }
}

// 2. MLP over hidden chunks, 3. the epilogue: out = (acc + b2) * gamma + sX
// (the residual rows) with TAIL, acc + b2 without, rounded once. The first W1
// and W2 chunks were committed as the last two cp.async groups, and sY holds
// the 64 MLP input rows (zeros past the last token) once every thread has
// reached the first __syncthreads. The W1 chunk for the next step loads
// during this step's second product, the W2 chunk during the next first
// product.
template <int C, bool TAIL, typename Act = GeluTanh>
__device__ __forceinline__ void mlp_tail(
    bf16* smem, const bf16* __restrict__ w1t, const float* __restrict__ b1,
    const bf16* __restrict__ w2t, const float* __restrict__ b2,
    const float* __restrict__ gamma, bf16* __restrict__ out, long long tok0,
    long long M) {
  using L = Layout<C>;
  using G = Grid2<C>;
  constexpr int NCHUNK = 4 * C / HC;
  bf16* sY = smem + L::Y;
  bf16* sX = smem + L::X;
  bf16* sW1 = smem + L::W1;
  bf16* sW2 = smem + L::W2;
  bf16* sH = smem + L::HID;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

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
      const float2 h0 = Act::apply(hacc[0][j][0] + hacc[1][j][0] + bb0,
                                   hacc[0][j][1] + hacc[1][j][1] + bb1);
      const float2 h1 = Act::apply(hacc[0][j][2] + hacc[1][j][2] + bb0,
                                   hacc[0][j][3] + hacc[1][j][3] + bb1);
      svt::store2(sH + (m1 + g) * L::LDH + col, h0.x, h0.y);
      svt::store2(sH + (m1 + g + 8) * L::LDH + col, h1.x, h1.y);
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
    if constexpr (TAIL) {
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
    } else {
#pragma unroll
      for (int mi = 0; mi < G::MT; ++mi) {
        const int r0 = (wm * G::MT + mi) * 16 + g;
        svt::store2(sY + r0 * L::LDY + col, acc[mi][nj][0] + bb0, acc[mi][nj][1] + bb1);
        svt::store2(sY + (r0 + 8) * L::LDY + col, acc[mi][nj][2] + bb0,
                    acc[mi][nj][3] + bb1);
      }
    }
  }
  __syncthreads();
  store_rows<C>(sY, out, tok0, M);
}

// The row prologue of the copy forms: the residual rows (TAIL) and the y rows
// (!LN) as one cp.async group (zeros past the last token).
template <int C, bool LN, bool TAIL>
__device__ __forceinline__ void load_rows(bf16* sY, bf16* sX, const bf16* __restrict__ x,
                                          const bf16* __restrict__ res, long long tok0,
                                          long long M) {
  constexpr int ROW = C / 8;
  for (int v = threadIdx.x; v < TOK * ROW; v += NTHREADS) {
    const int r = v / ROW, kk = (v % ROW) * 8;
    const long long tok = tok0 + r;
    if (tok < M) {
      if (TAIL) cp_async16(sX + r * Layout<C>::LDY + kk, res + tok * C + kk);
      if (!LN) cp_async16(sY + r * Layout<C>::LDY + kk, x + tok * C + kk);
    } else {
      if (TAIL) *reinterpret_cast<uint4*>(sX + r * Layout<C>::LDY + kk) = make_uint4(0, 0, 0, 0);
      if (!LN) *reinterpret_cast<uint4*>(sY + r * Layout<C>::LDY + kk) = make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_commit();
}

// The MLP of token rows without the stencil. LN: y = LN(x row) * ln_scale +
// ln_bias in f32 (mean, then the mean of centred squares), rounded to bf16;
// otherwise the x row is y. TAIL: the res rows are the residual.
template <int C, bool LN, bool TAIL, typename Act = GeluTanh>
__global__ void __launch_bounds__(NTHREADS, 1) row_mlp_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ res,
    const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
    const bf16* __restrict__ w1t, const float* __restrict__ b1,
    const bf16* __restrict__ w2t, const float* __restrict__ b2,
    const float* __restrict__ gamma, bf16* __restrict__ out, long long M, float eps) {
  static_assert(TAIL || !LN, "the LN form always has its tail");
  using L = Layout<C>;
  constexpr int NP = svt::Lanes<C>::NP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* sY = smem + L::Y;
  bf16* sX = smem + L::X;
  const long long tok0 = (long long)blockIdx.x * TOK;

  // The residual rows and, without LN, the y rows: one cp.async group ahead
  // of the first weight chunks.
  load_rows<C, LN, TAIL>(sY, sX, x, res, tok0, M);
  load_w1<C>(smem + L::W1, w1t, 0);
  cp_async_commit();
  load_w2<C>(smem + L::W2, w2t, 0);
  cp_async_commit();

  if constexpr (LN) {
    // A warp LayerNorms its TOK / NWARPS rows, one at a time.
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    for (int i = 0; i < TOK / NWARPS; ++i) {
      const int r = warp * (TOK / NWARPS) + i;
      const long long tok = tok0 + r;
      bf16* yrow = sY + r * L::LDY;
      float v[NP][2];
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const int p = lane + 32 * q;
        v[q][0] = v[q][1] = 0.f;
        if (tok < M && svt::Lanes<C>::valid(p)) {
          const float2 a = svt::load2(x + tok * C + 2 * p);
          v[q][0] = a.x;
          v[q][1] = a.y;
        }
      }
      float mu;
      const float rstd = svt::centre_rstd<C>(v, eps, lane, mu);
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const int p = lane + 32 * q;
        if (!svt::Lanes<C>::valid(p)) continue;
        if (tok < M) {  // uniform over the warp
          const float2 sv = svt::load2(ln_scale + 2 * p);
          const float2 bv = svt::load2(ln_bias + 2 * p);
          svt::store2(yrow + 2 * p, v[q][0] * rstd * sv.x + bv.x, v[q][1] * rstd * sv.y + bv.y);
        } else {
          svt::store2(yrow + 2 * p, 0.f, 0.f);
        }
      }
    }
  }
  mlp_tail<C, TAIL, Act>(smem, w1t, b1, w2t, b2, gamma, out, tok0, M);
}

template <int C, bool LN, bool TAIL, typename Act = GeluTanh>
int launch_rows(const void* x, const void* res, const void* ln_scale,
                const void* ln_bias, const void* w1t, const void* b1, const void* w2t,
                const void* b2, const void* gamma, void* out, long long M, float eps,
                cudaStream_t stream) {
  const size_t smem = Layout<C>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      row_mlp_kernel<C, LN, TAIL, Act>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + TOK - 1) / TOK));
  row_mlp_kernel<C, LN, TAIL, Act><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)res, (const float*)ln_scale, (const float*)ln_bias,
      (const bf16*)w1t, (const float*)b1, (const bf16*)w2t, (const float*)b2,
      (const float*)gamma, (bf16*)out, M, eps);
  return (int)cudaGetLastError();
}

}  // namespace
