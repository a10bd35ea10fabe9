// The ConvNeXt v1 block forward, NHWC bf16 or f32, for Hopper, in three
// launches:
//   out = x + gamma * (W2 . gelu_tanh(W1 . LN(dwconv7x7(x) + b_dw) + b1) + b2)
//
// Replaces spine_vision_tpu/ops/convnext_block.py::_block_pallas
// (_make_block_kernel) in both forms. With emit_conv (the hybrid training
// block, ops/block_train.py) it also writes t = dwconv7x7(x) + b_dw rounded
// to bf16, and its LayerNorm reads the rounded t, as the TPU kernel's
// emit_conv form does; the inference form's LayerNorm reads the f32 t. On the
// inference path it runs 33 of ConvNeXt-base's 36 blocks (16 images; C = 128
// at 128x128, 256 at 64x64, 512 at 32x32). Its two products do 16 * M * C^2
// flops against about 24 * M * C bytes of device-memory traffic once y and
// the hidden cross device memory (x read twice, y and h written and read,
// out written): 0.67 * C flops a byte, under the H100's ~295 at C <= 256
// (bytes bound it there) and above it at C = 512 (the products do).
//
// The TPU kernel keeps a token tile's hidden in VMEM. Here the work is split
// where Hopper's tools fit it:
//   P  block_prologue: a CTA takes a PH x 8 tile of one image at full C. The
//      x halo ((PH + 6) x 14 positions) streams through shared memory in
//      chunks of 64 channels, two chunks in flight (cp.async, zeros outside
//      the image), so each x element comes from L2 once a tile instead of 49
//      times. A warp takes a tile column and a lane a channel pair: each halo
//      element read serves up to 7 outputs of the column, in f32. t = conv +
//      b_dw goes to a shared f32 tile ([PH * 8, C]); then a warp a token
//      LayerNorms it (mean, then the mean of centred squares, in f32) and
//      writes y in bf16, [M, C] (and, with emit_conv, t in bf16).
//   F1 wg_gemm<1, NB, false, EPI_GELU> (wg_gemm.cuh): h = gelu_tanh(y . W1^T
//      + b1), stored in bf16, [M, 4C].
//   F2 wg_gemm<1, NB, false, EPI_OUT>: out = (h . W2^T + b2) * gamma + x in
//      f32, rounded once to bf16; the residual x is read in the epilogue.
// The products are the MLP backward's (ln_mlp_bwd.cu): a persistent CTA an
// SM, operands fed by TMA through an mbarrier ring, two consumer warpgroups
// on wgmma. Weights are read in the layout nn.Linear keeps ([out, in]): K
// contiguous. The caller allocates y and h. No atomics: every output element
// has one writer, so two runs agree bit for bit.
//
// The f32 form (the JAX kernel run in f32, as the JAX package runs it with
// mixed_precision=False) is P in f32, block_prologue<float, C, EMIT> (an f32
// halo ring, t and y in f32; t's rounding is the identity, so both forms'
// LayerNorm reads the f32 t), then F1 and F2 on wg_gemm.cuh's 3xTF32 path
// (mlp_products_f32). Its halo doubles P's ring: 134 KB a CTA at C = 512 (a
// 4 x 8 tile) and 146 KB at C = 192 (8 x 8), one CTA an SM at most widths
// where bf16 fits two (ops/convnext_block.py, forward_geometry). Its bound is
// the TF32 rate (3 * 16 * M * C^2 flops at 495 TFLOP/s).
#include "mma_bf16.cuh"
#include "wg_gemm.cuh"

#include <type_traits>

namespace {

// P's tile: PH rows by PW columns of one image; PCC channels a halo chunk.
constexpr int PW = 8;
constexpr int PCC = 64;
constexpr int P_THREADS = 256;
static_assert(P_THREADS / 32 == PW, "a warp a tile column");

template <typename T, int C>
struct PTile {
  static constexpr int PH = C <= 192 ? 8 : 4;       // (ops/convnext_block.py, _tile_rows)
  static constexpr int TOKS = PH * PW;
  static constexpr int HR = PH + 2 * svt::PAD;      // halo rows
  static constexpr int HW = PW + 2 * svt::PAD;      // halo columns
  static constexpr int NCH = (C + PCC - 1) / PCC;   // channel chunks
  static constexpr int HALO = HR * HW * PCC;        // elements a ring slot
  static constexpr size_t T_BYTES = (size_t)TOKS * C * sizeof(float);
  static constexpr size_t BYTES = T_BYTES + 2 * HALO * sizeof(T);
};

// 16 bytes global -> shared, or 16 zeros with `bytes` 0 (src is not read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Channels [c0, c0 + PCC) of the tile's halo into a ring slot [HR][HW][PCC]:
// zeros outside the image and past C.
template <typename T, int C>
__device__ __forceinline__ void load_halo(T* slot, const T* __restrict__ x, int b, int h0,
                                          int w0, int c0, int H, int W) {
  using P = PTile<T, C>;
  constexpr int EV = 16 / (int)sizeof(T);  // elements a 16-byte vector
  constexpr int V = PCC / EV;              // 16-byte vectors a position
  for (int v = threadIdx.x; v < P::HR * P::HW * V; v += P_THREADS) {
    const int pos = v / V, cv = c0 + (v % V) * EV;
    const int hh = h0 + pos / P::HW - svt::PAD, ww = w0 + pos % P::HW - svt::PAD;
    const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W && cv < C;
    const T* src = in ? x + (((size_t)b * H + hh) * W + ww) * C + cv : x;
    cp_async16_zfill(slot + pos * PCC + (v % V) * EV, src, in ? 16 : 0);
  }
}

// P: t = dwconv7x7(x) + dw_bias over a PH x PW tile, then y = LN(t) (EMIT:
// t rounded to T first, written to t_out, and the LayerNorm reads the
// rounded t). Tokens outside the image are computed on zeros and never stored.
template <typename T, int C, bool EMIT>
__global__ void __launch_bounds__(P_THREADS, 2) block_prologue(
    const T* __restrict__ x, const T* __restrict__ k, const float* __restrict__ dw_bias,
    const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
    T* __restrict__ y_out, T* __restrict__ t_out, int H, int W, int tiles_h,
    int tiles_w, float eps) {
  using P = PTile<T, C>;
  constexpr int NP = svt::Lanes<C>::NP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sT = reinterpret_cast<float*>(smem_raw);
  T* ring = reinterpret_cast<T*>(smem_raw + P::T_BYTES);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tw = blockIdx.x % tiles_w;
  const int th = (blockIdx.x / tiles_w) % tiles_h;
  const int b = blockIdx.x / (tiles_w * tiles_h);
  const int h0 = th * P::PH, w0 = tw * PW;
  const int wcol = w0 + warp;  // this warp's image column in the stencil

  load_halo<T, C>(ring, x, b, h0, w0, 0, H, W);
  svt::cp_async_commit();
  for (int ch = 0; ch < P::NCH; ++ch) {
    if (ch + 1 < P::NCH) load_halo<T, C>(ring + ((ch + 1) & 1) * P::HALO, x, b, h0, w0,
                                         (ch + 1) * PCC, H, W);
    svt::cp_async_commit();
    svt::cp_async_wait_1();  // this chunk has landed (the next may be in flight)
    __syncthreads();
    const T* slot = ring + (ch & 1) * P::HALO;
    const int c = ch * PCC + 2 * lane;  // this lane's channel pair
    if (c < C) {  // C = 96: the second chunk's upper lanes idle
      float2 acc[P::PH];
#pragma unroll
      for (int r = 0; r < P::PH; ++r) acc[r] = make_float2(0.f, 0.f);
#pragma unroll
      for (int dx = 0; dx < svt::KS; ++dx) {
        float2 kv[svt::KS];
#pragma unroll
        for (int dy = 0; dy < svt::KS; ++dy) kv[dy] = svt::load2(k + (dy * svt::KS + dx) * C + c);
#pragma unroll
        for (int ih = 0; ih < P::HR; ++ih) {
          const float2 xv = svt::load2(slot + (ih * P::HW + warp + dx) * PCC + 2 * lane);
#pragma unroll
          for (int r = 0; r < P::PH; ++r) {
            const int dy = ih - r;
            if (dy < 0 || dy >= svt::KS) continue;
            acc[r].x = fmaf(xv.x, kv[dy].x, acc[r].x);
            acc[r].y = fmaf(xv.y, kv[dy].y, acc[r].y);
          }
        }
      }
      const float2 bv = svt::load2(dw_bias + c);
#pragma unroll
      for (int r = 0; r < P::PH; ++r) {
        float t0 = acc[r].x + bv.x, t1 = acc[r].y + bv.y;
        if constexpr (EMIT && std::is_same<T, bf16>::value) {
          const __nv_bfloat162 tv = __floats2bfloat162_rn(t0, t1);
          if (h0 + r < H && wcol < W)
            *reinterpret_cast<__nv_bfloat162*>(
                t_out + (((size_t)b * H + h0 + r) * W + wcol) * C + c) = tv;
          const float2 tf = __bfloat1622float2(tv);
          t0 = tf.x;
          t1 = tf.y;
        } else if constexpr (EMIT) {  // f32: t as it is
          if (h0 + r < H && wcol < W)
            svt::store2(t_out + (((size_t)b * H + h0 + r) * W + wcol) * C + c, t0, t1);
        }
        svt::store2(sT + (r * PW + warp) * C + c, t0, t1);
      }
    }
    __syncthreads();  // the slot is free for chunk ch + 2; after the last, sT is whole
  }

  // y = LN(t) * ln_scale + ln_bias, a warp a token (the tile column `warp`).
  for (int r = 0; r < P::PH; ++r) {
    const int hh = h0 + r;
    if (hh >= H || wcol >= W) continue;  // uniform over the warp
    const float* trow = sT + (r * PW + warp) * C;
    float v[NP][2];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      v[q][0] = v[q][1] = 0.f;
      if (svt::Lanes<C>::valid(p)) {
        const float2 a = svt::load2(trow + 2 * p);
        v[q][0] = a.x;
        v[q][1] = a.y;
      }
    }
    float mu;
    const float rstd = svt::centre_rstd<C>(v, eps, lane, mu);
    T* yrow = y_out + (((size_t)b * H + hh) * W + wcol) * C;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int p = lane + 32 * q;
      if (!svt::Lanes<C>::valid(p)) continue;
      const float2 sv = svt::load2(ln_scale + 2 * p);
      const float2 bv = svt::load2(ln_bias + 2 * p);
      svt::store2(yrow + 2 * p, v[q][0] * rstd * sv.x + bv.x, v[q][1] * rstd * sv.y + bv.y);
    }
  }
}

// Everything a forward call reads and writes, x's type T; y [M, C] and h
// [M, 4C] are the caller's scratch, t is null in the inference form.
template <typename T>
struct BlockFwd {
  const T *x, *k;
  const float *dw_bias, *ln_scale, *ln_bias;
  const T* w1t;
  const float* b1;
  const T* w2t;
  const float *b2, *gamma;
  T *out, *t, *y, *h;
  float* ws;  // f32: the K splits' partials (null where none is split)
  KPlan kp;
  int B, H, W;
  float eps;
};

template <typename T, int C, bool EMIT>
int block_forward_c(const BlockFwd<T>& a, cudaStream_t s) {
  using P = PTile<T, C>;
  const long long M = (long long)a.B * a.H * a.W;
  int err;
  {  // P
    const int tiles_h = (a.H + P::PH - 1) / P::PH, tiles_w = (a.W + PW - 1) / PW;
    const long long ctas = (long long)a.B * tiles_h * tiles_w;
    if ((err = (int)cudaFuncSetAttribute(block_prologue<T, C, EMIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)P::BYTES)))
      return err;
    block_prologue<T, C, EMIT><<<(unsigned)ctas, P_THREADS, P::BYTES, s>>>(
        a.x, a.k, a.dw_bias, a.ln_scale, a.ln_bias, a.y, a.t, a.H, a.W, tiles_h, tiles_w,
        a.eps);
    if ((err = (int)cudaGetLastError())) return err;
  }
  // F1 and F2: h = gelu_tanh(y . W1^T + b1), out = (h . W2^T + b2) * gamma + x.
  if constexpr (std::is_same<T, float>::value) {
    EpiT<float> e{};
    e.b2 = a.b2;
    e.gamma = a.gamma;
    e.x = a.x;
    e.out = a.out;
    return mlp_products_f32<C, EPI_OUT>(a.y, a.w1t, a.b1, a.w2t, a.h, M, e, a.ws, a.kp, s);
  } else {
    Epi e{};
    e.b2 = a.b2;
    e.gamma = a.gamma;
    e.x = a.x;
    e.out = a.out;
    return mlp_products<C, EPI_OUT>(a.y, a.w1t, a.b1, a.w2t, a.h, M, e, s);
  }
}

template <typename T, int C>
int block_forward(const BlockFwd<T>& a, cudaStream_t s) {
  return a.t ? block_forward_c<T, C, true>(a, s) : block_forward_c<T, C, false>(a, s);
}

template <typename T>
int block_dispatch(const void* x, const void* k, const void* dw_bias, const void* ln_scale,
                   const void* ln_bias, const void* w1t, const void* b1, const void* w2t,
                   const void* b2, const void* gamma, void* out, void* t, void* y, void* h,
                   void* ws, const long long* plan, int B, int H, int W, int C, float eps,
                   cudaStream_t s) {
  const BlockFwd<T> a{(const T*)x, (const T*)k, (const float*)dw_bias, (const float*)ln_scale,
                      (const float*)ln_bias, (const T*)w1t, (const float*)b1, (const T*)w2t,
                      (const float*)b2, (const float*)gamma, (T*)out, (T*)t, (T*)y, (T*)h,
                      (float*)ws, kplan(plan), B, H, W, eps};
#define SVT_BLOCK_CASE(CC) \
  case CC:                 \
    return block_forward<T, CC>(a, s);
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

}  // namespace


// x, k [49, C], w1t [4C, C], w2t [C, 4C], out, t, y and h of one type
// (dtype 0: bf16, 1: f32); the rest f32. t (the conv output rounded to that
// type, [B, H, W, C]) may be null: the inference form. y [B * H * W, C] and h
// [B * H * W, 4C] are scratch. f32 also takes plan and ws as row_mlp.cu's
// svt_ln_mlp_forward (F1's and F2's K splits and their partials); bf16
// ignores both. Returns the first cudaError_t of its launches.
extern "C" int svt_convnext_block_forward(
    const void* x, const void* k, const void* dw_bias, const void* ln_scale,
    const void* ln_bias, const void* w1t, const void* b1, const void* w2t,
    const void* b2, const void* gamma, void* out, void* t, void* y, void* h, void* ws,
    const long long* plan, int dtype, int B, int H, int W, int C, float eps, void* stream) {
  const long long M = (long long)B * H * W;
  if (M == 0) return 0;
  if (B < 0 || H < 0 || W < 0 || M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return block_dispatch<bf16>(x, k, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, out,
                                t, y, h, nullptr, nullptr, B, H, W, C, eps, s);
  if (dtype == 1)
    return block_dispatch<float>(x, k, dw_bias, ln_scale, ln_bias, w1t, b1, w2t, b2, gamma, out,
                                 t, y, h, ws, plan, B, H, W, C, eps, s);
  return (int)cudaErrorInvalidValue;
}
