// MLP-body ablation probe: the block MLP with its tail,
//   out = res + gamma * (W2 . act(W1 . x + b1) + b2),
// through the production row kernel (mlp_body.cuh's row_mlp_kernel in its
// copy form with TAIL) with the hidden activation swapped:
//   0 GeluTanh  tanh-GELU in f32, what #1, #5 and #7 compile to
//   1 ErfF32    A&S erf-GELU in f32 (the script's "full")
//   2 Relu
//   3 ErfBf16   erf-GELU in bf16 arithmetic (the script's "gelu_bf16")
//   4 NoAct     h only rounded to bf16 (the script's "matmul_only")
//   5 copy      out = x + res through the same 64-token prologue and
//               coalesced epilogue, no body (the script's "copy": the floor
//               of a CTA's fixed cost)
//
// Replaces scripts/ablate_mlp_kernel.py::run (its pallas_call at :96, the
// body make_kernel at :55), which split the TPU kernel's time the same way.
// The TPU script also swept the token tile (1024-4096 rows a grid step); the
// body here has one tile, TOK = 64 tokens a CTA, so the probe sweeps C only.
// The products, 16 * M * C^2 flops against 6 * M * C bytes, bound every
// variant but the copy by the tensor cores; the differences between variants
// are what each activation and the body's data movement cost.
#include "mlp_body.cuh"
#include "probe_act.cuh"

namespace {

// out = x + res in bf16 arithmetic (f32 sum rounded once) through the row
// prologue and the coalesced epilogue.
template <int C>
__global__ void __launch_bounds__(NTHREADS, 1) row_copy_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ res, bf16* __restrict__ out,
    long long M) {
  using L = Layout<C>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* sY = smem + L::Y;
  bf16* sX = smem + L::X;
  const long long tok0 = (long long)blockIdx.x * TOK;
  load_rows<C, false, true>(sY, sX, x, res, tok0, M);
  svt::cp_async_wait_all();
  __syncthreads();
  constexpr int ROW = C / 2;  // bf16 pairs a row
  for (int v = threadIdx.x; v < TOK * ROW; v += NTHREADS) {
    const int r = v / ROW, kk = (v % ROW) * 2;
    const float2 a = svt::load2(sY + r * L::LDY + kk);
    const float2 b = svt::load2(sX + r * L::LDY + kk);
    svt::store2(sY + r * L::LDY + kk, a.x + b.x, a.y + b.y);
  }
  __syncthreads();
  store_rows<C>(sY, out, tok0, M);
}

template <int C>
int launch_copy(const void* x, const void* res, void* out, long long M, cudaStream_t s) {
  const size_t smem = Layout<C>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      row_copy_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  row_copy_kernel<C><<<(unsigned)((M + TOK - 1) / TOK), NTHREADS, smem, s>>>(
      (const bf16*)x, (const bf16*)res, (bf16*)out, M);
  return (int)cudaGetLastError();
}

template <int C>
int launch_variant(int variant, const void* x, const void* res, const void* w1t,
                   const void* b1, const void* w2t, const void* b2, const void* gamma,
                   void* out, long long M, cudaStream_t s) {
  switch (variant) {
    case 0:
      return launch_rows<C, false, true, GeluTanh>(x, res, nullptr, nullptr, w1t, b1, w2t, b2,
                                                   gamma, out, M, 0.f, s);
    case 1:
      return launch_rows<C, false, true, ErfF32>(x, res, nullptr, nullptr, w1t, b1, w2t, b2,
                                                 gamma, out, M, 0.f, s);
    case 2:
      return launch_rows<C, false, true, Relu>(x, res, nullptr, nullptr, w1t, b1, w2t, b2,
                                               gamma, out, M, 0.f, s);
    case 3:
      return launch_rows<C, false, true, ErfBf16>(x, res, nullptr, nullptr, w1t, b1, w2t, b2,
                                                  gamma, out, M, 0.f, s);
    case 4:
      return launch_rows<C, false, true, NoAct>(x, res, nullptr, nullptr, w1t, b1, w2t, b2,
                                                gamma, out, M, 0.f, s);
    case 5:
      return launch_copy<C>(x, res, out, M, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One ablation variant (0-5, above) over M token rows of width C (128, 256 or
// 512): x, res, w1t [4C, C], w2t [C, 4C] and out bf16, b1, b2, gamma f32; the
// copy variant reads only x and res. Returns the cudaError_t of the launch.
extern "C" int svt_probe_mlp(int variant, const void* x, const void* res, const void* w1t,
                             const void* b1, const void* w2t, const void* b2,
                             const void* gamma, void* out, long long M, int C, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 128: return launch_variant<128>(variant, x, res, w1t, b1, w2t, b2, gamma, out, M, s);
    case 256: return launch_variant<256>(variant, x, res, w1t, b1, w2t, b2, gamma, out, M, s);
    case 512: return launch_variant<512>(variant, x, res, w1t, b1, w2t, b2, gamma, out, M, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
