// GELU-cost probe: one elementwise pass over a bf16 [M, N] array (the stage-1
// hidden, M = 32 * 128 * 128, N = 512, at batch 32) with four bodies:
//   0 copy           y = x
//   1 erf-GELU f32   the A&S erf-GELU of probe_act.cuh
//   2 gelu+grad      h + dh from svt::gelu_and_grad_tanh (one tanhf for both)
//   3 tanh-GELU      svt::gelu_tanh
// each in f32 on the bf16 input, rounded once to bf16.
//
// Replaces scripts/probe_gelu_cost.py::make (its pallas_call at :45), which
// timed the same bodies on the TPU's vector unit. The tanh-GELU is the
// production kernels' own (gelu.cuh, the MLP body's), and gelu+grad the tanh
// form that the JAX function and the first CUDA MLP backward compute
// (probe_act.cuh), so the time beyond the copy is what each activation costs
// per element on this card. The pass moves 4 bytes an element
// and does 10-30 f32 operations on it: bound by device memory on an H100 (the
// f32 rate needs 67e12 / 3.35e12 = 20 operations a byte), so the bodies' cost
// shows only where it exceeds the copy's time. A thread takes 16 bytes (8
// values) per step, so loads and stores are full 16-byte vectors.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "probe_act.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;

template <int OP>
__device__ __forceinline__ float body(float x) {
  if constexpr (OP == 0) {
    return x;
  } else if constexpr (OP == 1) {
    return svt::erf_gelu(x);
  } else if constexpr (OP == 2) {
    float h, dh;
    svt::gelu_and_grad_tanh(x, h, dh);
    return h + dh;
  } else {
    return svt::gelu_tanh(x);
  }
}

template <int OP>
__global__ void __launch_bounds__(THREADS) gelu_map(const uint4* __restrict__ x,
                                                    uint4* __restrict__ y, long long nvec) {
  const long long base = (long long)blockIdx.x * THREADS * UNROLL + threadIdx.x;
  uint4 v[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long i = base + (long long)u * THREADS;
    if (i < nvec) v[u] = x[i];
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long i = base + (long long)u * THREADS;
    if (i >= nvec) continue;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v[u]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(p[k]);
      p[k] = __floats2bfloat162_rn(body<OP>(f.x), body<OP>(f.y));
    }
    y[i] = v[u];
  }
}

template <int OP>
int launch(const void* x, void* y, long long nvec, cudaStream_t s) {
  const long long per = (long long)THREADS * UNROLL;
  gelu_map<OP><<<(unsigned)((nvec + per - 1) / per), THREADS, 0, s>>>(
      (const uint4*)x, (uint4*)y, nvec);
  return (int)cudaGetLastError();
}

}  // namespace

// y = body(x) over n bf16 values (n a multiple of 8, both 16-byte aligned);
// op as above. Returns the cudaError_t of the launch.
extern "C" int svt_probe_gelu(int op, const void* x, void* y, long long n, void* stream) {
  if (n == 0) return 0;
  if (n % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case 0: return launch<0>(x, y, n / 8, s);
    case 1: return launch<1>(x, y, n / 8, s);
    case 2: return launch<2>(x, y, n / 8, s);
    case 3: return launch<3>(x, y, n / 8, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
