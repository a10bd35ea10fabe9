// Fixed-order column sums of per-CTA partials, shared by the backward kernels
// (ln_mlp_bwd.cu, dwconv_bwd.cu). Each CTA writes its partial sums to its own
// row of a workspace; colsum adds the rows in one order, so two runs of a
// backward agree bit for bit (no float atomics).
#pragma once

#include <cuda_runtime.h>

namespace svt {
namespace {  // a kernel of each library that includes this

// out[c] = sum over p (in a fixed order) of in[p][c]. Launch with
// ((N + 31) / 32) blocks of dim3(32, 32).
__global__ void __launch_bounds__(1024) colsum(const float* __restrict__ in,
                                               long long P, int N,
                                               float* __restrict__ out) {
  __shared__ float sm[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < N)
    for (long long p = threadIdx.y; p < P; p += 32) s += in[p * N + c];
  sm[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < N) {
    float total = 0.f;
    for (int y = 0; y < 32; ++y) total += sm[y][threadIdx.x];
    out[c] = total;
  }
}

}  // namespace
}  // namespace svt
