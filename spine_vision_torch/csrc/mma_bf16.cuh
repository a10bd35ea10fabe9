// Tensor-core and copy helpers shared by the block forward (convnext_block.cu,
// mlp_body.cuh) and the probes (probe_*.cu): mma.sync m16n8k16 bf16 -> f32,
// ldmatrix operand loads (plain and transposed) and cp.async streaming; the
// tanh-GELU comes from gelu.cuh.
//
// Fragment conventions of mma.sync.m16n8k16.row.col (g = lane / 4,
// t = lane % 4): A (16 x 16) a[0] = A[g][2t..2t+1], a[1] = A[g+8][2t..],
// a[2] = A[g][2t+8..], a[3] = A[g+8][2t+8..]; B (16 x 8) b0 = B[2t..2t+1][g],
// b1 = B[2t+8..2t+9][g]; D (16 x 8) d[0..1] = D[g][2t..2t+1],
// d[2..3] = D[g+8][2t..2t+1].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gelu.cuh"

namespace svt {

using bf16 = __nv_bfloat16;

// 16-byte global -> shared copy that bypasses the register file.
__device__ __forceinline__ void cp_async16(bf16* smem, const bf16* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// A fragment (16x16 at rows m0.., cols k0..) of a row-major [*, ld] array.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* base,
                                       int ld, int m0, int k0, int lane) {
  ldsm_x4(a, base + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}
// A fragment of A = X^T, X stored k-major ([k][m], row stride ld).
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4], const bf16* base,
                                             int ld, int m0, int k0, int lane) {
  ldsm_x4_trans(a, base + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
                       ((lane >> 3) & 1) * 8);
}
// B fragments of the two 16x8 tiles at n0 and n0 + 8 of an n-major [n][ld]
// array: {b0, b1} of the first in r[0..1], of the second in r[2..3].
__device__ __forceinline__ void load_b2(uint32_t (&b)[4], const bf16* base,
                                        int ld, int n0, int k0, int lane) {
  ldsm_x4(b, base + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                 ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ void load_b1(uint32_t (&b)[2], const bf16* base,
                                        int ld, int n0, int k0, int lane) {
  ldsm_x2(b, base + (n0 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
}
// The same two tiles from a k-major [k][ld] array (B stored row-major).
__device__ __forceinline__ void load_b2_trans(uint32_t (&b)[4], const bf16* base,
                                              int ld, int n0, int k0, int lane) {
  ldsm_x4_trans(b, base + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 +
                       ((lane >> 4) << 3));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace svt
