// Tensor-core and asynchronous-copy helpers of the bf16 kernel bodies
// (K1 cost_volume_mma_kernel, K2 stem_mma_kernel, K5 upconv_mma_kernel,
// K4a/K4b cv_bwd_mma_kernel):
// shared-memory addresses, cp.async 16-byte copies, ldmatrix operand loads
// and mma.sync m16n8k16.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace qpw {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Wait until at most N of this thread's committed copy groups are pending
// (the ring's next chunk may stay in flight).
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a));
}

// Two 8x8 b16 matrices; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&d)[2], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(d[0]), "=r"(d[1])
               : "r"(a));
}

// The same loads transposed: each lane gets a column pair of its matrix,
// so [k][m] rows in shared memory give the row-major A fragment of [m][k].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&d)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&d)[2],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(d[0]), "=r"(d[1])
      : "r"(a));
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace qpw
