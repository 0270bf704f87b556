// Warp-level building blocks of the experiment kernels (static_max_variants.cu;
// mma_probe.cu takes its ldmatrix): bf16 tensor-core products with
// mma.sync.m16n8k16 (fp32 accumulators in registers), ldmatrix fragment
// loads from shared memory, and 16-byte cp.async copies with zero fill.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// with g = lane / 4 and t = lane % 4:
//   A (16 x 16, 4 regs of bf16x2): a0 (row g,   k 2t..2t+1), a1 (row g+8, k 2t..2t+1),
//                                   a2 (row g,   k 2t+8..+9), a3 (row g+8, k 2t+8..+9)
//   B (16 x 8,  2 regs):            b0 (k 2t..2t+1, col g),  b1 (k 2t+8..+9, col g)
//   C (16 x 8,  4 floats):          c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols)
// The low half of a bf16x2 register holds the lower k (or column) index.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace warp_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(row)));
}

// the same, each matrix transposed on the way into registers
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_addr(row)));
}

// c += a . b on the tensor cores (bf16 operands, fp32 accumulators)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory, asynchronously; with `valid`
// false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// two floats, each rounded to bf16 (round to nearest even), low half first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

}  // namespace warp_mma
