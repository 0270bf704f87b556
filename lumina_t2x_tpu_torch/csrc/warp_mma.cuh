// Warp-level fragment loads of the tensor-core probe (mma_probe.cu): ldmatrix
// from shared memory into the A-fragment layout that mma.sync.m16n8k16 and
// a register-sourced wgmma share. With g = lane / 4 and t = lane % 4, a
// 16 x 16 A tile is 4 registers of bf16x2:
//   a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..2t+1),
//   a2 (row g, k 2t+8..+9), a3 (row g+8, k 2t+8..+9)
// The low half of a bf16x2 register holds the lower k index.

#pragma once

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

}  // namespace warp_mma
