// The tensor-core building blocks that csrc/conv3d.cu and csrc/attention.cu
// share, for Hopper (sm_90a): cp.async copies into shared memory, ldmatrix
// fragment loads and the bf16 mma.sync m16n8k16 with fp32 accumulators.
//
// Fragments of mma.sync.m16n8k16.row.col (PTX ISA), lane = 4*g + t:
//   A (16 x 16, row-major)  a0: row g, columns 2t, 2t+1;  a1: row g+8, the
//                           same; a2, a3: as a0, a1 at columns 2t+8, 2t+9
//   B (16 x 8, "col")       b0: rows (K) 2t, 2t+1 of column g; b1: rows
//                           2t+8, 2t+9
//   C (16 x 8, fp32)        c0, c1: row g, columns 2t, 2t+1; c2, c3: row g+8
// Two n8 tiles of C side by side (columns 0-7 and 8-15) hold, once packed
// in pairs to bf16, exactly the A fragment of a 16 x 16 tile: a product's
// result feeds the next product's A operand without leaving the registers.
// ldmatrix gives lane 4*g + t the elements (g, 2t) and (g, 2t+1) of each
// 8 x 8 matrix whose 8 rows of 16 bytes the lanes address; with .trans the
// elements (2t, g) and (2t+1, g).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; only `src_bytes` (16
// or 0) are read and the rest of the 16 are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// 4 bytes, through L1; `src_bytes` 4 or 0 (zero-fill).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c += a * b on a 16 x 8 x 16 tile, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two fp32 values rounded to bf16 and packed, lo in the low half: the pair
// order of an A or B fragment register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace
