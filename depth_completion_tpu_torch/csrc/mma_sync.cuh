// Warp-level tensor-core building blocks shared by the Hopper kernels of
// this package (sm_90a): cp.async copies into shared memory, ldmatrix
// fragment loads and the bf16 mma.sync m16n8k16 product with fp32
// accumulation. Fragment layouts follow the PTX ISA's m16n8k16 figures;
// with g = lane / 4 and t = lane % 4:
//   A (16x16, row-major): a0 (row g, cols 2t..2t+1), a1 (row g+8, same),
//                         a2 (row g, cols 2t+8..), a3 (row g+8, cols 2t+8..)
//   B (16x8, "col"):      b0 (rows 2t..2t+1, col g), b1 (rows 2t+8.., col g)
//   C (16x8, fp32):       c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// Each 32-bit register holds two bf16, the lower column in the low half.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace dct {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronous; zero-filled when !valid (src is
// then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes global → shared (through L1: the 4-byte form has no .cg), for
// fp32 rows whose start need not be 16-byte aligned; zero-filled when !valid
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// the same, each matrix transposed (a row-major [k][n] tile read as B)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a · b (m16n8k16, bf16 operands, fp32 accumulator)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element offset of 16-byte chunk `chunk` (0-7) of row `row` in a 64-column
// bf16 tile whose chunks are XORed with row % 8: the eight rows one ldmatrix
// reads at one logical chunk then sit in eight distinct bank groups.
__device__ __forceinline__ int swz64(int row, int chunk) {
  return row * 64 + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace dct
