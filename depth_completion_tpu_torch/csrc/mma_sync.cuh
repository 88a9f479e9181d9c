// Warp-level tensor-core building blocks shared by the Hopper kernels of
// this package (sm_90a): cp.async copies into shared memory, ldmatrix
// fragment loads, the bf16 mma.sync m16n8k16 product with fp32
// accumulation, and the TF32 m16n8k8 product with its 3xTF32 split for
// fp32 operands (below pack_bf16). Fragment layouts follow the PTX ISA's m16n8k16 figures;
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

// two 8x8 bf16 matrices; lanes 0-15 give the addresses (lane l: row l % 8 of
// matrix l / 8)
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// barrier `id` (1-15; 0 is __syncthreads) over `threads` threads of the block
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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

// x rounded to bf16 and widened back (round to nearest even)
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// d += a · b (m16n8k8, tf32 operands, fp32 accumulator). With g = lane / 4
// and t = lane % 4 (PTX ISA, m16n8k8 .tf32 figures):
//   A (16x8, row-major): a0 (row g, col t), a1 (row g+8, col t),
//                        a2 (row g, col t+4), a3 (row g+8, col t+4)
//   B (8x8, "col"):      b0 (row t, col g), b1 (row t+4, col g)
//   C (16x8, fp32):      as m16n8k16
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 by integer ops: half a TF32 ulp added to the bits, the
// 13 low bits cleared. The same rounding as cvt.rna.tf32.f32 (to nearest,
// ties away from zero; a NaN may not stay one), at the integer pipes' rate.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// 3xTF32's split of an fp32 operand (the generic flash pair's and the fp32
// conv's): x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), so that
// hi·hi' + hi·lo' + lo·hi' carries ~22 bits of each product, where a single
// TF32 pass keeps 11.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a · b over one k8 step, each operand given as its TF32 parts (hi,
// lo; tf32_split). kSplit: three products (lo·hi', hi·lo', then hi·hi': the
// small ones first), else one (operands exact in TF32, lo unused). The
// products go into a zeroed fragment that joins c with fp32 adds (round to
// nearest): c itself never passes through the tensor cores, whose
// accumulation drops low bits.
// (The fp32 conv's wgmma form, conv3x3.cu, lets them sum one ring stage.)
// Kept in the mma accumulator over S=6912 keys, o read 3.7e-6-9.0e-6 from
// its fp32 twin (of max|o| ~0.12) where dq, which left through fp32 atomics
// a tile at a time, read 4e-7-1.6e-6 (H100 80GB HBM3; PERF.md).
template <bool kSplit>
__device__ __forceinline__ void mma_tf32x3(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (kSplit) {
    mma_tf32(d, al, bh0, bh1);
    mma_tf32(d, ah, bl0, bl1);
  }
  mma_tf32(d, ah, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}

}  // namespace dct
