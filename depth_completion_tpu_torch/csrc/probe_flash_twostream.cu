// Probe kernel for Hopper (sm_90a): the flash-attention forward of
// csrc/flash_attention.cu (flash_fwd_kernel, head dim 64) with two query
// tiles per block. Both streams share each staged key/value tile; each
// keeps its own running max, sum and fp32 accumulator. Same function, same
// [N, S, heads·64] strided layout, same ragged-tail masking, same lse2
// output as flash_fwd_kernel, which is the single-stream form the probe
// compares it with. No path of the port launches it.
//
// Replaces the TPU probe scripts/exp_flash_twostream.py _twostream_kernel
// (:64; _single_kernel :32 is flash_attention.py's _fwd_kernel, whose port
// is flash_fwd_kernel), launched by _fwd (:115) at [bh=5, S=7168, 64]: two
// q blocks per grid step so that Mosaic may run one stream's softmax while
// the other's products hold the MXU.
//
// What bounds it: as flash_fwd, 4·S²·64 FLOP per head against 8·S·64 bytes
// of q/k/v/o: the tensor cores (and the SFUs' exp2, 1 per score, nearly as
// long at d=64). On Hopper the warp scheduler already interleaves warps, so
// the question the TPU asked of one body is asked here of the block: 8
// warps (two 64-row streams of 4 warps) over one k/v tile, against
// flash_fwd's 4. The design halves the k/v tile loads per query row; its
// cost is shared memory: 129 KB a block (one block, 8 warps, per SM)
// against flash_fwd's 74.5 KB (up to three blocks, 12 warps, per SM), above
// the default 48 KB, so the entry
// point raises the limit with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;              // head dim
constexpr int BR = 64;             // rows of a key tile and of one query stream
constexpr int STREAMS = 2;         // query tiles per block
constexpr int BQ = STREAMS * BR;   // query rows per block
constexpr int TS_WARPS = BQ / 16;  // 16 query rows per warp: warps 0-3 stream 0, 4-7 stream 1
constexpr int NTHREADS = TS_WARPS * 32;
constexpr int LDB = D + 16;        // as csrc/flash_attention.cu
constexpr int LDF = BR + 4;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy rows [row0, row0 + rows) x 64 channels of a strided bf16 matrix into
// a shared tile; rows at or past nrows are zero.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long row_stride, int row0,
                                          int nrows, int rows) {
  for (int i = threadIdx.x; i < rows * (D / 8); i += NTHREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDB + c) = val;
  }
}

struct Smem {
  bf16 q[BQ * LDB];
  bf16 k[BR * LDB];
  bf16 v[BR * LDB];
  bf16 p[BQ * LDB];
  float s[BQ * LDF];
  float o[BQ * LDF];
  float m[BQ];
  float l[BQ];
};

__global__ void __launch_bounds__(NTHREADS)
flash_fwd_twostream_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           float* __restrict__ lse, int sq, int sk, int heads,
                           long q_sn, long q_ss, long k_sn, long k_ss, long v_sn, long v_ss,
                           long o_sn, long o_ss, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* kb = k + n * k_sn + h * D;
  const bf16* vb = v + n * v_sn + h * D;

  load_rows(sm.q, q + n * q_sn + h * D, q_ss, q0, sq, BQ);
  for (int i = threadIdx.x; i < BQ * LDF; i += NTHREADS) sm.o[i] = 0.f;
  if (threadIdx.x < BQ) {
    sm.m[threadIdx.x] = -INFINITY;
    sm.l[threadIdx.x] = 0.f;
  }
  float* s_w = sm.s + warp * 16 * LDF;
  float* o_w = sm.o + warp * 16 * LDF;

  for (int k0 = 0; k0 < sk; k0 += BR) {
    __syncthreads();  // previous tile fully consumed by both streams
    load_rows(sm.k, kb, k_ss, k0, sk, BR);
    load_rows(sm.v, vb, v_ss, k0, sk, BR);
    __syncthreads();

    // s = q kᵀ for this warp's 16 query rows
    FragC acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, sm.q + warp * 16 * LDB + kk, LDB);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBT b;
        wmma::load_matrix_sync(b, sm.k + j * 16 * LDB + kk, LDB);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(s_w + j * 16, acc[j], LDF, wmma::mem_row_major);
    __syncwarp();

    // online softmax over the tile (log2 domain), rows private to the warp
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const float* srow = s_w + r * LDF;
      const int c0 = lane, c1 = lane + 32;
      const float s0 = (k0 + c0 < sk) ? srow[c0] * scale_log2 : -INFINITY;
      const float s1 = (k0 + c1 < sk) ? srow[c1] * scale_log2 : -INFINITY;
      const float m_old = sm.m[row];
      const float l_old = sm.l[row];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
      const float psum = warp_sum(p0 + p1);
      const float alpha = exp2f(m_old - m_new);
      sm.p[row * LDB + c0] = __float2bfloat16(p0);
      sm.p[row * LDB + c1] = __float2bfloat16(p1);
      o_w[r * LDF + c0] *= alpha;
      o_w[r * LDF + c1] *= alpha;
      __syncwarp();
      if (lane == 0) {
        sm.m[row] = m_new;
        sm.l[row] = l_old * alpha + psum;
      }
    }
    __syncwarp();

    // o += p v
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::load_matrix_sync(acc[j], o_w + j * 16, LDF, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, sm.p + warp * 16 * LDB + kk, LDB);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, sm.v + kk * LDB + j * 16, LDB);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(o_w + j * 16, acc[j], LDF, wmma::mem_row_major);
    __syncwarp();
  }

  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r, gq = q0 + row;
    if (gq >= sq) break;
    const float l = sm.l[row];
    const float inv = l == 0.f ? 1.f : 1.f / l;
    bf16* orow = o + n * o_sn + (long)gq * o_ss + h * D;
    orow[lane] = __float2bfloat16(o_w[r * LDF + lane] * inv);
    orow[lane + 32] = __float2bfloat16(o_w[r * LDF + lane + 32] * inv);
    if (lane == 0)
      lse[((long)n * heads + h) * sq + gq] = sm.m[row] + (l == 0.f ? 0.f : log2f(l));
  }
}

}  // namespace

// Arguments as dct_flash_fwd (csrc/flash_attention.cu).
extern "C" int dct_flash_fwd_twostream(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int batch, int heads, int sq, int sk,
                                       long q_sn, long q_ss, long k_sn, long k_ss, long v_sn,
                                       long v_ss, long o_sn, long o_ss, float scale,
                                       void* stream) {
  const int smem = sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_twostream_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, heads, batch);
  flash_fwd_twostream_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, sq, sk, heads,
      q_sn, q_ss, k_sn, k_ss, v_sn, v_ss, o_sn, o_ss, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
