// Probe kernel for Hopper (sm_90a): `steps` repeats of one flash-forward
// block step on tiles resident in shared memory, in one of three modes, to
// ask whether the tensor-core products serialise with the softmax:
//
//   full     s = q kᵀ·scale, online softmax (running max m and sum l),
//            acc = acc·α + bf16(p) v
//   dots     s = q kᵀ·scale, p = s, acc = acc·α + bf16(p) v, with α read
//            from a per-row scratch that starts at 1 and is never written
//   softmax  no products: the score tile is faked from the running l
//            (every column = l), then the online softmax, acc += p
//
// and o = bf16(acc), unnormalised. If full takes about dots + softmax, the
// two serialise; if about max(dots, softmax), they overlap.
//
// Replaces the TPU probe scripts/exp_flash_overlap.py _body (:39, launched
// by _run :82): STEPS grid steps over grid-resident q [512, 64] and k, v
// [1024, 64]. That tile (320 KB of bf16 plus a 2 MB fp32 score tile) does
// not fit an SM's 227 KB, so this kernel takes the port's own flash tile
// (csrc/flash_attention.cu: 64 query and 64 key rows, 4 warps of 16 rows,
// the same shared-memory strides and the same per-row softmax code) and
// turns the grid into a loop inside the block. One block runs on each SM,
// each on its own q, k, v and writing its own output, so every output is
// checked. The reference's dots mode reads α from the running-max scratch,
// which starts at -inf: acc·α is 0·(-inf) at its first step and its output
// is all NaN. Here α starts at 1 and the multiply stays in the loop.
//
// What bounds it: per step, 4·64·64·64 FLOP of products (full, dots) and
// 64·64 exp2 (full, softmax) per block: the tensor cores and the SFUs, with
// the products at WMMA's rate; nothing is read from device memory inside
// the loop. The softmax mode writes its fake tile through shared memory in
// a lane order unlike the one it reads in, so the compiler cannot fold the
// equal columns into one exp2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;           // head dim
constexpr int BR = 64;          // query rows and key rows of the tile
constexpr int NWARPS = 4;       // 16 rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDB = D + 16;     // bf16 tile row stride (as csrc/flash_attention.cu)
constexpr int LDF = BR + 4;     // fp32 tile row stride
constexpr int FULL = 0, DOTS = 1, SOFTMAX = 2;

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

// Copy a contiguous [64, 64] bf16 tile into shared memory (row stride LDB).
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src) {
  for (int i = threadIdx.x; i < BR * (D / 8); i += NTHREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDB + c) =
        *reinterpret_cast<const uint4*>(src + r * D + c);
  }
}

struct Smem {
  bf16 q[BR * LDB];
  bf16 k[BR * LDB];
  bf16 v[BR * LDB];
  bf16 p[BR * LDB];
  float s[BR * LDF];
  float o[BR * LDF];
  float m[BR];
  float l[BR];
  float alpha[BR];  // dots mode: the rescale scratch, 1 throughout
};

template <int MODE>
__global__ void __launch_bounds__(NTHREADS)
block_step_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int steps,
                  float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const long base = (long)blockIdx.x * BR * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile(sm.q, q + base);
  load_tile(sm.k, k + base);
  load_tile(sm.v, v + base);
  for (int i = threadIdx.x; i < BR * LDF; i += NTHREADS) sm.o[i] = 0.f;
  if (threadIdx.x < BR) {
    sm.m[threadIdx.x] = -INFINITY;
    sm.l[threadIdx.x] = 0.f;
    sm.alpha[threadIdx.x] = 1.f;
  }
  __syncthreads();
  float* s_w = sm.s + warp * 16 * LDF;
  float* o_w = sm.o + warp * 16 * LDF;
  const int c0 = lane, c1 = lane + 32;
  const float sc = MODE == SOFTMAX ? 1.f : scale_log2;

  for (int step = 0; step < steps; ++step) {
    FragC acc[4];
    if (MODE != SOFTMAX) {  // s = q kᵀ for this warp's 16 query rows
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
    } else {  // the fake score tile: every column of row r holds l[r]
      const int cw = (lane + 1) & 31;
      for (int r = 0; r < 16; ++r) {
        const float lr = sm.l[warp * 16 + r];
        s_w[r * LDF + cw] = lr;
        s_w[r * LDF + cw + 32] = lr;
      }
    }
    __syncwarp();

    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const float* srow = s_w + r * LDF;
      const float s0 = srow[c0] * sc, s1 = srow[c1] * sc;
      if (MODE == DOTS) {
        const float alpha = sm.alpha[row];
        sm.p[row * LDB + c0] = __float2bfloat16(s0);
        sm.p[row * LDB + c1] = __float2bfloat16(s1);
        o_w[r * LDF + c0] *= alpha;
        o_w[r * LDF + c1] *= alpha;
      } else {
        const float m_old = sm.m[row];
        const float l_old = sm.l[row];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
        const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
        const float psum = warp_sum(p0 + p1);
        const float alpha = exp2f(m_old - m_new);
        if (MODE == FULL) {
          sm.p[row * LDB + c0] = __float2bfloat16(p0);
          sm.p[row * LDB + c1] = __float2bfloat16(p1);
          o_w[r * LDF + c0] *= alpha;
          o_w[r * LDF + c1] *= alpha;
        } else {
          o_w[r * LDF + c0] += p0;
          o_w[r * LDF + c1] += p1;
        }
        __syncwarp();
        if (lane == 0) {
          sm.m[row] = m_new;
          sm.l[row] = l_old * alpha + psum;
        }
      }
    }
    __syncwarp();

    if (MODE != SOFTMAX) {  // acc += p v
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
  }

  for (int r = 0; r < 16; ++r) {
    bf16* orow = o + base + (warp * 16 + r) * D;
    orow[c0] = __float2bfloat16(o_w[r * LDF + c0]);
    orow[c1] = __float2bfloat16(o_w[r * LDF + c1]);
  }
}

template <int MODE>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int steps,
           float scale_log2, cudaStream_t stream) {
  const int smem = sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(block_step_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  block_step_kernel<MODE><<<batch, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, steps, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous [batch, 64, 64] bf16, one block per batch entry.
// mode: 0 full, 1 dots, 2 softmax.
extern "C" int dct_probe_block_step(const void* q, const void* k, const void* v, void* o,
                                    int batch, int steps, int mode, float scale_log2,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case FULL: return launch<FULL>(q, k, v, o, batch, steps, scale_log2, st);
    case DOTS: return launch<DOTS>(q, k, v, o, batch, steps, scale_log2, st);
    case SOFTMAX: return launch<SOFTMAX>(q, k, v, o, batch, steps, scale_log2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
