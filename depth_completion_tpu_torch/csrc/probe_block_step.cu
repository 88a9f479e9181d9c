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
// Two designs of the block step, the same function: "wmma", the first
// flash_fwd_kernel's (score tile, p tile and fp32 accumulator in shared
// memory, 16 rows in turn per warp; block_step_kernel, entry point
// dct_probe_block_step), and "mma", the redesigned flash_fwd_kernel's
// (scores, p and accumulator in mma.sync fragments, quad-shuffle softmax;
// block_step_mma_kernel, entry point dct_probe_block_step_mma). Their times
// side by side say whether the redesign moved the piece it aimed at.
//
// Replaces the TPU probe scripts/exp_flash_overlap.py _body (:39, launched
// by _run :82): STEPS grid steps over grid-resident q [512, 64] and k, v
// [1024, 64]. That tile (320 KB of bf16 plus a 2 MB fp32 score tile) does
// not fit an SM's 227 KB, so this kernel takes the port's own flash tile
// (csrc/flash_attention.cu: 64 query and 64 key rows, 4 warps of 16 rows,
// and each design's own block-step code) and turns the grid into a loop
// inside the block. One block runs on each SM,
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

#include "mma_sync.cuh"

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


// ---------------------------------------------------------------------------
// The "mma" design: flash_fwd_kernel's block step (csrc/flash_attention.cu)
// on the same resident tiles. q's fragments in registers; s = q kᵀ in
// mma.sync accumulators; the online softmax on the fragments (row max by
// quad shuffles, the row sum kept per lane as the kernel keeps it); α
// rescales the register accumulator; p becomes the A fragments of p·v; v
// read through ldmatrix.trans. Tiles are swizzled as the kernel's. dots
// reads α from the shared scratch (1 throughout), as the WMMA design does;
// softmax fakes every score of row r as l[r] through an opaque register
// copy each (so the compiler cannot fold a row's exp2 into one), which
// needs the full row sum every step: that mode reduces l over the quad.
// ---------------------------------------------------------------------------

struct MmaSmem {
  bf16 q[BR * D];
  bf16 k[BR * D];
  bf16 v[BR * D];
  float alpha[BR];  // dots mode: the rescale scratch, 1 throughout
};

// a contiguous [64, 64] bf16 tile into a swizzled shared tile
__device__ __forceinline__ void load_swizzled(bf16* dst, const bf16* src) {
  for (int i = threadIdx.x; i < BR * (D / 8); i += NTHREADS) {
    const int r = i >> 3, c = i & 7;
    *reinterpret_cast<uint4*>(dst + dct::swz64(r, c)) = *reinterpret_cast<const uint4*>(src + r * D + c * 8);
  }
}

__device__ __forceinline__ float opaque(float x) {
  float y;
  asm volatile("mov.b32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int MODE>
__global__ void __launch_bounds__(NTHREADS)
block_step_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int steps,
                      float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  MmaSmem& sm = *reinterpret_cast<MmaSmem*>(smem_raw);
  const long base = (long)blockIdx.x * BR * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, mi = lane >> 3;
  const int row_qv = ((mi & 1) << 3) + lr, ch_qv = mi >> 1;
  const int row_k = ((mi >> 1) << 3) + lr, ch_k = mi & 1;

  load_swizzled(sm.q, q + base);
  load_swizzled(sm.k, k + base);
  load_swizzled(sm.v, v + base);
  if (threadIdx.x < BR) sm.alpha[threadIdx.x] = 1.f;
  __syncthreads();
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    dct::ldsm_x4(qf[kk], dct::smem_u32(sm.q + (warp * 16 + row_qv) * D +
                                       (((kk * 2 + ch_qv) ^ lr) << 3)));
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const float sc = MODE == SOFTMAX ? 1.f : scale_log2;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int step = 0; step < steps; ++step) {
    float s[8][4];
    if (MODE != SOFTMAX) {
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t b[4];
          dct::ldsm_x4(b, dct::smem_u32(sm.k + (jp * 16 + row_k) * D +
                                        (((kk * 2 + ch_k) ^ lr) << 3)));
          dct::mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
          dct::mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
        }
      }
    } else {  // the fake score tile: every column of row r holds l[r]
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i][0] = opaque(l0);
        s[i][1] = opaque(l0);
        s[i][2] = opaque(l1);
        s[i][3] = opaque(l1);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] *= sc;

    float alpha0, alpha1;
    if (MODE == DOTS) {
      alpha0 = sm.alpha[r0];
      alpha1 = sm.alpha[r1];
    } else {
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(s[i][0], s[i][1]));
        mx1 = fmaxf(mx1, fmaxf(s[i][2], s[i][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      alpha0 = exp2f(m0 - mx0);
      alpha1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i][0] = exp2f(s[i][0] - m0);
        s[i][1] = exp2f(s[i][1] - m0);
        s[i][2] = exp2f(s[i][2] - m1);
        s[i][3] = exp2f(s[i][3] - m1);
        ps0 += s[i][0] + s[i][1];
        ps1 += s[i][2] + s[i][3];
      }
      if (MODE == SOFTMAX) {  // the fake needs the full row sum every step
        ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
        ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
        ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
        ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
      }
      l0 = l0 * alpha0 + ps0;
      l1 = l1 * alpha1 + ps1;
    }

    if (MODE == SOFTMAX) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += s[i][e];
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] *= alpha0;
        acc[i][1] *= alpha0;
        acc[i][2] *= alpha1;
        acc[i][3] *= alpha1;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t pa[4] = {dct::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                dct::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                dct::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                dct::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t b[4];
          dct::ldsm_x4_t(b, dct::smem_u32(sm.v + (kk * 16 + row_qv) * D +
                                          (((dp * 2 + ch_qv) ^ lr) << 3)));
          dct::mma_bf16(acc[2 * dp], pa, b[0], b[1]);
          dct::mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
        }
      }
    }
  }
  asm volatile("" ::"f"(l0), "f"(l1));  // the row sums stay live, as in the kernel

  bf16* o0 = o + base + r0 * D + 2 * t;
  bf16* o1 = o + base + r1 * D + 2 * t;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    *reinterpret_cast<uint32_t*>(o0 + i * 8) = dct::pack_bf16(acc[i][0], acc[i][1]);
    *reinterpret_cast<uint32_t*>(o1 + i * 8) = dct::pack_bf16(acc[i][2], acc[i][3]);
  }
}

template <int MODE>
int launch_mma(const void* q, const void* k, const void* v, void* o, int batch, int steps,
               float scale_log2, cudaStream_t stream) {
  const int smem = sizeof(MmaSmem);
  cudaError_t err = cudaFuncSetAttribute(block_step_mma_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  block_step_mma_kernel<MODE><<<batch, NTHREADS, smem, stream>>>(
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

// The same modes in the "mma" design (flash_fwd_kernel's block step).
extern "C" int dct_probe_block_step_mma(const void* q, const void* k, const void* v, void* o,
                                        int batch, int steps, int mode, float scale_log2,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case FULL: return launch_mma<FULL>(q, k, v, o, batch, steps, scale_log2, st);
    case DOTS: return launch_mma<DOTS>(q, k, v, o, batch, steps, scale_log2, st);
    case SOFTMAX: return launch_mma<SOFTMAX>(q, k, v, o, batch, steps, scale_log2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
