// Flash attention for Hopper (sm_90a): non-causal multi-head forward and a
// one-pass backward, bf16 operands, fp32 accumulation, head dim 64.
//
// Replaces the TPU kernels of depth_completion_tpu/ops/flash_attention.py:
//   flash_fwd  <- _fwd_kernel (:163, launched by _fwd :354)
//   flash_bwd  <- _bwd_fused_kernel (:464) / _bwd_fused_kernel_t (:534),
//                 launched by _fused_bwd_call (:673)
//
// What bounds it: at the UNet's stage-0 shape (S=6912, 5 heads, d=64) the
// work is ~4·S²·d FLOP per head forward against ~4·S·d·2 bytes of q/k/v/o,
// i.e. hundreds of FLOP per byte: the tensor cores bound it, not memory.
// Design: scores never leave shared memory. A block owns 64 query rows
// (forward) or 64 key rows (backward) of one (batch, head) and walks the
// other sequence in 64-row tiles; products run on the tensor cores through
// WMMA (bf16 m16n16k16, fp32 accumulate) and the online softmax runs in
// fp32 on a shared-memory score tile. This is the simple, right first form:
// no TMA, no wgmma, no pipelining of the tile loads.
//
// Layout: q/k/v/o are [N, S, heads*64] with the head at channel offset
// h*64, addressed through (batch, row) strides, so the projections need no
// transpose copy. The ragged tail of either sequence is masked in-kernel.
// The row statistic is lse2 = m + log2(l) in the log2 domain (scores
// scaled by scale*log2(e)); the backward recomputes p = exp2(s - lse2).
//
// Backward: parallel over key blocks. dk/dv accumulate in WMMA registers
// over all query tiles; dq accumulates in an fp32 buffer with atomicAdd
// (the caller zeroes it and casts it). di = rowsum(do*o) comes from a small
// pre-pass kernel launched by the same entry point.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;           // head dim
constexpr int BR = 64;          // rows per tile (query and key tiles alike)
constexpr int NWARPS = 4;       // 16 rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDB = D + 16;     // bf16 tile row stride: 160 B keeps WMMA pointers 32 B aligned
constexpr int LDF = BR + 4;     // fp32 tile row stride

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
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

// Copy rows [row0, row0+64) x 64 channels of a strided bf16 matrix into a
// shared tile; rows at or past nrows are zero.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long row_stride,
                                          int row0, int nrows) {
  for (int i = threadIdx.x; i < BR * (D / 8); i += NTHREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDB + c) = val;
  }
}

struct FwdSmem {
  bf16 q[BR * LDB];
  bf16 k[BR * LDB];
  bf16 v[BR * LDB];
  bf16 p[BR * LDB];
  float s[BR * LDF];
  float o[BR * LDF];
  float m[BR];
  float l[BR];
};

__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int heads,
                 long q_sn, long q_ss, long k_sn, long k_ss, long v_sn, long v_ss,
                 long o_sn, long o_ss, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int q0 = blockIdx.x * BR, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* qb = q + n * q_sn + h * D;
  const bf16* kb = k + n * k_sn + h * D;
  const bf16* vb = v + n * v_sn + h * D;

  load_tile(sm.q, qb, q_ss, q0, sq);
  for (int i = threadIdx.x; i < BR * LDF; i += NTHREADS) sm.o[i] = 0.f;
  if (threadIdx.x < BR) {
    sm.m[threadIdx.x] = -INFINITY;
    sm.l[threadIdx.x] = 0.f;
  }
  float* s_w = sm.s + warp * 16 * LDF;
  float* o_w = sm.o + warp * 16 * LDF;

  for (int k0 = 0; k0 < sk; k0 += BR) {
    __syncthreads();  // previous tile fully consumed
    load_tile(sm.k, kb, k_ss, k0, sk);
    load_tile(sm.v, vb, v_ss, k0, sk);
    __syncthreads();

    // s = q k^T for this warp's 16 query rows
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

// di[n, h, s] = sum_d do * o   (one warp per row, rows ordered (n, h, s))
__global__ void flash_bwd_di_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                    float* __restrict__ di, long rows, int sq, int heads,
                                    long o_sn, long o_ss, long d_sn, long d_ss) {
  const long row = (long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int s = row % sq;
  const int h = (row / sq) % heads;
  const long n = row / ((long)sq * heads);
  const bf16* orow = o + n * o_sn + (long)s * o_ss + h * D;
  const bf16* drow = dout + n * d_sn + (long)s * d_ss + h * D;
  float acc = __bfloat162float(orow[lane]) * __bfloat162float(drow[lane]) +
              __bfloat162float(orow[lane + 32]) * __bfloat162float(drow[lane + 32]);
  acc = warp_sum(acc);
  if (lane == 0) di[row] = acc;
}

struct BwdSmem {
  bf16 k[BR * LDB];
  bf16 v[BR * LDB];
  bf16 q[BR * LDB];
  bf16 dout[BR * LDB];
  bf16 p[BR * LDB];
  bf16 ds[BR * LDB];
  float s[BR * LDF];
  float lse[BR];
  float di[BR];
};

__global__ void __launch_bounds__(NTHREADS)
flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 int sq, int sk, int heads, long q_sn, long q_ss, long k_sn, long k_ss,
                 long v_sn, long v_ss, long d_sn, long d_ss, float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int k0 = blockIdx.x * BR, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* qb = q + n * q_sn + h * D;
  const bf16* db = dout + n * d_sn + h * D;
  const long stat0 = ((long)n * heads + h) * sq;
  const int C = heads * D;  // dq_acc / dk / dv are contiguous [N, S, heads*D]

  load_tile(sm.k, k + n * k_sn + h * D, k_ss, k0, sk);
  load_tile(sm.v, v + n * v_sn + h * D, v_ss, k0, sk);

  FragC dk_acc[4], dv_acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }
  float* s_w = sm.s + warp * 16 * LDF;
  const bool c0_ok = k0 + lane < sk, c1_ok = k0 + lane + 32 < sk;

  for (int q0 = 0; q0 < sq; q0 += BR) {
    __syncthreads();  // previous query tile fully consumed
    load_tile(sm.q, qb, q_ss, q0, sq);
    load_tile(sm.dout, db, d_ss, q0, sq);
    if (threadIdx.x < BR) {
      const int gq = q0 + threadIdx.x;
      sm.lse[threadIdx.x] = gq < sq ? lse[stat0 + gq] : 0.f;
      sm.di[threadIdx.x] = gq < sq ? di[stat0 + gq] : 0.f;
    }
    __syncthreads();

    // s = q k^T (warp owns 16 query rows)
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

    // p = exp2(s*scale*log2e - lse2), zero outside both sequences
    float p_reg[16][2];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const bool row_ok = q0 + row < sq;
      const float m = sm.lse[row];
      const float p0 = (row_ok && c0_ok) ? exp2f(s_w[r * LDF + lane] * scale_log2 - m) : 0.f;
      const float p1 = (row_ok && c1_ok) ? exp2f(s_w[r * LDF + lane + 32] * scale_log2 - m) : 0.f;
      p_reg[r][0] = p0;
      p_reg[r][1] = p1;
      sm.p[row * LDB + lane] = __float2bfloat16(p0);
      sm.p[row * LDB + lane + 32] = __float2bfloat16(p1);
    }
    __syncwarp();

    // dp = do v^T
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, sm.dout + warp * 16 * LDB + kk, LDB);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBT b;
        wmma::load_matrix_sync(b, sm.v + j * 16 * LDB + kk, LDB);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(s_w + j * 16, acc[j], LDF, wmma::mem_row_major);
    __syncwarp();

    // ds = p * (dp - di) * scale
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const float dd = sm.di[row];
      sm.ds[row * LDB + lane] =
          __float2bfloat16(p_reg[r][0] * (s_w[r * LDF + lane] - dd) * scale);
      sm.ds[row * LDB + lane + 32] =
          __float2bfloat16(p_reg[r][1] * (s_w[r * LDF + lane + 32] - dd) * scale);
    }
    __syncthreads();  // all of p and ds before the key-row products

    // dv += p^T do ; dk += ds^T q   (warp owns 16 key rows)
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      FragAT pt, dst;
      wmma::load_matrix_sync(pt, sm.p + kk * LDB + warp * 16, LDB);
      wmma::load_matrix_sync(dst, sm.ds + kk * LDB + warp * 16, LDB);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, sm.dout + kk * LDB + j * 16, LDB);
        wmma::mma_sync(dv_acc[j], pt, b, dv_acc[j]);
        wmma::load_matrix_sync(b, sm.q + kk * LDB + j * 16, LDB);
        wmma::mma_sync(dk_acc[j], dst, b, dk_acc[j]);
      }
    }

    // dq partial = ds k (warp owns 16 query rows), added into fp32 dq
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, sm.ds + warp * 16 * LDB + kk, LDB);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, sm.k + kk * LDB + j * 16, LDB);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(s_w + j * 16, acc[j], LDF, wmma::mem_row_major);
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int gq = q0 + warp * 16 + r;
      if (gq >= sq) break;
      float* dst = dq_acc + ((long)n * sq + gq) * C + h * D;
      atomicAdd(dst + lane, s_w[r * LDF + lane]);
      atomicAdd(dst + lane + 32, s_w[r * LDF + lane + 32]);
    }
  }

  // write dv then dk for this warp's 16 key rows
  __syncwarp();
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(s_w + j * 16, which == 0 ? dv_acc[j] : dk_acc[j], LDF,
                              wmma::mem_row_major);
    __syncwarp();
    bf16* out = which == 0 ? dv : dk;
    for (int r = 0; r < 16; ++r) {
      const int gk = k0 + warp * 16 + r;
      if (gk >= sk) break;
      bf16* dst = out + ((long)n * sk + gk) * C + h * D;
      dst[lane] = __float2bfloat16(s_w[r * LDF + lane]);
      dst[lane + 32] = __float2bfloat16(s_w[r * LDF + lane + 32]);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int dct_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int batch, int heads, int sq, int sk, long q_sn, long q_ss,
                             long k_sn, long k_ss, long v_sn, long v_ss, long o_sn, long o_ss,
                             float scale, void* stream) {
  const int smem = sizeof(FwdSmem);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BR - 1) / BR, heads, batch);
  flash_fwd_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, sq, sk, heads,
      q_sn, q_ss, k_sn, k_ss, v_sn, v_ss, o_sn, o_ss, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

extern "C" int dct_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, void* di, void* dq_acc,
                             void* dk, void* dv, int batch, int heads, int sq, int sk,
                             long q_sn, long q_ss, long k_sn, long k_ss, long v_sn, long v_ss,
                             long o_sn, long o_ss, long d_sn, long d_ss, float scale,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long rows = (long)batch * heads * sq;
  const int rows_per_block = 8;
  flash_bwd_di_kernel<<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                        rows_per_block * 32, 0, st>>>((const bf16*)o, (const bf16*)dout,
                                                      (float*)di, rows, sq, heads, o_sn, o_ss,
                                                      d_sn, d_ss);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = sizeof(BwdSmem);
  err = cudaFuncSetAttribute(flash_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sk + BR - 1) / BR, heads, batch);
  flash_bwd_kernel<<<grid, NTHREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)di, (float*)dq_acc, (bf16*)dk, (bf16*)dv, sq, sk, heads, q_sn, q_ss, k_sn,
      k_ss, v_sn, v_ss, d_sn, d_ss, scale, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
