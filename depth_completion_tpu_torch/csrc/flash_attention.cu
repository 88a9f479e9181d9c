// Flash attention for Hopper (sm_90a): non-causal multi-head forward and a
// one-pass backward, bf16 operands, fp32 accumulation, at head dim 64 (the
// UNet) and head dim 512 (the KL VAE's one-head mid attention; second half
// of this file).
//
// Replaces the TPU kernels of depth_completion_tpu/ops/flash_attention.py,
// which the JAX package runs at both head dims:
//   flash_fwd, flash_fwd_d512  <- _fwd_kernel (:163, launched by _fwd :354)
//   flash_bwd, flash_bwd_d512  <- _bwd_fused_kernel (:464) /
//                 _bwd_fused_kernel_t (:534), launched by _fused_bwd_call (:673)
//
// What bounds it: at the UNet's stage-0 shape (S=6912, 5 heads, d=64) the
// work is ~4·S²·d FLOP per head forward against ~4·S·d·2 bytes of q/k/v/o,
// i.e. hundreds of FLOP per byte: the tensor cores bound it, not memory;
// next come the S² exp2 on the special-function units (~1/16 of the
// products' time at peak) and the softmax's own instructions around them.
//
// d=64 forward (flash_fwd_kernel), the FlashAttention-2 form on mma.sync:
// a block of 4 warps owns 64 query rows of one (batch, head), 16 per warp,
// and walks the keys in 64-row tiles. Q's fragments are loaded into
// registers once (ldmatrix); each tile's scores s = q·kᵀ (mma.sync
// m16n8k16, bf16 in, fp32 out) stay in the accumulator registers, where the
// online softmax runs: a row's 16 columns per lane, its max and (after the
// loop) its sum over the lane quad by two __shfl_xor_sync, exp2f on the
// fragments, α rescaling the fp32 o accumulator (16x64 per warp, 32 values a
// lane) in place. p's C fragments become the bf16 A fragments of p·v without
// leaving the registers; v is read through ldmatrix.trans. No score, p or o
// tile and no m/l array lives in shared memory. K and V tiles arrive through
// a two-stage cp.async ring (16-byte copies, zero-filled past sk), so tile
// j+1 loads while tile j is used; the 128-byte tile rows are XOR-swizzled
// (16-byte chunk ^ row % 8) so that every ldmatrix is free of bank
// conflicts. Tile and occupancy: 40 KB of shared memory and at most 128
// registers (launch bounds) give 4 blocks (16 warps) per SM. At S=6912 with
// 5 heads that is 540 blocks on 528 slots: 12 blocks run a second, nearly
// empty wave. 128-row blocks (8 warps, 2 per SM) leave 6 of 270 in the same
// spot with twice the work each, and 96-row blocks (3 per SM) need <= 113
// registers, where this kernel's fragments (q 16, s 32, o 32) leave no room:
// 64 rows keeps the tail quantum smallest (reckoned, not measured).
//
// The backward and the d=512 kernels are the first, simple WMMA form:
// scores in shared memory, no pipelining of the tile loads.
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
#include <stddef.h>
#include <stdint.h>

#include "mma_sync.cuh"

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

// ---------------------------------------------------------------------------
// d=64 forward: mma.sync m16n8k16 with the online softmax on the accumulator
// fragments (design notes at the top of this file).
// ---------------------------------------------------------------------------

// BR query rows per block (16 per warp) and BR key rows per tile, each tile
// 64x64 bf16 (8 KB) with swizzled rows (dct::swz64)
struct FwdSmem {
  bf16 q[BR * D];
  bf16 k[2][BR * D];  // two-stage cp.async ring: tile j+1 lands while tile j is used
  bf16 v[2][BR * D];
};

// cp.async rows [row0, row0 + 64) x 64 channels of a strided bf16 matrix into
// a swizzled tile; rows at or past nrows are zero-filled.
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, long row_stride, int row0,
                                           int nrows) {
  for (int i = threadIdx.x; i < BR * 8; i += NTHREADS) {
    const int r = i >> 3, c = i & 7;
    const bool ok = row0 + r < nrows;
    dct::cp_async_16(dct::smem_u32(dst + dct::swz64(r, c)),
                     ok ? src + (long)(row0 + r) * row_stride + c * 8 : src, ok);
  }
}

// the o accumulator's rows g and g + 8 scaled by this tile's α
__device__ __forceinline__ void rescale(float (&acc)[8][4], float alpha0, float alpha1) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i][0] *= alpha0;
    acc[i][1] *= alpha0;
    acc[i][2] *= alpha1;
    acc[i][3] *= alpha1;
  }
}

__global__ void __launch_bounds__(NTHREADS, 4)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int heads,
                 long q_sn, long q_ss, long k_sn, long k_ss, long v_sn, long v_ss,
                 long o_sn, long o_ss, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int q0 = blockIdx.x * BR, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix addressing: lane gives row lr of matrix mi. For Q (A) and V
  // (B through .trans) matrix mi is rows +8·(mi & 1), chunk +(mi >> 1); for
  // K (B) rows +8·(mi >> 1), chunk +(mi & 1). Row offsets are multiples of
  // 8, so the swizzle term row % 8 is lr throughout.
  const int lr = lane & 7, mi = lane >> 3;
  const int row_qv = ((mi & 1) << 3) + lr, ch_qv = mi >> 1;
  const int row_k = ((mi >> 1) << 3) + lr, ch_k = mi & 1;
  const bf16* kb = k + n * k_sn + h * D;
  const bf16* vb = v + n * v_sn + h * D;
  const int ntiles = (sk + BR - 1) / BR;

  stage_tile(sm.q, q + n * q_sn + h * D, q_ss, q0, sq);
  stage_tile(sm.k[0], kb, k_ss, 0, sk);
  stage_tile(sm.v[0], vb, v_ss, 0, sk);
  dct::cp_async_commit();

  uint32_t qf[4][4];  // this warp's 16 query rows as A fragments, 4 steps of 16 channels
  float acc[8][4];    // o: 16 rows x 64 channels (8 n8 tiles)
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8 (log2 domain)
  float l0 = 0.f, l1 = 0.f;              // this lane's part of their row sums

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    dct::cp_async_wait<0>();
    __syncthreads();  // tile j landed for every thread; tile j-1 consumed by every warp
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        dct::ldsm_x4(qf[kk], dct::smem_u32(sm.q + (warp * 16 + row_qv) * D +
                                           (((kk * 2 + ch_qv) ^ lr) << 3)));
    }
    if (j + 1 < ntiles) {
      stage_tile(sm.k[st ^ 1], kb, k_ss, (j + 1) * BR, sk);
      stage_tile(sm.v[st ^ 1], vb, v_ss, (j + 1) * BR, sk);
    }
    dct::cp_async_commit();
    const bf16* ks = sm.k[st];
    const bf16* vs = sm.v[st];

    // s = q kᵀ: 16 rows x 64 keys (8 n8 tiles) in registers
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        dct::ldsm_x4(b, dct::smem_u32(ks + (jp * 16 + row_k) * D + (((kk * 2 + ch_k) ^ lr) << 3)));
        dct::mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        dct::mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }

    // online softmax on the fragments: lane holds columns 8i + 2t, +1 of rows
    // g (s[i][0..1]) and g + 8 (s[i][2..3]); a row's four lanes form a quad
    const int kcol = j * BR + 2 * t;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] *= scale_log2;
    if ((j + 1) * BR > sk) {  // the ragged last tile: keys at or past sk score -inf
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kcol + i * 8 + (e & 1) >= sk) s[i][e] = -INFINITY;
    }
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
    // column k0 < sk is valid in every row, so mx is finite; α is 0 at the first tile
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
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
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
    rescale(acc, alpha0, alpha1);

    // o += p v: p's C fragments of score tiles 2kk and 2kk+1 are the A
    // fragment of key step kk; v through ldmatrix.trans as B
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {dct::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              dct::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              dct::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              dct::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        dct::ldsm_x4_t(b, dct::smem_u32(vs + (kk * 16 + row_qv) * D +
                                        (((dp * 2 + ch_qv) ^ lr) << 3)));
        dct::mma_bf16(acc[2 * dp], pa, b[0], b[1]);
        dct::mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  }

  // full row sums from the quad; o = acc / l (a row with l == 0 keeps inv = 1)
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  float* lse_bh = lse + ((long)n * heads + h) * sq;
  if (r0 < sq) {
    bf16* orow = o + n * o_sn + (long)r0 * o_ss + h * D + 2 * t;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + i * 8) = dct::pack_bf16(acc[i][0] * inv0, acc[i][1] * inv0);
    if (t == 0) lse_bh[r0] = m0 + (l0 == 0.f ? 0.f : log2f(l0));
  }
  if (r1 < sq) {
    bf16* orow = o + n * o_sn + (long)r1 * o_ss + h * D + 2 * t;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + i * 8) = dct::pack_bf16(acc[i][2] * inv1, acc[i][3] * inv1);
    if (t == 0) lse_bh[r1] = m1 + (l1 == 0.f ? 0.f : log2f(l1));
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

// ===========================================================================
// Head dim 512: the KL VAE's mid attention (one head, S = 6912 at res 768).
//
// What bounds it: 4·S²·512 FLOP forward (98 GFLOP at S=6912) against
// 4·S·512·2 bytes of q/k/v/o: the tensor cores, by far. What changes from
// d=64 is the size of the per-row state: a 64-row fp32 output accumulator is
// 128 KB, so the d=64 design (accumulators in shared memory) does not fit.
// Design: the accumulators live in WMMA registers, split over the 8 warps
// by output columns (a warp owns 64 of the 512). The online softmax's
// per-row rescale reaches them through an accumulator fragment loaded from a
// row-broadcast tile (alpha_r in every column of row r): two accumulator
// fragments of one type map their elements to the same (row, column), so an
// elementwise product scales each row. Forward: 32 query rows per block,
// 64-key tiles. Backward: 32 key rows per block, 32-row query tiles; dk and
// dv (2 x 32 x 512 fp32) stay in registers across the query loop, each warp
// holding its 64 columns of both; P and dS need the full-d products Q·Kᵀ
// and dO·Vᵀ, which warps 0-3 and 4-7 compute side by side; dq is added into
// fp32 with atomics, one 16x16 fragment at a time through a per-warp tile.
// Simple first form: no TMA, no wgmma, one block per SM.
// ===========================================================================

namespace {

constexpr int HD5 = 512;         // head dim
constexpr int LD5 = HD5 + 8;     // bf16 row stride of a 512-wide tile (1040 B)
constexpr int LDO5 = HD5 + 4;    // fp32 row stride of the output staging
constexpr int NW5 = 8;           // warps per block
constexpr int NT5 = NW5 * 32;
constexpr int FQ5 = 32;          // forward: query rows per block
constexpr int FK5 = 64;          // forward: key rows per tile
constexpr int FLDS = FK5 + 4;    // forward: fp32 score stride
constexpr int FLDP = FK5 + 8;    // forward: bf16 p stride
constexpr int BK5 = 32;          // backward: key rows per block
constexpr int BQ5 = 32;          // backward: query rows per tile
constexpr int BLDS = BK5 + 4;
constexpr int BLDP = BK5 + 8;

// Copy rows [row0, row0 + rows) x 512 channels of a strided bf16 matrix into
// a shared tile; rows at or past nrows are zero.
__device__ __forceinline__ void load_rows512(bf16* dst, const bf16* src, long row_stride,
                                             int row0, int nrows, int rows) {
  for (int i = threadIdx.x; i < rows * (HD5 / 8); i += NT5) {
    const int r = i / (HD5 / 8), c = (i % (HD5 / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD5 + c) = val;
  }
}

// Write rows [row0, row0 + rows) of an fp32 staging tile (stride LDO5),
// times the per-row factor (nullptr: 1), as bf16 rows below nrows.
__device__ __forceinline__ void store_rows512(bf16* dst, long row_stride, const float* stage,
                                              const float* row_scale, int row0, int nrows,
                                              int rows) {
  for (int i = threadIdx.x; i < rows * (HD5 / 8); i += NT5) {
    const int r = i / (HD5 / 8), c = (i % (HD5 / 8)) * 8;
    if (row0 + r >= nrows) continue;
    const float f = row_scale == nullptr ? 1.f : row_scale[r];
    uint4 ov;
    bf16* os = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int e = 0; e < 8; ++e) os[e] = __float2bfloat16(stage[r * LDO5 + c + e] * f);
    *reinterpret_cast<uint4*>(dst + (long)(row0 + r) * row_stride + c) = ov;
  }
}

struct Fwd512Smem {
  bf16 q[FQ5 * LD5];
  bf16 k[FK5 * LD5];   // also the fp32 output staging after the key loop
  bf16 v[FK5 * LD5];
  float s[FQ5 * FLDS];
  bf16 p[FQ5 * FLDP];
  float alpha[FQ5 * 16];  // row r: this tile's rescale of row r, in all 16 columns
  float m[FQ5];
  float l[FQ5];
};
static_assert(sizeof(Fwd512Smem) <= 232448, "forward tiles exceed shared memory");
static_assert(FQ5 * LDO5 * 4 <= FK5 * LD5 * 2, "output staging must fit the k tile");
static_assert(offsetof(Fwd512Smem, k) % 32 == 0 && offsetof(Fwd512Smem, v) % 32 == 0 &&
              offsetof(Fwd512Smem, s) % 32 == 0 && offsetof(Fwd512Smem, p) % 32 == 0 &&
              offsetof(Fwd512Smem, alpha) % 32 == 0, "WMMA tiles must be 32-byte aligned");

__global__ void __launch_bounds__(NT5)
flash_fwd_d512_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int sq, int sk, int heads,
                      long q_sn, long q_ss, long k_sn, long k_ss, long v_sn, long v_ss,
                      long o_sn, long o_ss, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Fwd512Smem& sm = *reinterpret_cast<Fwd512Smem*>(smem_raw);
  const int q0 = blockIdx.x * FQ5, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* kb = k + n * k_sn + (long)h * HD5;
  const bf16* vb = v + n * v_sn + (long)h * HD5;

  load_rows512(sm.q, q + n * q_sn + (long)h * HD5, q_ss, q0, sq, FQ5);
  if (threadIdx.x < FQ5) {
    sm.m[threadIdx.x] = -INFINITY;
    sm.l[threadIdx.x] = 0.f;
  }
  FragC acc_o[2][4];  // rows rb*16.., columns warp*64 + c*16..
#pragma unroll
  for (int rb = 0; rb < 2; ++rb)
#pragma unroll
    for (int c = 0; c < 4; ++c) wmma::fill_fragment(acc_o[rb][c], 0.f);
  const int srb = warp >> 2, scb = warp & 3;  // this warp's 16x16 score fragment

  for (int k0 = 0; k0 < sk; k0 += FK5) {
    __syncthreads();  // previous tile fully consumed
    load_rows512(sm.k, kb, k_ss, k0, sk, FK5);
    load_rows512(sm.v, vb, v_ss, k0, sk, FK5);
    __syncthreads();

    // s = q kᵀ: one 16x16 fragment per warp, contracted over all 512 columns
    {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll 8
      for (int kk = 0; kk < HD5; kk += 16) {
        FragA a;
        FragBT b;
        wmma::load_matrix_sync(a, sm.q + srb * 16 * LD5 + kk, LD5);
        wmma::load_matrix_sync(b, sm.k + scb * 16 * LD5 + kk, LD5);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sm.s + srb * 16 * FLDS + scb * 16, acc, FLDS, wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax (log2 domain), 4 rows per warp, 2 columns per lane
    for (int r = 0; r < FQ5 / NW5; ++r) {
      const int row = warp * (FQ5 / NW5) + r;
      const float* srow = sm.s + row * FLDS;
      const float s0 = (k0 + lane < sk) ? srow[lane] * scale_log2 : -INFINITY;
      const float s1 = (k0 + lane + 32 < sk) ? srow[lane + 32] * scale_log2 : -INFINITY;
      const float m_old = sm.m[row], l_old = sm.l[row];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
      const float psum = warp_sum(p0 + p1);
      const float alpha = exp2f(m_old - m_new);
      sm.p[row * FLDP + lane] = __float2bfloat16(p0);
      sm.p[row * FLDP + lane + 32] = __float2bfloat16(p1);
      if (lane < 16) sm.alpha[row * 16 + lane] = alpha;
      __syncwarp();
      if (lane == 0) {
        sm.m[row] = m_new;
        sm.l[row] = l_old * alpha + psum;
      }
    }
    __syncthreads();

    // o = alpha·o + p v over this warp's 64 output columns
#pragma unroll
    for (int rb = 0; rb < 2; ++rb) {
      FragC af;
      wmma::load_matrix_sync(af, sm.alpha + rb * 16 * 16, 16, wmma::mem_row_major);
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < af.num_elements; ++e) acc_o[rb][c].x[e] *= af.x[e];
    }
#pragma unroll
    for (int kk = 0; kk < FK5; kk += 16) {
      FragA pa[2];
#pragma unroll
      for (int rb = 0; rb < 2; ++rb)
        wmma::load_matrix_sync(pa[rb], sm.p + rb * 16 * FLDP + kk, FLDP);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        FragB b;
        wmma::load_matrix_sync(b, sm.v + kk * LD5 + warp * 64 + c * 16, LD5);
#pragma unroll
        for (int rb = 0; rb < 2; ++rb) wmma::mma_sync(acc_o[rb][c], pa[rb], b, acc_o[rb][c]);
      }
    }
  }

  __syncthreads();  // k and v consumed: the k tile becomes the output staging
  float* stage = reinterpret_cast<float*>(sm.k);
#pragma unroll
  for (int rb = 0; rb < 2; ++rb)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      wmma::store_matrix_sync(stage + rb * 16 * LDO5 + warp * 64 + c * 16, acc_o[rb][c], LDO5,
                              wmma::mem_row_major);
  if (threadIdx.x < FQ5) {
    const float l_row = sm.l[threadIdx.x];
    sm.alpha[threadIdx.x] = 1.f / l_row;  // every row saw at least one key: l_row >= 1
    if (q0 + threadIdx.x < sq)
      lse[((long)n * heads + h) * sq + q0 + threadIdx.x] = sm.m[threadIdx.x] + log2f(l_row);
  }
  __syncthreads();
  store_rows512(o + n * o_sn + (long)h * HD5, o_ss, stage, sm.alpha, q0, sq, FQ5);
}

// di[n, h, s] = sum over the 512 columns of do * o (one warp per row)
__global__ void flash_bwd_di_d512_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                         float* __restrict__ di, long rows, int sq, int heads,
                                         long o_sn, long o_ss, long d_sn, long d_ss) {
  const long row = (long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int s = row % sq;
  const int h = (row / sq) % heads;
  const long n = row / ((long)sq * heads);
  const bf16* orow = o + n * o_sn + (long)s * o_ss + (long)h * HD5;
  const bf16* drow = dout + n * d_sn + (long)s * d_ss + (long)h * HD5;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < HD5 / 32; ++j)
    acc += __bfloat162float(orow[lane + 32 * j]) * __bfloat162float(drow[lane + 32 * j]);
  acc = warp_sum(acc);
  if (lane == 0) di[row] = acc;
}

struct Bwd512Smem {
  bf16 k[BK5 * LD5];
  bf16 v[BK5 * LD5];
  bf16 q[BQ5 * LD5];     // q and dout together are the fp32 dk/dv staging at the end
  bf16 dout[BQ5 * LD5];
  float s[BQ5 * BLDS];
  float dp[BQ5 * BLDS];
  bf16 p[BQ5 * BLDP];
  bf16 ds[BQ5 * BLDP];
  float stage[NW5 * 256];  // one 16x16 fp32 tile per warp (dq partials)
  float lse[BQ5];
  float di[BQ5];
};
static_assert(sizeof(Bwd512Smem) <= 232448, "backward tiles exceed shared memory");
static_assert(BK5 * LDO5 * 4 <= 2 * BQ5 * LD5 * 2, "dk/dv staging must fit the q and dout tiles");
static_assert(offsetof(Bwd512Smem, v) % 32 == 0 && offsetof(Bwd512Smem, q) % 32 == 0 &&
              offsetof(Bwd512Smem, dout) % 32 == 0 && offsetof(Bwd512Smem, s) % 32 == 0 &&
              offsetof(Bwd512Smem, dp) % 32 == 0 && offsetof(Bwd512Smem, p) % 32 == 0 &&
              offsetof(Bwd512Smem, ds) % 32 == 0 && offsetof(Bwd512Smem, stage) % 32 == 0,
              "WMMA tiles must be 32-byte aligned");

__global__ void __launch_bounds__(NT5)
flash_bwd_d512_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ di,
                      float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                      int sq, int sk, int heads, long q_sn, long q_ss, long k_sn, long k_ss,
                      long v_sn, long v_ss, long d_sn, long d_ss, float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Bwd512Smem& sm = *reinterpret_cast<Bwd512Smem*>(smem_raw);
  const int kt0 = blockIdx.x * BK5, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* qb = q + n * q_sn + (long)h * HD5;
  const bf16* db = dout + n * d_sn + (long)h * HD5;
  const long stat0 = ((long)n * heads + h) * sq;
  const long C = (long)heads * HD5;  // dq_acc / dk / dv are contiguous [N, S, heads*512]

  load_rows512(sm.k, k + n * k_sn + (long)h * HD5, k_ss, kt0, sk, BK5);
  load_rows512(sm.v, v + n * v_sn + (long)h * HD5, v_ss, kt0, sk, BK5);

  FragC acc_dk[2][4], acc_dv[2][4];  // key rows rb*16.., columns warp*64 + c*16..
#pragma unroll
  for (int rb = 0; rb < 2; ++rb)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wmma::fill_fragment(acc_dk[rb][c], 0.f);
      wmma::fill_fragment(acc_dv[rb][c], 0.f);
    }
  // warps 0-3: a fragment of s = q kᵀ; warps 4-7: the same fragment of dp = do vᵀ
  const int frb = (warp & 3) >> 1, fcb = warp & 1;
  const bf16* a_src = warp < 4 ? sm.q : sm.dout;
  const bf16* b_src = warp < 4 ? sm.k : sm.v;
  float* f_dst = warp < 4 ? sm.s : sm.dp;
  float* stg = sm.stage + warp * 256;

  for (int q0 = 0; q0 < sq; q0 += BQ5) {
    __syncthreads();  // previous query tile fully consumed
    load_rows512(sm.q, qb, q_ss, q0, sq, BQ5);
    load_rows512(sm.dout, db, d_ss, q0, sq, BQ5);
    if (threadIdx.x < BQ5) {
      const int gq = q0 + threadIdx.x;
      sm.lse[threadIdx.x] = gq < sq ? lse[stat0 + gq] : 0.f;
      sm.di[threadIdx.x] = gq < sq ? di[stat0 + gq] : 0.f;
    }
    __syncthreads();

    {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll 8
      for (int kk = 0; kk < HD5; kk += 16) {
        FragA a;
        FragBT b;
        wmma::load_matrix_sync(a, a_src + frb * 16 * LD5 + kk, LD5);
        wmma::load_matrix_sync(b, b_src + fcb * 16 * LD5 + kk, LD5);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(f_dst + frb * 16 * BLDS + fcb * 16, acc, BLDS, wmma::mem_row_major);
    }
    __syncthreads();

    // p = exp2(s·scale·log2e − lse2), ds = p·(dp − di)·scale; zero outside both sequences
    for (int i = threadIdx.x; i < BQ5 * BK5; i += NT5) {
      const int r = i / BK5, c = i % BK5;
      const bool ok = q0 + r < sq && kt0 + c < sk;
      const float pv = ok ? exp2f(sm.s[r * BLDS + c] * scale_log2 - sm.lse[r]) : 0.f;
      sm.p[r * BLDP + c] = __float2bfloat16(pv);
      sm.ds[r * BLDP + c] = __float2bfloat16(pv * (sm.dp[r * BLDS + c] - sm.di[r]) * scale);
    }
    __syncthreads();

    // dv += pᵀ do ; dk += dsᵀ q over this warp's 64 columns
#pragma unroll
    for (int kk = 0; kk < BQ5; kk += 16) {
      FragAT pt[2], dst[2];
#pragma unroll
      for (int rb = 0; rb < 2; ++rb) {
        wmma::load_matrix_sync(pt[rb], sm.p + kk * BLDP + rb * 16, BLDP);
        wmma::load_matrix_sync(dst[rb], sm.ds + kk * BLDP + rb * 16, BLDP);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        FragB b;
        wmma::load_matrix_sync(b, sm.dout + kk * LD5 + warp * 64 + c * 16, LD5);
#pragma unroll
        for (int rb = 0; rb < 2; ++rb) wmma::mma_sync(acc_dv[rb][c], pt[rb], b, acc_dv[rb][c]);
        wmma::load_matrix_sync(b, sm.q + kk * LD5 + warp * 64 + c * 16, LD5);
#pragma unroll
        for (int rb = 0; rb < 2; ++rb) wmma::mma_sync(acc_dk[rb][c], dst[rb], b, acc_dk[rb][c]);
      }
    }

    // dq += ds k over this warp's 64 columns, one fragment at a time into fp32
    for (int rb = 0; rb < 2; ++rb) {
      for (int c = 0; c < 4; ++c) {
        FragC acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < BK5; kk += 16) {
          FragA a;
          FragB b;
          wmma::load_matrix_sync(a, sm.ds + rb * 16 * BLDP + kk, BLDP);
          wmma::load_matrix_sync(b, sm.k + kk * LD5 + warp * 64 + c * 16, LD5);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(stg, acc, 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int idx = lane + 32 * e, gq = q0 + rb * 16 + idx / 16;
          if (gq < sq)
            atomicAdd(dq_acc + ((long)n * sq + gq) * C + (long)h * HD5 + warp * 64 + c * 16 + idx % 16,
                      stg[idx]);
        }
        __syncwarp();
      }
    }
  }

  // write dv, then dk, through the staging tile over q and dout
  float* stage = reinterpret_cast<float*>(sm.q);
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    __syncthreads();  // q/dout (then the previous output) no longer read
#pragma unroll
    for (int rb = 0; rb < 2; ++rb)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wmma::store_matrix_sync(stage + rb * 16 * LDO5 + warp * 64 + c * 16,
                                which == 0 ? acc_dv[rb][c] : acc_dk[rb][c], LDO5,
                                wmma::mem_row_major);
    __syncthreads();
    store_rows512((which == 0 ? dv : dk) + n * sk * C + (long)h * HD5, C, stage, nullptr, kt0, sk,
                  BK5);
  }
}

}  // namespace

extern "C" int dct_flash_fwd_d512(const void* q, const void* k, const void* v, void* o, void* lse,
                                  int batch, int heads, int sq, int sk, long q_sn, long q_ss,
                                  long k_sn, long k_ss, long v_sn, long v_ss, long o_sn,
                                  long o_ss, float scale, void* stream) {
  const int smem = sizeof(Fwd512Smem);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_d512_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + FQ5 - 1) / FQ5, heads, batch);
  flash_fwd_d512_kernel<<<grid, NT5, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, sq, sk, heads,
      q_sn, q_ss, k_sn, k_ss, v_sn, v_ss, o_sn, o_ss, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

extern "C" int dct_flash_bwd_d512(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, void* di, void* dq_acc,
                                  void* dk, void* dv, int batch, int heads, int sq, int sk,
                                  long q_sn, long q_ss, long k_sn, long k_ss, long v_sn,
                                  long v_ss, long o_sn, long o_ss, long d_sn, long d_ss,
                                  float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long rows = (long)batch * heads * sq;
  const int rows_per_block = 8;
  flash_bwd_di_d512_kernel<<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                             rows_per_block * 32, 0, st>>>((const bf16*)o, (const bf16*)dout,
                                                           (float*)di, rows, sq, heads, o_sn,
                                                           o_ss, d_sn, d_ss);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = sizeof(Bwd512Smem);
  err = cudaFuncSetAttribute(flash_bwd_d512_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sk + BK5 - 1) / BK5, heads, batch);
  flash_bwd_d512_kernel<<<grid, NT5, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)di, (float*)dq_acc, (bf16*)dk, (bf16*)dv, sq, sk, heads, q_sn, q_ss, k_sn,
      k_ss, v_sn, v_ss, d_sn, d_ss, scale, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
