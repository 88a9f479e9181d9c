// Flash attention for Hopper (sm_90a): non-causal multi-head forward and a
// one-pass backward, bf16 operands, fp32 accumulation, at head dim 64 (the
// UNet) and head dim 512 (the KL VAE's one-head mid attention; second half
// of this file). Every other (dtype, head dim) pair the JAX package sends to
// Pallas, fp32 operands included, takes the generic kernels of
// flash_generic.cuh.
//
// Replaces the TPU kernels of depth_completion_tpu/ops/flash_attention.py,
// which the JAX package runs at both head dims:
//   flash_fwd, flash_fwd_d512  <- _fwd_kernel (:163, launched by _fwd :354)
//   flash_bwd, flash_bwd_d512  <- _bwd_fused_kernel (:464) /
//                 _bwd_fused_kernel_t (:534), launched by _fused_bwd_call (:673)
//   flash_fwd_ring, flash_bwd_ring  <- the flash ring of
//                 depth_completion_tpu/ops/ring_attention.py (_make_flash_ring,
//                 :99): #1 and #2 per visiting key block, merged online
//
// What bounds it: at the UNet's stage-0 shape (S=6912, 5 heads, d=64) the
// work is ~4·S²·d FLOP per head forward (10·S²·d backward) against ~4·S·d·2
// bytes of q/k/v/o, i.e. hundreds of FLOP per byte: the tensor cores bound
// it, not memory; next come the S² exp2 on the special-function units (~1/16
// of the products' time at peak) and the softmax's own instructions around
// them. With mma.sync on 16-row warp tiles every B fragment read from shared
// memory feeds one m16n8k16 product, so shared-memory bandwidth (128 B per
// clock per SM, 4 clocks per ldmatrix.x4) runs level with the tensor cores.
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
// d=64 backward (flash_bwd_kernel), the same machinery turned round: a
// block of 4 warps owns 64 key rows, 16 per warp, and walks the query tiles
// (64 rows). Each warp loads its k and v rows as A fragments once and keeps
// them (32 registers) with its dk and dv accumulators (16x64 fp32 each, 64
// registers). Per query tile, in four groups of 16 queries: sᵀ = k·qᵀ and
// dpᵀ = v·doᵀ (q and do as B through plain ldmatrix) land in accumulator
// registers; pᵀ = exp2(sᵀ·scale·log2e − lse2) and dsᵀ = pᵀ∘(dpᵀ − di)·scale
// are formed there, with lse2 and di read by the lane's columns; their C
// fragments become the A fragments of dv += pᵀ·do and dk += dsᵀ·q (do and q
// through ldmatrix.trans). The groups keep s and dp at 8 registers each, so
// the kernel fits 168 registers with no spill. dq needs ds with the queries
// as rows: each group's dsᵀ is written once as bf16 into an 8 KB swizzled
// tile, and after one barrier each warp takes 16 query rows of dq = ds·k
// over the block's 64 keys (dsᵀ and k through ldmatrix.trans) and adds them
// into the fp32 dq buffer with 16-byte atomicAdd (float4, sm_90): lanes t
// and t^1 swap halves of their C fragments so that each holds four
// consecutive columns of one row. Q, dO and their lse2/di slices arrive
// through a two-stage cp.async ring (the statistics as 4-byte copies: their
// rows start anywhere), zero-filled past sq; p is zeroed past sq and sk.
// Per warp and query tile: 160 mma against 84 ldmatrix.x4.
// dq, reckoned both ways at S=6912, 5 heads: atomics add S²·heads·64/64 =
// 239M fp32 values per call as 60M 16-byte reductions into L2, overlapped
// with the products; the two-kernel form (a dk/dv kernel plus a dq kernel
// parallel over query blocks, as _bwd_dkv_kernel / _bwd_dq_kernel) needs no
// atomics but recomputes s and dp: 7 products for 5, +40% FLOP on a kernel
// that the products and their ldmatrix traffic bound. Atomics chosen.
// Occupancy: 57 KB of shared memory gives 3 blocks (12 warps) per SM (4
// would need 4·58 KB > 228 KB), and ptxas fits the launch bounds' 168
// registers with 0 bytes of spill; 540 blocks at S=6912, 5 heads fill 396
// slots and 144 run in a second wave (1.36 waves); at S=1728, 10 heads 270
// blocks fit one wave. Tried on an H100 and dropped, each slower than this
// form: 128-key blocks of 8 warps (half the atomics; 2 blocks per SM, 128
// registers with k and v reloaded, a few bytes of spill); clusters of two
// blocks summing their dq partials through distributed shared memory before
// the atomics (half the atomics, one cluster barrier per query tile); each
// block starting at its own query tile (atomics spread over rows). What the
// atomics cost: PERF.md, Findings.
//
// Layout: q/k/v/o are [N, S, heads*64] with the head at channel offset
// h*64, addressed through (batch, row) strides, so the projections need no
// transpose copy. The ragged tail of either sequence is masked in-kernel.
// The row statistic is lse2 = m + log2(l) in the log2 domain (scores
// scaled by scale*log2(e)); the backward recomputes p = exp2(s - lse2), and
// takes lse2 as given: the ring passes the global statistic of a row whose
// o came from other key blocks too. di = rowsum(do*o) comes from a small
// pre-pass kernel launched by the same entry point; the caller zeroes dq's
// fp32 buffer and casts it.
//
// The ring (ops/ring_attention.py) runs template instantiations of the same
// two kernels, one launch per visiting key block over every shard. Its
// running state is the online softmax's own: with M the running max, the
// row sum W = Σ 2^(s−M) and ACC = Σ 2^(s−M)·v over every key seen so far, a
// ring step is flash_fwd_kernel started from the carried (M, W, ACC) in
// place of (−inf, 0, 0) over the visiting block's keys. Steps before the
// last write the state back in fp32 (m, l [N, heads, S], acc [N, S, C]:
// acc read and written, 8 bytes an element a step, in place), the last
// writes o and lse2, so o is rounded to bf16 once. The backward's ring
// instantiation takes di from the first step's pre-pass (o and dO are the
// same for every block), adds dq into one fp32 buffer with its atomics, and
// adds dk and dv into the travelling fp32 buffer (8-byte reductions, two
// fp32 a lane) where flash_bwd stores bf16. Plain flash_fwd / flash_bwd
// are <false, false> / <false>, the same code as before the ring took them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_sync.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;           // head dim
constexpr int BR = 64;          // rows per tile (query and key tiles alike)
constexpr int NWARPS = 4;       // 16 rows per warp
constexpr int NTHREADS = NWARPS * 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N][4], float alpha0, float alpha1) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i][0] *= alpha0;
    acc[i][1] *= alpha0;
    acc[i][2] *= alpha1;
    acc[i][3] *= alpha1;
  }
}

// StateIn: the online softmax starts from the ring's carried state (m, l,
// acc of the key blocks visited before) in place of (-inf, 0, 0); StateOut:
// it ends by writing that state back in fp32 (m, the full row sum l, acc
// unnormalised) in place of o and lse2. <false, false> is flash_fwd; the
// ring's first step is <false, true>, its middle steps <true, true>, its
// last <true, false>. m and l are [N, heads, sq], acc [N, sq, heads*64].
template <bool StateIn, bool StateOut>
__global__ void __launch_bounds__(NTHREADS, 4)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, float* __restrict__ m_st, float* __restrict__ l_st,
                 float* __restrict__ acc_st, int sq, int sk, int heads,
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
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const long stat_bh = ((long)n * heads + h) * sq;
  // this lane's columns of rows r0 and r1 in the fp32 state acc [N, sq, heads*64]
  float* acc_r0 = acc_st + ((long)n * sq + r0) * heads * D + h * D + 2 * t;
  float* acc_r1 = acc_r0 + (long)8 * heads * D;
  if constexpr (StateIn) {  // the quad's lane t = 0 carries the row sum
    if (r0 < sq) {
      m0 = m_st[stat_bh + r0];
      l0 = t == 0 ? l_st[stat_bh + r0] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 a = *reinterpret_cast<const float2*>(acc_r0 + i * 8);
        acc[i][0] = a.x;
        acc[i][1] = a.y;
      }
    }
    if (r1 < sq) {
      m1 = m_st[stat_bh + r1];
      l1 = t == 0 ? l_st[stat_bh + r1] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 a = *reinterpret_cast<const float2*>(acc_r1 + i * 8);
        acc[i][2] = a.x;
        acc[i][3] = a.y;
      }
    }
  }

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
    // column k0 < sk is valid in every row, so mx is finite; α is 0 at the
    // first tile, or rescales the carried state there
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
  if constexpr (StateOut) {  // the state for the next ring step, in place
    if (r0 < sq) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float2*>(acc_r0 + i * 8) = make_float2(acc[i][0], acc[i][1]);
      if (t == 0) {
        m_st[stat_bh + r0] = m0;
        l_st[stat_bh + r0] = l0;
      }
    }
    if (r1 < sq) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float2*>(acc_r1 + i * 8) = make_float2(acc[i][2], acc[i][3]);
      if (t == 0) {
        m_st[stat_bh + r1] = m1;
        l_st[stat_bh + r1] = l1;
      }
    }
    return;
  }
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
  float* lse_bh = lse + stat_bh;
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

// ---------------------------------------------------------------------------
// d=64 backward: mma.sync m16n8k16 with p, dp and ds on the accumulator
// fragments (design notes at the top of this file).
// ---------------------------------------------------------------------------

// BR key rows per block (16 per warp); query tiles of BR rows through a
// two-stage cp.async ring, with their lse2 and di slices
struct BwdSmem {
  bf16 k[BR * D];
  bf16 v[BR * D];
  bf16 q[2][BR * D];
  bf16 dout[2][BR * D];
  bf16 ds[BR * D];  // dsᵀ of the current query tile: [key][query], swizzled
  float lse[2][BR];
  float di[2][BR];
};

// cp.async the fp32 statistics of rows [row0, row0 + 64) (lse2 by threads
// 0-63, di by 64-127); rows at or past nrows are zero-filled
__device__ __forceinline__ void stage_stats(float* lse_dst, float* di_dst, const float* lse_row,
                                            const float* di_row, int row0, int nrows) {
  const int i = threadIdx.x & (BR - 1);
  const bool ok = row0 + i < nrows;
  const float* src = threadIdx.x < BR ? lse_row : di_row;
  float* dst = threadIdx.x < BR ? lse_dst : di_dst;
  dct::cp_async_4(dct::smem_u32(dst + i), ok ? src + row0 + i : src, ok);
}

// p[0..1] += (x, y) into the travelling fp32 dk|dv of the ring, as one
// 8-byte reduction (sm_90): L2 adds it, so the block's last loop issues its
// adds without waiting for a load (no other block touches these rows)
__device__ __forceinline__ void add_f2(float* p, float x, float y) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(x, y));
}

// Ring: dk and dv are added into the ring's travelling fp32 buffer dkv_acc
// ([N, sk, 2·heads·64], dk in the first heads·64 channels of a row, dv in
// the rest) in place of the bf16 stores into dk and dv.
template <bool Ring>
__global__ void __launch_bounds__(NTHREADS, 3)
flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 float* __restrict__ dkv_acc, int sq, int sk, int heads, long q_sn, long q_ss, long k_sn, long k_ss,
                 long v_sn, long v_ss, long d_sn, long d_ss, float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int k0 = blockIdx.x * BR, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix addressing as in flash_fwd_kernel: (row_qv, ch_qv) for an A
  // operand stored row-major and for a B operand through .trans; (row_k,
  // ch_k) for a B operand stored [n][k] and for an A operand stored [k][m]
  // through .trans (dsᵀ in the dq product)
  const int lr = lane & 7, mi = lane >> 3;
  const int row_qv = ((mi & 1) << 3) + lr, ch_qv = mi >> 1;
  const int row_k = ((mi >> 1) << 3) + lr, ch_k = mi & 1;
  const bf16* qb = q + n * q_sn + h * D;
  const bf16* db = dout + n * d_sn + h * D;
  const float* lse_bh = lse + ((long)n * heads + h) * sq;
  const float* di_bh = di + ((long)n * heads + h) * sq;
  const int C = heads * D;  // dq_acc / dk / dv are contiguous [N, S, heads*D]
  const int ntiles = (sq + BR - 1) / BR;
  const int kr0 = k0 + warp * 16 + g;  // this lane's key rows kr0 and kr0 + 8
  const bool key_tail = k0 + BR > sk;

  stage_tile(sm.k, k + n * k_sn + h * D, k_ss, k0, sk);
  stage_tile(sm.v, v + n * v_sn + h * D, v_ss, k0, sk);
  stage_tile(sm.q[0], qb, q_ss, 0, sq);
  stage_tile(sm.dout[0], db, d_ss, 0, sq);
  stage_stats(sm.lse[0], sm.di[0], lse_bh, di_bh, 0, sq);
  dct::cp_async_commit();

  uint32_t kf[4][4], vf[4][4];  // this warp's 16 key rows of k and v as A fragments
  float dk_acc[8][4], dv_acc[8][4];  // dk, dv: 16 key rows x 64 channels
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1, q0 = j * BR;
    dct::cp_async_wait<0>();
    __syncthreads();  // tile j landed; tile j-1 and its dsᵀ consumed by every warp
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int off = (warp * 16 + row_qv) * D + (((kk * 2 + ch_qv) ^ lr) << 3);
        dct::ldsm_x4(kf[kk], dct::smem_u32(sm.k + off));
        dct::ldsm_x4(vf[kk], dct::smem_u32(sm.v + off));
      }
    }
    if (j + 1 < ntiles) {
      stage_tile(sm.q[st ^ 1], qb, q_ss, q0 + BR, sq);
      stage_tile(sm.dout[st ^ 1], db, d_ss, q0 + BR, sq);
      stage_stats(sm.lse[st ^ 1], sm.di[st ^ 1], lse_bh, di_bh, q0 + BR, sq);
    }
    dct::cp_async_commit();
    const bf16* qs = sm.q[st];
    const bf16* dos = sm.dout[st];
    const bool ragged = key_tail || q0 + BR > sq;

    // four groups of 16 queries: sᵀ = k qᵀ and dpᵀ = v doᵀ (16 keys x 16
    // queries, two n8 tiles each) in registers, then pᵀ and dsᵀ, then one
    // key step of dv += pᵀ do and dk += dsᵀ q
#pragma unroll
    for (int jq = 0; jq < 4; ++jq) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b[4];
        const int off = (jq * 16 + row_k) * D + (((kk * 2 + ch_k) ^ lr) << 3);
        dct::ldsm_x4(b, dct::smem_u32(qs + off));
        dct::mma_bf16(s[0], kf[kk], b[0], b[1]);
        dct::mma_bf16(s[1], kf[kk], b[2], b[3]);
        dct::ldsm_x4(b, dct::smem_u32(dos + off));
        dct::mma_bf16(dp[0], vf[kk], b[0], b[1]);
        dct::mma_bf16(dp[1], vf[kk], b[2], b[3]);
      }
      // lane holds keys g (e = 0, 1) and g + 8 (e = 2, 3) at queries
      // jq·16 + 8i + 2t + (e & 1): lse2 and di are read by the columns
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = jq * 16 + i * 8 + 2 * t;
        const float2 lse2 = *reinterpret_cast<const float2*>(sm.lse[st] + c);
        const float2 dis = *reinterpret_cast<const float2*>(sm.di[st] + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[i][e] * scale_log2 - ((e & 1) ? lse2.y : lse2.x));
          if (ragged && (q0 + c + (e & 1) >= sq || kr0 + ((e >> 1) << 3) >= sk)) p = 0.f;
          s[i][e] = p;
          dp[i][e] = p * (dp[i][e] - ((e & 1) ? dis.y : dis.x)) * scale;
        }
        // dsᵀ rows (keys) g and g + 8 of this warp, 32-bit stores
        bf16* dst = sm.ds + (warp * 16 + g) * D + 2 * t;
        *reinterpret_cast<uint32_t*>(dst + (((jq * 2 + i) ^ g) << 3)) =
            dct::pack_bf16(dp[i][0], dp[i][1]);
        *reinterpret_cast<uint32_t*>(dst + 8 * D + (((jq * 2 + i) ^ g) << 3)) =
            dct::pack_bf16(dp[i][2], dp[i][3]);
      }
      const uint32_t pa[4] = {dct::pack_bf16(s[0][0], s[0][1]), dct::pack_bf16(s[0][2], s[0][3]),
                              dct::pack_bf16(s[1][0], s[1][1]), dct::pack_bf16(s[1][2], s[1][3])};
      const uint32_t da[4] = {dct::pack_bf16(dp[0][0], dp[0][1]), dct::pack_bf16(dp[0][2], dp[0][3]),
                              dct::pack_bf16(dp[1][0], dp[1][1]), dct::pack_bf16(dp[1][2], dp[1][3])};
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        uint32_t b[4];
        const int off = (jq * 16 + row_qv) * D + (((dd * 2 + ch_qv) ^ lr) << 3);
        dct::ldsm_x4_t(b, dct::smem_u32(dos + off));
        dct::mma_bf16(dv_acc[2 * dd], pa, b[0], b[1]);
        dct::mma_bf16(dv_acc[2 * dd + 1], pa, b[2], b[3]);
        dct::ldsm_x4_t(b, dct::smem_u32(qs + off));
        dct::mma_bf16(dk_acc[2 * dd], da, b[0], b[1]);
        dct::mma_bf16(dk_acc[2 * dd + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // dsᵀ complete

    // dq rows q0 + 16·warp.. += ds k over the block's 64 keys: ds as A
    // through ldmatrix.trans of dsᵀ, k as B through ldmatrix.trans
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      dct::ldsm_x4_t(a, dct::smem_u32(sm.ds + (kk * 16 + row_k) * D +
                                      (((warp * 2 + ch_k) ^ lr) << 3)));
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        uint32_t b[4];
        dct::ldsm_x4_t(b, dct::smem_u32(sm.k + (kk * 16 + row_qv) * D +
                                        (((dd * 2 + ch_qv) ^ lr) << 3)));
        dct::mma_bf16(acc[2 * dd], a, b[0], b[1]);
        dct::mma_bf16(acc[2 * dd + 1], a, b[2], b[3]);
      }
    }
    // into fp32 dq, 16 bytes per atomic: lanes t and t ^ 1 swap halves so
    // that an even t holds row g, columns 8i + 2t.. 2t + 3, and an odd t
    // row g + 8, columns 8i + 2t - 2.. 2t + 1
    const bool odd = t & 1;
    const int row = q0 + warp * 16 + g + (odd ? 8 : 0);
    float* dq_row = dq_acc + ((long)n * sq + row) * C + h * D + 2 * (t & 2);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float x = __shfl_xor_sync(0xffffffffu, odd ? acc[i][0] : acc[i][2], 1);
      const float y = __shfl_xor_sync(0xffffffffu, odd ? acc[i][1] : acc[i][3], 1);
      const float4 val = odd ? make_float4(x, y, acc[i][2], acc[i][3])
                             : make_float4(acc[i][0], acc[i][1], x, y);
      if (row < sq) atomicAdd(reinterpret_cast<float4*>(dq_row + i * 8), val);
    }
  }

  // dk and dv rows kr0 and kr0 + 8
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = kr0 + 8 * half;
    if (r >= sk) continue;
    if constexpr (Ring) {
      float* dk_row = dkv_acc + ((long)n * sk + r) * 2 * C + h * D + 2 * t;
      float* dv_row = dk_row + C;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        add_f2(dk_row + i * 8, dk_acc[i][2 * half], dk_acc[i][2 * half + 1]);
        add_f2(dv_row + i * 8, dv_acc[i][2 * half], dv_acc[i][2 * half + 1]);
      }
      continue;
    }
    bf16* dk_row = dk + ((long)n * sk + r) * C + h * D + 2 * t;
    bf16* dv_row = dv + ((long)n * sk + r) * C + h * D + 2 * t;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<uint32_t*>(dk_row + i * 8) =
          dct::pack_bf16(dk_acc[i][2 * half], dk_acc[i][2 * half + 1]);
      *reinterpret_cast<uint32_t*>(dv_row + i * 8) =
          dct::pack_bf16(dv_acc[i][2 * half], dv_acc[i][2 * half + 1]);
    }
  }
}

}  // namespace

namespace {

template <bool StateIn, bool StateOut>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, void* m, void* l,
               void* acc, int batch, int heads, int sq, int sk, long q_sn, long q_ss, long k_sn,
               long k_ss, long v_sn, long v_ss, long o_sn, long o_ss, float scale, void* stream) {
  const int smem = sizeof(FwdSmem);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<StateIn, StateOut>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BR - 1) / BR, heads, batch);
  flash_fwd_kernel<StateIn, StateOut><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, (float*)m,
      (float*)l, (float*)acc, sq, sk, heads, q_sn, q_ss, k_sn, k_ss, v_sn, v_ss, o_sn, o_ss,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// the di pre-pass, then the backward kernel
template <bool Ring>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* di, void* dq_acc, void* dk, void* dv, void* dkv_acc,
               int batch, int heads, int sq, int sk, long q_sn, long q_ss, long k_sn, long k_ss,
               long v_sn, long v_ss, long o_sn, long o_ss, long d_sn, long d_ss, bool with_di,
               float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (with_di) {
    const long rows = (long)batch * heads * sq;
    const int rows_per_block = 8;
    flash_bwd_di_kernel<<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                          rows_per_block * 32, 0, st>>>((const bf16*)o, (const bf16*)dout,
                                                        (float*)di, rows, sq, heads, o_sn, o_ss,
                                                        d_sn, d_ss);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int smem = sizeof(BwdSmem);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<Ring>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sk + BR - 1) / BR, heads, batch);
  flash_bwd_kernel<Ring><<<grid, NTHREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)di, (float*)dq_acc, (bf16*)dk, (bf16*)dv, (float*)dkv_acc, sq, sk, heads,
      q_sn, q_ss, k_sn, k_ss, v_sn, v_ss, d_sn, d_ss, scale, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dct_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int batch, int heads, int sq, int sk, long q_sn, long q_ss,
                             long k_sn, long k_ss, long v_sn, long v_ss, long o_sn, long o_ss,
                             float scale, void* stream) {
  return launch_fwd<false, false>(q, k, v, o, lse, nullptr, nullptr, nullptr, batch, heads, sq,
                                  sk, q_sn, q_ss, k_sn, k_ss, v_sn, v_ss, o_sn, o_ss, scale,
                                  stream);
}

// One step of the ring's forward: state_in reads (m, l, acc), state_out
// writes them (in place: each lane reads and writes only its own rows);
// without state_out the step writes o and lse2.
extern "C" int dct_flash_fwd_ring(const void* q, const void* k, const void* v, void* o,
                                  void* lse, void* m, void* l, void* acc, int batch, int heads,
                                  int sq, int sk, long q_sn, long q_ss, long k_sn, long k_ss,
                                  long v_sn, long v_ss, long o_sn, long o_ss, int state_in,
                                  int state_out, float scale, void* stream) {
  auto launch = state_in ? (state_out ? launch_fwd<true, true> : launch_fwd<true, false>)
                         : (state_out ? launch_fwd<false, true> : launch_fwd<false, false>);
  return launch(q, k, v, o, lse, m, l, acc, batch, heads, sq, sk, q_sn, q_ss, k_sn, k_ss, v_sn,
                v_ss, o_sn, o_ss, scale, stream);
}

extern "C" int dct_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, void* di, void* dq_acc,
                             void* dk, void* dv, int batch, int heads, int sq, int sk,
                             long q_sn, long q_ss, long k_sn, long k_ss, long v_sn, long v_ss,
                             long o_sn, long o_ss, long d_sn, long d_ss, float scale,
                             void* stream) {
  return launch_bwd<false>(q, k, v, o, dout, lse, di, dq_acc, dk, dv, nullptr, batch, heads, sq,
                           sk, q_sn, q_ss, k_sn, k_ss, v_sn, v_ss, o_sn, o_ss, d_sn, d_ss, true,
                           scale, stream);
}

// One step of the ring's backward: dq and the travelling dk|dv (fp32,
// zeroed by the caller before the first step) gain this key block's part;
// the first step also computes di, which o and dout fix for every step.
extern "C" int dct_flash_bwd_ring(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, void* di, void* dq_acc,
                                  void* dkv_acc, int batch, int heads, int sq, int sk, long q_sn,
                                  long q_ss, long k_sn, long k_ss, long v_sn, long v_ss,
                                  long o_sn, long o_ss, long d_sn, long d_ss, int first,
                                  float scale, void* stream) {
  return launch_bwd<true>(q, k, v, o, dout, lse, di, dq_acc, nullptr, nullptr, dkv_acc, batch,
                          heads, sq, sk, q_sn, q_ss, k_sn, k_ss, v_sn, v_ss, o_sn, o_ss, d_sn,
                          d_ss, first != 0, scale, stream);
}

// ===========================================================================
// Head dim 512: the KL VAE's mid attention (one head, S = 6912 at res 768).
//
// What bounds it: 4·S²·512 FLOP forward (98 GFLOP at S=6912) against
// 4·S·512·2 bytes of q/k/v/o: the tensor cores, by far. What changes from
// d=64 is the size of the per-row state: a 64-row fp32 output accumulator is
// 128 KB, half the SM's register file.
//
// Forward (flash_fwd_d512_kernel), mma.sync with the softmax on the
// fragments as at d=64. A block of 8 warps owns 64 query rows (108 blocks
// at S=6912: one wave on 82% of the SMs; 32-row blocks made 216, two waves,
// and read k and v 216 times). The output columns are split over a warp
// pair: warps 2p and 2p+1 share query rows 16p.., each contracts s = q·kᵀ
// over its half of the 512 channels (16 k-steps, q and k through
// ldmatrix), the pair swaps the 16x32 partial score fragments through
// shared memory (lane-major float4, a named barrier of 64 threads), both
// add them (the same sum in both: IEEE addition commutes) and run the same
// online softmax; each then holds o for its 256 channels, 128 fp32
// registers a lane, rescaled by α in place, and adds p·v with p's C
// fragments repacked as A and v through ldmatrix.trans. Chosen over each
// warp recomputing the full q·kᵀ for its rows (1.5x the FLOP and twice the
// k reads) for the price of 4 KB of stores and loads per warp pair and one
// pair barrier per key tile. K and V come in 32-key tiles (32 KB each)
// through a two-stage cp.async ring beside the 64 KB q tile: 208 KB of
// shared memory, one block per SM; ptxas gives 229 registers, 0 bytes of
// spill. 512-column rows are swizzled within each group of eight 16-byte
// chunks (swz512).
//
// Backward (flash_bwd_d512_kernel), mma.sync with sᵀ, dpᵀ, pᵀ and dsᵀ on
// accumulator fragments, as flash_bwd_kernel. The constraint is registers:
// dk and dv for 32 keys x 512 channels are 128 KB of fp32, half the SM's
// register file (64 keys would need all of it). So a block of 8 warps owns
// 32 key rows and each warp holds 64 columns of dk and dv for all 32 (128
// fp32 registers a lane), walking the queries in 32-row tiles. Per tile:
// warps 0-3 form sᵀ = k·qᵀ and warps 4-7 dpᵀ = v·doᵀ, each a 16-key x
// 16-query quarter contracted over all 512 channels (k/v as A, q/do as B
// through ldmatrix); warps w + 4 hand their dpᵀ fragments to warps w
// through shared memory (lane-major float4, a 64-thread named barrier),
// which form pᵀ = exp2(sᵀ·scale·log2e − lse2) and dsᵀ = pᵀ∘(dpᵀ − di)·scale
// and store both as bf16 tiles (80-byte rows: the eight rows of one
// ldmatrix in distinct banks). After one barrier every warp adds dv += pᵀ·do
// and dk += dsᵀ·q over its 64 columns (pᵀ, dsᵀ as A; do, q through
// ldmatrix.trans). Q, dO and their lse2/di slices arrive through a
// two-stage cp.async ring (swz512 rows), K and V once. 32 KB each for k
// and v, 128 KB for the q/do ring, 9 KB for pᵀ, dsᵀ and the hand-over:
// one block per SM, 216 blocks at S=6912 (1.64 waves on 132 SMs).
//
// dq, reckoned both ways at S=6912 (PERF.md, Findings, has the times):
//  1. one pass (kDq): per tile each warp also forms dq = ds·k for the
//     tile's 32 queries over its 64 columns (dsᵀ and k through
//     ldmatrix.trans), in two 16-query halves of 32 registers, and adds it
//     into fp32 dq with float4 atomics (lanes t, t^1 swap halves, as
//     flash_bwd_kernel): 216 key blocks x 6912 rows x 512 channels / 4 =
//     191M 16-byte reductions into L2, in place of the first form's 764M
//     scalar ones. Per warp and tile: 160 mma against 108 ldmatrix.x4.
//     Built only by scripts/kernel_ab_variants.cu, for the comparison.
//  2. two kernels, no atomics, as JAX's _bwd_dkv_kernel / _bwd_dq_kernel
//     (what dct_flash_bwd_d512 runs): this kernel without dq (128 mma, 88
//     ldmatrix.x4), then flash_bwd_dq_d512_kernel over 64-row query blocks
//     (below): 7 products for 5, +40% FLOP (the bound from 0.2473 to 0.346
//     ms), but no atomics, and the dq kernel's 108 blocks are one wave. On
//     an H100 the atomics cost more than the recomputed products do.
// ===========================================================================

namespace {

constexpr int HD5 = 512;         // head dim
constexpr int NW5 = 8;           // warps per block
constexpr int NT5 = NW5 * 32;
constexpr int BK5 = 32;          // backward: key rows per block
constexpr int BQ5 = 32;          // backward: query rows per tile
constexpr int LDP5 = BQ5 + 8;    // backward: bf16 row stride of the pᵀ and dsᵀ tiles (80 B)

constexpr int FQ5 = 64;          // forward: query rows per block (16 per warp pair)
constexpr int FK5 = 32;          // forward: key rows per tile
constexpr int HALF5 = HD5 / 2;   // forward: a warp's half of the channels

// Element offset of 16-byte chunk `chunk` (0-63) of row `row` in a 512-column
// bf16 tile whose chunks are XORed with row % 8 (within their group of
// eight): the eight rows one ldmatrix reads sit in eight distinct bank groups
__device__ __forceinline__ int swz512(int row, int chunk) {
  return row * HD5 + ((chunk ^ (row & 7)) << 3);
}

// cp.async rows [row0, row0 + rows) x 512 channels of a strided bf16 matrix
// into a swizzled tile; rows at or past nrows are zero-filled
__device__ __forceinline__ void stage_rows512(bf16* dst, const bf16* src, long row_stride,
                                              int row0, int nrows, int rows) {
  for (int i = threadIdx.x; i < rows * (HD5 / 8); i += NT5) {
    const int r = i >> 6, c = i & 63;
    const bool ok = row0 + r < nrows;
    dct::cp_async_16(dct::smem_u32(dst + swz512(r, c)),
                     ok ? src + (long)(row0 + r) * row_stride + c * 8 : src, ok);
  }
}

// the two warps of pair `id - 1` (barrier 0 is __syncthreads)
__device__ __forceinline__ void bar_pair(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

struct Fwd512Smem {
  bf16 q[FQ5 * HD5];
  bf16 k[2][FK5 * HD5];  // two-stage cp.async ring: tile j+1 lands while tile j is used
  bf16 v[2][FK5 * HD5];
  float4 xch[NW5][FK5 / 8][32];  // each warp's partial score fragments, lane-major
};
static_assert(sizeof(Fwd512Smem) <= 232448, "forward tiles exceed shared memory");

__global__ void __launch_bounds__(NT5, 1)
flash_fwd_d512_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int sq, int sk, int heads,
                      long q_sn, long q_ss, long k_sn, long k_ss, long v_sn, long v_ss,
                      long o_sn, long o_ss, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Fwd512Smem& sm = *reinterpret_cast<Fwd512Smem*>(smem_raw);
  const int q0 = blockIdx.x * FQ5, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, mi = lane >> 3;  // ldmatrix addressing as in flash_fwd_kernel
  const int row_qv = ((mi & 1) << 3) + lr, ch_qv = mi >> 1;
  const int row_k = ((mi >> 1) << 3) + lr, ch_k = mi & 1;
  const int pair = warp >> 1, half = warp & 1;  // query rows 16·pair.., channels 256·half..
  const int c0 = half * (HALF5 / 8);            // this warp's first 16-byte chunk
  const bf16* kb = k + n * k_sn + (long)h * HD5;
  const bf16* vb = v + n * v_sn + (long)h * HD5;
  const int ntiles = (sk + FK5 - 1) / FK5;

  stage_rows512(sm.q, q + n * q_sn + (long)h * HD5, q_ss, q0, sq, FQ5);
  stage_rows512(sm.k[0], kb, k_ss, 0, sk, FK5);
  stage_rows512(sm.v[0], vb, v_ss, 0, sk, FK5);
  dct::cp_async_commit();

  float o_acc[32][4];  // o: 16 rows x this warp's 256 channels (32 n8 tiles)
#pragma unroll
  for (int i = 0; i < 32; ++i) o_acc[i][0] = o_acc[i][1] = o_acc[i][2] = o_acc[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8 (log2 domain)
  float sum0 = 0.f, sum1 = 0.f;          // this lane's part of their row sums

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    dct::cp_async_wait<0>();
    __syncthreads();  // tile j landed for every thread; tile j-1 and the partials consumed
    if (j + 1 < ntiles) {
      stage_rows512(sm.k[st ^ 1], kb, k_ss, (j + 1) * FK5, sk, FK5);
      stage_rows512(sm.v[st ^ 1], vb, v_ss, (j + 1) * FK5, sk, FK5);
    }
    dct::cp_async_commit();
    const bf16* ks = sm.k[st];
    const bf16* vs = sm.v[st];

    // this warp's half of the contraction of s = q kᵀ: 16 rows x 32 keys
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HALF5 / 16; ++kk) {
      uint32_t a[4];
      dct::ldsm_x4(a, dct::smem_u32(sm.q + swz512(pair * 16 + row_qv, c0 + kk * 2 + ch_qv)));
#pragma unroll
      for (int jp = 0; jp < FK5 / 16; ++jp) {
        uint32_t b[4];
        dct::ldsm_x4(b, dct::smem_u32(ks + swz512(jp * 16 + row_k, c0 + kk * 2 + ch_k)));
        dct::mma_bf16(s[2 * jp], a, b[0], b[1]);
        dct::mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
      }
    }
    // the pair adds the other half: same fragment layout, so lane l reads
    // lane l's partial of the other warp; both then hold the same s
#pragma unroll
    for (int i = 0; i < 4; ++i) sm.xch[warp][i][lane] = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    bar_pair(1 + pair);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 other = sm.xch[warp ^ 1][i][lane];
      s[i][0] += other.x;
      s[i][1] += other.y;
      s[i][2] += other.z;
      s[i][3] += other.w;
    }

    // online softmax on the fragments, as in flash_fwd_kernel
    const int kcol = j * FK5 + 2 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] *= scale_log2;
    if ((j + 1) * FK5 > sk) {  // the ragged last tile: keys at or past sk score -inf
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kcol + i * 8 + (e & 1) >= sk) s[i][e] = -INFINITY;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[i][0], s[i][1]));
      mx1 = fmaxf(mx1, fmaxf(s[i][2], s[i][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i][0] = exp2f(s[i][0] - m0);
      s[i][1] = exp2f(s[i][1] - m0);
      s[i][2] = exp2f(s[i][2] - m1);
      s[i][3] = exp2f(s[i][3] - m1);
      ps0 += s[i][0] + s[i][1];
      ps1 += s[i][2] + s[i][3];
    }
    sum0 = sum0 * alpha0 + ps0;
    sum1 = sum1 * alpha1 + ps1;
    rescale(o_acc, alpha0, alpha1);

    // o += p v over this warp's 256 channels, v through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < FK5 / 16; ++kk) {
      const uint32_t pa[4] = {dct::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              dct::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              dct::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              dct::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HALF5 / 16; ++dp) {
        uint32_t b[4];
        dct::ldsm_x4_t(b, dct::smem_u32(vs + swz512(kk * 16 + row_qv, c0 + dp * 2 + ch_qv)));
        dct::mma_bf16(o_acc[2 * dp], pa, b[0], b[1]);
        dct::mma_bf16(o_acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  }

  // full row sums from the quad (every row saw key 0: sums >= 1); o = acc / sum
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
  const int r0 = q0 + pair * 16 + g, r1 = r0 + 8;
  float* lse_bh = lse + ((long)n * heads + h) * sq;
  if (r0 < sq) {
    bf16* orow = o + n * o_sn + (long)r0 * o_ss + (long)h * HD5 + half * HALF5 + 2 * t;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      *reinterpret_cast<uint32_t*>(orow + i * 8) =
          dct::pack_bf16(o_acc[i][0] * inv0, o_acc[i][1] * inv0);
    if (half == 0 && t == 0) lse_bh[r0] = m0 + log2f(sum0);
  }
  if (r1 < sq) {
    bf16* orow = o + n * o_sn + (long)r1 * o_ss + (long)h * HD5 + half * HALF5 + 2 * t;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      *reinterpret_cast<uint32_t*>(orow + i * 8) =
          dct::pack_bf16(o_acc[i][2] * inv1, o_acc[i][3] * inv1);
    if (half == 0 && t == 0) lse_bh[r1] = m1 + log2f(sum1);
  }
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
  bf16 k[BK5 * HD5];  // the block's 32 key rows (swz512), loaded once
  bf16 v[BK5 * HD5];
  bf16 q[2][BQ5 * HD5];  // two-stage cp.async ring: tile j+1 lands while tile j is used
  bf16 dout[2][BQ5 * HD5];
  bf16 pt[BK5 * LDP5];  // pᵀ of the current query tile: [key][query]
  bf16 dst[BK5 * LDP5];  // dsᵀ
  float4 xch[4][2][32];  // dpᵀ fragments of warps 4-7, lane-major
  float lse[2][BQ5];
  float di[2][BQ5];
};
static_assert(sizeof(Bwd512Smem) <= 232448, "backward tiles exceed shared memory");

// cp.async the fp32 statistics of query rows [row0, row0 + 32) (lse2 by
// threads 0-31, di by 32-63); rows at or past nrows are zero-filled
__device__ __forceinline__ void stage_stats512(float* lse_dst, float* di_dst, const float* lse_row,
                                               const float* di_row, int row0, int nrows) {
  if (threadIdx.x >= 2 * BQ5) return;
  const int i = threadIdx.x & (BQ5 - 1);
  const bool ok = row0 + i < nrows;
  const float* src = threadIdx.x < BQ5 ? lse_row : di_row;
  float* dst = threadIdx.x < BQ5 ? lse_dst : di_dst;
  dct::cp_async_4(dct::smem_u32(dst + i), ok ? src + row0 + i : src, ok);
}

// kDq: dq by float4 atomics in the same pass (design 1 of the note above);
// without it the kernel computes dk and dv only (design 2's first kernel)
template <bool kDq>
__global__ void __launch_bounds__(NT5, 1)
flash_bwd_d512_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ di,
                      float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                      int sq, int sk, int heads, long q_sn, long q_ss, long k_sn, long k_ss,
                      long v_sn, long v_ss, long d_sn, long d_ss, float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Bwd512Smem& sm = *reinterpret_cast<Bwd512Smem*>(smem_raw);
  const int k0 = blockIdx.x * BK5, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, mi = lane >> 3;  // ldmatrix addressing as in flash_bwd_kernel
  const int row_qv = ((mi & 1) << 3) + lr, ch_qv = mi >> 1;
  const int row_k = ((mi >> 1) << 3) + lr, ch_k = mi & 1;
  const bf16* qb = q + n * q_sn + (long)h * HD5;
  const bf16* db = dout + n * d_sn + (long)h * HD5;
  const float* lse_bh = lse + ((long)n * heads + h) * sq;
  const float* di_bh = di + ((long)n * heads + h) * sq;
  const long C = (long)heads * HD5;  // dq_acc / dk / dv are contiguous [N, S, heads*512]
  const int ntiles = (sq + BQ5 - 1) / BQ5;
  const int c0 = warp * 8;  // this warp's first 16-byte chunk: columns 64·warp..
  // score quarter of this warp: sᵀ (warps 0-3) or dpᵀ (4-7), keys 16·kh..,
  // queries 16·qh.. of the tile
  const bool is_dp = warp >= 4;
  const int kh = (warp >> 1) & 1, qh = warp & 1;
  const bf16* a_src = is_dp ? sm.v : sm.k;

  stage_rows512(sm.k, k + n * k_sn + (long)h * HD5, k_ss, k0, sk, BK5);
  stage_rows512(sm.v, v + n * v_sn + (long)h * HD5, v_ss, k0, sk, BK5);
  stage_rows512(sm.q[0], qb, q_ss, 0, sq, BQ5);
  stage_rows512(sm.dout[0], db, d_ss, 0, sq, BQ5);
  stage_stats512(sm.lse[0], sm.di[0], lse_bh, di_bh, 0, sq);
  dct::cp_async_commit();

  float dk_acc[2][8][4], dv_acc[2][8][4];  // keys 16m + g (+8), columns 64·warp + 8i + 2t
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[m][i][e] = dv_acc[m][i][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1, q0 = j * BQ5;
    dct::cp_async_wait<0>();
    __syncthreads();  // tile j landed; tile j-1, its pᵀ and dsᵀ consumed by every warp
    if (j + 1 < ntiles) {
      stage_rows512(sm.q[st ^ 1], qb, q_ss, q0 + BQ5, sq, BQ5);
      stage_rows512(sm.dout[st ^ 1], db, d_ss, q0 + BQ5, sq, BQ5);
      stage_stats512(sm.lse[st ^ 1], sm.di[st ^ 1], lse_bh, di_bh, q0 + BQ5, sq);
    }
    dct::cp_async_commit();
    const bf16* qs = sm.q[st];
    const bf16* dos = sm.dout[st];

    // this warp's quarter of sᵀ or dpᵀ: 16 keys x 16 queries over 512 channels
    float c[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
    const bf16* b_src = is_dp ? dos : qs;
#pragma unroll 8
    for (int kk = 0; kk < HD5 / 16; ++kk) {
      uint32_t a[4], b[4];
      dct::ldsm_x4(a, dct::smem_u32(a_src + swz512(kh * 16 + row_qv, kk * 2 + ch_qv)));
      dct::ldsm_x4(b, dct::smem_u32(b_src + swz512(qh * 16 + row_k, kk * 2 + ch_k)));
      dct::mma_bf16(c[0], a, b[0], b[1]);
      dct::mma_bf16(c[1], a, b[2], b[3]);
    }
    if (is_dp) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        sm.xch[warp - 4][i][lane] = make_float4(c[i][0], c[i][1], c[i][2], c[i][3]);
    }
    bar_pair(1 + (warp & 3));  // warps w and w + 4
    if (!is_dp) {
      // lane holds keys kh·16 + g (e = 0, 1) and + 8 (e = 2, 3) at queries
      // qh·16 + 8i + 2t + (e & 1): lse2 and di are read by the columns
      const int kr = k0 + kh * 16 + g;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qc = qh * 16 + i * 8 + 2 * t;
        const float2 lse2 = *reinterpret_cast<const float2*>(sm.lse[st] + qc);
        const float2 dis = *reinterpret_cast<const float2*>(sm.di[st] + qc);
        const float4 dpv = sm.xch[warp][i][lane];
        const float dpe[4] = {dpv.x, dpv.y, dpv.z, dpv.w};
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = exp2f(c[i][e] * scale_log2 - ((e & 1) ? lse2.y : lse2.x));
          if (q0 + qc + (e & 1) >= sq || kr + ((e >> 1) << 3) >= sk) pe = 0.f;
          p[e] = pe;
          ds[e] = pe * (dpe[e] - ((e & 1) ? dis.y : dis.x)) * scale;
        }
        const int off = (kh * 16 + g) * LDP5 + qc;
        *reinterpret_cast<uint32_t*>(sm.pt + off) = dct::pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(sm.pt + off + 8 * LDP5) = dct::pack_bf16(p[2], p[3]);
        *reinterpret_cast<uint32_t*>(sm.dst + off) = dct::pack_bf16(ds[0], ds[1]);
        *reinterpret_cast<uint32_t*>(sm.dst + off + 8 * LDP5) = dct::pack_bf16(ds[2], ds[3]);
      }
    }
    __syncthreads();  // pᵀ and dsᵀ complete

    // dv += pᵀ do and dk += dsᵀ q over this warp's 64 columns, 16 queries a step
#pragma unroll
    for (int kk = 0; kk < BQ5 / 16; ++kk) {
      uint32_t pa[2][4], da[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int off = (m * 16 + row_qv) * LDP5 + (kk * 2 + ch_qv) * 8;
        dct::ldsm_x4(pa[m], dct::smem_u32(sm.pt + off));
        dct::ldsm_x4(da[m], dct::smem_u32(sm.dst + off));
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        const int off = swz512(kk * 16 + row_qv, c0 + np * 2 + ch_qv);
        dct::ldsm_x4_t(b, dct::smem_u32(dos + off));
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          dct::mma_bf16(dv_acc[m][2 * np], pa[m], b[0], b[1]);
          dct::mma_bf16(dv_acc[m][2 * np + 1], pa[m], b[2], b[3]);
        }
        dct::ldsm_x4_t(b, dct::smem_u32(qs + off));
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          dct::mma_bf16(dk_acc[m][2 * np], da[m], b[0], b[1]);
          dct::mma_bf16(dk_acc[m][2 * np + 1], da[m], b[2], b[3]);
        }
      }
    }

    if constexpr (kDq) {
      // dq rows q0 + 16·mq.., columns 64·warp.. += ds k over the block's 32
      // keys: ds as A through ldmatrix.trans of dsᵀ, k as B through .trans
#pragma unroll
      for (int mq = 0; mq < BQ5 / 16; ++mq) {
        float acc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BK5 / 16; ++kk) {
          uint32_t a[4];
          dct::ldsm_x4_t(a, dct::smem_u32(sm.dst + (kk * 16 + row_k) * LDP5 + (mq * 2 + ch_k) * 8));
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t b[4];
            dct::ldsm_x4_t(b, dct::smem_u32(sm.k + swz512(kk * 16 + row_qv, c0 + np * 2 + ch_qv)));
            dct::mma_bf16(acc[2 * np], a, b[0], b[1]);
            dct::mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
          }
        }
        // into fp32 dq, 16 bytes per atomic (the lane pairing of flash_bwd_kernel)
        const bool odd = t & 1;
        const int qr = q0 + mq * 16 + g + (odd ? 8 : 0);
        float* dq_row = dq_acc + ((long)n * sq + qr) * C + (long)h * HD5 + warp * 64 + 2 * (t & 2);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x = __shfl_xor_sync(0xffffffffu, odd ? acc[i][0] : acc[i][2], 1);
          const float y = __shfl_xor_sync(0xffffffffu, odd ? acc[i][1] : acc[i][3], 1);
          const float4 val = odd ? make_float4(x, y, acc[i][2], acc[i][3])
                                 : make_float4(acc[i][0], acc[i][1], x, y);
          if (qr < sq) atomicAdd(reinterpret_cast<float4*>(dq_row + i * 8), val);
        }
      }
    }
  }

  // dk and dv: keys k0 + 16m + g (+8), this warp's 64 columns
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = k0 + m * 16 + g + 8 * half;
      if (r >= sk) continue;
      bf16* dk_row = dk + ((long)n * sk + r) * C + (long)h * HD5 + warp * 64 + 2 * t;
      bf16* dv_row = dv + ((long)n * sk + r) * C + (long)h * HD5 + warp * 64 + 2 * t;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        *reinterpret_cast<uint32_t*>(dk_row + i * 8) =
            dct::pack_bf16(dk_acc[m][i][2 * half], dk_acc[m][i][2 * half + 1]);
        *reinterpret_cast<uint32_t*>(dv_row + i * 8) =
            dct::pack_bf16(dv_acc[m][i][2 * half], dv_acc[m][i][2 * half + 1]);
      }
    }
}

// dq of the d=512 backward (design 2 of the note above): 64 query rows per
// block, warps 2p and 2p+1 on rows 16p.., each contracting q·kᵀ and do·vᵀ
// over its half of the channels; the pair swaps the 16x32 partial
// fragments of both through shared memory and both form ds = p∘(dp −
// di)·scale on the fragments; each warp then holds dq for its 256 channels
// and adds ds·k (ds's C fragments repacked as A, k through ldmatrix.trans).
// The q and do tiles (64 KB each) stay for the whole key loop, so K and V
// have one 32-key buffer each (32 KB), refilled as soon as every warp is
// done with it: V(j+1) lands while s and dq of tile j run, K(j+1) while dp
// of tile j+1 runs. Per warp and tile: 192 mma against 128 ldmatrix.x4.
constexpr int DQ_Q = 64;  // dq kernel: query rows per block (16 per warp pair)
constexpr int DQ_K = 32;  // dq kernel: key rows per tile

struct Dq512Smem {
  bf16 q[DQ_Q * HD5];
  bf16 dout[DQ_Q * HD5];
  bf16 k[DQ_K * HD5];
  bf16 v[DQ_K * HD5];
  float4 xs[NW5][DQ_K / 8][32];   // each warp's partial s fragments, lane-major
  float4 xdp[NW5][DQ_K / 8][32];  // and its partial dp fragments
};
static_assert(sizeof(Dq512Smem) <= 232448, "dq tiles exceed shared memory");

__global__ void __launch_bounds__(NT5, 1)
flash_bwd_dq_d512_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         float* __restrict__ dq, int sq, int sk, int heads, long q_sn, long q_ss,
                         long k_sn, long k_ss, long v_sn, long v_ss, long d_sn, long d_ss,
                         float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Dq512Smem& sm = *reinterpret_cast<Dq512Smem*>(smem_raw);
  const int q0 = blockIdx.x * DQ_Q, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, mi = lane >> 3;  // ldmatrix addressing as in flash_fwd_kernel
  const int row_qv = ((mi & 1) << 3) + lr, ch_qv = mi >> 1;
  const int row_k = ((mi >> 1) << 3) + lr, ch_k = mi & 1;
  const int pair = warp >> 1, half = warp & 1;  // query rows 16·pair.., channels 256·half..
  const int c0 = half * (HALF5 / 8);
  const bf16* kb = k + n * k_sn + (long)h * HD5;
  const bf16* vb = v + n * v_sn + (long)h * HD5;
  const int ntiles = (sk + DQ_K - 1) / DQ_K;

  // groups in flight: (q, do, V(0)), then K(0); per tile one V and one K group
  stage_rows512(sm.q, q + n * q_sn + (long)h * HD5, q_ss, q0, sq, DQ_Q);
  stage_rows512(sm.dout, dout + n * d_sn + (long)h * HD5, d_ss, q0, sq, DQ_Q);
  stage_rows512(sm.v, vb, v_ss, 0, sk, DQ_K);
  dct::cp_async_commit();
  stage_rows512(sm.k, kb, k_ss, 0, sk, DQ_K);
  dct::cp_async_commit();

  const int r0 = q0 + pair * 16 + g, r1 = r0 + 8;
  const long stat = ((long)n * heads + h) * sq;
  const float lse0 = r0 < sq ? lse[stat + r0] : 0.f, lse1 = r1 < sq ? lse[stat + r1] : 0.f;
  const float di0 = r0 < sq ? di[stat + r0] : 0.f, di1 = r1 < sq ? di[stat + r1] : 0.f;
  float acc[32][4];  // dq: 16 rows x this warp's 256 channels
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    dct::cp_async_wait<1>();
    __syncthreads();  // V(j) landed for every thread

    // this warp's half of dp = do vᵀ: 16 rows x 32 keys
    float dp[4][4], s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[i][e] = s[i][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < HALF5 / 16; ++kk) {
      uint32_t a[4];
      dct::ldsm_x4(a, dct::smem_u32(sm.dout + swz512(pair * 16 + row_qv, c0 + kk * 2 + ch_qv)));
#pragma unroll
      for (int jp = 0; jp < DQ_K / 16; ++jp) {
        uint32_t b[4];
        dct::ldsm_x4(b, dct::smem_u32(sm.v + swz512(jp * 16 + row_k, c0 + kk * 2 + ch_k)));
        dct::mma_bf16(dp[2 * jp], a, b[0], b[1]);
        dct::mma_bf16(dp[2 * jp + 1], a, b[2], b[3]);
      }
    }
    dct::cp_async_wait<0>();
    __syncthreads();  // every warp done with V(j); K(j) landed for every thread
    if (j + 1 < ntiles) stage_rows512(sm.v, vb, v_ss, (j + 1) * DQ_K, sk, DQ_K);
    dct::cp_async_commit();

    // this warp's half of s = q kᵀ
#pragma unroll 4
    for (int kk = 0; kk < HALF5 / 16; ++kk) {
      uint32_t a[4];
      dct::ldsm_x4(a, dct::smem_u32(sm.q + swz512(pair * 16 + row_qv, c0 + kk * 2 + ch_qv)));
#pragma unroll
      for (int jp = 0; jp < DQ_K / 16; ++jp) {
        uint32_t b[4];
        dct::ldsm_x4(b, dct::smem_u32(sm.k + swz512(jp * 16 + row_k, c0 + kk * 2 + ch_k)));
        dct::mma_bf16(s[2 * jp], a, b[0], b[1]);
        dct::mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
      }
    }
    // the pair adds the other half of both (lane l reads lane l's partials)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sm.xs[warp][i][lane] = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      sm.xdp[warp][i][lane] = make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
    }
    bar_pair(1 + pair);
    const int kcol = j * DQ_K + 2 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 os = sm.xs[warp ^ 1][i][lane], od = sm.xdp[warp ^ 1][i][lane];
      const float sa[4] = {s[i][0] + os.x, s[i][1] + os.y, s[i][2] + os.z, s[i][3] + os.w};
      const float da[4] = {dp[i][0] + od.x, dp[i][1] + od.y, dp[i][2] + od.z, dp[i][3] + od.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = exp2f(sa[e] * scale_log2 - (e < 2 ? lse0 : lse1));
        if (kcol + i * 8 + (e & 1) >= sk) pe = 0.f;
        s[i][e] = pe * (da[e] - (e < 2 ? di0 : di1)) * scale;  // ds
      }
    }
    // dq += ds k over this warp's 256 channels: ds's C fragments of key
    // tiles 2kk and 2kk+1 are the A fragment of key step kk
#pragma unroll
    for (int kk = 0; kk < DQ_K / 16; ++kk) {
      const uint32_t pa[4] = {dct::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              dct::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              dct::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              dct::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dd = 0; dd < HALF5 / 16; ++dd) {
        uint32_t b[4];
        dct::ldsm_x4_t(b, dct::smem_u32(sm.k + swz512(kk * 16 + row_qv, c0 + dd * 2 + ch_qv)));
        dct::mma_bf16(acc[2 * dd], pa, b[0], b[1]);
        dct::mma_bf16(acc[2 * dd + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp done with K(j) and the partials
    if (j + 1 < ntiles) stage_rows512(sm.k, kb, k_ss, (j + 1) * DQ_K, sk, DQ_K);
    dct::cp_async_commit();
  }

  const long C = (long)heads * HD5;  // dq is contiguous [N, S, heads*512], written here
  if (r0 < sq) {
    float* row = dq + ((long)n * sq + r0) * C + (long)h * HD5 + half * HALF5 + 2 * t;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      *reinterpret_cast<float2*>(row + i * 8) = make_float2(acc[i][0], acc[i][1]);
  }
  if (r1 < sq) {
    float* row = dq + ((long)n * sq + r1) * C + (long)h * HD5 + half * HALF5 + 2 * t;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      *reinterpret_cast<float2*>(row + i * 8) = make_float2(acc[i][2], acc[i][3]);
  }
}

// the di pre-pass of the d=512 backward
int launch_di512(const void* o, const void* dout, void* di, int batch, int heads, int sq,
                 long o_sn, long o_ss, long d_sn, long d_ss, cudaStream_t st) {
  const long rows = (long)batch * heads * sq;
  const int rows_per_block = 8;
  flash_bwd_di_d512_kernel<<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                             rows_per_block * 32, 0, st>>>((const bf16*)o, (const bf16*)dout,
                                                           (float*)di, rows, sq, heads, o_sn,
                                                           o_ss, d_sn, d_ss);
  return (int)cudaGetLastError();
}

template <bool kDq>
int launch_bwd512(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* di, void* dq_acc, void* dk, void* dv, int batch, int heads, int sq,
                  int sk, long q_sn, long q_ss, long k_sn, long k_ss, long v_sn, long v_ss,
                  long d_sn, long d_ss, float scale, cudaStream_t st) {
  const int smem = sizeof(Bwd512Smem);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_d512_kernel<kDq>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sk + BK5 - 1) / BK5, heads, batch);
  flash_bwd_d512_kernel<kDq><<<grid, NT5, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)di, (float*)dq_acc, (bf16*)dk, (bf16*)dv, sq, sk, heads, q_sn, q_ss, k_sn,
      k_ss, v_sn, v_ss, d_sn, d_ss, scale, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
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
  int err = launch_di512(o, dout, di, batch, heads, sq, o_sn, o_ss, d_sn, d_ss, st);
  if (err != 0) return err;
  err = launch_bwd512<false>(q, k, v, dout, lse, di, dq_acc, dk, dv, batch, heads, sq, sk, q_sn,
                             q_ss, k_sn, k_ss, v_sn, v_ss, d_sn, d_ss, scale, st);
  if (err != 0) return err;
  const int smem = sizeof(Dq512Smem);
  err = (int)cudaFuncSetAttribute(flash_bwd_dq_d512_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  dim3 grid((sq + DQ_Q - 1) / DQ_Q, heads, batch);
  flash_bwd_dq_d512_kernel<<<grid, NT5, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)di, (float*)dq_acc, sq, sk, heads, q_sn, q_ss, k_sn, k_ss, v_sn, v_ss, d_sn,
      d_ss, scale, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
