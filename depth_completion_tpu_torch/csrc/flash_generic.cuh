// Flash attention for Hopper (sm_90a) at every (element type, head dim)
// pair that the tuned bf16 kernels of flash_attention.cu do not take: fp32
// operands at head dims 64, 128, 256, 384 and 512, and bf16 operands at 128,
// 256 and 384 (and the ring's steps at 512). flash_generic_f32.cu and
// flash_generic_bf16.cu instantiate it, one library each, built in parallel.
//
// Replaces the same TPU kernels as flash_attention.cu, at the dtypes and
// head dims the JAX package sends to them (it routes by sequence length and
// head dim only, depth_completion_tpu/ops/flash_attention.py:893-921; its
// fp32 policy, core/dtypes.py:33-37, runs them on fp32 operands):
//   flash_fwd_generic  <- _fwd_kernel (:163), and the forward step of the
//                 flash ring (ops/ring_attention.py, _make_flash_ring :99)
//   flash_bwd_generic  <- _bwd_fused_kernel (:464) / _bwd_fused_kernel_t
//                 (:534), and the ring's backward step
//
// What bounds it: the tensor cores (4·S²·d FLOP forward, 10·S²·d backward,
// against ~4·S·d operand elements). bf16 runs mma.sync m16n8k16 (bf16's
// 989 TFLOP/s dense). fp32 runs 3xTF32 on m16n8k8 (TF32's 494.7 TFLOP/s):
// each operand split into a TF32 high part and a TF32 remainder, three
// products a k-step (lo·hi', hi·lo', hi·hi'), ~2^-22 of each product kept
// where one TF32 pass keeps 2^-11. The fp32 bound (chip_smoke.py, PERF.md)
// counts each product once at TF32's rate; 3xTF32's own floor is 3x it.
// Each k-step's fp32 products land in a zeroed fragment and join the sums
// with fp32 adds (dct::mma_tf32x3 says why). bf16 rounds p and ds to bf16
// before their products, as the tuned kernels do. Softmax state, row
// statistics and accumulators are fp32 at either dtype.
//
// Forward (flash_fwd_generic), the FA2 form of flash_fwd_kernel generalised
// over D. A block owns BQ = 16·RG query rows of one (batch, head): RG row
// groups of 16 rows, each served by W warps that split o's channels (DW =
// D / W each: bf16 128, fp32 64, so that o and, at fp32, q's split
// fragments fit the registers). Per key tile of BK rows each warp forms the
// partial scores of its rows over its DW channels for all BK keys in
// registers. W = 1 (bf16 d=128, fp32 d=64): that is s. W > 1: the row
// group's warps hand their partials over through shared memory (lane-major
// float4, double-buffered by tile parity, one named barrier of the W warps)
// and each adds all W in one order, so that every warp holds the same s,
// runs the same online softmax (max and sum over the lane quad, exp2 on the
// fragments, α rescaling its o in place) and turns p's C fragments into the
// A fragments of p·v over its own channels without leaving the registers.
// Chosen over one bf16 p tile in shared memory, which needs the row max
// across the W warps first (an exchange and a barrier either way) and a
// barrier after p; the hand-over costs W·16·BK·4 bytes of shared-memory
// reads a warp and tile and W-fold exp2 (16·BK a warp).
// bf16: q comes with the first key tile and its fragments are loaded once
// (ldmatrix, kept in registers); k and v come through a two-stage cp.async
// ring of XOR-swizzled tiles (16-byte chunk ^ row % 8 within each group of
// eight), so tile j+1 loads while tile j is used, one block barrier a tile;
// k by ldmatrix, v by ldmatrix.trans.
// fp32: q's fragments are read once from global memory and split into TF32
// (hi, lo) in registers. k and v land raw through cp.async and are split
// once a tile into hi and lo planes by every thread, between two block
// barriers, while the next raw tile copies behind the products: k as it is,
// v transposed ([channel][key]) with each eight keys stored 0, 2, 4, 6, 1,
// 3, 5, 7. A lane's C fragment holds keys 2t and 2t+1 of each n8 tile, so
// p·v takes column t of its A fragment as key 2t and t + 4 as 2t+1, and one
// ldmatrix.b16 on 32-bit words gives v's B fragments of two key groups (its
// x4 layout is TF32's A fragment's, and a [n][k] B's over two k-steps). The
// split rounds with integer ops (dct::tf32_rna: the same rounding as
// cvt.rna.tf32.f32); against cvt.rna that took the d=64 forward from 1.82
// to 1.72 ms and the backward from 5.13 to 4.12 ms (H100 80GB HBM3, 700 W;
// PERF.md). fp32 d=256 and 512 have two plans: the
// launcher takes the one for a full card (32 rows, 8-key tiles) where its
// grid has at least as many blocks as the card has SMs (a whole call at
// S=6912), else the one for a small grid (a ring step's 4x432 rows).
//
// Backward (flash_bwd_generic), flash_bwd_kernel turned the same way: a
// block owns BK = 16·KG key rows in KG key groups, each served by W = D / 64
// warps that split dk's and dv's channels (16 keys x 64 channels of each in
// registers). Per query tile of BQ rows (q, dO and their lse2 / di slices
// through a two-stage cp.async ring) and per 16 queries, each warp forms the
// partial sᵀ = k·qᵀ and dpᵀ = v·dOᵀ over its 64 channels; W > 1 hands them
// over as the forward does (one buffer, two named barriers); then pᵀ =
// exp2(sᵀ·scale·log2e − lse2) and dsᵀ = pᵀ∘(dpᵀ − di)·scale on the
// fragments, whose C fragments become the A fragments of dv += pᵀ·dO and dk
// += dsᵀ·q over the warp's channels (bf16: dO, q by ldmatrix.trans; fp32:
// scalar loads of rows 2t and 2t+1, the queries reordered as the forward's
// keys). The first warp of each key group writes ds once (bf16: dsᵀ
// [key][query], rows padded to BQ + 8; fp32: hi and lo planes [query][key],
// the keys reordered as v's), and after one barrier the warps form dq =
// ds·k in items of 16 rows x 8·DQN channels and add it into the fp32 dq
// with float4 atomics (lanes t and t^1 swap halves, as flash_bwd_kernel).
// k and v are staged once; their A fragments are read at each use to keep
// the registers for dk and dv. fp32 splits each fragment as it is read:
// split planes measured level at d=64 for k and v (4.14 against 4.13 ms)
// and 16% slower with q and dO too (their extra barrier and 16-query
// tiles). Ring: dk and dv are added into the travelling fp32 dk|dv ([N, sk,
// 2·heads·D]) in place of the stores (each element belongs to one thread of
// one block: a plain read-add-write is exact). di = rowsum(dO∘o) comes from
// flash_bwd_di_generic, launched by the same entry point when asked.
//
// Plans, occupancy and waves at the timed shapes (PERF.md §6): rows or keys
// a block, warps, key or query tile, shared memory; registers from ptxas
// (nvcc -Xptxas -v of the card's build, chip_smoke.py prints them; H100
// 80GB HBM3, 700 W), spill bytes where not 0; blocks an SM (the lesser of
// what the shared memory and the registers allow); blocks of the grid.
//   fwd bf16 d=128  64 rows, 4 warps, 64 keys,  80 KB, 199-210 regs: 2;
//                   S=1728 5 heads 135 blocks, one wave
//       bf16 d=256  32 rows, 4 warps, 32 keys,  96 KB, 180-191: 2; S=6912 216
//       bf16 d=384  32 rows, 6 warps, 16 keys,  84 KB, 160-168: 2; S=1728 2h 108
//       bf16 d=512  16 rows, 4 warps, 16 keys,  88 KB, 165-168: 2; ring 108
//       fp32 d=64   64 rows, 4 warps, 32 keys,  52 KB, 168 (44-88 B spill):
//                   3; S=6912 5h 540 blocks, 1.36 waves; S=1728 10h 270
//       fp32 d=128  32 rows, 4 warps, 16 keys,  61 KB, 168 (12-36 B): 3;
//                   S=1728 5h 270, one wave
//       fp32 d=256  full card: 32 rows, 8 warps, 8 keys, 65 KB, 128 (64-132
//                   B): 2; S=6912 216, one wave; small grid: 16 keys,
//                   121 KB, 255 (24-48 B): 1; ring 56
//       fp32 d=384  32 rows, 12 warps, 8 keys,  97 KB, 168 (0-4 B): 1; 108
//       fp32 d=512  full card: 32 rows, 16 warps, 8 keys, 129 KB, 128
//                   (64-136 B): 1; S=6912 216, 1.64 waves; small grid: 16
//                   rows, 8 warps, 16 keys, 225 KB, 255 (32-144 B): 1; ring 108
//   bwd bf16 d=128  32 keys, 4 warps, 32 queries, 59 KB, 164: 3; S=1728 5h 270
//       bf16 d=256  32 keys, 8 warps, 16 queries, 82 KB, 128: 2; S=6912 216
//       bf16 d=384  16 keys, 6 warps, 16 queries, 85 KB, 158: 2; S=1728 2h 216
//       bf16 d=512  16 keys, 8 warps, 16 queries, 113 KB, 128: 2; ring 108
//       fp32 d=64   64 keys, 4 warps, 32 queries, 86 KB, 248: 2; S=6912 5h
//                   540 blocks, 2.05 waves; S=1728 10h 270, 1.02 waves
//       fp32 d=128  48 keys, 6 warps, 16 queries, 101 KB, 168 (0-180 B): 2;
//                   S=1728 5h 180
//       fp32 d=256  16 keys, 4 warps, 16 queries, 108 KB, 250: 2; S=6912
//                   432, 1.64 waves
//       fp32 d=384  32 keys, 12 warps, 16 queries, 223 KB, 168 (16-96 B): 1;
//                   S=1728 2h 108
//       fp32 d=512  16 keys, 8 warps, 16 queries, 212 KB, 250: 1; S=6912
//                   432, 3.27 waves
// Every plan keeps two or more blocks an SM but fp32 d=384 and 512 and fp32
// d=256's small-grid plan (at d >= 384 a 16-row fp32 tile of q or dO is
// 25-33 KB and the ring of both 99-132 KB; the forward's 32-row plans there
// use 12-16 warps). The fp32 d=64 backward's 540 and 270 blocks leave a tail wave at
// two blocks an SM; three (16-query tiles, 168 registers) measured 9%
// slower (4.50 against 4.12 ms).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sync.cuh"

namespace dct_generic {

typedef __nv_bfloat16 bf16;

// Rows of D channels in shared memory: bf16 rows of D elements whose 16-byte
// chunks are XORed with row % 8 (within each group of eight chunks, so the
// eight rows one ldmatrix reads sit in eight bank groups); fp32 rows of
// D + 4 words (the same for 16-byte reads, and 32 banks for the scalar
// reads of rows 2t, 2t+1 at column g).
template <typename T, int D>
struct Rows {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  static constexpr int LD = kF32 ? D + 4 : D;     // elements per row
  static constexpr int CHUNKS = D / EPC;
  // element offset of chunk `chunk` of row `row`
  __device__ __forceinline__ static int off(int row, int chunk) {
    if constexpr (kF32) {
      return row * LD + chunk * 4;
    } else {
      return row * D + ((chunk ^ (row & 7)) << 3);
    }
  }
};

// cp.async rows [row0, row0 + rows) of a strided matrix (D channels from
// src) into a tile of Rows<T, D>; rows at or past nrows are zero-filled
template <typename T, int D, int NT>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long row_stride, int row0,
                                           int nrows, int rows) {
  using R = Rows<T, D>;
  for (int i = threadIdx.x; i < rows * R::CHUNKS; i += NT) {
    const int r = i / R::CHUNKS, c = i % R::CHUNKS;
    const bool ok = row0 + r < nrows;
    dct::cp_async_16(dct::smem_u32(dst + R::off(r, c)),
                     ok ? src + (long)(row0 + r) * row_stride + c * R::EPC : src, ok);
  }
}

// cp.async the fp32 statistics of rows [row0, row0 + n) (lse2 by threads
// 0..n-1, di by n..2n-1); rows at or past nrows are zero-filled
__device__ __forceinline__ void stage_stats(float* lse_dst, float* di_dst, const float* lse_row,
                                            const float* di_row, int row0, int nrows, int n) {
  const int tid = threadIdx.x, i = tid % n;
  if (tid >= 2 * n) return;
  const bool ok = row0 + i < nrows;
  const float* src = tid < n ? lse_row : di_row;
  float* dst = tid < n ? lse_dst : di_dst;
  dct::cp_async_4(dct::smem_u32(dst + i), ok ? src + row0 + i : src, ok);
}

template <int N>
__device__ __forceinline__ void split4(const uint32_t (&x)[N], uint32_t (&hi)[N],
                                       uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) dct::tf32_split(__uint_as_float(x[i]), hi[i], lo[i]);
}

__device__ __forceinline__ void store2(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}

__device__ __forceinline__ void store2(bf16* dst, float x, float y) {
  *reinterpret_cast<uint32_t*>(dst) = dct::pack_bf16(x, y);
}

__device__ __forceinline__ void add4(float (&y)[4], float4 x) {
  y[0] += x.x;
  y[1] += x.y;
  y[2] += x.z;
  y[3] += x.w;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// the o (or dk, dv) accumulator's rows g and g + 8 scaled
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

// position of key e (0-7) of a group of eight in the fp32 ds planes: even
// keys first, so that an A fragment's column t (t + 4) is key 2t (2t + 1)
__device__ __forceinline__ int key_pos(int e) { return (e & 1) ? 4 + (e >> 1) : (e >> 1); }

// Full: the plan of fp32 d=256 and 512 for a grid that fills the card (the
// launcher takes it where its blocks are at least the SMs: a whole call at
// S=6912): 32 rows and 8-key tiles, at d=256 two blocks an SM; else (a ring
// step's 4x432 rows: 56 blocks of 32 rows) d=256 one block an SM with
// 16-key tiles, d=512 16 rows and 16-key tiles
template <typename T, int D, bool Full = false>
struct FwdCfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kHasFull = kF32 && (D == 256 || D == 512);
  static constexpr int DW = kF32 ? 64 : (D < 128 ? D : 128);  // channels of o per warp
  static constexpr int W = D / DW;                            // warps per row group
  static constexpr int RG = kF32 ? (D == 64 ? 4 : D <= 384 || Full ? 2 : 1)
                                 : (D == 128 ? 4 : D <= 384 ? 2 : 1);  // row groups
  static constexpr int BK = kF32 ? (D == 64 ? 32 : D == 128 ? 16 : D == 384 || Full ? 8 : 16)
                                 : (D == 128 ? 64 : D == 256 ? 32 : 16);  // key rows per tile
  static constexpr int BQ = 16 * RG, NW = RG * W, NT = NW * 32;
  static constexpr int NS = BK / 8;  // n8 tiles of a warp's scores
  static constexpr int NN = DW / 8;  // n8 tiles of its o
  using R = Rows<T, D>;
  static constexpr int TILE = BK * R::LD;  // elements of one k or v tile
  static constexpr int LDT = BK + 4;       // fp32: words per row of v's planes, [channel][key]
  static constexpr int VT = D * LDT;       // fp32: words of one v plane
  // bf16: q, then k[2], v[2]; fp32: raw k, raw v, the hi and lo planes of k
  // and of v (transposed); then the score hand-over, [2][RG][W][NS][32] float4
  static constexpr int Q_BYTES = kF32 ? 0 : BQ * D * 2;
  static constexpr int KV_BYTES = kF32 ? (4 * TILE + 2 * VT) * 4 : 4 * TILE * 2;
  static constexpr int XCH_BYTES = W > 1 ? 2 * RG * W * NS * 512 : 0;
  static constexpr int SMEM = Q_BYTES + KV_BYTES + XCH_BYTES;
  // blocks an SM that the registers are held to: fp32 d <= 128 three (12
  // warps), fp32 d >= 256 one (8-16 warps) but d=256's Full plan two, else
  // two where the shared memory lets them
  static constexpr int MINB = kF32 && D <= 128 ? 3 : kF32 && D >= 256 && !(D == 256 && Full) ? 1
                              : 2 * (SMEM + 1024) <= 233472 ? 2 : 1;
  static_assert(D % DW == 0 && BK % 8 == 0 && (kF32 || BK % 16 == 0), "tile shapes");
  static_assert(SMEM <= 232448, "forward tiles exceed shared memory");
};

// StateIn / StateOut as flash_fwd_kernel's: <false, false> is the forward,
// the ring's first step <false, true>, its middle steps <true, true>, its
// last <true, false>
template <typename T, int D, bool StateIn, bool StateOut, bool Full>
__global__ void __launch_bounds__(FwdCfg<T, D, Full>::NT, FwdCfg<T, D, Full>::MINB)
flash_fwd_generic(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, float* __restrict__ lse, float* __restrict__ m_st,
                  float* __restrict__ l_st, float* __restrict__ acc_st, int sq, int sk,
                  int heads, long q_sn, long q_ss, long k_sn, long k_ss, long v_sn, long v_ss,
                  long o_sn, long o_ss, float scale_log2) {
  using C = FwdCfg<T, D, Full>;
  using R = typename C::R;
  constexpr bool kF32 = C::kF32;
  constexpr int BQ = C::BQ, BK = C::BK, W = C::W, DW = C::DW, NT = C::NT;
  constexpr int NS = C::NS, NN = C::NN, TILE = C::TILE, LD = R::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* s_q = reinterpret_cast<T*>(smem);
  T* s_kv = reinterpret_cast<T*>(smem + C::Q_BYTES);
  const uint32_t* planes = reinterpret_cast<const uint32_t*>(s_kv + 2 * TILE);  // fp32
  float4* s_x = reinterpret_cast<float4*>(smem + C::Q_BYTES + C::KV_BYTES);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix addressing (bf16, as flash_fwd_kernel): lane gives row lr of
  // matrix mi; (row_qv, ch_qv) for an A operand and a B through .trans,
  // (row_k, ch_k) for a B stored [n][k]
  const int lr = lane & 7, mi = lane >> 3;
  const int row_qv = ((mi & 1) << 3) + lr, ch_qv = mi >> 1;
  const int row_k = ((mi >> 1) << 3) + lr, ch_k = mi & 1;
  const int rg = warp / W, ws = warp % W;
  const int rb = rg * 16, cb = ws * DW;  // this warp's first row in the block, its first channel
  const int r0 = q0 + rb + g, r1 = r0 + 8;  // this lane's rows
  const long stat_bh = ((long)n * heads + h) * sq;
  const long cc = (long)heads * D;  // channels of a row of the ring's acc
  const T* qh = q + n * q_sn + (long)h * D;  // this head's queries
  const T* kb = k + n * k_sn + (long)h * D;
  const T* vb = v + n * v_sn + (long)h * D;
  const int ntiles = (sk + BK - 1) / BK;

  // bf16: q and the first k, v stage; fp32: the first raw k, v tile
  if constexpr (!kF32) stage_rows<T, D, NT>(s_q, qh, q_ss, q0, sq, BQ);
  stage_rows<T, D, NT>(s_kv, kb, k_ss, 0, sk, BK);
  stage_rows<T, D, NT>(s_kv + (kF32 ? 1 : 2) * TILE, vb, v_ss, 0, sk, BK);
  dct::cp_async_commit();

  // q as A fragments: bf16 over DW / 16 k-steps (loaded at the first tile);
  // fp32 split into TF32 (hi, lo) over DW / 8, read here from global memory
  uint32_t qf[kF32 ? 1 : DW / 16][4];
  uint32_t qhi[kF32 ? DW / 8 : 1][4], qlo[kF32 ? DW / 8 : 1][4];
  if constexpr (kF32) {
#pragma unroll
    for (int kk = 0; kk < DW / 8; ++kk) {
      const int c = cb + kk * 8 + t;
      const float x0 = r0 < sq ? to_f(qh[(long)r0 * q_ss + c]) : 0.f;
      const float x1 = r1 < sq ? to_f(qh[(long)r1 * q_ss + c]) : 0.f;
      const float x2 = r0 < sq ? to_f(qh[(long)r0 * q_ss + c + 4]) : 0.f;
      const float x3 = r1 < sq ? to_f(qh[(long)r1 * q_ss + c + 4]) : 0.f;
      dct::tf32_split(x0, qhi[kk][0], qlo[kk][0]);
      dct::tf32_split(x1, qhi[kk][1], qlo[kk][1]);
      dct::tf32_split(x2, qhi[kk][2], qlo[kk][2]);
      dct::tf32_split(x3, qhi[kk][3], qlo[kk][3]);
    }
  }

  float acc[NN][4];  // o of rows r0, r1 over channels cb + 8j + 2t, +1
#pragma unroll
  for (int j = 0; j < NN; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0 and r1 (log2 domain)
  float l0 = 0.f, l1 = 0.f;              // this lane's part of their row sums
  if constexpr (StateIn) {  // the quad's lane t = 0 carries the row sum
    const float* a0 = acc_st + ((long)n * sq + r0) * cc + (long)h * D + cb + 2 * t;
    if (r0 < sq) {
      m0 = m_st[stat_bh + r0];
      l0 = t == 0 ? l_st[stat_bh + r0] : 0.f;
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        const float2 x = *reinterpret_cast<const float2*>(a0 + j * 8);
        acc[j][0] = x.x;
        acc[j][1] = x.y;
      }
    }
    if (r1 < sq) {
      m1 = m_st[stat_bh + r1];
      l1 = t == 0 ? l_st[stat_bh + r1] : 0.f;
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        const float2 x = *reinterpret_cast<const float2*>(a0 + 8 * cc + j * 8);
        acc[j][2] = x.x;
        acc[j][3] = x.y;
      }
    }
  }

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    dct::cp_async_wait<0>();
    __syncthreads();  // tile j landed for every thread; tile j-1 consumed by every warp
    if constexpr (kF32) {
      // split raw k and v into their hi and lo planes, 4 channels a thread:
      // k as it is, v transposed, [channel][key], each eight keys in the
      // order 0, 2, 4, 6, 1, 3, 5, 7 (threads take consecutive keys there)
      uint32_t* kp = reinterpret_cast<uint32_t*>(s_kv + 2 * TILE);
      for (int i = threadIdx.x; i < BK * (D / 4); i += NT) {
        const int off = (i / (D / 4)) * LD + (i % (D / 4)) * 4;
        const float4 x = *reinterpret_cast<const float4*>(s_kv + off);
        uint4 hi, lo;
        dct::tf32_split(x.x, hi.x, lo.x);
        dct::tf32_split(x.y, hi.y, lo.y);
        dct::tf32_split(x.z, hi.z, lo.z);
        dct::tf32_split(x.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(kp + off) = hi;
        *reinterpret_cast<uint4*>(kp + TILE + off) = lo;
      }
      for (int i = threadIdx.x; i < BK * (D / 4); i += NT) {
        const int r = i % BK, c = (i / BK) * 4;
        const float4 x = *reinterpret_cast<const float4*>(s_kv + TILE + r * LD + c);
        const float xs[4] = {x.x, x.y, x.z, x.w};
        const int pos = (r & ~7) + key_pos(r & 7);  // this key's column in v's planes
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dct::tf32_split(xs[e], kp[2 * TILE + (c + e) * C::LDT + pos],
                kp[2 * TILE + C::VT + (c + e) * C::LDT + pos]);
      }
      __syncthreads();  // the planes ready; the raw tile consumed
      if (j + 1 < ntiles) {
        stage_rows<T, D, NT>(s_kv, kb, k_ss, (j + 1) * BK, sk, BK);
        stage_rows<T, D, NT>(s_kv + TILE, vb, v_ss, (j + 1) * BK, sk, BK);
      }
    } else {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < DW / 16; ++kk)
          dct::ldsm_x4(qf[kk], dct::smem_u32(s_q + R::off(rb + row_qv, cb / 8 + kk * 2 + ch_qv)));
      }
      if (j + 1 < ntiles) {
        stage_rows<T, D, NT>(s_kv + (st ^ 1) * TILE, kb, k_ss, (j + 1) * BK, sk, BK);
        stage_rows<T, D, NT>(s_kv + (2 + (st ^ 1)) * TILE, vb, v_ss, (j + 1) * BK, sk, BK);
      }
    }
    dct::cp_async_commit();
    const T* ks = s_kv + st * TILE;         // bf16
    const T* vs = s_kv + (2 + st) * TILE;   // bf16
    const uint32_t* khi = planes;           // fp32
    const uint32_t* klo = planes + TILE;
    const uint32_t* vhi = planes + 2 * TILE;
    const uint32_t* vlo = vhi + C::VT;

    // this warp's partial s = q kᵀ: its 16 rows, its DW channels, all BK keys
    float s[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    if constexpr (kF32) {
#pragma unroll
      for (int jn = 0; jn < NS; ++jn) {
#pragma unroll
        for (int kk = 0; kk < DW / 16; ++kk) {  // two k8 steps per ldmatrix
          uint32_t bh[4], bl[4];
          const int off = (jn * 8 + lr) * LD + cb + kk * 16 + mi * 4;
          dct::ldsm_x4(bh, dct::smem_u32(khi + off));
          dct::ldsm_x4(bl, dct::smem_u32(klo + off));
          dct::mma_tf32x3<true>(s[jn], qhi[2 * kk], qlo[2 * kk], bh[0], bh[1], bl[0], bl[1]);
          dct::mma_tf32x3<true>(s[jn], qhi[2 * kk + 1], qlo[2 * kk + 1], bh[2], bh[3], bl[2],
                                bl[3]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < DW / 16; ++kk) {
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          uint32_t b[4];
          dct::ldsm_x4(b, dct::smem_u32(ks + R::off(jp * 16 + row_k, cb / 8 + kk * 2 + ch_k)));
          dct::mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
          dct::mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
        }
      }
    }
    if constexpr (W > 1) {  // the row group's W partials, added in one order by every warp
      float4* xb = s_x + ((j & 1) * C::RG + rg) * W * NS * 32;
#pragma unroll
      for (int i = 0; i < NS; ++i)
        xb[(ws * NS + i) * 32 + lane] = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      dct::bar_sync(1 + rg, W * 32);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float4 x = xb[(w * NS + i) * 32 + lane];
          add4(s[i], x);
        }
      }
    }

    // online softmax on the fragments: lane holds columns 8i + 2t, +1 of rows
    // g (s[i][0..1]) and g + 8 (s[i][2..3]); a row's four lanes form a quad
    const int kcol = j * BK + 2 * t;
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] *= scale_log2;
    if ((j + 1) * BK > sk) {  // the ragged last tile: keys at or past sk score -inf
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kcol + i * 8 + (e & 1) >= sk) s[i][e] = -INFINITY;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[i][0], s[i][1]));
      mx1 = fmaxf(mx1, fmaxf(s[i][2], s[i][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // column j·BK < sk is valid in every row, so mx is finite; α is 0 at the
    // first tile, or rescales the carried state there
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
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

    // o += p v over this warp's channels, p's C fragments as A
    if constexpr (kF32) {
      // keys 8i..8i+7: A's column t is key 8i + 2t and t + 4 key 8i + 2t + 1,
      // which v's planes hold at columns t and t + 4 of the group: one
      // ldmatrix gives the B fragments of two key groups (one at NS = 1)
      constexpr int KP = NS % 2 == 0 ? 2 : 1;
#pragma unroll
      for (int i = 0; i < NS; i += KP) {
        uint32_t ah[KP][4], al[KP][4];
#pragma unroll
        for (int u = 0; u < KP; ++u) {
          dct::tf32_split(s[i + u][0], ah[u][0], al[u][0]);
          dct::tf32_split(s[i + u][2], ah[u][1], al[u][1]);
          dct::tf32_split(s[i + u][1], ah[u][2], al[u][2]);
          dct::tf32_split(s[i + u][3], ah[u][3], al[u][3]);
        }
#pragma unroll
        for (int nn = 0; nn < NN; ++nn) {
          const int off = (cb + nn * 8 + lr) * C::LDT + i * 8 + (KP == 2 ? mi : mi & 1) * 4;
          if constexpr (KP == 2) {
            uint32_t bh[4], bl[4];
            dct::ldsm_x4(bh, dct::smem_u32(vhi + off));
            dct::ldsm_x4(bl, dct::smem_u32(vlo + off));
            dct::mma_tf32x3<true>(acc[nn], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
            dct::mma_tf32x3<true>(acc[nn], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
          } else {
            uint32_t bh[2], bl[2];
            dct::ldsm_x2(bh, dct::smem_u32(vhi + off));
            dct::ldsm_x2(bl, dct::smem_u32(vlo + off));
            dct::mma_tf32x3<true>(acc[nn], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pa[4] = {dct::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                dct::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                dct::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                dct::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < DW / 16; ++dp) {
          uint32_t b[4];
          dct::ldsm_x4_t(b, dct::smem_u32(vs + R::off(kk * 16 + row_qv, cb / 8 + dp * 2 + ch_qv)));
          dct::mma_bf16(acc[2 * dp], pa, b[0], b[1]);
          dct::mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
        }
      }
    }
  }

  // full row sums from the quad; o = acc / l (a row with l == 0 keeps inv = 1)
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const bool writes_stats = ws == 0 && t == 0;  // every warp of the row group holds them
  if constexpr (StateOut) {  // the state for the next ring step, in place
    float* a0 = acc_st + ((long)n * sq + r0) * cc + (long)h * D + cb + 2 * t;
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      if (r0 < sq) store2(a0 + j * 8, acc[j][0], acc[j][1]);
      if (r1 < sq) store2(a0 + 8 * cc + j * 8, acc[j][2], acc[j][3]);
    }
    if (writes_stats && r0 < sq) {
      m_st[stat_bh + r0] = m0;
      l_st[stat_bh + r0] = l0;
    }
    if (writes_stats && r1 < sq) {
      m_st[stat_bh + r1] = m1;
      l_st[stat_bh + r1] = l1;
    }
    return;
  }
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
  T* o0 = o + n * o_sn + (long)r0 * o_ss + (long)h * D + cb + 2 * t;
#pragma unroll
  for (int j = 0; j < NN; ++j) {
    if (r0 < sq) store2(o0 + j * 8, acc[j][0] * inv0, acc[j][1] * inv0);
    if (r1 < sq) store2(o0 + 8 * o_ss + j * 8, acc[j][2] * inv1, acc[j][3] * inv1);
  }
  if (writes_stats && r0 < sq) lse[stat_bh + r0] = m0 + (l0 == 0.f ? 0.f : log2f(l0));
  if (writes_stats && r1 < sq) lse[stat_bh + r1] = m1 + (l1 == 0.f ? 0.f : log2f(l1));
}

// di[n, h, s] = Σ_d dO·o over the D channels (one warp per row, rows
// ordered (n, h, s))
template <typename T, int D>
__global__ void flash_bwd_di_generic(const T* __restrict__ o, const T* __restrict__ dout,
                                     float* __restrict__ di, long rows, int sq, int heads,
                                     long o_sn, long o_ss, long d_sn, long d_ss) {
  const long row = (long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int s = row % sq;
  const int h = (row / sq) % heads;
  const long n = row / ((long)sq * heads);
  const T* orow = o + n * o_sn + (long)s * o_ss + (long)h * D;
  const T* drow = dout + n * d_sn + (long)s * d_ss + (long)h * D;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc += to_f(orow[c]) * to_f(drow[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) di[row] = acc;
}

template <typename T, int D>
struct BwdCfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int W = D / 64;  // warps per key group: 64 channels of dk, dv each
  static constexpr int KG = kF32 ? (D == 64 ? 4 : D == 128 ? 3 : D == 384 ? 2 : 1) : (D <= 256 ? 2 : 1);
  static constexpr int BK = 16 * KG;  // key rows per block
  static constexpr int BQ = (kF32 ? D == 64 : D == 128) ? 32 : 16;  // query rows per tile
  static constexpr int NW = KG * W, NT = NW * 32;
  // n8 tiles of a dq item (16 rows): the widest that gives every warp one
  static constexpr int DQN = (BQ / 16) * (D / 64) >= NW ? 8 : (BQ / 16) * (D / 32) >= NW ? 4 : 2;
  static constexpr int DQ_ITEMS = (BQ / 16) * (D / (8 * DQN));
  using R = Rows<T, D>;
  static constexpr int QT = BQ * R::LD;  // elements of one q or dO tile
  // ds: fp32 hi and lo planes [BQ][BK + 4]; bf16 dsᵀ [BK][BQ + 8]
  static constexpr int LDP = kF32 ? BK + 4 : BQ + 8;
  // k, v; q[2], dO[2]; ds; lse2[2], di[2]; the hand-over [KG][W][4][32] float4
  static constexpr int KV_BYTES = 2 * BK * R::LD * (int)sizeof(T);
  static constexpr int QD_BYTES = 4 * QT * (int)sizeof(T);
  static constexpr int DS_BYTES = kF32 ? 2 * BQ * LDP * 4 : BK * LDP * 2;
  static constexpr int ST_BYTES = 4 * BQ * 4;
  static constexpr int XCH_BYTES = W > 1 ? KG * W * 4 * 512 : 0;
  static constexpr int SMEM = KV_BYTES + QD_BYTES + DS_BYTES + ST_BYTES + XCH_BYTES;
  static constexpr int MINB = 2 * (SMEM + 1024) <= 233472 ? 2 : 1;
  static_assert(BQ % 16 == 0 && DQ_ITEMS >= NW && DQN % 2 == 0, "tile shapes");
  static_assert(NT >= 2 * BQ && NT <= 1024, "threads");
  static_assert(SMEM <= 232448, "backward tiles exceed shared memory");
};

template <typename T, int D, bool Ring>
__global__ void __launch_bounds__(BwdCfg<T, D>::NT, BwdCfg<T, D>::MINB)
flash_bwd_generic(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ di, float* __restrict__ dq_acc, T* __restrict__ dk,
                  T* __restrict__ dv, float* __restrict__ dkv_acc, int sq, int sk, int heads,
                  long q_sn, long q_ss, long k_sn, long k_ss, long v_sn, long v_ss, long d_sn,
                  long d_ss, float scale, float scale_log2) {
  using C = BwdCfg<T, D>;
  using R = typename C::R;
  constexpr bool kF32 = C::kF32;
  constexpr int BQ = C::BQ, BK = C::BK, W = C::W, NT = C::NT, NW = C::NW, QT = C::QT;
  constexpr int LD = R::LD, LDP = C::LDP, DQN = C::DQN;
  extern __shared__ __align__(128) unsigned char smem[];
  T* s_k = reinterpret_cast<T*>(smem);
  T* s_v = s_k + BK * LD;
  T* s_qd = reinterpret_cast<T*>(smem + C::KV_BYTES);  // stage st: q at 2·st·QT, dO after it
  unsigned char* s_ds = smem + C::KV_BYTES + C::QD_BYTES;
  bf16* s_dst = reinterpret_cast<bf16*>(s_ds);                // bf16: dsᵀ [BK][LDP]
  uint32_t* s_dshi = reinterpret_cast<uint32_t*>(s_ds);       // fp32: ds hi, lo [BQ][LDP]
  uint32_t* s_dslo = s_dshi + BQ * LDP;
  float* s_st = reinterpret_cast<float*>(s_ds + C::DS_BYTES);  // stage st: lse2 at 2·st·BQ, di after
  float4* s_x = reinterpret_cast<float4*>(s_ds + C::DS_BYTES + C::ST_BYTES);

  const int k0 = blockIdx.x * BK, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix addressing as in flash_fwd_generic (bf16), and for an A operand
  // stored [k][m] through .trans: (row_k, ch_k)
  const int lr = lane & 7, mi = lane >> 3;
  const int row_qv = ((mi & 1) << 3) + lr, ch_qv = mi >> 1;
  const int row_k = ((mi >> 1) << 3) + lr, ch_k = mi & 1;
  const int kg = warp / W, ws = warp % W;
  const int kb = kg * 16, cb = ws * 64;  // this warp's first key row of dk, dv and its first channel
  const T* qb = q + n * q_sn + (long)h * D;
  const T* db = dout + n * d_sn + (long)h * D;
  const float* lse_bh = lse + ((long)n * heads + h) * sq;
  const float* di_bh = di + ((long)n * heads + h) * sq;
  const long cc = (long)heads * D;  // dq_acc, dk, dv are contiguous [N, S, heads·D]
  const int ntiles = (sq + BQ - 1) / BQ;
  const bool key_tail = k0 + BK > sk;

  stage_rows<T, D, NT>(s_k, k + n * k_sn + (long)h * D, k_ss, k0, sk, BK);
  stage_rows<T, D, NT>(s_v, v + n * v_sn + (long)h * D, v_ss, k0, sk, BK);
  stage_rows<T, D, NT>(s_qd, qb, q_ss, 0, sq, BQ);
  stage_rows<T, D, NT>(s_qd + QT, db, d_ss, 0, sq, BQ);
  stage_stats(s_st, s_st + BQ, lse_bh, di_bh, 0, sq, BQ);
  dct::cp_async_commit();

  float dk_acc[8][4], dv_acc[8][4];  // key rows kb + g (+8), channels cb + 8j + 2t
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1, q0 = j * BQ;
    dct::cp_async_wait<0>();
    __syncthreads();  // tile j landed; tile j-1 and its ds consumed by every warp
    if (j + 1 < ntiles) {
      stage_rows<T, D, NT>(s_qd + 2 * (st ^ 1) * QT, qb, q_ss, q0 + BQ, sq, BQ);
      stage_rows<T, D, NT>(s_qd + (2 * (st ^ 1) + 1) * QT, db, d_ss, q0 + BQ, sq, BQ);
      stage_stats(s_st + 2 * (st ^ 1) * BQ, s_st + (2 * (st ^ 1) + 1) * BQ, lse_bh, di_bh,
                  q0 + BQ, sq, BQ);
    }
    dct::cp_async_commit();
    const T* qs = s_qd + 2 * st * QT;
    const T* dos = qs + QT;
    const float* lse_s = s_st + 2 * st * BQ;
    const float* di_s = lse_s + BQ;
    const bool ragged = key_tail || q0 + BQ > sq;

#pragma unroll 1
    for (int jq = 0; jq < BQ / 16; ++jq) {
      // partial sᵀ = k qᵀ and dpᵀ = v dOᵀ over this warp's 64 channels: its
      // 16 keys x the group's 16 queries (two n8 tiles each)
      float s[2][4], dp[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
      if constexpr (kF32) {
#pragma unroll
        for (int kp = 0; kp < 4; ++kp) {  // channels cb + 16kp: two k8 steps
          uint32_t akh[2][4], akl[2][4], avh[2][4], avl[2][4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            uint32_t x[4];
            const int off = (kb + ((mi & 1) << 3) + lr) * LD + cb + kp * 16 + e * 8 + ((mi >> 1) << 2);
            dct::ldsm_x4(x, dct::smem_u32(s_k + off));
            split4(x, akh[e], akl[e]);
            dct::ldsm_x4(x, dct::smem_u32(s_v + off));
            split4(x, avh[e], avl[e]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            uint32_t x[4], bh[4], bl[4];
            const int off = (jq * 16 + nt * 8 + lr) * LD + cb + kp * 16 + mi * 4;
            dct::ldsm_x4(x, dct::smem_u32(qs + off));
            split4(x, bh, bl);
            dct::mma_tf32x3<true>(s[nt], akh[0], akl[0], bh[0], bh[1], bl[0], bl[1]);
            dct::mma_tf32x3<true>(s[nt], akh[1], akl[1], bh[2], bh[3], bl[2], bl[3]);
            dct::ldsm_x4(x, dct::smem_u32(dos + off));
            split4(x, bh, bl);
            dct::mma_tf32x3<true>(dp[nt], avh[0], avl[0], bh[0], bh[1], bl[0], bl[1]);
            dct::mma_tf32x3<true>(dp[nt], avh[1], avl[1], bh[2], bh[3], bl[2], bl[3]);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t a[4], b[4];
          const int off_a = R::off(kb + row_qv, cb / 8 + kk * 2 + ch_qv);
          const int off_b = R::off(jq * 16 + row_k, cb / 8 + kk * 2 + ch_k);
          dct::ldsm_x4(a, dct::smem_u32(s_k + off_a));
          dct::ldsm_x4(b, dct::smem_u32(qs + off_b));
          dct::mma_bf16(s[0], a, b[0], b[1]);
          dct::mma_bf16(s[1], a, b[2], b[3]);
          dct::ldsm_x4(a, dct::smem_u32(s_v + off_a));
          dct::ldsm_x4(b, dct::smem_u32(dos + off_b));
          dct::mma_bf16(dp[0], a, b[0], b[1]);
          dct::mma_bf16(dp[1], a, b[2], b[3]);
        }
      }
      if constexpr (W > 1) {  // the key group's W partials, added in one order by every warp
        float4* xs = s_x + kg * W * 4 * 32;
        xs[(ws * 4 + 0) * 32 + lane] = make_float4(s[0][0], s[0][1], s[0][2], s[0][3]);
        xs[(ws * 4 + 1) * 32 + lane] = make_float4(s[1][0], s[1][1], s[1][2], s[1][3]);
        xs[(ws * 4 + 2) * 32 + lane] = make_float4(dp[0][0], dp[0][1], dp[0][2], dp[0][3]);
        xs[(ws * 4 + 3) * 32 + lane] = make_float4(dp[1][0], dp[1][1], dp[1][2], dp[1][3]);
        dct::bar_sync(1 + kg, W * 32);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          add4(s[0], xs[(w * 4 + 0) * 32 + lane]);
          add4(s[1], xs[(w * 4 + 1) * 32 + lane]);
          add4(dp[0], xs[(w * 4 + 2) * 32 + lane]);
          add4(dp[1], xs[(w * 4 + 3) * 32 + lane]);
        }
        dct::bar_sync(1 + kg, W * 32);  // every partial read before the next group's
      }
      // pᵀ and dsᵀ: lane holds keys kb + g (e = 0, 1) and + 8 (e = 2, 3) at
      // queries jq·16 + 8i + 2t + (e & 1)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = jq * 16 + i * 8 + 2 * t;
        const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 dis = *reinterpret_cast<const float2*>(di_s + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[i][e] * scale_log2 - ((e & 1) ? lse2.y : lse2.x));
          if (ragged && (q0 + c + (e & 1) >= sq || k0 + kb + g + ((e >> 1) << 3) >= sk)) p = 0.f;
          s[i][e] = p;
          dp[i][e] = p * (dp[i][e] - ((e & 1) ? dis.y : dis.x)) * scale;
        }
        if (ws == 0) {  // ds once per key group
          if constexpr (kF32) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int x = (c + (e & 1)) * LDP + kb + ((e >> 1) << 3) + key_pos(g);
              dct::tf32_split(dp[i][e], s_dshi[x], s_dslo[x]);
            }
          } else {
            bf16* dst = s_dst + (kb + g) * LDP + c;
            *reinterpret_cast<uint32_t*>(dst) = dct::pack_bf16(dp[i][0], dp[i][1]);
            *reinterpret_cast<uint32_t*>(dst + 8 * LDP) = dct::pack_bf16(dp[i][2], dp[i][3]);
          }
        }
      }
      // dv += pᵀ dO and dk += dsᵀ q over this warp's channels, pᵀ's and dsᵀ's
      // C fragments as A
      if constexpr (kF32) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // queries 8i..: A's column t is query 2t, t + 4 is 2t + 1
          uint32_t ph[4], pl[4], dh[4], dl[4];
          dct::tf32_split(s[i][0], ph[0], pl[0]);
          dct::tf32_split(s[i][2], ph[1], pl[1]);
          dct::tf32_split(s[i][1], ph[2], pl[2]);
          dct::tf32_split(s[i][3], ph[3], pl[3]);
          dct::tf32_split(dp[i][0], dh[0], dl[0]);
          dct::tf32_split(dp[i][2], dh[1], dl[1]);
          dct::tf32_split(dp[i][1], dh[2], dl[2]);
          dct::tf32_split(dp[i][3], dh[3], dl[3]);
          const int row = (jq * 16 + i * 8 + 2 * t) * LD + cb + g;
#pragma unroll
          for (int nn = 0; nn < 8; ++nn) {
            const int x = row + nn * 8;
            uint32_t b0h, b0l, b1h, b1l;
            dct::tf32_split(dos[x], b0h, b0l);
            dct::tf32_split(dos[x + LD], b1h, b1l);
            dct::mma_tf32x3<true>(dv_acc[nn], ph, pl, b0h, b1h, b0l, b1l);
            dct::tf32_split(qs[x], b0h, b0l);
            dct::tf32_split(qs[x + LD], b1h, b1l);
            dct::mma_tf32x3<true>(dk_acc[nn], dh, dl, b0h, b1h, b0l, b1l);
          }
        }
      } else {
        const uint32_t pa[4] = {dct::pack_bf16(s[0][0], s[0][1]), dct::pack_bf16(s[0][2], s[0][3]),
                                dct::pack_bf16(s[1][0], s[1][1]), dct::pack_bf16(s[1][2], s[1][3])};
        const uint32_t da[4] = {dct::pack_bf16(dp[0][0], dp[0][1]), dct::pack_bf16(dp[0][2], dp[0][3]),
                                dct::pack_bf16(dp[1][0], dp[1][1]), dct::pack_bf16(dp[1][2], dp[1][3])};
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          uint32_t b[4];
          const int off = R::off(jq * 16 + row_qv, cb / 8 + dd * 2 + ch_qv);
          dct::ldsm_x4_t(b, dct::smem_u32(dos + off));
          dct::mma_bf16(dv_acc[2 * dd], pa, b[0], b[1]);
          dct::mma_bf16(dv_acc[2 * dd + 1], pa, b[2], b[3]);
          dct::ldsm_x4_t(b, dct::smem_u32(qs + off));
          dct::mma_bf16(dk_acc[2 * dd], da, b[0], b[1]);
          dct::mma_bf16(dk_acc[2 * dd + 1], da, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // ds complete

    // dq rows of this tile += ds k over the block's BK keys, in items of 16
    // rows x 8·DQN channels; float4 atomics
    constexpr int CI = D / (8 * DQN);  // channel items
#pragma unroll 1
    for (int it = warp; it < C::DQ_ITEMS; it += NW) {
      const int qg = it / CI, c0 = (it % CI) * 8 * DQN;
      float acc[DQN][4];
#pragma unroll
      for (int i = 0; i < DQN; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      if constexpr (kF32) {
#pragma unroll
        for (int ks = 0; ks < BK / 8; ++ks) {
          uint32_t ah[4], al[4];
          const int off = (qg * 16 + ((mi & 1) << 3) + lr) * LDP + ks * 8 + ((mi >> 1) << 2);
          dct::ldsm_x4(ah, dct::smem_u32(s_dshi + off));
          dct::ldsm_x4(al, dct::smem_u32(s_dslo + off));
          const int row = (ks * 8 + 2 * t) * LD + c0 + g;  // keys 8ks + 2t, + 1
#pragma unroll
          for (int nn = 0; nn < DQN; ++nn) {
            const int x = row + nn * 8;
            uint32_t b0h, b0l, b1h, b1l;
            dct::tf32_split(s_k[x], b0h, b0l);
            dct::tf32_split(s_k[x + LD], b1h, b1l);
            dct::mma_tf32x3<true>(acc[nn], ah, al, b0h, b1h, b0l, b1l);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t a[4];
          dct::ldsm_x4_t(a, dct::smem_u32(s_dst + (kk * 16 + row_k) * LDP + (qg * 2 + ch_k) * 8));
#pragma unroll
          for (int dd = 0; dd < DQN / 2; ++dd) {
            uint32_t b[4];
            dct::ldsm_x4_t(b, dct::smem_u32(s_k + R::off(kk * 16 + row_qv, c0 / 8 + dd * 2 + ch_qv)));
            dct::mma_bf16(acc[2 * dd], a, b[0], b[1]);
            dct::mma_bf16(acc[2 * dd + 1], a, b[2], b[3]);
          }
        }
      }
      // lanes t and t ^ 1 swap halves: an even t holds row g, columns
      // 8i + 2t.. 2t + 3; an odd t row g + 8, columns 8i + 2t - 2.. 2t + 1
      const bool odd = t & 1;
      const int row = q0 + qg * 16 + g + (odd ? 8 : 0);
      float* dq_row = dq_acc + ((long)n * sq + row) * cc + (long)h * D + c0 + 2 * (t & 2);
#pragma unroll
      for (int i = 0; i < DQN; ++i) {
        const float x = __shfl_xor_sync(0xffffffffu, odd ? acc[i][0] : acc[i][2], 1);
        const float y = __shfl_xor_sync(0xffffffffu, odd ? acc[i][1] : acc[i][3], 1);
        const float4 val = odd ? make_float4(x, y, acc[i][2], acc[i][3])
                               : make_float4(acc[i][0], acc[i][1], x, y);
        if (row < sq) atomicAdd(reinterpret_cast<float4*>(dq_row + i * 8), val);
      }
    }
  }

  // dk and dv rows k0 + kb + g (+8)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = k0 + kb + g + 8 * half;
    if (r >= sk) continue;
    if constexpr (Ring) {
      float* dk_row = dkv_acc + ((long)n * sk + r) * 2 * cc + (long)h * D + cb + 2 * t;
      float* dv_row = dk_row + cc;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 a = *reinterpret_cast<const float2*>(dk_row + j * 8);
        const float2 b = *reinterpret_cast<const float2*>(dv_row + j * 8);
        store2(dk_row + j * 8, a.x + dk_acc[j][2 * half], a.y + dk_acc[j][2 * half + 1]);
        store2(dv_row + j * 8, b.x + dv_acc[j][2 * half], b.y + dv_acc[j][2 * half + 1]);
      }
    } else {
      T* dk_row = dk + ((long)n * sk + r) * cc + (long)h * D + cb + 2 * t;
      T* dv_row = dv + ((long)n * sk + r) * cc + (long)h * D + cb + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        store2(dk_row + j * 8, dk_acc[j][2 * half], dk_acc[j][2 * half + 1]);
        store2(dv_row + j * 8, dv_acc[j][2 * half], dv_acc[j][2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers (one per element type and head dim), behind the C entry points
// of flash_generic_f32.cu and flash_generic_bf16.cu
// ---------------------------------------------------------------------------

template <typename T, int D, bool StateIn, bool StateOut, bool Full>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, void* m, void* l,
               void* acc, int batch, int heads, int sq, int sk, long q_sn, long q_ss, long k_sn,
               long k_ss, long v_sn, long v_ss, long o_sn, long o_ss, float scale,
               cudaStream_t st) {
  using C = FwdCfg<T, D, Full>;
  auto kernel = flash_fwd_generic<T, D, StateIn, StateOut, Full>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + C::BQ - 1) / C::BQ, heads, batch);
  kernel<<<grid, C::NT, C::SMEM, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, (float*)m, (float*)l,
      (float*)acc, sq, sk, heads, q_sn, q_ss, k_sn, k_ss, v_sn, v_ss, o_sn, o_ss,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool Full>
int fwd_plan(const void* q, const void* k, const void* v, void* o, void* lse, void* m, void* l,
             void* acc, int batch, int heads, int sq, int sk, long q_sn, long q_ss, long k_sn,
             long k_ss, long v_sn, long v_ss, long o_sn, long o_ss, int state_in, int state_out,
             float scale, cudaStream_t st) {
  auto launch = state_in ? (state_out ? launch_fwd<T, D, true, true, Full>
                                      : launch_fwd<T, D, true, false, Full>)
                         : (state_out ? launch_fwd<T, D, false, true, Full>
                                      : launch_fwd<T, D, false, false, Full>);
  return launch(q, k, v, o, lse, m, l, acc, batch, heads, sq, sk, q_sn, q_ss, k_sn, k_ss, v_sn,
                v_ss, o_sn, o_ss, scale, st);
}

// the current device's SM count, read once
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <typename T, int D>
int fwd_any(const void* q, const void* k, const void* v, void* o, void* lse, void* m, void* l,
            void* acc, int batch, int heads, int sq, int sk, long q_sn, long q_ss, long k_sn,
            long k_ss, long v_sn, long v_ss, long o_sn, long o_ss, int state_in, int state_out,
            float scale, cudaStream_t st) {
  using Fc = FwdCfg<T, D, true>;
  if constexpr (Fc::kHasFull) {
    if ((long)((sq + Fc::BQ - 1) / Fc::BQ) * heads * batch >= sm_count())
      return fwd_plan<T, D, true>(q, k, v, o, lse, m, l, acc, batch, heads, sq, sk, q_sn, q_ss,
                                  k_sn, k_ss, v_sn, v_ss, o_sn, o_ss, state_in, state_out, scale,
                                  st);
  }
  return fwd_plan<T, D, false>(q, k, v, o, lse, m, l, acc, batch, heads, sq, sk, q_sn, q_ss, k_sn,
                               k_ss, v_sn, v_ss, o_sn, o_ss, state_in, state_out, scale, st);
}

template <typename T, int D, bool Ring>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* di, void* dq_acc, void* dk, void* dv, void* dkv_acc, int batch,
               int heads, int sq, int sk, long q_sn, long q_ss, long k_sn, long k_ss, long v_sn,
               long v_ss, long d_sn, long d_ss, float scale, cudaStream_t st) {
  using C = BwdCfg<T, D>;
  auto kernel = flash_bwd_generic<T, D, Ring>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sk + C::BK - 1) / C::BK, heads, batch);
  kernel<<<grid, C::NT, C::SMEM, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)di, (float*)dq_acc, (T*)dk, (T*)dv, (float*)dkv_acc, sq, sk, heads, q_sn,
      q_ss, k_sn, k_ss, v_sn, v_ss, d_sn, d_ss, scale, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// the di pre-pass when with_di, then the backward (Ring: dk|dv added into
// dkv_acc; else stored into dk and dv)
template <typename T, int D>
int bwd_any(const void* q, const void* k, const void* v, const void* o, const void* dout,
            const void* lse, void* di, void* dq_acc, void* dk, void* dv, void* dkv_acc,
            int batch, int heads, int sq, int sk, long q_sn, long q_ss, long k_sn, long k_ss,
            long v_sn, long v_ss, long o_sn, long o_ss, long d_sn, long d_ss, int ring,
            int with_di, float scale, cudaStream_t st) {
  if (with_di) {
    const long rows = (long)batch * heads * sq;
    const int rows_per_block = 8;
    flash_bwd_di_generic<T, D><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                                 rows_per_block * 32, 0, st>>>(
        (const T*)o, (const T*)dout, (float*)di, rows, sq, heads, o_sn, o_ss, d_sn, d_ss);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  auto launch = ring ? launch_bwd<T, D, true> : launch_bwd<T, D, false>;
  return launch(q, k, v, dout, lse, di, dq_acc, dk, dv, dkv_acc, batch, heads, sq, sk, q_sn, q_ss,
                k_sn, k_ss, v_sn, v_ss, d_sn, d_ss, scale, st);
}

}  // namespace dct_generic

// The C entry points of one element type: the forward (state_in /
// state_out for the ring's steps; both 0 for a whole call) and the backward
// (ring: add dk|dv into dkv_acc; with_di: run the di pre-pass first), each
// switching on the head dim d; a head dim the type's library does not hold
// returns cudaErrorInvalidValue.
#define DCT_FLASH_FWD_ENTRY(NAME)                                                              \
  extern "C" int dct_flash_fwd_##NAME(                                                         \
      const void* q, const void* k, const void* v, void* o, void* lse, void* m, void* l,      \
      void* acc, int batch, int heads, int sq, int sk, int d, long q_sn, long q_ss, long k_sn, \
      long k_ss, long v_sn, long v_ss, long o_sn, long o_ss, int state_in, int state_out,     \
      float scale, void* stream)
#define DCT_FLASH_FWD_ARGS                                                                     \
  q, k, v, o, lse, m, l, acc, batch, heads, sq, sk, q_sn, q_ss, k_sn, k_ss, v_sn, v_ss, o_sn,  \
      o_ss, state_in, state_out, scale, (cudaStream_t)stream
#define DCT_FLASH_BWD_ENTRY(NAME)                                                              \
  extern "C" int dct_flash_bwd_##NAME(                                                         \
      const void* q, const void* k, const void* v, const void* o, const void* dout,           \
      const void* lse, void* di, void* dq_acc, void* dk, void* dv, void* dkv_acc, int batch,  \
      int heads, int sq, int sk, int d, long q_sn, long q_ss, long k_sn, long k_ss, long v_sn, \
      long v_ss, long o_sn, long o_ss, long d_sn, long d_ss, int ring, int with_di,           \
      float scale, void* stream)
#define DCT_FLASH_BWD_ARGS                                                                     \
  q, k, v, o, dout, lse, di, dq_acc, dk, dv, dkv_acc, batch, heads, sq, sk, q_sn, q_ss, k_sn,  \
      k_ss, v_sn, v_ss, o_sn, o_ss, d_sn, d_ss, ring, with_di, scale, (cudaStream_t)stream
