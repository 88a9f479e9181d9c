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
// Arithmetic: every product runs on the tensor cores as mma.sync m16n8k8
// with TF32 operands and fp32 accumulation. fp32 operands take 3xTF32: each
// split into a TF32 high part and a TF32 remainder, three products per
// k-step (hi·lo', lo·hi', hi·hi'), ~2^-22 of each product kept where one TF32
// pass keeps 2^-11 (dct::mma_strip_tf32). bf16 operands are exact in TF32, so
// they take one pass; p and ds are rounded to bf16 before their products, as
// the bf16 kernels do. Softmax state, row statistics and accumulators are
// fp32 at either dtype, and every sum is taken with fp32 adds: each
// k-step's products land in a zeroed fragment first (dct::mma_strip_tf32
// says why).
//
// What bounds it: the tensor cores, as for the bf16 kernels (4·S²·d FLOP
// forward, 10·S²·d backward, against ~4·S·d operand bytes), at TF32's 495
// TFLOP/s dense, and three products per k-step at fp32: 3 x the operations.
// This is the first, simple form: tiles are staged into shared memory as
// fp32 by plain loads (no cp.async ring), fragments are read with scalar
// loads from padded rows (no ldmatrix), and the score tile makes a round trip
// through shared memory between its product and the softmax. Its times
// against that bound are in PERF.md.
//
// Forward (flash_fwd_generic<T, D, StateIn, StateOut>): a block owns BQ
// query rows of one (batch, head) and walks the keys in BK-row tiles. Warps
// are laid out as (row group of 16 queries) x (WSPLIT channel slices of DW =
// D / WSPLIT channels): each warp forms the partial scores of its 16 rows
// over its channel slice for all BK keys and writes them to its own slice of
// the score buffer; the softmax pass (four threads a row) adds the slices,
// scales, masks keys past sk, takes the running max, writes p over slice 0
// and keeps m, l and this tile's α per row in shared memory; each warp then
// rescales its o accumulator (16 rows x DW channels in registers) by α and
// adds p·v over its channels. Tile plan: D <= 128: 64-row query blocks and
// key tiles, 4 warps, o over all D channels (the d=64 kernel's plan); D >=
// 256: 32-row query blocks and key tiles, 2 row groups x D/128 slices of 128
// channels (the d=512 kernel's plan of warps splitting the channels), so
// that o stays at 64 fp32 registers a lane
// and fp32 tiles fit the 227 KB of shared memory (q, k, v of 32 x 512 fp32
// and the score slices: 212 KB at D=512). The ring's state (StateIn /
// StateOut: m, l [N, heads, sq], acc [N, sq, heads·D], fp32) is read into
// and written from the same registers and rows, as flash_fwd_kernel does.
//
// Backward (flash_bwd_generic<T, D, Ring>): a block owns BK key rows and
// walks the queries in BQ-row tiles (D <= 128: 64 and 64; D >= 256: 32 and
// 16, so that k, v, q and dO fit as fp32). Per query tile: the partial
// products s = q·kᵀ and dp = dO·vᵀ (m16 x n32 strips, the contraction split
// into KS slices of D / KS channels) go to shared slices; one pass adds the
// slices and forms p = exp2(s·scale·log2e − lse2) and ds = p∘(dp − di)·scale
// (zero past sq and sk); then each warp, owning 16 key rows x 64 channels of
// dk and dv in registers, adds dv += pᵀ·dO and dk += dsᵀ·q, and the warps
// form dq = ds·k for the tile's rows (16 x 64 each) and add it into the fp32
// dq with float2 atomics. Ring: dk and dv are added into the travelling fp32
// dk|dv ([N, sk, 2·heads·D]) in place of the stores: each element belongs to
// one thread of one block, so a plain read-add-write is exact. di =
// rowsum(dO∘o) comes from flash_bwd_di_generic, launched by the same entry
// point when asked.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sync.cuh"

namespace dct_generic {

typedef __nv_bfloat16 bf16;

template <typename T, int D>
struct FwdCfg {
  static constexpr bool kSplit = std::is_same<T, float>::value;  // 3xTF32
  static constexpr int BQ = D <= 128 ? 64 : 32;        // query rows per block
  static constexpr int BK = D <= 128 ? 64 : 32;        // key rows per tile
  static constexpr int WSPLIT = D <= 128 ? 1 : D / 128;  // channel slices
  static constexpr int DW = D / WSPLIT;                // channels of o per warp
  static constexpr int NW = (BQ / 16) * WSPLIT;
  static constexpr int NT = NW * 32;
  static constexpr int LDX = D + 4;   // q and k rows (floats): A and B reads conflict-free
  static constexpr int LDV = D + 8;   // v rows: B reads of p·v conflict-free
  static constexpr int LDS = BK + 4;  // score rows
  static constexpr int FLOATS = BQ * LDX + BK * LDX + BK * LDV + WSPLIT * BQ * LDS + 3 * BQ;
  static constexpr int SMEM = FLOATS * 4;
  static_assert(D % 64 == 0 && DW % 8 == 0 && BK % 8 == 0, "tile shapes");
  static_assert(SMEM <= 232448, "forward tiles exceed shared memory");
};

template <typename T, int D>
struct BwdCfg {
  static constexpr bool kSplit = std::is_same<T, float>::value;
  static constexpr int BK = D <= 128 ? 64 : 32;   // key rows per block
  static constexpr int BQ = D <= 128 ? 64 : 16;   // query rows per tile
  static constexpr int WSPLIT = D / 64;           // dk, dv: 64 channels per warp
  static constexpr int NW = (BK / 16) * WSPLIT;
  static constexpr int NT = NW * 32;
  static constexpr int KS = D <= 128 ? 1 : 4;     // contraction slices of s and dp
  static constexpr int KC = D / KS;               // channels per slice
  static constexpr int LDX = D + 4;               // k, v, q and dO rows
  static constexpr int LDS = BK + 8;              // s / p and dp / ds rows
  static constexpr int FLOATS = 2 * BK * LDX + 2 * BQ * LDX + 2 * KS * BQ * LDS + 2 * BQ;
  static constexpr int SMEM = FLOATS * 4;
  static_assert(BQ % 16 == 0 && BK % 32 == 0 && KC % 8 == 0, "tile shapes");
  static_assert(NT <= 1024, "too many threads");
  static_assert(SMEM <= 232448, "backward tiles exceed shared memory");
};

// 8 consecutive elements as fp32 (16 bytes of bf16 or 32 of fp32, aligned)
__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* src, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}

__device__ __forceinline__ void store2(bf16* dst, float x, float y) {
  *reinterpret_cast<uint32_t*>(dst) = dct::pack_bf16(x, y);
}

// rows [row0, row0 + rows) x cols channels of a strided matrix into fp32
// shared rows of stride ld; rows at or past nrows are zero-filled
template <int NT, typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src, long row_stride,
                                           int row0, int nrows, int rows, int cols) {
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += NT) {
    const int r = i / chunks, c = (i % chunks) * 8;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row0 + r < nrows) load8(src + (long)(row0 + r) * row_stride + c, v);
    float4* d = reinterpret_cast<float4*>(dst + r * ld + c);
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// one warp's m16 x n(8·NN) C fragments into fp32 shared rows of stride ld
template <int NN>
__device__ __forceinline__ void store_frags(float* dst, int ld, const float (&c)[NN][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NN; ++j) {
    store2(dst + g * ld + j * 8 + 2 * t, c[j][0], c[j][1]);
    store2(dst + (g + 8) * ld + j * 8 + 2 * t, c[j][2], c[j][3]);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// StateIn / StateOut as flash_fwd_kernel's: <false, false> is the forward,
// the ring's first step <false, true>, its middle steps <true, true>, its
// last <true, false>
template <typename T, int D, bool StateIn, bool StateOut>
__global__ void __launch_bounds__(FwdCfg<T, D>::NT, 1)
flash_fwd_generic(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, float* __restrict__ lse, float* __restrict__ m_st,
                  float* __restrict__ l_st, float* __restrict__ acc_st, int sq, int sk,
                  int heads, long q_sn, long q_ss, long k_sn, long k_ss, long v_sn, long v_ss,
                  long o_sn, long o_ss, float scale_log2) {
  using C = FwdCfg<T, D>;
  constexpr int BQ = C::BQ, BK = C::BK, LDX = C::LDX, LDV = C::LDV, LDS = C::LDS;
  constexpr int NT = C::NT, DW = C::DW, NN = DW / 8;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                              // [BQ][LDX]
  float* s_k = s_q + BQ * LDX;                    // [BK][LDX]
  float* s_v = s_k + BK * LDX;                    // [BK][LDV]
  float* s_s = s_v + BK * LDV;                    // [WSPLIT][BQ][LDS]: score slices; p in slice 0
  float* s_m = s_s + C::WSPLIT * BQ * LDS;        // [BQ] running max (log2 domain)
  float* s_l = s_m + BQ;                          // [BQ] running row sum
  float* s_a = s_l + BQ;                          // [BQ] this tile's α

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rb = (warp / C::WSPLIT) * 16;   // this warp's first row in the block
  const int cb = (warp % C::WSPLIT) * DW;   // its first channel
  const long stat_bh = ((long)n * heads + h) * sq;
  const T* kb = k + n * k_sn + (long)h * D;
  const T* vb = v + n * v_sn + (long)h * D;
  const int r0 = q0 + rb + g, r1 = r0 + 8;   // this lane's rows
  const long cc = (long)heads * D;           // channels of a row of the ring's acc

  stage_rows<NT>(s_q, LDX, q + n * q_sn + (long)h * D, q_ss, q0, sq, BQ, D);
  for (int i = threadIdx.x; i < BQ; i += NT) {
    float m = -INFINITY, l = 0.f;
    if (StateIn && q0 + i < sq) {
      m = m_st[stat_bh + q0 + i];
      l = l_st[stat_bh + q0 + i];
    }
    s_m[i] = m;
    s_l[i] = l;
  }
  float acc[NN][4];  // o of rows r0, r1 over channels cb + 8j + 2t, +1
#pragma unroll
  for (int j = 0; j < NN; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  if constexpr (StateIn) {
    const float* a0 = acc_st + ((long)n * sq + r0) * cc + (long)h * D + cb + 2 * t;
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      if (r0 < sq) {
        const float2 x = *reinterpret_cast<const float2*>(a0 + j * 8);
        acc[j][0] = x.x;
        acc[j][1] = x.y;
      }
      if (r1 < sq) {
        const float2 x = *reinterpret_cast<const float2*>(a0 + 8 * cc + j * 8);
        acc[j][2] = x.x;
        acc[j][3] = x.y;
      }
    }
  }

  const int ntiles = (sk + BK - 1) / BK;
  for (int j = 0; j < ntiles; ++j) {
    __syncthreads();  // tile j-1's k, v and p consumed by every warp
    stage_rows<NT>(s_k, LDX, kb, k_ss, j * BK, sk, BK, D);
    stage_rows<NT>(s_v, LDV, vb, v_ss, j * BK, sk, BK, D);
    __syncthreads();
    {  // this warp's slice of s = q kᵀ: its 16 rows, its channels, all BK keys
      float s[BK / 8][4];
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dct::mma_strip_tf32<C::kSplit, BK / 8>(s, s_q + rb * LDX + cb, LDX, 1, s_k + cb, 1, LDX,
                                             DW);
      store_frags<BK / 8>(s_s + ((warp % C::WSPLIT) * BQ + rb) * LDS, LDS, s);
    }
    __syncthreads();
    // online softmax, four threads a row: the slices added, scaled, keys at
    // or past sk at -inf; p over slice 0
    for (int r = threadIdx.x >> 2; r < BQ; r += NT / 4) {
      const int part = threadIdx.x & 3;
      float mx = -INFINITY;
      for (int c = part; c < BK; c += 4) {
        float x = 0.f;
#pragma unroll
        for (int w = 0; w < C::WSPLIT; ++w) x += s_s[(w * BQ + r) * LDS + c];
        x = j * BK + c < sk ? x * scale_log2 : -INFINITY;
        s_s[r * LDS + c] = x;
        mx = fmaxf(mx, x);
      }
      mx = quad_max(mx);  // key j·BK < sk is in every row: finite
      const float m_old = s_m[r], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = part; c < BK; c += 4) {
        const float p = exp2f(s_s[r * LDS + c] - m_new);
        sum += p;
        s_s[r * LDS + c] = C::kSplit ? p : dct::round_bf16(p);  // bf16: p·v on bf16 p
      }
      sum = quad_sum(sum);
      if (part == 0) {
        const float alpha = exp2f(m_old - m_new);  // 0 at the first tile without state
        s_a[r] = alpha;
        s_m[r] = m_new;
        s_l[r] = s_l[r] * alpha + sum;
      }
    }
    __syncthreads();
    const float alpha0 = s_a[rb + g], alpha1 = s_a[rb + g + 8];
#pragma unroll
    for (int i = 0; i < NN; ++i) {
      acc[i][0] *= alpha0;
      acc[i][1] *= alpha0;
      acc[i][2] *= alpha1;
      acc[i][3] *= alpha1;
    }
    // o += p v over this warp's rows and channels
    dct::mma_strip_tf32<C::kSplit, NN>(acc, s_s + rb * LDS, LDS, 1, s_v + cb, LDV, 1, BK);
  }
  // s_m and s_l were last written before the last tile's barrier

  if constexpr (StateOut) {  // the state for the next ring step, in place
    float* a0 = acc_st + ((long)n * sq + r0) * cc + (long)h * D + cb + 2 * t;
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      if (r0 < sq) store2(a0 + j * 8, acc[j][0], acc[j][1]);
      if (r1 < sq) store2(a0 + 8 * cc + j * 8, acc[j][2], acc[j][3]);
    }
    for (int i = threadIdx.x; i < BQ; i += NT) {
      if (q0 + i < sq) {
        m_st[stat_bh + q0 + i] = s_m[i];
        l_st[stat_bh + q0 + i] = s_l[i];
      }
    }
    return;
  }
  const float l0 = s_l[rb + g], l1 = s_l[rb + g + 8];
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
  T* o0 = o + n * o_sn + (long)r0 * o_ss + (long)h * D + cb + 2 * t;
#pragma unroll
  for (int j = 0; j < NN; ++j) {
    if (r0 < sq) store2(o0 + j * 8, acc[j][0] * inv0, acc[j][1] * inv0);
    if (r1 < sq) store2(o0 + 8 * o_ss + j * 8, acc[j][2] * inv1, acc[j][3] * inv1);
  }
  for (int i = threadIdx.x; i < BQ; i += NT) {
    if (q0 + i < sq) lse[stat_bh + q0 + i] = s_m[i] + (s_l[i] == 0.f ? 0.f : log2f(s_l[i]));
  }
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

template <typename T, int D, bool Ring>
__global__ void __launch_bounds__(BwdCfg<T, D>::NT, 1)
flash_bwd_generic(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ di, float* __restrict__ dq_acc, T* __restrict__ dk,
                  T* __restrict__ dv, float* __restrict__ dkv_acc, int sq, int sk, int heads,
                  long q_sn, long q_ss, long k_sn, long k_ss, long v_sn, long v_ss, long d_sn,
                  long d_ss, float scale, float scale_log2) {
  using C = BwdCfg<T, D>;
  constexpr int BQ = C::BQ, BK = C::BK, LDX = C::LDX, LDS = C::LDS, KS = C::KS, KC = C::KC;
  constexpr int NT = C::NT, NW = C::NW;
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;                  // [BK][LDX]
  float* s_v = s_k + BK * LDX;        // [BK][LDX]
  float* s_q = s_v + BK * LDX;        // [BQ][LDX]
  float* s_do = s_q + BQ * LDX;       // [BQ][LDX]
  float* s_s = s_do + BQ * LDX;       // [KS][BQ][LDS]: s slices; p in slice 0
  float* s_dp = s_s + KS * BQ * LDS;  // [KS][BQ][LDS]: dp slices; ds in slice 0
  float* s_lse = s_dp + KS * BQ * LDS;  // [BQ]
  float* s_di = s_lse + BQ;             // [BQ]

  const int k0 = blockIdx.x * BK, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kb = (warp / C::WSPLIT) * 16;  // this warp's first key row of dk, dv
  const int cb = (warp % C::WSPLIT) * 64;  // and its first channel
  const T* qb = q + n * q_sn + (long)h * D;
  const T* db = dout + n * d_sn + (long)h * D;
  const float* lse_bh = lse + ((long)n * heads + h) * sq;
  const float* di_bh = di + ((long)n * heads + h) * sq;
  const long cc = (long)heads * D;  // dq_acc, dk, dv are contiguous [N, S, heads·D]

  stage_rows<NT>(s_k, LDX, k + n * k_sn + (long)h * D, k_ss, k0, sk, BK, D);
  stage_rows<NT>(s_v, LDX, v + n * v_sn + (long)h * D, v_ss, k0, sk, BK, D);
  float dk_acc[8][4], dv_acc[8][4];  // key rows kb + g (+8), channels cb + 8j + 2t
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  const int ntiles = (sq + BQ - 1) / BQ;
  for (int jq = 0; jq < ntiles; ++jq) {
    const int q0 = jq * BQ;
    __syncthreads();  // the tile before consumed by every warp
    stage_rows<NT>(s_q, LDX, qb, q_ss, q0, sq, BQ, D);
    stage_rows<NT>(s_do, LDX, db, d_ss, q0, sq, BQ, D);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const bool ok = q0 + i < sq;
      s_lse[i] = ok ? lse_bh[q0 + i] : 0.f;
      s_di[i] = ok ? di_bh[q0 + i] : 0.f;
    }
    __syncthreads();
    // s = q kᵀ and dp = dO vᵀ: m16 x n32 strips, each over one contraction slice
    constexpr int RG = BQ / 16, NG = BK / 32, ITEMS = 2 * RG * NG * KS;
    for (int it = warp; it < ITEMS; it += NW) {
      const int ks = it % KS, ng = (it / KS) % NG, rg = (it / (KS * NG)) % RG;
      const bool dp = it >= RG * NG * KS;
      float c[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
      dct::mma_strip_tf32<C::kSplit, 4>(c, (dp ? s_do : s_q) + rg * 16 * LDX + ks * KC, LDX, 1,
                                        (dp ? s_v : s_k) + ng * 32 * LDX + ks * KC, 1, LDX, KC);
      store_frags<4>((dp ? s_dp : s_s) + (ks * BQ + rg * 16) * LDS + ng * 32, LDS, c);
    }
    __syncthreads();
    // p = exp2(s·scale·log2e − lse2), ds = p∘(dp − di)·scale; 0 past sq and sk
    for (int e = threadIdx.x; e < BQ * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      float s = 0.f, d = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        s += s_s[(ks * BQ + r) * LDS + c];
        d += s_dp[(ks * BQ + r) * LDS + c];
      }
      float p = exp2f(s * scale_log2 - s_lse[r]);
      if (q0 + r >= sq || k0 + c >= sk) p = 0.f;
      const float ds = p * (d - s_di[r]) * scale;
      s_s[r * LDS + c] = C::kSplit ? p : dct::round_bf16(p);
      s_dp[r * LDS + c] = C::kSplit ? ds : dct::round_bf16(ds);
    }
    __syncthreads();
    // dv += pᵀ dO and dk += dsᵀ q over this warp's key rows and channels
    dct::mma_strip_tf32<C::kSplit, 8>(dv_acc, s_s + kb, 1, LDS, s_do + cb, LDX, 1, BQ);
    dct::mma_strip_tf32<C::kSplit, 8>(dk_acc, s_dp + kb, 1, LDS, s_q + cb, LDX, 1, BQ);
    // dq rows of this tile += ds k: 16 rows x 64 channels per item, float2 atomics
    constexpr int DQ_ITEMS = RG * (D / 64);
    for (int it = warp; it < DQ_ITEMS; it += NW) {
      const int rq = it / (D / 64), cq = (it % (D / 64)) * 64;
      float c[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
      dct::mma_strip_tf32<C::kSplit, 8>(c, s_dp + rq * 16 * LDS, LDS, 1, s_k + cq, LDX, 1, BK);
      const int row = q0 + rq * 16 + g;
      float* dq0 = dq_acc + ((long)n * sq + row) * cc + (long)h * D + cq + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (row < sq) atomicAdd(reinterpret_cast<float2*>(dq0 + j * 8), make_float2(c[j][0], c[j][1]));
        if (row + 8 < sq)
          atomicAdd(reinterpret_cast<float2*>(dq0 + 8 * cc + j * 8), make_float2(c[j][2], c[j][3]));
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

template <typename T, int D, bool StateIn, bool StateOut>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, void* m, void* l,
               void* acc, int batch, int heads, int sq, int sk, long q_sn, long q_ss, long k_sn,
               long k_ss, long v_sn, long v_ss, long o_sn, long o_ss, float scale,
               cudaStream_t st) {
  using C = FwdCfg<T, D>;
  auto kernel = flash_fwd_generic<T, D, StateIn, StateOut>;
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

template <typename T, int D>
int fwd_any(const void* q, const void* k, const void* v, void* o, void* lse, void* m, void* l,
            void* acc, int batch, int heads, int sq, int sk, long q_sn, long q_ss, long k_sn,
            long k_ss, long v_sn, long v_ss, long o_sn, long o_ss, int state_in, int state_out,
            float scale, cudaStream_t st) {
  auto launch = state_in ? (state_out ? launch_fwd<T, D, true, true> : launch_fwd<T, D, true, false>)
                         : (state_out ? launch_fwd<T, D, false, true>
                                      : launch_fwd<T, D, false, false>);
  return launch(q, k, v, o, lse, m, l, acc, batch, heads, sq, sk, q_sn, q_ss, k_sn, k_ss, v_sn,
                v_ss, o_sn, o_ss, scale, st);
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
