// Fused 3x3 stride-1 SAME convolution for Hopper (sm_90a), NHWC, bf16
// operands, fp32 accumulation, with bias / skip / ReLU fused into the
// epilogue and an optional input mask (operand zeroed where mask <= 0, halo
// included) that can also be written back out as a second output.
//
// Replaces depth_completion_tpu/ops/conv3x3.py:_conv_kernel (:81, launched
// by _conv_call :139). The JAX package runs it on width-packed C=128 maps;
// here the real TAESD width C=64 runs unpacked.
//
// What bounds it: 2·9·Ci·Co FLOP per pixel against (Ci + Co)·2 bytes. At
// the KL VAE's widths (Ci, Co >= 128) that is >= 1,150 FLOP per byte: the
// tensor cores bound it (288x384 512->256: 261 GFLOP, 0.26 ms at 989
// TFLOP/s). At TAESD's C=64 it is ~288 FLOP/byte, at the H100's bf16 ridge;
// the masked dx reads 128 more bytes per pixel and sits below it. Before
// either bound, a block's own traffic from L2 sets the pace: each block
// stages its input halo and the weights of its output channels.
//
// Design: implicit GEMM with M = output pixels, N = Co, K = 9·Ci taken in
// (16-channel chunk, tap) order; no im2col tensor is written. A block owns
// a 4x32-pixel output tile (M = 128) and BN = 128 output channels (64 where
// Co <= 64, TAESD), so each staged halo serves 128 output channels (2x the
// first form's 64) and each staged weight chunk 128 pixels. Per K-step
// (one 16-channel chunk) a stage holds the 6x34-pixel halo of that chunk
// (6.5 KB; with a mask, its 6x34 mask tile too) and the chunk's nine taps
// for the block's channels (36 KB at BN=128): nine shifted [128 x 16] x
// [16 x BN] products read the same halo. Stages arrive through a two-stage
// cp.async ring (16-byte copies, zero-filled outside the image, past Ci and
// past Co), so chunk c+1 loads during chunk c's products. The 8 warps each
// own a 64x32 (BN=128) or 32x32 (BN=64) sub-tile and run ldmatrix +
// mma.sync m16n8k16; halo rows (32 B a pixel) and weight rows are XOR-
// swizzled by 16-byte chunk so every ldmatrix is free of bank conflicts.
// The mask cannot ride on cp.async (it copies bytes verbatim): with a mask
// the stage's halo is masked in shared memory, halo rows included, before
// the products, and the co-tile-0 block writes the masked operand for its
// own pixels. Epilogue: bias on the accumulator fragments, then an fp32
// staging tile over the drained ring; skip and ReLU in the pass that
// writes y with 16-byte stores. Occupancy: 87 KB of shared memory at
// BN=128 (63 KB with a mask at BN=64) and at most 128 registers (launch
// bounds; the build log reads 128 at BN=128 and 111 at BN=64, no spill)
// give 2 blocks (16 warps) per SM. The tap loop is unrolled by 3, not 9:
// fully unrolled, BN=128 spilled 112-148 bytes for a 0.5-3% gain (H100
// 80GB HBM3, CUDA-graph device time). A 4x32 tile also fits the native
// path's widths (152, 304, 608, 1216) better than the first form's 2x64
// (95-100% of the columns used against 79-95%).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 4;             // output rows per block
constexpr int TW = 32;            // output columns per block
constexpr int BM = TH * TW;       // output pixels per block (GEMM M)
constexpr int HR = TH + 2;        // halo rows
constexpr int HC = TW + 2;        // halo columns
constexpr int HPIX = HR * HC;     // halo pixels
constexpr int CK = 16;            // input channels per K-step (one k16 per tap)
constexpr int NTHREADS = 256;     // 8 warps
constexpr int HALO = HPIX * CK;   // bf16 elements of one staged halo chunk

template <int BN, bool MASK>
struct Cfg {
  static constexpr int WM = BN == 128 ? 2 : 4;      // warps along pixels
  static constexpr int WN = 8 / WM;                 // warps along output channels
  static constexpr int MT = BM / (WM * 16);         // m16 tiles per warp
  static constexpr int NT = BN / (WN * 8);          // n8 tiles per warp
  static constexpr int W_OFF = HALO * (MASK ? 2 : 1);  // weights after halo (and mask)
  static constexpr int STAGE = W_OFF + 9 * CK * BN;    // bf16 elements per stage
  static constexpr int LDO = BN + 8;                // fp32 staging row stride
  static constexpr int RING_BYTES = 2 * STAGE * 2;
  static constexpr int OUT_BYTES = BM * LDO * 4;
  static constexpr int SMEM = RING_BYTES > OUT_BYTES ? RING_BYTES : OUT_BYTES;
  static_assert(NT == 4, "each warp owns 32 output channels");
  static_assert(SMEM <= 232448, "tiles exceed shared memory");
};

// halo element offset of chunk c (0, 1) of pixel p: 32-byte pixel rows,
// chunk ^ bit 2 of p keeps any 8 consecutive pixels on distinct banks
__device__ __forceinline__ int halo_off(int p, int c) {
  return p * CK + ((c ^ ((p >> 2) & 1)) << 3);
}

// weight element offset of chunk nv of input-channel row kr of tap t
template <int BN>
__device__ __forceinline__ int w_off(int t, int kr, int nv) {
  return (t * CK + kr) * BN + ((nv ^ (kr & 7)) << 3);
}

__device__ __forceinline__ uint4 mask_vec(uint4 x, uint4 m) {
  const bf16* xs = reinterpret_cast<const bf16*>(&x);
  const bf16* ms = reinterpret_cast<const bf16*>(&m);
  uint4 out;
  bf16* os = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    os[e] = __bfloat162float(ms[e]) > 0.f ? xs[e] : __float2bfloat16(0.f);
  return out;
}

// cp.async one K-step: the halo of channels [c0, c0 + 16) (and its mask),
// and the nine taps of those channels for output channels [co0, co0 + BN)
template <int BN, bool MASK>
__device__ __forceinline__ void load_stage(bf16* st, const bf16* __restrict__ x,
                                           const bf16* __restrict__ mask,
                                           const bf16* __restrict__ w, int n, int H, int W,
                                           int Ci, int Co, int h0, int w0, int co0, int c0) {
  for (int i = threadIdx.x; i < HPIX * 2; i += NTHREADS) {
    const int p = i >> 1, c = i & 1;
    const int gh = h0 - 1 + p / HC, gw = w0 - 1 + p % HC, ch = c0 + c * 8;
    const bool ok = gh >= 0 && gh < H && gw >= 0 && gw < W && ch < Ci;
    const long off = ok ? (((long)n * H + gh) * W + gw) * Ci + ch : 0;
    const int so = halo_off(p, c);
    dct::cp_async_16(dct::smem_u32(st + so), x + off, ok);
    if (MASK) dct::cp_async_16(dct::smem_u32(st + HALO + so), mask + off, ok);
  }
  bf16* sw = st + Cfg<BN, MASK>::W_OFF;
  constexpr int CPR = BN / 8;  // 16-byte chunks per weight row
  for (int i = threadIdx.x; i < 9 * CK * CPR; i += NTHREADS) {
    const int nv = i % CPR, kr = (i / CPR) % CK, t = i / (CPR * CK);
    const int ci = c0 + kr;
    const bool ok = ci < Ci && co0 + nv * 8 < Co;  // w is [3][3][Ci][Co]
    const long off = ok ? ((long)t * Ci + ci) * Co + co0 + nv * 8 : 0;
    dct::cp_async_16(dct::smem_u32(sw + w_off<BN>(t, kr, nv)), w + off, ok);
  }
}

template <int BN, bool MASK>
__global__ void __launch_bounds__(NTHREADS, 2)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const bf16* __restrict__ bias, const bf16* __restrict__ skip,
               const bf16* __restrict__ mask, bf16* __restrict__ y,
               bf16* __restrict__ masked_out, int H, int W, int Ci, int Co, int relu) {
  using C = Cfg<BN, MASK>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  float* s_out = reinterpret_cast<float*>(smem_raw);  // aliases the ring after the products

  const int n_co = (Co + BN - 1) / BN;
  const int n = blockIdx.z / n_co, co0 = (blockIdx.z % n_co) * BN;
  const int h0 = blockIdx.y * TH, w0 = blockIdx.x * TW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int g = lane >> 2, t4 = lane & 3;
  // ldmatrix lanes: row lr of matrix mi; for A (pixels x channels) and for
  // B through .trans (channels x output channels) matrix mi is rows
  // +8·(mi & 1) and 16-byte chunk +(mi >> 1)
  const int lr = lane & 7, mi = lane >> 3;
  const int row8 = ((mi & 1) << 3) + lr, ch8 = mi >> 1;
  // halo pixel of this lane's A row in the warp's first m16 tile at tap
  // (0, 0); tile i lies (i / 2) output rows and (i % 2)·16 columns further
  const int a_pix = (wm * C::MT * 16 / TW) * HC + row8;
  static_assert(TW == 32 && C::MT % 2 == 0, "two m16 tiles per output row");

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nk = (Ci + CK - 1) / CK;
  load_stage<BN, MASK>(ring, x, mask, w, n, H, W, Ci, Co, h0, w0, co0, 0);
  dct::cp_async_commit();

  for (int kc = 0; kc < nk; ++kc) {
    bf16* st = ring + (kc & 1) * C::STAGE;
    dct::cp_async_wait<0>();
    __syncthreads();  // chunk kc landed; chunk kc-1's stage consumed by every warp
    if (kc + 1 < nk)
      load_stage<BN, MASK>(ring + ((kc + 1) & 1) * C::STAGE, x, mask, w, n, H, W, Ci, Co, h0,
                           w0, co0, (kc + 1) * CK);
    dct::cp_async_commit();

    if (MASK) {  // zero the operand where mask <= 0, halo rows included
      for (int i = threadIdx.x; i < HPIX * 2; i += NTHREADS) {
        const int p = i >> 1, c = i & 1;
        const int rr = p / HC, cc = p % HC;
        uint4* xs = reinterpret_cast<uint4*>(st + halo_off(p, c));
        const uint4 xv = *xs, mv = *reinterpret_cast<const uint4*>(st + HALO + halo_off(p, c));
        const uint4 val = mask_vec(xv, mv);
        *xs = val;
        // the masked operand: once per pixel (co tile 0), the tile's own pixels
        const int gh = h0 - 1 + rr, gw = w0 - 1 + cc, ch = kc * CK + c * 8;
        if (masked_out != nullptr && co0 == 0 && rr >= 1 && rr <= TH && cc >= 1 && cc <= TW &&
            gh < H && gw < W && ch < Ci)
          *reinterpret_cast<uint4*>(masked_out + (((long)n * H + gh) * W + gw) * Ci + ch) = val;
      }
      __syncthreads();
    }

    const bf16* sw = st + C::W_OFF;
#pragma unroll 3  // in full, the taps' fragments would spill past 128 registers
    for (int t = 0; t < 9; ++t) {
      const int shift = (t / 3) * HC + t % 3;
      uint32_t a[C::MT][4];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        const int p = a_pix + (i >> 1) * HC + (i & 1) * 16 + shift;
        dct::ldsm_x4(a[i], dct::smem_u32(st + halo_off(p, ch8)));
      }
#pragma unroll
      for (int jp = 0; jp < C::NT / 2; ++jp) {
        uint32_t b[4];
        const int nv = (wn * 32 + jp * 16) / 8 + ch8;
        dct::ldsm_x4_t(b, dct::smem_u32(sw + w_off<BN>(t, row8, nv)));
#pragma unroll
        for (int i = 0; i < C::MT; ++i) {
          dct::mma_bf16(acc[i][2 * jp], a[i], b[0], b[1]);
          dct::mma_bf16(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  dct::cp_async_wait<0>();
  __syncthreads();  // staging aliases the ring
  // + bias on the fragments, into the fp32 staging tile
#pragma unroll
  for (int j = 0; j < C::NT; ++j) {
    const int co = wn * 32 + j * 8 + 2 * t4;
    const bool bok = bias != nullptr && co0 + co < Co;
    const float b0 = bok ? __bfloat162float(bias[co0 + co]) : 0.f;
    const float b1 = bok ? __bfloat162float(bias[co0 + co + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < C::MT; ++i) {
      const int p = (wm * C::MT + i) * 16 + g;
      *reinterpret_cast<float2*>(s_out + p * C::LDO + co) =
          make_float2(acc[i][j][0] + b0, acc[i][j][1] + b1);
      *reinterpret_cast<float2*>(s_out + (p + 8) * C::LDO + co) =
          make_float2(acc[i][j][2] + b0, acc[i][j][3] + b1);
    }
  }
  __syncthreads();

  // + skip, ReLU, cast; 8 channels (16 bytes) per thread and step
  for (int i = threadIdx.x; i < BM * (BN / 8); i += NTHREADS) {
    const int cv = i % (BN / 8), pm = i / (BN / 8);
    const int gh = h0 + pm / TW, gw = w0 + pm % TW, co = co0 + cv * 8;
    if (gh >= H || gw >= W || co >= Co) continue;
    const long off = (((long)n * H + gh) * W + gw) * Co + co;
    const float4 lo = *reinterpret_cast<const float4*>(s_out + pm * C::LDO + cv * 8);
    const float4 hi = *reinterpret_cast<const float4*>(s_out + pm * C::LDO + cv * 8 + 4);
    float vals[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    if (skip != nullptr) {
      const uint4 sv = *reinterpret_cast<const uint4*>(skip + off);
      const bf16* ss = reinterpret_cast<const bf16*>(&sv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] += __bfloat162float(ss[e]);
    }
    uint4 ov;
    bf16* os = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int e = 0; e < 8; ++e) os[e] = __float2bfloat16(relu ? fmaxf(vals[e], 0.f) : vals[e]);
    *reinterpret_cast<uint4*>(y + off) = ov;
  }
}

template <int BN, bool MASK>
int launch(const void* x, const void* w, const void* bias, const void* skip, const void* mask,
           void* y, void* masked_out, int N, int H, int W, int Ci, int Co, int relu,
           cudaStream_t stream) {
  constexpr int smem = Cfg<BN, MASK>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<BN, MASK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_co = (Co + BN - 1) / BN;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N * n_co);
  conv3x3_kernel<BN, MASK><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)bias, (const bf16*)skip, (const bf16*)mask,
      (bf16*)y, (bf16*)masked_out, H, W, Ci, Co, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// ===========================================================================
// fp32 form (conv3x3_f32_kernel): the same function on fp32 NHWC x, skip and
// mask, fp32 HWIO weights and bias, fp32 y (and the masked x), for
// --precision fp32 (the JAX package sizes its tile by x.dtype.itemsize and
// runs this kernel at fp32 too, depth_completion_tpu/ops/conv3x3.py:69-78).
//
// Arithmetic: 3xTF32 on the tensor cores (mma.sync m16n8k8: each operand
// split into a TF32 high part and a TF32 remainder, three products per
// k-step, each k-step's sum added to the fp32 accumulator with an fp32 add;
// dct::mma_strip_tf32), so the result keeps ~22
// bits of every product where one TF32 pass keeps 11. What bounds it: as the
// bf16 form, at TF32's 495 TFLOP/s and three products a k-step (3 x the
// operations), and twice the bytes. This is the first, simple form: the same
// implicit GEMM and 4x32-pixel tile, a K-step of 8 channels (one k8 per tap),
// BN = 64 output channels a block, stages through the two-stage cp.async
// ring (fp32 needs no conversion), fragments read with scalar loads from
// padded halo rows (12 floats a pixel: conflict-free) and padded weight rows,
// and the epilogue (bias, skip, ReLU) written straight from the fragments.
// 8 warps: one output row of the tile (two m16 tiles) by 32 output channels
// each. Shared memory: 61 KB (81 KB with a mask).
// ===========================================================================

namespace {

constexpr int CK32 = 8;              // input channels per K-step
constexpr int CKP32 = 12;            // halo pixel stride (floats)
constexpr int BN32 = 64;             // output channels per block
constexpr int LDW32 = BN32 + 8;      // weight row stride (floats)
constexpr int HALO32 = HPIX * CKP32;  // floats of one staged halo chunk
constexpr int WTS32 = 9 * CK32 * LDW32;  // floats of one chunk's nine taps

template <bool MASK>
struct Cfg32 {
  static constexpr int W_OFF = HALO32 * (MASK ? 2 : 1);
  static constexpr int STAGE = W_OFF + WTS32;  // floats
  static constexpr int SMEM = 2 * STAGE * 4;
  static_assert(SMEM <= 232448, "tiles exceed shared memory");
};

template <bool MASK>
__device__ __forceinline__ void load_stage32(float* st, const float* __restrict__ x,
                                             const float* __restrict__ mask,
                                             const float* __restrict__ w, int n, int H, int W,
                                             int Ci, int Co, int h0, int w0, int co0, int c0) {
  for (int i = threadIdx.x; i < HPIX * 2; i += NTHREADS) {
    const int p = i >> 1, c = i & 1;
    const int gh = h0 - 1 + p / HC, gw = w0 - 1 + p % HC, ch = c0 + c * 4;
    const bool ok = gh >= 0 && gh < H && gw >= 0 && gw < W && ch < Ci;
    const long off = ok ? (((long)n * H + gh) * W + gw) * Ci + ch : 0;
    const int so = p * CKP32 + c * 4;
    dct::cp_async_16(dct::smem_u32(st + so), x + off, ok);
    if (MASK) dct::cp_async_16(dct::smem_u32(st + HALO32 + so), mask + off, ok);
  }
  float* sw = st + Cfg32<MASK>::W_OFF;
  constexpr int CPR = BN32 / 4;  // 16-byte chunks per weight row
  for (int i = threadIdx.x; i < 9 * CK32 * CPR; i += NTHREADS) {
    const int nv = i % CPR, kr = (i / CPR) % CK32, t = i / (CPR * CK32);
    const int ci = c0 + kr;
    const bool ok = ci < Ci && co0 + nv * 4 < Co;  // w is [3][3][Ci][Co]
    const long off = ok ? ((long)t * Ci + ci) * Co + co0 + nv * 4 : 0;
    dct::cp_async_16(dct::smem_u32(sw + (t * CK32 + kr) * LDW32 + nv * 4), w + off, ok);
  }
}

template <bool MASK>
__global__ void __launch_bounds__(NTHREADS, 2)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ skip,
                   const float* __restrict__ mask, float* __restrict__ y,
                   float* __restrict__ masked_out, int H, int W, int Ci, int Co, int relu) {
  using C = Cfg32<MASK>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);

  const int n_co = (Co + BN32 - 1) / BN32;
  const int n = blockIdx.z / n_co, co0 = (blockIdx.z % n_co) * BN32;
  const int h0 = blockIdx.y * TH, w0 = blockIdx.x * TW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;  // output row wm of the tile; channels 32·wn..
  const int g = lane >> 2, t4 = lane & 3;

  float acc[2][4][4];  // m16 tiles (columns 0-15, 16-31) x n8 tiles
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nk = (Ci + CK32 - 1) / CK32;
  load_stage32<MASK>(ring, x, mask, w, n, H, W, Ci, Co, h0, w0, co0, 0);
  dct::cp_async_commit();

  for (int kc = 0; kc < nk; ++kc) {
    float* st = ring + (kc & 1) * C::STAGE;
    dct::cp_async_wait<0>();
    __syncthreads();  // chunk kc landed; chunk kc-1's stage consumed by every warp
    if (kc + 1 < nk)
      load_stage32<MASK>(ring + ((kc + 1) & 1) * C::STAGE, x, mask, w, n, H, W, Ci, Co, h0, w0,
                         co0, (kc + 1) * CK32);
    dct::cp_async_commit();

    if (MASK) {  // zero the operand where mask <= 0, halo rows included
      for (int i = threadIdx.x; i < HPIX * 2; i += NTHREADS) {
        const int p = i >> 1, c = i & 1;
        const int rr = p / HC, cc = p % HC;
        float4* xs = reinterpret_cast<float4*>(st + p * CKP32 + c * 4);
        const float4 xv = *xs;
        const float4 mv = *reinterpret_cast<const float4*>(st + HALO32 + p * CKP32 + c * 4);
        const float4 val = make_float4(mv.x > 0.f ? xv.x : 0.f, mv.y > 0.f ? xv.y : 0.f,
                                       mv.z > 0.f ? xv.z : 0.f, mv.w > 0.f ? xv.w : 0.f);
        *xs = val;
        // the masked operand: once per pixel (co tile 0), the tile's own pixels
        const int gh = h0 - 1 + rr, gw = w0 - 1 + cc, ch = kc * CK32 + c * 4;
        if (masked_out != nullptr && co0 == 0 && rr >= 1 && rr <= TH && cc >= 1 && cc <= TW &&
            gh < H && gw < W && ch < Ci)
          *reinterpret_cast<float4*>(masked_out + (((long)n * H + gh) * W + gw) * Ci + ch) = val;
      }
      __syncthreads();
    }

    const float* sw = st + C::W_OFF;
#pragma unroll 3
    for (int t = 0; t < 9; ++t) {
      const int dh = t / 3, dw = t % 3;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        dct::mma_strip_tf32<true, 4>(acc[i], st + ((wm + dh) * HC + i * 16 + dw) * CKP32, CKP32,
                                     1, sw + t * CK32 * LDW32 + wn * 32, LDW32, 1, CK32);
    }
  }

  // epilogue from the fragments: + bias, + skip, ReLU; float2 stores
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + wn * 32 + j * 8 + 2 * t4;
    if (co >= Co) continue;
    const float b0 = bias != nullptr ? bias[co] : 0.f;
    const float b1 = bias != nullptr ? bias[co + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gh = h0 + wm, gw = w0 + i * 16 + g + 8 * half;
        if (gh >= H || gw >= W) continue;
        const long off = (((long)n * H + gh) * W + gw) * Co + co;
        float v0 = acc[i][j][2 * half] + b0, v1 = acc[i][j][2 * half + 1] + b1;
        if (skip != nullptr) {
          const float2 s = *reinterpret_cast<const float2*>(skip + off);
          v0 += s.x;
          v1 += s.y;
        }
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<float2*>(y + off) = make_float2(v0, v1);
      }
  }
}

template <bool MASK>
int launch32(const void* x, const void* w, const void* bias, const void* skip, const void* mask,
             void* y, void* masked_out, int N, int H, int W, int Ci, int Co, int relu,
             cudaStream_t stream) {
  constexpr int smem = Cfg32<MASK>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_f32_kernel<MASK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_co = (Co + BN32 - 1) / BN32;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N * n_co);
  conv3x3_f32_kernel<MASK><<<grid, NTHREADS, smem, stream>>>(
      (const float*)x, (const float*)w, (const float*)bias, (const float*)skip,
      (const float*)mask, (float*)y, (float*)masked_out, H, W, Ci, Co, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dct_conv3x3(const void* x, const void* w, const void* bias, const void* skip,
                           const void* mask, void* y, void* masked_out, int N, int H, int W,
                           int Ci, int Co, int relu, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Co <= 64)
    return mask != nullptr
               ? launch<64, true>(x, w, bias, skip, mask, y, masked_out, N, H, W, Ci, Co, relu, st)
               : launch<64, false>(x, w, bias, skip, mask, y, masked_out, N, H, W, Ci, Co, relu, st);
  return mask != nullptr
             ? launch<128, true>(x, w, bias, skip, mask, y, masked_out, N, H, W, Ci, Co, relu, st)
             : launch<128, false>(x, w, bias, skip, mask, y, masked_out, N, H, W, Ci, Co, relu, st);
}

extern "C" int dct_conv3x3_f32(const void* x, const void* w, const void* bias, const void* skip,
                               const void* mask, void* y, void* masked_out, int N, int H, int W,
                               int Ci, int Co, int relu, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return mask != nullptr
             ? launch32<true>(x, w, bias, skip, mask, y, masked_out, N, H, W, Ci, Co, relu, st)
             : launch32<false>(x, w, bias, skip, mask, y, masked_out, N, H, W, Ci, Co, relu, st);
}
