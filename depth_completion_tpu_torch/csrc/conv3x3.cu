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
// mask, fp32 weights and bias, fp32 y (and the masked x), for
// --precision fp32 (the JAX package sizes its tile by x.dtype.itemsize and
// runs this kernel at fp32 too, depth_completion_tpu/ops/conv3x3.py:69-78).
// The weights come K-major, OHWI [Co][3][3][Ci] (ops/conv3x3.py _k_major:
// the one copy per call that the wrapper made of HWIO before makes this
// layout now; 72·Ci·Co bytes read and written, 2-10 us a call, 4-27 us
// with the dx's flip; scripts/kernel_ab.py).
//
// Arithmetic: 3xTF32 on the tensor cores: each operand split into a TF32
// high part and a TF32 remainder (dct::tf32_split, integer rounding), three
// products a k-step (lo·hi', hi·lo', hi·hi'), ~22 bits of each product kept
// where one TF32 pass keeps 11. The tensor cores sum one stage's products
// (27 wgmma k8 steps: K = 72, 216 products an output) in a zeroed
// accumulator; it joins the fp32 sum with fp32 adds after the stage's
// wgmma.wait. Against the fp32 twin this reads at most 0.21 of FP32_REL
// (at Ci = 512, K = 4608; PERF.md).
//
// What bounds it: the tensor cores at 3xTF32 (3·2·9·Ci·Co FLOP a pixel at
// TF32's 494.7 TFLOP/s: 0.79 ms at 576x768 128->128; chip_smoke.py's bound
// counts each product once). Before them, on this card, two budgets of the
// SM: shared memory (128 bytes a clock: wgmma reads both operands there, and
// each stage passes through it four times: copied, read, written as hi and
// lo) and the L2 (each block reads every weight of its output channels once
// per call).
//
// Design: the implicit GEMM of the bf16 form (M = output pixels, N = Co, K =
// 9·Ci) on wgmma.mma_async m64n64k8 .tf32 (sm_90a), both operands from
// shared memory through matrix descriptors in the no-swizzle K-major layout:
// 8-row core matrices of 16 bytes a row (4 channels), 128 bytes each. A
// block (two consumer warpgroups, 256 threads) owns TH32 = 4 output rows of
// TW32 = 64 columns and BN32 = 64 output channels; each warpgroup owns two
// rows, one m64 tile each. A stage is CK32 = 8 input channels and all nine
// taps. The halo (6 x 66 pixels) is staged as planes [4-channel
// group][pixel][4]: any 8 pixels in a row of it form one core matrix, so tap
// (kh, kw)'s A tile is a descriptor on the same planes started kh rows and
// kw pixels further (no im2col copy). The weights are staged [tap][4-channel
// group][co][4] from the OHWI rows (wgmma takes .tf32 operands K-major only).
// A stage lands raw through 16-byte cp.async (zero-filled outside the image
// and past Ci; each thread's copies are addressed once per block) in a raw
// ring of NR slots, and every thread splits it once into one of two split
// slots: hi and lo planes, read by the products (with a mask the operand is
// masked in the same pass, halo rows included, and the co-tile-0 block
// writes the masked operand of its own pixels); no element is split twice
// in a block, none once a tap. While the tensor cores run stage s, the
// threads copy stage s+NR into the raw slot stage s left and split stage
// s+1; two block barriers a stage, NR - 1 stages in flight.
// Why this tile at every width (H100 80GB HBM3, 700 W; PERF.md): blocks of
// 128 pixels x 128 output channels at the KL widths were L2-bound (their
// copies alone took 1.12 ms at 576x768 128->128, as long as their
// products); 256 x 64 blocks read 37% fewer bytes a product from the L2 and
// ran 6-8% faster. A thread-block cluster sharing each weight stage through
// distributed shared memory, and two stage accumulators (ptxas then
// serialises the wgmmas, C7514), both ran slower.
// Occupancy: 185 registers (238 with a mask), 213 KB of shared memory
// (NR = 3; 207 KB and NR = 2 with a mask): one block (8 warps) an SM.
// Blocks: 576x768x64 1728 (13.1 waves of 132), 576x768 128->128 3456
// (26.2), 288x384 512->256 1728 (13.1), 352x1216x64 1672 (12.7; the native
// decoder's widths 152, 304, 608 fill 79%, 95%, 95% of their 64-column
// tiles), 72x96x512 288 (2.2 waves, 75% of the columns), the ragged
// 2x13x37 256->128 16.
// ===========================================================================

namespace {

constexpr int TW32 = 64;                  // output columns per block: one m64 tile a row
constexpr int HC32 = TW32 + 2;            // halo columns
constexpr int BN32 = 64;                  // output channels per block (wgmma N)
constexpr int MT32 = 2;                   // m64 tiles (output rows) per warpgroup
constexpr int TH32 = 2 * MT32;            // output rows per block
constexpr int CK32 = 8;                   // input channels per stage: one k8 step a tap
constexpr int NPIX32 = (TH32 + 2) * HC32;  // halo pixels
constexpr int A32 = CK32 * NPIX32;        // floats of a stage's halo
constexpr int B32 = 9 * CK32 * BN32;      // floats of its weights
constexpr int XS32 = 2 * (A32 + B32);     // a split slot: A hi, A lo, B hi, B lo
constexpr int NA32 = (A32 / 4 + NTHREADS - 1) / NTHREADS;  // a thread's 16-byte halo copies
constexpr int NB32 = (B32 / 4 + NTHREADS - 1) / NTHREADS;  // its weight copies

template <bool MASK>
struct Ring32 {  // raw ring: NR slots of [x | mask | weights] as cp.async lands them
  static constexpr int RB = (MASK ? 2 : 1) * A32;  // the weights' offset in a slot
  static constexpr int RS = RB + B32;              // floats of a slot
  static constexpr int NR_FIT = (232448 / 4 - 2 * XS32) / RS;
  static constexpr int NR = NR_FIT < 3 ? NR_FIT : 3;
  static constexpr int SMEM = (2 * XS32 + NR * RS) * 4;
  static_assert(NR >= 2, "the raw ring needs two slots");
};

// matrix descriptor, no swizzle: start, leading (K: next 4 channels) and
// stride (M or N: next 8 rows) byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// after the wait: the accumulator is read only past this point
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A · B, m64n64k8, tf32 operands from shared memory; scale_d = 0
// zeroes d first. Accumulator fragment of a warpgroup thread (warp w, g =
// lane / 4, t = lane % 4): d[4j], d[4j+1] at row 16w + g, columns 8j + 2t,
// +1; d[4j+2], d[4j+3] at row + 8.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ float4 mask4(float4 x, float4 m) {
  return make_float4(m.x > 0.f ? x.x : 0.f, m.y > 0.f ? x.y : 0.f, m.z > 0.f ? x.z : 0.f,
                     m.w > 0.f ? x.w : 0.f);
}

__device__ __forceinline__ void split4(float4 v, float4& hi, float4& lo) {
  uint32_t h, l;
  dct::tf32_split(v.x, h, l);
  hi.x = __uint_as_float(h), lo.x = __uint_as_float(l);
  dct::tf32_split(v.y, h, l);
  hi.y = __uint_as_float(h), lo.y = __uint_as_float(l);
  dct::tf32_split(v.z, h, l);
  hi.z = __uint_as_float(h), lo.z = __uint_as_float(l);
  dct::tf32_split(v.w, h, l);
  hi.w = __uint_as_float(h), lo.w = __uint_as_float(l);
}

// A thread's share of every stage's copies, fixed for the block: 16-byte
// halo and weight items (neighbouring threads take a pixel's or a weight
// row's two 4-channel groups: one 32-byte sector), with their offsets at
// channel 0; stage s adds 8·s channels.
struct Loader32 {
  int a_off[NA32], a_so[NA32], a_ch[NA32];  // a_ch < 0: no item; past Ci: zero-filled
  int b_off[NB32], b_so[NB32], b_ch[NB32];  // b_ch < 0: no item, or past Co

  __device__ __forceinline__ Loader32(int H, int W, int Ci, int Co, int h0, int w0, int co0,
                                      int rb) {
#pragma unroll
    for (int k = 0; k < NA32; ++k) {
      const int i = threadIdx.x + k * NTHREADS;
      const int p = i >> 1, kg = i & 1;
      const int gh = h0 - 1 + p / HC32, gw = w0 - 1 + p % HC32;
      const bool in = gh >= 0 && gh < H && gw >= 0 && gw < W;
      a_off[k] = in ? (gh * W + gw) * Ci + kg * 4 : 0;
      a_so[k] = (kg * NPIX32 + p) * 4;
      a_ch[k] = i >= A32 / 4 ? -1 : in ? kg * 4 : 1 << 30;
    }
#pragma unroll
    for (int k = 0; k < NB32; ++k) {
      const int i = threadIdx.x + k * NTHREADS;
      const int co = (i >> 1) % BN32, t = (i >> 1) / BN32, kg = i & 1;
      b_off[k] = ((co0 + co) * 9 + t) * Ci + kg * 4;  // w is [Co][3][3][Ci]
      b_so[k] = rb + ((t * 2 + kg) * BN32 + co) * 4;
      b_ch[k] = i < B32 / 4 && co0 + co < Co ? kg * 4 : -1;
    }
  }

  // cp.async stage s raw into a slot of the raw ring: the halo (and the
  // mask) as planes [group][pixel][4], the taps of the block's output
  // channels as [tap][group][co][4] (a row past Co is not copied: its
  // output channel is not stored)
  template <bool MASK>
  __device__ __forceinline__ void load(float* st, const float* __restrict__ xn,
                                       const float* __restrict__ maskn,
                                       const float* __restrict__ w, int Ci, int s) const {
    const int c0 = s * CK32;
#pragma unroll
    for (int k = 0; k < NA32; ++k) {
      if (a_ch[k] < 0) continue;
      const bool ok = a_ch[k] + c0 < Ci;
      const int off = ok ? a_off[k] + c0 : 0;
      dct::cp_async_16(dct::smem_u32(st + a_so[k]), xn + off, ok);
      if (MASK) dct::cp_async_16(dct::smem_u32(st + A32 + a_so[k]), maskn + off, ok);
    }
#pragma unroll
    for (int k = 0; k < NB32; ++k) {
      if (b_ch[k] < 0) continue;
      const bool ok = b_ch[k] + c0 < Ci;
      dct::cp_async_16(dct::smem_u32(st + b_so[k]), w + (ok ? b_off[k] + c0 : 0), ok);
    }
  }
};

// split stage s once, from its raw slot into a split slot (with a mask: the
// operand masked first, and the tile's own pixels written to masked_out by
// the co-tile-0 block)
template <bool MASK>
__device__ __forceinline__ void split_stage32(const float* raw, float* xs,
                                              float* __restrict__ masked_out, int n, int H, int W,
                                              int Ci, int h0, int w0, int co0, int s) {
  const int c0 = s * CK32;
  const bool emit = MASK && masked_out != nullptr && co0 == 0;
  const float4* a = reinterpret_cast<const float4*>(raw);
  float4* ax = reinterpret_cast<float4*>(xs);
#pragma unroll
  for (int k = 0; k < (A32 / 4 + NTHREADS - 1) / NTHREADS; ++k) {
    const int j = threadIdx.x + k * NTHREADS;
    if (j >= A32 / 4) break;
    float4 v = a[j];
    if (MASK) {
      v = mask4(v, a[A32 / 4 + j]);
      const int p = j % NPIX32, rr = p / HC32, cc = p % HC32;  // halo row, column
      const int gh = h0 - 1 + rr, gw = w0 - 1 + cc, ch = c0 + (j / NPIX32) * 4;
      if (emit && rr >= 1 && rr <= TH32 && cc >= 1 && cc <= TW32 && gh < H && gw < W && ch < Ci)
        *reinterpret_cast<float4*>(masked_out + (((long)n * H + gh) * W + gw) * Ci + ch) = v;
    }
    float4 hi, lo;
    split4(v, hi, lo);
    ax[j] = hi;
    ax[A32 / 4 + j] = lo;
  }
  const float4* b = reinterpret_cast<const float4*>(raw + Ring32<MASK>::RB);
  float4* bx = reinterpret_cast<float4*>(xs + 2 * A32);
#pragma unroll
  for (int k = 0; k < (B32 / 4 + NTHREADS - 1) / NTHREADS; ++k) {
    const int j = threadIdx.x + k * NTHREADS;
    if (j >= B32 / 4) break;
    float4 hi, lo;
    split4(b[j], hi, lo);
    bx[j] = hi;
    bx[B32 / 4 + j] = lo;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
}

template <bool MASK>
__global__ void __launch_bounds__(NTHREADS, 1)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ skip,
                   const float* __restrict__ mask, float* __restrict__ y,
                   float* __restrict__ masked_out, int H, int W, int Ci, int Co, int relu) {
  using R = Ring32<MASK>;
  constexpr int ND = BN32 / 2;  // accumulator floats a thread per m64 tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // two split slots
  float* raw = xs + 2 * XS32;                      // the raw ring
  const uint32_t xs_u32 = dct::smem_u32(xs);

  const int n_co = (Co + BN32 - 1) / BN32;
  const int n = blockIdx.z / n_co, co0 = (blockIdx.z % n_co) * BN32;
  const int h0 = blockIdx.y * TH32, w0 = blockIdx.x * TW32;
  const int wg = threadIdx.x >> 7;  // warpgroup: output rows 2·wg, 2·wg + 1

  float acc[MT32][ND], d[MT32][ND];  // the sum; one stage's products
#pragma unroll
  for (int i = 0; i < MT32; ++i)
#pragma unroll
    for (int e = 0; e < ND; ++e) acc[i][e] = d[i][e] = 0.f;

  const long img = (long)n * H * W * Ci;
  const float* xn = x + img;
  const float* maskn = MASK ? mask + img : nullptr;
  const Loader32 ld(H, W, Ci, Co, h0, w0, co0, R::RB);
  const int nst = (Ci + CK32 - 1) / CK32;
#pragma unroll
  for (int r = 0; r < R::NR; ++r) {  // stages 0 .. NR-1 in flight
    if (r < nst) ld.load<MASK>(raw + r * R::RS, xn, maskn, w, Ci, r);
    dct::cp_async_commit();
  }
  dct::cp_async_wait<R::NR - 1>();
  __syncthreads();
  split_stage32<MASK>(raw, xs, masked_out, n, H, W, Ci, h0, w0, co0, 0);
  __syncthreads();

  for (int s = 0; s < nst; ++s) {
    const uint32_t st = xs_u32 + (s & 1) * XS32 * 4;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const uint64_t bh = gmma_desc(st + (2 * A32 + t * 2 * BN32 * 4) * 4, BN32 * 16, 128);
      const uint64_t bl = bh + (B32 >> 2);  // the lo plane, B32·4 bytes on
#pragma unroll
      for (int i = 0; i < MT32; ++i) {
        const int pix = (wg * MT32 + i + t / 3) * HC32 + t % 3;  // tap t's first pixel
        const uint64_t ah = gmma_desc(st + pix * 16, NPIX32 * 16, 128);
        const uint64_t al = ah + (A32 >> 2);
        wgmma_tf32(d[i], al, bh, t > 0);  // the stage's first product zeroes d
        wgmma_tf32(d[i], ah, bl, 1);
        wgmma_tf32(d[i], ah, bh, 1);
      }
    }
    wgmma_commit();
    if (s + R::NR < nst)  // into stage s's raw slot, split in step s-1
      ld.load<MASK>(raw + (s % R::NR) * R::RS, xn, maskn, w, Ci, s + R::NR);
    dct::cp_async_commit();
    if (s + 1 < nst) {
      dct::cp_async_wait<R::NR - 1>();
      __syncthreads();  // stage s+1 landed
      split_stage32<MASK>(raw + ((s + 1) % R::NR) * R::RS, xs + ((s + 1) & 1) * XS32,
                          masked_out, n, H, W, Ci, h0, w0, co0, s + 1);
    }
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < MT32; ++i) {
      fence_operands(d[i]);
#pragma unroll
      for (int e = 0; e < ND; ++e) acc[i][e] += d[i][e];
    }
    __syncthreads();  // stage s+1 split; stage s's split slot read by both warpgroups
  }

  // epilogue from the fragments: + bias, + skip, ReLU; float2 stores
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < BN32 / 8; ++j) {
    const int co = co0 + j * 8 + 2 * t4;
    if (co >= Co) continue;
    const float b0 = bias != nullptr ? bias[co] : 0.f;
    const float b1 = bias != nullptr ? bias[co + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MT32; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gh = h0 + wg * MT32 + i, gw = w0 + warp * 16 + g + 8 * half;
        if (gh >= H || gw >= W) continue;
        const long off = (((long)n * H + gh) * W + gw) * Co + co;
        float v0 = acc[i][4 * j + 2 * half] + b0, v1 = acc[i][4 * j + 2 * half + 1] + b1;
        if (skip != nullptr) {
          const float2 sv = *reinterpret_cast<const float2*>(skip + off);
          v0 += sv.x;
          v1 += sv.y;
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
  constexpr int smem = Ring32<MASK>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_f32_kernel<MASK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_co = (Co + BN32 - 1) / BN32;
  dim3 grid((W + TW32 - 1) / TW32, (H + TH32 - 1) / TH32, N * n_co);
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
             ? launch32<true>(x, w, bias, skip, mask, y, masked_out, N, H, W, Ci, Co, relu,
                              st)
             : launch32<false>(x, w, bias, skip, mask, y, masked_out, N, H, W, Ci, Co, relu,
                               st);
}

// dct_conv3x3_f32 takes K-major (OHWI) weights; a checkout whose fp32 form
// reads HWIO has no such symbol (scripts/kernel_ab.py builds both)
extern "C" int dct_conv3x3_f32_k_major(void) { return 1; }
