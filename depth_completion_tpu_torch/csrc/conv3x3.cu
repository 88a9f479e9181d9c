// Fused 3x3 stride-1 SAME convolution for Hopper (sm_90a), NHWC, bf16
// operands, fp32 accumulation, with bias / skip / ReLU fused into the
// epilogue and an optional input mask (operand zeroed where mask <= 0, halo
// included) that can also be written back out as a second output.
//
// Replaces depth_completion_tpu/ops/conv3x3.py:_conv_kernel (:81, launched
// by _conv_call :139). The JAX package runs it on width-packed C=128 maps;
// here the real TAESD width C=64 runs unpacked.
//
// What bounds it: a 64->64 channel 3x3 conv does 2*9*64*64 = 73,728 FLOP
// per pixel against 128 bytes read and 128 written (bf16, no skip), ~288
// FLOP/byte: right at the H100's bf16 ridge (~295), so tensor-core rate and
// bytes both matter; the dx pass with a mask reads 128 more bytes per pixel
// and sits below the ridge. Design: implicit GEMM. A block owns a
// 2x64-pixel output tile and 64 output channels; it stages the 4x66-pixel
// input halo tile and the 9 taps of a 32-channel input slice in shared
// memory (zero padding and the mask applied while staging), and runs nine
// shifted [128 px x 32] x [32 x 64] products per slice on the tensor cores
// through WMMA. No im2col tensor is ever written. Simple first form: no
// TMA, no wgmma, no double buffering of the slices.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 2;            // output rows per block
constexpr int TW = 64;           // output columns per block
constexpr int CO_T = 64;         // output channels per block
constexpr int CI_T = 32;         // input channels staged per slice
constexpr int HR = TH + 2;       // halo rows
constexpr int HC = TW + 2;       // halo columns
constexpr int LDI = CI_T + 16;   // bf16 stride per staged pixel (96 B: 32 B aligned)
constexpr int LDW = CO_T + 16;   // bf16 stride per staged tap row (160 B)
constexpr int LDO = CO_T + 4;    // fp32 stride of the epilogue staging rows
constexpr int NTHREADS = 256;    // 8 warps: 4 along pixels x 2 along channels

constexpr int IN_ELEMS = HR * HC * LDI;
constexpr int W_ELEMS = 9 * CI_T * LDW;
constexpr int SMEM_BYTES = (IN_ELEMS + W_ELEMS) * 2;
static_assert(TH * TW * LDO * 4 <= SMEM_BYTES, "epilogue staging must fit the aliased tiles");

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;

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

__global__ void __launch_bounds__(NTHREADS)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const bf16* __restrict__ bias, const bf16* __restrict__ skip,
               const bf16* __restrict__ mask, bf16* __restrict__ y,
               bf16* __restrict__ masked_out, int H, int W, int Ci, int Co, int relu) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* s_in = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_w = s_in + IN_ELEMS;
  float* s_out = reinterpret_cast<float*>(smem_raw);  // aliases both after the products

  const int n_co = (Co + CO_T - 1) / CO_T;
  const int n = blockIdx.z / n_co, cot = blockIdx.z % n_co;
  const int h0 = blockIdx.y * TH, w0 = blockIdx.x * TW, co0 = cot * CO_T;
  const int warp = threadIdx.x / 32;
  const int wm = warp >> 1, wn = warp & 1;
  const int px = wm * 32;                 // first of this warp's 32 output pixels
  const int pr = px / TW, pc = px % TW;   // its tile row and column

  FragC acc[2][2];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int g = 0; g < 2; ++g) wmma::fill_fragment(acc[f][g], 0.f);

  for (int c0 = 0; c0 < Ci; c0 += CI_T) {
    __syncthreads();  // previous slice consumed
    // input halo tile, zero outside the image and past Ci, masked if asked
    for (int i = threadIdx.x; i < HR * HC * (CI_T / 8); i += NTHREADS) {
      const int vec = i % (CI_T / 8), pix = i / (CI_T / 8);
      const int rr = pix / HC, cc = pix % HC;
      const int gh = h0 - 1 + rr, gw = w0 - 1 + cc, ch = c0 + vec * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gh >= 0 && gh < H && gw >= 0 && gw < W && ch < Ci) {
        const long off = (((long)n * H + gh) * W + gw) * Ci + ch;
        val = *reinterpret_cast<const uint4*>(x + off);
        if (mask != nullptr) val = mask_vec(val, *reinterpret_cast<const uint4*>(mask + off));
        if (masked_out != nullptr && cot == 0 && rr >= 1 && rr <= TH && cc >= 1 && cc <= TW)
          *reinterpret_cast<uint4*>(masked_out + off) = val;
      }
      *reinterpret_cast<uint4*>(s_in + pix * LDI + vec * 8) = val;
    }
    // the nine taps of this input slice: w is [3][3][Ci][Co]
    for (int i = threadIdx.x; i < 9 * CI_T * (CO_T / 8); i += NTHREADS) {
      const int nv = i % (CO_T / 8), kr = (i / (CO_T / 8)) % CI_T, t = i / (CI_T * (CO_T / 8));
      const int ci = c0 + kr, co = co0 + nv * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (ci < Ci && co < Co)
        val = *reinterpret_cast<const uint4*>(w + ((long)t * Ci + ci) * Co + co);
      *reinterpret_cast<uint4*>(s_w + (t * CI_T + kr) * LDW + nv * 8) = val;
    }
    __syncthreads();

#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int dh = t / 3, dw = t % 3;
#pragma unroll
      for (int kk = 0; kk < CI_T; kk += 16) {
        FragA a[2];
        FragB b[2];
#pragma unroll
        for (int f = 0; f < 2; ++f)
          wmma::load_matrix_sync(a[f], s_in + ((pr + dh) * HC + pc + f * 16 + dw) * LDI + kk,
                                 LDI);
#pragma unroll
        for (int g = 0; g < 2; ++g)
          wmma::load_matrix_sync(b[g], s_w + (t * CI_T + kk) * LDW + wn * 32 + g * 16, LDW);
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int g = 0; g < 2; ++g) wmma::mma_sync(acc[f][g], a[f], b[g], acc[f][g]);
      }
    }
  }

  __syncthreads();  // staging aliases the input and tap tiles
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int g = 0; g < 2; ++g)
      wmma::store_matrix_sync(s_out + (px + f * 16) * LDO + wn * 32 + g * 16, acc[f][g], LDO,
                              wmma::mem_row_major);
  __syncthreads();

  // epilogue: + bias + skip, ReLU, cast, 8 channels per thread
  for (int i = threadIdx.x; i < TH * TW * (CO_T / 8); i += NTHREADS) {
    const int cv = i % (CO_T / 8), pm = i / (CO_T / 8);
    const int gh = h0 + pm / TW, gw = w0 + pm % TW, co = co0 + cv * 8;
    if (gh >= H || gw >= W || co >= Co) continue;
    const long off = (((long)n * H + gh) * W + gw) * Co + co;
    float vals[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) vals[e] = s_out[pm * LDO + cv * 8 + e];
    if (bias != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] += __bfloat162float(bias[co + e]);
    }
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

}  // namespace

extern "C" int dct_conv3x3(const void* x, const void* w, const void* bias, const void* skip,
                           const void* mask, void* y, void* masked_out, int N, int H, int W,
                           int Ci, int Co, int relu, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int n_co = (Co + CO_T - 1) / CO_T;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N * n_co);
  conv3x3_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)bias, (const bf16*)skip, (const bf16*)mask,
      (bf16*)y, (bf16*)masked_out, H, W, Ci, Co, relu);
  return (int)cudaGetLastError();
}
