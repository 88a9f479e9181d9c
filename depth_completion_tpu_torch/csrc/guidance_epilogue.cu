// Fused guidance-step epilogue for Hopper (sm_90a): the ε-norm gradient
// rescale, the latent's Adam update and the DDIM transition of one per-step
// guided step, over fp32 [N, K] latents (K = EH*EW*4), in one launch.
//
// Replaces depth_completion_tpu/ops/guidance_epilogue.py:_kernel (:62,
// launched by guided_epilogue :210). The TPU kernel padded each sample to
// [R, 128] lanes and paid a relayout on either side; here a sample is a
// flat run of float4s and nothing is padded or moved.
//
// What bounds it: 8 x 4 bytes per element (lat, g, out, m, v read; lat, m,
// v written; out as bf16 reads 2), about 0.9 MB per sample at res 768:
// 0.26 us at the card's memory rate, so in practice its launch. Design: one
// block per sample; the first pass reduces ‖ε̂‖² and ‖g‖² (fp32, warp
// shuffles, then one warp over the per-warp sums), the second applies the
// update elementwise and writes lat, m and v in place. Each element is read
// and written by the same thread, so in place is safe.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 512;  // threads per block (one block per sample)

struct Step {
  float sa, s1, sap, s1p, bc1, bc2, lr, b1, b2, eps;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// element i (in float4 units) of the UNet output, bf16 or fp32
__device__ __forceinline__ float4 load_out(const void* out, int out_bf16, long i) {
  if (!out_bf16) return reinterpret_cast<const float4*>(out)[i];
  const uint2 raw = reinterpret_cast<const uint2*>(out)[i];
  const bf16* b = reinterpret_cast<const bf16*>(&raw);
  return make_float4(__bfloat162float(b[0]), __bfloat162float(b[1]), __bfloat162float(b[2]),
                     __bfloat162float(b[3]));
}

__device__ __forceinline__ float eps_hat(float x, float o, int v_pred, const Step& st) {
  return v_pred ? st.sa * o + st.s1 * x : o;
}

// one element: rescaled gradient → Adam → DDIM on the updated latent
__device__ __forceinline__ void update(float& x, float g, float o, float& m, float& v,
                                       float factor, int v_pred, const Step& st) {
  g *= factor;
  m = st.b1 * m + (1.f - st.b1) * g;
  v = st.b2 * v + (1.f - st.b2) * g * g;
  x = x - st.lr * (m * st.bc1) / (sqrtf(v * st.bc2) + st.eps);
  const float x0 = v_pred ? st.sa * x - st.s1 * o : (x - st.s1 * o) / st.sa;
  x = st.sap * x0 + st.s1p * eps_hat(x, o, v_pred, st);
}

__global__ void __launch_bounds__(NT)
guidance_epilogue_kernel(float* __restrict__ lat, const float* __restrict__ g,
                         const void* __restrict__ out, float* __restrict__ m,
                         float* __restrict__ v, long k4, int out_bf16, int v_pred, Step st) {
  __shared__ float red[2][NT / 32];
  const long base = (long)blockIdx.x * k4;  // this sample, in float4 units
  float4* lat4 = reinterpret_cast<float4*>(lat) + base;
  const float4* g4 = reinterpret_cast<const float4*>(g) + base;
  float4* m4 = reinterpret_cast<float4*>(m) + base;
  float4* v4 = reinterpret_cast<float4*>(v) + base;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // pass 1: ‖ε̂‖² and ‖g‖² of the sample
  float e2 = 0.f, g2 = 0.f;
  for (long i = threadIdx.x; i < k4; i += NT) {
    const float4 x = lat4[i], gg = g4[i], o = load_out(out, out_bf16, base + i);
    const float ex = eps_hat(x.x, o.x, v_pred, st), ey = eps_hat(x.y, o.y, v_pred, st);
    const float ez = eps_hat(x.z, o.z, v_pred, st), ew = eps_hat(x.w, o.w, v_pred, st);
    e2 += ex * ex + ey * ey + ez * ez + ew * ew;
    g2 += gg.x * gg.x + gg.y * gg.y + gg.z * gg.z + gg.w * gg.w;
  }
  e2 = warp_sum(e2);
  g2 = warp_sum(g2);
  if (lane == 0) {
    red[0][warp] = e2;
    red[1][warp] = g2;
  }
  __syncthreads();
  if (warp == 0) {
    e2 = warp_sum(lane < NT / 32 ? red[0][lane] : 0.f);
    g2 = warp_sum(lane < NT / 32 ? red[1][lane] : 0.f);
    if (lane == 0) {
      red[0][0] = e2;
      red[1][0] = g2;
    }
  }
  __syncthreads();
  const float factor = sqrtf(red[0][0]) / fmaxf(sqrtf(red[1][0]), 1e-7f);

  // pass 2: the update, in place
  for (long i = threadIdx.x; i < k4; i += NT) {
    float4 x = lat4[i], mm = m4[i], vv = v4[i];
    const float4 gg = g4[i], o = load_out(out, out_bf16, base + i);
    update(x.x, gg.x, o.x, mm.x, vv.x, factor, v_pred, st);
    update(x.y, gg.y, o.y, mm.y, vv.y, factor, v_pred, st);
    update(x.z, gg.z, o.z, mm.z, vv.z, factor, v_pred, st);
    update(x.w, gg.w, o.w, mm.w, vv.w, factor, v_pred, st);
    lat4[i] = x;
    m4[i] = mm;
    v4[i] = vv;
  }
}

}  // namespace

extern "C" int dct_guidance_epilogue(void* lat, const void* g, const void* out, void* m, void* v,
                                     int n, long k, int out_bf16, int v_pred, float sa, float s1,
                                     float sap, float s1p, float bc1, float bc2, float lr,
                                     float b1, float b2, float adam_eps, void* stream) {
  const Step st{sa, s1, sap, s1p, bc1, bc2, lr, b1, b2, adam_eps};
  guidance_epilogue_kernel<<<n, NT, 0, (cudaStream_t)stream>>>(
      (float*)lat, (const float*)g, out, (float*)m, (float*)v, k / 4, out_bf16, v_pred, st);
  return (int)cudaGetLastError();
}
