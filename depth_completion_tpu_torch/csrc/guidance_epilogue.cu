// Fused guidance-step epilogue for Hopper (sm_90a): the ε-norm gradient
// rescale, the latent's Adam update and the DDIM transition of one per-step
// guided step, over fp32 [N, K] latents (K = EH*EW*4), in one launch.
//
// Replaces depth_completion_tpu/ops/guidance_epilogue.py:_kernel (:62,
// launched by guided_epilogue :210). The TPU kernel padded each sample to
// [R, 128] lanes and paid a relayout on either side; here a sample is a
// flat run of float4s and nothing is padded or moved.
//
// What bounds it: 8 x 4 bytes per element less 2 (lat, g, m, v read as
// fp32, out as bf16; lat, m, v written), about 0.83 MB per sample at res
// 768: 0.25 us at the card's memory rate, so in practice its launch and
// how many SMs stream those bytes.
//
// The six per-step scalars [sa, s1, sap, s1p, bc1, bc2] come from a device
// table [steps, 6] at a step index that lives on the device too, so one
// launch captured in a CUDA graph serves every step: the host advances the
// index between replays and passes no per-step value. lr, b1, b2 and eps
// are constant per request and stay arguments.
//
// Design: one thread-block cluster per sample (CLUSTER blocks of NT
// threads, launched with cudaLaunchKernelEx and a cluster-dimension
// attribute), so a sample's bytes stream through CLUSTER SMs and not one.
// Each thread loads its share of lat, g, out, m and v once, into registers
// (VPT float4s of each: HELD float4s per sample in all), and sums its part
// of ‖ε̂‖² and ‖g‖². Each block reduces its partials with warp shuffles;
// after one cluster barrier every warp reads the CLUSTER blocks' partials
// through distributed shared memory (lane r reads block r, then a warp
// sum: the same sum in the same order in every block), so every block has
// the sample's two norms without a second launch or global atomics. The
// update is applied from the registers and written in place. A sample
// larger than HELD float4s is read a second time beyond that share: once
// for the norms, once more for the update. Each element is read and
// written by the same thread, so in place is safe. A second cluster
// barrier (arrive after the reads of the other blocks' partials, wait at
// the end) keeps every block's shared memory alive while it may be read.
//
// Cluster size: 16 blocks (non-portable) over the portable 8, for the main
// path's batch 1: device time 0.0050 against 0.0058 ms at [1,72,96,4]; at
// batch 8, 0.0064 against 0.0059 (scripts/kernel_ab.py, NVIDIA H100 80GB
// HBM3 at 700 W; the one-block design took 0.0144 and 0.0153).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int CLUSTER = 16;  // blocks per sample (above 8, a non-portable cluster size)
constexpr int NT = 256;      // threads per block
constexpr int NW = NT / 32;
constexpr int HELD = 8192;                  // float4s of a sample held in registers
constexpr int VPT = HELD / (CLUSTER * NT);  // float4s of each tensor per thread
static_assert(VPT * CLUSTER * NT == HELD, "HELD must split evenly over the cluster's threads");

struct Step {
  float sa, s1, sap, s1p, bc1, bc2, lr, b1, b2, eps;
};

struct Adam {
  float lr, b1, b2, eps;
};

// this step's row of the table: [sa, s1, sap, s1p, bc1, bc2]
__device__ __forceinline__ Step load_step(const float* __restrict__ table,
                                          const long long* __restrict__ step, Adam a) {
  const float* row = table + 6 * *step;
  return Step{row[0], row[1], row[2], row[3], row[4], row[5], a.lr, a.b1, a.b2, a.eps};
}

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

__device__ __forceinline__ float sq4(float4 a) {
  return a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
}

// ‖ε̂‖² of four elements
__device__ __forceinline__ float eps_sq4(float4 x, float4 o, int v_pred, const Step& st) {
  return sq4(make_float4(eps_hat(x.x, o.x, v_pred, st), eps_hat(x.y, o.y, v_pred, st),
                         eps_hat(x.z, o.z, v_pred, st), eps_hat(x.w, o.w, v_pred, st)));
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

__device__ __forceinline__ void update4(float4& x, float4 g, float4 o, float4& m, float4& v,
                                        float factor, int v_pred, const Step& st) {
  update(x.x, g.x, o.x, m.x, v.x, factor, v_pred, st);
  update(x.y, g.y, o.y, m.y, v.y, factor, v_pred, st);
  update(x.z, g.z, o.z, m.z, v.z, factor, v_pred, st);
  update(x.w, g.w, o.w, m.w, v.w, factor, v_pred, st);
}

__global__ void __launch_bounds__(NT)
guidance_epilogue_kernel(float* __restrict__ lat, const float* __restrict__ g,
                         const void* __restrict__ out, float* __restrict__ m,
                         float* __restrict__ v, long k4, int out_bf16, int v_pred,
                         const float* __restrict__ table, const long long* __restrict__ step,
                         Adam adam) {
  cg::cluster_group cluster = cg::this_cluster();
  const Step st = load_step(table, step, adam);
  __shared__ float red[2][NW];
  __shared__ float2 part;  // this block's (‖ε̂‖², ‖g‖²) partial
  const int rank = (int)cluster.block_rank();
  const long base = (long)(blockIdx.x / CLUSTER) * k4;  // this sample, in float4 units
  float4* lat4 = reinterpret_cast<float4*>(lat) + base;
  const float4* g4 = reinterpret_cast<const float4*>(g) + base;
  float4* m4 = reinterpret_cast<float4*>(m) + base;
  float4* v4 = reinterpret_cast<float4*>(v) + base;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long first = (long)rank * NT + threadIdx.x;  // this thread's first float4
  constexpr long STRIDE = (long)CLUSTER * NT;

  // the held share, read once: lat, g and out for the norms, m and v in flight
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 x[VPT], gg[VPT], o[VPT], mm[VPT], vv[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const long i = first + j * STRIDE;
    const bool in = i < k4;
    x[j] = in ? lat4[i] : zero;
    gg[j] = in ? g4[i] : zero;
    o[j] = in ? load_out(out, out_bf16, base + i) : zero;
    mm[j] = in ? m4[i] : zero;
    vv[j] = in ? v4[i] : zero;
  }
  float e2 = 0.f, g2 = 0.f;  // zeros add nothing to either norm
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    e2 += eps_sq4(x[j], o[j], v_pred, st);
    g2 += sq4(gg[j]);
  }
  // beyond the held share: read here for the norms, again for the update
  for (long i = first + HELD; i < k4; i += STRIDE) {
    e2 += eps_sq4(lat4[i], load_out(out, out_bf16, base + i), v_pred, st);
    g2 += sq4(g4[i]);
  }

  // the block's partial
  e2 = warp_sum(e2);
  g2 = warp_sum(g2);
  if (lane == 0) {
    red[0][warp] = e2;
    red[1][warp] = g2;
  }
  __syncthreads();
  if (warp == 0) {
    e2 = warp_sum(lane < NW ? red[0][lane] : 0.f);
    g2 = warp_sum(lane < NW ? red[1][lane] : 0.f);
    if (lane == 0) part = make_float2(e2, g2);
  }
  cluster.sync();  // every block's partial written and visible to the cluster

  // the sample's norms: lane r of each warp reads block r's partial (DSMEM)
  const float2 p = lane < CLUSTER ? *cluster.map_shared_rank(&part, lane)
                                   : make_float2(0.f, 0.f);
  e2 = warp_sum(p.x);
  g2 = warp_sum(p.y);
  // this block has read the others' shared memory: arrive now, wait at the end
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  const float factor = sqrtf(e2) / fmaxf(sqrtf(g2), 1e-7f);

  // the update, from the registers, in place
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const long i = first + j * STRIDE;
    if (i < k4) {
      update4(x[j], gg[j], o[j], mm[j], vv[j], factor, v_pred, st);
      lat4[i] = x[j];
      m4[i] = mm[j];
      v4[i] = vv[j];
    }
  }
  for (long i = first + HELD; i < k4; i += STRIDE) {
    float4 xr = lat4[i], mr = m4[i], vr = v4[i];
    update4(xr, g4[i], load_out(out, out_bf16, base + i), mr, vr, factor, v_pred, st);
    lat4[i] = xr;
    m4[i] = mr;
    v4[i] = vr;
  }
  // no block leaves while another may still read its partial
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace

extern "C" int dct_guidance_epilogue_table(void* lat, const void* g, const void* out, void* m,
                                           void* v, int n, long k, int out_bf16, int v_pred,
                                           const void* table, const void* step, float lr,
                                           float b1, float b2, float adam_eps, void* stream) {
  if (n <= 0 || k <= 0 || k % 4) return (int)cudaErrorInvalidValue;
  if (CLUSTER > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        guidance_epilogue_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  const Adam adam{lr, b1, b2, adam_eps};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n * CLUSTER);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, guidance_epilogue_kernel, (float*)lat, (const float*)g, out, (float*)m, (float*)v,
      k / 4, out_bf16, v_pred, (const float*)table, (const long long*)step, adam);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
