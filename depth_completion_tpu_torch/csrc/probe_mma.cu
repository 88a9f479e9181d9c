// Probe kernel for Hopper (sm_90a): batched bf16 products on the tensor
// cores, R repeats of each product summed in fp32, times a scale, bf16 out:
//
//   out[b] = bf16(scale · Σ_{r<R} Σ_t op(A_t[b]) · B_t[b]),   t < 1 or 2 terms
//
// with op(A) = A ([M, K], row-major) or Aᵀ (A stored as [K, M]); B is
// [K, N] row-major, out [M, N]. It answers the TPU probes' question on this
// card: is a product with N = 64 output columns slower per FLOP than one
// with N = 128, and at what rate do products on resident tiles run?
//
// Replaces two TPU probe kernels:
//   dct_probe_products <- scripts/exp_pallas_n64.py kern_a..kern_e (:61-110,
//                         launched by make_call :133): variants A-E, two
//                         heads' products per grid step, R inner repeats
//                         averaged (scale 1/R; 0.5/R for C's sum/diff);
//                         scripts/exp_packed_pv.py _kern (:36, call :53):
//                         the fp32 sum of `steps` repeats of p @ v on
//                         grid-resident tiles (scale 1)
//
// What bounds it: R·2·M·N·K FLOP against one read of A and B. At 9c's shape
// (bq=512, bk=1024, R=8) that is 2·64·8 / 2 = 512 FLOP per byte of p at
// N=64, above the card's ~295 bf16 FLOP/byte: the tensor cores, not HBM. At 9d's
// (R=512 repeats of a 1 MB p tile) it is the tensor cores by far; each copy
// of the tile is read from L2 once per 64-wide K chunk, 1/512 of what its
// products consume, so L2 does not bound it either.
//
// Design: a block of 4 warps owns a 64-row strip of one product and a
// 64- or 128-column tile of its output (16 rows per warp, accumulators in
// WMMA registers). It stages K in 64-wide chunks of A and B in shared
// memory and runs the R repeats on each chunk before loading the next, so
// the sum is Σ_chunk Σ_t Σ_r (not the TPU's Σ_r Σ_t Σ_K): fp32 sums in
// another order, stated in the callers' tolerances. Products run through WMMA
// (bf16 m16n16k16, fp32 accumulate), the instruction family of the port's
// flash kernels. Aᵀ (variant E) loads its chunk as stored, [K rows][M
// columns], and reads it through col-major A fragments: no transpose copy.
// Simple first form: no TMA, no wgmma, no pipelining of the chunk loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int KC = 64;        // K chunk staged in shared memory
constexpr int NWARPS = 4;     // 16 rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDA = 64 + 8;   // bf16 row stride of an A chunk (either layout): 144 B

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;

template <int NT, int TERMS>
struct Smem {
  static constexpr int LDB = NT + 8;  // bf16 row stride of a B chunk: 144 or 272 B
  bf16 a[TERMS][KC * LDA];
  bf16 b[TERMS][KC * LDB];
  float stage[NWARPS][256];  // one 16x16 fp32 output fragment per warp
};

// Copy a rows x cols bf16 tile (cols a multiple of 8) from a row-major
// matrix with row stride ld into shared memory with row stride lds.
__device__ __forceinline__ void load_chunk(bf16* dst, int lds, const bf16* src, long ld,
                                           int rows, int cols) {
  const int vecs = cols / 8;
  for (int i = threadIdx.x; i < rows * vecs; i += NTHREADS) {
    const int r = i / vecs, c = (i % vecs) * 8;
    *reinterpret_cast<uint4*>(dst + r * lds + c) =
        *reinterpret_cast<const uint4*>(src + (long)r * ld + c);
  }
}

template <bool TRANS_A, int NT, int TERMS>
__global__ void __launch_bounds__(NTHREADS)
products_kernel(const bf16* __restrict__ a0, const bf16* __restrict__ b0,
                const bf16* __restrict__ a1, const bf16* __restrict__ b1,
                bf16* __restrict__ out, int m, int n, int k, long a_sb, long b_sb, long o_sb,
                int repeats, float scale) {
  typedef typename std::conditional<TRANS_A,
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>,
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>>::type FragA;
  constexpr int LDB = Smem<NT, TERMS>::LDB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<NT, TERMS>& sm = *reinterpret_cast<Smem<NT, TERMS>*>(smem_raw);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * NT;
  const long bz = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* as[2] = {a0 + bz * a_sb, TERMS > 1 ? a1 + bz * a_sb : nullptr};
  const bf16* bs[2] = {b0 + bz * b_sb, TERMS > 1 ? b1 + bz * b_sb : nullptr};

  FragC acc[NT / 16];
#pragma unroll
  for (int j = 0; j < NT / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < k; k0 += KC) {
    __syncthreads();  // previous chunk fully consumed
#pragma unroll
    for (int t = 0; t < TERMS; ++t) {
      if (TRANS_A)  // Aᵀ stored [K, M]: rows k0.., columns m0..
        load_chunk(sm.a[t], LDA, as[t] + (long)k0 * m + m0, m, KC, BM);
      else          // A [M, K]: rows m0.., columns k0..
        load_chunk(sm.a[t], LDA, as[t] + (long)m0 * k + k0, k, BM, KC);
      load_chunk(sm.b[t], LDB, bs[t] + (long)k0 * n + n0, n, KC, NT);
    }
    __syncthreads();

    // one term at a time: with the repeats outside the terms, the two-term
    // form used 255 registers and spilled (the one-term forms use ~246)
#pragma unroll
    for (int t = 0; t < TERMS; ++t) {
#pragma unroll 1
      for (int r = 0; r < repeats; ++r) {
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) {
          FragA fa;
          if (TRANS_A)  // element (row i, depth kk+e) at [kk+e][warp*16+i]
            wmma::load_matrix_sync(fa, sm.a[t] + kk * LDA + warp * 16, LDA);
          else
            wmma::load_matrix_sync(fa, sm.a[t] + warp * 16 * LDA + kk, LDA);
#pragma unroll
          for (int j = 0; j < NT / 16; ++j) {
            FragB fb;
            wmma::load_matrix_sync(fb, sm.b[t] + kk * LDB + j * 16, LDB);
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
          }
        }
      }
    }
  }

  // scale, round to bf16, write this warp's 16 rows one fragment at a time
  float* stg = sm.stage[warp];
  bf16* orow = out + bz * o_sb + (long)(m0 + warp * 16) * n + n0;
#pragma unroll
  for (int j = 0; j < NT / 16; ++j) {
#pragma unroll
    for (int e = 0; e < acc[j].num_elements; ++e) acc[j].x[e] *= scale;
    wmma::store_matrix_sync(stg, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int idx = lane + 32 * e;
      orow[(long)(idx / 16) * n + j * 16 + idx % 16] = __float2bfloat16(stg[idx]);
    }
    __syncwarp();
  }
}

template <bool TRANS_A, int NT, int TERMS>
int launch(const void* a0, const void* b0, const void* a1, const void* b1, void* out,
           int batch, int m, int n, int k, long a_sb, long b_sb, long o_sb, int repeats,
           float scale, cudaStream_t stream) {
  auto kernel = products_kernel<TRANS_A, NT, TERMS>;
  const int smem = sizeof(Smem<NT, TERMS>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(m / BM, n / NT, batch);
  kernel<<<grid, NTHREADS, smem, stream>>>((const bf16*)a0, (const bf16*)b0, (const bf16*)a1,
                                          (const bf16*)b1, (bf16*)out, m, n, k, a_sb, b_sb,
                                          o_sb, repeats, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// m, k multiples of 64, n a multiple of 64; a1/b1 null for one term. The
// output tile is 128 columns wide where n allows, else 64. Returns a CUDA
// error code, or cudaErrorInvalidValue for a form that is not built.
extern "C" int dct_probe_products(const void* a0, const void* b0, const void* a1,
                                  const void* b1, void* out, int batch, int m, int n, int k,
                                  long a_sb, long b_sb, long o_sb, int trans_a, int repeats,
                                  float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool two = a1 != nullptr, wide = n % 128 == 0;
  if (m % BM || n % 64 || k % KC) return (int)cudaErrorInvalidValue;
  if (trans_a) {
    if (two || !wide) return (int)cudaErrorInvalidValue;
    return launch<true, 128, 1>(a0, b0, a1, b1, out, batch, m, n, k, a_sb, b_sb, o_sb,
                                repeats, scale, st);
  }
  if (two) {
    if (!wide) return (int)cudaErrorInvalidValue;
    return launch<false, 128, 2>(a0, b0, a1, b1, out, batch, m, n, k, a_sb, b_sb, o_sb,
                                 repeats, scale, st);
  }
  if (wide)
    return launch<false, 128, 1>(a0, b0, a1, b1, out, batch, m, n, k, a_sb, b_sb, o_sb,
                                 repeats, scale, st);
  return launch<false, 64, 1>(a0, b0, a1, b1, out, batch, m, n, k, a_sb, b_sb, o_sb, repeats,
                              scale, st);
}
