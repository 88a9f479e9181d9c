// A variant of the d=512 flash backward that scripts/kernel_ab.py times
// beside the one the port runs (compiled with -I for a copy of the port's
// csrc/, which kernel_ab.py may have edited first).
//
// dct_flash_bwd_d512_one_pass: design 1 of the d=512 backward note in
// csrc/flash_attention.cu, one kernel with no second pass over the keys:
// flash_bwd_d512_kernel<true> forms dq = ds·k for each query tile beside dk
// and dv and adds it into the fp32 dq with float4 atomics (191M 16-byte
// reductions at S=6912). The port runs design 2 (dct_flash_bwd_d512: the
// same kernel without dq, then flash_bwd_dq_d512_kernel), which is faster
// on the card (PERF.md, Findings).

#include "flash_attention.cu"

// the same contract as dct_flash_bwd_d512
extern "C" int dct_flash_bwd_d512_one_pass(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
    void* di, void* dq_acc, void* dk, void* dv, int batch, int heads, int sq, int sk, long q_sn,
    long q_ss, long k_sn, long k_ss, long v_sn, long v_ss, long o_sn, long o_ss, long d_sn,
    long d_ss, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int err = launch_di512(o, dout, di, batch, heads, sq, o_sn, o_ss, d_sn, d_ss, st);
  if (err != 0) return err;
  return launch_bwd512<true>(q, k, v, dout, lse, di, dq_acc, dk, dv, batch, heads, sq, sk, q_sn,
                             q_ss, k_sn, k_ss, v_sn, v_ss, d_sn, d_ss, scale, st);
}
