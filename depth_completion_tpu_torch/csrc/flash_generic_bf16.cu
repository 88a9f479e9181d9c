// The generic flash kernels (flash_generic.cuh) on bf16 operands (bf16
// mma.sync m16n8k16, fp32 accumulation), at the head dims the tuned bf16 kernels of
// flash_attention.cu do not take: 128, 256 and 384, forward, backward and
// the ring's steps; and 512, whose ring steps only come from here (a whole
// d=512 call takes flash_fwd_d512 / flash_bwd_d512). Replaces
// depth_completion_tpu/ops/flash_attention.py:_fwd_kernel (:163) and
// _bwd_fused_kernel (:464) / _bwd_fused_kernel_t (:534), and the flash
// ring of depth_completion_tpu/ops/ring_attention.py (:99), at those head
// dims.

#include "flash_generic.cuh"

using dct_generic::bf16;
using dct_generic::bwd_any;
using dct_generic::fwd_any;

DCT_FLASH_FWD_ENTRY(bf16) {
  switch (d) {
    case 128: return fwd_any<bf16, 128>(DCT_FLASH_FWD_ARGS);
    case 256: return fwd_any<bf16, 256>(DCT_FLASH_FWD_ARGS);
    case 384: return fwd_any<bf16, 384>(DCT_FLASH_FWD_ARGS);
    case 512: return fwd_any<bf16, 512>(DCT_FLASH_FWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

DCT_FLASH_BWD_ENTRY(bf16) {
  switch (d) {
    case 128: return bwd_any<bf16, 128>(DCT_FLASH_BWD_ARGS);
    case 256: return bwd_any<bf16, 256>(DCT_FLASH_BWD_ARGS);
    case 384: return bwd_any<bf16, 384>(DCT_FLASH_BWD_ARGS);
    case 512: return bwd_any<bf16, 512>(DCT_FLASH_BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}
