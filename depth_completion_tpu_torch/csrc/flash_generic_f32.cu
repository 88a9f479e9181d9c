// The generic flash kernels (flash_generic.cuh) on fp32 operands, 3xTF32,
// at head dims 64, 128, 256, 384 and 512: the forward (and the ring's
// forward steps) and the backward (and the ring's backward steps) behind
// ops/flash_attention.py at --precision fp32. Replaces
// depth_completion_tpu/ops/flash_attention.py:_fwd_kernel (:163) and
// _bwd_fused_kernel (:464) / _bwd_fused_kernel_t (:534), and the flash
// ring of depth_completion_tpu/ops/ring_attention.py (:99), on fp32.

#include "flash_generic.cuh"

using dct_generic::bwd_any;
using dct_generic::fwd_any;

DCT_FLASH_FWD_ENTRY(f32) {
  switch (d) {
    case 64: return fwd_any<float, 64>(DCT_FLASH_FWD_ARGS);
    case 128: return fwd_any<float, 128>(DCT_FLASH_FWD_ARGS);
    case 256: return fwd_any<float, 256>(DCT_FLASH_FWD_ARGS);
    case 384: return fwd_any<float, 384>(DCT_FLASH_FWD_ARGS);
    case 512: return fwd_any<float, 512>(DCT_FLASH_FWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

DCT_FLASH_BWD_ENTRY(f32) {
  switch (d) {
    case 64: return bwd_any<float, 64>(DCT_FLASH_BWD_ARGS);
    case 128: return bwd_any<float, 128>(DCT_FLASH_BWD_ARGS);
    case 256: return bwd_any<float, 256>(DCT_FLASH_BWD_ARGS);
    case 384: return bwd_any<float, 384>(DCT_FLASH_BWD_ARGS);
    case 512: return bwd_any<float, 512>(DCT_FLASH_BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}
