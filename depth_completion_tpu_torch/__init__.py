"""PyTorch/CUDA port of ``depth_completion_tpu`` for NVIDIA Hopper GPUs.

Guided-diffusion depth completion (Marigold-DC) in eager PyTorch, with the
hot kernels written by hand in CUDA C++ for ``sm_90a`` (``csrc/``). Module
names mirror the JAX package's so each counterpart is easy to find; public
tensors keep its NHWC layout.

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit ``"cpu"`` they raise. A kernel
wrapper given a CPU tensor computes its plain PyTorch version; given a CUDA
tensor it launches its kernel or raises. Nothing falls back silently.
"""

from depth_completion_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
