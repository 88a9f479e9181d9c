"""Warm-model serving for depth completion, PyTorch counterpart of
``depth_completion_tpu.serving``: load the bundle once, then answer a
stream of requests at steady-state latency.

- ``ServingEngine``: request queue, same-geometry micro-batching padded to
  a batch bucket, per-session temporal latent carry, warmup, and
  latency/batching stats.
- ``server``: a stdlib HTTP front end (npz in, npy out).
"""

from depth_completion_tpu_torch.serving.engine import (
    OverloadedError,
    ServeRequest,
    ServingEngine,
)

__all__ = ["ServingEngine", "ServeRequest", "OverloadedError"]
