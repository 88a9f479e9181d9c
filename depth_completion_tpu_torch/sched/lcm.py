"""LCM scheduler settings (a copy of ``depth_completion_tpu.sched.lcm``'s
``LCMConfig``, so ``SamplerConfig`` keeps the JAX package's fields). The LCM
step itself is not ported yet; the sampler raises for ``scheduler="lcm"``."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LCMConfig:
    original_inference_steps: int = 50
    timestep_scaling: float = 10.0
    sigma_data: float = 0.5
