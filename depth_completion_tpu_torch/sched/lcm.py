"""LCM (latent consistency) sampling, PyTorch counterpart of
``depth_completion_tpu.sched.lcm``: the timestep selection and the step.

The step predicts x̂₀, blends it with the sample through the
consistency-model scalings c_skip / c_out into a "denoised" estimate and,
except at the last step, re-noises that to the next timestep with fresh
Gaussian noise. The noise is JAX's: ``prng.normal`` of the step's key,
drawn on the host in float32, so one seed gives one LCM request on both
sides.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from depth_completion_tpu_torch.core import prng
from depth_completion_tpu_torch.sched.ddim import DiffusionSchedule, pred_original


@dataclasses.dataclass(frozen=True)
class LCMConfig:
    original_inference_steps: int = 50
    timestep_scaling: float = 10.0
    sigma_data: float = 0.5


def make_lcm_timesteps(num_train_timesteps: int, num_steps: int,
                       config: LCMConfig = LCMConfig()) -> np.ndarray:
    """Descending int32 timesteps: the origin grid ``k·i − 1`` (k = T //
    original_inference_steps) reversed, at the indices
    ``floor(linspace(0, orig, num_steps, endpoint=False))`` (diffusers'
    ``LCMScheduler.set_timesteps``; not a fixed stride: 4 steps on a
    50-point grid pick origin indices 49, 37, 24, 12)."""
    orig = config.original_inference_steps
    if num_steps > orig:
        raise ValueError(
            f"num_steps ({num_steps}) cannot exceed original_inference_steps ({orig})")
    k = num_train_timesteps // orig
    origin_desc = np.arange(orig, 0, -1, dtype=np.int64) * k - 1
    idx = np.floor(np.linspace(0, orig, num=num_steps, endpoint=False)).astype(np.int64)
    return np.ascontiguousarray(origin_desc[idx].astype(np.int32))


def lcm_step(sched: DiffusionSchedule, model_out: torch.Tensor, t: int, prev_t: int,
             sample: torch.Tensor, key: np.ndarray, is_last: bool,
             config: LCMConfig = LCMConfig()) -> tuple[torch.Tensor, torch.Tensor]:
    """One LCM step → ``(prev_sample, denoised)``. ``prev_t`` is the next
    timestep, or -1 at the last step (ᾱ then the schedule's final value);
    ``key`` (a raw threefry key) draws the re-noise, which ``is_last``
    skips. The scalings are computed in float32, as in the JAX package."""
    scaled_t = np.float32(t) * np.float32(config.timestep_scaling)
    sd2 = np.float32(config.sigma_data**2)
    c_skip = float(sd2 / (scaled_t * scaled_t + sd2))
    c_out = float(scaled_t / np.sqrt(scaled_t * scaled_t + sd2))
    x0 = pred_original(sched, model_out, t, sample).float()
    denoised = c_out * x0 + c_skip * sample.float()
    if is_last:
        prev = denoised
    else:
        a_prev = np.float32(sched.alpha_at(prev_t))
        noise = torch.from_numpy(prng.normal(key, tuple(sample.shape))).to(sample.device)
        prev = (float(np.sqrt(a_prev)) * denoised
                + float(np.sqrt(np.float32(1.0) - a_prev)) * noise)
    return prev.to(sample.dtype), denoised.to(sample.dtype)
