"""LCM (latent consistency) sampling, PyTorch counterpart of
``depth_completion_tpu.sched.lcm``: the timestep selection and the step.

The step predicts x̂₀, blends it with the sample through the
consistency-model scalings c_skip / c_out into a "denoised" estimate and,
except at the last step, re-noises that to the next timestep with fresh
Gaussian noise. The noise is JAX's: ``prng.normal`` of the step's key,
drawn on the host in float32, so one seed gives one LCM request on both
sides. The sampler's captured LCM step reads its scalars from
``lcm_tables`` and its re-noise from a buffer that ``lcm_renoise`` fills
with one request's draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from depth_completion_tpu_torch.core import prng
from depth_completion_tpu_torch.device import upload
from depth_completion_tpu_torch.sched.ddim import (
    DiffusionSchedule,
    StepTables,
    _coeffs,
    pred_original_at,
)


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


def lcm_scalars(sched: DiffusionSchedule, t: int, prev_t: int, is_last: bool,
                config: LCMConfig = LCMConfig()) -> tuple[float, ...]:
    """The step's scalars, each the float32 value ``lcm_step`` computes in
    numpy: √ᾱ_t, √(1−ᾱ_t) (x̂₀), c_skip, c_out, and √ᾱ_prev, √(1−ᾱ_prev)
    (the re-noise); at the last step (1, 0) in place of the last pair, so
    that ``sap·denoised + s1p·0`` is the denoised estimate itself."""
    scaled_t = np.float32(t) * np.float32(config.timestep_scaling)
    sd2 = np.float32(config.sigma_data**2)
    c_skip = float(sd2 / (scaled_t * scaled_t + sd2))
    c_out = float(scaled_t / np.sqrt(scaled_t * scaled_t + sd2))
    if is_last:
        sap, s1p = 1.0, 0.0
    else:
        a_prev = np.float32(sched.alpha_at(prev_t))
        sap, s1p = float(np.sqrt(a_prev)), float(np.sqrt(np.float32(1.0) - a_prev))
    return (*_coeffs(sched, t), c_skip, c_out, sap, s1p)


def lcm_tables(sched: DiffusionSchedule, timesteps, config: LCMConfig = LCMConfig(),
               device: torch.device | str = "cpu") -> StepTables:
    """Step k's timestep and ``lcm_scalars`` (``coeffs`` [S, 6] float32) on
    ``device``, for the sampler's captured LCM step."""
    ts = [int(t) for t in timesteps]
    rows = [lcm_scalars(sched, t, ts[i + 1] if i + 1 < len(ts) else -1, i == len(ts) - 1, config)
            for i, t in enumerate(ts)]
    device = torch.device(device)
    return StepTables(t=upload(np.array(ts, dtype=np.int64), device),
                      coeffs=upload(np.array(rows, dtype=np.float32), device))


def lcm_renoise(seed: int, num_steps: int, shape: tuple[int, ...]) -> np.ndarray:
    """One request's re-noise, [num_steps, *shape] float32: row k is what
    step k draws on JAX's key chain (the carry starts from the first key of
    ``split(PRNGKey(seed))``, whose second drew the initial noise; each step
    splits it and draws with the second key); the last step draws nothing,
    its row is zero."""
    key = prng.split(prng.PRNGKey(seed))[0]
    noise = np.zeros((num_steps, *shape), np.float32)
    noise[:-1] = prng.chain_normals(key, num_steps - 1, shape)
    return noise


def lcm_step(sched: DiffusionSchedule, model_out: torch.Tensor, t: int, prev_t: int,
             sample: torch.Tensor, key: np.ndarray, is_last: bool,
             config: LCMConfig = LCMConfig()) -> tuple[torch.Tensor, torch.Tensor]:
    """One LCM step → ``(prev_sample, denoised)``. ``prev_t`` is the next
    timestep, or -1 at the last step (ᾱ then the schedule's final value);
    ``key`` (a raw threefry key) draws the re-noise, which ``is_last``
    skips. The scalings are computed in float32, as in the JAX package."""
    row = lcm_scalars(sched, t, prev_t, is_last, config)
    noise = None if is_last else torch.from_numpy(
        prng.normal(key, tuple(sample.shape))).to(sample.device)
    return lcm_step_at(sched, model_out, sample, noise, *row)


def lcm_step_at(sched: DiffusionSchedule, model_out, sample, noise, sqrt_a, sqrt_1ma, c_skip,
                c_out, sqrt_ap, sqrt_1map):
    """``lcm_step`` with its scalars given (floats, or 0-d float32 tensors:
    an ``lcm_tables`` row) and its re-noise a tensor (None: the last step,
    the denoised estimate returned as it is)."""
    x0 = pred_original_at(sched, model_out, sample, sqrt_a, sqrt_1ma).float()
    denoised = c_out * x0 + c_skip * sample.float()
    prev = denoised if noise is None else sqrt_ap * denoised + sqrt_1map * noise
    return prev.to(sample.dtype), denoised.to(sample.dtype)
