"""Deterministic (η=0) DDIM over a precomputed ᾱ table, PyTorch counterpart
of ``depth_completion_tpu.sched.ddim``.

The eager loops walk python-int timesteps, so ᾱ lookups are plain indexing;
``alphas_cumprod`` stays float32 whatever the model dtype (the ᾱ ratios
near t=0 lose precision in bf16). Marigold uses scaled-linear betas over
1000 train steps, trailing spacing and v-prediction.

The sampler's captured steps (``pipeline.sampler``'s programs) cannot
freeze per-step floats into their graphs: ``step_tables`` gives every
step's t and coefficients as device tensors, and ``pred_original_at``,
``pred_epsilon_at`` and ``ddim_step_at`` take 0-d tensor coefficients
(JAX's scan indexes its schedule with a traced t in the same way). The
float and tensor forms run the same float32 arithmetic, so their values
are bit-identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from depth_completion_tpu_torch.device import upload


@dataclasses.dataclass(frozen=True)
class DDIMConfig:
    """Schedule hyperparameters (diffusers-compatible semantics)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # "linear" | "scaled_linear" | "squaredcos"
    prediction_type: str = "v_prediction"  # "epsilon" | "sample" | "v_prediction"
    timestep_spacing: str = "trailing"  # "trailing" | "leading" | "linspace"
    set_alpha_to_one: bool = False
    steps_offset: int = 1
    clip_sample: bool = False
    clip_sample_range: float = 1.0


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    alphas_cumprod: np.ndarray  # [T] float32
    final_alpha_cumprod: float
    config: DDIMConfig

    def alpha_at(self, t: int) -> float:
        """ᾱ_t as a float32 value; negative t maps to the final ᾱ."""
        return float(self.alphas_cumprod[t]) if t >= 0 else self.final_alpha_cumprod


def make_schedule(config: DDIMConfig = DDIMConfig()) -> DiffusionSchedule:
    T = config.num_train_timesteps
    if config.beta_schedule == "linear":
        betas = np.linspace(config.beta_start, config.beta_end, T, dtype=np.float64)
    elif config.beta_schedule == "scaled_linear":
        betas = (
            np.linspace(config.beta_start**0.5, config.beta_end**0.5, T, dtype=np.float64) ** 2
        )
    elif config.beta_schedule == "squaredcos":
        steps = np.arange(T + 1, dtype=np.float64) / T
        f = np.cos((steps + 0.008) / 1.008 * np.pi / 2) ** 2
        betas = np.clip(1.0 - f[1:] / f[:-1], 0.0, 0.999)
    else:
        raise ValueError(f"Unknown beta schedule: {config.beta_schedule}")
    acp = np.cumprod(1.0 - betas).astype(np.float32)
    final = np.float32(1.0) if config.set_alpha_to_one else acp[0]
    return DiffusionSchedule(alphas_cumprod=acp, final_alpha_cumprod=float(final), config=config)


def make_timesteps(config: DDIMConfig, num_steps: int) -> np.ndarray:
    """Descending int32 timesteps; "trailing" is round(arange(T, 0, -T/steps)) - 1."""
    T = config.num_train_timesteps
    if num_steps < 1 or num_steps > T:
        raise ValueError(f"num_steps must be in [1, {T}], got {num_steps}")
    spacing = config.timestep_spacing
    if spacing == "trailing":
        ts = np.round(np.arange(T, 0, -T / num_steps)).astype(np.int32) - 1
    elif spacing == "leading":
        ratio = T // num_steps
        ts = (np.arange(num_steps) * ratio).round().astype(np.int32)[::-1] + config.steps_offset
    elif spacing == "linspace":
        ts = np.linspace(0, T - 1, num_steps).round().astype(np.int32)[::-1]
    else:
        raise ValueError(f"Unknown timestep spacing: {spacing}")
    return np.ascontiguousarray(ts)


def _coeffs(sched: DiffusionSchedule, t: int):
    a = np.float32(sched.alpha_at(t))
    return float(np.sqrt(a)), float(np.sqrt(np.float32(1.0) - a))


def prev_timestep(sched: DiffusionSchedule, t: int, num_steps: int) -> int:
    return t - sched.config.num_train_timesteps // num_steps


@dataclasses.dataclass(frozen=True)
class StepTables:
    """Per-step schedule rows on a device: ``t`` [S] int64, and ``coeffs``
    [S, 4] float32 with columns √ᾱ_t, √(1−ᾱ_t), √ᾱ_prev, √(1−ᾱ_prev)."""

    t: torch.Tensor
    coeffs: torch.Tensor


def step_tables(sched: DiffusionSchedule, timesteps, num_steps: int,
                device: torch.device | str = "cpu") -> StepTables:
    """Step k's timestep and coefficients (``_coeffs`` at t and at the
    previous timestep, the same numpy float32 arithmetic, so each value is
    the host float exactly) as device tensors."""
    ts = [int(t) for t in timesteps]
    rows = [(*_coeffs(sched, t), *_coeffs(sched, prev_timestep(sched, t, num_steps)))
            for t in ts]
    device = torch.device(device)
    return StepTables(t=upload(np.array(ts, dtype=np.int64), device),
                      coeffs=upload(np.array(rows, dtype=np.float32), device))


def pred_original(sched: DiffusionSchedule, model_out, t: int, sample):
    """Tweedie x̂₀ for the configured prediction type (differentiable)."""
    return pred_original_at(sched, model_out, sample, *_coeffs(sched, t))


def pred_original_at(sched: DiffusionSchedule, model_out, sample, sqrt_a, sqrt_1ma):
    """``pred_original`` with the coefficients given (floats, or 0-d float32
    tensors: a ``step_tables`` row)."""
    x, out = sample.float(), model_out.float()
    ptype = sched.config.prediction_type
    if ptype == "epsilon":
        x0 = (x - sqrt_1ma * out) / sqrt_a
    elif ptype == "v_prediction":
        x0 = sqrt_a * x - sqrt_1ma * out
    elif ptype == "sample":
        x0 = out
    else:
        raise ValueError(f"Unknown prediction type: {ptype}")
    if sched.config.clip_sample:
        r = sched.config.clip_sample_range
        x0 = x0.clamp(-r, r)
    return x0.to(sample.dtype)


def pred_epsilon(sched: DiffusionSchedule, model_out, t: int, sample):
    """ε̂ implied by the model output (the gradient-rescale reference)."""
    return pred_epsilon_at(sched, model_out, sample, *_coeffs(sched, t))


def pred_epsilon_at(sched: DiffusionSchedule, model_out, sample, sqrt_a, sqrt_1ma):
    """``pred_epsilon`` with the coefficients given (floats or 0-d tensors)."""
    x, out = sample.float(), model_out.float()
    ptype = sched.config.prediction_type
    if ptype == "epsilon":
        eps = out
    elif ptype == "v_prediction":
        eps = sqrt_a * out + sqrt_1ma * x
    elif ptype == "sample":
        eps = (x - sqrt_a * out) / sqrt_1ma
    else:
        raise ValueError(f"Unknown prediction type: {ptype}")
    return eps.to(sample.dtype)


def ddim_step(sched: DiffusionSchedule, model_out, t: int, sample, num_steps: int):
    """One η=0 DDIM step → ``(prev_sample, pred_original_sample)``."""
    prev_t = prev_timestep(sched, t, num_steps)
    return ddim_step_at(sched, model_out, sample, *_coeffs(sched, t), *_coeffs(sched, prev_t))


def ddim_step_at(sched: DiffusionSchedule, model_out, sample, sqrt_a, sqrt_1ma, sqrt_ap,
                 sqrt_1map):
    """``ddim_step`` with the four coefficients given (floats, or 0-d float32
    tensors: a ``step_tables`` row)."""
    x0 = pred_original_at(sched, model_out, sample, sqrt_a, sqrt_1ma).float()
    eps = pred_epsilon_at(sched, model_out, sample, sqrt_a, sqrt_1ma).float()
    prev = sqrt_ap * x0 + sqrt_1map * eps
    return prev.to(sample.dtype), x0.to(sample.dtype)
