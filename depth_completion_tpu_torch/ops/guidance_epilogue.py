"""Fused guidance-step epilogue: ε-rescale + Adam + DDIM in one kernel.

Counterpart of ``depth_completion_tpu.ops.guidance_epilogue``. After the
guidance backward pass of a per-step guided DDIM step, per sample:

    ε̂ = sa·out + s1·lat   (v-prediction; ε̂ = out for ε-prediction)
    g ← g·‖ε̂‖ / max(‖g‖, 1e-7)
    m = b1·m + (1−b1)·g ;  v = b2·v + (1−b2)·g²
    lat ← lat − lr·m·bc1 / (√(v·bc2) + eps)
    lat ← sap·x0(lat) + s1p·ε(lat)   (x0, ε from the updated lat and the old out)

The CUDA kernel (``csrc/guidance_epilogue.cu``) replaces the TPU kernel
``_kernel`` (guidance_epilogue.py:62): one thread-block cluster per sample,
each thread holding its share of the five tensors in registers (read
once), the two norms summed across the cluster's blocks through
distributed shared memory, the update applied from the registers. Any
per-sample size K with K % 4 == 0 launches (the part beyond what the
cluster holds is read a second time); any other K raises, as does a
launch the card refuses. It needs no padding of the latent to 128 lanes
and no relayout, which is where the TPU kernel lost its time. The plain
twin follows ``_epilogue_xla`` (:120).

The six per-step scalars [sa, s1, sap, s1p, bc1, bc2] are read on the
device, from a table of every step's row (``epilogue_table``: the float32
values of ``epilogue_scalars``) at a step index that is a device tensor
too, so one launch captured in a CUDA graph serves every step of a request
(``pipeline.sampler.FusedStepProgram``); lr and Adam's b1, b2 and eps are
constant per request and stay arguments.

The epilogue updates ``lat``, ``m`` and ``v`` in place (the sampler's latent
and Adam state); a CPU tensor takes the plain twin and copies its results
back, a CUDA tensor launches the kernel or raises. ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from depth_completion_tpu_torch import _build
from depth_completion_tpu_torch.device import upload
from depth_completion_tpu_torch.guidance.optim import ADAM_B1, ADAM_B2, ADAM_EPS
from depth_completion_tpu_torch.sched.ddim import DiffusionSchedule, _coeffs

EPSILON = 1e-7  # floor of the gradient norm in the rescale

LAUNCHES = {"guidance_epilogue": 0}

_p, _i, _l, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("guidance_epilogue")
        lib.dct_guidance_epilogue_table.argtypes = [_p] * 5 + [_i, _l, _i, _i, _p, _p] + \
            [_f] * 4 + [_p]
        lib.dct_guidance_epilogue_table.restype = _i
        _lib = lib
    return _lib


def supported(sched: DiffusionSchedule) -> bool:
    """The epilogue's scope: v- or ε-prediction without sample clipping."""
    cfg = sched.config
    return cfg.prediction_type in ("v_prediction", "epsilon") and not cfg.clip_sample


def epilogue_scalars(sched: DiffusionSchedule, t: int, num_steps: int, count: int
                     ) -> tuple[float, ...]:
    """[sa, s1, sap, s1p, bc1, bc2] for the step at timestep ``t`` whose Adam
    count before the step is ``count`` (bias corrections use count + 1)."""
    sa, s1 = _coeffs(sched, t)
    sap, s1p = _coeffs(sched, t - sched.config.num_train_timesteps // num_steps)
    tf = count + 1
    return sa, s1, sap, s1p, 1.0 / (1.0 - ADAM_B1**tf), 1.0 / (1.0 - ADAM_B2**tf)


def epilogue_table(sched: DiffusionSchedule, timesteps, num_steps: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """[steps, 6] float32 on ``device``: row k is ``epilogue_scalars`` of
    step k (timestep ``timesteps[k]``, Adam count k), each value the float32
    the kernel took as an argument before."""
    rows = [epilogue_scalars(sched, int(t), num_steps, k) for k, t in enumerate(timesteps)]
    return upload(np.array(rows, dtype=np.float32), torch.device(device))


def guidance_epilogue_plain(lat, g, out, m, v, table, step, *, lr: float, v_pred: bool):
    """The kernel's function in plain PyTorch (fp32) → (new lat, m, v), with
    the scalars from row ``step`` (a one-element integer tensor) of
    ``table``."""
    b1, b2 = ADAM_B1, ADAM_B2
    sa, s1, sap, s1p, bc1, bc2 = table.index_select(0, step)[0].unbind(0)
    n = lat.shape[0]
    lat, g, out, m, v = (x.float() for x in (lat, g, out, m, v))
    eps_hat = sa * out + s1 * lat if v_pred else out
    eps_norm = eps_hat.reshape(n, -1).norm(dim=1)
    g_norm = g.reshape(n, -1).norm(dim=1)
    g = g * (eps_norm / torch.clamp(g_norm, min=EPSILON)).reshape((n,) + (1,) * (g.dim() - 1))
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    lat = lat - lr * (m * bc1) / (torch.sqrt(v * bc2) + ADAM_EPS)
    if v_pred:
        x0, eps = sa * lat - s1 * out, sa * out + s1 * lat
    else:
        x0, eps = (lat - s1 * out) / sa, out
    return sap * x0 + s1p * eps, m, v


def guidance_epilogue(lat, g, out, m, v, table, step, *, lr: float, v_pred: bool) -> None:
    """One step's epilogue over [N, ...] latents, updating ``lat``, ``m`` and
    ``v`` (fp32, contiguous) in place. ``g`` is the latent gradient (fp32),
    ``out`` the UNet output (bf16 or fp32); the scalars are row ``step`` (a
    one-element int64 tensor) of ``table`` (``epilogue_table``), both on the
    latent's device."""
    if lat.device.type == "cpu":
        for dst, src in zip((lat, m, v), guidance_epilogue_plain(
                lat, g, out, m, v, table, step, lr=lr, v_pred=v_pred)):
            dst.copy_(src)
        return
    g, out = g.contiguous(), out.contiguous()
    for name, t in (("lat", lat), ("g", g), ("m", m), ("v", v), ("out", out)):
        if t.shape != lat.shape:
            raise ValueError(f"epilogue {name} shape {tuple(t.shape)} != latent {tuple(lat.shape)}")
        if name != "out" and t.dtype != torch.float32:
            raise TypeError(f"epilogue {name} must be float32, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"epilogue {name} must be contiguous and 16-byte aligned")
    if out.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"epilogue out must be bfloat16 or float32, got {out.dtype}")
    if (table.dim() != 2 or table.shape[1] != 6 or table.dtype != torch.float32
            or not table.is_contiguous() or table.device != lat.device):
        raise ValueError(f"epilogue table must be [steps, 6] contiguous float32 on {lat.device}, "
                         f"got {tuple(table.shape)} {table.dtype} on {table.device}")
    if step.numel() != 1 or step.dtype != torch.int64 or step.device != lat.device:
        raise ValueError(f"epilogue step must be a one-element int64 tensor on {lat.device}")
    n = lat.shape[0]
    k = lat.numel() // n
    if k % 4:
        raise ValueError(f"epilogue needs a per-sample size divisible by 4, got {k}")
    status = _kernels().dct_guidance_epilogue_table(
        lat.data_ptr(), g.data_ptr(), out.data_ptr(), m.data_ptr(), v.data_ptr(),
        n, k, int(out.dtype == torch.bfloat16), int(v_pred), table.data_ptr(), step.data_ptr(),
        lr, ADAM_B1, ADAM_B2, ADAM_EPS, torch.cuda.current_stream(lat.device).cuda_stream,
    )
    _build.check(status, "guidance_epilogue")
    LAUNCHES["guidance_epilogue"] += 1
