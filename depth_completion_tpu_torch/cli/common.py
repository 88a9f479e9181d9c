"""Option coercion and model init shared by the port's CLI entry points,
PyTorch-port counterpart of ``depth_completion_tpu.cli.common``.

The coercion rules are the JAX package's: invalid loss functions are
skipped with an error log, ``norm=const`` is incompatible with log/inverse
projections, the LCM model cannot train latents, and disabling latent
training forces the closed-form affine.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Any

import torch

from depth_completion_tpu_torch.logger import logger

SUPPORTED_LOSS_FUNCS = ["l1", "l2", "edge", "smooth"]


def coerce_guidance_options(
    loss_funcs: list[str],
    norm: str,
    projection: str,
    inv: bool,
    model: str,
    train_latents: bool,
    closed_form: bool,
) -> tuple[list[str], str, bool, bool]:
    """Apply the JAX package's option-coercion rules.

    Returns the coerced ``(loss_funcs, norm, train_latents, closed_form)``.
    An entirely-invalid ``loss_funcs`` list coerces to an empty list — the
    sampler raises its clear ValueError downstream.
    """
    loss_funcs_ok = []
    for lf in loss_funcs:
        if lf not in SUPPORTED_LOSS_FUNCS:
            logger.error(f"Invalid loss function (skipped): {lf}")
        else:
            loss_funcs_ok.append(lf)
    loss_funcs = loss_funcs_ok

    if (projection in ("log", "log10") or inv) and norm == "const":
        logger.error(
            "norm=const is not allowed when projection=log/log10 or inv=True. "
            "Falling back to norm=minmax"
        )
        norm = "minmax"
    if model == "lcm" and train_latents:
        logger.error(
            "LCM-based model does not support trainable latents. "
            "Falling back to train_latents=False"
        )
        train_latents = False
    if not train_latents and not closed_form:
        logger.error(
            "closed-form solution must be enabled without trainable latents. "
            "Falling back to closed_form=True"
        )
        closed_form = True
    return loss_funcs, norm, train_latents, closed_form


def exact_fp32() -> None:
    """fp32 all the way through: cuDNN's convolutions (the UNet's) and
    cuBLAS's products in full fp32, not TF32 (PyTorch rounds fp32
    convolutions to TF32 by default); the port's own fp32 kernels take
    3xTF32 (``ops.conv3x3``, ``ops.flash_attention``)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def init_bundle(
    model: str,
    checkpoint_dir: Path | None,
    taesd_dir: Path | None,
    vae: str,
    precision: str,
    device: str | torch.device,
) -> Any:
    """The model bundle of a CLI invocation on ``device`` (random or from a
    checkpoint directory).

    ``--model=random`` gives a random-weight bundle (full Marigold geometry,
    or the tiny test geometry under DCT_RANDOM_MODEL_SIZE=tiny); otherwise
    a local HF-layout checkpoint directory is required (exits with a clear
    message if missing; nothing is downloaded).
    """
    from depth_completion_tpu_torch.models import registry
    from depth_completion_tpu_torch.models.bundle import load_bundle, make_random_bundle

    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    if dtype == torch.float32:
        exact_fp32()
    vae_kind = "tiny" if vae == "light" else "kl"
    if model == "random":
        logger.warning("Running with RANDOM weights (smoke-test mode)")
        if os.environ.get("DCT_RANDOM_MODEL_SIZE") == "tiny":
            # scaled-down geometry for CPU smoke tests
            return make_random_bundle(seed=0, vae_kind=vae_kind, dtype=dtype, device=device)
        return make_random_bundle(
            seed=0,
            unet_config=registry.MARIGOLD_UNET_CONFIG,
            vae_kind=vae_kind,
            vae_config=registry.TAESD_CONFIG if vae_kind == "tiny" else registry.SD_VAE_CONFIG,
            text_config=registry.SD2_TEXT_CONFIG,
            dtype=dtype,
            device=device,
        )
    if checkpoint_dir is None:
        logger.critical(
            "--checkpoint-dir is required (nothing is downloaded). "
            "Use --model=random for smoke tests."
        )
        sys.exit(1)
    return load_bundle(checkpoint_dir, vae_kind=vae_kind, taesd_dir=taesd_dir, dtype=dtype,
                       device=device)
