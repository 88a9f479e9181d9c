"""Per-sample guidance losses, PyTorch counterpart of
``depth_completion_tpu.guidance.losses``: l1 / l2 masked anchor losses,
edge (prediction gradient vs gray-image gradient) and smooth (total
variation), and the KLD penalty of the latent toward N(0, 1)."""

from __future__ import annotations

from collections.abc import Sequence

import torch

from depth_completion_tpu_torch.ops.stats import kld_stdnorm

SUPPORTED_LOSS_FUNCS = ("l1", "l2", "edge", "smooth")
_LUMA = (0.299, 0.587, 0.114)  # Rec. 601


def _to_gray(images: torch.Tensor) -> torch.Tensor:
    c = images.shape[-1]
    if c == 3:
        return _LUMA[0] * images[..., 0:1] + _LUMA[1] * images[..., 1:2] + _LUMA[2] * images[..., 2:3]
    if c == 1:
        return images
    raise ValueError(f"Image must have 1 or 3 channels, got {c}")


def compute_loss(
    denses: torch.Tensor,
    sparses: torch.Tensor,
    masks: torch.Tensor,
    loss_funcs: Sequence[str],
    images: torch.Tensor | None = None,
    kld: bool = False,
    kld_weight: float = 0.1,
    kld_mode: str = "simple",
    pred_latents: torch.Tensor | None = None,
) -> torch.Tensor:
    """Combined per-sample loss → [N] float32 (NHWC inputs); with ``kld``,
    plus ``kld_weight`` times each sample's ``kld_stdnorm`` of
    ``pred_latents``."""
    if len(loss_funcs) == 0:
        raise ValueError("loss_funcs must contain at least one loss function")
    if kld and pred_latents is None:
        raise ValueError("pred_latents must be provided when kld is enabled")
    d, s, m = denses.float(), sparses.float(), masks.float()
    num_valid = torch.clamp(m.sum(dim=(1, 2, 3)), min=1.0)
    total = torch.zeros(d.shape[0], dtype=torch.float32, device=d.device)
    for loss_func in loss_funcs:
        if loss_func == "l1":
            total = total + ((d - s).abs() * m).sum(dim=(1, 2, 3)) / num_valid
        elif loss_func == "l2":
            total = total + ((d - s).square() * m).sum(dim=(1, 2, 3)) / num_valid
        elif loss_func == "edge":
            if images is None:
                raise ValueError("images must be provided for edge loss")
            gray = _to_gray(images.float())
            gpx = (d[:, :, :-1] - d[:, :, 1:]).abs()
            gpy = (d[:, :-1] - d[:, 1:]).abs()
            ggx = (gray[:, :, :-1] - gray[:, :, 1:]).abs()
            ggy = (gray[:, :-1] - gray[:, 1:]).abs()
            total = total + (gpx - ggx).abs().mean(dim=(1, 2, 3))
            total = total + (gpy - ggy).abs().mean(dim=(1, 2, 3))
        elif loss_func == "smooth":
            if images is None:
                raise ValueError("images must be provided for smooth loss")
            total = total + (d[:, :-1] - d[:, 1:]).abs().mean(dim=(1, 2, 3))
            total = total + (d[:, :, :-1] - d[:, :, 1:]).abs().mean(dim=(1, 2, 3))
        else:
            raise ValueError(f"Unknown loss function: {loss_func}")
    if kld:
        total = total + kld_weight * kld_stdnorm(pred_latents, reduction="none", mode=kld_mode)
    return total
