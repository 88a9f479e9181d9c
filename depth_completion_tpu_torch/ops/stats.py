"""Masked statistics, PyTorch counterpart of ``depth_completion_tpu.ops.stats``:
``masked_minmax`` and ``masked_quantile`` (the sampler's normalisation),
``masked_mae`` and ``masked_rmse`` (the analyzer's scorer), ``kld_stdnorm``
(the guidance's KLD penalty)."""

from __future__ import annotations

import torch


def masked_minmax(x: torch.Tensor, mask: torch.Tensor, dim: int = -1):
    """Min/max of ``x`` over ``dim`` where ``mask`` → (mins, maxs, any_valid).
    Rows with no valid entry give (+inf, -inf) and any_valid False."""
    if x.shape != mask.shape:
        raise ValueError(f"x shape {tuple(x.shape)} != mask shape {tuple(mask.shape)}")
    # scalar fills: no host-to-device copy (the captured guided step runs this)
    mins = torch.where(mask, x, float("inf")).amin(dim=dim)
    maxs = torch.where(mask, x, float("-inf")).amax(dim=dim)
    return mins, maxs, mask.any(dim=dim)


def masked_quantile(x: torch.Tensor, mask: torch.Tensor, qs) -> torch.Tensor:
    """Per-row quantiles of the masked entries of ``x`` [N, M] with linear
    interpolation (``torch.quantile(x[mask], q)`` per row) → [N, Q]."""
    if x.dim() != 2 or x.shape != mask.shape:
        raise ValueError(f"expected matching 2-D x/mask, got {tuple(x.shape)} / {tuple(mask.shape)}")
    x = x.float()
    n_valid = mask.sum(dim=-1).float()
    sorted_x = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))), dim=-1).values
    # each q a scalar operand: no host-to-device copy (the captured prepare
    # step runs this)
    last = torch.clamp(n_valid[:, None] - 1.0, min=0.0)
    pos = torch.cat([float(q) * last for q in qs], dim=-1)
    lo, hi = torch.floor(pos).long(), torch.ceil(pos).long()
    frac = pos - lo.float()
    return sorted_x.gather(-1, lo) * (1.0 - frac) + sorted_x.gather(-1, hi) * frac


def kld_stdnorm(x: torch.Tensor, reduction: str = "mean", mode: str = "simple") -> torch.Tensor:
    """KL divergence of ``x`` (flattened per sample) from N(0, 1), fp32:
    ``simple`` is mean(x²); ``strict`` is 0.5·(μ² + σ² − log(σ² + eps) − 1)
    with the biased variance and eps float32's. ``reduction``: ``mean``,
    ``sum`` over the samples, or ``none`` (one value per sample)."""
    flat = x.reshape(x.shape[0], -1).float()
    if mode == "simple":
        dist = flat.square().mean(dim=-1)
    elif mode == "strict":
        mu = flat.mean(dim=-1)
        var = flat.var(dim=-1, correction=0)
        eps = torch.finfo(torch.float32).eps
        dist = 0.5 * (mu.square() + var - torch.log(var + eps) - 1.0)
    else:
        raise ValueError(f"Unknown mode: {mode}")
    if reduction == "mean":
        return dist.mean()
    if reduction == "sum":
        return dist.sum()
    if reduction == "none":
        return dist
    raise ValueError(f"Unknown reduction: {reduction}")


def masked_mae(preds: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean absolute error over the masked entries (fp32)."""
    err = (preds.float() - targets.float()).abs()
    if mask is None:
        return err.mean()
    m = mask.float()
    return (err * m).sum() / m.sum().clamp(min=1.0)


def masked_rmse(preds: torch.Tensor, targets: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Root mean squared error over the masked entries (fp32)."""
    err = (preds.float() - targets.float()).square()
    if mask is None:
        return err.mean().sqrt()
    m = mask.float()
    return ((err * m).sum() / m.sum().clamp(min=1.0)).sqrt()
