"""Depth projections and sparse-depth normalisation, PyTorch counterpart of
``depth_completion_tpu.guidance.projection``:

1. per-sample depth range from the sparse map (const | minmax | percentile)
2. clamp to the range, project (linear | log | log10, optionally inverted)
3. affine-normalise to [0, 1]

All tensors are NHWC with one channel for depth.
"""

from __future__ import annotations

import dataclasses

import torch

from depth_completion_tpu_torch.ops.stats import masked_minmax, masked_quantile


def project(x: torch.Tensor, projection: str, inv: bool) -> torch.Tensor:
    if projection == "log":
        x = torch.log(x)
    elif projection == "log10":
        x = torch.log10(x)
    elif projection != "linear":
        raise ValueError(f"Unknown projection method: {projection}")
    return 1.0 / x if inv else x


@dataclasses.dataclass(frozen=True)
class DepthNormalization:
    """Per-sample normalisation state; ranges are [N,1,1,1]."""

    sparses_normed: torch.Tensor  # [N, H, W, 1] in [0, 1]
    masks: torch.Tensor  # [N, H, W, 1] bool
    min_depths: torch.Tensor
    max_depths: torch.Tensor
    min_proj: torch.Tensor
    max_proj: torch.Tensor
    any_valid: torch.Tensor  # [N] bool


def normalize_sparse(
    sparses: torch.Tensor,
    *,
    norm: str,
    projection: str,
    inv: bool,
    min_depth: float,
    max_depth: float,
    percentile: tuple[float, float] = (0.01, 0.99),
) -> DepthNormalization:
    if sparses.dim() != 4 or sparses.shape[-1] != 1:
        raise ValueError(f"sparses must be [N,H,W,1], got {tuple(sparses.shape)}")
    n = sparses.shape[0]
    sparses = sparses.float()
    masks = sparses > 0
    flat, flat_mask = sparses.reshape(n, -1), masks.reshape(n, -1)
    if norm == "minmax":
        mins, maxs, any_valid = masked_minmax(flat, flat_mask)
    elif norm == "percentile":
        ranges = masked_quantile(flat, flat_mask, percentile)
        mins, maxs = ranges[:, 0], ranges[:, 1]
        any_valid = flat_mask.any(dim=-1)
    elif norm == "const":
        mins = torch.full((n,), float(min_depth), device=sparses.device)
        maxs = torch.full((n,), float(max_depth), device=sparses.device)
        any_valid = flat_mask.any(dim=-1)
    else:
        raise ValueError(f"Unknown norm method: {norm}")
    mins, maxs = mins.reshape(n, 1, 1, 1), maxs.reshape(n, 1, 1, 1)
    sparses_clamped = torch.minimum(torch.maximum(sparses, mins), maxs)
    if norm in ("minmax", "percentile"):
        mins = torch.clamp(mins, min=min_depth)
        maxs = torch.clamp(maxs, max=max_depth)
    min_proj = project(mins, projection, inv=False)
    max_proj = project(maxs, projection, inv=False)
    sparses_proj = project(sparses_clamped, projection, inv=False)
    if inv:
        min_proj, max_proj = 1.0 / max_proj, 1.0 / min_proj
        sparses_proj = 1.0 / sparses_proj
    return DepthNormalization(
        sparses_normed=(sparses_proj - min_proj) / (max_proj - min_proj),
        masks=masks,
        min_depths=mins,
        max_depths=maxs,
        min_proj=min_proj,
        max_proj=max_proj,
        any_valid=any_valid,
    )


def renormalize_to_guidance(denses_normed, dn: DepthNormalization, projection: str, inv: bool):
    """[0,1] linear-space prediction → guidance space (identity for linear)."""
    if projection == "linear" and not inv:
        return denses_normed
    metric = denses_normed * (dn.max_depths - dn.min_depths) + dn.min_depths
    proj = project(metric, projection, inv=False)
    if inv:
        proj = 1.0 / proj
    return (proj - dn.min_proj) / (dn.max_proj - dn.min_proj)


def denormalize_depth(denses_normed, dn: DepthNormalization):
    """[0,1] → metric depth."""
    return denses_normed * (dn.max_depths - dn.min_depths) + dn.min_depths
