"""Affine (scale/shift) alignment of affine-invariant depth to the sparse
anchors, PyTorch counterpart of ``depth_completion_tpu.guidance.affine``:
closed form (masked least squares) and learned (squared scale/shift)."""

from __future__ import annotations

import torch

from depth_completion_tpu_torch.ops.stats import masked_minmax

EPSILON = 1e-7


def compute_affine_params(affines, guides, masks):
    """Masked least-squares (scales [N], shifts [N]) float32."""
    n = affines.shape[0]
    a = affines.reshape(n, -1).float()
    g = guides.reshape(n, -1).float()
    m = masks.reshape(n, -1).float()
    num_valid = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    a_mean = (a * m).sum(dim=1, keepdim=True) / num_valid
    g_mean = (g * m).sum(dim=1, keepdim=True) / num_valid
    a_c, g_c = (a - a_mean) * m, (g - g_mean) * m
    scales = (a_c * g_c).sum(dim=1, keepdim=True) / ((a_c * a_c).sum(dim=1, keepdim=True) + EPSILON)
    shifts = g_mean - scales * a_mean
    return scales[:, 0], shifts[:, 0]


def affine_to_metric_closed_form(affines, guides, masks):
    n = affines.shape[0]
    scales, shifts = compute_affine_params(affines, guides, masks)
    return scales.reshape(n, 1, 1, 1) * affines + shifts.reshape(n, 1, 1, 1)


def affine_to_metric_learned(affines, guides, masks, scale, shift):
    """scale²·(max−min)·affine + shift²·min with (min, max) the guide's
    masked range per sample and learned [N,1,1,1] scale/shift."""
    n = affines.shape[0]
    mins, maxs, _ = masked_minmax(guides.reshape(n, -1), masks.reshape(n, -1))
    mins, maxs = mins.reshape(n, 1, 1, 1), maxs.reshape(n, 1, 1, 1)
    return scale.square() * (maxs - mins) * affines + shift.square() * mins
