"""Evaluation metrics and binning (host-side numpy), PyTorch-port
counterpart of ``depth_completion_tpu.eval.metrics``: numpy twins of
``ops.stats.masked_mae``/``masked_rmse`` for the analyzer, and ``calc_bins``.
"""

from __future__ import annotations

import numpy as np


def calc_bins(
    lower_bound: float, upper_bound: float, bin_size: float
) -> list[tuple[float, float]]:
    """Equal bins over [lower, upper]; last bin may be short."""
    if lower_bound >= upper_bound:
        raise ValueError(
            f"Lower bound {lower_bound} must be less than upper bound {upper_bound}"
        )
    bins: list[tuple[float, float]] = []
    while lower_bound < upper_bound:
        bins.append((lower_bound, min(lower_bound + bin_size, upper_bound)))
        lower_bound += bin_size
    return bins


def np_mae(preds: np.ndarray, targets: np.ndarray, mask: np.ndarray | None = None) -> float:
    if mask is not None:
        preds, targets = preds[mask], targets[mask]
    return float(np.mean(np.abs(preds.astype(np.float64) - targets.astype(np.float64))))


def np_rmse(preds: np.ndarray, targets: np.ndarray, mask: np.ndarray | None = None) -> float:
    if mask is not None:
        preds, targets = preds[mask], targets[mask]
    d = preds.astype(np.float64) - targets.astype(np.float64)
    return float(np.sqrt(np.mean(d * d)))
