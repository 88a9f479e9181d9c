"""Dense-vs-sparse evaluation engine, PyTorch-port counterpart of
``depth_completion_tpu.eval.analyzer`` (the analyze CLI's core).

Semantics as in the JAX package:
- dataset dirs found recursively; results mirror the tree under result_root
- pairs ``sparse/*.png`` with ``dense/*.{npy,npz,bl2}`` by stem (first stem
  wins on duplicates)
- the "ground truth" is the sparse input itself (self-consistency); scores
  are means of per-batch means; binned masks use inclusive bounds
- per-dataset ``results.json`` + global ``results_all.json``

Extension over the reference: ``gt_dir`` lets a true ground-truth directory
(e.g. KITTI-DC ``groundtruth``) replace the sparse maps as the comparison
target while keeping the same pairing logic — the BASELINE.md KITTI/NYU
configs need this. ``gt_format`` decodes it:

- "png8":  the reference's 8-bit channel-0 convention (v/255 · max_depth)
- "png16": KITTI-DC 16-bit PNGs (depth = v/256 meters, 0 = invalid),
  decoded by the port's ``io/png.py``
- "array": npy/npz/dcz metric depth arrays

``accel`` scores each batch with one torch function on ``device`` (the
counterpart of the JAX package's jitted scorer): overall and binned masked
MAE/RMSE and point counts, in float32.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from depth_completion_tpu_torch.device import resolve_device
from depth_completion_tpu_torch.eval.metrics import calc_bins, np_mae, np_rmse
from depth_completion_tpu_torch.io.codecs import NPARRAY_EXTS, load_arrays
from depth_completion_tpu_torch.io.dataset import (
    DATASET_DIR_NAME_SPARSE,
    RESULT_DIR_NAME_DENSE,
    find_dataset_dirs,
    find_file_with_exts,
)
from depth_completion_tpu_torch.io.image import load_img_arrays, to_depth
from depth_completion_tpu_torch.io.png import read_png
from depth_completion_tpu_torch.logger import logger
from depth_completion_tpu_torch.ops.stats import masked_mae, masked_rmse

METRICS = ("mae", "rmse")
_METRIC_FNS = {"mae": np_mae, "rmse": np_rmse}


def _make_accel_scorer(bin_ranges, min_depth, max_depth, device):
    """One torch function per batch on ``device``: overall + per-bin masked
    MAE/RMSE/counts → (overall [3], binned [n_bins, 3]) as numpy."""
    lowers = torch.tensor([lo for lo, _ in bin_ranges], dtype=torch.float32, device=device)
    uppers = torch.tensor([hi for _, hi in bin_ranges], dtype=torch.float32, device=device)
    shape = (-1, 1, 1, 1, 1)

    @torch.no_grad()
    def score(denses, sparses):
        d = torch.as_tensor(np.asarray(denses, np.float32), device=device)
        s = torch.as_tensor(np.asarray(sparses, np.float32), device=device)
        mask = s > 0
        s = s.clamp(min_depth, max_depth)
        d = d.clamp(min_depth, max_depth)
        overall = torch.stack([masked_mae(d, s, mask), masked_rmse(d, s, mask),
                               mask.sum().float()])
        m = (mask[None] & (s[None] >= lowers.view(shape)) & (s[None] <= uppers.view(shape)))
        m = m.flatten(1).float()
        n = m.sum(dim=1)
        err = (d - s).flatten()
        mae = (m * err.abs()).sum(dim=1) / n.clamp(min=1.0)
        rmse = ((m * err.square()).sum(dim=1) / n.clamp(min=1.0)).sqrt()
        binned = torch.stack([mae, rmse, n], dim=1)
        return overall.cpu().numpy(), binned.cpu().numpy()

    return score


def _pair_paths(sparse_dir: Path, dense_dir: Path) -> tuple[list[Path], list[Path]]:
    sparse_paths: list[Path] = []
    dense_paths: list[Path] = []
    seen: set[str] = set()
    for path in sorted(sparse_dir.rglob("*")):
        if path.suffix != ".png" or path.stem in seen:
            continue
        seen.add(path.stem)
        dense = find_file_with_exts(
            dense_dir / path.relative_to(sparse_dir), NPARRAY_EXTS
        )
        if dense is None:
            logger.warning(f"No dense depth map found for {path} (skipped)")
            continue
        sparse_paths.append(path)
        dense_paths.append(dense)
    return sparse_paths, dense_paths


def _load_gt_batch(
    gt_paths: list[Path],
    gt_format: str,
    max_sparse_depth: float,
    num_threads: int,
) -> np.ndarray:
    """[B,H,W,1] metric ground-truth depth; 0 marks invalid pixels."""
    if gt_format == "png8":
        imgs = load_img_arrays(gt_paths, mode="RGB", num_threads=num_threads)
        return to_depth(np.stack(imgs), max_distance=max_sparse_depth)
    if gt_format == "png16":
        outs = [read_png(p).astype(np.float32) / 256.0 for p in gt_paths]
        return np.stack(outs)[..., np.newaxis]
    if gt_format == "array":
        arrs = load_arrays(gt_paths, num_threads=num_threads)
        out = np.stack(arrs).astype(np.float32)
        return out if out.ndim == 4 else out[..., np.newaxis]
    raise ValueError(f"Unknown gt format: {gt_format}")


def analyze_datasets(
    dataset_root: Path,
    result_root: Path,
    metrics: tuple[str, ...] = ("mae", "rmse"),
    calc_binned_scores: bool = True,
    bin_size: float = 10.0,
    max_sparse_depth: float = 120.0,
    max_depth: float = 120.0,
    min_depth: float = 0.0,
    batch_size: int = 32,
    num_threads: int = 8,
    gt_dir: str | None = None,
    gt_format: str = "png16",
    accel: bool = False,
    progress: Any | None = None,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Run the evaluation; writes results.json files, returns the global dict.
    With ``accel``, batches are scored on ``device`` (default: the GPU)."""
    dataset_root, result_root = Path(dataset_root), Path(result_root)
    dataset_dirs = find_dataset_dirs(dataset_root)
    if not dataset_dirs:
        raise FileNotFoundError(f"No dataset directories found at {dataset_root}")
    logger.info(f"Found {len(dataset_dirs):,} datasets")

    bin_ranges = calc_bins(min_depth, max_depth, bin_size)
    accel_scorer = None
    if accel:
        dev = resolve_device(device)
        accel_scorer = _make_accel_scorer(bin_ranges, min_depth, max_depth, dev)
        logger.info(f"Accelerated metrics on {dev}")
    g_overall: dict[str, list[float]] = {m: [] for m in metrics}
    g_binned: list[dict[str, list[float]]] = [
        {m: [] for m in metrics} for _ in bin_ranges
    ]
    g_pts = 0
    g_pts_binned = [0] * len(bin_ranges)

    for dataset_dir in dataset_dirs:
        result_dir = result_root / dataset_dir.relative_to(dataset_root)
        if not result_dir.exists():
            logger.warning(
                f"No result directory found for {dataset_dir.name}. Skip this dataset"
            )
            continue
        sparse_dir = dataset_dir / DATASET_DIR_NAME_SPARSE
        dense_dir = result_dir / RESULT_DIR_NAME_DENSE
        sparse_paths, dense_paths = _pair_paths(sparse_dir, dense_dir)
        if not sparse_paths:
            logger.warning(
                f"No dense & sparse pairs found for {dataset_dir.name}. Skip"
            )
            continue

        gt_paths: list[Path] | None = None
        if gt_dir is not None:
            gt_root = dataset_dir / gt_dir
            gt_paths = []
            keep = []
            for j, sp in enumerate(sparse_paths):
                rel = sp.relative_to(sparse_dir)
                if gt_format == "array":
                    gp = find_file_with_exts(gt_root / rel, NPARRAY_EXTS)
                else:
                    gp = gt_root / rel.with_suffix(".png")
                    gp = gp if gp.exists() else None
                if gp is None:
                    logger.warning(f"No ground truth for {sp} (skipped)")
                    continue
                gt_paths.append(gp)
                keep.append(j)
            sparse_paths = [sparse_paths[j] for j in keep]
            dense_paths = [dense_paths[j] for j in keep]
            if not sparse_paths:
                logger.warning(f"No GT pairs for {dataset_dir.name}. Skip")
                continue
        logger.info(f"Found {len(sparse_paths):,} pairs for {dataset_dir.name}")

        d_overall: dict[str, list[float]] = {m: [] for m in metrics}
        d_binned: list[dict[str, list[float]]] = [
            {m: [] for m in metrics} for _ in bin_ranges
        ]
        d_pts = 0
        d_pts_binned = [0] * len(bin_ranges)

        for i in range(0, len(sparse_paths), batch_size):
            sp = sparse_paths[i : i + batch_size]
            dp = dense_paths[i : i + batch_size]
            if gt_paths is not None:
                # true-GT evaluation: target = ground truth, mask = gt>0
                sparses = _load_gt_batch(
                    gt_paths[i : i + batch_size], gt_format, max_sparse_depth,
                    num_threads,
                )
            else:
                # reference behavior: self-consistency vs the sparse input
                sparses = to_depth(
                    np.stack(load_img_arrays(sp, mode="RGB", num_threads=num_threads)),
                    max_distance=max_sparse_depth,
                )  # [B,H,W,1]
            denses = np.stack(load_arrays(dp, num_threads=num_threads))
            denses = denses.reshape(sparses.shape)

            if accel_scorer is not None:
                overall, binned = accel_scorer(denses, sparses)
                scores_by_name = {"mae": overall[0], "rmse": overall[1]}
                for m in metrics:
                    d_overall[m].append(float(scores_by_name[m]))
                    g_overall[m].append(float(scores_by_name[m]))
                d_pts += int(overall[2])
                g_pts += int(overall[2])
                if calc_binned_scores:
                    for b in range(len(bin_ranges)):
                        n_bin = int(binned[b, 2])
                        if n_bin == 0:
                            continue
                        bin_scores = {"mae": binned[b, 0], "rmse": binned[b, 1]}
                        for m in metrics:
                            d_binned[b][m].append(float(bin_scores[m]))
                            g_binned[b][m].append(float(bin_scores[m]))
                        d_pts_binned[b] += n_bin
                        g_pts_binned[b] += n_bin
                if progress is not None:
                    progress.update(len(sp))
                continue

            mask = sparses > 0
            n_pts = int(mask.sum())
            sparses = np.clip(sparses, min_depth, max_depth)
            denses = np.clip(denses, min_depth, max_depth)

            for m in metrics:
                score = _METRIC_FNS[m](denses, sparses, mask)
                d_overall[m].append(score)
                g_overall[m].append(score)
            d_pts += n_pts
            g_pts += n_pts

            if calc_binned_scores:
                for b, (lo, hi) in enumerate(bin_ranges):
                    mb = mask & (sparses >= lo) & (sparses <= hi)
                    if not mb.any():
                        continue
                    for m in metrics:
                        score = _METRIC_FNS[m](denses, sparses, mb)
                        d_binned[b][m].append(score)
                        g_binned[b][m].append(score)
                    d_pts_binned[b] += int(mb.sum())
                    g_pts_binned[b] += int(mb.sum())
            if progress is not None:
                progress.update(len(sp))

        results: dict[str, Any] = {"overall": {}}
        logger.info(f"[{dataset_dir.name}]:")
        logger.info(f"  {min_depth:.1f} <= x <= {max_depth:.1f}:")
        for m in metrics:
            score = float(np.mean(d_overall[m])) if d_overall[m] else float("nan")
            results["overall"][m] = score
            logger.info(f"    {m}: {score:.2f}")
        if calc_binned_scores:
            results["binned"] = []
            for b, (lo, hi) in enumerate(bin_ranges):
                pct = 100.0 * d_pts_binned[b] / max(d_pts, 1)
                entry: dict[str, Any] = {
                    "range": (lo, hi),
                    "metrics": {},
                    "percentage": pct,
                }
                for m in metrics:
                    entry["metrics"][m] = (
                        float(np.mean(d_binned[b][m])) if d_binned[b][m] else float("nan")
                    )
                results["binned"].append(entry)
        save_path = result_dir / "results.json"
        with save_path.open("w") as f:
            json.dump(results, f, indent=2)
        logger.success(f"Saved results to {save_path}")

    results_all: dict[str, Any] = {"overall": {}, "binned": []}
    for m in metrics:
        score = float(np.mean(g_overall[m])) if g_overall[m] else float("nan")
        results_all["overall"][m] = score
        logger.info(f"[All] {m}: {score:.2f}")
    if calc_binned_scores:
        for b, (lo, hi) in enumerate(bin_ranges):
            pct = 100.0 * g_pts_binned[b] / max(g_pts, 1)
            entry = {"range": (lo, hi), "metrics": {}, "percentage": pct}
            for m in metrics:
                entry["metrics"][m] = (
                    float(np.mean(g_binned[b][m])) if g_binned[b][m] else float("nan")
                )
            results_all["binned"].append(entry)
    save_path = result_root / "results_all.json"
    with save_path.open("w") as f:
        json.dump(results_all, f, indent=2)
    logger.success(f"Saved results for all datasets to {save_path}")
    return results_all
