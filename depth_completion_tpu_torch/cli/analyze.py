"""Evaluation CLI, PyTorch-port counterpart of
``depth_completion_tpu.cli.analyze``:

    python -m depth_completion_tpu_torch.cli.analyze DATASET_ROOT RESULT_ROOT [options]

The same flags and defaults, parsed with argparse, plus ``--device
{cuda,cpu}`` (default ``cuda``): ``--accel`` (default on) scores each batch
with one torch function on that device (``eval.analyzer``); ``--accel
false`` scores on the host in numpy. With no GPU, ``--accel`` needs
``--device cpu``. A progress line through the logger replaces tqdm.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Any

from depth_completion_tpu_torch.cli.options import (
    comma_separated,
    existing_dir,
    number_range,
    str2bool,
)
from depth_completion_tpu_torch.eval.analyzer import METRICS, analyze_datasets
from depth_completion_tpu_torch.logger import LOG_LEVELS, Progress, logger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m depth_completion_tpu_torch.cli.analyze",
                                description="Analyze results of depth completion.")
    p.add_argument("dataset_root", type=existing_dir)
    p.add_argument("result_root", type=existing_dir)
    p.add_argument("--log", type=Path, default=None, help="Path to save logs.")
    p.add_argument("--log-level", choices=LOG_LEVELS, default="INFO", help="Minimum log level.")
    p.add_argument("--metrics", type=comma_separated(str), default="mae,rmse",
                   help="Metrics: mae, rmse.")
    p.add_argument("--calc-binned-scores", type=str2bool, default=True,
                   help="Compute per-depth-bin scores.")
    p.add_argument("--bin-size", type=number_range(float, min=0, min_open=True), default=10.0,
                   help="Bin size in meters.")
    p.add_argument("--max-sparse-depth", type=number_range(float, min=0, min_open=True),
                   default=120.0, help="Max distance [m] of sparse maps.")
    p.add_argument("--max-depth", type=number_range(float, min=0, min_open=True),
                   default=120.0, help="Max distance [m] of dense maps.")
    p.add_argument("--min-depth", type=number_range(float, min=0), default=0.0,
                   help="Min distance [m] of dense maps.")
    p.add_argument("-bs", "--batch-size", type=number_range(int, min=1), default=32,
                   help="Batch size for loading depth maps.")
    p.add_argument("-nt", "--num-threads", type=number_range(int, min=1), default=8,
                   help="IO threads.")
    p.add_argument("--accel", type=str2bool, default=True,
                   help="Score each batch with one torch function on --device.")
    p.add_argument("--gt-dir", type=str, default=None,
                   help="Ground-truth subdirectory inside each dataset dir (e.g. "
                   "'groundtruth' for KITTI-DC). Default: the sparse input.")
    p.add_argument("--gt-format", choices=["png8", "png16", "array"], default="png16",
                   help="Ground-truth encoding: png16 = KITTI v/256 m; png8 = 8-bit "
                   "channel-0 v/255*max; array = metric npy/npz/dcz.")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Device of the --accel scorer (the tests pass cpu).")
    return p


def main(argv: list[str] | None = None) -> dict[str, Any]:
    args = build_parser().parse_args(argv)
    logger.configure(level=args.log_level, log_path=args.log)

    metrics_ok = []
    for m in args.metrics:
        if m not in METRICS:
            logger.error(f"Invalid metric: {m} (skipped)")
        else:
            metrics_ok.append(m)
    if not metrics_ok:
        logger.critical("No valid metrics provided")
        sys.exit(1)

    try:
        return analyze_datasets(
            args.dataset_root,
            args.result_root,
            metrics=metrics_ok,
            calc_binned_scores=args.calc_binned_scores,
            bin_size=args.bin_size,
            max_sparse_depth=args.max_sparse_depth,
            max_depth=args.max_depth,
            min_depth=args.min_depth,
            batch_size=args.batch_size,
            num_threads=args.num_threads,
            gt_dir=args.gt_dir,
            gt_format=args.gt_format,
            accel=args.accel,
            progress=Progress(desc="analyze"),
            device=args.device,
        )
    except FileNotFoundError as e:
        logger.critical(str(e))
        sys.exit(1)


if __name__ == "__main__":
    main()
