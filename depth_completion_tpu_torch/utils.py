"""Drop-in aggregation of the reference's ``utils`` names over the port's
own modules, name for name with ``depth_completion_tpu.utils``.

Array and image helpers take numpy (host side); the masked statistics
(``masked_minmax``, ``masked_quantile``, ``kld_stdnorm``) take tensors, as
the port's ``ops.stats`` does. ``CommaSeparated`` is an argparse type here
(the port has no click): call it, or ``convert`` as click's type would.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from depth_completion_tpu_torch.cli.options import comma_separated
from depth_completion_tpu_torch.eval.metrics import calc_bins, np_mae as _np_mae, np_rmse as _np_rmse
from depth_completion_tpu_torch.io.codecs import (
    NPARRAY_EXTS,
    is_array_path,
    load_array,
    load_arrays,
    save_array,
)
from depth_completion_tpu_torch.io.csvio import load_csv, load_segmap
from depth_completion_tpu_torch.io.dataset import (
    DATASET_DIR_NAME_IMAGE,
    DATASET_DIR_NAME_SEGMASK,
    DATASET_DIR_NAME_SPARSE,
    RESULT_DIR_NAME_DENSE,
    RESULT_DIR_NAME_VIS,
    find_dataset_dirs,
    find_file_with_exts,
    find_img_paths,
    is_dataset_dir,
)
from depth_completion_tpu_torch.io.image import (
    image_size,
    is_img_file,
    load_img_array,
    load_img_arrays,
    save_img_array,
    to_depth,
    to_segmask,
)
from depth_completion_tpu_torch.ops.stats import (
    kld_stdnorm,
    masked_minmax,
    masked_quantile,
)
from depth_completion_tpu_torch.viz import has_nan, make_grid, visualize_depth

EPSILON = 1e-7


class CommaSeparated:
    """Parse "a,b,c" into a typed list; optionally exactly ``n`` items
    (reference utils.py:742-814). Bad input raises
    ``argparse.ArgumentTypeError``."""

    name = "comma_separated"

    def __init__(self, type_: type = str, n: int | None = None) -> None:
        self.type = type_
        self.n = n
        self._parse = comma_separated(type_, n)

    def __call__(self, value: str) -> list[Any]:
        return self._parse(value)

    def convert(self, value, param=None, ctx=None) -> list[Any] | None:
        if value is None or isinstance(value, list):
            return value
        return self._parse(value)


def filterout(li: list[Any], flags: list[bool]) -> list[Any]:
    """Keep items whose flag is True (reference utils.py:141-159)."""
    if len(li) != len(flags):
        raise ValueError(
            f"Length of list {len(li)} must be equal to length of flags {len(flags)}"
        )
    return [item for item, flag in zip(li, flags) if flag]


def mae(preds, targets, masks=None) -> float:
    """Masked mean absolute error (reference utils.py:692-714), host numpy."""
    return _np_mae(np.asarray(preds), np.asarray(targets), None if masks is None else np.asarray(masks))


def rmse(preds, targets, masks=None) -> float:
    """Masked RMSE (reference utils.py:717-739), host numpy."""
    return _np_rmse(np.asarray(preds), np.asarray(targets), None if masks is None else np.asarray(masks))


__all__ = [
    "CommaSeparated",
    "DATASET_DIR_NAME_IMAGE",
    "DATASET_DIR_NAME_SEGMASK",
    "DATASET_DIR_NAME_SPARSE",
    "EPSILON",
    "NPARRAY_EXTS",
    "RESULT_DIR_NAME_DENSE",
    "RESULT_DIR_NAME_VIS",
    "calc_bins",
    "filterout",
    "find_dataset_dirs",
    "find_file_with_exts",
    "find_img_paths",
    "has_nan",
    "image_size",
    "is_array_path",
    "is_dataset_dir",
    "is_img_file",
    "kld_stdnorm",
    "load_array",
    "load_arrays",
    "load_csv",
    "load_img_array",
    "load_img_arrays",
    "load_segmap",
    "mae",
    "make_grid",
    "masked_minmax",
    "masked_quantile",
    "rmse",
    "save_array",
    "save_img_array",
    "to_depth",
    "to_segmask",
    "visualize_depth",
]
