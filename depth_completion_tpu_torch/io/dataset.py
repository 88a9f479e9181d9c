"""Dataset discovery and pairing, PyTorch-port counterpart of
``depth_completion_tpu.io.dataset``.

A dataset directory contains ``image/`` + ``sparse/`` (and optionally
``segmask/`` with a ``map.csv``); results mirror the tree under ``dense/``
and ``vis/``.
"""

from __future__ import annotations

from pathlib import Path

from depth_completion_tpu_torch.io.image import is_img_file

DATASET_DIR_NAME_SPARSE = "sparse"
DATASET_DIR_NAME_IMAGE = "image"
DATASET_DIR_NAME_SEGMASK = "segmask"
RESULT_DIR_NAME_DENSE = "dense"
RESULT_DIR_NAME_VIS = "vis"


def is_dataset_dir(path: Path) -> bool:
    return (
        path.is_dir()
        and (path / DATASET_DIR_NAME_SPARSE).is_dir()
        and (path / DATASET_DIR_NAME_IMAGE).is_dir()
    )


def find_dataset_dirs(root: Path) -> list[Path]:
    """The root itself if it is a dataset dir, else a recursive search."""
    root = Path(root)
    if is_dataset_dir(root):
        return [root]
    return [p for p in root.rglob("*") if is_dataset_dir(p)]


def find_img_paths(root: Path) -> list[Path]:
    return [p for p in Path(root).rglob("*") if is_img_file(p)]


def find_file_with_exts(path: Path, exts: list[str] | None = None) -> Path | None:
    """Exact path, else same stem with one of the alternative extensions."""
    if path.exists() and path.is_file():
        return path
    if exts is not None:
        for ext in exts:
            alt = path.with_suffix(ext)
            if alt.exists() and alt.is_file():
                return alt
    return None
