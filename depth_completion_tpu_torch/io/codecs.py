"""Array codecs, PyTorch-port counterpart of
``depth_completion_tpu.io.codecs``: ``.npy`` / ``.npz`` (under ``arr_0``),
``.bl2`` (blosc2's contiguous frame, ``io/bl2.py``) and ``.dcz``
(``io/dcz.py``), with threaded batch loaders. Arrays may be numpy arrays or
tensors; floats other than float32/float64 (bfloat16, float16) are upcast
to float32 on save.
"""

from __future__ import annotations

import concurrent.futures
from pathlib import Path
from typing import Any

import numpy as np
import torch

from depth_completion_tpu_torch.io.bl2 import load_bl2, save_bl2
from depth_completion_tpu_torch.io.dcz import load_dcz, save_dcz

NPARRAY_EXTS = [".npy", ".npz", ".bl2", ".dcz"]


def is_array_path(path: Path) -> bool:
    return path.is_file() and path.suffix in NPARRAY_EXTS


def _as_numpy(x: Any) -> np.ndarray:
    """A host float32/float64 (or non-float) array: tensors are moved to
    the host, narrower floats upcast to float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point() and x.dtype not in (torch.float32, torch.float64):
            x = x.float()
        return x.cpu().numpy()
    x = np.asarray(x)
    if x.dtype.kind == "f" and x.dtype not in (np.float32, np.float64):
        x = x.astype(np.float32)
    return x


def load_array(path: Path) -> np.ndarray:
    """Load ``.npy`` / ``.npz`` / ``.bl2`` / ``.dcz``."""
    path = Path(path)
    if not is_array_path(path):
        raise ValueError(
            f"Invalid extension: {path.suffix} (must be one of {NPARRAY_EXTS})"
        )
    if path.suffix == ".bl2":
        return load_bl2(path)
    if path.suffix == ".dcz":
        return load_dcz(path)
    if path.suffix == ".npz":
        return np.load(path)["arr_0"]
    return np.load(path)


def save_array(x: Any, path: Path, compress: str | None = None, bl2_codec: str = "zstd") -> None:
    """Save with the JAX package's extension/compression contract.
    ``bl2_codec`` is the ``.bl2`` writer's codec: "zstd" (what the JAX
    package writes by default; needs the system libzstd), or "blosclz",
    "lz4", "lz4hc" or "zlib" (the port's own encoders and Python's zlib)."""
    path = Path(path)
    expected = {None: ".npy", "npy": ".npy", "npz": ".npz", "bl2": ".bl2", "dcz": ".dcz"}
    if compress not in expected:
        raise ValueError(f"Unknown compression: {compress}")
    if bl2_codec != "zstd" and compress != "bl2":
        raise ValueError(f"bl2_codec={bl2_codec!r} is for compress='bl2', not {compress!r}")
    if path.suffix != expected[compress]:
        raise ValueError(
            f"Invalid extension: {path.suffix} (must be {expected[compress]})"
        )
    x = _as_numpy(x)
    path.parent.mkdir(parents=True, exist_ok=True)
    if compress == "bl2":
        save_bl2(x, path, codec=bl2_codec)
    elif compress == "npz":
        np.savez_compressed(path, x)
    elif compress == "dcz":
        save_dcz(x, path)
    else:
        np.save(path, x)


def load_arrays(paths: list[Path], num_threads: int = 1) -> list[np.ndarray]:
    """Order-preserving threaded batch load."""
    if not paths:
        return []
    if num_threads == 1:
        return [load_array(p) for p in paths]
    with concurrent.futures.ThreadPoolExecutor(max_workers=num_threads) as ex:
        return list(ex.map(load_array, paths))
