"""Host-side image IO, PyTorch-port counterpart of
``depth_completion_tpu.io.image`` (which decodes with OpenCV; the port's
machines have no ``cv2``, so PNG goes through ``io/png.py`` and JPEG out
through ``io/jpeg.py``), keeping cv2's contract:

- ``load_img_array``: a PNG decoded as ``cv2.imread(IMREAD_UNCHANGED)``
  would decode it, then the JAX package's conversions: RGB out for
  ``mode="RGB"`` (grey replicated, alpha dropped), ``mode="L"`` from colour
  by cv2's fixed-point BGR2GRAY (4899/9617/1868, ``>> 14`` with
  rounding), ``mode=None`` keeps cv2's channel order (BGR for 3 or 4
  channels); an all-zero image or a file that is not an image gives
  ``None``. A JPEG (or other non-PNG) input raises ``NotImplementedError``:
  decoding it waits for a later slice (ROADMAP queue 1, item 4a).
- ``image_size``: header sniffing (PNG/JPEG/GIF/BMP), a copy.
- ``save_img_array``: ``.png`` through ``io/png.py``, ``.jpg``/``.jpeg``
  through ``io/jpeg.py`` (quality 95, 4:2:0, as cv2 writes them).
- ``to_depth`` / ``to_segmask``: copies.
"""

from __future__ import annotations

import concurrent.futures
import struct
from pathlib import Path

import numpy as np

from depth_completion_tpu_torch.io.jpeg import write_jpeg
from depth_completion_tpu_torch.io.png import SIGNATURE, read_png, write_png

def image_size(path: Path) -> tuple[int, int]:
    """(width, height) from file headers; (-1, -1) if not a known image."""
    try:
        with open(path, "rb") as f:
            head = f.read(32)
            if len(head) < 10:
                return (-1, -1)
            # PNG
            if head.startswith(b"\x89PNG\r\n\x1a\n"):
                w, h = struct.unpack(">II", head[16:24])
                return (w, h)
            # GIF
            if head[:6] in (b"GIF87a", b"GIF89a"):
                w, h = struct.unpack("<HH", head[6:10])
                return (w, h)
            # BMP
            if head.startswith(b"BM"):
                w, h = struct.unpack("<ii", head[18:26])
                return (w, abs(h))
            # JPEG: walk the segment markers to a SOF
            if head.startswith(b"\xff\xd8"):
                f.seek(2)
                while True:
                    seg = f.read(4)
                    if len(seg) < 4:
                        return (-1, -1)
                    marker, size = seg[0:2], struct.unpack(">H", seg[2:4])[0]
                    if marker[0] != 0xFF:
                        return (-1, -1)
                    if 0xC0 <= marker[1] <= 0xCF and marker[1] not in (
                        0xC4,
                        0xC8,
                        0xCC,
                    ):
                        body = f.read(5)
                        h, w = struct.unpack(">HH", body[1:5])
                        return (w, h)
                    f.seek(size - 2, 1)
    except OSError:
        pass
    return (-1, -1)


def is_img_file(path: Path) -> bool:
    return path.is_file() and image_size(path) != (-1, -1)


def _bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """cv2's ``COLOR_BGR2GRAY`` (fixed point, 14 fractional bits, rounded)."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    return ((b * 1868 + g * 9617 + r * 4899 + (1 << 13)) >> 14).astype(img.dtype)


def load_img_array(path: Path, mode: str | None = None) -> np.ndarray | None:
    """Decode an image to [H,W,C] numpy; None on failure or all-zero image."""
    path = Path(path)
    if not is_img_file(path):
        return None
    with open(path, "rb") as f:
        if f.read(8) != SIGNATURE:
            raise NotImplementedError(
                f"{path}: only PNG inputs can be decoded yet; JPEG (and other) input "
                "decoding waits for a later slice (ROADMAP queue 1, item 4a)")
    img = read_png(path)
    if img.ndim == 3:  # cv2's order: BGR(A)
        img = img[..., [2, 1, 0, 3][: img.shape[2]]]
    if mode is None:
        if img.ndim == 3 and img.shape[2] == 3:
            mode = "RGB"
        elif img.ndim == 2:
            mode = "L"
    if mode == "RGB":
        img = np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img[..., 2::-1]
    elif mode == "L":
        if img.ndim == 3:
            img = _bgr_to_gray(img)
        img = img[..., np.newaxis]
    if not np.any(img):
        return None
    return np.ascontiguousarray(img)


def load_img_arrays(
    paths: list[Path], mode: str | None = None, num_threads: int = 1
) -> list[np.ndarray | None]:
    """Order-preserving threaded batch decode."""
    if not paths:
        return []
    if num_threads == 1:
        return [load_img_array(p, mode) for p in paths]
    with concurrent.futures.ThreadPoolExecutor(max_workers=num_threads) as ex:
        return list(ex.map(lambda p: load_img_array(p, mode), paths))


def save_img_array(img: np.ndarray, path: Path) -> None:
    """Save [H,W,C] RGB (uint8 or float in [0, 1]) as ``.png`` or ``.jpg``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if img.dtype != np.uint8:
        if img.max() > 1.0 + 1e-6 or img.min() < -1e-6:
            raise ValueError("float image must be in [0, 1]")
        img = (np.clip(img, 0, 1) * 255.0).round().astype(np.uint8)
    suffix = path.suffix.lower()
    if suffix == ".png":
        write_png(img, path)
    elif suffix in (".jpg", ".jpeg"):
        write_jpeg(img, path)
    else:
        raise ValueError(f"Failed to write image to {path}: only .png and .jpg are supported")


def to_depth(
    imgs: np.ndarray, dtype=np.float32, max_distance: float = 120.0
) -> np.ndarray:
    """[N,H,W,3] uint8-range → [N,H,W,1] metric depth from channel 0."""
    return (max_distance * (imgs.astype(dtype)[..., 0] / 255.0))[..., np.newaxis]


def to_segmask(
    imgs: np.ndarray, colormap: list[tuple[int, int, int]]
) -> np.ndarray:
    """[N,H,W,3] RGB class colors → [N,H,W,1] class-id mask."""
    if imgs.ndim != 4 or imgs.shape[-1] != 3:
        raise ValueError("Input must be [N, H, W, 3]")
    seg = np.zeros(imgs.shape[:3] + (1,), dtype=imgs.dtype)
    for class_id, rgb in enumerate(colormap):
        match = np.all(imgs == np.asarray(rgb, dtype=imgs.dtype), axis=-1)
        seg[match] = class_id
    return seg
