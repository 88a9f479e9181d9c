"""Host-side image IO, PyTorch-port counterpart of
``depth_completion_tpu.io.image`` (which decodes with OpenCV; the port's
machines have no ``cv2``, so it decodes with its own ``io/png.py``,
``io/jpeg.py``, ``io/gif.py`` and ``io/bmp.py``), keeping cv2's contract:

- ``load_img_array``: the file decoded as ``cv2.imread(IMREAD_UNCHANGED)``
  would decode it, chosen by its signature (PNG, JPEG, GIF or BMP), then
  the JAX package's conversions: RGB out for ``mode="RGB"`` (grey
  replicated, alpha dropped), ``mode="L"`` from colour by OpenCV 5's
  fixed-point BGR2GRAY (9798/19235/3735, ``>> 15`` with rounding),
  ``mode=None`` keeps cv2's channel order (BGR for 3 or 4 channels); an
  all-zero image, a file that is not an image or a corrupt one gives
  ``None``. A well-formed variant that cv2 reads and the port does not
  (arithmetic-coded, lossless, hierarchical or 12-bit JPEG, BMP holding a
  JPEG or PNG)
  raises ``UnsupportedImage``.
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

from depth_completion_tpu_torch.io.bmp import decode_bmp
from depth_completion_tpu_torch.io.gif import decode_gif
from depth_completion_tpu_torch.io.jpeg import UnsupportedImage, decode_jpeg, write_jpeg
from depth_completion_tpu_torch.io.png import SIGNATURE, decode_png, write_png

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
    """cv2's ``COLOR_BGR2GRAY`` for 8 and 16 bits (OpenCV 5: fixed point,
    15 fractional bits, rounded)."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(img.dtype)


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Image bytes → what ``cv2.imread(IMREAD_UNCHANGED)`` gives for a file
    holding them: grey
    [H,W] or BGR(A) [H,W,C], uint8 (uint16 for a 16-bit PNG). Raises
    ``ValueError`` for a corrupt or unknown file, ``UnsupportedImage`` for
    a variant the port does not read."""
    if data[:8] == SIGNATURE:
        img = decode_png(data, name)
        return img[..., [2, 1, 0, 3][: img.shape[2]]] if img.ndim == 3 else img
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data, name)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return decode_gif(data, name)
    if data[:2] == b"BM":
        return decode_bmp(data, name)
    raise ValueError(f"{name}: not a PNG, JPEG, GIF or BMP file")


def load_img_array(path: Path, mode: str | None = None) -> np.ndarray | None:
    """Decode an image to [H,W,C] numpy; None on failure or all-zero image."""
    path = Path(path)
    if not is_img_file(path):
        return None
    try:
        img = decode_image(path.read_bytes(), str(path))
    except UnsupportedImage:
        raise
    except ValueError:
        return None  # cv2.imread's None for a file it cannot decode
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
