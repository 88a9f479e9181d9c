"""PNG decoder and encoder in numpy and ``zlib`` (the part of OpenCV's PNG
codec the port's IO needs).

``read_png`` gives what ``cv2.imread(path, IMREAD_UNCHANGED)`` gives, in
the file's channel order (RGB, not cv2's BGR):

- colour types 0 (grey → [H,W]), 2 (RGB), 3 (palette → RGB, RGBA with a
  ``tRNS`` chunk), 4 (grey+alpha → [G,G,G,A]) and 6 (RGBA); an RGB image
  with a ``tRNS`` key colour gains an alpha channel (0 at the key), a grey
  one ignores it, as cv2 does;
- bit depths 1, 2, 4 (grey, scaled to 0-255 as libpng's
  ``png_set_expand_gray_1_2_4_to_8`` scales them, and palette), 8 and 16
  (uint8 / uint16; 16-bit grey is KITTI-DC's ground truth), any number of
  ``IDAT`` chunks, all five filter types (the serial per-row loop is host
  C++, ``csrc/png_unfilter.cpp``), Adam7 interlacing (each pass unfiltered
  on its own, then scattered into the frame), every chunk's CRC checked.

``write_png`` writes 8-bit grey, RGB and RGBA and 16-bit grey, rows
filtered "Up", deflated by ``zlib``.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

from depth_completion_tpu_torch import _build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (row start, column start, row step, column step) of each pass
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))


def _unfilter_lib() -> ctypes.CDLL:
    lib = _build.load("png_unfilter")
    lib.png_unfilter.restype = ctypes.c_long
    lib.png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
                                 ctypes.c_size_t, ctypes.c_void_p]
    return lib


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes → uint8/uint16 [H,W] or [H,W,C] (see the module note)."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, idat, palette, trns, ihdr = 8, [], None, None, None
    while pos + 12 <= len(data):
        length, ctype = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8: pos + 8 + length]
        crc = data[pos + 8 + length: pos + 12 + length]
        if len(body) != length or len(crc) != 4 \
                or zlib.crc32(ctype + body) != int.from_bytes(crc, "big"):
            raise ValueError(f"{name}: corrupt PNG chunk {ctype!r}")
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{name}: PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = ihdr
    if color not in _CHANNELS or depth not in _DEPTHS[color] or interlace > 1:
        raise ValueError(f"{name}: invalid PNG header (bit depth {depth}, colour type {color}, "
                         f"interlace {interlace})")
    ch = _CHANNELS[color]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt PNG image data ({e})") from None
    if not interlace:
        img, _ = _unfilter(raw, 0, h, w, ch, depth, name)
    else:
        img = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for r0, c0, dr, dc in ADAM7:
            ph, pw = -(-(h - r0) // dr), -(-(w - c0) // dc)
            if ph > 0 and pw > 0:
                img[r0::dr, c0::dc], pos = _unfilter(raw, pos, ph, pw, ch, depth, name)
    if depth < 8 and color == 0:
        img = img * np.uint8(255 // ((1 << depth) - 1))
    if color == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        # libpng's 256-entry tables: black, opaque past the file's entries
        lut = np.zeros((256, 3), np.uint8)
        lut[: len(palette)] = palette[:256]
        if trns is not None:
            alpha = np.full((256, 1), 255, np.uint8)
            alpha[: min(len(trns), len(palette)), 0] = np.frombuffer(trns, np.uint8)[: len(palette)]
            lut = np.concatenate([lut, alpha], axis=1)
        return lut[img[..., 0]]
    if color == 0:
        return img[..., 0]
    if color == 4:
        return img[..., [0, 0, 0, 1]]
    if color == 2 and trns is not None and len(trns) >= 6:
        key = np.asarray(struct.unpack(">HHH", trns[:6]), img.dtype)
        alpha = np.where((img == key).all(axis=-1), 0, np.iinfo(img.dtype).max)
        return np.concatenate([img, alpha[..., None].astype(img.dtype)], axis=-1)
    return img


def _unfilter(raw: bytes, pos: int, h: int, w: int, ch: int, depth: int,
              name: str) -> tuple[np.ndarray, int]:
    """The [h, w, ch] samples of one filtered image (or Adam7 pass) that
    starts at ``raw[pos]``, and the offset after it."""
    bpp = max(1, ch * depth // 8)
    stride = -(-w * ch * depth // 8)
    end = pos + h * (stride + 1)
    if len(raw) < end:
        raise ValueError(f"{name}: truncated PNG image data")
    out = np.empty(h * stride, np.uint8)
    rc = _unfilter_lib().png_unfilter(raw[pos:end], h, stride, bpp, out.ctypes.data)
    if rc != 0:
        raise ValueError(f"{name}: bad PNG filter type in row {-1 - rc}")
    if depth == 16:
        return out.view(">u2").astype(np.uint16).reshape(h, w, ch), end
    if depth == 8:
        return out.reshape(h, w, ch), end
    bits = np.unpackbits(out.reshape(h, stride), axis=1)[:, : w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=-1, dtype=np.uint8)[..., None], end


def read_png(path: Path) -> np.ndarray:
    return decode_png(Path(path).read_bytes(), str(path))


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H,W], [H,W,1], [H,W,3], [H,W,4] or uint16 [H,W] / [H,W,1]
    (channels in RGB(A) order) → PNG bytes."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    ch = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 3: 2, 4: 6}.get(ch)
    if img.ndim not in (2, 3) or color is None or img.dtype not in (np.uint8, np.uint16) \
            or (img.dtype == np.uint16 and ch != 1):
        raise ValueError(f"cannot write a PNG from a {img.dtype} array of shape {img.shape}")
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8)
    rows = rows.reshape(h, -1)
    up = rows.copy()
    up[1:] -= rows[:-1]  # filter "Up": each byte minus the byte above, mod 256
    scan = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(scan.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(img: np.ndarray, path: Path) -> None:
    Path(path).write_bytes(encode_png(img))
