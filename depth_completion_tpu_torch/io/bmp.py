"""BMP decoder in numpy: what ``cv2.imread(path, IMREAD_UNCHANGED)`` gives
for an uncompressed Windows or OS/2 bitmap.

- ``BI_RGB`` at 1, 4 and 8 bits with a colour table: BGR, or grey [H,W]
  when every one of the 2^bits table entries (those past the file's count
  read as black) has equal blue, green and red, as cv2 decides;
- ``BI_RGB`` at 24 bits: BGR; at 32 bits: BGR (the fourth byte dropped);
- ``BI_BITFIELDS`` at 32 bits: BGRA, the four bytes of each pixel as they
  are stored (cv2 reads them so; its own writer stores B, G, R, A masks);
- rows bottom-up, or top-down for a negative height; rows padded to 4
  bytes.

Other bit depths and compressions (RLE, ``BI_BITFIELDS`` below 32 bits,
embedded JPEG or PNG) raise ``UnsupportedImage``; a file that is not a BMP
or is truncated raises ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

from depth_completion_tpu_torch.io.jpeg import UnsupportedImage

BI_RGB, BI_BITFIELDS = 0, 3


def decode_bmp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """BMP bytes → uint8 BGR [H,W,3], BGRA [H,W,4] or grey [H,W]."""
    if data[:2] != b"BM" or len(data) < 26:
        raise ValueError(f"{name}: not a BMP file")
    (offset,) = struct.unpack_from("<I", data, 10)
    (hsize,) = struct.unpack_from("<I", data, 14)
    try:
        if hsize == 12:  # OS/2 BITMAPCOREHEADER: 3-byte colour table entries
            w, h, _, bpp = struct.unpack_from("<HHHH", data, 18)
            comp, clrused, entry = BI_RGB, 0, 3
        elif hsize >= 40:
            w, h, _, bpp, comp = struct.unpack_from("<iiHHI", data, 18)
            (clrused,) = struct.unpack_from("<I", data, 46)
            entry = 4
        else:
            raise ValueError(f"{name}: BMP header of {hsize} bytes")
    except struct.error:
        raise ValueError(f"{name}: truncated BMP header") from None
    top_down = h < 0
    h = abs(h)
    if w <= 0 or h == 0:
        raise ValueError(f"{name}: BMP of {w}x{h} pixels")
    if not ((comp == BI_RGB and bpp in (1, 4, 8, 24, 32)) or (comp == BI_BITFIELDS and bpp == 32)):
        raise UnsupportedImage(f"{name}: BMP compression {comp} at {bpp} bits is not supported "
                               "(uncompressed 1/4/8/24/32-bit and 32-bit bitfields are)")
    stride = (w * bpp + 31) // 32 * 4
    if offset + stride * h > len(data):
        raise ValueError(f"{name}: truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp == 24:
        return np.ascontiguousarray(rows[:, : 3 * w].reshape(h, w, 3))
    if bpp == 32:
        px = rows[:, : 4 * w].reshape(h, w, 4)
        return np.ascontiguousarray(px if comp == BI_BITFIELDS else px[..., :3])
    n = clrused if 0 < clrused <= 1 << bpp else 1 << bpp
    start = 14 + hsize
    table = np.zeros((1 << bpp, 3), np.uint8)
    raw = np.frombuffer(data[start: start + n * entry], np.uint8)
    if raw.size != n * entry:
        raise ValueError(f"{name}: truncated BMP colour table")
    table[:n] = raw.reshape(n, entry)[:, :3]
    if bpp == 8:
        idx = rows[:, :w]
    else:
        bits = np.unpackbits(rows, axis=1)[:, : w * bpp].reshape(h, w, bpp)
        idx = (bits * (1 << np.arange(bpp - 1, -1, -1)).astype(np.uint8)).sum(-1, dtype=np.uint8)
    grey = bool((table[:, 0] == table[:, 1]).all() and (table[:, 1] == table[:, 2]).all())
    out = table[idx]
    return np.ascontiguousarray(out[..., 0] if grey else out)

