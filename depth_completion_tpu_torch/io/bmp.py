"""BMP decoder in numpy: what ``cv2.imread(path, IMREAD_UNCHANGED)`` gives
for a Windows or OS/2 bitmap.

- ``BI_RGB`` at 1, 4 and 8 bits with a colour table: BGR, or grey [H,W]
  when every one of the 2^bits table entries (those past the file's count
  read as black) has equal blue, green and red, as cv2 decides;
- ``BI_RLE8`` at 8 bits and ``BI_RLE4`` at 4 bits, through that table, as
  OpenCV's decoder walks them: encoded runs (RLE8's wrap to the next row
  where they end on its last pixel, RLE4's need an end of line), absolute
  runs padded to 16 bits, end of line, end of bitmap, and delta escapes:
  in RLE8 a delta moves the cursor dx + dy rows along the rows and the end
  of bitmap ends the image; in RLE4 a delta moves it dx along its row (the
  dy byte is read, not used) and the end of bitmap ends the row only;
  every pixel an escape passes over takes table entry 0; a run past its
  row's end, or data that ends before the last row is done, is refused as
  cv2 refuses it;
- ``BI_RGB`` at 16 bits (5-5-5) and ``BI_BITFIELDS`` at 16 bits with the
  5-6-5 or the 5-5-5 masks: BGR, each field shifted to the top of its byte
  (no bit replication), as OpenCV converts them; other masks are refused;
- ``BI_RGB`` at 24 bits: BGR; at 32 bits: BGR (the fourth byte dropped);
- ``BI_BITFIELDS`` at 32 bits: BGRA, the four bytes of each pixel as they
  are stored (cv2 reads them so; its own writer stores B, G, R, A masks);
- rows bottom-up, or top-down for a negative height; rows padded to 4
  bytes.

Embedded JPEG or PNG and other bit depths raise ``UnsupportedImage``; a
file that is not a BMP, is truncated, or that cv2 refuses raises
``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

from depth_completion_tpu_torch.io.jpeg import UnsupportedImage

BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3
_MASKS_565, _MASKS_555 = (0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)


def _rle_indices(data: bytes, pos: int, w: int, h: int, bpp: int, name: str) -> np.ndarray:
    """The palette indices [h, w] of an RLE8 or RLE4 stream, rows in the
    order they are stored (OpenCV's ``BmpDecoder::readData`` walk)."""
    out = np.zeros((h, w), np.uint8)
    y = x = 0
    wrapped = False  # RLE8: the last encoded or absolute run moved to a new row

    def fill(count: int, idx: int) -> None:  # FillUniColor: across rows
        nonlocal x, y
        while True:
            end = min(x + count, w)
            count -= end - x
            out[y, x:end] = idx
            x = end
            if x >= w:
                x, y = 0, y + 1
                if y >= h:
                    return
            if count <= 0:
                return

    def take(n: int) -> bytes:
        nonlocal pos
        if pos + n > len(data):
            raise ValueError(f"{name}: truncated RLE BMP data")
        pos += n
        return data[pos - n: pos]

    while True:
        count, code = take(2)
        if count:  # encoded run
            if x + count > w:
                raise ValueError(f"{name}: RLE run past the end of a row")
            if bpp == 8:
                row = y
                fill(count, code)
                wrapped = y != row
                if y >= h:
                    break
            else:
                out[y, x:x + count] = np.resize([code >> 4, code & 15], count)
                x += count
        elif code > 2:  # absolute run
            if x + code > w:
                raise ValueError(f"{name}: RLE run past the end of a row")
            if bpp == 8:
                out[y, x:x + code] = np.frombuffer(take((code + 1) & ~1), np.uint8)[:code]
                wrapped = False
            else:
                packed = np.frombuffer(take(((code + 1) // 2 + 1) & ~1), np.uint8)
                out[y, x:x + code] = np.stack([packed >> 4, packed & 15], -1).reshape(-1)[:code]
            x += code
        elif bpp == 4:  # RLE4's escapes: the end of bitmap ends the row only, a
            skip = w - x  # delta moves dx along it (its dy byte is read, not used)
            if code == 2:
                skip = take(2)[0]
            fill(skip, 0)
            if y >= h:
                break
        else:  # 0: end of line, 1: end of bitmap, 2: delta
            if code == 0 and wrapped and x == 0:
                wrapped = False  # the run already moved to this row
                continue
            skip = w - x
            if code == 2:
                dx, dy = take(2)
                skip = dx + dy * w
            elif code == 1:
                skip += (h - y) * w
            fill(skip, 0)
            wrapped = False
            if y >= h:
                break
    return out


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
    rle = (comp, bpp) in ((BI_RLE8, 8), (BI_RLE4, 4))
    if not ((comp == BI_RGB and bpp in (1, 4, 8, 16, 24, 32)) or rle
            or (comp == BI_BITFIELDS and bpp in (16, 32))):
        if comp in (BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS):
            raise ValueError(f"{name}: BMP compression {comp} at {bpp} bits")
        raise UnsupportedImage(f"{name}: BMP compression {comp} at {bpp} bits is not supported "
                               "(uncompressed, RLE8, RLE4 and bitfields are)")
    if bpp == 16:
        masks = _MASKS_555
        if comp == BI_BITFIELDS:
            try:
                masks = struct.unpack_from("<III", data, 54)
            except struct.error:
                raise ValueError(f"{name}: truncated BMP header") from None
            if masks not in (_MASKS_565, _MASKS_555):
                raise ValueError(f"{name}: 16-bit BMP masks {[hex(m) for m in masks]}")
    stride = (w * bpp + 31) // 32 * 4
    if not rle:
        if offset + stride * h > len(data):
            raise ValueError(f"{name}: truncated BMP pixel data")
        rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
        if not top_down:
            rows = rows[::-1]
    if bpp == 16:
        t = rows[:, : 2 * w].copy().view("<u2").astype(np.int32)
        if masks == _MASKS_565:
            g, r = (t >> 3) & 0xFC, (t >> 8) & 0xF8
        else:
            g, r = (t >> 2) & 0xF8, (t >> 7) & 0xF8
        return np.stack([(t << 3) & 0xF8, g, r], -1).astype(np.uint8)
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
    if rle:
        idx = _rle_indices(data, offset, w, h, bpp, name)
        if not top_down:
            idx = idx[::-1]
    elif bpp == 8:
        idx = rows[:, :w]
    else:
        bits = np.unpackbits(rows, axis=1)[:, : w * bpp].reshape(h, w, bpp)
        idx = (bits * (1 << np.arange(bpp - 1, -1, -1)).astype(np.uint8)).sum(-1, dtype=np.uint8)
    grey = bool((table[:, 0] == table[:, 1]).all() and (table[:, 1] == table[:, 2]).all())
    out = table[idx]
    return np.ascontiguousarray(out[..., 0] if grey else out)

