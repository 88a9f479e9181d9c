"""GIF decoder in Python and numpy: what ``cv2.imread(path,
IMREAD_UNCHANGED)`` gives for a GIF, its first frame.

- The canvas is the logical screen, filled with the global colour table's
  background entry (black without a table); the first image is drawn on it
  with its local colour table, else the global one, LZW-decoded and, when
  interlaced, its four passes put back in row order.
- Pixels of the transparent index (a Graphic Control Extension's) are not
  drawn. cv2 gives 4 channels, BGRA with alpha 0 where nothing was drawn
  and 255 elsewhere, when any Graphic Control Extension of the file marks
  a transparent index, and BGR otherwise.

A file that ends before its first image, or whose LZW data is short or
corrupt, raises ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np


def _subblocks(data: bytes, pos: int) -> tuple[bytes, int]:
    """The concatenated data sub-blocks at ``pos``, and the offset after
    their terminator."""
    parts = []
    while True:
        if pos >= len(data):
            raise ValueError("truncated GIF data sub-blocks")
        n = data[pos]
        if n == 0:
            return b"".join(parts), pos + 1
        parts.append(data[pos + 1: pos + 1 + n])
        pos += 1 + n


def lzw_decode(data: bytes, min_size: int, count: int) -> np.ndarray:
    """GIF's variable-width LZW (codes LSB first, clear and end codes, up
    to 12 bits, deferred clear) → the first ``count`` indices."""
    if not 2 <= min_size <= 11:
        raise ValueError(f"bad GIF LZW code size {min_size}")
    clear, end = 1 << min_size, (1 << min_size) + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table, size, prev = list(base), min_size + 1, b""
    out = bytearray()
    acc = nbits = pos = 0
    while len(out) < count:
        while nbits < size:
            if pos >= len(data):
                raise ValueError("GIF LZW data ends early")
            acc |= data[pos] << nbits
            nbits += 8
            pos += 1
        code = acc & ((1 << size) - 1)
        acc >>= size
        nbits -= size
        if code == clear:
            table, size, prev = list(base), min_size + 1, b""
            continue
        if code == end:
            break
        if code < len(table):
            entry = table[code]
        elif code == len(table) and prev:
            entry = prev + prev[:1]
        else:
            raise ValueError(f"bad GIF LZW code {code}")
        out += entry
        if prev and len(table) < 4096:
            table.append(prev + entry[:1])
            if len(table) == 1 << size and size < 12:
                size += 1
        prev = entry
    if len(out) < count:
        raise ValueError("GIF LZW data ends early")
    return np.frombuffer(bytes(out[:count]), np.uint8)


def decode_gif(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """GIF bytes → uint8 BGR [H,W,3] or BGRA [H,W,4] (see the module note)."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError(f"{name}: not a GIF file")
    sw, sh, flags, bg = struct.unpack_from("<HHBB", data, 6)
    pos, palette = 13, None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        palette = np.frombuffer(data[pos: pos + n], np.uint8).reshape(-1, 3)
        pos += n
    frame, transparent_any, transparent = None, False, None
    try:
        while pos < len(data):
            kind = data[pos]
            if kind == 0x3B:  # trailer
                break
            if kind == 0x21:  # extension
                label = data[pos + 1]
                body, pos = _subblocks(data, pos + 2)
                if label == 0xF9 and len(body) >= 4 and body[0] & 1:
                    transparent_any = True
                    if frame is None:
                        transparent = body[3]
                continue
            if kind != 0x2C:
                raise ValueError(f"unknown GIF block 0x{kind:02x}")
            if frame is not None:  # a later frame: only its extensions matter
                fflags = data[pos + 9]
                pos += 10 + ((3 << ((fflags & 7) + 1)) if fflags & 0x80 else 0) + 1
                _, pos = _subblocks(data, pos)
                continue
            left, top, w, h, fflags = struct.unpack_from("<HHHHB", data, pos + 1)
            pos += 10
            table = palette
            if fflags & 0x80:
                n = 3 << ((fflags & 7) + 1)
                table = np.frombuffer(data[pos: pos + n], np.uint8).reshape(-1, 3)
                pos += n
            min_size = data[pos]
            lzw, pos = _subblocks(data, pos + 1)
            idx = lzw_decode(lzw, min_size, w * h).reshape(h, w)
            if fflags & 0x40:  # interlaced: rows 0::8, 4::8, 2::4, 1::2
                order = np.concatenate([np.arange(s, h, d) for s, d in
                                        ((0, 8), (4, 8), (2, 4), (1, 2))])
                rows = np.empty_like(idx)
                rows[order] = idx
                idx = rows
            if table is None:
                raise ValueError("GIF image without a colour table")
            frame = (left, top, idx, table, transparent)
            transparent = None
    except (IndexError, struct.error) as e:
        raise ValueError(f"{name}: truncated GIF ({e})") from None
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if frame is None:
        raise ValueError(f"{name}: GIF without an image")
    left, top, idx, table, transparent = frame
    lut = np.zeros((256, 3), np.uint8)
    lut[: len(table)] = table[:256]
    canvas = np.zeros((sh, sw, 4), np.uint8)
    if palette is not None and bg < len(palette):
        canvas[..., :3] = palette[bg]
    h, w = idx.shape
    region = canvas[top: top + h, left: left + w]
    idx = idx[: region.shape[0], : region.shape[1]]
    drawn = idx != transparent if transparent is not None else np.ones(idx.shape, bool)
    region[drawn, :3] = lut[idx[drawn]]
    region[drawn, 3] = 255
    canvas = canvas[..., [2, 1, 0, 3]]
    return np.ascontiguousarray(canvas if transparent_any else canvas[..., :3])

