"""Write the image fixtures of the PyTorch port's decoders.

    python scripts/make_torch_io_fixtures.py [OUT_DIR]

Writes small files (64x48 or smaller) under ``tests/data/torch_io/`` (or
OUT_DIR), each beside its ``cv2.imread(path, IMREAD_UNCHANGED)`` decode as
``<name>.npy``: JPEG from cv2 and PIL (4:4:4, 4:2:2, 4:2:0 and 4:4:0,
grey, restart markers, a ragged 53x37 frame, progressive, optimised
tables, Adobe RGB), PNG at bit depths 1, 2 and 4 (grey and palette) and
Adam7-interlaced PNG (written here: neither cv2 nor PIL writes one), GIF
(global and local palettes, interlaced, transparent) and BMP (8-bit
palette, grey palette, 24 and 32 bits, bottom-up and top-down). This needs
cv2 and PIL; the port never imports either: its tests and ``chip_smoke.py``
hold its decoders to the recorded decodes.
"""

from __future__ import annotations

import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

OUT = Path(__file__).resolve().parent.parent / "tests" / "data" / "torch_io"
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))  # (row start, column start, row step, column step) per pass


def photo(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded RGB scene: gradients, a disc with hard edges, saturated
    bars (colour conversion clamps) and noise (AC energy everywhere)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([255 * xx / w, 128 + 100 * np.sin(yy / 5.0), 255 * (1 - yy / h)], axis=-1)
    disc = (yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (min(h, w) / 4) ** 2
    img[disc] = (250, 20, 40)
    img[:, -w // 6:] = (0, 255, 0)
    img[: h // 8] = (255, 255, 255)
    img += rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w*ch] samples → [h, stride] bytes at ``depth`` bits (MSB first)."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = np.unpackbits(samples.astype(np.uint8)[..., None], axis=-1)[..., 8 - depth:]
    return np.packbits(bits.reshape(samples.shape[0], -1), axis=1)


def _filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Row i filtered with type i % 5 (None, Sub, Up, Average, Paeth), the
    type byte in front."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for i, row in enumerate(rows.astype(np.int64)):
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        kind = i % 5
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(np.concatenate([[kind], (row - pred) % 256]))
        prev = row
    return np.asarray(out, np.uint8).reshape(len(rows), -1)


def write_png(path: Path, samples: np.ndarray, color: int, depth: int, interlace: bool = False,
              palette: np.ndarray | None = None, trns: bytes | None = None) -> None:
    """A PNG of ``samples`` [h, w] or [h, w, ch] in any colour type and bit
    depth, optionally Adam7-interlaced; row i of each image or pass is
    filtered with type i % 5."""
    h, w = samples.shape[:2]
    flat = samples.reshape(h, w, -1)
    bpp = max(1, flat.shape[2] * depth // 8)

    def scan(img):
        return _filter_rows(_pack_rows(img.reshape(img.shape[0], -1), depth), bpp).tobytes()

    if interlace:
        raw = b"".join(scan(flat[r0::dr, c0::dc]) for r0, c0, dr, dc in ADAM7
                       if r0 < h and c0 < w)
    else:
        raw = scan(flat)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                                            int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    path.write_bytes(out + _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND", b""))


def jpeg_cases(out: Path) -> list[Path]:
    img = photo(48, 64, 1)
    bgr = img[..., ::-1]
    paths = []

    def cv(name, arr, *params):
        p = out / f"{name}.jpg"
        if not cv2.imwrite(str(p), arr, list(params)):
            raise RuntimeError(f"cv2 could not write {p}")
        paths.append(p)

    def pil(name, arr, **kw):
        p = out / f"{name}.jpg"
        Image.fromarray(arr).save(p, "JPEG", **kw)
        paths.append(p)

    q = cv2.IMWRITE_JPEG_QUALITY
    sf = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    cv("jpeg_444", bgr, q, 90, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    cv("jpeg_422", bgr, q, 90, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)
    cv("jpeg_420", bgr, q, 90, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)
    cv("jpeg_440", bgr, q, 90, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)
    cv("jpeg_411", bgr, q, 90, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)
    cv("jpeg_grey", cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY), q, 85)
    cv("jpeg_restart", bgr, q, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, 3)
    cv("jpeg_low_quality", bgr, q, 20)
    cv("jpeg_progressive_cv2", bgr, q, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    ragged = photo(37, 53, 2)
    cv("jpeg_53x37_420", ragged[..., ::-1], q, 92)
    pil("jpeg_53x37_422", ragged, quality=88, subsampling=1)
    cv("jpeg_53x37_restart_1", ragged[..., ::-1], q, 75, cv2.IMWRITE_JPEG_RST_INTERVAL, 1)
    pil("jpeg_progressive", img, quality=90, progressive=True)
    pil("jpeg_progressive_444", ragged, quality=95, progressive=True, subsampling=0)
    pil("jpeg_progressive_grey", ragged[..., 1], quality=70, progressive=True)
    pil("jpeg_optimized", img, quality=85, optimize=True)
    pil("jpeg_adobe_rgb", img, quality=90, keep_rgb=True, subsampling=0)
    # a tiny frame: one MCU, chroma narrower than the triangle filter needs
    cv("jpeg_3x2", np.ascontiguousarray(bgr[:2, :3]), q, 95)
    return paths


def png_cases(out: Path) -> list[Path]:
    rng = np.random.default_rng(3)
    h, w = 37, 53
    img = photo(h, w, 4)
    paths = []

    def add(name, *args, **kw):
        p = out / f"{name}.png"
        write_png(p, *args, **kw)
        paths.append(p)

    for depth in (1, 2, 4):
        levels = rng.integers(0, 1 << depth, (h, w))
        add(f"png_grey{depth}", levels, 0, depth)
        add(f"png_grey{depth}_adam7", levels, 0, depth, interlace=True)
        pal = rng.integers(0, 256, (1 << depth, 3))
        add(f"png_palette{depth}", levels, 3, depth, palette=pal)
        add(f"png_palette{depth}_trns", levels, 3, depth, palette=pal, trns=bytes([0, 128]))
    grey_pal = np.repeat(np.arange(16)[:, None] * 17, 3, axis=1)
    add("png_palette4_grey_entries", rng.integers(0, 16, (h, w)), 3, 4, palette=grey_pal)
    add("png_palette4_adam7", rng.integers(0, 16, (h, w)), 3, 4, interlace=True,
        palette=rng.integers(0, 256, (16, 3)))
    add("png_rgb8_adam7", img, 2, 8, interlace=True)
    add("png_rgba8_adam7", np.concatenate([img, img[..., :1]], axis=-1), 6, 8, interlace=True)
    add("png_grey8_adam7", img[..., 0], 0, 8, interlace=True)
    add("png_grey16_adam7", rng.integers(0, 65536, (h, w)), 0, 16, interlace=True)
    add("png_rgb16_adam7", rng.integers(0, 65536, (h, w, 3)), 2, 16, interlace=True)
    add("png_greyalpha8_adam7", img[..., :2], 4, 8, interlace=True)
    add("png_rgb8_adam7_5x3", img[:3, :5], 2, 8, interlace=True)  # passes 2, 4 and 6 empty
    add("png_grey1_adam7_1x1", np.ones((1, 1), np.uint8), 0, 1, interlace=True)
    return paths


def gif_cases(out: Path) -> list[Path]:
    img = photo(48, 64, 5)
    small = photo(12, 10, 6)
    paths = []

    def pil(name, im, **kw):
        p = out / f"{name}.gif"
        im.save(p, "GIF", **kw)
        paths.append(p)

    pil("gif_interlaced", Image.fromarray(img).convert("P", palette=Image.ADAPTIVE, colors=200),
        interlace=True)
    pil("gif_not_interlaced", Image.fromarray(img).convert("P", palette=Image.ADAPTIVE, colors=7),
        interlace=False)
    pil("gif_small", Image.fromarray(small).convert("P", palette=Image.ADAPTIVE, colors=16))
    pil("gif_grey", Image.fromarray(img[..., 1]))
    pil("gif_transparent", Image.fromarray(img).convert("P", palette=Image.ADAPTIVE, colors=32),
        transparency=5)
    # a local colour table: a second frame's palette differs, so the first
    # frame keeps the global one and the file carries both kinds
    frames = [Image.fromarray(img).convert("P", palette=Image.ADAPTIVE, colors=64),
              Image.fromarray(img[::-1]).convert("P", palette=Image.ADAPTIVE, colors=64)]
    pil("gif_two_frames", frames[0], save_all=True, append_images=frames[1:])
    # the first frame under a local table only: written by hand from PIL's bytes
    p = out / "gif_local_table.gif"
    p.write_bytes(_local_table_gif(frames[0]))
    paths.append(p)
    # a 10x12 image at (3, 2) on a 16x14 screen whose background is entry 2
    p = out / "gif_offset_frame.gif"
    data = bytearray((out / "gif_small.gif").read_bytes())
    data[6:10] = struct.pack("<HH", 16, 14)
    data[11] = 2
    i = data.index(b"\x2c")
    data[i + 1: i + 5] = struct.pack("<HH", 3, 2)
    p.write_bytes(bytes(data))
    paths.append(p)
    return paths


def _local_table_gif(im: Image.Image) -> bytes:
    """The PIL GIF of ``im`` with its global colour table moved into the
    image descriptor as a local one (the screen's table flag cleared)."""
    import io

    buf = io.BytesIO()
    im.save(buf, "GIF", interlace=False)
    data = buf.getvalue()
    flags = data[10]
    if not flags & 0x80:
        raise RuntimeError("PIL wrote no global colour table")
    size = 3 << ((flags & 7) + 1)
    table = data[13: 13 + size]
    rest = data[13 + size:]
    i = rest.index(b"\x2c")  # the image descriptor
    desc = bytearray(rest[i: i + 10])
    desc[9] = (desc[9] & 0x40) | 0x80 | (flags & 7)
    header = data[:10] + bytes([flags & 0x70]) + data[11:13]
    return header + rest[:i] + bytes(desc) + table + rest[i + 10:]


def bmp_cases(out: Path) -> list[Path]:
    img = photo(48, 64, 7)
    ragged = photo(37, 53, 8)
    paths = []

    def add(name, write):
        p = out / f"{name}.bmp"
        write(p)
        paths.append(p)

    add("bmp_24", lambda p: cv2.imwrite(str(p), img[..., ::-1]))
    add("bmp_24_ragged", lambda p: Image.fromarray(ragged).save(p))
    add("bmp_32", lambda p: Image.fromarray(np.concatenate([ragged, ragged[..., :1]], -1),
                                            "RGBA").save(p))
    add("bmp_32_bitfields", lambda p: cv2.imwrite(
        str(p), np.concatenate([ragged[..., ::-1], ragged[..., :1]], -1)))
    add("bmp_8_palette", lambda p: Image.fromarray(ragged).convert(
        "P", palette=Image.ADAPTIVE, colors=100).save(p))
    add("bmp_8_grey", lambda p: cv2.imwrite(str(p), ragged[..., 1]))

    def top_down(p):  # a 24-bit file with a negative height: rows stored top first
        rows = ragged[..., ::-1]
        stride = (53 * 3 + 3) & ~3
        pix = np.zeros((37, stride), np.uint8)
        pix[:, : 53 * 3] = rows.reshape(37, -1)
        info = struct.pack("<IiiHHIIiiII", 40, 53, -37, 1, 24, 0, pix.size, 2835, 2835, 0, 0)
        p.write_bytes(b"BM" + struct.pack("<IHHI", 54 + pix.size, 0, 0, 54) + info + pix.tobytes())

    add("bmp_24_top_down", top_down)
    return paths


def main(out: Path = OUT) -> None:
    out.mkdir(parents=True, exist_ok=True)
    for old in out.glob("*"):
        old.unlink()
    paths = jpeg_cases(out) + png_cases(out) + gif_cases(out) + bmp_cases(out)
    for p in paths:
        dec = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
        if dec is None:
            raise RuntimeError(f"cv2 cannot decode {p}")
        np.save(p.with_suffix(".npy"), dec)
        print(f"{p.name}: {dec.shape} {dec.dtype}")


if __name__ == "__main__":
    main(Path(sys.argv[1]) if len(sys.argv) > 1 else OUT)
