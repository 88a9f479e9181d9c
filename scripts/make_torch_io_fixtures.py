"""Write the image fixtures of the PyTorch port's decoders.

    python scripts/make_torch_io_fixtures.py [OUT_DIR]

Writes small files (64x48 or smaller) under ``tests/data/torch_io/`` (or
OUT_DIR), each beside its ``cv2.imread(path, IMREAD_UNCHANGED)`` decode as
``<name>.npy``: JPEG from cv2 and PIL (4:4:4, 4:2:2, 4:2:0 and 4:4:0,
grey, restart markers, a ragged 53x37 frame, progressive, optimised
tables, Adobe RGB, CMYK with and without Adobe's marker, YCCK, and
progressive files cut after a few of their scans), PNG at bit depths 1, 2
and 4 (grey and palette) and Adam7-interlaced PNG (written here: neither
cv2 nor PIL writes one), GIF (global and local palettes, interlaced,
transparent) and BMP (8-bit palette, grey palette, 24 and 32 bits,
bottom-up and top-down; RLE8, RLE4 and 16-bit written here). This needs
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
        (arr if isinstance(arr, Image.Image) else Image.fromarray(arr)).save(p, "JPEG", **kw)
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

    # four components: PIL writes Adobe CMYK (stored inverted); the same
    # file without its APP14 marker (plain CMYK), with the marker's
    # transform set to 2 (YCCK: nothing here writes one, so its first three
    # components are read as YCbCr), and progressive
    cmyk = np.concatenate([255 - ragged, ragged.min(-1, keepdims=True)], -1)
    pil("jpeg_cmyk_adobe", Image.fromarray(cmyk, "CMYK"), quality=90)
    adobe = (out / "jpeg_cmyk_adobe.jpg").read_bytes()
    i = adobe.index(b"\xff\xee")
    end = i + 2 + int.from_bytes(adobe[i + 2: i + 4], "big")
    raw(out, "jpeg_cmyk_no_adobe", adobe[:i] + adobe[end:], paths)
    ycck = bytearray(adobe)
    ycck[i + 15] = 2  # the transform byte of "Adobe" APP14
    raw(out, "jpeg_ycck", bytes(ycck), paths)
    pil("jpeg_cmyk_progressive", Image.fromarray(cmyk, "CMYK"), quality=85, progressive=True)

    # progressive files cut after their 1st, 2nd and a middle scan, EOI
    # appended: libjpeg block-smooths what the missing scans would refine
    for name, src in (("jpeg_progressive", "colour"), ("jpeg_progressive_grey", "grey")):
        data = (out / f"{name}.jpg").read_bytes()
        sos = [k for k in range(len(data) - 1) if data[k: k + 2] == b"\xff\xda"]
        for scans in (1, 2, len(sos) // 2):
            raw(out, f"jpeg_progressive_{src}_{scans}_scans", data[: sos[scans]] + b"\xff\xd9",
                paths)
    return paths


def raw(out: Path, name: str, data: bytes, paths: list[Path]) -> None:
    """Write ``data`` as ``<name>.jpg`` and list it."""
    p = out / f"{name}.jpg"
    p.write_bytes(data)
    paths.append(p)


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

    # RLE8 and RLE4 (neither cv2 nor PIL writes them): encoded and
    # absolute runs, then the same with delta escapes, early ends of line
    # and an early end of bitmap, whose skipped pixels cv2 fills with
    # colour table entry 0
    rng = np.random.default_rng(9)
    idx = rle_scene(37, 53, rng)
    pal = rng.integers(0, 256, (256, 3))
    grey = np.repeat(np.arange(256)[:, None], 3, axis=1)
    add("bmp_rle8", lambda p: write_rle_bmp(p, idx, pal, 8))
    add("bmp_rle8_grey", lambda p: write_rle_bmp(p, idx, grey, 8))
    add("bmp_rle8_skips", lambda p: write_rle_bmp(p, idx, pal, 8, skips=True))
    add("bmp_rle4", lambda p: write_rle_bmp(p, idx % 16, pal[:16], 4))
    add("bmp_rle4_skips", lambda p: write_rle_bmp(p, idx % 16, pal[:16], 4, skips=True))
    # 16 bits: 5-5-5 as BI_RGB and as bitfields, 5-6-5 as bitfields
    words = rng.integers(0, 1 << 16, (37, 53))
    add("bmp_16_555", lambda p: write_bmp16(p, words & 0x7FFF, None))
    add("bmp_16_555_bitfields", lambda p: write_bmp16(p, words & 0x7FFF, (0x7C00, 0x3E0, 0x1F)))
    add("bmp_16_565_bitfields", lambda p: write_bmp16(p, words, (0xF800, 0x7E0, 0x1F)))
    return paths


def rle_scene(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """Palette indices [h, w]: flat bands (encoded runs, some ending on a
    row's last pixel, some 255 long over several rows' worth), alternating
    pairs (RLE4's two-colour runs) and noise (absolute runs of odd and even
    lengths)."""
    idx = np.repeat(rng.integers(0, 256, (h, 1)), w, axis=1)
    idx[:, w // 3: w // 2] = rng.integers(0, 256, (h, w // 2 - w // 3))
    idx[::3, 5:11] = np.resize([7, 200], 6)
    idx[1::4, -7:] = 3
    idx[h // 2, :] = rng.integers(0, 256, w)
    return idx.astype(np.uint8)


def rle_row(row: np.ndarray, bpp: int) -> bytes:
    """One row as RLE8 or RLE4 codes: runs of 3 or more (RLE4: of one
    two-colour pattern) encoded, what lies between them absolute (at least
    3 pixels, padded to 16 bits), shorter leftovers as short runs."""
    out = bytearray()
    n, i = len(row), 0

    def run_at(j: int) -> int:
        k = j + 1
        while k < n and k - j < 255 and (row[k] == row[k - 2] if bpp == 4 and k - j >= 2
                                           else row[k] == row[j] if bpp == 8 else True):
            k += 1
        return k - j

    lit: list[int] = []

    def flush() -> None:
        j = 0
        while len(lit) - j >= 3:
            chunk = lit[j: j + 255]
            if bpp == 8:
                body = bytes(chunk) + bytes(len(chunk) % 2)
            else:
                nib = chunk + [0] * (len(chunk) % 2)
                body = bytes((a << 4) | b for a, b in zip(nib[::2], nib[1::2]))
                body += bytes(len(body) % 2)
            out.extend([0, len(chunk)])
            out.extend(body)
            j += len(chunk)
        for v in lit[j:]:  # 1 or 2 left: one-pixel runs
            out.extend([1, v if bpp == 8 else v << 4])
        lit.clear()

    while i < n:
        r = run_at(i)
        if r >= 3:
            flush()
            code = row[i] if bpp == 8 else (row[i] << 4) | (row[i + 1] if r > 1 else 0)
            out.extend([r, int(code)])
            i += r
        else:
            lit.append(int(row[i]))
            i += 1
    flush()
    return bytes(out)


def write_rle_bmp(path: Path, idx: np.ndarray, palette: np.ndarray, bpp: int,
                  skips: bool = False) -> None:
    """An RLE8 or RLE4 BMP of ``idx`` (rows stored bottom-up), each row
    ended by an end of line and the bitmap by an end of bitmap. With
    ``skips``: row 2 ends early, a delta of (3, 2) leaves row 4 (RLE8
    lands in row 6; cv2's RLE4 ignores dy and stays in row 4), row 9 starts
    with a delta of (5, 0), and the bitmap ends early: four rows early in
    RLE8, a third into the last row in RLE4 (whose end of bitmap cv2 reads
    as an end of line, so an earlier one would leave rows unread)."""
    h, w = idx.shape
    rows = idx[::-1]
    body = bytearray()
    y = 0
    while y < h:
        if skips and y == h - (4 if bpp == 8 else 1):
            if bpp == 4:
                body += rle_row(rows[y][: w // 3], bpp)
            break
        if skips and y == 2:
            body += rle_row(rows[y][: w // 2], bpp) + b"\x00\x00"
        elif skips and y == 4:  # left part, then a delta down 2 rows and 3 right
            body += rle_row(rows[y][:10], bpp) + bytes([0, 2, 3, 2])
            body += rle_row(rows[y + 2][13:], bpp) + b"\x00\x00"
            y += 3 if bpp == 8 else 1
            continue
        elif skips and y == 9:
            body += bytes([0, 2, 5, 0]) + rle_row(rows[y][5:], bpp) + b"\x00\x00"
        else:
            body += rle_row(rows[y], bpp) + b"\x00\x00"
        y += 1
    body += b"\x00\x01"
    table = np.concatenate([palette[:, ::-1], np.zeros((len(palette), 1))], 1).astype(np.uint8)
    offset = 54 + table.size
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, 1 if bpp == 8 else 2, len(body), 2835,
                       2835, len(palette), 0)
    path.write_bytes(b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + info
                     + table.tobytes() + bytes(body))


def write_bmp16(path: Path, words: np.ndarray, masks: tuple[int, int, int] | None) -> None:
    """A 16-bit BMP of ``words`` [h, w] (bottom-up): BI_RGB (5-5-5) when
    ``masks`` is None, else BI_BITFIELDS with the red, green, blue masks
    after the header."""
    h, w = words.shape
    stride = (2 * w + 3) & ~3
    pix = np.zeros((h, stride), np.uint8)
    pix[:, : 2 * w] = words[::-1].astype("<u2").view(np.uint8).reshape(h, -1)
    extra = b"" if masks is None else struct.pack("<III", *masks)
    offset = 54 + len(extra)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 16, 0 if masks is None else 3, pix.size,
                       2835, 2835, 0, 0)
    path.write_bytes(b"BM" + struct.pack("<IHHI", offset + pix.size, 0, 0, offset) + info
                     + extra + pix.tobytes())


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
