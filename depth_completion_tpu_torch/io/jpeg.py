"""JPEG codec of the port.

``decode_jpeg``: what ``cv2.imread(path, IMREAD_UNCHANGED)`` gives (libjpeg-turbo with its defaults), sample for sample: BGR [H,W,3] or
grey [H,W]; baseline, extended and progressive Huffman frames, 8-bit, 1, 3
or 4 components (CMYK, with or without Adobe's marker, and YCCK: BGR
through OpenCV's CMYK conversion), any integral sampling, restart markers;
EXIF orientation is not applied. The decoder is host C++
(``csrc/jpeg_decode.cpp``, built with g++ at first use). Arithmetic coding,
lossless and hierarchical frames, 12-bit samples and other component
counts raise ``UnsupportedImage`` naming the SOF or the count; a file that
is not a JPEG, or is corrupt, raises ``ValueError``. A file cut short
decodes as libjpeg decodes a file that ends early (grey where the data ran
out), a progressive one with libjpeg's block smoothing of the coefficients
its missing scans would have refined.

``encode_jpeg`` / ``write_jpeg``: a baseline JFIF encoder in numpy, to
OpenCV's defaults: quality 95 (the Annex K tables scaled as libjpeg scales
them), 4:2:0 chroma, the standard Huffman tables of Annex K.3, one scan, no
restart markers.

Vectorised over the whole image: the 8x8 DCT is one matrix product over
all blocks, the zero runs, size categories and Huffman codes are arrays
over every coded symbol, and the bit string is packed with
``np.packbits``, then 0xFF bytes are stuffed with a zero. A 512x2039 grid
takes a fraction of a second where a per-block Python loop takes tens of
seconds.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from pathlib import Path

import numpy as np

from depth_completion_tpu_torch import _build


class UnsupportedImage(ValueError):
    """A well-formed image in a variant the port's decoders do not read
    (cv2 reads it): raised, never taken for a corrupt file."""


QUALITY = 95  # cv2.imwrite's default (IMWRITE_JPEG_QUALITY)
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
])
_Q_CHROMA = np.full(64, 99)
_Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25, 32]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66, 99]
# position in the 8x8 block (row-major) of each zigzag index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])
# Annex K.3 Huffman tables: (code counts per length 1..16, symbols). Each
# AC table lists its most frequent symbols first, then every other symbol
# (0xRS: a run R of zeros, then a magnitude of size S = 1..10) in order.
_AC_SYMBOLS = [r << 4 | s for r in range(16) for s in range(1, 11)] + [0x00, 0xF0]


def _ac_symbols(head: list[int]) -> bytes:
    return bytes(head + sorted(set(_AC_SYMBOLS) - set(head)))


_AC_LUMA_SYMBOLS = _ac_symbols([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1,
    0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16])
_AC_CHROMA_SYMBOLS = _ac_symbols([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09,
    0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25,
    0xF1])
HUFFMAN = {
    "dc_luma": ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
    "dc_chroma": ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12))),
    "ac_luma": ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), _AC_LUMA_SYMBOLS),
    "ac_chroma": ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), _AC_CHROMA_SYMBOLS),
}


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_quality_scaling`` + ``jpeg_add_quant_table``
    (baseline: 1..255), in row-major block order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _code_table(counts, symbols) -> tuple[np.ndarray, np.ndarray]:
    """Canonical Huffman codes: (code, length) arrays indexed by symbol."""
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


def _dct_matrix() -> np.ndarray:
    u, x = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    m = 0.5 * np.cos((2 * x + 1) * u * np.pi / 16)
    m[0] /= np.sqrt(2.0)
    return m


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[H, W] (multiples of 8) → [H/8, W/8, 8, 8] blocks."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _size_bits(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """JPEG magnitude category and its extra bits (one's complement for
    negative values)."""
    size = np.zeros(v.shape, np.int64)
    nz = v != 0
    size[nz] = np.floor(np.log2(np.abs(v[nz]))).astype(np.int64) + 1
    extra = np.where(v >= 0, v, v + (1 << size) - 1)
    return size, extra


def _scan(coefs: np.ndarray, comp: np.ndarray, tables) -> bytes:
    """Entropy-code quantised zigzag blocks ``coefs`` [B, 64] (in scan
    order; ``comp`` [B]: 0 luma, 1 Cb, 2 Cr) → stuffed scan bytes."""
    nb = coefs.shape[0]
    chroma = comp > 0
    # DC: the difference from the previous block of the same component
    dc = coefs[:, 0].copy()
    diff = np.empty_like(dc)
    for c in range(3):
        sel = np.flatnonzero(comp == c)
        diff[sel] = np.diff(dc[sel], prepend=0)
    dsize, dextra = _size_bits(diff)
    dtab = np.where(chroma, 1, 0)
    dcode = np.where(dtab, tables["dc_chroma"][0][dsize], tables["dc_luma"][0][dsize])
    dlen = np.where(dtab, tables["dc_chroma"][1][dsize], tables["dc_luma"][1][dsize])
    ev_key = [np.arange(nb) * 1024]
    ev_val = [(dcode << dsize) | dextra]
    ev_len = [dlen + dsize]

    # AC: each nonzero coefficient after a run of zeros (ZRL per 16 zeros)
    ac = coefs[:, 1:]
    blk, pos = np.nonzero(ac)
    pos = pos + 1
    prev = np.empty_like(pos)
    first = np.ones(blk.shape, bool)
    first[1:] = blk[1:] != blk[:-1]
    prev[first] = 0
    prev[~first] = pos[:-1][~first[1:]]
    run = pos - prev - 1
    v = coefs[blk, pos]
    size, extra = _size_bits(v)
    sym = ((run % 16) << 4) | size
    ac_chroma = chroma[blk]
    code = np.where(ac_chroma, tables["ac_chroma"][0][sym], tables["ac_luma"][0][sym])
    clen = np.where(ac_chroma, tables["ac_chroma"][1][sym], tables["ac_luma"][1][sym])
    ev_key.append(blk * 1024 + pos * 8 + 4)
    ev_val.append((code << size) | extra)
    ev_len.append(clen + size)
    nzrl = run // 16
    zi = np.repeat(np.arange(blk.size), nzrl)
    if zi.size:
        zk = np.arange(zi.size) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl)
        zc = chroma[blk[zi]]
        ev_key.append(blk[zi] * 1024 + pos[zi] * 8 + zk)
        ev_val.append(np.where(zc, tables["ac_chroma"][0][0xF0], tables["ac_luma"][0][0xF0]))
        ev_len.append(np.where(zc, tables["ac_chroma"][1][0xF0], tables["ac_luma"][1][0xF0]))
    # end of block where the last coefficient is zero
    eob = np.flatnonzero(coefs[:, 63] == 0)
    ec = chroma[eob]
    ev_key.append(eob * 1024 + 64 * 8)
    ev_val.append(np.where(ec, tables["ac_chroma"][0][0], tables["ac_luma"][0][0]))
    ev_len.append(np.where(ec, tables["ac_chroma"][1][0], tables["ac_luma"][1][0]))

    order = np.argsort(np.concatenate(ev_key), kind="stable")
    vals = np.concatenate(ev_val)[order].astype(np.int64)
    lens = np.concatenate(ev_len)[order].astype(np.int64)
    total = int(lens.sum())
    starts = np.cumsum(lens) - lens
    shift = np.repeat(lens, lens) - 1 - (np.arange(total) - np.repeat(starts, lens))
    bits = ((np.repeat(vals, lens) >> shift) & 1).astype(np.uint8)
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])  # pad with 1 bits
    data = np.packbits(bits)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def _marker(code: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, code, len(body) + 2) + body


def encode_jpeg(img: np.ndarray) -> bytes:
    """uint8 RGB [H,W,3] (or grey [H,W] / [H,W,1], coded as RGB) → JFIF bytes."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"cannot write a JPEG from a {img.dtype} array of shape {img.shape}")
    h, w = img.shape[:2]
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    x = np.pad(img.astype(np.float64), ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b - 128.0
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b
    # 4:2:0: each chroma sample the mean of a 2x2 block
    cb = cb.reshape(hp // 2, 2, wp // 2, 2).mean(axis=(1, 3))
    cr = cr.reshape(hp // 2, 2, wp // 2, 2).mean(axis=(1, 3))

    q_luma, q_chroma = quant_table(_Q_LUMA, QUALITY), quant_table(_Q_CHROMA, QUALITY)
    m = _dct_matrix()

    def quantise(plane, q):
        coef = m @ _blocks(plane) @ m.T
        out = np.round(coef / q.reshape(8, 8)).astype(np.int64)
        return out.reshape(*out.shape[:2], 64)[..., ZIGZAG]

    my, mx = hp // 16, wp // 16
    yq = quantise(y, q_luma).reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4)
    yq = yq.reshape(my, mx, 4, 64)
    cbq, crq = quantise(cb, q_chroma), quantise(cr, q_chroma)
    mcus = np.concatenate([yq, cbq[:, :, None], crq[:, :, None]], axis=2)  # [my, mx, 6, 64]
    coefs = mcus.reshape(-1, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)
    tables = {k: _code_table(*v) for k, v in HUFFMAN.items()}

    dqt = (bytes([0]) + bytes(q_luma[ZIGZAG].astype(np.uint8))
           + bytes([1]) + bytes(q_chroma[ZIGZAG].astype(np.uint8)))
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    dht = b"".join(bytes([tc_th]) + bytes(HUFFMAN[k][0]) + HUFFMAN[k][1] for tc_th, k in (
        (0x00, "dc_luma"), (0x10, "ac_luma"), (0x01, "dc_chroma"), (0x11, "ac_chroma")))
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return (b"\xff\xd8"
            + _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + _marker(0xDB, dqt) + _marker(0xC0, sof) + _marker(0xC4, dht)
            + _marker(0xDA, sos) + _scan(coefs, comp, tables) + b"\xff\xd9")


def write_jpeg(img: np.ndarray, path: Path) -> None:
    Path(path).write_bytes(encode_jpeg(img))


@functools.cache
def _decode_lib() -> ctypes.CDLL:
    """The decoder, built at first use; signatures declared once."""
    lib = _build.load("jpeg_decode")
    lib.jpeg_header.restype = ctypes.c_int
    lib.jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                ctypes.c_char_p, ctypes.c_size_t]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
                                ctypes.c_char_p, ctypes.c_size_t]
    return lib


def _raise(rc: int, err: ctypes.Array, name: str) -> None:
    msg = f"{name}: {err.value.decode(errors='replace')}"
    raise (UnsupportedImage if rc == 2 else ValueError)(msg)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes → uint8 BGR [H,W,3] or grey [H,W] (see the module note)."""
    lib = _decode_lib()
    err = ctypes.create_string_buffer(256)
    info = np.zeros(3, np.int32)
    rc = lib.jpeg_header(data, len(data), info.ctypes.data, err, len(err))
    if rc:
        _raise(rc, err, name)
    h, w, ch = (int(v) for v in info)
    out = np.empty((h, w, ch) if ch == 3 else (h, w), np.uint8)
    rc = lib.jpeg_decode(data, len(data), out.ctypes.data, out.size, err, len(err))
    if rc:
        _raise(rc, err, name)
    return out

