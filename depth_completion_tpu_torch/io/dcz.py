"""dcz: compressed-array codec (ctypes binding to ``csrc/dcz_codec.cpp``),
PyTorch-port counterpart of ``depth_completion_tpu.io.dcz``: the same
container, byte for byte, so each side reads the other's files.

Byte-plane shuffle + LZ4 in host C++ (no external libraries), over a C ABI
through ctypes. Container format (little-endian):
    magic   4s   b"DCZ1"
    dtype   16s  numpy dtype string, NUL-padded (e.g. "<f4")
    ndim    u32
    shape   ndim × u64
    rawlen  u64  uncompressed payload bytes
    clen    u64  compressed payload bytes
    crc32   u32  CRC of the uncompressed payload
    payload clen bytes (LZ4 of byte-shuffled data)

The library is built with g++ at first use into ``_build/`` (``_build.load``,
keyed by the source's hash); with no g++ it raises.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

from depth_completion_tpu_torch import _build

_MAGIC = b"DCZ1"


def _get_lib() -> ctypes.CDLL:
    lib = _build.load("dcz_codec")
    lib.dcz_compress_bound.restype = ctypes.c_size_t
    lib.dcz_compress_bound.argtypes = [ctypes.c_size_t]
    lib.dcz_compress.restype = ctypes.c_long
    lib.dcz_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.dcz_decompress.restype = ctypes.c_long
    lib.dcz_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
    ]
    return lib


def save_dcz(x: np.ndarray, path: Path) -> None:
    lib = _get_lib()
    x = np.asarray(x, order="C")  # (ascontiguousarray would promote 0-d to 1-d)
    raw = x.tobytes()
    esize = x.dtype.itemsize
    bound = lib.dcz_compress_bound(len(raw))
    out = ctypes.create_string_buffer(bound)
    clen = lib.dcz_compress(raw, len(raw), esize, out, bound)
    if clen < 0:
        raise RuntimeError("dcz compression failed")
    dtype_str = x.dtype.str.encode()[:16].ljust(16, b"\x00")
    header = _MAGIC + dtype_str + struct.pack("<I", x.ndim)
    header += struct.pack(f"<{x.ndim}Q", *x.shape)
    header += struct.pack("<QQI", len(raw), clen, zlib.crc32(raw))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header)
        f.write(out.raw[:clen])


def load_dcz(path: Path) -> np.ndarray:
    lib = _get_lib()
    data = Path(path).read_bytes()
    if data[:4] != _MAGIC:
        raise ValueError(f"Not a DCZ file: {path}")
    dtype = np.dtype(data[4:20].rstrip(b"\x00").decode())
    (ndim,) = struct.unpack_from("<I", data, 20)
    off = 24
    shape = struct.unpack_from(f"<{ndim}Q", data, off)
    off += 8 * ndim
    rawlen, clen, crc = struct.unpack_from("<QQI", data, off)
    off += 20
    payload = data[off : off + clen]
    out = ctypes.create_string_buffer(rawlen)
    got = lib.dcz_decompress(payload, clen, out, rawlen, dtype.itemsize)
    if got != rawlen:
        raise ValueError(f"DCZ payload corrupt in {path} ({got} != {rawlen})")
    raw = out.raw[:rawlen]
    if zlib.crc32(raw) != crc:
        raise ValueError(f"DCZ checksum mismatch in {path}")
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
