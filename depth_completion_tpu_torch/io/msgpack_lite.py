"""Minimal msgpack encoder/decoder (the subset blosc2 frames use): the
port's own copy of ``depth_completion_tpu.io.msgpack_lite``, byte for byte
the same encoding.

The blosc2 contiguous-frame container (``io/bl2.py``) encodes its header,
metalayer index and vlmeta payloads with msgpack. Only the subset of the
msgpack spec that appears in those structures is implemented: nil/bool,
all int widths, float32/64, str, bin, array, map and fixext16. It imports
only ``struct``.

Spec: https://github.com/msgpack/msgpack/blob/master/spec.md (public,
stable since 2013).
"""

from __future__ import annotations

import struct
from typing import Any

__all__ = ["packb", "unpackb", "unpack_from"]


def packb(obj: Any) -> bytes:
    """Serialize ``obj`` to msgpack bytes (tuples encode as arrays)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 0x100:
            out += bytes([0xD9, n])
        elif n < 0x10000:
            out.append(0xDA)
            out += struct.pack(">H", n)
        else:
            out.append(0xDB)
            out += struct.pack(">I", n)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        n = len(data)
        if n < 0x100:
            out += bytes([0xC4, n])
        elif n < 0x10000:
            out.append(0xC5)
            out += struct.pack(">H", n)
        else:
            out.append(0xC6)
            out += struct.pack(">I", n)
        out += data
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        elif n < 0x10000:
            out.append(0xDC)
            out += struct.pack(">H", n)
        else:
            out.append(0xDD)
            out += struct.pack(">I", n)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 0x10000:
            out.append(0xDE)
            out += struct.pack(">H", n)
        else:
            out.append(0xDF)
            out += struct.pack(">I", n)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack_lite cannot pack type {type(obj)!r}")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif 0 <= v < 0x100:
        out += bytes([0xCC, v])
    elif 0 <= v < 0x10000:
        out.append(0xCD)
        out += struct.pack(">H", v)
    elif 0 <= v < 0x100000000:
        out.append(0xCE)
        out += struct.pack(">I", v)
    elif v >= 0:
        out.append(0xCF)
        out += struct.pack(">Q", v)
    elif v >= -0x80:
        out.append(0xD0)
        out += struct.pack(">b", v)
    elif v >= -0x8000:
        out.append(0xD1)
        out += struct.pack(">h", v)
    elif v >= -0x80000000:
        out.append(0xD2)
        out += struct.pack(">i", v)
    else:
        out.append(0xD3)
        out += struct.pack(">q", v)


def unpack_from(buf: bytes, offset: int = 0) -> tuple[Any, int]:
    """Decode one msgpack object at ``offset``; returns (object, end_offset).

    fixext16 (0xD8, used for the frame fingerprint and filter pipeline)
    decodes to a ``(type_code, bytes)`` tuple.
    """
    b = buf[offset]
    o = offset + 1
    if b < 0x80:
        return b, o
    if b >= 0xE0:
        return b - 0x100, o
    if 0x80 <= b <= 0x8F:
        return _unpack_map(buf, o, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _unpack_array(buf, o, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return buf[o : o + n].decode("utf-8", errors="replace"), o + n
    if b == 0xC0:
        return None, o
    if b == 0xC2:
        return False, o
    if b == 0xC3:
        return True, o
    if b == 0xC4:
        n = buf[o]
        return bytes(buf[o + 1 : o + 1 + n]), o + 1 + n
    if b == 0xC5:
        n = struct.unpack_from(">H", buf, o)[0]
        return bytes(buf[o + 2 : o + 2 + n]), o + 2 + n
    if b == 0xC6:
        n = struct.unpack_from(">I", buf, o)[0]
        return bytes(buf[o + 4 : o + 4 + n]), o + 4 + n
    if b == 0xCA:
        return struct.unpack_from(">f", buf, o)[0], o + 4
    if b == 0xCB:
        return struct.unpack_from(">d", buf, o)[0], o + 8
    if b == 0xCC:
        return buf[o], o + 1
    if b == 0xCD:
        return struct.unpack_from(">H", buf, o)[0], o + 2
    if b == 0xCE:
        return struct.unpack_from(">I", buf, o)[0], o + 4
    if b == 0xCF:
        return struct.unpack_from(">Q", buf, o)[0], o + 8
    if b == 0xD0:
        return struct.unpack_from(">b", buf, o)[0], o + 1
    if b == 0xD1:
        return struct.unpack_from(">h", buf, o)[0], o + 2
    if b == 0xD2:
        return struct.unpack_from(">i", buf, o)[0], o + 4
    if b == 0xD3:
        return struct.unpack_from(">q", buf, o)[0], o + 8
    if b == 0xD8:  # fixext16
        return (buf[o], bytes(buf[o + 1 : o + 17])), o + 17
    if b == 0xD9:
        n = buf[o]
        return buf[o + 1 : o + 1 + n].decode("utf-8", errors="replace"), o + 1 + n
    if b == 0xDA:
        n = struct.unpack_from(">H", buf, o)[0]
        return buf[o + 2 : o + 2 + n].decode("utf-8", errors="replace"), o + 2 + n
    if b == 0xDB:
        n = struct.unpack_from(">I", buf, o)[0]
        return buf[o + 4 : o + 4 + n].decode("utf-8", errors="replace"), o + 4 + n
    if b == 0xDC:
        n = struct.unpack_from(">H", buf, o)[0]
        return _unpack_array(buf, o + 2, n)
    if b == 0xDD:
        n = struct.unpack_from(">I", buf, o)[0]
        return _unpack_array(buf, o + 4, n)
    if b == 0xDE:
        n = struct.unpack_from(">H", buf, o)[0]
        return _unpack_map(buf, o + 2, n)
    if b == 0xDF:
        n = struct.unpack_from(">I", buf, o)[0]
        return _unpack_map(buf, o + 4, n)
    raise ValueError(f"msgpack_lite: unsupported marker 0x{b:02x} at {offset}")


def _unpack_array(buf: bytes, o: int, n: int) -> tuple[list, int]:
    items = []
    for _ in range(n):
        item, o = unpack_from(buf, o)
        items.append(item)
    return items, o


def _unpack_map(buf: bytes, o: int, n: int) -> tuple[dict, int]:
    d = {}
    for _ in range(n):
        k, o = unpack_from(buf, o)
        v, o = unpack_from(buf, o)
        d[k] = v
    return d, o


def unpackb(buf: bytes) -> Any:
    """Decode a single msgpack object from ``buf``."""
    obj, _ = unpack_from(buf, 0)
    return obj
