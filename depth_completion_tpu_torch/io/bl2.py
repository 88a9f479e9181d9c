"""``.bl2`` arrays (blosc2's contiguous frame), the port's own codec:
counterpart of ``depth_completion_tpu.io.bl2`` without its dependency on
the system c-blosc library: the port carries the blosc containers itself.

- **Chunks.** Both headers are read directly: blosc1 (16 bytes, version
  <= 2) and blosc2's extended one (32 bytes: its filter pipeline, then
  ``blosc2_flags``). Then ``bstarts``, one offset per block, each block in
  ``typesize`` streams unless the chunk's "don't split" flag (0x10) is set
  or the block is the last, shorter one; a stream as long as its share of
  the block is stored raw. Memcpyed chunks (flag 0x02) hold the bytes after
  the header; blosc2's special-value chunks (zeros, NaNs, a repeated value,
  uninitialised) are materialised; dictionary compression and the delta
  and truncation filters raise ``ValueError`` as the JAX reader does.
  Blocks are byte-unshuffled (flag 0x01) or bit-unshuffled (0x04).
- **Codecs.** zstd through the system ``libzstd.so.1`` (``ctypes``; a
  compression library, not a kernel package: absent, the codec raises
  naming it), LZ4 and LZ4HC streams and blosclz through the port's own
  decoders (``csrc/dcz_codec.cpp``), zlib through Python's ``zlib``.
- **Writer.** What the JAX package's ``save_bl2`` writes through c-blosc
  1.21, for every codec it takes (blosclz, lz4, lz4hc, zlib, zstd) at
  clevel 0-9: byte shuffle for typesize > 1; blocks as c-blosc sizes them
  (32 KiB, doubled for lz4hc, zlib and zstd, scaled by the clevel; split
  into typesize streams for every codec but zstd when a stream holds at
  least 128 elements, the block then 64 KiB to 1 MiB); chunks of 4 MiB; a
  memcpyed chunk at clevel 0, under 128 bytes, or where compression does
  not pay (beyond the 4 KiB of slack the JAX writer gives c-blosc); the
  chunk offsets as a memcpyed chunk of int64s, the frame header and trailer
  of ``save_bl2`` and its ``__pack_tensor__`` vlmeta entry (``["numpy",
  shape, dtype.str]``). The streams: zstd at c-blosc's level (2 clevel - 1,
  the maximum at 9) and zlib at the clevel (Python's ``zlib``) give the
  bytes c-blosc gives; LZ4, LZ4HC (a hash-chain search whose depth grows
  with the clevel) and blosclz are the port's own encoders
  (``csrc/dcz_codec.cpp``), whose streams any LZ4 or blosclz decoder reads.
  The default (zstd at clevel 1) is byte-identical to the JAX writer's.
- **Frame reader.** Lenient as ``load_bl2`` is: the magic, the
  ``__pack_tensor__`` triple found after its name, the first chunk at the
  header's ``header_len`` (else the first plausible chunk header), then
  chunks in a row until the array's bytes are in.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import struct
import threading
import zlib
from pathlib import Path

import numpy as np

from depth_completion_tpu_torch import _build
from depth_completion_tpu_torch.io import msgpack_lite as mp

__all__ = ["save_bl2", "load_bl2", "compress_chunk", "decompress_chunk", "chunk_info",
           "zstd_version"]

MAGIC = b"b2frame\x00"
DEFAULT_CHUNKSIZE = 1 << 22  # 4 MiB, a multiple of every typesize
MIN_BUFFERSIZE = 128  # below it blosc stores a chunk memcpyed
MAX_SPLITS = 16
# the JAX writer hands c-blosc a destination of nbytes + 16 + 4096 bytes:
# a chunk stays compressed up to that size, and only beyond it is memcpyed
DEST_SLACK = 16 + 4096
FLAG_SHUFFLE, FLAG_MEMCPYED, FLAG_BITSHUFFLE, FLAG_DONT_SPLIT = 0x1, 0x2, 0x4, 0x10
_CODEC_NAMES = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}
# the codecs written: (the chunk header's codec code, the frame header's
# codec byte in blosc2's compressor codes)
WRITE_CODECS = {"blosclz": (0, 0), "lz4": (1, 1), "lz4hc": (1, 2), "zlib": (3, 4),
                "zstd": (4, 5)}
_HCR_CODECS = ("lz4hc", "zlib", "zstd")  # c-blosc doubles their blocks
L1 = 32 * 1024  # c-blosc's base block size
MAX_CLEVEL = 9
_B2_USEDICT = 0x1
_B2_FILTER_SHUFFLE, _B2_FILTER_BITSHUFFLE = 1, 2
_UNSUPPORTED_FILTERS = {3: "delta", 4: "truncation"}

_zstd_lock = threading.Lock()
_zstd: list[ctypes.CDLL] = []


def _zstd_lib() -> ctypes.CDLL:
    """The system libzstd (``libzstd.so.1``), loaded once."""
    with _zstd_lock:
        if not _zstd:
            name = "libzstd.so.1"
            try:
                lib = ctypes.CDLL(name)
            except OSError:
                found = ctypes.util.find_library("zstd")
                if found is None:
                    raise RuntimeError(
                        f"{name} not found: the .bl2 codec's zstd streams need the system zstd "
                        "library; write dcz, npy or npz, or LZ4 .bl2 "
                        "(save_array(..., bl2_codec='lz4'))") from None
                lib = ctypes.CDLL(found)
            lib.ZSTD_decompress.restype = ctypes.c_size_t
            lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                                            ctypes.c_size_t]
            lib.ZSTD_compress.restype = ctypes.c_size_t
            lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                                          ctypes.c_size_t, ctypes.c_int]
            lib.ZSTD_compressBound.restype = ctypes.c_size_t
            lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
            lib.ZSTD_versionString.restype = ctypes.c_char_p
            _zstd.append(lib)
        return _zstd[0]


def zstd_version() -> str:
    """The loaded libzstd's version string (loads it; raises if absent)."""
    return _zstd_lib().ZSTD_versionString().decode()


@functools.cache
def _codec_lib() -> ctypes.CDLL:
    """The port's chunk primitives, built at first use; signatures declared once."""
    lib = _build.load("dcz_codec")
    for fn in ("bl2_lz4_compress", "bl2_lz4_decompress", "bl2_blosclz_decompress"):
        getattr(lib, fn).restype = ctypes.c_long
        getattr(lib, fn).argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                     ctypes.c_size_t]
    for fn in ("bl2_lz4hc_compress", "bl2_blosclz_compress"):
        getattr(lib, fn).restype = ctypes.c_long
        getattr(lib, fn).argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                     ctypes.c_size_t, ctypes.c_int]
    for fn in ("bl2_shuffle", "bl2_unshuffle"):
        getattr(lib, fn).restype = None
        getattr(lib, fn).argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t,
                                     ctypes.c_size_t]
    lib.bl2_bitunshuffle.restype = None
    lib.bl2_bitunshuffle.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t,
                                     ctypes.c_size_t, ctypes.c_int]
    return lib


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------


def _decode_stream(codec: int, data: bytes, size: int) -> bytes:
    """One compressed stream → exactly ``size`` bytes."""
    if codec == 4:
        lib = _zstd_lib()
        out = ctypes.create_string_buffer(size)
        got = lib.ZSTD_decompress(out, size, data, len(data))
        if lib.ZSTD_isError(got):
            raise ValueError("corrupt zstd stream in a .bl2 chunk")
        raw = out.raw[:got]
    elif codec == 3:
        try:
            raw = zlib.decompress(data)
        except zlib.error as e:
            raise ValueError(f"corrupt zlib stream in a .bl2 chunk ({e})") from None
    elif codec in (0, 1):
        out = ctypes.create_string_buffer(max(size, 1))
        fn = _codec_lib().bl2_blosclz_decompress if codec == 0 else _codec_lib().bl2_lz4_decompress
        got = fn(data, len(data), out, size)
        if got < 0:
            raise ValueError(f"corrupt {_CODEC_NAMES[codec]} stream in a .bl2 chunk")
        raw = out.raw[:got]
    else:
        raise ValueError(f".bl2 chunk compressed with {_CODEC_NAMES.get(codec, codec)!r}, which "
                         "the port does not read")
    if len(raw) != size:
        raise ValueError(f"a .bl2 stream decoded to {len(raw)} bytes, not {size}")
    return raw


def _zstd_level(clevel: int) -> int:
    """c-blosc 1.21's zstd level for a blosc clevel: 2 clevel - 1, and
    zstd's maximum at 9."""
    return 2 * clevel - 1 if clevel < MAX_CLEVEL else 22


def _encode_stream(codec: str, data: bytes, clevel: int) -> bytes | None:
    """One stream compressed, or None where it does not shrink."""
    if codec == "zstd":
        lib = _zstd_lib()
        cap = lib.ZSTD_compressBound(len(data))
        out = ctypes.create_string_buffer(cap)
        got = lib.ZSTD_compress(out, cap, data, len(data), _zstd_level(clevel))
        if lib.ZSTD_isError(got):
            raise RuntimeError("ZSTD_compress failed")
        raw = out.raw[:got]
    elif codec == "zlib":
        raw = zlib.compress(data, clevel)
    else:
        out = ctypes.create_string_buffer(len(data))
        lib = _codec_lib()
        if codec == "lz4":
            got = lib.bl2_lz4_compress(data, len(data), out, len(data))
        elif codec == "lz4hc":
            got = lib.bl2_lz4hc_compress(data, len(data), out, len(data), clevel)
        else:
            got = lib.bl2_blosclz_compress(data, len(data), out, len(data), clevel)
        raw = out.raw[:got]
    return raw if 0 < len(raw) < len(data) else None


# ---------------------------------------------------------------------------
# chunks
# ---------------------------------------------------------------------------


def chunk_info(chunk: bytes) -> dict:
    """The header fields both chunk formats share."""
    if len(chunk) < 16:
        raise ValueError("truncated blosc chunk header")
    nbytes, blocksize, cbytes = struct.unpack_from("<iii", chunk, 4)
    return {"version": chunk[0], "versionlz": chunk[1], "flags": chunk[2], "typesize": chunk[3],
            "nbytes": nbytes, "blocksize": blocksize, "cbytes": cbytes}


def _special(code: int, chunk: bytes, nbytes: int, typesize: int) -> bytes:
    if code in (1, 4):  # zeros, uninitialised
        return bytes(nbytes)
    if code == 2:  # NaNs
        one = struct.pack("<d" if typesize == 8 else "<f", float("nan"))
        return (one * (nbytes // len(one) + 1))[:nbytes]
    if code == 3:  # a repeated value after the header
        value = chunk[32: 32 + typesize]
        if len(value) != typesize:
            raise ValueError("truncated special-value blosc2 chunk")
        return (value * (nbytes // typesize + 1))[:nbytes]
    raise ValueError(f"unknown blosc2 special-value code {code}")


def decompress_chunk(chunk: bytes) -> bytes:
    """One chunk, blosc1 or blosc2, → its bytes."""
    info = chunk_info(chunk)
    nbytes, blocksize, typesize, flags = (info["nbytes"], info["blocksize"], info["typesize"],
                                          info["flags"])
    blosc2 = info["version"] > 2
    head = 16
    if blosc2:
        if len(chunk) < 32:
            raise ValueError("truncated blosc2 chunk header")
        head = 32
        b2flags = chunk[31]
        if b2flags & _B2_USEDICT:
            raise ValueError(".bl2 chunk uses blosc2 dictionary compression, which the port's "
                             "codec does not support")
        if (b2flags >> 4) & 0x7:
            return _special((b2flags >> 4) & 0x7, chunk, nbytes, typesize)
        for f in chunk[16:22]:
            if f in _UNSUPPORTED_FILTERS:
                raise ValueError(f".bl2 chunk uses the blosc2 '{_UNSUPPORTED_FILTERS[f]}' filter, "
                                 "which the port's codec does not support")
            if f == _B2_FILTER_SHUFFLE:
                flags |= FLAG_SHUFFLE
            elif f == _B2_FILTER_BITSHUFFLE:
                flags |= FLAG_BITSHUFFLE
    if nbytes < 0 or (nbytes and blocksize <= 0):
        raise ValueError("bad blosc chunk header")
    if flags & FLAG_MEMCPYED:
        body = chunk[head: head + nbytes]
        if len(body) != nbytes:
            raise ValueError("truncated memcpyed blosc chunk")
        return bytes(body)
    codec = flags >> 5
    nblocks = -(-nbytes // blocksize) if nbytes else 0
    if len(chunk) < head + 4 * nblocks:
        raise ValueError("truncated blosc chunk block index")
    bstarts = struct.unpack_from(f"<{nblocks}i", chunk, head)
    lib = _codec_lib()
    out = ctypes.create_string_buffer(max(nbytes, 1))
    for b, start in enumerate(bstarts):
        bsize = min(blocksize, nbytes - b * blocksize)
        last = bsize < blocksize
        streams = 1 if flags & FLAG_DONT_SPLIT or last else typesize
        neblock = bsize // streams
        parts, pos = [], start
        for _ in range(streams):
            if pos + 4 > len(chunk):
                raise ValueError("truncated blosc chunk stream")
            (csize,) = struct.unpack_from("<i", chunk, pos)
            pos += 4
            if blosc2 and csize == 0:  # a run of zeros
                parts.append(bytes(neblock))
            elif blosc2 and csize < 0:  # a run of one byte value
                parts.append(bytes([-csize & 0xFF]) * neblock)
                csize = 0
            elif csize == neblock:
                parts.append(chunk[pos: pos + neblock])
            else:
                parts.append(_decode_stream(codec, chunk[pos: pos + csize], neblock))
            pos += max(csize, 0)
        block = b"".join(parts)
        if len(block) != bsize:
            raise ValueError("truncated blosc chunk stream")
        dst = ctypes.addressof(out) + b * blocksize
        if flags & FLAG_SHUFFLE and typesize > 1:
            lib.bl2_unshuffle(block, dst, bsize, typesize)
        elif flags & FLAG_BITSHUFFLE and bsize >= typesize:
            lib.bl2_bitunshuffle(block, dst, bsize, typesize, int(blosc2))
        else:
            ctypes.memmove(dst, block, bsize)
    return out.raw[:nbytes]


def _splits(codec: str, typesize: int, blocksize: int) -> bool:
    """c-blosc 1.21's split rule (its forward-compatible default): every
    codec but zstd splits a block into typesize streams when the typesize
    is at most 16 and a stream holds at least 128 elements."""
    return codec != "zstd" and typesize <= MAX_SPLITS and blocksize // typesize >= MIN_BUFFERSIZE


def _blocksize(codec: str, typesize: int, nbytes: int, clevel: int) -> int:
    """The block size c-blosc 1.21 chooses (``compute_blocksize``): L1,
    doubled for lz4hc, zlib and zstd, scaled by the clevel (0: /4, 1: /2,
    3: x2, 4-5: x4, 6-9: x8, 9 doubling again for the doubled codecs); for
    a split codec at clevel > 0 at most 256 KiB per stream, times the
    typesize, kept within 64 KiB to 1 MiB; never beyond the chunk, and a
    multiple of the typesize."""
    if nbytes < typesize:
        return 1
    size = nbytes
    if nbytes >= L1:
        size = L1 * (2 if codec in _HCR_CODECS else 1)
        size = {0: size // 4, 1: size // 2, 2: size, 3: size * 2, 4: size * 4,
                5: size * 4}.get(clevel, size * 8)
        if clevel == MAX_CLEVEL and codec in _HCR_CODECS:
            size *= 2
        if clevel > 0 and _splits(codec, typesize, size):
            size = min(max(min(size, 1 << 18) * typesize, 1 << 16), 1 << 20)
    size = min(size, nbytes)
    if size > typesize:
        size -= size % typesize
    return size


def _check_codec(codec: str, clevel: int) -> None:
    if codec not in WRITE_CODECS:
        raise ValueError(f"the port writes .bl2 with {', '.join(WRITE_CODECS)}, not {codec!r}")
    if not 0 <= clevel <= MAX_CLEVEL:
        raise ValueError(f".bl2 clevel {clevel} is not in 0-{MAX_CLEVEL}")


def compress_chunk(data: bytes, typesize: int, codec: str = "zstd", clevel: int = 1) -> bytes:
    """One blosc1 chunk (format version 2) of ``data``, byte shuffled for
    a typesize above 1, as c-blosc 1.21 lays it out (see the module note)."""
    _check_codec(codec, clevel)
    nbytes = len(data)
    shuffle = typesize > 1
    flags = (WRITE_CODECS[codec][0] << 5) | (FLAG_SHUFFLE if shuffle else 0)
    blocksize = _blocksize(codec, typesize, nbytes, clevel)
    split = _splits(codec, typesize, blocksize)
    if not split:
        flags |= FLAG_DONT_SPLIT
    memcpyed = struct.pack("<BBBBiii", 2, 1, flags | FLAG_MEMCPYED, typesize, nbytes,
                           blocksize, 16 + nbytes) + data
    if nbytes < MIN_BUFFERSIZE or clevel == 0:
        return memcpyed
    lib = _codec_lib()
    nblocks = -(-nbytes // blocksize)
    body, pos = [], 16 + 4 * nblocks
    bstarts = []
    for b in range(nblocks):
        block = data[b * blocksize: (b + 1) * blocksize]
        if shuffle:
            buf = ctypes.create_string_buffer(len(block))
            lib.bl2_shuffle(block, buf, len(block), typesize)
            block = buf.raw
        streams = typesize if split and len(block) == blocksize else 1
        neblock = len(block) // streams
        bstarts.append(pos)
        for s in range(streams):
            raw = block[s * neblock: (s + 1) * neblock]
            packed = _encode_stream(codec, raw, clevel)
            payload = raw if packed is None else packed
            body.append(struct.pack("<i", len(payload)) + payload)
            pos += 4 + len(payload)
        if pos > nbytes + DEST_SLACK:  # compression does not pay
            return memcpyed
    header = struct.pack("<BBBBiii", 2, 1, flags, typesize, nbytes, blocksize, pos)
    return header + struct.pack(f"<{nblocks}i", *bstarts) + b"".join(body)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def _build_header(frame_len: int, nbytes: int, cbytes: int, typesize: int, blocksize: int,
                  chunksize: int, codec: str) -> bytes:
    """The 94-byte frame header ``save_bl2`` writes (msgpack markers at
    fixed offsets: magic@2, header_len@11, frame_len@16, flags@25,
    nbytes@30, cbytes@39, typesize@48, blocksize@53, chunksize@58)."""
    out = bytearray([0x90 | 13, 0xA8]) + MAGIC
    out += b"\xd2" + struct.pack(">i", 94)
    out += b"\xcf" + struct.pack(">Q", frame_len)
    out += b"\xa4" + bytes([0x10 | 0x1, 0, WRITE_CODECS[codec][1], 0])
    out += b"\xd3" + struct.pack(">q", nbytes)
    out += b"\xd3" + struct.pack(">q", cbytes)
    out += b"\xd2" + struct.pack(">i", typesize)
    out += b"\xd2" + struct.pack(">i", blocksize)
    out += b"\xd2" + struct.pack(">i", chunksize)
    out += b"\xd1" + struct.pack(">h", 1)  # compression threads
    out += b"\xd1" + struct.pack(">h", 1)  # decompression threads
    out += b"\xc3"  # has vlmeta
    # filter pipeline: fixext16, type byte = number of filters
    out += b"\xd8" + bytes([1]) + bytes([_B2_FILTER_SHUFFLE, 0, 0, 0, 0, 0, 0, 0]) + bytes(8)
    out += bytes([0x93, 0xCD, 0x00, 0x00, 0xDE, 0x00, 0x00])  # empty metalayers
    return bytes(out)


def _build_trailer(vlmeta: dict[str, bytes]) -> bytes:
    """[version, vlmeta index and contents, trailer_len, fingerprint]."""
    names = list(vlmeta)
    index = bytearray([0x93, 0xCD, 0x00, 0x00, 0xDE]) + struct.pack(">H", len(names))
    slots = []
    for name in names:
        index += mp.packb(name)
        slots.append(len(index) + 1)
        index += b"\xd2\x00\x00\x00\x00"  # offset, patched below
    struct.pack_into(">H", index, 2, len(index))
    contents = bytearray()
    for name, slot in zip(names, slots):
        struct.pack_into(">i", index, slot, len(index) + len(contents))
        contents += mp.packb(vlmeta[name])
    body = bytes([0x90 | 4, 0x01]) + bytes(index) + bytes(contents)
    tail_len = len(body) + 5 + 18
    return body + b"\xce" + struct.pack(">I", tail_len) + b"\xd8\x00" + bytes(16)


def save_bl2(x, path: Path | str, clevel: int = 1, codec: str = "zstd",
             chunksize: int = DEFAULT_CHUNKSIZE) -> None:
    """Write ``x`` as a blosc2 contiguous frame (see the module note)."""
    _check_codec(codec, clevel)
    path = Path(path)
    x = np.asarray(x)
    if not x.flags.c_contiguous:  # ascontiguousarray would make a 0-d array 1-d
        x = np.ascontiguousarray(x)
    data = x.tobytes()
    typesize = x.dtype.itemsize if 0 < x.dtype.itemsize <= 255 else 8
    chunksize = max(typesize, chunksize - chunksize % typesize)
    chunks = [compress_chunk(data[s: s + chunksize], typesize, codec, clevel)
              for s in range(0, len(data), chunksize)]
    blob = b"".join(chunks)
    offsets = np.cumsum([0] + [len(c) for c in chunks[:-1]]).astype("<i8") if chunks \
        else np.zeros(0, "<i8")
    # the chunk offsets: a memcpyed chunk of int64s, as c-blosc writes it at clevel 0
    coffsets = struct.pack("<BBBBiii", 2, 1, FLAG_MEMCPYED | FLAG_DONT_SPLIT | (4 << 5), 8,
                           offsets.nbytes, max(offsets.nbytes, 1), 16 + offsets.nbytes) \
        + offsets.tobytes()
    trailer = _build_trailer({"__pack_tensor__": mp.packb(
        ["numpy", [int(s) for s in x.shape], x.dtype.str])})
    blocksize = chunk_info(chunks[0])["blocksize"] if chunks else 0
    frame_len = 94 + len(blob) + len(coffsets) + len(trailer)
    header = _build_header(frame_len, len(data), len(blob), typesize, blocksize, chunksize, codec)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(header + blob + coffsets + trailer)


def _pack_tensor_meta(buf: bytes) -> tuple[list[int], np.dtype] | None:
    """The ``__pack_tensor__`` payload: a msgpack [kind, shape, dtype-str]
    triple somewhere after the entry's name."""
    start = buf.rfind(b"__pack_tensor__")
    if start < 0:
        return None
    region = buf[start: start + 4096]
    for off in range(len(region)):
        if region[off] != 0x93:  # a 3-element fixarray
            continue
        try:
            obj, _ = mp.unpack_from(region, off)
        except (ValueError, IndexError, struct.error):
            continue
        if isinstance(obj, list) and len(obj) == 3 and isinstance(obj[0], str) \
                and isinstance(obj[1], list) and all(isinstance(s, int) and s >= 0 for s in obj[1]) \
                and isinstance(obj[2], str):
            try:
                return [int(s) for s in obj[1]], np.dtype(obj[2])
            except TypeError:
                continue
    return None


def _plausible_chunk(buf: bytes, off: int) -> bool:
    if off < 0 or off + 16 > len(buf):
        return False
    version, typesize = buf[off], buf[off + 3]
    if version not in (2, 3, 4, 5, 6) or typesize == 0:
        return False
    nbytes, blocksize, cbytes = struct.unpack_from("<iii", buf, off + 4)
    return nbytes > 0 and cbytes >= 16 and off + cbytes <= len(buf) \
        and 0 < blocksize <= max(nbytes, 32)


def load_bl2(path: Path | str) -> np.ndarray:
    """Read a ``.bl2`` frame written by blosc2, the JAX package or the port."""
    buf = Path(path).read_bytes()
    if buf[2:9] != MAGIC[:7] and MAGIC[:7] not in buf[:16]:
        raise ValueError(f"{path}: not a blosc2 frame (missing b2frame magic)")
    meta = _pack_tensor_meta(buf)
    if meta is None:
        raise ValueError(f"{path}: no __pack_tensor__ metadata found; was this file written by "
                         "blosc2.save_array or save_bl2?")
    shape, dtype = meta
    expected = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    starts = [struct.unpack_from(">i", buf, 11)[0]] if len(buf) > 15 and buf[10] == 0xD2 else []
    starts += range(32, min(len(buf), 8192))
    first = next((s for s in starts if _plausible_chunk(buf, s)), None)
    if first is None:
        if expected == 0:
            return np.zeros(shape, dtype)
        raise ValueError(f"{path}: could not locate the first blosc chunk")
    out, off = [], first
    got = 0
    while got < expected:
        if not _plausible_chunk(buf, off):
            raise ValueError(f"{path}: invalid chunk header at offset {off} ({got}/{expected} "
                             "bytes recovered)")
        info = chunk_info(buf[off: off + 16])
        if info["nbytes"] > expected - got + DEFAULT_CHUNKSIZE:  # a corrupt size
            raise ValueError(f"{path}: chunk at offset {off} holds {info['nbytes']} bytes, "
                             f"past the array's {expected}")
        cbytes = info["cbytes"]
        part = decompress_chunk(buf[off: off + cbytes])
        out.append(part)
        got += len(part)
        off += cbytes
    return np.frombuffer(b"".join(out)[:expected], dtype).reshape(shape)
