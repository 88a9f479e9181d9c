"""The port's ``.bl2`` codec and ``msgpack_lite`` against the JAX package's:
msgpack bytes and round trips on tests/test_bl2.py's objects; chunks from
the system libblosc (through JAX's ``blosc1_compress_chunk``) decoded
exactly for every codec, shuffle mode and clevel, blosc2 extended,
memcpyed and special-value chunks, dictionary and filter refusals; frames
bit-identical both ways (JAX ``save_bl2`` → port, port → JAX
``load_bl2``) over dtypes and 0-d, empty and multi-chunk shapes, the
port's default writer byte-identical to JAX's; every codec the JAX writer
takes (blosclz, lz4, lz4hc, zlib, zstd) at clevel 0, 1, 5 and 9 read both
ways, each file within 1.15x of the JAX writer's size at clevel 1-9; the
codecs' ``.bl2`` path; a missing libzstd raises naming it.
"""

import struct

import numpy as np
import pytest
import torch

from depth_completion_tpu.io import bl2 as jbl2
from depth_completion_tpu.io import codecs as jcodecs
from depth_completion_tpu.io import msgpack_lite as jmp
from depth_completion_tpu_torch.io import bl2, codecs
from depth_completion_tpu_torch.io import msgpack_lite as mp

from tests.test_bl2 import _as_blosc2_chunk

MSGPACK_OBJECTS = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -129,
    -(2**20), -(2**40), 3.5, "", "hello", "x" * 40, "x" * 300, b"", b"bytes", b"y" * 300, [],
    [1, "two", [3.0, None]], list(range(20)), {}, {"a": 1, "b": [2, 3]},
    ["numpy", [352, 1216], "<f4"],
]


@pytest.mark.parametrize("obj", MSGPACK_OBJECTS, ids=lambda o: repr(o)[:24])
def test_msgpack_matches_jax(obj):
    packed = mp.packb(obj)
    assert packed == jmp.packb(obj)
    assert mp.unpackb(packed) == jmp.unpackb(packed) == obj


def test_msgpack_fixext16_and_errors():
    buf = b"\xd8\x00" + bytes(range(16))
    assert mp.unpack_from(buf) == jmp.unpack_from(buf) == ((0, bytes(range(16))), 18)
    with pytest.raises(ValueError, match="unsupported marker"):
        mp.unpackb(b"\xc1")
    with pytest.raises(TypeError):
        mp.packb(object())


def _payloads():
    rng = np.random.default_rng(7)
    smooth = np.cumsum(rng.normal(size=50_000)).astype(np.float32)
    return [
        smooth, smooth.astype(np.float64), (smooth * 10).astype(np.uint16),
        rng.integers(0, 256, 30_000).astype(np.uint8), np.zeros(70_000, np.float32),
        rng.normal(size=1001).astype(np.float32),  # a last block shorter than the rest
        np.arange(37, dtype=np.int32),  # below 128 bytes: memcpyed
    ]


@pytest.mark.parametrize("codec", ["blosclz", "lz4", "lz4hc", "zlib", "zstd"])
@pytest.mark.parametrize("shuffle", [0, 1, 2])
def test_libblosc_chunks_decode_exactly(codec, shuffle):
    for clevel in (1, 5, 9):
        for arr in _payloads():
            data = arr.tobytes()
            chunk = jbl2.blosc1_compress_chunk(data, arr.dtype.itemsize, clevel=clevel,
                                               shuffle=shuffle, codec=codec)
            assert bl2.decompress_chunk(chunk) == data, (codec, shuffle, clevel, arr.dtype)


@pytest.mark.parametrize("codec", ["blosclz", "lz4", "zstd"])
def test_multiblock_and_blosc2_extended_chunks(codec):
    arr = np.arange(500_000, dtype=np.float32)
    for shuffle in (0, 1, 2):
        chunk = jbl2.blosc1_compress_chunk(arr.tobytes(), 4, blocksize=65536, codec=codec,
                                           shuffle=shuffle)
        assert bl2.chunk_info(chunk)["blocksize"] < arr.nbytes // 4  # several blocks
        assert bl2.decompress_chunk(chunk) == arr.tobytes()
    data = np.cumsum(np.ones(100_000, np.float32) * 0.25).tobytes()
    for shuffle in (0, 1):
        b2 = _as_blosc2_chunk(jbl2.blosc1_compress_chunk(data, 4, clevel=5, shuffle=shuffle,
                                                          codec=codec))
        assert bl2.decompress_chunk(b2) == jbl2.decompress_chunk(b2) == data


def test_blosc2_memcpyed_special_and_refused_chunks():
    data = np.random.default_rng(3).bytes(10_000)
    b1 = jbl2.blosc1_compress_chunk(data, 1, clevel=0, shuffle=0)
    assert bl2.chunk_info(b1)["flags"] & bl2.FLAG_MEMCPYED
    assert bl2.decompress_chunk(b1) == bl2.decompress_chunk(_as_blosc2_chunk(b1)) == data

    def special(code, nbytes, ts, tail=b""):
        header = struct.pack("<BBBBiii", 5, 1, 0, ts, nbytes, nbytes, 32 + len(tail))
        return header + bytes(15) + bytes([code << 4]) + tail

    for chunk in (special(1, 64, 4), special(2, 64, 4), special(2, 64, 8),
                  special(3, 64, 4, struct.pack("<f", 2.5)), special(4, 24, 8)):
        np.testing.assert_array_equal(
            np.frombuffer(bl2.decompress_chunk(chunk), np.uint8),
            np.frombuffer(jbl2.decompress_chunk(chunk), np.uint8))
    assert np.isnan(np.frombuffer(bl2.decompress_chunk(special(2, 64, 4)), np.float32)).all()
    with pytest.raises(ValueError, match="dictionary"):
        bl2.decompress_chunk(struct.pack("<BBBBiii", 5, 1, 0, 4, 64, 64, 40) + bytes(15)
                             + b"\x01" + bytes(8))
    delta = bytearray(_as_blosc2_chunk(jbl2.blosc1_compress_chunk(data, 1, clevel=5)))
    delta[16] = 3
    with pytest.raises(ValueError, match="'delta' filter"):
        bl2.decompress_chunk(bytes(delta))


FRAME_ARRAYS = {
    "f32-depth": np.where(np.random.default_rng(0).random((48, 64, 1)) < 0.3,
                          np.random.default_rng(1).uniform(1, 100, (48, 64, 1)), 0)
    .astype(np.float32),
    "f32-noise": np.random.default_rng(2).normal(size=(352, 1216)).astype(np.float32),
    "f64": np.arange(24, dtype=np.float64).reshape(2, 3, 4),
    "u8": np.random.default_rng(3).integers(0, 256, (37, 53, 3)).astype(np.uint8),
    "u16": np.random.default_rng(4).integers(0, 2**16, (33, 7)).astype(np.uint16),
    "i32": np.random.default_rng(5).integers(-2**31, 2**31, (100, 3)).astype(np.int32),
    "bool": np.random.default_rng(6).random((50, 70)) < 0.5,
    "0-d": np.asarray(np.float32(3.25)),
    "empty": np.zeros((0, 5), np.float32),
    "incompressible": np.frombuffer(np.random.default_rng(7).bytes(100_000), np.uint8),
}


@pytest.mark.parametrize("name", FRAME_ARRAYS)
def test_frames_both_ways(tmp_path, name):
    x = FRAME_ARRAYS[name]
    port, jax = tmp_path / "port.bl2", tmp_path / "jax.bl2"
    bl2.save_bl2(x, port)
    jbl2.save_bl2(x, jax)
    assert port.read_bytes() == jax.read_bytes()  # the same chunks, frame and vlmeta
    for got in (bl2.load_bl2(jax), jbl2.load_bl2(port), bl2.load_bl2(port)):
        assert got.dtype == x.dtype and got.shape == x.shape
        np.testing.assert_array_equal(got, x)


def test_multichunk_and_lz4_frames(tmp_path):
    x = np.random.default_rng(8).normal(size=(300, 500)).astype(np.float32)
    for codec in ("zstd", "lz4"):
        p = tmp_path / f"{codec}.bl2"
        bl2.save_bl2(x, p, codec=codec, chunksize=1 << 16)  # ~10 chunks
        np.testing.assert_array_equal(jbl2.load_bl2(p), x)
        np.testing.assert_array_equal(bl2.load_bl2(p), x)
        q = tmp_path / f"jax_{codec}.bl2"
        jbl2.save_bl2(x, q, codec=codec, chunksize=1 << 16)
        np.testing.assert_array_equal(bl2.load_bl2(q), x)
    smooth = np.cumsum(np.ones((64, 64), np.float32), axis=1)
    p = tmp_path / "lz4_split.bl2"
    bl2.save_bl2(smooth, p, codec="lz4")
    raw = p.read_bytes()
    assert not bl2.chunk_info(raw[94:110])["flags"] & bl2.FLAG_DONT_SPLIT
    assert len(raw) < smooth.nbytes // 4
    np.testing.assert_array_equal(jbl2.load_bl2(p), smooth)
    with pytest.raises(ValueError, match="not 'snappy'"):
        bl2.save_bl2(smooth, tmp_path / "x.bl2", codec="snappy")
    for clevel in (-1, 10):
        with pytest.raises(ValueError, match=f"clevel {clevel} is not in 0-9"):
            bl2.save_bl2(smooth, tmp_path / "x.bl2", clevel=clevel, codec="lz4")


WRITE_CODECS = ["blosclz", "lz4", "lz4hc", "zlib", "zstd"]


def dense_map(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A smooth dense depth map [h, w, 1] in metres: a sum of seeded
    low-frequency waves over a slanted floor, as the pipeline's maps are."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    depth = 5.0 + 40.0 * yy / h
    for _ in range(6):
        fy, fx = rng.uniform(0.2, 3.0, 2) * 2 * np.pi / np.array([h, w])
        depth += rng.uniform(0.5, 4.0) * np.sin(fy * yy + fx * xx + rng.uniform(0, 2 * np.pi))
    return depth.astype(np.float32)[..., None]


@pytest.mark.parametrize("clevel", [0, 1, 5, 9])
@pytest.mark.parametrize("codec", WRITE_CODECS)
def test_every_codec_and_clevel_both_ways(tmp_path, codec, clevel):
    """The port's file for each codec and clevel is read bit-exact by the
    JAX reader (libblosc1) and the port's; the JAX writer's file for the
    same codec and clevel by the port's. clevel 0 writes memcpyed chunks,
    as c-blosc does."""
    port, jax = tmp_path / "port.bl2", tmp_path / "jax.bl2"
    for name in ("f32-depth", "u16", "incompressible", "0-d"):
        x = FRAME_ARRAYS[name]
        bl2.save_bl2(x, port, clevel=clevel, codec=codec)
        jbl2.save_bl2(x, jax, clevel=clevel, codec=codec)
        for got in (jbl2.load_bl2(port), bl2.load_bl2(port), bl2.load_bl2(jax)):
            assert got.dtype == x.dtype and got.shape == x.shape, (name, got.shape)
            np.testing.assert_array_equal(got, x, err_msg=name)
        if clevel == 0:
            assert bl2.chunk_info(port.read_bytes()[94:110])["flags"] & bl2.FLAG_MEMCPYED
    # several chunks, and blocks split into streams (the codecs but zstd)
    x = dense_map(64, 96, seed=1)
    bl2.save_bl2(x, port, clevel=clevel, codec=codec, chunksize=1 << 13)
    np.testing.assert_array_equal(jbl2.load_bl2(port), x)
    np.testing.assert_array_equal(bl2.load_bl2(port), x)


@pytest.mark.parametrize("codec", WRITE_CODECS)
def test_writer_size_within_bound_of_jax(tmp_path, codec):
    """At every clevel from 1 to 9 the port's file of a smooth dense depth
    map is at most 1.15x the JAX writer's (c-blosc 1.21) for the same codec
    and clevel: its encoders compress. The JAX reader reads each file
    bit-exact. zstd and zlib give c-blosc's bytes, so their files are the
    same size; every chunk header carries c-blosc's block size and split
    flag."""
    x = dense_map(192, 256)
    for clevel in range(1, 10):
        port, jax = tmp_path / f"port{clevel}.bl2", tmp_path / f"jax{clevel}.bl2"
        bl2.save_bl2(x, port, clevel=clevel, codec=codec)
        jbl2.save_bl2(x, jax, clevel=clevel, codec=codec)
        np.testing.assert_array_equal(jbl2.load_bl2(port), x)  # every clevel read by JAX
        size, ref = port.stat().st_size, jax.stat().st_size
        assert size <= 1.15 * ref, (clevel, size, ref)
        assert size < 0.8 * x.nbytes, (clevel, size)
        if codec in ("zstd", "zlib"):
            assert size == ref, (clevel, size, ref)
        mine, theirs = (bl2.chunk_info(p.read_bytes()[94:110]) for p in (port, jax))
        assert (mine["blocksize"], mine["flags"]) == (theirs["blocksize"], theirs["flags"]), clevel


def test_frame_errors(tmp_path):
    p = tmp_path / "junk.bl2"
    p.write_bytes(bytes(256))
    with pytest.raises(ValueError, match="magic"):
        bl2.load_bl2(p)
    p.write_bytes(b"\x9d\xa8b2frame\x00" + bytes(128))
    with pytest.raises(ValueError, match="__pack_tensor__"):
        bl2.load_bl2(p)


def test_codecs_bl2_path(tmp_path):
    x = FRAME_ARRAYS["f32-depth"]
    codecs.save_array(torch.from_numpy(x).to(torch.bfloat16), tmp_path / "a.bl2", compress="bl2")
    np.testing.assert_array_equal(codecs.load_array(tmp_path / "a.bl2"),
                                  torch.from_numpy(x).to(torch.bfloat16).float().numpy())
    jcodecs.save_array(x, tmp_path / "j.bl2", compress="bl2")
    got = codecs.load_arrays([tmp_path / "j.bl2", tmp_path / "a.bl2"], num_threads=2)
    np.testing.assert_array_equal(got[0], x)
    assert codecs.is_array_path(tmp_path / "j.bl2")
    codecs.save_array(x, tmp_path / "lz4.bl2", compress="bl2", bl2_codec="lz4")
    np.testing.assert_array_equal(jcodecs.load_array(tmp_path / "lz4.bl2"), x)
    with pytest.raises(ValueError, match="bl2_codec='lz4' is for compress='bl2'"):
        codecs.save_array(x, tmp_path / "a.npy", bl2_codec="lz4")


def test_missing_libzstd_raises_naming_it(monkeypatch, tmp_path):
    """Without libzstd the zstd codec raises naming the library, and the
    LZ4 writer its message points to still works."""
    import ctypes

    bl2._codec_lib()  # the port's own library, built and loaded before CDLL is broken

    def no_lib(name, *a, **k):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(bl2, "_zstd", [])
    monkeypatch.setattr(ctypes, "CDLL", no_lib)
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    with pytest.raises(RuntimeError, match="libzstd.so.1 not found.*bl2_codec='lz4'"):
        bl2.zstd_version()
    x = FRAME_ARRAYS["f32-noise"]
    codecs.save_array(x, tmp_path / "lz4.bl2", compress="bl2", bl2_codec="lz4")
    np.testing.assert_array_equal(bl2.load_bl2(tmp_path / "lz4.bl2"), x)
