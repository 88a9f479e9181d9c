"""The port's image decoders against OpenCV: every committed fixture under
``tests/data/torch_io/`` (written by ``scripts/make_torch_io_fixtures.py``:
JPEG in each sampling, grey, with restart markers, ragged, progressive with
successive approximation, Adobe RGB, CMYK and YCCK, progressive files cut
after a few scans; PNG at bit depths 1, 2 and 4 and Adam7-interlaced; GIF;
BMP uncompressed, RLE8, RLE4 and 16-bit) decodes bit-exact to the cv2
decode recorded beside it and to a live ``cv2.imread``; ``load_img_array``
equals the JAX package's for every mode; full-size JPEG frames decode
bit-exact; the refused JPEG variants raise naming what they are; a
truncated JPEG decodes as cv2.imread decodes it, a progressive one cut
inside any scan with libjpeg's block smoothing; corrupt Huffman tables and
bad RLE BMPs are refused as cv2 refuses them.
"""

import io
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from depth_completion_tpu.io import image as jimage
from depth_completion_tpu_torch.io import image, jpeg
from depth_completion_tpu_torch.io.jpeg import UnsupportedImage

DATA = Path(__file__).resolve().parent / "data" / "torch_io"
FIXTURES = sorted(p.name for p in DATA.iterdir() if p.suffix != ".npy")


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_decodes_bit_exact(name):
    path = DATA / name
    want = np.load(path.with_suffix(".npy"))
    got = image.decode_image(path.read_bytes(), name)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, cv2.imread(str(path), cv2.IMREAD_UNCHANGED))


def test_fixtures_cover_every_kind():
    kinds = {n.split("_")[0] for n in FIXTURES}
    assert kinds == {"jpeg", "png", "gif", "bmp"}
    for needed in ("jpeg_444", "jpeg_422", "jpeg_420", "jpeg_440", "jpeg_grey", "jpeg_restart",
                   "jpeg_53x37_420", "jpeg_progressive", "jpeg_adobe_rgb", "png_grey1",
                   "png_palette2", "png_grey4_adam7", "png_rgb8_adam7", "png_grey16_adam7",
                   "bmp_8_palette", "bmp_24", "bmp_32", "gif_interlaced", "gif_local_table",
                   "jpeg_cmyk_adobe", "jpeg_cmyk_no_adobe", "jpeg_ycck", "jpeg_cmyk_progressive",
                   "jpeg_progressive_colour_1_scans", "jpeg_progressive_grey_2_scans",
                   "bmp_rle8", "bmp_rle8_skips", "bmp_rle4", "bmp_rle4_skips", "bmp_16_555",
                   "bmp_16_565_bitfields"):
        assert any(n.startswith(needed + ".") for n in FIXTURES), needed
    # the PIL progressive file refines with successive approximation
    data = (DATA / "jpeg_progressive.jpg").read_bytes()
    sos = [i for i in range(len(data) - 1) if data[i: i + 2] == b"\xff\xda"]
    ah = [data[i + 7 + 2 * data[i + 4]] >> 4 for i in sos]
    assert len(sos) > 4 and any(ah), ah


@pytest.mark.parametrize("mode", [None, "RGB", "L"])
def test_load_img_array_matches_jax_on_fixtures(mode):
    for name in FIXTURES:
        want = jimage.load_img_array(DATA / name, mode)
        got = image.load_img_array(DATA / name, mode)
        if want is None:
            assert got is None, name
            continue
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _photo(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 / w, 128 + 100 * np.sin(yy / 17), yy * 255 / h], -1)
    return np.clip(img + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("h,w", [(480, 640), (352, 1216)])
def test_full_size_frames_bit_exact(h, w):
    img = _photo(h, w, h)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90, progressive=True)
    for data in (jpeg.encode_jpeg(img), cv2.imencode(".jpg", img[..., ::-1])[1].tobytes(),
                 buf.getvalue()):
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), want)


def _with_sof(data: bytes, code: int) -> bytes:
    i = data.index(b"\xff\xc0")
    return data[: i + 1] + bytes([code]) + data[i + 2:]


def test_jpeg_input_raises(tmp_path):
    """Baseline JPEG input now decodes (it raised before the decoder); the
    variants the port refuses raise ``UnsupportedImage`` naming what they
    are, through ``load_img_array`` too."""
    p = tmp_path / "frame.jpg"
    cv2.imwrite(str(p), np.full((8, 8, 3), 100, np.uint8))
    np.testing.assert_array_equal(image.load_img_array(p, "RGB"),
                                  jimage.load_img_array(p, "RGB"))
    base = jpeg.encode_jpeg(_photo(16, 16, 1))
    cases = {
        "SOF9": (_with_sof(base, 0xC9), r"arithmetic-coded JPEG \(SOF9\)"),
        "SOF3": (_with_sof(base, 0xC3), r"lossless JPEG \(SOF3\)"),
        "SOF5": (_with_sof(base, 0xC5), r"hierarchical JPEG \(SOF5\)"),
    }
    i = base.index(b"\xff\xc0") + 4
    cases["12-bit"] = (base[:i] + b"\x0c" + base[i + 1:], r"12-bit JPEG \(SOF0\)")
    # CMYK decodes since the 4-component fixtures; a component count
    # outside 1, 3 and 4 still raises
    cmyk = io.BytesIO()
    Image.fromarray(np.full((8, 8, 4), 60, np.uint8), "CMYK").save(cmyk, "JPEG")
    i = cmyk.getvalue().index(b"\xff\xc0") + 9
    cases["2 components"] = (cmyk.getvalue()[:i] + b"\x02" + cmyk.getvalue()[i + 1:],
                             "JPEG with 2 components")
    for name, (data, match) in cases.items():
        with pytest.raises(UnsupportedImage, match=match):
            jpeg.decode_jpeg(data, name)
        q = tmp_path / f"{name}.jpg"
        q.write_bytes(data)
        with pytest.raises(UnsupportedImage, match=f"{name}.jpg: {match}"):
            image.load_img_array(q)


def test_truncated_and_corrupt_files_are_undecodable(tmp_path):
    """A PNG, GIF or BMP cut short, and a JPEG cut before its first scan,
    give None from ``load_img_array`` and a ``ValueError`` from
    ``decode_image``, as cv2.imread gives None."""
    for name in ("png_rgb8_adam7.png", "gif_interlaced.gif", "bmp_24.bmp", "jpeg_420.jpg",
                 "jpeg_progressive.jpg"):
        data = (DATA / name).read_bytes()
        cut = data[: data.index(b"\xff\xda") - 40] if name.startswith("jpeg") else data[: len(data) // 2]
        path = tmp_path / f"cut_{name}"
        path.write_bytes(cut)
        assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None, name
        assert image.load_img_array(path) is None, name
        with pytest.raises(ValueError):
            image.decode_image(cut, name)
    # trailing bytes after EOI are ignored, as by cv2
    data = (DATA / "jpeg_progressive.jpg").read_bytes() + b"trailing"
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), np.load(DATA / "jpeg_progressive.npy"))
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x00" * 32)


def _sos_offsets(data: bytes) -> list[int]:
    return [i for i in range(len(data) - 1) if data[i: i + 2] == b"\xff\xda"]


@pytest.mark.parametrize("name", ["jpeg_420.jpg", "jpeg_444.jpg", "jpeg_grey.jpg",
                                  "jpeg_53x37_restart_1.jpg", "jpeg_low_quality.jpg",
                                  "jpeg_progressive.jpg", "jpeg_progressive_grey.jpg"])
def test_truncated_jpeg_decodes_as_cv2(tmp_path, name):
    """A JPEG cut inside or after its scans (the EOI marker missing, the
    entropy data ending mid-block, a segment cut short) decodes to what
    cv2.imread gives: libjpeg reads a fake EOI past the end of the file,
    zero bits where a scan runs out, and leaves the later blocks grey. The
    block where the bits ran out holds coefficients no encoder writes, so
    this also holds the IDCT's 16-bit lanes to libjpeg-turbo's. For a
    progressive file the cuts lie in its last scan, and one more inside its
    third, where libjpeg smooths the blocks."""
    data = (DATA / name).read_bytes()
    first = _sos_offsets(data)[-1 if "progressive" in name else 0]
    span = len(data) - first
    cuts = [len(data) - 2, len(data) - 1, first + 14, first + span // 3, first + 2 * span // 3]
    if "progressive" not in name:
        cuts.append(first + 5 + 2 * data[first + 4])  # at Ss: the fake EOI's bytes are read
    path = tmp_path / name
    for cut in cuts:
        path.write_bytes(data[:cut])
        want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        assert want is not None, cut
        np.testing.assert_array_equal(jpeg.decode_jpeg(data[:cut]), want, err_msg=f"cut {cut}")
        np.testing.assert_array_equal(image.load_img_array(path), jimage.load_img_array(path))
    if "progressive" in name:
        cut = data[: _sos_offsets(data)[2] + 40]
        path.write_bytes(cut)
        np.testing.assert_array_equal(jpeg.decode_jpeg(cut),
                                      cv2.imread(str(path), cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("name", ["jpeg_progressive.jpg", "jpeg_progressive_grey.jpg",
                                  "jpeg_progressive_444.jpg", "jpeg_cmyk_progressive.jpg"])
def test_progressive_cut_inside_each_scan_is_smoothed_as_cv2(tmp_path, name):
    """A progressive file cut inside any of its scans decodes as
    cv2.imread decodes it: libjpeg block-smooths the coefficients the
    later scans would refine, and the rows past the one where the cut
    scan's data ran out with the progression status from before that scan
    (the first scan's rows past it as the rest of that scan)."""
    data = (DATA / name).read_bytes()
    sos = _sos_offsets(data)
    path = tmp_path / name
    for k, start in enumerate(sos):
        end = sos[k + 1] if k + 1 < len(sos) else len(data) - 2
        for frac in (0.2, 0.5, 0.8):
            cut = data[: start + int((end - start) * frac)]
            path.write_bytes(cut)
            want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
            if want is None:  # cut inside the scan header
                continue
            np.testing.assert_array_equal(jpeg.decode_jpeg(cut), want,
                                          err_msg=f"scan {k}, {frac}")


def test_cmyk_conversion_uses_every_channel():
    """The 4-component fixtures are not degenerate: the CMYK decode has
    many colours, and the YCCK file (the same data, read as YCbCr + K)
    decodes to other pixels than the CMYK one."""
    cmyk = np.load(DATA / "jpeg_cmyk_adobe.npy")
    ycck = np.load(DATA / "jpeg_ycck.npy")
    assert cmyk.shape == ycck.shape == (37, 53, 3)
    assert (cmyk != ycck).mean() > 0.5
    assert len(np.unique(cmyk.reshape(-1, 3), axis=0)) > 100


def test_bad_rle_bmp_is_refused_as_cv2_refuses_it(tmp_path):
    """An RLE8 run past its row's end and RLE data that ends before the
    bitmap's last row make cv2.imread give None; the port raises
    ``ValueError`` for each and ``load_img_array`` gives None."""
    data = (DATA / "bmp_rle8.bmp").read_bytes()
    offset = int.from_bytes(data[10:14], "little")
    cases = {"past_row": data[:offset] + bytes([60, 1]) + data[offset:],
             "truncated": data[: offset + (len(data) - offset) // 2]}
    for label, bad in cases.items():
        p = tmp_path / f"{label}.bmp"
        p.write_bytes(bad)
        assert cv2.imread(str(p), cv2.IMREAD_UNCHANGED) is None, label
        with pytest.raises(ValueError, match="RLE"):
            image.decode_image(bad, p.name)
        assert image.load_img_array(p) is None, label


def _with_dht(data: bytes, **tables) -> bytes:
    """``data`` (from ``encode_jpeg``) with its one DHT segment rebuilt from
    ``jpeg.HUFFMAN`` with ``tables`` put in."""
    i = data.index(b"\xff\xc4")
    end = i + 2 + int.from_bytes(data[i + 2: i + 4], "big")
    huff = {**jpeg.HUFFMAN, **tables}
    body = b"".join(bytes([tc_th]) + bytes(huff[k][0]) + bytes(huff[k][1]) for tc_th, k in (
        (0x00, "dc_luma"), (0x10, "ac_luma"), (0x01, "dc_chroma"), (0x11, "ac_chroma")))
    return data[:i] + jpeg._marker(0xC4, body) + data[end:]


@pytest.mark.parametrize("case", ["3 codes of length 1", "over-full length 9",
                                  "all-ones code", "DC category 16"])
def test_bad_huffman_table_is_refused(tmp_path, case):
    """Code counts that overfill a length (which would index past the
    decoder's 9-bit lookahead tables), a code of all ones, and a DC symbol
    above 15 are refused, as libjpeg refuses them (cv2.imread gives None)."""
    dc = jpeg.HUFFMAN["dc_luma"]
    table = {
        "3 codes of length 1": {"dc_luma": ((3,) + (0,) * 15, bytes([0, 1, 2]))},
        "over-full length 9": {"ac_luma": ((1, 1, 0, 0, 0, 0, 0, 0, 200) + (0,) * 7,
                                           bytes(range(202)))},
        "all-ones code": {"dc_luma": ((2,) + (0,) * 15, bytes([0, 1]))},
        "DC category 16": {"dc_luma": (dc[0], bytes(list(range(11)) + [16]))},
    }[case]
    data = _with_dht(jpeg.encode_jpeg(_photo(16, 16, 1)), **table)
    path = tmp_path / "bad.jpg"
    path.write_bytes(data)
    assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(ValueError, match="bad Huffman table"):
        jpeg.decode_jpeg(data)
    assert image.load_img_array(path) is None


def test_compressed_bmp_raises(tmp_path):
    """A BMP holding a JPEG or a PNG raises ``UnsupportedImage`` naming its
    compression (RLE8 and RLE4 decode since their fixtures); uncompressed
    pixels relabelled RLE8 are walked as RLE8 codes, as cv2 walks them:
    both refuse the file, or both give the same pixels."""
    data = bytearray((DATA / "bmp_8_grey.bmp").read_bytes())
    for comp in (4, 5):
        data[30] = comp  # BI_JPEG, BI_PNG
        p = tmp_path / f"c{comp}.bmp"
        p.write_bytes(bytes(data))
        with pytest.raises(UnsupportedImage, match=f"c{comp}.bmp: BMP compression {comp} at 8 bits"):
            image.load_img_array(p)
    data[30] = 1  # BI_RLE8
    p = tmp_path / "rle.bmp"
    p.write_bytes(bytes(data))
    want = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
    if want is None:
        assert image.load_img_array(p) is None
        with pytest.raises(ValueError):
            image.decode_image(bytes(data), "rle.bmp")
    else:
        np.testing.assert_array_equal(image.decode_image(bytes(data), "rle.bmp"), want)
