"""The port's host IO against the JAX package's (which decodes with OpenCV):
the PNG codec against ``cv2.imread(IMREAD_UNCHANGED)`` for files written by
cv2 and PIL, ``load_img_array`` / ``image_size`` / ``to_segmask`` /
``load_segmap`` against JAX's, the JPEG encoder through cv2's decoder, the
dcz container byte for byte both ways, npy/npz/bl2, the Spectral LUT and
the grid resize against cv2's ``INTER_LINEAR``, and the port's ``utils``
name for name against JAX's.
"""

import zlib

import numpy as np
import pytest
import torch
import cv2
from PIL import Image

from depth_completion_tpu import utils as jutils
from depth_completion_tpu import viz as jviz
from depth_completion_tpu.io import codecs as jcodecs
from depth_completion_tpu.io import csvio as jcsvio
from depth_completion_tpu.io import image as jimage
from depth_completion_tpu_torch import utils, viz
from depth_completion_tpu_torch.io import codecs, csvio, image, jpeg, png
from scripts.make_torch_io_fixtures import write_png

SIZES = ((5, 7), (33, 17), (48, 64))


def _cv2_rgb(path):
    """cv2's decode, channels turned to the file's order (RGB[A])."""
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][: img.shape[2]]]
    return img


def _write_cases(tmp_path, h, w, rng):
    """(name, path) of files in every colour type and bit depth the decoder
    reads, written by cv2 and by PIL (PIL chooses a filter per row)."""
    g = rng.integers(0, 256, (h, w), dtype=np.uint8)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    g16 = rng.integers(0, 65536, (h, w), dtype=np.uint16)
    smooth = np.clip(np.cumsum(rng.integers(-3, 4, (h, w, 3)), axis=1) + 128, 0, 255)
    smooth = smooth.astype(np.uint8)
    cases = {
        "cv2_grey": (lambda p: cv2.imwrite(str(p), g)),
        "cv2_rgb": (lambda p: cv2.imwrite(str(p), rgb[..., ::-1])),
        "cv2_rgba": (lambda p: cv2.imwrite(str(p), rgba[..., [2, 1, 0, 3]])),
        "cv2_grey16": (lambda p: cv2.imwrite(str(p), g16)),
        "pil_grey": (lambda p: Image.fromarray(g).save(p)),
        "pil_rgb": (lambda p: Image.fromarray(smooth).save(p)),
        "pil_rgb_optimized": (lambda p: Image.fromarray(rgb).save(p, optimize=True)),
        "pil_rgba": (lambda p: Image.fromarray(rgba).save(p)),
        "pil_palette": (lambda p: Image.fromarray(smooth).convert(
            "P", palette=Image.ADAPTIVE, colors=64).save(p)),
        "pil_palette_trns": (lambda p: Image.fromarray(smooth).convert(
            "P", palette=Image.ADAPTIVE, colors=64).save(p, transparency=3)),
        "pil_grey_alpha": (lambda p: Image.fromarray(rgba[..., :2], "LA").save(p)),
        "pil_grey16": (lambda p: Image.fromarray(g16).save(p)),
    }
    out = []
    for name, write in cases.items():
        path = tmp_path / f"{name}_{h}x{w}.png"
        write(path)
        out.append((name, path))
    return out


@pytest.mark.parametrize("h,w", SIZES)
def test_png_decode_matches_cv2(tmp_path, h, w):
    rng = np.random.default_rng(h * w)
    for name, path in _write_cases(tmp_path, h, w, rng):
        want = _cv2_rgb(path)
        got = png.read_png(path)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("h,w", SIZES)
def test_png_writer_round_trips(tmp_path, h, w):
    rng = np.random.default_rng(1)
    for arr in (rng.integers(0, 256, (h, w), dtype=np.uint8),
                rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                rng.integers(0, 256, (h, w, 4), dtype=np.uint8),
                rng.integers(0, 65536, (h, w), dtype=np.uint16)):
        path = tmp_path / "o.png"
        png.write_png(arr, path)
        np.testing.assert_array_equal(png.read_png(path), arr)
        np.testing.assert_array_equal(_cv2_rgb(path), arr)
        assert image.image_size(path) == jimage.image_size(path) == (w, h)


def test_png_unsupported_raise_naming_the_file(tmp_path):
    """Adam7 and 1-bit PNGs, which raised before, decode as cv2 decodes
    them; a PNG header no decoder accepts (bit depth 3), a corrupt chunk
    and a stream whose interlace byte lies raise naming the file, and
    ``load_img_array`` gives None for them, as cv2 does."""
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    onebit = tmp_path / "onebit.png"
    Image.fromarray(rng.integers(0, 256, (16, 16), dtype=np.uint8)).convert("1").save(onebit)
    interlaced = tmp_path / "interlaced.png"
    write_png(interlaced, rgb, 2, 8, interlace=True)
    for path in (onebit, interlaced):
        np.testing.assert_array_equal(png.read_png(path), _cv2_rgb(path))
        np.testing.assert_array_equal(image.load_img_array(path), jimage.load_img_array(path))
    # the IHDR's interlace byte set to 1 on a non-interlaced stream, its CRC made anew
    data = bytearray(png.encode_png(rgb))
    data[28] = 1
    data[29:33] = zlib.crc32(bytes(data[12:29])).to_bytes(4, "big")
    liar = tmp_path / "liar.png"
    liar.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="liar.png: "):
        png.read_png(liar)
    assert image.load_img_array(liar) is None
    data = bytearray(png.encode_png(rgb))
    data[24] = 3  # bit depth 3
    data[29:33] = zlib.crc32(bytes(data[12:29])).to_bytes(4, "big")
    bad = tmp_path / "depth3.png"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="depth3.png: invalid PNG header.*bit depth 3"):
        png.read_png(bad)
    assert image.load_img_array(bad) is None
    data = bytearray(png.encode_png(np.ones((4, 4), np.uint8)))
    data[40] ^= 0xFF  # inside the IDAT chunk
    with pytest.raises(ValueError, match="corrupt PNG chunk"):
        png.decode_png(bytes(data))


@pytest.mark.parametrize("mode", [None, "RGB", "L"])
def test_load_img_array_matches_jax(tmp_path, mode):
    rng = np.random.default_rng(3)
    files = [p for _, p in _write_cases(tmp_path, 13, 21, rng)]
    zero = tmp_path / "zero.png"
    cv2.imwrite(str(zero), np.zeros((9, 11, 3), np.uint8))
    text = tmp_path / "notes.png"
    text.write_text("not an image")
    for path in files + [zero, text]:
        want = jimage.load_img_array(path, mode)
        got = image.load_img_array(path, mode)
        if want is None:
            assert got is None, path.name
            continue
        assert got.dtype == want.dtype and got.shape == want.shape, path.name
        np.testing.assert_array_equal(got, want, err_msg=path.name)
    assert jimage.load_img_array(zero, mode) is None


def test_image_size_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    paths = []
    for ext in (".png", ".jpg", ".bmp"):
        paths.append(tmp_path / f"a{ext}")
        cv2.imwrite(str(paths[-1]), img)
    paths.append(tmp_path / "a.gif")
    Image.fromarray(img).save(paths[-1])
    paths.append(tmp_path / "port.jpg")
    jpeg.write_jpeg(img, paths[-1])
    paths.append(tmp_path / "b.txt")
    paths[-1].write_text("hello world, not an image")
    for p in paths:
        assert image.image_size(p) == jimage.image_size(p), p.name
    assert image.image_size(tmp_path / "port.jpg") == (53, 37)


def test_jpeg_input_raises(tmp_path):
    """A JPEG input, which raised before the port had a decoder, now
    decodes as the JAX package decodes it (tests/test_torch_jpeg.py holds
    the decoder to cv2 in detail); an arithmetic-coded one raises naming
    its SOF."""
    p = tmp_path / "frame.jpg"
    cv2.imwrite(str(p), np.full((8, 8, 3), 100, np.uint8))
    np.testing.assert_array_equal(image.load_img_array(p, "RGB"), jimage.load_img_array(p, "RGB"))
    data = bytearray(p.read_bytes())
    i = data.index(b"\xff\xc0")
    data[i + 1] = 0xC9
    p.write_bytes(bytes(data))
    with pytest.raises(jpeg.UnsupportedImage, match=r"frame.jpg: arithmetic-coded JPEG \(SOF9\)"):
        image.load_img_array(p, "RGB")


def _psnr(a, b):
    return 10 * np.log10(255.0**2 / np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))


def test_jpeg_grid_psnr(tmp_path):
    """Vis grids of 512x2039 at quality 95 through the port's encoder and
    cv2's decoder. A Spectral depth grid (sparse | dense | a second dense
    view) reads >= 35 dB (measured 39.6 dB; cv2's own encoder 39.6 dB). The
    CLI's grid with a noisy random-walk photo in front (image | sparse |
    dense) is dominated by the photo's high frequencies: 31.3 dB from
    either encoder, and the port's must stay within 0.1 dB of cv2's (the
    same tables and 4:2:0 sampling; libjpeg's integer colour conversion and
    DCT round otherwise)."""
    rng = np.random.default_rng(5)
    h, w = 480, 640
    yy, xx = np.mgrid[0:h, 0:w]
    dense = (5 + 40 * (yy / h) + 10 * np.sin(xx / 37.0))[..., None].astype(np.float32)
    dense2 = (60 - 50 * (xx / w) + 5 * np.cos(yy / 23.0))[..., None].astype(np.float32)
    sparse = np.where(rng.random((h, w, 1)) < 0.01, dense, 0).astype(np.float32)
    photo = np.clip(np.cumsum(rng.integers(-2, 3, (h, w, 3)), axis=1) + 128, 0, 255)
    sparse_vis = viz.visualize_depth(sparse[None], 120.0)[0]
    sparse_vis[sparse[..., 0] <= 0] = 0
    dense_vis = [viz.visualize_depth(d[None], 120.0)[0] for d in (dense, dense2)]
    readings = []
    for views in ([sparse_vis, *dense_vis], [photo.astype(np.uint8), sparse_vis, dense_vis[0]]):
        grid = viz.make_grid(views, resize=(512, -1))
        assert grid.shape == (512, 2039, 3)
        path = tmp_path / "grid_vis.jpg"
        image.save_img_array(grid, path)
        assert image.image_size(path) == (2039, 512)
        port_psnr = _psnr(cv2.imread(str(path))[..., ::-1], grid)
        ok, ref = cv2.imencode(".jpg", grid[..., ::-1])
        readings.append((port_psnr, _psnr(cv2.imdecode(ref, cv2.IMREAD_COLOR)[..., ::-1], grid)))
    (depth_port, depth_cv2), (full_port, full_cv2) = readings
    assert depth_port >= 35.0, readings
    assert abs(depth_port - depth_cv2) < 0.1 and abs(full_port - full_cv2) < 0.1, readings


def test_jpeg_odd_sizes_and_grey(tmp_path):
    rng = np.random.default_rng(6)
    for h, w in ((2, 3), (8, 8), (9, 17), (31, 33)):
        img = np.clip(np.cumsum(rng.integers(-4, 5, (h, w, 3)), axis=0) + 128, 0, 255)
        img = img.astype(np.uint8)
        dec = cv2.imdecode(np.frombuffer(jpeg.encode_jpeg(img), np.uint8), cv2.IMREAD_COLOR)
        assert dec.shape == (h, w, 3)
        assert _psnr(dec[..., ::-1], img) > 30.0, (h, w)
    grey = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    dec = cv2.imdecode(np.frombuffer(jpeg.encode_jpeg(grey), np.uint8), cv2.IMREAD_GRAYSCALE)
    assert dec.shape == (16, 16)


def test_dcz_byte_identical_both_ways(tmp_path):
    rng = np.random.default_rng(7)
    depth = np.zeros((48, 64, 1), np.float32)
    mask = rng.random((48, 64, 1)) < 0.3
    depth[mask] = rng.uniform(1, 100, mask.sum()).astype(np.float32)
    for x in (depth, rng.normal(size=(3, 5)).astype(np.float64),
              rng.integers(0, 1000, (7,)).astype(np.uint16)):
        a, b = tmp_path / "port.dcz", tmp_path / "jax.dcz"
        codecs.save_array(x, a, compress="dcz")
        jcodecs.save_array(x, b, compress="dcz")
        assert a.read_bytes() == b.read_bytes()
        for got in (codecs.load_array(b), jcodecs.load_array(a)):
            assert got.dtype == x.dtype
            np.testing.assert_array_equal(got, x)


def test_npy_npz_and_upcast(tmp_path):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(6, 7, 1)).astype(np.float32)
    for fmt in ("npy", "npz"):
        p = tmp_path / f"a.{fmt}"
        codecs.save_array(x, p, compress=fmt)
        np.testing.assert_array_equal(codecs.load_array(p), x)
        np.testing.assert_array_equal(jcodecs.load_array(p), x)
        q = tmp_path / f"j.{fmt}"
        jcodecs.save_array(x, q, compress=fmt)
        np.testing.assert_array_equal(codecs.load_array(q), x)
    t = torch.from_numpy(x).to(torch.bfloat16)
    codecs.save_array(t, tmp_path / "bf16.dcz", compress="dcz")
    got = codecs.load_array(tmp_path / "bf16.dcz")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, t.float().numpy())
    codecs.save_array(x.astype(np.float16), tmp_path / "f16.npy", compress="npy")
    assert codecs.load_array(tmp_path / "f16.npy").dtype == np.float32
    codecs.save_array(x, tmp_path / "a.bl2", compress="bl2")  # raised before the bl2 codec
    np.testing.assert_array_equal(jcodecs.load_array(tmp_path / "a.bl2"), x)
    with pytest.raises(ValueError, match="Invalid extension"):
        codecs.save_array(x, tmp_path / "a.npy", compress="dcz")


def test_spectral_lut_exact():
    np.testing.assert_array_equal(viz.SPECTRAL_LUT, jviz._spectral_lut())
    d = np.linspace(-5, 130, 97, dtype=np.float32).reshape(1, 97, 1, 1)
    np.testing.assert_array_equal(viz.visualize_depth(d, 120.0, 1.0),
                                  jviz.visualize_depth(d, 120.0, 1.0))


@pytest.mark.parametrize("h,w,resize", [
    (48, 64, (512, -1)),  # the CLI's default, upscaled
    (37, 53, (20, -1)),  # downscaled, ragged
    (100, 100, (-1, 333)),
    (64, 64, (31, 47)),
])
def test_make_grid_resize_within_one_lsb(h, w, resize):
    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(3)]
    want = jviz.make_grid(imgs, resize=resize)
    got = viz.make_grid(imgs, resize=resize)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(viz.make_grid(imgs), jviz.make_grid(imgs))


def test_segmap_and_segmask_match_jax(tmp_path):
    csv = tmp_path / "map.csv"
    csv.write_text("id,name,r,g,b\n0,void,0,0,0\n2,car,10,20,30\n1,road,128,64,128\n\n")
    want = jcsvio.load_segmap(csv)
    assert csvio.load_segmap(csv) == want
    rng = np.random.default_rng(10)
    colors = np.array(want["color"], np.uint8)
    imgs = colors[rng.integers(0, 3, (2, 9, 11))]
    imgs[0, 0, 0] = (1, 2, 3)  # no class
    np.testing.assert_array_equal(image.to_segmask(imgs, want["color"]),
                                  jimage.to_segmask(imgs, want["color"]))
    np.testing.assert_array_equal(image.to_depth(imgs, max_distance=80.0),
                                  jimage.to_depth(imgs, max_distance=80.0))


def test_has_nan_takes_tensors():
    assert viz.has_nan(torch.tensor([1.0, float("nan")]))
    assert not viz.has_nan(np.zeros(3))


def test_utils_names_match_jax(tmp_path):
    """Every public name of JAX's ``utils`` exists in the port's and agrees
    on a seeded input."""
    assert set(utils.__all__) == set(jutils.__all__)
    for name in jutils.__all__:
        assert hasattr(utils, name), name
    rng = np.random.default_rng(11)
    preds, targets = rng.uniform(0, 80, (2, 9, 11, 1)), rng.uniform(0, 80, (2, 9, 11, 1))
    masks = rng.random((2, 9, 11, 1)) < 0.4
    for fn in ("mae", "rmse"):
        assert getattr(utils, fn)(preds, targets, masks) == pytest.approx(
            getattr(jutils, fn)(preds, targets, masks), rel=1e-12)
        assert getattr(utils, fn)(preds, targets) == pytest.approx(
            getattr(jutils, fn)(preds, targets), rel=1e-12)
    assert utils.EPSILON == jutils.EPSILON
    assert utils.filterout([1, 2, 3], [True, False, True]) == jutils.filterout(
        [1, 2, 3], [True, False, True]) == [1, 3]
    with pytest.raises(ValueError):
        utils.filterout([1], [])
    assert utils.CommaSeparated(int, 3)("1,2,3") == jutils.CommaSeparated(int, 3).convert(
        "1,2,3", None, None) == [1, 2, 3]
    assert utils.CommaSeparated(float).convert("0.5,2") == [0.5, 2.0]
    np.testing.assert_array_equal(utils.calc_bins(0.0, 120.0, 10.0),
                                  jutils.calc_bins(0.0, 120.0, 10.0))
    x = rng.normal(size=(3, 40)).astype(np.float32)
    m = rng.random((3, 40)) < 0.6
    for got, want in zip(utils.masked_minmax(torch.from_numpy(x), torch.from_numpy(m)),
                         jutils.masked_minmax(x, m)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(
        utils.masked_quantile(torch.from_numpy(x), torch.from_numpy(m), [0.1, 0.5, 0.9]).numpy(),
        np.asarray(jutils.masked_quantile(x, m, np.asarray([0.1, 0.5, 0.9], np.float32))),
        rtol=1e-6, atol=1e-6)
    for mode in ("simple", "strict"):
        np.testing.assert_allclose(utils.kld_stdnorm(torch.from_numpy(x), mode=mode).numpy(),
                                   np.asarray(jutils.kld_stdnorm(x, mode=mode)), rtol=1e-6)
    d = rng.uniform(0, 120, (1, 6, 7, 1)).astype(np.float32)
    np.testing.assert_array_equal(utils.visualize_depth(d, 120.0), jutils.visualize_depth(d, 120.0))
    assert utils.has_nan(np.array([np.nan])) and jutils.has_nan(np.array([np.nan]))
    img = rng.integers(1, 255, (9, 11, 3), dtype=np.uint8)
    utils.save_img_array(img, tmp_path / "a.png")
    np.testing.assert_array_equal(utils.load_img_array(tmp_path / "a.png"),
                                  jutils.load_img_array(tmp_path / "a.png"))
    assert utils.image_size(tmp_path / "a.png") == jutils.image_size(tmp_path / "a.png")
    utils.save_array(d, tmp_path / "d.bl2", compress="bl2")
    np.testing.assert_array_equal(jutils.load_array(tmp_path / "d.bl2"), d)
    assert utils.NPARRAY_EXTS == jutils.NPARRAY_EXTS
    for name in ("DATASET_DIR_NAME_IMAGE", "DATASET_DIR_NAME_SEGMASK", "DATASET_DIR_NAME_SPARSE",
                 "RESULT_DIR_NAME_DENSE", "RESULT_DIR_NAME_VIS"):
        assert getattr(utils, name) == getattr(jutils, name)
