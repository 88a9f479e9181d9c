"""The port's ``cli.predict`` and ``cli.analyze`` against the JAX package's
click CLIs: the parsed options for a matrix of argv, both CLIs end to end
on one HF-layout checkpoint directory and one dataset, the analyzer's
``results_all.json``, ``--resume`` (per frame and the temporal carry), the
sampler's modes (per-input, KLD, ensembles, ``--model lcm``), and the flags
whose path is not ported.

Geometry: the tiny UNet, KL VAE and text tower (``--vae original``), a
3-frame 48x64 dataset, ``--steps 2 --res 64 --precision fp32 --batch-size
2``: the JAX CLI pads its second batch, the port's runs one row. Both
samplers run the fused epilogue (``DCT_EPILOGUE=on`` on the JAX side), as
tests/test_torch_checkpoint.py's end-to-end request does.
"""

import json

import click
import numpy as np
import pytest
import torch

from depth_completion_tpu.cli.analyze import main as j_analyze
from depth_completion_tpu.cli.predict import main as j_predict
from depth_completion_tpu.io import codecs as jcodecs
from depth_completion_tpu.io.image import save_img_array as j_save_img
from depth_completion_tpu_torch.cli import analyze, predict
from depth_completion_tpu_torch.io import codecs
from depth_completion_tpu_torch.io import image as codecs_image

from tests.test_torch_checkpoint import _write_tiny_kl_checkpoint

TINY = ["--steps", "2", "--res", "64", "--precision", "fp32", "--batch-size", "2",
        "--compress", "dcz", "--vae", "original", "--model", "original"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _dataset(root, n=3):
    ds = root / "scene"
    rng = np.random.default_rng(0)
    for i in range(n):
        img = rng.integers(1, 255, size=(48, 64, 3)).astype(np.uint8)
        j_save_img(img, ds / "image" / f"{i:05d}.png")
        sparse = np.zeros((48, 64, 3), np.uint8)
        mask = rng.random((48, 64)) < 0.05
        sparse[mask, 0] = rng.integers(10, 250, mask.sum()).astype(np.uint8)
        sparse[..., 1] = rng.integers(0, 255, (48, 64))  # ignored: depth is channel 0
        j_save_img(sparse, ds / "sparse" / f"{i:05d}.png")
    return root


PREDICT_ARGV = [
    [],
    *[["--vis", w] for w in ("1", "true", "T", "Yes", "y", "ON", "0", "False", "f", "NO",
                             "n", "off")],
    ["-vr", "512", "-1"],
    ["--vis-res", "256", "320", "--save-dense", "false"],
    ["-vo", "image,foo,dense", "--loss-funcs", "l1,bogus,edge"],
    ["--percentile", "0.05,0.95", "--norm", "percentile", "--projection", "log", "--inv", "t"],
    ["--percentile", ""],
    ["-n", "7", "-r", "512", "-p", "fp32", "-c", "npz", "-bs", "3", "--beta", "0.5",
     "--use-prev-latent", "yes", "--opt", "sgd", "--lr-latent", "0.1", "--lr-scaling", "0.2",
     "--min-depth", "0.5", "--max-depth", "80", "--max-sparse-depth", "90",
     "--compile-effort", "-1.0", "--compile-graph", "on", "--compile-mode", "default",
     "--shard-index", "1", "--num-shards", "2", "--resume", "1", "--ensemble", "3",
     "--ensemble-reduce", "aligned-mean", "--ensemble-uncertainty", "y", "--mesh-model", "2",
     "--native-res", "1", "--fast-guidance", "1", "--multihost", "0", "--model", "lcm",
     "--checkpoint-dir", "ckpt", "--taesd-dir", "taesd", "--log", "x.log",
     "--log-level", "DEBUG", "--profile-dir", "prof", "--kld", "y", "--kld-mode", "strict",
     "--kld-weight", "0.3", "--use-segmask", "1", "--closed-form", "1", "--train-latents",
     "0", "--train-method", "per-input", "--train-steps", "4", "--interp-mode", "nearest"],
]
PREDICT_BAD = [
    ["--steps", "0"], ["--res", "-3"], ["--max-depth", "0"], ["--lr-latent", "0"],
    ["--min-depth", "-1"], ["--compile-effort", "1.5"], ["--compile-effort", "-2"],
    ["--shard-index", "-1"], ["--percentile", "a,b"], ["--vis", "maybe"],
    ["--model", "foo"], ["--compress", "zip"], ["-vr", "512"], ["--batch-size", "1.5"],
]


@pytest.mark.parametrize("argv", PREDICT_ARGV, ids=lambda a: " ".join(a)[:40] or "defaults")
def test_predict_options_match_click(tmp_path, argv):
    argv = [str(tmp_path), str(tmp_path / "out"), *argv]
    want = j_predict.make_context("predict", list(argv)).params
    _, got = predict.parse_args(list(argv))
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("argv", PREDICT_BAD, ids=lambda a: " ".join(a))
def test_predict_bad_options_fail_on_both_sides(tmp_path, argv):
    argv = [str(tmp_path), str(tmp_path / "out"), *argv]
    with pytest.raises(click.UsageError):
        j_predict.make_context("predict", list(argv))
    with pytest.raises(SystemExit) as e:
        predict.parse_args(list(argv))
    assert e.value.code == 2


@pytest.mark.parametrize("argv", [
    [], ["--metrics", "mae,foo", "--calc-binned-scores", "F", "--bin-size", "2.5"],
    ["-bs", "4", "-nt", "2", "--accel", "off", "--gt-dir", "groundtruth", "--gt-format",
     "png8", "--min-depth", "1", "--max-depth", "80", "--max-sparse-depth", "85",
     "--log-level", "WARNING", "--log", "a.log"],
], ids=["defaults", "metrics", "all"])
def test_analyze_options_match_click(tmp_path, argv):
    argv = [str(tmp_path), str(tmp_path), *argv]
    want = j_analyze.make_context("analyze", list(argv)).params
    got = vars(analyze.build_parser().parse_args(list(argv)))
    assert got.pop("device") == "cuda"
    assert got == want
    for bad in (["--bin-size", "0"], ["-bs", "0"], ["--gt-format", "exr"]):
        with pytest.raises(click.UsageError):
            j_analyze.make_context("analyze", [*argv, *bad])
        with pytest.raises(SystemExit):
            analyze.build_parser().parse_args([*argv, *bad])
    with pytest.raises(click.UsageError):
        j_analyze.make_context("analyze", [str(tmp_path / "missing"), str(tmp_path)])
    with pytest.raises(SystemExit):
        analyze.build_parser().parse_args([str(tmp_path / "missing"), str(tmp_path)])


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    _write_tiny_kl_checkpoint(root)
    return root


def _dense(out, fmt="dcz", reader=codecs.load_array):
    return np.stack([reader(p) for p in sorted((out / "scene" / "dense").glob(f"*.{fmt}"))])


def test_both_clis_on_one_checkpoint(tmp_path, checkpoint, monkeypatch):
    """Both predict CLIs on one checkpoint directory and dataset: dense maps
    of (48, 64, 1) within the KL path's tolerance (relative to the 120 m
    range: sound readings rms 1.5e-7, max 7.0e-7; the port with a
    UNet-detached gradient, ``--fast-guidance``, rms 1.0e-2, max 5.8e-2;
    limits rms 1e-5, max 1e-4), each side's dcz read by the other, three vis
    grids each; then both analyze CLIs on each side's outputs: the same
    ``results_all.json`` to 1e-6 through each one's accelerated scorer,
    and exactly through the host path."""
    monkeypatch.setenv("DCT_EPILOGUE", "on")
    data = _dataset(tmp_path / "data")
    argv = [*TINY, "--checkpoint-dir", str(checkpoint)]
    with pytest.raises(SystemExit) as e:
        j_predict([str(data), str(tmp_path / "jax"), *argv], standalone_mode=True)
    assert e.value.code in (0, None)
    totals = predict.main([str(data), str(tmp_path / "port"), *argv, "--device", "cpu"])
    assert totals["frames"] == 3 and totals["dense_bytes"] > 0

    d_port, d_jax = _dense(tmp_path / "port"), _dense(tmp_path / "jax")
    assert d_port.shape == d_jax.shape == (3, 48, 64, 1) and d_port.dtype == np.float32
    np.testing.assert_array_equal(_dense(tmp_path / "jax", reader=jcodecs.load_array), d_jax)
    np.testing.assert_array_equal(_dense(tmp_path / "port", reader=jcodecs.load_array), d_port)
    diff = (d_port - d_jax) / 120.0
    rms = float(np.sqrt(np.mean(diff**2)))
    assert rms < 1e-5 and np.abs(diff).max() < 1e-4, (rms, np.abs(diff).max())
    for side in ("jax", "port"):
        assert len(list((tmp_path / side / "scene" / "vis").glob("*_vis.jpg"))) == 3

    for accel, tol in (("true", 1e-6), ("false", 0.0)):
        for side in ("port", "jax"):
            out = tmp_path / side
            with pytest.raises(SystemExit) as e:
                j_analyze([str(data), str(out), "--accel", accel], standalone_mode=True)
            assert e.value.code in (0, None)
            want = json.loads((out / "results_all.json").read_text())
            got = analyze.main([str(data), str(out), "--accel", accel, "--device", "cpu"])
            assert json.loads((out / "results_all.json").read_text()) == json.loads(
                json.dumps(got))
            assert len(got["binned"]) == 12 and np.isfinite(got["overall"]["mae"])
            _assert_results_close(got, want, tol)


def test_both_clis_on_jpeg_frames_with_bl2(tmp_path, checkpoint, monkeypatch):
    """JPEG frames in (the port's encoder, decoded by cv2 on the JAX side
    and by the port's decoder), ``--compress bl2`` out (``--compress bl2``
    raised before the port had a codec): dense maps within the tolerance
    of ``test_both_clis_on_one_checkpoint`` (rms 1e-5, max 1e-4 of 120 m),
    each side's ``.bl2`` read by the other, and the analyze CLI's
    ``--gt-format array`` reading the JAX side's ``.bl2`` maps."""
    from depth_completion_tpu_torch.io.jpeg import write_jpeg

    monkeypatch.setenv("DCT_EPILOGUE", "on")
    data = _dataset(tmp_path / "data", n=2)
    for p in sorted((data / "scene" / "image").glob("*.png")):
        write_jpeg(codecs_image.load_img_array(p, "RGB"), p.with_suffix(".jpg"))
        p.unlink()
    argv = [*TINY[:-6], "--compress", "bl2", "--vae", "original", "--model", "original",
            "--checkpoint-dir", str(checkpoint)]
    with pytest.raises(SystemExit) as e:
        j_predict([str(data), str(tmp_path / "jax"), *argv], standalone_mode=True)
    assert e.value.code in (0, None)
    assert predict.main([str(data), str(tmp_path / "port"), *argv, "--device", "cpu"])[
        "frames"] == 2
    d_port, d_jax = _dense(tmp_path / "port", "bl2"), _dense(tmp_path / "jax", "bl2")
    assert d_port.shape == d_jax.shape == (2, 48, 64, 1) and d_port.dtype == np.float32
    np.testing.assert_array_equal(_dense(tmp_path / "port", "bl2", jcodecs.load_array), d_port)
    np.testing.assert_array_equal(_dense(tmp_path / "jax", "bl2", codecs.load_array), d_jax)
    diff = (d_port - d_jax) / 120.0
    rms = float(np.sqrt(np.mean(diff**2)))
    assert rms < 1e-5 and np.abs(diff).max() < 1e-4, (rms, np.abs(diff).max())
    # the JAX side's dense maps as array ground truth for the port's analyzer
    gt = data / "scene" / "gt"
    gt.mkdir()
    for p in sorted((tmp_path / "jax" / "scene" / "dense").glob("*.bl2")):
        (gt / p.name).write_bytes(p.read_bytes())
    got = analyze.main([str(data), str(tmp_path / "port"), "--gt-dir", "gt", "--gt-format",
                        "array", "--device", "cpu"])
    valid = d_jax > 0
    assert got["overall"]["mae"] == pytest.approx(
        float(np.abs(d_port - d_jax)[valid].mean()), rel=1e-3, abs=1e-6)


def _assert_results_close(got, want, tol):
    assert got.keys() == want.keys()
    for m, v in want["overall"].items():
        np.testing.assert_allclose(got["overall"][m], v, rtol=tol, atol=tol)
    for g, w in zip(got["binned"], want["binned"], strict=True):
        assert list(g["range"]) == list(w["range"])
        np.testing.assert_allclose(g["percentage"], w["percentage"], rtol=tol, atol=tol)
        for m, v in w["metrics"].items():
            np.testing.assert_allclose(g["metrics"][m], v, rtol=tol, atol=tol)


def test_resume_skips_done_frames(tmp_path, monkeypatch):
    """--resume runs only the frames whose dense file is missing;
    --profile-dir writes a Chrome trace of the first batch; a shard runs
    every num_shards-th frame."""
    monkeypatch.setenv("DCT_RANDOM_MODEL_SIZE", "tiny")
    data = _dataset(tmp_path / "data")
    out = tmp_path / "out"
    argv = [str(data), str(out), "--model", "random", "--steps", "1", "--res", "64",
            "--precision", "fp32", "--compress", "npy", "--vis", "false", "--device", "cpu"]
    assert predict.main([*argv, "--profile-dir", str(tmp_path / "prof")])["frames"] == 3
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    first = _dense(out, "npy")
    (out / "scene" / "dense" / "00001.npy").unlink()
    assert predict.main([*argv, "--resume", "true"])["frames"] == 1
    np.testing.assert_array_equal(_dense(out, "npy"), first)
    assert predict.main([*argv, "--resume", "true"])["frames"] == 0
    shard = tmp_path / "shard"
    assert predict.main([str(data), str(shard), *argv[2:], "--num-shards", "2",
                         "--shard-index", "1"])["frames"] == 1
    assert [p.name for p in (shard / "scene" / "dense").iterdir()] == ["00001.npy"]


def test_temporal_resume_restores_the_carry(tmp_path, monkeypatch):
    """--use-prev-latent writes latent_state.npz after every frame; a
    resumed run skips the frames done and starts from their latents: frame
    2 of a run resumed after frames 0-1 equals frame 2 of one run over all
    three."""
    monkeypatch.setenv("DCT_RANDOM_MODEL_SIZE", "tiny")
    data = _dataset(tmp_path / "data")
    opts = ["--model", "random", "--steps", "1", "--res", "64", "--precision", "fp32",
            "--compress", "npy", "--vis", "false", "--use-prev-latent", "true",
            "--device", "cpu"]
    assert predict.main([str(data), str(tmp_path / "full"), *opts])["frames"] == 3
    full = _dense(tmp_path / "full", "npy")
    state = np.load(tmp_path / "full" / "scene" / "latent_state.npz")
    assert str(state["frame_name"]) == "00002.png" and state["latents"].shape[0] == 1

    part = tmp_path / "part"
    last = data / "scene"
    hidden = {sub: (last / sub / "00002.png").read_bytes() for sub in ("image", "sparse")}
    for sub in hidden:
        (last / sub / "00002.png").unlink()
    assert predict.main([str(data), str(part), *opts])["frames"] == 2
    for sub, raw in hidden.items():
        (last / sub / "00002.png").write_bytes(raw)
    assert predict.main([str(data), str(part), *opts, "--resume", "true"])["frames"] == 1
    np.testing.assert_array_equal(_dense(part, "npy"), full)
    # without the carry frame 2 comes out otherwise
    (part / "scene" / "latent_state.npz").unlink()
    (part / "scene" / "dense" / "00002.npy").unlink()
    for sub in ("image", "sparse"):
        for i in (0, 1):
            (last / sub / f"{i:05d}.png").unlink()
    predict.main([str(data), str(part), *opts])
    assert not np.array_equal(_dense(part, "npy")[2], full[2])


@pytest.mark.parametrize("flags", [
    ["--train-method", "per-input", "--train-steps", "2", "--closed-form", "false"],
    ["--kld", "true", "--kld-mode", "strict", "--kld-weight", "0.3"],
    ["--ensemble", "3", "--ensemble-uncertainty", "true", "--ensemble-reduce", "aligned-median"],
], ids=["per-input", "kld", "ensemble"])
def test_sampler_modes_run(tmp_path, monkeypatch, flags):
    """Per-input training, the KLD penalty and a 3-member ensemble with its
    uncertainty through ``cli.predict`` on the tiny random bundle: finite
    (48, 64, 1) dense maps for every frame, and for the ensemble an
    uncertainty map (>= 0) beside each under ``uncertainty/``."""
    monkeypatch.setenv("DCT_RANDOM_MODEL_SIZE", "tiny")
    data = _dataset(tmp_path / "data", n=2)
    out = tmp_path / "out"
    totals = predict.main([str(data), str(out), "--model", "random", "--steps", "1", "--res",
                           "64", "--precision", "fp32", "--compress", "npy", "--vis", "false",
                           "--device", "cpu", *flags])
    dense = _dense(out, "npy")
    assert totals["frames"] == 2 and dense.shape == (2, 48, 64, 1) and np.isfinite(dense).all()
    uncs = sorted((out / "scene" / "uncertainty").glob("*.npy"))
    assert len(uncs) == (2 if "--ensemble" in flags else 0)
    for p in uncs:
        unc = codecs.load_array(p)
        assert unc.shape == (48, 64, 1) and np.isfinite(unc).all() and (unc >= 0).all()


def test_lcm_model_runs(tmp_path, checkpoint, monkeypatch):
    """``--model lcm`` loads the checkpoint directory as ``original`` does
    and samples with the LCM scheduler (training forced off, closed-form
    affine): finite dense maps, and the scheduler the pipeline got."""
    seen = []
    call = predict.DepthCompletionPipeline.__call__

    def spy(self, *args, **kwargs):
        seen.append((kwargs["scheduler"], kwargs["train_latents"], kwargs["closed_form"]))
        return call(self, *args, **kwargs)

    monkeypatch.setattr(predict.DepthCompletionPipeline, "__call__", spy)
    data = _dataset(tmp_path / "data", n=1)
    out = tmp_path / "out"
    argv = [*TINY, "--checkpoint-dir", str(checkpoint), "--model", "lcm", "--steps", "3",
            "--compress", "npy", "--vis", "false", "--device", "cpu"]
    assert predict.main([str(data), str(out), *argv])["frames"] == 1
    dense = _dense(out, "npy")
    assert dense.shape == (1, 48, 64, 1) and np.isfinite(dense).all()
    assert seen == [("lcm", False, True)]


def test_native_res_and_device_errors(tmp_path):
    data = _dataset(tmp_path / "data", n=1)
    with pytest.raises(SystemExit) as e:
        predict.main([str(data), str(tmp_path / "out"), "--device", "cpu", "--native-res", "1"])
    assert e.value.code == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            predict.main([str(data), str(tmp_path / "out")])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            analyze.main([str(data), str(data)])
