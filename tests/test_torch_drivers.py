"""The port's configuration drivers (``scripts/bench_nativeres_torch.py``,
``frontier_torch.py``, ``bench_kitti_torch.py``, ``bench_scaling_torch.py``)
on the CPU at tiny geometry: the frontier's figures against the same
figures computed from the JAX package's ``guided_sample`` on the same
weights (``from_jax_params``) and frames, kitti-native-ring1 against
kitti-native, bench_kitti as a subprocess and its parser, bench_scaling's
n = 1 rows and its launcher, and each driver's refusal without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_completion_tpu.models import registry as jreg
from depth_completion_tpu.models.bundle import VAE as JVAE
from depth_completion_tpu.models.bundle import ModelBundle as JBundle
from depth_completion_tpu.pipeline import sampler as JS
from depth_completion_tpu_torch.models import registry
from depth_completion_tpu_torch.models.weights import from_jax_params
from depth_completion_tpu_torch.ops import conv3x3 as c3
from depth_completion_tpu_torch.ops import flash_attention as fa
from depth_completion_tpu_torch.ops import ring_attention as ra
from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline
from scripts import bench_kitti_torch as kitti
from scripts import bench_nativeres_torch as nativeres
from scripts import bench_scaling_torch as scaling
from scripts import frontier_torch as frontier
from scripts.drivers_torch import synthetic_frames

from tests.test_torch_weights import tiny_jax_trees

REPO = Path(__file__).resolve().parents[1]
FRAME, RES, BATCH, STEPS, POINTS = (48, 64), 64, 2, 2, 64


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small CPU shapes: two threads, restored after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bundles():
    # seed 3 (tests/test_torch_sampler.py's): its decoded depth lies inside
    # the guidance range at norm="const", max_depth=120, so the guidance
    # trains and fast guidance drifts from the reference (at seed 5 the
    # decode clamps to 0 and every mode's map is the same)
    unet_np, taesd_np, ctx = tiny_jax_trees(seed=3)
    jbundle = JBundle(
        unet_params=jax.tree.map(jnp.asarray, unet_np), unet_config=jreg.TINY_UNET_CONFIG,
        vae=JVAE(kind="tiny", params=jax.tree.map(jnp.asarray, taesd_np),
                 config=jreg.TINY_TAESD_CONFIG),
        text_context=jnp.asarray(ctx))
    tbundle = from_jax_params(unet_np, taesd_np, ctx, unet_config=registry.TINY_UNET_CONFIG,
                              vae_config=registry.TINY_TAESD_CONFIG, device="cpu")
    return jbundle, tbundle


def test_frontier_figures_match_jax(bundles):
    """full-50 and fast-50 (at 2 steps) through the frontier's ``sweep``
    against the same figures from JAX's ``guided_sample`` outputs (the same
    default seed, so the same threefry noise). Tolerance model of
    tests/test_pipeline_parity.py: guidance through the UNet, so a
    statistical bound, ≥3x above the cross-framework floor and ≥3x below
    an injected bug's drift. Measured at this geometry: dense maps differ by
    rms 2.6e-6 m, max 1.5e-5 m; the figures by ≤ 7.7e-6 m. The injected bug
    is fast guidance itself: 0.167 m of MAE against full-50. Bound: 1e-3 m on
    every figure (≥100x the floor, 167x below the bug) and 1e-4 m rms on
    the maps."""
    jbundle, tbundle = bundles
    images, sparse = synthetic_frames(BATCH, *FRAME, POINTS)
    modes = {k: v for k, v in frontier.make_modes(STEPS, RES).items()
             if k in ("full-50", "fast-50")}
    rows = {r["mode"]: r for r in frontier.sweep(tbundle, modes, images, sparse, repeats=1)}

    fn = jax.jit(JS.guided_sample, static_argnames=("cfg",))
    outs = {name: np.asarray(fn(jbundle, jnp.asarray(images), jnp.asarray(sparse),
                                JS.SamplerConfig(**cfg))[0]) for name, cfg in modes.items()}
    valid = sparse > 0
    want = {name: {"anchor_mae_m": float(np.abs(o[valid] - sparse[valid]).mean())}
            for name, o in outs.items()}
    diff = outs["fast-50"] - outs["full-50"]
    want["fast-50"]["mae_vs_full_m"] = float(np.abs(diff).mean())
    want["fast-50"]["rmse_vs_full_m"] = float(np.sqrt((diff**2).mean()))

    assert rows["full-50"].get("is_reference") and "mae_vs_full_m" not in rows["full-50"]
    assert "is_reference" not in rows["fast-50"]
    for name, figures in want.items():
        for key, value in figures.items():
            assert abs(rows[name][key] - value) < 1e-3, (name, key, rows[name][key], value)
    assert want["fast-50"]["mae_vs_full_m"] > 0.05  # the drift this test must see
    pipe = DepthCompletionPipeline(tbundle)
    for name, cfg in modes.items():
        d = pipe(images, sparse, **cfg)[0].numpy() - outs[name]
        assert np.sqrt(np.mean(d**2)) < 1e-4, name


def test_frontier_reference_is_full_50_only(bundles):
    """Without full-50 no mode becomes the reference and no row has drift
    keys."""
    _, tbundle = bundles
    images, sparse = synthetic_frames(1, *FRAME, POINTS)
    modes = {k: v for k, v in frontier.make_modes(STEPS, RES).items() if k == "lcm-4"}
    (row,) = frontier.sweep(tbundle, modes, images, sparse, repeats=1)
    assert row["mode"] == "lcm-4" and row["steps"] == 4
    assert not {"is_reference", "mae_vs_full_m", "rmse_vs_full_m"} & set(row)


def test_nativeres_ring1_matches_native(bundles):
    """kitti-native-ring1 against kitti-native through ``run_mode`` (the
    smoke's check (c) on the plain versions): at this geometry every UNet
    self-attention takes the ring's step twins at P=1, one visiting block
    (the online softmax from scratch, then its normalisation), where
    kitti-native takes the plain attention. Measured: max 7.6e-6 m over 2
    guided steps (fp32 sums in another order, through the ε-norm rescale);
    bound 1e-4 m."""
    _, tbundle = bundles
    images, sparse = synthetic_frames(BATCH, *FRAME, POINTS)
    modes = nativeres.make_modes(STEPS, native_res=FRAME[1])
    rows, denses = {}, {}
    for name in ("kitti-native", "kitti-native-ring1"):
        rows[name], denses[name] = nativeres.run_mode(DepthCompletionPipeline(tbundle),
                                                      modes[name], images, sparse, 1)
    assert np.abs(denses["kitti-native-ring1"] - denses["kitti-native"]).max() < 1e-4
    for row in rows.values():
        assert (row["batch"], row["steps"], row["resolution"]) == (BATCH, STEPS, FRAME[1])
        assert row["latent_hw"] == [24, 32] and len(row["frame_times_s"]) == 1
        assert row["remat"] is False and row["peak_gib"] is None
        assert set(row["launches"]) == set(fa.LAUNCHES) | set(c3.LAUNCHES) | {"guidance_epilogue"}
        assert not any(row["launches"].values())  # the CPU runs the plain versions
    assert nativeres.mode_batch(DepthCompletionPipeline(tbundle), modes["kitti-native"], FRAME,
                                8) == 8  # no card limit on the CPU


def test_ring_steps_by_head_dim():
    """The ring takes its step wrappers where JAX's flash ring applies (head
    dim 64 or a multiple of 128; on the card they launch the step kernels up
    to 512) and their plain twins where JAX takes its XLA ring body; the
    twins' ring at d=16 equals the plain attention."""
    for d in (64, 128, 512):
        assert ra.ring_steps(d) == (fa.flash_fwd_ring, fa.flash_bwd_ring)
    for d in (16, 32, 96):
        assert ra.ring_steps(d) == (fa.flash_fwd_ring_plain, fa.flash_bwd_ring_plain)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 96, 32, generator=g, requires_grad=True) for _ in range(3))
    out = ra.ring_attention(q, k, v, 2, ra.LocalRing(2))
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    ref = fa.plain_attention(q, k, v, 2)
    ref_grads = torch.autograd.grad(ref.square().sum(), (q, k, v))
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_bench_kitti_tiny_subprocess(tmp_path):
    """``bench_kitti_torch.py`` as a user runs it on the CPU (the tiny random
    model through the CLI, 2 frames, 2 steps, an E=2 ensemble, res 64): its
    JSON line, and rc 0, which it exits with only where it checked one finite
    (352, 1216, 1) map per frame."""
    env = dict(os.environ, DCT_RANDOM_MODEL_SIZE="tiny", KB_DEVICE="cpu", KB_RES="64",
               KB_FRAMES="2", KB_STEPS="2", KB_ENSEMBLE="2", TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / "bench_kitti_torch.py")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "config", "s_per_frame", "frames", "batch", "infer_s",
            "capture_plus_first_s", "process_wall_s", "device_memory_high_water_gib",
            "launches", "card", "git_commit"} <= set(out)
    assert out["metric"] == "kitti_frames_per_sec_per_chip" and out["frames"] == out["maps"] == 2
    assert len(out["infer_s"]) == 2 and out["value"] == 1 / out["infer_s"][1]
    assert out["capture_plus_first_s"] == out["infer_s"][0]
    assert out["device"] == "cpu" and out["card"] is None
    assert out["device_memory_high_water_gib"] is None and not any(out["launches"].values())
    assert not any(tmp_path.iterdir())  # its dataset and outputs removed


# The port CLI's log of a KITTI run on the card (NVIDIA H100 80GB HBM3,
# 700 W): 2 frames, 2 steps, res 768, an E=2 ensemble, batch 1.
CARD_LOG = """\
2026-10-18 06:37:25,736 | WARNING  | Running with RANDOM weights (smoke-test mode)
2026-10-18 06:37:26,781 | INFO     | Device: cuda (NVIDIA H100 80GB HBM3)
2026-10-18 06:37:26,786 | INFO     | Found 1 dataset directories
2026-10-18 06:37:26,788 | INFO     | Found 2 input pairs for kitti
2026-10-18 06:37:30,431 | INFO     | 1/1 - kitti: 1/2 [3.6 s, time/infer=3.594, time/io=0.044, time/vis=0.000]
2026-10-18 06:37:30,551 | INFO     | 1/1 - kitti: 2/2 [3.8 s, time/infer=0.101, time/io=0.041, time/vis=0.000]
2026-10-18 06:37:30,551 | SUCCESS  | Finished processing kitti
2026-10-18 06:37:30,554 | INFO     | Device memory high-water: 4.00 GiB
2026-10-18 06:37:30,556 | INFO     | Kernel launches: {"flash_fwd": 20, "flash_bwd": 20, "flash_fwd_d512": 0, "flash_bwd_d512": 0, "flash_fwd_ring": 0, "flash_bwd_ring": 0, "conv3x3": 330, "guidance_epilogue": 4}
2026-10-18 06:37:30,556 | SUCCESS  | Finished processing all 1 datasets
"""


def test_parse_cli_log():
    """``parse_log`` on a captured port CLI log: every batch's time/infer in
    order, the device-memory high-water line (not the JAX CLI's "HBM
    high-water"), the run's kernel launches; the steady time is the fastest
    after the first."""
    log = kitti.parse_log(CARD_LOG)
    assert log["infer_s"] == [3.594, 0.101]
    assert log["device_memory_high_water_gib"] == 4.0
    assert log["launches"] == {"flash_fwd": 20, "flash_bwd": 20, "flash_fwd_d512": 0,
                               "flash_bwd_d512": 0, "flash_fwd_ring": 0, "flash_bwd_ring": 0,
                               "conv3x3": 330, "guidance_epilogue": 4}
    assert kitti.steady_infer_s(log["infer_s"]) == 0.101
    assert kitti.steady_infer_s([2.0, 0.5, 0.4]) == 0.4 and kitti.steady_infer_s([2.0]) == 2.0
    with pytest.raises(ValueError, match="time/infer"):
        kitti.parse_log(CARD_LOG.replace("time/infer", "time/other"))
    with pytest.raises(ValueError, match="kernel launches"):
        kitti.parse_log(CARD_LOG.replace("Kernel launches", "Launches"))


def test_scaling_n1_rows_in_process():
    """bench_scaling_torch's n = 1 rows in process on the CPU (no process
    group: a one-rank mesh; the ring row through ``LocalRing(1)``): the tiny
    bundle at 48x64, res 64, 2 steps; efficiency and the ring's ratio 1.0."""
    dev = torch.device("cpu")
    cfg = {**scaling.settings(), "steps": STEPS}
    assert (cfg["frame"], cfg["resolution"], cfg["frames_per_device"]) == (FRAME, RES, 1)
    rows = scaling.add_ratios(scaling.world_rows(dev, scaling.make_bundle(dev, False), cfg,
                                                 ring=True))
    dp, ring = rows
    assert dp["devices"] == 1 and dp["batch"] == 1 and dp["scaling_efficiency"] == 1.0
    assert ring["mode"] == "ring" and ring["ring_size"] == 1 and ring["vs_single_device"] == 1.0
    for row in rows:
        assert row["frames_per_sec"] > 0 and row["steps"] == STEPS and row["latent_hw"] == [24, 32]
        assert row["peak_gib"] is None and not any(row["launches"].values())


@pytest.mark.parametrize("visible, sizes", [(1, [1]), (2, [1, 2]), (8, [1, 2, 4, 8]),
                                            (6, [1, 2, 4, 6])])
def test_scaling_launcher(visible, sizes):
    """The worlds bench_scaling launches for the visible cards, and the
    command of each: torchrun of this script in worker mode, ``--device cpu``
    only on the CPU."""
    assert scaling.world_sizes(visible) == sizes
    for n in sizes:
        cmd = scaling.launch_command(n, torch.device("cuda"))
        assert cmd[1:6] == ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
                            str(n)]
        assert cmd[6].endswith("bench_scaling_torch.py") and cmd[7:] == ["--worker"]
    assert scaling.launch_command(2, torch.device("cpu"))[-2:] == ["--device", "cpu"]


def test_scaling_cpu_ranks(monkeypatch):
    """On the CPU, BENCH_CPU_RANKS gloo ranks stand for cards (1 by default),
    as the JAX script's virtual CPU devices do."""
    monkeypatch.delenv("BENCH_CPU_RANKS", raising=False)
    assert scaling.visible_devices(torch.device("cpu")) == 1
    monkeypatch.setenv("BENCH_CPU_RANKS", "4")
    assert scaling.world_sizes(scaling.visible_devices(torch.device("cpu"))) == [1, 2, 4]


@pytest.mark.parametrize("module, prefix", [(nativeres, "NR"), (frontier, "FRONTIER"),
                                            (kitti, "KB"), (scaling, "BENCH")])
def test_driver_raises_without_card(module, prefix, monkeypatch):
    """Without a card and without ``--device cpu`` or ``<PREFIX>_DEVICE=cpu``
    each driver raises the device error before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the driver would run on it")
    monkeypatch.delenv(f"{prefix}_DEVICE", raising=False)
    monkeypatch.setattr(sys, "argv", [module.__file__])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main()
