"""Native-resolution mode on one card, the port's counterpart of
``scripts/bench_nativeres.py``.

At KITTI-DC geometry (352x1216 frames, 2000 sparse points), the full-width
Marigold UNet with TAESD, bf16, random weights from seed 0:

- ``kitti-768``: the downsampled default (res 768 → 28x96 latents, UNet
  stage-0 self-attention at S=2688), the baseline the others are read
  against;
- ``kitti-native``: res 1216 (44x152 latents), no ring: one flash call per
  stage-0 self-attention over S=6688;
- ``kitti-native-ring1``: the same geometry through the ring with one shard
  (``ring_mesh=LocalRing(1)``, the counterpart of the JAX script's
  one-device mesh): every UNet self-attention takes the ring's step kernels,
  one visiting block each, so the row costs the ring's own machinery.

    python3 scripts/bench_nativeres_torch.py
    NR_BATCH=1 NR_STEPS=2 python3 scripts/bench_nativeres_torch.py

Env (the JAX script's): NR_BATCH (8; each mode runs at the smaller of it
and the largest guided batch that fits the card at its latent,
``sampler.largest_batch``, and reports the batch it used), NR_REPEATS (2),
NR_MODES (a comma filter), NR_BUDGET_S (7200: no new mode starts past it);
and NR_STEPS (50), NR_DEVICE (cuda; ``cpu``, or ``--device cpu``, for the
plain versions). Each mode runs through its own ``DepthCompletionPipeline``
(its programs captured at the first call, reported as
``capture_plus_first_s``). A mode that fails ends the script with its error.
Output: one JSON line per mode (batch, frames/s, seconds per timed call,
the kernel launches of one timed call, peak GiB, the card's name and power
limit, the commit), then the JAX script's markdown table.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from depth_completion_tpu_torch.ops.resize import latent_size  # noqa: E402
from depth_completion_tpu_torch.ops.ring_attention import LocalRing  # noqa: E402
from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline  # noqa: E402
from depth_completion_tpu_torch.pipeline.sampler import largest_batch  # noqa: E402
from scripts.drivers_torch import (  # noqa: E402
    bench_bundle,
    card,
    driver_device,
    git_commit,
    measure,
    release,
    synthetic_frames,
)

FRAME = (352, 1216)  # the KITTI-DC crop
POINTS = 2000  # LiDAR-class density


def make_modes(steps: int, native_res: int = FRAME[1]) -> dict[str, dict]:
    """The three modes as the pipeline's keyword arguments (the JAX script's
    base config, :82-94, and its modes, :95-102)."""
    base = dict(
        max_depth=120.0, steps=steps, resolution=768, train_latents=True,
        train_method="per-step", closed_form=False, loss_funcs=("l1", "l2"), norm="const",
        # native-res activation maps pass the batch-12-equivalent threshold;
        # "auto" decides per geometry
        remat_unet="auto",
    )
    return {
        "kitti-768": base,
        "kitti-native": {**base, "resolution": native_res},
        "kitti-native-ring1": {**base, "resolution": native_res, "ring_mesh": LocalRing(1)},
    }


def mode_batch(pipe, cfg: dict, frame: tuple[int, int], requested: int) -> int:
    """The requested batch, or the largest guided batch that fits the card
    at this mode's latent where that is smaller (no limit on the CPU)."""
    if pipe.bundle.device.type != "cuda":
        return requested
    hw = latent_size(frame, cfg["resolution"], pipe.bundle.vae.downsample_factor)
    return min(requested, largest_batch(pipe.bundle.vae.kind, hw, pipe.bundle.device,
                                        pipe.bundle.dtype))


def run_mode(pipe, cfg: dict, images, sparse, repeats: int) -> tuple[dict, np.ndarray]:
    """One mode (``cfg``: the pipeline's keyword arguments) over the whole
    of ``images``/``sparse`` through ``pipe`` → (its row without the mode's
    name, the last timed run's dense maps)."""
    readings, dense = measure(pipe, cfg, images, sparse, repeats)
    batch = images.shape[0]
    row = {
        "batch": batch,
        "resolution": cfg["resolution"],
        "steps": cfg["steps"],
        "latent_hw": list(latent_size(images.shape[1:3], cfg["resolution"],
                                      pipe.bundle.vae.downsample_factor)),
        "frames_per_sec_per_chip": batch / min(readings["frame_times_s"]),
        **readings,
    }
    return row, dense


def main() -> None:
    t_start = time.time()
    dev = driver_device("NR")
    batch = int(os.environ.get("NR_BATCH", "8"))
    repeats = int(os.environ.get("NR_REPEATS", "2"))
    budget_s = float(os.environ.get("NR_BUDGET_S", "7200"))
    steps = int(os.environ.get("NR_STEPS", "50"))
    modes = make_modes(steps)
    only = os.environ.get("NR_MODES")
    if only:
        keep = [m.strip() for m in only.split(",")]
        modes = {k: v for k, v in modes.items() if k in keep}

    bundle = bench_bundle(dev)
    images, sparse = synthetic_frames(batch, *FRAME, POINTS)
    context = {"device": str(dev), "card": card(dev), "git_commit": git_commit()}
    rows = []
    for name, cfg in modes.items():
        if rows and time.time() - t_start > budget_s:
            rows.append({"mode": name, "skipped": "budget"})
            continue
        pipe = DepthCompletionPipeline(bundle)
        b = mode_batch(pipe, cfg, FRAME, batch)
        print(f"[nativeres +{time.time() - t_start:7.1f}s] {name}: capture + first run "
              f"(batch {b})", file=sys.stderr, flush=True)
        row, _ = run_mode(pipe, cfg, images[:b], sparse[:b], repeats)
        row = {"mode": name, **row, **context}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del pipe
        release(dev)

    print("\n| mode | res | batch | f/s/chip | vs kitti-768 |")
    print("|---|---|---|---|---|")
    ref = next((r for r in rows if r["mode"] == "kitti-768" and "skipped" not in r), None)
    for r in rows:
        if "skipped" in r:
            print(f"| {r['mode']} | | {r['skipped']} | | |")
            continue
        rel = (f"{r['frames_per_sec_per_chip'] / ref['frames_per_sec_per_chip']:.2f}x"
               if ref else "—")
        print(f"| {r['mode']} | {r['resolution']} | {r['batch']} | "
              f"{r['frames_per_sec_per_chip']:.4f} | {rel} |")


if __name__ == "__main__":
    main()
