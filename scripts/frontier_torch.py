"""Speed/quality frontier of the fast sampling modes, the port's counterpart
of ``scripts/frontier.py``.

Each mode runs the bench config (the full-width Marigold UNet with TAESD,
bf16, random weights from seed 0) on the same 480x640 frames (500 sparse
points, ``bench.py``'s seeds) as the full-parity reference, ``full-50``,
and reports:

- frames/s on the card (the whole batch per call, the fastest of the
  timed calls);
- ``mae_vs_full_m`` / ``rmse_vs_full_m``: how far the mode's dense maps
  move from the reference's, in metres;
- ``anchor_mae_m``: |dense - sparse| at the sparse points, in metres, also
  for the reference itself.

With random weights the drift measures the algorithmic deviation of each
sampler path given the same model function; the real-checkpoint cost needs
the real weights. Mode order and relative sizes are the signal.

Modes (the JAX script's): ``full-50`` (per-step guidance, learned affine),
``fast-50`` (``detach_unet_grad``: the guidance gradient stops at the
scheduler preview), ``lcm-4`` / ``lcm-8`` (guided LCM through the
closed-form affine), ``ddim-25`` / ``ddim-10`` (per-step guidance at fewer
DDIM steps). Only ``full-50`` may be the reference: a run without it reports
no drift.

    python3 scripts/frontier_torch.py
    FRONTIER_BATCH=1 FRONTIER_REF_STEPS=2 FRONTIER_MODES=full-50,lcm-4 python3 scripts/frontier_torch.py

Env (the JAX script's): FRONTIER_MODES (a comma filter), FRONTIER_BATCH (8;
a batch the card cannot hold even with UNet remat is refused up front,
``sampler.check_batch_fits``), FRONTIER_REPEATS (2), FRONTIER_BUDGET_S
(7200: no new mode starts past it), FRONTIER_RES (768), FRONTIER_REF_STEPS
(50: the steps of full-50 and fast-50); and FRONTIER_DEVICE (cuda; ``cpu``,
or ``--device cpu``, for the plain versions), FRONTIER_SAVE (a directory:
each mode's dense maps and the sparse input written there as ``.npy``).
Each mode runs through its own ``DepthCompletionPipeline``; a mode that
fails ends the script with its error. Output: one JSON line per mode (with
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
from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline  # noqa: E402
from depth_completion_tpu_torch.pipeline.sampler import check_batch_fits  # noqa: E402
from scripts.drivers_torch import (  # noqa: E402
    bench_bundle,
    card,
    driver_device,
    git_commit,
    measure,
    release,
    synthetic_frames,
)

FRAME = (480, 640)
POINTS = 500
REFERENCE = "full-50"


def make_modes(ref_steps: int, res: int) -> dict[str, dict]:
    """The six modes as the pipeline's keyword arguments, in the JAX
    script's order (:100-112): the reference first."""
    base = dict(max_depth=120.0, steps=ref_steps, resolution=res, train_latents=True,
                train_method="per-step", closed_form=False, loss_funcs=("l1", "l2"),
                norm="const")
    return {
        REFERENCE: base,
        "fast-50": {**base, "detach_unet_grad": True},
        "lcm-4": {**base, "steps": 4, "scheduler": "lcm", "closed_form": True},
        "ddim-25": {**base, "steps": 25},
        "ddim-10": {**base, "steps": 10},
        "lcm-8": {**base, "steps": 8, "scheduler": "lcm", "closed_form": True},
    }


def sweep(bundle, modes: dict[str, dict], images, sparse, repeats: int,
          budget_s: float = float("inf"), save: Path | None = None):
    """Every mode of ``modes`` over ``images``/``sparse``, each through its
    own pipeline; yields one row per mode as it ends (``mode``, ``steps``, ``batch``,
    ``latent_hw``, frames/s, the timings, launches, peak GiB,
    ``anchor_mae_m``; the reference's ``is_reference``, every later row's
    drift against it)."""
    t_start = time.time()
    dev = bundle.device
    valid = sparse > 0
    ref_out = None
    for name, cfg in modes.items():
        if ref_out is not None and time.time() - t_start > budget_s:
            yield {"mode": name, "skipped": "budget"}
            continue
        print(f"[frontier +{time.time() - t_start:7.1f}s] {name}: capture + first run",
              file=sys.stderr, flush=True)
        pipe = DepthCompletionPipeline(bundle)
        readings, out = measure(pipe, cfg, images, sparse, repeats)
        del pipe
        release(dev)
        row = {
            "mode": name,
            "steps": cfg["steps"],
            "batch": images.shape[0],
            "latent_hw": list(latent_size(images.shape[1:3], cfg["resolution"],
                                          bundle.vae.downsample_factor)),
            "frames_per_sec_per_chip": images.shape[0] / min(readings["frame_times_s"]),
            **readings,
            "anchor_mae_m": float(np.abs(out[valid] - sparse[valid]).mean()),
        }
        # only the full-parity mode may be the drift reference: a filtered
        # or failed full-50 must not promote a fast mode in its place
        if name == REFERENCE and ref_out is None:
            ref_out = out
            row["is_reference"] = True
        elif ref_out is not None:
            diff = out - ref_out
            row["mae_vs_full_m"] = float(np.abs(diff).mean())
            row["rmse_vs_full_m"] = float(np.sqrt((diff**2).mean()))
        if save is not None:
            np.save(save / f"{name}.npy", out)
        yield row


def main() -> None:
    dev = driver_device("FRONTIER")
    batch = int(os.environ.get("FRONTIER_BATCH", "8"))
    repeats = int(os.environ.get("FRONTIER_REPEATS", "2"))
    budget_s = float(os.environ.get("FRONTIER_BUDGET_S", "7200"))
    res = int(os.environ.get("FRONTIER_RES", "768"))
    ref_steps = int(os.environ.get("FRONTIER_REF_STEPS", "50"))
    save = Path(os.environ["FRONTIER_SAVE"]) if os.environ.get("FRONTIER_SAVE") else None
    modes = make_modes(ref_steps, res)
    only = os.environ.get("FRONTIER_MODES")
    if only:
        keep = [m.strip() for m in only.split(",")]
        modes = {k: v for k, v in modes.items() if k in keep}

    bundle = bench_bundle(dev)
    check_batch_fits(bundle.vae.kind, batch, latent_size(FRAME, res, bundle.vae.downsample_factor),
                     dev, bundle.dtype)
    images, sparse = synthetic_frames(batch, *FRAME, POINTS)
    if save is not None:
        save.mkdir(parents=True, exist_ok=True)
        np.save(save / "sparse.npy", sparse)
    context = {"device": str(dev), "card": card(dev), "git_commit": git_commit()}
    rows = []
    for row in sweep(bundle, modes, images, sparse, repeats, budget_s, save):
        rows.append({**row, **context})
        print(json.dumps(rows[-1]), flush=True)

    ref_row = next((r for r in rows if r.get("is_reference")), None)
    print("\n| mode | steps | f/s/chip | speedup | MAE vs full (m) | RMSE vs full (m) "
          "| anchor MAE (m) |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        if "skipped" in r:
            print(f"| {r['mode']} | — | {r['skipped']} | | | | |")
            continue
        sp = (r["frames_per_sec_per_chip"] / ref_row["frames_per_sec_per_chip"]
              if ref_row else float("nan"))
        mae = f"{r['mae_vs_full_m']:.4f}" if "mae_vs_full_m" in r else "—"
        rmse = f"{r['rmse_vs_full_m']:.4f}" if "rmse_vs_full_m" in r else "—"
        print(f"| {r['mode']} | {r['steps']} | {r['frames_per_sec_per_chip']:.4f} | "
              f"{sp:.2f}x | {mae} | {rmse} | {r['anchor_mae_m']:.4f} |")


if __name__ == "__main__":
    main()
