"""KITTI-DC north-star config through the port's predict CLI, the port's
counterpart of ``scripts/bench_kitti.py``.

Writes a synthetic dataset of 352x1216 frames (PNG, the port's writer;
~0.5% of the pixels carry a sparse depth) and runs ``python -m
depth_completion_tpu_torch.cli.predict`` over it: random weights (full
Marigold width, TAESD, bf16; throughput does not depend on the weights),
a 50-step guided DDIM at processing res 768, a 5-member ensemble with the
aligned-median reduce, ``.npy`` dense maps, no vis grids. Parses the CLI's
``time/infer=`` per batch, its ``Device memory high-water: X GiB`` and its
``Kernel launches: {...}`` lines, checks one finite (352, 1216, 1) dense
map per frame, and prints one JSON line: frames/s on the card (the batch
over the steadiest batch's ``time/infer``, every batch after the first,
which captures the programs), seconds per frame, the first batch's
seconds (``capture_plus_first_s``), the process's wall seconds, the
high-water GiB, the kernel launches per batch, the card's name and power
limit, the commit.

    python3 scripts/bench_kitti_torch.py
    KB_FRAMES=2 KB_ENSEMBLE=2 KB_STEPS=2 python3 scripts/bench_kitti_torch.py

CPU smoke (the tiny random model, the plain versions):

    DCT_RANDOM_MODEL_SIZE=tiny KB_DEVICE=cpu KB_RES=64 KB_FRAMES=2 KB_STEPS=2 \\
        KB_ENSEMBLE=2 python3 scripts/bench_kitti_torch.py

Env (the JAX script's): KB_BATCH (1), KB_FRAMES (max(4, 3 x KB_BATCH)),
KB_ENSEMBLE (5), KB_STEPS (50), KB_REDUCE (aligned-median); and KB_RES
(768), KB_DEVICE (cuda; ``cpu`` adds ``--device cpu`` to the CLI). The
dataset and the CLI's outputs go to a temporary directory, removed at the
end. A CLI that fails ends the script with its exit code and the end of its
log; a missing, misshapen or non-finite map ends it with an error.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from depth_completion_tpu_torch.io.image import save_img_array  # noqa: E402
from scripts.drivers_torch import REPO, card, driver_device, git_commit  # noqa: E402

FRAME = (352, 1216)


def write_dataset(ds: Path, frames: int) -> None:
    """The JAX script's frames (:37-45, its seed and draw order): RGB in
    [1, 255), sparse depth bytes in [5, 200) on ~0.5% of the pixels, in
    channel 0."""
    rng = np.random.default_rng(0)
    h, w = FRAME
    for i in range(frames):
        img = rng.integers(1, 255, size=(h, w, 3)).astype(np.uint8)
        save_img_array(img, ds / "image" / f"{i:05d}.png")
        sparse = np.zeros((h, w, 3), np.uint8)
        mask = rng.random((h, w)) < 0.005  # ~2k lidar points
        sparse[mask, 0] = rng.integers(5, 200, mask.sum()).astype(np.uint8)
        save_img_array(sparse, ds / "sparse" / f"{i:05d}.png")


def parse_log(text: str) -> dict:
    """The port CLI's log → ``infer_s`` (``time/infer`` of every batch, in
    order), ``device_memory_high_water_gib`` (None where the CLI logged
    none: the CPU) and ``launches`` (the run's kernel launches)."""
    infer = [float(m) for m in re.findall(r"time/infer=([0-9.]+)", text)]
    if not infer:
        raise ValueError("the CLI's log has no time/infer")
    peaks = re.findall(r"Device memory high-water: ([0-9.]+) GiB", text)
    launches = re.findall(r"Kernel launches: (\{.*\})", text)
    if not launches:
        raise ValueError("the CLI's log has no kernel launches line")
    return {"infer_s": infer,
            "device_memory_high_water_gib": float(peaks[-1]) if peaks else None,
            "launches": json.loads(launches[-1])}


def steady_infer_s(infer: list[float]) -> float:
    """The steady ``time/infer``: the fastest batch after the first (whose
    time holds the programs' capture); the first where it is the only one."""
    return min(infer[1:]) if len(infer) > 1 else infer[0]


def main() -> None:
    dev = driver_device("KB")
    batch = int(os.environ.get("KB_BATCH", "1"))
    frames = int(os.environ.get("KB_FRAMES", str(max(4, 3 * batch))))
    ensemble = int(os.environ.get("KB_ENSEMBLE", "5"))
    steps = int(os.environ.get("KB_STEPS", "50"))
    res = int(os.environ.get("KB_RES", "768"))
    reduce = os.environ.get("KB_REDUCE", "aligned-median")
    root = Path(tempfile.mkdtemp(prefix="dct_kitti_"))
    try:
        data, out = root / "data", root / "out"
        write_dataset(data / "kitti", frames)
        args = [
            sys.executable, "-m", "depth_completion_tpu_torch.cli.predict", str(data), str(out),
            "--model", "random", "--steps", str(steps), "--res", str(res),
            "--ensemble", str(ensemble), "--ensemble-reduce", reduce,
            "--batch-size", str(batch), "--compress", "npy", "--vis", "false",
            "--log-level", "INFO",
        ]
        if dev.type == "cpu":
            args += ["--device", "cpu"]
        t0 = time.time()
        proc = subprocess.run(args, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=REPO, timeout=7200)
        wall = time.time() - t0
        if proc.returncode != 0:
            print(proc.stdout[-3000:])
            raise SystemExit(proc.returncode)
        log = parse_log(proc.stdout)
        denses = sorted((out / "kitti" / "dense").glob("*.npy"))
        if len(denses) != frames:
            raise RuntimeError(f"{len(denses)} dense maps for {frames} frames")
        for path in denses:
            d = np.load(path)
            if d.shape != (*FRAME, 1) or not np.isfinite(d).all():
                raise RuntimeError(f"{path.name}: shape {d.shape}, finite {np.isfinite(d).all()}")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    requests = len(log["infer_s"])
    per_request = {k: n // requests for k, n in log["launches"].items()}
    if any(n % requests for n in log["launches"].values()):
        raise RuntimeError(f"{log['launches']} launches over {requests} batches: not one "
                           "count per batch")
    steady = steady_infer_s(log["infer_s"])
    print(json.dumps({
        "metric": "kitti_frames_per_sec_per_chip",
        "value": batch / steady,
        "unit": "frames/s",
        "config": f"1216x352, {steps}-step guided DDIM, res {res}, ensemble {ensemble} "
                  f"({reduce}), batch {batch}, bf16, taesd",
        "s_per_frame": steady / batch,
        "frames": frames,
        "maps": len(denses),
        "batch": batch,
        "steps": steps,
        "resolution": res,
        "ensemble": ensemble,
        "infer_s": log["infer_s"],
        "capture_plus_first_s": log["infer_s"][0],
        "process_wall_s": wall,
        "device_memory_high_water_gib": log["device_memory_high_water_gib"],
        "launches": per_request,
        "device": str(dev),
        "card": card(dev),
        "git_commit": git_commit(),
    }))


if __name__ == "__main__":
    main()
