"""What the port's configuration drivers share (``bench_nativeres_torch.py``,
``frontier_torch.py``, ``bench_kitti_torch.py``, ``bench_scaling_torch.py``):
the device each runs on, the bench bundle, the JAX scripts' synthetic
frames, one mode's timed runs through a ``DepthCompletionPipeline`` and what
every row carries besides its figures (the card, the commit).

Each driver runs on ``cuda``. It runs on the CPU only when asked, by
``--device cpu`` or its ``<PREFIX>_DEVICE=cpu``; without a card and without
that request it raises.
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from depth_completion_tpu_torch.device import resolve_device  # noqa: E402
from depth_completion_tpu_torch.models import registry  # noqa: E402
from depth_completion_tpu_torch.models.bundle import make_random_bundle  # noqa: E402
from depth_completion_tpu_torch.pipeline.programs import launch_counts  # noqa: E402
from depth_completion_tpu_torch.probes import card as nvidia_smi_card  # noqa: E402


def driver_device(prefix: str, argv: list[str] | None = None) -> torch.device:
    """``cuda``, or the CPU where ``--device cpu`` is in ``argv`` or
    ``<prefix>_DEVICE=cpu`` is set; raises without a card otherwise."""
    argv = sys.argv[1:] if argv is None else argv
    asked = os.environ.get(f"{prefix}_DEVICE")
    if "--device" in argv:
        asked = argv[argv.index("--device") + 1]
    return resolve_device(asked or None)


def card(dev: torch.device) -> str | None:
    """The card's name and power limit as nvidia-smi reports them; None on
    the CPU."""
    return nvidia_smi_card() if dev.type == "cuda" else None


def git_commit() -> str | None:
    """The checkout's short commit; None outside a git checkout."""
    proc = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
                          capture_output=True, text=True)
    return proc.stdout.strip() or None


def bench_bundle(dev: torch.device):
    """The JAX benches' bundle: the full-width Marigold UNet, TAESD, the tiny
    text tower (its 2-token context is computed once; the full tower only
    adds weights), bf16, seed 0."""
    return make_random_bundle(
        seed=0, unet_config=registry.MARIGOLD_UNET_CONFIG, vae_kind="tiny",
        vae_config=registry.TAESD_CONFIG, text_config=registry.TINY_TEXT_CONFIG,
        dtype=torch.bfloat16, device=dev)


def synthetic_frames(batch: int, h: int, w: int, points: int, seed: int = 0):
    """The JAX scripts' frames, in their draw order: uniform RGB in [0, 255)
    and the same ``points`` sparse pixels in every frame, depths uniform in
    [2, 80) m. → (images [B,H,W,3], sparse [B,H,W,1]), float32."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, size=(batch, h, w, 3)).astype(np.float32)
    sparse = np.zeros((batch, h * w), np.float32)
    idx = rng.choice(h * w, size=points, replace=False)
    sparse[:, idx] = rng.uniform(2.0, 80.0, points).astype(np.float32)
    return images, sparse.reshape(batch, h, w, 1)


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(pipe, kwargs: dict, images, sparse, repeats: int, barrier=None):
    """One mode through ``pipe``: the first call (program capture plus its
    first run), then ``repeats`` timed runs, each started after ``barrier``
    (a callable, e.g. ``dist.barrier`` across data-parallel ranks; none by
    default) and ended by a synchronize.
    → (readings, the last run's dense maps as a numpy array). Readings:
    ``capture_plus_first_s``, ``frame_times_s`` (one per repeat: seconds
    per call of the whole batch), ``launches`` (the kernel launches of the
    last timed run), ``remat`` (whether the UNet was rematerialised: the
    program's key), ``peak_gib`` (the mode's peak device memory; None on the
    CPU)."""
    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    dev = pipe.bundle.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pipe(images, sparse, **kwargs)
    synchronize(dev)
    first = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        if barrier is not None:
            barrier()
        before = launch_counts()
        t0 = time.perf_counter()
        dense = pipe(images, sparse, **kwargs)[0]
        synchronize(dev)
        times.append(time.perf_counter() - t0)
        after = launch_counts()
    readings = {
        "capture_plus_first_s": first,
        "frame_times_s": times,
        "launches": {k: after[k] - before[k] for k in after},
        "remat": bool(pipe.program_keys()[-1][3]),
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None,
    }
    return readings, dense.float().cpu().numpy()


def release(dev: torch.device) -> None:
    """Hand a finished mode's blocks back (its pipeline, programs and graphs
    dropped by the caller), so the next mode's peak is its own."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
