"""Data-parallel scaling: frames/s at 1 against n cards, the port's
counterpart of ``scripts/bench_scaling.py``.

The JAX script loops over device subsets in one process; the port runs one
process per card (``core.distributed``). So this script launches itself
under ``torchrun --standalone --nproc-per-node n`` (``python -m
torch.distributed.run``) for each n of (1, 2, 4, 8, the visible cards) that
the visible cards hold; NCCL joins the ranks on cards, gloo on the CPU. In
each world the ranks form one data mesh and run the same guided request
over n x BENCH_FPD frames, each rank its block of rows
(``DepthCompletionPipeline(data_mesh=...)`` shards them with
``parallel.sharding.shard_batch`` and gathers the dense maps). Rank 0
prints its row, ``{devices, frames_per_sec}`` (the batch over the fastest
of 3 timed requests, each started together by a barrier and ended by a
synchronize); this process adds ``scaling_efficiency`` (frames/s over n
times the 1-card figure) and prints each. With BENCH_RING=1 (the default)
each world then runs one frame in native-resolution mode, the UNet's
self-attention over a ring of the n ranks (``ProcessGroupRing``;
``LocalRing(1)`` at n = 1, the JAX script's self-loop ring on one device)
and prints ``{mode: "ring", devices, frames_per_sec, vs_single_device}``.
A machine with one card runs only the n = 1 rows: they measure no scaling.

    python3 scripts/bench_scaling_torch.py                 # tiny bundle, 48x64
    BENCH_FULL=1 python3 scripts/bench_scaling_torch.py    # full width, 480x640

Env (the JAX script's): BENCH_FULL (0: the tiny random bundle at 48x64,
res 64, 4 steps; 1: the full-width Marigold UNet with TAESD, bf16, at
480x640, res 768, 50 steps), BENCH_STEPS, BENCH_FPD (frames per card, 1),
BENCH_RING (1); and BENCH_DEVICE (cuda; ``cpu``, or ``--device cpu``, for
gloo ranks on the CPU), BENCH_CPU_RANKS (on the CPU, the ranks that stand
for cards, as the JAX script's virtual CPU devices do; 1). Every row
carries the kernel launches of one timed request on rank 0, rank 0's peak
GiB over its requests, the card's name and power limit and the commit. A world that fails
ends the script with its exit code.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from depth_completion_tpu_torch.core.distributed import initialize  # noqa: E402
from depth_completion_tpu_torch.core.mesh import AXIS_DATA, MeshSpec, make_mesh  # noqa: E402
from depth_completion_tpu_torch.models.bundle import make_random_bundle  # noqa: E402
from depth_completion_tpu_torch.ops.resize import latent_size  # noqa: E402
from depth_completion_tpu_torch.ops.ring_attention import LocalRing, ProcessGroupRing  # noqa: E402
from depth_completion_tpu_torch.parallel.sharding import shard_bundle  # noqa: E402
from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline  # noqa: E402
from scripts.drivers_torch import (  # noqa: E402
    REPO,
    bench_bundle,
    card,
    driver_device,
    git_commit,
    measure,
)

WORKER = "--worker"
REPEATS = 3


def settings() -> dict:
    """BENCH_FULL's geometry and steps, BENCH_STEPS and BENCH_FPD."""
    full = os.environ.get("BENCH_FULL", "0") == "1"
    h, w, res = (480, 640, 768) if full else (48, 64, 64)
    return {"full": full, "frame": (h, w), "resolution": res,
            "steps": int(os.environ.get("BENCH_STEPS", "50" if full else "4")),
            "frames_per_device": int(os.environ.get("BENCH_FPD", "1"))}


def visible_devices(dev: torch.device) -> int:
    """The cards a world may take: every visible card, or on the CPU
    BENCH_CPU_RANKS ranks."""
    if dev.type == "cuda":
        return torch.cuda.device_count()
    return int(os.environ.get("BENCH_CPU_RANKS", "1"))


def world_sizes(visible: int) -> list[int]:
    """(1, 2, 4, 8, the visible count), those the visible count holds, in
    order (the JAX script's sizes)."""
    return sorted({n for n in (1, 2, 4, 8, visible) if 1 <= n <= visible})


def launch_command(n: int, dev: torch.device) -> list[str]:
    """The command that runs one world of ``n`` ranks of this script."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), str(Path(__file__).resolve()), WORKER]
    return cmd + (["--device", "cpu"] if dev.type == "cpu" else [])


def frames(batch: int, frame: tuple[int, int]):
    """The JAX script's inputs: uniform RGB from seed 0, a sparse point of
    10 m on every 8th row and column."""
    h, w = frame
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, size=(batch, h, w, 3)).astype(np.float32)
    sparse = np.zeros((batch, h, w, 1), np.float32)
    sparse[:, ::8, ::8, 0] = 10.0
    return images, sparse


def world_rows(dev: torch.device, bundle, cfg: dict, ring: bool) -> list[dict]:
    """This rank's rows of its world: the data-parallel row and, with
    ``ring``, the ring row (frames/s, the launches of one timed request,
    peak GiB, the geometry)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_mesh(MeshSpec(data=n, model=1))
    bundle = shard_bundle(mesh, bundle)
    kwargs = dict(max_depth=120.0, steps=cfg["steps"], resolution=cfg["resolution"],
                  norm="const", closed_form=False)
    hw = list(latent_size(cfg["frame"], cfg["resolution"], bundle.vae.downsample_factor))
    batch = n * cfg["frames_per_device"]
    barrier = dist.barrier if dist.is_initialized() else None

    def timed(images, sparse, extra: dict) -> dict:
        readings, _ = measure(DepthCompletionPipeline(bundle), {**kwargs, **extra}, images,
                              sparse, REPEATS, barrier)
        return {"seconds": min(readings["frame_times_s"]), "launches": readings["launches"],
                "peak_gib": readings["peak_gib"]}

    dp = timed(*frames(batch, cfg["frame"]), {"data_mesh": mesh})
    rows = [{"devices": n, "frames_per_sec": batch / dp["seconds"], "batch": batch,
             "rows_per_rank": batch // n, "steps": cfg["steps"], "latent_hw": hw,
             "launches": dp["launches"], "peak_gib": dp["peak_gib"]}]
    if ring:
        ring_mesh = LocalRing(1) if n == 1 else ProcessGroupRing(mesh.groups[AXIS_DATA])
        r = timed(*frames(1, cfg["frame"]), {"ring_mesh": ring_mesh})
        rows.append({"mode": "ring", "devices": n, "frames_per_sec": 1.0 / r["seconds"],
                     "batch": 1, "steps": cfg["steps"], "latent_hw": hw,
                     "ring_size": n, "launches": r["launches"], "peak_gib": r["peak_gib"]})
    return rows


def make_bundle(dev: torch.device, full: bool):
    """BENCH_FULL's bundle; the tiny one (the JAX script's default bundle) in
    bf16 on a card, whose kernels take bf16, and fp32 on the CPU."""
    if full:
        return bench_bundle(dev)
    return make_random_bundle(seed=0, device=dev,
                              dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)


def worker() -> None:
    """One rank of a world (under torchrun): its rows, printed by rank 0."""
    dev = initialize(driver_device("BENCH"))
    cfg = settings()
    try:
        rows = world_rows(dev, make_bundle(dev, cfg["full"]), cfg,
                          os.environ.get("BENCH_RING", "1") == "1")
        if not dist.is_initialized() or dist.get_rank() == 0:
            for row in rows:
                print(json.dumps(row), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def add_ratios(rows: list[dict]) -> list[dict]:
    """The data-parallel rows with ``scaling_efficiency`` (frames/s over
    the n = 1 row's times n), then the ring rows with ``vs_single_device``
    (frames/s over the n = 1 ring row's: sequence parallelism buys memory,
    not throughput; 1.0 is free sharding)."""
    dp = [r for r in rows if "mode" not in r]
    ring = [r for r in rows if r.get("mode") == "ring"]
    out = [{**r, "scaling_efficiency": r["frames_per_sec"] / (dp[0]["frames_per_sec"]
                                                             * r["devices"])} for r in dp]
    out += [{**r, "vs_single_device": r["frames_per_sec"] / ring[0]["frames_per_sec"]}
            for r in ring]
    return out


def main() -> None:
    if WORKER in sys.argv[1:]:
        return worker()
    dev = driver_device("BENCH")
    visible = visible_devices(dev)
    sizes = world_sizes(visible)
    rows = []
    for n in sizes:
        print(f"[scaling] world of {n}: {' '.join(launch_command(n, dev))}", file=sys.stderr,
              flush=True)
        proc = subprocess.run(launch_command(n, dev), cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, timeout=7200)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-2000:] + proc.stderr[-4000:])
            raise SystemExit(proc.returncode)
        rows += [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    context = {"device": str(dev), "card": card(dev), "git_commit": git_commit()}
    if sizes == [1]:
        print(f"[scaling] {visible} visible {'card' if dev.type == 'cuda' else 'rank'}: only "
              "the n = 1 rows run; they measure no scaling", file=sys.stderr, flush=True)
        context["note"] = "one device: n = 1 only, no scaling measured"
    for row in add_ratios(rows):
        print(json.dumps({**row, **context}), flush=True)


if __name__ == "__main__":
    main()
