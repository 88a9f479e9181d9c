"""Serving benchmark of the PyTorch port on the GPU (warm-model lifecycle),
the port's counterpart of ``scripts/bench_serve.py``.

Drives the port's real ``ServingEngine`` (random weights, seeded; latency
does not depend on the weights) with a closed-loop pool of concurrent
clients, after a warmup that runs every (geometry, bucket) signature and
the carry one: requests/s, per-request p50/p95 latency, batch fill
(batched rows / (batched + padded)), the first response after warmup, and
per-geometry p50/p95 for a mixed stream.

    python3 scripts/bench_serve_torch.py
    SB_GEOMETRY=480x640,352x1216 SB_REQUESTS=48 python3 scripts/bench_serve_torch.py

CPU smoke (the plain versions, the tiny random model; no card numbers):

    SB_DEVICE=cpu DCT_RANDOM_MODEL_SIZE=tiny SB_RES=64 SB_GEOMETRY=48x64,64x48 \\
        SB_REQUESTS=8 SB_STEPS=2 python3 scripts/bench_serve_torch.py

Env (``scripts/bench_serve.py``'s): SB_GEOMETRY (default 480x640; a comma
list for a mixed stream), SB_RES (768), SB_STEPS (50), SB_CLIENTS (8),
SB_REQUESTS (24), SB_MAX_BATCH (8), SB_MAX_DELAY_MS (25), SB_MAX_PROGRAMS
(the pipeline's bound on live captured programs, LRU-evicted; unset:
unbounded), SB_TIERED=1 (tiered warmup: every signature warms on the eager
twin, then the compute thread captures each between batches; after the
clients the script waits for the promotions, SB_WAIT_PROMOTE=0 skips the
wait, SB_PROMOTE_TIMEOUT_S bounds it and a timeout raises, and reports
``tiered``, ``promote_s`` (seconds from the warmup's return until tier 0
was dropped) and ``tier_promoted``), SB_WARM_PARALLEL (a no-op: a CUDA
graph is captured on the one compute stream, so signatures warm one after
another); and SB_DEVICE (cuda; cpu for the smoke). Prints one JSON line,
with the card's name and power limit as ``nvidia-smi`` reports them, and
the pipeline's live program count.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from depth_completion_tpu_torch.device import resolve_device  # noqa: E402
from depth_completion_tpu_torch.models import registry  # noqa: E402
from depth_completion_tpu_torch.models.bundle import make_random_bundle  # noqa: E402
from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline  # noqa: E402
from depth_completion_tpu_torch.serving import ServeRequest, ServingEngine  # noqa: E402

GEOMETRIES = [
    tuple(int(x) for x in g.lower().split("x"))
    for g in os.environ.get("SB_GEOMETRY", "480x640").split(",")
]
RES = int(os.environ.get("SB_RES", "768"))
STEPS = int(os.environ.get("SB_STEPS", "50"))
CLIENTS = int(os.environ.get("SB_CLIENTS", "8"))
REQUESTS = int(os.environ.get("SB_REQUESTS", "24"))
MAX_BATCH = int(os.environ.get("SB_MAX_BATCH", "8"))
MAX_DELAY_MS = float(os.environ.get("SB_MAX_DELAY_MS", "25"))
MAX_PROGRAMS = int(os.environ["SB_MAX_PROGRAMS"]) if os.environ.get("SB_MAX_PROGRAMS") else None
TIERED = os.environ.get("SB_TIERED", "0") == "1"
WARM_PARALLEL = int(os.environ.get("SB_WARM_PARALLEL", "1"))
DEVICE = os.environ.get("SB_DEVICE", "cuda")
WAIT_PROMOTE = os.environ.get("SB_WAIT_PROMOTE", "1") == "1"
PROMOTE_TIMEOUT_S = float(os.environ.get("SB_PROMOTE_TIMEOUT_S", "3600"))


def card() -> str | None:
    """The card's name and power limit (None off the card)."""
    if DEVICE != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def wait_for_promotions(engine: ServingEngine, warm_end: float) -> float | None:
    """Wait until every warmed signature is promoted to its captured graphs
    and return the seconds since the warmup returned; None when a
    signature's promotion failed for good (no promotion is pending then).
    The port promotes on its compute thread, also while idle, so polling
    ``stats()`` is enough; past SB_PROMOTE_TIMEOUT_S this raises."""
    deadline = time.monotonic() + PROMOTE_TIMEOUT_S
    while True:
        stats = engine.stats()
        if not stats.get("tier0_active"):  # tier 0 dropped: all promoted
            return time.monotonic() - warm_end
        promoted, warmed = map(int, stats["tier_promoted"].split("/"))
        if promoted == warmed:  # tier 0 kept only for programs the LRU evicted
            return time.monotonic() - warm_end
        if stats["tier_failed"]:
            return None
        if time.monotonic() > deadline:
            raise TimeoutError(f"tiered warmup: {stats['tier_promoted']} signatures promoted "
                               f"after {PROMOTE_TIMEOUT_S} s")
        time.sleep(0.05)


def main() -> None:
    dev = resolve_device(DEVICE)
    if os.environ.get("DCT_RANDOM_MODEL_SIZE") == "tiny":
        bundle = make_random_bundle(seed=0, vae_kind="tiny", vae_config=registry.TAESD_CONFIG,
                                    dtype=torch.float32, device=dev)
    else:
        # bench_serve.py's bundle: bf16 weights, the tiny text tower (the
        # 2-token context is computed once; the full tower only adds weights)
        bundle = make_random_bundle(
            seed=0, unet_config=registry.MARIGOLD_UNET_CONFIG, vae_kind="tiny",
            vae_config=registry.TAESD_CONFIG, text_config=registry.TINY_TEXT_CONFIG,
            dtype=torch.bfloat16, device=dev)
    engine = ServingEngine(
        DepthCompletionPipeline(bundle, max_programs=MAX_PROGRAMS),
        dict(max_depth=120.0, steps=STEPS, resolution=RES, norm="const",
             loss_funcs=("l1", "l2")),
        max_batch=MAX_BATCH, max_delay_ms=MAX_DELAY_MS,
    )
    try:
        t0 = time.monotonic()
        engine.warmup(GEOMETRIES, parallel=WARM_PARALLEL, tiered=TIERED)
        warm_s = time.monotonic() - t0

        rng = np.random.default_rng(0)
        h0, w0 = GEOMETRIES[0]
        img0 = rng.uniform(0, 255, size=(h0, w0, 3)).astype(np.float32)
        sp0 = np.zeros((h0, w0, 1), np.float32)
        sp0[h0 // 2, w0 // 2, 0] = 5.0
        sp0[h0 // 4, w0 // 4, 0] = 50.0
        t_first = time.monotonic()
        first = engine.complete(img0, sp0, timeout=1200)
        ttfr_s = time.monotonic() - t_first
        if not np.isfinite(first).all():
            raise RuntimeError("the first response is not finite")
        frames = []
        for i in range(CLIENTS):
            h, w = GEOMETRIES[i % len(GEOMETRIES)]
            img = rng.uniform(0, 255, size=(h, w, 3)).astype(np.float32)
            sparse = np.zeros((h, w, 1), np.float32)
            idx = rng.choice(h * w, size=max(16, h * w // 200), replace=False)
            sparse.reshape(-1)[idx] = rng.uniform(2.0, 100.0, idx.size)
            frames.append(((h, w), img, sparse))

        latencies: dict[tuple[int, int], list[float]] = {g: [] for g in GEOMETRIES}
        lock = threading.Lock()
        left = [REQUESTS]
        errors: list[BaseException] = []

        def client(i: int) -> None:
            geo, img, sparse = frames[i]
            try:
                while True:
                    with lock:
                        if left[0] <= 0:
                            return
                        left[0] -= 1
                    t = time.monotonic()
                    dense = engine.submit(ServeRequest(image=img, sparse=sparse)).wait(1200)
                    if not np.isfinite(dense).all():
                        raise RuntimeError("a response is not finite")
                    with lock:
                        latencies[geo].append(time.monotonic() - t)
            except BaseException as exc:  # reported after the join
                errors.append(exc)
                raise

        before = engine.stats()
        t1 = time.monotonic()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        span = time.monotonic() - t1
        if errors:
            raise errors[0]
        promote_s = wait_for_promotions(engine, t0 + warm_s) if TIERED and WAIT_PROMOTE else None
        stats = engine.stats()
    finally:
        engine.shutdown()

    def pctl(xs: list[float], q: float) -> float:
        return sorted(xs)[min(int(len(xs) * q), len(xs) - 1)]

    all_lats = [x for xs in latencies.values() for x in xs]
    batched = stats["batched_rows"] - before["batched_rows"]
    rows = batched + stats["padded_rows"] - before["padded_rows"]
    out = {
        "metric": "serve_requests_per_sec",
        "value": len(all_lats) / span,
        "unit": "req/s",
        "config": (
            f"{STEPS}-step guided, res {RES}, geometries "
            f"{'+'.join(f'{h}x{w}' for h, w in GEOMETRIES)}, "
            f"{CLIENTS} clients, max_batch {MAX_BATCH}"
        ),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "card": card(),
        "requests": len(all_lats),
        "latency_s_p50": pctl(all_lats, 0.5),
        "latency_s_p95": pctl(all_lats, 0.95),
        "batches": stats["batches"] - before["batches"],
        "batch_fill": batched / rows if rows else None,
        "warmup_s": warm_s,
        "ttfr_s": ttfr_s,  # first response after warmup returned
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None,
    }
    if TIERED:
        n = len(stats["tier_promotions"])
        out["tiered"] = True
        out["promote_s"] = promote_s
        out["tier_promoted"] = stats.get("tier_promoted", f"{n}/{n}")
    out["pipe_programs"] = stats.get("pipe_programs")
    if len(GEOMETRIES) > 1:
        out["per_geometry"] = {
            f"{h}x{w}": {"requests": len(xs), "p50": pctl(xs, 0.5), "p95": pctl(xs, 0.95)}
            for (h, w), xs in latencies.items() if xs
        }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
