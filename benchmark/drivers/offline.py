"""Offline traffic: requests of ``batch`` frames, back to back, through
``DepthCompletionPipeline.__call__`` (a dataset job).

Set-up builds the bundle from the seed and runs one warm-up request of the
same shape, which builds the kernels and captures the program's graphs.
The window then starts; request k's frames are made while request k - 1
runs on the card (as a loader with workers would) and its results are
copied to the host before it counts as done. The window ends when the
first request that finishes after ``seconds`` has finished.

With ``trace``, the first whole requests of the window, at least
``trace_min_s`` of them, run under ``torch.profiler`` inside a
``bench.window`` span.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.drivers.common import make_bundle, peak_bytes, profiler, sampler_kwargs
from benchmark.harness.frames import offline_batch
from benchmark.harness.trace import WINDOW_SPAN, Trace, events_from_profiler

WARMUP_REQUEST = 10**9  # a frame index no window request reaches


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(*, config, mix, seed, seconds, trace, device, t0):
    from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline

    pipe = DepthCompletionPipeline(make_bundle(config, seed, device))
    kwargs = sampler_kwargs(mix["request"])
    pipe(*offline_batch(mix, seed, WARMUP_REQUEST), **kwargs)
    _sync(device)
    nxt = offline_batch(mix, seed, 0)
    setup_s = time.perf_counter() - t0

    requests, outputs = [], []
    prof, span, traced, profiled = None, None, 0, None
    start = time.perf_counter()
    if trace:
        prof = profiler()
        prof.__enter__()
        span = torch.profiler.record_function(WINDOW_SPAN)
        span.__enter__()
    k = 0
    while True:
        images, sparses = nxt
        sent = time.perf_counter()
        with torch.profiler.record_function("bench.request"):
            denses, latents = pipe(images, sparses, **kwargs)
        with torch.profiler.record_function("bench.frames"):
            nxt = offline_batch(mix, seed, k + 1)
        with torch.profiler.record_function("bench.fetch"):
            dense, latent = denses.cpu().numpy(), latents.cpu().numpy()
        done = time.perf_counter()
        requests.append({"sent": sent, "done": done, "frames": int(images.shape[0]), "ok": True})
        outputs.append((dense, latent))
        if prof is not None:
            traced += 1
            if done - start >= mix["trace_min_s"] or done - start >= seconds:
                span.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                profiled, prof = prof, None
        k += 1
        if done - start >= seconds:
            break
    end = requests[-1]["done"]
    memory = peak_bytes(device)
    del pipe
    tr = Trace(events_from_profiler(profiled)) if profiled is not None else None
    return _record(mix, seed, setup_s, start, end, requests, outputs, memory, tr, traced)


def _record(mix, seed, setup_s, start, end, requests, outputs, memory, tr, traced):
    rng = np.random.default_rng([seed % 2**63, 7])
    r = int(rng.integers(len(requests)))
    n = mix["batch"]
    rows = [0] if n == 1 else sorted({int(rng.integers(n // 2)), int(n // 2 + rng.integers(n - n // 2))})
    images, sparses = offline_batch(mix, seed, r)
    dense, latent = outputs[r]
    checked = [{"images": images[rows], "sparses": sparses[rows], "carry": None,
                "dense": dense[rows], "latent": latent[rows]}]
    return {"setup_s": setup_s, "window": (start, end), "requests": requests,
            "attempted": len(requests), "failed": 0, "memory_peak_bytes": memory,
            "checked": checked, "trace": tr, "traced_frames": traced * n,
            "traced_requests": traced,
            "steps": mix["request"]["steps"]}
