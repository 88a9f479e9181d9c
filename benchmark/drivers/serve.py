"""Served traffic: video streams over HTTP to the serving engine (robots and
video services sending camera frames to a warm ``cli.serve``).

The system under test is ``serving.server.make_server`` on 127.0.0.1 at an
ephemeral port, over a ``ServingEngine`` with the mix's ``engine`` settings
(``cli.serve``'s defaults) and the mix's sampler settings. Set-up warms,
through the same HTTP path, what the streams use: a stream's first frame
and a carried one. In the window ``streams`` client threads start
together, each one camera (``harness.frames.Stream``) with a session of
its own, and each POSTs its next frame's npz as soon as it has read the
previous response (closed loop). After ``seconds`` they stop sending; the
window ends when the last response is read.

Each request records when its POST started and its response was read, the
engine's ``X-DCT-Latency-S`` header, and the dense map it returned; ``GET /v1/stats`` is read before and after the
window. The HTTP answer carries no latent, so the checked stream's client,
once it has read each checked response and before it sends its next frame,
takes the latent that the engine keeps for its session: the final latent of
that frame, which the next frame carries. It holds a reference to the
engine's tensor (a fresh one each request) and copies it to the host only
after the window. With ``trace``, every stream's first request runs under
``torch.profiler`` inside a ``bench.window`` span; the streams then wait
until the profiler has stopped, with the engine idle, and go on.
"""

from __future__ import annotations

import http.client
import io
import json
import sys
import threading
import time

import numpy as np
import torch

from benchmark.drivers.common import make_bundle, peak_bytes, profiler, sampler_kwargs
from benchmark.harness.frames import Stream
from benchmark.harness.trace import WINDOW_SPAN, Trace, events_from_profiler

TIMEOUT_S = 600.0


def _npz(image: np.ndarray, sparse: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, image=image, sparse=sparse[..., 0])
    return buf.getvalue()


def _post(port: int, path: str, body: bytes = b"") -> tuple[int, dict, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _stats(port: int) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/v1/stats")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def run(*, config, mix, seed, seconds, trace, device, t0):
    from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline
    from depth_completion_tpu_torch.serving.engine import ServingEngine
    from depth_completion_tpu_torch.serving.server import make_server

    req = mix["request"]
    call_kwargs = dict(sampler_kwargs(req), percentile=(0.01, 0.99), projection="linear",
                       inv=False, train_latents=True, train_method="per-step", train_steps=10,
                       scheduler="ddim", detach_unet_grad=False)
    eng = mix["engine"]
    engine = ServingEngine(DepthCompletionPipeline(make_bundle(config, seed, device)),
                           call_kwargs, max_batch=eng["max_batch"],
                           max_delay_ms=eng["max_delay_ms"], beta=req["beta"],
                           batch_buckets=tuple(eng["batch_buckets"]))
    httpd = make_server(engine, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, name="bench-http", daemon=True)
    server.start()
    streams = [Stream(mix, seed, j) for j in range(mix["streams"])]
    try:
        warm = Stream(mix, seed, 10**6)
        for f in range(2):  # a first frame, then a carried one
            status, _, body = _post(port, "/v1/complete?session=warmup", _npz(*warm.frame(f)))
            if status != 200:
                raise RuntimeError(f"warm-up request failed: {status} {body[:200]!r}")
        _post(port, "/v1/session/warmup/reset")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t0
        record = _window(port, streams, mix, seed, seconds, trace, engine)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
        engine.shutdown()
    record["memory_peak_bytes"] = peak_bytes(device)
    record["setup_s"] = setup_s
    del engine
    return record


def _session_latent(engine, session: str):
    with engine._lock:
        held = engine._sessions.get(session)
    return None if held is None else held[0]


def _window(port, streams, mix, seed, seconds, trace, engine):
    results: list[list[dict]] = [[] for _ in streams]
    checked_j = int(np.random.default_rng([seed % 2**63, 11]).integers(len(streams)))
    go = threading.Barrier(len(streams) + 1)
    # traced: every stream's first request, then a pause while the profiler
    # stops with the engine idle (stopping it under load hung the run)
    first_round = threading.Barrier(len(streams) + 1)
    resume = threading.Event()
    state = {"start": 0.0}

    def client(j: int) -> None:
        stream, f = streams[j], 0
        go.wait()
        while True:
            body = _npz(*stream.frame(f))
            sent = time.perf_counter()
            try:
                status, headers, payload = _post(port, f"/v1/complete?session=s{j}", body)
            except (OSError, http.client.HTTPException) as exc:
                status, headers, payload = -1, {}, repr(exc).encode()
            done = time.perf_counter()
            item = {"sent": sent, "done": done, "ok": status == 200,
                    "server_s": float(headers.get("X-DCT-Latency-S", "nan"))}
            item["dense"] = np.load(io.BytesIO(payload)) if status == 200 else None
            if j == checked_j and f < mix["check_frames"] and status == 200:
                item["latent"] = _session_latent(engine, f"s{j}")
            results[j].append(item)
            if trace and f == 0:
                first_round.wait()
                resume.wait()
            f += 1
            if done - state["start"] >= seconds:
                return

    threads = [threading.Thread(target=client, args=(j,), name=f"bench-stream-{j}")
               for j in range(len(streams))]
    for t in threads:
        t.start()
    stats0 = _stats(port)
    prof = None
    if trace:
        prof = profiler()
        prof.__enter__()
        span = torch.profiler.record_function(WINDOW_SPAN)
        span.__enter__()
    state["start"] = time.perf_counter()
    go.wait()
    if prof is not None:
        first_round.wait()
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        resume.set()
    for t in threads:
        t.join(TIMEOUT_S + seconds)
    stats1 = _stats(port)
    reqs = [r for rs in results for r in rs]
    end = max(r["done"] for r in reqs)
    sys.stderr.write(f"serve: {len(reqs)} requests in the window, "
                     f"{sum(not r['ok'] for r in reqs)} failed\n")
    return {"window": (state["start"], end), "requests": reqs, "attempted": len(reqs),
            "failed": sum(not r["ok"] for r in reqs), "stats": (stats0, stats1),
            "checked": _checked(results[checked_j], streams[checked_j], mix),
            "trace": Trace(events_from_profiler(prof)) if prof is not None else None}


def _checked(results, stream, mix) -> list[dict]:
    """The stream drawn from the seed: its first ``check_frames`` frames
    that it sent, each after the first carrying the one before (a frame
    sent and not answered stays in, with no dense map), with the session's
    latent after each."""
    out = []
    for f, got in enumerate(results[: mix["check_frames"]]):
        image, sparse = stream.frame(f)
        latent = got.get("latent")
        out.append({"carry": f - 1 if f else None,
                    "images": image[None].astype(np.float32), "sparses": sparse[None],
                    "dense": None if got["dense"] is None else got["dense"][None],
                    "latent": None if latent is None else latent[:1].float().cpu().numpy()})
    return out
