"""The port's serving engine, HTTP server and serve CLI against the JAX
package's: (i) the fake-pipe engine cases of tests/test_serving.py on the
port's engine (buckets, round-robin, backlog priority, cancel, load
shedding, pending counts, session sweep, the 500 path, the bounded retry,
and a pipe that fails every call); (ii) three coalesced requests and a
session's second frame through the port's engine against the JAX
``DepthCompletionPipeline`` on the same weights; (iii) an HTTP round trip
and its error codes; (iv) the serve CLI's parsed options against the JAX
click CLI's; (v) fast guidance without the UNet's graph; (vi) remat "auto"
per VAE kind and the error above the largest batch that fits.

Geometry: 48x64 frames, processing resolution 64, 2 steps, fp32, the tiny
UNet and TAESD (``from_jax_params`` of the JAX trees), two torch threads.
"""

from __future__ import annotations

import functools
import http.client
import io
import json
import threading
import time

import click
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_completion_tpu.cli import serve as j_serve
from depth_completion_tpu.models import registry as jreg
from depth_completion_tpu.models.bundle import VAE as JVAE
from depth_completion_tpu.models.bundle import ModelBundle as JBundle
from depth_completion_tpu.pipeline import DepthCompletionPipeline as JPipe
from depth_completion_tpu.pipeline import sampler as JS
from depth_completion_tpu_torch.cli import serve
from depth_completion_tpu_torch.models import registry
from depth_completion_tpu_torch.models.weights import from_jax_params
from depth_completion_tpu_torch.ops.resize import latent_size
from depth_completion_tpu_torch.pipeline import sampler as TS
from depth_completion_tpu_torch.pipeline.programs import ProgramCache
from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline
from depth_completion_tpu_torch.serving import OverloadedError, ServeRequest, ServingEngine
from depth_completion_tpu_torch.serving.server import make_server

from tests.test_torch_weights import tiny_jax_trees

H, W = 48, 64
MAX_DEPTH = 10.0
CALL_KWARGS = dict(max_depth=MAX_DEPTH, steps=2, resolution=64, norm="minmax",
                   loss_funcs=("l1", "l2"))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _frame(seed: int = 0, h: int = H, w: int = W):
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 255, size=(h, w, 3)).astype(np.float32)
    sparse = np.zeros((h, w, 1), np.float32)
    idx = rng.choice(h * w, size=40, replace=False)
    sparse.reshape(-1)[idx] = rng.uniform(0.5, 9.5, 40)
    return image, sparse


def _fake_pipe_result(images):
    n, h, w = images.shape[:3]
    return np.zeros((n, h, w, 1), np.float32), np.zeros((n, 4, 4, 4), np.float32)


def _post(srv, path: str, body: bytes):
    host, port = srv.server_address
    conn = http.client.HTTPConnection(host, port, timeout=300)
    conn.request("POST", path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    headers = dict(resp.getheaders())
    conn.close()
    return resp.status, data, headers


def _get(srv, path: str):
    host, port = srv.server_address
    conn = http.client.HTTPConnection(host, port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _npz_payload(image, sparse) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, image=image, sparse=sparse)
    return buf.getvalue()


@pytest.fixture
def serving():
    """A started HTTP server for a given engine, shut down with it."""
    started = []

    def start(eng, **kw):
        srv = make_server(eng, host="127.0.0.1", port=0, **kw)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        started.append((srv, eng))
        return srv

    yield start
    for srv, eng in started:
        srv.shutdown()
        srv.server_close()
        eng.shutdown()


class _Blocking:
    """A fake pipe whose first call blocks until ``release`` (so that the
    requests after it queue deterministically), recording each call."""

    def __init__(self, block_first: bool = True, block_all: bool = False):
        self.entered, self.release = threading.Event(), threading.Event()
        self.calls: list[tuple] = []
        self.block_first, self.block_all = block_first, block_all

    def __call__(self, images, sparses, **k):
        self.calls.append((images.shape[0], tuple(images.shape[1:3]), "pred_latents_prev" in k))
        if self.block_all or (self.block_first and len(self.calls) == 1):
            self.entered.set()
            self.release.wait(60)
        return _fake_pipe_result(images)

    def program_keys(self):
        """One program per (batch, geometry) run, keyed as the pipeline's."""
        shapes = dict.fromkeys((n, *hw) for n, hw, _ in self.calls)
        return [("step", (n, h, w, 3)) for n, h, w in shapes]


# ---------------------------------------------------------------------------
# (i) the fake-pipe engine cases of tests/test_serving.py, on the port
# ---------------------------------------------------------------------------

def case_rejects_invalid_sparse_at_admission(engines):
    """No points > 0 (all-zero or negative-only) is rejected in submit(),
    a constant frame under minmax too; const normalisation accepts it."""
    eng = engines(_Blocking(block_first=False), dict(max_depth=120.0, norm="minmax"),
                  max_batch=1)
    img, sp = _frame(8)
    for bad in (np.zeros_like(sp), -np.abs(sp) - 1.0):
        with pytest.raises(ValueError, match="No valid values found in mask"):
            eng.submit(ServeRequest(image=img, sparse=bad))
    const_sp = np.where(sp > 0, 7.0, 0.0).astype(np.float32)
    with pytest.raises(ValueError, match="Degenerate sparse depth range"):
        eng.submit(ServeRequest(image=img, sparse=const_sp))
    assert eng.stats()["requests"] == 0
    eng2 = engines(_Blocking(block_first=False), dict(max_depth=120.0, norm="const"), max_batch=1)
    eng2.complete(img, const_sp, timeout=30)


def case_session_sweep_expired(engines):
    """Expired carry latents are dropped for every session id."""
    eng = engines(_Blocking(block_first=False), dict(max_depth=120.0), max_batch=1,
                  session_ttl_s=1.0)
    img, sp = _frame(9)
    eng.complete(img, sp, session="s1", timeout=30)
    eng.complete(img, sp, session="s2", timeout=30)
    assert eng.stats()["sessions_active"] == 2
    time.sleep(1.1)
    eng.complete(img, sp, timeout=30)  # any round triggers the sweep
    deadline = time.monotonic() + 5
    while eng.stats()["sessions_active"] > 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert eng.stats()["sessions_active"] == 0


def case_backlog_priority(engines):
    """A minority-geometry request is served before same-geometry requests
    that arrived after it."""
    pipe = _Blocking()
    eng = engines(pipe, dict(max_depth=120.0), max_batch=2, max_delay_ms=200.0)
    (img_a, sp_a), (img_b, sp_b) = _frame(0), _frame(1, h=W, w=H)
    reqs = [eng.submit(ServeRequest(image=img_a, sparse=sp_a))]
    assert pipe.entered.wait(10)
    for img, sp in ((img_a, sp_a), (img_b, sp_b), (img_a, sp_a), (img_a, sp_a)):
        reqs.append(eng.submit(ServeRequest(image=img, sparse=sp)))
    pipe.release.set()
    for r in reqs:
        r.wait(30)
    geos = [c[1] for c in pipe.calls]
    assert geos.index((W, H)) < max(i for i, g in enumerate(geos) if g == (H, W)), geos


def case_batch_buckets(engines):
    """A lone request runs bucket 1; three coalesce into bucket 4 (one
    padded row, a copy of row 0); warmup runs every bucket and the carry
    signature."""
    fed = []

    class _Pipe(_Blocking):
        def __call__(self, images, sparses, **k):
            fed.append(images.copy())
            return super().__call__(images, sparses, **k)

    pipe = _Pipe()
    eng = engines(pipe, dict(max_depth=120.0), max_batch=4, max_delay_ms=200.0)
    assert eng.batch_buckets == (1, 4)
    first = eng.submit(ServeRequest(image=_frame(0)[0], sparse=_frame(0)[1]))
    assert pipe.entered.wait(10)
    rest = [eng.submit(ServeRequest(image=img, sparse=sp))
            for img, sp in (_frame(i) for i in (1, 2, 3))]
    pipe.release.set()
    for r in (first, *rest):
        r.wait(30)
    assert [c[0] for c in pipe.calls] == [1, 4]
    np.testing.assert_array_equal(fed[1][3], fed[1][0])  # padded with row 0
    stats = eng.stats()
    assert stats["padded_rows"] == 1 and stats["batched_rows"] == 4
    progs = [tuple(p) for p in stats["compiled_programs"]]
    assert (H, W, 1) in progs and (H, W, 4) in progs
    pipe.calls.clear()
    eng.warmup([(H, W)])
    assert [(c[0], c[2]) for c in pipe.calls] == [(1, False), (4, False), (1, True)]


def case_cancel_skips_device_work(engines):
    pipe = _Blocking()
    eng = engines(pipe, dict(max_depth=120.0), max_batch=1)
    img, sp = _frame(0)
    first = eng.submit(ServeRequest(image=img, sparse=sp))
    assert pipe.entered.wait(10)
    doomed = eng.submit(ServeRequest(image=img, sparse=sp))
    tail = eng.submit(ServeRequest(image=img, sparse=sp))
    doomed.cancel()
    pipe.release.set()
    first.wait(30)
    tail.wait(30)
    with pytest.raises(RuntimeError, match="cancelled"):
        doomed.wait(10)
    assert eng.stats()["cancelled"] == 1 and len(pipe.calls) == 2


def case_http_engine_error_returns_500(engines, serving):
    class _Boom:
        def __call__(self, images, sparses, **k):
            raise RuntimeError("device exploded")

    eng = engines(_Boom(), dict(max_depth=120.0), max_batch=1, own=False)
    eng.dispatch_retry_backoff_s = 0.0
    srv = serving(eng)
    status, data, _ = _post(srv, "/v1/complete", _npz_payload(*_frame(7)))
    assert status == 500 and b"device exploded" in data


def case_load_shedding(engines, serving):
    """Beyond max_queue pending requests submit() sheds (503 over HTTP);
    slots free as requests resolve."""
    pipe = _Blocking(block_all=True)
    eng = engines(pipe, dict(max_depth=120.0), max_batch=1, max_queue=2, own=False)
    srv = serving(eng)
    img, sp = _frame(0)
    first = eng.submit(ServeRequest(image=img, sparse=sp))
    assert pipe.entered.wait(10)
    queued = eng.submit(ServeRequest(image=img, sparse=sp))
    with pytest.raises(OverloadedError, match="queue full"):
        eng.submit(ServeRequest(image=img, sparse=sp))
    status, data, _ = _post(srv, "/v1/complete", _npz_payload(img, sp))
    assert status == 503 and b"queue full" in data
    assert eng.stats()["rejected"] == 2 and eng.stats()["pending"] == 2
    pipe.release.set()
    first.wait(30)
    queued.wait(30)
    deadline = time.monotonic() + 5
    while eng.stats()["pending"] and time.monotonic() < deadline:
        time.sleep(0.01)
    assert eng.stats()["pending"] == 0
    eng.complete(img, sp, timeout=30)


def case_pending_counts_backlog(engines):
    """Queued, collected and in-flight requests all hold admission slots."""
    pipe = _Blocking(block_all=True)
    eng = engines(pipe, dict(max_depth=120.0), max_batch=2, max_delay_ms=2000.0, max_queue=3)
    (img_a, sp_a), (img_b, sp_b) = _frame(0), _frame(1, h=W, w=H)
    reqs = [eng.submit(ServeRequest(image=i, sparse=s))
            for i, s in ((img_a, sp_a), (img_b, sp_b), (img_a, sp_a))]
    assert pipe.entered.wait(10)
    assert eng.stats()["pending"] == 3
    with pytest.raises(OverloadedError, match="queue full"):
        eng.submit(ServeRequest(image=img_a, sparse=sp_a))
    pipe.release.set()
    for r in reqs:
        r.wait(30)


def case_round_robin_across_geometries(engines):
    pipe = _Blocking()
    eng = engines(pipe, dict(max_depth=120.0), max_batch=2, max_delay_ms=5.0)
    (img_a, sp_a), (img_b, sp_b) = _frame(0), _frame(1, h=W, w=H)
    first = eng.submit(ServeRequest(image=img_a, sparse=sp_a))
    assert pipe.entered.wait(10)
    reqs = ([eng.submit(ServeRequest(image=img_a, sparse=sp_a)) for _ in range(4)]
            + [eng.submit(ServeRequest(image=img_b, sparse=sp_b)) for _ in range(2)])
    pipe.release.set()
    for r in (first, *reqs):
        r.wait(30)
    geos = [c[1] for c in pipe.calls]
    assert geos[0] == (H, W) and (W, H) in geos[1:3], geos


def case_warmup_parallel_runs_serially(engines):
    """warmup(parallel=N) runs the serial program set, one job at a time."""
    inflight, peak, lock = [0], [0], threading.Lock()
    calls = []

    class _Pipe:
        def __call__(self, images, sparses, **k):
            with lock:
                inflight[0] += 1
                peak[0] = max(peak[0], inflight[0])
                calls.append((images.shape[0], "pred_latents_prev" in k))
            time.sleep(0.05)
            with lock:
                inflight[0] -= 1
            return _fake_pipe_result(images)

    eng = engines(_Pipe(), dict(max_depth=120.0), max_batch=4)
    eng.warmup([(H, W), (W, H)], parallel=3)
    assert eng.warm and peak[0] == 1
    assert calls == [(1, False), (4, False), (1, True)] * 2
    # tiered: every job on tier 0, then each signature promoted on the
    # compute thread (the carry shares bucket 1's program)
    tier0 = []

    class _Tier0:
        def __call__(self, images, sparses, **k):
            tier0.append((images.shape[0], "pred_latents_prev" in k))
            return _fake_pipe_result(images)

    eng._make_tier0_pipe = lambda effort: _Tier0()
    calls.clear()
    eng.warmup([(H, W)], parallel=3, tiered=True)
    assert tier0 == [(1, False), (4, False), (1, True)]
    deadline = time.monotonic() + 30
    while eng.stats().get("tier0_active") and time.monotonic() < deadline:
        time.sleep(0.02)
    st = eng.stats()
    assert "tier0_active" not in st and calls == [(1, False), (4, False)]
    assert [p["signature"] for p in st["tier_promotions"]] == [((H, W), 1), ((H, W), 4)]


def case_http_timeout_returns_504(engines, serving):
    pipe = _Blocking(block_all=True)
    eng = engines(pipe, dict(max_depth=120.0), max_batch=1, own=False)
    srv = serving(eng, request_timeout_s=0.2)
    status, data, _ = _post(srv, "/v1/complete", _npz_payload(*_frame(0)))
    pipe.release.set()
    assert status == 504 and b"timed out" in data


def case_session_keeps_fifo_slot(engines):
    """[plain, session, plain] on one geometry run as three batches in
    arrival order."""
    pipe = _Blocking()
    eng = engines(pipe, dict(max_depth=120.0), max_batch=4, max_delay_ms=50.0)
    img, sp = _frame(0)
    first = eng.submit(ServeRequest(image=img, sparse=sp))
    assert pipe.entered.wait(10)
    reqs = [eng.submit(ServeRequest(image=img, sparse=sp, session=s)) for s in (None, "v1", None)]
    pipe.release.set()
    for r in (first, *reqs):
        r.wait(30)
    assert [c[0] for c in pipe.calls] == [1, 1, 1, 1] and eng.stats()["batches"] == 4


class _Poisoned:
    """An array-like whose fetch raises (an asynchronous device failure)."""

    def __array__(self, dtype=None, copy=None):
        raise RuntimeError("transient device error")


def case_retry_on_dispatch_error(engines):
    calls = []

    class _Flaky:
        def __call__(self, images, sparses, **k):
            calls.append(images.shape[0])
            if len(calls) == 1:
                raise RuntimeError("CUDA error: transient")
            return _fake_pipe_result(images)

    eng = engines(_Flaky(), dict(max_depth=120.0), max_batch=2)
    assert eng.complete(*_frame(0), timeout=30).shape == (H, W, 1)
    assert calls == [1, 1]
    assert eng.stats()["retried_batches"] == 1 and eng.stats()["errors"] == 0


def case_retry_on_fetch_error(engines):
    """A device error that surfaces at the fetch is requeued once."""
    calls = []

    class _Flaky:
        def __call__(self, images, sparses, **k):
            calls.append(images.shape[0])
            if len(calls) == 1:
                return _Poisoned(), np.zeros((images.shape[0], 4, 4, 4), np.float32)
            # a CPU tensor result goes through the same fetch
            return tuple(torch.from_numpy(x) for x in _fake_pipe_result(images))

    eng = engines(_Flaky(), dict(max_depth=120.0), max_batch=2)
    out = eng.complete(*_frame(0), timeout=30)
    assert out.shape == (H, W, 1) and isinstance(out, np.ndarray)
    assert calls == [1, 1]
    assert eng.stats()["retried_batches"] == 1 and eng.stats()["errors"] == 0


def case_deterministic_error_fails_after_one_retry(engines):
    calls = []

    class _Dead:
        def __call__(self, images, sparses, **k):
            calls.append(1)
            raise RuntimeError("shape mismatch: deterministic bug")

    eng = engines(_Dead(), dict(max_depth=120.0), max_batch=1)
    with pytest.raises(RuntimeError, match="deterministic bug"):
        eng.complete(*_frame(0), timeout=30)
    assert len(calls) == 2
    assert eng.stats()["errors"] == 1 and eng.stats()["retried_batches"] == 1


def case_sticky_error_resolves_every_request(engines):
    """A pipe that fails every call (a sticky CUDA error: every later call
    fails), at dispatch or at the fetch: each request resolves with the
    error after its one retry; none hangs, and the engine still shuts
    down."""
    for at_fetch in (False, True):
        class _Sticky:
            def __call__(self, images, sparses, **k):
                if at_fetch:
                    return _Poisoned(), np.zeros((images.shape[0], 4, 4, 4), np.float32)
                raise RuntimeError("CUDA error: an illegal memory access was encountered")

        eng = engines(_Sticky(), dict(max_depth=120.0), max_batch=2, max_delay_ms=50.0)
        reqs = [eng.submit(ServeRequest(image=img, sparse=sp, session=s))
                for (img, sp), s in zip((_frame(i) for i in range(5)),
                                        (None, None, "cam", "cam", None))]
        for r in reqs:
            with pytest.raises(RuntimeError, match="illegal memory access|transient"):
                r.wait(30)
        assert eng.stats()["errors"] == 5 and eng.stats()["pending"] == 0


def case_fetch_retry_restores_session_carry(engines):
    """A failed session frame does not leave its latents as the carry: the
    retry chains off the previous frame's."""
    seen, calls = [], []

    class _Flaky:
        def __call__(self, images, sparses, **k):
            calls.append(1)
            seen.append(k.get("pred_latents_prev"))
            n = images.shape[0]
            if len(calls) == 2:
                return _Poisoned(), np.full((n, 4, 4, 4), 99.0, np.float32)
            return (np.zeros((n, H, W, 1), np.float32),
                    torch.full((n, 4, 4, 4), float(len(calls))))

    eng = engines(_Flaky(), dict(max_depth=120.0), max_batch=1)
    img, sp = _frame(0)
    eng.complete(img, sp, session="v", timeout=30)
    eng.complete(img, sp, session="v", timeout=30)
    assert len(calls) == 3 and seen[0] is None
    assert float(seen[1][0, 0, 0, 0]) == 1.0 and float(seen[2][0, 0, 0, 0]) == 1.0


def case_warmup_carry_channels_follow_bundle(engines):
    class _Vae:
        config = type("Cfg", (), {"latent_channels": 16})()
        downsample_factor = 8

    shapes = []

    class _Pipe:
        bundle = type("Bundle", (), {"vae": _Vae()})()

        def __call__(self, images, sparses, **k):
            if "pred_latents_prev" in k:
                shapes.append(np.asarray(k["pred_latents_prev"]).shape)
            return _fake_pipe_result(images)

    eng = engines(_Pipe(), dict(max_depth=120.0, resolution=64), max_batch=2)
    eng.warmup([(H, W)])
    assert shapes == [(1, 6, 8, 16)]


def case_mixed_batch_retry_only_fresh(engines):
    calls = []
    pipe = _Blocking()

    class _Pipe:
        def __call__(self, images, sparses, **k):
            calls.append(images.shape[0])
            if len(calls) == 1:
                return pipe(images, sparses, **k)
            if len(calls) == 2:
                raise RuntimeError("transient backend error")
            return _fake_pipe_result(images)

    eng = engines(_Pipe(), dict(max_depth=120.0), max_batch=2, max_delay_ms=200.0)
    img, sp = _frame(0)
    blocker = eng.submit(ServeRequest(image=img, sparse=sp))
    assert pipe.entered.wait(10)
    ra = eng.submit(ServeRequest(image=img, sparse=sp))
    ra._retried = True  # as if already requeued once
    rb = eng.submit(ServeRequest(image=img, sparse=sp))
    pipe.release.set()
    blocker.wait(30)
    with pytest.raises(RuntimeError, match="transient"):
        ra.wait(30)
    assert rb.wait(30).shape == (H, W, 1)
    assert calls == [1, 2, 1]
    assert eng.stats()["errors"] == 1 and eng.stats()["retried_batches"] == 1


def case_requeue_batch_inserts_after_retried_front(engines):
    pipe = _Blocking(block_all=True)
    eng = engines(pipe, dict(max_depth=120.0), max_batch=1)
    img, sp = _frame(0)
    eng.submit(ServeRequest(image=img, sparse=sp))
    assert pipe.entered.wait(10)
    ra = eng.submit(ServeRequest(image=img, sparse=sp))
    ra._retried = True
    rb = eng.submit(ServeRequest(image=img, sparse=sp))
    with eng._cv:
        eng._queues[(H, W)].remove(rb)  # as if collected, then failed
    rb._retried = True
    eng._requeue_batch([rb], (H, W))
    with eng._cv:
        assert list(eng._queues[(H, W)]) == [ra, rb]
    pipe.release.set()


def case_finisher_restores_only_readable_carry(engines):
    """On a failed fetch the finisher reinstates the previous carry only
    where that carry is itself readable."""
    eng = engines(_Blocking(block_first=False), dict(max_depth=120.0), max_batch=1)
    img, sp = _frame(0)

    def feed(prev_held, session):
        req = ServeRequest(image=img, sparse=sp, session=session)
        req._retried = True  # exhausted: the finisher fails it, no requeue
        with eng._lock:
            eng._pending += 1
        eng._sessions[session] = (_Poisoned(), time.monotonic())
        eng._finish.put(([req], 1, 0, (H, W), _Poisoned(), session, prev_held))
        with pytest.raises(RuntimeError):
            req.wait(10)

    good = (torch.ones((1, 4, 4, 4)), time.monotonic())
    feed(good, "good")
    with eng._lock:
        assert eng._sessions.get("good") is good
    feed((_Poisoned(), time.monotonic()), "bad")
    with eng._lock:
        assert "bad" not in eng._sessions


ENGINE_CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
                if name.startswith("case_")}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_fake_pipe(case, request):
    """The fake-pipe engine cases, on the port's engine (each engine shut
    down after its case; the dispatch retry without its backoff)."""
    made = []

    def engines(pipe, call_kwargs, own=True, **kw):
        eng = ServingEngine(pipe, call_kwargs, **kw)
        eng.dispatch_retry_backoff_s = 0.0
        if own:
            made.append(eng)
        return eng

    fn = ENGINE_CASES[case]
    try:
        if "serving" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
            fn(engines, request.getfixturevalue("serving"))
        else:
            fn(engines)
    finally:
        for eng in made:
            eng.shutdown()


# ---------------------------------------------------------------------------
# (ii) the port's engine against the JAX pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bundles():
    unet_np, taesd_np, ctx = tiny_jax_trees(seed=5)
    jbundle = JBundle(
        unet_params=jax.tree.map(jnp.asarray, unet_np), unet_config=jreg.TINY_UNET_CONFIG,
        vae=JVAE(kind="tiny", params=jax.tree.map(jnp.asarray, taesd_np),
                 config=jreg.TINY_TAESD_CONFIG),
        text_context=jnp.asarray(ctx),
    )
    tbundle = from_jax_params(unet_np, taesd_np, ctx, unet_config=registry.TINY_UNET_CONFIG,
                              vae_config=registry.TINY_TAESD_CONFIG, device="cpu")
    return jbundle, tbundle


@pytest.fixture(scope="module")
def engine(bundles):
    eng = ServingEngine(DepthCompletionPipeline(bundles[1]), CALL_KWARGS, max_batch=4,
                        max_delay_ms=1000.0, beta=0.9)
    yield eng
    eng.shutdown()


def _rms(x):
    return float(np.sqrt(np.mean(np.square(x))))


def _assert_close_to_jax(port, ref):
    """tests/test_torch_sampler.py's bounds for a few guided steps (dense
    rms 1.2e-2, max 0.15 at max_depth 10)."""
    d = np.asarray(port) - np.asarray(ref)
    assert _rms(d) < 1.2e-2 and np.abs(d).max() < 0.15, (_rms(d), np.abs(d).max())


def test_coalesced_batch_and_session_match_jax(bundles, engine):
    """Three concurrent requests coalesce into one batch padded to 4, and
    each row matches the JAX pipeline's batch of the three frames; a
    session's second frame, carried through the engine, matches the JAX
    pipeline given the port's carried latents; the reset drops it."""
    jbundle, _ = bundles
    frames = [_frame(10 + i) for i in range(3)]
    before = engine.stats()
    reqs = [engine.submit(ServeRequest(image=img, sparse=sp)) for img, sp in frames]
    outs = [r.wait(timeout=600) for r in reqs]
    after = engine.stats()
    assert after["batches"] - before["batches"] == 1
    assert after["padded_rows"] - before["padded_rows"] == 1
    assert all(r._batch_size == 3 for r in reqs)
    kw = {k: v for k, v in CALL_KWARGS.items() if k != "max_depth"}
    want, _ = JPipe(jbundle)(np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames]),
                             MAX_DEPTH, **kw)
    for out, ref in zip(outs, np.asarray(want)):
        assert out.shape == (H, W, 1) and out.dtype == np.float32
        _assert_close_to_jax(out, ref)

    img_a, sp_a = _frame(20)
    img_b, sp_b = _frame(21)
    engine.complete(img_a, sp_a, session="cam0", timeout=600)
    carry = engine._sessions["cam0"][0]
    eh, ew = latent_size((H, W), 64, bundles[1].vae.downsample_factor)
    assert isinstance(carry, torch.Tensor) and tuple(carry.shape) == (1, eh, ew, 4)
    second = engine.complete(img_b, sp_b, session="cam0", timeout=600)
    want_b, _ = JPipe(jbundle)(img_b[None], sp_b[None], MAX_DEPTH,
                               pred_latents_prev=carry.numpy(), beta=0.9, **kw)
    _assert_close_to_jax(second, np.asarray(want_b)[0])
    fresh = engine.complete(img_b, sp_b, timeout=600)
    assert not np.allclose(second, fresh)  # the carry moved the trajectory
    assert engine.reset_session("cam0") is True and engine.reset_session("cam0") is False


# ---------------------------------------------------------------------------
# (iii) the HTTP round trip
# ---------------------------------------------------------------------------

def test_http_round_trip_and_errors(engine):
    srv = make_server(engine, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        status, data = _get(srv, "/healthz")
        assert status == 200 and json.loads(data)["status"] == "ok"
        img, sp = _frame(4)
        status, data, headers = _post(srv, "/v1/complete?session=vid1", _npz_payload(img, sp))
        assert status == 200, data
        dense = np.load(io.BytesIO(data))
        assert dense.shape == (H, W, 1) and dense.dtype == np.float32
        assert np.isfinite(dense).all()
        assert float(headers["X-DCT-Latency-S"]) > 0 and int(headers["X-DCT-Batch-Size"]) == 1
        status, data, _ = _post(srv, "/v1/session/vid1/reset", b"")
        assert status == 200 and json.loads(data) == {"session": "vid1", "dropped": True}
        status, data = _get(srv, "/v1/stats")
        stats = json.loads(data)
        assert status == 200 and stats["completed"] >= 1 and "latency_s_p50" in stats
        status, data, _ = _post(srv, "/v1/complete", b"not an npz")
        assert status == 400 and b"bad npz" in data
        status, data, _ = _post(srv, "/v1/complete", _npz_payload(img, np.zeros_like(sp)))
        assert status == 422 and b"No valid values" in data
        assert _get(srv, "/nope")[0] == 404 and _post(srv, "/v1/nope", b"")[0] == 404
    finally:
        srv.shutdown()
        srv.server_close()


# ---------------------------------------------------------------------------
# (iv) the serve CLI
# ---------------------------------------------------------------------------

SERVE_ARGV = [
    [],
    ["--model", "lcm", "--checkpoint-dir", "ckpt", "--taesd-dir", "taesd", "--vae", "original",
     "-n", "7", "-r", "512", "--norm", "percentile", "--percentile", "0.05,0.95",
     "--max-depth", "80", "--min-depth", "0.5", "-p", "fp32", "--loss-funcs", "l1,bogus,edge",
     "--opt", "sgd", "--lr-latent", "0.1", "--lr-scaling", "0.2", "--closed-form", "yes",
     "--projection", "log", "--inv", "T", "--train-latents", "0", "--train-method",
     "per-input", "--train-steps", "3", "--beta", "0.5", "--fast-guidance", "on"],
    ["--host", "0.0.0.0", "--port", "0", "--max-batch", "8", "--batch-buckets", "1,2,8",
     "--max-delay-ms", "0", "--session-ttl", "12.5", "--max-queue", "3", "--warmup",
     "480x640,352x1216", "--warmup-parallel", "3", "--warmup-tiered", "--tier-effort", "-0.5",
     "--max-programs", "6", "--log", "x.log", "--log-level", "DEBUG"],
    ["--warmup-tiered", "--no-warmup-tiered", "--percentile", "", "--batch-buckets", ""],
]
SERVE_BAD = [
    ["--steps", "0"], ["--beta", "1"], ["--beta", "0"], ["--max-depth", "0"], ["--port", "-1"],
    ["--tier-effort", "0.5"], ["--tier-effort", "-2"], ["--session-ttl", "0"],
    ["--max-batch", "0"], ["--batch-buckets", "a,b"], ["--vae", "kl"], ["--closed-form", "maybe"],
]


@pytest.mark.parametrize("argv", SERVE_ARGV, ids=lambda a: " ".join(a)[:40] or "defaults")
def test_serve_options_match_click(argv):
    want = j_serve.main.make_context("serve", list(argv)).params
    got = vars(serve.build_parser().parse_args(list(argv)))
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("argv", SERVE_BAD, ids=lambda a: " ".join(a))
def test_serve_bad_options_fail_on_both_sides(argv):
    with pytest.raises(click.UsageError):
        j_serve.main.make_context("serve", list(argv))
    with pytest.raises(SystemExit) as e:
        serve.build_parser().parse_args(list(argv))
    assert e.value.code == 2


def _help(parser, flag: str) -> str:
    return next(a.help for a in parser._actions if flag in a.option_strings)


def _click_help(command, flag: str) -> str:
    return next(p.help for p in command.params if flag in p.opts)


# flag → words its help must hold; the working flags must not call
# themselves no-ops, the others must say they are and why
HELP_PINS = {
    ("serve", "--warmup-tiered"): ("Serve first", "eager twin", "tier 0", "capture each",
                                  "between batches", "promoted"),
    ("serve", "--max-programs"): ("Bound the number of live captured", "least-recently-used",
                                  "evicted", "Default: unbounded (batch-job behavior)"),
    ("predict", "--compile-graph"): ("a no-op: every request already runs as", "CUDA graphs"),
    ("serve", "--warmup-parallel"): ("a no-op: the warmup runs its signatures",),
    ("serve", "--tier-effort"): ("a no-op: tier 0 is the eager twin",),
    ("predict", "--compile-mode"): ("a no-op: there is no compiler",),
    ("predict", "--compile-effort"): ("a no-op: capture has no effort level",),
}


@pytest.mark.parametrize("cli,flag", sorted(HELP_PINS), ids=lambda x: x)
def test_cli_help_says_what_each_flag_does(cli, flag):
    """The CLIs' help: --warmup-tiered and --max-programs say what they do
    (worded after the JAX serve CLI's help, whose key phrases they share),
    --compile-graph that the step is always captured, and the flags that do
    nothing on the card that they are no-ops and why."""
    from depth_completion_tpu.cli import predict as j_predict
    from depth_completion_tpu_torch.cli import predict

    port, jax_cli = {"serve": (serve, j_serve), "predict": (predict, j_predict)}[cli]
    text = _help(port.build_parser(), flag)
    for words in HELP_PINS[(cli, flag)]:
        assert words in text, (flag, words, text)
    if flag in ("--warmup-tiered", "--max-programs"):
        assert "no-op" not in text and "not ported" not in text
        shared = {"--warmup-tiered": "Serve first", "--max-programs": "Default: unbounded"}[flag]
        assert shared in _click_help(jax_cli.main, flag)
    else:
        assert "no-op" in text


def test_bench_serve_honours_max_programs_and_tiers():
    """``scripts/bench_serve_torch.py``'s CPU smoke (tiny model): with
    SB_MAX_PROGRAMS=1 the pipeline keeps one program where two geometries,
    two buckets and the carry would keep more; with SB_TIERED=1 the script
    waits until every warmed signature is promoted and reports ``tiered``,
    ``promote_s`` and ``tier_promoted``."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, SB_DEVICE="cpu", DCT_RANDOM_MODEL_SIZE="tiny", SB_RES="64",
               SB_GEOMETRY="48x64,64x48", SB_REQUESTS="4", SB_CLIENTS="2", SB_STEPS="1",
               SB_MAX_BATCH="2", SB_MAX_PROGRAMS="1", SB_TIERED="1", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, str(repo / "scripts" / "bench_serve_torch.py")],
                          cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["pipe_programs"] == 1 and out["requests"] == 4
    assert out["tiered"] is True and out["promote_s"] > 0
    promoted, warmed = map(int, out["tier_promoted"].split("/"))
    assert promoted == warmed == 4  # 2 geometries x buckets 1 and 2


def test_serve_cli_runs_and_refuses(monkeypatch):
    """run_serve on the CPU with the tiny random model warms 48x64 (buckets
    1 and 4, the carry) and answers over HTTP, logging the XLA flags as
    no-ops; --max-programs bounds the pipeline's programs; --warmup-tiered
    warms on the eager twin, promotes each signature and serves; without a
    GPU and without --device cpu it raises the device error."""
    monkeypatch.setenv("DCT_RANDOM_MODEL_SIZE", "tiny")
    base = ["--model", "random", "--steps", "1", "--res", "64", "--precision", "fp32",
            "--port", "0", "--log-level", "WARNING"]
    params = vars(serve.build_parser().parse_args(
        [*base, "--device", "cpu", "--warmup", "48x64", "--max-programs", "4",
         "--warmup-parallel", "2", "--log-level", "INFO"]))
    calls = []
    real = DepthCompletionPipeline.__call__
    monkeypatch.setattr(DepthCompletionPipeline, "__call__", lambda self, i, s, **k: (
        calls.append((i.shape[0], "pred_latents_prev" in k)) or real(self, i, s, **k)))
    engine, httpd = serve.run_serve(**params, serve_forever=False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        assert engine.warm and calls == [(1, False), (4, False), (1, True)]
        assert engine.pipe.max_programs == 4 and len(engine.pipe.program_keys()) == 2
        status, data, _ = _post(httpd, "/v1/complete", _npz_payload(*_frame(3)))
        assert status == 200 and np.load(io.BytesIO(data)).shape == (H, W, 1)
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.shutdown()
    calls.clear()
    params = vars(serve.build_parser().parse_args(
        [*base, "--device", "cpu", "--warmup", "48x64", "--warmup-tiered", "--max-batch", "2"]))
    engine, httpd = serve.run_serve(**params, serve_forever=False)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        assert engine.warm and calls[:3] == [(1, False), (2, False), (1, True)]
        deadline = time.monotonic() + 60
        while engine.stats().get("tier0_active") and time.monotonic() < deadline:
            time.sleep(0.05)
        st = engine.stats()
        assert "tier0_active" not in st and calls[3:] == [(1, False), (2, False)]
        assert [p["signature"] for p in st["tier_promotions"]] == [((H, W), 1), ((H, W), 2)]
        status, data, _ = _post(httpd, "/v1/complete", _npz_payload(*_frame(3)))
        assert status == 200 and np.load(io.BytesIO(data)).shape == (H, W, 1)
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.shutdown()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device|CUDA is not available"):
            serve.main(base)


# ---------------------------------------------------------------------------
# (v) fast guidance
# ---------------------------------------------------------------------------

def _saved(fn):
    """``fn()``'s tensors saved for backward: (count, bytes)."""
    count, nbytes = [0], [0]

    def pack(t):
        count[0] += 1
        nbytes[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return count[0], nbytes[0]


def test_fast_guidance_keeps_no_unet_graph(bundles):
    """With ``detach_unet_grad`` the step saves only what the decoder's
    loss saves (the guidance loss of the x0 preview, the same tensors the
    step differentiates) and no UNet tensor; the full step saves many
    times more. The sampler then equals JAX's with the same flag, at the
    bounds of tests/test_torch_sampler.py."""
    jbundle, tbundle = bundles
    img, sp = _frame(30)
    images, sparses = torch.from_numpy(img[None]), torch.from_numpy(sp[None])
    readings = {}
    for detach in (False, True, "decoder"):
        cfg = TS.SamplerConfig(steps=2, resolution=64, closed_form=False, max_depth=MAX_DEPTH,
                               detach_unet_grad=bool(detach))
        sched = TS.make_schedule(cfg.ddim)
        img_lat, lat0, dn, padding, orig_res = TS._prepare(tbundle, images, sparses, cfg, None)
        denoise = TS._Denoiser(tbundle, img_lat, TS.flash_attention)
        decode = functools.partial(TS.decode_prediction, tbundle)
        lat = lat0.clone().requires_grad_(True)
        aff = [torch.ones((1, 1, 1, 1), requires_grad=True),
               torch.zeros((1, 1, 1, 1), requires_grad=True)]
        if detach == "decoder":
            with torch.no_grad():
                out = denoise(lat, 999)
            x0 = TS.pred_original(sched, out, 999, lat.detach()).requires_grad_(True)
            readings[detach] = _saved(lambda: torch.autograd.grad(TS.guidance_loss(
                decode, cfg, dn, images, orig_res, padding, False, x0, aff, lat).sum(),
                [x0, *aff]))
        else:
            readings[detach] = _saved(lambda: TS.guided_step_grads(
                denoise, decode, sched, cfg, dn, images, orig_res, padding, False, lat, aff, 999))
    (n_full, b_full), (n_fast, b_fast), (n_dec, b_dec) = (
        readings[False], readings[True], readings["decoder"])
    assert n_fast <= n_dec + 2 and b_fast <= b_dec + 2 * lat.numel() * 4, readings
    assert n_full > 3 * n_fast, readings

    kw = dict(steps=2, resolution=64, closed_form=False, max_depth=MAX_DEPTH,
              detach_unet_grad=True)
    d_j, _ = jax.jit(JS.guided_sample, static_argnames=("cfg",))(
        jbundle, jnp.asarray(img[None]), jnp.asarray(sp[None]), JS.SamplerConfig(**kw))
    d_t, _ = TS.guided_sample(tbundle, images, sparses, TS.SamplerConfig(**kw),
                              programs=ProgramCache())
    _assert_close_to_jax(d_t.numpy(), np.asarray(d_j))


# ---------------------------------------------------------------------------
# (vi) remat "auto" per VAE kind, and the batch that does not fit
# ---------------------------------------------------------------------------

def test_remat_auto_per_vae_kind_and_batch_limit(monkeypatch):
    """Arithmetic against a stubbed 80 GB card: "auto" turns remat on where
    the step without it passes 90% of the memory, at a smaller batch with
    the KL decoder than with TAESD; above the largest batch that fits even
    with remat the error names that batch; the CPU checks nothing."""
    card = 80 * 10**9
    monkeypatch.setattr(TS, "card_memory_bytes", lambda device: card)
    cuda, hw = torch.device("cuda"), (72, 96)
    budget = TS.REMAT_MEMORY_SHARE * card
    cfg = TS.SamplerConfig()
    first_on = {}
    for kind in ("tiny", "kl"):
        on = [n for n in range(1, 65) if TS.resolve_remat(cfg, n, hw, cuda, kind)]
        first_on[kind] = on[0]
        assert TS.step_peak_bytes(kind, False, on[0], hw) > budget
        assert TS.step_peak_bytes(kind, False, on[0] - 1, hw) <= budget
        limit = TS.largest_batch(kind, hw, cuda)
        assert TS.step_peak_bytes(kind, True, limit, hw) <= budget
        assert TS.step_peak_bytes(kind, True, limit + 1, hw) > budget
        TS.check_batch_fits(kind, limit, hw, cuda)
        with pytest.raises(ValueError, match=f"the largest batch that fits at this geometry "
                                             f"is {limit}$"):
            TS.check_batch_fits(kind, limit + 1, hw, cuda)
        TS.check_batch_fits(kind, 10**6, hw, torch.device("cpu"))
        assert not TS.resolve_remat(cfg, 10**6, hw, torch.device("cpu"), kind)
        for setting, want in (("on", True), ("off", False), (True, True), (False, False)):
            assert TS.resolve_remat(TS.SamplerConfig(remat_unet=setting), 1, hw, cuda, kind) \
                is want
    assert first_on["kl"] < first_on["tiny"]
    assert TS.largest_batch("kl", hw, cuda) < TS.largest_batch("tiny", hw, cuda)


def test_fp32_rows_refuse_or_rematerialise(monkeypatch):
    """``STEP_PEAK_BYTES`` is keyed by the bundle's dtype: a batch that the
    bf16 rows run without remat rematerialises at fp32, and a batch that
    the bf16 rows let through is refused at fp32 with the fp32 limit named
    (stubbed 80 GB card)."""
    card = 80 * 10**9
    monkeypatch.setattr(TS, "card_memory_bytes", lambda device: card)
    cuda, hw = torch.device("cuda"), (72, 96)
    cfg = TS.SamplerConfig()
    for kind in ("tiny", "kl"):
        for remat in (False, True):
            bf16 = TS.step_peak_bytes(kind, remat, 1, hw)
            assert TS.step_peak_bytes(kind, remat, 1, hw, torch.bfloat16) == bf16
            assert TS.step_peak_bytes(kind, remat, 1, hw, torch.float32) > bf16
        remat_at = [n for n in range(1, 65)
                    if TS.resolve_remat(cfg, n, hw, cuda, kind, torch.float32)
                    and not TS.resolve_remat(cfg, n, hw, cuda, kind, torch.bfloat16)]
        assert remat_at, kind
        limit32 = TS.largest_batch(kind, hw, cuda, torch.float32)
        assert limit32 < TS.largest_batch(kind, hw, cuda)
        TS.check_batch_fits(kind, limit32 + 1, hw, cuda)  # bf16: fits
        with pytest.raises(ValueError, match=f"the largest batch that fits at this geometry "
                                             f"is {limit32}$"):
            TS.check_batch_fits(kind, limit32 + 1, hw, cuda, torch.float32)
