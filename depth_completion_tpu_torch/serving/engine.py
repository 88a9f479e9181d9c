"""Serving engine: micro-batching, session carry, warmup. PyTorch counterpart
of ``depth_completion_tpu.serving.engine``; the host logic is the JAX
engine's, with its names.

- One compute thread owns every launch; HTTP and caller threads only
  enqueue. A finisher thread hands results back, so the host's fetch of one
  batch overlaps the next batch's launches (up to two batches in flight).
  The compute thread starts each batch's dense rows on their way to the
  host right after ``pipe(...)`` returns (a non-blocking copy into pinned
  memory, then a recorded CUDA event); the finisher waits on that event,
  not behind the next batch queued on the same stream. A device error
  surfaces there, as JAX's does when a result is materialised.
- Same-geometry micro-batching: requests whose frames share (H, W) are
  stacked and padded with copies of row 0 to the smallest batch bucket
  that fits (default {1, max_batch}); padded rows are computed and
  discarded. Each geometry has its own FIFO, served round-robin.
- Sessions: a video stream passes ``session=<id>`` and the engine carries
  the previous frame's final latent (a tensor on the card) into the next
  request (``beta*noise + (1-beta)*prev``); carry requests run alone.
- The sampler config is fixed at construction: requests asking for another
  one would need another warmup. Admission checks each request on the host
  (shape, the empty-sparse and degenerate-range errors) so that one bad
  request cannot fail a shared batch, and sheds load beyond ``max_queue``
  pending requests.
- One bounded retry per request after a failed dispatch or fetch. A sticky
  CUDA error (an illegal address) fails every later call: the retry fails
  too and the requests resolve with the error; nothing hangs.

- Programs: the pipeline keeps one program per signature, whatever the
  sampler branch (on the card, captured CUDA graphs of the request's
  prepare step, its steps and its final decode, ``pipeline.programs``);
  the carry shares its geometry's bucket-1 program (the carry only changes
  the initial latent). ``warmup`` captures each (geometry, bucket) program
  before traffic.
- Tiered warmup ("serve first, optimise later", JAX ``engine.py:285-496``):
  tier 0 is the pipeline's eager twin (``pipe.twin()``), tier 1 its
  captured graph. ``warmup(tiered=True)`` runs every signature on tier 0
  and opens for traffic; the compute thread then promotes one signature at
  a time, between batches (at most one capture between two batches, and
  back to back while idle), after the batches in flight have reached the
  host: a capture must not overlap the finisher's copies. Promotion times
  are in ``stats()["tier_promotions"]``. A capture that still fails after
  ``promote_retries`` retries is not hidden behind tier 0 (as JAX does):
  the batches of its signature fail with its error, and the signature is
  listed in ``stats()["tier_failed"]``.
- With ``max_programs`` below the warmed signature count, a promoted
  program can be evicted by a later promotion; dispatch then serves that
  signature from tier 0 rather than capture again on the compute thread
  (JAX :716-747), and tier 0 stays while any promoted program is evicted
  (JAX drops it once all are promoted: its evicted programs recompile for
  minutes, where a capture here churns the pool).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from depth_completion_tpu_torch.logger import logger
from depth_completion_tpu_torch.ops.resize import latent_size
from depth_completion_tpu_torch.pipeline.programs import signature


_PROMOTE = object()  # _next_request: promote a signature before the next batch


class OverloadedError(RuntimeError):
    """Raised by submit() when the request queue is at max_queue depth."""


@dataclass
class ServeRequest:
    """One depth-completion request (host arrays, NHWC semantics)."""

    image: np.ndarray  # [H,W,3] RGB, 0..255
    sparse: np.ndarray  # [H,W] or [H,W,1] metric depth, 0 = missing
    session: str | None = None
    # filled by the engine:
    _done: threading.Event = field(default_factory=threading.Event, repr=False)
    _result: np.ndarray | None = field(default=None, repr=False)
    _error: Exception | None = field(default=None, repr=False)
    _enqueued_at: float = 0.0
    _batch_size: int = 0
    _cancelled: bool = False
    # one bounded retry per request: a transient device error must not fail
    # a whole micro-batch
    _retried: bool = False

    def wait(self, timeout: float | None = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError("depth completion request timed out")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result

    def cancel(self) -> None:
        """Mark the request abandoned: if it has not started computing, the
        worker drops it instead of spending seconds of device time on a
        result nobody will read. A request already inside a batch completes
        normally (its result is discarded)."""
        self._cancelled = True


def _to_host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _HostCopy:
    """A batch's first ``n`` dense rows on their way from the card to pinned
    host memory: the copy and its event are queued on the compute thread's
    stream; ``wait()`` blocks only until that copy is done."""

    def __init__(self, denses: torch.Tensor, n: int):
        rows = denses[:n]
        self.host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        self.host.copy_(rows, non_blocking=True)
        self.done = torch.cuda.Event()
        self.done.record()

    def wait(self) -> np.ndarray:
        self.done.synchronize()
        return self.host.numpy()


def _materialize(denses: Any, n: int) -> np.ndarray:
    if isinstance(denses, _HostCopy):
        return denses.wait()
    return _to_host(denses)[:n]


class ServingEngine:
    """Keeps a ``DepthCompletionPipeline`` warm and serves requests.

    Args:
        pipe: a ``DepthCompletionPipeline`` (or any callable with its
            signature returning (denses, latents)).
        call_kwargs: fixed sampler kwargs passed to every ``pipe(...)`` call
            (steps, resolution, loss_funcs, norm, ... and ``max_depth``,
            which is required).
        max_batch: micro-batch size; also the largest batch bucket.
        max_delay_ms: how long the batcher waits for same-geometry
            batchmates after the first request of a batch arrives.
        session_ttl_s: idle seconds after which a session's carry latent
            is dropped.
        batch_buckets: padded batch sizes; a coalesced batch runs the
            smallest bucket that fits. Default {1, max_batch}. max_batch is
            always included; buckets above it are dropped.
    """

    def __init__(
        self,
        pipe: Any,
        call_kwargs: dict[str, Any],
        *,
        max_batch: int = 4,
        max_delay_ms: float = 25.0,
        session_ttl_s: float = 300.0,
        beta: float | None = None,
        max_queue: int = 256,
        batch_buckets: tuple[int, ...] | None = None,
    ) -> None:
        if "max_depth" not in call_kwargs:
            raise ValueError("call_kwargs must include max_depth")
        self.pipe = pipe
        self.call_kwargs = dict(call_kwargs)
        self.max_batch = int(max_batch)
        self.max_delay_ms = float(max_delay_ms)
        self.session_ttl_s = float(session_ttl_s)
        self.max_queue = int(max_queue)
        if batch_buckets is None:
            buckets = {1, self.max_batch}
        else:
            buckets = {int(b) for b in batch_buckets}
            if any(b < 1 for b in buckets):
                raise ValueError(f"batch buckets must be >= 1: {batch_buckets}")
            buckets.add(self.max_batch)  # largest bucket must fit max_batch
            buckets = {b for b in buckets if b <= self.max_batch}
        self.batch_buckets = tuple(sorted(buckets))
        if beta is not None:
            self.call_kwargs["beta"] = float(beta)

        # Per-geometry FIFO queues with round-robin dispatch, guarded by
        # _cv; lock nesting is always _cv → _lock, never the reverse.
        self._cv = threading.Condition()
        self._queues: dict[tuple[int, int], deque[ServeRequest]] = {}
        self._rr: deque[tuple[int, int]] = deque()  # round-robin key order
        # Admitted-but-unresolved requests: queued, collected and in flight.
        self._pending = 0
        self._sessions: dict[str, tuple[Any, float]] = {}
        self._lock = threading.Lock()
        self._stats = {
            "requests": 0,
            "completed": 0,
            "errors": 0,
            "rejected": 0,
            "cancelled": 0,
            "retried_batches": 0,
            "batches": 0,
            "batched_rows": 0,
            "padded_rows": 0,
            "compiled_geometries": [],
        }
        self._latencies: deque[float] = deque(maxlen=512)
        # tiered warmup: tier-0 pipe, its warmed signatures ((h, w), bucket),
        # the promoted ones, the promotions still to run (job, failures) and
        # when each landed (seconds after warmup returned)
        self._tier_lock = threading.Lock()
        self._tier0_pipe: Any = None
        self._tier0_ready: set[tuple] = set()
        self._full_ready: set[tuple] = set()
        self._promotions: deque[tuple] = deque()
        self._promotion_log: list[dict] = []
        self._failed_promotions: dict[tuple, Exception] = {}
        self._tiered_at = 0.0
        self._promoted_last = False  # the compute thread's last act was a promotion
        # a failed promotion is retried this many times, then the batches of
        # its signature fail with its error
        self.promote_retries = 2
        self._warm = False
        self._stop = False
        # pause before the one bounded batch retry (tests shrink it)
        self.dispatch_retry_backoff_s = 0.5
        # the card the compute thread launches on (the current device is
        # per thread)
        device = getattr(getattr(pipe, "bundle", None), "device", None)
        self._device = device if isinstance(device, torch.device) else None
        # at most two batches in flight between dispatch and finish
        self._finish: queue.Queue[tuple | None] = queue.Queue(maxsize=2)
        self._thread = threading.Thread(
            target=self._worker, name="dct-serving-worker", daemon=True
        )
        self._finisher = threading.Thread(
            target=self._finisher_loop, name="dct-serving-finisher", daemon=True
        )
        self._thread.start()
        self._finisher.start()

    # ------------------------------------------------------------- public

    def submit(self, req: ServeRequest) -> ServeRequest:
        req.sparse = np.asarray(req.sparse)
        if req.sparse.ndim == 2:
            req.sparse = req.sparse[..., None]
        req.image = np.asarray(req.image)
        if req.image.ndim != 3 or req.image.shape[-1] != 3:
            raise ValueError(f"image must be [H,W,3], got {req.image.shape}")
        if req.sparse.shape[:2] != req.image.shape[:2]:
            raise ValueError(
                f"sparse {req.sparse.shape} does not match image "
                f"{req.image.shape}"
            )
        # Per-request validity at admission (the pipeline's empty-sparse
        # contract): checking here keeps one invalid request from failing
        # the whole micro-batch it would share.
        if not (req.sparse > 0).any():
            raise ValueError(
                "No valid values found in mask for some positions. Ensure "
                "that mask has at least one True value along the specified "
                "dimensions. (sparse frame has no points > 0)"
            )
        # Degenerate-range guard (as in the pipeline): under minmax or
        # percentile normalisation a constant-valued sparse frame divides
        # by zero in the normaliser.
        norm = self.call_kwargs.get("norm", "minmax")
        if norm in ("minmax", "percentile"):
            vals = req.sparse[req.sparse > 0]
            if norm == "minmax":
                lo, hi = float(vals.min()), float(vals.max())
            else:
                pct = self.call_kwargs.get("percentile", (0.01, 0.99))
                lo, hi = (float(q) for q in np.quantile(vals, pct))
            lo = max(lo, float(self.call_kwargs.get("min_depth", 0.0)))
            hi = min(hi, float(self.call_kwargs["max_depth"]))
            if not hi > lo:
                raise ValueError(
                    f"Degenerate sparse depth range: norm={norm!r} "
                    f"estimated [{lo}, {hi}] — all valid points share one "
                    "value (or the range collapses after clamping). Use "
                    "norm='const' or provide varied sparse points."
                )
        # bounded admission on the pending counter
        with self._lock:
            if self._pending >= self.max_queue:
                self._stats["rejected"] += 1
                raise OverloadedError(
                    f"request queue full ({self.max_queue} pending)"
                )
            self._pending += 1
            self._stats["requests"] += 1
        req._enqueued_at = time.monotonic()
        with self._cv:
            key = tuple(req.image.shape[:2])
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = deque()
                self._rr.append(key)
            q.append(req)
            self._cv.notify()
        return req

    def complete(
        self,
        image: np.ndarray,
        sparse: np.ndarray,
        session: str | None = None,
        timeout: float | None = None,
    ) -> np.ndarray:
        """Synchronous convenience wrapper: submit and wait."""
        return self.submit(
            ServeRequest(image=image, sparse=sparse, session=session)
        ).wait(timeout)

    def _make_tier0_pipe(self, effort: float) -> Any:
        """Tier 0: the pipeline's eager twin, sharing its bundle (``effort``,
        JAX's compile effort, has no counterpart: one capture form)."""
        del effort
        return self.pipe.twin()

    def warmup(
        self,
        geometries: list[tuple[int, int]],
        parallel: int | None = None,
        tiered: bool = False,
        tier_effort: float = -1.0,
    ) -> None:
        """Run every (geometry, batch-bucket) signature once, plus the
        session-carry job per geometry, one after another, so the first live
        request pays none of the start-up: each signature's program is
        captured (the carry replays its geometry's bucket-1 program), the
        kernels are built, cuDNN has chosen its plans. A bucket the card
        cannot hold raises here (``sampler.check_batch_fits``), not on live
        traffic.

        Calls the pipeline directly: no traffic is flowing yet.
        ``tiered=True``: the jobs run on tier 0 (the eager twin) and the
        engine opens at once; each signature's graph is captured later, on
        the compute thread between batches (class docstring). ``parallel``
        > 1 runs serially all the same (one card gains nothing from
        concurrent warmup); ``tier_effort`` is ignored (one capture form).
        """
        if parallel is not None and parallel > 1:
            logger.info(f"warmup(parallel={parallel}) runs serially: one card gains "
                        "nothing from concurrent warmup")
        if tiered:
            with self._tier_lock:
                self._tier0_pipe = self._make_tier0_pipe(tier_effort)
                self._tier0_ready, self._full_ready = set(), set()
                self._promotion_log, self._failed_promotions = [], {}
        rng = np.random.default_rng(0)
        jobs: list[tuple[tuple, np.ndarray, np.ndarray, np.ndarray | None]] = []
        resolution = int(self.call_kwargs.get("resolution", 768))
        vae = getattr(getattr(self.pipe, "bundle", None), "vae", None)
        factor = getattr(vae, "downsample_factor", 8)  # only test fakes lack a bundle
        channels = getattr(getattr(vae, "config", None), "latent_channels", 4)
        for h, w in geometries:
            img = rng.uniform(0, 255, size=(h, w, 3)).astype(np.float32)
            sparse = np.zeros((h, w, 1), np.float32)
            sparse[h // 2, w // 2, 0] = 1.0
            sparse[h // 4, w // 4, 0] = self.call_kwargs["max_depth"] / 2
            for b in self.batch_buckets:
                jobs.append((((h, w), b), np.repeat(img[None], b, 0),
                             np.repeat(sparse[None], b, 0), None))
            # the carry job (sessions run alone, so batch 1 suffices); zeros
            # are a valid prior latent; it shares the bucket-1 signature
            eh, ew = latent_size((h, w), resolution, factor)
            jobs.append((((h, w), 1), img[None], sparse[None],
                         np.zeros((1, eh, ew, channels), np.float32)))
        first_pipe = self._tier0_pipe if tiered else self.pipe
        for job in jobs:
            self._run_job(first_pipe, job)
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        if tiered:
            with self._tier_lock:
                self._tier0_ready = {job[0] for job in jobs}
            with self._cv:
                # one capture per (geometry, bucket): the carry jobs share them
                self._promotions = deque((job, 0) for job in jobs if job[3] is None)
                self._tiered_at = time.monotonic()
                self._cv.notify()
        self._warm = True

    def _run_job(self, pipe: Any, job: tuple) -> None:
        _, images, sparses, carry = job
        kwargs = dict(self.call_kwargs)
        if carry is not None:
            kwargs["pred_latents_prev"] = carry
        pipe(images, sparses, **kwargs)

    def _promote_next(self) -> None:
        """Promote one signature to its captured graph, on the compute
        thread, once the batches in flight have reached the host."""
        with self._cv:
            if not self._promotions:
                return
            job, failures = self._promotions.popleft()
        self._finish.join()  # no finisher copy overlaps the capture
        try:
            self._run_job(self.pipe, job)
            if self._device is not None and self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
        except Exception as exc:
            exc.__traceback__ = None
            if failures < self.promote_retries:
                with self._cv:
                    self._promotions.append((job, failures + 1))
            else:
                logger.error(f"tiered warmup: signature {job[0]} failed promotion "
                             f"{failures + 1} times; its batches fail: {exc}")
                with self._tier_lock:
                    self._failed_promotions[job[0]] = exc
            return
        with self._tier_lock:
            self._full_ready.add(job[0])
            self._promotion_log.append({"signature": job[0],
                                        "s": time.monotonic() - self._tiered_at})
            self._maybe_drop_tier0()

    def _maybe_drop_tier0(self) -> None:
        """Drop tier 0 once every warmed signature is promoted and its
        program is live (with ``_tier_lock`` held)."""
        if self._tier0_pipe is None or not self._full_ready >= self._tier0_ready:
            return
        if any(not self._program_alive(key) for key in self._tier0_ready):
            return
        self._tier0_pipe = None

    def _program_alive(self, key: tuple) -> bool:
        """Whether the pipeline's program for signature ``key`` ((h, w),
        bucket) is live; pipes without a bound keep every program."""
        return getattr(self.pipe, "max_programs", None) is None or self._has_program(key)

    def _has_program(self, key: tuple) -> bool:
        (h, w), n = key
        return any(signature(pk)[:3] == (n, h, w) for pk in self.pipe.program_keys())

    @property
    def warm(self) -> bool:
        return self._warm

    def stats(self) -> dict[str, Any]:
        with self._lock:
            out = dict(self._stats)
            out["compiled_geometries"] = list(out["compiled_geometries"])
            lats = sorted(self._latencies)
            out["sessions_active"] = len(self._sessions)
        if lats:
            out["latency_s_p50"] = round(lats[len(lats) // 2], 4)
            out["latency_s_p95"] = round(lats[int(len(lats) * 0.95)], 4)
        with self._cv:
            out["queue_depth"] = sum(len(q) for q in self._queues.values())
            out["geometry_queues"] = {
                f"{h}x{w}": len(q) for (h, w), q in self._queues.items() if q
            }
        with self._lock:
            out["pending"] = self._pending
        if hasattr(self.pipe, "program_keys"):
            keys = self.pipe.program_keys()
            out["pipe_programs"] = len(keys)
            out["compiled_programs"] = [(h, w, n) for n, h, w, _ in map(signature, keys)]
        with self._tier_lock:
            if self._tier0_pipe is not None:
                out["tier0_active"] = True
                out["tier_promoted"] = f"{len(self._full_ready)}/{len(self._tier0_ready)}"
            out["tier_promotions"] = [dict(p) for p in self._promotion_log]
            out["tier_failed"] = list(self._failed_promotions)
        return out

    def reset_session(self, session: str) -> bool:
        with self._lock:
            return self._sessions.pop(session, None) is not None

    def shutdown(self, timeout: float = 10.0) -> None:
        self._stop = True
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout)
        self._finish.put(None)
        self._finisher.join(timeout)
        # Final drain: a retry requeue racing the worker's own leftover
        # cleanup could strand requests in a queue nobody reads.
        exc = RuntimeError("serving engine shut down")
        with self._cv:
            leftovers = [r for q in self._queues.values() for r in q]
            for q in self._queues.values():
                q.clear()
        for r in leftovers:
            self._resolve(r, exc)

    # ------------------------------------------------------------- worker

    def _resolve(self, req: ServeRequest, error: Exception | None = None) -> None:
        """Resolve a request (success fields already set, or an error) and
        release its admission slot. Every _done.set() goes through here so
        the pending counter stays exact."""
        if error is not None:
            req._error = error
        with self._lock:
            self._pending -= 1
        req._done.set()

    def _reap_cancelled(self, req: ServeRequest) -> bool:
        """True if the request was abandoned by its waiter; resolve it
        without device work."""
        if not req._cancelled:
            return False
        with self._lock:
            self._stats["cancelled"] += 1
        self._resolve(req, RuntimeError("request cancelled by caller"))
        return True

    def _next_request(self) -> ServeRequest | None | object:
        """Next request, round-robin across geometry queues; blocks until
        one is available or shutdown (returns None). With promotions
        pending it returns ``_PROMOTE`` where one is due: while no request
        waits, or when the last act was a batch (at most one capture
        between two batches)."""
        with self._cv:
            while True:
                queued = any(self._queues.get(k) for k in self._rr)
                if self._promotions and not self._stop and (
                        not queued or not self._promoted_last):
                    return _PROMOTE
                for _ in range(len(self._rr)):
                    key = self._rr[0]
                    self._rr.rotate(-1)  # next round starts after this key
                    q = self._queues.get(key)
                    if q:
                        return q.popleft()
                if self._stop:
                    return None
                self._cv.wait(timeout=0.5)

    def _collect_batch(self, first: ServeRequest) -> list[ServeRequest]:
        """Greedily gather same-geometry, sessionless batchmates from the
        geometry's own queue until max_batch or the delay deadline. Session
        (carry) requests always run alone and keep their FIFO slot:
        collection stops at a session head rather than jumping past it."""
        batch = [first]
        if first.session is not None or self.max_batch <= 1:
            return batch
        key = tuple(first.image.shape[:2])
        deadline = time.monotonic() + self.max_delay_ms / 1e3
        with self._cv:
            q = self._queues[key]
            while len(batch) < self.max_batch:
                while q and len(batch) < self.max_batch:
                    nxt = q[0]
                    if nxt._cancelled:
                        q.popleft()
                        self._reap_cancelled(nxt)
                        continue
                    if nxt.session is not None:
                        return batch  # runs alone next round, in order
                    batch.append(q.popleft())
                if len(batch) >= self.max_batch or self._stop:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
        return batch

    def _worker(self) -> None:
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while True:
            first = self._next_request()
            if first is None:
                break
            if first is _PROMOTE:
                self._promote_next()
                self._promoted_last = True
                continue
            self._promoted_last = False
            if self._reap_cancelled(first):
                continue
            batch = self._collect_batch(first)
            try:
                self._run_batch(batch)
            except Exception as exc:
                # the traceback's frames hold the failed batch's tensors:
                # drop them before the retry allocates again (an
                # out-of-memory error surfaces at dispatch)
                exc.__traceback__ = None
                logger.warning(f"a batch of {len(batch)} failed at dispatch: "
                               f"{type(exc).__name__}: {exc}")
                # One bounded retry PER REQUEST: only the already-retried
                # requests of a batch fail; fresh batchmates get their own
                # retry. Deterministic errors simply fail again.
                fresh = [r for r in batch if not r._retried]
                stale = [r for r in batch if r._retried]
                if stale:
                    with self._lock:
                        self._stats["errors"] += len(stale)
                    for r in stale:
                        self._resolve(r, exc)
                if fresh:
                    for r in fresh:
                        r._retried = True
                    with self._lock:
                        self._stats["retried_batches"] += 1
                    time.sleep(self.dispatch_retry_backoff_s)
                    try:
                        self._run_batch(fresh)
                    except Exception as exc2:
                        exc2.__traceback__ = None
                        with self._lock:
                            self._stats["errors"] += len(fresh)
                        for r in fresh:
                            self._resolve(r, exc2)
            self._sweep_sessions()
        # fail any requests still queued at shutdown instead of letting
        # their waiters hang until timeout
        exc_ = RuntimeError("serving engine shut down")
        with self._cv:
            leftovers = [r for q in self._queues.values() for r in q]
            for q in self._queues.values():
                q.clear()
        for r in leftovers:
            self._resolve(r, exc_)

    def _sweep_sessions(self) -> None:
        """Drop expired carry latents for all sessions (not only re-used
        keys): one O(sessions) scan per batch keeps a stream of fresh
        session ids from growing the dict without bound."""
        now = time.monotonic()
        with self._lock:
            dead = [
                k
                for k, (_, ts) in self._sessions.items()
                if now - ts > self.session_ttl_s
            ]
            for k in dead:
                del self._sessions[k]

    def _run_batch(self, batch: list[ServeRequest]) -> None:
        """Dispatch one batch and hand it to the finisher; blocks only when
        two batches are already in flight."""
        n = len(batch)
        geo = tuple(batch[0].image.shape[:2])
        images = np.stack([r.image for r in batch]).astype(np.float32)
        sparses = np.stack([r.sparse for r in batch]).astype(np.float32)
        # pad to the smallest bucket >= n with copies of row 0
        if batch[0].session is None:
            bucket = min(b for b in self.batch_buckets if b >= n)
            pad = bucket - n
        else:
            pad = 0
        if pad:
            images = np.concatenate([images, images[:1].repeat(pad, 0)])
            sparses = np.concatenate([sparses, sparses[:1].repeat(pad, 0)])

        kwargs = dict(self.call_kwargs)
        session = batch[0].session
        prev_held = None
        if session is not None:
            now = time.monotonic()
            with self._lock:
                held = self._sessions.get(session)
                if held is not None and now - held[1] > self.session_ttl_s:
                    held = None
                    self._sessions.pop(session, None)
            prev_held = held  # restored if this dispatch fails (retry path)
            if held is not None:
                kwargs["pred_latents_prev"] = held[0]

        # tiered warmup: a signature not yet promoted, or whose promoted
        # program the pipeline's LRU has evicted, runs on tier 0
        key = (geo, n + pad)
        with self._tier_lock:
            failed = self._failed_promotions.get(key)
            if failed is not None:
                raise RuntimeError(f"the program of signature {key} failed to capture: "
                                   f"{type(failed).__name__}: {failed}")
            tier0 = self._tier0_pipe is not None and key in self._tier0_ready and (
                key not in self._full_ready or not self._program_alive(key))
            pipe = self._tier0_pipe if tier0 else self.pipe
        if pipe is self.pipe and hasattr(pipe, "program_keys") and not self._has_program(key):
            # a signature's first request captures its graph: not while the
            # finisher copies an earlier batch
            self._finish.join()

        denses, latents = pipe(images, sparses, **kwargs)
        if isinstance(denses, torch.Tensor) and denses.is_cuda:
            denses = _HostCopy(denses, n)

        if session is not None:
            # the latents stay on the card; the session's next frame queues
            # behind this batch on the same stream
            with self._lock:
                self._sessions[session] = (latents, time.monotonic())

        self._finish.put((batch, n, pad, geo, denses, session, prev_held))

    def _requeue_batch(self, batch: list[ServeRequest], geo: tuple) -> None:
        """Put a failed batch back near the front of its geometry queue so
        the compute thread redispatches it (the finisher never launches
        device work itself), after any already-requeued requests at the
        front, so that FIFO, and a session's frame order, hold."""
        with self._cv:
            q = self._queues.get(geo)
            if q is None:
                q = self._queues[geo] = deque()
                self._rr.append(geo)
            idx = 0
            while idx < len(q) and q[idx]._retried:
                idx += 1
            for i, r in enumerate(batch):
                q.insert(idx + i, r)
            self._cv.notify()

    def _finisher_loop(self) -> None:
        """Wait for dispatched batches' results and resolve their waiters,
        off the compute thread."""
        while True:
            item = self._finish.get()
            try:
                if item is None:
                    break
                self._finish_batch(*item)
            finally:
                self._finish.task_done()

    def _finish_batch(self, batch, n, pad, geo, denses, session, prev_held) -> None:
        """Resolve one dispatched batch's waiters (or hand it back for its
        retry)."""
        try:
            denses = _materialize(denses, n)
        except Exception as exc:  # a device error surfaces here
            exc.__traceback__ = None
            # restore the session carry the failed dispatch overwrote,
            # if it is itself readable, then hand the batch back to the
            # compute thread for one bounded retry
            if session is not None:
                restored = False
                if prev_held is not None:
                    try:
                        _to_host(prev_held[0])
                        restored = True
                    except Exception:
                        restored = False
                with self._lock:
                    if restored:
                        self._sessions[session] = prev_held
                    else:
                        self._sessions.pop(session, None)
            fresh = [r for r in batch if not r._retried]
            stale = [r for r in batch if r._retried]
            if self._stop:
                stale, fresh = batch, []
            if stale:
                with self._lock:
                    self._stats["errors"] += len(stale)
                for r in stale:
                    self._resolve(r, exc)
            if fresh:
                for r in fresh:
                    r._retried = True
                with self._lock:
                    self._stats["retried_batches"] += 1
                time.sleep(self.dispatch_retry_backoff_s)
                self._requeue_batch(fresh, geo)
            return
        done_at = time.monotonic()
        with self._lock:
            self._stats["completed"] += n
            self._stats["batches"] += 1
            self._stats["batched_rows"] += n
            self._stats["padded_rows"] += pad
            if geo not in self._stats["compiled_geometries"]:
                self._stats["compiled_geometries"].append(geo)
            for r in batch:
                self._latencies.append(done_at - r._enqueued_at)
        for i, r in enumerate(batch):
            r._result = denses[i]
            r._batch_size = n
            self._resolve(r)
