"""Stdlib HTTP front end for the serving engine, PyTorch counterpart of
``depth_completion_tpu.serving.server``, with its wire format:

- ``POST /v1/complete``: body an ``.npz`` archive with arrays ``image``
  ([H,W,3] RGB 0..255) and ``sparse`` ([H,W] or [H,W,1] metric depth,
  0 = missing); query ``session=<id>`` for the temporal latent carry.
  Response: ``.npy`` of the dense depth ([H,W,1] float32), with the
  ``X-DCT-Latency-S`` and ``X-DCT-Batch-Size`` headers.
- ``GET /healthz``: 200 ``{"status": "ok", "warm": true|false}``.
- ``GET /v1/stats``: batching and latency counters as JSON.
- ``POST /v1/session/<id>/reset``: drop a session's carry latent.

Status codes: 400 for a payload that is not such an npz, 404 for an
unknown path, 422 for an invalid request (the engine's admission errors),
503 when the engine sheds load, 504 when the wait times out (the request
is cancelled), 500 for an engine or device failure.

The HTTP threads only enqueue; every launch happens on the engine's
compute thread. ``ThreadingHTTPServer`` takes requests concurrently, which
is what lets a micro-batch fill.
"""

from __future__ import annotations

import io
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from depth_completion_tpu_torch.logger import logger
from depth_completion_tpu_torch.serving.engine import (
    OverloadedError,
    ServeRequest,
    ServingEngine,
)


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
    engine: ServingEngine  # set by make_server
    request_timeout_s: float = 600.0

    # access logs go through the port's logger at debug level
    def log_message(self, fmt: str, *args: object) -> None:
        logger.debug("http: " + fmt % args)

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        path = urlparse(self.path).path
        if path == "/healthz":
            self._json(200, {"status": "ok", "warm": self.engine.warm})
        elif path == "/v1/stats":
            self._json(200, self.engine.stats())
        else:
            self._json(404, {"error": f"unknown path {path}"})

    def do_POST(self) -> None:  # noqa: N802
        parsed = urlparse(self.path)
        path = parsed.path
        if path.startswith("/v1/session/") and path.endswith("/reset"):
            sid = path[len("/v1/session/") : -len("/reset")]
            existed = self.engine.reset_session(sid)
            self._json(200, {"session": sid, "dropped": existed})
            return
        if path != "/v1/complete":
            self._json(404, {"error": f"unknown path {path}"})
            return

        try:
            length = int(self.headers.get("Content-Length", "0"))
            with np.load(io.BytesIO(self.rfile.read(length))) as npz:
                image = npz["image"]
                sparse = npz["sparse"]
        except Exception as exc:
            self._json(400, {"error": f"bad npz payload: {exc}"})
            return

        q = parse_qs(parsed.query)
        session = q.get("session", [None])[0]

        t0 = time.monotonic()
        try:
            req = self.engine.submit(
                ServeRequest(image=image, sparse=sparse, session=session)
            )
            dense = req.wait(timeout=self.request_timeout_s)
        except (ValueError, TimeoutError, OverloadedError) as exc:
            # invalid input, a timed-out wait, or an overloaded server:
            # a timeout is 504 (the work may still complete), load shedding
            # 503 (retry against another replica)
            if isinstance(exc, TimeoutError):
                req.cancel()  # no device time on an answer nobody reads
                code = 504
            elif isinstance(exc, ValueError):
                code = 422
            else:
                code = 503
            self._json(code, {"error": str(exc)})
            return
        except Exception as exc:  # engine or device failure re-raised by wait()
            self._json(500, {"error": f"{type(exc).__name__}: {exc}"})
            return

        body = _npy_bytes(np.asarray(dense, np.float32))
        self.send_response(200)
        self.send_header("Content-Type", "application/x-npy")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-DCT-Latency-S", f"{time.monotonic() - t0:.4f}")
        self.send_header("X-DCT-Batch-Size", str(req._batch_size))
        self.end_headers()
        self.wfile.write(body)


def make_server(
    engine: ServingEngine,
    host: str = "127.0.0.1",
    port: int = 8571,
    request_timeout_s: float = 600.0,
) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; call serve_forever() or
    run it in a thread. Port 0 picks a free port (see server_address)."""
    handler = type(
        "BoundHandler",
        (_Handler,),
        {"engine": engine, "request_timeout_s": request_timeout_s},
    )
    return ThreadingHTTPServer((host, port), handler)
