"""serve_http_ms: the median of the client's latency less the engine's own
(``X-DCT-Latency-S``): npz decode, npy encode and the socket, in ms."""

import math
import statistics


def read(record):
    gaps = [r["done"] - r["sent"] - r["server_s"] for r in record["requests"]
            if r["ok"] and math.isfinite(r["server_s"])]
    return 1e3 * statistics.median(gaps) if gaps else None
