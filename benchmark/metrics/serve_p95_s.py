"""serve_p95_s: the 95th percentile (nearest rank) of the client's latency,
POST sent to response read, over every request of the window. A failed
request counts as missing every limit: as the window's whole length."""

import math
import sys


def read(record):
    start, end = record["window"]
    lat = sorted(r["done"] - r["sent"] if r["ok"] else end - start for r in record["requests"])
    if not lat:
        return None
    sys.stderr.write(f"serve_p95_s over {len(lat)} requests\n")
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
