"""frames_per_s: frames of every request completed in the window, over the
window's wall time (its start to the last request's completion)."""


def read(record):
    start, end = record["window"]
    frames = sum(r["frames"] for r in record["requests"] if r["ok"])
    return frames / (end - start) if end > start else None
