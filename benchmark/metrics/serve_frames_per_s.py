"""serve_frames_per_s: responses read (status 200) over the window's wall
time (its start to the last response read)."""


def read(record):
    start, end = record["window"]
    done = sum(r["ok"] for r in record["requests"])
    return done / (end - start) if end > start else None
