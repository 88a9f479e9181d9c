"""device_idle_pct.serve: the share of the profiled window in which no
kernel, copy or set runs on the card (the union of device intervals)."""


def read(record):
    tr = record.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
