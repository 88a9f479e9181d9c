"""step_mfu_pct: the profiled requests' FLOPs (counted by ``harness.flops``
from the configuration and the shapes) over the profiled window's wall time
times the card's bf16 peak, in percent."""

from benchmark.harness.flops import PEAK_FLOPS


def read(record):
    tr, work = record.get("trace"), record["work"]
    if tr is None or not record.get("traced_frames"):
        return None
    per_frame = (record["steps"] * work["step"]["flops"] + work["prepare"]["flops"]
                 + work["finish"]["flops"])
    return 100.0 * record["traced_frames"] * per_frame / (tr.window_s * PEAK_FLOPS)
