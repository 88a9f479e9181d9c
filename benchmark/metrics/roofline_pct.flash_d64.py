"""roofline_pct.flash_d64: the least time of the UNet's flash self-attention
calls (forward 4·S²·d·h and backward 10·S²·d·h FLOPs at the bf16 peak, per
call as ``harness.flops`` counts them) over the device time of the
``flash_fwd`` and ``flash_bwd`` kernel families (the backward's ``di``
pre-pass included) in the profiled window, in percent.

The bound and the device time have to cover the same calls: the
``flash_fwd`` launches in the window (one a call) have to be the calls
counted, or the metric is not read. A replayed graph's launches carry no
shapes of their own, so the count is what ties the two together."""

import sys

from benchmark.harness import flops


def read(record):
    tr = record.get("trace")
    if tr is None or not record.get("traced_frames"):
        return None
    launches = tr.family_launches().get("flash_fwd", 0)
    want = record["traced_requests"] * flops.request_launches(
        record["work"], flops.is_flash_d64, record["steps"], 1)
    if launches != want:
        sys.stderr.write(f"roofline_pct.flash_d64 not read: {launches} flash_fwd launches in the "
                         f"window, {want} calls counted\n")
        return None
    fam = tr.family_seconds()
    device = fam.get("flash_fwd", 0.0) + fam.get("flash_bwd", 0.0)
    b = flops.request_bounds(record["work"], flops.is_flash_d64, flops.flash_bound_s)
    bound = record["traced_frames"] * (record["steps"] * b["step"] + b["request"])
    return 100.0 * bound / device if device > 0 and bound > 0 else None
