"""roofline_pct.conv3x3: the least time of the VAE's fused 3x3 convs (per
call the larger of its operations at the bf16 peak and its bytes, each read
or written once, at the HBM peak; forward, and the input gradient in every
guided step, as ``harness.flops`` counts them) over the device time of the
``conv3x3`` kernel family in the profiled window, in percent.

The bound and the device time have to cover the same calls: the family's
launches in the window have to be the calls counted (one forward and one
input gradient a step, one forward in the encode and the final decode),
or the metric is not read. A replayed graph's launches carry no shapes of
their own, so the count is what ties the two together."""

import sys

from benchmark.harness import flops


def read(record):
    tr = record.get("trace")
    if tr is None or not record.get("traced_frames"):
        return None
    launches = tr.family_launches().get("conv3x3", 0)
    want = record["traced_requests"] * flops.request_launches(
        record["work"], flops.is_conv3x3, record["steps"], 2)
    if launches != want:
        sys.stderr.write(f"roofline_pct.conv3x3 not read: {launches} conv3x3 launches in the "
                         f"window, {want} calls counted\n")
        return None
    device = tr.family_seconds().get("conv3x3", 0.0)
    b = flops.request_bounds(record["work"], flops.is_conv3x3, flops.conv_bound_s)
    bound = record["traced_frames"] * (record["steps"] * b["step"] + b["request"])
    return 100.0 * bound / device if device > 0 and bound > 0 else None
