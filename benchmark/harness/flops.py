"""The yardstick's arithmetic: the card's peaks, each kernel's operations
and bytes, and the work of one guided step counted from the configuration.

The peaks are NVIDIA's published dense figures for one H100 SXM at its
700 W limit: 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM.

``count_work(config, request, height, width)`` runs the plain reference
once on the ``meta`` device (no data, no arithmetic) at batch 1 under
``torch.utils.flop_counter.FlopCounterMode`` and a ``nn.CallLog``, for the
three phases of a request: ``prepare`` (preprocess and encode), ``step``
(one guided step: the UNet forward and its input gradient, the decode
forward and its input gradient, the loss) and ``finish`` (the final
decode). Each phase gives its FLOPs (multiply-adds counted as two; matmuls
and convs only) and the tagged conv and attention calls with their shapes.
Everything scales with the batch: a request of N frames is N times one.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS = 989e12  # bf16 dense, tensor cores
PEAK_BYTES = 3.35e12  # HBM3
BF16_BYTES = 2

# the port runs a UNet self-attention call through its flash kernels at
# these head dims once the keys reach this length (shorter calls, and the
# cross-attention over the 2-token context, run plain attention)
FLASH_MIN_KEYS = 768


def flash_flops(s: int, sk: int, heads: int, d: int, n: int = 1, backward: bool = False) -> float:
    """Forward: QKᵀ and PV, 4·S·Sk·d·h; backward: dV, dP, dS→dQ, dK and the
    recomputed QKᵀ, 10·S·Sk·d·h."""
    return (10 if backward else 4) * n * s * sk * d * heads


def flash_bound_s(call: dict, backward: bool = False) -> float:
    """The least time of one flash call: its FLOPs at the bf16 peak (its
    bytes, q, k, v and o, are a few MB against GFLOPs)."""
    return flash_flops(call["s"], call["sk"], call["heads"], call["d"], call["n"], backward) \
        / PEAK_FLOPS


def conv_ops(call: dict) -> float:
    out_hw = (call["h"] // call["stride"]) * (call["w"] // call["stride"])
    return 2.0 * call["n"] * out_hw * call["ci"] * call["co"] * call["k"] ** 2


def conv_bytes(call: dict, backward: bool = False) -> float:
    """Each input byte read once and each output byte written once, bf16.
    Forward: x, the kernel, the bias and the skip in, y out. The input
    gradient: dy, the kernel and (under a ReLU, whose mask it streams) y
    in, dx out, and the masked dy out where a skip takes its gradient."""
    pix = call["n"] * call["h"] * call["w"]
    x, y = pix * call["ci"], pix * call["co"]
    w = call["k"] ** 2 * call["ci"] * call["co"]
    if not backward:
        elems = x + w + y + (call["co"] if call["bias"] else 0) + (y if call["skip"] else 0)
    else:
        elems = y + w + x + (y if call["relu"] else 0) + (y if call["relu"] and call["skip"] else 0)
    return float(elems * BF16_BYTES)


def conv_bound_s(call: dict, backward: bool = False) -> float:
    return max(conv_ops(call) / PEAK_FLOPS, conv_bytes(call, backward) / PEAK_BYTES)


def is_flash_d64(call: dict) -> bool:
    return call["kind"] == "unet_self" and call["d"] == 64 and call["sk"] >= FLASH_MIN_KEYS


def is_conv3x3(call: dict) -> bool:
    """The VAE's stride-1 3x3 convs at channel counts the fused kernel
    takes (multiples of 8)."""
    return (call["kind"] == "vae3x3" and call["k"] == 3 and call["stride"] == 1
            and call["ci"] % 8 == 0 and call["co"] % 8 == 0)


def count_work(config: dict, request: dict, height: int, width: int) -> dict:
    """{phase: {"flops": float, "calls": [dict]}} for one frame, phases
    ``prepare``, ``step`` and ``finish``; a ``step`` call's input gradient
    runs the same shapes backward."""
    from benchmark.harness import weights
    from benchmark.reference.nn import CallLog
    from benchmark.reference.sampler import Reference

    meta = torch.device("meta")
    params = weights.make(config, 0, meta, torch.float32)
    ref = Reference(params, config, dict(request, steps=1))
    images = torch.empty((1, height, width, 3), device=meta)
    sparse = torch.empty((1, height, width, 1), device=meta)
    ref._ctx = torch.empty((1, 2, config["text"]["hidden_size"]), device=meta)
    out = {}
    with torch.no_grad():
        log = CallLog()
        with FlopCounterMode(display=False) as fc:
            img_latents, z, padding = ref.prepare(log, images)
        out["prepare"] = {"flops": float(fc.get_total_flops()), "calls": log.calls}
        mask = torch.empty(sparse.shape, dtype=torch.bool, device=meta)
        lim = torch.empty((1, 1, 1, 1), device=meta)
        state = {"affine": [lim, lim.clone()], "am": [lim.clone(), lim.clone()],
                 "av": [lim.clone(), lim.clone()], "m": torch.empty_like(z),
                 "v": torch.empty_like(z)}
        log = CallLog()
        with FlopCounterMode(display=False) as fc:
            ref.step(log, 0, img_latents, z, padding, (height, width), sparse, mask, lim, lim,
                     state)
        out["step"] = {"flops": float(fc.get_total_flops()), "calls": log.calls}
        log = CallLog()
        with FlopCounterMode(display=False) as fc:
            ref._metric(log, z, padding, (height, width), lim, lim, lim, lim)
        out["finish"] = {"flops": float(fc.get_total_flops()), "calls": log.calls}
    return out


def request_launches(work: dict, select, steps: int, per_step_call: int) -> int:
    """The launches of one request's calls that ``select`` keeps, where each
    call of a step launches ``per_step_call`` kernels of the family counted
    and each call of the prepare and finish phases one. The batch does not
    count: a kernel takes the whole batch in one launch."""
    step = sum(1 for c in work["step"]["calls"] if select(c))
    once = sum(1 for ph in ("prepare", "finish") for c in work[ph]["calls"] if select(c))
    return steps * per_step_call * step + once


def request_bounds(work: dict, select, bound) -> dict:
    """Per frame, the summed least time (s) of the calls ``select`` keeps:
    {"step": forward and input gradient of one step, "request": the
    prepare and finish phases' forward calls}."""
    step = sum(bound(c) + bound(c, True) for c in work["step"]["calls"] if select(c))
    once = sum(bound(c) for ph in ("prepare", "finish") for c in work[ph]["calls"] if select(c))
    return {"step": step, "request": once}
