"""Do the flash block step's products serialise with its softmax?

Counterpart of ``scripts/exp_flash_overlap.py``: ``steps`` repeats of one
flash-forward block step on resident tiles, in three modes (``full``: QK,
online softmax, PV; ``dots``: QK and PV with p = s; ``softmax``: no
products, the score tile faked from the running l), output the bf16 of the
unnormalised fp32 accumulator. The verdict is the script's (:115-120):
serialised if full > 0.85·(dots + softmax).

The kernel (``csrc/probe_block_step.cu``) takes the port's flash tile (64
query and 64 key rows, d=64, 4 warps) in place of the TPU's 512x1024, one
block per SM, each on its own q, k, v. Its ``dots`` mode reads α from a
scratch that starts at 1: the reference's starts at -inf and its dots
output is all NaN (0·(-inf) at the first step).

Two designs of the block step (``DESIGNS``), one twin: ``wmma``, the first
flash kernel's (score, p and accumulator tiles in shared memory), and
``mma``, the redesigned ``flash_fwd_kernel``'s (scores, p and accumulator
in ``mma.sync`` fragments, the softmax by quad shuffles). ``run`` times
every mode of both, so the two block steps read side by side.

    python3 -m depth_completion_tpu_torch.probes.flash_overlap
"""

from __future__ import annotations

import ctypes
import json

import torch

from depth_completion_tpu_torch import _build
from depth_completion_tpu_torch.probes import card, require_cuda, time_ms

BR, D, STEPS = 64, 64, 256
SCALE = 0.125 * 1.4426950408889634  # 1/sqrt(64) in the log2 domain, the script's
MODES = ("full", "dots", "softmax")
DESIGNS = ("wmma", "mma")  # the first flash_fwd kernel's block step; the redesigned one's

# kernel launches by the wrapper, read by chip_smoke.py
LAUNCHES = {"probe_block_step": 0}

_i, _f, _p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_fns: dict[str, object] = {}


def _kernel(design: str):
    if design not in _fns:
        suffix = "" if design == "wmma" else f"_{design}"
        fn = getattr(_build.load("probe_block_step"), f"dct_probe_block_step{suffix}")
        fn.argtypes = [_p] * 4 + [_i] * 3 + [_f, _p]
        fn.restype = _i
        _fns[design] = fn
    return _fns[design]


def block_step_plain(q, k, v, mode: str, steps: int = STEPS, scale: float = SCALE):
    """q [B, BQ, d], k and v [B, BK, d] (BK >= d) → o [B, BQ, d] bf16, the
    unnormalised accumulator after ``steps`` block steps, in fp32 with p
    rounded to bf16 before PV (as the script's ``p.astype(v.dtype)``)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    b, bq, d = q.shape
    bk = k.shape[1]
    m = torch.full((b, bq, 1), float("-inf"), device=q.device)
    l, acc = torch.zeros((b, bq, 1), device=q.device), torch.zeros((b, bq, d), device=q.device)
    qk = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    vf = v.float()
    for _ in range(steps):
        s = l.expand(b, bq, bk) if mode == "softmax" else qk
        if mode == "dots":
            p, alpha = s, torch.ones_like(l)  # the scratch, 1 throughout
        else:
            m_next = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha, p = torch.exp2(m - m_next), torch.exp2(s - m_next)
            l, m = alpha * l + p.sum(-1, keepdim=True), m_next
        if mode == "softmax":
            acc = acc + p[..., :d]
        else:
            acc = acc * alpha + torch.matmul(p.to(torch.bfloat16).float(), vf)
    return acc.to(torch.bfloat16)


def block_step(q, k, v, mode: str, steps: int = STEPS, design: str = "wmma"):
    """The kernel of ``design`` on CUDA tensors (contiguous [B, 64, 64]
    bf16, one block each), the plain twin (the same for both designs) on
    the CPU."""
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}, got {design!r}")
    if q.device.type == "cpu":
        return block_step_plain(q, k, v, mode, steps)
    for x in (q, k, v):
        if x.dtype != torch.bfloat16 or x.shape != q.shape or x.shape[1:] != (BR, D) \
                or not x.is_contiguous():
            raise ValueError(f"block-step kernel takes contiguous [B, {BR}, {D}] bfloat16, "
                             f"got {x.dtype} {tuple(x.shape)}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    o = torch.empty_like(q)
    status = _kernel(design)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), q.shape[0],
                       steps, MODES.index(mode), SCALE,
                       torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, f"probe block_step {design} {mode}")
    LAUNCHES["probe_block_step"] += 1
    return o


def inputs(device, blocks: int | None = None, seed: int = 0):
    """q, k, v [blocks, 64, 64] standard normal bf16; one block per SM by
    default."""
    if blocks is None:
        blocks = torch.cuda.get_device_properties(device).multi_processor_count
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn((blocks, BR, D), generator=gen, device=device).to(torch.bfloat16)
                 for _ in range(3))


def verdict(us: dict) -> str:
    serial = us["full"] > 0.85 * (us["dots"] + us["softmax"])
    return "serialized" if serial else "overlapped"


def run(device="cuda", steps: int = STEPS, reps: int = 20, seed: int = 0) -> dict:
    """Each mode of each design timed through its kernel: µs per step (one
    block per SM). Per design: ms, us_per_step, dots_plus_softmax_us,
    max_dots_softmax_us and the verdict."""
    device = require_cuda(device)
    q, k, v = inputs(device, seed=seed)
    designs = {}
    for design in DESIGNS:
        ms = {mode: time_ms(lambda mode=mode: block_step(q, k, v, mode, steps, design), reps)
              for mode in MODES}
        us = {mode: t * 1e3 / steps for mode, t in ms.items()}
        designs[design] = {
            "ms": ms, "us_per_step": us, "dots_plus_softmax_us": us["dots"] + us["softmax"],
            "max_dots_softmax_us": max(us["dots"], us["softmax"]), "verdict": verdict(us)}
    return {"probe": "flash_overlap", "blocks": q.shape[0], "steps": steps, "designs": designs,
            "verdict": ", ".join(f"{d}: {r['verdict']}" for d, r in designs.items())}


def main() -> None:
    print(card())
    r = run()
    print(json.dumps(r))
    for design, d in r["designs"].items():
        us = d["us_per_step"]
        print(f"{design}: full {us['full']:.3f} vs dots+softmax {d['dots_plus_softmax_us']:.3f} "
              f"vs max {d['max_dots_softmax_us']:.3f} us/step -> {d['verdict']}")


if __name__ == "__main__":
    main()
