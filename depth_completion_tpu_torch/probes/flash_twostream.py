"""Does a second query stream per block pay in the flash forward?

Counterpart of ``scripts/exp_flash_twostream.py``: the flash forward with
one query tile per block (``_single_kernel``; here the port's own
``flash_fwd`` kernel, the same function) against two query tiles per block
sharing each key/value tile (``_twostream_kernel``; here
``csrc/probe_flash_twostream.cu``, 8 warps over 128 query rows), at UNet
stage-0 size: [bh=5, S=7168, d=64] (the script's padded length) and
S=6912, the real stage-0 length. Inputs as the script's: q and k 0.3·N(0,1),
v N(0,1), bf16. Prints the speedup and max|diff| as the script does
(:157-167); the two-stream form wins if it takes less than 0.95 of the
single-stream time (the rule of ``exp_packed_pv.py``).

No path of the port launches the two-stream kernel.

    python3 -m depth_completion_tpu_torch.probes.flash_twostream
"""

from __future__ import annotations

import ctypes
import json
import math

import torch

from depth_completion_tpu_torch import _build
from depth_completion_tpu_torch.ops import flash_attention as fa
from depth_completion_tpu_torch.probes import card, require_cuda, time_ms

HEADS, D, SEQS = 5, 64, (7168, 6912)

# kernel launches by the wrapper, read by chip_smoke.py
LAUNCHES = {"flash_fwd_twostream": 0}

_i, _l, _f, _p = ctypes.c_int, ctypes.c_long, ctypes.c_float, ctypes.c_void_p
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("probe_flash_twostream").dct_flash_fwd_twostream
        fn.argtypes = [_p] * 5 + [_i] * 4 + [_l] * 8 + [_f, _p]
        fn.restype = _i
        _fn = fn
    return _fn


def flash_fwd_twostream(q, k, v, num_heads):
    """As ``ops.flash_attention.flash_fwd`` at head dim 64 → (o, lse2),
    through the two-stream kernel on CUDA; on the CPU the plain twin of
    both forms, ``ops.flash_attention.flash_fwd_plain``."""
    if q.device.type == "cpu":
        return fa.flash_fwd_plain(q, k, v, num_heads)
    n, sq, c = q.shape
    sk = k.shape[1]
    if fa._check_cuda_operands(q, k, v, head_dim=c // num_heads) != torch.bfloat16:
        raise TypeError(f"the two-stream kernel takes bfloat16, got {q.dtype}")
    if c != num_heads * D:
        raise NotImplementedError(f"the two-stream kernel is built for head dim {D}")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse2 = torch.empty((n, num_heads, sq), device=q.device, dtype=torch.float32)
    status = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse2.data_ptr(),
        n, num_heads, sq, sk, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), o.stride(0), o.stride(1), 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_fwd_twostream")
    LAUNCHES["flash_fwd_twostream"] += 1
    return o, lse2


def inputs(device, s: int, heads: int = HEADS, seed: int = 0):
    """q, k (0.3·N(0,1)) and v (N(0,1)), [1, S, heads·64] bf16."""
    gen = torch.Generator(device=device).manual_seed(seed + s)

    def rnd(scale):
        return (scale * torch.randn((1, s, heads * D), generator=gen, device=device)).to(
            torch.bfloat16)

    return rnd(0.3), rnd(0.3), rnd(1.0)


def verdict(speedup: float) -> str:
    return f"two streams {'win' if speedup > 1 / 0.95 else 'do not win'} ({speedup:.2f}x)"


def run(device="cuda", seqs=SEQS, heads: int = HEADS, reps: int = 10, seed: int = 0) -> dict:
    """Per sequence length: the single-stream kernel (``flash_fwd``) and the
    two-stream kernel, timed; their outputs' max|diff|."""
    device = require_cuda(device)
    rows = []
    for s in seqs:
        q, k, v = inputs(device, s, heads, seed)
        o1, _ = fa.flash_fwd(q, k, v, heads)
        o2, _ = flash_fwd_twostream(q, k, v, heads)
        t1 = time_ms(lambda: fa.flash_fwd(q, k, v, heads), reps)
        t2 = time_ms(lambda: flash_fwd_twostream(q, k, v, heads), reps)
        rows.append({"s": s, "heads": heads, "single_ms": t1, "twostream_ms": t2,
                     "speedup": t1 / t2, "max_abs_diff": float((o1.float() - o2.float()).abs().max()),
                     "verdict": verdict(t1 / t2)})
    return {"probe": "flash_twostream", "rows": rows, "verdict": rows[0]["verdict"]}


def main() -> None:
    print(card())
    r = run()
    for row in r["rows"]:
        print(f"single    S={row['s']} {row['single_ms']:8.4f} ms/call")
        print(f"twostream S={row['s']} {row['twostream_ms']:8.4f} ms/call")
        print(f"  -> speedup {row['speedup']:.2f}x, max|diff| {row['max_abs_diff']:.2e}")
    print(json.dumps(r))


if __name__ == "__main__":
    main()
