"""Products on resident tiles: is an N=64 product slower than two heads
packed into one N=128 product?

Counterpart of ``scripts/exp_packed_pv.py``: the fp32 sum of repeats of
one product on tiles that stay on chip, bf16 out, for

  A  [512,1024]x[1024,64],  2N repeats   (the flash PV shape, per head)
  B  [512,2048]x[2048,128],  N repeats   (two heads packed, 2x executed MACs)

with N=256: equal useful work. The script's verdict (:88-91): packing wins
if B takes less than 0.95 of A's time.

The TPU ran one product on its one core. Here the kernel of
``csrc/probe_mma.cu`` takes a 64-row strip per block, so one product fills
8 SMs: the probe runs ``sm_count // 8`` copies of it at once, every copy
reading the same p and v (an ``expand``ed batch), one block per SM, so
that the time is the card's rate. Each block reads its strip from L2 once
per 64-wide K chunk and runs all the repeats on it from shared memory.

    python3 -m depth_completion_tpu_torch.probes.packed_pv
"""

from __future__ import annotations

import json

import torch

from depth_completion_tpu_torch.probes import card, mma_n64, require_cuda, time_ms

BQ, BK, N_STEPS = 512, 1024, 256
# variant → (output columns N, depth K, repeats as a multiple of N_STEPS)
VARIANTS = {"A": (64, BK, 2), "B": (128, 2 * BK, 1)}

# kernel launches by the wrapper, read by chip_smoke.py
LAUNCHES = {"probe_packed_pv": 0}


def resident_products_plain(p, v, steps: int, copies: int = 1):
    """[copies, M, N]: bf16 of the fp32 sum of ``steps`` repeats of p @ v."""
    return mma_n64.products_plain(p.expand(copies, *p.shape), v.expand(copies, *v.shape),
                                  repeats=steps, scale=1.0)


def resident_products(p, v, steps: int, copies: int = 1):
    """The kernel on CUDA (p [M, K], v [K, N] shared by every copy), the
    plain twin on the CPU."""
    if p.device.type == "cpu":
        return resident_products_plain(p, v, steps, copies)
    out = mma_n64.launch(p.expand(copies, *p.shape), v.expand(copies, *v.shape),
                         repeats=steps, scale=1.0)
    LAUNCHES["probe_packed_pv"] += 1
    return out


def copies_for(device, m: int = BQ) -> int:
    """Copies of an M-row product that put one block on each SM at most."""
    return max(1, torch.cuda.get_device_properties(device).multi_processor_count // (m // 64))


def inputs(device, n_out: int, bk: int, seed: int = 0):
    gen = torch.Generator(device=device).manual_seed(seed + n_out)
    p = torch.randn((BQ, bk), generator=gen, device=device).to(torch.bfloat16)
    v = torch.randn((bk, n_out), generator=gen, device=device).to(torch.bfloat16)
    return p, v


def flops(name: str, steps: int = N_STEPS, copies: int = 1) -> float:
    n_out, bk, mult = VARIANTS[name]
    return copies * mult * steps * 2.0 * BQ * bk * n_out


def run(device="cuda", steps: int = N_STEPS, reps: int = 20, seed: int = 0) -> dict:
    device = require_cuda(device)
    copies = copies_for(device)
    ms, tflops = {}, {}
    for name, (n_out, bk, mult) in VARIANTS.items():
        p, v = inputs(device, n_out, bk, seed)
        ms[name] = time_ms(lambda p=p, v=v, r=mult * steps: resident_products(p, v, r, copies), reps)
        tflops[name] = flops(name, steps, copies) / ms[name] * 1e-9
    wins = ms["B"] < 0.95 * ms["A"]
    return {
        "probe": "packed_pv", "steps": steps, "copies": copies, "ms": ms,
        "tflops_executed": tflops,
        "verdict": f"packing {'WINS' if wins else 'neutral/loses'} ({ms['A'] / ms['B']:.2f}x)",
    }


def main() -> None:
    print(card())
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
