"""Hopper probes of the flash kernel's inner loop: the port's counterparts
of the JAX package's TPU probe scripts (``scripts/exp_*.py``).

- ``flash_overlap``: do the tensor-core products serialise with the
  softmax? (``exp_flash_overlap.py``; kernel ``csrc/probe_block_step.cu``)
- ``flash_twostream``: does a second query stream per block pay?
  (``exp_flash_twostream.py``; kernel ``csrc/probe_flash_twostream.cu``)
- ``mma_n64``: is an N=64 output product slower per FLOP than an N=128
  one? (``exp_pallas_n64.py``; kernel ``csrc/probe_mma.cu``)
- ``packed_pv``: the same on resident tiles, one block per SM
  (``exp_packed_pv.py``; kernel ``csrc/probe_mma.cu``)

Each module holds its kernel wrapper (plain twin on a CPU tensor, the
kernel or an error on a CUDA tensor, and a launch count), ``run(device)``,
which measures on the card and returns the readings, and ``main()``:

    python3 -m depth_completion_tpu_torch.probes.<name>

No path of the port launches these kernels.
"""

from __future__ import annotations

import subprocess

import torch


def require_cuda(device) -> torch.device:
    """The probes measure the card: raise for any other device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the probes time kernels on a CUDA device, got {device}")
    return device


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
