"""Process-group bootstrap, PyTorch counterpart of
``depth_completion_tpu.core.distributed``.

One process per GPU, started by ``torchrun`` (or anything that sets its
environment: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, and ``MASTER_ADDR`` /
``MASTER_PORT`` for the default ``env://`` rendezvous). NCCL joins the
ranks on the card; gloo when the caller asks for the CPU. The ring of
``ops.ring_attention.ProcessGroupRing`` runs over the group this joins.

    device = initialize()               # each rank: cuda:LOCAL_RANK
    ring = ProcessGroupRing()           # native-resolution mode
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from depth_completion_tpu_torch.device import resolve_device


def initialize(device: str | torch.device | None = None,
               init_method: str = "env://") -> torch.device:
    """Join the process group from the launcher's environment (a no-op for
    the group if already joined); → this rank's device: ``cuda:LOCAL_RANK``,
    made current, unless ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
            rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
        )
    return dev


def is_primary() -> bool:
    """Rank 0 of the group, or a process that joined none."""
    return not dist.is_initialized() or dist.get_rank() == 0
