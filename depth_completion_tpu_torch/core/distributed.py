"""Process-group bootstrap, PyTorch counterpart of
``depth_completion_tpu.core.distributed``.

One process per GPU. The configuration comes from the arguments or, where
they are absent, from the environment: torchrun's ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT`` (the ``env://``
rendezvous), or the JAX package's ``DCT_COORDINATOR_ADDRESS``
(``host:port``, a ``tcp://`` rendezvous), ``DCT_NUM_PROCESSES``,
``DCT_PROCESS_ID`` and ``DCT_INIT_TIMEOUT`` (seconds, default 300). The
arguments and ``DCT_*`` take precedence over torchrun's variables. NCCL
joins the ranks on the card; gloo when the caller asks for the CPU.

- No configuration anywhere: the process stays alone (a debug log), the
  common case of ``--multihost true`` on one machine without a launcher.
- Any explicit configuration that fails (a coordinator that does not
  answer, ``DCT_NUM_PROCESSES=2`` without an address or a process id, a
  rendezvous timeout) raises ``RuntimeError``: a process that ran alone
  would take every frame believing it is rank 0 of 1.
- A process group that is already joined makes ``initialize`` a no-op.

    device = initialize()               # each rank: cuda:LOCAL_RANK
    mesh = make_mesh()                  # core.mesh: data axis over every rank
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from depth_completion_tpu_torch.device import resolve_device
from depth_completion_tpu_torch.logger import logger


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value else None


def _rank_device(dev: torch.device, rank: int | None) -> torch.device:
    """``cuda:LOCAL_RANK`` (without it, the process id modulo the cards), or
    the card the caller named (``cuda:0``), made current; the CPU as
    given."""
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        local = _env_int("LOCAL_RANK")
        if local is None:
            local = (rank or 0) % torch.cuda.device_count()
        dev = torch.device("cuda", local)
    torch.cuda.set_device(dev)
    return dev


def initialize(
    device: str | torch.device | None = None,
    init_method: str | None = None,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    initialization_timeout: int | None = None,
    backend: str | None = None,
) -> torch.device:
    """Join the process group (see the module docstring) → this rank's
    device. ``init_method`` overrides the rendezvous (the tests pass a
    ``file://`` store); ``backend`` overrides NCCL on the card and gloo on
    the CPU (gloo also takes CUDA tensors for ``all_reduce`` and
    ``broadcast``)."""
    dev = resolve_device(device)
    if dist.is_initialized():
        logger.debug("torch.distributed already initialized")
        return _rank_device(dev, dist.get_rank())
    if coordinator_address is None:
        coordinator_address = os.environ.get("DCT_COORDINATOR_ADDRESS") or None
    if num_processes is None:
        num_processes = _env_int("DCT_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("DCT_PROCESS_ID")
    if initialization_timeout is None:
        initialization_timeout = int(os.environ.get("DCT_INIT_TIMEOUT", "300"))
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    # any explicit piece counts: DCT_NUM_PROCESSES=2 with no address must
    # fail, not run as two processes that each believe they are rank 0 of 1
    if all(x is None for x in (init_method, coordinator_address, world, rank)):
        logger.debug("distributed: no process-group configuration (torchrun's RANK and "
                     "WORLD_SIZE, or DCT_*); running as a single process")
        return _rank_device(dev, 0)
    if init_method is None:
        if coordinator_address is not None:
            init_method = f"tcp://{coordinator_address}"
        elif os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
            init_method = "env://"
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    try:
        missing = [what for what, v in (("a coordinator address", init_method),
                                        ("the number of processes", world),
                                        ("the process id", rank)) if v is None]
        if missing:
            raise ValueError("missing " + ", ".join(missing))
        dev = _rank_device(dev, rank)
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=initialization_timeout))
    except (RuntimeError, ValueError, TimeoutError, OSError) as e:
        raise RuntimeError(
            "torch.distributed.init_process_group failed with an explicitly configured "
            f"runtime (init_method={init_method}, num_processes={world}, process_id={rank}): "
            f"{e}") from e
    logger.info(f"distributed: process {rank}/{world}, backend {dist.get_backend()}, "
                f"device {dev}")
    return dev


def is_primary() -> bool:
    """Rank 0 of the group, or a process that joined none: the process that
    writes shared artifacts."""
    return not dist.is_initialized() or dist.get_rank() == 0
