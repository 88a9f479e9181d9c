"""Device policy: CUDA unless the caller asks for the CPU, never a fallback;
and host arrays' upload."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the GPU; raise when there is none.

    ``device="cpu"`` (what the tests pass) is honoured as given.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch paths on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. To a card it goes through pinned memory
    without waiting: a copy from pageable memory would synchronise the
    stream, holding the host until the work queued before it has run."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
