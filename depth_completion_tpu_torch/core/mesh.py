"""The rank mesh, PyTorch counterpart of ``depth_completion_tpu.core.mesh``.

A 2-D logical layout of the process group's ranks, one GPU each:

- ``data``: frames and ensemble members (each data rank runs its block of
  rows), or the attention sequence in native-resolution mode (the ring);
- ``model``: tensor parallelism of the UNet (``parallel.sharding``).

Ranks are laid out ``[data, model]`` with the data axis outermost, as the
JAX package lays out its devices, so the ranks of one model group are
consecutive (one host's cards under torchrun). Each rank belongs to one
group per axis. Collectives are explicit: the UNet's tensor-parallel pairs
reduce over the model group; the data-parallel paths gather their rows over
the data group (``gather_rows``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_MODEL = "model"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; ``data * model`` must equal the rank count."""

    data: int = -1  # -1 = all remaining ranks
    model: int = 1


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``ranks``: the global ranks as a ``[data, model]`` grid. ``coords``:
    this process's (data, model) index, None where it is outside the grid.
    ``groups``: this process's group along each axis (None outside the grid,
    or with no process group joined)."""

    ranks: np.ndarray
    coords: dict[str, int] | None
    groups: dict[str, Any]

    @property
    def shape(self) -> dict[str, int]:
        return {AXIS_DATA: int(self.ranks.shape[0]), AXIS_MODEL: int(self.ranks.shape[1])}

    @property
    def member(self) -> bool:
        return self.coords is not None


def make_mesh(spec: MeshSpec | None = None, ranks=None) -> Mesh:
    """Lay ``ranks`` (default: every rank of the joined group, or this one
    process) out as ``[data, model]``. With ``spec.data == -1`` every rank
    not taken by ``model`` goes to the data axis.

    Every rank of the world must call this with the same arguments, ranks
    outside the grid too: each creates every subgroup, in one order (a rank
    that skipped a ``new_group`` would leave the others waiting)."""
    spec = spec or MeshSpec()
    if ranks is None:
        ranks = range(dist.get_world_size()) if dist.is_initialized() else [0]
    ranks = [int(r) for r in ranks]
    n = len(ranks)
    model = spec.model
    if model <= 0:
        raise ValueError(f"model axis size must be positive, got {model}")
    data = spec.data if spec.data != -1 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} does not match device count {n}")
    grid = np.asarray(ranks).reshape(data, model)
    if not dist.is_initialized():
        if ranks != [0]:
            raise RuntimeError(f"a mesh over ranks {ranks} needs a joined process group "
                               "(core.distributed.initialize)")
        return Mesh(grid, {AXIS_DATA: 0, AXIS_MODEL: 0}, {AXIS_DATA: None, AXIS_MODEL: None})
    me = dist.get_rank()
    groups: dict[str, Any] = {AXIS_DATA: None, AXIS_MODEL: None}
    for j in range(model):  # the data groups: one per model index
        group = dist.new_group(grid[:, j].tolist())
        if me in grid[:, j]:
            groups[AXIS_DATA] = group
    for i in range(data):  # the model groups: one per data index
        group = dist.new_group(grid[i].tolist())
        if me in grid[i]:
            groups[AXIS_MODEL] = group
    hit = np.argwhere(grid == me)
    coords = ({AXIS_DATA: int(hit[0][0]), AXIS_MODEL: int(hit[0][1])} if len(hit) else None)
    return Mesh(grid, coords, groups)


def _rows(mesh: Mesh, n: int) -> tuple[int, int]:
    d = mesh.shape[AXIS_DATA]
    if n % d:
        raise ValueError(f"{n} rows do not divide the data axis of {d}")
    i = mesh.coords[AXIS_DATA]
    return i * n // d, (i + 1) * n // d


def data_sharding(mesh: Mesh, x, axis: int = 0):
    """This rank's contiguous block of ``x`` along ``axis`` (numpy array or
    tensor), as ``PartitionSpec("data")`` on that dimension places it."""
    lo, hi = _rows(mesh, x.shape[axis])
    index = [slice(None)] * x.ndim
    index[axis] = slice(lo, hi)
    return x[tuple(index)]


def replicated(mesh: Mesh, x):
    """``x`` whole on every rank (each rank holds its own copy)."""
    return x


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The data ranks' row blocks of ``x`` concatenated in rank order: the
    whole ``[N, ...]`` on every rank of the data group. gloo gathers only
    host tensors; its ``all_reduce`` takes CUDA tensors, so there each rank
    sums its block, placed in zeros, into the whole (exact: one term per
    element is not zero)."""
    group, d = mesh.groups[AXIS_DATA], mesh.shape[AXIS_DATA]
    if d == 1 or group is None:
        return x
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        whole = x.new_zeros((d, *x.shape))
        whole[mesh.coords[AXIS_DATA]] = x
        dist.all_reduce(whole, group=group)
        return whole.flatten(0, 1)
    parts = [torch.empty_like(x) for _ in range(d)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)
