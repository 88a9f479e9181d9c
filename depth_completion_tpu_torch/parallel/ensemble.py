"""Ensemble sampling, PyTorch counterpart of
``depth_completion_tpu.parallel.ensemble``.

Member m of every frame starts from noise m: member 0 from the plain
path's key (the second of ``split(PRNGKey(seed))``), member m > 0 from
``fold_in`` of that key with m, each drawn as JAX draws it, so one seed
gives one ensemble on both sides and E=1 is the plain request. The N·E
rows run as one batch, frame-major (frame 0's members, then frame 1's),
so every kernel takes the whole ensemble in one launch. Each member comes
out metric (aligned to the anchors by the guidance), and the reduce is
elementwise over the members: ``median`` / ``mean``, or ``aligned-*``,
which first fits each member by least squares (scale, shift; a full mask)
to the elementwise member median. The uncertainty is the member median
absolute deviation around the reduced map, on the aligned members for the
aligned reduces.

The medians average the two middle values at an even member count, as
``jnp.median`` does (``torch.median`` returns the lower one).

Over a ``mesh`` (``core.mesh``; JAX :112-120 constrains the rows to its
data axis) the N·E rows spread over the data ranks in contiguous blocks:
each rank runs its rows, global rows ``[r0, r1)``, row ``i`` being frame
``i // E``'s member ``i % E`` with that member's noise, so the rows are
the one-card rows. The member maps are gathered over the data group before
the reduce, and every rank returns the whole result.
"""

from __future__ import annotations

import numpy as np
import torch

from depth_completion_tpu_torch.core import prng
from depth_completion_tpu_torch.core.mesh import AXIS_DATA, gather_rows
from depth_completion_tpu_torch.device import upload
from depth_completion_tpu_torch.guidance.affine import compute_affine_params
from depth_completion_tpu_torch.models.bundle import ModelBundle
from depth_completion_tpu_torch.ops.resize import latent_size
from depth_completion_tpu_torch.pipeline.programs import ProgramCache
from depth_completion_tpu_torch.pipeline.sampler import SamplerConfig, guided_sample

ENSEMBLE_REDUCES = ("median", "mean", "aligned-median", "aligned-mean")


def median(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """The median over ``dim``, the mean of the two middle values at an even
    count (``jnp.median``'s rule)."""
    s = torch.sort(x, dim=dim).values
    e = x.shape[dim]
    mid = (s.narrow(dim, (e - 1) // 2, 1) + s.narrow(dim, e // 2, 1)) * 0.5
    return mid if keepdim else mid.squeeze(dim)


def align_members(members: torch.Tensor) -> torch.Tensor:
    """Each member [N,E,H,W,1] fitted (least-squares scale and shift over
    all pixels, ``compute_affine_params`` with a full mask) to the
    elementwise member median of its frame."""
    n, e, h, w, c = members.shape
    ref = median(members, 1, keepdim=True)
    flat = members.reshape(n * e, h, w, c)
    guides = ref.expand(members.shape).reshape(n * e, h, w, c)
    scales, shifts = compute_affine_params(flat, guides, torch.ones_like(flat, dtype=torch.bool))
    aligned = scales.reshape(-1, 1, 1, 1) * flat + shifts.reshape(-1, 1, 1, 1)
    return aligned.reshape(n, e, h, w, c)


def reduce_members(members: torch.Tensor, reduce: str, return_uncertainty: bool = False):
    """``members`` [N,E,H,W,1] → the reduced [N,H,W,1], and with
    ``return_uncertainty`` the member MAD around it."""
    over = align_members(members) if reduce.startswith("aligned-") else members
    denses = median(over, 1) if reduce.endswith("median") else over.mean(dim=1)
    if return_uncertainty:
        return denses, median((over - denses[:, None]).abs(), 1)
    return denses, None


def member_noise(seed: int, ensemble_size: int, latent_hw: tuple[int, int]) -> np.ndarray:
    """[E, EH, EW, 4] float32: member 0 the plain path's noise, member m the
    noise of ``fold_in(key, m)``."""
    _, key = prng.split(prng.PRNGKey(seed))
    keys = [key] + [prng.fold_in(key, m) for m in range(1, ensemble_size)]
    return np.concatenate([prng.normal(k, (1, *latent_hw, 4)) for k in keys])


def ensemble_sample(bundle: ModelBundle, images: torch.Tensor, sparses: torch.Tensor,
                    cfg: SamplerConfig, ensemble_size: int, reduce: str = "median",
                    mesh=None, return_uncertainty: bool = False, *,
                    programs: ProgramCache) -> tuple[torch.Tensor, ...]:
    """(denses [N,H,W,1], member denses [N,E,H,W,1]) of an E-member
    ensemble; with ``return_uncertainty`` the per-pixel member MAD
    [N,H,W,1] is appended. The N·E rows are one batch signature of
    ``programs`` (``guided_sample``'s program cache)."""
    if ensemble_size < 1:
        raise ValueError(f"ensemble_size must be >= 1, got {ensemble_size}")
    if reduce not in ENSEMBLE_REDUCES:
        raise ValueError(f"Unknown ensemble reduce: {reduce} (choose from {ENSEMBLE_REDUCES})")
    n, h, w, _ = images.shape
    e = ensemble_size
    eh, ew = latent_size((h, w), cfg.resolution, bundle.vae.downsample_factor)
    noise = upload(member_noise(cfg.seed, e, (eh, ew)), images.device)
    r0, r1 = 0, n * e
    if mesh is not None:
        d = mesh.shape[AXIS_DATA]
        if (n * e) % d:
            raise ValueError(f"{n} frames x {e} members do not divide the data axis of {d}")
        r0 = mesh.coords[AXIS_DATA] * (n * e // d)
        r1 = r0 + n * e // d
    rows = torch.arange(r0, r1, device=images.device)  # frame-major: frame i // e, member i % e
    denses_flat, _ = guided_sample(
        bundle, images.index_select(0, rows // e), sparses.index_select(0, rows // e), cfg,
        init_noise=noise.index_select(0, rows % e), programs=programs,
    )
    if mesh is not None:
        denses_flat = gather_rows(mesh, denses_flat)
    members = denses_flat.reshape(n, e, h, w, 1)
    denses, mad = reduce_members(members, reduce, return_uncertainty)
    return (denses, members, mad) if return_uncertainty else (denses, members)
