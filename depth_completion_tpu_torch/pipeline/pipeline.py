"""Public pipeline API, PyTorch counterpart of
``depth_completion_tpu.pipeline.pipeline.DepthCompletionPipeline``.

Host-side validation (shapes, the empty-sparse and degenerate-range errors,
the temporal-carry shape check), config assembly, then ``guided_sample`` on
the bundle's device. Arrays are NHWC; inputs may be numpy arrays or
tensors, outputs are tensors on the bundle's device. ``ensemble_size`` > 1 runs
``parallel.ensemble.ensemble_sample``.

Data parallelism (``data_mesh``, a ``core.mesh.Mesh``): the host checks
run on the whole batch, which every rank holds, as JAX's
``process_allgather`` of the rows' validity (:156-176) lets every process
see them all; then this rank's block of rows (``parallel.sharding.
shard_batch``) goes through ``guided_sample``, whose step has no collective
(the guidance is per row), and the dense maps and latents are gathered over
the data group, so every rank returns the whole batch. The batch must
divide the data axis. ``ensemble_mesh`` spreads an ensemble's rows the same
way (``parallel.ensemble``).

The program cache is the JAX pipeline's (:70-126, :313-318): every request,
whatever its sampler branch, goes through the pipeline's
``programs.ProgramCache``, one ``sampler.SamplerProgram`` per signature (on
a card, captured CUDA graphs of the request's prepare step, of its steps,
replayed at every step, and of its final decode), ``max_programs`` bounding
the live ones in LRU order, ``program_keys()`` listing them. The outputs
are copies out of the program's buffers. ``twin()`` is the same pipeline
with every phase run eagerly (the serving engine's tier 0; the reference
``chip_smoke.py`` holds the graphs to).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from depth_completion_tpu_torch.core.mesh import AXIS_DATA, gather_rows
from depth_completion_tpu_torch.device import upload
from depth_completion_tpu_torch.models.bundle import ModelBundle
from depth_completion_tpu_torch.ops.resize import latent_size
from depth_completion_tpu_torch.parallel.ensemble import ensemble_sample
from depth_completion_tpu_torch.parallel.sharding import shard_batch
from depth_completion_tpu_torch.pipeline.programs import EagerTwin, ProgramCache
from depth_completion_tpu_torch.pipeline.sampler import SamplerConfig, guided_sample


def _host(x: Any) -> np.ndarray | torch.Tensor:
    """``x`` as a float32 numpy array where it lives on the host; a tensor
    already on a device stays as it is."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            return x
        x = x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _as_tensor(x: np.ndarray | torch.Tensor, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return upload(x, device)


class DepthCompletionPipeline:
    """Sparse→dense guided-diffusion depth completion.

        pipe = DepthCompletionPipeline(bundle)
        denses, latents = pipe(images, sparses, max_depth=120.0, steps=50)

    ``images``: [N,H,W,3] raw RGB (0..255); ``sparses``: [N,H,W,1] metric
    depth with 0 at missing points. Returns metric [N,H,W,1] dense depth and
    the final latents for temporal carry. With ``ensemble_size`` > 1 the
    second output is the member denses [N,E,H,W,1] in place of the latents,
    and with ``ensemble_uncertainty=True`` a third, the member MAD
    [N,H,W,1], is appended.
    """

    def __init__(self, bundle: ModelBundle, max_programs: int | None = None):
        """``max_programs``: bound the live programs (their graphs,
        buffers and share of the graph pool), least recently used first out;
        None keeps every signature's program, which is right for batch
        jobs. A long-running server over a mixed-geometry stream passes a
        bound."""
        self.bundle = bundle
        self.max_programs = max_programs
        self.programs = ProgramCache(max_programs)

    def program_keys(self) -> list[tuple]:
        """Live program signatures, oldest first (diagnostics)."""
        return self.programs.keys()

    def replace_bundle(self, **changes: Any) -> "DepthCompletionPipeline":
        return DepthCompletionPipeline(dataclasses.replace(self.bundle, **changes),
                                       max_programs=self.max_programs)

    def twin(self) -> "DepthCompletionPipeline":
        """This pipeline's plain twin: the same bundle and ``max_programs``,
        a program cache of its own whose steps run eagerly
        (``programs.EagerTwin``)."""
        twin = DepthCompletionPipeline(self.bundle, max_programs=self.max_programs)
        twin.programs = EagerTwin(self.max_programs)
        return twin

    def __call__(
        self,
        images: Any,
        sparses: Any,
        max_depth: float,
        min_depth: float = 0.0,
        pred_latents_prev: Any | None = None,
        **config_overrides: Any,
    ) -> tuple[torch.Tensor, ...]:
        device = self.bundle.device
        # the checks read the host arrays, before the upload
        images, sparses = _host(images), _host(sparses)
        if sparses.ndim == 3:
            sparses = sparses[..., None]
        if (
            images.ndim != 4
            or sparses.ndim != 4
            or images.shape[0] != sparses.shape[0]
            or images.shape[1:3] != sparses.shape[1:3]
            or sparses.shape[-1] != 1
        ):
            raise ValueError(
                "images must be [N,H,W,C] and sparses [N,H,W,1] with matching "
                f"batch and spatial dims, got {tuple(images.shape)} / {tuple(sparses.shape)}"
            )

        sp_np = sparses if isinstance(sparses, np.ndarray) else sparses.cpu().numpy()
        rows_valid = (sp_np > 0).any(axis=(1, 2, 3))
        if not rows_valid.all():
            raise ValueError(
                "No valid values found in mask for some positions. Ensure "
                "that mask has at least one True value along the specified "
                f"dimensions. (sparse frames {np.flatnonzero(~rows_valid).tolist()} "
                "have no points > 0)"
            )

        loss_funcs = config_overrides.pop("loss_funcs", None)
        if loss_funcs is not None:
            config_overrides["loss_funcs"] = tuple(loss_funcs)
        percentile = config_overrides.pop("percentile", None)
        if percentile is not None:
            config_overrides["percentile"] = tuple(percentile)
        lr = config_overrides.pop("lr", None)
        if lr is not None:
            config_overrides["lr_latent"], config_overrides["lr_scaling"] = lr
        ensemble_size = int(config_overrides.pop("ensemble_size", 1))
        ensemble_reduce = config_overrides.pop("ensemble_reduce", "median")
        ensemble_mesh = config_overrides.pop("ensemble_mesh", None)
        data_mesh = config_overrides.pop("data_mesh", None)
        ensemble_uncertainty = bool(config_overrides.pop("ensemble_uncertainty", False))
        if "ddim" not in config_overrides and self.bundle.ddim_config is not None:
            config_overrides["ddim"] = self.bundle.ddim_config

        cfg = SamplerConfig(min_depth=min_depth, max_depth=max_depth, **config_overrides)
        cfg.validate()

        # Degenerate range: minmax/percentile would divide by (max-min)=0.
        if cfg.norm in ("minmax", "percentile"):
            for i in range(sp_np.shape[0]):
                vals = sp_np[i][sp_np[i] > 0]
                if cfg.norm == "minmax":
                    lo, hi = float(vals.min()), float(vals.max())
                else:
                    lo, hi = (float(q) for q in np.quantile(vals, cfg.percentile))
                lo, hi = max(lo, cfg.min_depth), min(hi, cfg.max_depth)
                if not hi > lo:
                    raise ValueError(
                        f"Degenerate sparse depth range for frame {i}: "
                        f"norm={cfg.norm!r} estimated [{lo}, {hi}] "
                        "(all valid points share one value, or the range "
                        "collapses after clamping to "
                        f"[{cfg.min_depth}, {cfg.max_depth}]). Use "
                        "norm='const' or provide varied sparse points."
                    )

        if data_mesh is not None and data_mesh.shape[AXIS_DATA] > 1 and ensemble_size == 1:
            images, sparses = shard_batch(data_mesh, images, sparses)
            if pred_latents_prev is not None:
                pred_latents_prev = shard_batch(data_mesh, pred_latents_prev)
        else:
            data_mesh = None
        images, sparses = _as_tensor(images, device), _as_tensor(sparses, device)
        if pred_latents_prev is not None:
            pred_latents_prev = _as_tensor(_host(pred_latents_prev), device)
            eh, ew = latent_size(
                (int(images.shape[1]), int(images.shape[2])),
                cfg.resolution,
                self.bundle.vae.downsample_factor,
            )
            expected = (images.shape[0], eh, ew, self.bundle.vae.config.latent_channels)
            if tuple(pred_latents_prev.shape) != expected:
                raise ValueError(
                    f"Shape of pred_latents_prev must be {expected}, but got "
                    f"{tuple(pred_latents_prev.shape)}"
                )

        if ensemble_size > 1:
            if pred_latents_prev is not None:
                raise ValueError("temporal latent carry is not supported with ensembling")
            return ensemble_sample(self.bundle, images, sparses, cfg, ensemble_size,
                                   ensemble_reduce, mesh=ensemble_mesh,
                                   return_uncertainty=ensemble_uncertainty,
                                   programs=self.programs)
        denses, latents = guided_sample(self.bundle, images, sparses, cfg, pred_latents_prev,
                                        programs=self.programs)
        if data_mesh is not None:
            return gather_rows(data_mesh, denses), gather_rows(data_mesh, latents)
        return denses, latents
