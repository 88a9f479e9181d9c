"""What every driver does with the system under test: build its bundle from
the benchmark's weights, and the sampler settings it is called with."""

from __future__ import annotations

import gc

import torch

from benchmark.harness import weights


def make_bundle(config: dict, seed: int, device: torch.device):
    """The port's ``ModelBundle`` over the seed's weights: the UNet and VAE
    trees as the benchmark made them, the context computed by the port's
    own text tower (whose weights are then dropped)."""
    from depth_completion_tpu_torch.models import clip_text, registry
    from depth_completion_tpu_torch.models.bundle import VAE, ModelBundle
    from depth_completion_tpu_torch.sched.ddim import DDIMConfig

    dtype = weights.config_dtype(config)
    params = weights.make(config, seed, device, dtype)
    text_cfg = registry.CLIPTextConfig(**config["text"])
    with torch.no_grad():
        ctx = clip_text.empty_prompt_context(params.pop("text_encoder"), text_cfg)
    u = config["unet"]
    unet_cfg = registry.UNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                                      for k, v in u.items()})
    v = config["vae"]
    vae_fields = {k: tuple(x) if isinstance(x, list) else x for k, x in v.items()}
    vae_cfg = (registry.VAEConfig if config["vae_kind"] == "kl" else registry.TaesdConfig)(
        **vae_fields)
    sched = {k: x for k, x in config["scheduler"].items()}
    bundle = ModelBundle(unet_params=params["unet"], unet_config=unet_cfg,
                         vae=VAE(kind=config["vae_kind"], params=params["vae"], config=vae_cfg),
                         text_context=ctx, ddim_config=DDIMConfig(**sched))
    gc.collect()
    return bundle


def sampler_kwargs(request: dict) -> dict:
    """The pipeline's keyword arguments for the mix's request settings."""
    r = request
    return dict(max_depth=r["max_depth"], min_depth=r["min_depth"], steps=r["steps"],
                resolution=r["resolution"], norm=r["norm"], loss_funcs=tuple(r["loss_funcs"]),
                opt=r["opt"], lr_latent=r["lr_latent"], lr_scaling=r["lr_scaling"],
                closed_form=r["closed_form"], seed=r["seed"])


def peak_bytes(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device)


def profiler():
    """``torch.profiler`` over the host and, where there is one, the card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)
