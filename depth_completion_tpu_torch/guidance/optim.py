"""Latent / affine optimizers: one torch optimizer over two parameter groups
— the latent (lr 0.05 by default) and the learned affine scale/shift (lr
0.005) — as ``depth_completion_tpu.guidance.optim`` builds with optax.
Hyperparameters are torch's: Adam β 0.9/0.999, eps 1e-8; plain SGD;
Adagrad with eps 1e-10 and a zero initial accumulator."""

from __future__ import annotations

import torch


def make_optimizer(opt: str, latents, affine_params, lr_latent=0.05, lr_scaling=0.005):
    """``latents``: the latent tensor; ``affine_params``: list of tensors
    (empty for the closed-form affine)."""
    groups = [{"params": [latents], "lr": lr_latent}]
    if affine_params:
        groups.append({"params": list(affine_params), "lr": lr_scaling})
    if opt == "adam":
        return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
    if opt == "sgd":
        return torch.optim.SGD(groups, lr=lr_latent)
    if opt == "adagrad":
        return torch.optim.Adagrad(groups, lr=lr_latent, initial_accumulator_value=0.0, eps=1e-10)
    raise ValueError(f"Unknown optimizer: {opt}")
