"""Latent / affine optimizers: one torch optimizer over two parameter groups
— the latent (lr 0.05 by default) and the learned affine scale/shift (lr
0.005) — as ``depth_completion_tpu.guidance.optim`` builds with optax.
Hyperparameters are torch's: Adam β 0.9/0.999, eps 1e-8; plain SGD;
Adagrad with eps 1e-10 and a zero initial accumulator, whose step follows
the JAX package (below)."""

from __future__ import annotations

import torch


class Adagrad(torch.optim.Optimizer):
    """Adagrad with optax's ``scale_by_rss`` rule, as ``optax.adagrad`` in
    the JAX package, this port's reference: acc += g², then
    p -= lr · g · rsqrt(acc + eps) where acc > 0, else no change.

    ``torch.optim.Adagrad`` (the rule of the original PyTorch Marigold-DC)
    steps lr · g / (sqrt(acc) + eps) instead: eps outside the root. The two
    agree for gradients well above sqrt(eps) and part below it (a first step
    at |g| = 1e-5 is lr·0.707 here, lr there)."""

    def __init__(self, params, lr: float, eps: float = 1e-10):
        super().__init__(params, {"lr": lr, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("Adagrad.step takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum"] = torch.zeros_like(p)
                acc = state["sum"]
                acc.add_(p.grad * p.grad)
                inv = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), torch.zeros_like(acc))
                p.add_(inv * p.grad * -group["lr"])


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
        return Adagrad(groups, lr=lr_latent, eps=1e-10)
    raise ValueError(f"Unknown optimizer: {opt}")
