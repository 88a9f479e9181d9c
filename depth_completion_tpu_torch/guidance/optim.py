"""Latent / affine optimizers: one torch optimizer over two parameter groups
— the latent (lr 0.05 by default) and the learned affine scale/shift (lr
0.005) — as ``depth_completion_tpu.guidance.optim`` builds with optax.
Hyperparameters are torch's: Adam β 0.9/0.999, eps 1e-8; plain SGD;
Adagrad with eps 1e-10 and a zero initial accumulator, whose step follows
the JAX package (below).

``FixedOptimizer`` is the same three optimizers as tensor ops over fixed
state, for the sampler's captured steps: ``torch.optim.Adam`` keeps its
step count on the host and takes its bias corrections as host floats,
which a CUDA graph would freeze at their capture-time values. Here they
are rows of a device table (``adam_table``) read at a device step index;
every op is the one ``torch.optim``'s single-tensor step (and the port's
``Adagrad``) runs, in its order, so on the CPU the two agree bit for bit.
``make_optimizer`` stays the twin it is held to."""

from __future__ import annotations

import numpy as np
import torch

from depth_completion_tpu_torch.device import upload

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # torch.optim.Adam's defaults
ADAGRAD_EPS = 1e-10


class Adagrad(torch.optim.Optimizer):
    """Adagrad with optax's ``scale_by_rss`` rule, as ``optax.adagrad`` in
    the JAX package, this port's reference: acc += g², then
    p -= lr · g · rsqrt(acc + eps) where acc > 0, else no change.

    ``torch.optim.Adagrad`` (the rule of the original PyTorch Marigold-DC)
    steps lr · g / (sqrt(acc) + eps) instead: eps outside the root. The two
    agree for gradients well above sqrt(eps) and part below it (a first step
    at |g| = 1e-5 is lr·0.707 here, lr there)."""

    def __init__(self, params, lr: float, eps: float = ADAGRAD_EPS):
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
        return torch.optim.Adam(groups, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS)
    if opt == "sgd":
        return torch.optim.SGD(groups, lr=lr_latent)
    if opt == "adagrad":
        return Adagrad(groups, lr=lr_latent, eps=ADAGRAD_EPS)
    raise ValueError(f"Unknown optimizer: {opt}")


def adam_table(num_steps: int, lr: float, device: torch.device | str = "cpu") -> torch.Tensor:
    """[steps, 2] float32: step k's −lr/(1−b1^(k+1)) and √(1−b2^(k+1)), the
    values ``torch.optim.Adam`` takes as host floats at its (k+1)-th step."""
    rows = [(-(lr / (1 - ADAM_B1 ** c)), (1 - ADAM_B2 ** c) ** 0.5)
            for c in range(1, num_steps + 1)]
    return upload(np.array(rows, dtype=np.float32), torch.device(device))


class FixedOptimizer:
    """``make_optimizer``'s optimizer (``opt``: adam, sgd or adagrad) as
    tensor ops over fixed buffers: ``params`` (updated in place) with one
    learning rate each (``lrs``), the state beside them (Adam's m and v,
    Adagrad's sum), zeroed by ``reset``. ``step(grads, k)`` is the
    optimizer's step ``k`` (0-based; a one-element int64 device tensor),
    Adam's bias corrections read from its table row; nothing reads a device
    value on the host."""

    def __init__(self, opt: str, params: list[torch.Tensor], lrs: list[float], num_steps: int):
        if opt not in ("adam", "sgd", "adagrad"):
            raise ValueError(f"Unknown optimizer: {opt}")
        self.opt, self.params, self.lrs = opt, list(params), list(lrs)
        zeros = [torch.zeros_like(p) for p in self.params]
        self.state: dict[str, list[torch.Tensor]] = {}
        if opt == "adam":
            self.tables = {lr: adam_table(num_steps, lr, p.device)
                           for p, lr in zip(self.params, self.lrs)}
            self.state = {"adam_m": zeros, "adam_v": [torch.zeros_like(p) for p in self.params]}
        elif opt == "adagrad":
            self.state = {"adagrad_sum": zeros}

    def reset(self) -> None:
        for bufs in self.state.values():
            for b in bufs:
                b.zero_()

    def step(self, grads, k: torch.Tensor) -> None:
        for i, (p, g, lr) in enumerate(zip(self.params, grads, self.lrs)):
            if self.opt == "sgd":
                p.add_(g, alpha=-lr)
            elif self.opt == "adagrad":
                acc = self.state["adagrad_sum"][i]
                acc.add_(g * g)
                inv = torch.where(acc > 0, torch.rsqrt(acc + ADAGRAD_EPS), torch.zeros_like(acc))
                p.add_(inv * g * -lr)
            else:
                # torch.optim.Adam's single-tensor arithmetic, its host
                # floats read from the table row
                m, v = self.state["adam_m"][i], self.state["adam_v"][i]
                neg_step_size, bc2_sqrt = self.tables[lr].index_select(0, k)[0].unbind(0)
                m.lerp_(g, 1 - ADAM_B1)
                v.mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                p.add_(m * neg_step_size / (v.sqrt() / bc2_sqrt).add_(ADAM_EPS))
