"""Layer primitives as plain functions over parameter dicts of tensors.

Counterpart of ``depth_completion_tpu.models.layers``. Parameters are nested
dicts (the JAX package's tree, same keys) holding torch tensors in PyTorch's
own layouts: conv weights OIHW, linear weights ``[out, in]``. Activations
are NHWC at every function here, as in the JAX package; a conv runs on the
NCHW view of an NHWC tensor (``permute``), which PyTorch treats as a
channels-last tensor, so no copy is made either way.

Numerics follow the JAX package: matmuls and convs in the activation dtype
with fp32 accumulation; normalisation statistics and softmax in fp32, cast
back to the input dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d(params, x: torch.Tensor, stride: int = 1, padding=1) -> torch.Tensor:
    """3x3 / 1x1 / strided conv over NHWC ``x`` with an OIHW kernel.

    ``padding`` is an int (symmetric) or explicit ``((top, bottom), (left,
    right))``, as the KL encoder's downsamplers use ``((0, 1), (0, 1))``.
    """
    w = params["kernel"].to(x.dtype)
    b = params.get("bias")
    xc = nhwc_to_nchw(x)
    if not isinstance(padding, int):
        (top, bottom), (left, right) = padding
        xc, padding = F.pad(xc, (left, right, top, bottom)), 0
    y = F.conv2d(xc, w, None if b is None else b.to(x.dtype), stride=stride, padding=padding)
    return nchw_to_nhwc(y)


def linear(params, x: torch.Tensor) -> torch.Tensor:
    b = params.get("bias")
    return F.linear(x, params["kernel"].to(x.dtype), None if b is None else b.to(x.dtype))


def group_norm(params, x: torch.Tensor, num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over the channel (last) dim of NHWC / ``[N, ..., C]`` input:
    fp32 statistics over contiguous channel groups, output in ``x.dtype``."""
    n, c = x.shape[0], x.shape[-1]
    g = min(num_groups, c)
    xf = x.float().reshape(n, -1, g, c // g)
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
    out = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


def layer_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    out = F.layer_norm(
        x.float(), (x.shape[-1],), params["scale"].float(), params["bias"].float(), eps
    )
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Multi-head softmax attention over ``[N, S, C]`` tensors.

    fp32 logits and softmax, probabilities cast to the input dtype for the
    value product (fp32 accumulation), as ``layers.attention`` in the JAX
    package. This is the plain path; ``ops.flash_attention`` routes the
    long self-attention calls to the Hopper kernel.
    """
    n, sq, c = q.shape
    sk = k.shape[1]
    hd = c // num_heads
    qh = q.reshape(n, sq, num_heads, hd).transpose(1, 2)
    kh = k.reshape(n, sk, num_heads, hd).transpose(1, 2)
    vh = v.reshape(n, sk, num_heads, hd).transpose(1, 2)
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / math.sqrt(hd)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(probs.float(), vh.float()).to(q.dtype)
    return out.transpose(1, 2).reshape(n, sq, c)


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding, ``[cos, sin]`` order (SD convention):
    ``[N]`` → ``[N, dim]`` float32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def conv3x3_mean_tap(params, h: torch.Tensor) -> torch.Tensor:
    """Channel mean of ``conv3x3(h) + bias`` with the mean folded into the
    kernel: ``mean_co(conv(h, W) + b) = conv(h, mean_co W) + mean_co b``
    (exact). One single-output conv instead of a C_out=3 conv and a mean.
    Returns ``[N, H, W]``."""
    kbar = params["kernel"].float().mean(dim=0, keepdim=True).to(h.dtype)  # [1, C, 3, 3]
    b = params.get("bias")
    bbar = None if b is None else b.float().mean().reshape(1).to(h.dtype)
    return F.conv2d(nhwc_to_nchw(h), kbar, bbar, padding=1)[:, 0]


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest-neighbour 2x upsample."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """NHWC nearest resize with half-pixel centres (``jax.image.resize``'s
    "nearest", which is PyTorch's ``nearest-exact``)."""
    return nchw_to_nhwc(F.interpolate(nhwc_to_nchw(x), size=size, mode="nearest-exact"))


def upsample_conv_2x_matmul(params, x: torch.Tensor) -> torch.Tensor:
    """``conv2d(params, upsample_nearest_2x(x))``. The JAX package computes
    the same function in a subpixel form (2x2 taps summed in ``x.dtype`` on
    the source grid); on the H100 the conv of the upsampled map ran the KL
    step's device time lower (``scripts/profile_torch_step.py --upsample``)."""
    return conv2d(params, upsample_nearest_2x(x))
