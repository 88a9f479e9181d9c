"""Tiny VAE (TAESD), the default decode path the guidance gradient runs through.

Counterpart of ``depth_completion_tpu.models.vae_tiny``:

- encoder: conv 3→C, stages of residual Blocks with strided downsample
  convs between, conv C→4; input mapped [-1,1]→[0,1] first. Plain convs.
- decoder: soft clamp 3·tanh(x/3), conv 4→C, ReLU, stages of Blocks with
  nearest-2x upsample + bias-free conv between, conv C→3, output mapped
  [0,1]→[-1,1].
- Block(C) = relu(conv3(relu(conv2(relu(conv1(x))))) + x).

Every decoder conv after ``conv_in`` (the block convs with their ReLU and
skip, and the bias-free ``up_conv``) runs through
``ops.conv3x3.conv3x3_routed``: the Hopper kernel on CUDA at the real
width C=64 (any C that is a multiple of 8), ``F.conv2d`` at other widths
(``conv3x3.fits``), as the JAX package runs XLA's conv there
(``decode_depth`` takes another ``conv_fn`` to compare against); the JAX
package's width-packing to 128 lanes is a TPU layout trick and is not
carried over.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from depth_completion_tpu_torch.models.layers import (
    conv2d,
    conv3x3_mean_tap,
    upsample_nearest_2x,
)
from depth_completion_tpu_torch.models.registry import TaesdConfig
from depth_completion_tpu_torch.ops.conv3x3 import conv3x3_routed


def _block_plain(p, x):
    h = F.relu(conv2d(p["conv1"], x))
    h = F.relu(conv2d(p["conv2"], h))
    return F.relu(conv2d(p["conv3"], h) + x)


def _block_fused(p, x, conv_fn):
    h = conv_fn(x, p["conv1"]["kernel"], p["conv1"]["bias"], relu=True)
    h = conv_fn(h, p["conv2"]["kernel"], p["conv2"]["bias"], relu=True)
    return conv_fn(h, p["conv3"]["kernel"], p["conv3"]["bias"], relu=True, skip=x)


def encode(params, images: torch.Tensor, config: TaesdConfig) -> torch.Tensor:
    """[-1,1] NHWC → latent [N, H/8, W/8, 4] (already in diffusion scale)."""
    del config
    enc = params["encoder"]
    h = conv2d(enc["conv_in"], (images + 1.0) / 2.0)
    for stage in enc["stages"]:
        if "down" in stage:
            h = conv2d(stage["down"], h, stride=2, padding=1)
        for p in stage["blocks"]:
            h = _block_plain(p, h)
    return conv2d(enc["conv_out"], h)


def _decode_backbone(params, latents: torch.Tensor, conv_fn) -> torch.Tensor:
    """Shared decoder trunk: latent → pre-``conv_out`` features [N,H,W,C]."""
    dec = params["decoder"]
    h = 3.0 * torch.tanh(latents / 3.0)
    h = F.relu(conv2d(dec["conv_in"], h)).contiguous()
    for stage in dec["stages"]:
        for p in stage["blocks"]:
            h = _block_fused(p, h, conv_fn)
        if "up_conv" in stage:
            h = conv_fn(upsample_nearest_2x(h), stage["up_conv"]["kernel"])
    return h


def decode(params, latents: torch.Tensor, config: TaesdConfig) -> torch.Tensor:
    """Latent → NHWC image in [-1,1]."""
    del config
    h = _decode_backbone(params, latents, conv3x3_routed)
    out01 = conv2d(params["decoder"]["conv_out"], h)
    return out01 * 2.0 - 1.0


def decode_depth(params, latents: torch.Tensor, config: TaesdConfig,
                 conv_fn=conv3x3_routed) -> torch.Tensor:
    """Latent → [0,1] single-channel depth [N,H,W,1]: the Marigold decode
    head ``clip(mean_rgb(decode(z)), -1, 1)·0.5 + 0.5`` with the channel mean
    folded into ``conv_out`` (``layers.conv3x3_mean_tap``)."""
    del config
    h = _decode_backbone(params, latents, conv_fn)
    out = conv3x3_mean_tap(params["decoder"]["conv_out"], h)
    return torch.clamp(out, 0.0, 1.0)[..., None]
