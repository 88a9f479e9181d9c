"""KL autoencoder (SD VAE, ``--vae original``): 8x spatial downsample, 4
latent channels.

Counterpart of ``depth_completion_tpu.models.vae_kl``: deterministic encode
(posterior mean · ``scaling_factor``) and a differentiable decoder that sits
on the per-step guidance gradient path.

- encoder: conv_in → 4 down stages (time-free ResNets, strided conv with
  ``((0, 1), (0, 1))`` padding between) → mid (ResNet, one-head spatial
  attention, ResNet) → GroupNorm/SiLU/conv_out → quant_conv → mean.
- decoder: post_quant_conv → conv_in → mid → 4 up stages (ResNets, nearest
  2x upsample and conv between) → GroupNorm/SiLU → conv_out (or the Marigold
  mean-tap depth head).

Every stride-1 3x3 conv inside a ResNet runs through
``ops.conv3x3.conv3x3_routed``: the Hopper kernel at the real widths
128/256/512 (any Ci and Co that are multiples of 8), the ResNet's residual
add fused into its second conv as the kernel's skip operand, and
``F.conv2d`` at other widths (``conv3x3.fits``), as the JAX package runs
XLA's conv where its kernel does not fit; ``conv_in``, ``conv_out``, the
1x1 shortcuts, the strided downsamplers and the upsample convs are plain
PyTorch. The mid attention runs through ``ops.flash_attention`` (the
heads=1, d=512 kernel at S >= 768). ``encode`` and ``decode_depth`` take
both as ``conv_fn`` and ``attention_fn``, so a caller can run the same
encode or decode through the plain twins.
"""

from __future__ import annotations

import torch

from depth_completion_tpu_torch.models.layers import (
    conv2d,
    conv3x3_mean_tap,
    group_norm,
    linear,
    silu,
    upsample_conv_2x_matmul,
)
from depth_completion_tpu_torch.models.registry import VAEConfig
from depth_completion_tpu_torch.ops.conv3x3 import conv3x3_routed
from depth_completion_tpu_torch.ops.flash_attention import flash_attention


def _resnet(p, x, cfg: VAEConfig, conv_fn):
    h = silu(group_norm(p["norm1"], x, cfg.norm_groups, cfg.norm_eps))
    h = conv_fn(h, p["conv1"]["kernel"], p["conv1"].get("bias"))
    h = silu(group_norm(p["norm2"], h, cfg.norm_groups, cfg.norm_eps))
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding=0)
    return conv_fn(h, p["conv2"]["kernel"], p["conv2"].get("bias"), skip=x)


def _attn(p, x, cfg: VAEConfig, attention_fn):
    """Single-head spatial self-attention (the mid block's)."""
    n, h, w, c = x.shape
    hidden = group_norm(p["group_norm"], x, cfg.norm_groups, cfg.norm_eps).reshape(n, h * w, c)
    q = linear(p["to_q"], hidden)
    k = linear(p["to_k"], hidden)
    v = linear(p["to_v"], hidden)
    out = attention_fn(q, k, v, 1)
    return x + linear(p["to_out"], out).reshape(n, h, w, c)


def _mid(mid, h, cfg, conv_fn, attention_fn):
    h = _resnet(mid["resnets"][0], h, cfg, conv_fn)
    h = _attn(mid["attentions"][0], h, cfg, attention_fn)
    return _resnet(mid["resnets"][1], h, cfg, conv_fn)


def encode(params, images: torch.Tensor, config: VAEConfig, conv_fn=conv3x3_routed,
           attention_fn=flash_attention) -> torch.Tensor:
    """[-1,1] NHWC images → scaled latent (posterior mean · scaling_factor)."""
    cfg = config
    enc = params["encoder"]
    h = conv2d(enc["conv_in"], images)
    for stage in enc["down_blocks"]:
        for p in stage["resnets"]:
            h = _resnet(p, h, cfg, conv_fn)
        if "downsampler" in stage:
            h = conv2d(stage["downsampler"], h, stride=2, padding=((0, 1), (0, 1)))
    h = _mid(enc["mid_block"], h, cfg, conv_fn, attention_fn)
    h = group_norm(enc["conv_norm_out"], h, cfg.norm_groups, cfg.norm_eps)
    moments = conv2d(enc["conv_out"], silu(h))
    moments = conv2d(params["quant_conv"], moments, padding=0)
    return moments[..., : cfg.latent_channels] * cfg.scaling_factor


def _decode_backbone(params, latents, cfg: VAEConfig, conv_fn, attention_fn):
    """Shared decoder trunk: latent → pre-``conv_out`` activations [N,H,W,C]."""
    z = conv2d(params["post_quant_conv"], latents / cfg.scaling_factor, padding=0)
    dec = params["decoder"]
    h = _mid(dec["mid_block"], conv2d(dec["conv_in"], z), cfg, conv_fn, attention_fn)
    for stage in dec["up_blocks"]:
        for p in stage["resnets"]:
            h = _resnet(p, h, cfg, conv_fn)
        if "upsampler" in stage:
            h = upsample_conv_2x_matmul(stage["upsampler"], h)
    return silu(group_norm(dec["conv_norm_out"], h, cfg.norm_groups, cfg.norm_eps))


def decode(params, latents: torch.Tensor, config: VAEConfig) -> torch.Tensor:
    """Scaled latent → NHWC image in [-1,1]."""
    h = _decode_backbone(params, latents, config, conv3x3_routed, flash_attention)
    return conv2d(params["decoder"]["conv_out"], h)


def decode_depth(params, latents: torch.Tensor, config: VAEConfig, conv_fn=conv3x3_routed,
                 attention_fn=flash_attention) -> torch.Tensor:
    """Latent → [0,1] depth [N,H,W,1]: ``clip(mean_rgb(decode(z)), -1, 1)·0.5
    + 0.5`` with the channel mean folded into ``conv_out``."""
    h = _decode_backbone(params, latents, config, conv_fn, attention_fn)
    m = conv3x3_mean_tap(params["decoder"]["conv_out"], h)
    return torch.clamp(0.5 * m + 0.5, 0.0, 1.0)[..., None]
