"""The plain networks: the Marigold UNet (SD2-class), TAESD, the SD KL VAE
and the CLIP text tower, written from their published structure over the
benchmark's parameter trees (``harness.weights``), float32 throughout.

Configurations are the dicts of ``benchmark/configs/<name>.json``
(``unet``, ``vae``, ``text``). Each product runs through ``nx``, a
``nn.Numerics``; the convs and attention calls that the port computes with
its own kernels are tagged, so ``nn.CallLog`` can count them:

- ``vae3x3``: the stride-1 3x3 convs inside the VAE's blocks (TAESD's block
  convs and bias-free upsample convs in the decoder; the KL VAE's ResNet
  convs, encoder and decoder);
- ``unet_self``: the UNet's self-attention; ``vae_mid``: the KL VAE's mid
  attention.

Departures from diffusers' modules, as in the system under test: the GEGLU
gate takes the tanh GELU (the JAX original's ``jax.nn.gelu``), and the
depth head is the channel mean of ``conv_out`` folded into its kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.nn import (
    group_norm,
    layer_norm,
    resize_nearest,
    timestep_embedding,
    upsample_nearest_2x,
)


def _silu(x):
    return F.silu(x)


def _mean_tap(p):
    """``conv_out`` with its output channels averaged: one output channel."""
    out = {"kernel": p["kernel"].float().mean(dim=0, keepdim=True)}
    if "bias" in p:
        out["bias"] = p["bias"].float().mean().reshape(1)
    return out


# -- UNet -----------------------------------------------------------------

def _unet_resnet(nx, p, x, temb, cfg):
    h = _silu(group_norm(p["norm1"], x, cfg["norm_groups"], cfg["norm_eps"]))
    h = nx.conv(p["conv1"], h)
    h = h + nx.linear(p["time_emb_proj"], _silu(temb))[:, None, None, :]
    h = _silu(group_norm(p["norm2"], h, cfg["norm_groups"], cfg["norm_eps"]))
    h = nx.conv(p["conv2"], h)
    if "conv_shortcut" in p:
        x = nx.conv(p["conv_shortcut"], x, padding=0)
    return x + h


def _unet_attention(nx, a, x, ctx, heads, tag):
    kv = x if ctx is None else ctx
    out = nx.attention(nx.linear(a["to_q"], x), nx.linear(a["to_k"], kv),
                       nx.linear(a["to_v"], kv), heads, tag=tag)
    return nx.linear(a["to_out"], out)


def _transformer(nx, p, x, ctx, heads, cfg):
    n, h, w, c = x.shape
    hidden = group_norm(p["norm"], x, cfg["norm_groups"], 1e-6).reshape(n, h * w, c)
    hidden = nx.linear(p["proj_in"], hidden)
    for blk in p["blocks"]:
        hidden = hidden + _unet_attention(nx, blk["attn1"], layer_norm(blk["norm1"], hidden, 1e-5),
                                          None, heads, "unet_self")
        hidden = hidden + _unet_attention(nx, blk["attn2"], layer_norm(blk["norm2"], hidden, 1e-5),
                                          ctx, heads, "unet_cross")
        val, gate = nx.linear(blk["ff"]["proj_in"], layer_norm(blk["norm3"], hidden, 1e-5)).chunk(
            2, dim=-1)
        hidden = hidden + nx.linear(blk["ff"]["proj_out"], val * F.gelu(gate, approximate="tanh"))
    hidden = nx.linear(p["proj_out"], hidden)
    return hidden.reshape(n, h, w, c) + x


def unet(nx, params, sample, t, ctx, cfg):
    """[N, EH, EW, 8], [N] timesteps, [N, S, D] context → [N, EH, EW, 4]."""
    temb = timestep_embedding(t, cfg["block_out_channels"][0])
    temb = nx.linear(params["time_embedding"]["linear_1"], temb)
    temb = nx.linear(params["time_embedding"]["linear_2"], _silu(temb))
    attn = cfg["attention_stages"]
    h = nx.conv(params["conv_in"], sample)
    skips = [h]
    for i, stage in enumerate(params["down_blocks"]):
        for j, res in enumerate(stage["resnets"]):
            h = _unet_resnet(nx, res, h, temb, cfg)
            if attn[i]:
                h = _transformer(nx, stage["attentions"][j], h, ctx, cfg["num_heads"][i], cfg)
            skips.append(h)
        if "downsampler" in stage:
            h = nx.conv(stage["downsampler"], h, stride=2)
            skips.append(h)
    mid = params["mid_block"]
    h = _unet_resnet(nx, mid["resnets"][0], h, temb, cfg)
    h = _transformer(nx, mid["attentions"][0], h, ctx, cfg["num_heads"][-1], cfg)
    h = _unet_resnet(nx, mid["resnets"][1], h, temb, cfg)
    n_stages = len(cfg["block_out_channels"])
    for i, stage in enumerate(params["up_blocks"]):
        idx = n_stages - 1 - i
        for j, res in enumerate(stage["resnets"]):
            h = _unet_resnet(nx, res, torch.cat([h, skips.pop()], dim=-1), temb, cfg)
            if attn[idx]:
                h = _transformer(nx, stage["attentions"][j], h, ctx, cfg["num_heads"][idx], cfg)
        if "upsampler" in stage:
            target = tuple(skips[-1].shape[1:3])
            if target == (h.shape[1] * 2, h.shape[2] * 2):
                h = upsample_nearest_2x(h)
            else:
                h = resize_nearest(h, target)
            h = nx.conv(stage["upsampler"], h)
    h = _silu(group_norm(params["conv_norm_out"], h, cfg["norm_groups"], cfg["norm_eps"]))
    return nx.conv(params["conv_out"], h)


# -- TAESD ----------------------------------------------------------------

def _taesd_block(nx, p, x, tag=None):
    h = nx.conv(p["conv1"], x, tag=tag, relu=True)
    h = nx.conv(p["conv2"], h, tag=tag, relu=True)
    return nx.conv(p["conv3"], h, tag=tag, relu=True, skip=x)


def taesd_encode(nx, params, images):
    """[-1, 1] NHWC images → latent (diffusion scale)."""
    enc = params["encoder"]
    h = nx.conv(enc["conv_in"], (images + 1.0) / 2.0)
    for stage in enc["stages"]:
        if "down" in stage:
            h = nx.conv(stage["down"], h, stride=2)
        for p in stage["blocks"]:
            h = _taesd_block(nx, p, h)
    return nx.conv(enc["conv_out"], h)


def taesd_decode_depth(nx, params, latents):
    """Latent → [0, 1] depth [N, H, W, 1]: clamp(mean_rgb(decode(z)), 0, 1)."""
    dec = params["decoder"]
    h = 3.0 * torch.tanh(latents / 3.0)
    h = torch.relu(nx.conv(dec["conv_in"], h))
    for stage in dec["stages"]:
        for p in stage["blocks"]:
            h = _taesd_block(nx, p, h, tag="vae3x3")
        if "up_conv" in stage:
            h = nx.conv(stage["up_conv"], upsample_nearest_2x(h), tag="vae3x3")
    return torch.clamp(nx.conv(_mean_tap(dec["conv_out"]), h), 0.0, 1.0)


# -- KL VAE ---------------------------------------------------------------

def _kl_resnet(nx, p, x, cfg):
    h = _silu(group_norm(p["norm1"], x, cfg["norm_groups"], cfg["norm_eps"]))
    h = nx.conv(p["conv1"], h, tag="vae3x3")
    h = _silu(group_norm(p["norm2"], h, cfg["norm_groups"], cfg["norm_eps"]))
    if "conv_shortcut" in p:
        x = nx.conv(p["conv_shortcut"], x, padding=0)
    return nx.conv(p["conv2"], h, tag="vae3x3", skip=x)


def _kl_mid(nx, mid, h, cfg):
    h = _kl_resnet(nx, mid["resnets"][0], h, cfg)
    a = mid["attentions"][0]
    n, hh, ww, c = h.shape
    hidden = group_norm(a["group_norm"], h, cfg["norm_groups"], cfg["norm_eps"]).reshape(
        n, hh * ww, c)
    out = nx.attention(nx.linear(a["to_q"], hidden), nx.linear(a["to_k"], hidden),
                       nx.linear(a["to_v"], hidden), 1, tag="vae_mid")
    h = h + nx.linear(a["to_out"], out).reshape(n, hh, ww, c)
    return _kl_resnet(nx, mid["resnets"][1], h, cfg)


def kl_encode(nx, params, images, cfg):
    """[-1, 1] NHWC images → posterior mean · scaling_factor."""
    enc = params["encoder"]
    h = nx.conv(enc["conv_in"], images)
    for stage in enc["down_blocks"]:
        for p in stage["resnets"]:
            h = _kl_resnet(nx, p, h, cfg)
        if "downsampler" in stage:
            h = nx.conv(stage["downsampler"], h, stride=2, padding=((0, 1), (0, 1)))
    h = _kl_mid(nx, enc["mid_block"], h, cfg)
    h = _silu(group_norm(enc["conv_norm_out"], h, cfg["norm_groups"], cfg["norm_eps"]))
    moments = nx.conv(params["quant_conv"], nx.conv(enc["conv_out"], h), padding=0)
    return moments[..., : cfg["latent_channels"]] * cfg["scaling_factor"]


def kl_decode_depth(nx, params, latents, cfg):
    """Latent → [0, 1] depth: clamp(0.5·mean_rgb(decode(z)) + 0.5, 0, 1)."""
    z = nx.conv(params["post_quant_conv"], latents / cfg["scaling_factor"], padding=0)
    dec = params["decoder"]
    h = _kl_mid(nx, dec["mid_block"], nx.conv(dec["conv_in"], z), cfg)
    for stage in dec["up_blocks"]:
        for p in stage["resnets"]:
            h = _kl_resnet(nx, p, h, cfg)
        if "upsampler" in stage:
            h = nx.conv(stage["upsampler"], upsample_nearest_2x(h))
    h = _silu(group_norm(dec["conv_norm_out"], h, cfg["norm_groups"], cfg["norm_eps"]))
    m = nx.conv(_mean_tap(dec["conv_out"]), h)
    return torch.clamp(0.5 * m + 0.5, 0.0, 1.0)


class VAE:
    """The configuration's VAE: ``encode`` and ``decode_depth``."""

    def __init__(self, kind: str, params, cfg: dict):
        if kind not in ("tiny", "kl"):
            raise ValueError(f"unknown VAE kind {kind!r}")
        self.kind, self.params, self.cfg = kind, params, cfg

    def encode(self, nx, images):
        if self.kind == "kl":
            return kl_encode(nx, self.params, images, self.cfg)
        return taesd_encode(nx, self.params, images)

    def decode_depth(self, nx, latents):
        if self.kind == "kl":
            return kl_decode_depth(nx, self.params, latents, self.cfg)
        return taesd_decode_depth(nx, self.params, latents)


# -- CLIP text tower --------------------------------------------------------

def text_context(params, cfg: dict) -> torch.Tensor:
    """The empty prompt's last hidden state ``[1, 2, hidden]``: the ids
    [BOS, EOS] (clamped into the vocabulary), a pre-LN causal transformer
    with the exact GELU (``quick_gelu``: x·σ(1.702x)), a final LayerNorm."""
    hid, nh = cfg["hidden_size"], cfg["num_heads"]
    hd = hid // nh
    ids = torch.tensor([cfg["bos_token_id"], cfg["eos_token_id"]]).clamp(max=cfg["vocab_size"] - 1)
    dev = params["token_embedding"].device
    h = params["token_embedding"].float()[ids.to(dev)] + params["position_embedding"].float()[:2]
    h = h[None]
    s = h.shape[1]
    mask = torch.full((s, s), float("-inf"), device=dev).triu(1)
    eps = cfg["layer_norm_eps"]

    def lin(p, x):
        return F.linear(x, p["kernel"].float(), p["bias"].float())

    for layer in params["layers"]:
        x = layer_norm(layer["layer_norm1"], h, eps)
        q, k, v = (lin(layer[n], x).reshape(1, s, nh, hd) for n in ("q_proj", "k_proj", "v_proj"))
        logits = torch.einsum("nqhd,nkhd->nhqk", q, k) / hd ** 0.5
        attn = torch.einsum("nhqk,nkhd->nqhd", torch.softmax(logits + mask, dim=-1), v)
        h = h + lin(layer["out_proj"], attn.reshape(1, s, hid))
        x = lin(layer["fc1"], layer_norm(layer["layer_norm2"], h, eps))
        x = F.gelu(x) if cfg["hidden_act"] == "gelu" else x * torch.sigmoid(1.702 * x)
        h = h + lin(layer["fc2"], x)
    return layer_norm(params["final_layer_norm"], h, eps)
