"""SD2-class conditional UNet (the Marigold denoiser), PyTorch counterpart of
``depth_completion_tpu.models.unet``.

conv_in → [down stages: resnet (+transformer) ×L, downsample] → mid
(resnet, transformer, resnet) → [up stages: skip-concat resnet
(+transformer) ×(L+1), upsample] → GN → silu → conv_out. Transformer block:
LN → self-attn → LN → cross-attn → LN → GEGLU MLP, linear proj in/out.

Activations are NHWC throughout; convs run on their channels-last NCHW view
(``layers.conv2d``). Self-attention goes through ``attention_fn`` — the seam
where ``ops.flash_attention`` (the Hopper kernel) drops in.

With ``remat`` each down stage and each up stage runs under
``torch.utils.checkpoint`` (non-reentrant) when autograd records: its
activations are recomputed in the backward instead of kept, as the JAX
package's ``jax.checkpoint`` does; ``conv_in``, the mid block and
``conv_out`` stay outside. The skips an up stage consumes are taken off
the list before the stage and passed in, so its recompute reads the same
tensors.

The GEGLU gate uses the tanh-approximate GELU: the JAX package calls
``jax.nn.gelu``, whose default is ``approximate=True`` (diffusers' SD2 UNet
uses the exact GELU; see ROADMAP.md "Faults").

Tensor parallelism (``parallel.sharding.shard_bundle``), Megatron's way:
a block whose parameters are a ``ModelShard`` holds this rank's slices of
its fan-out and fan-in layers and runs on its share of the channels or
heads. A replicated activation enters the pair through
``copy_to_model_parallel`` (identity forward; the gradient, partial on each
rank, summed over the model group backward) and leaves through
``reduce_from_model_parallel`` (the partial outputs summed forward; the
gradient passed through backward), and the fan-in layer's bias is added
once, after the sum. The pairs: ``conv1`` with ``time_emb_proj`` and
``conv2`` of a ResNet (``norm2`` on this rank's groups between them);
``to_q``/``to_k``/``to_v`` and ``to_out`` of an attention (whole heads);
the GEGLU's ``proj_in`` (matching slices of both halves) and ``proj_out``.
JAX gets the same function from GSPMD's annotations.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from depth_completion_tpu_torch.models.layers import (
    attention,
    conv2d,
    group_norm,
    layer_norm,
    linear,
    resize_nearest,
    silu,
    timestep_embedding,
    upsample_nearest_2x,
)
from depth_completion_tpu_torch.models.registry import UNetConfig

AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int], torch.Tensor]


class ModelShard(dict):
    """A block's parameters split over a model-parallel ``group`` of
    ``size`` ranks: this rank's slices of the sharded leaves, the others
    whole."""

    def __init__(self, params: dict, group, size: int):
        super().__init__(params)
        self.group, self.size = group, size


class _CopyToModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """The entry of a sharded pair: ``x`` forward; the sum of the ranks'
    gradients backward."""
    return _CopyToModelParallel.apply(x, group)


def reduce_from_model_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """The exit of a sharded pair: the sum of the ranks' partial outputs
    forward; the gradient as it is backward."""
    return _ReduceFromModelParallel.apply(x, group)


def _fan_in(layer, p, x, group):
    """``layer`` (``linear`` or ``conv2d``) of ``x``; for a sharded pair, on
    this rank's input slice, summed over the group, then the bias once."""
    if group is None:
        return layer(p, x)
    y = reduce_from_model_parallel(layer({"kernel": p["kernel"]}, x), group)
    return y + p["bias"].to(y.dtype) if "bias" in p else y


def _resnet(p, x, temb, cfg: UNetConfig):
    group = p.group if isinstance(p, ModelShard) else None
    h = silu(group_norm(p["norm1"], x, cfg.norm_groups, cfg.norm_eps))
    t, groups = silu(temb), cfg.norm_groups
    if group is not None:
        h, t = copy_to_model_parallel(h, group), copy_to_model_parallel(t, group)
        groups //= p.size
    h = conv2d(p["conv1"], h)
    h = h + linear(p["time_emb_proj"], t)[:, None, None, :]
    h = group_norm(p["norm2"], h, groups, cfg.norm_eps)
    h = _fan_in(conv2d, p["conv2"], silu(h), group)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding=0)
    return x + h


def _geglu_ff(p, x):
    group = p.group if isinstance(p, ModelShard) else None
    if group is not None:
        x = copy_to_model_parallel(x, group)
    val, gate = linear(p["proj_in"], x).chunk(2, dim=-1)
    return _fan_in(linear, p["proj_out"], val * F.gelu(gate, approximate="tanh"), group)


def _attention(a, x, ctx, num_heads, attention_fn: AttentionFn):
    """One attention layer over ``x`` (self-attention with ``ctx=None``)."""
    group = a.group if isinstance(a, ModelShard) else None
    if group is not None:
        x = copy_to_model_parallel(x, group)
        ctx = None if ctx is None else copy_to_model_parallel(ctx, group)
        num_heads //= a.size
    kv = x if ctx is None else ctx
    attn = attention_fn(linear(a["to_q"], x), linear(a["to_k"], kv), linear(a["to_v"], kv),
                        num_heads)
    return _fan_in(linear, a["to_out"], attn, group)


def _transformer(p, x, ctx, num_heads, cfg: UNetConfig, attention_fn: AttentionFn):
    """Spatial transformer over NHWC input with linear proj in/out."""
    n, h, w, c = x.shape
    hidden = group_norm(p["norm"], x, cfg.norm_groups, eps=1e-6).reshape(n, h * w, c)
    hidden = linear(p["proj_in"], hidden)
    for blk in p["blocks"]:
        hidden = hidden + _attention(blk["attn1"], layer_norm(blk["norm1"], hidden), None,
                                     num_heads, attention_fn)
        hidden = hidden + _attention(blk["attn2"], layer_norm(blk["norm2"], hidden), ctx,
                                     num_heads, attention_fn)
        hidden = hidden + _geglu_ff(blk["ff"], layer_norm(blk["norm3"], hidden))
    hidden = linear(p["proj_out"], hidden)
    return hidden.reshape(n, h, w, c) + x


def _down_stage(stage, h, temb, ctx, stage_idx: int, cfg: UNetConfig,
                attention_fn: AttentionFn) -> tuple[torch.Tensor, ...]:
    """One down stage → (h, *the skips it adds)."""
    skips = []
    for j, res_p in enumerate(stage["resnets"]):
        h = _resnet(res_p, h, temb, cfg)
        if cfg.attention_stages[stage_idx]:
            h = _transformer(
                stage["attentions"][j], h, ctx, cfg.num_heads[stage_idx], cfg, attention_fn
            )
        skips.append(h)
    if "downsampler" in stage:
        h = conv2d(stage["downsampler"], h, stride=2, padding=1)
        skips.append(h)
    return (h, *skips)


def _up_stage(stage, h, stage_skips, up_target, temb, ctx, stage_idx: int, cfg: UNetConfig,
              attention_fn: AttentionFn) -> torch.Tensor:
    """One up stage; resnet j consumes ``stage_skips[j]`` (newest first).
    ``up_target``: the (H, W) the upsampler must produce, the next stage's
    skip size (odd down-path sizes, e.g. KITTI's 28→14→7→4 latent, are not
    plain 2x)."""
    for j, res_p in enumerate(stage["resnets"]):
        h = _resnet(res_p, torch.cat([h, stage_skips[j]], dim=-1), temb, cfg)
        if cfg.attention_stages[stage_idx]:
            h = _transformer(
                stage["attentions"][j], h, ctx, cfg.num_heads[stage_idx], cfg, attention_fn
            )
    if "upsampler" in stage:
        if up_target == (h.shape[1] * 2, h.shape[2] * 2):
            h = upsample_nearest_2x(h)
        else:
            h = resize_nearest(h, up_target)
        h = conv2d(stage["upsampler"], h)
    return h


def _direct(fn, *args):
    return fn(*args)


def apply_unet(
    params,
    sample: torch.Tensor,
    timestep: torch.Tensor | int,
    encoder_hidden_states: torch.Tensor,
    config: UNetConfig,
    attention_fn: AttentionFn = attention,
    remat: bool = False,
) -> torch.Tensor:
    """UNet forward: [N,EH,EW,Cin], scalar/[N] t, [N,S,D] context → [N,EH,EW,4].
    ``remat``: recompute each down and up stage in the backward. A tensor
    ``timestep`` on the sample's device is read where it lies (the captured
    guided step passes its table row); a Python int becomes a tensor here."""
    cfg = config
    n = sample.shape[0]
    t = timestep if isinstance(timestep, torch.Tensor) else torch.as_tensor(
        timestep, device=sample.device)
    if t.dim() == 0:
        t = t.expand(n)
    temb = timestep_embedding(t, cfg.block_out_channels[0]).to(sample.dtype)
    temb = linear(params["time_embedding"]["linear_1"], temb)
    temb = linear(params["time_embedding"]["linear_2"], silu(temb))
    ctx = encoder_hidden_states.to(sample.dtype)
    n_stages = len(cfg.block_out_channels)
    run = _direct
    if remat and torch.is_grad_enabled():
        # the UNet draws no random numbers (as jax.checkpoint carries no RNG),
        # so nothing saves and restores the RNG state: reading the CUDA
        # generator's state is not allowed inside a CUDA graph capture
        run = functools.partial(checkpoint, use_reentrant=False, preserve_rng_state=False)

    h = conv2d(params["conv_in"], sample)
    skips = [h]
    for i, stage in enumerate(params["down_blocks"]):
        h, *new_skips = run(_down_stage, stage, h, temb, ctx, i, cfg, attention_fn)
        skips.extend(new_skips)

    mid = params["mid_block"]
    h = _resnet(mid["resnets"][0], h, temb, cfg)
    h = _transformer(mid["attentions"][0], h, ctx, cfg.num_heads[-1], cfg, attention_fn)
    h = _resnet(mid["resnets"][1], h, temb, cfg)

    for i, stage in enumerate(params["up_blocks"]):
        stage_skips = [skips.pop() for _ in stage["resnets"]]
        up_target = tuple(skips[-1].shape[1:3]) if skips else None
        h = run(_up_stage, stage, h, stage_skips, up_target, temb, ctx, n_stages - 1 - i, cfg,
                attention_fn)

    h = group_norm(params["conv_norm_out"], h, cfg.norm_groups, cfg.norm_eps)
    return conv2d(params["conv_out"], silu(h))
