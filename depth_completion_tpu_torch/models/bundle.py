"""ModelBundle: the pipeline's view of (UNet, VAE, text context, schedule),
the port's own seeded random initialisation, and ``load_bundle``, which
reads an HF-layout checkpoint directory.

Counterpart of ``depth_completion_tpu.models.bundle``. Parameter trees are
nested dicts with the JAX package's keys; tensors use PyTorch layouts (conv
OIHW, linear ``[out, in]``). Initialisation follows the JAX package's
scheme (Kaiming-uniform ``±1/√fan_in`` for weights and biases, unit/zero
norms, normal embeddings) from a ``torch.Generator``; the numbers differ
from JAX's, which is why the tests move weights across with
``weights.from_jax_params``. Either way the context is the CLIP text
tower's output for the empty prompt, computed once.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Any

import torch

from depth_completion_tpu_torch.device import resolve_device
from depth_completion_tpu_torch.models import clip_text, registry, vae_kl, vae_tiny
from depth_completion_tpu_torch.models.registry import (
    CLIPTextConfig,
    TaesdConfig,
    UNetConfig,
    VAEConfig,
)
from depth_completion_tpu_torch.ops.conv3x3 import conv3x3_routed
from depth_completion_tpu_torch.ops.flash_attention import flash_attention


class _Init:
    """Seeded parameter factory (a ``meta`` device makes shapes only)."""

    def __init__(self, seed: int, dtype: torch.dtype, device: torch.device):
        self.dtype, self.device = dtype, device
        self.gen = None
        if device.type != "meta":
            self.gen = torch.Generator(device=device).manual_seed(seed)

    def _uniform(self, shape, fan_in):
        if self.gen is None:
            return torch.empty(shape, dtype=self.dtype, device=self.device)
        bound = 1.0 / math.sqrt(fan_in)
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        return t.uniform_(-bound, bound, generator=self.gen).to(self.dtype)

    def normal(self, shape, std):
        if self.gen is None:
            return torch.empty(shape, dtype=self.dtype, device=self.device)
        t = torch.randn(shape, generator=self.gen, dtype=torch.float32, device=self.device)
        return (t * std).to(self.dtype)

    def conv(self, k, cin, cout, bias=True):
        p = {"kernel": self._uniform((cout, cin, k, k), k * k * cin)}
        if bias:
            p["bias"] = self._uniform((cout,), k * k * cin)
        return p

    def linear(self, cin, cout, bias=True):
        p = {"kernel": self._uniform((cout, cin), cin)}
        if bias:
            p["bias"] = self._uniform((cout,), cin)
        return p

    def norm(self, c):
        return {
            "scale": torch.ones((c,), dtype=self.dtype, device=self.device),
            "bias": torch.zeros((c,), dtype=self.dtype, device=self.device),
        }


def _resnet_init(mk: _Init, cin, cout, temb_dim):
    p = {
        "norm1": mk.norm(cin),
        "conv1": mk.conv(3, cin, cout),
        "time_emb_proj": mk.linear(temb_dim, cout),
        "norm2": mk.norm(cout),
        "conv2": mk.conv(3, cout, cout),
    }
    if cin != cout:
        p["conv_shortcut"] = mk.conv(1, cin, cout)
    return p


def _transformer_init(mk: _Init, c, cfg: UNetConfig):
    def attn(kv_dim):
        return {
            "to_q": mk.linear(c, c, bias=False),
            "to_k": mk.linear(kv_dim, c, bias=False),
            "to_v": mk.linear(kv_dim, c, bias=False),
            "to_out": mk.linear(c, c),
        }

    return {
        "norm": mk.norm(c),
        "proj_in": mk.linear(c, c),
        "blocks": [
            {
                "norm1": mk.norm(c),
                "attn1": attn(c),
                "norm2": mk.norm(c),
                "attn2": attn(cfg.cross_attention_dim),
                "norm3": mk.norm(c),
                "ff": {"proj_in": mk.linear(c, c * 8), "proj_out": mk.linear(c * 4, c)},
            }
            for _ in range(cfg.transformer_layers)
        ],
        "proj_out": mk.linear(c, c),
    }


def init_unet(mk: _Init, cfg: UNetConfig):
    temb_dim = cfg.time_embed_dim
    chans = cfg.block_out_channels
    params: dict = {
        "conv_in": mk.conv(3, cfg.in_channels, chans[0]),
        "time_embedding": {
            "linear_1": mk.linear(chans[0], temb_dim),
            "linear_2": mk.linear(temb_dim, temb_dim),
        },
    }
    down, skip_channels, cin = [], [chans[0]], chans[0]
    for i, cout in enumerate(chans):
        stage: dict = {"resnets": [], "attentions": []}
        for _ in range(cfg.layers_per_block):
            stage["resnets"].append(_resnet_init(mk, cin, cout, temb_dim))
            cin = cout
            if cfg.attention_stages[i]:
                stage["attentions"].append(_transformer_init(mk, cout, cfg))
            skip_channels.append(cout)
        if i < len(chans) - 1:
            stage["downsampler"] = mk.conv(3, cout, cout)
            skip_channels.append(cout)
        down.append(stage)
    params["down_blocks"] = down
    c_mid = chans[-1]
    params["mid_block"] = {
        "resnets": [
            _resnet_init(mk, c_mid, c_mid, temb_dim),
            _resnet_init(mk, c_mid, c_mid, temb_dim),
        ],
        "attentions": [_transformer_init(mk, c_mid, cfg)],
    }
    up, cin = [], c_mid
    for i in range(len(chans)):
        stage_idx = len(chans) - 1 - i
        cout = chans[stage_idx]
        stage = {"resnets": [], "attentions": []}
        for _ in range(cfg.layers_per_block + 1):
            stage["resnets"].append(
                _resnet_init(mk, cin + skip_channels.pop(), cout, temb_dim)
            )
            cin = cout
            if cfg.attention_stages[stage_idx]:
                stage["attentions"].append(_transformer_init(mk, cout, cfg))
        if i < len(chans) - 1:
            stage["upsampler"] = mk.conv(3, cout, cout)
        up.append(stage)
    params["up_blocks"] = up
    params["conv_norm_out"] = mk.norm(chans[0])
    params["conv_out"] = mk.conv(3, chans[0], cfg.out_channels)
    return params


def init_taesd(mk: _Init, cfg: TaesdConfig):
    c = cfg.channels

    def block():
        return {"conv1": mk.conv(3, c, c), "conv2": mk.conv(3, c, c), "conv3": mk.conv(3, c, c)}

    enc: dict = {"conv_in": mk.conv(3, 3, c), "stages": []}
    for i, n_blocks in enumerate(cfg.encoder_blocks):
        stage = {"blocks": [block() for _ in range(n_blocks)]}
        if i > 0:
            stage["down"] = mk.conv(3, c, c, bias=False)
        enc["stages"].append(stage)
    enc["conv_out"] = mk.conv(3, c, cfg.latent_channels)
    dec: dict = {"conv_in": mk.conv(3, cfg.latent_channels, c), "stages": []}
    for i, n_blocks in enumerate(cfg.decoder_blocks):
        stage = {"blocks": [block() for _ in range(n_blocks)]}
        if i < len(cfg.decoder_blocks) - 1:
            stage["up_conv"] = mk.conv(3, c, c, bias=False)
        dec["stages"].append(stage)
    dec["conv_out"] = mk.conv(3, c, 3)
    return {"encoder": enc, "decoder": dec}


def _kl_resnet_init(mk: _Init, cin, cout):
    p = {
        "norm1": mk.norm(cin),
        "conv1": mk.conv(3, cin, cout),
        "norm2": mk.norm(cout),
        "conv2": mk.conv(3, cout, cout),
    }
    if cin != cout:
        p["conv_shortcut"] = mk.conv(1, cin, cout)
    return p


def _kl_mid_init(mk: _Init, c):
    return {
        "resnets": [_kl_resnet_init(mk, c, c), _kl_resnet_init(mk, c, c)],
        "attentions": [{
            "group_norm": mk.norm(c),
            "to_q": mk.linear(c, c),
            "to_k": mk.linear(c, c),
            "to_v": mk.linear(c, c),
            "to_out": mk.linear(c, c),
        }],
    }


def init_vae(mk: _Init, cfg: VAEConfig):
    """KL-VAE parameter tree (the JAX package's ``vae_kl.init_vae`` keys)."""
    chans = cfg.block_out_channels
    n_stages = len(chans)
    enc: dict = {"conv_in": mk.conv(3, cfg.in_channels, chans[0]), "down_blocks": []}
    cin = chans[0]
    for i, cout in enumerate(chans):
        stage: dict = {"resnets": []}
        for _ in range(cfg.layers_per_block):
            stage["resnets"].append(_kl_resnet_init(mk, cin, cout))
            cin = cout
        if i < n_stages - 1:
            stage["downsampler"] = mk.conv(3, cout, cout)
        enc["down_blocks"].append(stage)
    c_mid = chans[-1]
    enc["mid_block"] = _kl_mid_init(mk, c_mid)
    enc["conv_norm_out"] = mk.norm(c_mid)
    enc["conv_out"] = mk.conv(3, c_mid, 2 * cfg.latent_channels)
    dec: dict = {"conv_in": mk.conv(3, cfg.latent_channels, c_mid)}
    dec["mid_block"] = _kl_mid_init(mk, c_mid)
    up, cin = [], c_mid
    for i in range(n_stages):
        cout = chans[n_stages - 1 - i]
        stage = {"resnets": []}
        for _ in range(cfg.layers_per_block + 1):
            stage["resnets"].append(_kl_resnet_init(mk, cin, cout))
            cin = cout
        if i < n_stages - 1:
            stage["upsampler"] = mk.conv(3, cout, cout)
        up.append(stage)
    dec["up_blocks"] = up
    dec["conv_norm_out"] = mk.norm(chans[0])
    dec["conv_out"] = mk.conv(3, chans[0], cfg.in_channels)
    return {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": mk.conv(1, 2 * cfg.latent_channels, 2 * cfg.latent_channels),
        "post_quant_conv": mk.conv(1, cfg.latent_channels, cfg.latent_channels),
    }


@dataclasses.dataclass(frozen=True)
class VAE:
    """VAE params + config, dispatching on the family: ``"tiny"`` (TAESD,
    ``--vae light``) or ``"kl"`` (``AutoencoderKL``, ``--vae original``)."""

    kind: str  # "tiny" | "kl"
    params: Any
    config: TaesdConfig | VAEConfig

    def __post_init__(self):
        if self.kind not in ("tiny", "kl"):
            raise ValueError(f"unknown VAE kind {self.kind!r} (expected 'tiny' or 'kl')")

    def encode(self, images: torch.Tensor, conv_fn=conv3x3_routed,
               attention_fn=flash_attention) -> torch.Tensor:
        """[-1,1] NHWC images → scaled latent; ``conv_fn`` and
        ``attention_fn`` run the KL encoder's stride-1 3x3 convs and mid
        attention (the TAESD encoder runs neither)."""
        if self.kind == "kl":
            return vae_kl.encode(self.params, images, self.config, conv_fn, attention_fn)
        return vae_tiny.encode(self.params, images, self.config)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        if self.kind == "kl":
            return vae_kl.decode(self.params, latents, self.config)
        return vae_tiny.decode(self.params, latents, self.config)

    def decode_depth(self, latents: torch.Tensor, conv_fn=conv3x3_routed,
                     attention_fn=flash_attention) -> torch.Tensor:
        """Latent → [0,1] depth [N,H,W,1] with ``conv_fn`` running the
        decoder's stride-1 3x3 convs and ``attention_fn`` the KL mid
        attention (TAESD has none)."""
        if self.kind == "kl":
            return vae_kl.decode_depth(self.params, latents, self.config, conv_fn, attention_fn)
        return vae_tiny.decode_depth(self.params, latents, self.config, conv_fn)

    @property
    def downsample_factor(self) -> int:
        """Spatial downsampling of encode (8 for the full-size configs)."""
        if self.kind == "kl":
            return 2 ** (len(self.config.block_out_channels) - 1)
        return 2 ** (len(self.config.encoder_blocks) - 1)


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """Everything the sampling loop needs besides the schedule."""

    unet_params: Any
    unet_config: UNetConfig
    vae: VAE
    # [1, S, D] cached empty-prompt context (S=2)
    text_context: torch.Tensor
    ddim_config: Any = None  # sched.ddim.DDIMConfig | None → sampler default
    # the model-parallel process group of a tensor-parallel UNet
    # (parallel.sharding.shard_bundle); None for a whole UNet
    model_group: Any = None

    @property
    def device(self) -> torch.device:
        return self.text_context.device

    @property
    def dtype(self) -> torch.dtype:
        return self.text_context.dtype


def make_random_params(
    seed: int,
    unet_config: UNetConfig,
    vae_kind: str,
    vae_config: TaesdConfig | VAEConfig,
    text_config: CLIPTextConfig,
    dtype: torch.dtype,
    device: torch.device,
) -> dict:
    """Seeded ``{"unet", "vae", "text_encoder"}`` trees (seeds ``seed``,
    ``seed + 1``, ``seed + 2``): what ``make_random_bundle`` assembles, and
    what a checkpoint directory written from them holds."""
    init_vae_fn = init_vae if vae_kind == "kl" else init_taesd
    return {
        "unet": init_unet(_Init(seed, dtype, device), unet_config),
        "vae": init_vae_fn(_Init(seed + 1, dtype, device), vae_config),
        "text_encoder": clip_text.init_text_encoder(_Init(seed + 2, dtype, device), text_config),
    }


def make_random_bundle(
    seed: int = 0,
    unet_config: UNetConfig = registry.TINY_UNET_CONFIG,
    vae_config: TaesdConfig | VAEConfig | None = None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
    vae_kind: str = "tiny",
    text_config: CLIPTextConfig = registry.TINY_TEXT_CONFIG,
) -> ModelBundle:
    """Random-weight bundle made from ``seed`` on ``device`` (the GPU by
    default). ``vae_kind`` picks TAESD (``"tiny"``) or the KL VAE
    (``"kl"``) and must match ``vae_config``'s type; ``vae_config=None``
    takes that family's tiny test config. The context is a seeded text
    tower's output for the empty prompt, zero-padded or trimmed to the
    UNet's ``cross_attention_dim`` where the two configs disagree."""
    if vae_kind not in ("tiny", "kl"):
        raise ValueError(f"unknown VAE kind {vae_kind!r} (expected 'tiny' or 'kl')")
    kl = vae_kind == "kl"
    if vae_config is None:
        vae_config = registry.TINY_VAE_CONFIG if kl else registry.TINY_TAESD_CONFIG
    elif isinstance(vae_config, VAEConfig) != kl:
        raise ValueError(f"vae_kind={vae_kind!r} does not match {type(vae_config).__name__}")
    dev = resolve_device(device)
    params = make_random_params(seed, unet_config, vae_kind, vae_config, text_config, dtype, dev)
    with torch.no_grad():
        ctx = clip_text.empty_prompt_context(params["text_encoder"], text_config)
    width = unet_config.cross_attention_dim
    if ctx.shape[-1] != width:
        padded = ctx.new_zeros((1, ctx.shape[1], width))
        keep = min(ctx.shape[-1], width)
        padded[..., :keep] = ctx[..., :keep]
        ctx = padded
    return ModelBundle(
        unet_params=params["unet"],
        unet_config=unet_config,
        vae=VAE(kind=vae_kind, params=params["vae"], config=vae_config),
        text_context=ctx,
    )


def _read_json(path: Path) -> dict | None:
    return json.loads(path.read_text()) if path.exists() else None


def load_bundle(
    model_dir: str | Path,
    vae_kind: str = "tiny",
    taesd_dir: str | Path | None = None,
    dtype: torch.dtype = torch.bfloat16,
    unet_config: UNetConfig | None = None,
    text_config: CLIPTextConfig | None = None,
    device: str | torch.device | None = None,
) -> ModelBundle:
    """A Marigold HF-layout checkpoint directory on ``device`` (the GPU by
    default).

    ``model_dir`` holds ``unet/``, ``vae/``, ``text_encoder/`` and
    ``scheduler/``; ``taesd_dir`` (flat safetensors, ``TAESD_CONFIG``)
    replaces the VAE when ``vae_kind="tiny"``, the reference's default
    assembly (predict.py:478-488). Geometry and the diffusion schedule come
    from the directory's config JSONs where present (explicit
    ``unet_config`` / ``text_config`` override), else the full-size
    defaults; the context is the loaded tower's, computed once."""
    from depth_completion_tpu_torch.models import weights

    dev = resolve_device(device)
    if vae_kind not in ("tiny", "kl"):
        raise ValueError(f"unknown VAE kind {vae_kind!r} (expected 'tiny' or 'kl')")
    if vae_kind == "tiny" and taesd_dir is None:
        raise ValueError("taesd_dir is required for vae_kind='tiny'")
    model_dir = Path(model_dir)
    if unet_config is None:
        cfg = _read_json(model_dir / "unet" / "config.json")
        unet_config = (registry.unet_config_from_diffusers(cfg) if cfg
                       else registry.MARIGOLD_UNET_CONFIG)
    if text_config is None:
        cfg = _read_json(model_dir / "text_encoder" / "config.json")
        text_config = (registry.text_config_from_transformers(cfg) if cfg
                       else registry.SD2_TEXT_CONFIG)
    cfg = _read_json(model_dir / "scheduler" / "scheduler_config.json")
    ddim_config = registry.ddim_config_from_diffusers(cfg) if cfg else None

    unet = weights.load_unet(model_dir / "unet", unet_config, dtype, dev)
    if vae_kind == "tiny":
        vae = VAE("tiny", weights.load_taesd(taesd_dir, registry.TAESD_CONFIG, dtype, dev),
                  registry.TAESD_CONFIG)
    else:
        cfg = _read_json(model_dir / "vae" / "config.json")
        vae_config = registry.vae_config_from_diffusers(cfg) if cfg else registry.SD_VAE_CONFIG
        vae = VAE("kl", weights.load_vae(model_dir / "vae", vae_config, dtype, dev), vae_config)
    text = weights.load_text_encoder(model_dir / "text_encoder", text_config, dtype, dev)
    with torch.no_grad():
        ctx = clip_text.empty_prompt_context(text, text_config)
    return ModelBundle(
        unet_params=unet,
        unet_config=unet_config,
        vae=vae,
        text_context=ctx,
        ddim_config=ddim_config,
    )
