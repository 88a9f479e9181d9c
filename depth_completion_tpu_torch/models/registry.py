"""Model configurations (a copy of ``depth_completion_tpu.models.registry``'s
dataclasses for the slice's models; the port imports nothing from there).

- ``MARIGOLD_UNET_CONFIG``: the SD2-class Marigold UNet (8-channel input,
  v-prediction, head dim 64).
- ``TAESD_CONFIG``: the tiny VAE (``madebyollin/taesd``), the default decode.
- ``SD_VAE_CONFIG``: the KL autoencoder (``--vae original``, diffusers'
  ``AutoencoderKL`` at SD widths 128/256/512/512).
- ``SD2_TEXT_CONFIG``: the OpenCLIP-ViT/H text tower of SD2/Marigold, which
  makes the empty-prompt context once per bundle.

The ``*_from_diffusers`` / ``*_from_transformers`` readers build these from
a checkpoint directory's ``config.json`` files, with the JAX package's
defaults for any field a file leaves out.
"""

from __future__ import annotations

import dataclasses

from depth_completion_tpu_torch.sched.ddim import DDIMConfig


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    # number of attention heads per stage (SD2 convention: head_dim 64)
    num_heads: tuple[int, ...] = (5, 10, 20, 20)
    # which stages carry transformer blocks (SD2: all but the last down stage)
    attention_stages: tuple[bool, ...] = (True, True, True, False)
    transformer_layers: int = 1
    norm_groups: int = 32
    norm_eps: float = 1e-5
    time_embed_dim_mult: int = 4

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * self.time_embed_dim_mult


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    norm_eps: float = 1e-6
    scaling_factor: float = 0.18215


@dataclasses.dataclass(frozen=True)
class TaesdConfig:
    latent_channels: int = 4
    channels: int = 64
    encoder_blocks: tuple[int, ...] = (1, 3, 3, 3)
    decoder_blocks: tuple[int, ...] = (3, 3, 3, 1)
    scaling_factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    num_layers: int = 23
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"  # SD2's OpenCLIP-ViT/H tower uses the exact GELU
    bos_token_id: int = 49406
    eos_token_id: int = 49407


MARIGOLD_UNET_CONFIG = UNetConfig()
SD_VAE_CONFIG = VAEConfig()
TAESD_CONFIG = TaesdConfig()
SD2_TEXT_CONFIG = CLIPTextConfig()

# Scaled-down geometries for tests (same topology, tiny widths).
TINY_UNET_CONFIG = UNetConfig(
    block_out_channels=(32, 64),
    num_heads=(2, 4),
    attention_stages=(True, False),
    cross_attention_dim=32,
    layers_per_block=1,
    norm_groups=8,
)
TINY_VAE_CONFIG = VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_groups=8)
TINY_TAESD_CONFIG = TaesdConfig(channels=16, encoder_blocks=(1, 1), decoder_blocks=(1, 1))
TINY_TEXT_CONFIG = CLIPTextConfig(
    vocab_size=512, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64
)


def unet_config_from_diffusers(cfg: dict) -> UNetConfig:
    """A UNetConfig from a diffusers ``unet/config.json`` dict (the SD1/SD2/
    Marigold family of ``UNet2DConditionModel`` configs)."""
    blocks = tuple(cfg["block_out_channels"])
    down_types = cfg.get(
        "down_block_types",
        ["CrossAttnDownBlock2D"] * (len(blocks) - 1) + ["DownBlock2D"],
    )
    head_dim = cfg.get("attention_head_dim", 8)
    if isinstance(head_dim, (list, tuple)):
        # diffusers quirk: SD2-class configs store per-stage head *counts* here
        num_heads = tuple(head_dim)
    else:
        num_heads = tuple(max(c // 64, 1) for c in blocks)
    layers = cfg.get("transformer_layers_per_block", 1)
    return UNetConfig(
        in_channels=cfg.get("in_channels", 8),
        out_channels=cfg.get("out_channels", 4),
        block_out_channels=blocks,
        layers_per_block=cfg.get("layers_per_block", 2),
        cross_attention_dim=cfg.get("cross_attention_dim", 1024),
        num_heads=num_heads,
        attention_stages=tuple("CrossAttn" in t for t in down_types),
        transformer_layers=layers if isinstance(layers, int) else 1,
        norm_groups=cfg.get("norm_num_groups", 32),
        norm_eps=cfg.get("norm_eps", 1e-5),
    )


def vae_config_from_diffusers(cfg: dict) -> VAEConfig:
    """A VAEConfig from a diffusers ``vae/config.json`` dict."""
    return VAEConfig(
        in_channels=cfg.get("in_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg["block_out_channels"]),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_groups=cfg.get("norm_num_groups", 32),
        scaling_factor=cfg.get("scaling_factor", 0.18215),
    )


def ddim_config_from_diffusers(cfg: dict) -> DDIMConfig:
    """A DDIMConfig from ``scheduler/scheduler_config.json``. The spacing is
    trailing whatever the file says: the reference rebuilds its scheduler
    with trailing spacing (predict.py:490-498)."""
    schedule = cfg.get("beta_schedule", "scaled_linear")
    if schedule == "squaredcos_cap_v2":
        schedule = "squaredcos"
    return DDIMConfig(
        num_train_timesteps=cfg.get("num_train_timesteps", 1000),
        beta_start=cfg.get("beta_start", 0.00085),
        beta_end=cfg.get("beta_end", 0.012),
        beta_schedule=schedule,
        prediction_type=cfg.get("prediction_type", "v_prediction"),
        set_alpha_to_one=cfg.get("set_alpha_to_one", False),
        steps_offset=cfg.get("steps_offset", 1),
        clip_sample=cfg.get("clip_sample", False),
        clip_sample_range=cfg.get("clip_sample_range", 1.0),
        timestep_spacing="trailing",
    )


def text_config_from_transformers(cfg: dict) -> CLIPTextConfig:
    """A CLIPTextConfig from a transformers ``text_encoder/config.json``."""
    return CLIPTextConfig(
        vocab_size=cfg.get("vocab_size", 49408),
        hidden_size=cfg.get("hidden_size", 1024),
        num_layers=cfg.get("num_hidden_layers", 23),
        num_heads=cfg.get("num_attention_heads", 16),
        intermediate_size=cfg.get("intermediate_size", 4096),
        max_position_embeddings=cfg.get("max_position_embeddings", 77),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
        hidden_act=cfg.get("hidden_act", "gelu"),
        bos_token_id=cfg.get("bos_token_id", 49406),
        eos_token_id=cfg.get("eos_token_id", 49407),
    )
