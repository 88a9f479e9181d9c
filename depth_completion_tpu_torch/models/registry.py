"""Model configurations (a copy of ``depth_completion_tpu.models.registry``'s
dataclasses for the slice's models; the port imports nothing from there).

- ``MARIGOLD_UNET_CONFIG``: the SD2-class Marigold UNet (8-channel input,
  v-prediction, head dim 64).
- ``TAESD_CONFIG``: the tiny VAE (``madebyollin/taesd``), the default decode.
- ``SD_VAE_CONFIG``: the KL autoencoder (``--vae original``, diffusers'
  ``AutoencoderKL`` at SD widths 128/256/512/512).
"""

from __future__ import annotations

import dataclasses


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


MARIGOLD_UNET_CONFIG = UNetConfig()
SD_VAE_CONFIG = VAEConfig()
TAESD_CONFIG = TaesdConfig()

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
