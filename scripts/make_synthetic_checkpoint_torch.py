"""Write a full-size synthetic Marigold checkpoint in the HF layout with the
PyTorch port alone: the counterpart of ``scripts/make_synthetic_checkpoint.py``.

The real pinned weights (``prs-eth/marigold-v1-0``, ``madebyollin/taesd``)
are not on the machine, so this writes a checkpoint with their layout, key
inventory and shapes and random values: the whole load → convert → sample
path runs at production geometry before the weights arrive, and on that day
``scripts/verify_checkpoint_torch.py`` checks the real files key by key.

- **Inventories** come from the port's exporters (``models/weights.py``:
  ``to_diffusers_unet_state``, ``to_diffusers_vae_state``,
  ``to_diffusers_taesd_state``, ``to_transformers_text_encoder_state``)
  applied to the port's parameter trees built on the ``meta`` device, so no
  full-width tensor is allocated to learn a shape. The geometry is read from
  the config JSONs written (``models/registry.py``'s readers, as the loader
  reads them).
- **Values** are what the JAX script writes: float16 ``standard_normal *
  0.02`` from ``numpy.random.default_rng``, one generator per component
  (the UNet at ``seed``, the KL VAE at ``seed + 1``, TAESD at ``seed + 2``),
  drawn key by key in the JAX script's order (JAX flattens a dict in
  sorted key order; TAESD's encoder before its decoder). So both drills
  load the same UNet, VAE and TAESD weights. The JAX script takes its text
  tower from ``transformers``' own initialiser; the port's machines have no
  ``transformers``, so the tower here is seeded normals too (``seed + 3``),
  in the inventory ``transformers.CLIPTextModel`` has at SD2 geometry.
- **Layout**, the JAX script's::

      OUT_DIR/
        unet/config.json + diffusion_pytorch_model.safetensors   (~866M params)
        vae/config.json + diffusion_pytorch_model.safetensors    (~84M)
        text_encoder/config.json + model.safetensors             (~340M)
        scheduler/scheduler_config.json                          (Marigold DDIM)
      TAESD_DIR/ (default OUT_DIR/../taesd)
        config.json + diffusion_pytorch_model.safetensors        (~2.4M)

``write_checkpoint`` is the writer: the config JSONs and the components to
write, each from a given state dict (``chip_smoke.py`` hands it its seeded
trees) or from the seeded synthetic one.

Usage::

    python scripts/make_synthetic_checkpoint_torch.py /tmp/drill/marigold-synth \\
        [--taesd-out /tmp/drill/taesd] [--seed 0]
    python scripts/verify_checkpoint_torch.py /tmp/drill/marigold-synth --taesd /tmp/drill/taesd

One-command drill: ``scripts/checkpoint_drill_torch.sh``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from depth_completion_tpu_torch.models import registry, safetensors_io, weights  # noqa: E402
from depth_completion_tpu_torch.models.bundle import make_random_params  # noqa: E402

# The config JSONs a real prs-eth/marigold-v1-0 and madebyollin/taesd ship
# (every field the readers of models/registry.py consume), as the JAX
# script writes them; the text tower's is transformers' CLIPTextConfig of
# SD2's OpenCLIP-ViT/H tower with the tokenizer's BOS and EOS ids.
UNET_CONFIG_JSON = {
    "_class_name": "UNet2DConditionModel", "in_channels": 8, "out_channels": 4,
    "block_out_channels": [320, 640, 1280, 1280],
    "down_block_types": ["CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                         "DownBlock2D"],
    "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                       "CrossAttnUpBlock2D"],
    "layers_per_block": 2, "cross_attention_dim": 1024, "attention_head_dim": [5, 10, 20, 20],
    "norm_num_groups": 32, "norm_eps": 1e-05, "sample_size": 96,
}
VAE_CONFIG_JSON = {
    "_class_name": "AutoencoderKL", "in_channels": 3, "out_channels": 3, "latent_channels": 4,
    "block_out_channels": [128, 256, 512, 512], "layers_per_block": 2, "norm_num_groups": 32,
    "scaling_factor": 0.18215, "sample_size": 768,
}
SCHEDULER_CONFIG_JSON = {
    "_class_name": "DDIMScheduler", "num_train_timesteps": 1000, "beta_start": 0.00085,
    "beta_end": 0.012, "beta_schedule": "scaled_linear", "clip_sample": False,
    "set_alpha_to_one": False, "steps_offset": 1, "prediction_type": "v_prediction",
    "timestep_spacing": "leading",
}
TAESD_CONFIG_JSON = {
    "_class_name": "AutoencoderTiny", "in_channels": 3, "out_channels": 3, "latent_channels": 4,
    "encoder_block_out_channels": [64, 64, 64, 64], "decoder_block_out_channels": [64, 64, 64, 64],
    "num_encoder_blocks": [1, 3, 3, 3], "num_decoder_blocks": [3, 3, 3, 1], "scaling_factor": 1.0,
}
TEXT_ENCODER_CONFIG_JSON = {
    "architectures": ["CLIPTextModel"], "hidden_act": "gelu", "hidden_size": 1024,
    "intermediate_size": 4096, "layer_norm_eps": 1e-05, "max_position_embeddings": 77,
    "num_attention_heads": 16, "num_hidden_layers": 23, "projection_dim": 512,
    "vocab_size": 49408, "bos_token_id": 49406, "eos_token_id": 49407, "torch_dtype": "float16",
}
CONFIGS = {"unet": UNET_CONFIG_JSON, "vae": VAE_CONFIG_JSON,
           "text_encoder": TEXT_ENCODER_CONFIG_JSON, "scheduler": SCHEDULER_CONFIG_JSON,
           "taesd": TAESD_CONFIG_JSON}
COMPONENTS = tuple(CONFIGS)
# the JAX script's generator seeds, as offsets from --seed (the text tower's
# is the port's own)
SEED_OFFSETS = {"unet": 0, "vae": 1, "taesd": 2, "text_encoder": 3}
WEIGHT_FILES = {"unet": "diffusion_pytorch_model.safetensors",
                "vae": "diffusion_pytorch_model.safetensors",
                "text_encoder": "model.safetensors",
                "taesd": "diffusion_pytorch_model.safetensors"}


def taesd_config(cfg: dict) -> registry.TaesdConfig:
    """The TAESD geometry of an ``AutoencoderTiny`` config.json."""
    return registry.TaesdConfig(
        latent_channels=cfg.get("latent_channels", 4),
        channels=cfg.get("decoder_block_out_channels", [64])[0],
        encoder_blocks=tuple(cfg.get("num_encoder_blocks", (1, 3, 3, 3))),
        decoder_blocks=tuple(cfg.get("num_decoder_blocks", (3, 3, 3, 1))),
        scaling_factor=cfg.get("scaling_factor", 1.0))


def _sorted_tree(tree):
    """``tree`` with every dict's keys in sorted order, as JAX flattens it."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted_tree(v) for v in tree)
    return tree


def inventory(component: str, config: dict) -> dict[str, tuple[int, ...]]:
    """HF key → torch-layout shape of ``component`` ("unet", "vae",
    "text_encoder" or "taesd") at the geometry of its config JSON, in the
    JAX script's key order; computed on the meta device."""
    meta = torch.device("meta")
    text_cfg = registry.TINY_TEXT_CONFIG
    if component == "unet":
        tree = make_random_params(0, registry.unet_config_from_diffusers(config), "tiny",
                                  registry.TAESD_CONFIG, text_cfg, torch.float16, meta)["unet"]
        state = weights.to_diffusers_unet_state(_sorted_tree(tree))
    elif component == "vae":
        tree = make_random_params(0, registry.TINY_UNET_CONFIG, "kl",
                                  registry.vae_config_from_diffusers(config), text_cfg,
                                  torch.float16, meta)["vae"]
        state = weights.to_diffusers_vae_state(_sorted_tree(tree))
    elif component == "taesd":
        cfg = taesd_config(config)
        tree = make_random_params(0, registry.TINY_UNET_CONFIG, "tiny", cfg, text_cfg,
                                  torch.float16, meta)["vae"]
        tree = {side: _sorted_tree(tree[side]) for side in ("encoder", "decoder")}
        state = weights.to_diffusers_taesd_state(tree, cfg)
    elif component == "text_encoder":
        cfg = registry.text_config_from_transformers(config)
        tree = make_random_params(0, registry.TINY_UNET_CONFIG, "tiny", registry.TAESD_CONFIG,
                                  cfg, torch.float16, meta)["text_encoder"]
        state = weights.to_transformers_text_encoder_state(tree)
    else:
        raise ValueError(f"no weights for component {component!r}")
    return {k: tuple(v.shape) for k, v in state.items()}


def synthetic_state(shapes: dict[str, tuple[int, ...]], seed: int) -> dict[str, torch.Tensor]:
    """float16 ``standard_normal * 0.02`` per key, in ``shapes``' order, from
    one seeded numpy generator (the JAX script's ``_random_like_shapes``)."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy((rng.standard_normal(s) * 0.02).astype(np.float16))
            for k, s in shapes.items()}


def write_checkpoint(out_dir: Path, taesd_dir: Path | None = None, *,
                     components: tuple[str, ...] = COMPONENTS,
                     configs: dict[str, dict] | None = None,
                     states: dict[str, dict[str, torch.Tensor]] | None = None,
                     seed: int = 0, log=print) -> dict[str, dict]:
    """Write ``components`` of an HF-layout checkpoint: ``unet/``, ``vae/``,
    ``text_encoder/`` and ``scheduler/`` under ``out_dir``, ``taesd`` into
    ``taesd_dir`` (default ``out_dir/../taesd``). Each config.json is
    ``configs[component]`` (default: the published ones above); each
    weight file holds ``states[component]`` where given, else the seeded
    synthetic state at that config's geometry. → per component: tensors,
    parameters, bytes written and seconds."""
    configs = {**CONFIGS, **(configs or {})}
    states = states or {}
    taesd_dir = Path(taesd_dir) if taesd_dir is not None else Path(out_dir).parent / "taesd"
    report = {}
    for comp in components:
        t0 = time.perf_counter()
        where = taesd_dir if comp == "taesd" else Path(out_dir) / comp
        where.mkdir(parents=True, exist_ok=True)
        if comp == "scheduler":
            (where / "scheduler_config.json").write_text(json.dumps(configs[comp], indent=2))
            report[comp] = {"tensors": 0, "params": 0, "bytes": 0,
                            "s": time.perf_counter() - t0}
            continue
        state = states.get(comp)
        if state is None:
            state = synthetic_state(inventory(comp, configs[comp]), seed + SEED_OFFSETS[comp])
        (where / "config.json").write_text(json.dumps(configs[comp], indent=2))
        nbytes = safetensors_io.save_file(state, where / WEIGHT_FILES[comp])
        report[comp] = {"tensors": len(state), "params": sum(t.numel() for t in state.values()),
                        "bytes": nbytes, "s": time.perf_counter() - t0}
        log(f"{comp}: {len(state)} tensors, {report[comp]['params'] / 1e6:.1f}M params, "
            f"{nbytes} bytes in {report[comp]['s']:.2f} s")
        del state
    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir", type=Path)
    ap.add_argument("--taesd-out", type=Path, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    taesd_out = args.taesd_out or args.out_dir.parent / "taesd"
    t0 = time.time()
    write_checkpoint(args.out_dir, taesd_out, seed=args.seed)
    print(f"Wrote {args.out_dir} (+ {taesd_out}) in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
