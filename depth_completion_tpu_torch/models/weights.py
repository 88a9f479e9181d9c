"""Weight bridge from the JAX package's parameter trees.

``from_jax_params`` takes the JAX UNet and VAE (TAESD or KL) trees as nested
dicts/lists of numpy arrays (``jax.tree.map(np.asarray, tree)``) and returns the port's
``ModelBundle``: conv kernels HWIO → OIHW, linear kernels ``[in, out]`` →
``[out, in]``, everything else as is. The port's own parameter shapes
(built on the ``meta`` device from the configs) are the template: a JAX
leaf the template does not have, a template leaf the JAX tree lacks, or a
shape that disagrees raises. The HF-safetensors loader is a later slice.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from depth_completion_tpu_torch.device import resolve_device
from depth_completion_tpu_torch.models.bundle import (
    VAE,
    ModelBundle,
    _Init,
    init_taesd,
    init_unet,
    init_vae,
)
from depth_completion_tpu_torch.models.registry import TaesdConfig, UNetConfig, VAEConfig


def _flatten(tree: Any, prefix: tuple = ()) -> dict[tuple, Any]:
    if isinstance(tree, dict):
        out: dict[tuple, Any] = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (i,)))
        return out
    return {prefix: tree}


def _to_torch_layout(path: tuple, arr: np.ndarray) -> np.ndarray:
    if path[-1] == "kernel":
        if arr.ndim == 4:  # HWIO → OIHW
            return arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:  # [in, out] → [out, in]
            return arr.T
    return arr


def _convert(jax_tree: Any, template: Any, what: str, dtype, device) -> Any:
    leaves = _flatten(jax_tree)
    consumed: set[tuple] = set()

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        if path not in leaves:
            raise KeyError(f"{what}: missing parameter {'/'.join(map(str, path))}")
        arr = _to_torch_layout(path, np.asarray(leaves[path]))
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(
                f"{what}: {'/'.join(map(str, path))} has shape {arr.shape} "
                f"(converted), expected {tuple(node.shape)}"
            )
        consumed.add(path)
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=device, dtype=dtype
        )

    out = walk(template, ())
    extra = sorted("/".join(map(str, p)) for p in set(leaves) - consumed)
    if extra:
        raise KeyError(f"{what}: unconsumed parameters {extra}")
    return out


def from_jax_params(
    unet_tree: Any,
    vae_tree: Any,
    text_context: Any,
    *,
    unet_config: UNetConfig,
    vae_config: TaesdConfig | VAEConfig,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> ModelBundle:
    """Port bundle holding the same weights as the JAX trees; the VAE tree
    is read as a KL VAE for a ``VAEConfig`` and as TAESD otherwise."""
    vae_kind, init_vae_fn = ("kl", init_vae) if isinstance(vae_config, VAEConfig) else (
        "tiny", init_taesd)
    dev = resolve_device(device)
    meta = _Init(0, dtype, torch.device("meta"))
    unet = _convert(unet_tree, init_unet(meta, unet_config), "unet", dtype, dev)
    vae = _convert(vae_tree, init_vae_fn(meta, vae_config), f"vae ({vae_kind})", dtype, dev)
    ctx = torch.from_numpy(np.asarray(text_context, dtype=np.float32)).to(device=dev, dtype=dtype)
    return ModelBundle(
        unet_params=unet,
        unet_config=unet_config,
        vae=VAE(kind=vae_kind, params=vae, config=vae_config),
        text_context=ctx,
    )
