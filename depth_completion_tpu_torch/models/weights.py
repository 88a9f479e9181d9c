"""Weights into the port's parameter trees: from the JAX package's trees, and
from and to HF-layout checkpoint directories.

``from_jax_params`` takes the JAX UNet, VAE (TAESD or KL) and, optionally,
text-encoder trees as nested dicts/lists of numpy arrays
(``jax.tree.map(np.asarray, tree)``) and returns the port's ``ModelBundle``:
conv kernels HWIO → OIHW, linear kernels ``[in, out]`` → ``[out, in]``,
everything else as is.

``load_unet``, ``load_vae``, ``load_taesd`` and ``load_text_encoder`` read
``*.safetensors`` files (``models.safetensors_io``) with the key rules of
the JAX package's converters (``depth_completion_tpu.models.weights``):
diffusers' ``downsamplers.0.conv``, ``to_out.0``, ``ff.net.*`` and
``transformer_blocks`` names, the old VAE attention names
``query``/``key``/``value``/``proj_attn``, TAESD's sequential layer
indices, and transformers' ``text_model.`` prefix. HF checkpoints are
already in PyTorch's layouts, so nothing is transposed: a ``[out, in, 1,
1]`` 1x1 conv used as a linear becomes ``[out, in]``, and that is all. The
``to_*_state`` exporters are the converse, and write what the loaders read.

Every tree goes through one template check: the port's own parameter
shapes, built on the ``meta`` device from the configs. A leaf the template
does not have, a template leaf the source lacks, or a shape that disagrees
raises. The one key skipped is ``text_model.embeddings.position_ids``, a
buffer that transformers checkpoints may carry.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

from depth_completion_tpu_torch.device import resolve_device
from depth_completion_tpu_torch.models import clip_text, safetensors_io
from depth_completion_tpu_torch.models.bundle import (
    VAE,
    ModelBundle,
    _Init,
    init_taesd,
    init_unet,
    init_vae,
)
from depth_completion_tpu_torch.models.registry import (
    CLIPTextConfig,
    TaesdConfig,
    UNetConfig,
    VAEConfig,
)


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


def _template(init_fn, config, dtype) -> Any:
    """The port's parameter tree for ``config``, shapes only."""
    return init_fn(_Init(0, dtype, torch.device("meta")), config)


def _convert(leaves: dict[tuple, Any], template: Any, what: str, dtype, device) -> Any:
    """The template's tree filled from ``leaves`` (path → numpy array or
    tensor, already in the port's layout), in ``dtype`` on ``device``."""
    consumed: set[tuple] = set()

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        if path not in leaves:
            raise KeyError(f"{what}: missing parameter {'/'.join(map(str, path))}")
        value = leaves[path]
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value, dtype=np.float32))
        if tuple(value.shape) != tuple(node.shape):
            raise ValueError(
                f"{what}: {'/'.join(map(str, path))} has shape {tuple(value.shape)} "
                f"(converted), expected {tuple(node.shape)}"
            )
        consumed.add(path)
        return value.to(device=device, dtype=dtype).contiguous()

    out = walk(template, ())
    extra = sorted("/".join(map(str, p)) for p in set(leaves) - consumed)
    if extra:
        raise KeyError(f"{what}: unconsumed parameters {extra}")
    return out


# ---------------------------------------------------------------------------
# From the JAX package's trees
# ---------------------------------------------------------------------------

def _to_torch_layout(path: tuple, arr: np.ndarray) -> np.ndarray:
    if path[-1] == "kernel":
        if arr.ndim == 4:  # HWIO → OIHW
            return arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:  # [in, out] → [out, in]
            return arr.T
    return arr


def _from_jax(tree: Any, template: Any, what: str, dtype, device) -> Any:
    leaves = {p: _to_torch_layout(p, np.asarray(a)) for p, a in _flatten(tree).items()}
    return _convert(leaves, template, what, dtype, device)


def text_encoder_from_jax(tree: Any, config: CLIPTextConfig, dtype=torch.float32,
                          device: str | torch.device | None = None) -> dict:
    """The port's text-encoder tree holding the JAX tree's weights."""
    return _from_jax(tree, _template(clip_text.init_text_encoder, config, dtype), "text encoder",
                     dtype, resolve_device(device))


def from_jax_params(
    unet_tree: Any,
    vae_tree: Any,
    text_context: Any = None,
    *,
    unet_config: UNetConfig,
    vae_config: TaesdConfig | VAEConfig,
    text_tree: Any = None,
    text_config: CLIPTextConfig | None = None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> ModelBundle:
    """Port bundle holding the same weights as the JAX trees; the VAE tree
    is read as a KL VAE for a ``VAEConfig`` and as TAESD otherwise. The
    context is ``text_context`` as given, or the port's own tower on
    ``text_tree`` (with ``text_config``) for the empty prompt."""
    if (text_context is None) == (text_tree is None):
        raise ValueError("give exactly one of text_context and text_tree")
    vae_kind, init_vae_fn = ("kl", init_vae) if isinstance(vae_config, VAEConfig) else (
        "tiny", init_taesd)
    dev = resolve_device(device)
    unet = _from_jax(unet_tree, _template(init_unet, unet_config, dtype), "unet", dtype, dev)
    vae = _from_jax(vae_tree, _template(init_vae_fn, vae_config, dtype), f"vae ({vae_kind})",
                    dtype, dev)
    if text_tree is None:
        ctx = torch.from_numpy(np.asarray(text_context, dtype=np.float32)).to(device=dev,
                                                                              dtype=dtype)
    else:
        if text_config is None:
            raise ValueError("text_tree needs its text_config")
        with torch.no_grad():
            ctx = clip_text.empty_prompt_context(
                text_encoder_from_jax(text_tree, text_config, dtype, dev), text_config)
    return ModelBundle(
        unet_params=unet,
        unet_config=unet_config,
        vae=VAE(kind=vae_kind, params=vae, config=vae_config),
        text_context=ctx,
    )


# ---------------------------------------------------------------------------
# HF-layout checkpoints → the port's trees
# ---------------------------------------------------------------------------

def _path(tokens) -> tuple:
    return tuple(int(t) if t.isdigit() else t for t in tokens)


def _hf_leaf(tokens: list[str], leaf: str, kind: str, value: torch.Tensor):
    """One HF tensor → (port path, tensor). ``kind``: "norm" (weight →
    scale), "conv" or "linear" (weight → kernel). The layouts already agree;
    a 1x1 conv used as a linear drops its unit axes."""
    if kind == "norm":
        leaf = "scale" if leaf == "weight" else leaf
    elif leaf == "weight":
        leaf = "kernel"
        if kind == "linear" and value.dim() == 4 and tuple(value.shape[2:]) == (1, 1):
            value = value[:, :, 0, 0]
    return _path(tokens) + (leaf,), value


def _convert_state(state: dict, translate, template: Any, what: str, dtype, device) -> Any:
    """``translate(key, value)`` → (path, tensor), or None for a key skipped."""
    leaves: dict[tuple, Any] = {}
    for key, value in state.items():
        out = translate(key, torch.as_tensor(value))
        if out is None:
            continue
        path, value = out
        if path in leaves:
            raise KeyError(f"{what}: {key} maps onto {'/'.join(map(str, path))} twice")
        leaves[path] = value
    return _convert(leaves, template, what, dtype, device)


def _split(key: str) -> tuple[str, str]:
    k, _, leaf = key.rpartition(".")
    return k, leaf


def _unet_leaf(key: str, value):
    k, leaf = _split(key)
    k = re.sub(r"downsamplers\.0\.conv", "downsampler", k)
    k = re.sub(r"upsamplers\.0\.conv", "upsampler", k)
    k = re.sub(r"to_out\.0", "to_out", k)
    k = re.sub(r"ff\.net\.0\.proj", "ff.proj_in", k)
    k = re.sub(r"ff\.net\.2", "ff.proj_out", k)
    k = re.sub(r"transformer_blocks", "blocks", k)
    tokens = k.split(".")
    name = tokens[-1]
    if name.startswith(("norm", "layer_norm")) or name in ("conv_norm_out", "group_norm"):
        kind = "norm"
    elif name in ("conv_in", "conv_out", "conv1", "conv2", "conv_shortcut", "downsampler",
                  "upsampler"):
        kind = "conv"
    else:  # time embedding, attention projections, ff, proj_in/out
        kind = "linear"
    return _hf_leaf(tokens, leaf, kind, value)


def _vae_leaf(key: str, value):
    k, leaf = _split(key)
    k = re.sub(r"downsamplers\.0\.conv", "downsampler", k)
    k = re.sub(r"upsamplers\.0\.conv", "upsampler", k)
    k = re.sub(r"to_out\.0", "to_out", k)
    # very old checkpoints name the VAE attention query/key/value/proj_attn
    k = re.sub(r"\.query$", ".to_q", k)
    k = re.sub(r"\.key$", ".to_k", k)
    k = re.sub(r"\.value$", ".to_v", k)
    k = re.sub(r"\.proj_attn$", ".to_out", k)
    tokens = k.split(".")
    name = tokens[-1]
    if name.startswith("norm") or name in ("conv_norm_out", "group_norm"):
        kind = "norm"
    elif name in ("to_q", "to_k", "to_v", "to_out"):
        kind = "linear"
    else:  # every other parametric module of the VAE is a conv
        kind = "conv"
    return _hf_leaf(tokens, leaf, kind, value)


def _taesd_layer_index_maps(encoder_blocks, decoder_blocks):
    """diffusers ``AutoencoderTiny`` sequential index → the port's path."""
    enc: dict[int, list] = {0: ["conv_in"]}
    idx = 1
    for i, n in enumerate(encoder_blocks):
        if i > 0:
            enc[idx] = ["stages", i, "down"]
            idx += 1
        for j in range(n):
            enc[idx] = ["stages", i, "blocks", j]
            idx += 1
    enc[idx] = ["conv_out"]

    dec: dict[int, list] = {0: ["conv_in"]}
    idx = 2  # index 1 is the activation (no parameters)
    for i, n in enumerate(decoder_blocks):
        for j in range(n):
            dec[idx] = ["stages", i, "blocks", j]
            idx += 1
        if i < len(decoder_blocks) - 1:
            idx += 1  # nn.Upsample (no parameters)
            dec[idx] = ["stages", i, "up_conv"]
            idx += 1
    dec[idx] = ["conv_out"]
    return enc, dec


_TAESD_BLOCK_CONVS = {"0": "conv1", "2": "conv2", "4": "conv3"}  # AutoencoderTinyBlock conv.{0,2,4}


def _taesd_leaf_fn(config: TaesdConfig):
    maps = dict(zip(("encoder", "decoder"),
                    _taesd_layer_index_maps(config.encoder_blocks, config.decoder_blocks)))

    def leaf_fn(key: str, value):
        parts = key.split(".")
        if len(parts) < 4 or parts[0] not in maps or parts[1] != "layers" \
                or not parts[2].isdigit() or int(parts[2]) not in maps[parts[0]]:
            raise KeyError(f"taesd: unknown key {key}")
        base = [parts[0]] + [str(p) for p in maps[parts[0]][int(parts[2])]]
        rest = parts[3:]
        if rest[0] == "conv" and len(rest) == 3 and rest[1] in _TAESD_BLOCK_CONVS:
            return _hf_leaf(base + [_TAESD_BLOCK_CONVS[rest[1]]], rest[2], "conv", value)
        if len(rest) != 1:
            raise KeyError(f"taesd: unknown key {key}")
        return _hf_leaf(base, rest[0], "conv", value)

    return leaf_fn


_TEXT_PREFIX = "text_model."
_TEXT_MODULES = {"q_proj": "self_attn", "k_proj": "self_attn", "v_proj": "self_attn",
                 "out_proj": "self_attn", "fc1": "mlp", "fc2": "mlp"}


def _text_leaf(key: str, value):
    if key == _TEXT_PREFIX + "embeddings.position_ids":
        return None  # a buffer, not a parameter
    if not key.startswith(_TEXT_PREFIX):
        raise KeyError(f"text encoder: unknown key {key}")
    k, leaf = _split(key[len(_TEXT_PREFIX):])
    if k in ("embeddings.token_embedding", "embeddings.position_embedding") and leaf == "weight":
        return (k.split(".")[1],), value
    if k == "final_layer_norm":
        return _hf_leaf([k], leaf, "norm", value)
    parts = k.split(".")
    if len(parts) >= 4 and parts[:2] == ["encoder", "layers"] and parts[2].isdigit():
        i, rest = parts[2], parts[3:]
        if rest in (["layer_norm1"], ["layer_norm2"]):
            return _hf_leaf(["layers", i, rest[0]], leaf, "norm", value)
        if len(rest) == 2 and _TEXT_MODULES.get(rest[1]) == rest[0]:
            return _hf_leaf(["layers", i, rest[1]], leaf, "linear", value)
    raise KeyError(f"text encoder: unknown key {key}")


def convert_unet_state(state: dict, config: UNetConfig, dtype=torch.bfloat16,
                       device: str | torch.device | None = None) -> dict:
    """A diffusers ``UNet2DConditionModel`` state dict → the port's tree."""
    return _convert_state(state, _unet_leaf, _template(init_unet, config, dtype), "unet", dtype,
                          resolve_device(device))


def convert_vae_state(state: dict, config: VAEConfig, dtype=torch.bfloat16,
                      device: str | torch.device | None = None) -> dict:
    """A diffusers ``AutoencoderKL`` state dict → the port's tree."""
    return _convert_state(state, _vae_leaf, _template(init_vae, config, dtype), "vae (kl)", dtype,
                          resolve_device(device))


def convert_taesd_state(state: dict, config: TaesdConfig, dtype=torch.bfloat16,
                        device: str | torch.device | None = None) -> dict:
    """A diffusers ``AutoencoderTiny`` state dict → the port's tree."""
    return _convert_state(state, _taesd_leaf_fn(config), _template(init_taesd, config, dtype),
                          "vae (tiny)", dtype, resolve_device(device))


def convert_text_encoder_state(state: dict, config: CLIPTextConfig, dtype=torch.bfloat16,
                               device: str | torch.device | None = None) -> dict:
    """A transformers ``CLIPTextModel`` state dict → the port's tree."""
    return _convert_state(state, _text_leaf, _template(clip_text.init_text_encoder, config, dtype),
                          "text encoder", dtype, resolve_device(device))


def load_unet(path, config: UNetConfig, dtype=torch.bfloat16, device=None) -> dict:
    return convert_unet_state(safetensors_io.load_dir(path), config, dtype, device)


def load_vae(path, config: VAEConfig, dtype=torch.bfloat16, device=None) -> dict:
    return convert_vae_state(safetensors_io.load_dir(path), config, dtype, device)


def load_taesd(path, config: TaesdConfig, dtype=torch.bfloat16, device=None) -> dict:
    return convert_taesd_state(safetensors_io.load_dir(path), config, dtype, device)


def load_text_encoder(path, config: CLIPTextConfig, dtype=torch.bfloat16, device=None) -> dict:
    return convert_text_encoder_state(safetensors_io.load_dir(path), config, dtype, device)


# ---------------------------------------------------------------------------
# The port's trees → HF-layout state dicts (the converse of the loaders)
# ---------------------------------------------------------------------------

_LEAF_NAMES = {"kernel": "weight", "scale": "weight"}


def _export(tree: Any, rename) -> dict[str, torch.Tensor]:
    """``rename(tokens)`` maps a module path (strings) to the HF one. A
    tensor at the top of the tree (an embedding) is a module's weight."""
    state = {}
    for path, t in _flatten(tree).items():
        tokens = [str(p) for p in path]
        module, leaf = (tokens, "weight") if len(tokens) == 1 else (tokens[:-1], tokens[-1])
        state[".".join(rename(module) + [_LEAF_NAMES.get(leaf, leaf)])] = t
    return state


def _diffusers_tokens(tokens: list[str]) -> list[str]:
    out = []
    for i, tok in enumerate(tokens):
        prev = tokens[i - 1] if i else ""
        if tok in ("downsampler", "upsampler"):
            out += [tok + "s", "0", "conv"]
        elif tok == "to_out":
            out += ["to_out", "0"]
        elif prev == "ff" and tok == "proj_in":
            out += ["net", "0", "proj"]
        elif prev == "ff" and tok == "proj_out":
            out += ["net", "2"]
        elif tok == "blocks" and i >= 2 and tokens[i - 2] == "attentions":
            out.append("transformer_blocks")
        else:
            out.append(tok)
    return out


def to_diffusers_unet_state(tree) -> dict[str, torch.Tensor]:
    """The port's UNet tree → diffusers ``UNet2DConditionModel`` state dict."""
    return _export(tree, _diffusers_tokens)


def to_diffusers_vae_state(tree) -> dict[str, torch.Tensor]:
    """The port's KL-VAE tree → diffusers ``AutoencoderKL`` state dict."""
    return _export(tree, _diffusers_tokens)


def to_diffusers_taesd_state(tree, config: TaesdConfig) -> dict[str, torch.Tensor]:
    """The port's TAESD tree → diffusers ``AutoencoderTiny`` state dict."""
    rev = {side: {tuple(str(p) for p in path): idx for idx, path in m.items()}
           for side, m in zip(("encoder", "decoder"),
                              _taesd_layer_index_maps(config.encoder_blocks,
                                                      config.decoder_blocks))}
    conv_pos = {name: pos for pos, name in _TAESD_BLOCK_CONVS.items()}

    def rename(tokens):
        side, rest = tokens[0], tokens[1:]
        if rest[-1] in conv_pos:  # a block's conv
            return [side, "layers", str(rev[side][tuple(rest[:-1])]), "conv", conv_pos[rest[-1]]]
        return [side, "layers", str(rev[side][tuple(rest)])]

    return _export(tree, rename)


def to_transformers_text_encoder_state(tree) -> dict[str, torch.Tensor]:
    """The port's text-encoder tree → transformers ``CLIPTextModel`` state
    dict (without the ``position_ids`` buffer)."""
    def rename(tokens):
        if tokens[0] in ("token_embedding", "position_embedding"):
            return ["text_model", "embeddings", tokens[0]]
        if tokens[0] == "layers":
            i, name = tokens[1], tokens[2]
            mod = [_TEXT_MODULES[name]] if name in _TEXT_MODULES else []
            return ["text_model", "encoder", "layers", i, *mod, name]
        return ["text_model", *tokens]

    return _export(tree, rename)

