"""CLIP text encoder (the OpenCLIP-ViT/H tower of SD2/Marigold).

Counterpart of ``depth_completion_tpu.models.clip_text``. The reference
embeds only the empty prompt, once per pipeline (reference
marigold_dc.py:663-674); with ``padding="do_not_pad"`` that prompt is
[BOS, EOS], so the cached context is ``[1, 2, hidden]``.

A pre-LN transformer with a causal mask and a final LayerNorm; the context
is the last hidden state, not the pooled output. Logits and softmax are
fp32, the probabilities cast to the activation dtype for the value product
(fp32 accumulation), as in the JAX package. ``hidden_act="gelu"`` is the
*exact* GELU here (the UNet's GEGLU uses the tanh form, ``models/unet.py``);
``"quick_gelu"`` is x·σ(1.702x). Parameters are a nested dict with the JAX
package's keys, linear weights in PyTorch's ``[out, in]`` layout.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from depth_completion_tpu_torch.models.layers import layer_norm, linear
from depth_completion_tpu_torch.models.registry import CLIPTextConfig


def empty_prompt_ids(config: CLIPTextConfig) -> torch.Tensor:
    """Token ids of "" with do_not_pad: ``[[BOS, EOS]]`` (int64)."""
    return torch.tensor([[config.bos_token_id, config.eos_token_id]], dtype=torch.long)


def init_text_encoder(mk, config: CLIPTextConfig) -> dict:
    """Seeded tower parameters from the bundle's parameter factory ``mk``
    (``models.bundle._Init``): embeddings ~ N(0, 0.02²) and N(0, 0.01²),
    linears Kaiming-uniform, unit/zero norms, as the JAX initialiser."""
    cfg = config
    hid, inter = cfg.hidden_size, cfg.intermediate_size
    return {
        "token_embedding": mk.normal((cfg.vocab_size, hid), 0.02),
        "position_embedding": mk.normal((cfg.max_position_embeddings, hid), 0.01),
        "layers": [
            {
                "layer_norm1": mk.norm(hid),
                "q_proj": mk.linear(hid, hid),
                "k_proj": mk.linear(hid, hid),
                "v_proj": mk.linear(hid, hid),
                "out_proj": mk.linear(hid, hid),
                "layer_norm2": mk.norm(hid),
                "fc1": mk.linear(hid, inter),
                "fc2": mk.linear(inter, hid),
            }
            for _ in range(cfg.num_layers)
        ],
        "final_layer_norm": mk.norm(hid),
    }


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        return F.gelu(x)  # exact (erf)
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(f"unknown activation: {kind}")


def apply_text_encoder(params, input_ids: torch.Tensor, config: CLIPTextConfig) -> torch.Tensor:
    """``[N, S]`` token ids → ``[N, S, hidden]`` last hidden state."""
    cfg = config
    n, s = input_ids.shape
    nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    h = params["token_embedding"][input_ids] + params["position_embedding"][None, :s]
    mask = torch.full((s, s), float("-inf"), device=h.device).triu(1)
    scale = 1.0 / math.sqrt(hd)
    for layer in params["layers"]:
        x = layer_norm(layer["layer_norm1"], h, eps=cfg.layer_norm_eps)
        q, k, v = (linear(layer[name], x).reshape(n, s, nh, hd).float()
                   for name in ("q_proj", "k_proj", "v_proj"))
        logits = torch.einsum("nqhd,nkhd->nhqk", q, k) * scale
        probs = torch.softmax(logits + mask, dim=-1).to(h.dtype)
        attn = torch.einsum("nhqk,nkhd->nqhd", probs.float(), v).to(h.dtype)
        h = h + linear(layer["out_proj"], attn.reshape(n, s, cfg.hidden_size))
        x = layer_norm(layer["layer_norm2"], h, eps=cfg.layer_norm_eps)
        h = h + linear(layer["fc2"], _act(linear(layer["fc1"], x), cfg.hidden_act))
    return layer_norm(params["final_layer_norm"], h, eps=cfg.layer_norm_eps)


def empty_prompt_context(params, config: CLIPTextConfig) -> torch.Tensor:
    """The cached ``[1, 2, hidden]`` context: the tower on the empty prompt.
    The ids are clamped into the vocabulary, as JAX's gather clamps an index
    out of range; only the tiny test vocabularies need it."""
    ids = empty_prompt_ids(config).clamp(max=config.vocab_size - 1)
    return apply_text_encoder(params, ids.to(params["token_embedding"].device), config)
