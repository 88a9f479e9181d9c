"""Random weights from the run's seed, made on the device in a few large
calls, in the type they are served in.

A configuration's parameter trees (UNet, VAE, text tower) are nested dicts
with the port's keys and PyTorch layouts (conv kernels OIHW, linear
kernels ``[out, in]``). Each component's leaves are views of one flat
buffer: one ``torch.rand`` (or ``torch.randn`` for the embeddings) over the
whole buffer with a ``torch.Generator`` on the device, then each uniform
leaf scaled in place to ``±1/√fan_in`` (Kaiming-uniform, weights and
biases alike), norm scales set to 1 and their biases to 0 (TAESD's output
conv apart: ``taesd_spec``). The same seed
gives the same tensors, so the reference regenerates them after the
system under test has been freed instead of sharing its tensors.
"""

from __future__ import annotations

import math

import torch

ALIGN = 64  # elements between leaf offsets (128 bytes in bf16)
COMPONENTS = ("unet", "vae", "text_encoder")


def _conv(k, cin, cout, bias=True):
    p = {"kernel": ("u", (cout, cin, k, k), k * k * cin)}
    if bias:
        p["bias"] = ("u", (cout,), k * k * cin)
    return p


def _linear(cin, cout, bias=True):
    p = {"kernel": ("u", (cout, cin), cin)}
    if bias:
        p["bias"] = ("u", (cout,), cin)
    return p


def _norm(c):
    return {"scale": ("one", (c,)), "bias": ("zero", (c,))}


def _unet_resnet(cin, cout, temb):
    p = {"norm1": _norm(cin), "conv1": _conv(3, cin, cout), "time_emb_proj": _linear(temb, cout),
         "norm2": _norm(cout), "conv2": _conv(3, cout, cout)}
    if cin != cout:
        p["conv_shortcut"] = _conv(1, cin, cout)
    return p


def _transformer(c, cfg):
    def attn(kv):
        return {"to_q": _linear(c, c, False), "to_k": _linear(kv, c, False),
                "to_v": _linear(kv, c, False), "to_out": _linear(c, c)}

    return {"norm": _norm(c), "proj_in": _linear(c, c),
            "blocks": [{"norm1": _norm(c), "attn1": attn(c), "norm2": _norm(c),
                        "attn2": attn(cfg["cross_attention_dim"]), "norm3": _norm(c),
                        "ff": {"proj_in": _linear(c, c * 8), "proj_out": _linear(c * 4, c)}}
                       for _ in range(cfg["transformer_layers"])],
            "proj_out": _linear(c, c)}


def unet_spec(cfg: dict) -> dict:
    chans = cfg["block_out_channels"]
    temb = chans[0] * cfg["time_embed_dim_mult"]
    spec = {"conv_in": _conv(3, cfg["in_channels"], chans[0]),
            "time_embedding": {"linear_1": _linear(chans[0], temb),
                               "linear_2": _linear(temb, temb)}}
    down, skips, cin = [], [chans[0]], chans[0]
    for i, cout in enumerate(chans):
        stage = {"resnets": [], "attentions": []}
        for _ in range(cfg["layers_per_block"]):
            stage["resnets"].append(_unet_resnet(cin, cout, temb))
            cin = cout
            if cfg["attention_stages"][i]:
                stage["attentions"].append(_transformer(cout, cfg))
            skips.append(cout)
        if i < len(chans) - 1:
            stage["downsampler"] = _conv(3, cout, cout)
            skips.append(cout)
        down.append(stage)
    spec["down_blocks"] = down
    mid = chans[-1]
    spec["mid_block"] = {"resnets": [_unet_resnet(mid, mid, temb), _unet_resnet(mid, mid, temb)],
                         "attentions": [_transformer(mid, cfg)]}
    up, cin = [], mid
    for i in range(len(chans)):
        idx = len(chans) - 1 - i
        cout = chans[idx]
        stage = {"resnets": [], "attentions": []}
        for _ in range(cfg["layers_per_block"] + 1):
            stage["resnets"].append(_unet_resnet(cin + skips.pop(), cout, temb))
            cin = cout
            if cfg["attention_stages"][idx]:
                stage["attentions"].append(_transformer(cout, cfg))
        if i < len(chans) - 1:
            stage["upsampler"] = _conv(3, cout, cout)
        up.append(stage)
    spec["up_blocks"] = up
    spec["conv_norm_out"] = _norm(chans[0])
    spec["conv_out"] = _conv(3, chans[0], cfg["out_channels"])
    return spec


def taesd_spec(cfg: dict) -> dict:
    c = cfg["channels"]

    def block():
        return {"conv1": _conv(3, c, c), "conv2": _conv(3, c, c), "conv3": _conv(3, c, c)}

    enc = {"conv_in": _conv(3, 3, c), "stages": []}
    for i, n in enumerate(cfg["encoder_blocks"]):
        stage = {"blocks": [block() for _ in range(n)]}
        if i > 0:
            stage["down"] = _conv(3, c, c, bias=False)
        enc["stages"].append(stage)
    enc["conv_out"] = _conv(3, c, cfg["latent_channels"])
    dec = {"conv_in": _conv(3, cfg["latent_channels"], c), "stages": []}
    for i, n in enumerate(cfg["decoder_blocks"]):
        stage = {"blocks": [block() for _ in range(n)]}
        if i < len(cfg["decoder_blocks"]) - 1:
            stage["up_conv"] = _conv(3, c, c, bias=False)
        dec["stages"].append(stage)
    # the RGB output spans its range as a trained decoder's does: bias 0.5
    # and weights ±16/√fan_in put the depth head (the clamped channel mean)
    # at 0.5 with a spread of 0.06-0.07 over a frame and a gradient of
    # 0.6-0.8 a pixel, the KL head's order (0.5, 0.09, 0.4). With the plain
    # ±1/√fan_in draw it sits at 0.00-0.03 with a spread of 0.005, clamps to
    # 0 over most of the frame, and the guidance cannot move it
    dec["conv_out"] = {"kernel": ("u", (3, c, 3, 3), 9 * c / 256), "bias": ("const", (3,), 0.5)}
    return {"encoder": enc, "decoder": dec}


def _kl_resnet(cin, cout):
    p = {"norm1": _norm(cin), "conv1": _conv(3, cin, cout), "norm2": _norm(cout),
         "conv2": _conv(3, cout, cout)}
    if cin != cout:
        p["conv_shortcut"] = _conv(1, cin, cout)
    return p


def _kl_mid(c):
    return {"resnets": [_kl_resnet(c, c), _kl_resnet(c, c)],
            "attentions": [{"group_norm": _norm(c), "to_q": _linear(c, c), "to_k": _linear(c, c),
                            "to_v": _linear(c, c), "to_out": _linear(c, c)}]}


def kl_spec(cfg: dict) -> dict:
    chans, lc = cfg["block_out_channels"], cfg["latent_channels"]
    enc = {"conv_in": _conv(3, cfg["in_channels"], chans[0]), "down_blocks": []}
    cin = chans[0]
    for i, cout in enumerate(chans):
        stage = {"resnets": []}
        for _ in range(cfg["layers_per_block"]):
            stage["resnets"].append(_kl_resnet(cin, cout))
            cin = cout
        if i < len(chans) - 1:
            stage["downsampler"] = _conv(3, cout, cout)
        enc["down_blocks"].append(stage)
    enc["mid_block"] = _kl_mid(chans[-1])
    enc["conv_norm_out"] = _norm(chans[-1])
    enc["conv_out"] = _conv(3, chans[-1], 2 * lc)
    dec = {"conv_in": _conv(3, lc, chans[-1]), "mid_block": _kl_mid(chans[-1])}
    up, cin = [], chans[-1]
    for i in range(len(chans)):
        cout = chans[len(chans) - 1 - i]
        stage = {"resnets": []}
        for _ in range(cfg["layers_per_block"] + 1):
            stage["resnets"].append(_kl_resnet(cin, cout))
            cin = cout
        if i < len(chans) - 1:
            stage["upsampler"] = _conv(3, cout, cout)
        up.append(stage)
    dec["up_blocks"] = up
    dec["conv_norm_out"] = _norm(chans[0])
    dec["conv_out"] = _conv(3, chans[0], cfg["in_channels"])
    return {"encoder": enc, "decoder": dec, "quant_conv": _conv(1, 2 * lc, 2 * lc),
            "post_quant_conv": _conv(1, lc, lc)}


def text_spec(cfg: dict) -> dict:
    hid, inter = cfg["hidden_size"], cfg["intermediate_size"]
    return {"token_embedding": ("n", (cfg["vocab_size"], hid), 0.02),
            "position_embedding": ("n", (cfg["max_position_embeddings"], hid), 0.01),
            "layers": [{"layer_norm1": _norm(hid), "q_proj": _linear(hid, hid),
                        "k_proj": _linear(hid, hid), "v_proj": _linear(hid, hid),
                        "out_proj": _linear(hid, hid), "layer_norm2": _norm(hid),
                        "fc1": _linear(hid, inter), "fc2": _linear(inter, hid)}
                       for _ in range(cfg["num_layers"])],
            "final_layer_norm": _norm(hid)}


def spec(config: dict) -> dict:
    """The configuration's three trees of leaf specs."""
    vae = kl_spec if config["vae_kind"] == "kl" else taesd_spec
    return {"unet": unet_spec(config["unet"]), "vae": vae(config["vae"]),
            "text_encoder": text_spec(config["text"])}


def _leaves(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def _component(tree, seed: int, dtype: torch.dtype, device: torch.device):
    leaves = _leaves(tree, [])
    offsets, total = [], 0
    for leaf in leaves:
        offsets.append(total)
        total += -(-math.prod(leaf[1]) // ALIGN) * ALIGN
    if device.type == "meta":
        flat = torch.empty(total, dtype=dtype, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        normal = any(leaf[0] == "n" for leaf in leaves)
        draw = torch.randn if normal else torch.rand
        flat = draw(total, generator=gen, dtype=torch.float32, device=device).to(dtype)
    views = {}
    for leaf, off in zip(leaves, offsets):
        n = math.prod(leaf[1])
        v = flat[off:off + n]
        if device.type != "meta":
            if leaf[0] == "u":
                bound = 1.0 / math.sqrt(leaf[2])
                if normal:  # a normal draw: map it to a uniform one through Φ
                    v.copy_(torch.special.ndtr(v.float()).to(dtype))
                v.mul_(2 * bound).sub_(bound)
            elif leaf[0] == "n":
                v.mul_(leaf[2])
            elif leaf[0] == "const":
                v.fill_(leaf[2])
            else:
                v.fill_(1.0 if leaf[0] == "one" else 0.0)
        views[id(leaf)] = v.view(leaf[1])
    return flat, views


def _build(tree, views):
    if isinstance(tree, dict):
        return {k: _build(v, views) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_build(v, views) for v in tree]
    return views[id(tree)]


def make(config: dict, seed: int, device: torch.device, dtype: torch.dtype) -> dict:
    """{"unet", "vae", "text_encoder"} parameter trees from ``seed``."""
    trees = spec(config)
    out = {}
    for i, name in enumerate(COMPONENTS):
        _, views = _component(trees[name], (int(seed) * 1_000_003 + i) % 2**62, dtype,
                              torch.device(device))
        out[name] = _build(trees[name], views)
    return out


def config_dtype(config: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[config["dtype"]]
