"""HF-layout checkpoints in the port: the safetensors reader and writer
(``models/safetensors_io.py``), the converters and exporters
(``models/weights.py``), the config readers (``models/registry.py``) and
``load_bundle`` (``models/bundle.py``), against the JAX package and the
``safetensors`` and ``transformers`` packages (test dependencies only: the
port imports neither).

Geometry is tiny (UNet, KL VAE, text tower) except TAESD, whose full
geometry is ~2.4M parameters. Weights come from ``jax.eval_shape`` of the
JAX initialisers filled by a seeded numpy generator (no JAX init compile).
"""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from safetensors.numpy import load_file as st_load_numpy
from safetensors.numpy import save_file as st_save_numpy
from safetensors.torch import load_file as st_load_torch
from safetensors.torch import save_file as st_save_torch

from depth_completion_tpu.models import clip_text as jclip
from depth_completion_tpu.models import registry as jreg
from depth_completion_tpu.models import weights as jweights
from depth_completion_tpu.models.bundle import load_bundle as j_load_bundle
from depth_completion_tpu.models.unet import init_unet as j_init_unet
from depth_completion_tpu.models.vae_kl import init_vae as j_init_kl
from depth_completion_tpu.models.vae_tiny import init_taesd as j_init_taesd
from depth_completion_tpu.pipeline import sampler as JS
from depth_completion_tpu_torch.models import clip_text, registry, safetensors_io, weights
from depth_completion_tpu_torch.models.bundle import load_bundle, make_random_bundle
from depth_completion_tpu_torch.models.bundle import make_random_params
from depth_completion_tpu_torch.models.weights import _flatten
from depth_completion_tpu_torch.pipeline import sampler as TS
from depth_completion_tpu_torch.pipeline.programs import ProgramCache

from scripts.make_synthetic_checkpoint import (
    SCHEDULER_CONFIG_JSON,
    UNET_CONFIG_JSON,
    VAE_CONFIG_JSON,
)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small CPU shapes: two threads, restored after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_tree(init, seed):
    """A JAX parameter tree (structure from ``init``'s ``eval_shape``),
    filled from a seeded numpy generator: kernels at the init scale, norms
    near unit scale, embeddings and biases small normals."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", None)
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            return rng.uniform(-bound, bound, size=leaf.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        if name in ("token_embedding", "position_embedding"):
            return (0.02 * rng.normal(size=leaf.shape)).astype(np.float32)
        return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: init(k), jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _unet_key(key):
    """The JAX exporter renames every "blocks." of an attention key, so its
    stage prefixes read "down_transformer_blocks" / "up_transformer_blocks"
    where diffusers (and the port's exporter) write "down_blocks" /
    "up_blocks". Both converters read either."""
    return key.replace("down_transformer_blocks.", "down_blocks.").replace(
        "up_transformer_blocks.", "up_blocks.")


TAESD = registry.TAESD_CONFIG
FAMILIES = {
    # family: (JAX init, JAX exporter, port loader, port exporter, port config, JAX key → HF key)
    "unet": (lambda k: j_init_unet(k, jreg.TINY_UNET_CONFIG, jnp.float32),
             jweights.to_diffusers_unet_state, weights.load_unet,
             weights.to_diffusers_unet_state, registry.TINY_UNET_CONFIG, _unet_key),
    "kl": (lambda k: j_init_kl(k, jreg.TINY_VAE_CONFIG, jnp.float32),
           jweights.to_diffusers_vae_state, weights.load_vae,
           weights.to_diffusers_vae_state, registry.TINY_VAE_CONFIG, str),
    "taesd": (lambda k: j_init_taesd(k, jreg.TAESD_CONFIG, jnp.float32),
              lambda t: jweights.to_diffusers_taesd_state(t, TAESD.encoder_blocks,
                                                           TAESD.decoder_blocks),
              weights.load_taesd, lambda t: weights.to_diffusers_taesd_state(t, TAESD), TAESD, str),
    "text": (lambda k: jclip.init_text_encoder(k, jreg.TINY_TEXT_CONFIG, jnp.float32),
             jweights.to_transformers_text_encoder_state, weights.load_text_encoder,
             weights.to_transformers_text_encoder_state, registry.TINY_TEXT_CONFIG, str),
}


def _from_jax(family, tree):
    """The port's tree for a JAX tree through ``from_jax_params`` (the text
    tower through ``text_encoder_from_jax``, which it calls)."""
    if family == "text":
        return weights.text_encoder_from_jax(tree, registry.TINY_TEXT_CONFIG, device="cpu")
    unet = _jax_tree(FAMILIES["unet"][0], 0) if family != "unet" else tree
    vae = tree if family in ("kl", "taesd") else _jax_tree(FAMILIES["taesd"][0], 0)
    vae_config = {"kl": registry.TINY_VAE_CONFIG}.get(family, TAESD)
    bundle = weights.from_jax_params(unet, vae, np.zeros((1, 2, 32), np.float32),
                                     unet_config=registry.TINY_UNET_CONFIG,
                                     vae_config=vae_config, device="cpu")
    return bundle.unet_params if family == "unet" else bundle.vae.params


def _assert_trees_equal(got, ref):
    g, r = _flatten(got), _flatten(ref)
    assert set(g) == set(r)
    for path in r:
        assert g[path].dtype == r[path].dtype, path
        assert torch.equal(g[path], r[path]), "/".join(map(str, path))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_loads_bit_exact_and_exports_back(family, tmp_path):
    """JAX tree → JAX exporter → a file written by ``safetensors`` → the
    port's loader: every leaf equal, bit for bit, to the same tree through
    ``from_jax_params``. Then the port's exporter and writer: a file that
    ``safetensors`` reads back to the JAX exporter's state (same keys, same
    values)."""
    jinit, jexport, load, export, config, hf_key = FAMILIES[family]
    tree = _jax_tree(jinit, 1)
    # contiguous: safetensors' numpy writer stores a transposed view's
    # buffer in memory order, not its logical order
    jstate = {k: np.ascontiguousarray(v, np.float32) for k, v in jexport(tree).items()}
    st_save_numpy(jstate, str(tmp_path / "model.safetensors"))
    got = load(tmp_path, config, torch.float32, "cpu")
    _assert_trees_equal(got, _from_jax(family, tree))

    written = safetensors_io.save_file(export(got), tmp_path / "port.safetensors")
    assert written == (tmp_path / "port.safetensors").stat().st_size
    back = st_load_numpy(str(tmp_path / "port.safetensors"))
    ref = {hf_key(k): v for k, v in jstate.items()}
    assert set(back) == set(ref)
    for k, v in ref.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def _sample_state(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = {"a.weight": (3, 5), "b.bias": (7,), "c.kernel": (2, 3, 4, 1), "d.scalar": (),
              "e.empty": (0, 4)}
    return {k: torch.randn(s, generator=g).to(dtype) for k, s in shapes.items()}


@pytest.mark.parametrize("name,dtype", [("F32", torch.float32), ("F16", torch.float16),
                                        ("BF16", torch.bfloat16)])
def test_reader_and_writer_match_safetensors(name, dtype, tmp_path):
    """The port's reader on files that ``safetensors`` wrote (F32 and F16 by
    its numpy writer, BF16 by its torch writer), and ``safetensors`` on the
    files the port's writer wrote: the same tensors, bit for bit, in the
    same dtype; ``__metadata__`` is skipped."""
    state = _sample_state(dtype)
    theirs = tmp_path / "theirs.safetensors"
    if dtype == torch.bfloat16:
        st_save_torch(state, str(theirs), metadata={"format": "pt"})
    else:
        st_save_numpy({k: v.numpy() for k, v in state.items()}, str(theirs),
                      metadata={"format": "np"})
    got = safetensors_io.load_file(theirs)
    assert set(got) == set(state)
    for k, v in state.items():
        assert got[k].dtype == dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
        assert json.loads(theirs.read_bytes()[8:8 + int.from_bytes(
            theirs.read_bytes()[:8], "little")])[k]["dtype"] == name
    ours = tmp_path / "ours.safetensors"
    safetensors_io.save_file(state, ours)
    back = st_load_torch(str(ours))
    assert set(back) == set(state)
    for k, v in state.items():
        assert back[k].dtype == dtype and torch.equal(back[k], v), k


def _write_raw(path, header: dict, data: bytes):
    blob = json.dumps(header).encode()
    path.write_bytes(len(blob).to_bytes(8, "little") + blob + data)


@pytest.mark.parametrize("fault", ["dtype", "overrun", "size", "header"])
def test_reader_raises_on_bad_files(fault, tmp_path):
    """A dtype outside the reader's table, a buffer past the end of the
    file, a buffer whose size disagrees with its shape, and a header longer
    than the file all raise ``ValueError``."""
    path = tmp_path / "bad.safetensors"
    if fault == "dtype":
        st_save_numpy({"x": np.arange(6, dtype=np.int8)}, str(path))
        match = "dtype I8"
    elif fault == "overrun":
        _write_raw(path, {"x": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}, b"\0" * 8)
        match = "spans bytes"
    elif fault == "size":
        _write_raw(path, {"x": {"dtype": "F32", "shape": [3], "data_offsets": [0, 16]}}, b"\0" * 16)
        match = "needs 12"
    else:
        path.write_bytes((10**6).to_bytes(8, "little") + b"{}")
        match = "overruns the file"
    with pytest.raises(ValueError, match=match):
        safetensors_io.load_file(path)


def _text_state():
    return {k: torch.from_numpy(np.asarray(v)) for k, v in
            jweights.to_transformers_text_encoder_state(
                _jax_tree(FAMILIES["text"][0], 2)).items()}


@pytest.mark.parametrize("fault", ["missing", "extra", "unknown", "shape"])
def test_converter_raises_on_mismatch(fault):
    """A missing key, a key the template does not have, a key no rule knows
    and a wrong shape (a conv kernel left in the JAX layout) each raise."""
    if fault == "shape":
        state = {k: torch.from_numpy(np.asarray(v)) for k, v in
                 jweights.to_diffusers_vae_state(_jax_tree(FAMILIES["kl"][0], 2)).items()}
        state["decoder.conv_out.weight"] = state["decoder.conv_out.weight"].permute(2, 3, 1, 0)
        with pytest.raises(ValueError, match="conv_out/kernel has shape"):
            weights.convert_vae_state(state, registry.TINY_VAE_CONFIG, torch.float32, "cpu")
        return
    state = _text_state()
    if fault == "missing":
        del state["text_model.encoder.layers.1.mlp.fc2.bias"]
        match = "missing parameter layers/1/fc2/bias"
    elif fault == "extra":
        state["text_model.encoder.layers.0.layer_norm1.running_mean"] = torch.zeros(32)
        match = "unconsumed parameters"
    else:
        state["lm_head.weight"] = torch.zeros(4, 32)
        match = "unknown key lm_head.weight"
    with pytest.raises(KeyError, match=match):
        weights.convert_text_encoder_state(state, registry.TINY_TEXT_CONFIG, torch.float32, "cpu")
    unet = {k: torch.from_numpy(np.asarray(v)) for k, v in
            jweights.to_diffusers_unet_state(_jax_tree(FAMILIES["unet"][0], 2)).items()}
    unet["conv_in.stray"] = torch.zeros(3)
    with pytest.raises(KeyError, match="unconsumed parameters"):
        weights.convert_unet_state(unet, registry.TINY_UNET_CONFIG, torch.float32, "cpu")


def test_real_transformers_text_model_loads_and_agrees():
    """A real tiny ``transformers.CLIPTextModel`` (exact GELU), its
    ``position_ids`` buffer included: its state dict converts, and the
    port's tower gives its last hidden state on the empty prompt (ids
    clamped into the tiny vocabulary) to rel 1e-5."""
    transformers = pytest.importorskip("transformers")
    cfg = registry.TINY_TEXT_CONFIG
    hf_cfg = transformers.CLIPTextConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_position_embeddings, hidden_act="gelu",
        layer_norm_eps=cfg.layer_norm_eps, bos_token_id=cfg.bos_token_id,
        eos_token_id=cfg.eos_token_id)
    torch.manual_seed(0)
    model = transformers.CLIPTextModel(hf_cfg).eval()
    state = dict(model.state_dict())
    state.setdefault("text_model.embeddings.position_ids",
                     torch.arange(cfg.max_position_embeddings)[None])
    params = weights.convert_text_encoder_state(state, cfg, torch.float32, "cpu")
    ids = clip_text.empty_prompt_ids(cfg).clamp(max=cfg.vocab_size - 1)
    with torch.no_grad():
        ref = model(input_ids=ids).last_hidden_state
        got = clip_text.empty_prompt_context(params, cfg)
    assert got.shape == ref.shape == (1, 2, cfg.hidden_size)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


def test_synthetic_text_tower_inventory_matches_transformers():
    """``scripts/make_synthetic_checkpoint_torch.py``'s text tower (the JAX
    script takes it from ``transformers`` itself): at SD2 geometry its keys
    and shapes are those of a ``transformers.CLIPTextModel`` built on the
    meta device, without its ``position_ids`` buffer."""
    transformers = pytest.importorskip("transformers")
    from scripts import make_synthetic_checkpoint_torch as synth

    cfg = registry.text_config_from_transformers(synth.TEXT_ENCODER_CONFIG_JSON)
    assert cfg == registry.SD2_TEXT_CONFIG
    hf_cfg = transformers.CLIPTextConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_position_embeddings, hidden_act=cfg.hidden_act)
    with torch.device("meta"):
        model = transformers.CLIPTextModel(hf_cfg)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.endswith("position_ids")}
    assert synth.inventory("text_encoder", synth.TEXT_ENCODER_CONFIG_JSON) == want


SD2_TEXT_CONFIG_JSON = {  # transformers' CLIPTextConfig of SD2's OpenCLIP-ViT/H tower
    "architectures": ["CLIPTextModel"], "hidden_act": "gelu", "hidden_size": 1024,
    "intermediate_size": 4096, "layer_norm_eps": 1e-05, "max_position_embeddings": 77,
    "num_attention_heads": 16, "num_hidden_layers": 23, "projection_dim": 512,
    "vocab_size": 49408, "bos_token_id": 0, "eos_token_id": 2, "torch_dtype": "float32",
}
READER_CASES = [
    ("unet_config_from_diffusers", UNET_CONFIG_JSON),
    ("unet_config_from_diffusers", {"block_out_channels": [32, 64], "attention_head_dim": 8,
                                    "transformer_layers_per_block": [1, 2]}),
    ("vae_config_from_diffusers", VAE_CONFIG_JSON),
    ("vae_config_from_diffusers", {"block_out_channels": [16, 32], "norm_num_groups": 8}),
    ("ddim_config_from_diffusers", SCHEDULER_CONFIG_JSON),
    ("ddim_config_from_diffusers", {"beta_schedule": "squaredcos_cap_v2", "clip_sample": True,
                                    "prediction_type": "epsilon"}),
    ("ddim_config_from_diffusers", {}),
    ("text_config_from_transformers", SD2_TEXT_CONFIG_JSON),
    ("text_config_from_transformers", {"hidden_act": "quick_gelu", "hidden_size": 32}),
]


@pytest.mark.parametrize("reader,cfg", READER_CASES,
                         ids=[f"{r}-{i}" for i, (r, _) in enumerate(READER_CASES)])
def test_config_readers_match_jax(reader, cfg):
    """Each reader against the JAX package's on the same JSON, field by
    field."""
    got = getattr(registry, reader)(json.loads(json.dumps(cfg)))
    ref = getattr(jreg, reader)(json.loads(json.dumps(cfg)))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def _write_tiny_kl_checkpoint(root):
    """A tiny ``vae_kind="kl"`` directory written by the JAX package's
    exporters and ``safetensors`` (fp16, as real checkpoints ship), with
    config JSONs (tests/test_weights.py's drill)."""
    ucfg, vcfg, tcfg = jreg.TINY_UNET_CONFIG, jreg.TINY_VAE_CONFIG, jreg.TINY_TEXT_CONFIG
    parts = {
        "unet": (jweights.to_diffusers_unet_state(_jax_tree(FAMILIES["unet"][0], 10)),
                 "diffusion_pytorch_model.safetensors", {
                     "block_out_channels": list(ucfg.block_out_channels),
                     "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
                     "attention_head_dim": list(ucfg.num_heads),
                     "in_channels": ucfg.in_channels, "out_channels": ucfg.out_channels,
                     "layers_per_block": ucfg.layers_per_block,
                     "cross_attention_dim": ucfg.cross_attention_dim,
                     "norm_num_groups": ucfg.norm_groups}),
        "vae": (jweights.to_diffusers_vae_state(_jax_tree(FAMILIES["kl"][0], 11)),
                "diffusion_pytorch_model.safetensors", {
                    "block_out_channels": list(vcfg.block_out_channels),
                    "layers_per_block": vcfg.layers_per_block,
                    "norm_num_groups": vcfg.norm_groups,
                    "latent_channels": vcfg.latent_channels}),
        "text_encoder": (jweights.to_transformers_text_encoder_state(
            _jax_tree(FAMILIES["text"][0], 12)), "model.safetensors", {
                "vocab_size": tcfg.vocab_size, "hidden_size": tcfg.hidden_size,
                "num_hidden_layers": tcfg.num_layers, "num_attention_heads": tcfg.num_heads,
                "intermediate_size": tcfg.intermediate_size}),
    }
    for sub, (state, fname, cfg) in parts.items():
        (root / sub).mkdir(parents=True)
        st_save_numpy({k: np.asarray(v, np.float16) for k, v in state.items()},
                      str(root / sub / fname))
        (root / sub / "config.json").write_text(json.dumps(cfg))
    (root / "scheduler").mkdir()
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(SCHEDULER_CONFIG_JSON))


def test_load_bundle_matches_jax_end_to_end(tmp_path, monkeypatch):
    """One tiny KL checkpoint directory read by JAX's ``load_bundle`` and the
    port's: equal configs and schedule, contexts (each side's own tower)
    within 1e-5, and a 2-step guided request (learned affine) through both
    samplers on the same inputs and noise within the KL bounds of
    tests/test_torch_sampler.py (the tolerance model of
    tests/test_pipeline_parity.py:36-49; the fused epilogue on both sides)."""
    monkeypatch.setenv("DCT_EPILOGUE", "on")
    _write_tiny_kl_checkpoint(tmp_path)
    jb = j_load_bundle(tmp_path, vae_kind="kl", dtype=jnp.float32)
    tb = load_bundle(tmp_path, vae_kind="kl", dtype=torch.float32, device="cpu")
    assert dataclasses.asdict(tb.unet_config) == dataclasses.asdict(jb.unet_config)
    assert dataclasses.asdict(tb.vae.config) == dataclasses.asdict(jb.vae.config)
    assert dataclasses.asdict(tb.ddim_config) == dataclasses.asdict(jb.ddim_config)
    ctx_j = np.asarray(jb.text_context)
    assert tb.text_context.shape == ctx_j.shape == (1, 2, 32)
    np.testing.assert_allclose(tb.text_context.numpy(), ctx_j, rtol=0, atol=1e-5)

    rng = np.random.default_rng(7)
    n, h, w = 1, 50, 80
    imgs = rng.uniform(0, 255, size=(n, h, w, 3)).astype(np.float32)
    sparses = np.zeros((n, h * w), np.float32)
    idx = rng.choice(h * w, size=64, replace=False)
    sparses[0, idx] = rng.uniform(0.5, 9.5, size=64)
    sparses = sparses.reshape(n, h, w, 1)
    noise = rng.standard_normal((n, 24, 32, 4)).astype(np.float32)
    kw = dict(steps=2, resolution=64, closed_form=False, max_depth=10.0)
    d_j, l_j = jax.jit(JS.guided_sample, static_argnames=("cfg",))(
        jb, jnp.asarray(imgs), jnp.asarray(sparses),
        JS.SamplerConfig(**kw, ddim=jb.ddim_config), init_noise=jnp.asarray(noise))
    d_t, l_t = TS.guided_sample(tb, torch.from_numpy(imgs), torch.from_numpy(sparses),
                                TS.SamplerConfig(**kw, ddim=tb.ddim_config),
                                init_noise=torch.from_numpy(noise), programs=ProgramCache())
    dd, ll = d_t.numpy() - np.asarray(d_j), l_t.numpy() - np.asarray(l_j)
    rms = [float(np.sqrt(np.mean(x ** 2))) for x in (dd, ll)]
    assert rms[0] < 1e-4 and np.abs(dd).max() < 1e-3 and rms[1] < 1e-4, (rms, np.abs(dd).max())


def test_port_checkpoint_roundtrip_with_taesd(tmp_path):
    """The checkpoint phase of chip_smoke.py at tiny UNet and text widths:
    seeded trees → the port's exporters and writer (bf16) → ``load_bundle``
    with a TAESD directory: every leaf bit-exact, the schedule read, and
    the context equal to the tower's on the source trees."""
    dtype = torch.bfloat16
    params = make_random_params(0, registry.TINY_UNET_CONFIG, "tiny", TAESD,
                                registry.TINY_TEXT_CONFIG, dtype, torch.device("cpu"))
    for sub, state, fname in (
            ("m/unet", weights.to_diffusers_unet_state(params["unet"]),
             "diffusion_pytorch_model.safetensors"),
            ("m/text_encoder", weights.to_transformers_text_encoder_state(params["text_encoder"]),
             "model.safetensors"),
            ("taesd", weights.to_diffusers_taesd_state(params["vae"], TAESD),
             "diffusion_pytorch_model.safetensors")):
        (tmp_path / sub).mkdir(parents=True)
        safetensors_io.save_file(state, tmp_path / sub / fname)
    (tmp_path / "m" / "scheduler").mkdir()
    (tmp_path / "m" / "scheduler" / "scheduler_config.json").write_text(
        json.dumps(SCHEDULER_CONFIG_JSON))
    bundle = load_bundle(tmp_path / "m", "tiny", tmp_path / "taesd", dtype,
                         unet_config=registry.TINY_UNET_CONFIG,
                         text_config=registry.TINY_TEXT_CONFIG, device="cpu")
    _assert_trees_equal(bundle.unet_params, params["unet"])
    _assert_trees_equal(bundle.vae.params, params["vae"])
    assert bundle.vae.config == TAESD and bundle.ddim_config.prediction_type == "v_prediction"
    with torch.no_grad():
        ctx = clip_text.empty_prompt_context(params["text_encoder"], registry.TINY_TEXT_CONFIG)
    assert torch.equal(bundle.text_context, ctx)
    # make_random_bundle assembles the same trees and the same context
    rb = make_random_bundle(0, registry.TINY_UNET_CONFIG, TAESD, dtype, "cpu")
    _assert_trees_equal(rb.unet_params, params["unet"])
    assert torch.equal(rb.text_context, ctx)


def test_entry_points_raise_without_gpu_unless_cpu(tmp_path):
    """``load_bundle`` and ``make_random_bundle`` default to the GPU and never
    fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_bundle(tmp_path, "kl")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_random_bundle(0)
    with pytest.raises(ValueError, match="taesd_dir is required"):
        load_bundle(tmp_path, "tiny", device="cpu")
