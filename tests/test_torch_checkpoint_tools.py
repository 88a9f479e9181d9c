"""The port's checkpoint-day tools against the JAX package's:
``scripts/make_synthetic_checkpoint_torch.py`` against
``scripts/make_synthetic_checkpoint.py`` (the full-width key inventory and
shapes of the UNet, the KL VAE and TAESD, from ``jax.eval_shape`` and the
JAX script's own ``_tree_shapes_to_state`` on one side and meta tensors on
the other; the values, key by key, for the same seed), and
``scripts/verify_checkpoint_torch.py`` on a tiny directory the port wrote:
JAX's ``load_bundle`` and the port's read equal trees from it, and the
verifier's 2-step dense map on the CPU matches the JAX pipeline's on the
same directory within the tolerance model of
tests/test_pipeline_parity.py:36-49 (the bounds of
tests/test_torch_checkpoint.py's end-to-end case). The text tower's
inventory against ``transformers`` is in tests/test_torch_checkpoint.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from depth_completion_tpu.models import registry as jreg
from depth_completion_tpu.models import vae_kl as jkl
from depth_completion_tpu.models import vae_tiny as jtiny
from depth_completion_tpu.models import weights as jweights
from depth_completion_tpu.models.bundle import load_bundle as j_load_bundle
from depth_completion_tpu.models.unet import init_unet as j_init_unet
from depth_completion_tpu.pipeline import DepthCompletionPipeline as JPipe
from depth_completion_tpu_torch.models import registry, weights
from depth_completion_tpu_torch.models.bundle import load_bundle

from scripts import make_synthetic_checkpoint_torch as synth
from scripts.make_synthetic_checkpoint import _random_like_shapes, _tree_shapes_to_state

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _hf_key(key: str) -> str:
    """The JAX exporter's UNet stage prefixes ("down_transformer_blocks")
    in diffusers' names, which the port writes."""
    return key.replace("down_transformer_blocks.", "down_blocks.").replace(
        "up_transformer_blocks.", "up_blocks.")


def _jax_inventory(component: str, ucfg=jreg.MARIGOLD_UNET_CONFIG, vcfg=jreg.SD_VAE_CONFIG):
    """The JAX script's key → shape for ``component``, keys in diffusers'
    names, in its order."""
    key = jax.random.PRNGKey(0)
    if component == "unet":
        shapes = _tree_shapes_to_state(
            jweights.to_diffusers_unet_state, jax.eval_shape(lambda k: j_init_unet(k, ucfg), key))
    elif component == "vae":
        shapes = _tree_shapes_to_state(
            jweights.to_diffusers_vae_state, jax.eval_shape(lambda k: jkl.init_vae(k, vcfg), key))
    else:
        t = jreg.TAESD_CONFIG
        shapes = _tree_shapes_to_state(
            jweights.to_diffusers_taesd_state,
            jax.eval_shape(lambda k: jtiny.init_taesd(k, t), key), t.encoder_blocks,
            t.decoder_blocks)
    return {_hf_key(k): s for k, s in shapes.items()}


@pytest.mark.parametrize("component", ["unet", "vae", "taesd"])
def test_full_width_inventory_matches_jax_script(component):
    """Marigold's UNet (866M parameters), SD's KL VAE and TAESD: the same
    keys, in the same order, with the same shapes, and nothing allocated at
    full width on either side."""
    want = _jax_inventory(component)
    got = synth.inventory(component, synth.CONFIGS[component])
    assert list(got.items()) == list(want.items())
    params = sum(int(np.prod(s)) for s in got.values())
    assert params == {"unet": 865_922_244, "vae": 83_653_863, "taesd": 2_445_063}[component]


def _tiny_configs() -> dict[str, dict]:
    """Config JSONs at the tiny UNet, KL VAE and text-tower geometries."""
    u, v, t = registry.TINY_UNET_CONFIG, registry.TINY_VAE_CONFIG, registry.TINY_TEXT_CONFIG
    return {
        "unet": {**synth.UNET_CONFIG_JSON, "block_out_channels": list(u.block_out_channels),
                 "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
                 "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"],
                 "attention_head_dim": list(u.num_heads),
                 "cross_attention_dim": u.cross_attention_dim,
                 "norm_num_groups": u.norm_groups, "layers_per_block": u.layers_per_block},
        "vae": {**synth.VAE_CONFIG_JSON, "block_out_channels": list(v.block_out_channels),
                "norm_num_groups": v.norm_groups, "layers_per_block": v.layers_per_block},
        "text_encoder": {**synth.TEXT_ENCODER_CONFIG_JSON, "vocab_size": t.vocab_size,
                         "hidden_size": t.hidden_size, "num_hidden_layers": t.num_layers,
                         "num_attention_heads": t.num_heads,
                         "intermediate_size": t.intermediate_size},
    }


def test_written_values_match_jax_script(tmp_path):
    """At the tiny UNet and KL VAE and at TAESD's own width, the files the
    port's writer leaves for seed 5 hold, key by key, the float16 values the
    JAX script draws for seed 5 (UNet at the seed, VAE at seed + 1, TAESD at
    seed + 2), so both drills load the same weights."""
    report = synth.write_checkpoint(tmp_path / "m", tmp_path / "taesd", seed=5,
                                    configs=_tiny_configs(),
                                    components=("unet", "vae", "taesd"))
    assert set(report) == {"unet", "vae", "taesd"}
    ucfg, vcfg = jreg.TINY_UNET_CONFIG, jreg.TINY_VAE_CONFIG
    for comp, path, seed in (("unet", tmp_path / "m" / "unet", 5),
                             ("vae", tmp_path / "m" / "vae", 6),
                             ("taesd", tmp_path / "taesd", 7)):
        got = load_file(str(path / "diffusion_pytorch_model.safetensors"))
        shapes = _jax_inventory(comp, ucfg, vcfg)
        want = _random_like_shapes(shapes, np.float16, seed)
        assert set(got) == set(want) and report[comp]["tensors"] == len(want)
        for key, value in want.items():
            assert got[key].dtype == np.float16
            np.testing.assert_array_equal(got[key], value, err_msg=f"{comp} {key}")


def test_tiny_directory_loads_and_verifies_as_jax(tmp_path):
    """A tiny directory written by the port (every component, seeded):
    JAX's ``load_bundle`` and the port's read the same UNet, KL VAE and
    TAESD trees and contexts within 1e-5; ``verify_checkpoint_torch.py
    --device cpu`` exits 0, printing its parameter counts, OK and zero
    launches (the plain twins); its 2-step dense map at 128x160 equals the
    JAX pipeline's on the same directory within rms 1e-4, max 1e-3."""
    model, taesd = tmp_path / "m", tmp_path / "taesd"
    synth.write_checkpoint(model, taesd, configs=_tiny_configs(), seed=3)
    jb = j_load_bundle(model, vae_kind="tiny", taesd_dir=taesd, dtype=jnp.float32)
    jkl_bundle = j_load_bundle(model, vae_kind="kl", dtype=jnp.float32)
    tb = load_bundle(model, "tiny", taesd, torch.float32, device="cpu")
    tkl = load_bundle(model, "kl", None, torch.float32, device="cpu")
    for jtree, ttree, vcfg in ((jb.vae.params, tb.vae.params, registry.TAESD_CONFIG),
                               (jkl_bundle.vae.params, tkl.vae.params, registry.TINY_VAE_CONFIG)):
        ref = weights.from_jax_params(jb.unet_params, jtree, np.array(jb.text_context),
                                      unet_config=registry.TINY_UNET_CONFIG, vae_config=vcfg,
                                      device="cpu")
        for got, want in ((tb.unet_params, ref.unet_params), (ttree, ref.vae.params)):
            g, r = weights._flatten(got), weights._flatten(want)
            assert set(g) == set(r)
            assert all(torch.equal(g[p], r[p]) for p in r)
    for t, j in ((tb, jb), (tkl, jkl_bundle)):
        np.testing.assert_allclose(t.text_context.numpy(), np.asarray(j.text_context), atol=1e-5)

    out = tmp_path / "dense.npy"
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "verify_checkpoint_torch.py"), str(model),
         "--taesd", str(taesd), "--device", "cpu", "--precision", "fp32", "--out", str(out)],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="2"), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[-1] == "OK" and any(line.startswith("  unet:") for line in lines)
    launches = next(line for line in lines if line.startswith("launches "))
    assert '"conv3x3": 0' in launches and '"flash_fwd": 0' in launches

    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, size=(1, 128, 160, 3)).astype(np.float32)
    sparse = np.zeros((1, 128, 160, 1), np.float32)
    sparse[0, ::16, ::16, 0] = rng.uniform(2.0, 100.0, sparse[0, ::16, ::16, 0].shape)
    want, _ = JPipe(jb)(images, sparse, max_depth=120.0, steps=2, resolution=128)
    diff = np.load(out) - np.asarray(want)
    assert diff.shape == (1, 128, 160, 1)
    rms = float(np.sqrt(np.mean(diff ** 2)))
    assert rms < 1e-4 and np.abs(diff).max() < 1e-3, (rms, np.abs(diff).max())
