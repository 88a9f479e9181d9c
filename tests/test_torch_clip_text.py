"""The port's CLIP text tower (``models/clip_text.py``) against the JAX
package's ``apply_text_encoder`` at ``TINY_TEXT_CONFIG``, fp32, on the same
weights: the empty prompt (ids clamped into the tiny vocabulary, as both
bundles do) and a random 9-token sequence, with the exact GELU and with
quick GELU."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from depth_completion_tpu.models import clip_text as jclip
from depth_completion_tpu.models import registry as jreg
from depth_completion_tpu_torch.models import clip_text, registry
from depth_completion_tpu_torch.models.weights import text_encoder_from_jax


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small CPU shapes: two threads, restored after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def jax_text_tree(config=jreg.TINY_TEXT_CONFIG, seed=0):
    """A text-encoder tree with the JAX package's structure and layouts
    (``jax.eval_shape`` of its initialiser, no compile), filled from a
    seeded numpy generator: embeddings and biases normal, kernels at the
    init scale, norms near unit scale."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", None)
        if name == "kernel":
            bound = 1.0 / np.sqrt(leaf.shape[0])
            return rng.uniform(-bound, bound, size=leaf.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        if name in ("token_embedding", "position_embedding"):
            return (0.02 * rng.normal(size=leaf.shape)).astype(np.float32)
        return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jclip.init_text_encoder(k, config, jnp.float32),
                            jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _ids(kind, config):
    if kind == "empty":
        return np.minimum(jclip.empty_prompt_ids(config), config.vocab_size - 1)
    rng = np.random.default_rng(5)
    return rng.integers(0, config.vocab_size, size=(2, 9)).astype(np.int32)


@pytest.mark.parametrize("ids_kind", ["empty", "random9"])
@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_tower_matches_jax(act, ids_kind):
    """Last hidden state to rel 1e-5 of its largest value: fp32 on both
    sides, products and sums in another order."""
    jcfg = dataclasses.replace(jreg.TINY_TEXT_CONFIG, hidden_act=act)
    tcfg = dataclasses.replace(registry.TINY_TEXT_CONFIG, hidden_act=act)
    tree = jax_text_tree(jcfg)
    ids = _ids(ids_kind, jcfg)
    ref = np.asarray(jax.jit(jclip.apply_text_encoder, static_argnums=2)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(ids), jcfg))
    params = text_encoder_from_jax(tree, tcfg, device="cpu")
    with torch.no_grad():
        got = clip_text.apply_text_encoder(params, torch.from_numpy(ids).long(), tcfg).numpy()
        if ids_kind == "empty":
            np.testing.assert_array_equal(
                clip_text.empty_prompt_context(params, tcfg).numpy(), got)
    assert got.shape == ref.shape == (ids.shape[0], ids.shape[1], tcfg.hidden_size)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_gelu_is_exact_not_tanh():
    """The tower's "gelu" is erf-based: it differs from the tanh form the
    UNet's GEGLU uses by more than fp32 rounding at |x| ~ 2."""
    x = torch.linspace(-3, 3, 61, dtype=torch.float64)
    exact = 0.5 * x * (1 + torch.erf(x / np.sqrt(2.0)))
    np.testing.assert_allclose(clip_text._act(x, "gelu").numpy(), exact.numpy(), rtol=1e-12)
    tanh = torch.nn.functional.gelu(x, approximate="tanh")
    assert float((clip_text._act(x, "gelu") - tanh).abs().max()) > 1e-4
    with pytest.raises(ValueError, match="unknown activation"):
        clip_text._act(x, "relu")


def test_from_jax_params_computes_context_with_port_tower():
    """``from_jax_params`` given the JAX text tree: the bundle's context is
    the port's tower on the empty prompt, equal to JAX's to rel 1e-5."""
    from tests.test_torch_weights import tiny_jax_trees
    from depth_completion_tpu_torch.models.weights import from_jax_params

    unet, taesd, _ = tiny_jax_trees()
    tree = jax_text_tree(seed=3)
    cfg = jreg.TINY_TEXT_CONFIG
    ids = np.minimum(jclip.empty_prompt_ids(cfg), cfg.vocab_size - 1)
    ref = np.asarray(jclip.apply_text_encoder(jax.tree.map(jnp.asarray, tree), jnp.asarray(ids),
                                              cfg))
    bundle = from_jax_params(unet, taesd, unet_config=registry.TINY_UNET_CONFIG,
                             vae_config=registry.TINY_TAESD_CONFIG, text_tree=tree,
                             text_config=registry.TINY_TEXT_CONFIG, device="cpu")
    np.testing.assert_allclose(bundle.text_context.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    with pytest.raises(ValueError, match="exactly one"):
        from_jax_params(unet, taesd, ref, unet_config=registry.TINY_UNET_CONFIG,
                        vae_config=registry.TINY_TAESD_CONFIG, text_tree=tree,
                        text_config=registry.TINY_TEXT_CONFIG, device="cpu")


@pytest.mark.parametrize("hidden", [16, 64])
def test_random_bundle_context_fits_cross_attention_width(hidden):
    """``make_random_bundle`` zero-pads (tower narrower than the UNet's
    ``cross_attention_dim``) or trims (wider) the tower's context, as the
    JAX package's does; the kept channels are the tower's own."""
    from depth_completion_tpu_torch.models.bundle import make_random_bundle, make_random_params

    tcfg = dataclasses.replace(registry.TINY_TEXT_CONFIG, hidden_size=hidden,
                               intermediate_size=2 * hidden)
    width = registry.TINY_UNET_CONFIG.cross_attention_dim
    bundle = make_random_bundle(0, registry.TINY_UNET_CONFIG, device="cpu", text_config=tcfg)
    params = make_random_params(0, registry.TINY_UNET_CONFIG, "tiny", registry.TINY_TAESD_CONFIG,
                                tcfg, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        ctx = clip_text.empty_prompt_context(params["text_encoder"], tcfg)
    keep = min(hidden, width)
    assert bundle.text_context.shape == (1, 2, width)
    assert torch.equal(bundle.text_context[..., :keep], ctx[..., :keep])
    assert not bundle.text_context[..., keep:].any()
