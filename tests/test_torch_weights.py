"""``weights.from_jax_params``: every JAX leaf consumed once, in the port's
layouts, with the same values; extra or missing leaves raise."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from depth_completion_tpu.models import registry as jreg
from depth_completion_tpu.models.unet import init_unet
from depth_completion_tpu.models.vae_kl import init_vae as init_kl_vae
from depth_completion_tpu.models.vae_tiny import init_taesd
from depth_completion_tpu_torch.models import registry
from depth_completion_tpu_torch.models.weights import _flatten, from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small CPU shapes: two threads, restored after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def tiny_jax_trees(unet_config=jreg.TINY_UNET_CONFIG, vae_config=jreg.TINY_TAESD_CONFIG, seed=0):
    """UNet and VAE trees (TAESD, or the KL VAE for a ``VAEConfig``) with the
    JAX package's structure and layouts (``jax.eval_shape`` of its
    initialisers, no compile), filled from a seeded numpy generator at the
    init scale, and a seeded context."""
    init_vae = init_kl_vae if isinstance(vae_config, jreg.VAEConfig) else init_taesd
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", None)
        shape = leaf.shape
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            return rng.uniform(-bound, bound, size=shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    trees = [
        jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init, key))
        for init in (
            lambda k: init_unet(k, unet_config, jnp.float32),
            lambda k: init_vae(k, vae_config, jnp.float32),
        )
    ]
    ctx = rng.normal(size=(1, 2, unet_config.cross_attention_dim)).astype(np.float32)
    return trees[0], trees[1], ctx


@pytest.fixture(scope="module")
def jax_trees():
    return tiny_jax_trees()


def _convert(unet, taesd, ctx):
    return from_jax_params(
        unet, taesd, ctx, unet_config=registry.TINY_UNET_CONFIG,
        vae_config=registry.TINY_TAESD_CONFIG, device="cpu",
    )


def test_every_leaf_once_with_layout(jax_trees):
    unet, taesd, ctx = jax_trees
    bundle = _convert(unet, taesd, ctx)
    for jtree, ttree in ((unet, bundle.unet_params), (taesd, bundle.vae.params)):
        jl, tl = _flatten(jtree), _flatten(ttree)
        assert set(jl) == set(tl)
        for path, arr in jl.items():
            got = tl[path].numpy()
            if path[-1] == "kernel" and arr.ndim == 4:
                ref = arr.transpose(3, 2, 0, 1)  # HWIO → OIHW
            elif path[-1] == "kernel" and arr.ndim == 2:
                ref = arr.T  # [in, out] → [out, in]
            else:
                ref = arr
            # a pure relayout of fp32 values: exact
            np.testing.assert_array_equal(got, ref, err_msg="/".join(map(str, path)))
    np.testing.assert_array_equal(bundle.text_context.numpy(), ctx)


def test_extra_or_missing_leaf_raises(jax_trees):
    unet, taesd, ctx = jax_trees
    extra = copy.deepcopy(unet)
    extra["conv_in"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unconsumed"):
        _convert(extra, taesd, ctx)
    missing = copy.deepcopy(taesd)
    del missing["decoder"]["conv_out"]["bias"]
    with pytest.raises(KeyError, match="missing"):
        _convert(unet, missing, ctx)
    wrong = copy.deepcopy(unet)
    wrong["conv_out"]["kernel"] = wrong["conv_out"]["kernel"][..., :1]
    with pytest.raises(ValueError, match="shape"):
        _convert(wrong, taesd, ctx)


def test_no_gpu_means_raise_unless_cpu(jax_trees):
    """Entry points default to the GPU and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    unet, taesd, ctx = jax_trees
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_params(
            unet, taesd, ctx, unet_config=registry.TINY_UNET_CONFIG,
            vae_config=registry.TINY_TAESD_CONFIG,
        )
