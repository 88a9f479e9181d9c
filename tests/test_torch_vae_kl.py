"""The port's KL VAE (``--vae original``) against the JAX package on the
same weights (``from_jax_params``) and inputs: encode, decode, decode_depth
and its latent gradient, the upsample conv, and the weight bridge
on a KL tree. ``TINY_VAE_CONFIG`` (16/32 channels, 2 stages), fp32."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from depth_completion_tpu.models import layers as jl
from depth_completion_tpu.models import registry as jreg
from depth_completion_tpu.models import vae_kl as jvae
from depth_completion_tpu_torch.models import layers as tl
from depth_completion_tpu_torch.models import registry
from depth_completion_tpu_torch.models.bundle import VAE, make_random_bundle
from depth_completion_tpu_torch.models.weights import _flatten, from_jax_params
from depth_completion_tpu_torch.ops.conv3x3 import conv3x3_fused

from tests.test_torch_weights import tiny_jax_trees


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small CPU shapes: two threads, restored after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def kl():
    unet_j, vae_j, ctx = tiny_jax_trees(vae_config=jreg.TINY_VAE_CONFIG, seed=2)
    bundle = from_jax_params(
        unet_j, vae_j, ctx, unet_config=registry.TINY_UNET_CONFIG,
        vae_config=registry.TINY_VAE_CONFIG, device="cpu",
    )
    return unet_j, vae_j, ctx, bundle


@pytest.mark.parametrize("hw", [(16, 24), (15, 22)], ids=["even", "odd"])
def test_kl_encode(kl, hw):
    """Posterior mean x 0.18215; odd sizes take the downsamplers'
    asymmetric ((0, 1), (0, 1)) padding at an odd edge. fp32 through ~15
    layers, sums in another order."""
    _, vae_j, _, bundle = kl
    img = np.random.default_rng(hw[1]).uniform(-1, 1, size=(2,) + hw + (3,)).astype(np.float32)
    ref = jax.jit(lambda a: jvae.encode(vae_j, a, jreg.TINY_VAE_CONFIG))(jnp.asarray(img))
    got = bundle.vae.encode(torch.from_numpy(img))
    assert got.shape == ref.shape == (2, hw[0] // 2, hw[1] // 2, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_kl_encode_runs_given_conv_and_attention(kl):
    """``encode`` sends every stride-1 3x3 conv of the ResNets (4 in the mid
    block, 2 per ResNet in the down stages) to ``conv_fn`` and the mid
    attention to ``attention_fn``: the same latent as the default, exactly
    (both are the plain twins on the CPU)."""
    _, _, _, bundle = kl
    calls = {"conv": 0, "attention": 0}

    def counted(fn, key):
        def run(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return run

    img = torch.from_numpy(
        np.random.default_rng(5).uniform(-1, 1, size=(1, 16, 24, 3)).astype(np.float32))
    got = bundle.vae.encode(img, conv_fn=counted(conv3x3_fused, "conv"),
                            attention_fn=counted(tl.attention, "attention"))
    cfg = registry.TINY_VAE_CONFIG
    assert calls == {"conv": 4 + 2 * len(cfg.block_out_channels) * cfg.layers_per_block,
                     "attention": 1}
    torch.testing.assert_close(got, bundle.vae.encode(img), rtol=0, atol=0)


def test_kl_decode_depth_and_grad(kl):
    """decode_depth with its latent gradient, and decode (RGB). The mid
    attention runs at S = 8x12 = 96 (the plain path on both sides); the
    ResNet convs take the conv kernel's plain twin on the CPU."""
    _, vae_j, _, bundle = kl
    rng = np.random.default_rng(8)
    lat = rng.normal(size=(2, 8, 12, 4)).astype(np.float32)
    g = rng.normal(size=(2, 16, 24, 1)).astype(np.float32)

    @jax.jit
    def run(z, g):
        out, vjp = jax.vjp(lambda z: jvae.decode_depth(vae_j, z, jreg.TINY_VAE_CONFIG), z)
        return out, vjp(g)[0]

    out_j, dz_j = run(jnp.asarray(lat), jnp.asarray(g))
    tz = torch.tensor(lat, requires_grad=True)
    out_t = bundle.vae.decode_depth(tz)
    (dz_t,) = torch.autograd.grad(out_t, tz, torch.from_numpy(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dz_t.numpy(), np.asarray(dz_j), rtol=1e-3, atol=1e-5)
    rgb_t = bundle.vae.decode(torch.from_numpy(lat))
    rgb_j = jax.jit(lambda z: jvae.decode(vae_j, z, jreg.TINY_VAE_CONFIG))(jnp.asarray(lat))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=1e-4, atol=1e-5)


def test_upsample_conv_2x_matmul():
    """The port's form (the conv of the upsampled map) against the JAX
    package's subpixel form: fp32 to summation order (1e-5); bf16 (JAX sums
    the taps in bf16 before its products) to 2 bf16 ulps of the largest
    output."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 5, 7, 16)).astype(np.float32)
    conv = {"kernel": (rng.normal(size=(3, 3, 16, 8)) / 12).astype(np.float32),
            "bias": rng.normal(size=8).astype(np.float32)}
    tconv = {"kernel": torch.from_numpy(conv["kernel"].transpose(3, 2, 0, 1).copy()),
             "bias": torch.from_numpy(conv["bias"])}
    jconv = {k: jnp.asarray(v) for k, v in conv.items()}
    got = tl.upsample_conv_2x_matmul(tconv, torch.from_numpy(x))
    ref = jl.upsample_conv_2x_matmul(jconv, jnp.asarray(x))
    direct = tl.conv2d(tconv, tl.upsample_nearest_2x(torch.from_numpy(x)))
    assert got.shape == (2, 10, 14, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=1e-5, atol=1e-5)
    got16 = tl.upsample_conv_2x_matmul(tconv, torch.from_numpy(x).to(torch.bfloat16))
    ref16 = np.asarray(jl.upsample_conv_2x_matmul(jconv, jnp.asarray(x, jnp.bfloat16)), np.float32)
    np.testing.assert_allclose(got16.float().numpy(), ref16, rtol=0,
                               atol=1.6e-2 * np.abs(ref16).max())


def test_kl_weights_every_leaf_once(kl):
    _, vae_j, _, bundle = kl
    assert bundle.vae.kind == "kl"
    jl_, tl_ = _flatten(vae_j), _flatten(bundle.vae.params)
    assert set(jl_) == set(tl_)
    for path, arr in jl_.items():
        ref = arr.transpose(3, 2, 0, 1) if path[-1] == "kernel" and arr.ndim == 4 else (
            arr.T if path[-1] == "kernel" else arr)
        # a pure relayout of fp32 values: exact
        np.testing.assert_array_equal(tl_[path].numpy(), ref, err_msg="/".join(map(str, path)))


def test_kl_weights_extra_or_missing_leaf_raises(kl):
    unet_j, vae_j, ctx, _ = kl

    def convert(vae_tree):
        return from_jax_params(unet_j, vae_tree, ctx, unet_config=registry.TINY_UNET_CONFIG,
                               vae_config=registry.TINY_VAE_CONFIG, device="cpu")

    extra = copy.deepcopy(vae_j)
    extra["decoder"]["mid_block"]["attentions"][0]["to_q"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unconsumed"):
        convert(extra)
    missing = copy.deepcopy(vae_j)
    del missing["encoder"]["down_blocks"][0]["downsampler"]["bias"]
    with pytest.raises(KeyError, match="missing"):
        convert(missing)


def test_kl_bundle_and_downsample_factor():
    """Seeded random KL bundle on the CPU; the factor is 2 per stage after
    the first (8 at SD widths)."""
    b = make_random_bundle(seed=0, vae_kind="kl", device="cpu")
    assert b.vae.kind == "kl" and b.vae.config == registry.TINY_VAE_CONFIG
    assert b.vae.downsample_factor == 2
    assert VAE(kind="kl", params={}, config=registry.SD_VAE_CONFIG).downsample_factor == 8
    lat = b.vae.encode(torch.zeros((1, 16, 16, 3)))
    assert lat.shape == (1, 8, 8, 4) and torch.isfinite(lat).all()
    with pytest.raises(ValueError, match="unknown VAE kind"):
        make_random_bundle(seed=0, vae_kind="full", device="cpu")


@pytest.mark.parametrize("kind, config", [("tiny", registry.SD_VAE_CONFIG),
                                          ("kl", registry.TAESD_CONFIG)])
def test_make_random_bundle_kind_must_match_config(kind, config):
    with pytest.raises(ValueError, match="does not match"):
        make_random_bundle(seed=0, vae_kind=kind, vae_config=config, device="cpu")
