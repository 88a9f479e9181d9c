"""The port's UNet, TAESD and layer pieces against the JAX package on the
same weights (moved across with ``from_jax_params``) and the same inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from depth_completion_tpu.models import layers as jl
from depth_completion_tpu.models import registry as jreg
from depth_completion_tpu.models import unet as junet
from depth_completion_tpu.models import vae_tiny as jvae
from depth_completion_tpu_torch.models import layers as tl
from depth_completion_tpu_torch.models import registry
from depth_completion_tpu_torch.models import unet as tunet
from depth_completion_tpu_torch.models.weights import from_jax_params

from tests.test_torch_weights import tiny_jax_trees


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small CPU shapes: two threads, restored after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    unet_j, taesd_j, ctx = tiny_jax_trees(seed=1)
    bundle = from_jax_params(
        unet_j, taesd_j, ctx, unet_config=registry.TINY_UNET_CONFIG,
        vae_config=registry.TINY_TAESD_CONFIG, device="cpu",
    )
    return unet_j, taesd_j, ctx, bundle


def _jit_vjp(fn):
    """(out, vjp(g)) of a one-argument function, compiled once."""

    @jax.jit
    def run(x, g):
        out, vjp = jax.vjp(fn, x)
        return out, vjp(g)[0]

    return run


@pytest.mark.parametrize("hw", [(8, 12), (7, 10)], ids=["even", "odd_upsample_target"])
def test_unet_forward_and_latent_grad(models, hw):
    """Forward and d(out·g)/d(sample). (7, 10) takes the odd-target upsample
    branch (nearest with half-pixel centres)."""
    unet_j, _, ctx, bundle = models
    rng = np.random.default_rng(hw[0])
    x = rng.normal(size=(2,) + hw + (8,)).astype(np.float32)
    g = rng.normal(size=(2,) + hw + (4,)).astype(np.float32)
    ctx2 = np.repeat(ctx, 2, axis=0)
    t = 700

    def jfn(x):
        return junet.apply_unet(
            unet_j, x, jnp.asarray(t), jnp.asarray(ctx2), jreg.TINY_UNET_CONFIG
        )

    out_j, dx_j = _jit_vjp(jfn)(jnp.asarray(x), jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    out_t = tunet.apply_unet(
        bundle.unet_params, tx, t, torch.from_numpy(ctx2), registry.TINY_UNET_CONFIG
    )
    (dx_t,) = torch.autograd.grad(out_t, tx, torch.from_numpy(g))
    # fp32 through ~30 layers, sums in another order
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), rtol=1e-3, atol=1e-4)


def test_taesd_encode(models):
    _, taesd_j, _, bundle = models
    img = np.random.default_rng(4).uniform(-1, 1, size=(2, 16, 24, 3)).astype(np.float32)
    ref = jax.jit(lambda a: jvae.encode(taesd_j, a, jreg.TINY_TAESD_CONFIG))(jnp.asarray(img))
    got = bundle.vae.encode(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("w", [12, 7], ids=["even_width", "odd_width"])
def test_taesd_decode_depth_and_grad(models, w):
    """decode_depth and its latent gradient; odd latent widths take the JAX
    package's unpacked path, even widths its width-packed path."""
    _, taesd_j, _, bundle = models
    rng = np.random.default_rng(w)
    lat = rng.normal(size=(2, 8, w, 4)).astype(np.float32)
    g = rng.normal(size=(2, 16, 2 * w, 1)).astype(np.float32)

    def jfn(z):
        return jvae.decode_depth(taesd_j, z, jreg.TINY_TAESD_CONFIG)

    out_j, dz_j = _jit_vjp(jfn)(jnp.asarray(lat), jnp.asarray(g))
    tz = torch.tensor(lat, requires_grad=True)
    out_t = bundle.vae.decode_depth(tz)
    (dz_t,) = torch.autograd.grad(out_t, tz, torch.from_numpy(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dz_t.numpy(), np.asarray(dz_j), rtol=1e-3, atol=1e-5)
    rgb_t = bundle.vae.decode(torch.from_numpy(lat))
    rgb_j = jax.jit(lambda z: jvae.decode(taesd_j, z, jreg.TINY_TAESD_CONFIG))(jnp.asarray(lat))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=1e-4, atol=1e-5)


def test_layer_pieces():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 5, 6, 16)).astype(np.float32)
    norm = {"scale": rng.normal(size=16).astype(np.float32),
            "bias": rng.normal(size=16).astype(np.float32)}
    jn = {k: jnp.asarray(v) for k, v in norm.items()}
    tn = {k: torch.from_numpy(v) for k, v in norm.items()}
    # normalisations: fp32 statistics on both sides
    np.testing.assert_allclose(
        tl.group_norm(tn, torch.from_numpy(x), 4, 1e-6).numpy(),
        np.asarray(jl.group_norm(jn, jnp.asarray(x), 4, 1e-6)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tl.layer_norm(tn, torch.from_numpy(x)).numpy(),
        np.asarray(jl.layer_norm(jn, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    # attention: regular and the 2-token KV (the JAX package unrolls it)
    q = rng.normal(size=(2, 30, 16)).astype(np.float32)
    for sk in (30, 2):
        k = rng.normal(size=(2, sk, 16)).astype(np.float32)
        v = rng.normal(size=(2, sk, 16)).astype(np.float32)
        np.testing.assert_allclose(
            tl.attention(*(torch.from_numpy(a) for a in (q, k, v)), 2).numpy(),
            np.asarray(jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2)),
            rtol=1e-5, atol=1e-6)
    ts = np.asarray([0, 1, 500, 999], np.int32)
    np.testing.assert_allclose(
        tl.timestep_embedding(torch.from_numpy(ts), 32).numpy(),
        np.asarray(jl.timestep_embedding(jnp.asarray(ts), 32)), rtol=1e-5, atol=1e-5)
    conv = {"kernel": rng.normal(size=(3, 3, 16, 3)).astype(np.float32),
            "bias": rng.normal(size=3).astype(np.float32)}
    tconv = {"kernel": torch.from_numpy(conv["kernel"].transpose(3, 2, 0, 1).copy()),
             "bias": torch.from_numpy(conv["bias"])}
    np.testing.assert_allclose(
        tl.conv3x3_mean_tap(tconv, torch.from_numpy(x)).numpy(),
        np.asarray(jl.conv3x3_mean_tap({k: jnp.asarray(v) for k, v in conv.items()},
                                       jnp.asarray(x))), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        tl.upsample_nearest_2x(torch.from_numpy(x)).numpy(),
        np.asarray(jl.upsample_nearest_2x(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tl.resize_nearest(torch.from_numpy(x), (9, 13)).numpy(),
        np.asarray(jax.image.resize(jnp.asarray(x), (2, 9, 13, 16), "nearest")))


def test_geglu_uses_tanh_gelu():
    """jax.nn.gelu defaults to the tanh approximation; the port must match
    it, and exact GELU would not (up to ~4.7e-4 apart)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 16)).astype(np.float32) * 3
    p = {"proj_in": {"kernel": rng.normal(size=(16, 64)).astype(np.float32),
                     "bias": rng.normal(size=64).astype(np.float32)},
         "proj_out": {"kernel": rng.normal(size=(32, 16)).astype(np.float32),
                      "bias": rng.normal(size=16).astype(np.float32)}}
    ref = np.asarray(junet._geglu_ff(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    tp = {k: {"kernel": torch.from_numpy(v["kernel"].T.copy()), "bias": torch.from_numpy(v["bias"])}
          for k, v in p.items()}
    got = tunet._geglu_ff(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    z = torch.linspace(-6, 6, 2001)
    gap = (F.gelu(z) - F.gelu(z, approximate="tanh")).abs().max().item()
    assert 4e-4 < gap < 5e-4
