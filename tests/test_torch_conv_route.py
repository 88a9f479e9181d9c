"""The VAEs' stride-1 3x3 convs routed by shape (``ops.conv3x3.fits``): at
the widths the conv kernel takes (bf16 or fp32, Ci and Co multiples of 8)
they run ``conv3x3_fused``, elsewhere ``F.conv2d`` with the bias, the skip
and the ReLU after it; either way the VAE equals the JAX package's, which
runs XLA's conv where its Pallas kernel does not fit.

Tolerance model (``tests/test_pipeline_parity.py``'s): fp32 forwards agree
to machine noise summed in another order (rtol 1e-4, atol 1e-5 over a
dozen layers); the latent gradient of an l1 loss on ``decode_depth`` has
no ε-norm rescale to amplify the backward's reduction-order noise (rtol
1e-3, atol 1e-5)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from depth_completion_tpu.models import registry as jreg
from depth_completion_tpu.models import vae_kl as jkl
from depth_completion_tpu.models import vae_tiny as jtiny
from depth_completion_tpu_torch.models import registry
from depth_completion_tpu_torch.models.bundle import make_random_bundle
from depth_completion_tpu_torch.models.weights import from_jax_params
from depth_completion_tpu_torch.ops import conv3x3 as c3

from tests.test_torch_weights import tiny_jax_trees

# widths that are not multiples of 8: every ResNet / Block conv takes F.conv2d
KL = dict(block_out_channels=(12, 20), layers_per_block=1, norm_groups=4)
TAESD = dict(channels=12, encoder_blocks=(1, 1), decoder_blocks=(1, 1))
FORWARD = dict(rtol=1e-4, atol=1e-5)
GRADIENT = dict(rtol=1e-3, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small CPU shapes: two threads, restored after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("dtype, ci, co, want", [
    (torch.bfloat16, 64, 64, True), (torch.float32, 64, 64, True),
    (torch.bfloat16, 12, 20, False), (torch.float32, 12, 20, False),
    (torch.bfloat16, 64, 36, False), (torch.float32, 36, 64, False),
    (torch.float16, 64, 64, False), (torch.float64, 64, 64, False),
])
def test_fits(dtype, ci, co, want):
    assert c3.fits(dtype, ci, co) is want


def _bundle(jax_config, port_config, seed):
    unet_j, vae_j, ctx = tiny_jax_trees(vae_config=jax_config, seed=seed)
    bundle = from_jax_params(unet_j, vae_j, ctx, unet_config=registry.TINY_UNET_CONFIG,
                             vae_config=port_config, device="cpu")
    return vae_j, bundle.vae


def _decode_and_l1_grad(decode, z):
    """(decode(z), d/dz of Σ|decode(z) - 0.5|)."""
    out, vjp = jax.vjp(decode, z)
    return out, vjp(jnp.sign(out - 0.5))[0]


@pytest.fixture(scope="module")
def narrow():
    """(JAX result, port result) per case, both VAEs at widths no kernel
    takes (the JAX side in one compile), and the number of convs each route
    ran on the port's side."""
    ran = {"kernel": 0, "library": 0}
    fused, conv2d = c3.conv3x3_fused, c3.conv2d

    def count(fn, key):
        def run(*args, **kwargs):
            ran[key] += 1
            return fn(*args, **kwargs)
        return run

    c3.conv3x3_fused, c3.conv2d = count(fused, "kernel"), count(conv2d, "library")
    try:
        rng = np.random.default_rng(21)
        img = rng.uniform(-1, 1, size=(1, 16, 24, 3)).astype(np.float32)
        lat = rng.normal(size=(1, 8, 12, 4)).astype(np.float32)
        kl_cfg, tiny_cfg = jreg.VAEConfig(**KL), jreg.TaesdConfig(**TAESD)
        kl_j, kl_t = _bundle(kl_cfg, registry.VAEConfig(**KL), seed=3)
        tiny_j, tiny_t = _bundle(tiny_cfg, registry.TaesdConfig(**TAESD), seed=4)

        @jax.jit
        def reference(z, x):  # the weights as constants, as the other port tests close over them
            return (_decode_and_l1_grad(lambda z: jkl.decode_depth(kl_j, z, kl_cfg), z),
                    _decode_and_l1_grad(lambda z: jtiny.decode_depth(tiny_j, z, tiny_cfg), z),
                    jkl.encode(kl_j, x, kl_cfg))

        kl_ref, tiny_ref, enc_ref = reference(jnp.asarray(lat), jnp.asarray(img))
        cases = {"kl-encode": (enc_ref, kl_t.encode(torch.from_numpy(img)))}
        for name, vae_t, (out_j, dz_j) in (("kl", kl_t, kl_ref), ("taesd", tiny_t, tiny_ref)):
            tz = torch.tensor(lat, requires_grad=True)
            out = vae_t.decode_depth(tz)
            (dz,) = torch.autograd.grad(torch.abs(out - 0.5).sum(), tz)
            cases[f"{name}-decode_depth"] = (out_j, out.detach())
            cases[f"{name}-latent_grad"] = (dz_j, dz)
    finally:
        c3.conv3x3_fused, c3.conv2d = fused, conv2d
    return cases, ran


@pytest.mark.parametrize("case", ["kl-encode", "kl-decode_depth", "kl-latent_grad",
                                  "taesd-decode_depth", "taesd-latent_grad"])
def test_narrow_vae_matches_jax(narrow, case):
    """KL at widths (12, 20) with 4 groups: encode, ``decode_depth`` and the
    latent gradient of an l1 loss on it; TAESD at C=12: ``decode_depth`` and
    its gradient. Every ResNet / Block conv took ``F.conv2d``."""
    cases, ran = narrow
    ref, got = cases[case]
    assert got.shape == ref.shape
    tol = GRADIENT if case.endswith("grad") else FORWARD
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
    # two convs in each KL ResNet: decode 2 (mid) + 2 + 2, encode 1 + 1 + 2;
    # TAESD 2 Blocks of 3 and an up conv
    assert ran == {"kernel": 0, "library": 2 * (6 + 4) + 7}


def test_route_takes_the_kernel_where_it_fits(monkeypatch):
    """A KL decoder at widths (16, 12): the convs with Ci and Co both
    multiples of 8 (16→16, three of them) go to ``conv3x3_fused``, the nine
    others to ``F.conv2d``; the route keeps each conv's function (the
    result equals every conv through the kernel's plain twin)."""
    cfg = registry.VAEConfig(block_out_channels=(16, 12), layers_per_block=1, norm_groups=4)
    vae = make_random_bundle(seed=5, vae_kind="kl", vae_config=cfg, device="cpu").vae
    ran = []
    fused = c3.conv3x3_fused
    monkeypatch.setattr(c3, "conv3x3_fused", lambda x, w, *a, **k: (
        ran.append(tuple(w.shape[:2])), fused(x, w, *a, **k))[1])
    lat = torch.from_numpy(np.random.default_rng(6).normal(size=(1, 6, 8, 4)).astype(np.float32))
    got = vae.decode_depth(lat)
    assert ran == [(16, 16)] * 3
    monkeypatch.undo()
    twin = vae.decode_depth(lat, conv_fn=c3.conv3x3_fused)
    np.testing.assert_allclose(got.numpy(), twin.numpy(), rtol=1e-5, atol=1e-6)


def test_kernel_call_raises_off_the_cpu_where_the_route_does_not(monkeypatch):
    """Off the CPU (a meta tensor stands in for the card's: no kernel is
    built) ``conv3x3_call`` still refuses Ci or Co not a multiple of 8;
    the routed conv reaches it only where ``fits`` holds."""
    with pytest.raises(ValueError, match="divisible by 8"):
        c3.conv3x3_call(torch.empty((1, 4, 4, 12), device="meta"),
                        torch.empty((3, 3, 12, 20), device="meta"))

    def kernel(*args, **kwargs):
        raise AssertionError("the kernel's call")

    monkeypatch.setattr(c3, "conv3x3_call", kernel)
    rng = np.random.default_rng(7)
    for ci, co in ((12, 20), (16, 12), (12, 16)):
        x, skip = (torch.from_numpy(rng.normal(size=(1, 4, 5, c)).astype(np.float32))
                   for c in (ci, co))
        w = torch.from_numpy(rng.normal(size=(co, ci, 3, 3)).astype(np.float32))
        y = c3.conv3x3_routed(x, w, torch.ones(co), relu=True, skip=skip)
        assert y.shape == (1, 4, 5, co)
    with pytest.raises(AssertionError, match="the kernel's call"):
        c3.conv3x3_routed(torch.zeros((1, 4, 5, 16)), torch.zeros((8, 16, 3, 3)))
