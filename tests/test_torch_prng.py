"""The port's threefry (``core/prng.py``) against ``jax.random`` with JAX's
defaults (partitionable threefry2x32, 64-bit mode off), and the sampler's
initial noise: one seed gives one starting latent, and one depth map, on
both sides.

``random_bits``, ``split`` and ``uniform`` are bit for bit. ``normal``
carries XLA's ``ErfInv32`` polynomial; XLA's own ``log`` rounds otherwise
for some inputs, and the measured reading is at most 3 float32 ulp
(2.4e-7) on about 1% of the words, the limit held here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_completion_tpu.models import registry as jreg
from depth_completion_tpu.models.bundle import VAE as JVAE
from depth_completion_tpu.models.bundle import ModelBundle as JBundle
from depth_completion_tpu.pipeline import sampler as JS
from depth_completion_tpu_torch.core import prng
from depth_completion_tpu_torch.models import registry
from depth_completion_tpu_torch.models.weights import from_jax_params
from depth_completion_tpu_torch.pipeline import sampler as TS
from depth_completion_tpu_torch.pipeline.programs import ProgramCache

from tests.test_torch_weights import tiny_jax_trees

SEEDS = (0, 1, 2024, 2**31 + 5)
SHAPES = ((1, 24, 32, 4), (1, 72, 96, 4))
NORMAL_ULP, NORMAL_SHARE = 3, 0.02


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_bit_exact(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(jax.random.key_data(key)))
    for num in (2, 3):
        np.testing.assert_array_equal(
            prng.split(prng.PRNGKey(seed), num), np.asarray(jax.random.split(key, num)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_normal(seed, shape):
    """bits and uniform bit for bit; normal within NORMAL_ULP ulp on at
    most NORMAL_SHARE of the words, on the sampler's own key (the second
    half of a split)."""
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    pkey = prng.split(prng.PRNGKey(seed))[1]
    np.testing.assert_array_equal(prng.random_bits(pkey, shape),
                                  np.asarray(jax.random.bits(key, shape)))
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u_j = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, 1.0))
    np.testing.assert_array_equal(prng.uniform(pkey, shape, lo, 1.0).view(np.uint32),
                                  u_j.view(np.uint32))
    n_j = np.asarray(jax.random.normal(key, shape))
    n_p = prng.normal(pkey, shape)
    assert n_p.dtype == np.float32 and n_p.shape == shape
    ulp = np.abs(n_j.view(np.int32).astype(np.int64) - n_p.view(np.int32))
    assert ulp.max() <= NORMAL_ULP and (ulp > 0).mean() <= NORMAL_SHARE, (
        ulp.max(), (ulp > 0).mean())


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bit_exact(seed):
    """``fold_in`` of the sampler's noise key (the ensemble's member keys)
    and of a raw seed key, for member indices and data at the 32-bit edges."""
    for key, pkey in ((jax.random.split(jax.random.PRNGKey(seed))[1],
                       prng.split(prng.PRNGKey(seed))[1]),
                      (jax.random.PRNGKey(seed), prng.PRNGKey(seed))):
        for data in (0, 1, 2, 4, 7, 2**31 + 3, 2**32 - 1):
            np.testing.assert_array_equal(
                prng.fold_in(pkey, data),
                np.asarray(jax.random.key_data(jax.random.fold_in(key, data))))


def test_erfinv_edges():
    x = np.array([-1.0, 0.0, 1.0, 0.5, -0.999], np.float32)
    got = prng.erfinv(x)
    assert got[0] == -np.inf and got[1] == 0.0 and got[2] == np.inf
    np.testing.assert_allclose(got[3:], np.asarray(jax.lax.erf_inv(jnp.asarray(x[3:]))),
                               rtol=1e-6)


N, H, W = 2, 50, 80


@pytest.fixture(scope="module")
def bundles():
    unet_np, taesd_np, ctx = tiny_jax_trees(seed=3)
    jbundle = JBundle(
        unet_params=jax.tree.map(jnp.asarray, unet_np),
        unet_config=jreg.TINY_UNET_CONFIG,
        vae=JVAE(kind="tiny", params=jax.tree.map(jnp.asarray, taesd_np),
                 config=jreg.TINY_TAESD_CONFIG),
        text_context=jnp.asarray(ctx),
    )
    tbundle = from_jax_params(
        unet_np, taesd_np, ctx, unet_config=registry.TINY_UNET_CONFIG,
        vae_config=registry.TINY_TAESD_CONFIG, device="cpu",
    )
    return jbundle, tbundle


def test_guided_sample_seed_noise_matches_jax(bundles):
    """No ``init_noise``: each side draws its own noise from the seed (2024).
    Three guided steps with a learned affine: the dense maps and latents
    agree within the tolerance model of tests/test_pipeline_parity.py (the
    bounds of tests/test_torch_sampler.py, there with injected noise); the
    port's draw from another seed lies far outside them."""
    jbundle, tbundle = bundles
    rng = np.random.default_rng(7)
    imgs = rng.uniform(0, 255, size=(N, H, W, 3)).astype(np.float32)
    sparses = np.zeros((N, H * W), np.float32)
    for i in range(N):
        idx = rng.choice(H * W, size=64, replace=False)
        sparses[i, idx] = rng.uniform(0.5, 9.5, size=64).astype(np.float32)
    sparses = sparses.reshape(N, H, W, 1)
    kw = dict(steps=3, resolution=64, closed_form=False, max_depth=10.0)
    jfn = jax.jit(JS.guided_sample, static_argnames=("cfg",))
    d_j, l_j = jfn(jbundle, jnp.asarray(imgs), jnp.asarray(sparses), JS.SamplerConfig(**kw))
    d_j, l_j = np.asarray(d_j), np.asarray(l_j)

    def port(seed):
        d, lat = TS.guided_sample(tbundle, torch.from_numpy(imgs), torch.from_numpy(sparses),
                                  TS.SamplerConfig(seed=seed, **kw), programs=ProgramCache())
        return d.numpy() - d_j, lat.numpy() - l_j

    def rms(x):
        return float(np.sqrt(np.mean(x**2)))

    dd, ll = port(2024)
    assert rms(dd) < 1.2e-2 and np.abs(dd).max() < 0.15 and rms(ll) < 3.5e-2, (
        rms(dd), np.abs(dd).max(), rms(ll))
    _, ll_other = port(2025)
    assert rms(ll_other) > 10 * 3.5e-2, rms(ll_other)
