"""The port's ensembles (``parallel.ensemble``) against the JAX package's
``ensemble_sample``, ``align_members`` and ``jnp.median``: a 3-member
ensemble end to end (member noise from ``fold_in``), the four reduces and
the uncertainty at an odd and an even member count, and E=1 against the
plain request.

Geometry as tests/test_torch_modes.py: 50x80 inputs at resolution 64,
tiny UNet and TAESD in fp32, the same weights on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_completion_tpu.models import registry as jreg
from depth_completion_tpu.models.bundle import VAE as JVAE
from depth_completion_tpu.models.bundle import ModelBundle as JBundle
from depth_completion_tpu.parallel import ensemble as JE
from depth_completion_tpu.pipeline import sampler as JS
from depth_completion_tpu_torch.models import registry
from depth_completion_tpu_torch.models.weights import from_jax_params
from depth_completion_tpu_torch.parallel import ensemble as TE
from depth_completion_tpu_torch.pipeline import sampler as TS
from depth_completion_tpu_torch.pipeline.programs import ProgramCache

from tests.test_torch_weights import tiny_jax_trees

N, H, W = 2, 50, 80


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


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


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    imgs = rng.uniform(0, 255, size=(N, H, W, 3)).astype(np.float32)
    sparses = np.zeros((N, H * W), np.float32)
    for i in range(N):
        idx = rng.choice(H * W, size=64, replace=False)
        sparses[i, idx] = rng.uniform(0.5, 9.5, size=64).astype(np.float32)
    return imgs, sparses.reshape(N, H, W, 1)


def _rms(x):
    return float(np.sqrt(np.mean(np.square(x))))


def test_ensemble_matches_jax(bundles, inputs):
    """E=3, ``train_latents=False``, ``aligned-median`` with the
    uncertainty, each side drawing the member noise from the seed (member m
    > 0 from ``fold_in``): forward only, so the bounds of the no-train
    sampler test (rms 1e-4, max 5e-4) hold for the members, the reduced
    map and the MAD (measured rms 5.2e-7 to 7.2e-7, max 2.4e-6). The
    members differ from one another."""
    jbundle, tbundle = bundles
    imgs, sparses = inputs
    cfg = dict(steps=2, resolution=64, train_latents=False, max_depth=10.0)
    fn = jax.jit(JE.ensemble_sample,
                 static_argnames=("cfg", "ensemble_size", "reduce", "return_uncertainty"))
    ref = fn(jbundle, jnp.asarray(imgs), jnp.asarray(sparses), JS.SamplerConfig(**cfg),
             ensemble_size=3, reduce="aligned-median", return_uncertainty=True)
    got = TE.ensemble_sample(tbundle, torch.from_numpy(imgs), torch.from_numpy(sparses),
                             TS.SamplerConfig(**cfg), 3, "aligned-median",
                             return_uncertainty=True, programs=ProgramCache())
    for name, g, r in zip(("denses", "members", "mad"), got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape, (name, g.shape, r.shape)
        assert _rms(g - r) < 1e-4 and np.abs(g - r).max() < 5e-4, name
    members = got[1].numpy()
    assert np.abs(members[:, 0] - members[:, 1]).max() > 1e-2
    assert (got[2].numpy() >= 0).all()


@pytest.mark.parametrize("e", [3, 4])
def test_reduces_match_jax(e):
    """The four reduces and their MAD on one fixed member array [2,E,7,9,1]
    against ``jnp.median`` / ``jnp.mean`` and JAX's ``align_members``: 1e-4
    m (measured: the plain reduces exact to 3.8e-6, the aligned ones
    1.1e-5, fp32 least squares in another order). At E=4 the median
    averages the two middle members, as ``jnp.median`` does;
    ``torch.median`` returns the lower one, 25 m off here."""
    rng = np.random.default_rng(e)
    members = rng.uniform(1.0, 80.0, size=(2, e, 7, 9, 1)).astype(np.float32)
    t = torch.from_numpy(members)
    for reduce in TE.ENSEMBLE_REDUCES:
        over = JE.align_members(jnp.asarray(members)) if reduce.startswith("aligned-") else \
            jnp.asarray(members)
        ref = jnp.median(over, axis=1) if reduce.endswith("median") else jnp.mean(over, axis=1)
        mad = jnp.median(jnp.abs(over - ref[:, None]), axis=1)
        got, got_mad = TE.reduce_members(t, reduce, return_uncertainty=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4, err_msg=reduce)
        np.testing.assert_allclose(got_mad.numpy(), np.asarray(mad), rtol=0, atol=1e-4,
                                   err_msg=reduce)
    lower = torch.median(t, dim=1).values.numpy()
    gap = np.abs(lower - np.asarray(jnp.median(jnp.asarray(members), axis=1))).max()
    assert (gap > 1.0) if e % 2 == 0 else (gap == 0.0), gap


def test_ensemble_of_one_is_the_plain_request(bundles, inputs):
    """E=1: member 0's noise is the plain path's, so the reduced map equals
    ``guided_sample``'s (the same ops on the same inputs: 1e-6)."""
    _, tbundle = bundles
    imgs, sparses = inputs
    cfg = TS.SamplerConfig(steps=2, resolution=64, closed_form=False, max_depth=10.0)
    images, sp = torch.from_numpy(imgs), torch.from_numpy(sparses)
    denses, members = TE.ensemble_sample(tbundle, images, sp, cfg, 1, programs=ProgramCache())
    plain, _ = TS.guided_sample(tbundle, images, sp, cfg, programs=ProgramCache())
    torch.testing.assert_close(denses, plain, rtol=1e-6, atol=1e-6)
    assert tuple(members.shape) == (N, 1, H, W, 1)
    with pytest.raises(ValueError, match="Unknown ensemble reduce"):
        TE.ensemble_sample(tbundle, images, sp, cfg, 2, "bogus", programs=ProgramCache())
