"""The sampler's other modes in the port against the JAX package: the KLD
penalty (``kld_stdnorm``, ``compute_loss``, per-step guidance with it), the
LCM schedule, step and sampler, per-input training, and UNet
rematerialisation.

Geometry (as tests/test_torch_sampler.py): 50x80 inputs at processing
resolution 64 → 24x32 latents; tiny UNet and TAESD, fp32, the same weights
on both sides (``from_jax_params``). JAX runs as its own tests run it on
the CPU: ``jax.jit(guided_sample)`` with its plain attention. Tolerances
follow tests/test_pipeline_parity.py: at least 3x above the measured
cross-framework floor, and at least 3x below a planted drift.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_completion_tpu.guidance.losses import compute_loss as j_loss
from depth_completion_tpu.models import registry as jreg
from depth_completion_tpu.models.bundle import VAE as JVAE
from depth_completion_tpu.models.bundle import ModelBundle as JBundle
from depth_completion_tpu.ops.stats import kld_stdnorm as j_kld
from depth_completion_tpu.pipeline import sampler as JS
from depth_completion_tpu.sched import ddim as jd
from depth_completion_tpu.sched import lcm as jl
from depth_completion_tpu_torch.core import prng
from depth_completion_tpu_torch.guidance.losses import compute_loss as t_loss
from depth_completion_tpu_torch.models import registry, unet
from depth_completion_tpu_torch.models.weights import from_jax_params
from depth_completion_tpu_torch.ops.stats import kld_stdnorm as t_kld
from depth_completion_tpu_torch.pipeline import sampler as TS
from depth_completion_tpu_torch.pipeline.programs import ProgramCache
from depth_completion_tpu_torch.sched import ddim as td
from depth_completion_tpu_torch.sched import lcm as tl

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


def _jax_sample(bundles, inputs, **kw):
    jbundle, _ = bundles
    imgs, sparses = inputs
    jfn = jax.jit(JS.guided_sample, static_argnames=("cfg",))
    d, lat = jfn(jbundle, jnp.asarray(imgs), jnp.asarray(sparses), JS.SamplerConfig(**kw))
    return np.asarray(d), np.asarray(lat)


def _port_sample(bundles, inputs, **kw):
    _, tbundle = bundles
    imgs, sparses = inputs
    d, lat = TS.guided_sample(tbundle, torch.from_numpy(imgs), torch.from_numpy(sparses),
                              TS.SamplerConfig(**kw), programs=ProgramCache())
    return d.numpy(), lat.numpy()


def _readings(port, ref):
    dd, ll = port[0] - ref[0], port[1] - ref[1]
    return _rms(dd), float(np.abs(dd).max()), _rms(ll)


# ---------------------------------------------------------------------------
# KLD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("mode", ["simple", "strict"])
def test_kld_stdnorm_matches_jax(mode, reduction):
    """Both modes and the three reductions on latents off N(0, 1) (shifted
    and scaled, so μ, σ² and the log all count): fp32, rtol 1e-6."""
    rng = np.random.default_rng(5)
    x = (0.3 + 1.7 * rng.standard_normal((3, 24, 32, 4))).astype(np.float32)
    got = t_kld(torch.from_numpy(x), reduction, mode).numpy()
    np.testing.assert_allclose(got, np.asarray(j_kld(jnp.asarray(x), reduction, mode)),
                               rtol=1e-6, atol=0)


def test_compute_loss_kld_matches_jax(inputs):
    """``compute_loss`` with the KLD term (strict, weight 0.3) beside l1 and
    l2: fp32 reductions, 1e-6. Without the latents it raises JAX's error."""
    _, sparses = inputs
    rng = np.random.default_rng(11)
    dense = rng.uniform(0, 1, size=sparses.shape).astype(np.float32)
    lat = rng.standard_normal((N, 24, 32, 4)).astype(np.float32)
    kw = dict(kld=True, kld_weight=0.3, kld_mode="strict")
    ref = j_loss(jnp.asarray(dense), jnp.asarray(sparses / 10), jnp.asarray(sparses > 0),
                 ("l1", "l2"), pred_latents=jnp.asarray(lat), **kw)
    got = t_loss(torch.from_numpy(dense), torch.from_numpy(sparses / 10),
                 torch.from_numpy(sparses > 0), ("l1", "l2"), pred_latents=torch.from_numpy(lat),
                 **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="pred_latents must be provided"):
        t_loss(torch.from_numpy(dense), torch.from_numpy(sparses), torch.from_numpy(sparses > 0),
               ("l1",), kld=True)


def test_kld_per_step_matches_jax(bundles, inputs, monkeypatch):
    """3 per-step guided steps with ``kld=True, kld_mode="strict"`` (the
    penalty on the pre-update latent), learned affine, each side drawing its
    noise from the seed; both run a fused epilogue (``DCT_EPILOGUE=on`` on
    the JAX side). Bounds in the style of tests/test_torch_sampler.py's KL
    test (dense rms 1e-4, max 1e-3, latent rms 1e-4): measured floor dense
    rms 2.0e-6, max 5.8e-5, latent rms 5.2e-6; the penalty left out on the
    port side drifts by dense rms 2.7e-3 (limit 3e-4 for the drift)."""
    monkeypatch.setenv("DCT_EPILOGUE", "on")
    kw = dict(steps=3, resolution=64, closed_form=False, max_depth=10.0, kld=True,
              kld_mode="strict")
    ref = _jax_sample(bundles, inputs, **kw)
    d_rms, d_max, l_rms = _readings(_port_sample(bundles, inputs, **kw), ref)
    without = _readings(_port_sample(bundles, inputs, **{**kw, "kld": False}), ref)
    assert d_rms < 1e-4 and d_max < 1e-3 and l_rms < 1e-4, (d_rms, d_max, l_rms)
    assert without[0] > 3e-4, without


# ---------------------------------------------------------------------------
# LCM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 4, 7, 50])
def test_lcm_timesteps_match_jax(steps):
    got = tl.make_lcm_timesteps(1000, steps)
    ref = jl.make_lcm_timesteps(1000, steps)
    assert got.dtype == np.int32 and np.array_equal(got, ref), (got, ref)
    with pytest.raises(ValueError, match="cannot exceed"):
        tl.make_lcm_timesteps(1000, 51)


@pytest.mark.parametrize("last", [False, True], ids=["middle", "last"])
def test_lcm_step_matches_jax(last):
    """One LCM step on the same model output, sample and key: fp32
    elementwise arithmetic, 1e-6 (the middle step re-noises with the key's
    normal draw, the last returns the denoised estimate)."""
    rng = np.random.default_rng(3)
    out, x = (rng.standard_normal((2, 6, 8, 4)).astype(np.float32) for _ in range(2))
    ts = tl.make_lcm_timesteps(1000, 4)
    i = 3 if last else 1
    t, prev_t = int(ts[i]), (-1 if last else int(ts[i + 1]))
    key = jax.random.split(jax.random.PRNGKey(9))[1]
    got = tl.lcm_step(td.make_schedule(), torch.from_numpy(out), t, prev_t, torch.from_numpy(x),
                      prng.split(prng.PRNGKey(9))[1], last)
    ref = jl.lcm_step(jd.make_schedule(), jnp.asarray(out), jnp.asarray(t), jnp.asarray(prev_t),
                      jnp.asarray(x), key, jnp.asarray(last))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


def test_lcm_sampler_matches_jax(bundles, inputs, monkeypatch):
    """3 LCM steps, ``train_latents=False`` (closed-form affine), each side
    drawing the initial noise and the two re-noises from the seed: the
    streams match, so the forward-only bounds of JAX's
    ``test_lcm_single_step`` hold (dense rms 1e-4, max 5e-4, latent rms
    1e-4; measured 6.4e-7, 2.9e-6, 3.9e-7). Re-noising with another key
    chain on the port side (the program's re-noise table drawn from a seed
    folded in) reads dense rms 0.52."""
    kw = dict(steps=3, resolution=64, train_latents=False, scheduler="lcm", max_depth=10.0)
    ref = _jax_sample(bundles, inputs, **kw)
    d_rms, d_max, l_rms = _readings(_port_sample(bundles, inputs, **kw), ref)
    assert d_rms < 1e-4 and d_max < 5e-4 and l_rms < 1e-4, (d_rms, d_max, l_rms)
    renoise = TS.lcm_renoise
    monkeypatch.setattr(TS, "lcm_renoise", lambda seed, *a: renoise(prng.fold_in(
        prng.PRNGKey(seed), 1)[1], *a))
    other = _readings(_port_sample(bundles, inputs, **kw), ref)
    assert other[0] > 3e-4, other


# ---------------------------------------------------------------------------
# Per-input training
# ---------------------------------------------------------------------------

def test_per_input_sampler_matches_jax(bundles, inputs, monkeypatch):
    """Per-input training: 2 plain DDIM steps, then 3 Adam steps on the
    latent and the learned affine through the unclamped decode. No ε-norm
    rescale, so the port stays far closer to JAX than the JAX package's own
    torch counterpart (1.5e-3, 2e-2, 5e-3): limits dense rms 1e-5, max 1e-4,
    latent rms 1e-5 over a measured floor of 4.9e-7, 2.5e-6, 1.0e-6. The
    clamp turned on before the loss changes nothing here (the prediction
    stays inside [0, 1] over 3 steps); the planted drift is the original
    PyTorch Marigold-DC's stale latent (the latent's learning rate 0, only
    the affine trains): dense rms 7.1e-2."""
    kw = dict(steps=2, resolution=64, closed_form=False, max_depth=10.0,
              train_method="per-input", train_steps=3)
    ref = _jax_sample(bundles, inputs, **kw)
    d_rms, d_max, l_rms = _readings(_port_sample(bundles, inputs, **kw), ref)
    assert d_rms < 1e-5 and d_max < 1e-4 and l_rms < 1e-5, (d_rms, d_max, l_rms)
    fixed = TS.FixedOptimizer
    monkeypatch.setattr(TS, "FixedOptimizer",
                        lambda opt, params, lrs, n: fixed(opt, params, [0.0, *lrs[1:]], n))
    stale = _readings(_port_sample(bundles, inputs, **kw), ref)
    assert stale[0] > 3e-5, stale


# ---------------------------------------------------------------------------
# UNet rematerialisation
# ---------------------------------------------------------------------------

def test_remat_step_equals_no_remat(bundles, inputs, monkeypatch):
    """One guided step's losses and gradients (latent, affine) with the
    UNet's stages rematerialised equal those without, to 1e-6: the
    recompute runs the same fp32 ops on the same inputs. The up stages'
    skips detached under remat (the forward unchanged, no gradient into the
    down path through them) fail it."""
    _, tbundle = bundles
    imgs, sparses = inputs
    images, sp = torch.from_numpy(imgs), torch.from_numpy(sparses)
    results = []
    for remat in ("on", "off", "detached skips"):
        if remat == "detached skips":
            up = unet._up_stage
            monkeypatch.setattr(unet, "_up_stage", lambda stage, h, skips, *a: up(
                stage, h, [x.detach() for x in skips], *a))
            remat = "on"
        cfg = TS.SamplerConfig(steps=5, resolution=64, closed_form=False, max_depth=10.0,
                               remat_unet=remat)
        img_lat, lat0, dn, padding, orig_res = TS._prepare(tbundle, images, sp, cfg, None)
        lat = lat0.clone().requires_grad_(True)
        aff = [torch.ones((N, 1, 1, 1), requires_grad=True),
               torch.zeros((N, 1, 1, 1), requires_grad=True)]
        denoise = TS._Denoiser(tbundle, img_lat, TS.flash_attention,
                               TS.resolve_remat(cfg, N, tuple(img_lat.shape[1:3]), images.device))
        assert denoise.remat == (remat == "on")
        losses, out, grads = TS.guided_step_grads(
            denoise, functools.partial(TS.decode_prediction, tbundle),
            TS.make_schedule(cfg.ddim), cfg, dn, images, orig_res, padding, False, lat, aff, 999)
        results.append((losses, out, *grads))
    for a, b in zip(results[0], results[1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    for a, b in zip(results[1][:2], results[2][:2]):  # losses and UNet output: the forward
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    g, g_bad = results[1][2], results[2][2]
    assert float((g - g_bad).norm() / g.norm()) > 1e-2


def test_remat_sampler_matches_jax(bundles, inputs):
    """2 per-step guided steps with ``remat_unet="on"`` on both sides,
    learned affine, noise from the seed: dense rms 1e-4, max 1e-3, latent
    rms 1e-4 over a measured floor of 2.6e-7, 1.2e-6, 5.4e-7; the port with a
    UNet-detached gradient drifts by dense rms 2.0e-2. An unknown value
    raises JAX's ``ValueError``; "auto" is off on the CPU."""
    kw = dict(steps=2, resolution=64, closed_form=False, max_depth=10.0, remat_unet="on")
    ref = _jax_sample(bundles, inputs, **kw)
    d_rms, d_max, l_rms = _readings(_port_sample(bundles, inputs, **kw), ref)
    assert d_rms < 1e-4 and d_max < 1e-3 and l_rms < 1e-4, (d_rms, d_max, l_rms)
    drift = _readings(_port_sample(bundles, inputs, **kw, detach_unet_grad=True), ref)
    assert drift[0] > 3e-4, drift
    with pytest.raises(ValueError, match="remat_unet must be"):
        _port_sample(bundles, inputs, **{**kw, "remat_unet": "bogus"})
    assert not TS.resolve_remat(TS.SamplerConfig(), 64, (128, 128), torch.device("cpu"))
