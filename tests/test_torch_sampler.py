"""The port's guided sampler and pipeline against the JAX package: one
guided step at the gradient level, the no-train branch, three per-step
guided steps end to end, and the pipeline's validation errors.

Geometry: 50x80 inputs at processing resolution 64 → 40x64 (a 1.25 ratio,
so the exact jax-compatible resize matters) → edge-padded to 48x64 → TAESD
downsample 2 → 24x32 latents; tiny UNet and TAESD, fp32, same weights on
both sides (``from_jax_params``), same injected noise.
"""

import functools
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from depth_completion_tpu.guidance.projection import normalize_sparse as j_normalize
from depth_completion_tpu.models import registry as jreg
from depth_completion_tpu.models.bundle import VAE as JVAE
from depth_completion_tpu.models.bundle import ModelBundle as JBundle
from depth_completion_tpu.models.unet import apply_unet as j_apply_unet
from depth_completion_tpu.pipeline import sampler as JS
from depth_completion_tpu.pipeline.preprocess import preprocess_images as j_preprocess
from depth_completion_tpu.sched.ddim import make_schedule as j_make_schedule
from depth_completion_tpu.sched.ddim import pred_original as j_pred_original
from depth_completion_tpu_torch.models import registry
from depth_completion_tpu_torch.models.weights import from_jax_params
from depth_completion_tpu_torch.pipeline import pipeline as tpipe
from depth_completion_tpu_torch.pipeline import sampler as TS
from depth_completion_tpu_torch.pipeline.programs import ProgramCache

from tests.test_torch_weights import tiny_jax_trees


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small CPU shapes: two threads, restored after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)
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


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    imgs = rng.uniform(0, 255, size=(N, H, W, 3)).astype(np.float32)
    sparses = np.zeros((N, H * W), np.float32)
    for i in range(N):
        idx = rng.choice(H * W, size=64, replace=False)
        sparses[i, idx] = rng.uniform(0.5, 9.5, size=64).astype(np.float32)
    noise = rng.standard_normal((N, 24, 32, 4)).astype(np.float32)
    return imgs, sparses.reshape(N, H, W, 1), noise


def test_one_guided_step_matches_jax(bundles, inputs):
    """One per-step iteration up to the gradients (before the ε-norm rescale
    amplifies fp32 reduction-order noise): per-sample losses to 1e-5,
    affine gradients to 1e-4, latent-gradient direction to cosine 0.999
    (as tests/test_pipeline_parity.py holds the JAX package's step)."""
    jbundle, tbundle = bundles
    imgs, sparses, noise = inputs
    t0 = 999
    jcfg = JS.SamplerConfig(steps=5, resolution=64, closed_form=False, max_depth=10.0)

    static = {}

    @jax.jit
    def encode(imgs):  # one program, not op by op; the padding is static
        x, static["pad"], _ = j_preprocess(imgs, 64)
        return jbundle.vae.encode(x)

    lat_img_j = encode(jnp.asarray(imgs))
    pad_j = static["pad"]
    dn = j_normalize(jnp.asarray(sparses), norm="minmax", projection="linear", inv=False,
                     min_depth=0.0, max_depth=10.0)
    sched_j = j_make_schedule()

    @jax.jit
    def loss_and_grads(params):
        def loss_fn(p):
            lat = p["latents"]
            xin = jnp.concatenate([lat_img_j, lat], axis=-1)
            ctx = jnp.broadcast_to(jbundle.text_context, (N,) + jbundle.text_context.shape[1:])
            out = j_apply_unet(jbundle.unet_params, xin, jnp.asarray(t0), ctx, jbundle.unet_config)
            x0 = j_pred_original(sched_j, out, jnp.asarray(t0), lat)
            losses = JS._guidance_loss(jbundle, jcfg, dn, jnp.asarray(imgs), (H, W), pad_j,
                                       False, x0, p["affine"], lat)
            return jnp.sum(losses), losses

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, losses_j), grads_j = loss_and_grads({
        "latents": jnp.asarray(noise),
        "affine": {"scale": jnp.ones((N, 1, 1, 1)), "shift": jnp.zeros((N, 1, 1, 1))},
    })

    tcfg = TS.SamplerConfig(steps=5, resolution=64, closed_form=False, max_depth=10.0)
    images, sp = torch.from_numpy(imgs), torch.from_numpy(sparses)
    img_lat, lat0, tdn, padding, orig_res = TS._prepare(
        tbundle, images, sp, tcfg, None, init_noise=torch.from_numpy(noise))
    lat = lat0.clone().requires_grad_(True)
    aff = [torch.ones((N, 1, 1, 1), requires_grad=True), torch.zeros((N, 1, 1, 1), requires_grad=True)]
    losses_t, _, grads_t = TS.guided_step_grads(
        TS._Denoiser(tbundle, img_lat, TS.flash_attention),
        functools.partial(TS.decode_prediction, tbundle), TS.make_schedule(tcfg.ddim), tcfg,
        tdn, images, orig_res, padding, False, lat, aff, t0)

    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=1e-5, atol=1e-6)
    for g_t, key in zip(grads_t[1:], ("scale", "shift")):
        np.testing.assert_allclose(g_t.numpy().ravel(), np.asarray(grads_j["affine"][key]).ravel(),
                                   rtol=1e-4, atol=1e-6)
    g_j, g_t = np.asarray(grads_j["latents"]).ravel(), grads_t[0].numpy().ravel()
    cos = float(g_j @ g_t / (np.linalg.norm(g_j) * np.linalg.norm(g_t)))
    assert cos > 0.999, f"latent gradient cosine {cos}"
    assert abs(np.linalg.norm(g_t) / np.linalg.norm(g_j) - 1.0) < 0.01


@pytest.fixture(scope="module")
def kl_bundles():
    unet_np, vae_np, ctx = tiny_jax_trees(vae_config=jreg.TINY_VAE_CONFIG, seed=4)
    jbundle = JBundle(
        unet_params=jax.tree.map(jnp.asarray, unet_np),
        unet_config=jreg.TINY_UNET_CONFIG,
        vae=JVAE(kind="kl", params=jax.tree.map(jnp.asarray, vae_np),
                 config=jreg.TINY_VAE_CONFIG),
        text_context=jnp.asarray(ctx),
    )
    tbundle = from_jax_params(
        unet_np, vae_np, ctx, unet_config=registry.TINY_UNET_CONFIG,
        vae_config=registry.TINY_VAE_CONFIG, device="cpu",
    )
    return jbundle, tbundle


def _run_both(bundles, inputs, **cfg_kwargs):
    """→ (dense, latent) differences port - JAX, and the port's dense map."""
    jbundle, tbundle = bundles
    imgs, sparses, noise = inputs
    jfn = jax.jit(JS.guided_sample, static_argnames=("cfg",))
    d_j, l_j = jfn(jbundle, jnp.asarray(imgs), jnp.asarray(sparses),
                   JS.SamplerConfig(**cfg_kwargs), init_noise=jnp.asarray(noise))
    d_t, l_t = TS.guided_sample(tbundle, torch.from_numpy(imgs), torch.from_numpy(sparses),
                                TS.SamplerConfig(**cfg_kwargs), init_noise=torch.from_numpy(noise),
                                programs=ProgramCache())
    return d_t.numpy() - np.asarray(d_j), l_t.numpy() - np.asarray(l_j), d_t


def _rms(x):
    return float(np.sqrt(np.mean(x**2)))


def test_no_train_matches_jax(bundles, inputs):
    """train_latents=False: DDIM denoise + closed-form affine, forward only:
    near-machine bounds (tests/test_pipeline_parity.py uses the same)."""
    dd, ll, _ = _run_both(bundles, inputs, steps=3, resolution=64, train_latents=False,
                          max_depth=10.0)
    assert _rms(dd) < 1e-4 and np.abs(dd).max() < 5e-4 and _rms(ll) < 1e-4, (
        _rms(dd), np.abs(dd).max(), _rms(ll))


def test_three_guided_steps_match_jax(bundles, inputs):
    """Per-step guidance, learned affine, 3 steps, identical init noise.
    The ε-norm rescale amplifies fp32 backward noise through UNet + decode,
    so the bounds are statistical: those of tests/test_pipeline_parity.py
    (≥3x above the measured cross-framework floor, ≥3x below injected-bug
    drift)."""
    dd, ll, _ = _run_both(bundles, inputs, steps=3, resolution=64, closed_form=False,
                          max_depth=10.0)
    assert _rms(dd) < 1.2e-2 and np.abs(dd).max() < 0.15 and _rms(ll) < 3.5e-2, (
        _rms(dd), np.abs(dd).max(), _rms(ll))


def test_three_guided_steps_kl_match_jax(kl_bundles, inputs, monkeypatch):
    """The KL VAE (``--vae original``) on the guidance path: 3 per-step
    guided steps, learned affine. The port runs its fused epilogue, the JAX
    package its own (``DCT_EPILOGUE=on``: its XLA form off the TPU); the
    TAESD test above holds the port against JAX's default optax chain. At
    this geometry the cross-framework floor is ~1e-6 (dense rms), and a
    UNet-detached gradient on the port side, checked here too, drifts by
    ~0.1: the bounds sit ~100x above the one and ~1000x below the other."""
    monkeypatch.setenv("DCT_EPILOGUE", "on")
    kw = dict(steps=3, resolution=64, closed_form=False, max_depth=10.0)
    dd, ll, d_ok = _run_both(kl_bundles, inputs, **kw)
    assert _rms(dd) < 1e-4 and np.abs(dd).max() < 1e-3 and _rms(ll) < 1e-4, (
        _rms(dd), np.abs(dd).max(), _rms(ll))
    imgs, sparses, noise = inputs
    d_bug, _ = TS.guided_sample(kl_bundles[1], torch.from_numpy(imgs), torch.from_numpy(sparses),
                                TS.SamplerConfig(**kw, detach_unet_grad=True),
                                init_noise=torch.from_numpy(noise), programs=ProgramCache())
    assert _rms(d_bug.numpy() - d_ok.numpy()) > 3e-2


def test_fused_adam_matches_eager_chain(monkeypatch):
    """The fused Adam branch (``FusedStepProgram``: the epilogue's state m,
    v and its table row per step; the affine's Adam as tensor ops) against
    the eager chain (one two-group Adam) over the same gradients, 4 steps,
    v- and ε-prediction: fp32, norms summed in another order (1e-5). The
    program's steps run eagerly here (the CPU) with its gradients
    injected."""
    from tests.test_torch_programs import _eager_steps  # the former loop

    rng = np.random.default_rng(21)
    shape, n = (2, 6, 8, 4), 2
    steps = [(rng.standard_normal(shape).astype(np.float32) * 1e-3,
              rng.standard_normal(shape).astype(np.float32),
              rng.standard_normal((n, 1, 1, 1)).astype(np.float32),
              rng.standard_normal((n, 1, 1, 1)).astype(np.float32)) for _ in range(4)]
    lat0 = rng.standard_normal(shape).astype(np.float32)
    # 48x64 frames at res 64 and an 8x downsample: 6x8 latents
    vae = types.SimpleNamespace(downsample_factor=8,
                                config=types.SimpleNamespace(latent_channels=4))
    bundle = types.SimpleNamespace(text_context=torch.zeros((1, 2, 8)), dtype=torch.float32,
                                   model_group=None, vae=vae)
    for ptype in ("v_prediction", "epsilon"):
        cfg = TS.SamplerConfig(steps=4, resolution=64, ddim=TS.DDIMConfig(prediction_type=ptype))
        sched = TS.make_schedule(cfg.ddim)
        ts = [int(t) for t in TS.make_timesteps(cfg.ddim, cfg.steps)]

        def injected():
            it = iter(steps)

            def step(*args, **kwargs):
                g, out, gs, gb = (torch.from_numpy(x) for x in next(it))
                return None, out, (g, gs, gb)

            return step

        monkeypatch.setattr(TS, "guided_step_grads", injected())
        program = TS.FusedStepProgram(bundle, cfg, sched, False, torch.zeros((n, 48, 64, 3)),
                                      torch.zeros((n, 48, 64, 1)))
        program.latents.copy_(torch.from_numpy(lat0))
        program.reset_state()
        for k in range(cfg.steps):
            program.step_eager(k)
        fused = [program.latents] + program.affine
        latents = torch.tensor(lat0, requires_grad=True)
        aff = [torch.ones((n, 1, 1, 1), requires_grad=True),
               torch.zeros((n, 1, 1, 1), requires_grad=True)]
        with torch.no_grad():
            _eager_steps(injected(), sched, cfg, ts, latents, aff)
        for a, b in zip(fused, [latents.detach()] + [p.detach() for p in aff]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_pipeline_validation(bundles, inputs, monkeypatch):
    _, tbundle = bundles
    imgs, sparses, _ = inputs
    pipe = tpipe.DepthCompletionPipeline(tbundle)
    seen = {}
    monkeypatch.setattr(tpipe, "guided_sample",
                        lambda b, i, s, cfg, prev, programs: seen.setdefault("cfg", cfg)
                        and (i, prev))
    with pytest.raises(ValueError, match="matching"):
        pipe(imgs, sparses[:, :-1], max_depth=10.0)
    empty = sparses.copy()
    empty[1] = 0.0
    with pytest.raises(ValueError, match="No valid values"):
        pipe(imgs, empty, max_depth=10.0)
    flat = np.where(sparses > 0, 3.0, 0.0).astype(np.float32)
    with pytest.raises(ValueError, match="Degenerate"):
        pipe(imgs, flat, max_depth=10.0, norm="minmax")
    pipe(imgs, flat, max_depth=10.0, norm="const")  # const has no range to collapse
    with pytest.raises(ValueError, match="pred_latents_prev"):
        pipe(imgs, sparses, max_depth=10.0, resolution=64,
             pred_latents_prev=np.zeros((N, 24, 31, 4), np.float32))
    seen.clear()
    pipe(imgs, sparses, max_depth=10.0, resolution=64, lr=(0.1, 0.01),
         loss_funcs=["l1"], pred_latents_prev=np.zeros((N, 24, 32, 4), np.float32))
    assert (seen["cfg"].lr_latent, seen["cfg"].lr_scaling) == (0.1, 0.01)
    assert seen["cfg"].loss_funcs == ("l1",)
    # ensembles: no temporal carry (JAX's error), raised before any sampling
    with pytest.raises(ValueError, match="temporal latent carry is not supported"):
        pipe(imgs, sparses, max_depth=10.0, resolution=64, ensemble_size=3,
             pred_latents_prev=np.zeros((N, 24, 32, 4), np.float32))


def test_ddim_schedule_and_step_match_jax():
    """make_timesteps (trailing), ᾱ table, x̂₀ / ε̂ and one DDIM step."""
    from depth_completion_tpu.sched import ddim as jd
    from depth_completion_tpu_torch.sched import ddim as td

    assert np.array_equal(td.make_timesteps(td.DDIMConfig(), 50),
                          jd.make_timesteps(jd.DDIMConfig(), 50))
    js, ts = jd.make_schedule(), td.make_schedule()
    np.testing.assert_array_equal(ts.alphas_cumprod, np.asarray(js.alphas_cumprod))
    rng = np.random.default_rng(9)
    out, x = (rng.normal(size=(2, 4, 6, 4)).astype(np.float32) for _ in range(2))
    for t in (999, 19, 0):
        got = td.ddim_step(ts, torch.from_numpy(out), t, torch.from_numpy(x), 50)
        ref = jd.ddim_step(js, jnp.asarray(out), jnp.asarray(t), jnp.asarray(x), 50)
        for g, r in zip(got, ref):  # fp32 elementwise arithmetic
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            td.pred_epsilon(ts, torch.from_numpy(out), t, torch.from_numpy(x)).numpy(),
            np.asarray(jd.pred_epsilon(js, jnp.asarray(out), jnp.asarray(t), jnp.asarray(x))),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "norm,projection,inv",
    [("const", "linear", False), ("minmax", "log", False), ("percentile", "linear", True)],
)
def test_normalize_sparse_matches_jax(inputs, norm, projection, inv):
    from depth_completion_tpu_torch.guidance.projection import normalize_sparse

    _, sparses, _ = inputs
    kw = dict(norm=norm, projection=projection, inv=inv, min_depth=0.1, max_depth=10.0,
              percentile=(0.05, 0.95))
    ref = j_normalize(jnp.asarray(sparses), **kw)
    got = normalize_sparse(torch.from_numpy(sparses), **kw)
    for name in ("sparses_normed", "min_depths", "max_depths", "min_proj", "max_proj"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_losses_match_jax(inputs):
    """compute_loss with all four terms on NHWC inputs (fp32 reductions)."""
    from depth_completion_tpu.guidance.losses import compute_loss as jloss
    from depth_completion_tpu_torch.guidance.losses import compute_loss as tloss

    imgs, sparses, _ = inputs
    rng = np.random.default_rng(11)
    dense = rng.uniform(0, 1, size=sparses.shape).astype(np.float32)
    funcs = ("l1", "l2", "edge", "smooth")
    ref = jloss(jnp.asarray(dense), jnp.asarray(sparses / 10), jnp.asarray(sparses > 0), funcs,
                images=jnp.asarray(imgs / 255))
    got = tloss(torch.from_numpy(dense), torch.from_numpy(sparses / 10),
                torch.from_numpy(sparses > 0), funcs, images=torch.from_numpy(imgs / 255))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("grad_scale", [1.0, 1e-3, 1e-5])
@pytest.mark.parametrize("opt", ["adam", "sgd", "adagrad"])
def test_optimizers_match_optax(opt, grad_scale):
    """Two updates of the two-group optimizer (latent and affine lrs), with
    gradients near 1, and near 1e-3 and 1e-5 as per-input training hands
    them over unrescaled (at 1e-5 Adagrad's eps inside the root, optax's
    rule, and outside it, torch's, part)."""
    import optax

    from depth_completion_tpu.guidance.optim import make_optimizer as joptim
    from depth_completion_tpu_torch.guidance.optim import make_optimizer as toptim

    rng = np.random.default_rng(12)
    lat, scale = rng.normal(size=(2, 3, 4, 4)).astype(np.float32), np.ones((2, 1, 1, 1), np.float32)
    grads = [((grad_scale * rng.normal(size=lat.shape)).astype(np.float32),
              (grad_scale * rng.normal(size=scale.shape)).astype(np.float32)) for _ in range(2)]
    params = {"latents": jnp.asarray(lat), "affine": {"scale": jnp.asarray(scale)}}
    tx = joptim(opt, 0.05, 0.005)
    state = tx.init(params)
    tl, ts = torch.tensor(lat), torch.tensor(scale)
    topt = toptim(opt, tl, [ts], 0.05, 0.005)
    for gl, gs in grads:
        upd, state = tx.update({"latents": jnp.asarray(gl), "affine": {"scale": jnp.asarray(gs)}},
                               state, params)
        params = optax.apply_updates(params, upd)
        tl.grad, ts.grad = torch.from_numpy(gl), torch.from_numpy(gs)
        topt.step()
    np.testing.assert_allclose(tl.numpy(), np.asarray(params["latents"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(params["affine"]["scale"]), rtol=1e-6, atol=1e-6)
