"""The captured guided step's CPU side: the per-step tables, the step
program (``sampler.FusedStepProgram``, eager here: the CPU runs the graph's
plain twin) against the per-step loop it replaced and against JAX's
``guided_sample``, the program cache (``pipeline.programs``) and the serving
engine's tiered warmup and eviction-aware dispatch.

Geometry: ``test_torch_sampler.py``'s (50x80 frames, res 64, 24x32
latents, the tiny UNet and TAESD, fp32), two torch threads.
"""

import functools
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from depth_completion_tpu.pipeline import sampler as JS
from depth_completion_tpu_torch.ops import guidance_epilogue as ge
from depth_completion_tpu_torch.ops.ring_attention import LocalRing
from depth_completion_tpu_torch.pipeline import sampler as TS
from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline
from depth_completion_tpu_torch.pipeline.programs import EagerTwin, ProgramCache, signature
from depth_completion_tpu_torch.core import prng
from depth_completion_tpu_torch.sched import ddim, lcm
from depth_completion_tpu_torch.serving import ServeRequest, ServingEngine

from tests.test_ring_attention import _mesh
from tests.test_torch_sampler import _rms, bundles, inputs  # noqa: F401  (fixtures)

KW = dict(steps=3, resolution=64, closed_form=False, max_depth=10.0)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_steps", [1, 10, 50])
@pytest.mark.parametrize("ptype", ["v_prediction", "epsilon"])
@pytest.mark.parametrize("spacing", ["trailing", "leading"])
def test_tables_equal_host_scalars(spacing, ptype, num_steps):
    """``step_tables``, ``epilogue_table`` and ``lcm_tables`` hold
    ``_coeffs``, ``epilogue_scalars`` and ``lcm_scalars`` bit for bit
    (float32), and the tensor-indexed x̂₀, ε̂, DDIM and LCM steps equal the
    float forms bit for bit."""
    cfg = ddim.DDIMConfig(prediction_type=ptype, timestep_spacing=spacing)
    sched = ddim.make_schedule(cfg)
    ts = ddim.make_timesteps(cfg, num_steps)
    tables = ddim.step_tables(sched, ts, num_steps)
    epi = ge.epilogue_table(sched, ts, num_steps)
    assert tables.t.tolist() == [int(t) for t in ts]
    rng = np.random.default_rng(num_steps)
    out, x = (torch.from_numpy(rng.standard_normal((2, 3, 5, 4)).astype(np.float32))
              for _ in range(2))
    for k, t in enumerate(int(t) for t in ts):
        prev = ddim.prev_timestep(sched, t, num_steps)
        host = np.float32([*ddim._coeffs(sched, t), *ddim._coeffs(sched, prev)])
        assert np.array_equal(tables.coeffs[k].numpy(), host)
        assert np.array_equal(epi[k].numpy(), np.float32(ge.epilogue_scalars(sched, t,
                                                                             num_steps, k)))
        row = tables.coeffs.index_select(0, torch.tensor([k]))[0, :2].unbind(0)
        assert torch.equal(ddim.pred_original_at(sched, out, x, *row),
                           ddim.pred_original(sched, out, t, x))
        assert torch.equal(ddim.pred_epsilon_at(sched, out, x, *row),
                           ddim.pred_epsilon(sched, out, t, x))
        full = tables.coeffs.index_select(0, torch.tensor([k]))[0].unbind(0)
        assert all(torch.equal(a, b) for a, b in zip(ddim.ddim_step_at(sched, out, x, *full),
                                                     ddim.ddim_step(sched, out, t, x, num_steps)))
    # the LCM table: each row the host floats ``lcm_step`` takes, and the
    # tensor-indexed step equal to it (the last step: the denoised estimate)
    lts = [int(t) for t in lcm.make_lcm_timesteps(cfg.num_train_timesteps, num_steps)]
    ltab = lcm.lcm_tables(sched, lts)
    assert ltab.t.tolist() == lts
    key = prng.split(prng.PRNGKey(num_steps))[0]
    for k, t in enumerate(lts):
        last = k == len(lts) - 1
        prev_t = -1 if last else lts[k + 1]
        assert np.array_equal(ltab.coeffs[k].numpy(),
                              np.float32(lcm.lcm_scalars(sched, t, prev_t, last)))
        row = ltab.coeffs.index_select(0, torch.tensor([k]))[0].unbind(0)
        noise = torch.zeros_like(x) if last else torch.from_numpy(prng.normal(key, x.shape))
        got = lcm.lcm_step_at(sched, out, x, noise, *row)
        assert all(torch.equal(a, b) for a, b in zip(
            got, lcm.lcm_step(sched, out, t, prev_t, x, key, last)))


# ---------------------------------------------------------------------------
# the step program against the loop it replaced, and against JAX
# ---------------------------------------------------------------------------

def _old_fused_adam_steps(step, sched, cfg, ts, latents, affine_params):
    """The per-step loop the step program replaced, as it was: each step's
    six scalars as host floats (``epilogue_scalars``), the epilogue's plain
    arithmetic on them, the affine's ``torch.optim.Adam``."""
    m, v = torch.zeros_like(latents), torch.zeros_like(latents)
    aff_opt = torch.optim.Adam(affine_params, lr=cfg.lr_scaling,
                               betas=(ge.ADAM_B1, ge.ADAM_B2), eps=ge.ADAM_EPS)
    v_pred = sched.config.prediction_type == "v_prediction"
    n = latents.shape[0]
    for count, t in enumerate(ts):
        _, out, grads = step(t)
        for p, gp in zip(affine_params, grads[1:]):
            p.grad = gp
        aff_opt.step()
        sa, s1, sap, s1p, bc1, bc2 = ge.epilogue_scalars(sched, t, cfg.steps, count)
        lat, g, o = latents.detach(), grads[0], out.float()
        eps_hat = sa * o + s1 * lat if v_pred else o
        g = g * (eps_hat.reshape(n, -1).norm(dim=1)
                 / torch.clamp(g.reshape(n, -1).norm(dim=1), min=ge.EPSILON)).reshape(n, 1, 1, 1)
        m.copy_(ge.ADAM_B1 * m + (1.0 - ge.ADAM_B1) * g)
        v.copy_(ge.ADAM_B2 * v + (1.0 - ge.ADAM_B2) * g * g)
        lat = lat - cfg.lr_latent * (m * bc1) / (torch.sqrt(v * bc2) + ge.ADAM_EPS)
        x0, eps = (sa * lat - s1 * o, sa * o + s1 * lat) if v_pred else ((lat - s1 * o) / sa, o)
        latents.copy_(sap * x0 + s1p * eps)


@torch.no_grad()
def _old_guided_sample(bundle, images, sparses, cfg, noise):
    """``guided_sample``'s per-step branch before the step program."""
    remat = TS.resolve_remat(cfg, images.shape[0], (24, 32), images.device)
    sched = TS.make_schedule(cfg.ddim)
    img_latents, pred_latents, dn, padding, orig_res = TS._prepare(
        bundle, images, sparses, cfg, None, noise)
    unet_attention = TS.flash_attention if cfg.ring_mesh is None else functools.partial(
        TS.ring_or_base, cfg.ring_mesh, TS.flash_attention)
    denoise = TS._Denoiser(bundle, img_latents, unet_attention, remat)
    decode = functools.partial(TS.decode_prediction, bundle, attention_fn=TS.flash_attention)
    n = images.shape[0]
    affine = [torch.ones((n, 1, 1, 1)).requires_grad_(True),
              torch.zeros((n, 1, 1, 1)).requires_grad_(True)]
    latents = pred_latents.clone().requires_grad_(True)
    step = functools.partial(TS.guided_step_grads, denoise, decode, sched, cfg, dn, images,
                             orig_res, padding, False, latents, affine)
    _old_fused_adam_steps(step, sched, cfg, [int(t) for t in TS.make_timesteps(cfg.ddim,
                                                                             cfg.steps)],
                          latents, affine)
    dense = TS.latent_to_affine(decode, latents.detach(), orig_res, padding, cfg.interp_mode)
    dense = torch.clamp(TS._affine_to_metric(dense, dn, affine, False), 0.0, 1.0)
    return TS.denormalize_depth(dense, dn), latents.detach()


OPTIONS = {"plain": {}, "remat": {"remat_unet": "on"}, "fast": {"detach_unet_grad": True},
           "ring": {"ring_mesh": LocalRing(4)},
           "epsilon": {"ddim": TS.DDIMConfig(prediction_type="epsilon")}}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_program_equals_the_loop_it_replaced(bundles, inputs, option):
    """3 steps through ``FusedStepProgram`` (eager on the CPU) against the
    former loop on the same inputs: bit-identical denses and latents (the
    tables hold the host floats exactly, and a 0-d float32 tensor multiplies
    as the float does)."""
    _, tbundle = bundles
    imgs, sparses, noise = (torch.from_numpy(x) for x in inputs)
    cfg = TS.SamplerConfig(**KW, **OPTIONS[option])
    cache = ProgramCache()
    d_new, l_new = TS.guided_sample(tbundle, imgs, sparses, cfg, init_noise=noise,
                                    programs=cache)
    d_old, l_old = _old_guided_sample(tbundle, imgs, sparses, cfg, noise)
    assert len(cache.keys()) == 1 and cache.find(imgs.shape).graphs == {}  # eager on the CPU
    assert torch.equal(l_new, l_old) and torch.equal(d_new, d_old), (
        float((l_new - l_old).abs().max()), float((d_new - d_old).abs().max()))


@pytest.mark.parametrize("option", ["remat_ring", "fast"])
def test_program_matches_jax(bundles, inputs, option):
    """The step program against JAX's ``guided_sample`` (jit, CPU): remat
    with the ring (JAX on a 4-device ring mesh), and fast guidance; the
    bounds of ``test_torch_sampler.py``'s guided test, the tolerance model
    of ``tests/test_pipeline_parity.py:36-49``."""
    jbundle, tbundle = bundles
    imgs, sparses, noise = inputs
    if option == "fast":
        jopt, topt = {"detach_unet_grad": True}, {"detach_unet_grad": True}
    else:
        jopt = {"remat_unet": True, "ring_mesh": _mesh(4)}
        topt = {"remat_unet": "on", "ring_mesh": LocalRing(4)}
    jfn = jax.jit(JS.guided_sample, static_argnames=("cfg",))
    d_j, l_j = jfn(jbundle, jnp.asarray(imgs), jnp.asarray(sparses),
                   JS.SamplerConfig(**KW, **jopt), init_noise=jnp.asarray(noise))
    cache = ProgramCache()
    d_t, l_t = TS.guided_sample(tbundle, torch.from_numpy(imgs), torch.from_numpy(sparses),
                                TS.SamplerConfig(**KW, **topt), init_noise=torch.from_numpy(noise),
                                programs=cache)
    assert cache.keys()[0][3] == (option != "fast")  # remat in the signature
    dd, ll = d_t.numpy() - np.asarray(d_j), l_t.numpy() - np.asarray(l_j)
    assert _rms(dd) < 1.2e-2 and np.abs(dd).max() < 0.15 and _rms(ll) < 3.5e-2, (
        _rms(dd), np.abs(dd).max(), _rms(ll))


# ---------------------------------------------------------------------------
# the program cache
# ---------------------------------------------------------------------------

def _frame(seed, h, w):
    rng = np.random.default_rng(seed)
    image = rng.uniform(0, 255, size=(1, h, w, 3)).astype(np.float32)
    sparse = np.zeros((1, h * w), np.float32)
    sparse[0, rng.choice(h * w, size=40, replace=False)] = rng.uniform(0.5, 9.5, 40)
    return image, sparse.reshape(1, h, w, 1)


def test_pipeline_lru_program_cache(bundles):
    """``max_programs`` bounds the live programs with LRU eviction; an
    evicted signature is made again on its next use and gives the same
    result; a carried latent and another seed share the program
    (``tests/test_serving.py:598``)."""
    _, tbundle = bundles
    pipe = DepthCompletionPipeline(tbundle, max_programs=2)
    kw = dict(steps=2, resolution=64)
    a, b, c = _frame(0, 48, 64), _frame(1, 64, 48), _frame(2, 32, 48)
    out_a1, lat_a = pipe(*a, 10.0, **kw)
    assert len(pipe.program_keys()) == 1
    pipe(*a, 10.0, pred_latents_prev=lat_a, seed=7, **kw)  # the carry: same program
    assert len(pipe.program_keys()) == 1
    pipe(*b, 10.0, **kw)
    assert len(pipe.program_keys()) == 2
    pipe(*c, 10.0, **kw)  # evicts A (oldest)
    keys = pipe.program_keys()
    assert len(keys) == 2 and not any(signature(k)[1:3] == (48, 64) for k in keys), keys
    assert pipe.programs.find(a[0].shape) is None
    assert pipe.programs.find(c[0].shape) is not None
    out_a2, _ = pipe(*a, 10.0, **kw)
    assert torch.equal(out_a1, out_a2)
    pipe(*b, 10.0, **kw)  # LRU: A and B are the newest
    assert [signature(k)[1:3] for k in pipe.program_keys()] == [(48, 64), (64, 48)]
    twin = pipe.twin()
    assert isinstance(twin.programs, EagerTwin) and twin.bundle is pipe.bundle
    assert torch.equal(twin(*a, 10.0, **kw)[0], out_a1)
    assert pipe.replace_bundle().max_programs == 2


def test_program_cache_thread_safety():
    """Concurrent callers of one cache keep the bound and each gets a
    program (``tests/test_serving.py:725``)."""
    cache = ProgramCache(max_programs=3)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(200):
                key = ("step", int(rng.integers(0, 8)))
                assert cache.get(key, lambda: object()) is not None
                assert len(cache.keys()) <= 3
        except Exception as exc:  # surfaced after join
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors and len(cache.keys()) <= 3
    with pytest.raises(ValueError, match="max_programs"):
        ProgramCache(max_programs=0)


# ---------------------------------------------------------------------------
# the serving engine's tiers
# ---------------------------------------------------------------------------

H, W = 48, 64


def _fake_result(images):
    n, h, w = images.shape[:3]
    return np.zeros((n, h, w, 1), np.float32), np.zeros((n, 4, 4, 4), np.float32)


def test_engine_tiered_warmup_promotes():
    """Tiered warmup: every job on tier 0, then one promotion at a time on
    the compute thread, between batches; traffic for a signature not yet
    promoted runs on tier 0, a promoted one on the graph pipe; tier 0 drops
    once all are promoted (``tests/test_serving.py:666``)."""
    full, tier0 = [], []
    gate = threading.Semaphore(0)  # holds the first promotion

    class _Full:
        def __call__(self, images, sparses, **k):
            full.append(images.shape[0])
            if len(full) == 1:
                gate.acquire(timeout=30)
            return _fake_result(images)

    class _Tier0:
        def __call__(self, images, sparses, **k):
            tier0.append((images.shape[0], "pred_latents_prev" in k))
            return _fake_result(images)

    eng = ServingEngine(_Full(), dict(max_depth=120.0), max_batch=2, max_delay_ms=500.0)
    eng._make_tier0_pipe = lambda effort: _Tier0()
    eng.dispatch_retry_backoff_s = 0.0
    try:
        eng.warmup([(H, W)], tiered=True)
        assert tier0 == [(1, False), (2, False), (1, True)]
        st = eng.stats()
        assert st["tier0_active"] and st["tier_promoted"] == "0/2"
        deadline = time.monotonic() + 30
        while not full and time.monotonic() < deadline:  # bucket 1's promotion is running
            time.sleep(0.01)
        rng = np.random.default_rng(0)
        frames = [(rng.uniform(0, 255, (H, W, 3)), np.full((H, W, 1), 0.0)) for _ in range(3)]
        for img, sp in frames:
            sp[5, 5, 0], sp[9, 9, 0] = 1.0, 3.0
        reqs = [eng.submit(ServeRequest(image=img, sparse=sp)) for img, sp in frames]
        gate.release()
        for r in reqs:
            r.wait(30)
        # bucket 1 promoted first; the queued pair (bucket 2, not yet
        # promoted) ran on tier 0, then bucket 2's promotion, then the
        # third request on the graph pipe
        assert tier0[3:] == [(2, False)] and full == [1, 2, 1], (tier0, full)
        st = eng.stats()
        assert "tier0_active" not in st
        assert [p["signature"] for p in st["tier_promotions"]] == [((H, W), 1), ((H, W), 2)]
        assert all(p["s"] >= 0 for p in st["tier_promotions"])
    finally:
        gate.release()
        eng.shutdown()


def test_tiered_dispatch_avoids_evicted_program():
    """With ``max_programs`` below the warmed signatures, a promoted
    program evicted by a later promotion is served from tier 0 rather than
    captured again on the compute thread; tier 0 stays while that holds
    (``tests/test_serving.py:1084``)."""
    full, tier0 = [], []

    class _Full:
        max_programs = 1

        def __call__(self, images, sparses, **k):
            full.append(images.shape[0])
            return _fake_result(images)

        def program_keys(self):
            return [("step", (2, H, W, 3), None, False, 0)]  # only bucket 2 survived

    class _Tier0:
        def __call__(self, images, sparses, **k):
            tier0.append(images.shape[0])
            return _fake_result(images)

    eng = ServingEngine(_Full(), dict(max_depth=120.0), max_batch=2, max_delay_ms=500.0)
    try:
        img = np.random.default_rng(1).uniform(0, 255, (H, W, 3))
        sp = np.zeros((H, W, 1))
        sp[1, 1, 0], sp[2, 2, 0] = 1.0, 2.0
        with eng._tier_lock:
            eng._tier0_pipe = _Tier0()
            eng._tier0_ready = {((H, W), 1), ((H, W), 2)}
            eng._full_ready = set(eng._tier0_ready)  # both promoted
            eng._maybe_drop_tier0()
            assert eng._tier0_pipe is not None  # bucket 1's program is gone
        eng.complete(img, sp, timeout=30)  # bucket 1: evicted → tier 0
        assert tier0 == [1] and full == []
        reqs = [eng.submit(ServeRequest(image=img, sparse=sp)) for _ in range(2)]
        for r in reqs:
            r.wait(30)
        assert full == [2] and tier0 == [1]  # bucket 2 is live → the graph pipe
    finally:
        eng.shutdown()


def test_engine_failed_promotion_fails_its_batches():
    """A promotion that still fails after ``promote_retries`` retries is not
    hidden behind tier 0: the batches of its signature fail with the
    capture's error and ``stats()["tier_failed"]`` lists it; the other
    signature is promoted and served by its graph."""
    full, tier0 = [], []

    class _Full:
        def __call__(self, images, sparses, **k):
            full.append(images.shape[0])
            if images.shape[0] == 1:
                raise RuntimeError("capture failed")
            return _fake_result(images)

    class _Tier0:
        def __call__(self, images, sparses, **k):
            tier0.append(images.shape[0])
            return _fake_result(images)

    eng = ServingEngine(_Full(), dict(max_depth=120.0), max_batch=2, max_delay_ms=500.0)
    eng._make_tier0_pipe = lambda effort: _Tier0()
    eng.dispatch_retry_backoff_s = 0.0
    eng.promote_retries = 1
    try:
        eng.warmup([(H, W)], tiered=True)
        deadline = time.monotonic() + 30
        while len(eng.stats()["tier_promotions"]) + len(eng.stats()["tier_failed"]) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        st = eng.stats()
        assert st["tier_failed"] == [((H, W), 1)] and full == [1, 2, 1], (st, full)
        assert [p["signature"] for p in st["tier_promotions"]] == [((H, W), 2)]
        img = np.random.default_rng(2).uniform(0, 255, (H, W, 3))
        sp = np.zeros((H, W, 1))
        sp[1, 1, 0], sp[2, 2, 0] = 1.0, 2.0
        with pytest.raises(RuntimeError, match="failed to capture: RuntimeError: capture failed"):
            eng.complete(img, sp, timeout=30)  # bucket 1: neither tier 0 nor a capture
        assert tier0 == [1, 2, 1] and full == [1, 2, 1]
        reqs = [eng.submit(ServeRequest(image=img, sparse=sp)) for _ in range(2)]
        for r in reqs:
            r.wait(30)
        assert full == [1, 2, 1, 2] and tier0 == [1, 2, 1]  # bucket 2 on its graph
    finally:
        eng.shutdown()
