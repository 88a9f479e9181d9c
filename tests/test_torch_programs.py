"""Every branch of the port's ``guided_sample`` as a program of the cache
(``sampler.SamplerProgram``: prepare, the branch's steps, finish; eager on
the CPU, the plain twin of the card's graphs) against the eager loops it
replaced, bit for bit; the LCM re-noise table across seeds; the tensor-op
optimizers against ``make_optimizer``; the prepare and finish bodies
against ``_prepare`` and the former final decode; and the serving engine's
tiers over a branch other than the fused one.

Geometry: ``test_torch_sampler.py``'s (50x80 frames, res 64, 24x32
latents, the tiny UNet and TAESD, fp32), two torch threads.
"""

import dataclasses
import functools
import time

import numpy as np
import pytest
import torch

from depth_completion_tpu_torch.core import prng
from depth_completion_tpu_torch.guidance.optim import FixedOptimizer, make_optimizer
from depth_completion_tpu_torch.pipeline import sampler as TS
from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline
from depth_completion_tpu_torch.pipeline.programs import ProgramCache
from depth_completion_tpu_torch.sched.ddim import ddim_step, make_timesteps, pred_epsilon
from depth_completion_tpu_torch.sched.lcm import lcm_step, make_lcm_timesteps
from depth_completion_tpu_torch.serving import ServingEngine

from tests.test_torch_sampler import bundles, inputs  # noqa: F401  (fixtures)

KW = dict(steps=3, resolution=64, max_depth=10.0)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# the eager loops the programs replaced, as they were
# ---------------------------------------------------------------------------

def _ddim_denoise(denoise, sched, cfg, lat):
    for t in make_timesteps(cfg.ddim, cfg.steps):
        lat, _ = ddim_step(sched, denoise(lat, int(t)), int(t), lat, cfg.steps)
    return lat


def _lcm_denoise(denoise, sched, cfg, lat):
    ts = [int(t) for t in make_lcm_timesteps(cfg.ddim.num_train_timesteps, cfg.steps, cfg.lcm)]
    key = prng.split(prng.PRNGKey(cfg.seed))[0]
    for i, t in enumerate(ts):
        key, sub = prng.split(key)
        last = i == len(ts) - 1
        lat, _ = lcm_step(sched, denoise(lat, t), t, -1 if last else ts[i + 1], lat, sub,
                          last, cfg.lcm)
    return lat


def _per_input_steps(decode, cfg, dn, images, orig_res, padding, closed_form, latents,
                     affine_params):
    opt = make_optimizer(cfg.opt, latents, affine_params, cfg.lr_latent, cfg.lr_scaling)
    for _ in range(cfg.train_steps):
        _, grads = TS.per_input_grads(decode, cfg, dn, images, orig_res, padding, closed_form,
                                      latents, affine_params)
        for p, g in zip([latents, *affine_params], grads):
            p.grad = g
        opt.step()


def _eager_epilogue(sched, opt, latents, g, out, t, num_steps):
    n = latents.shape[0]
    eps_norm = pred_epsilon(sched, out, t, latents).reshape(n, -1).float().norm(dim=1)
    g = g.float()
    g_norm = g.reshape(n, -1).norm(dim=1)
    latents.grad = g * (eps_norm / torch.clamp(g_norm, min=TS.EPSILON)).reshape(n, 1, 1, 1)
    opt.step()
    new_lat, _ = ddim_step(sched, out, t, latents, num_steps)
    latents.copy_(new_lat)


def _eager_steps(step, sched, cfg, ts, latents, affine_params):
    opt = make_optimizer(cfg.opt, latents, affine_params, cfg.lr_latent, cfg.lr_scaling)
    for t in ts:
        _, out, grads = step(t)
        for p, gp in zip(affine_params, grads[1:]):
            p.grad = gp
        _eager_epilogue(sched, opt, latents, grads[0], out, t, cfg.steps)


def _old_finish(decode, cfg, latents, dn, affine_params, closed_form, orig_res, padding):
    dense = TS.latent_to_affine(decode, latents, orig_res, padding, cfg.interp_mode)
    dense = torch.clamp(TS._affine_to_metric(dense, dn, affine_params, closed_form), 0.0, 1.0)
    return TS.denormalize_depth(dense, dn)


@torch.no_grad()
def _old_guided_sample(bundle, images, sparses, cfg, prev=None, noise=None):
    """``guided_sample``'s eager branches before every branch had a program."""
    closed_form = cfg.resolved_closed_form()
    sched = TS.make_schedule(cfg.ddim)
    img_latents, pred_latents, dn, padding, orig_res = TS._prepare(
        bundle, images, sparses, cfg, prev, noise)
    denoise = TS._Denoiser(bundle, img_latents, TS.flash_attention)
    decode = functools.partial(TS.decode_prediction, bundle, attention_fn=TS.flash_attention)
    affine = []
    if not (cfg.train_latents and cfg.scheduler != "lcm"):
        run = _lcm_denoise if cfg.scheduler == "lcm" else _ddim_denoise
        final = run(denoise, sched, cfg, pred_latents)
    else:
        if not closed_form:
            n = images.shape[0]
            affine = [torch.ones((n, 1, 1, 1)).requires_grad_(True),
                      torch.zeros((n, 1, 1, 1)).requires_grad_(True)]
        if cfg.train_method == "per-input":
            latents = _ddim_denoise(denoise, sched, cfg, pred_latents).requires_grad_(True)
            _per_input_steps(decode, cfg, dn, images, orig_res, padding, closed_form, latents,
                             affine)
        else:
            latents = pred_latents.clone().requires_grad_(True)
            step = functools.partial(TS.guided_step_grads, denoise, decode, sched, cfg, dn,
                                     images, orig_res, padding, closed_form, latents, affine)
            ts = [int(t) for t in make_timesteps(cfg.ddim, cfg.steps)]
            _eager_steps(step, sched, cfg, ts, latents, affine)
        final = latents.detach()
    return _old_finish(decode, cfg, final, dn, affine, closed_form, orig_res, padding), final


# ---------------------------------------------------------------------------
# each branch's program against the loop it replaced
# ---------------------------------------------------------------------------

MODES = {
    "sgd": ("general-step", dict(opt="sgd", closed_form=False)),
    "adagrad": ("general-step", dict(opt="adagrad", closed_form=False)),
    "adam_clip": ("general-step", dict(closed_form=False,
                                       ddim=TS.DDIMConfig(clip_sample=True))),
    "ddim": ("ddim", dict(train_latents=False)),
    "lcm": ("lcm", dict(scheduler="lcm", train_latents=False)),
    "per_input_adam": ("per-input", dict(train_method="per-input", train_steps=3,
                                         closed_form=False)),
    "per_input_adagrad": ("per-input", dict(train_method="per-input", train_steps=3,
                                            opt="adagrad", closed_form=False)),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_branch_program_equals_the_loop_it_replaced(bundles, inputs, mode):
    """One request of the mode through ``ProgramCache`` (every phase eager
    on the CPU) against the former eager loop on the same inputs, with the
    carried latent of a first request: bit-identical denses and latents
    (the tables hold the host floats exactly, a 0-d float32 tensor
    multiplies as the float does, and the tensor-op optimizers run
    ``torch.optim``'s ops in its order); one program, tagged with the
    branch."""
    _, tbundle = bundles
    imgs, sparses, noise = (torch.from_numpy(x) for x in inputs)
    branch, options = MODES[mode]
    cfg = TS.SamplerConfig(**KW, **options)
    cache = ProgramCache()
    d_new, l_new = TS.guided_sample(tbundle, imgs, sparses, cfg, init_noise=noise,
                                    programs=cache)
    d_old, l_old = _old_guided_sample(tbundle, imgs, sparses, cfg, noise=noise)
    assert torch.equal(l_new, l_old) and torch.equal(d_new, d_old), (
        float((l_new - l_old).abs().max()), float((d_new - d_old).abs().max()))
    carried = TS.guided_sample(tbundle, imgs, sparses, cfg, l_new, programs=cache)
    old = _old_guided_sample(tbundle, imgs, sparses, cfg, prev=l_old)
    assert all(torch.equal(a, b) for a, b in zip(carried, old))
    (key,) = cache.keys()
    program = cache.find(imgs.shape)
    assert key[0] == branch == program.tag and program.graphs == {}  # eager on the CPU


def test_lcm_program_refills_its_noise_per_seed(bundles, inputs):
    """The seed is not in the program key: one LCM program serving seed 0
    then seed 1 equals a fresh program for each (the re-noise table is drawn
    again for the second seed, not kept from the first)."""
    _, tbundle = bundles
    imgs, sparses, _ = (torch.from_numpy(x) for x in inputs)
    cfg = TS.SamplerConfig(**KW, scheduler="lcm", train_latents=False, seed=0)
    shared = ProgramCache()
    runs = [TS.guided_sample(tbundle, imgs, sparses, dataclasses.replace(cfg, seed=s),
                             programs=shared) for s in (0, 1)]
    fresh = [TS.guided_sample(tbundle, imgs, sparses, dataclasses.replace(cfg, seed=s),
                              programs=ProgramCache()) for s in (0, 1)]
    assert len(shared.keys()) == 1
    for (d, lat), (d_ref, lat_ref) in zip(runs, fresh):
        assert torch.equal(d, d_ref) and torch.equal(lat, lat_ref)
    assert not torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("opt", ["adam", "sgd", "adagrad"])
def test_fixed_optimizer_equals_make_optimizer(opt):
    """``FixedOptimizer`` (tensor ops, Adam's bias corrections from its
    table at a device step index) against ``make_optimizer``'s optimizer
    over the latent and the affine, 10 steps of random gradients (some
    zero, where Adagrad's accumulator stays 0): bit for bit."""
    rng = np.random.default_rng(5)
    shapes = [(2, 3, 4, 4), (2, 1, 1, 1), (2, 1, 1, 1)]
    start = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    ref = [p.clone().requires_grad_(True) for p in start]
    ours = [p.clone() for p in start]
    torch_opt = make_optimizer(opt, ref[0], ref[1:], 0.05, 0.005)
    fixed = FixedOptimizer(opt, ours, [0.05, 0.005, 0.005], 10)
    for k in range(10):
        grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
        grads[0][0, 0] = 0.0
        for p, g in zip(ref, grads):
            p.grad = g.clone()
        with torch.no_grad():
            torch_opt.step()
            fixed.step(grads, torch.tensor([k]))
        for a, b in zip(ours, ref):
            assert torch.equal(a, b.detach()), (opt, k, float((a - b).abs().max()))
    fixed.reset()
    assert all(float(b.abs().max()) == 0.0 for bufs in fixed.state.values() for b in bufs)
    FixedOptimizer(opt, [], [], 10).step([], torch.tensor([0]))  # a closed-form affine's


@pytest.mark.parametrize("carry", [False, True])
def test_prepare_and_finish_bodies(bundles, inputs, carry):
    """The prepare body (from the request's seeded noise, with and without a
    carried latent) equals ``_prepare`` bit for bit, the state reset
    included; the finish body equals the former final decode, with the
    learned affine (no carry) and the closed form (carry)."""
    _, tbundle = bundles
    imgs, sparses, _ = (torch.from_numpy(x) for x in inputs)
    prev = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 24, 32, 4))
                            .astype(np.float32)) if carry else None
    cfg = TS.SamplerConfig(**KW, beta=0.7, closed_form=carry, train_latents=not carry)
    sched = TS.make_schedule(cfg.ddim)
    program = TS.PROGRAMS[TS.sampler_branch(cfg, sched)](tbundle, cfg, sched, False, imgs,
                                                           sparses)
    _, key = prng.split(prng.PRNGKey(cfg.seed))
    program.load(imgs, sparses, torch.from_numpy(prng.normal(key, (1, 24, 32, 4))), prev, cfg)
    if not carry:
        program.affine[0].fill_(3.0)  # a state the reset must undo
    program.step_eager(0, "prepare")
    img_latents, latents, dn, padding, orig_res = TS._prepare(tbundle, imgs, sparses, cfg, prev)
    assert torch.equal(program.img_latents, img_latents)
    assert torch.equal(program.latents, latents)
    assert all(torch.equal(getattr(program.dn, f.name), getattr(dn, f.name))
               for f in dataclasses.fields(dn))
    assert (program.padding, program.orig_res) == (padding, orig_res)
    assert [float(p.mean()) for p in program.affine] == ([] if carry else [1.0, 0.0])
    final = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 24, 32, 4))
                             .astype(np.float32))
    program.latents.copy_(final)
    for p, v in zip(program.affine, (1.3, 0.2)):
        p.fill_(v)
    affine = [p.clone() for p in program.affine]
    program.step_eager(0, "finish")
    decode = functools.partial(TS.decode_prediction, tbundle, attention_fn=TS.flash_attention)
    want = _old_finish(decode, cfg, final, dn, affine, cfg.resolved_closed_form(), orig_res,
                       padding)
    assert torch.equal(program.dense, want)


# ---------------------------------------------------------------------------
# the serving engine's tiers over a branch without the fused step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["lcm", "sgd"])
def test_engine_promotes_any_branch_under_max_programs(bundles, mode):
    """An engine serving LCM (or SGD) with ``max_programs=1`` and tiered
    warmup: the signature is promoted, its program is live, tier 0 drops,
    and a later request runs on the graph pipeline (an engine whose
    pipeline made a program for the fused step only kept tier 0 for every
    other branch)."""
    _, tbundle = bundles
    h, w = 48, 64
    calls = []

    class Spy:
        def __init__(self, pipe, tier):
            self.pipe, self.tier = pipe, tier

        def __getattr__(self, name):
            return getattr(self.pipe, name)

        def __call__(self, images, sparses, **kwargs):
            calls.append(self.tier)
            return self.pipe(images, sparses, **kwargs)

    pipe = DepthCompletionPipeline(tbundle, max_programs=1)
    options = {"lcm": dict(scheduler="lcm", train_latents=False),
               "sgd": dict(opt="sgd", closed_form=False)}[mode]
    eng = ServingEngine(Spy(pipe, "graph"), dict(max_depth=10.0, steps=2, resolution=64,
                                                 **options), max_batch=1)
    eng._make_tier0_pipe = lambda effort: Spy(pipe.twin(), "tier0")
    try:
        eng.warmup([(h, w)], tiered=True)
        assert calls == ["tier0", "tier0"]  # bucket 1 and the carry job
        deadline = time.monotonic() + 60
        while "tier0_active" in eng.stats():
            assert time.monotonic() < deadline, eng.stats()
            time.sleep(0.01)
        st = eng.stats()
        assert [p["signature"] for p in st["tier_promotions"]] == [((h, w), 1)]
        assert st["compiled_programs"] == [(h, w, 1)]
        rng = np.random.default_rng(6)
        sparse = np.zeros((h, w, 1), np.float32)
        sparse[3, 4, 0], sparse[20, 30, 0] = 2.0, 7.0
        out = eng.complete(rng.uniform(0, 255, (h, w, 3)).astype(np.float32), sparse,
                           timeout=60)
        assert out.shape == (h, w, 1) and np.isfinite(out).all()
        assert calls[-1] == "graph" and calls.count("graph") == 2  # the promotion, the request
    finally:
        eng.shutdown()
