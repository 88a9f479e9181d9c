"""The port's fused guidance epilogue (plain twin on the CPU) against the
JAX package's: its XLA form ``_epilogue_xla``, its Pallas ``_kernel`` run in
the Pallas interpreter, and its per-step scalars (read by the port from a
device table at a step index)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from depth_completion_tpu.ops import guidance_epilogue as jge
from depth_completion_tpu.sched.ddim import DDIMConfig as JDDIMConfig
from depth_completion_tpu.sched.ddim import make_schedule as j_make_schedule
from depth_completion_tpu_torch.ops import guidance_epilogue as ge
from depth_completion_tpu_torch.sched.ddim import DDIMConfig, make_schedule

PTYPES = ["v_prediction", "epsilon"]


def _state(shape, seed):
    """lat, g, out, m, v: Adam state from a few earlier steps (v >= m²)."""
    rng = np.random.default_rng(seed)
    lat, g, out, m = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    v = (m * m + 0.1 * rng.random(shape)).astype(np.float32)
    return lat, 1e-3 * g, out, 0.3 * m, v


def test_scalars_match_jax():
    """[sa, s1, sap, s1p, bc1, bc2] as host floats against JAX's fp32 row.
    The square roots are fp32 on both sides; the bias corrections are taken
    in double here, as ``torch.optim.Adam`` takes them, and in fp32 there,
    where 1 - 0.999 rounds to 1.3e-5 relative: rtol 2e-5."""
    jsched, tsched = j_make_schedule(), make_schedule()
    for t, count in ((999, 0), (519, 24), (19, 49)):
        ref = jge._scalars(jsched, jnp.asarray(t), jnp.asarray(t - 20),
                           jnp.asarray(count, jnp.int32), 0.9, 0.999, True)
        got = ge.epilogue_scalars(tsched, t, 50, count)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=0)
    assert ge.epilogue_scalars(tsched, 19, 50, 0)[2:4] == pytest.approx(
        (np.sqrt(tsched.final_alpha_cumprod), np.sqrt(1 - tsched.final_alpha_cumprod)), rel=1e-6)


@pytest.mark.parametrize("ptype", PTYPES)
def test_twin_matches_jax_xla(ptype):
    """One step from non-zero Adam state: new latent, m and v against
    ``_epilogue_xla`` on the same scalars; fp32 elementwise math, the norms
    summed in another order (rtol 1e-5)."""
    shape = (2, 6, 10, 4)
    lat, g, out, m, v = _state(shape, 1)
    sc = ge.epilogue_scalars(make_schedule(), 759, 50, 5)
    kw = dict(lr=0.05, b1=0.9, b2=0.999, adam_eps=1e-8, v_pred=ptype == "v_prediction")
    ref = jge._epilogue_xla(*(jnp.asarray(x.reshape(2, -1)) for x in (lat, g, out, m, v)),
                            jnp.asarray(sc, jnp.float32), **kw)
    got = ge.guidance_epilogue_plain(*(torch.from_numpy(x) for x in (lat, g, out, m, v)),
                                     torch.tensor([sc]), torch.zeros(1, dtype=torch.int64),
                                     lr=0.05, v_pred=kw["v_pred"])
    for name, a, b in zip(("lat", "m", "v"), got, ref):
        np.testing.assert_allclose(a.numpy().reshape(2, -1), np.asarray(b), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("ptype", PTYPES)
def test_matches_pallas_kernel_interpreted(ptype, monkeypatch):
    """Three chained steps from zero moments: the port's wrapper (plain twin,
    updating in place on the CPU) against ``guided_epilogue`` running the
    Pallas kernel in interpret mode (K = 24·17·4 = 1632, not a multiple of
    its 1024-element tile, so its zero padding is in play). The JAX
    package's own test holds the kernel to its optax chain at 2e-5."""
    monkeypatch.setattr(jge, "INTERPRET", True)
    monkeypatch.setenv("DCT_EPILOGUE", "on")
    shape, steps = (2, 24, 17, 4), 5
    v_pred = ptype == "v_prediction"
    jsched, tsched = j_make_schedule(JDDIMConfig(prediction_type=ptype)), make_schedule(
        DDIMConfig(prediction_type=ptype))
    rng = np.random.default_rng(3)
    lat = rng.standard_normal(shape).astype(np.float32)
    jlat, jm, jv, count = (jnp.asarray(lat), jnp.zeros(shape), jnp.zeros(shape),
                           jnp.zeros((), jnp.int32))
    tlat, tm, tv = torch.from_numpy(lat.copy()), torch.zeros(shape), torch.zeros(shape)
    table = ge.epilogue_table(tsched, (999, 799, 599), steps)
    for i, t in enumerate((999, 799, 599)):
        g, out = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        jlat, jm, jv, count = jge.guided_epilogue(
            jlat, jnp.asarray(g), jnp.asarray(out), jm, jv, count, jsched, jnp.asarray(t),
            steps, lr=0.05)
        ge.guidance_epilogue(tlat, torch.from_numpy(g), torch.from_numpy(out), tm, tv, table,
                             torch.tensor([i]), lr=0.05, v_pred=v_pred)
        for name, a, b in (("lat", tlat, jlat), ("m", tm, jm), ("v", tv, jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-5,
                                       err_msg=f"{name} after step {i}")


def test_supported_scope():
    """v/ε prediction without sample clipping; anything else keeps the
    eager chain."""
    assert ge.supported(make_schedule(DDIMConfig()))
    assert ge.supported(make_schedule(DDIMConfig(prediction_type="epsilon")))
    assert not ge.supported(make_schedule(DDIMConfig(prediction_type="sample")))
    assert not ge.supported(make_schedule(DDIMConfig(clip_sample=True)))


def test_wrapper_takes_plain_twin_only_on_cpu():
    """A CPU tensor runs the twin and counts no launch."""
    lat, g, out, m, v = (torch.from_numpy(x) for x in _state((1, 4, 6, 4), 2))
    before = dict(ge.LAUNCHES)
    table = torch.tensor([[0.1, 0.2, 0.3, 0.4, 1.0, 1.0], [0.5, 0.8, 0.6, 0.7, 10.0, 100.0]])
    step = torch.tensor([1])
    ref = ge.guidance_epilogue_plain(lat, g, out, m, v, table, step, lr=0.05, v_pred=True)
    ge.guidance_epilogue(lat, g, out, m, v, table, step, lr=0.05, v_pred=True)
    assert ge.LAUNCHES == before
    for a, b in zip((lat, m, v), ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
