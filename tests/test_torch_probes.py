"""The port's probe twins (``depth_completion_tpu_torch.probes``) against
the JAX package's TPU probe scripts (``scripts/exp_*.py``), run unchanged:
in the Pallas interpreter where the script's kernel is a module-level
function (``exp_flash_overlap._body``, ``exp_flash_twostream._fwd``,
``exp_packed_pv._kern``), and as ``jnp`` formulas copied from
``exp_pallas_n64.py:61-110`` for its variants A-E, whose kernels are
closures inside its ``main()`` and whose ``pallas_call`` (:133-148) has no
interpret flag. Inputs from a numpy seed, rounded to bf16 alike on both
sides.

Tolerances: the outputs are bf16 of fp32 sums taken in another order, so
they may differ by one bf16 ulp (2^-7 of the element); where p is rounded
to bf16 before a product (the flash forms), scores that differ in the last
fp32 bit may round p apart, which stays far below 2^-8 of the largest
output. The fp32 sums over the repeats add ~R ulps of fp32, invisible
after the bf16 rounding."""

import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from depth_completion_tpu_torch.ops import flash_attention as tfa
from depth_completion_tpu_torch.probes import flash_overlap as fo
from depth_completion_tpu_torch.probes import flash_twostream as fts
from depth_completion_tpu_torch.probes import mma_n64 as n64
from depth_completion_tpu_torch.probes import packed_pv as ppv

RTOL = 2**-7  # one bf16 ulp of the element


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _script(name):
    """``scripts/<name>.py``, imported without keeping the compilation-cache
    variables its import sets (the suite runs with JAX's cache off)."""
    keys = ("JAX_COMPILATION_CACHE_DIR", "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS")
    saved = {k: os.environ.get(k) for k in keys}
    try:
        return importlib.import_module(f"scripts.{name}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _normal(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]


def _both(x):
    """(jnp bf16, torch bf16) of one float32 array: the same bf16 values."""
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _assert_bf16_close(got, ref, atol_frac=2**-8):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=atol_frac * np.abs(ref).max())


# ---------------------------------------------------------------------------
# 9a: exp_flash_overlap._body
# ---------------------------------------------------------------------------

BQ, BK, D, STEPS = 64, 128, 64, 3


def _overlap_jax(mode, q, k, v, monkeypatch):
    """The script's ``_body`` through its own specs (:82-98), interpreted,
    at BQ=64, BK=128 and 3 steps."""
    ov = _script("exp_flash_overlap")
    monkeypatch.setattr(ov, "BQ", BQ)
    monkeypatch.setattr(ov, "BK", BK)
    fn = pl.pallas_call(
        functools.partial(ov._body, mode),
        grid=(STEPS,),
        in_specs=[
            pl.BlockSpec((BQ, D), lambda i: (0, 0)),
            pl.BlockSpec((BK, D), lambda i: (0, 0)),
            pl.BlockSpec((BK, D), lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((BQ, D), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((BQ, D), jnp.bfloat16),
        scratch_shapes=[
            pltpu.VMEM((BQ, 128), jnp.float32),
            pltpu.VMEM((BQ, 128), jnp.float32),
            pltpu.VMEM((BQ, D), jnp.float32),
        ],
        interpret=True,
    )
    return np.asarray(fn(q, k, v).astype(jnp.float32))


def _overlap_inputs():
    (jq, tq), (jk, tk), (jv, tv) = (_both(x) for x in _normal(0, (BQ, D), (BK, D), (BK, D)))
    return (jq, jk, jv), (tq[None], tk[None], tv[None])


@pytest.mark.parametrize("design", fo.DESIGNS)
@pytest.mark.parametrize("mode", ["full", "softmax"])
def test_block_step_twin_matches_jax_probe(mode, design, monkeypatch):
    """full: the flash body's QK, online softmax and PV with bf16 p;
    softmax: the faked score tile (exact: every p is 1 in 3 steps, so both
    give exactly 3.0, the count of steps). Both designs of the block step
    compute the same function: on a CPU tensor each takes the one twin."""
    jx, tx = _overlap_inputs()
    ref = _overlap_jax(mode, *jx, monkeypatch)
    got = fo.block_step(*tx, mode, STEPS, design=design)[0].float().numpy()
    if mode == "softmax":
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, np.full_like(got, STEPS))
    else:
        _assert_bf16_close(got, ref)


def test_block_step_rejects_unknown_design():
    _, tx = _overlap_inputs()
    with pytest.raises(ValueError, match="design"):
        fo.block_step(*tx, "full", STEPS, design="wgmma")


def test_dots_mode_reference_nan_port_repaired(monkeypatch):
    """The script's dots mode reads α from the running-max scratch, -inf at
    the first step: its output is all NaN. The port's α scratch starts at 1,
    so its output is finite: STEPS times bf16(q kᵀ·scale) · v."""
    jx, tx = _overlap_inputs()
    assert np.isnan(_overlap_jax("dots", *jx, monkeypatch)).all()
    got = fo.block_step_plain(*tx, "dots", STEPS)[0].float()
    assert torch.isfinite(got).all()
    q, k, v = (x[0].float() for x in tx)
    p = (q @ k.T * fo.SCALE).to(torch.bfloat16).float()
    _assert_bf16_close(got.numpy(), (STEPS * (p @ v)).to(torch.bfloat16).float().numpy())


# ---------------------------------------------------------------------------
# 9b: exp_flash_twostream._fwd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("twostream", [False, True], ids=["single", "twostream"])
def test_flash_forms_match_jax_twostream_probe(twostream):
    """``_fwd`` at [bh=2, S=256, 64], bq=64, bk=128 (its single- or
    two-stream body) against the port's single-stream wrapper and its
    two-stream wrapper (plain twins here, heads=1 per batch entry). The
    script rounds p to bf16 against its running max, the twins against the
    final max: the flash tolerance."""
    ts = _script("exp_flash_twostream")
    arrays = _normal(1, *[(2, 256, 64)] * 3)
    arrays[0] *= 0.3
    arrays[1] *= 0.3
    (jq, tq), (jk, tk), (jv, tv) = (_both(x) for x in arrays)
    ref = np.asarray(ts._fwd(jq, jk, jv, 1.0 / 8.0, 64, 128, twostream).astype(jnp.float32))
    port = fts.flash_fwd_twostream if twostream else tfa.flash_fwd
    o, lse2 = port(tq, tk, tv, 1)
    assert lse2.shape == (2, 1, 256)
    _assert_bf16_close(o.float().numpy(), ref)


# ---------------------------------------------------------------------------
# 9c: exp_pallas_n64 variants A-E (formulas of :61-110 on the operands of
# :158-173 and :185-186)
# ---------------------------------------------------------------------------

P, NQ, NK, R = 2, 64, 128, 3


def _dot(a, b):
    return jax.lax.dot_general(a, b, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)


def _dott(a, b):
    return jax.lax.dot_general(a, b, (((0,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)


def _repeat(f, *xs):
    acc = f(*xs)
    for _ in range(R - 1):
        acc += f(*xs)
    return acc


def _jax_variant(name, p1, p2, v1, v2, do1, do2):
    """One variant's per-pair outputs as the script's kernels compute them."""
    bf = jnp.bfloat16
    if name == "A":
        return jnp.stack([(_repeat(_dot, p, v) / R).astype(bf) for p, v in ((p1, v1), (p2, v2))])
    if name == "B":
        zeros = jnp.zeros_like(v1)
        pcat = jnp.concatenate([p1, p2], axis=1)
        vbd = jnp.concatenate([jnp.concatenate([v1, zeros], 1),
                               jnp.concatenate([zeros, v2], 1)], 0)
        return (_repeat(_dot, pcat, vbd) / R).astype(bf)
    if name == "C":
        p_sum = (p1.astype(jnp.float32) + p2.astype(jnp.float32)).astype(bf)
        p_diff = (p1.astype(jnp.float32) - p2.astype(jnp.float32)).astype(bf)
        vcat, vneg = jnp.concatenate([v1, v2], 1), jnp.concatenate([v1, -v2], 1)
        acc = _repeat(lambda: _dot(p_sum, vcat) + _dot(p_diff, vneg))
        return (0.5 * acc / R).astype(bf)
    if name == "D":
        return jnp.stack([(_repeat(_dot, v.T, p.T) / R).astype(bf) for p, v in ((p1, v1), (p2, v2))])
    return jnp.stack([(_repeat(_dott, do, p) / R).astype(bf) for p, do in ((p1, do1), (p2, do2))])


@pytest.mark.parametrize("name", n64.VARIANTS)
def test_products_twin_matches_n64_variant(name):
    """Each variant through ``make_operands`` and the products twin (R=3,
    PAIRS=2, bq=64, bk=128, d=64) against the script's formula per pair."""
    arrays = _normal(2, (P, NQ, NK), (P, NQ, NK), (P, NK, D), (P, NK, D), (P, NQ, D), (P, NQ, D))
    jx, tx = zip(*(_both(x) for x in arrays))
    ref = jax.vmap(functools.partial(_jax_variant, name))(*jx)
    if name in ("A", "D", "E"):  # [P, 2, ., .] → the port's batch of 2·P, heads first
        ref = jnp.swapaxes(ref, 0, 1).reshape(2 * P, *ref.shape[2:])
    got = n64.run_variant(n64.make_operands(*tx), name, R)
    _assert_bf16_close(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), 2**-12)


# ---------------------------------------------------------------------------
# 9d: exp_packed_pv._kern
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_out", [64, 128])
def test_resident_products_match_packed_pv_kernel(n_out):
    """``_kern`` (steps=3 on grid-resident [64, 128] x [128, n_out] tiles),
    interpreted, against the resident-products twin."""
    pv = _script("exp_packed_pv")
    steps = 3
    (jp, tp), (jv, tv) = (_both(x) for x in _normal(3, (64, 128), (128, n_out)))
    fn = pl.pallas_call(
        pv._kern,
        grid=(steps,),
        in_specs=[pl.BlockSpec((64, 128), lambda i: (0, 0)),
                  pl.BlockSpec((128, n_out), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((64, n_out), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((64, n_out), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((64, n_out), jnp.float32)],
        interpret=True,
    )
    ref = np.asarray(fn(jp, jv).astype(jnp.float32))
    got = ppv.resident_products(tp, tv, steps, copies=2)
    assert got.shape == (2, 64, n_out)
    for copy in got:
        _assert_bf16_close(copy.float().numpy(), ref, 2**-12)


@pytest.mark.parametrize("probe", [fo, fts, n64, ppv], ids=lambda m: m.__name__.split(".")[-1])
def test_probe_runs_measure_only_the_card(probe):
    with pytest.raises(ValueError, match="CUDA device"):
        probe.run("cpu")
