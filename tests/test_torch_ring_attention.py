"""The port's ring attention (``ops.ring_attention``) against the JAX
package's, on the CPU in fp32: ``LocalRing`` forward and gradients against
JAX ``ring_attention`` on the virtual mesh and against full attention, one
case against JAX's flash ring in the Pallas interpreter,
``ProcessGroupRing`` under gloo in spawned ranks against ``LocalRing``, and
the guided sampler in native-resolution mode against JAX's ring sampler
and against the port's own run without the ring."""

import multiprocessing

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from depth_completion_tpu.core.mesh import AXIS_DATA
from depth_completion_tpu.models.layers import attention as j_attention
from depth_completion_tpu.ops import flash_attention as j_fa
from depth_completion_tpu.ops.ring_attention import ring_attention as j_ring_attention
from depth_completion_tpu.ops.ring_attention import ring_attention_sharded
from depth_completion_tpu.pipeline import sampler as JS
from depth_completion_tpu_torch.ops import flash_attention as tfa
from depth_completion_tpu_torch.ops.ring_attention import LocalRing, ring_attention
from depth_completion_tpu_torch.pipeline import sampler as TS
from depth_completion_tpu_torch.pipeline.programs import ProgramCache

from tests import torch_ring_worker
from tests.test_ring_attention import _mesh
from tests.test_torch_sampler import _rms, bundles, inputs  # noqa: F401  (fixtures)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small CPU shapes: two threads, restored after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _qkvdo(n, s, c, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(n, s, c)).astype(np.float32) for _ in range(4))


def _port(q, k, v, do, heads, ring):
    """→ (o, (dq, dk, dv)) of the port's ring attention, as numpy."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = ring_attention(q, k, v, heads, ring)
    grads = torch.autograd.grad(o, (q, k, v), torch.from_numpy(do))
    return o.detach().numpy(), tuple(g.numpy() for g in grads)


def _jax_vjp(fn, q, k, v, do):
    """→ (fn(q, k, v), its vjp with ``do``), jitted as one program."""
    @jax.jit
    def run(q, k, v, do):
        o, vjp = jax.vjp(fn, q, k, v)
        return o, vjp(do)

    o, grads = run(*(jnp.asarray(x) for x in (q, k, v, do)))
    return np.asarray(o), tuple(np.asarray(g) for g in grads)


def _jax_flash_ring(q, k, v, heads, mesh):
    """→ (o, the gradient of sum(o²) in q, k, v) of JAX's flash-tiled ring
    (``use_flash="on"``, Pallas bodies in the interpreter, as
    ``tests/test_ring_attention.py:_run_flash_ring`` runs it), jitted as one
    program: the cotangent of sum(o²) is 2·o."""
    sharding = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, AXIS_DATA, None))
    qs, ks, vs = (jax.device_put(jnp.asarray(x), sharding) for x in (q, k, v))

    @jax.jit
    def run(q, k, v):
        o, vjp = jax.vjp(lambda q, k, v: ring_attention_sharded(q, k, v, heads, mesh,
                                                                use_flash="on"), q, k, v)
        return o, vjp(2.0 * o)

    old, j_fa.INTERPRET = j_fa.INTERPRET, True
    try:
        o, grads = run(qs, ks, vs)
    finally:
        j_fa.INTERPRET = old
    return np.asarray(o), tuple(np.asarray(g) for g in grads)


_FULL_ATTENTION = {}  # case → JAX full attention's (o, grads): one compile for every ring size


# the shapes of tests/test_ring_attention.py:25-73: (n, s, c, heads, seed,
# forward (rtol, atol), gradient (rtol, atol))
CASES = {
    "s256": (2, 256, 64, 4, 0, (1e-4, 1e-5), (1e-4, 1e-5)),
    "s64": (1, 64, 32, 2, 1, (1e-4, 1e-5), (1e-4, 1e-5)),
    "stage0": (1, 2304, 320, 5, 2, (1e-4, 1e-4), (1e-4, 1e-3)),
}


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_local_ring_matches_jax(case, p):
    """``LocalRing(P)`` forward and dq/dk/dv against JAX ``ring_attention``
    on a P-device virtual mesh (its XLA body) and against full attention."""
    n, s, c, heads, seed, fwd_tol, grad_tol = CASES[case]
    q, k, v, do = _qkvdo(n, s, c, seed)
    o, grads = _port(q, k, v, do, heads, LocalRing(p))
    mesh = _mesh(p)
    if case not in _FULL_ATTENTION:
        _FULL_ATTENTION[case] = _jax_vjp(lambda q, k, v: j_attention(q, k, v, heads), q, k, v, do)
    refs = {
        "jax ring": _jax_vjp(lambda q, k, v: j_ring_attention(q, k, v, heads, mesh), q, k, v, do),
        "jax attention": _FULL_ATTENTION[case],
    }
    for ref_name, (o_ref, grads_ref) in refs.items():
        np.testing.assert_allclose(o, o_ref, rtol=fwd_tol[0], atol=fwd_tol[1], err_msg=ref_name)
        for g, g_ref, name in zip(grads, grads_ref, "qkv"):
            np.testing.assert_allclose(g, g_ref, rtol=grad_tol[0], atol=grad_tol[1],
                                       err_msg=f"{ref_name} d{name}")


@pytest.mark.parametrize("c", [128, 256], ids=["d64", "d128"])
def test_local_ring_matches_jax_flash_ring(c):
    """Against JAX's flash-tiled ring (``_make_flash_ring``, Pallas kernels
    in the interpreter): 2 heads of d=64 (the UNet's) or d=128 (where the
    ring's generic step kernels take it on the card), fp32, 600 rows on a
    4-ring, so 150-row shards, not a multiple of the 128-row blocks (padded
    and masked there)."""
    q, k, v, _ = _qkvdo(1, 600, c, 6)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = ring_attention(tq, tk, tv, 2, LocalRing(4))
    # the gradient of sum(o²), as tests/test_ring_attention.py takes it
    grads = [g.numpy() for g in torch.autograd.grad(o.square().sum(), (tq, tk, tv))]
    o_ref, grads_ref = _jax_flash_ring(q, k, v, 2, _mesh(4))
    np.testing.assert_allclose(o.detach().numpy(), o_ref, rtol=2e-4, atol=2e-4)
    for g, g_ref, name in zip(grads, grads_ref, "qkv"):
        np.testing.assert_allclose(g, np.asarray(g_ref), rtol=2e-3, atol=2e-3, err_msg=f"d{name}")


@pytest.mark.parametrize("world", [2, 4])
def test_process_group_ring_matches_local_ring(world, tmp_path):
    """``ProcessGroupRing`` under gloo, ``world`` spawned ranks on replicated
    inputs: every rank's output and gradients equal ``LocalRing``'s."""
    q, k, v, do = _qkvdo(2, 128, 64, 7)
    heads = 4
    torch.save(tuple(torch.from_numpy(x) for x in (q, k, v, do)) + (heads,), tmp_path / "in.pt")
    # ranks fork from one server that has imported torch and the port once
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "tests.torch_ring_worker",
                                "depth_completion_tpu_torch.ops.ring_attention"])
    procs = [ctx.Process(target=torch_ring_worker.run,
                         args=(r, world, str(tmp_path / "store"), str(tmp_path / "in.pt"),
                               str(tmp_path / f"out{r}.pt")))
             for r in range(world)]
    for proc in procs:
        proc.start()
    try:
        for proc in procs:
            proc.join(timeout=120)
        hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
        assert not hung, f"ranks {hung} did not finish within 120 s"
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(10)
    assert [proc.exitcode for proc in procs] == [0] * world
    o_ref, grads_ref = _port(q, k, v, do, heads, LocalRing(world))
    for r in range(world):
        got = torch.load(tmp_path / f"out{r}.pt")
        assert got["primary"] == (r == 0)
        np.testing.assert_allclose(got["o"].numpy(), o_ref, rtol=1e-5, atol=1e-5,
                                   err_msg=f"rank {r}")
        for g, g_ref, name in zip(got["grads"], grads_ref, "qkv"):
            np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} d{name}")


@pytest.mark.parametrize("p", [2, 3, 4])
def test_ring_step_state_matches_jax_merge(p):
    """The state ``flash_fwd_ring_plain`` carries between ring steps against
    the JAX ring's online merge (``ring_attention.py:145-165``) rebuilt in
    float64 numpy from per-block (o_b, lse2_b): the step's (m, l, acc) is
    the merge's (M, W, ACC) against its own max, 2^m·l = 2^M·W and
    2^m·acc = 2^M·ACC, after every step; the last step's o and lse2 are
    ACC / W and M + log2 W. 2 shards of 2 heads (d=64), 150-row blocks
    (ragged against the kernels' 64-row tiles). fp32 twin against float64:
    rtol 1e-5, atol 1e-6 of the largest magnitude."""
    rng = np.random.default_rng(21)
    n, s_loc, heads, d = 2, 150, 2, 64
    q = rng.normal(size=(n, s_loc, heads * d))
    k, v = (rng.normal(size=(n, p * s_loc, heads * d)) for _ in "kv")

    def split(x):  # [N, S, C] → [N, heads, S, d]
        return x.reshape(n, -1, heads, d).transpose(0, 2, 1, 3)

    qh = split(q)
    m_j = np.full((n, heads, s_loc), -np.inf)
    w_j = np.zeros((n, heads, s_loc))
    acc_j = np.zeros((n, heads, s_loc, d))
    state = None
    for b in range(p):
        kb, vb = k[:, b * s_loc:(b + 1) * s_loc], v[:, b * s_loc:(b + 1) * s_loc]
        sc = qh @ split(kb).transpose(0, 1, 3, 2) / np.sqrt(d) * np.log2(np.e)
        lse2_b = np.log2(np.exp2(sc).sum(-1))
        o_b = np.exp2(sc - lse2_b[..., None]) @ split(vb)
        m_new = np.maximum(m_j, lse2_b)
        scale_old, scale_b = np.exp2(m_j - m_new), np.exp2(lse2_b - m_new)
        acc_j = acc_j * scale_old[..., None] + o_b * scale_b[..., None]
        w_j = w_j * scale_old + scale_b
        m_j = m_new
        last = b == p - 1
        state = tfa.flash_fwd_ring_plain(
            *(torch.from_numpy(x.astype(np.float32)) for x in (q, kb, vb)), heads, state, last)
        if last:
            break
        m, l, acc = (x.double().numpy() for x in state)
        rel = np.exp2(m - m_j)
        np.testing.assert_allclose(l * rel, w_j, rtol=1e-5, atol=1e-6 * w_j.max())
        np.testing.assert_allclose(split(acc) * rel[..., None], acc_j, rtol=1e-5,
                                   atol=1e-6 * np.abs(acc_j).max())
    o, lse2 = (x.double().numpy() for x in state)
    o_ref = (acc_j / w_j[..., None]).transpose(0, 2, 1, 3).reshape(n, s_loc, heads * d)
    np.testing.assert_allclose(o, o_ref, rtol=1e-5, atol=1e-6 * np.abs(o_ref).max())
    np.testing.assert_allclose(lse2, m_j + np.log2(w_j), rtol=0, atol=1e-5)


def test_ring_rejects_ragged_sequence():
    x = torch.zeros(1, 102, 8)
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(x, x, x, 2, LocalRing(4))
    with pytest.raises(ValueError, match="self-attention"):
        ring_attention(x, torch.zeros(1, 2, 8), torch.zeros(1, 2, 8), 2, LocalRing(2))


def test_ring_sampler_matches_jax_and_base(bundles, inputs):  # noqa: F811
    """Native-resolution mode in the guided sampler: 3 per-step guided
    steps, learned affine, with ``ring_mesh=LocalRing(4)`` (every UNet
    self-attention of the 24x32 latent divides 4: 768, 192 rows) against
    JAX ``guided_sample`` on a 4-device ring mesh, at the bounds of
    ``test_torch_sampler.py``'s guided test; and against the port's own run
    without the ring at the bounds of ``test_ring_attention.py``'s sampler
    test (rtol 1e-3, atol 1e-4)."""
    jbundle, tbundle = bundles
    imgs, sparses, noise = inputs
    kw = dict(steps=3, resolution=64, closed_form=False, max_depth=10.0)
    jfn = jax.jit(JS.guided_sample, static_argnames=("cfg",))
    d_j, l_j = jfn(jbundle, jnp.asarray(imgs), jnp.asarray(sparses),
                   JS.SamplerConfig(**kw, ring_mesh=_mesh(4)), init_noise=jnp.asarray(noise))
    runs = {}
    for name, ring in (("ring", LocalRing(4)), ("base", None)):
        d, lat = TS.guided_sample(tbundle, torch.from_numpy(imgs), torch.from_numpy(sparses),
                                  TS.SamplerConfig(**kw, ring_mesh=ring),
                                  init_noise=torch.from_numpy(noise), programs=ProgramCache())
        runs[name] = (d.numpy(), lat.numpy())
    (d_r, l_r), (d_b, l_b) = runs["ring"], runs["base"]
    assert np.isfinite(d_r).all()
    dd, ll = d_r - np.asarray(d_j), l_r - np.asarray(l_j)
    assert _rms(dd) < 1.2e-2 and np.abs(dd).max() < 0.15 and _rms(ll) < 3.5e-2, (
        _rms(dd), np.abs(dd).max(), _rms(ll))
    np.testing.assert_allclose(d_r, d_b, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(l_r, l_b, rtol=1e-3, atol=1e-4)
