"""The port's flash attention (plain twins on the CPU) against the JAX
package's Pallas flash attention run in the Pallas interpreter."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import depth_completion_tpu.ops.flash_attention as fa
from depth_completion_tpu_torch.ops import flash_attention as tfa
from depth_completion_tpu_torch.ops import ring_attention


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small CPU shapes: two threads, restored after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def interpret_mode():
    fa.INTERPRET = True
    yield
    fa.INTERPRET = False


def _inputs(s, sk, c=128, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, n, c)).astype(np.float32) for n in (s, sk, sk, s)]


def _jax_vjp(fn, q, k, v, g):
    """→ (fn(q, k, v), its vjp with ``g``), jitted as one program (the
    Pallas kernels in the interpreter)."""
    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(g)

    return run(*(jnp.asarray(x) for x in (q, k, v, g)))


@pytest.mark.parametrize("s,c,heads", [(256, 128, 2), (200, 128, 2), (200, 256, 2),
                                        (256, 256, 1)],
                         ids=["aligned", "ragged", "d128_ragged", "d256_aligned"])
def test_flash_matches_jax_forward_and_grads(s, c, heads):
    """fp32 operands (the port's --precision fp32) at head dims 64 (the
    UNet), 128 and 256 (where the generic kernels take them on the card)."""
    q, k, v, g = _inputs(s, s, c=c)

    def jfn(q, k, v):
        return fa.flash_attention(
            q, k, v, heads, block_q=128, block_k=128, bwd_block_q=128,
            bwd_block_k=128, min_seq_len=1,
        )

    out_j, grads_j = _jax_vjp(jfn, q, k, v, g)

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out_t = tfa.flash_attention(tq, tk, tv, heads, min_seq_len=1)
    grads_t = torch.autograd.grad(out_t, (tq, tk, tv), torch.from_numpy(g))

    # fp32 on both sides; the forward differs only by summation order
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-5)
    # the JAX backward rounds its per-KV-block dq partials to bf16 (0.4%
    # relative): dq at 1e-2 of its largest magnitude; dk, dv are fp32
    for name, gt, gj in zip("qkv", grads_t, grads_j):
        gj = np.asarray(gj)
        tol = 1e-2 * np.abs(gj).max() if name == "q" else 1e-4 * np.abs(gj).max()
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=tol, err_msg=f"d{name}")


def test_cross_attention_routes_to_plain():
    """2 KV tokens: both packages take their plain attention (sk < 768)."""
    q, k, v, _ = _inputs(64, 2)
    out_j = fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2)
    calls = dict(tfa.LAUNCHES)
    out_t = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 2)
    assert tfa.LAUNCHES == calls
    # plain fp32 softmax attention on both sides
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-6)


def test_plain_lse2_is_log2_sum_exp():
    """The row statistic the backward (and later the ring merge) reads:
    lse2 = log2 Σ_k exp2(s·scale·log2 e), fp32."""
    q, k, v, _ = _inputs(96, 80, c=64)
    _, lse2 = tfa.flash_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 1)
    s = (q[0] @ k[0].T) / 8.0
    ref = np.log2(np.exp(s.astype(np.float64)).sum(-1))
    np.testing.assert_allclose(lse2[0, 0].numpy(), ref, rtol=1e-5, atol=1e-5)


FLASH_KW = dict(block_q=128, block_k=128, bwd_block_q=128, bwd_block_k=128, min_seq_len=1)
HEAD_DIMS = pytest.mark.parametrize("c,heads", [(128, 2), (512, 1)], ids=["d64", "d512"])


@HEAD_DIMS
def test_jax_transposed_forward_matches_port(c, heads, monkeypatch):
    """The JAX package's transposed forward (``_fwd_kernel_t``, taken with
    ``FWD_TRANSPOSED``) computes the same function as its forward without
    the TPU layout: held here, in the Pallas interpreter, against the port's
    plain forward, which the Hopper kernels ``flash_fwd`` (d=64) and
    ``flash_fwd_d512`` are held to on the card. Ragged S=200; fp32 on both
    sides, sums in another order."""
    monkeypatch.setattr(fa, "FWD_TRANSPOSED", True)
    q, k, v, _ = _inputs(200, 200, c=c, seed=3)
    out_j = fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, **FLASH_KW)
    out_t, _ = tfa.flash_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-5)


@HEAD_DIMS
def test_jax_two_kernel_backward_matches_port(c, heads, monkeypatch):
    """The JAX package's two-kernel backward (``_bwd_dkv_kernel`` and
    ``_bwd_dq_kernel``, taken with ``FUSED_BWD=False``) against the port's
    plain backward, which the Hopper kernels ``flash_bwd`` and
    ``flash_bwd_d512`` are held to on the card. The two-kernel form sums dq
    in fp32 (unlike the fused one's bf16 partials): every gradient to 1e-4
    of its largest magnitude."""
    monkeypatch.setattr(fa, "FUSED_BWD", False)
    q, k, v, g = _inputs(200, 200, c=c, seed=5)
    _, grads_j = _jax_vjp(lambda q, k, v: fa.flash_attention(q, k, v, heads, **FLASH_KW),
                          q, k, v, g)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out_t = tfa.flash_attention(tq, tk, tv, heads, min_seq_len=1)
    grads_t = torch.autograd.grad(out_t, (tq, tk, tv), torch.from_numpy(g))
    for name, gt, gj in zip("qkv", grads_t, grads_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-4 * np.abs(gj).max(),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_kernel_head_dims(dtype, monkeypatch):
    """Each head dim the JAX package sends to Pallas (64 and the multiples
    of 128 up to 512) maps, in bf16 and fp32, to a kernel entry point and a
    launch count of its own; the ring's steps the same. bf16 at 64 and 512
    keep the tuned kernels of flash_attention.cu and their names. Above 512
    the operand check raises and names the limit; a head dim of 96 takes the
    plain attention, as in JAX, and never reaches a kernel wrapper (the
    checks are device-independent, so they run here). The bf16 form of this
    test pinned a raise at 128-384 and for the d=512 ring: the kernels
    there now exist."""
    tag = "bf16" if dtype == torch.bfloat16 else "fp32"
    lib = "flash_generic_bf16" if dtype == torch.bfloat16 else "flash_generic_f32"
    suffix = lib.rsplit("_", 1)[1]
    generic = (lib, f"dct_flash_fwd_{suffix}", f"dct_flash_bwd_{suffix}")
    tuned = {64: ("flash_attention", "dct_flash_fwd", "dct_flash_bwd", "flash_fwd", "flash_bwd"),
             512: ("flash_attention", "dct_flash_fwd_d512", "dct_flash_bwd_d512",
                   "flash_fwd_d512", "flash_bwd_d512")}
    for d in (64, 128, 256, 384, 512):
        x = torch.zeros((1, 8, 2 * d), dtype=dtype)
        assert tfa._check_cuda_operands(x, x, head_dim=d) == dtype
        if dtype == torch.bfloat16 and d in tuned:
            assert tfa.route(dtype, d) == tuned[d]
        else:
            assert tfa.route(dtype, d) == (*generic, f"flash_fwd_{tag}_d{d}",
                                           f"flash_bwd_{tag}_d{d}")
        if dtype == torch.bfloat16 and d == 64:
            assert tfa.route(dtype, d, ring=True) == (
                "flash_attention", "dct_flash_fwd_ring", "dct_flash_bwd_ring", "flash_fwd_ring",
                "flash_bwd_ring")
        else:
            assert tfa.route(dtype, d, ring=True) == (
                *generic, f"flash_fwd_ring_{tag}_d{d}", f"flash_bwd_ring_{tag}_d{d}")
        for ring in (False, True):
            assert tfa.launch_names(dtype, d, ring) == tfa.route(dtype, d, ring)[3:]
            assert set(tfa.launch_names(dtype, d, ring)) <= set(tfa.LAUNCHES)
    x = torch.zeros((1, 8, 640), dtype=dtype)
    with pytest.raises(NotImplementedError, match="MAX_HEAD_DIM=512"):
        tfa._check_cuda_operands(x, head_dim=640)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tfa._check_cuda_operands(x.half(), head_dim=640)
    # 40 names: fwd and bwd, whole calls and ring steps, 2 dtypes, 5 head dims
    assert len(tfa.LAUNCHES) == 40

    # routing above the wrappers: 96 (neither 64 nor a multiple of 128) takes
    # the plain attention and the ring's step twins; 128 the kernel path
    def no_kernel(*args):
        raise AssertionError("routed to the kernels")

    monkeypatch.setattr(tfa.FlashAttention, "apply", no_kernel)
    q = torch.randn((1, 800, 192), dtype=dtype)
    out = tfa.flash_attention(q, q, q, 2)  # d = 96, S = 800 >= 768
    assert torch.equal(out, tfa.plain_attention(q, q, q, 2))
    with pytest.raises(AssertionError, match="routed to the kernels"):
        tfa.flash_attention(torch.zeros((1, 800, 256), dtype=dtype), *[torch.zeros(
            (1, 800, 256), dtype=dtype)] * 2, 2)  # d = 128
    assert ring_attention.ring_steps(96) == (tfa.flash_fwd_ring_plain, tfa.flash_bwd_ring_plain)
    for d in (64, 128, 256, 384, 512, 640):
        assert ring_attention.ring_steps(d) == (tfa.flash_fwd_ring, tfa.flash_bwd_ring)


# every (dtype, head dim, ring) the kernels take → (library, forward and
# backward entry points, launch-count names), written out: bf16 at 64 (and
# at 512 for whole calls) the tuned kernels, every other pair the generic
# pair of its dtype
_ROUTES = {
    ("bf16", 64, False): ("flash_attention", "dct_flash_fwd", "dct_flash_bwd", "flash_fwd",
                          "flash_bwd"),
    ("bf16", 64, True): ("flash_attention", "dct_flash_fwd_ring", "dct_flash_bwd_ring",
                         "flash_fwd_ring", "flash_bwd_ring"),
    ("bf16", 512, False): ("flash_attention", "dct_flash_fwd_d512", "dct_flash_bwd_d512",
                           "flash_fwd_d512", "flash_bwd_d512"),
    **{("bf16", d, ring): ("flash_generic_bf16", "dct_flash_fwd_bf16", "dct_flash_bwd_bf16",
                           f"flash_fwd_{'ring_' if ring else ''}bf16_d{d}",
                           f"flash_bwd_{'ring_' if ring else ''}bf16_d{d}")
       for d in (128, 256, 384) for ring in (False, True)},
    ("bf16", 512, True): ("flash_generic_bf16", "dct_flash_fwd_bf16", "dct_flash_bwd_bf16",
                          "flash_fwd_ring_bf16_d512", "flash_bwd_ring_bf16_d512"),
    **{("fp32", d, ring): ("flash_generic_f32", "dct_flash_fwd_f32", "dct_flash_bwd_f32",
                           f"flash_fwd_{'ring_' if ring else ''}fp32_d{d}",
                           f"flash_bwd_{'ring_' if ring else ''}fp32_d{d}")
       for d in (64, 128, 256, 384, 512) for ring in (False, True)},
}


@pytest.mark.parametrize("key", sorted(_ROUTES),
                         ids=lambda k: f"{k[0]}-d{k[1]}-{'ring' if k[2] else 'call'}")
def test_route_pinned(key):
    """Each (dtype, head dim, ring) of ``HEAD_DIMS`` keeps its library, entry
    points and launch-count names, so a kernel's redesign cannot move a
    pair to another kernel, or its launches to another count, unnoticed."""
    tag, d, ring = key
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[tag]
    assert d in tfa.HEAD_DIMS
    assert tuple(tfa.route(dtype, d, ring)) == _ROUTES[key]
    assert tfa.launch_names(dtype, d, ring) == _ROUTES[key][3:]
    assert set(_ROUTES[key][3:]) <= set(tfa.LAUNCHES)
    assert len(_ROUTES) == 2 * 2 * len(tfa.HEAD_DIMS)


# the ring step twins over P key blocks of 150 rows (ragged against the
# kernels' 64-row tiles), 2 heads of d=64, a batch of 2 and 100 query rows
RING_PS = pytest.mark.parametrize("p", [1, 2, 3, 4])


def _ring_blocks(p, seed):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.normal(size=(2, 100, 128)).astype(np.float32)) for _ in "qd")
    k, v = (torch.from_numpy(rng.normal(size=(2, 150 * p, 128)).astype(np.float32)) for _ in "kv")
    return q, k, v, do, [slice(b * 150, (b + 1) * 150) for b in range(p)]


@RING_PS
def test_ring_step_twin_matches_flash_fwd_plain(p):
    """``flash_fwd_ring_plain`` over P visiting blocks, the state carried
    from step to step, equals ``flash_fwd_plain`` over all the keys at once
    in o and lse2. fp32 on both sides; the carried sums are taken in
    another order: rtol 1e-5 (tens of fp32 ulps), lse2 (|lse2| ~ 10) to
    1e-5."""
    q, k, v, _, blocks = _ring_blocks(p, seed=11)
    state = None
    for i, b in enumerate(blocks):
        state = tfa.flash_fwd_ring_plain(q, k[:, b], v[:, b], 2, state, last=i == p - 1)
    o, lse2 = state
    o_ref, lse2_ref = tfa.flash_fwd_plain(q, k, v, 2)
    np.testing.assert_allclose(o.numpy(), o_ref.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lse2.numpy(), lse2_ref.numpy(), rtol=0, atol=1e-5)


@RING_PS
def test_ring_bwd_step_twin_matches_flash_bwd_plain(p):
    """``flash_bwd_ring_plain`` over P visiting blocks equals
    ``flash_bwd_plain`` over all the keys: dq summed in place over the
    blocks, each block's dk|dv in its own rows (no rotation here: one query
    shard). fp32, sums in another order: 1e-5 of each gradient's largest
    magnitude."""
    q, k, v, do, blocks = _ring_blocks(p, seed=12)
    o, lse2 = tfa.flash_fwd_plain(q, k, v, 2)
    dq_ref, dk_ref, dv_ref = tfa.flash_bwd_plain(q, k, v, o, do, lse2, 2)
    state, dks, dvs = None, [], []
    for b in blocks:
        di, dq, dkv = tfa.flash_bwd_ring_plain(q, k[:, b], v[:, b], o, do, lse2, 2, state)
        dks.append(dkv[..., :128].clone())
        dvs.append(dkv[..., 128:].clone())
        state = (di, dq, torch.zeros_like(dkv))
    for got, ref in ((dq, dq_ref), (torch.cat(dks, 1), dk_ref), (torch.cat(dvs, 1), dv_ref)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))
