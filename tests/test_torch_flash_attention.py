"""The port's flash attention (plain twins on the CPU) against the JAX
package's Pallas flash attention run in the Pallas interpreter."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import depth_completion_tpu.ops.flash_attention as fa
from depth_completion_tpu_torch.ops import flash_attention as tfa


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


@pytest.mark.parametrize("s", [256, 200], ids=["aligned", "ragged"])
def test_flash_matches_jax_forward_and_grads(s):
    q, k, v, g = _inputs(s, s)
    heads = 2  # d = 64

    def jfn(q, k, v):
        return fa.flash_attention(
            q, k, v, heads, block_q=128, block_k=128, bwd_block_q=128,
            bwd_block_k=128, min_seq_len=1,
        )

    out_j, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(g))

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
