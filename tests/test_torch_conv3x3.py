"""The port's fused 3x3 conv (plain twin on the CPU) and its autograd
Function against the JAX package's Pallas conv in the Pallas interpreter."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import depth_completion_tpu.ops.conv3x3 as c3
from depth_completion_tpu_torch.ops import conv3x3 as tc3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small CPU shapes: two threads, restored after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def interpret_mode():
    c3.INTERPRET = True
    yield
    c3.INTERPRET = False


def _data(n=1, h=12, w=16, c=128, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    k_hwio = (rng.normal(size=(3, 3, c, c)) * 0.05).astype(np.float32)
    b = rng.normal(size=(c,)).astype(np.float32)
    g = rng.normal(size=(n, h, w, c)).astype(np.float32)
    return x, k_hwio, b, g


def _oihw(k_hwio):
    return torch.from_numpy(np.ascontiguousarray(k_hwio.transpose(3, 2, 0, 1)))


# fp32 on both sides: the sums differ only in order (1e-4 absolute on
# outputs of magnitude ~5, as tests/test_conv3x3.py holds the JAX kernel)
ATOL, RTOL = 1e-4, 1e-5


@pytest.mark.parametrize(
    "shape,use_skip,c,relu",
    [((1, 12, 16), False, 128, True), ((1, 12, 16), True, 128, True),
     ((1, 128, 8), True, 128, True), ((1, 12, 16), True, 256, False)],
    ids=["bias_relu", "skip_relu", "two_h_tiles", "kl_256_skip"],
)
def test_conv_forward_and_dx_match_jax(shape, use_skip, c, relu):
    """Forward with bias+ReLU (and skip), and dx through the ReLU mask (with
    and without skip). 128x8 runs the JAX kernel as two 64-row H tiles, so
    the halo rows at the tile seam are exercised on the JAX side. kl_256_skip:
    the KL VAE ResNet's form (bias and residual, no ReLU) at one of its
    widths, fp32 throughout, as ``--precision fp32`` runs it (the fp32
    kernel, ``conv3x3_fp32``, is held to this twin on the card)."""
    n, h, w = shape
    x, k, b, g = _data(n, h, w, c=c, seed=h + int(use_skip))
    skip = (0.3 * x) if use_skip else None

    def jfn(x, skip):
        return c3.conv3x3_fused(x, jnp.asarray(k), jnp.asarray(b), relu=relu, skip=skip)

    y_j, vjp = jax.vjp(jfn, jnp.asarray(x), None if skip is None else jnp.asarray(skip))
    dx_j, dskip_j = vjp(jnp.asarray(g))

    tx = torch.tensor(x, requires_grad=True)
    tskip = None if skip is None else torch.tensor(skip, requires_grad=True)
    y_t = tc3.conv3x3_fused(tx, _oihw(k), torch.from_numpy(b), relu=relu, skip=tskip)
    inputs = (tx,) if tskip is None else (tx, tskip)
    grads = torch.autograd.grad(y_t, inputs, torch.from_numpy(g))

    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(dx_j), rtol=RTOL, atol=ATOL)
    if tskip is not None:
        # dskip is the masked dy: a select, identical on both sides
        np.testing.assert_array_equal(grads[1].numpy(), np.asarray(dskip_j))


def _k_major_gemm(x, w_k):
    """The fp32 kernel's contraction over its K-major weights, in plain
    PyTorch: y[p, co] = sum over K = 9·Ci of x_pad[p + tap shift, ci] ·
    w_k[co, (3·kh + kw)·Ci + ci], the order in which the kernel reads the
    [Co, 3, 3, Ci] rows."""
    n, h, w, ci = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, kh:kh + h, kw:kw + w] for kh in range(3) for kw in range(3)], -1)
    return (cols.reshape(-1, 9 * ci) @ w_k.reshape(w_k.shape[0], -1).T).reshape(n, h, w, -1)


@pytest.mark.parametrize("ci,co", [(16, 24), (24, 8)], ids=["16to24", "24to8"])
@pytest.mark.parametrize("direction", ["forward", "dx"])
def test_k_major_weights_match_jax(direction, ci, co):
    """The layout the fp32 kernel reads (``_k_major``: OHWI, the forward's
    taps and the dx's flip-transposed ones) against ``lax`` at fp32, Ci !=
    Co: through the kernel's K-order contraction, and fed back (as HWIO)
    through ``conv3x3_plain``. The dx is the ReLU-masked backward of
    ``relu(conv(x) + b)``."""
    rng = np.random.default_rng(ci * 7 + co)
    x = rng.normal(size=(1, 7, 9, ci)).astype(np.float32)
    k = (rng.normal(size=(3, 3, ci, co)) * 0.1).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    g = rng.normal(size=(1, 7, 9, co)).astype(np.float32)

    def jfn(x):
        y = jax.lax.conv_general_dilated(x, jnp.asarray(k), (1, 1), ((1, 1), (1, 1)),
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jnp.maximum(y + jnp.asarray(b), 0.0)

    y_j, vjp = jax.vjp(jfn, jnp.asarray(x))
    w = _oihw(k)
    if direction == "forward":
        w_k = tc3._k_major(tc3._hwio(w)).contiguous()
        assert w_k.shape == (co, 3, 3, ci)
        ref, inp, mask = np.asarray(y_j), torch.from_numpy(x), None
        gemm = torch.relu(_k_major_gemm(inp, w_k) + torch.from_numpy(b))
        plain = tc3.conv3x3_plain(inp, w_k.permute(1, 2, 3, 0), torch.from_numpy(b),
                                  relu=True)[0]
    else:
        w_k = tc3._k_major(tc3._flip_transpose_hwio(w)).contiguous()
        assert w_k.shape == (ci, 3, 3, co)
        (dx_j,) = vjp(jnp.asarray(g))
        ref, inp, mask = np.asarray(dx_j), torch.from_numpy(g), torch.from_numpy(np.array(y_j))
        gemm = _k_major_gemm(torch.where(mask > 0, inp, torch.zeros_like(inp)), w_k)
        plain = tc3.conv3x3_plain(inp, w_k.permute(1, 2, 3, 0), mask=mask)[0]
    np.testing.assert_allclose(gemm.numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_masked_operand_and_halo_exact():
    """The masked dx call zeroes the operand where mask <= 0, halo rows
    included, and emits the masked operand: the emitted tensor is exactly
    the select, and dx equals an unfused conv of it."""
    x, k, _, g = _data(1, 10, 9, c=16, seed=3)
    mask = torch.from_numpy(x)
    dy = torch.from_numpy(g)
    w = torch.from_numpy(k)
    dx, dy_m = tc3.conv3x3_call(dy, w, mask=mask, emit_masked=True)
    sel = torch.where(mask > 0, dy, torch.zeros_like(dy))
    assert torch.equal(dy_m, sel)
    ref = tc3.conv3x3_call(sel, w)
    assert torch.equal(dx, ref)


def test_conv_c64_matches_lax_conv():
    """TAESD's real width C=64 (the port runs it unpacked) against
    jax.lax.conv_general_dilated + bias + ReLU."""
    x, k, b, _ = _data(2, 9, 11, c=64, seed=5)
    y_j = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    y_j = jnp.maximum(y_j + jnp.asarray(b), 0.0)
    y_t = tc3.conv3x3_fused(torch.from_numpy(x), _oihw(k), torch.from_numpy(b), relu=True)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=RTOL, atol=ATOL)


def test_weight_grads_only_when_asked():
    """dW/db are computed only for weights that require grad; with frozen
    weights the backward returns dx alone (the sampler's case)."""
    x, k, b, g = _data(1, 6, 8, c=16, seed=7)
    tx = torch.tensor(x, requires_grad=True)
    w = _oihw(k).requires_grad_(True)
    tb = torch.tensor(b, requires_grad=True)
    y = tc3.conv3x3_fused(tx, w, tb, relu=True)
    dx, dw, db = torch.autograd.grad(y, (tx, w, tb), torch.from_numpy(g))
    xr = tx.detach().clone().requires_grad_(True)
    wr = w.detach().clone().requires_grad_(True)
    br = tb.detach().clone().requires_grad_(True)
    yr = torch.relu(torch.nn.functional.conv2d(xr.permute(0, 3, 1, 2), wr, br, padding=1)).permute(0, 2, 3, 1)
    rx, rw, rb = torch.autograd.grad(yr, (xr, wr, br), torch.from_numpy(g))
    for got, ref in ((dx, rx), (dw, rw), (db, rb)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-4)
    frozen = tc3.conv3x3_fused(tx, _oihw(k), torch.from_numpy(b), relu=True)
    (dx_only,) = torch.autograd.grad(frozen, (tx,), torch.from_numpy(g))
    np.testing.assert_allclose(dx_only.numpy(), rx.numpy(), rtol=1e-5, atol=1e-4)


def test_kernel_library_name_follows_shared_headers(tmp_path, monkeypatch):
    """The conv and flash kernels include ``csrc/mma_sync.cuh``: a library
    is named by the hash of its source and of the shared headers, so an
    edited header rebuilds every kernel and an unchanged tree reuses it."""
    from depth_completion_tpu_torch import _build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("k")
    assert _build._target("k") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    assert _build._target("k") != first
    assert (_build.CSRC / "k.cu").exists() and not first.exists()
