"""``resize_antialias`` against ``jax.image.resize(antialias=True)`` at the
main path's non-integer ratio (480x640 <-> 576x768, 1.2) and an odd ratio,
forward and gradient."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from depth_completion_tpu.ops import resize as jresize
from depth_completion_tpu_torch.ops import resize as tresize


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small CPU shapes: two threads, restored after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize(
    "src,dst,method",
    [((480, 640), (576, 768), "bilinear"), ((576, 768), (480, 640), "bilinear"),
     ((37, 53), (64, 29), "bilinear"), ((37, 53), (64, 29), "bicubic")],
    ids=["up_1.2", "down_1.2", "odd", "odd_bicubic"],
)
def test_resize_matches_jax(src, dst, method):
    rng = np.random.default_rng(sum(src))
    x = rng.uniform(0, 1, size=(1,) + src + (1,)).astype(np.float32)
    g = rng.normal(size=(1,) + dst + (1,)).astype(np.float32)
    out_j, vjp = jax.vjp(
        lambda a: jresize.resize_antialias(a, dst, method), jnp.asarray(x)
    )
    (dx_j,) = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    out_t = tresize.resize_antialias(tx, dst, method)
    (dx_t,) = torch.autograd.grad(out_t, tx, torch.from_numpy(g))
    # the same weight matrices (built in float64 here, float32 in jax)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=0, atol=1e-5)
    # the gradient is the transposed product: sums of up to ~3 weighted
    # cotangents, so the same bound scaled by max|g|
    np.testing.assert_allclose(
        dx_t.numpy(), np.asarray(dx_j), rtol=0, atol=1e-5 * float(np.abs(g).max()) * 3
    )


def test_nearest_and_geometry_helpers():
    x = np.random.default_rng(1).normal(size=(1, 44, 64, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tresize.resize_antialias(torch.from_numpy(x), (31, 47), "nearest").numpy(),
        np.asarray(jresize.resize_antialias(jnp.asarray(x), (31, 47), "nearest")),
    )
    pt, pad_t = tresize.pad_to_multiple(torch.from_numpy(x))
    pj, pad_j = jresize.pad_to_multiple(jnp.asarray(x))
    assert pad_t == pad_j
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(tresize.unpad(pt, pad_t).numpy(), x)
    for res, size in (((480, 640), 768), ((352, 1216), 768), ((88, 128), 64)):
        assert tresize.processing_size(res, size) == jresize.processing_size(res, size)
        assert tresize.latent_size(res, size) == jresize.latent_size(res, size)


def test_preprocess_matches_jax():
    from depth_completion_tpu.pipeline.preprocess import preprocess_images as jprep
    from depth_completion_tpu_torch.pipeline.preprocess import preprocess_images as tprep

    imgs = np.random.default_rng(2).uniform(0, 255, size=(1, 480, 640, 3)).astype(np.float32)
    xt, pad_t, res_t = tprep(torch.from_numpy(imgs), 768)
    xj, pad_j, res_j = jprep(jnp.asarray(imgs), 768)
    assert (pad_t, res_t) == (pad_j, res_j)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-5)
