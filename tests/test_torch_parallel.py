"""The port's rank mesh, sharding rules and data and tensor parallelism
(``core.mesh``, ``parallel.sharding``, the UNet's tensor-parallel pairs,
the pipeline's data-parallel request) against the JAX package, on the CPU.

The distributed runs are gloo ranks in spawned processes
(``tests/torch_parallel_worker.py``): one group of world 2 and one of world
4, each started once for the module, running every job the tests compare
while the JAX references compile. Geometry as ``tests/test_parallel.py``:
32x48 frames at resolution 64, 2 steps, the tiny UNet; the tensor-parallel
runs use a tiny UNet whose stage 0 has 1 head (it does not divide M, so
that attention stays whole) and whose mid block has 4."""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec

from depth_completion_tpu.core import mesh as jmesh
from depth_completion_tpu.models import registry as jreg
from depth_completion_tpu.models.bundle import VAE as JVAE
from depth_completion_tpu.models.bundle import ModelBundle as JBundle
from depth_completion_tpu.parallel import sharding as jsharding
from depth_completion_tpu.pipeline.sampler import SamplerConfig, guided_sample
from depth_completion_tpu_torch.core import mesh as tmesh
from depth_completion_tpu_torch.models import registry
from depth_completion_tpu_torch.models.unet import ModelShard
from depth_completion_tpu_torch.models.weights import from_jax_params
from depth_completion_tpu_torch.parallel import sharding as tsharding

from tests import torch_parallel_worker
from tests.test_parallel import _inputs, _mesh
from tests.test_torch_weights import tiny_jax_trees

CFG = SamplerConfig(steps=2, resolution=64, max_depth=120.0)
OVERRIDES = dict(steps=2, resolution=64, max_depth=120.0)
TP_JAX_CONFIG = dataclasses.replace(jreg.TINY_UNET_CONFIG, num_heads=(1, 4))
TP_CONFIG = dataclasses.replace(registry.TINY_UNET_CONFIG, num_heads=(1, 4))
# world → {job name: (data, model)} of the pipeline runs
DP_RUNS = {2: {"dp": (2, 1)}}
TP_RUNS = {2: {"tp": (1, 2)}, 4: {"dp_tp": (2, 2), "tp4": (1, 4)}}
LAYOUTS = {2: [(-1, 1), (-1, 2), (2, 1)], 4: [(-1, 1), (-1, 2), (2, 2), (1, 4)]}


def _jax_bundle(trees, config):
    unet_np, taesd_np, ctx = trees
    return JBundle(unet_params=jax.tree.map(jnp.asarray, unet_np), unet_config=config,
                   vae=JVAE(kind="tiny", params=jax.tree.map(jnp.asarray, taesd_np),
                            config=jreg.TINY_TAESD_CONFIG),
                   text_context=jnp.asarray(ctx))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups' results and the JAX references: JAX ``shard_bundle`` +
    ``shard_batch`` + ``guided_sample`` on the 8-device virtual mesh (data
    parallel) and JAX's replicated run of the tensor-parallel config."""
    trees = tiny_jax_trees(seed=0)
    tp_trees = tiny_jax_trees(unet_config=TP_JAX_CONFIG, seed=0)
    images4, sparses4 = _inputs(4)
    images2, sparses2 = _inputs(2)
    waits = {}
    for world in (2, 4):
        jobs = {"layouts": ("mesh_layouts", {"specs": LAYOUTS[world]})}
        for name, (data, model) in DP_RUNS.get(world, {}).items():
            jobs[name] = ("pipeline_run", dict(trees=trees, unet_config=registry.TINY_UNET_CONFIG,
                                               images=images4, sparses=sparses4, data=data,
                                               model=model, overrides=OVERRIDES))
        for name, (data, model) in TP_RUNS[world].items():
            jobs[name] = ("pipeline_run", dict(trees=tp_trees, unet_config=TP_CONFIG,
                                               images=images2, sparses=sparses2, data=data,
                                               model=model, overrides=OVERRIDES))
        waits[world] = torch_parallel_worker.spawn(world, jobs,
                                                   tmp_path_factory.mktemp(f"world{world}"))
    jfn = jax.jit(guided_sample, static_argnames=("cfg",))
    mesh = _mesh(4, 2)
    bundle_s = jsharding.shard_bundle(mesh, _jax_bundle(trees, jreg.TINY_UNET_CONFIG))
    im_s, sp_s = jsharding.shard_batch(mesh, jnp.asarray(images4), jnp.asarray(sparses4))
    dp_ref = jfn(bundle_s, im_s, sp_s, CFG)
    tp_ref = jfn(_jax_bundle(tp_trees, TP_JAX_CONFIG), jnp.asarray(images2),
                 jnp.asarray(sparses2), CFG)
    refs = {"dp": tuple(np.asarray(x) for x in dp_ref), "tp": tuple(np.asarray(x) for x in tp_ref)}
    return {world: wait() for world, wait in waits.items()}, refs


# ----- the mesh ----------------------------------------------------------------

@pytest.mark.parametrize("spec", [(3, 3), (-1, 0), (2, 3)])
def test_make_mesh_errors_match_jax(spec):
    """``tests/test_core.py``'s invalid meshes over 8 devices (ranks), and
    one more: the same ``ValueError`` messages."""
    with pytest.raises(ValueError) as jerr:
        jmesh.make_mesh(jmesh.MeshSpec(*spec))
    with pytest.raises(ValueError) as terr:
        tmesh.make_mesh(tmesh.MeshSpec(*spec), ranks=range(8))
    assert str(terr.value) == str(jerr.value)


def test_single_process_mesh():
    """No process group: a 1x1 mesh of this process, whose helpers keep
    everything whole; a mesh over more ranks needs a joined group."""
    mesh = tmesh.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == {"data": 0, "model": 0}
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(tmesh.data_sharding(mesh, x), x)
    assert tmesh.replicated(mesh, x) is x and tmesh.gather_rows(mesh, x) is x
    with pytest.raises(RuntimeError, match="needs a joined process group"):
        tmesh.make_mesh(tmesh.MeshSpec(data=2), ranks=range(2))


@pytest.mark.parametrize("axis", [0, 1])
def test_data_sharding_matches_jax_placement(axis):
    """Each data rank's block equals the shard JAX's ``data_sharding``
    places on the device at that data index (4x2 virtual mesh)."""
    x = np.arange(8 * 8 * 2, dtype=np.float32).reshape(8, 8, 2)
    jm = jmesh.make_mesh(jmesh.MeshSpec(data=4, model=2))
    placed = jax.device_put(x, jmesh.data_sharding(jm, 3, axis))
    by_device = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    grid = np.arange(8).reshape(4, 2)
    for i in range(4):
        mesh = tmesh.Mesh(grid, {"data": i, "model": 0}, {"data": None, "model": None})
        np.testing.assert_array_equal(tmesh.data_sharding(mesh, x, axis),
                                      by_device[jm.devices[i, 0]])
        rows, cols = tsharding.shard_batch(mesh, x, x[:, 0])
        np.testing.assert_array_equal(rows, x[2 * i:2 * i + 2])
        np.testing.assert_array_equal(cols, x[2 * i:2 * i + 2, 0])


@pytest.mark.parametrize("world,spec", [(w, s) for w in LAYOUTS for s in LAYOUTS[w]])
def test_mesh_layout_matches_jax(runs, world, spec):
    """The rank grid, each rank's coordinates and its data and model groups
    against JAX ``make_mesh`` over as many devices: rank r sits where
    device r sits."""
    results, _ = runs
    jm = jmesh.make_mesh(jmesh.MeshSpec(*spec), devices=jax.devices()[:world])
    grid = np.vectorize(lambda d: jax.devices().index(d))(jm.devices)
    for r in range(world):
        got = results[world][r]["layouts"][spec]
        assert got["shape"] == dict(jm.shape)
        i, j = (int(v) for v in np.argwhere(grid == r)[0])
        assert got["coords"] == {"data": i, "model": j}
        assert got["data"] == grid[:, j].tolist() and got["model"] == grid[i].tolist()


# ----- the sharding rules ------------------------------------------------------

def _port_path(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _to_port_layout(spec: PartitionSpec, ndim: int) -> tuple:
    """A JAX spec of a [in, out] linear or HWIO conv kernel in the port's
    [out, in] / OIHW layout (trailing Nones dropped, as the port writes
    them)."""
    dims = list(spec) + [None] * (ndim - len(spec))
    if not any(dims):
        return ()
    if ndim == 2:
        dims = dims[::-1]
    elif ndim == 4:
        dims = [dims[3], dims[2], dims[0], dims[1]]
    return tuple(dims)


@pytest.fixture(scope="module")
def tp_trees():
    unet_np, taesd_np, ctx = tiny_jax_trees(unet_config=TP_JAX_CONFIG, seed=0)
    bundle = from_jax_params(unet_np, taesd_np, ctx, unet_config=TP_CONFIG,
                             vae_config=registry.TINY_TAESD_CONFIG, device="cpu")
    return unet_np, bundle


@pytest.mark.parametrize("model", [1, 2, 3, 4, 8])
def test_tp_spec_leaf_by_leaf_matches_jax(tp_trees, model):
    """Every leaf of the tiny UNet: the port's ``unet_tp_spec`` and
    ``unet_param_sharding`` (the divisibility fallback) against JAX's, on
    a mesh whose model axis is ``model``, in the port's layouts."""
    unet_np, bundle = tp_trees
    jm = _mesh(8 // model, model)
    port_leaves = tsharding._flatten(bundle.unet_params)
    flat = jax.tree_util.tree_flatten_with_path(unet_np)[0]
    assert len(flat) == len(port_leaves)
    for path, leaf in flat:
        port_path = _port_path(path)
        tleaf = port_leaves[port_path]
        assert tsharding.unet_tp_spec(port_path, tleaf) == _to_port_layout(
            jsharding.unet_tp_spec(path, leaf), leaf.ndim), port_path
        assert tsharding.unet_param_sharding(types.SimpleNamespace(shape=dict(jm.shape)),
                                             port_path, tleaf) == _to_port_layout(
            jsharding.unet_param_sharding(jm, path, leaf).spec, leaf.ndim), port_path


def _stage(path, config):
    last = len(config.block_out_channels) - 1
    return {"down_blocks": lambda: path[1], "up_blocks": lambda: last - path[1]}.get(
        path[0], lambda: last)()


def _expected_departures(params, config, m):
    """The stated departures, by name: a transformer's own proj_in/proj_out
    ("whole"); a sharded ResNet's norm2 ("norm2"), a ResNet whose groups do
    not divide M ("groups"); an attention of a stage whose heads do not
    divide M ("heads"); a GEGLU proj_in ("halves") — each only where the
    per-leaf spec, with its fallback, would shard the leaf."""
    size = types.SimpleNamespace(shape={"model": m})
    out = {}
    for path, leaf in tsharding._flatten(params).items():
        spec = tsharding.unet_param_sharding(size, path, leaf)
        names = [k for k in path if isinstance(k, str)]
        if "resnets" in names and config.norm_groups % m == 0 and names[-2] == "norm2":
            out[path] = "norm2"
        elif not spec:
            continue
        elif "resnets" in names and config.norm_groups % m:
            out[path] = "groups"
        elif names[-2] in ("proj_in", "proj_out") and "blocks" not in names:
            out[path] = "whole"
        elif names[-3] in ("attn1", "attn2") and config.num_heads[_stage(path, config)] % m:
            out[path] = "heads"
        elif names[-3:-1] == ["ff", "proj_in"]:
            out[path] = "halves"
    return out


@pytest.mark.parametrize("model", [2, 4, 16])
def test_tp_departures_listed_exactly(tp_trees, model):
    """``tp_departures`` names exactly the stated departures from the spec,
    and the placement ``shard_bundle`` applies differs from the spec's
    exactly there (apart from the halves, placed on the spec's dimension)."""
    _, bundle = tp_trees
    params = bundle.unet_params
    got = tsharding.tp_departures(params, TP_CONFIG, model)
    assert got == _expected_departures(params, TP_CONFIG, model)
    assert set(got.values()) >= ({"whole", "halves", "heads"} if model < 16 else {"groups"})
    applied = tsharding.applied_specs(params, TP_CONFIG, model)
    size = types.SimpleNamespace(shape={"model": model})
    differ = {p for p, leaf in tsharding._flatten(params).items()
              if applied[p] != tsharding.unet_param_sharding(size, p, leaf)}
    assert differ == {p for p, why in got.items() if why != "halves"}


def test_shard_bundle_takes_each_ranks_slices(tp_trees):
    """Rank 1 of a model axis of 2 (no process group: the slicing alone):
    a sharded leaf holds the second half of its sharded dimension, a GEGLU
    proj_in the second halves of its value and its gate rows; replicated
    leaves, the VAE and the context are the same tensors."""
    _, bundle = tp_trees
    mesh = tmesh.Mesh(np.arange(2).reshape(1, 2), {"data": 0, "model": 1},
                      {"data": None, "model": None})
    sharded = tsharding.shard_bundle(mesh, bundle, tensor_parallel=True)
    full, mine = tsharding._flatten(bundle.unet_params), tsharding._flatten(sharded.unet_params)
    applied = tsharding.applied_specs(bundle.unet_params, TP_CONFIG, 2)
    for path, leaf in full.items():
        spec = applied[path]
        if not spec:
            assert mine[path] is leaf, path
            continue
        dim = spec.index("model")
        if path[-2:] in (("proj_in", "kernel"), ("proj_in", "bias")):
            f = leaf.shape[0] // 2
            want = torch.cat([leaf[f // 2:f], leaf[f + f // 2:]])
        else:
            want = leaf.narrow(dim, leaf.shape[dim] // 2, leaf.shape[dim] // 2)
        assert torch.equal(mine[path], want), path
    mid = sharded.unet_params["mid_block"]
    assert isinstance(mid["resnets"][0], ModelShard)
    assert isinstance(mid["attentions"][0]["blocks"][0]["attn1"], ModelShard)
    assert not isinstance(sharded.unet_params["down_blocks"][0]["attentions"][0]["blocks"][0]
                          ["attn1"], ModelShard)  # 1 head: whole
    assert sharded.vae is bundle.vae and sharded.text_context is bundle.text_context


# ----- data and tensor parallelism against JAX ---------------------------------

def test_data_parallel_matches_jax_sharded(runs):
    """World 2, data axis 2, 4 rows: every rank's gathered dense maps and
    latents against JAX's sharded run on the virtual mesh
    (``test_data_parallel_matches_single_device``'s tolerance)."""
    results, refs = runs
    for r in range(2):
        for got, ref in zip(results[2][r]["dp"]["out"], refs["dp"]):
            np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3, err_msg=f"rank {r}")


@pytest.mark.parametrize("world,name", [(w, n) for w in TP_RUNS for n in TP_RUNS[w]])
def test_tensor_parallel_matches_jax_replicated(runs, world, name):
    """The tensor-parallel UNet (model axis 2 or 4, with data axis 2 at world
    4) against JAX's replicated run (``test_tensor_parallel_matches_
    replicated``'s tolerance), on every rank."""
    results, refs = runs
    for r in range(world):
        for got, ref in zip(results[world][r][name]["out"], refs["tp"]):
            np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3,
                                       err_msg=f"rank {r}")


@pytest.mark.parametrize("world,name", [(w, n) for w in TP_RUNS for n in TP_RUNS[w]])
def test_tensor_parallel_ranks_hold_one_state(runs, world, name):
    """After the run, the ranks of a model group hold the same latent, Adam
    m and v and affine (with its Adam m and v), bit for bit: each rank's
    latent gradient is the whole one (the entry op's all_reduce)."""
    results, _ = runs
    data, model = TP_RUNS[world][name]
    for i in range(data):
        group = [results[world][i * model + j][name]["state"] for j in range(model)]
        for j in range(1, model):
            for a, b, what in zip(group[0], group[j],
                                  ("latent", "m", "v", "scale", "shift", "scale m", "shift m",
                                   "scale v", "shift v")):
                np.testing.assert_array_equal(a, b, err_msg=f"{what}, rank {i * model + j}")
