"""The port's process group, ensembles over the mesh, native-resolution mode
over ``ProcessGroupRing`` and the predict CLI across ranks, on the CPU:
the counterparts of ``tests/test_multiprocess.py`` and of
``tests/test_parallel.py``'s ensemble over a mesh.

One gloo group of world 2 (``tests/torch_parallel_worker.py``, spawned
once for the module) runs the ensembles, the ring and four CLI runs with
``--multihost true``; two more processes run ``python -m
depth_completion_tpu_torch.cli.predict --multihost true --num-shards 2``
with the ``DCT_*`` environment; JAX's ``ensemble_sample`` over a 2-device
mesh and the single-process CLI runs they are compared with run
meanwhile."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from depth_completion_tpu.models import registry as jreg
from depth_completion_tpu.parallel.ensemble import ensemble_sample
from depth_completion_tpu_torch.cli import predict
from depth_completion_tpu_torch.core.distributed import initialize, is_primary
from depth_completion_tpu_torch.models import registry

from tests import torch_parallel_worker
from tests.test_parallel import _inputs, _mesh
from tests.test_torch_cli import _dataset
from tests.test_torch_parallel import CFG, OVERRIDES, _jax_bundle
from tests.test_torch_weights import tiny_jax_trees

REPO = Path(__file__).resolve().parents[1]
CLI = ["--model", "random", "--steps", "1", "--res", "48", "--precision", "fp32",
       "--compress", "npy", "--vis", "false", "--device", "cpu"]
# name → the CLI's options on the world-2 mesh (with --multihost true)
CLI_RUNS = {
    "dp": ["--batch-size", "2"],  # 3 frames: batches of 2 and 1 (padded)
    "tp": ["--mesh-model", "2"],
    "native": ["--native-res", "true"],
    "ensemble": ["--ensemble", "2", "--ensemble-uncertainty", "true"],
}
# the same runs in one process (the tensor-parallel one without --mesh-model)
ALONE_RUNS = {"dp": CLI_RUNS["dp"], "tp": [], "ensemble": CLI_RUNS["ensemble"]}
TINY_ENV = {"DCT_RANDOM_MODEL_SIZE": "tiny"}
# (frames, members, reduce, uncertainty): E=3 over 2 ranks puts 3 rows, one
# frame's members, on each; E=2 with 3 frames puts rows 0-2 on rank 0 and
# 3-5 on rank 1, whose first row is member 1 (its local index would say 0)
ENSEMBLES = {"e3": (2, 3, "aligned-median", True), "e2": (3, 2, "mean", False)}


def _port_env(**extra):
    env = dict(os.environ, **TINY_ENV, OMP_NUM_THREADS="2", **extra)  # tiny shapes: two threads
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    return env


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small CPU shapes: two threads, restored after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _denses(out: Path, sub: str = "dense") -> np.ndarray:
    return np.stack([np.load(p) for p in sorted((out / "scene" / sub).glob("*.npy"))])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distributed")
    data = _dataset(tmp / "data")
    trees = tiny_jax_trees(seed=0)
    jobs = {}
    for name, (n, e, reduce, unc) in ENSEMBLES.items():
        images, sparses = _inputs(n)
        jobs[name] = ("ensemble_run", dict(
            trees=trees, unet_config=registry.TINY_UNET_CONFIG, images=images, sparses=sparses,
            ensemble_size=e, overrides=dict(OVERRIDES, ensemble_reduce=reduce,
                                            ensemble_uncertainty=unc)))
    images, sparses = _inputs(2)
    jobs["ring"] = ("ring_run", dict(trees=trees, unet_config=registry.TINY_UNET_CONFIG,
                                     images=images, sparses=sparses, overrides=OVERRIDES))
    jobs["cli"] = ("predict_runs", dict(
        argvs=[[str(data), str(tmp / name), *CLI, "--multihost", "true", *opts]
               for name, opts in CLI_RUNS.items()], env=TINY_ENV))
    (tmp / "group").mkdir()
    wait = torch_parallel_worker.spawn(2, jobs, tmp / "group")

    # --multihost true --num-shards 2: two processes, the DCT_* environment
    port, shards = _free_port(), tmp / "shards"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "depth_completion_tpu_torch.cli.predict", str(data), str(shards),
         *CLI, "--multihost", "true", "--shard-index", str(i), "--num-shards", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env=_port_env(DCT_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", DCT_NUM_PROCESSES="2",
                      DCT_PROCESS_ID=str(i), DCT_INIT_TIMEOUT="120"))
        for i in range(2)]

    n, e, reduce, unc = ENSEMBLES["e3"]
    images, sparses = _inputs(n)
    # jit-compatible as a whole (its docstring): one program, not op by op
    jax_e3 = jax.jit(ensemble_sample, static_argnums=(3, 4, 5, 6, 7))(
        _jax_bundle(trees, jreg.TINY_UNET_CONFIG), jnp.asarray(images), jnp.asarray(sparses),
        CFG, e, reduce, _mesh(2, 1), unc)
    alone = {name: tmp / f"alone_{name}" for name in ALONE_RUNS}
    saved = os.environ.get("DCT_RANDOM_MODEL_SIZE")
    os.environ.update(TINY_ENV)
    try:
        for name, opts in ALONE_RUNS.items():
            predict.main([str(data), str(alone[name]), *CLI, *opts])
    finally:
        if saved is None:
            del os.environ["DCT_RANDOM_MODEL_SIZE"]
        else:
            os.environ["DCT_RANDOM_MODEL_SIZE"] = saved
    logs = []
    for proc in procs:
        out, _ = proc.communicate(timeout=240)
        logs.append((proc.returncode, out))
    return {"group": wait(), "jax_e3": tuple(np.asarray(x) for x in jax_e3), "tmp": tmp,
            "alone": alone, "shards": (shards, logs)}


# ----- ensembles over the mesh -------------------------------------------------

def test_ensemble_over_mesh_matches_jax(runs):
    """E=3, aligned median with the uncertainty, the 6 rows over 2 ranks:
    every rank's dense maps, members and MAD against JAX ``ensemble_sample``
    with its rows on a 2-device data axis."""
    for r, res in enumerate(runs["group"]):
        for got, ref, what in zip(res["e3"]["mesh"], runs["jax_e3"], ("dense", "members", "mad")):
            np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3,
                                       err_msg=f"rank {r} {what}")


@pytest.mark.parametrize("name", sorted(ENSEMBLES))
def test_ensemble_over_mesh_runs_the_one_card_rows(runs, name):
    """Each rank's rows draw their members' noise by global row index: the
    mesh's members, reduce and MAD equal the one-process ensemble's (run on
    rank 0)."""
    alone = runs["group"][0][name]["alone"]
    for r, res in enumerate(runs["group"]):
        for got, ref in zip(res[name]["mesh"], alone):
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")
    a, b = (res[name]["mesh"] for res in runs["group"])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)  # every rank returns the whole result


# ----- native resolution over ProcessGroupRing ---------------------------------

def test_process_group_ring_through_sampler_matches_local_ring(runs):
    """The guided sampler with ``ring_mesh=ProcessGroupRing()`` over 2 gloo
    ranks against ``LocalRing(2)`` in one process (rank 0; held to JAX's
    ring by ``tests/test_torch_ring_attention.py``): dense maps and latents."""
    local = runs["group"][0]["ring"]["local"]
    for r, res in enumerate(runs["group"]):
        for got, ref in zip(res["ring"]["group"], local):
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4, err_msg=f"rank {r}")


# ----- the CLI -------------------------------------------------------------------

def test_multihost_num_shards_writes_disjoint_frames(runs):
    """``--multihost true --num-shards 2`` with ``DCT_*``: each process joins
    the group, runs its own frames (0 and 2; 1) and writes them; all three
    dense maps exist (``test_multihost_predict_two_processes``)."""
    shards, logs = runs["shards"]
    for i, (rc, out) in enumerate(logs):
        assert rc == 0, out
        assert "distributed: process" in out, out
        assert f"Shard {i}/2: {2 - i} frames" in out, out
    denses = sorted((shards / "scene" / "dense").glob("*.npy"))
    assert [p.name for p in denses] == ["00000.npy", "00001.npy", "00002.npy"]
    for p in denses:
        d = np.load(p)
        assert d.shape == (48, 64, 1) and np.isfinite(d).all()


@pytest.mark.parametrize("name", sorted(CLI_RUNS))
def test_global_mesh_writes_each_frame_once(runs, name):
    """On a world-2 mesh (data parallel over a padded batch, tensor
    parallel, native resolution, an ensemble's rows) both ranks run every
    frame and rank 0 alone writes it: three dense maps, each written once."""
    totals = [res["cli"][list(CLI_RUNS).index(name)] for res in runs["group"]]
    assert [t["frames"] for t in totals] == [3, 3]
    assert [t["written"] for t in totals] == [3, 0]
    assert totals[1]["dense_bytes"] == 0
    d = _denses(runs["tmp"] / name)
    assert d.shape == (3, 48, 64, 1) and np.isfinite(d).all()
    if name == "ensemble":
        assert _denses(runs["tmp"] / name, "uncertainty").shape == (3, 48, 64, 1)


@pytest.mark.parametrize("name", ["dp", "tp", "ensemble"])
def test_global_mesh_maps_match_one_process(runs, name):
    """The mesh's maps against the same CLI run in one process (for the
    tensor-parallel run: without ``--mesh-model``), at the data- and
    tensor-parallel tolerance."""
    got, ref = _denses(runs["tmp"] / name), _denses(runs["alone"][name])
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


def test_native_res_cli_matches_one_process_without_ring(runs):
    """``--native-res true`` over the 2-rank ring against one process's run
    without a ring (``test_ring_sampler_matches_jax_and_base``'s bound)."""
    np.testing.assert_allclose(_denses(runs["tmp"] / "native"), _denses(runs["alone"]["dp"]),
                               rtol=1e-3, atol=1e-3)


# ----- the process group ---------------------------------------------------------

@pytest.fixture
def clean_env(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                 "DCT_COORDINATOR_ADDRESS", "DCT_NUM_PROCESSES", "DCT_PROCESS_ID",
                 "DCT_INIT_TIMEOUT"):
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    yield monkeypatch
    assert not dist.is_initialized()


def test_initialize_without_configuration_stays_single(clean_env):
    """No torchrun environment and no ``DCT_*``: one process, no group."""
    assert str(initialize(device="cpu")) == "cpu"
    assert is_primary()


def test_initialize_raises_on_bad_explicit_coordinator(clean_env):
    """An explicit coordinator that does not answer raises ``RuntimeError``
    (``test_initialize_raises_on_bad_explicit_coordinator``)."""
    with pytest.raises(RuntimeError, match="explicitly configured"):
        initialize(device="cpu", coordinator_address="127.0.0.1:9", num_processes=2,
                   process_id=1, initialization_timeout=2)


@pytest.mark.parametrize("env", [{"DCT_NUM_PROCESSES": "2", "DCT_PROCESS_ID": "0"},
                                 {"DCT_NUM_PROCESSES": "2"}, {"RANK": "1", "WORLD_SIZE": "2"}])
def test_initialize_raises_on_processes_without_coordinator(clean_env, env):
    """A process count, with or without a process id, and no coordinator
    (``test_initialize_raises_on_processes_without_coordinator``): no rank
    runs alone believing it is rank 0 of 1."""
    for name, value in env.items():
        clean_env.setenv(name, value)
    with pytest.raises(RuntimeError, match="missing a coordinator address"):
        initialize(device="cpu")


def test_native_res_one_rank_is_a_usage_error_under_multihost(tmp_path, clean_env):
    """``--multihost true`` with no group to join leaves one rank: the ring
    needs two, as in JAX."""
    clean_env.setenv("DCT_RANDOM_MODEL_SIZE", "tiny")
    with pytest.raises(SystemExit) as e:
        predict.main([str(_dataset(tmp_path / "data", n=1)), str(tmp_path / "out"), *CLI,
                      "--multihost", "true", "--native-res", "true"])
    assert e.value.code == 2
