"""One rank of the port's distributed tests, started in a forked process by
``tests/test_torch_parallel.py`` and ``tests/test_torch_distributed.py``:
joins the gloo group through ``core.distributed.initialize`` (file-store
rendezvous), runs the jobs the test wrote, in order, and saves what the
rank holds. Every rank runs every job: the meshes' subgroups are created by
all of them in one order. Imports torch and the port only."""

import os

import torch
import torch.distributed as dist


def _bundle(trees, unet_config):
    from depth_completion_tpu_torch.models import registry
    from depth_completion_tpu_torch.models.weights import from_jax_params

    unet_np, taesd_np, ctx = trees
    return from_jax_params(unet_np, taesd_np, ctx, unet_config=unet_config,
                           vae_config=registry.TINY_TAESD_CONFIG, device="cpu")


def _mesh(data, model):
    from depth_completion_tpu_torch.core.mesh import MeshSpec, make_mesh

    return make_mesh(MeshSpec(data=data, model=model), ranks=range(data * model))


def _numpy(out):
    return tuple(o.detach().float().numpy() for o in out)


def mesh_layouts(specs):
    """Per (data, model) spec: the mesh's shape, this rank's coordinates and
    the global ranks of its data and model groups (None outside the grid)."""
    from depth_completion_tpu_torch.core.mesh import AXIS_DATA, AXIS_MODEL, MeshSpec, make_mesh

    out = {}
    for data, model in specs:
        mesh = make_mesh(MeshSpec(data=data, model=model))
        groups = {axis: (None if g is None else dist.get_process_group_ranks(g))
                  for axis, g in mesh.groups.items()}
        out[(data, model)] = {"shape": mesh.shape, "coords": mesh.coords,
                              AXIS_DATA: groups[AXIS_DATA], AXIS_MODEL: groups[AXIS_MODEL]}
    return out


def pipeline_run(trees, unet_config, images, sparses, data, model, overrides):
    """The pipeline on a (data, model) mesh, the batch split over the data
    axis and the UNet tensor-parallel over the model axis → (denses,
    latents, the step program's state: latent, Adam m and v, affine and its
    Adam m and v)."""
    from depth_completion_tpu_torch.parallel.sharding import shard_bundle
    from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline

    mesh = _mesh(data, model)
    bundle = shard_bundle(mesh, _bundle(trees, unet_config), tensor_parallel=model > 1)
    pipe = DepthCompletionPipeline(bundle)
    out = pipe(images, sparses, data_mesh=mesh, **overrides)
    (key,) = pipe.program_keys()
    program = pipe.programs.get(key, None)
    state = [t for tensors in program.state_groups().values() for t in tensors]
    return {"out": _numpy(out), "state": _numpy(state)}


def ensemble_run(trees, unet_config, images, sparses, ensemble_size, overrides):
    """An ensemble over the data axis of every rank, and on rank 0 the same
    ensemble in that process alone → (mesh outputs, one-process outputs or
    None)."""
    from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline

    mesh = _mesh(dist.get_world_size(), 1)
    pipe = DepthCompletionPipeline(_bundle(trees, unet_config))
    kw = dict(overrides, ensemble_size=ensemble_size)
    return {"mesh": _numpy(pipe(images, sparses, ensemble_mesh=mesh, **kw)),
            "alone": _numpy(pipe(images, sparses, **kw)) if dist.get_rank() == 0 else None}


def ring_run(trees, unet_config, images, sparses, overrides):
    """Native-resolution mode through the sampler: a ``ProcessGroupRing``
    over every rank, and on rank 0 ``LocalRing(world)`` in that process
    alone (or None)."""
    from depth_completion_tpu_torch.ops.ring_attention import LocalRing, ProcessGroupRing
    from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline

    pipe = DepthCompletionPipeline(_bundle(trees, unet_config))
    out = {"group": _numpy(pipe(images, sparses, ring_mesh=ProcessGroupRing(), **overrides))}
    out["local"] = _numpy(pipe(images, sparses, ring_mesh=LocalRing(dist.get_world_size()),
                               **overrides)) if dist.get_rank() == 0 else None
    return out


def predict_runs(argvs, env):
    """The predict CLI in process, once per argv (``--multihost true``: the
    group is already joined, so it stays) → each run's totals."""
    from depth_completion_tpu_torch.cli import predict

    os.environ.update(env)
    return [predict.main(argv) for argv in argvs]


JOBS = {f.__name__: f for f in (mesh_layouts, pipeline_run, ensemble_run, ring_run, predict_runs)}


def run(rank: int, world: int, store: str, jobs: str, out: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from depth_completion_tpu_torch.core.distributed import initialize

    initialize(device="cpu", init_method=f"file://{store}")
    try:
        results = {}
        for name, (job, kwargs) in torch.load(jobs, weights_only=False).items():
            results[name] = JOBS[job](**kwargs)
        torch.save(results, out)
    finally:
        dist.destroy_process_group()


def spawn(world: int, jobs: dict, tmp, timeout: float = 240.0):
    """Start ``world`` ranks on ``jobs`` (name → (job, kwargs)) → a function
    that waits for them and returns each rank's results."""
    import multiprocessing

    torch.save(jobs, tmp / "jobs.pt")
    # ranks fork from one server that has imported torch and the port once
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "tests.torch_parallel_worker",
                                "depth_completion_tpu_torch.pipeline.pipeline",
                                "depth_completion_tpu_torch.cli.predict"])
    procs = [ctx.Process(target=run, args=(r, world, str(tmp / "store"), str(tmp / "jobs.pt"),
                                           str(tmp / f"out{r}.pt")))
             for r in range(world)]
    for proc in procs:
        proc.start()

    def wait():
        try:
            for proc in procs:
                proc.join(timeout=timeout)
            hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
            assert not hung, f"ranks {hung} did not finish within {timeout} s"
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
        assert [proc.exitcode for proc in procs] == [0] * world
        return [torch.load(tmp / f"out{r}.pt", weights_only=False) for r in range(world)]

    return wait
