"""Batch inference CLI, PyTorch-port counterpart of
``depth_completion_tpu.cli.predict``:

    python -m depth_completion_tpu_torch.cli.predict SRC DST [options]

The same flags, defaults and coercions, parsed with argparse (the JAX CLI
uses click); one more flag, ``--device {cuda,cpu}`` (default ``cuda``),
the counterpart of the JAX CLI honouring ``JAX_PLATFORMS``. With no GPU and
no ``--device cpu`` the command exits with the device error.

- ``--model lcm`` loads the checkpoint directory as ``original`` does and
  samples with the LCM scheduler (latent training off, closed-form affine).
  ``--ensemble N`` runs N members per frame as one batch; with
  ``--ensemble-uncertainty true`` the member MAD map is written under
  ``uncertainty/`` beside ``dense/``, in the dense map's format.
- Inputs may be PNG, JPEG, GIF or BMP frames; ``--compress bl2`` writes
  blosc2 frames through the port's own codec (``io/bl2.py``).
- Several cards, one process per card under ``torchrun`` (JAX
  :348-397): ``--multihost true`` joins the process group
  (``core.distributed.initialize``: torchrun's environment or the
  ``DCT_*`` variables). With ``--num-shards`` > 1 each process then runs
  its own frames on its own card and writes them. Otherwise the ranks form
  one mesh (``core.mesh``): ``--mesh-model M`` ranks per tensor-parallel
  group, and a data axis of ``gcd(batch·ensemble, world / M)`` ranks
  (a warning names the idle ranks, which run nothing), over which a batch
  (padded to ``--batch-size`` with its last frame) or an ensemble's rows
  are split; ``--native-res true`` takes the whole data axis as the ring
  of a ``ProcessGroupRing`` over the UNet's self-attention sequence. Every
  rank of the mesh holds the whole batch's maps; rank 0 alone writes them.
  ``--native-res true`` on one rank, or with ``--ensemble`` > 1, is a usage
  error, as in JAX.
- ``--compile-graph``, ``--compile-mode`` and ``--compile-effort`` are
  accepted and logged as no-ops, as in the JAX CLI: on the card the guided
  step is always captured, one CUDA graph per signature, and replayed at
  every DDIM step (``pipeline.programs``).
- ``--profile-dir`` writes a ``torch.profiler`` Chrome trace of the first
  batch; the device-memory high-water mark is
  ``torch.cuda.max_memory_allocated``; the last lines log it and the kernel
  launches of the run (``Kernel launches: {...}``, JSON, counted from the
  run's start: 0 on the CPU, where the plain versions run).
- The loop is the JAX loop: dataset discovery and pairing, segmask loading
  (read, not used), ``--shard-index/--num-shards``, ``--resume`` (per frame,
  and the temporal ``latent_state.npz`` carry), a two-batch prefetch
  thread, the NaN skip, ``dense/<stem>.<compress>`` and
  ``vis/<stem>_vis.jpg`` grids; a progress line through the logger in
  place of tqdm. The last batch is not padded to ``--batch-size`` (a
  smaller last batch is one more signature: its own program and
  captures), and only a batch's finished dense maps and latents come back
  to the host.

``main(argv)`` returns the run's totals (frames, seconds of IO, inference,
visualisation, image decode and JPEG encode, dense bytes written).
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import json
import math
import sys
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from depth_completion_tpu_torch.cli.common import coerce_guidance_options, init_bundle
from depth_completion_tpu_torch.cli.options import (
    comma_separated,
    existing_dir,
    number_range,
    str2bool,
)
from depth_completion_tpu_torch.core.distributed import initialize, is_primary
from depth_completion_tpu_torch.core.mesh import AXIS_DATA, AXIS_MODEL, MeshSpec, make_mesh
from depth_completion_tpu_torch.device import resolve_device
from depth_completion_tpu_torch.io import (
    DATASET_DIR_NAME_IMAGE,
    DATASET_DIR_NAME_SEGMASK,
    DATASET_DIR_NAME_SPARSE,
    RESULT_DIR_NAME_DENSE,
    RESULT_DIR_NAME_VIS,
    find_dataset_dirs,
    find_img_paths,
    load_img_arrays,
    save_array,
    save_img_array,
    to_depth,
    to_segmask,
)
from depth_completion_tpu_torch.io.csvio import load_segmap
from depth_completion_tpu_torch.logger import LOG_LEVELS, Progress, logger
from depth_completion_tpu_torch.ops.ring_attention import ProcessGroupRing
from depth_completion_tpu_torch.parallel.sharding import shard_bundle
from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline
from depth_completion_tpu_torch.pipeline.programs import launch_counts
from depth_completion_tpu_torch.viz import has_nan, make_grid, visualize_depth

_POS_INT = number_range(int, min=1)
_POS_FLOAT = number_range(float, min=0, min_open=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m depth_completion_tpu_torch.cli.predict",
        description="Predict dense depth maps from sparse depth maps and camera images.")
    p.add_argument("src_root", type=existing_dir)
    p.add_argument("dst_root", type=Path)
    p.add_argument("--model", choices=["original", "lcm", "random"], default="original",
                   help="Marigold model family; random: random weights, smoke tests only.")
    p.add_argument("--checkpoint-dir", type=Path, default=None,
                   help="Local HF-layout checkpoint directory (unet/, vae/, text_encoder/). "
                   "Required unless --model=random.")
    p.add_argument("--taesd-dir", type=Path, default=None,
                   help="Local TAESD checkpoint directory (safetensors), for --vae=light.")
    p.add_argument("--vae", choices=["original", "light"], default="light",
                   help="VAE for decode: original (SD KL VAE) or light (TAESD).")
    p.add_argument("-n", "--steps", type=_POS_INT, default=50, help="Denoising steps.")
    p.add_argument("-r", "--res", type=_POS_INT, default=768,
                   help="Processing resolution (longest side).")
    p.add_argument("--norm", choices=["const", "minmax", "percentile"], default="const",
                   help="Normalization of the input sparse depth maps.")
    p.add_argument("--percentile", type=comma_separated(float), default="0.01,0.99",
                   help="Percentile range for --norm=percentile.")
    p.add_argument("--max-sparse-depth", type=_POS_FLOAT, default=120.0,
                   help="Max distance [m] encoded in sparse depth PNGs.")
    p.add_argument("--max-depth", type=_POS_FLOAT, default=120.0,
                   help="Max distance [m] of output dense depth maps.")
    p.add_argument("--min-depth", type=number_range(float, min=0), default=0.0,
                   help="Min distance [m] of output dense depth maps.")
    p.add_argument("-v", "--vis", type=str2bool, default=True, help="Save visualization grids.")
    p.add_argument("-vr", "--vis-res", type=int, nargs=2, default=(512, -1),
                   metavar=("H", "W"), help="Visualization grid resolution; -1 keeps aspect.")
    p.add_argument("-vo", "--vis-order", type=comma_separated(str),
                   default="image,sparse,dense", help="Views in the grid: image,sparse,dense.")
    p.add_argument("--save-dense", type=str2bool, default=True, help="Save dense depth arrays.")
    p.add_argument("--log", type=Path, default=None, help="Path to save logs.")
    p.add_argument("--log-level", choices=LOG_LEVELS, default="INFO", help="Minimum log level.")
    p.add_argument("-p", "--precision", choices=["bf16", "fp32"], default="bf16",
                   help="Data precision for inference.")
    p.add_argument("-c", "--compress", choices=["npz", "bl2", "npy", "dcz"], default="dcz",
                   help="Array format of the dense depth.")
    p.add_argument("--compile-graph", type=str2bool, default=False,
                   help="Accepted for compatibility; a no-op: every request already runs as "
                   "its program's captured CUDA graphs (prepare, each step, finish), "
                   "replayed from the second run of a signature on.")
    p.add_argument("--compile-mode", choices=["max-autotune", "reduce-overhead", "default"],
                   default="reduce-overhead",
                   help="Accepted for compatibility; a no-op: there is no compiler to tune, "
                   "the graphs replay the hand-written kernels as captured.")
    p.add_argument("--compile-effort", type=number_range(float, min=-1.0, max=1.0),
                   default=None,
                   help="Accepted for compatibility; a no-op: capture has no effort level.")
    p.add_argument("--interp-mode", choices=["bilinear", "nearest"], default="bilinear",
                   help="Interpolation mode for resizing.")
    p.add_argument("--loss-funcs", type=comma_separated(str), default="l1,l2",
                   help="Loss functions: l1, l2, edge, smooth.")
    p.add_argument("--opt", choices=["adam", "sgd", "adagrad"], default="adam",
                   help="Optimizer for latent guidance.")
    p.add_argument("--lr-latent", type=_POS_FLOAT, default=0.05,
                   help="Learning rate for the latent.")
    p.add_argument("--lr-scaling", type=_POS_FLOAT, default=0.005,
                   help="Learning rate for scale/shift parameters.")
    p.add_argument("--kld", type=str2bool, default=False,
                   help="KL-divergence penalty toward N(0,1).")
    p.add_argument("--kld-mode", choices=["simple", "strict"], default="simple",
                   help="KL divergence mode.")
    p.add_argument("--kld-weight", type=_POS_FLOAT, default=0.1, help="KL penalty weight.")
    p.add_argument("-bs", "--batch-size", type=_POS_INT, default=1, help="Batch size.")
    p.add_argument("--use-prev-latent", type=str2bool, default=False,
                   help="Use the previous frame's latents as a temporal prior.")
    p.add_argument("--beta", type=_POS_FLOAT, default=0.9,
                   help="Temporal blend weight (with --use-prev-latent).")
    p.add_argument("--use-segmask", type=str2bool, default=False,
                   help="Load segmentation masks (loaded but unused downstream).")
    p.add_argument("--closed-form", type=str2bool, default=False,
                   help="Closed-form affine parameters instead of learned.")
    p.add_argument("--projection", choices=["linear", "log", "log10"], default="linear",
                   help="Depth projection space.")
    p.add_argument("--inv", type=str2bool, default=False, help="Inverse (disparity) projection.")
    p.add_argument("--train-latents", type=str2bool, default=True,
                   help="Optimize latents during sampling.")
    p.add_argument("--train-method", choices=["per-step", "per-input"], default="per-step",
                   help="Latent training method.")
    p.add_argument("--train-steps", type=_POS_INT, default=10,
                   help="Optimization steps for --train-method=per-input.")
    p.add_argument("--resume", type=str2bool, default=False,
                   help="Skip frames whose dense output already exists.")
    p.add_argument("--shard-index", type=number_range(int, min=0), default=0,
                   help="This worker's shard of the frame list.")
    p.add_argument("--num-shards", type=_POS_INT, default=1,
                   help="Total number of workers sharding the frame list.")
    p.add_argument("--ensemble", type=_POS_INT, default=1,
                   help="Ensemble members per frame.")
    p.add_argument("--ensemble-reduce",
                   choices=["median", "mean", "aligned-median", "aligned-mean"],
                   default="median", help="Ensemble reduction.")
    p.add_argument("--ensemble-uncertainty", type=str2bool, default=False,
                   help="Save a per-pixel ensemble uncertainty map (needs --ensemble>1).")
    p.add_argument("--mesh-model", type=_POS_INT, default=1,
                   help="Tensor-parallel axis size (ranks per model group).")
    p.add_argument("--native-res", type=str2bool, default=False,
                   help="Ring attention over a multi-device data axis (needs two or more "
                   "devices).")
    p.add_argument("--fast-guidance", type=str2bool, default=False,
                   help="Skip the UNet backward in the guidance gradient.")
    p.add_argument("--profile-dir", type=Path, default=None,
                   help="Write a torch.profiler Chrome trace of the first batch here.")
    p.add_argument("--multihost", type=str2bool, default=False,
                   help="Join the process group (torchrun's environment or DCT_*).")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Device to run on (the tests pass cpu).")
    return p


def parse_args(argv: list[str] | None = None) -> tuple[argparse.ArgumentParser, dict[str, Any]]:
    parser = build_parser()
    params = vars(parser.parse_args(argv))
    params["vis_res"] = tuple(params["vis_res"])
    return parser, params


def main(argv: list[str] | None = None) -> dict[str, Any]:
    """The CLI; a process group that ``--multihost true`` joined here is
    left again at the end."""
    parser, params = parse_args(argv)
    joins = params["multihost"] and not dist.is_initialized()
    try:
        return run_predict(parser=parser, **params)
    finally:
        if joins and dist.is_initialized():
            dist.destroy_process_group()


def run_predict(
    src_root: Path,
    dst_root: Path,
    model: str,
    checkpoint_dir: Path | None,
    taesd_dir: Path | None,
    vae: str,
    steps: int,
    res: int,
    norm: str,
    percentile: list[float],
    max_sparse_depth: float,
    max_depth: float,
    min_depth: float,
    vis: bool,
    vis_res: tuple[int, int],
    vis_order: list[str],
    save_dense: bool,
    log: Path | None,
    log_level: str,
    precision: str,
    compress: str,
    compile_graph: bool,
    compile_mode: str,
    interp_mode: str,
    loss_funcs: list[str],
    opt: str,
    lr_latent: float,
    lr_scaling: float,
    kld: bool,
    kld_mode: str,
    kld_weight: float,
    batch_size: int,
    use_prev_latent: bool,
    beta: float,
    use_segmask: bool,
    closed_form: bool,
    projection: str,
    inv: bool,
    train_latents: bool,
    train_method: str,
    train_steps: int,
    resume: bool = False,
    shard_index: int = 0,
    num_shards: int = 1,
    ensemble: int = 1,
    ensemble_reduce: str = "median",
    ensemble_uncertainty: bool = False,
    mesh_model: int = 1,
    native_res: bool = False,
    fast_guidance: bool = False,
    profile_dir: Path | None = None,
    multihost: bool = False,
    compile_effort: float | None = None,
    device: str = "cuda",
    parser: argparse.ArgumentParser | None = None,
) -> dict[str, Any]:
    logger.configure(level=log_level, log_path=log)
    dev = resolve_device(device)
    launches_before = launch_counts()

    # ----- option validation / coercion (the JAX CLI's rules) -------------
    if vis:
        vis_order_ok = []
        for view in vis_order:
            if view not in ("image", "sparse", "dense"):
                logger.error(f"Invalid order (skipped): {view}")
                continue
            vis_order_ok.append(view)
        if not vis_order_ok:
            logger.critical("No valid visualization order specified")
            sys.exit(1)
        vis_order = vis_order_ok

    if use_prev_latent and batch_size > 1:
        logger.warning("batch_size is forced to 1 when use_prev_latent=True")
        batch_size = 1
    if ensemble > 1 and use_prev_latent:
        logger.error(
            "ensembling is not supported with --use-prev-latent. Falling back to --ensemble=1"
        )
        ensemble = 1
    if ensemble_uncertainty and ensemble <= 1:
        logger.warning("--ensemble-uncertainty requires --ensemble>1; disabled")
        ensemble_uncertainty = False
    loss_funcs, norm, train_latents, closed_form = coerce_guidance_options(
        loss_funcs, norm, projection, inv, model, train_latents, closed_form
    )

    # ----- ranks and mesh (the JAX CLI's sizing) --------------------------
    if multihost:
        dev = initialize(dev)
    # with --num-shards > 1 each process runs its own frames on its own
    # card; otherwise every rank of the group joins one mesh
    world = dist.get_world_size() if dist.is_initialized() and num_shards == 1 else 1
    mesh = None
    if world > 1 or mesh_model > 1:
        total_rows = batch_size * ensemble
        if native_res:  # the ring splits the sequence, not the batch
            data_axis = max(world // mesh_model, 1)
        else:
            data_axis = math.gcd(total_rows, max(world // mesh_model, 1))
        if not native_res and data_axis * mesh_model < world:
            logger.warning(
                f"Using {data_axis * mesh_model}/{world} devices — make batch_size*ensemble "
                f"({total_rows}) a multiple of {world // mesh_model} to use the full mesh")
        mesh = make_mesh(MeshSpec(data=data_axis, model=mesh_model),
                         ranks=range(min(data_axis * mesh_model, world)))
        logger.info(f"Mesh: data={data_axis} x model={mesh_model}")
    if native_res:
        msg = None
        if ensemble > 1:
            msg = "--native-res is incompatible with --ensemble>1"
        elif mesh is None or mesh.shape[AXIS_DATA] < 2:
            msg = "--native-res needs a multi-device data axis (ring size >= 2)"
        if msg is not None:
            if parser is None:
                raise ValueError(msg)
            parser.error(msg)
    totals = {"frames": 0, "written": 0, "time_io": 0.0, "time_infer": 0.0, "time_vis": 0.0,
              "time_decode": 0.0, "time_jpeg": 0.0, "dense_bytes": 0,
              "world": dist.get_world_size() if dist.is_initialized() else 1,
              "backend": dist.get_backend() if dist.is_initialized() else None}
    if mesh is not None and not mesh.member:
        logger.warning(f"rank {dist.get_rank()} is outside the {mesh.shape[AXIS_DATA]}x"
                       f"{mesh.shape[AXIS_MODEL]} mesh: it runs nothing")
        return totals
    writer = mesh is None or is_primary()
    if compile_graph or compile_effort is not None:
        logger.info(
            f"--compile-graph/--compile-mode={compile_mode}/--compile-effort={compile_effort} "
            "noted: the flags are no-ops; on the card the guided step is always captured "
            "as a CUDA graph per signature and replayed"
        )

    # ----- model initialization -------------------------------------------
    bundle = init_bundle(model, checkpoint_dir, taesd_dir, vae, precision, dev)
    ring = None
    if mesh is not None:
        bundle = shard_bundle(mesh, bundle, tensor_parallel=mesh_model > 1)
        if native_res:
            ring = ProcessGroupRing(mesh.groups[AXIS_DATA])
            logger.info(f"Native-res mode: self-attention sequence sharded over "
                        f"data={mesh.shape[AXIS_DATA]} (ring attention)")
    pipe = DepthCompletionPipeline(bundle)
    scheduler = "lcm" if model == "lcm" else "ddim"
    logger.info(f"Device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})"
                                    if dev.type == "cuda" else ""))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # ----- dataset scan ---------------------------------------------------
    dataset_dirs = find_dataset_dirs(src_root)
    if not dataset_dirs:
        logger.critical(f"No dataset directories found at {src_root}")
        sys.exit(1)
    logger.info(f"Found {len(dataset_dirs):,} dataset directories")

    img_paths_all: dict[str, list[Path]] = {}
    sparse_paths_all: dict[str, list[Path]] = {}
    segmask_paths_all: dict[str, list[Path | None]] = {}
    segmaps: dict[str, dict[str, Any]] = {}
    for dataset_dir in dataset_dirs:
        is_segmask_enabled = use_segmask
        segmask_dir = dataset_dir / DATASET_DIR_NAME_SEGMASK
        if use_segmask:
            if not segmask_dir.exists():
                logger.error(
                    f"No segmentation directory found at {segmask_dir}. "
                    f"Segmentation masks will not be used for {dataset_dir.name}"
                )
                is_segmask_enabled = False
            else:
                segmap_path = segmask_dir / "map.csv"
                if not segmap_path.exists():
                    logger.error(
                        f"No segmentation mapping file found at {segmap_path}. "
                        f"Segmentation masks will not be used for {dataset_dir.name}"
                    )
                    is_segmask_enabled = False
                else:
                    segmaps[dataset_dir.name] = load_segmap(segmap_path)

        img_dir = dataset_dir / DATASET_DIR_NAME_IMAGE
        img_paths = sorted(find_img_paths(img_dir), key=lambda x: x.name)
        sparse_dir = dataset_dir / DATASET_DIR_NAME_SPARSE
        img_paths_all[dataset_dir.name] = []
        sparse_paths_all[dataset_dir.name] = []
        segmask_paths_all[dataset_dir.name] = []
        for path in img_paths:
            sparse_path = sparse_dir / path.relative_to(img_dir).with_suffix(".png")
            if not sparse_path.exists():
                logger.warning(f"No sparse depth map found for image {path} (skipped)")
                continue
            segmask_path = segmask_dir / path.relative_to(img_dir).with_suffix(".png")
            if is_segmask_enabled and not segmask_path.exists():
                logger.warning(f"No segmentation mask found for image {path} (skipped)")
                continue
            img_paths_all[dataset_dir.name].append(path)
            sparse_paths_all[dataset_dir.name].append(sparse_path)
            segmask_paths_all[dataset_dir.name].append(
                segmask_path if is_segmask_enabled else None
            )
        n = len(img_paths_all[dataset_dir.name])
        if n == 0:
            logger.critical("No valid input pairs found")
            sys.exit(1)
        logger.info(f"Found {n:,} input pairs for {dataset_dir.name}")

    dst_root.mkdir(parents=True, exist_ok=True)

    # ----- inference loop -------------------------------------------------
    for dataset_idx, dataset_dir in enumerate(dataset_dirs):
        out_dir = dst_root / dataset_dir.relative_to(src_root)
        img_dir = dataset_dir / DATASET_DIR_NAME_IMAGE
        sparse_dir = dataset_dir / DATASET_DIR_NAME_SPARSE
        img_paths = img_paths_all[dataset_dir.name]
        sparse_paths = sparse_paths_all[dataset_dir.name]
        segmask_paths = segmask_paths_all[dataset_dir.name]

        # Work sharding: frame j belongs to worker (j mod num_shards).
        if num_shards > 1:
            keep = [j for j in range(len(img_paths)) if j % num_shards == shard_index]
            img_paths = [img_paths[j] for j in keep]
            sparse_paths = [sparse_paths[j] for j in keep]
            segmask_paths = [segmask_paths[j] for j in keep]
            logger.info(f"Shard {shard_index}/{num_shards}: {len(img_paths):,} frames")

        # Idempotent resume: re-runs complete only what is missing.
        prev_latents_restored = None
        if resume and not use_prev_latent:
            def _done(sp: Path) -> bool:
                out_path = (
                    out_dir / RESULT_DIR_NAME_DENSE / sp.relative_to(sparse_dir)
                ).with_suffix(f".{compress}")
                return out_path.exists()

            keep = [j for j, sp in enumerate(sparse_paths) if not _done(sp)]
            skipped = len(sparse_paths) - len(keep)
            if skipped:
                logger.info(f"Resume: skipping {skipped:,} completed frames")
            img_paths = [img_paths[j] for j in keep]
            sparse_paths = [sparse_paths[j] for j in keep]
            segmask_paths = [segmask_paths[j] for j in keep]
        elif resume and use_prev_latent:
            # temporal mode resumes from the latent carry written after
            # every frame: skip up to the last completed frame
            state_path = out_dir / "latent_state.npz"
            if state_path.exists():
                state = np.load(state_path)
                last_name = str(state["frame_name"])
                names = [p.name for p in sparse_paths]
                if last_name in names:
                    cut = names.index(last_name) + 1
                    prev_latents_restored = state["latents"]
                    logger.info(
                        f"Resume (temporal): skipping {cut:,} frames, latents "
                        f"restored from {state_path}"
                    )
                    img_paths = img_paths[cut:]
                    sparse_paths = sparse_paths[cut:]
                    segmask_paths = segmask_paths[cut:]

        is_segmask_enabled = any(p is not None for p in segmask_paths)
        progress = Progress(
            total=len(img_paths), desc=f"{dataset_idx + 1}/{len(dataset_dirs)} - {dataset_dir.name}"
        )
        postfix: dict[str, Any] = {}
        prev_latents = None
        if prev_latents_restored is not None:
            prev_latents = torch.as_tensor(prev_latents_restored, device=dev)

        def load_batch(i: int) -> dict[str, Any]:
            """Threaded decode of one batch (runs ahead of the device)."""
            b_img_paths = img_paths[i : i + batch_size]
            b_sparse_paths = sparse_paths[i : i + batch_size]
            b_segmask_paths = segmask_paths[i : i + batch_size]
            t0 = time.perf_counter()
            imgs_list = load_img_arrays(b_img_paths, mode="RGB", num_threads=len(b_img_paths))
            sparses_list = load_img_arrays(
                b_sparse_paths, mode="RGB", num_threads=len(b_sparse_paths)
            )
            segmasks_list: list[np.ndarray | None] = []
            if is_segmask_enabled:
                segmasks_list = load_img_arrays(
                    list(b_segmask_paths), mode="RGB", num_threads=len(b_segmask_paths)
                )
            return {
                "i": i,
                "img_paths": b_img_paths,
                "sparse_paths": b_sparse_paths,
                "imgs": imgs_list,
                "sparses": sparses_list,
                "segmasks": segmasks_list,
                "load_s": time.perf_counter() - t0,
            }

        # Decode batch i+1 while the device runs batch i; at most two
        # batches ahead, to cap host memory.
        starts = iter(range(0, len(img_paths), batch_size))
        prefetcher = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        pending: collections.deque = collections.deque()
        for _ in range(2):
            s = next(starts, None)
            if s is not None:
                pending.append(prefetcher.submit(load_batch, s))

        try:
            while pending:
                fut = pending.popleft()
                s = next(starts, None)
                if s is not None:
                    pending.append(prefetcher.submit(load_batch, s))
                batch = fut.result()
                i = batch["i"]
                b_img_paths = batch["img_paths"]
                b_sparse_paths = batch["sparse_paths"]
                imgs_list = batch["imgs"]
                sparses_list = batch["sparses"]
                segmasks_list = batch["segmasks"]
                progress_n = len(b_img_paths)
                time_io = batch["load_s"]
                totals["time_decode"] += batch["load_s"]
                stime = time.perf_counter()

                flags = []
                for j in range(len(imgs_list)):
                    ok = imgs_list[j] is not None and sparses_list[j] is not None
                    if is_segmask_enabled:
                        ok = ok and segmasks_list[j] is not None
                    flags.append(ok)
                if not any(flags):
                    logger.error(f"All images in batch {i + 1} failed to load (skipped)")
                    progress.update(progress_n)
                    continue
                b_img_paths = [p for p, f in zip(b_img_paths, flags) if f]
                b_sparse_paths = [p for p, f in zip(b_sparse_paths, flags) if f]
                imgs_list = [x for x, f in zip(imgs_list, flags) if f]
                sparses_list = [x for x, f in zip(sparses_list, flags) if f]
                if is_segmask_enabled:
                    segmasks_list = [x for x, f in zip(segmasks_list, flags) if f]

                n_real = len(imgs_list)
                if mesh is not None:
                    # one signature on every rank, the rows dividing the
                    # data axis: pad to the batch size (padded rows dropped)
                    imgs_list += imgs_list[-1:] * (batch_size - n_real)
                    sparses_list += sparses_list[-1:] * (batch_size - n_real)
                batch_imgs = np.stack(imgs_list).astype(np.float32)
                batch_sparses = to_depth(np.stack(sparses_list), max_distance=max_sparse_depth)
                if is_segmask_enabled:
                    segmap = segmaps[dataset_dir.name]
                    # computed for parity, never passed to the pipeline
                    _ = to_segmask(np.stack(segmasks_list), segmap["color"])
                time_io += time.perf_counter() - stime

                profiler = contextlib.nullcontext()
                if profile_dir is not None and i == 0:
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if dev.type == "cuda":
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    profiler = torch.profiler.profile(activities=activities)
                stime_infer = time.perf_counter()
                with profiler:
                    out = pipe(
                        batch_imgs,
                        batch_sparses,
                        max_depth,
                        min_depth=min_depth,
                        projection=projection,
                        inv=inv,
                        norm=norm,
                        percentile=tuple(percentile),
                        pred_latents_prev=prev_latents,
                        beta=beta,
                        steps=steps,
                        resolution=res,
                        interp_mode=interp_mode,
                        loss_funcs=tuple(loss_funcs),
                        opt=opt,
                        lr=(lr_latent, lr_scaling),
                        kld=kld,
                        kld_mode=kld_mode,
                        kld_weight=kld_weight,
                        closed_form=closed_form if train_latents else True,
                        train_latents=train_latents,
                        train_method=train_method,
                        train_steps=train_steps,
                        scheduler=scheduler,
                        ensemble_size=ensemble,
                        ensemble_reduce=ensemble_reduce,
                        ensemble_uncertainty=ensemble_uncertainty,
                        ensemble_mesh=mesh,
                        data_mesh=mesh if ensemble == 1 and ring is None else None,
                        ring_mesh=ring,
                        detach_unet_grad=fast_guidance,
                    )
                    denses, latents = out[0], out[1]
                    denses_np = denses[:n_real].float().cpu().numpy()
                    uncs_np = out[2][:n_real].float().cpu().numpy() if len(out) == 3 else None
                if isinstance(profiler, torch.profiler.profile):
                    profile_dir.mkdir(parents=True, exist_ok=True)
                    profiler.export_chrome_trace(str(profile_dir / "trace.json"))
                    logger.info(f"Saved profiler trace to {profile_dir / 'trace.json'}")
                if use_prev_latent:
                    prev_latents = latents
                if use_prev_latent and writer:
                    # on-disk latent carry: temporal jobs are resumable
                    out_dir.mkdir(parents=True, exist_ok=True)
                    np.savez(
                        out_dir / "latent_state.npz",
                        frame_name=b_sparse_paths[-1].name,
                        latents=latents.float().cpu().numpy(),
                    )
                postfix["time/infer"] = time.perf_counter() - stime_infer
                totals["time_infer"] += postfix["time/infer"]

                time_vis = 0.0
                for fi, (dense, sparse, sparse_path, img, img_path) in enumerate(zip(
                    denses_np, batch_sparses, b_sparse_paths, batch_imgs, b_img_paths
                )):
                    if has_nan(dense):
                        logger.error("NaN values found in dense depth map (skipped)")
                        continue
                    totals["frames"] += 1
                    if not writer:
                        continue
                    totals["written"] += 1
                    if save_dense:
                        stime = time.perf_counter()
                        save_dir = (
                            out_dir / RESULT_DIR_NAME_DENSE / sparse_path.relative_to(sparse_dir)
                        ).parent
                        save_path = save_dir / sparse_path.with_suffix(f".{compress}").name
                        save_array(dense, save_path, compress=compress)
                        totals["dense_bytes"] += save_path.stat().st_size
                        if uncs_np is not None:
                            unc_dir = (out_dir / "uncertainty"
                                       / sparse_path.relative_to(sparse_dir)).parent
                            save_array(uncs_np[fi], unc_dir / save_path.name, compress=compress)
                        time_io += time.perf_counter() - stime
                    if vis:
                        stime = time.perf_counter()
                        to_vis = []
                        for order in vis_order:
                            if order == "image":
                                to_vis.append(img.astype(np.uint8))
                            elif order == "sparse":
                                sparse_vis = visualize_depth(
                                    sparse[np.newaxis], min_depth=min_depth, max_depth=max_depth
                                )[0]
                                sparse_vis[sparse[..., 0] <= 0.0] = 0
                                to_vis.append(sparse_vis)
                            elif order == "dense":
                                to_vis.append(
                                    visualize_depth(
                                        dense[np.newaxis], min_depth=min_depth,
                                        max_depth=max_depth,
                                    )[0]
                                )
                        grid = make_grid(to_vis, resize=vis_res)
                        time_vis += time.perf_counter() - stime
                        stime = time.perf_counter()
                        save_dir = (
                            out_dir / RESULT_DIR_NAME_VIS / img_path.relative_to(img_dir)
                        ).parent
                        save_img_array(grid, save_dir / f"{img_path.stem}_vis.jpg")
                        dt = time.perf_counter() - stime
                        totals["time_jpeg"] += dt
                        time_io += dt

                postfix["time/io"] = time_io
                postfix["time/vis"] = time_vis
                totals["time_io"] += time_io
                totals["time_vis"] += time_vis
                progress.set_postfix(postfix)
                progress.update(progress_n)
        finally:
            prefetcher.shutdown(wait=True, cancel_futures=True)
        logger.success(f"Finished processing {dataset_dir.name}")
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        logger.info(f"Device memory high-water: {peak / 2**30:.2f} GiB")
    launches = {k: n - launches_before[k] for k, n in launch_counts().items()}
    logger.info(f"Kernel launches: {json.dumps(launches)}")
    logger.success(f"Finished processing all {len(dataset_dirs):,} datasets")
    return totals


if __name__ == "__main__":
    main()
