"""Serving CLI, PyTorch-port counterpart of ``depth_completion_tpu.cli.serve``:
keep the model warm and answer completion requests over HTTP.

    python -m depth_completion_tpu_torch.cli.serve --checkpoint-dir DIR \\
        --taesd-dir DIR --port 8571 --warmup 480x640

    curl -s -X POST --data-binary @frame.npz \\
        'http://127.0.0.1:8571/v1/complete?session=cam0' -o dense.npy

The flags, defaults and coercions of the JAX CLI, parsed with argparse (the
JAX CLI uses click); one more flag, ``--device {cuda,cpu}`` (default
``cuda``): with no GPU and no ``--device cpu`` the command exits with the
device error. The sampler config is fixed for the server's lifetime.

- ``--max-programs`` bounds the pipeline's live programs (one per
  signature, whatever the sampler branch: its captured CUDA graphs; LRU
  order).
- ``--warmup-tiered`` opens for traffic after every signature ran on the
  eager step (tier 0), then captures each signature's graph on the compute
  thread between batches (``ServingEngine.warmup(tiered=True)``).
- ``--tier-effort`` (XLA's compile effort) and ``--warmup-parallel`` > 1
  are accepted and logged as no-ops: there is one capture form, and
  warmup runs its signatures one after another on one card.
- A ``--max-batch`` bucket that the card cannot hold even with UNet remat
  fails at warmup with the sampler's error naming the largest batch that
  fits (``sampler.check_batch_fits``), not on live traffic.

``run_serve(..., serve_forever=False)`` returns ``(engine, httpd)``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Any

from depth_completion_tpu_torch.cli.common import coerce_guidance_options, init_bundle
from depth_completion_tpu_torch.cli.options import comma_separated, number_range, str2bool
from depth_completion_tpu_torch.logger import LOG_LEVELS, logger

_POS_INT = number_range(int, min=1)
_POS_FLOAT = number_range(float, min=0, min_open=True)


def _parse_geometry(value: str) -> tuple[int, int]:
    try:
        h, w = value.lower().split("x")
        return int(h), int(w)
    except ValueError as exc:
        raise ValueError(f"geometry must look like 480x640, got {value!r}") from exc


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m depth_completion_tpu_torch.cli.serve",
        description="Serve depth completion over HTTP with a warm model.")
    p.add_argument("--model", choices=["original", "lcm", "random"], default="original",
                   help="Marigold model family (see predict --help).")
    p.add_argument("--checkpoint-dir", type=Path, default=None,
                   help="Local HF-layout checkpoint directory. Required unless --model=random.")
    p.add_argument("--taesd-dir", type=Path, default=None,
                   help="Local TAESD checkpoint directory (for --vae=light).")
    p.add_argument("--vae", choices=["original", "light"], default="light",
                   help="VAE for decode.")
    p.add_argument("-n", "--steps", type=_POS_INT, default=50, help="Denoising steps.")
    p.add_argument("-r", "--res", type=_POS_INT, default=768,
                   help="Processing resolution (longest side).")
    p.add_argument("--norm", choices=["const", "minmax", "percentile"], default="const",
                   help="Sparse-depth normalization method.")
    p.add_argument("--percentile", type=comma_separated(float), default="0.01,0.99",
                   help="Percentile range for --norm=percentile.")
    p.add_argument("--max-depth", type=_POS_FLOAT, default=120.0,
                   help="Max distance [m] of output dense depth maps (fixed for the server's "
                   "lifetime).")
    p.add_argument("--min-depth", type=number_range(float, min=0), default=0.0,
                   help="Min distance [m].")
    p.add_argument("-p", "--precision", choices=["bf16", "fp32"], default="bf16",
                   help="Inference precision.")
    p.add_argument("--loss-funcs", type=comma_separated(str), default="l1,l2",
                   help="Guidance losses: l1, l2, edge, smooth.")
    p.add_argument("--opt", choices=["adam", "sgd", "adagrad"], default="adam",
                   help="Guidance optimizer.")
    p.add_argument("--lr-latent", type=_POS_FLOAT, default=0.05, help="Latent learning rate.")
    p.add_argument("--lr-scaling", type=_POS_FLOAT, default=0.005, help="Affine learning rate.")
    p.add_argument("--closed-form", type=str2bool, default=False,
                   help="Closed-form affine instead of learned.")
    p.add_argument("--projection", choices=["linear", "log", "log10"], default="linear",
                   help="Depth projection.")
    p.add_argument("--inv", type=str2bool, default=False, help="Inverse (disparity) projection.")
    p.add_argument("--train-latents", type=str2bool, default=True,
                   help="Optimize latents during sampling.")
    p.add_argument("--train-method", choices=["per-step", "per-input"], default="per-step",
                   help="Training method.")
    p.add_argument("--train-steps", type=_POS_INT, default=10,
                   help="Steps for --train-method=per-input.")
    p.add_argument("--beta", type=number_range(float, min=0, max=1, min_open=True,
                                               max_open=True), default=0.9,
                   help="Temporal blend weight for session latent carry, in (0,1).")
    p.add_argument("--fast-guidance", type=str2bool, default=False,
                   help="Skip the UNet backward in guidance (non-parity gradients).")
    p.add_argument("--host", type=str, default="127.0.0.1",
                   help="Bind address. Use 0.0.0.0 only behind a trusted network.")
    p.add_argument("--port", type=number_range(int, min=0), default=8571,
                   help="Bind port (0 picks a free port).")
    p.add_argument("--max-batch", type=_POS_INT, default=4,
                   help="Micro-batch size (also the largest batch bucket).")
    p.add_argument("--batch-buckets", type=comma_separated(int), default=None,
                   help="Padded batch sizes, e.g. 1,4,8; a coalesced batch runs the smallest "
                   "bucket that fits. Default: 1,<max-batch>.")
    p.add_argument("--max-delay-ms", type=number_range(float, min=0), default=25.0,
                   help="How long to wait for same-geometry batchmates.")
    p.add_argument("--session-ttl", type=_POS_FLOAT, default=300.0,
                   help="Idle seconds before a session's carry latent is dropped.")
    p.add_argument("--max-queue", type=_POS_INT, default=256,
                   help="Pending-request admission limit; beyond it requests are shed with "
                   "HTTP 503.")
    p.add_argument("--warmup", type=comma_separated(str), default=None,
                   help="Comma-separated HxW geometries to run before accepting traffic, "
                   "e.g. 480x640,352x1216.")
    p.add_argument("--warmup-parallel", type=_POS_INT, default=1,
                   help="Accepted for compatibility; a no-op: the warmup runs its signatures "
                   "one after another, because a CUDA graph is captured on the one compute "
                   "stream and a capture does not overlap another.")
    p.add_argument("--warmup-tiered", dest="warmup_tiered", action="store_true", default=False,
                   help="Serve first, capture later: warm every signature on the eager twin "
                   "(tier 0), open for traffic, then capture each signature's CUDA graphs on "
                   "the compute thread between batches (also while idle) and move its "
                   "dispatch to them as each lands; tier 0 is dropped once every signature "
                   "is promoted. Steady-state throughput unchanged.")
    p.add_argument("--no-warmup-tiered", dest="warmup_tiered", action="store_false")
    p.add_argument("--tier-effort", type=number_range(float, min=-1.0, max=0.0), default=-1.0,
                   help="Accepted for compatibility; a no-op: tier 0 is the eager twin, "
                   "which has no compile effort to lower.")
    p.add_argument("--max-programs", type=_POS_INT, default=None,
                   help="Bound the number of live captured (geometry, bucket) programs; the "
                   "least-recently-used program is evicted, freeing its graphs and buffers. "
                   "Default: unbounded (batch-job behavior). Size it to >= geometries x "
                   "(buckets+1) you want permanently warm.")
    p.add_argument("--log", type=Path, default=None, help="Path to save logs.")
    p.add_argument("--log-level", choices=LOG_LEVELS, default="INFO", help="Minimum log level.")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Device to run on (the tests pass cpu).")
    return p


def main(argv: list[str] | None = None) -> None:
    run_serve(**vars(build_parser().parse_args(argv)))


def run_serve(
    model: str,
    checkpoint_dir: Path | None,
    taesd_dir: Path | None,
    vae: str,
    steps: int,
    res: int,
    norm: str,
    percentile: list[float],
    max_depth: float,
    min_depth: float,
    precision: str,
    loss_funcs: list[str],
    opt: str,
    lr_latent: float,
    lr_scaling: float,
    closed_form: bool,
    projection: str,
    inv: bool,
    train_latents: bool,
    train_method: str,
    train_steps: int,
    beta: float,
    fast_guidance: bool,
    host: str,
    port: int,
    max_batch: int,
    batch_buckets: list[int] | None,
    max_delay_ms: float,
    session_ttl: float,
    max_queue: int,
    warmup: list[str] | None,
    max_programs: int | None,
    log: Path | None,
    log_level: str,
    warmup_parallel: int = 1,
    warmup_tiered: bool = False,
    tier_effort: float = -1.0,
    device: str = "cuda",
    *,
    serve_forever: bool = True,
):
    """Build the engine and the HTTP server. Returns (engine, httpd) when
    serve_forever=False; otherwise blocks."""
    from depth_completion_tpu_torch.device import resolve_device

    logger.configure(level=log_level, log_path=log)
    dev = resolve_device(device)
    if warmup_parallel > 1 or tier_effort != -1.0:
        logger.info(f"--warmup-parallel={warmup_parallel}/--tier-effort={tier_effort} noted: "
                    "one capture form, one card; the flags are no-ops")
    geoms = [_parse_geometry(g) for g in warmup] if warmup else []

    loss_funcs, norm, train_latents, closed_form = coerce_guidance_options(
        loss_funcs, norm, projection, inv, model, train_latents, closed_form
    )
    if not loss_funcs:
        # a server with no valid losses would reject every request forever
        logger.critical("No valid loss functions specified")
        sys.exit(1)

    from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline
    from depth_completion_tpu_torch.serving.engine import ServingEngine
    from depth_completion_tpu_torch.serving.server import make_server

    bundle = init_bundle(model, checkpoint_dir, taesd_dir, vae, precision, dev)
    pipe = DepthCompletionPipeline(bundle, max_programs=max_programs)
    logger.info(f"Device: {dev}")

    call_kwargs: dict[str, Any] = dict(
        max_depth=max_depth,
        min_depth=min_depth,
        steps=steps,
        resolution=res,
        norm=norm,
        percentile=tuple(percentile),
        loss_funcs=tuple(loss_funcs),
        opt=opt,
        lr_latent=lr_latent,
        lr_scaling=lr_scaling,
        closed_form=closed_form,
        projection=projection,
        inv=inv,
        train_latents=train_latents,
        train_method=train_method,
        train_steps=train_steps,
        scheduler="lcm" if model == "lcm" else "ddim",
        detach_unet_grad=fast_guidance,
    )
    engine = ServingEngine(
        pipe,
        call_kwargs,
        max_batch=max_batch,
        max_delay_ms=max_delay_ms,
        session_ttl_s=session_ttl,
        beta=beta,
        max_queue=max_queue,
        batch_buckets=tuple(batch_buckets) if batch_buckets else None,
    )
    if geoms:
        logger.info(f"Warming up {len(geoms)} geometries: {geoms} (tiered={warmup_tiered})")
        try:
            engine.warmup(geoms, parallel=warmup_parallel, tiered=warmup_tiered,
                          tier_effort=tier_effort)
        except BaseException:
            engine.shutdown()
            raise
        logger.success("Warmup complete" + (" (tier 0; graphs captured between batches)"
                                            if warmup_tiered else ""))

    httpd = make_server(engine, host=host, port=port)
    bound = httpd.server_address
    logger.success(f"Serving on http://{bound[0]}:{bound[1]}")
    if not serve_forever:
        return engine, httpd
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        logger.info("Shutting down")
    finally:
        httpd.shutdown()
        engine.shutdown()
    return None


if __name__ == "__main__":
    main()
