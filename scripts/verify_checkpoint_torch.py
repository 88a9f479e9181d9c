"""Verify that a local Marigold HF-layout checkpoint loads and runs on the
PyTorch port: the counterpart of ``scripts/verify_checkpoint.py``.

Usage::

    python scripts/verify_checkpoint_torch.py /path/to/marigold-v1-0 \\
        [--taesd /path/to/taesd] [--vae original|light] [--device cuda|cpu] \\
        [--precision bf16|fp32] [--out dense.npy]

Loads the bundle with ``load_bundle`` (configs from the checkpoint's JSONs;
the port's own safetensors reader, every key checked against the port's
inventory), prints the parameter count of each component, the text
context's shape and the scheduler, then runs one 2-step guided request at
128x160 (processing resolution 128) end to end, as the JAX script does.
Run it before pointing the predict CLI at new weights: a converter
mismatch fails here with a key-level error instead of NaNs mid-sampling.

On the card (the default) the request runs the hand-written kernels; the
launches it counted print on a line ``launches {...}`` (JSON, kernel name →
count; on the CPU every wrapper takes its plain twin and the counts are 0).
Prints ``OK``, or ``FAILED`` and exits 1 on a non-finite dense map.
``--out`` saves the dense map [1, 128, 160, 1] as ``.npy``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from depth_completion_tpu_torch.cli.common import exact_fp32  # noqa: E402
from depth_completion_tpu_torch.models.bundle import load_bundle  # noqa: E402
from depth_completion_tpu_torch.models.weights import _flatten  # noqa: E402
from depth_completion_tpu_torch.ops import conv3x3, flash_attention, guidance_epilogue  # noqa: E402
from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline  # noqa: E402

COUNTERS = (flash_attention.LAUNCHES, conv3x3.LAUNCHES, guidance_epilogue.LAUNCHES)
FRAME, RESOLUTION, STEPS = (128, 160), 128, 2


def count_params(tree) -> int:
    return sum(t.numel() for t in _flatten(tree).values())


def request(pipe: DepthCompletionPipeline) -> np.ndarray:
    """The JAX script's request: a seeded random frame with points on a
    16-pixel grid (varied values: a constant sparse frame has a degenerate
    min-max range and is refused) → the dense map [1, H, W, 1]."""
    rng = np.random.default_rng(0)
    h, w = FRAME
    images = rng.uniform(0, 255, size=(1, h, w, 3)).astype(np.float32)
    sparse = np.zeros((1, h, w, 1), np.float32)
    sparse[0, ::16, ::16, 0] = rng.uniform(2.0, 100.0, sparse[0, ::16, ::16, 0].shape)
    denses, _ = pipe(images, sparse, max_depth=120.0, steps=STEPS, resolution=RESOLUTION)
    return denses.float().cpu().numpy()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkpoint_dir", type=Path)
    ap.add_argument("--taesd", type=Path, default=None)
    ap.add_argument("--vae", choices=["original", "light"], default="light")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="Device to run on (the tests pass cpu).")
    ap.add_argument("--precision", choices=["bf16", "fp32"], default="bf16")
    ap.add_argument("--out", type=Path, default=None, help="Save the dense map here (.npy).")
    args = ap.parse_args(argv)

    vae_kind = "tiny" if args.vae == "light" else "kl"
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    if dtype == torch.float32:
        exact_fp32()
    print(f"Loading {args.checkpoint_dir} (vae={vae_kind}, {args.precision}, {args.device}) ...")
    bundle = load_bundle(args.checkpoint_dir, vae_kind=vae_kind, taesd_dir=args.taesd,
                         dtype=dtype, device=args.device)
    print(f"  unet:  {count_params(bundle.unet_params) / 1e6:,.1f} M params "
          f"({bundle.unet_config.block_out_channels})")
    print(f"  vae:   {count_params(bundle.vae.params) / 1e6:,.1f} M params "
          f"({bundle.vae.kind}, {bundle.vae.downsample_factor}x)")
    print(f"  text context: {tuple(bundle.text_context.shape)}")
    if bundle.ddim_config is not None:
        print(f"  scheduler: {bundle.ddim_config.prediction_type}, "
              f"{bundle.ddim_config.beta_schedule}")

    pipe = DepthCompletionPipeline(bundle)
    for counter in COUNTERS:
        for key in counter:
            counter[key] = 0
    d = request(pipe)
    counts = {k: v for counter in COUNTERS for k, v in counter.items()}
    ok = bool(np.isfinite(d).all())
    print(f"  smoke step: denses {d.shape}, finite={ok}, range [{d.min():.2f}, {d.max():.2f}]")
    print(f"launches {json.dumps(counts)}")
    if args.out is not None:
        np.save(args.out, d)
    print("OK" if ok else "FAILED: non-finite output")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
