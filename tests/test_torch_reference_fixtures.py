"""Accuracy of the PyTorch port against exported reference fixtures: the
counterpart of tests/test_reference_fixtures.py, with the port's pipeline
on the card.

Marked ``gpu``; runs only when the files are present and a GPU is (none is
in the CPU test run, and the files are not in the repository yet), and
skips inside its fixture otherwise:

    DCT_FIXTURES_DIR      fixtures from scripts/export_reference_fixtures.py
    DCT_CHECKPOINT_DIR    local HF-layout marigold checkpoint
    DCT_TAESD_DIR         optional TAESD dir (else the KL VAE)

The same bounds as the JAX test, on the masked MAE at the sparse anchors
and on the mean disagreement over the frame: the reference's torch noise
draws differ from the port's (JAX's threefry), so the trajectories differ
and the bound is on anchor consistency and output agreement, not bit
equality. The port runs in bf16, its kernels' precision on the card.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

FIXTURES = os.environ.get("DCT_FIXTURES_DIR")
CHECKPOINT = os.environ.get("DCT_CHECKPOINT_DIR")

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def setup():
    if not (FIXTURES and Path(FIXTURES).is_dir() and CHECKPOINT):
        pytest.skip("reference fixtures / checkpoints not available")
    if not torch.cuda.is_available():
        pytest.skip("the port's pipeline runs its kernels on a GPU")
    from depth_completion_tpu_torch.models.bundle import load_bundle
    from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline

    fixtures = Path(FIXTURES)
    cfg = json.loads((fixtures / "config.json").read_text())
    taesd = os.environ.get("DCT_TAESD_DIR")
    bundle = load_bundle(Path(CHECKPOINT), vae_kind="tiny" if taesd else "kl",
                         taesd_dir=Path(taesd) if taesd else None, dtype=torch.bfloat16,
                         device="cuda")
    pipe = DepthCompletionPipeline(bundle)
    image = np.load(fixtures / "input_image.npy")[None]
    sparse = np.load(fixtures / "input_sparse.npy")[None]
    return pipe, fixtures, cfg, image, sparse


MODE_ARGS = {
    "per_step": dict(train_latents=True, train_method="per-step"),
    "closed_form": dict(train_latents=False),
    "per_input": dict(train_latents=True, train_method="per-input", train_steps=4),
}


@pytest.mark.parametrize("mode", ["per_step", "closed_form", "per_input"])
def test_dense_output_parity(setup, mode):
    pipe, fixtures, cfg, image, sparse = setup
    ref = np.load(fixtures / f"dense_{mode}.npy")
    ours, _ = pipe(image, sparse, max_depth=cfg["max_depth"], steps=cfg["steps"],
                   resolution=cfg["resolution"], seed=cfg["seed"], norm=cfg["norm"],
                   **MODE_ARGS[mode])
    ours = ours.float().cpu().numpy()[0]
    mask = sparse[0] > 0
    # anchors: both implementations must track the sparse points comparably
    mae_ours = np.abs(ours[mask] - sparse[0][mask]).mean()
    mae_ref = np.abs(ref[mask] - sparse[0][mask]).mean()
    assert mae_ours <= mae_ref * 1.5 + 0.5, (mae_ours, mae_ref)
    # outputs: bounded disagreement over the full frame
    assert np.abs(ours - ref).mean() < 0.15 * cfg["max_depth"]
