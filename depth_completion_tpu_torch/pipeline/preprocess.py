"""Image preprocessing: [-1, 1] range, longest-side resize, x16 edge padding
(PyTorch counterpart of ``depth_completion_tpu.pipeline.preprocess``)."""

from __future__ import annotations

import torch

from depth_completion_tpu_torch.ops.resize import pad_to_multiple, resize_to_max_edge


def preprocess_images(images: torch.Tensor, resolution: int, interp_mode: str = "bilinear"):
    """Raw [N,H,W,C] images (0..255) → ([N,PPH,PPW,C] in [-1,1], padding, orig_res)."""
    _, h, w, _ = images.shape
    x = images.float() / 255.0 * 2.0 - 1.0
    x = resize_to_max_edge(x, resolution, method=interp_mode)
    x, padding = pad_to_multiple(x)
    return x, padding, (h, w)
