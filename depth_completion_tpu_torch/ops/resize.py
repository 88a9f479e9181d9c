"""Differentiable resizing and padding bookkeeping, PyTorch counterpart of
``depth_completion_tpu.ops.resize``.

``resize_antialias`` reproduces ``jax.image.resize(..., antialias=True)``
exactly, which ``F.interpolate(antialias=True)`` does not at non-integer
ratios (the main path's 480×640 ↔ 576×768 is a 1.2 ratio). Per spatial axis
it builds jax's weight matrix — the triangle (or Keys cubic) kernel at
half-pixel centres, its width scaled by ``max(1/scale, 1)`` when
downsampling, each output's weights normalised by their sum — and applies
the two matrices as small einsums, so the resize is exact and its gradient
is the transposed product.

The weight matrices and the nearest resize's indices are built on the host
once per (in size, out size, method, device) and kept on that device
(``_device_table``): the guided step resizes every step, and a CUDA graph
capture allows no copy from the host. The first, eager step of a captured
program fills the cache before its capture.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from depth_completion_tpu_torch.device import upload

LATENT_ALIGN = 16  # spatial alignment of the VAE input (8x downsample + UNet /2)


def _triangle(x):
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x):
    f32 = np.float32
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1)
    out = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4)) * x + f32(2), out)
    return np.where(x >= 2.0, f32(0), out)


def _weight_matrix(in_size: int, out_size: int, kernel) -> np.ndarray:
    """jax.image's ``compute_weight_mat`` (antialias, no translation),
    evaluated in float32 as jax evaluates it: ``[out_size, in_size]``."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = kernel(x).astype(f32)  # [in, out]
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, f32(0))
    return np.ascontiguousarray(w.T, dtype=f32)


_TABLES: dict[tuple, torch.Tensor] = {}
_TABLES_LOCK = threading.Lock()


def _device_table(key: tuple, device: torch.device, build) -> torch.Tensor:
    """``build()`` (a numpy array) on ``device``, built and uploaded once per
    (``key``, device) and kept."""
    key = (*key, str(device))
    with _TABLES_LOCK:
        table = _TABLES.get(key)
        if table is None:
            table = _TABLES[key] = upload(build(), device)
    return table


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    pos = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * np.float32(in_size)
    return np.floor(pos * (np.float32(1) / np.float32(out_size))).astype(np.int64)


def _resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """jax.image's nearest: source index floor((i + 0.5) · in · (1/out)) in
    float32 (the compiled jax program multiplies by the reciprocal)."""
    for axis, out_size in ((1, size[0]), (2, size[1])):
        in_size = x.shape[axis]
        if in_size == out_size:
            continue
        idx = _device_table(("nearest", in_size, out_size), x.device,
                            lambda: _nearest_index(in_size, out_size))
        x = x.index_select(axis, idx)
    return x


def resize_antialias(x: torch.Tensor, size: tuple[int, int], method: str = "bilinear") -> torch.Tensor:
    """Resize NHWC ``x`` to ``size=(H, W)`` as ``jax.image.resize`` with
    antialiasing does. ``method`` ∈ {"bilinear", "bicubic", "nearest"}."""
    h, w = size
    if method == "nearest":
        return _resize_nearest(x, (h, w))
    kernel = {"bilinear": _triangle, "bicubic": _keys_cubic}.get(method)
    if kernel is None:
        raise ValueError(f"Unknown interpolation method: {method}")
    out = x.float()
    for axis, size_out, spec in ((1, h, "oh,nhwc->nowc"), (2, w, "ow,nhwc->nhoc")):
        size_in = out.shape[axis]
        if size_in != size_out:
            wm = _device_table((method, size_in, size_out), x.device,
                               lambda: _weight_matrix(size_in, size_out, kernel))
            out = torch.einsum(spec, wm, out)
    return out.to(x.dtype)


def resize_to_max_edge(x: torch.Tensor, max_edge: int, method: str = "bilinear") -> torch.Tensor:
    """Resize NHWC ``x`` so its longer side is ``max_edge`` (floor division,
    aspect kept)."""
    _, h, w, _ = x.shape
    m = max(h, w)
    return resize_antialias(x, (max_edge * h // m, max_edge * w // m), method=method)


def pad_to_multiple(x: torch.Tensor, align: int = LATENT_ALIGN):
    """Edge-pad NHWC bottom/right to a multiple of ``align`` → (padded, (ph, pw))."""
    _, h, w, _ = x.shape
    ph, pw = -h % align, -w % align
    if ph == 0 and pw == 0:
        return x, (0, 0)
    padded = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate")
    return padded.permute(0, 2, 3, 1), (ph, pw)


def unpad(x: torch.Tensor, padding: tuple[int, int]) -> torch.Tensor:
    ph, pw = padding
    return x[:, : x.shape[1] - ph, : x.shape[2] - pw, :]


def processing_padding(orig_res: tuple[int, int], resolution: int) -> tuple[int, int]:
    """(ph, pw): the edge padding ``pad_to_multiple`` adds to the frame
    resized to ``resolution`` (``resize_to_max_edge``)."""
    h, w = orig_res
    m = max(h, w)
    rh, rw = resolution * h // m, resolution * w // m
    return -rh % LATENT_ALIGN, -rw % LATENT_ALIGN


def processing_size(orig_res: tuple[int, int], resolution: int) -> tuple[int, int]:
    """(PPH, PPW): longest side floor-scaled to ``resolution``, aligned to 16."""
    h, w = orig_res
    m = max(h, w)
    ph, pw = processing_padding(orig_res, resolution)
    return resolution * h // m + ph, resolution * w // m + pw


def latent_size(orig_res: tuple[int, int], resolution: int, downsample: int = 8) -> tuple[int, int]:
    """(EH, EW): padded processing size / the VAE's downsample factor."""
    pph, ppw = processing_size(orig_res, resolution)
    return pph // downsample, ppw // downsample
