"""Visualisation, PyTorch-port counterpart of ``depth_completion_tpu.viz``:
the Spectral depth colormap and grid composition, on the host in numpy.

- The Spectral LUT is the port's own constant: matplotlib's 11
  ``_Spectral_data`` control colours (ColorBrewer's, k/255), interpolated
  as ``LinearSegmentedColormap.from_list`` does at N=256, rounded to uint8.
- ``make_grid``'s resize is a copy of OpenCV's ``INTER_LINEAR`` for uint8:
  half-pixel centres, float32 source positions, 11-bit fixed-point weights
  in each direction, and the vertical pass as cv2's vector path rounds it
  (each row sum shifted right by 4, high half of its product with the
  weight, the two added and rounded off 2 bits); cv2 runs the last few
  bytes of a row, past its vector width, through its scalar path, which
  may round 1 LSB otherwise.
"""

from __future__ import annotations

import numpy as np

_LUT_SIZE = 256
# matplotlib's _Spectral_data (ColorBrewer Spectral, 11 classes) as 8-bit RGB
_SPECTRAL_CONTROL = np.array([
    (158, 1, 66), (213, 62, 79), (244, 109, 67), (253, 174, 97), (254, 224, 139),
    (255, 255, 191), (230, 245, 152), (171, 221, 164), (102, 194, 165), (50, 136, 189),
    (94, 79, 162)]) / 255.0


def _segmented_lut(colors: np.ndarray, n: int) -> np.ndarray:
    """matplotlib's ``_create_lookup_table`` for evenly spaced control
    colours (``from_list``), one channel at a time → [n, C] in [0, 1]."""
    x = np.linspace(0.0, 1.0, len(colors)) * (n - 1)
    xind = (n - 1) * np.linspace(0.0, 1.0, n)
    ind = np.searchsorted(x, xind)[1:-1]
    dist = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    mid = dist[:, None] * (colors[ind] - colors[ind - 1]) + colors[ind - 1]
    return np.clip(np.concatenate([colors[:1], mid, colors[-1:]]), 0.0, 1.0)


SPECTRAL_LUT = (_segmented_lut(_SPECTRAL_CONTROL, _LUT_SIZE) * 255.0).round().astype(np.uint8)


def visualize_depth(
    depth_maps: np.ndarray,
    max_depth: float,
    min_depth: float = 0.0,
) -> np.ndarray:
    """[N,H,W,1] metric depth → [N,H,W,3] uint8 RGB in the Spectral colormap."""
    if min_depth >= max_depth:
        raise ValueError(f"Invalid values range: [{min_depth}, {max_depth}].")
    if depth_maps.ndim != 4 or depth_maps.shape[-1] != 1:
        raise ValueError(
            f"Input depth maps must have shape [N,H,W,1], got {depth_maps.shape}"
        )
    x = np.clip(depth_maps.astype(np.float32), min_depth, max_depth)
    x = (x - min_depth) / (max_depth - min_depth)
    idx = np.clip((x[..., 0] * (_LUT_SIZE - 1)).round().astype(np.int32), 0, _LUT_SIZE - 1)
    return SPECTRAL_LUT[idx]


def _linear_taps(n_out: int, n_in: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv2's INTER_LINEAR taps along one axis: (first source index, second
    source index, first weight out of 2048)."""
    scale = np.float64(n_in) / n_out
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    left = s < 0
    f[left], s[left] = 0.0, 0
    right = s >= n_in - 1
    f[right], s[right] = 0.0, n_in - 1
    w0 = np.rint((np.float32(1.0) - f) * np.float32(2048.0)).astype(np.int64)
    return s, np.minimum(s + 1, n_in - 1), w0


def resize_linear_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=INTER_LINEAR)`` for
    uint8 [H,W,C]."""
    h, w = img.shape[:2]
    x0, x1, wx = _linear_taps(out_w, w)
    y0, y1, wy = _linear_taps(out_h, h)
    src = img.astype(np.int32)
    wx, wy = wx.astype(np.int32)[None, :, None], wy.astype(np.int32)[:, None, None]
    rows = (src[:, x0] * wx + src[:, x1] * (2048 - wx)) >> 4
    out = ((rows[y0] * wy) >> 16) + ((rows[y1] * (2048 - wy)) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def make_grid(
    imgs: np.ndarray | list[np.ndarray],
    nrow: int | None = None,
    resize: tuple[int, int] | None = None,
) -> np.ndarray:
    """Compose [N,H,W,C] (or list of [H,W,C]) into one grid image.

    Default single row; ``resize=(h, w)`` with -1 preserving aspect
    (default 2px padding), resized bilinearly as cv2's ``INTER_LINEAR``.
    """
    if isinstance(imgs, list):
        if not imgs:
            raise ValueError("Empty list of images provided")
        for im in imgs:
            if im.ndim != 3:
                raise ValueError("Each image in the list must be [H,W,C]")
        imgs = np.stack(imgs)
    if imgs.ndim != 4:
        raise ValueError("Images must be 4D [N,H,W,C]")
    n, h, w, c = imgs.shape
    if imgs.dtype != np.uint8:
        imgs = (np.clip(imgs, 0, 1) * 255).round().astype(np.uint8)
    if nrow is None:
        nrow = n
    ncol = nrow
    nrows = (n + ncol - 1) // ncol
    pad = 2
    grid = np.zeros(
        (nrows * h + (nrows + 1) * pad, ncol * w + (ncol + 1) * pad, c), np.uint8
    )
    for i in range(n):
        r, col = divmod(i, ncol)
        y = pad + r * (h + pad)
        x = pad + col * (w + pad)
        grid[y : y + h, x : x + w] = imgs[i]

    if resize is not None:
        th, tw = resize
        if th != -1 or tw != -1:
            gh, gw = grid.shape[:2]
            target_h = th if th != -1 else int(tw * gh / gw)
            target_w = tw if tw != -1 else int(th * gw / gh)
            grid = resize_linear_u8(grid, target_h, target_w)
    return grid


def has_nan(x) -> bool:
    """NaN guard for numpy arrays and tensors."""
    if hasattr(x, "isnan"):
        return bool(x.isnan().any())
    return bool(np.isnan(np.asarray(x)).any())
