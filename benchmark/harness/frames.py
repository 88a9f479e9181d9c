"""Frames from the run's seed: the one generator every traffic mix reads.

A frame is an RGB image (uint8 values, as a camera gives them) and a sparse
depth map with ``points`` valid pixels (depth uniform in the mix's
``depth_range``, 0 elsewhere), of the mix's ``height`` x ``width``.

- ``offline_frame(mix, seed, index)``: frame ``index`` of a dataset job,
  every pixel and point drawn from (seed, index), so no two frames agree.
- ``Stream(mix, seed, stream)``: one video stream: a scene (an image twice
  the motion range larger than the frame and a smooth depth field over it)
  drawn once from (seed, stream), and frame ``f`` is the scene seen through
  a window that moves by a seeded random walk of at most ``motion_px``
  pixels a frame, with its own ``points`` sampled from the depth field.
"""

from __future__ import annotations

import numpy as np


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng([int(k) % 2**63 for k in key])


def _points(rng, h: int, w: int, n: int, depth: np.ndarray | tuple) -> np.ndarray:
    sparse = np.zeros(h * w, np.float32)
    idx = rng.choice(h * w, size=n, replace=False)
    if isinstance(depth, tuple):
        sparse[idx] = rng.uniform(depth[0], depth[1], n).astype(np.float32)
    else:
        sparse[idx] = depth.reshape(-1)[idx]
    return sparse.reshape(h, w, 1)


def offline_frame(mix: dict, seed: int, index: int) -> tuple[np.ndarray, np.ndarray]:
    """(image [H, W, 3] uint8, sparse [H, W, 1] float32)."""
    h, w = mix["height"], mix["width"]
    rng = _rng(seed, 1, index)
    image = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    return image, _points(rng, h, w, mix["points"], tuple(mix["depth_range"]))


def offline_batch(mix: dict, seed: int, request: int) -> tuple[np.ndarray, np.ndarray]:
    """Request ``request``'s frames, stacked: float32 [N, H, W, 3], [N, H, W, 1]."""
    n = mix["batch"]
    frames = [offline_frame(mix, seed, request * n + i) for i in range(n)]
    return (np.stack([f[0] for f in frames]).astype(np.float32),
            np.stack([f[1] for f in frames]))


class Stream:
    """One camera's frames (see the module docstring)."""

    def __init__(self, mix: dict, seed: int, stream: int):
        self.mix, self.seed, self.stream = mix, seed, stream
        h, w, m = mix["height"], mix["width"], mix["motion_px"]
        self.margin = 4 * m
        rng = _rng(seed, 2, stream)
        hh, ww = h + 2 * self.margin, w + 2 * self.margin
        self.scene = rng.integers(0, 256, size=(hh, ww, 3), dtype=np.uint8)
        lo, hi = mix["depth_range"]
        yy, xx = np.mgrid[0:hh, 0:ww].astype(np.float32)
        a, b, c, d = rng.uniform(0.0, 1.0, 4)
        field = 0.5 + 0.25 * np.sin(2 * np.pi * (a + yy / hh * (1 + 2 * b))) \
            + 0.25 * np.cos(2 * np.pi * (c + xx / ww * (1 + 2 * d)))
        self.depth = (lo + (hi - lo) * field).astype(np.float32)
        steps = rng.integers(-m, m + 1, size=(4096, 2))
        self.path = np.clip(np.cumsum(steps, axis=0), -self.margin, self.margin)

    def frame(self, f: int) -> tuple[np.ndarray, np.ndarray]:
        """Frame ``f``: (image [H, W, 3] uint8, sparse [H, W, 1] float32)."""
        h, w = self.mix["height"], self.mix["width"]
        dy, dx = (0, 0) if f == 0 else self.path[(f - 1) % len(self.path)]
        y0, x0 = self.margin + dy, self.margin + dx
        image = np.ascontiguousarray(self.scene[y0:y0 + h, x0:x0 + w])
        rng = _rng(self.seed, 3, self.stream, f)
        depth = self.depth[y0:y0 + h, x0:x0 + w]
        return image, _points(rng, h, w, self.mix["points"], depth)
