"""How ``correct`` is decided: the timed path's own outputs against the plain
reference, run once the window has closed and the system under test has
been freed.

The driver hands over a list of checked requests, each a dict with the
frames it sent (``images`` float32 [n, H, W, 3], ``sparses`` [n, H, W, 1]),
``carry`` (None, or the index of an earlier checked request whose final
latent this one carried) and what the system returned for them (``dense``
[n, H, W, 1] metric depth, and ``latent`` where the entry returns it). The
reference regenerates the weights from the seed, recomputes each request
in float32 (TF32 off), carrying its own latents, and the compared numbers
are, over every checked frame:

- ``dense_rel``: the largest ‖dense − dense_ref‖ / ‖dense_ref‖;
- ``latent_rel``: the largest ‖latent − latent_ref‖ / ‖latent_ref‖, where
  the entry returns the latent;
- ``fit_gap``: the largest |fit − fit_ref| / fit_ref, where fit is the mean
  absolute gap between the dense map and the sparse points it was given
  (what the answer says about the anchors it was asked to honour);
- ``decode_rel``, where the entry returns the latent: the largest share of
  the dense map that no affine map of the reference's float32 decode of
  that same latent explains (‖y − (a·x + b)‖ / ‖y − ȳ‖ over the pixels the
  clamp left alone, a and b by least squares: the learned affine is the
  system's state, not an output). It judges the final decode alone, so
  the 50 steps' amplified rounding, which ``latent_rel`` carries, is not
  in it.

Each number is held to its limit in ``limits/<workload>.json``; a missing
or non-finite number, or a checked request that failed, is not correct.
"""

from __future__ import annotations

import gc
import math
from contextlib import contextmanager

import numpy as np
import torch

from benchmark.harness import weights
from benchmark.reference.nn import Numerics
from benchmark.reference.sampler import Reference, preprocess


def _tree_float(tree):
    if isinstance(tree, dict):
        return {k: _tree_float(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_float(v) for v in tree]
    return tree.float()


@contextmanager
def _float32_reference(config: dict, request: dict, seed: int, device: torch.device):
    """The reference over the seed's weights, with TF32 off. cuDNN takes its
    heuristics' algorithms: timing every shape's algorithms would add a
    minute to each run."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    try:
        params = _tree_float(weights.make(config, seed, device, weights.config_dtype(config)))
        yield Reference(params, config, request)
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = tf32
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()


def _frames(item: dict, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(np.asarray(item["images"], np.float32)).to(device),
            torch.from_numpy(np.asarray(item["sparses"], np.float32)).to(device))


def reference_outputs(config: dict, request: dict, seed: int, checked: list[dict],
                      device: torch.device, numerics: Numerics | None = None
                      ) -> list[tuple[np.ndarray, np.ndarray]]:
    """(dense, latent) of every checked request, by the reference in
    ``numerics`` (float32 by default)."""
    nx = numerics or Numerics()
    with _float32_reference(config, request, seed, device) as ref:
        out: list[tuple[np.ndarray, np.ndarray]] = []
        latents: list[torch.Tensor] = []
        for item in checked:
            carry = None if item.get("carry") is None else latents[item["carry"]]
            dense, latent = ref(nx, *_frames(item, device), carry)
            latents.append(latent)
            out.append((dense.cpu().numpy(), latent.cpu().numpy()))
        return out


@torch.no_grad()
def decoded_maps(config: dict, request: dict, seed: int, checked: list[dict],
                 device: torch.device) -> list[np.ndarray | None]:
    """The reference's float32 decode of each checked request's own latent
    (None where the entry returns none), cropped and resized to the frame."""
    with _float32_reference(config, request, seed, device) as ref:
        out: list[np.ndarray | None] = []
        for item in checked:
            if item.get("latent") is None:
                out.append(None)
                continue
            images, _ = _frames(item, device)
            padding = preprocess(images, request["resolution"])[1]
            latent = torch.from_numpy(np.asarray(item["latent"], np.float32)).to(device)
            out.append(ref.decoded(Numerics(), latent, padding, tuple(images.shape[1:3]))
                       .cpu().numpy())
        return out


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return math.inf
    return float(np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()), 1e-30))


def _fit(dense: np.ndarray, sparse: np.ndarray) -> float:
    mask = sparse > 0
    return float(np.abs(dense[mask].astype(np.float64) - sparse[mask]).mean())


def _decode_rel(dense: np.ndarray, decoded: np.ndarray, lo: float, hi: float) -> float:
    y = np.asarray(dense, np.float64).ravel()
    x = np.asarray(decoded, np.float64).ravel()
    margin = 1e-3 * (hi - lo)
    keep = (y > lo + margin) & (y < hi - margin)
    if keep.sum() < 2 or x.shape != y.shape:
        return math.inf
    y, a = y[keep], np.stack([x[keep], np.ones(int(keep.sum()))], axis=1)
    coef = np.linalg.lstsq(a, y, rcond=None)[0]
    return float(np.linalg.norm(y - a @ coef) / max(np.linalg.norm(y - y.mean()), 1e-30))


def compare(checked: list[dict], refs: list[tuple[np.ndarray, np.ndarray]], request: dict,
            decoded: list[np.ndarray | None] | None = None) -> dict[str, float]:
    """The compared numbers (module docstring), widest over the checked
    frames; ``decoded``: ``decoded_maps`` of the same requests."""
    numbers: dict[str, float] = {"dense_rel": 0.0, "fit_gap": 0.0}
    lo, hi = float(request["min_depth"]), float(request["max_depth"])
    for j, (item, (dense_ref, latent_ref)) in enumerate(zip(checked, refs)):
        if item.get("dense") is None:
            numbers["dense_rel"] = numbers["fit_gap"] = math.inf
            continue
        for i in range(dense_ref.shape[0]):
            numbers["dense_rel"] = max(numbers["dense_rel"], _rel(item["dense"][i], dense_ref[i]))
            sparse = np.asarray(item["sparses"][i], np.float64)
            fit_ref = _fit(dense_ref[i], sparse)
            numbers["fit_gap"] = max(numbers["fit_gap"],
                                     abs(_fit(item["dense"][i], sparse) - fit_ref)
                                     / max(fit_ref, 1e-30))
            if item.get("latent") is not None:
                numbers["latent_rel"] = max(numbers.get("latent_rel", 0.0),
                                            _rel(item["latent"][i], latent_ref[i]))
                if decoded is not None and decoded[j] is not None:
                    numbers["decode_rel"] = max(numbers.get("decode_rel", 0.0),
                                                _decode_rel(item["dense"][i], decoded[j][i], lo, hi))
    return numbers


def verdict(numbers: dict[str, float], limits: dict[str, float], complete: bool
            ) -> tuple[bool, dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}): every number that has a limit
    is finite and within it, and every checked request came back."""
    shown = {name: {"value": numbers.get(name, math.inf), "limit": limit}
             for name, limit in limits.items()}
    ok = complete and all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                          for v in shown.values())
    if not complete:
        shown["checked_requests_returned"] = {"value": 0, "limit": 1}
    for v in shown.values():
        if not math.isfinite(v["value"]):
            v["value"] = 1e30
    return ok, shown
