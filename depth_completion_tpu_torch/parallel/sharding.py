"""Sharding rules: data-parallel rows, tensor-parallel UNet; PyTorch
counterpart of ``depth_completion_tpu.parallel.sharding``.

- ``data`` axis: each data rank runs its contiguous block of the batch's
  rows (``shard_batch``) and the results are gathered over the data group
  (``core.mesh.gather_rows``).
- ``model`` axis: Megatron-style tensor parallelism of the UNet
  (``models.unet``'s ``ModelShard`` blocks and its two collectives).

``unet_tp_spec`` is the JAX package's rule set over the port's parameter
paths (the JAX tree's names, which ``from_jax_params`` keeps) in the
port's layouts (linear ``[out, in]``, conv OIHW), and
``unet_param_sharding`` adds its divisibility fallback. JAX's GSPMD may
place any leaf as its spec says and repairs the layout around it; the port
runs explicit collectives, so ``unet_tp_plan`` decides per block, and
departs from the per-leaf spec where the block's function needs it
(``tp_departures`` lists each leaf, with one of these reasons):

- ``"halves"``: a GEGLU ``proj_in`` (kernel and bias) is sharded on the
  spec's dimension, but each rank holds the matching slices of the value
  and the gate halves, not one contiguous block (which would give rank 0
  only values at M=2);
- ``"norm2"``: a sharded ResNet's ``norm2`` scale and bias follow
  ``conv1``'s output channels (the spec replicates them), and the norm runs
  ``norm_groups / M`` groups on them;
- ``"whole"``: a transformer's own ``proj_in``/``proj_out`` stay
  replicated: the layer norms and residuals between them need whole
  channels, and an all-gather per block would cost more than these C×C
  layers save;
- ``"heads"``: an attention whose head count does not divide M stays
  replicated (JAX splits its columns through a head);
- ``"groups"``: a ResNet whose ``norm_groups`` or channels do not divide M
  stays replicated (``norm2`` would straddle ranks);
- ``"pair"``: a leaf of a pair whose other leaves do not divide M stays
  replicated with them.

Ranks come to hold equal weights by each loading the same checkpoint (or
the same seed for random weights): the loaders are deterministic and
bit-exact, each rank reads in parallel, and no 2.4 GB broadcast is needed
at start-up. ``shard_bundle`` checks the claim: a fingerprint of the
weights, reduced over the mesh by min and max, must agree, or it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from depth_completion_tpu_torch.core.mesh import AXIS_DATA, AXIS_MODEL, Mesh, data_sharding
from depth_completion_tpu_torch.models.registry import UNetConfig
from depth_completion_tpu_torch.models.unet import ModelShard
from depth_completion_tpu_torch.models.weights import _flatten

# The JAX package's parameter-name rules (its sharding.py:72-81): fan-out
# layers shard their outputs, fan-in layers their inputs.
_TP_OUT_SHARDED = {"to_q", "to_k", "to_v", "proj_in"}
_TP_IN_SHARDED = {"to_out", "proj_out"}
_TP_CONV_OUT_SHARDED = {"conv1"}
_TP_CONV_IN_SHARDED = {"conv2"}
_TP_LINEAR_OUT_EXTRA = {"time_emb_proj"}  # rides conv1's output sharding

Spec = tuple  # per dimension: AXIS_MODEL or None; () = replicated


def unet_tp_spec(path: tuple, leaf: Any) -> Spec:
    """The spec of a UNet leaf at ``path`` (keys and list indices), in the
    port's layouts: JAX's ``unet_tp_spec`` with linear kernels transposed
    and conv kernels HWIO → OIHW."""
    keys = [k for k in path[:-1] if isinstance(k, str)]
    parent = keys[-1] if keys else None
    leaf_name = path[-1] if path else None
    if leaf.ndim == 2 and leaf_name == "kernel":  # [out, in]
        if parent in _TP_OUT_SHARDED | _TP_LINEAR_OUT_EXTRA:
            return (AXIS_MODEL, None)
        if parent in _TP_IN_SHARDED:
            return (None, AXIS_MODEL)
    if leaf.ndim == 4 and leaf_name == "kernel":  # OIHW
        if parent in _TP_CONV_OUT_SHARDED:
            return (AXIS_MODEL, None, None, None)
        if parent in _TP_CONV_IN_SHARDED:
            return (None, AXIS_MODEL, None, None)
    if leaf.ndim == 1 and parent in (
        _TP_OUT_SHARDED | _TP_LINEAR_OUT_EXTRA | _TP_CONV_OUT_SHARDED
    ):
        return (AXIS_MODEL,)
    return ()


def unet_param_sharding(mesh: Any, path: tuple, leaf: Any, tensor_parallel: bool = True) -> Spec:
    """``unet_tp_spec`` with JAX's divisibility fallback: a sharded dimension
    that does not divide the model axis replicates the leaf. ``mesh`` needs
    only ``.shape``; ``leaf`` only ``.shape`` and ``.ndim``."""
    model_size = mesh.shape.get(AXIS_MODEL, 1)
    spec = unet_tp_spec(path, leaf) if tensor_parallel else ()
    for dim, axis in enumerate(spec):
        if axis == AXIS_MODEL and leaf.shape[dim] % model_size:
            return ()
    return spec


def _blocks(params: Any, config: UNetConfig):
    """(kind, path, heads) of every ResNet, attention and GEGLU block; heads
    for attentions (the stage's, the widest stage's in the mid block)."""
    n_stages = len(config.block_out_channels)
    stages = [("down_blocks", i, i) for i in range(len(params["down_blocks"]))]
    stages += [("up_blocks", i, n_stages - 1 - i) for i in range(len(params["up_blocks"]))]
    stages.append(("mid_block", None, n_stages - 1))
    for name, i, stage in stages:
        block = params[name] if i is None else params[name][i]
        base = (name,) if i is None else (name, i)
        for j in range(len(block["resnets"])):
            yield "resnet", base + ("resnets", j), None
        for j, attn in enumerate(block.get("attentions", [])):
            for b in range(len(attn["blocks"])):
                blk = base + ("attentions", j, "blocks", b)
                yield "attention", blk + ("attn1",), config.num_heads[stage]
                yield "attention", blk + ("attn2",), config.num_heads[stage]
                yield "geglu", blk + ("ff",), None


def _get(tree: Any, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def unet_tp_plan(params: Any, config: UNetConfig, model_size: int) -> dict[tuple, tuple]:
    """Block path → (the specs ``shard_bundle`` applies to its leaves, by
    leaf path, or None where the block stays replicated, with the reason)."""
    m = model_size
    plan: dict[tuple, tuple] = {}
    for kind, path, heads in _blocks(params, config):
        p = _get(params, path)
        if kind == "resnet":
            cout = p["conv1"]["kernel"].shape[0]
            if config.norm_groups % m or cout % m:
                plan[path] = (None, "groups")
                continue
            specs = {("conv1", "kernel"): (AXIS_MODEL, None, None, None),
                     ("conv1", "bias"): (AXIS_MODEL,),
                     ("time_emb_proj", "kernel"): (AXIS_MODEL, None),
                     ("time_emb_proj", "bias"): (AXIS_MODEL,),
                     ("norm2", "scale"): (AXIS_MODEL,), ("norm2", "bias"): (AXIS_MODEL,),
                     ("conv2", "kernel"): (None, AXIS_MODEL, None, None)}
        elif kind == "attention":
            if heads % m:
                plan[path] = (None, "heads")
                continue
            specs = {(name, "kernel"): (AXIS_MODEL, None) for name in ("to_q", "to_k", "to_v")}
            specs[("to_out", "kernel")] = (None, AXIS_MODEL)
        else:
            if (p["proj_in"]["kernel"].shape[0] // 2) % m:
                plan[path] = (None, "pair")
                continue
            specs = {("proj_in", "kernel"): (AXIS_MODEL, None), ("proj_in", "bias"): (AXIS_MODEL,),
                     ("proj_out", "kernel"): (None, AXIS_MODEL)}
        plan[path] = (specs, None)
    return plan


def applied_specs(params: Any, config: UNetConfig, model_size: int) -> dict[tuple, Spec]:
    """Leaf path → the spec ``shard_bundle`` applies (() = replicated)."""
    out = {path: () for path in _flatten(params)}
    for block, (specs, _) in unet_tp_plan(params, config, model_size).items():
        for sub, spec in (specs or {}).items():
            out[block + sub] = spec
    return out


def tp_departures(params: Any, config: UNetConfig, model_size: int) -> dict[tuple, str]:
    """Leaf path → the reason (module docstring) where the port's placement
    differs from ``unet_param_sharding``'s, or where it slices a leaf
    differently (the GEGLU halves)."""
    mesh = _SizeOnly(model_size)
    plan = unet_tp_plan(params, config, model_size)
    applied = applied_specs(params, config, model_size)
    reasons: dict[tuple, str] = {}
    for path, leaf in _flatten(params).items():
        block = next((b for b in plan if path[:len(b)] == b), None)
        spec = unet_param_sharding(mesh, path, leaf)
        if block is not None and plan[block][0] is None and spec:
            reasons[path] = plan[block][1]
        elif applied[path] != spec:
            reasons[path] = ("norm2" if "norm2" in path else "whole")
        elif block is not None and block[-1] == "ff" and path[len(block)] == "proj_in" and spec:
            reasons[path] = "halves"
    return reasons


@dataclasses.dataclass(frozen=True)
class _SizeOnly:
    model: int

    @property
    def shape(self) -> dict[str, int]:
        return {AXIS_MODEL: self.model}


def _slice(leaf: torch.Tensor, spec: Spec, rank: int, m: int, halves: bool) -> torch.Tensor:
    """This rank's slice of ``leaf`` along its sharded dimension; with
    ``halves``, the matching slices of the two halves, concatenated."""
    dim = spec.index(AXIS_MODEL)
    if halves:
        val, gate = leaf.chunk(2, dim=dim)
        return torch.cat([_slice(val, spec, rank, m, False),
                          _slice(gate, spec, rank, m, False)], dim=dim)
    step = leaf.shape[dim] // m
    return leaf.narrow(dim, rank * step, step).clone()


def _fingerprint(bundle) -> torch.Tensor:
    """One float64 per tree (UNet, VAE, context): the sum of every leaf's
    float64 sum and its sum of squares."""
    def total(tree):
        leaves = [t.double() for t in _flatten(tree).values()]
        return sum(t.sum() + t.square().sum() for t in leaves)

    return torch.stack([total(bundle.unet_params), total(bundle.vae.params),
                        total(bundle.text_context)])


def check_replicas(mesh: Mesh, bundle) -> None:
    """Raise unless every rank of ``mesh`` holds the same weights: the
    fingerprint's min and max, reduced over the model group and then the
    data group (so over the whole grid), agree. ``all_reduce`` only, which
    gloo also runs on CUDA tensors."""
    if not mesh.member:
        return
    fp = _fingerprint(bundle)
    lo, hi = fp.clone(), fp.clone()
    for axis in (AXIS_MODEL, AXIS_DATA):
        group = mesh.groups[axis]
        if group is not None and mesh.shape[axis] > 1:
            dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
            dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    if not torch.equal(lo, hi):
        raise RuntimeError("the ranks of the mesh hold different weights (load the same "
                           f"checkpoint or seed on every rank): fingerprints {lo.tolist()} to "
                           f"{hi.tolist()}")


def shard_bundle(mesh: Mesh, bundle, tensor_parallel: bool = False):
    """The bundle for this rank of ``mesh``: replicated, or with the UNet's
    blocks tensor-parallel over the model group as ``unet_tp_plan`` says
    (each ``ModelShard`` holding this rank's slices); the VAE, the context
    and every replicated leaf stay whole. Checks first that every rank
    holds the same weights (``check_replicas``)."""
    check_replicas(mesh, bundle)
    m = mesh.shape[AXIS_MODEL]
    if not tensor_parallel or m == 1 or not mesh.member:
        return bundle
    rank, group = mesh.coords[AXIS_MODEL], mesh.groups[AXIS_MODEL]
    params = _copy_tree(bundle.unet_params)
    for block, (specs, _) in unet_tp_plan(params, bundle.unet_config, m).items():
        if specs is None:
            continue
        p = _copy_tree(_get(params, block))
        for sub, spec in specs.items():
            parent = _get(p, sub[:-1])
            halves = sub[0] == "proj_in"  # the GEGLU's value | gate
            parent[sub[-1]] = _slice(parent[sub[-1]], spec, rank, m, halves)
        _get(params, block[:-1])[block[-1]] = ModelShard(p, group, m)
    return dataclasses.replace(bundle, unet_params=params, model_group=group)


def _copy_tree(tree: Any) -> Any:
    """The containers of ``tree`` copied, its tensors shared."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return tree


def shard_batch(mesh: Mesh, *arrays):
    """This data rank's contiguous block of the leading (batch) dimension of
    each array, as ``PartitionSpec("data", ...)`` places it in JAX."""
    out = tuple(data_sharding(mesh, a, 0) for a in arrays)
    return out if len(out) > 1 else out[0]


__all__ = ["AXIS_DATA", "AXIS_MODEL", "applied_specs", "check_replicas", "shard_batch",
           "shard_bundle", "tp_departures", "unet_param_sharding", "unet_tp_plan",
           "unet_tp_spec"]
