"""Ring attention: self-attention with the sequence split into P contiguous
shards whose key/value blocks rotate around a ring, PyTorch counterpart of
``depth_completion_tpu.ops.ring_attention`` (its flash-tiled body,
``_make_flash_ring``, :99, the TPU kernel this replaces).

Each shard's query rows meet every visiting KV block through one ring
step of the flash kernels (``flash_fwd_ring`` / ``flash_bwd_ring``: the
Hopper kernels on a CUDA tensor, their plain twins on a CPU tensor). The
ring's merge is the kernels' own online softmax: with ``lse2_b = m + log2 l``
per block, softmax attention over all keys is Σ_b o_b·2^lse2_b /
Σ_b 2^lse2_b (JAX ``ring_attention.py:145-165``), and Σ_b o_b·2^(lse2_b−M)
= Σ_i 2^(s_i−M)·v_i over every key seen so far, so each step starts the
forward kernel from the running (max, row sum, fp32 accumulator) of the
blocks before and the last step normalises. Its lse2 is the global flash
row statistic, so the backward is a second ring pass of the backward
kernel per visiting block fed the global o and lse2: di is computed once,
dq accumulates in place in fp32, dk/dv accumulate in fp32 and travel with
their blocks, and are home after P rotations (:167-205). k and v travel
packed, as one ``[N', S/P, 2C]`` tensor, and so do dk and dv. The rule for
the step functions is JAX's (``_flash_ring_supported``, :215-224): at a
head dim that is neither 64 nor a multiple of 128, where JAX runs its XLA
ring body, the ring runs the steps' plain twins, on the card too; at every
other head dim it runs the step wrappers, which launch the step kernels of
the operands' (dtype, head dim) on the card, bf16 or fp32 at 64 and the
multiples of 128 up to 512, and raise above 512 (``MAX_HEAD_DIM``). The
softmax state and dq, dk|dv travel in fp32 at either dtype.

Shard r holds rows ``[r·S/P, (r+1)·S/P)`` (``PartitionSpec(None, axis,
None)`` in JAX). Two transports share the body, each with ``size``,
``shard`` (the caller's ``[N, S, C]`` → this process's shards), ``shift``
(the rotation by one: shard r takes shard r-1's block) and ``gather``
(shards → ``[N, S, C]``):

- ``LocalRing(P)``: all P shards in one process on one device, as one
  ``[N·P, S/P, C]`` tensor; the rotation rolls the shard axis, so each ring
  step is one kernel launch over every shard. The counterpart of the JAX
  tests' virtual mesh: every ring size runs on a single card.
- ``ProcessGroupRing(group)``: one rank per device over ``torch.distributed``
  (NCCL on CUDA, gloo on the CPU), the rotation a ``batch_isend_irecv`` to
  the next rank. Inputs are replicated ``[N, S, C]`` (the UNet stays
  replicated, as JAX native-res mode replicates the batch and shards the
  sequence); the ring takes its rank's shard and all-gathers the output,
  and in the backward the gradients.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from depth_completion_tpu_torch.ops.flash_attention import (
    flash_bwd_ring,
    flash_bwd_ring_plain,
    flash_fwd_ring,
    flash_fwd_ring_plain,
)


class LocalRing:
    """P shards in one process: ``[N, S, C]`` ↔ ``[N·P, S/P, C]`` views."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"ring size must be >= 1, got {size}")
        self.size = size

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        n, s, c = x.shape
        return x.reshape(n * self.size, s // self.size, c)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        n, s_loc, c = x.shape
        return x.reshape(n // self.size, s_loc * self.size, c)

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        # two slices concatenated: one vectorised copy, faster on an H100
        # than roll's indexed copy of the same bytes (PERF.md, Findings)
        x = x.unflatten(0, (-1, self.size))
        return torch.cat((x[:, -1:], x[:, :-1]), dim=1).flatten(0, 1)


class ProcessGroupRing:
    """One shard per rank of ``group`` (default: the world), over replicated
    ``[N, S, C]`` inputs and outputs."""

    def __init__(self, group: dist.ProcessGroup | None = None):
        self.group = dist.group.WORLD if group is None else group
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self._next = dist.get_global_rank(self.group, (self.rank + 1) % self.size)
        self._prev = dist.get_global_rank(self.group, (self.rank - 1) % self.size)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        s_loc = x.shape[1] // self.size
        return x[:, self.rank * s_loc:(self.rank + 1) * s_loc].contiguous()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=1)

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == 1:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, self._next, self.group),
               dist.P2POp(dist.irecv, out, self._prev, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


def ring_forward(q, k, v, num_heads: int, ring, step_fwd=flash_fwd_ring):
    """The ring's forward over shards ``[N', S/P, C]`` (``ring.shard``
    layout): → (o in q.dtype, lse2 ``[N', heads, S/P]`` fp32, the global
    row statistic). ``step_fwd`` runs one visiting block from the carried
    state (``flash_fwd_ring``'s contract)."""
    c = q.shape[-1]
    kv, state = torch.cat((k, v), dim=-1), None
    for step in range(ring.size):
        last = step == ring.size - 1
        state = step_fwd(q, kv[..., :c], kv[..., c:], num_heads, state, last)
        if not last:  # the last block need not move on
            kv = ring.shift(kv)
    return state


def ring_backward(q, k, v, o, do, lse2, num_heads: int, ring, step_bwd=flash_bwd_ring):
    """The ring's backward over shards, from the global ``o`` and ``lse2``
    of ``ring_forward``: → (dq, dk, dv) in the operands' dtypes. dk|dv
    rotate with their blocks, P times, so each ends at its own shard."""
    c = q.shape[-1]
    kv, state = torch.cat((k, v), dim=-1), None
    for step in range(ring.size):
        di, dq, dkv = step_bwd(q, kv[..., :c], kv[..., c:], o, do, lse2, num_heads, state)
        if step < ring.size - 1:
            kv = ring.shift(kv)
        state = (di, dq, ring.shift(dkv))
    _, dq, dkv = state
    dkv = dkv.to(k.dtype)
    return dq.to(q.dtype), dkv[..., :c], dkv[..., c:]


def ring_steps(head_dim: int):
    """The ring's (forward, backward) step functions at ``head_dim``: the
    plain twins where JAX's flash ring does not apply (neither 64 nor a
    multiple of 128), the step wrappers elsewhere, at either dtype."""
    if head_dim % 128 != 0 and head_dim != 64:
        return flash_fwd_ring_plain, flash_bwd_ring_plain
    return flash_fwd_ring, flash_bwd_ring


class RingAttention(torch.autograd.Function):
    """Softmax attention over ``[N, S, C]`` computed by ``ring``'s shards,
    forward and backward through ``ring_steps``."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, ring):
        qs, ks, vs = ring.shard(q), ring.shard(k), ring.shard(v)
        step_fwd, _ = ring_steps(q.shape[-1] // num_heads)
        o, lse2 = ring_forward(qs, ks, vs, num_heads, ring, step_fwd)
        ctx.save_for_backward(qs, ks, vs, o, lse2)
        ctx.num_heads, ctx.ring = num_heads, ring
        return ring.gather(o)

    @staticmethod
    def backward(ctx, do):
        qs, ks, vs, o, lse2 = ctx.saved_tensors
        ring = ctx.ring
        _, step_bwd = ring_steps(qs.shape[-1] // ctx.num_heads)
        dq, dk, dv = ring_backward(qs, ks, vs, o, ring.shard(do), lse2, ctx.num_heads, ring,
                                   step_bwd)
        return ring.gather(dq), ring.gather(dk), ring.gather(dv), None, None


def ring_attention(q, k, v, num_heads: int, ring) -> torch.Tensor:
    """Self-attention over ``[N, S, C]`` with the sequence split over
    ``ring`` (a ``LocalRing`` or ``ProcessGroupRing``); equals
    ``layers.attention`` up to the order of fp32 sums."""
    s = q.shape[1]
    if k.shape[1] != s or v.shape[1] != s:
        raise ValueError(f"ring attention takes self-attention, got Sq={s}, Sk={k.shape[1]}")
    if s % ring.size:
        raise ValueError(f"sequence {s} not divisible by ring size {ring.size}")
    return RingAttention.apply(q, k, v, num_heads, ring)
