"""Ring attention: self-attention with the sequence split into P contiguous
shards whose key/value blocks rotate around a ring, PyTorch counterpart of
``depth_completion_tpu.ops.ring_attention`` (its flash-tiled body,
``_make_flash_ring``, :99, the TPU kernel this replaces).

The ring has no kernel of its own. Each shard's query rows meet every
visiting KV block through ``flash_fwd`` (the Hopper kernel on a CUDA
tensor, its plain twin on a CPU tensor), and the per-block outputs merge
exactly in the kernels' log2 domain: with ``lse2_b = m + log2 l`` per query
row, softmax attention over all keys is Σ_b o_b·2^lse2_b / Σ_b 2^lse2_b,
accumulated against a running max M (JAX ``ring_attention.py:145-165``).
The merged ``lse2 = M + log2 W`` is the global flash row statistic, so the
backward is a second ring pass of ``flash_bwd`` per visiting block fed the
global o and lse2: dq accumulates where it is, dk/dv accumulate in fp32 and
travel with their blocks, and are home after P rotations (:167-205). The
merge is eager PyTorch, as the JAX package computes it outside Pallas.

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

from depth_completion_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd


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
        return x.unflatten(0, (-1, self.size)).roll(1, dims=1).flatten(0, 1)


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


def ring_forward(q, k, v, num_heads: int, ring, block_fwd=flash_fwd):
    """The ring's forward over shards ``[N', S/P, C]`` (``ring.shard``
    layout): → (o in q.dtype, lse2 ``[N', heads, S/P]`` fp32, the global
    row statistic). ``block_fwd`` computes one visiting block."""
    n, s_loc, c = q.shape
    d = c // num_heads
    k_blk, v_blk = k, v
    for step in range(ring.size):
        o_b, lse2_b = block_fwd(q, k_blk, v_blk, num_heads)
        o_b = o_b.float().view(n, s_loc, num_heads, d)
        lse2_b = lse2_b.transpose(1, 2).unsqueeze(-1)  # [N', S/P, heads, 1]
        if step == 0:
            m, w, acc = lse2_b, torch.ones_like(lse2_b), o_b
        else:
            m_new = torch.maximum(m, lse2_b)
            scale_old, scale_b = torch.exp2(m - m_new), torch.exp2(lse2_b - m_new)
            acc = acc * scale_old + o_b * scale_b
            w = w * scale_old + scale_b
            m = m_new
        if step < ring.size - 1:  # the last block need not move on
            k_blk, v_blk = ring.shift(k_blk), ring.shift(v_blk)
    o = (acc / w).to(q.dtype).view(n, s_loc, c)
    lse2 = (m + torch.log2(w)).squeeze(-1).transpose(1, 2).contiguous()
    return o, lse2


def ring_backward(q, k, v, o, do, lse2, num_heads: int, ring, block_bwd=flash_bwd):
    """The ring's backward over shards, from the global ``o`` and ``lse2``
    of ``ring_forward``: → (dq, dk, dv) in the operands' dtypes. dk/dv
    rotate with their blocks, P times, so each ends at its own shard."""
    k_blk, v_blk = k, v
    for step in range(ring.size):
        dq_b, dk_b, dv_b = block_bwd(q, k_blk, v_blk, o, do, lse2, num_heads)
        if step == 0:
            dq, dk, dv = dq_b.float(), dk_b.float(), dv_b.float()
        else:
            dq, dk, dv = dq + dq_b, dk + dk_b, dv + dv_b
        if step < ring.size - 1:
            k_blk, v_blk = ring.shift(k_blk), ring.shift(v_blk)
        dk, dv = ring.shift(dk), ring.shift(dv)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class RingAttention(torch.autograd.Function):
    """Softmax attention over ``[N, S, C]`` computed by ``ring``'s shards,
    forward and backward through the flash wrappers."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, ring):
        qs, ks, vs = ring.shard(q), ring.shard(k), ring.shard(v)
        o, lse2 = ring_forward(qs, ks, vs, num_heads, ring)
        ctx.save_for_backward(qs, ks, vs, o, lse2)
        ctx.num_heads, ctx.ring = num_heads, ring
        return ring.gather(o)

    @staticmethod
    def backward(ctx, do):
        qs, ks, vs, o, lse2 = ctx.saved_tensors
        ring = ctx.ring
        dq, dk, dv = ring_backward(qs, ks, vs, o, ring.shard(do), lse2, ctx.num_heads, ring)
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
