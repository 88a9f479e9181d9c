"""Flash attention: Hopper kernels (forward and one-pass backward), their
plain PyTorch twins, and the ``autograd.Function`` behind the UNet's and the
KL VAE's ``attention_fn`` seam.

Counterpart of ``depth_completion_tpu.ops.flash_attention``. The CUDA kernels
are in ``csrc/flash_attention.cu``, built for two head dims: 64 (the UNet)
and 512 (the KL VAE's one-head mid attention). They replace the TPU kernels
``_fwd_kernel`` (flash_attention.py:163) and ``_bwd_fused_kernel`` /
``_bwd_fused_kernel_t`` (:464 / :534), which the JAX package runs at both
head dims. Routing is the JAX package's (``flash_attention``, :893-921):
calls with ``sk < min_seq_len`` (the 2-token cross-attention, the deep UNet
stages) or a head dim other than 64 or a multiple of 128 take the plain
``layers.attention``; on a CUDA tensor, a head dim other than 64 or 512
raises.

Row statistic: ``lse2 = m + log2(l)`` per query row in the log2 domain
(scores scaled by ``scale * log2(e)``), fp32, ``[N, heads, Sq]``. The
backward recomputes ``p = exp2(s * scale * log2(e) - lse2)``.

The ring of ``ops.ring_attention`` (TPU kernel ``_make_flash_ring``,
ring_attention.py:99) runs its own instantiations of the d=64 kernels, one
step per visiting key/value block: ``flash_fwd_ring`` carries the online
softmax's state (m, l, acc) in fp32 from block to block, ``flash_bwd_ring``
adds into one fp32 dq and the travelling fp32 dk|dv. Each has a plain twin
with the same signature.

Wrappers take the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises. ``LAUNCHES`` counts kernel launches, the
d=512 and ring kernels under their own names.
"""

from __future__ import annotations

import ctypes
import math

import torch

from depth_completion_tpu_torch import _build
from depth_completion_tpu_torch.models.layers import attention as plain_attention

_LOG2E = 1.4426950408889634
# head dim → the kernels' entry points and launch-count names
_KERNELS = {64: ("", "flash_fwd", "flash_bwd"), 512: ("_d512", "flash_fwd_d512", "flash_bwd_d512")}

# kernel launches per wrapper, read by chip_smoke.py; the ring step kernels
# (head dim 64) under their own names
LAUNCHES = {name: 0 for _, fwd, bwd in _KERNELS.values() for name in (fwd, bwd)}
LAUNCHES.update(flash_fwd_ring=0, flash_bwd_ring=0)

_i, _l, _f, _p = ctypes.c_int, ctypes.c_long, ctypes.c_float, ctypes.c_void_p
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        for suffix, _, _ in _KERNELS.values():
            fwd, bwd = getattr(lib, f"dct_flash_fwd{suffix}"), getattr(lib, f"dct_flash_bwd{suffix}")
            fwd.argtypes = [_p] * 5 + [_i] * 4 + [_l] * 8 + [_f, _p]
            bwd.argtypes = [_p] * 10 + [_i] * 4 + [_l] * 10 + [_f, _p]
            fwd.restype = bwd.restype = _i
        lib.dct_flash_fwd_ring.argtypes = [_p] * 8 + [_i] * 4 + [_l] * 8 + [_i, _i, _f, _p]
        lib.dct_flash_bwd_ring.argtypes = [_p] * 9 + [_i] * 4 + [_l] * 10 + [_i, _f, _p]
        lib.dct_flash_fwd_ring.restype = lib.dct_flash_bwd_ring.restype = _i
        _lib = lib
    return _lib


def _check_cuda_operands(*xs: torch.Tensor, head_dim: int) -> tuple[str, str, str]:
    """Raise on what the kernels do not take; → (entry-point suffix, forward
    and backward launch-count names) for ``head_dim``."""
    for x in xs:
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bfloat16, got {x.dtype}")
        if x.dim() != 3 or x.stride(2) != 1 or x.stride(0) % 8 or x.stride(1) % 8:
            raise ValueError(
                "flash kernel takes [N, S, C] with unit channel stride and "
                f"batch/row strides that are multiples of 8, got strides {x.stride()}"
            )
        if x.data_ptr() % 16:
            raise ValueError("flash kernel operands must be 16-byte aligned")
    if head_dim not in _KERNELS:
        raise NotImplementedError(
            f"the flash kernels are built for head dims {sorted(_KERNELS)}, got {head_dim}"
        )
    return _KERNELS[head_dim]


# ---------------------------------------------------------------------------
# Plain twins (fp32 math)
# ---------------------------------------------------------------------------

def _heads(x, num_heads):
    """[N, S, C] → [N, heads, S, d] in fp32."""
    n, s, c = x.shape
    return x.float().reshape(n, s, num_heads, c // num_heads).transpose(1, 2)


def _merge(x):
    """[N, heads, S, d] → [N, S, heads·d]."""
    n, h, s, d = x.shape
    return x.transpose(1, 2).reshape(n, s, h * d)


def flash_fwd_ring_plain(q, k, v, num_heads, state=None, last=False):
    """One ring step of the forward: the online softmax over the visiting
    block's keys started from ``state`` = (m, l ``[N, heads, Sq]``, acc
    ``[N, Sq, C]``, fp32: running max, row sum 2^(s−m) and unnormalised
    output of the blocks before), or from scratch when ``state`` is None. →
    the new state, written into ``state``'s tensors where given; with
    ``last``, (o in q.dtype, lse2) instead. p is rounded to q.dtype for p·v,
    as the kernel rounds it to bf16."""
    n, sq, c = q.shape
    qh, kh, vh = _heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * ((1.0 / math.sqrt(c // num_heads)) * _LOG2E)
    m = s.amax(dim=-1)
    if state is not None:
        m = torch.maximum(state[0], m)
        alpha = torch.exp2(state[0] - m)
    p = torch.exp2(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.matmul(p.to(q.dtype).float(), vh)
    if state is not None:
        l = state[1] * alpha + l
        acc = _heads(state[2], num_heads) * alpha[..., None] + acc
    if last:
        return _merge(acc / l[..., None]).to(q.dtype), m + torch.log2(l)
    if state is None:
        return m, l, _merge(acc)
    for dst, src in zip(state, (m, l, _merge(acc))):
        dst.copy_(src)
    return state


def flash_fwd_plain(q, k, v, num_heads):
    """→ (o [N, Sq, C] in q.dtype, lse2 [N, heads, Sq] fp32)."""
    return flash_fwd_ring_plain(q, k, v, num_heads, last=True)


def flash_bwd_ring_plain(q, k, v, o, do, lse2, num_heads, state=None):
    """One ring step of the backward against one visiting block, from the
    global o and lse2: ``state`` is None on the first step (di = rowsum(do·o)
    is computed, dq ``[N, Sq, C]`` and the travelling dk|dv ``[N, Sk, 2C]``
    start at 0, fp32), else (di, dq, dkv) of the step before. Adds this
    block's dq, dk and dv into them in place → (di, dq, dkv)."""
    c = q.shape[-1]
    scale = 1.0 / math.sqrt(c // num_heads)
    qh, kh, vh, doh = (_heads(x, num_heads) for x in (q, k, v, do))
    if state is None:
        di = (doh * _heads(o, num_heads)).sum(dim=-1)
        dq = torch.zeros(q.shape, device=q.device, dtype=torch.float32)
        dkv = torch.zeros((k.shape[0], k.shape[1], 2 * c), device=q.device, dtype=torch.float32)
    else:
        di, dq, dkv = state
    p = torch.exp2(torch.matmul(qh, kh.transpose(-1, -2)) * (scale * _LOG2E) - lse2[..., None])
    ds = p * (torch.matmul(doh, vh.transpose(-1, -2)) - di[..., None]) * scale
    dq += _merge(torch.matmul(ds, kh))
    dkv[..., :c] += _merge(torch.matmul(ds.transpose(-1, -2), qh))
    dkv[..., c:] += _merge(torch.matmul(p.transpose(-1, -2), doh))
    return di, dq, dkv


def flash_bwd_plain(q, k, v, o, do, lse2, num_heads):
    """→ (dq, dk, dv) in the operands' dtype, recomputing p from lse2."""
    c = q.shape[-1]
    _, dq, dkv = flash_bwd_ring_plain(q, k, v, o, do, lse2, num_heads)
    return dq.to(q.dtype), dkv[..., :c].to(k.dtype), dkv[..., c:].to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def flash_fwd(q, k, v, num_heads):
    """Forward: (o [N, Sq, C], lse2 [N, heads, Sq] fp32). CPU → plain twin."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, num_heads)
    n, sq, c = q.shape
    sk = k.shape[1]
    suffix, name, _ = _check_cuda_operands(q, k, v, head_dim=c // num_heads)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse2 = torch.empty((n, num_heads, sq), device=q.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = getattr(_kernels(), f"dct_flash_fwd{suffix}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse2.data_ptr(),
        n, num_heads, sq, sk,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), o.stride(0), o.stride(1),
        1.0 / math.sqrt(c // num_heads), stream,
    )
    _build.check(status, name)
    LAUNCHES[name] += 1
    return o, lse2


def flash_bwd(q, k, v, o, do, lse2, num_heads):
    """Backward: (dq, dk, dv). CPU → plain twin."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, do, lse2, num_heads)
    n, sq, c = q.shape
    sk = k.shape[1]
    do = do.contiguous()
    suffix, _, name = _check_cuda_operands(q, k, v, o, do, head_dim=c // num_heads)
    di = torch.empty((n, num_heads, sq), device=q.device, dtype=torch.float32)
    dq_acc = torch.zeros((n, sq, c), device=q.device, dtype=torch.float32)
    dk = torch.empty((n, sk, c), device=q.device, dtype=k.dtype)
    dv = torch.empty((n, sk, c), device=q.device, dtype=v.dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = getattr(_kernels(), f"dct_flash_bwd{suffix}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse2.contiguous().data_ptr(), di.data_ptr(), dq_acc.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        n, num_heads, sq, sk,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        o.stride(0), o.stride(1), do.stride(0), do.stride(1),
        1.0 / math.sqrt(c // num_heads), stream,
    )
    _build.check(status, name)
    LAUNCHES[name] += 1
    return dq_acc.to(q.dtype), dk, dv


def _check_ring(*xs: torch.Tensor, num_heads: int) -> None:
    _check_cuda_operands(*xs, head_dim=xs[0].shape[-1] // num_heads)
    if xs[0].shape[-1] // num_heads != 64:
        raise NotImplementedError("the ring step kernels are built for head dim 64")


def flash_fwd_ring(q, k, v, num_heads, state=None, last=False):
    """One step of the ring's forward (``flash_fwd_ring_plain``'s contract):
    q's rows against one visiting key/value block, the online softmax
    started from ``state`` (None on the first step) → the state, updated in
    place, or with ``last`` (o, lse2). CPU → plain twin."""
    if q.device.type == "cpu":
        return flash_fwd_ring_plain(q, k, v, num_heads, state, last)
    n, sq, c = q.shape
    sk = k.shape[1]
    _check_ring(q, k, v, num_heads=num_heads)
    state_in = state is not None
    if state is None and not last:
        m = torch.empty((n, num_heads, sq), device=q.device, dtype=torch.float32)
        state = (m, torch.empty_like(m),
                 torch.empty((n, sq, c), device=q.device, dtype=torch.float32))
    if state is not None and not all(x.is_contiguous() and x.dtype == torch.float32 for x in state):
        raise ValueError("the ring's state must be contiguous fp32")
    o = lse2 = None
    if last:
        o = torch.empty((n, sq, c), device=q.device, dtype=q.dtype)
        lse2 = torch.empty((n, num_heads, sq), device=q.device, dtype=torch.float32)
    m, l, acc = state if state is not None else (None, None, None)

    def ptr(x):
        return None if x is None else x.data_ptr()

    status = _kernels().dct_flash_fwd_ring(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(o), ptr(lse2), ptr(m), ptr(l), ptr(acc),
        n, num_heads, sq, sk,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        sq * c, c, int(state_in), int(not last), 1.0 / math.sqrt(c // num_heads),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_fwd_ring")
    LAUNCHES["flash_fwd_ring"] += 1
    return (o, lse2) if last else state


def flash_bwd_ring(q, k, v, o, do, lse2, num_heads, state=None):
    """One step of the ring's backward (``flash_bwd_ring_plain``'s
    contract): the first step (``state`` None) also computes di and zeroes
    the fp32 dq and dk|dv; every step adds this block's part in place →
    (di, dq, dkv). CPU → plain twin."""
    if q.device.type == "cpu":
        return flash_bwd_ring_plain(q, k, v, o, do, lse2, num_heads, state)
    n, sq, c = q.shape
    sk = k.shape[1]
    do = do.contiguous()
    _check_ring(q, k, v, o, do, num_heads=num_heads)
    if state is None:
        di = torch.empty((n, num_heads, sq), device=q.device, dtype=torch.float32)
        dq = torch.zeros((n, sq, c), device=q.device, dtype=torch.float32)
        dkv = torch.zeros((n, sk, 2 * c), device=q.device, dtype=torch.float32)
    else:
        di, dq, dkv = state
        if not (dq.is_contiguous() and dkv.is_contiguous()):
            raise ValueError("the ring's dq and dk|dv must be contiguous fp32")
    status = _kernels().dct_flash_bwd_ring(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse2.contiguous().data_ptr(), di.data_ptr(), dq.data_ptr(), dkv.data_ptr(),
        n, num_heads, sq, sk,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        o.stride(0), o.stride(1), do.stride(0), do.stride(1), int(state is None),
        1.0 / math.sqrt(c // num_heads), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "flash_bwd_ring")
    LAUNCHES["flash_bwd_ring"] += 1
    return di, dq, dkv


class FlashAttention(torch.autograd.Function):
    """o = softmax(q kᵀ / √d) v per head, forward and backward through the
    wrappers above (kernels on CUDA, plain twins on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        o, lse2 = flash_fwd(q, k, v, num_heads)
        ctx.save_for_backward(q, k, v, o, lse2)
        ctx.num_heads = num_heads
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse2 = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, do, lse2, ctx.num_heads)
        return dq, dk, dv, None


def flash_attention(q, k, v, num_heads: int, min_seq_len: int = 768):
    """Drop-in for ``layers.attention`` over ``[N, S, C]`` tensors.

    Short KV sequences and head dims other than 64 or a multiple of 128 take
    the plain path, as in the JAX package; the kernels take d=64 and d=512.
    """
    c = q.shape[-1]
    sk = k.shape[1]
    if sk < min_seq_len or c % num_heads != 0:
        return plain_attention(q, k, v, num_heads)
    d = c // num_heads
    if d % 128 != 0 and d != 64:
        return plain_attention(q, k, v, num_heads)
    return FlashAttention.apply(q, k, v, num_heads)
