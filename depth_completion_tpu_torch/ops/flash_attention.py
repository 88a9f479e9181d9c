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

Wrappers take the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises. ``LAUNCHES`` counts kernel launches, the
d=512 kernels under their own names.
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

# kernel launches per wrapper, read by chip_smoke.py
LAUNCHES = {name: 0 for _, fwd, bwd in _KERNELS.values() for name in (fwd, bwd)}

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

def flash_fwd_plain(q, k, v, num_heads):
    """→ (o [N, Sq, C] in q.dtype, lse2 [N, heads, Sq] fp32)."""
    n, sq, c = q.shape
    sk = k.shape[1]
    d = c // num_heads
    qh = q.float().reshape(n, sq, num_heads, d).transpose(1, 2)
    kh = k.float().reshape(n, sk, num_heads, d).transpose(1, 2)
    vh = v.float().reshape(n, sk, num_heads, d).transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * ((1.0 / math.sqrt(d)) * _LOG2E)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(q.dtype).float(), vh) / l
    lse2 = (m + torch.log2(l))[..., 0]
    return o.transpose(1, 2).reshape(n, sq, c).to(q.dtype), lse2


def flash_bwd_plain(q, k, v, o, do, lse2, num_heads):
    """→ (dq, dk, dv) in the operands' dtype, recomputing p from lse2."""
    n, sq, c = q.shape
    sk = k.shape[1]
    d = c // num_heads
    scale = 1.0 / math.sqrt(d)

    def heads(x, s):
        return x.float().reshape(n, s, num_heads, d).transpose(1, 2)

    qh, kh, vh, oh, doh = heads(q, sq), heads(k, sk), heads(v, sk), heads(o, sq), heads(do, sq)
    p = torch.exp2(torch.matmul(qh, kh.transpose(-1, -2)) * (scale * _LOG2E) - lse2[..., None])
    di = (doh * oh).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), doh)
    ds = p * (torch.matmul(doh, vh.transpose(-1, -2)) - di) * scale
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)

    def merge(x, s):
        return x.transpose(1, 2).reshape(n, s, c).to(q.dtype)

    return merge(dq, sq), merge(dk, sk), merge(dv, sk)


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
