"""Flash attention: Hopper kernels (forward and one-pass backward), their
plain PyTorch twins, and the ``autograd.Function`` behind the UNet's and the
KL VAE's ``attention_fn`` seam.

Counterpart of ``depth_completion_tpu.ops.flash_attention``. The CUDA kernels
replace the TPU kernels ``_fwd_kernel`` (flash_attention.py:163) and
``_bwd_fused_kernel`` / ``_bwd_fused_kernel_t`` (:464 / :534), which the JAX
package runs at head dim 64 and every multiple of 128, on bf16 or fp32
operands. The route is keyed by (dtype, head dim): bf16 at 64 (the UNet)
and 512 (the KL VAE's one-head mid attention) take the tuned kernels of
``csrc/flash_attention.cu`` (``flash_fwd``/``flash_bwd``,
``flash_fwd_d512``/``flash_bwd_d512``); every other pair, fp32 at 64, 128,
256, 384 and 512 and bf16 at 128, 256 and 384, takes the generic pair of
``csrc/flash_generic.cuh`` (``csrc/flash_generic_f32.cu``: 3xTF32;
``csrc/flash_generic_bf16.cu``), counted as ``flash_fwd_<dtype>_d<D>`` and
``flash_bwd_<dtype>_d<D>``. Routing is the JAX package's (``flash_attention``,
:893-921): calls with ``sk < min_seq_len`` (the 2-token cross-attention, the
deep UNet stages) or a head dim other than 64 or a multiple of 128 take the
plain ``layers.attention``. On a CUDA tensor a head dim above
``MAX_HEAD_DIM`` (512, where JAX's own block sweep stops) raises.

Row statistic: ``lse2 = m + log2(l)`` per query row in the log2 domain
(scores scaled by ``scale * log2(e)``), fp32, ``[N, heads, Sq]``. The
backward recomputes ``p = exp2(s * scale * log2(e) - lse2)``.

The ring of ``ops.ring_attention`` (TPU kernel ``_make_flash_ring``,
ring_attention.py:99) runs ring instantiations of the same kernels, one
step per visiting key/value block, at every (dtype, head dim) pair above:
``flash_fwd_ring`` carries the online softmax's state (m, l, acc) in fp32
from block to block, ``flash_bwd_ring`` adds into one fp32 dq and the
travelling fp32 dk|dv. bf16 at 64 runs the tuned kernels' instantiations
(``flash_fwd_ring``/``flash_bwd_ring``), every other pair the generic
pair's (``flash_fwd_ring_<dtype>_d<D>``). Each has a plain twin with the
same signature.

Wrappers take the plain version only for CPU tensors; a CUDA tensor
launches the kernel of its (dtype, head dim) or raises: nothing casts
fp32 operands to bf16. ``LAUNCHES`` counts kernel launches under the names
above (``route``).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from depth_completion_tpu_torch import _build
from depth_completion_tpu_torch.models.layers import attention as plain_attention

_LOG2E = 1.4426950408889634
MAX_HEAD_DIM = 512
HEAD_DIMS = (64, 128, 256, 384, 512)  # the kernels' head dims: 64 and multiples of 128 to 512
DTYPE_TAGS = {torch.bfloat16: "bf16", torch.float32: "fp32"}
# the generic pair's library and entry-point suffix per dtype
_GENERIC = {torch.float32: ("flash_generic_f32", "f32"),
            torch.bfloat16: ("flash_generic_bf16", "bf16")}


class Route(NamedTuple):
    """Where a (dtype, head dim) pair's kernels live: the library, its
    forward and backward C entry points, and their launch-count names."""

    lib: str
    fwd_entry: str
    bwd_entry: str
    fwd: str
    bwd: str


def route(dtype: torch.dtype, head_dim: int, ring: bool = False) -> Route:
    """The kernels that take ``dtype`` operands at ``head_dim``, a whole call
    or with ``ring`` one ring step: bf16 at 64 and 512 (not the d=512 ring
    steps) the tuned kernels of ``flash_attention.cu``, every other pair the
    generic pair of its dtype."""
    if dtype == torch.bfloat16 and head_dim == 64:
        x = "_ring" if ring else ""
        return Route("flash_attention", f"dct_flash_fwd{x}", f"dct_flash_bwd{x}", f"flash_fwd{x}",
                     f"flash_bwd{x}")
    if dtype == torch.bfloat16 and head_dim == 512 and not ring:
        return Route("flash_attention", "dct_flash_fwd_d512", "dct_flash_bwd_d512",
                     "flash_fwd_d512", "flash_bwd_d512")
    lib, suffix = _GENERIC[dtype]
    tag = f"{'ring_' if ring else ''}{DTYPE_TAGS[dtype]}_d{head_dim}"
    return Route(lib, f"dct_flash_fwd_{suffix}", f"dct_flash_bwd_{suffix}", f"flash_fwd_{tag}",
                 f"flash_bwd_{tag}")


def launch_names(dtype: torch.dtype, head_dim: int, ring: bool = False) -> tuple[str, str]:
    """``route``'s (forward, backward) launch-count names."""
    r = route(dtype, head_dim, ring)
    return r.fwd, r.bwd


# kernel launches per wrapper, read by chip_smoke.py
LAUNCHES = {name: 0 for dtype in DTYPE_TAGS for d in HEAD_DIMS for ring in (False, True)
            for name in launch_names(dtype, d, ring)}

_i, _l, _f, _p = ctypes.c_int, ctypes.c_long, ctypes.c_float, ctypes.c_void_p
_libs: dict[str, ctypes.CDLL] = {}


def _kernels(name: str = "flash_attention"):
    """The loaded library ``name`` (the tuned kernels, or a generic pair's
    ``flash_generic_f32`` / ``flash_generic_bf16``), argument types set."""
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        if name == "flash_attention":
            for suffix in ("", "_d512"):
                fwd = getattr(lib, f"dct_flash_fwd{suffix}")
                bwd = getattr(lib, f"dct_flash_bwd{suffix}")
                fwd.argtypes = [_p] * 5 + [_i] * 4 + [_l] * 8 + [_f, _p]
                bwd.argtypes = [_p] * 10 + [_i] * 4 + [_l] * 10 + [_f, _p]
                fwd.restype = bwd.restype = _i
            lib.dct_flash_fwd_ring.argtypes = [_p] * 8 + [_i] * 4 + [_l] * 8 + [_i, _i, _f, _p]
            lib.dct_flash_bwd_ring.argtypes = [_p] * 9 + [_i] * 4 + [_l] * 10 + [_i, _f, _p]
            lib.dct_flash_fwd_ring.restype = lib.dct_flash_bwd_ring.restype = _i
        else:
            suffix = name.rsplit("_", 1)[1]
            fwd, bwd = getattr(lib, f"dct_flash_fwd_{suffix}"), getattr(lib, f"dct_flash_bwd_{suffix}")
            fwd.argtypes = [_p] * 8 + [_i] * 5 + [_l] * 8 + [_i, _i, _f, _p]
            bwd.argtypes = [_p] * 11 + [_i] * 5 + [_l] * 10 + [_i, _i, _f, _p]
            fwd.restype = bwd.restype = _i
        _libs[name] = lib
    return lib


def _check_cuda_operands(*xs: torch.Tensor, head_dim: int) -> torch.dtype:
    """Raise on what the kernels do not take; → the operands' dtype (bf16 or
    fp32, every operand alike)."""
    dtype = xs[0].dtype
    for x in xs:
        if x.dtype not in DTYPE_TAGS or x.dtype != dtype:
            raise TypeError(f"flash kernels take bfloat16 or float32 operands of one dtype, "
                            f"got {[y.dtype for y in xs]}")
        if x.dim() != 3 or x.stride(2) != 1 or x.stride(0) % 8 or x.stride(1) % 8:
            raise ValueError(
                "flash kernel takes [N, S, C] with unit channel stride and "
                f"batch/row strides that are multiples of 8, got strides {x.stride()}"
            )
        if x.data_ptr() % 16:
            raise ValueError("flash kernel operands must be 16-byte aligned")
    if head_dim not in HEAD_DIMS:
        raise NotImplementedError(
            f"the flash kernels take head dims {HEAD_DIMS} (64 and the multiples of 128 up to "
            f"MAX_HEAD_DIM={MAX_HEAD_DIM}, where JAX's block sweep stops), got {head_dim}"
        )
    return dtype


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

def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptr(x):
    return None if x is None else x.data_ptr()


def flash_fwd(q, k, v, num_heads):
    """Forward: (o [N, Sq, C], lse2 [N, heads, Sq] fp32). CPU → plain twin."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, num_heads)
    n, sq, c = q.shape
    sk, d = k.shape[1], c // num_heads
    r = route(_check_cuda_operands(q, k, v, head_dim=d), d)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse2 = torch.empty((n, num_heads, sq), device=q.device, dtype=torch.float32)
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1),
               v.stride(0), v.stride(1), o.stride(0), o.stride(1))
    fn = getattr(_kernels(r.lib), r.fwd_entry)
    if r.lib == "flash_attention":
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse2.data_ptr(),
                    n, num_heads, sq, sk, *strides, 1.0 / math.sqrt(d), _stream(q))
    else:
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse2.data_ptr(), None,
                    None, None, n, num_heads, sq, sk, d, *strides, 0, 0, 1.0 / math.sqrt(d),
                    _stream(q))
    _build.check(status, r.fwd)
    LAUNCHES[r.fwd] += 1
    return o, lse2


def flash_bwd(q, k, v, o, do, lse2, num_heads):
    """Backward: (dq, dk, dv). CPU → plain twin."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, do, lse2, num_heads)
    n, sq, c = q.shape
    sk, d = k.shape[1], c // num_heads
    do = do.contiguous()
    r = route(_check_cuda_operands(q, k, v, o, do, head_dim=d), d)
    di = torch.empty((n, num_heads, sq), device=q.device, dtype=torch.float32)
    dq_acc = torch.zeros((n, sq, c), device=q.device, dtype=torch.float32)
    dk = torch.empty((n, sk, c), device=q.device, dtype=k.dtype)
    dv = torch.empty((n, sk, c), device=q.device, dtype=v.dtype)
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
               o.stride(0), o.stride(1), do.stride(0), do.stride(1))
    lse2 = lse2.contiguous()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse2.data_ptr(), di.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr())
    fn = getattr(_kernels(r.lib), r.bwd_entry)
    if r.lib == "flash_attention":
        status = fn(*ptrs, n, num_heads, sq, sk, *strides, 1.0 / math.sqrt(d), _stream(q))
    else:
        status = fn(*ptrs, None, n, num_heads, sq, sk, d, *strides, 0, 1, 1.0 / math.sqrt(d),
                    _stream(q))
    _build.check(status, r.bwd)
    LAUNCHES[r.bwd] += 1
    return dq_acc.to(q.dtype), dk, dv


def flash_fwd_ring(q, k, v, num_heads, state=None, last=False):
    """One step of the ring's forward (``flash_fwd_ring_plain``'s contract):
    q's rows against one visiting key/value block, the online softmax
    started from ``state`` (None on the first step) → the state, updated in
    place, or with ``last`` (o, lse2). CPU → plain twin."""
    if q.device.type == "cpu":
        return flash_fwd_ring_plain(q, k, v, num_heads, state, last)
    n, sq, c = q.shape
    sk, d = k.shape[1], c // num_heads
    r = route(_check_cuda_operands(q, k, v, head_dim=d), d, ring=True)
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
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
               sq * c, c)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(o), _ptr(lse2), _ptr(m), _ptr(l),
            _ptr(acc))
    fn = getattr(_kernels(r.lib), r.fwd_entry)
    if r.lib == "flash_attention":  # bf16 at d=64: the tuned kernel's instantiation
        status = fn(*ptrs, n, num_heads, sq, sk, *strides, int(state_in), int(not last),
                    1.0 / math.sqrt(d), _stream(q))
    else:
        status = fn(*ptrs, n, num_heads, sq, sk, d, *strides, int(state_in), int(not last),
                    1.0 / math.sqrt(d), _stream(q))
    _build.check(status, r.fwd)
    LAUNCHES[r.fwd] += 1
    return (o, lse2) if last else state


def flash_bwd_ring(q, k, v, o, do, lse2, num_heads, state=None):
    """One step of the ring's backward (``flash_bwd_ring_plain``'s
    contract): the first step (``state`` None) also computes di and zeroes
    the fp32 dq and dk|dv; every step adds this block's part in place →
    (di, dq, dkv). CPU → plain twin."""
    if q.device.type == "cpu":
        return flash_bwd_ring_plain(q, k, v, o, do, lse2, num_heads, state)
    n, sq, c = q.shape
    sk, d = k.shape[1], c // num_heads
    do = do.contiguous()
    r = route(_check_cuda_operands(q, k, v, o, do, head_dim=d), d, ring=True)
    if state is None:
        di = torch.empty((n, num_heads, sq), device=q.device, dtype=torch.float32)
        dq = torch.zeros((n, sq, c), device=q.device, dtype=torch.float32)
        dkv = torch.zeros((n, sk, 2 * c), device=q.device, dtype=torch.float32)
    else:
        di, dq, dkv = state
        if not (dq.is_contiguous() and dkv.is_contiguous()):
            raise ValueError("the ring's dq and dk|dv must be contiguous fp32")
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
               o.stride(0), o.stride(1), do.stride(0), do.stride(1))
    lse2 = lse2.contiguous()
    fn = getattr(_kernels(r.lib), r.bwd_entry)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse2.data_ptr(), di.data_ptr(), dq.data_ptr())
    if r.lib == "flash_attention":  # bf16 at d=64: the tuned kernel's instantiation
        status = fn(*ptrs, dkv.data_ptr(), n, num_heads, sq, sk, *strides, int(state is None),
                    1.0 / math.sqrt(d), _stream(q))
    else:
        status = fn(*ptrs, None, None, dkv.data_ptr(), n, num_heads, sq, sk, d, *strides, 1,
                    int(state is None), 1.0 / math.sqrt(d), _stream(q))
    _build.check(status, r.bwd)
    LAUNCHES[r.bwd] += 1
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
    the plain path, as in the JAX package; the kernels take bf16 and fp32 at
    64 and the multiples of 128 up to ``MAX_HEAD_DIM``, and a CUDA tensor
    above it raises.
    """
    c = q.shape[-1]
    sk = k.shape[1]
    if sk < min_seq_len or c % num_heads != 0:
        return plain_attention(q, k, v, num_heads)
    d = c // num_heads
    if d % 128 != 0 and d != 64:
        return plain_attention(q, k, v, num_heads)
    return FlashAttention.apply(q, k, v, num_heads)
