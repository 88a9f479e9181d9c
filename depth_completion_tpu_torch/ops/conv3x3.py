"""Fused 3x3 conv: the Hopper kernels, their plain PyTorch twin and the
``autograd.Function`` the TAESD decoder runs through.

Counterpart of ``depth_completion_tpu.ops.conv3x3``. The CUDA kernels
(``csrc/conv3x3.cu``) replace the TPU kernel ``_conv_kernel``
(conv3x3.py:81): ``maybe_relu(conv3x3_same(x, W) + bias + skip)`` over NHWC
in one pass with fp32 accumulation, optionally zeroing its operand where a
mask is ``<= 0`` (halo rows included) and writing the masked operand out.
Two forms, chosen by the operands' dtype: bf16 (``conv3x3``) and fp32
(``conv3x3_fp32``, ``--precision fp32``: 3xTF32 products on the tensor
cores, fp32 in and out), each counted under its own name.

The ``Function``'s backward mirrors ``_conv_fused_bwd`` (conv3x3.py:257):
dx is the same kernel on flip-transposed taps with the ReLU mask ``y > 0``
streamed onto ``dy``; when a skip needs its gradient, the kernel also emits
the masked ``dy``. dW and db are plain PyTorch and run only when
``ctx.needs_input_grad`` asks for them (the port's weights are frozen, so
the sampler never does).

Weights are OIHW ``[Co, Ci, 3, 3]`` (the port's storage layout); the
wrappers take HWIO ``[3, 3, Ci, Co]`` taps. The bf16 kernel reads HWIO; the
fp32 kernel reads them K-major, OHWI ``[Co, 3, 3, Ci]`` (``_k_major``:
``wgmma`` takes tf32 operands K-major only), made by the one copy per call
that HWIO took before (72·Ci·Co bytes read and written).
A CPU tensor takes the plain twin; a CUDA tensor launches the kernel of
its dtype or raises. ``LAUNCHES`` counts kernel launches (forward and dx
alike) per form.

The models call ``conv3x3_routed``, which routes by shape before any
launch: where ``fits`` holds (bf16 or fp32 operands, Ci and Co multiples of
8: the kernels' own rule) it runs ``conv3x3_fused``, elsewhere the same
function through ``layers.conv2d`` (``F.conv2d``), as the JAX package runs
XLA's conv where its kernel's layout rule fails (vae_kl.py:56-57,
vae_tiny.py:134-146). The JAX package's ``C % 128``, ``W % 8`` rule is a
TPU layout rule and is not carried over.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from depth_completion_tpu_torch import _build
from depth_completion_tpu_torch.models.layers import conv2d

# operand dtype → (C entry point, launch-count name)
_FORMS = {torch.bfloat16: ("dct_conv3x3", "conv3x3"),
          torch.float32: ("dct_conv3x3_f32", "conv3x3_fp32")}
LAUNCHES = {name: 0 for _, name in _FORMS.values()}

_p, _i = ctypes.c_void_p, ctypes.c_int
_lib = None


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("conv3x3")
        for entry, _ in _FORMS.values():
            getattr(lib, entry).argtypes = [_p] * 7 + [_i] * 6 + [_p]
            getattr(lib, entry).restype = _i
        _lib = lib
    return _lib


def fits(x_dtype: torch.dtype, ci: int, co: int) -> bool:
    """Whether a conv of ``x_dtype`` operands from ``ci`` to ``co`` channels
    has a kernel: bf16 or fp32, both channel counts multiples of 8."""
    return x_dtype in _FORMS and ci % 8 == 0 and co % 8 == 0


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def conv3x3_plain(x, w_hwio, bias=None, skip=None, relu=False, mask=None):
    """The kernel's function in plain PyTorch (fp32 math, output in x.dtype).

    Returns ``(y, masked_x)``; ``masked_x`` is ``x`` zeroed where
    ``mask <= 0`` (or ``x`` itself without a mask).
    """
    xm = x if mask is None else torch.where(mask.float() > 0, x, torch.zeros_like(x))
    w = w_hwio.to(x.dtype).float().permute(3, 2, 0, 1)  # → OIHW
    y = F.conv2d(xm.float().permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(x.dtype).float()
    if skip is not None:
        y = y + skip.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype), xm


def conv3x3_call(x, w_hwio, bias=None, skip=None, relu=False, mask=None, emit_masked=False):
    """One conv through the kernel of x's dtype (CUDA: bf16 or fp32) or its
    plain twin (CPU).

    x ``[N, H, W, Ci]``, w_hwio ``[3, 3, Ci, Co]``, bias ``[Co]``, skip
    ``[N, H, W, Co]``, mask like x. Returns y, or ``(y, masked_x)`` when
    ``emit_masked``.
    """
    if emit_masked and mask is None:
        raise ValueError("emit_masked needs a mask")
    if x.device.type == "cpu":
        y, xm = conv3x3_plain(x, w_hwio, bias, skip, relu, mask)
        return (y, xm) if emit_masked else y
    n, h, w, ci = x.shape
    co = w_hwio.shape[3]
    if x.dtype not in _FORMS:
        raise TypeError(f"conv3x3 kernels take bfloat16 or float32, got {x.dtype}")
    entry, form = _FORMS[x.dtype]
    if ci % 8 or co % 8:
        raise ValueError(f"conv3x3 kernel needs channel counts divisible by 8, got {ci}->{co}")
    if w_hwio.shape != (3, 3, ci, co):
        raise ValueError(f"conv3x3 weights must be [3,3,{ci},{co}], got {tuple(w_hwio.shape)}")
    x = x.contiguous()
    wk = (_k_major(w_hwio) if x.dtype == torch.float32 else w_hwio).to(x.dtype).contiguous()
    bias = None if bias is None else bias.to(x.dtype).contiguous()
    skip = None if skip is None else skip.to(x.dtype).contiguous()
    mask = None if mask is None else mask.to(x.dtype).contiguous()
    for t, name in ((skip, "skip"), (mask, "mask")):
        if t is not None and t.shape[:3] != x.shape[:3]:
            raise ValueError(f"conv3x3 {name} shape {tuple(t.shape)} does not match x")
    y = torch.empty((n, h, w, co), device=x.device, dtype=x.dtype)
    xm = torch.empty_like(x) if emit_masked else None
    status = getattr(_kernels(), entry)(
        x.data_ptr(), wk.data_ptr(), _ptr(bias), _ptr(skip), _ptr(mask),
        y.data_ptr(), _ptr(xm), n, h, w, ci, co, int(relu),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, form)
    LAUNCHES[form] += 1
    return (y, xm) if emit_masked else y


def _hwio(weight_oihw):
    return weight_oihw.permute(2, 3, 1, 0)


def _k_major(w_hwio):
    """HWIO taps → OHWI ``[Co, 3, 3, Ci]``: row co holds K = 9·Ci taps,
    K index (3·kh + kw)·Ci + ci (the fp32 kernel's weight layout)."""
    return w_hwio.permute(3, 0, 1, 2)


def _flip_transpose_hwio(weight_oihw):
    """Input-grad taps in HWIO: kf[dh, dw] = k[2-dh, 2-dw]ᵀ (Ci and Co swap)."""
    return weight_oihw.flip(2, 3).permute(2, 3, 0, 1)


class Conv3x3Fused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, skip, relu):
        y = conv3x3_call(x, _hwio(weight), bias, skip, relu)
        ctx.relu = relu
        ctx.has_bias = bias is not None
        ctx.has_skip = skip is not None
        ctx.save_for_backward(x, weight, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, y = ctx.saved_tensors
        need_x, need_w, need_b, need_skip, _ = ctx.needs_input_grad
        dy = dy.contiguous()
        kf = _flip_transpose_hwio(weight)
        need_masked = need_w or need_b or need_skip
        dx = dy_m = None
        if ctx.relu:
            if need_x:
                out = conv3x3_call(dy, kf, mask=y, emit_masked=need_masked)
                dx, dy_m = out if need_masked else (out, None)
            elif need_masked:
                dy_m = torch.where(y > 0, dy, torch.zeros_like(dy))
        else:
            dy_m = dy
            if need_x:
                dx = conv3x3_call(dy, kf)
        dw = db = None
        if need_w:
            # dW[co, ci, kh, kw] = Σ dy_m[n, h, w, co] · x_pad[n, h+kh-1, w+kw-1, ci]
            dw = torch.nn.grad.conv2d_weight(
                x.float().permute(0, 3, 1, 2), weight.shape,
                dy_m.float().permute(0, 3, 1, 2), padding=1,
            ).to(weight.dtype)
        if need_b and ctx.has_bias:
            db = dy_m.float().sum(dim=(0, 1, 2)).to(dy.dtype)
        dskip = dy_m if (need_skip and ctx.has_skip) else None
        return dx, dw, db, dskip, None


def conv3x3_fused(x, weight, bias=None, *, relu: bool = False, skip=None):
    """``maybe_relu(conv3x3_same(x, weight) + bias + skip)`` as one kernel.

    x ``[N, H, W, Ci]`` NHWC, weight OIHW ``[Co, Ci, 3, 3]``, bias ``[Co]``
    or None, skip ``[N, H, W, Co]`` or None. Differentiable in all four.
    """
    return Conv3x3Fused.apply(x, weight, bias, skip, relu)


def conv3x3_routed(x, weight, bias=None, *, relu: bool = False, skip=None):
    """``conv3x3_fused``'s function, routed by shape: the kernel where
    ``fits(x.dtype, Ci, Co)`` holds, else ``layers.conv2d`` with the bias,
    then the skip added, then the ReLU (autograd's backward)."""
    co, ci = weight.shape[:2]
    if fits(x.dtype, ci, co):
        return conv3x3_fused(x, weight, bias, relu=relu, skip=skip)
    y = conv2d({"kernel": weight, "bias": bias}, x)
    if skip is not None:
        y = y + skip
    return torch.relu(y) if relu else y
