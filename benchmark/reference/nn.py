"""Layer primitives of the plain reference, and the numerics they run in.

Parameters are nested dicts with the layouts the benchmark makes them in
(``harness.weights``): conv kernels OIHW, linear kernels ``[out, in]``,
activations NHWC. Every product (conv, linear, attention matmul) goes
through a ``Numerics`` object, which decides the precision it runs in:

- ``Numerics()``: float32 everywhere. The reference itself; TF32 must be
  off (``harness.check`` turns it off before the reference runs).
- ``FP8Numerics()``: the control. Every operand of every product (weights
  and activations) is rounded to float8 e4m3 with a per-tensor scale, and
  every gradient that flows back into a product's input to float8 e5m2;
  the products themselves accumulate in float32. This is the precision
  below the configuration's bf16 that a later change could be tempted by.
- ``CallLog`` (a ``Numerics``): float32, and it writes down the shape of
  every tagged conv and attention call, so that the harness can count
  what the port's kernels have to do (``harness.flops``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _fake_quant(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a per-tensor scale, back in float32."""
    x = x.float()
    scale = torch.clamp(x.abs().amax() / top, min=1e-30)
    return (x / scale).to(dtype).float() * scale


class _Quant(torch.autograd.Function):
    """e4m3 forward, e5m2 gradient."""

    @staticmethod
    def forward(ctx, x):
        return _fake_quant(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _fake_quant(g, torch.float8_e5m2, E5M2_MAX)


class Numerics:
    """float32 products (the reference)."""

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as a product reads it."""
        return x.float()

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A parameter as a product reads it."""
        return w.float()

    def record(self, kind: str, **shape) -> None:
        """A tagged call's shape (only ``CallLog`` keeps them)."""

    # -- products ---------------------------------------------------------

    def conv(self, p, x, stride=1, padding=1, tag=None, relu=False, skip=None):
        """Conv over NHWC ``x`` (OIHW kernel), then the skip and the ReLU.
        ``padding``: int, or ((top, bottom), (left, right))."""
        w = self.weight(p["kernel"])
        b = p.get("bias")
        if tag is not None:
            self.record(tag, n=x.shape[0], h=x.shape[1], w=x.shape[2], ci=w.shape[1],
                        co=w.shape[0], k=w.shape[2], stride=stride, relu=relu,
                        skip=skip is not None, bias=b is not None)
        xc = self.operand(x).permute(0, 3, 1, 2)
        if not isinstance(padding, int):
            (top, bottom), (left, right) = padding
            xc, padding = F.pad(xc, (left, right, top, bottom)), 0
        y = F.conv2d(xc, w, None if b is None else b.float(), stride=stride,
                     padding=padding).permute(0, 2, 3, 1)
        if skip is not None:
            y = y + skip
        return torch.relu(y) if relu else y

    def linear(self, p, x):
        b = p.get("bias")
        return F.linear(self.operand(x), self.weight(p["kernel"]),
                        None if b is None else b.float())

    def attention(self, q, k, v, num_heads: int, tag=None):
        """Multi-head softmax attention over [N, S, C] (no mask)."""
        n, sq, c = q.shape
        sk = k.shape[1]
        hd = c // num_heads
        if tag is not None:
            self.record(tag, n=n, s=sq, sk=sk, heads=num_heads, d=hd)
        qh = q.reshape(n, sq, num_heads, hd).transpose(1, 2)
        kh = k.reshape(n, sk, num_heads, hd).transpose(1, 2)
        vh = v.reshape(n, sk, num_heads, hd).transpose(1, 2)
        logits = torch.matmul(self.operand(qh), self.operand(kh).transpose(-1, -2))
        probs = torch.softmax(logits / math.sqrt(hd), dim=-1)
        out = torch.matmul(self.operand(probs), self.operand(vh))
        return out.transpose(1, 2).reshape(n, sq, c)


class FP8Numerics(Numerics):
    """The control: every product's operands in float8 (see the module
    docstring)."""

    def __init__(self):
        self._weights: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    def operand(self, x):
        return _Quant.apply(x.float())

    def weight(self, w):
        held = self._weights.get(id(w))
        if held is None or held[0] is not w:
            held = self._weights[id(w)] = (w, _fake_quant(w, torch.float8_e4m3fn, E4M3_MAX))
        return held[1]


class CallLog(Numerics):
    """float32, with every tagged call's shape in ``calls``."""

    def __init__(self):
        self.calls: list[dict] = []

    def record(self, kind, **shape):
        self.calls.append({"kind": kind, **shape})


# -- parameter-free layers (float32) ----------------------------------------

def group_norm(p, x, groups: int, eps: float):
    n, c = x.shape[0], x.shape[-1]
    g = min(groups, c)
    xf = x.float().reshape(n, -1, g, c // g)
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
    out = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return out * p["scale"].float() + p["bias"].float()


def layer_norm(p, x, eps: float):
    return F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(), p["bias"].float(), eps)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, [cos, sin] (flip_sin_to_cos, no shift)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(exponent / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def upsample_nearest_2x(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def resize_nearest(x, size):
    """NHWC nearest resize with half-pixel centres."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=size, mode="nearest-exact")
    return y.permute(0, 2, 3, 1)
