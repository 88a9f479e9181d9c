"""Is an N=64 output product slower per FLOP than an N=128 one?

Counterpart of ``scripts/exp_pallas_n64.py``: each variant does two heads'
worth of flash-shaped products per pair, PAIRS=40 pairs, bq=512,
bk=1024, d=64, R=8 inner repeats averaged, bf16 in, fp32 sums, bf16 out:

  A  two products [bq,bk]x[bk,64]                       (N = 64)
  B  one [bq,2bk]x[2bk,128], v block-diagonal            (2x MACs, N = 128)
  C  0.5·(p_sum·vcat + p_diff·vneg), [bq,bk]x[bk,128]    (2x MACs, N = 128)
  D  two [64,bk]x[bk,bq]                                 (A's MACs, M = 64)
  E  two do^T·p, [bq,64]^T x [bq,bk]                     (A's MACs, M = 64)

All run through one kernel, ``csrc/probe_mma.cu`` (``products``): a
64-row strip per block, K staged in shared-memory chunks with the R
repeats run per chunk. Two heads become a batch of 2·PAIRS products (A, D,
E) or one product of twice the width (B, C). The verdict is the script's
(:245-262): the best of B-E wins if it takes less than 0.9 of A's time.

    python3 -m depth_completion_tpu_torch.probes.mma_n64
"""

from __future__ import annotations

import ctypes
import json

import torch

from depth_completion_tpu_torch import _build
from depth_completion_tpu_torch.probes import card, require_cuda, time_ms

PAIRS, BQ, BK, D, R = 40, 512, 1024, 64, 8
VARIANTS = ("A", "B", "C", "D", "E")

# kernel launches by the wrapper, read by chip_smoke.py
LAUNCHES = {"probe_mma_n64": 0}

_i, _l, _f, _p = ctypes.c_int, ctypes.c_long, ctypes.c_float, ctypes.c_void_p
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("probe_mma").dct_probe_products
        fn.argtypes = [_p] * 5 + [_i] * 4 + [_l] * 3 + [_i, _i, _f, _p]
        fn.restype = _i
        _fn = fn
    return _fn


def products_plain(a, b, a2=None, b2=None, *, repeats: int, scale: float, trans_a: bool = False):
    """bf16(scale · Σ over ``repeats`` of Σ_terms op(a)·b) in fp32, op(a) =
    aᵀ (the last two dims) with ``trans_a``. The repeats sum equal terms, so
    the sum is taken as ``repeats`` times one product."""
    def op(x):
        return x.float().transpose(-1, -2) if trans_a else x.float()

    acc = torch.matmul(op(a), b.float())
    if a2 is not None:
        acc = acc + torch.matmul(op(a2), b2.float())
    return (acc * (repeats * scale)).to(torch.bfloat16)


def launch(a, b, a2=None, b2=None, *, repeats: int, scale: float, trans_a: bool = False):
    """The products kernel on CUDA tensors [batch, ., .] (no launch count):
    a is [batch, M, K] ([batch, K, M] with ``trans_a``), b [batch, K, N];
    each matrix row-major, the batch stride any multiple of 8 (0 for an
    ``expand``ed operand); M, N and K multiples of 64. → [batch, M, N] bf16."""
    terms = [(a, b)] + ([(a2, b2)] if a2 is not None else [])
    for x in (t for pair in terms for t in pair):
        if x.dtype != torch.bfloat16 or x.dim() != 3:
            raise TypeError(f"products kernel takes 3-d bfloat16, got {x.dtype} {tuple(x.shape)}")
        if x.stride(2) != 1 or x.stride(1) != x.shape[2] or x.stride(0) % 8 or x.data_ptr() % 16:
            raise ValueError(f"products kernel takes row-major matrices, got strides {x.stride()}")
    for x, y in terms[1:]:
        if x.shape != a.shape or y.shape != b.shape or x.stride() != a.stride() or \
                y.stride() != b.stride():
            raise ValueError("the two terms must have the same shapes and strides")
    batch = a.shape[0]
    k, m = a.shape[1:] if trans_a else a.shape[2:0:-1]
    n = b.shape[2]
    if b.shape[:2] != (batch, k) or m % 64 or n % 64 or k % 64:
        raise ValueError(f"products kernel takes M, N, K multiples of 64 that agree, got "
                         f"a {tuple(a.shape)} b {tuple(b.shape)} trans_a={trans_a}")
    if trans_a and (a2 is not None or n % 128):
        raise NotImplementedError("trans_a is built for one term and N % 128 == 0")
    if a2 is not None and n % 128:
        raise NotImplementedError("two terms are built for N % 128 == 0")
    out = torch.empty((batch, m, n), device=a.device, dtype=torch.bfloat16)
    a2p, b2p = (a2.data_ptr(), b2.data_ptr()) if a2 is not None else (None, None)
    status = _kernel()(
        a.data_ptr(), b.data_ptr(), a2p, b2p, out.data_ptr(), batch, m, n, k,
        a.stride(0), b.stride(0), out.stride(0), int(trans_a), repeats, scale,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(status, "probe products")
    return out


def products(a, b, a2=None, b2=None, *, repeats: int, scale: float, trans_a: bool = False):
    """The variants' products: the kernel on CUDA, the plain twin on the CPU."""
    if a.device.type == "cpu":
        return products_plain(a, b, a2, b2, repeats=repeats, scale=scale, trans_a=trans_a)
    out = launch(a, b, a2, b2, repeats=repeats, scale=scale, trans_a=trans_a)
    LAUNCHES["probe_mma_n64"] += 1
    return out


def make_operands(p1, p2, v1, v2, do1, do2) -> dict:
    """Each variant's operands from the script's (:158-173, :185-186):
    p [P, bq, bk], v [P, bk, 64], do [P, bq, 64] per head. → variant →
    (a, b, a2, b2, trans_a, scale)."""
    zeros = torch.zeros_like(v1)
    vbd = torch.cat([torch.cat([v1, zeros], 2), torch.cat([zeros, v2], 2)], 1)
    p_sum = (p1.float() + p2.float()).to(torch.bfloat16)
    p_diff = (p1.float() - p2.float()).to(torch.bfloat16)

    def t(x):
        return x.transpose(1, 2).contiguous()

    return {
        "A": (torch.cat([p1, p2]), torch.cat([v1, v2]), None, None, False, 1.0),
        "B": (torch.cat([p1, p2], 2), vbd, None, None, False, 1.0),
        "C": (p_sum, torch.cat([v1, v2], 2), p_diff, torch.cat([v1, -v2], 2), False, 0.5),
        "D": (torch.cat([t(v1), t(v2)]), torch.cat([t(p1), t(p2)]), None, None, False, 1.0),
        "E": (torch.cat([do1, do2]), torch.cat([p1, p2]), None, None, True, 1.0),
    }


def run_variant(ops: dict, name: str, repeats: int = R):
    a, b, a2, b2, trans_a, scale = ops[name]
    return products(a, b, a2, b2, repeats=repeats, scale=scale / repeats, trans_a=trans_a)


def as_heads(name: str, out) -> torch.Tensor:
    """A variant's output as [2, P, ., .] fp32: p·v per head ([bq, 64]) for
    A-D, do^T·p per head ([64, bk]) for E."""
    out = out.float()
    if name in ("B", "C"):
        return torch.stack([out[..., :out.shape[-1] // 2], out[..., out.shape[-1] // 2:]])
    heads = out.unflatten(0, (2, -1))
    return heads.transpose(-1, -2) if name == "D" else heads


def reference(name: str, p1, p2, v1, v2, do1, do2) -> torch.Tensor:
    """The function a variant computes, per head, in fp32 ([2, P, ., .])."""
    if name == "E":
        return torch.stack([torch.matmul(do.float().transpose(1, 2), p.float())
                            for do, p in ((do1, p1), (do2, p2))])
    return torch.stack([torch.matmul(p.float(), v.float()) for p, v in ((p1, v1), (p2, v2))])


def flops(name: str, pairs: int = PAIRS, bq: int = BQ, bk: int = BK, repeats: int = R) -> float:
    """Tensor-core FLOP a variant executes (B and C twice A's)."""
    per_pair = 2 * 2.0 * bq * bk * D
    return repeats * pairs * per_pair * (2 if name in ("B", "C") else 1)


def inputs(device, pairs: int = PAIRS, bq: int = BQ, bk: int = BK, seed: int = 0):
    """p1, p2, v1, v2, do1, do2: standard normal bf16 (the script's)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    return (rnd(pairs, bq, bk), rnd(pairs, bq, bk), rnd(pairs, bk, D), rnd(pairs, bk, D),
            rnd(pairs, bq, D), rnd(pairs, bq, D))


def verdict(ms: dict) -> str:
    best = min((v for v in VARIANTS if v != "A"), key=ms.get)
    if ms[best] < 0.9 * ms["A"]:
        return f"{best} wins {ms['A'] / ms[best]:.2f}x"
    return "break-even/loss: no variant beats A by 10%"


def run(device="cuda", pairs: int = PAIRS, bq: int = BQ, bk: int = BK, repeats: int = R,
        reps: int = 30, seed: int = 0) -> dict:
    """Each variant timed through the kernel; its error against the function
    it computes, relative to that function's largest magnitude."""
    device = require_cuda(device)
    xs = inputs(device, pairs, bq, bk, seed)
    ops = make_operands(*xs)
    ms, rel_err, tflops = {}, {}, {}
    for name in VARIANTS:
        out = run_variant(ops, name, repeats)
        ms[name] = time_ms(lambda name=name: run_variant(ops, name, repeats), reps)
        ref = reference(name, *xs)
        rel_err[name] = float((as_heads(name, out) - ref).abs().max() / ref.abs().max())
        tflops[name] = flops(name, pairs, bq, bk, repeats) / ms[name] * 1e-9
    return {
        "probe": "mma_n64", "pairs": pairs, "bq": bq, "bk": bk, "d": D, "repeats": repeats,
        "ms": ms, "tflops_executed": tflops,
        "speedup_vs_A": {v: ms["A"] / ms[v] for v in VARIANTS[1:]},
        "rel_err": rel_err, "verdict": verdict(ms),
    }


def main() -> None:
    print(card())
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
