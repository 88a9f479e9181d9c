"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--steps N]

1. prints the card (nvidia-smi name and power limit), torch and CUDA
   versions, and builds every CUDA kernel of the package from ``csrc/``;
2. holds each kernel against its plain PyTorch version on the card at the
   paths' shapes (max error against a stated tolerance), and times kernel,
   plain version and the nearest single PyTorch library call (for the
   guidance epilogue, the eager chain it replaces);
3. drives both guided paths through ``DepthCompletionPipeline`` at full
   Marigold width (random bf16 weights from a seed): the TAESD decoder
   (``--vae light``, the default) and the KL VAE at SD widths
   (``--vae original``). Each path runs two 480x640 requests with 500 sparse
   points at processing resolution 768, the second carrying the first's
   latents; checks finite metric outputs and that every kernel was launched
   the number of times the path implies (counts set to 0 just before the
   path, read just after); holds the KL encode against the same encode
   through the plain versions and in fp32; and holds one guided step's
   losses and gradients, for a few noise seeds, against the same step run
   through the plain versions (and the latent gradient against an fp32 run);
4. prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

A tolerance check that fails is reported and the run goes on, so one run
prints every reading; the script then exits non-zero without the result
lines. Any other failure raises at once. Exits non-zero at once when CUDA
is not available. float32 matmuls and convolutions run without
TF32 (both flags set False) so the plain versions are true fp32 references.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import subprocess
import sys
import time


def _require_cuda():
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: CUDA is not available; this smoke needs a GPU\n")
        sys.exit(2)
    return torch


torch = _require_cuda()
import torch.nn.functional as F  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402

from depth_completion_tpu_torch import _build  # noqa: E402
from depth_completion_tpu_torch.guidance.optim import make_optimizer  # noqa: E402
from depth_completion_tpu_torch.models import registry  # noqa: E402
from depth_completion_tpu_torch.models.bundle import make_random_bundle  # noqa: E402
from depth_completion_tpu_torch.models.layers import attention as plain_attention  # noqa: E402
from depth_completion_tpu_torch.ops import conv3x3 as c3  # noqa: E402
from depth_completion_tpu_torch.ops import flash_attention as fa  # noqa: E402
from depth_completion_tpu_torch.ops import guidance_epilogue as ge  # noqa: E402
from depth_completion_tpu_torch.pipeline import sampler as S  # noqa: E402
from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline  # noqa: E402

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SFU_PER_SM_CLK = 16  # MUFU ex2 results per SM per clock (4 per SM sub-partition)
DEV = torch.device("cuda")
FAILURES: list[str] = []  # tolerance checks that failed, reported at the end
LAUNCH_COUNTS = (fa.LAUNCHES, c3.LAUNCHES, ge.LAUNCHES)


def exp_bound_ms(n_exp: float) -> float:
    """Least time for ``n_exp`` exp2 on the special-function units at the
    card's maximum SM clock (a bound the table's bf16 peak does not see)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n_exp / (sms * SFU_PER_SM_CLK * mhz * 1e6) * 1e3


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, err: float, tol: float, what: str = "max_abs_err") -> None:
    ok = err <= tol
    print(f"  {name}: {what}={err:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(f"{name}: {what} {err:.3e} > {tol:.3e}")


def check_elementwise(name: str, got, ref, rel: float, floor: float) -> float:
    """Holds |got - ref| <= rel·|ref| + floor·max|ref| at every element;
    returns the max abs error."""
    err = (got.float() - ref.float()).abs()
    mag = ref.float().abs()
    excess = float((err - rel * mag).max())
    print(f"  {name}: max_abs_err={float(err.max()):.3e} (max|ref| {float(mag.max()):.3e})")
    check(name, excess, floor * float(mag.max()), f"max(|err| - {rel:.3g}|ref|)")
    return float(err.max())


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def sdpa_backend(q, k, v) -> SDPBackend:
    """The first of PyTorch's fused SDPA backends, in its own order of
    preference, that takes these operands (the flash backend stops at head
    dim 256)."""
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q, k, v)
            return backend
        except RuntimeError:
            continue
    raise RuntimeError("no SDPA backend takes these operands")


def check_flash(sq: int, sk: int | None = None, heads: int = 5, timed: bool = True,
                reps: int = 10, d: int = 64) -> dict:
    sk = sq if sk is None else sk
    fwd_name, bwd_name = ("flash_fwd", "flash_bwd") if d == 64 else (
        f"flash_fwd_d{d}", f"flash_bwd_d{d}")
    gen = torch.Generator(device=DEV).manual_seed(sq * 7919 + sk + d)
    c = heads * d

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=DEV).to(torch.bfloat16)

    q, do, k, v = rnd(1, sq, c), rnd(1, sq, c), rnd(1, sk, c), rnd(1, sk, c)
    print(f"flash attention N=1 heads={heads} Sq={sq} Sk={sk} d={d} bf16")
    o, lse2 = fa.flash_fwd(q, k, v, heads)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, heads)
    torch.cuda.synchronize()
    # o: both round an fp32 result to bf16 (one ulp, <= 2^-7·|o|). Before
    # rounding they differ by p rounded to bf16 against a running max here
    # and the final max there: rms ~2^-9·sqrt(e/Sk)·rms(v), whose tail over
    # millions of outputs reaches ~2^-10·max|o|. The 2^-8·max|o| floor holds
    # the sound kernel at <= 0.35 of it and fails a row sum off by 1% at
    # >= 1.24 of it (scripts/chip_smoke_faults.sh; PERF.md, Findings).
    err_o = check_elementwise(f"{fwd_name} o", o, o_ref, 2**-7, 2**-8)
    # o as a whole: the sound kernel reads 2.3e-3-2.4e-3 relative (both
    # sides round o, and p, to bf16); a row sum off by 1%, which the
    # elementwise bound only just sees, reads 1.03e-2 (PERF.md, Findings)
    check(f"{fwd_name} o rel-norm",
          float((o.float() - o_ref.float()).norm() / o_ref.float().norm()), 2**-8,
          "|o-o_ref|/|o_ref|")
    # lse2 (|lse2| ~ 13, fp32 ulp 1e-6): 1e-4 is ~100 ulps; a row sum off
    # by 0.01% moves it 1.4e-4
    check(f"{fwd_name} lse2", max_err(lse2, lse_ref), 1e-4)
    dq, dk, dv = fa.flash_bwd(q, k, v, o, do, lse2, heads)
    rq, rk, rv = fa.flash_bwd_plain(q, k, v, o, do, lse2, heads)
    torch.cuda.synchronize()
    # bf16 p and ds feed the kernel's products (fp32 in the plain version):
    # 2% of the largest reference magnitude
    errs = {}
    for nm, got, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        errs[nm] = max_err(got, ref)
        check(f"{bwd_name} {nm}", errs[nm], 2e-2 * float(ref.float().abs().max()))
    fwd, bwd = {"max_abs_err": err_o}, {"max_abs_err": max(errs.values())}
    if not timed:
        return {fwd_name: fwd, bwd_name: bwd}

    qh, kh, vh = (t.view(1, -1, heads, d).transpose(1, 2) for t in (q, k, v))
    backend = sdpa_backend(qh, kh, vh)
    fwd["ms"] = time_ms(lambda: fa.flash_fwd(q, k, v, heads), reps)
    fwd["plain_ms"] = time_ms(lambda: fa.flash_fwd_plain(q, k, v, heads), 3, 1)
    bwd["ms"] = time_ms(lambda: fa.flash_bwd(q, k, v, o, do, lse2, heads), reps)
    bwd["plain_ms"] = time_ms(lambda: fa.flash_bwd_plain(q, k, v, o, do, lse2, heads), 3, 1)
    with sdpa_kernel([backend]):
        fwd["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), reps)
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (qh, kh, vh))
        ol = F.scaled_dot_product_attention(ql, kl, vl)
    doh = do.view(1, sq, heads, d).transpose(1, 2)
    bwd["library_ms"] = time_ms(
        lambda: torch.autograd.grad(ol, (ql, kl, vl), doh, retain_graph=True), reps
    )
    q_bytes, kv_bytes, stat_bytes = 2 * sq * c, 2 * sk * c, 4 * sq * heads
    fwd["bound_ms"], fwd["bound_by"] = bound(
        4.0 * sq * sk * d * heads, 2 * q_bytes + 2 * kv_bytes + stat_bytes)
    bwd["bound_ms"], bwd["bound_by"] = bound(
        10.0 * sq * sk * d * heads, 4 * q_bytes + 4 * kv_bytes + stat_bytes)
    exp_ms = exp_bound_ms(float(sq) * sk * heads)  # one exp2 per score, fwd and bwd alike
    for nm, r in ((fwd_name, fwd), (bwd_name, bwd)):
        print(f"  {nm} Sq={sq} Sk={sk} heads={heads} d={d}: kernel_ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
              f"(SDPA {backend.name}) bound_ms={r['bound_ms']:.4f} ({r['bound_by']}); "
              f"exp2 on the SFUs alone {exp_ms:.4f} ms")
    return {fwd_name: fwd, bwd_name: bwd}


def check_conv(n: int, h: int, w: int, cin: int = 64, cout: int | None = None,
               relu: bool = True, timed: bool = True, reps: int = 10) -> dict:
    """The conv kernel as a path runs it: TAESD (``relu``: bias+ReLU,
    bias+skip+ReLU, dx with the ReLU mask) or the KL VAE's ResNets (bias,
    bias+skip, dx without a mask)."""
    cout = cin if cout is None else cout
    gen = torch.Generator(device=DEV).manual_seed(h * w + cin + cout)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEV) * scale).to(torch.bfloat16)

    x, skip, dy = rnd(n, h, w, cin), rnd(n, h, w, cout), rnd(n, h, w, cout)
    wgt = rnd(cout, cin, 3, 3, scale=1.0 / math.sqrt(9 * cin))
    b = rnd(cout, scale=0.1)
    w_hwio = c3._hwio(wgt).contiguous()
    kf = c3._flip_transpose_hwio(wgt).contiguous()
    act = "+relu" if relu else ""
    print(f"conv3x3 N={n} H={h} W={w} C={cin}->{cout} bf16 ({'TAESD' if relu else 'KL'} form)")
    # bf16 outputs of fp32 sums taken in another order: 2 bf16 ulps of the
    # largest output
    errs = {}
    y = c3.conv3x3_call(x, w_hwio, b, relu=relu)
    y_ref, _ = c3.conv3x3_plain(x, w_hwio, b, relu=relu)
    errs["bias"] = max_err(y, y_ref)
    check(f"conv bias{act}", errs["bias"], 1.6e-2 * float(y_ref.float().abs().max()))
    ys = c3.conv3x3_call(x, w_hwio, b, skip=skip, relu=relu)
    ys_ref, _ = c3.conv3x3_plain(x, w_hwio, b, skip=skip, relu=relu)
    errs["skip"] = max_err(ys, ys_ref)
    check(f"conv bias+skip{act}", errs["skip"], 1.6e-2 * float(ys_ref.float().abs().max()))
    if relu:
        def run_dx():
            return c3.conv3x3_call(dy, kf, mask=y, emit_masked=True)

        dx, dym = run_dx()
        dx_ref, dym_ref = c3.conv3x3_plain(dy, kf, mask=y)
        check("conv emitted masked operand (exact)", max_err(dym, dym_ref), 0.0)
    else:
        def run_dx():
            return c3.conv3x3_call(dy, kf)

        dx = run_dx()
        dx_ref, _ = c3.conv3x3_plain(dy, kf)
    errs["dx"] = max_err(dx, dx_ref)
    check(f"conv {'masked ' if relu else ''}dx", errs["dx"],
          1.6e-2 * float(dx_ref.float().abs().max()))

    out = {"max_abs_err": max(errs.values())}
    if not timed:
        return out
    xc = x.permute(0, 3, 1, 2)  # channels-last view for cuDNN
    out["ms"] = time_ms(lambda: c3.conv3x3_call(x, w_hwio, b, relu=relu), reps)
    out["plain_ms"] = time_ms(lambda: c3.conv3x3_plain(x, w_hwio, b, relu=relu), 3, 1)
    out["library_ms"] = time_ms(lambda: F.conv2d(xc, wgt, b, padding=1), reps)
    out["dx_ms"] = time_ms(run_dx, reps)
    flops = 2.0 * n * h * w * cin * cout * 9
    x_bytes, y_bytes, w_bytes = 2 * n * h * w * cin, 2 * n * h * w * cout, 2 * 9 * cin * cout
    out["bound_ms"], out["bound_by"] = bound(flops, x_bytes + y_bytes + w_bytes + 2 * cout)
    # dx reads dy (and, with ReLU, the mask y) and writes dx (and dy masked)
    dx_bytes = x_bytes + y_bytes + w_bytes + (2 * y_bytes if relu else 0)
    out["dx_bound_ms"], _ = bound(flops, dx_bytes)
    print(f"  conv3x3 {h}x{w} {cin}->{cout}: kernel_ms={out['ms']:.4f} "
          f"({'masked ' if relu else ''}dx {out['dx_ms']:.4f}, bound {out['dx_bound_ms']:.4f}) "
          f"plain_ms={out['plain_ms']:.4f} library_ms={out['library_ms']:.4f} "
          f"bound_ms={out['bound_ms']:.4f} ({out['bound_by']})")
    return out


def check_autograd() -> None:
    """Each ``autograd.Function`` (forward and backward through the kernels)
    against autograd through the plain path, at the paths' shapes: catches
    wiring faults (gradients swapped, dropped or misplaced) that the
    kernel-level checks above cannot see. Tolerances as for the kernels:
    2% of the largest reference magnitude (bf16 p, ds and products). With
    ReLU, the plain path masks with the kernel output's sign: where the
    pre-activation lies within a rounding of 0 the two forwards can disagree
    on it, and the gradients then differ by the whole |dy| there."""
    gen = torch.Generator(device=DEV).manual_seed(77)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEV) * scale).to(torch.bfloat16)

    cases = []  # (name, kernel fn, plain fn of (kernel output, *inputs), inputs, dy)
    for s, heads, d in ((6912, 5, 64), (6912, 1, 512)):
        cases.append((f"flash d={d} S={s} heads={heads}",
                      functools.partial(fa.flash_attention, num_heads=heads),
                      lambda y, q, k, v, heads=heads: plain_attention(q, k, v, heads),
                      [rnd(1, s, heads * d) for _ in range(3)], rnd(1, s, heads * d)))
    for (h, w, c), relu in (((576, 768, 64), True), ((72, 96, 512), False)):
        wgt, b = rnd(c, c, 3, 3, scale=1.0 / math.sqrt(9 * c)), rnd(c, scale=0.1)

        def plain(y, x, skip, wgt=wgt, b=b, relu=relu):
            z = _plain_conv3x3_fused(x, wgt, b, skip=skip)
            return torch.where(y > 0, z, torch.zeros_like(z)) if relu else z

        cases.append((f"conv {h}x{w}x{c} {'bias+skip+relu' if relu else 'bias+skip'}",
                      lambda x, skip, wgt=wgt, b=b, relu=relu: c3.conv3x3_fused(
                          x, wgt, b, relu=relu, skip=skip),
                      plain, [rnd(1, h, w, c), rnd(1, h, w, c)], rnd(1, h, w, c)))
    for name, fn, plain_fn, xs, dy in cases:
        print(f"autograd {name} bf16")
        leaves = [x.detach().clone().requires_grad_(True) for x in xs]
        y = fn(*leaves)
        grads = torch.autograd.grad(y, leaves, dy, allow_unused=True)
        leaves = [x.detach().clone().requires_grad_(True) for x in xs]
        y_ref = plain_fn(y.detach(), *leaves)
        grads_ref = torch.autograd.grad(y_ref, leaves, dy)
        check(f"autograd {name} output", max_err(y, y_ref),
              2e-2 * float(y_ref.float().abs().max()))
        for i, (g, g_ref) in enumerate(zip(grads, grads_ref)):
            g = torch.zeros_like(g_ref) if g is None else g  # a gradient left out reads as 0
            check(f"autograd {name} grad of input {i}", max_err(g, g_ref),
                  2e-2 * float(g_ref.float().abs().max()))


def _eager_chain(sched, lat, m, v, count: int, lr: float):
    """The sampler's eager epilogue (``sampler.eager_epilogue``) on a copy of
    ``lat`` whose Adam state is (m, v) after ``count`` steps: → (the latent
    it updates, a function doing one step on given (g, out, t))."""
    p = lat.clone().requires_grad_(True)
    opt = make_optimizer("adam", p, [], lr)
    opt.state[p] = {"step": torch.tensor(float(count)), "exp_avg": m.clone(),
                    "exp_avg_sq": v.clone()}

    @torch.no_grad()
    def step(g, out, t):
        S.eager_epilogue(sched, opt, p, g, out, t, 50)

    return p, opt, step


def check_epilogue(n: int, v_pred: bool, timed: bool = True, reps: int = 100) -> dict:
    """The fused epilogue at the latent shape of res 768, against its plain
    twin and against the eager chain it replaces, from Adam state after
    three steps (bias corrections and the moments all in play)."""
    ptype = "v_prediction" if v_pred else "epsilon"
    sched = S.make_schedule(S.DDIMConfig(prediction_type=ptype))
    steps, count, lr = 50, 3, 0.05
    t = int(S.make_timesteps(sched.config, steps)[count])
    sc = ge.epilogue_scalars(sched, t, steps, count)
    gen = torch.Generator(device=DEV).manual_seed(4242 + n + 10 * int(v_pred))
    shape = (n, 72, 96, 4)

    def rnd(scale=1.0):
        return torch.randn(shape, generator=gen, device=DEV) * scale

    # a raw latent gradient is small; the rescale brings it to ‖ε̂‖
    lat, g, out = rnd(), rnd(1e-3), rnd().to(torch.bfloat16)
    m = rnd(0.3)
    v = m * m + 0.1 * torch.rand(shape, generator=gen, device=DEV)
    print(f"guidance epilogue N={n} {tuple(shape[1:])} {ptype} t={t} count={count}")
    got = [x.clone() for x in (lat, m, v)]
    ge.guidance_epilogue(got[0], g, out, got[1], got[2], sc, lr=lr, v_pred=v_pred)
    ref = ge.guidance_epilogue_plain(lat, g, out, m, v, sc, lr=lr, v_pred=v_pred)
    p, opt, chain = _eager_chain(sched, lat, m, v, count, lr)
    chain(g, out, t)
    st = opt.state[p]
    torch.cuda.synchronize()
    # fp32 throughout; the norms are sums of 27,648 squares per sample in
    # another order, and the DDIM combine rounds in another order (FMA):
    # 1e-5 of the largest value is ~100 fp32 ulps
    errs = []
    for nm, a, b in zip(("lat", "m", "v"), got, ref):
        errs.append(max_err(a, b))
        check(f"guidance_epilogue {nm} vs twin", errs[-1], 1e-5 * float(b.abs().max()))
    for nm, a, b in zip(("lat", "m", "v"), got, (p, st["exp_avg"], st["exp_avg_sq"])):
        check(f"guidance_epilogue {nm} vs eager chain", max_err(a, b),
              1e-5 * float(b.detach().abs().max()))
    res = {"max_abs_err": max(errs)}
    if not timed:
        return res
    res["ms"] = time_ms(lambda: ge.guidance_epilogue(
        got[0], g, out, got[1], got[2], sc, lr=lr, v_pred=v_pred), reps, 10)
    res["plain_ms"] = time_ms(lambda: ge.guidance_epilogue_plain(
        lat, g, out, m, v, sc, lr=lr, v_pred=v_pred), reps, 10)
    res["library_ms"] = time_ms(lambda: chain(g, out, t), reps, 10)
    k = g.numel()
    # reads lat, g, m, v (fp32) and out (bf16); writes lat, m, v; ~26 fp32
    # operations an element (two squares, ε̂, Adam, DDIM)
    res["bound_ms"], res["bound_by"] = bound(26.0 * k, k * (4 * 4 + 2 + 3 * 4), PEAK_FP32_FLOPS)
    print(f"  guidance_epilogue N={n}: kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
          f"library_ms={res['library_ms']:.4f} (the eager chain) "
          f"bound_ms={res['bound_ms']:.5f} ({res['bound_by']})")
    return res


# ---------------------------------------------------------------------------
# Phase 3: the guided paths
# ---------------------------------------------------------------------------

def expected_launches(unet_cfg, vae_kind: str, vae_cfg, latent_hw, steps: int) -> dict:
    """Kernel launches one guided request implies (JAX package routing:
    self-attention with S >= 768 and head dim 64 or 512 takes a flash
    kernel; every stride-1 3x3 conv of a decoder, and of the KL encoder,
    takes the conv kernel)."""
    eh, ew = latent_hw
    flash_per_unet = 0
    for i, has_attn in enumerate(unet_cfg.attention_stages):
        h, w = eh, ew
        for _ in range(i):
            h, w = (h + 1) // 2, (w + 1) // 2
        d = unet_cfg.block_out_channels[i] // unet_cfg.num_heads[i]
        if has_attn and h * w >= 768 and d == 64:
            flash_per_unet += 2 * unet_cfg.layers_per_block + 1
    if vae_kind == "tiny":
        convs_per_decode = 3 * sum(vae_cfg.decoder_blocks) + len(vae_cfg.decoder_blocks) - 1
        convs_per_encode = mid_attn = 0  # TAESD: plain encoder convs, no attention
    else:
        stages, layers = len(vae_cfg.block_out_channels), vae_cfg.layers_per_block
        convs_per_decode = 4 + 2 * stages * (layers + 1)  # mid: 2 ResNets; 2 convs each
        convs_per_encode = 4 + 2 * stages * layers
        mid_attn = int(eh * ew >= 768)  # one head at d = the widest stage
    return {
        "flash_fwd": flash_per_unet * steps,
        "flash_bwd": flash_per_unet * steps,
        # one encode, a decode per step, the final decode
        "flash_fwd_d512": mid_attn * (steps + 2),
        "flash_bwd_d512": mid_attn * steps,
        # per step: forward and dx of every decoder conv; the encode; the final decode
        "conv3x3": 2 * convs_per_decode * steps + convs_per_encode + convs_per_decode,
        "guidance_epilogue": steps,
    }


def reset_launches():
    for d in LAUNCH_COUNTS:
        for key in d:
            d[key] = 0


def launches() -> dict:
    return {k: v for d in LAUNCH_COUNTS for k, v in d.items()}


def _plain_conv3x3_fused(x, weight, bias=None, *, relu=False, skip=None):
    """``ops.conv3x3.conv3x3_fused`` through its plain twin (autograd-traced)."""
    return c3.conv3x3_plain(x, c3._hwio(weight), bias, skip, relu)[0]


# Limits of the reference step, from readings over the seeds below on the
# sound tree and under the planted faults of scripts/chip_smoke_faults.sh
# (PERF.md, Findings): (loss rel, affine-grad rel, latent-grad cosine gap).
# TAESD: loss rel <= 2.3e-6 and affine rel <= 1.5e-3 on the sound tree, and
# no planted fault moves either past its noise; the cosine gap reads
# <= 2.6e-3 on the sound tree and 0.030-0.032 with the conv's dx mask left
# off its halo rows. KL: 28 bf16 convs deep, the bf16 step moves the loss
# up to 8e-4 from the fp32 run with the kernels and the plain versions
# alike (the "loss rel to fp32" readings); sound readings reach loss rel
# 3.7e-4, affine rel 3.6e-2 and a cosine gap of 5.4e-3. With the KL
# ResNets' residual dropped in the conv Function (F9) the least reading
# over the seeds is loss rel 1.3e-3, affine rel 0.17 and a cosine gap of
# 0.94; with only its gradient dropped (F10), a cosine gap of 0.99.
REF_SEEDS = (2024, 0, 1)
REF_LIMITS = {"tiny": (2e-5, 1e-2, 1e-2), "kl": (1e-3, 0.1, 2e-2)}
# KL encode: kernel-to-fp32 distance over plain-bf16-to-fp32. Sound 1.004;
# the d=512 row sum off by 1% (F5) 1.011; the residual dropped (F9) 64.
ENCODE_LIMIT = 2.0


def fp32_bundle(bundle):
    """The bundle with every weight, and the text context, in fp32."""
    def as_fp32(tree):
        if isinstance(tree, dict):
            return {k: as_fp32(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [as_fp32(v) for v in tree]
        return tree.float()

    return dataclasses.replace(
        bundle, unet_params=as_fp32(bundle.unet_params),
        vae=dataclasses.replace(bundle.vae, params=as_fp32(bundle.vae.params)),
        text_context=bundle.text_context.float(),
    )


def encode_check(bundle, bundle32, images) -> None:
    """The KL encode of the path's frame at processing resolution (576x768)
    three ways: through the kernels (bf16: 20 stride-1 convs, the d=512
    flash forward), through the plain versions (bf16), and through the
    plain versions on the fp32 bundle. The kernel latent's relative
    distance to the fp32 latent may be at most ``ENCODE_LIMIT`` times the
    plain bf16 latent's: both round through the same bf16 layers, in
    another order."""
    cfg = S.SamplerConfig()
    imgs, _, _ = S.preprocess_images(images, cfg.resolution, cfg.interp_mode)
    with torch.no_grad():
        lk = bundle.vae.encode(imgs.to(bundle.dtype))
        lp = bundle.vae.encode(imgs.to(bundle.dtype), _plain_conv3x3_fused, plain_attention)
        l32 = bundle32.vae.encode(imgs.float(), _plain_conv3x3_fused, plain_attention)

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    rk, rp = rel(lk, l32), rel(lp, l32)
    print(f"  KL encode {tuple(imgs.shape[1:3])} -> {tuple(lk.shape[1:3])}: |kernel-fp32|/|fp32| "
          f"{rk:.3e}, |plain-fp32|/|fp32| {rp:.3e}, |kernel-plain|/|plain| {rel(lk, lp):.3e}")
    check("KL encode latent", rk / rp, ENCODE_LIMIT, "rel(kernel,fp32)/rel(plain,fp32)")


def reference_step_check(bundle, bundle32, images, sparses) -> None:
    """One guided step (t = the first timestep) on the path's inputs, for
    each of ``REF_SEEDS`` (the initial noise), three ways: through the
    kernels (bf16), through the plain versions (bf16), and through the
    plain versions on an fp32 copy of the bundle. The image latents come
    from one encode through the kernels, shared by the three (the KL
    encode is held on its own by ``encode_check``).

    Per-sample losses and the affine gradients (scalars) of the two bf16
    runs must agree to the path's loss and affine limits, relative. The
    latent gradient at random weights cancels heavily
    (tests/test_pipeline_parity.py tolerance model), so it is held against
    the fp32 run: the kernel run's cosine to it may fall short of the plain
    bf16 run's by at most the path's cosine-gap limit.
    """
    cfg = S.SamplerConfig(steps=50, norm="const", closed_form=False)
    sched = S.make_schedule(cfg.ddim)
    t = int(S.make_timesteps(cfg.ddim, cfg.steps)[0])
    loss_lim, aff_lim, cos_lim = REF_LIMITS[bundle.vae.kind]
    modes = {
        "kernel": (bundle, fa.flash_attention, c3.conv3x3_fused),
        "plain": (bundle, plain_attention, _plain_conv3x3_fused),
        "fp32": (bundle32, plain_attention, _plain_conv3x3_fused),
    }

    def cos(a, b):
        return float(F.cosine_similarity(a.flatten().float(), b.flatten().float(), dim=0))

    for seed in REF_SEEDS:
        gen = torch.Generator(device=DEV).manual_seed(seed)
        img_lat, lat0, dn, padding, orig_res = S._prepare(bundle, images, sparses, cfg, None, gen)
        results = {}
        for mode, (bnd, attention_fn, conv_fn) in modes.items():
            lat = lat0.clone().requires_grad_(True)
            aff = [torch.ones((1, 1, 1, 1), device=DEV).requires_grad_(True),
                   torch.zeros((1, 1, 1, 1), device=DEV).requires_grad_(True)]
            losses, _, grads = S.guided_step_grads(
                S._Denoiser(bnd, img_lat.to(bnd.dtype), attention_fn),
                functools.partial(S.decode_prediction, bnd, conv_fn=conv_fn,
                                  attention_fn=attention_fn),
                sched, cfg, dn, images, orig_res, padding, False, lat, aff, t)
            results[mode] = (losses, grads)
        (lk, gk), (lp, gp), (l32, g32) = results["kernel"], results["plain"], results["fp32"]
        rel_loss = float(((lk - lp).abs() / lp.abs()).max())
        rel32 = [float(((x - l32).abs() / l32.abs()).max()) for x in (lk, lp)]
        rel_aff = max(float(((a - b).abs() / b.abs().clamp(min=1e-12)).max())
                      for a, b in zip(gk[1:], gp[1:]))
        cos_kp, cos_k32, cos_p32 = cos(gk[0], gp[0]), cos(gk[0], g32[0]), cos(gp[0], g32[0])
        print(f"  reference step seed={seed} t={t}: loss {lk.tolist()} vs plain {lp.tolist()}; "
              f"latent-grad cosine kernel-plain {cos_kp:.5f}, kernel-fp32 {cos_k32:.5f}, "
              f"plain-fp32 {cos_p32:.5f}; loss rel to fp32: kernel {rel32[0]:.2e}, "
              f"plain {rel32[1]:.2e}")
        check(f"reference step seed={seed} loss", rel_loss, loss_lim, "rel_err")
        check(f"reference step seed={seed} affine grads", rel_aff, aff_lim, "rel_err")
        check(f"reference step seed={seed} latent grad", cos_p32 - cos_k32, cos_lim,
              "cos(plain,fp32)-cos(kernel,fp32)")


PATHS = (  # (label, VAE kind, VAE config)
    ("TAESD_CONFIG (--vae light)", "tiny", registry.TAESD_CONFIG),
    ("SD_VAE_CONFIG (--vae original)", "kl", registry.SD_VAE_CONFIG),
)


def guided_path(label: str, vae_kind: str, vae_config, steps: int) -> dict:
    """Two guided requests through the pipeline, launch counts checked per
    request; then the reference step. → the path's launch counts."""
    print(f"guided path: MARIGOLD_UNET_CONFIG + {label} bf16, 2 requests x {steps} "
          "guided steps, 480x640 frame, 500 sparse points, res 768, norm=const, learned affine")
    t0 = time.perf_counter()
    bundle = make_random_bundle(
        seed=0, unet_config=registry.MARIGOLD_UNET_CONFIG, vae_config=vae_config,
        dtype=torch.bfloat16, device=DEV, vae_kind=vae_kind,
    )
    torch.cuda.synchronize()
    print(f"  bundle built in {time.perf_counter() - t0:.1f} s")
    pipe = DepthCompletionPipeline(bundle)
    rng = torch.Generator(device="cpu").manual_seed(0)
    h, w = 480, 640
    images = torch.rand((1, h, w, 3), generator=rng) * 255.0
    sparses = torch.zeros((1, h * w))
    idx = torch.randperm(h * w, generator=rng)[:500]
    sparses[0, idx] = 2.0 + 78.0 * torch.rand(500, generator=rng)
    sparses = sparses.reshape(1, h, w, 1)
    expected = expected_launches(
        registry.MARIGOLD_UNET_CONFIG, vae_kind, vae_config, (72, 96), steps)

    prev, before = None, {}
    reset_launches()  # just before the path: two requests
    for req in range(2):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense, lat = pipe(images, sparses, max_depth=120.0, steps=steps, norm="const",
                          closed_form=False, pred_latents_prev=prev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        now = launches()
        counts = {k: now[k] - before.get(k, 0) for k in now}
        before = now
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  request {req}: {dt:.2f} s, {dt / steps:.3f} s/step (incl. encode and final "
              f"decode), peak memory {peak:.2f} GiB, launches {counts}")
        if tuple(dense.shape) != (1, h, w, 1) or tuple(lat.shape) != (1, 72, 96, 4):
            raise AssertionError(f"bad output shapes {tuple(dense.shape)} {tuple(lat.shape)}")
        if not (torch.isfinite(dense).all() and torch.isfinite(lat).all()):
            raise AssertionError("non-finite output")
        lo, hi = float(dense.min()), float(dense.max())
        if not (0.0 <= lo <= hi <= 120.0):
            raise AssertionError(f"dense depth outside the metric range [0, 120]: [{lo}, {hi}]")
        print(f"  request {req}: dense depth range [{lo:.3f}, {hi:.3f}] m")
        if counts != expected:
            raise AssertionError(f"kernel launches {counts} != expected {expected}")
        prev = lat
    totals = launches()  # read just after the path
    print(f"  path launches (2 requests): {totals}")
    reset_launches()
    bundle32 = fp32_bundle(bundle)
    if vae_kind == "kl":
        encode_check(bundle, bundle32, images.to(DEV))
    reference_step_check(bundle, bundle32, images.to(DEV), sparses.to(DEV))
    return totals


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50, help="guided steps per request")
    args = ap.parse_args()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}; allow_tf32 matmul=False cudnn=False")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    runs: dict[str, list] = {}  # kernel name → the checks' results, timed one first
    for sq, sk, heads, d, is_timed in (
        (6912, None, 5, 64, True),  # UNet stage 0 at 576x768 (main path)
        (1728, None, 10, 64, True),  # UNet stage 1 (main path)
        (2688, None, 5, 64, True),  # KITTI stage-0 length (42 full tiles)
        (6900, None, 5, 64, False),  # ragged: neither length a multiple of 64
        (1000, 2100, 5, 64, False),  # ragged, Sq != Sk
        (6912, None, 1, 512, True),  # KL VAE mid attention at 576x768
        (6900, None, 1, 512, False),  # ragged
        (1000, 2100, 1, 512, False),  # ragged, Sq != Sk
    ):
        for nm, r in check_flash(sq, sk, heads, is_timed, d=d).items():
            runs.setdefault(nm, []).append(r)
    runs["conv3x3"] = [
        check_conv(1, 576, 768),  # TAESD, C=64
        check_conv(1, 72, 96),
        check_conv(2, 13, 37, timed=False),  # H and W not tile multiples
        check_conv(1, 576, 768, 128, relu=False),  # KL decoder stage 3, encoder stage 0
        check_conv(1, 288, 384, 128, 256, relu=False),  # encoder stage-1 entry
        check_conv(1, 144, 192, 256, 512, relu=False),  # encoder stage-2 entry
        check_conv(1, 576, 768, 256, 128, relu=False),  # stage-3 entry
        check_conv(1, 288, 384, 512, 256, relu=False),  # stage-2 entry
        check_conv(1, 288, 384, 256, relu=False),  # stage 2
        check_conv(1, 144, 192, 512, relu=False),  # stage 1
        check_conv(1, 72, 96, 512, relu=False),  # mid and stage 0
        check_conv(2, 13, 37, 256, 128, relu=False, timed=False),  # ragged, cin != cout
    ]
    check_autograd()
    runs["guidance_epilogue"] = [
        check_epilogue(1, v_pred=True),
        check_epilogue(2, v_pred=True, timed=False),
        check_epilogue(1, v_pred=False, timed=False),
        check_epilogue(2, v_pred=False, timed=False),
    ]

    counts: dict[str, int] = {}
    for label, vae_kind, vae_config in PATHS:
        for k, n in guided_path(label, vae_kind, vae_config, args.steps).items():
            counts[k] = counts.get(k, 0) + n
    if FAILURES:
        sys.stderr.write("chip_smoke: checks failed:\n  " + "\n  ".join(FAILURES) + "\n")
        return 1

    fa_src, fa_py = "depth_completion_tpu_torch/csrc/flash_attention.cu", \
        "depth_completion_tpu/ops/flash_attention.py"
    sources = {  # name → (source, TPU kernel it replaces)
        "flash_fwd": (fa_src, f"{fa_py}:163"),
        "flash_bwd": (fa_src, f"{fa_py}:534"),
        "flash_fwd_d512": (fa_src, f"{fa_py}:163"),
        "flash_bwd_d512": (fa_src, f"{fa_py}:534"),
        "conv3x3": ("depth_completion_tpu_torch/csrc/conv3x3.cu",
                    "depth_completion_tpu/ops/conv3x3.py:81"),
        "guidance_epilogue": ("depth_completion_tpu_torch/csrc/guidance_epilogue.cu",
                              "depth_completion_tpu/ops/guidance_epilogue.py:62"),
    }
    entries = []
    # times and bound at the first timed shape (the TAESD path's largest for
    # flash d=64 and the conv); error over every shape checked
    for name, (src, replaces) in sources.items():
        r = next(x for x in runs[name] if "ms" in x)
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "max_abs_err": max(x["max_abs_err"] for x in runs[name]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
