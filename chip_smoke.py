"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--steps N] [--only-fp32 | --only-distributed | --only-drivers]

1. prints the card (nvidia-smi name and power limit), torch and CUDA
   versions, and builds every CUDA kernel of the package from ``csrc/``
   (and the host codecs, with g++), one compiler each, in parallel;
2. holds each kernel against its plain PyTorch version on the card at the
   paths' shapes (max error against a stated tolerance), and times kernel,
   plain version and the nearest single PyTorch library call (for the
   guidance epilogue, the eager chain it replaces; the epilogue at batch 1,
   2 and 8, at the paths' latents, at a latent larger than the kernel's
   cluster holds in registers and at a ragged one). The ring attention of
   native-resolution mode runs the ring instantiations of the flash kernels
   (``flash_fwd_ring``, ``flash_bwd_ring``), one step per visiting
   key/value block: each step kernel is held against its twin from the same
   carried state, and the ring's passes against one flash call over the
   whole sequence and against the same ring through the twins, at ring
   sizes 2 and 4; a KL decode at widths (64, 36) (``NARROW_VAE``: the
   convs ``ops.conv3x3.fits`` takes launch the kernel, the others run
   ``F.conv2d``) against the same decode through the plain twins, its
   launches one forward and one dx per fitting conv (``check_narrow_decode``),
   and a guided request with that VAE through the pipeline's graphs against
   its eager twin, its launches ``expected_launches``' (``check_narrow_request``);
   2b. the probes of the flash kernel's inner loop
   (``depth_completion_tpu_torch.probes``): each probe kernel held against
   its twin at the probes' shapes, then each probe's own ``run`` with its
   launches counted from 0 (each must launch its kernel), its verdict, and
   its times beside bound, plain and library times;
   2c. (``fp32_kernel_checks``) every kernel form ``--precision fp32`` runs
   and every head dim the JAX package sends to Pallas: the fp32 flash pair
   (3xTF32) at the paths' shapes, the generic pair at d=128, 256 and 384 in
   bf16 and fp32, every ring step form, the ring's passes at d=64 fp32 and
   d=128, the fp32 conv at TAESD's and the KL widths, the autograd Functions
   in fp32, the narrow KL decode in fp32 and the epilogue with an fp32
   ``out``; the fp32 kernels held to
   their fp32 twins at ``FP32_REL`` of the largest reference magnitude (the
   arithmetic beside the constant);
3. writes the seeded full-width bundle (Marigold UNet, TAESD, the SD2 CLIP
   text tower; bf16; and a seeded float16 KL VAE) as an HF-layout
   checkpoint directory through ``write_checkpoint`` of
   ``scripts/make_synthetic_checkpoint_torch.py`` (the port's exporters
   and safetensors writer), loads it with ``load_bundle`` (every
   leaf bit-exact, the context the tower's), and drives three guided
   paths through ``DepthCompletionPipeline`` at full Marigold width
   (random bf16 weights from a seed, the context made by the SD2 tower):
   the TAESD decoder (``--vae light``, the default) on the loaded bundle,
   and the KL VAE at SD widths
   (``--vae original``), each on 480x640 frames with 500 sparse points at
   processing resolution 768; and native-resolution mode (TAESD, a
   ``LocalRing(4)`` over the UNet's self-attention) on 352x1216 KITTI-size
   frames with 2000 points at resolution 1216. Each path runs two
   requests, the second carrying the first's latents; checks finite metric
   outputs and that every kernel was launched the number of times the path
   implies (counts set to 0 just before the path, read just after); holds
   the KL encode against the same encode through the plain versions and in
   fp32; and holds one guided step's losses and gradients, for a few noise
   seeds (JAX's noise for each seed), against the same step run through the
   plain versions (for the ring: through the flash kernels without the
   ring), and the latent gradient against an fp32 run. The pipeline runs
   every request as a program per signature (``pipeline.programs``): its
   prepare step (the encode), its guided step and its finish step (the
   final decode) each a captured CUDA graph (the first request runs each
   phase's step 0 eagerly, captures it, replays the rest), and each replay
   adds the launches its capture recorded to the counts: (a) the graph's
   request against requests through the pipeline's eager twin (the spread
   of two eager runs, or of up to ``GRAPH_TWINS`` where two leave the graph
   past the limit), over the latent, the dense map and the program's other
   state (Adam v, the affine); (b) ms per run of each
   phase eager and graph (CUDA events), device ms, busy share and launches
   (``torch.profiler``), capture and instantiation ms, pool growth, peaks;
   (c) the launches recorded at each capture against one run of its
   phase's, and each request's against one request's; (d) the graph one
   step at a time against the eager step from the same state, at step
   indices 0, 1, N/2 and N-1 (a fixed limit at any step count), after a
   request has reset the program's state exactly;
   3b. runs ``scripts/verify_checkpoint_torch.py`` on that directory in
   two processes, ``--vae light`` and ``--vae original``: each exits 0 with
   OK, and the launches it prints equal ``expected_launches`` of its
   2-step request at 128x160;
4. runs the predict CLI (``depth_completion_tpu_torch.cli.predict``) in
   process with its defaults on the checkpoint directory of step 3 over a
   3-frame 480x640 PNG dataset written with the port's PNG writer: dense
   ``.dcz`` maps and JPEG vis grids checked, the kernel launches three
   times one request's, frame 0 against the pipeline called directly on
   the same weights and arrays; ``--resume true`` then launches nothing,
   and the analyze CLI scores the outputs; 4b. holds every committed image
   fixture bit-exact to its recorded cv2 decode, runs the CLI over JPEG
   frames with ``--compress bl2``, and writes and reads one dense map with
   every ``.bl2`` codec at clevel 1, 5 and 9;
5. runs the sampler's other modes on that checkpoint's bundle (at 480x640,
   500 points, res 768; ``modes_phase``): UNet rematerialisation (one
   guided step at batch 8 and 1 with and without; the same with the KL
   decoder on the same UNet at batch 1, 2 and 4: the bytes per latent
   pixel and fixed bytes of ``sampler.STEP_PEAK_BYTES``, which must cover
   each peak; a KL batch one above the largest that fits is refused before
   any kernel launches; then a 4-step request at batch 8 with and without
   remat, each through its own step program: ms per replayed step, capture,
   pool growth; the KL decoder's batch 1 and 4 programs in one pool), a 5-member ensemble (its program's readings too; aligned median,
   uncertainty), fast guidance (``detach_unet_grad``: no ``flash_bwd``
   launch, its peak below the guided request's), LCM through
   ``cli.predict --model lcm`` against the same request through the plain
   versions, per-input training with its own reference step, a guided path
   with the strict KLD penalty, and the reference step on a bundle whose
   self-attention q and k are scaled until the softmax is peaked (kernels
   against the plain versions; the ring against one flash call); every
   request's launches counted from 0 against its mode's; then each mode's
   program (``mode_program_check``: LCM at 4 steps, per-input with 10 train
   steps, SGD, Adagrad, no-training DDIM, Adam with sample clipping): its
   first request's launches, phase 3's (a)-(d) for its prepare, step (and
   train) and finish graphs (LCM's at another seed than its first
   request's), and (e) its request against the eager loop it replaced;
5b. runs ``--precision fp32`` (``fp32_phase``, on that checkpoint read at
   fp32): TAESD at full width, ``--steps`` steps, two requests with the
   carry, then the KL VAE and native resolution over ``LocalRing(4)`` at
   ``FP32_STEPS``, each request's launches against
   ``expected_launches(dtype=torch.float32)`` (every conv and flash call an
   fp32 kernel) and ms per step graph against eager; an fp32 guided step
   against the plain versions (``FP32_REF_LIMITS``); a dense map against the
   same request through the plain fp32 versions (``FP32_DENSE_LIMITS``);
   ``cli.predict --precision fp32`` in its own process (exit 0, its logged
   launches) and the checkpoint verifier at fp32 with either VAE; a guided
   step through the UNet with stage 1 at d=128 in bf16 and fp32; the fp32
   rows of ``sampler.STEP_PEAK_BYTES``;
   ``--only-fp32`` runs phases 2c, 3a and 5b alone;
6. runs the serving engine through ``cli.serve.run_serve`` on that
   checkpoint directory (``serve_phase``: 480x640 frames over HTTP from
   client threads, at most 10 steps): the warmup's signatures, concurrent
   requests coalesced into one batch and padded with row 0, a session's
   carry, the error codes, each batch's launches, and every served row
   against a direct pipeline call; then 8 closed-loop clients; then the
   tiers: ``run_serve`` with ``--warmup-tiered --max-programs 4`` serving
   its first batch on the eager twin and later ones on the graphs as each
   signature is promoted, ``max_programs=1`` over two geometries, whose
   evicted program's requests run on the eager twin, and ``--max-programs
   1`` with ``--model lcm`` and with ``--opt sgd``, each signature
   promoted and tier 0 dropped; then ``--precision fp32``
   (``fp32_serve_phase``, at most 4 steps): four concurrent frames in one
   batch, each row against a direct fp32 call, a session's carry, 4
   closed-loop clients, every batch's launches the fp32 kernels'
   (``expected_launches(dtype=torch.float32)``) and no bf16 one, and one
   ``--vae original --max-batch 1`` request against a direct call;
7. runs the distributed layer (``distributed_phase``): (a) ``torchrun
   --standalone --nproc_per_node=1`` of the predict CLI with ``--multihost
   true`` on phase 4's frames at ``min(--steps, 10)`` steps, an NCCL group
   of one rank, against the single-process run (launches per rank counted
   in the rank); (b) on a machine with two or more cards, native-res over
   ``ProcessGroupRing``, data parallel at batch 4 and ``--mesh-model 2``
   against one card, and on one card a line saying it did not run; (c) two
   gloo ranks on the one card: a full-width tensor-parallel guided step
   against the whole UNet (``REF_LIMITS``) and an ensemble over a data axis
   of 2 (its rows exact), and what NCCL says to two ranks on one card;
   ``--only-distributed`` runs phases 3a, 3 (TAESD), 4 and 7 alone;
8. runs the configuration drivers (``drivers_phase``), each as a user
   runs it, at a reduced size and all at once: ``scripts/
   bench_nativeres_torch.py`` (kitti-768, kitti-native: one flash call
   over S=6688, kitti-native-ring1), ``frontier_torch.py`` (full-50,
   fast-50, lcm-4, ddim-10), ``bench_kitti_torch.py`` (the predict CLI
   over two KITTI frames, an E=2 ensemble) and ``bench_scaling_torch.py``
   (the n = 1 rows under torchrun): every row names the card, its launches
   equal ``expected_launches``, kitti-native-ring1 against kitti-native in
   process, the frontier's reference and drift recomputed from its maps,
   bench_kitti's frames/s from its parsed times and its maps, the scaling
   rows' times against the same request timed here; ``--only-drivers``
   runs phase 8 alone;
9. prints ``{"probes": [...]}`` (each probe's readings and verdict),
   ``{"composites": [...]}`` (the ring's passes: their times, errors
   and bound, and the ring step launches on the native path),
   ``{"graphs": {...}}`` (phase 3's (a)-(d) per path, the card),
   ``{"cli": {...}}`` (the CLI's seconds per frame and their split, PNG
   decode and JPEG encode ms per frame, dense bytes, analyze MAE),
   ``{"verify": {...}}`` (phase 3b: seconds and launches per VAE),
   ``{"host_io": {...}}`` (phase 4b: fixtures, JPEG decode and ``.bl2``
   ms, each codec's ms and ratio, the host CPU),
   ``{"modes": {...}}`` (per mode: seconds per request, launches, peak
   GiB, the check readings, the card), ``{"programs": {...}}`` (phase 5's
   programs, per mode: (a)-(e), each phase's ms eager and graph, busy
   share, capture ms and pool growth), ``{"serve": {...}}`` (warmup
   seconds per signature, the first request's latency, requests/s, p50 and
   p95 latency, s/step at batch 1 and 4, the device gap between batches,
   peak GiB, the step programs, the tiers' calls and promotion times, the
   card; under ``fp32`` the fp32 server's warmup, requests/s, p50, s/step,
   peak, checks and KL request), ``{"fp32": {...}}`` (phase 5b: per path
   seconds, peak and ms per step, the checks' readings, the CLI run, the
   d=128 steps, the peak rows),
   ``{"distributed": {...}}`` (phase 7's readings, the card),
   ``{"drivers": {...}}`` (phase 8: each driver's rows, (c)'s errors, the
   phase's seconds), ``{"kernels": [...]}`` (one entry per CUDA
   kernel form, its launches over phases 3, 5b, 6 and 7 (a), replays
   included; a probe kernel's
   launches are its probe's, and every guided path must launch it 0
   times) and, last,
   ``{"ok": true, "device": ...}``.

A tolerance check that fails is reported and the run goes on, so one run
prints every reading; the script then exits non-zero without the result
lines. Any other failure raises at once. Exits non-zero at once when CUDA
is not available. float32 matmuls and convolutions run without
TF32 (both flags set False) so the plain versions are true fp32 references.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import http.client
import io
import itertools
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path


def _require_cuda():
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: CUDA is not available; this smoke needs a GPU\n")
        sys.exit(2)
    return torch


torch = _require_cuda()
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402

import numpy as np  # noqa: E402

from depth_completion_tpu_torch import _build  # noqa: E402
from depth_completion_tpu_torch.cli import analyze as analyze_cli  # noqa: E402
from depth_completion_tpu_torch.cli import predict as predict_cli  # noqa: E402
from depth_completion_tpu_torch.cli import serve as serve_cli  # noqa: E402
from depth_completion_tpu_torch.core import distributed as dist_core  # noqa: E402
from depth_completion_tpu_torch.core import prng  # noqa: E402
from depth_completion_tpu_torch.core import mesh as mesh_core  # noqa: E402
from depth_completion_tpu_torch.guidance.optim import make_optimizer  # noqa: E402
from depth_completion_tpu_torch.io import bl2, codecs, image, jpeg, png  # noqa: E402
from depth_completion_tpu_torch.models import clip_text, registry, weights  # noqa: E402
from depth_completion_tpu_torch.models.bundle import (  # noqa: E402
    load_bundle,
    make_random_bundle,
    make_random_params,
)
from depth_completion_tpu_torch.models.layers import attention as plain_attention  # noqa: E402
from depth_completion_tpu_torch.ops import conv3x3 as c3  # noqa: E402
from depth_completion_tpu_torch.ops import flash_attention as fa  # noqa: E402
from depth_completion_tpu_torch.ops import guidance_epilogue as ge  # noqa: E402
from depth_completion_tpu_torch.ops import ring_attention as ra  # noqa: E402
from depth_completion_tpu_torch.ops.resize import latent_size  # noqa: E402
from depth_completion_tpu_torch.parallel import ensemble as TE  # noqa: E402
from depth_completion_tpu_torch.parallel import sharding  # noqa: E402
from depth_completion_tpu_torch.pipeline import sampler as S  # noqa: E402
from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline  # noqa: E402
from depth_completion_tpu_torch.probes import card, time_ms  # noqa: E402
from depth_completion_tpu_torch.probes import flash_overlap as fo  # noqa: E402
from depth_completion_tpu_torch.probes import flash_twostream as fts  # noqa: E402
from depth_completion_tpu_torch.probes import mma_n64 as n64  # noqa: E402
from depth_completion_tpu_torch.probes import packed_pv as ppv  # noqa: E402
from depth_completion_tpu_torch.sched.ddim import ddim_step, pred_epsilon  # noqa: E402
from depth_completion_tpu_torch.sched.lcm import lcm_step, make_lcm_timesteps  # noqa: E402
from scripts import make_synthetic_checkpoint_torch as synthetic  # noqa: E402

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_TF32_FLOPS = 494.7e12  # H100 SXM dense TF32 tensor-core rate (the fp32 kernels' bound)
PEAK_FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# The fp32 kernels (3xTF32 on the tensor cores) against their fp32 plain
# twins (TF32 off), as a share of the largest reference magnitude. Each
# operand is split into a TF32 high part and a TF32 remainder: ~22 bits of
# it, so a product keeps all but ~3·2^-22 of |x·y| (the dropped lo·lo' term
# and the remainder's rounding), against one TF32 pass's 2^-11; both sides
# round their fp32 sums in other orders (2^-24 an addition). Over a
# reduction of K terms of random sign the error is ~2^-21·sqrt(K)·rms(term)
# against an output of ~sqrt(K)·rms(term): ~2^-21 of the output, a few times
# that at the largest elements. FP32_REL = 2^-16 leaves 30x over that; one
# TF32 pass reads ~2^-12 and fails it by 10x or more (F59 in
# scripts/chip_smoke_faults.sh), a bf16 operand (2^-9) by far more (F60).
# The row statistic lse2 (|lse2| ~ 13): scores of |q·k| <= ~100 before
# their scale of ~0.18 or less, 3·2^-22 each, and log2 of an fp32 row sum:
# FP32_LSE = 2e-5 (~20 fp32 ulps); one TF32 pass moves it ~1e-3.
FP32_REL = 2.0 ** -16
FP32_LSE = 2e-5
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SFU_PER_SM_CLK = 16  # MUFU ex2 results per SM per clock (4 per SM sub-partition)
DEV = torch.device("cuda")
FAILURES: list[str] = []  # tolerance checks that failed, reported at the end
LAUNCH_COUNTS = (fa.LAUNCHES, c3.LAUNCHES, ge.LAUNCHES, fo.LAUNCHES, fts.LAUNCHES, n64.LAUNCHES,
                 ppv.LAUNCHES)
# the probes' kernels: name → (source, TPU probe kernel it replaces)
PROBE_KERNELS = {
    "probe_block_step": ("depth_completion_tpu_torch/csrc/probe_block_step.cu",
                         "scripts/exp_flash_overlap.py:39"),
    "flash_fwd_twostream": ("depth_completion_tpu_torch/csrc/probe_flash_twostream.cu",
                            "scripts/exp_flash_twostream.py:64"),
    "probe_mma_n64": ("depth_completion_tpu_torch/csrc/probe_mma.cu",
                      "scripts/exp_pallas_n64.py:61"),
    "probe_packed_pv": ("depth_completion_tpu_torch/csrc/probe_mma.cu",
                        "scripts/exp_packed_pv.py:36"),
}


def exp_bound_ms(n_exp: float) -> float:
    """Least time for ``n_exp`` exp2 on the special-function units at the
    card's maximum SM clock (a bound the table's bf16 peak does not see)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n_exp / (sms * SFU_PER_SM_CLK * mhz * 1e6) * 1e3


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def max_rel(a, b) -> float:
    """The largest |a - b| / |b| (|b| floored at 1e-12)."""
    return float(((a.float() - b.float()).abs() / b.float().abs().clamp(min=1e-12)).max())


def cos(a, b) -> float:
    return float(F.cosine_similarity(a.flatten().float(), b.flatten().float(), dim=0))


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
                reps: int = 10, d: int = 64, n: int = 1, dtype: torch.dtype = torch.bfloat16) -> dict:
    sk = sq if sk is None else sk
    fwd_name, bwd_name = fa.launch_names(dtype, d)
    fp32 = dtype == torch.float32
    gen = torch.Generator(device=DEV).manual_seed(sq * 7919 + sk + d + 100003 * (n - 1))
    c = heads * d

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=DEV).to(dtype)

    q, do, k, v = rnd(n, sq, c), rnd(n, sq, c), rnd(n, sk, c), rnd(n, sk, c)
    print(f"flash attention N={n} heads={heads} Sq={sq} Sk={sk} d={d} {fa.DTYPE_TAGS[dtype]}")
    o, lse2 = fa.flash_fwd(q, k, v, heads)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, heads)
    torch.cuda.synchronize()
    if fp32:  # 3xTF32 against fp32 (FP32_REL, FP32_LSE)
        err_o = max_err(o, o_ref)
        check(f"{fwd_name} o", err_o, FP32_REL * float(o_ref.abs().max()))
        check(f"{fwd_name} lse2", max_err(lse2, lse_ref), FP32_LSE)
    else:
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
    # bf16: p and ds in bf16 feed the kernel's products (fp32 in the plain
    # version): 2% of the largest reference magnitude; fp32: FP32_REL
    errs = {}
    for nm, got, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        errs[nm] = max_err(got, ref)
        check(f"{bwd_name} {nm}", errs[nm],
              (FP32_REL if fp32 else 2e-2) * float(ref.float().abs().max()))
    fwd, bwd = {"max_abs_err": err_o}, {"max_abs_err": max(errs.values())}
    if not timed:
        return {fwd_name: fwd, bwd_name: bwd}

    qh, kh, vh = (t.view(n, -1, heads, d).transpose(1, 2) for t in (q, k, v))
    backend = sdpa_backend(qh, kh, vh)
    fwd["ms"] = time_ms(lambda: fa.flash_fwd(q, k, v, heads), reps)
    fwd["plain_ms"] = time_ms(lambda: fa.flash_fwd_plain(q, k, v, heads), 3, 1)
    bwd["ms"] = time_ms(lambda: fa.flash_bwd(q, k, v, o, do, lse2, heads), reps)
    bwd["plain_ms"] = time_ms(lambda: fa.flash_bwd_plain(q, k, v, o, do, lse2, heads), 3, 1)
    with sdpa_kernel([backend]):
        fwd["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), reps)
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (qh, kh, vh))
        ol = F.scaled_dot_product_attention(ql, kl, vl)
    doh = do.view(n, sq, heads, d).transpose(1, 2)
    bwd["library_ms"] = time_ms(
        lambda: torch.autograd.grad(ol, (ql, kl, vl), doh, retain_graph=True), reps
    )
    size = q.element_size()
    q_bytes, kv_bytes, stat_bytes = size * n * sq * c, size * n * sk * c, 4 * n * sq * heads
    # fp32 runs on the TF32 tensor cores (three products a k-step: 3x the
    # operations the bound counts)
    peak = PEAK_TF32_FLOPS if fp32 else PEAK_BF16_FLOPS
    fwd["bound_ms"], fwd["bound_by"] = bound(
        4.0 * n * sq * sk * d * heads, 2 * q_bytes + 2 * kv_bytes + stat_bytes, peak)
    bwd["bound_ms"], bwd["bound_by"] = bound(
        10.0 * n * sq * sk * d * heads, 4 * q_bytes + 4 * kv_bytes + stat_bytes, peak)
    exp_ms = exp_bound_ms(float(n) * sq * sk * heads)  # one exp2 per score, fwd and bwd alike
    for nm, r in ((fwd_name, fwd), (bwd_name, bwd)):
        print(f"  {nm} Sq={sq} Sk={sk} heads={heads} d={d}: kernel_ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
              f"(SDPA {backend.name}) bound_ms={r['bound_ms']:.4f} ({r['bound_by']}); "
              f"exp2 on the SFUs alone {exp_ms:.4f} ms")
    return {fwd_name: fwd, bwd_name: bwd}


def check_ring(s: int, heads: int, p: int, timed: bool = True, reps: int = 10, d: int = 64,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """Ring attention over a ``LocalRing(p)`` (the ring step kernels, one
    launch per visiting block, the softmax state carried in fp32), forward
    and backward through its ``autograd.Function``, against one flash call
    over the whole sequence (kernels, through ``FlashAttention``) and
    against the same ring through the step twins; the ring's global lse2
    against the single call's. Tolerances as for the flash kernels, but for
    o's rel-norm against the single call, 2^-7: the ring's first form
    rounded each block's o to bf16 before its merge and read 3.0e-3-3.2e-3
    there (0.8 of the kernels' 2^-8), its merge without the rescale (F11)
    1.2e-2-4.2e-2; carried in fp32, o is rounded once (PERF.md, Findings).
    fp32: every comparison at FP32_REL, lse2 at FP32_LSE."""
    c = heads * d
    fp32 = dtype == torch.float32
    gen = torch.Generator(device=DEV).manual_seed(s * 31 + heads * 7 + p + d)

    def rnd():
        return torch.randn((1, s, c), generator=gen, device=DEV).to(dtype)

    q, k, v, do = rnd(), rnd(), rnd(), rnd()
    ring = ra.LocalRing(p)
    print(f"ring attention LocalRing({p}) N=1 heads={heads} S={s} ({s // p}-row shards) d={d} "
          f"{fa.DTYPE_TAGS[dtype]}")
    fwd_step, bwd_step = fa.launch_names(dtype, d, ring=True)

    def through(fn):
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        o = fn(*leaves)
        return o.detach(), torch.autograd.grad(o, leaves, do)

    o, grads = through(lambda q, k, v: ra.ring_attention(q, k, v, heads, ring))
    o1, grads1 = through(lambda q, k, v: fa.FlashAttention.apply(q, k, v, heads))
    qs, ks, vs, dos = (ring.shard(x) for x in (q, k, v, do))
    op_s, lse2p_s = ra.ring_forward(qs, ks, vs, heads, ring, fa.flash_fwd_ring_plain)
    grads_p = [ring.gather(g) for g in ra.ring_backward(
        qs, ks, vs, op_s, dos, lse2p_s, heads, ring, fa.flash_bwd_ring_plain)]
    o_p = ring.gather(op_s)
    o_s, lse2_s = ra.ring_forward(qs, ks, vs, heads, ring)
    _, lse2_1 = fa.flash_fwd(q, k, v, heads)
    torch.cuda.synchronize()
    # [P, heads, S/P] shards → [1, heads, S]
    lse2 = lse2_s.unflatten(0, (1, p)).permute(0, 2, 1, 3).reshape(1, heads, s)
    errs = []
    for ref_name, o_ref, g_ref in (("single flash", o1, grads1), ("plain ring", o_p, grads_p)):
        name = f"ring P={p} S={s} d={d} {fa.DTYPE_TAGS[dtype]} vs {ref_name}"
        if fp32:
            err = max_err(o, o_ref)
            check(f"{name} o", err, FP32_REL * float(o_ref.abs().max()))
        else:
            err = check_elementwise(f"{name} o", o, o_ref, 2**-7, 2**-8)
            check(f"{name} o rel-norm",
                  float((o.float() - o_ref.float()).norm() / o_ref.float().norm()),
                  2**-7 if ref_name == "single flash" else 2**-8, "|o-o_ref|/|o_ref|")
        for nm, g, gr in zip(("dq", "dk", "dv"), grads, g_ref):
            check(f"{name} {nm}", max_err(g, gr),
                  (FP32_REL if fp32 else 2e-2) * float(gr.float().abs().max()))
        if ref_name == "plain ring":
            errs.append(err)
            errs.extend(max_err(g, gr) for g, gr in zip(grads, g_ref))
    check(f"ring P={p} S={s} d={d} {fa.DTYPE_TAGS[dtype]} lse2 vs single flash", max_err(lse2, lse2_1),
          FP32_LSE if fp32 else 1e-4)
    fwd, bwd = {"max_abs_err": errs[0]}, {"max_abs_err": max(errs[1:])}
    if not timed:
        return {"ring_attention_fwd": fwd, "ring_attention_bwd": bwd}

    fwd["ms"] = time_ms(lambda: ra.ring_forward(qs, ks, vs, heads, ring), reps)
    fwd["plain_ms"] = time_ms(
        lambda: ra.ring_forward(qs, ks, vs, heads, ring, fa.flash_fwd_ring_plain), 3, 1)
    fwd["single_ms"] = time_ms(lambda: fa.flash_fwd(q, k, v, heads), reps)
    bwd["ms"] = time_ms(lambda: ra.ring_backward(qs, ks, vs, o_s, dos, lse2_s, heads, ring), reps)
    bwd["plain_ms"] = time_ms(lambda: ra.ring_backward(
        qs, ks, vs, op_s, dos, lse2p_s, heads, ring, fa.flash_bwd_ring_plain), 3, 1)
    bwd["single_ms"] = time_ms(lambda: fa.flash_bwd(q, k, v, o1, do, lse2_1, heads), reps)
    qh, kh, vh, doh = (t.view(1, s, heads, d).transpose(1, 2) for t in (q, k, v, do))
    backend = sdpa_backend(qh, kh, vh)
    with sdpa_kernel([backend]):
        fwd["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), reps)
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (qh, kh, vh))
        ol = F.scaled_dot_product_attention(ql, kl, vl)
    bwd["library_ms"] = time_ms(
        lambda: torch.autograd.grad(ol, (ql, kl, vl), doh, retain_graph=True), reps)
    # the function's bytes and operations are full attention's; the ring's
    # own traffic is reported beside the bound, in bytes per element of
    # [S, C]. Forward: the packed k|v (bf16) built once (read 4, written 4)
    # and rolled P-1 times (8 each); the fp32 state written by the first
    # step, read and written by the middle ones, read by the last (8(P-1)).
    # Backward: the same k|v traffic; dq and dk|dv (fp32) zeroed once (12),
    # dk|dv read and written by every step (16) and rotated P times (16),
    # dq read and written once by its atomics (8), both cast (18)
    x_bytes, stat_bytes = q.element_size() * s * c, 4 * s * heads
    peak = PEAK_TF32_FLOPS if fp32 else PEAK_BF16_FLOPS
    fwd["bound_ms"], fwd["bound_by"] = bound(4.0 * s * s * d * heads, 4 * x_bytes + stat_bytes,
                                             peak)
    bwd["bound_ms"], bwd["bound_by"] = bound(10.0 * s * s * d * heads, 8 * x_bytes + stat_bytes,
                                             peak)
    kv_bytes = 8 + 8 * (p - 1)
    fwd["extra_ms"] = (kv_bytes + 8 * (p - 1)) * s * c / PEAK_BYTES * 1e3
    bwd["extra_ms"] = (kv_bytes + 12 + 32 * p + 8 + 18) * s * c / PEAK_BYTES * 1e3
    fwd.update(d=d, dtype=fa.DTYPE_TAGS[dtype], kernel=fwd_step)
    bwd.update(d=d, dtype=fa.DTYPE_TAGS[dtype], kernel=bwd_step)
    for nm, r in (("ring_attention_fwd", fwd), ("ring_attention_bwd", bwd)):
        print(f"  {nm} P={p} S={s} heads={heads} d={d} {fa.DTYPE_TAGS[dtype]}: ring_ms={r['ms']:.4f} "
              f"single_flash_ms={r['single_ms']:.4f} (overhead {r['ms'] / r['single_ms'] - 1:+.1%}) "
              f"plain_ring_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
              f"(SDPA {backend.name}) "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}); the ring's own bytes "
              f"alone {r['extra_ms']:.4f} ms")
    return {"ring_attention_fwd": fwd, "ring_attention_bwd": bwd}


def check_ring_steps(s: int, heads: int, p: int, timed: bool = True, reps: int = 10, d: int = 64,
                     dtype: torch.dtype = torch.bfloat16) -> dict:
    """Each ring step kernel against its twin on the same inputs and the
    same carried state, at a ``LocalRing(p)``'s shapes (all p shards of
    S/p rows in one launch): the forward's first step (no state in), a
    middle one (state in and out) and the last (o and lse2 out) over three
    visiting blocks; the backward's first step (di, zeroed accumulators)
    and a later one, with the global o and lse2 of those blocks. The
    kernels update the state in place, so each side gets its own copy.
    The state (m, l, acc) is held as the statistic m + log2 l (as lse2:
    1e-4), m itself (1e-4) and the normalised acc / l (as o: the same p
    rounded to bf16 against another running max); the last step's o as
    ``flash_fwd``'s. The backward's accumulators are held by what the step
    added (got − state in against ref − state in) at the flash backward's
    2% of the largest reference magnitude, di (fp32 sums of d products in
    another order) at 1e-5 of its largest magnitude. fp32 operands: m and
    the statistic at FP32_LSE, everything else at FP32_REL."""
    c, s_loc = heads * d, s // p
    fp32 = dtype == torch.float32
    fwd_name, bwd_name = fa.launch_names(dtype, d, ring=True)
    gen = torch.Generator(device=DEV).manual_seed(s * 17 + heads + p + d)

    def rnd():
        return torch.randn((p, s_loc, c), generator=gen, device=DEV).to(dtype)

    q, do = rnd(), rnd()
    blocks = [(rnd(), rnd()) for _ in range(3)]
    tag = f"ring step P={p} S={s} d={d} {fa.DTYPE_TAGS[dtype]}"
    print(f"ring steps LocalRing({p}) heads={heads} {p}x{s_loc} rows d={d} {fa.DTYPE_TAGS[dtype]}")

    def copy(state):
        return tuple(x.clone() for x in state)

    def hold_state(name, got, ref):
        m, l, acc = got
        m_r, l_r, acc_r = ref
        stat_tol = FP32_LSE if fp32 else 1e-4
        check(f"{name} m", max_err(m, m_r), stat_tol)
        check(f"{name} m + log2 l", max_err(m + torch.log2(l), m_r + torch.log2(l_r)), stat_tol)

        def norm(acc, l):
            return acc.view(p, s_loc, heads, d) / l.transpose(1, 2)[..., None]

        if fp32:
            err = max_err(norm(acc, l), norm(acc_r, l_r))
            check(f"{name} acc / l", err, FP32_REL * float(norm(acc_r, l_r).abs().max()))
            return err
        return check_elementwise(f"{name} acc / l", norm(acc, l), norm(acc_r, l_r), 2**-7, 2**-8)

    errs_f, errs_b = [], []
    (k1, v1), (k2, v2), (k3, v3) = blocks
    first = fa.flash_fwd_ring(q, k1, v1, heads)
    errs_f.append(hold_state(f"{fwd_name} {tag} first", first,
                             fa.flash_fwd_ring_plain(q, k1, v1, heads)))
    mid = fa.flash_fwd_ring(q, k2, v2, heads, copy(first))
    errs_f.append(hold_state(f"{fwd_name} {tag} middle", mid,
                             fa.flash_fwd_ring_plain(q, k2, v2, heads, copy(first))))
    o, lse2 = fa.flash_fwd_ring(q, k3, v3, heads, copy(mid), last=True)
    o_r, lse2_r = fa.flash_fwd_ring_plain(q, k3, v3, heads, copy(mid), last=True)
    if fp32:
        errs_f.append(max_err(o, o_r))
        check(f"{fwd_name} {tag} last o", errs_f[-1], FP32_REL * float(o_r.abs().max()))
    else:
        errs_f.append(check_elementwise(f"{fwd_name} {tag} last o", o, o_r, 2**-7, 2**-8))
        check(f"{fwd_name} {tag} last o rel-norm",
              float((o.float() - o_r.float()).norm() / o_r.float().norm()), 2**-8,
              "|o-o_ref|/|o_ref|")
    check(f"{fwd_name} {tag} last lse2", max_err(lse2, lse2_r), FP32_LSE if fp32 else 1e-4)

    first_b = fa.flash_bwd_ring(q, k1, v1, o_r, do, lse2_r, heads)
    first_r = fa.flash_bwd_ring_plain(q, k1, v1, o_r, do, lse2_r, heads)
    di, di_r = first_b[0], first_r[0]
    check(f"{bwd_name} {tag} di", max_err(di, di_r), 1e-5 * float(di_r.abs().max()))
    later = fa.flash_bwd_ring(q, k2, v2, o_r, do, lse2_r, heads, copy(first_b))
    later_r = fa.flash_bwd_ring_plain(q, k2, v2, o_r, do, lse2_r, heads, copy(first_b))
    for step, got, ref, before in (("first", first_b, first_r, None),
                                   ("later", later, later_r, first_b)):
        for nm, sl in (("dq", (1, slice(None))), ("dk", (2, slice(0, c))),
                       ("dv", (2, slice(c, 2 * c)))):
            g, r = got[sl[0]][..., sl[1]], ref[sl[0]][..., sl[1]]
            if before is not None:
                g, r = g - before[sl[0]][..., sl[1]], r - before[sl[0]][..., sl[1]]
            errs_b.append(max_err(g, r))
            check(f"{bwd_name} {tag} {step} {nm}", errs_b[-1],
                  (FP32_REL if fp32 else 2e-2) * float(r.abs().max()))
    fwd, bwd = {"max_abs_err": max(errs_f)}, {"max_abs_err": max(errs_b)}
    if not timed:
        return {fwd_name: fwd, bwd_name: bwd}

    # a middle step of the forward and a later step of the backward, the
    # state updated in place call after call
    st_t, st_p = copy(first), copy(first)
    fwd["ms"] = time_ms(lambda: fa.flash_fwd_ring(q, k2, v2, heads, st_t), reps)
    fwd["plain_ms"] = time_ms(lambda: fa.flash_fwd_ring_plain(q, k2, v2, heads, st_p), 3, 1)
    bs_t, bs_p = copy(first_b), copy(first_b)
    bwd["ms"] = time_ms(lambda: fa.flash_bwd_ring(q, k2, v2, o_r, do, lse2_r, heads, bs_t), reps)
    bwd["plain_ms"] = time_ms(
        lambda: fa.flash_bwd_ring_plain(q, k2, v2, o_r, do, lse2_r, heads, bs_p), 3, 1)
    # the nearest single call: SDPA flash over the same shards and block,
    # which computes the block's attention but carries no state
    qh, kh, vh, doh = (t.view(p, s_loc, heads, d).transpose(1, 2) for t in (q, k2, v2, do))
    backend = sdpa_backend(qh, kh, vh)
    with sdpa_kernel([backend]):
        fwd["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), reps)
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (qh, kh, vh))
        ol = F.scaled_dot_product_attention(ql, kl, vl)
    bwd["library_ms"] = time_ms(
        lambda: torch.autograd.grad(ol, (ql, kl, vl), doh, retain_graph=True), reps)
    # bytes of one [P, S/P, C] operand, and of the same in fp32 (the state)
    x_bytes, f_bytes, rows = q.element_size() * p * s_loc * c, 4 * p * s_loc * c, p * s_loc * heads
    peak = PEAK_TF32_FLOPS if fp32 else PEAK_BF16_FLOPS
    # forward middle step: q, k, v read; acc (fp32) read and written; m, l read and written
    fwd["bound_ms"], fwd["bound_by"] = bound(4.0 * p * s_loc * s_loc * d * heads,
                                             3 * x_bytes + 2 * f_bytes + 16 * rows, peak)
    # backward later step: q, k, v, do read; lse2, di read; dq (fp32) and
    # dk|dv (fp32) read and written
    bwd["bound_ms"], bwd["bound_by"] = bound(10.0 * p * s_loc * s_loc * d * heads,
                                             4 * x_bytes + 8 * rows + 2 * f_bytes + 4 * f_bytes,
                                             peak)
    for nm, r in ((fwd_name, fwd), (bwd_name, bwd)):
        print(f"  {nm} {p}x{s_loc} rows heads={heads}: kernel_ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} (SDPA "
              f"{backend.name}, one block, no state) bound_ms={r['bound_ms']:.4f} "
              f"({r['bound_by']})")
    return {fwd_name: fwd, bwd_name: bwd}


def check_conv(n: int, h: int, w: int, cin: int = 64, cout: int | None = None,
               relu: bool = True, timed: bool = True, reps: int = 10,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """The conv kernel as a path runs it: TAESD (``relu``: bias+ReLU,
    bias+skip+ReLU, dx with the ReLU mask) or the KL VAE's ResNets (bias,
    bias+skip, dx without a mask); bf16, or fp32 (``conv3x3_fp32``, held at
    FP32_REL; library times: cuDNN with TF32 off, and on)."""
    cout = cin if cout is None else cout
    fp32 = dtype == torch.float32
    gen = torch.Generator(device=DEV).manual_seed(h * w + cin + cout)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)

    x, skip, dy = rnd(n, h, w, cin), rnd(n, h, w, cout), rnd(n, h, w, cout)
    wgt = rnd(cout, cin, 3, 3, scale=1.0 / math.sqrt(9 * cin))
    b = rnd(cout, scale=0.1)
    w_hwio = c3._hwio(wgt).contiguous()
    kf = c3._flip_transpose_hwio(wgt).contiguous()
    act = "+relu" if relu else ""
    print(f"conv3x3 N={n} H={h} W={w} C={cin}->{cout} {fa.DTYPE_TAGS[dtype]} "
          f"({'TAESD' if relu else 'KL'} form)")
    # bf16 outputs of fp32 sums taken in another order: 2 bf16 ulps of the
    # largest output; fp32: FP32_REL
    rel = FP32_REL if fp32 else 1.6e-2
    errs = {}
    y = c3.conv3x3_call(x, w_hwio, b, relu=relu)
    y_ref, _ = c3.conv3x3_plain(x, w_hwio, b, relu=relu)
    errs["bias"] = max_err(y, y_ref)
    check(f"conv bias{act}", errs["bias"], rel * float(y_ref.float().abs().max()))
    ys = c3.conv3x3_call(x, w_hwio, b, skip=skip, relu=relu)
    ys_ref, _ = c3.conv3x3_plain(x, w_hwio, b, skip=skip, relu=relu)
    errs["skip"] = max_err(ys, ys_ref)
    check(f"conv bias+skip{act}", errs["skip"], rel * float(ys_ref.float().abs().max()))
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
          rel * float(dx_ref.float().abs().max()))

    out = {"max_abs_err": max(errs.values())}
    if not timed:
        return out
    xc = x.permute(0, 3, 1, 2)  # channels-last view for cuDNN
    out["ms"] = time_ms(lambda: c3.conv3x3_call(x, w_hwio, b, relu=relu), reps)
    out["plain_ms"] = time_ms(lambda: c3.conv3x3_plain(x, w_hwio, b, relu=relu), 3, 1)
    out["library_ms"] = time_ms(lambda: F.conv2d(xc, wgt, b, padding=1), reps)
    if fp32:  # cuDNN's fp32 conv in TF32 (one pass: not the same function), for scale
        torch.backends.cudnn.allow_tf32 = True
        try:
            out["library_tf32_ms"] = time_ms(lambda: F.conv2d(xc, wgt, b, padding=1), reps)
        finally:
            torch.backends.cudnn.allow_tf32 = False
    out["dx_ms"] = time_ms(run_dx, reps)
    # cuDNN's backward-data on the same channels-last views (the dx of the
    # conv alone: no single call applies the ReLU mask too)
    dyc = dy.permute(0, 3, 1, 2)
    out["dx_library_ms"] = time_ms(lambda: torch.ops.aten.convolution_backward(
        dyc, xc, wgt, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, False, False]), reps)
    flops = 2.0 * n * h * w * cin * cout * 9
    size = x.element_size()
    x_bytes, y_bytes, w_bytes = (size * n * h * w * cin, size * n * h * w * cout,
                                 size * 9 * cin * cout)
    # fp32 runs on the TF32 tensor cores (three products a k-step: 3x the
    # operations the bound counts)
    peak = PEAK_TF32_FLOPS if fp32 else PEAK_BF16_FLOPS
    out["bound_ms"], out["bound_by"] = bound(flops, x_bytes + y_bytes + w_bytes + size * cout,
                                             peak)
    # dx reads dy (and, with ReLU, the mask y) and writes dx (and dy masked)
    dx_bytes = x_bytes + y_bytes + w_bytes + (2 * y_bytes if relu else 0)
    out["dx_bound_ms"], _ = bound(flops, dx_bytes, peak)
    # 3xTF32 runs three TF32 products for each one the bound counts
    tf32 = (f" cuDNN TF32 {out['library_tf32_ms']:.4f} 3xTF32 floor "
            f"{3 * flops / PEAK_TF32_FLOPS * 1e3:.4f}" if fp32 else "")
    print(f"  conv3x3 {fa.DTYPE_TAGS[dtype]} {h}x{w} {cin}->{cout}: kernel_ms={out['ms']:.4f} "
          f"({'masked ' if relu else ''}dx {out['dx_ms']:.4f}, bound {out['dx_bound_ms']:.4f}, "
          f"dx_library_ms {out['dx_library_ms']:.4f}) "
          f"plain_ms={out['plain_ms']:.4f} library_ms={out['library_ms']:.4f}{tf32} "
          f"bound_ms={out['bound_ms']:.4f} ({out['bound_by']})")
    return out


def check_autograd(dtype: torch.dtype = torch.bfloat16) -> None:
    """Each ``autograd.Function`` (forward and backward through the kernels)
    against autograd through the plain path, at the paths' shapes: catches
    wiring faults (gradients swapped, dropped or misplaced) that the
    kernel-level checks above cannot see. Tolerances as for the kernels:
    2% of the largest reference magnitude (bf16 p, ds and products), or
    FP32_REL for fp32 operands. With
    ReLU, the plain path masks with the kernel output's sign: where the
    pre-activation lies within a rounding of 0 the two forwards can disagree
    on it, and the gradients then differ by the whole |dy| there."""
    gen = torch.Generator(device=DEV).manual_seed(77)
    rel = FP32_REL if dtype == torch.float32 else 2e-2

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEV) * scale).to(dtype)

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
        name = f"{name} {fa.DTYPE_TAGS[dtype]}"
        print(f"autograd {name}")
        leaves = [x.detach().clone().requires_grad_(True) for x in xs]
        y = fn(*leaves)
        grads = torch.autograd.grad(y, leaves, dy, allow_unused=True)
        leaves = [x.detach().clone().requires_grad_(True) for x in xs]
        y_ref = plain_fn(y.detach(), *leaves)
        grads_ref = torch.autograd.grad(y_ref, leaves, dy)
        check(f"autograd {name} output", max_err(y, y_ref),
              rel * float(y_ref.float().abs().max()))
        for i, (g, g_ref) in enumerate(zip(grads, grads_ref)):
            g = torch.zeros_like(g_ref) if g is None else g  # a gradient left out reads as 0
            check(f"autograd {name} grad of input {i}", max_err(g, g_ref),
                  rel * float(g_ref.float().abs().max()))


# A KL decoder at widths the conv kernel does not all take: 64→64 fits
# (``ops.conv3x3.fits``), 36→36 and 36→64 run F.conv2d; the mid attention at
# d=36 takes the plain attention. Decoded from a 72x96 latent (res 768's) to
# 144x192 (two stages: one upsample).
NARROW_VAE = registry.VAEConfig(block_out_channels=(64, 36), layers_per_block=1, norm_groups=4)


def check_narrow_decode(dtype: torch.dtype = torch.bfloat16) -> dict:
    """``decode_depth`` of ``NARROW_VAE`` (seeded, ``dtype``) and its latent
    gradient (of Σ dy·out, dy seeded) through the routed convs, against the
    same decode through the plain twins (``conv_fn=`` the plain conv,
    ``attention_fn=`` the plain attention): the output within the conv
    check's limit of its largest magnitude (bf16 1.6e-2, fp32 ``FP32_REL``),
    the gradient's cosine gap within the reference step's (``REF_LIMITS``'
    KL, ``FP32_REF_LIMITS``). The kernel launches of the routed decode and
    its backward, counted from 0, are a forward and a dx per fitting conv
    (``vae_kernel_convs``), and nothing else."""
    fp32 = dtype == torch.float32
    tag = fa.DTYPE_TAGS[dtype]
    vae = make_random_bundle(seed=36, unet_config=registry.TINY_UNET_CONFIG,
                             vae_config=NARROW_VAE, dtype=dtype, device=DEV, vae_kind="kl").vae
    gen = torch.Generator(device=DEV).manual_seed(3636)
    lat = torch.randn((1, 72, 96, 4), generator=gen, device=DEV).to(dtype)
    f = vae.downsample_factor
    dy = torch.randn((1, 72 * f, 96 * f, 1), generator=gen, device=DEV).to(dtype)

    def decode(**fns):
        z = lat.clone().requires_grad_(True)
        out = vae.decode_depth(z, **fns)
        (g,) = torch.autograd.grad(out, z, dy)
        return out.detach(), g

    torch.cuda.synchronize()
    reset_launches()  # just before the routed decode
    out, g = decode()
    torch.cuda.synchronize()
    got = {k: n for k, n in launches().items() if n}
    reset_launches()
    per_decode, _ = vae_kernel_convs("kl", NARROW_VAE, dtype)
    want = {"conv3x3_fp32" if fp32 else "conv3x3": 2 * per_decode}
    out_p, g_p = decode(conv_fn=_plain_conv3x3_fused, attention_fn=plain_attention)
    rel = FP32_REL if fp32 else 1.6e-2
    err, gap = max_err(out, out_p), 1.0 - cos(g, g_p)
    print(f"narrow KL decode {tag} (widths {NARROW_VAE.block_out_channels}, latent 72x96): "
          f"launches {got} (want {want}), output max err {err:.3e} of "
          f"{float(out_p.float().abs().max()):.3f}, latent grad cosine gap {gap:.3e}, "
          f"|grad| max {float(g_p.float().abs().max()):.3e}")
    if got != want:
        raise AssertionError(f"narrow KL decode {tag}: kernel launches {got} != {want}")
    check(f"narrow KL decode {tag} output", err, rel * float(out_p.float().abs().max()))
    check(f"narrow KL decode {tag} latent grad (cosine gap)", gap,
          FP32_REF_LIMITS[2] if fp32 else REF_LIMITS["kl"][2], "1 - cos")
    return {"launches": got, "max_abs_err": err, "grad_cosine_gap": gap}


NARROW_STEPS = 3


def check_narrow_request(dtype: torch.dtype = torch.bfloat16) -> dict:
    """A guided request of ``NARROW_STEPS`` steps through the pipeline with
    the tiny UNet and ``NARROW_VAE`` (96x128 frames at res 128: a 48x64
    latent), whose prepare, step and finish graphs capture kernel and
    library convs side by side: its launches, counted from 0, equal
    ``expected_launches`` (the fitting convs only), and its dense map lies
    within ``FP32_DENSE_LIMITS`` (bf16: ``CLI_LIMITS``) of the same request
    through the pipeline's eager twin."""
    tag = fa.DTYPE_TAGS[dtype]
    bundle = make_random_bundle(seed=36, unet_config=registry.TINY_UNET_CONFIG,
                                vae_config=NARROW_VAE, dtype=dtype, device=DEV, vae_kind="kl")
    pipe, frame = DepthCompletionPipeline(bundle), (96, 128)
    images, sparses = path_inputs(frame, 200)
    kw = dict(max_depth=120.0, steps=NARROW_STEPS, resolution=128, norm="const",
              closed_form=False)
    eh, ew = latent_size(frame, 128, bundle.vae.downsample_factor)
    want = expected_launches(bundle.unet_config, "kl", NARROW_VAE, (eh, ew), NARROW_STEPS,
                             dtype=dtype)
    torch.cuda.synchronize()
    reset_launches()  # just before the request
    dense, lat = pipe(images, sparses, **kw)
    torch.cuda.synchronize()
    got = launches()
    reset_launches()
    check_request(dense, lat, (1, *frame, 1), (1, eh, ew, 4))
    twin, _ = pipe.twin()(images, sparses, **kw)
    reset_launches()
    rms, mx = _range_diff(dense[0], twin[0])
    limits = FP32_DENSE_LIMITS if dtype == torch.float32 else CLI_LIMITS
    print(f"narrow KL request {tag} ({NARROW_STEPS} steps, {frame[0]}x{frame[1]}, graphs): "
          f"launches {({k: n for k, n in got.items() if n})}, vs its eager twin rms {rms:.3e} "
          f"max {mx:.3e} of 120 m")
    if got != want:
        raise AssertionError(f"narrow KL request {tag}: kernel launches {got} != {want}")
    check(f"narrow KL request {tag} vs its eager twin (rms)", rms, limits[0], "rms/120 m")
    check(f"narrow KL request {tag} vs its eager twin (max)", mx, limits[1], "max/120 m")
    return {"rms": rms, "max": mx}


def eager_epilogue(sched, opt, latents, g, out, t: int, num_steps: int) -> None:
    """The guided step's epilogue as the chain of eager ops the sampler ran
    before the fused kernel and the tensor-op optimizers: the ε-norm rescale
    of the latent gradient ``g`` (per sample), ``opt.step()`` (a
    ``make_optimizer`` optimizer; the affine's gradients, if any, already
    set) and the DDIM transition of the updated ``latents`` with the old
    UNet output ``out``, in place."""
    n = latents.shape[0]
    eps_norm = pred_epsilon(sched, out, t, latents).reshape(n, -1).float().norm(dim=1)
    g = g.float()
    g_norm = g.reshape(n, -1).norm(dim=1)
    latents.grad = g * (eps_norm / torch.clamp(g_norm, min=S.EPSILON)).reshape(n, 1, 1, 1)
    opt.step()
    new_lat, _ = ddim_step(sched, out, t, latents, num_steps)
    latents.copy_(new_lat)


def _eager_chain(sched, lat, m, v, count: int, lr: float):
    """``eager_epilogue`` on a copy of ``lat`` whose Adam state is (m, v)
    after ``count`` steps: → (the latent it updates, a function doing one
    step on given (g, out, t))."""
    p = lat.clone().requires_grad_(True)
    opt = make_optimizer("adam", p, [], lr)
    opt.state[p] = {"step": torch.tensor(float(count)), "exp_avg": m.clone(),
                    "exp_avg_sq": v.clone()}

    @torch.no_grad()
    def step(g, out, t):
        eager_epilogue(sched, opt, p, g, out, t, 50)

    return p, opt, step


def check_epilogue(n: int, v_pred: bool, timed: bool = True, reps: int = 100,
                   latent_hw: tuple[int, int] = (72, 96),
                   out_dtype: torch.dtype = torch.bfloat16) -> dict:
    """The fused epilogue at a latent shape (72x96 at res 768, 44x152 on the
    native path, 128x128 at res 1024: more than the kernel's cluster holds
    in registers), against its plain twin and against the eager chain it
    replaces, from Adam state after three steps (bias corrections and the
    moments all in play); the scalars are row 3 of the 50-step table on the
    card, read at a step index on the card. ``out_dtype``: the UNet
    output's (bf16, or fp32 at ``--precision fp32``)."""
    ptype = "v_prediction" if v_pred else "epsilon"
    sched = S.make_schedule(S.DDIMConfig(prediction_type=ptype))
    steps, count, lr = 50, 3, 0.05
    ts = S.make_timesteps(sched.config, steps)
    t = int(ts[count])
    # every step's row on the card, read at step index ``count``
    table = ge.epilogue_table(sched, ts, steps, DEV)
    idx = torch.full((1,), count, dtype=torch.int64, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(4242 + n + 10 * int(v_pred) + latent_hw[1])
    shape = (n, *latent_hw, 4)

    def rnd(scale=1.0):
        return torch.randn(shape, generator=gen, device=DEV) * scale

    # a raw latent gradient is small; the rescale brings it to ‖ε̂‖
    lat, g, out = rnd(), rnd(1e-3), rnd().to(out_dtype)
    m = rnd(0.3)
    v = m * m + 0.1 * torch.rand(shape, generator=gen, device=DEV)
    print(f"guidance epilogue N={n} {tuple(shape[1:])} {ptype} t={t} count={count} "
          f"out {fa.DTYPE_TAGS[out_dtype]}")
    got = [x.clone() for x in (lat, m, v)]
    ge.guidance_epilogue(got[0], g, out, got[1], got[2], table, idx, lr=lr, v_pred=v_pred)
    ref = ge.guidance_epilogue_plain(lat, g, out, m, v, table, idx, lr=lr, v_pred=v_pred)
    p, opt, chain = _eager_chain(sched, lat, m, v, count, lr)
    chain(g, out, t)
    st = opt.state[p]
    torch.cuda.synchronize()
    # fp32 throughout; the norms are sums of 27,648 (26,752 native; 65,536
    # at 128x128) squares per sample in another order, and the DDIM combine
    # rounds in another order (FMA): 1e-5 of the largest value is ~100 fp32
    # ulps
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
        got[0], g, out, got[1], got[2], table, idx, lr=lr, v_pred=v_pred), reps, 10)
    res["plain_ms"] = time_ms(lambda: ge.guidance_epilogue_plain(
        lat, g, out, m, v, table, idx, lr=lr, v_pred=v_pred), reps, 10)
    res["library_ms"] = time_ms(lambda: chain(g, out, t), reps, 10)
    k = g.numel()
    # reads lat, g, m, v (fp32) and out; writes lat, m, v; ~26 fp32
    # operations an element (two squares, ε̂, Adam, DDIM)
    res["bound_ms"], res["bound_by"] = bound(26.0 * k, k * (4 * 4 + out.element_size() + 3 * 4),
                                             PEAK_FP32_FLOPS)
    print(f"  guidance_epilogue N={n}: kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
          f"library_ms={res['library_ms']:.4f} (the eager chain) "
          f"bound_ms={res['bound_ms']:.5f} ({res['bound_by']})")
    return res


# The generic flash pair's head dims other than the paths' 64 and 512, each
# at a shape a UNet or VAE reaches it (d=128: a 640-channel stage at 5
# heads, 1728 rows; d=256: a KL VAE whose widest stage is 256, one head at
# 6912 rows; d=384: 768 channels at 2 heads) and at a ragged one, in bf16 and
# fp32; and their ring steps (P=4 shards of 432 rows)
HEAD_DIM_CASES = ((128, 1728, 5), (256, 6912, 1), (384, 1728, 2))
RING_STEP_HEADS = {128: 5, 256: 1, 384: 2, 512: 1}


def fp32_kernel_checks(runs: dict, ring_runs: dict) -> None:
    """Phase 2c: every kernel form that ``--precision fp32`` runs, and every
    head dim the JAX package sends to Pallas, against its plain twin on the
    card (the twins in fp32 with TF32 off; limits FP32_REL and FP32_LSE, or
    the bf16 kernels' own): the fp32 flash pair at the paths' shapes (S=6912,
    5 heads, d=64; S=6912, 1 head, d=512) and ragged; the generic pair at
    d=128, 256 and 384 in both dtypes; every ring step form (fp32 at the
    native path's 4x1672, d=64; the others at 4x432) and the ring's passes at
    d=64 fp32 and d=128 in both dtypes; the fp32 conv at TAESD's C=64 and the
    KL widths; the autograd Functions in fp32; the epilogue with an fp32
    ``out``. Each result joins ``runs`` (the kernels line) under its
    kernel's name."""
    fp32 = torch.float32
    t_phase = time.perf_counter()

    def add(results, into=runs):
        for nm, r in results.items():
            into.setdefault(nm, []).append(r)

    for sq, sk, heads, d, is_timed in (
        (6912, None, 5, 64, True),  # UNet stage 0 at 576x768
        (1728, None, 10, 64, True),  # stage 1
        (6900, None, 5, 64, False),  # ragged
        (1000, 2100, 5, 64, False),  # ragged, Sq != Sk
        (6912, None, 1, 512, True),  # KL VAE mid attention at 576x768
        (1000, 2100, 1, 512, False),
    ):
        add(check_flash(sq, sk, heads, is_timed, d=d, dtype=fp32))
    for d, s, heads in HEAD_DIM_CASES:
        for dtype in (torch.bfloat16, fp32):
            add(check_flash(s, None, heads, True, d=d, dtype=dtype))
            add(check_flash(1000, 2100, heads, False, d=d, dtype=dtype))
    add(check_ring_steps(6688, 5, 4, True, dtype=fp32))  # the native path's stage 0
    add(check_ring_steps(1672, 10, 4, False, dtype=fp32))  # stage 1
    add(check_ring_steps(114, 20, 2, False, dtype=fp32))  # the mid block at P=2: below a tile
    for d, heads in RING_STEP_HEADS.items():
        for dtype in (torch.bfloat16, fp32):
            add(check_ring_steps(1728, heads, 4, True, d=d, dtype=dtype))
    add(check_ring(6688, 5, 4, False, dtype=fp32), ring_runs)
    for dtype in (torch.bfloat16, fp32):
        add(check_ring(1728, 5, 4, False, d=128, dtype=dtype), ring_runs)
    for args, kw in (
        ((1, 576, 768), {}),  # TAESD, C=64
        ((1, 72, 96), {"timed": False}),
        ((2, 13, 37), {"timed": False}),  # H and W not tile multiples
        ((1, 576, 768, 128), {"relu": False}),  # KL decoder stage 3, encoder stage 0
        ((1, 576, 768, 256, 128), {"relu": False, "timed": False}),  # stage-3 entry
        ((1, 288, 384, 512, 256), {"relu": False}),  # stage-2 entry
        ((1, 288, 384, 256), {"relu": False, "timed": False}),  # stage 2
        ((1, 288, 384, 128, 256), {"relu": False, "timed": False}),  # encoder stage-1 entry
        ((1, 144, 192, 256, 512), {"relu": False, "timed": False}),  # encoder stage-2 entry
        ((1, 144, 192, 512), {"relu": False, "timed": False}),  # stage 1
        ((1, 72, 96, 512), {"relu": False, "timed": False}),  # mid and stage 0
        ((2, 13, 37, 256, 128), {"relu": False, "timed": False}),  # ragged, cin != cout
        ((1, 88, 304), {"timed": False}),  # the native path's decoder widths
        ((1, 352, 1216), {}),  # its last Block, timed (PERF.md's native row)
        ((1, 352, 1216, 64, 64), {"relu": False, "timed": False}),
    ):
        runs.setdefault("conv3x3_fp32", []).append(check_conv(*args, dtype=fp32, **kw))
    check_autograd(fp32)
    check_narrow_decode(fp32)
    check_narrow_request(fp32)
    for n, v_pred, hw in ((1, True, (72, 96)), (8, False, (72, 96)), (1, True, (44, 152))):
        check_epilogue(n, v_pred=v_pred, timed=False, latent_hw=hw, out_dtype=fp32)
    print(f"phase 2c took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 2b: the probes of the flash kernel's inner loop (depth_completion_tpu_torch.probes)
# ---------------------------------------------------------------------------

def check_block_step() -> dict:
    """9a: each mode of each design (``fo.DESIGNS``: the first flash
    kernel's WMMA block step and the redesigned kernel's ``mma.sync`` one),
    one block per SM, ``fo.STEPS`` steps, against the twin. full and dots:
    the accumulator is STEPS times one tile's p·v (α = 1 after the first
    step) summed in another order, p rounds to bf16
    on both sides from scores that may differ in the last fp32 bit, and o
    rounds to bf16: the flash kernels' o tolerance. softmax: no products;
    the faked scores make every p an exact power of two (1, or 2^-64 once
    the running max runs ahead of l), so both sides sum the same values in
    the same order: exact."""
    q, k, v = fo.inputs(DEV, seed=5)
    print(f"probe block_step: {q.shape[0]} blocks x [{fo.BR}, {fo.D}] bf16, {fo.STEPS} steps")
    errs = []
    for mode in fo.MODES:
        ref = fo.block_step_plain(q, k, v, mode)
        for design in fo.DESIGNS:
            o = fo.block_step(q, k, v, mode, design=design)
            if mode == "softmax":
                errs.append(max_err(o, ref))
                check(f"probe block_step {design} softmax (exact)", errs[-1], 0.0)
            else:
                errs.append(check_elementwise(f"probe block_step {design} {mode}", o, ref,
                                              2**-7, 2**-8))
    return {"max_abs_err": max(errs), "blocks": q.shape[0],
            "plain_ms": time_ms(lambda: fo.block_step_plain(q, k, v, "full"), 3, 1)}


def check_twostream(sq: int, sk: int | None = None, heads: int = 5, timed: bool = False) -> dict:
    """9b: the two-stream flash forward against the plain forward, with the
    flash kernels' tolerances (the same function, the same roundings)."""
    sk = sq if sk is None else sk
    gen = torch.Generator(device=DEV).manual_seed(sq * 13 + sk)

    def rnd(n):
        return torch.randn((1, n, heads * 64), generator=gen, device=DEV).to(torch.bfloat16)

    q, k, v = rnd(sq), rnd(sk), rnd(sk)
    print(f"probe flash_fwd_twostream heads={heads} Sq={sq} Sk={sk} d=64 bf16")
    o, lse2 = fts.flash_fwd_twostream(q, k, v, heads)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, heads)
    err = check_elementwise("flash_fwd_twostream o", o, o_ref, 2**-7, 2**-8)
    check("flash_fwd_twostream o rel-norm",
          float((o.float() - o_ref.float()).norm() / o_ref.float().norm()), 2**-8,
          "|o-o_ref|/|o_ref|")
    check("flash_fwd_twostream lse2", max_err(lse2, lse_ref), 1e-4)
    out = {"max_abs_err": err}
    if timed:
        qh, kh, vh = (t.view(1, -1, heads, 64).transpose(1, 2) for t in (q, k, v))
        out["plain_ms"] = time_ms(lambda: fa.flash_fwd_plain(q, k, v, heads), 3, 1)
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            out["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
        out["bound_ms"], out["bound_by"] = bound(
            4.0 * sq * sk * 64 * heads, 2 * (2 * q.numel() + 2 * k.numel()) + 4 * sq * heads)
        out["bound_ms"] = max(out["bound_ms"], exp_bound_ms(float(sq) * sk * heads))
    return out


def check_mma_n64() -> dict:
    """9c: each variant at the script's shapes against its twin (bf16 of
    fp32 sums of the same products in another order: one bf16 ulp, 2^-7 of
    the element, plus 2^-12 of the largest for the fp32 order) and against
    the function it computes (p·v per head; do^T·p for E) at 2^-7 of that
    function's largest magnitude: C's bf16 p_sum and p_diff move it by
    ~2^-9, a variant off by any factor or term by far more. → per variant:
    max_abs_err, plain_ms, library_ms (``torch.bmm`` of the same operands,
    each product once: 1/R of the kernel's products; C: two calls),
    bound_ms, bound_by."""
    xs = n64.inputs(DEV, seed=3)
    ops = n64.make_operands(*xs)
    print(f"probe mma_n64: PAIRS={n64.PAIRS} bq={n64.BQ} bk={n64.BK} d={n64.D} R={n64.R} bf16")
    res = {}
    for name in n64.VARIANTS:
        a, b, a2, b2, trans_a, scale = ops[name]

        def twin(a=a, b=b, a2=a2, b2=b2, trans_a=trans_a, scale=scale):
            return n64.products_plain(a, b, a2, b2, repeats=n64.R, scale=scale / n64.R,
                                      trans_a=trans_a)

        def library(a=a, b=b, a2=a2, b2=b2, trans_a=trans_a):
            out = torch.bmm(a.transpose(1, 2) if trans_a else a, b)
            return out if a2 is None else torch.baddbmm(out, a2, b2)

        out = n64.run_variant(ops, name)
        r = {"max_abs_err": check_elementwise(f"probe mma_n64 {name} vs twin", out, twin(),
                                              2**-7, 2**-12)}
        fn = n64.reference(name, *xs)
        check(f"probe mma_n64 {name} vs the function",
              max_err(n64.as_heads(name, out), fn) / float(fn.abs().max()), 2**-7,
              "max|err|/max|ref|")
        r["plain_ms"] = time_ms(twin, 3, 1)
        r["library_ms"] = time_ms(library)
        nbytes = 2 * (sum(x.numel() for x in (a, b, a2, b2) if x is not None) + out.numel())
        r["bound_ms"], r["bound_by"] = bound(n64.flops(name), nbytes)
        res[name] = r
    return res


def check_packed_pv() -> dict:
    """9d: each variant, one block per SM over copies of one product on
    shared tiles, against its twin: one bf16 ulp as in 9c, and a floor for
    the kernel's 8,192 fp32 adds per element (16 chunks x 512 repeats),
    which drift by up to 8192 half-ulps, 2^-12 of the largest sum, where the
    roundings lean one way; with the bf16 rounding of both sides, 2^-10. →
    per variant as ``check_mma_n64`` (library: one ``torch.bmm`` of the
    expanded operands, each product once)."""
    copies = ppv.copies_for(DEV)
    res = {}
    for name, (n_out, bk, mult) in ppv.VARIANTS.items():
        p, v = ppv.inputs(DEV, n_out, bk, seed=7)
        steps = mult * ppv.N_STEPS
        print(f"probe packed_pv {name}: {copies} copies of [{ppv.BQ},{bk}]x[{bk},{n_out}] "
              f"x{steps} bf16")
        out = ppv.resident_products(p, v, steps, copies)
        ref = ppv.resident_products_plain(p, v, steps, copies)
        r = {"max_abs_err": check_elementwise(f"probe packed_pv {name} vs twin", out, ref,
                                              2**-7, 2**-10)}
        r["plain_ms"] = time_ms(lambda: ppv.resident_products_plain(p, v, steps, copies), 3, 1)
        pe, ve = p.expand(copies, *p.shape), v.expand(copies, *v.shape)
        r["library_ms"] = time_ms(lambda: torch.bmm(pe, ve))
        r["bound_ms"], r["bound_by"] = bound(ppv.flops(name, copies=copies),
                                             2 * (p.numel() + v.numel() + out.numel()))
        res[name] = r
    return res


def probe_phase() -> tuple[list, list]:
    """Phase 2b: every probe kernel against its twin at the probes' shapes;
    then each probe's own run (``run(DEV)``, the launches counted from 0),
    its verdict, and its readings beside bound, plain and library times. →
    (the probes line, the probe kernels' kernels-line entries)."""
    block = check_block_step()
    twostream = [check_twostream(7168, timed=True), check_twostream(6912, timed=True),
                 check_twostream(6900), check_twostream(1000, 2100)]
    mma = check_mma_n64()
    packed = check_packed_pv()

    reset_launches()  # just before the probes' runs
    runs = {"flash_overlap": fo.run(DEV), "flash_twostream": fts.run(DEV),
            "mma_n64": n64.run(DEV), "packed_pv": ppv.run(DEV)}
    counts = launches()  # just after
    reset_launches()
    for name in PROBE_KERNELS:
        if counts[name] == 0:
            FAILURES.append(f"probe kernel {name} was not launched by its probe's run")
    print(f"  probe launches: { {k: counts[k] for k in PROBE_KERNELS} }")

    ov = runs["flash_overlap"]
    per_step = ov["blocks"] * 4.0 * fo.BR * fo.BR * fo.D  # QK and PV FLOP, all blocks
    exps = ov["blocks"] * float(fo.BR * fo.BR)
    ov["bound_us_per_step"] = {
        "full": max(bound(per_step, 0)[0], exp_bound_ms(exps)) * 1e3,
        "dots": bound(per_step, 0)[0] * 1e3, "softmax": exp_bound_ms(exps) * 1e3}
    ov["plain_ms"], ov["library_ms"] = block["plain_ms"], None  # no single library call
    ts = runs["flash_twostream"]
    for row, chk in zip(ts["rows"], twostream):
        row.update({k: chk[k] for k in ("plain_ms", "library_ms", "bound_ms")})
    for name in ("mma_n64", "packed_pv"):
        for v, r in (mma if name == "mma_n64" else packed).items():
            runs[name].setdefault("bound_ms", {})[v] = r["bound_ms"]
            runs[name].setdefault("plain_ms", {})[v] = r["plain_ms"]
            runs[name].setdefault("library_ms", {})[v] = r["library_ms"]
    for name, r in runs.items():
        print(f"  probe {name}: {r['verdict']}")
    b = ov["bound_us_per_step"]
    for design, d in ov["designs"].items():
        us = d["us_per_step"]
        print(f"  flash_overlap {design} ({ov['blocks']} blocks): full {us['full']:.4f} dots "
              f"{us['dots']:.4f} softmax {us['softmax']:.4f} us/step (bounds {b['full']:.4f} / "
              f"{b['dots']:.4f} / {b['softmax']:.4f}); dots+softmax "
              f"{d['dots_plus_softmax_us']:.4f}, max {d['max_dots_softmax_us']:.4f} -> "
              f"{d['verdict']}; plain full {ov['plain_ms']:.4f} ms; "
              "library: none (no single call does a block step)")
    for row in ts["rows"]:
        print(f"  flash_twostream S={row['s']}: single {row['single_ms']:.4f} twostream "
              f"{row['twostream_ms']:.4f} ms (x{row['speedup']:.3f}, max|diff| "
              f"{row['max_abs_diff']:.2e}) plain {row['plain_ms']:.4f} library "
              f"{row['library_ms']:.4f} (SDPA FLASH) bound {row['bound_ms']:.4f}")
    for name in ("mma_n64", "packed_pv"):
        r = runs[name]
        for v in r["ms"]:
            print(f"  {name} {v}: kernel_ms={r['ms'][v]:.4f} ({r['tflops_executed'][v]:.1f} "
                  f"TFLOP/s) plain_ms={r['plain_ms'][v]:.4f} library_ms={r['library_ms'][v]:.4f} "
                  f"(torch.bmm) bound_ms={r['bound_ms'][v]:.4f}")

    full_ms = ov["designs"]["mma"]["ms"]["full"]  # the design flash_fwd now runs
    rows7168 = ts["rows"][0]
    readings = {  # per kernel: max_abs_err, ms, plain_ms, bound_ms, bound_by, library_ms
        "probe_block_step": (block["max_abs_err"], full_ms, ov["plain_ms"],
                             b["full"] * fo.STEPS / 1e3, "operations", None),
        "flash_fwd_twostream": (max(x["max_abs_err"] for x in twostream),
                                rows7168["twostream_ms"], rows7168["plain_ms"],
                                rows7168["bound_ms"], "operations", rows7168["library_ms"]),
        "probe_mma_n64": (max(x["max_abs_err"] for x in mma.values()), runs["mma_n64"]["ms"]["A"],
                          mma["A"]["plain_ms"], mma["A"]["bound_ms"], mma["A"]["bound_by"],
                          mma["A"]["library_ms"]),
        "probe_packed_pv": (max(x["max_abs_err"] for x in packed.values()),
                            runs["packed_pv"]["ms"]["A"], packed["A"]["plain_ms"],
                            packed["A"]["bound_ms"], packed["A"]["bound_by"],
                            packed["A"]["library_ms"]),
    }
    entries = []
    for name, (src, replaces) in PROBE_KERNELS.items():
        err, ms, plain, bnd, by, lib = readings[name]
        entries.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": counts[name], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain, "bound_ms": bnd, "bound_by": by, "library_ms": lib})
    return list(runs.values()), entries


# ---------------------------------------------------------------------------
# Phase 3: the guided paths
# ---------------------------------------------------------------------------

# What one run of each phase of a request's program launches, per request
# mode: (UNet forwards, UNet backwards, decoder forward-and-backward passes,
# encodes, final decodes, epilogues). Every mode's program has a prepare
# phase (the encode) and a finish phase (the final decode) besides these.
MODE_PHASES = {
    "per-step": {"step": (1, 1, 1, 0, 0, 1)},  # the fused Adam step
    "general": {"step": (1, 1, 1, 0, 0, 0)},  # SGD, Adagrad, Adam without the epilogue
    "fast_guidance": {"step": (1, 0, 1, 0, 0, 1)},
    "per-input": {"step": (1, 0, 0, 0, 0, 0), "train": (0, 0, 1, 0, 0, 0)},
    "forward": {"step": (1, 0, 0, 0, 0, 0)},  # no training: DDIM or LCM
}
EDGE_PHASES = {"prepare": (0, 0, 0, 1, 0, 0), "finish": (0, 0, 0, 0, 1, 0)}


def vae_kernel_convs(vae_kind: str, vae_cfg, dtype: torch.dtype) -> tuple[int, int]:
    """(per decode, per encode): the stride-1 3x3 convs of the decoder (TAESD's
    Blocks and up convs, the KL ResNets) and of the KL encoder that take the
    conv kernel, those whose widths ``ops.conv3x3.fits`` (the others run
    ``F.conv2d``), read from the config's widths."""
    if vae_kind == "tiny":
        c, blocks = vae_cfg.channels, vae_cfg.decoder_blocks
        return (3 * sum(blocks) + len(blocks) - 1) * c3.fits(dtype, c, c), 0
    chans, layers = vae_cfg.block_out_channels, vae_cfg.layers_per_block

    def resnets(cin, widths, per_stage):  # each ResNet: conv1 cin → c, conv2 c → c
        n = 0
        for c in widths:
            for _ in range(per_stage):
                n += c3.fits(dtype, cin, c) + c3.fits(dtype, c, c)
                cin = c
        return n

    mid = resnets(chans[-1], chans[-1:], 2)
    return (mid + resnets(chans[-1], chans[::-1], layers + 1),
            resnets(chans[0], chans, layers) + mid)


def expected_launches(unet_cfg, vae_kind: str, vae_cfg, latent_hw, steps: int,
                      ring_size: int | None = None, mode: str = "per-step",
                      train_steps: int = 0, remat: bool = False,
                      phase: str | None = None, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Kernel launches one request implies (JAX package routing:
    with a ring, UNet self-attention whose length divides the ring size
    takes the ring, which launches one ring step kernel per visiting block
    where the head dim is 64 or a multiple of 128 (elsewhere the step twins:
    none); other self-attention with S >= 768 and head dim 64 or a multiple
    of 128 takes a flash kernel; every stride-1 3x3 conv of a decoder, and of
    the KL encoder, for which ``ops.conv3x3.fits`` holds takes the conv
    kernel: ``vae_kernel_convs``). Each kernel counts under the
    name of its (``dtype``, head dim) form (``ops.flash_attention.
    launch_names``; ``conv3x3`` or ``conv3x3_fp32``). The batch does not
    count: every kernel takes it in one launch. ``mode`` (``MODE_PHASES``): "per-step" (a guided request
    with the fused epilogue: per step a UNet forward and backward, a decode
    forward and backward, the epilogue); "general" (the same without the
    epilogue: SGD, Adagrad, Adam with sample clipping); "fast_guidance" (a
    guided request whose UNet output is detached: per step a UNet forward
    without a graph, no UNet backward, a decode forward and backward, the
    epilogue); "per-input" (``steps`` UNet forwards, then ``train_steps``
    decode forward and backward passes); "forward" (no training, LCM or
    DDIM: ``steps`` UNet forwards); "step" and "step-remat" (one guided
    step's forward and backward alone, no encode, final decode or epilogue;
    with remat every flash forward of the UNet's checkpointed stages runs
    twice). A whole request adds the encode (prepare) and the final decode
    (finish); ``phase`` ("prepare", "step", "train", "finish"): one run of
    that phase of a ``mode`` request. ``remat``: the same second forward in
    every guided step."""
    eh, ew = latent_hw
    attn = []  # (sequence length, head dim, attention layers) per UNet stage and the mid block
    last = len(unet_cfg.block_out_channels) - 1
    for i in range(last + 1):
        h, w = eh, ew
        for _ in range(i):
            h, w = (h + 1) // 2, (w + 1) // 2
        d = unet_cfg.block_out_channels[i] // unet_cfg.num_heads[i]
        if unet_cfg.attention_stages[i]:
            attn.append((h * w, d, 2 * unet_cfg.layers_per_block + 1, True))
        if i == last:
            attn.append((h * w, d, 1, False))  # the mid block's transformer: not checkpointed
    if mode in ("step", "step-remat"):
        units = MODE_PHASES["general"]["step"]
        remat = remat or mode == "step-remat"
    else:
        table = {**EDGE_PHASES, **MODE_PHASES[mode]}
        runs = {"prepare": 1, "step": steps, "train": train_steps, "finish": 1}
        units = table[phase] if phase is not None else [
            sum(runs[p] * u[i] for p, u in table.items()) for i in range(6)]
    unet_fwd, unet_bwd, dec_bwd, encodes, decodes, epilogues = units
    out = {name: 0 for name in launches()}
    for s, d, layers, in_stage in attn:
        if d != 64 and d % 128:  # JAX's plain attention, and its XLA ring body
            continue
        if ring_size and s % ring_size == 0:  # one ring step launch per visiting block
            fwd, bwd = fa.launch_names(dtype, d, ring=True)
            out[fwd] += ring_size * layers * unet_fwd
            out[bwd] += ring_size * layers * unet_bwd
        elif s >= 768:
            fwd, bwd = fa.launch_names(dtype, d)
            out[fwd] += layers * unet_fwd + (layers * unet_bwd if remat and in_stage else 0)
            out[bwd] += layers * unet_bwd
    convs_per_decode, convs_per_encode = vae_kernel_convs(vae_kind, vae_cfg, dtype)
    d = vae_cfg.block_out_channels[-1] if vae_kind == "kl" else 0
    if eh * ew >= 768 and d and (d == 64 or d % 128 == 0):
        # the KL mid attention: one head at d = the widest stage
        fwd, bwd = fa.launch_names(dtype, d)
        out[fwd] += dec_bwd + encodes + decodes
        out[bwd] += dec_bwd
    # forward and dx of every decoder conv per trained decode; the encode;
    # the final decode
    out["conv3x3" if dtype == torch.bfloat16 else "conv3x3_fp32"] += (
        2 * convs_per_decode * dec_bwd + convs_per_encode * encodes + convs_per_decode * decodes)
    out["guidance_epilogue"] += epilogues
    return out  # no path launches a probe kernel


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
# Native path, ring against no ring (both through the flash kernels), as
# REF_LIMITS: the TAESD limits. Sound readings over the seeds (ring step
# kernels, NVIDIA H100 80GB HBM3, 700 W): loss rel <= 2.4e-6, affine rel
# <= 1.5e-3, cosine gap <= 3.4e-3; with each block's own o and lse2 in the
# ring's backward (F13) the cosine gap reads 0.43-0.44; with the last step's
# o left unnormalised (F14) loss rel reads 1.0e-3-1.2e-3, affine rel
# 0.60-0.74 and the cosine gap 0.94-0.95. The forward step without its
# rescale of the carried state (F11), dk|dv left one shard short of home
# (F12) and dk|dv stored over instead of added (F22, cosine gap 5.8e-3 to
# 7.2e-3) stay inside the limits: at random weights the near-uniform
# softmax passes little through the attention, and phase 2 holds all three
# (PERF.md, Findings).
RING_LIMITS = (2e-5, 1e-2, 1e-2)
# The fp32 reference step (--precision fp32): the fp32 kernels (3xTF32)
# against the plain versions on the same fp32 bundle, as REF_LIMITS: (loss
# rel, affine-grad rel, latent-grad cosine gap). The two runs differ only by
# each kernel's ~2^-21 relative error (FP32_REL's arithmetic) carried through
# the step: sound readings (TAESD and the d=128 UNet, two seeds, NVIDIA H100
# 80GB HBM3, 700 W) loss rel <= 6.1e-8 (one fp32 ulp of the loss), affine
# rel <= 4.6e-7, cosine gap <= 7.2e-6. One TF32 pass (F59: 2^-11 a product)
# reads affine rel 1.9e-5-5.3e-5 and a cosine gap of 8.2e-5-2.6e-4, while
# its loss still reads within an ulp or two (1.2e-7): the limits sit 10x and
# 4x above the sound readings and 3.8x and 2.7x below F59's; the loss limit
# only holds the loss to a few ulps (PERF.md, Findings).
FP32_REF_LIMITS = (1e-6, 5e-6, 3e-5)


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


@torch.no_grad()
def ddim_denoise(denoise, sched, cfg, lat):
    """Plain η=0 DDIM over the trailing timesteps, eagerly (the sampler's
    former no-training loop)."""
    for t in S.make_timesteps(cfg.ddim, cfg.steps):
        lat, _ = ddim_step(sched, denoise(lat, int(t)), int(t), lat, cfg.steps)
    return lat


def reference_step_check(bundle, bundle32, images, sparses, resolution: int = 768,
                         ring=None, options=(), per_input: bool = False,
                         label: str = "reference step", limits=None, tp_bundle=None,
                         seeds=REF_SEEDS) -> dict:
    """One guided step (t = the first timestep) on the path's inputs, with
    the path's sampler ``options``, for each of ``REF_SEEDS`` (the initial
    noise), three ways: the run under
    test, its bf16 reference, and the plain versions on an fp32 copy of the
    bundle. Without a ring, the run under test goes through the kernels and
    its reference through the plain versions; with ``ring``, the run under
    test takes the sampler's ring routing and its reference one flash call
    per attention layer (both through the kernels). The image latents come
    from one encode through the kernels, shared by the three (the KL
    encode is held on its own by ``encode_check``).

    Per-sample losses and the affine gradients (scalars) of the two bf16
    runs must agree to the path's loss and affine limits, relative. The
    latent gradient at random weights cancels heavily
    (tests/test_pipeline_parity.py tolerance model: two bf16 runs that
    round differently read cosines of 0.98-0.99 to each other), so it is
    held against the fp32 run: the tested run's cosine to it may fall short
    of the reference's by at most the path's cosine-gap limit.

    ``per_input``: one per-input training step in place of the guided step
    (``S.per_input_grads``: the loss of the latent's own decode, unclamped;
    no UNet), at the latent 4 DDIM steps from the seed's noise give (through
    the kernels, shared by the three runs), held to ``PER_INPUT_LIMITS``.
    ``limits`` replaces the path's limits (the peaked-softmax steps).
    ``tp_bundle``: the run under test is ``bundle`` tensor-parallel
    (``parallel.sharding.shard_bundle``), its reference ``bundle`` whole,
    both through the kernels, held to the path's limits. An fp32 ``bundle``
    (``--precision fp32``): the run under test through the fp32 kernels,
    its reference and the third run through the plain versions on it,
    ``FP32_REF_LIMITS``. ``seeds``: the noise seeds, ``REF_SEEDS`` by
    default.
    → the largest reading of each comparison over the seeds.
    """
    cfg = S.SamplerConfig(steps=50, resolution=resolution, norm="const", closed_form=False,
                          **dict(options))
    sched = S.make_schedule(cfg.ddim)
    t = int(S.make_timesteps(cfg.ddim, cfg.steps)[0])
    kernels = (bundle, fa.flash_attention, fa.flash_attention, c3.conv3x3_routed)
    fp32 = (bundle32, plain_attention, plain_attention, _plain_conv3x3_fused)
    if per_input:
        path_limits = PER_INPUT_LIMITS
        modes = {"kernel": kernels,
                 "plain": (bundle, plain_attention, plain_attention, _plain_conv3x3_fused),
                 "fp32": fp32}
    elif tp_bundle is not None:
        path_limits = REF_LIMITS[bundle.vae.kind]
        modes = {"tensor-parallel": (tp_bundle,) + kernels[1:], "whole": kernels, "fp32": fp32}
    elif ring is None:
        path_limits = FP32_REF_LIMITS if bundle.dtype == torch.float32 else \
            REF_LIMITS[bundle.vae.kind]
        modes = {"kernel": kernels,
                 "plain": (bundle, plain_attention, plain_attention, _plain_conv3x3_fused),
                 "fp32": fp32}
    else:
        path_limits = RING_LIMITS
        ring_attention = functools.partial(S.ring_or_base, ring, fa.flash_attention)
        modes = {"ring": (bundle, ring_attention) + kernels[2:], "no ring": kernels, "fp32": fp32}
    test, ref, _ = modes
    loss_lim, aff_lim, cos_lim = path_limits if limits is None else limits
    worst = {"loss_rel": 0.0, "affine_rel": 0.0, "cos_gap": -1.0}
    for seed in seeds:
        img_lat, lat0, dn, padding, orig_res = S._prepare(
            bundle, images, sparses, dataclasses.replace(cfg, seed=seed), None)
        if per_input:
            lat0 = ddim_denoise(S._Denoiser(bundle, img_lat, fa.flash_attention), sched,
                                dataclasses.replace(cfg, steps=4), lat0)
        results = []
        for bnd, unet_attention, attention_fn, conv_fn in modes.values():
            lat = lat0.clone().requires_grad_(True)
            aff = [torch.ones((1, 1, 1, 1), device=lat.device).requires_grad_(True),
                   torch.zeros((1, 1, 1, 1), device=lat.device).requires_grad_(True)]
            decode = functools.partial(S.decode_prediction, bnd, conv_fn=conv_fn,
                                       attention_fn=attention_fn)
            if per_input:
                losses, grads = S.per_input_grads(decode, cfg, dn, images, orig_res, padding,
                                                  False, lat, aff)
            else:
                losses, _, grads = S.guided_step_grads(
                    S._Denoiser(bnd, img_lat.to(bnd.dtype), unet_attention), decode,
                    sched, cfg, dn, images, orig_res, padding, False, lat, aff, t)
            results.append((losses, grads))
        (lk, gk), (lp, gp), (l32, g32) = results
        rel_loss = max_rel(lk, lp)
        rel32 = [max_rel(x, l32) for x in (lk, lp)]
        rel_aff = max(max_rel(a, b) for a, b in zip(gk[1:], gp[1:]))
        cos_kp, cos_k32, cos_p32 = cos(gk[0], gp[0]), cos(gk[0], g32[0]), cos(gp[0], g32[0])
        worst = {"loss_rel": max(worst["loss_rel"], rel_loss),
                 "affine_rel": max(worst["affine_rel"], rel_aff),
                 "cos_gap": max(worst["cos_gap"], cos_p32 - cos_k32)}
        print(f"  {label} seed={seed} t={t}: loss {lk.tolist()} vs {ref} {lp.tolist()}; "
              f"latent-grad cosine {test}-{ref} {cos_kp:.5f}, {test}-fp32 {cos_k32:.5f}, "
              f"{ref}-fp32 {cos_p32:.5f}; loss rel to fp32: {test} {rel32[0]:.2e}, "
              f"{ref} {rel32[1]:.2e}")
        check(f"{label} seed={seed} loss ({test} vs {ref})", rel_loss, loss_lim, "rel_err")
        check(f"{label} seed={seed} affine grads ({test} vs {ref})", rel_aff, aff_lim, "rel_err")
        check(f"{label} seed={seed} latent grad ({test} vs {ref})", cos_p32 - cos_k32,
              cos_lim, f"cos({ref},fp32)-cos({test},fp32)")
    return worst


@dataclasses.dataclass(frozen=True)
class GuidedPath:
    label: str
    vae_kind: str
    vae_config: object
    frame: tuple[int, int] = (480, 640)
    points: int = 500
    resolution: int = 768
    ring_size: int | None = None  # native-resolution mode: LocalRing(ring_size)
    options: tuple = ()  # further sampler options, (name, value) pairs


PATHS = (
    GuidedPath("TAESD_CONFIG (--vae light)", "tiny", registry.TAESD_CONFIG),
    GuidedPath("SD_VAE_CONFIG (--vae original)", "kl", registry.SD_VAE_CONFIG),
    GuidedPath("TAESD_CONFIG, KITTI native-res, ring P=4", "tiny", registry.TAESD_CONFIG,
               frame=(352, 1216), points=2000, resolution=1216, ring_size=4),
)


def path_inputs(frame: tuple[int, int], points: int, batch: int = 1, seed: int = 0):
    """``batch`` random RGB frames (0..255) and sparse maps of ``points``
    depths in [2, 80] m each, on the host: [B, H, W, 3], [B, H, W, 1]."""
    h, w = frame
    rng = torch.Generator(device="cpu").manual_seed(seed)
    images = torch.rand((batch, h, w, 3), generator=rng) * 255.0
    sparses = torch.zeros((batch, h * w))
    for b in range(batch):
        idx = torch.randperm(h * w, generator=rng)[:points]
        sparses[b, idx] = 2.0 + 78.0 * torch.rand(points, generator=rng)
    return images, sparses.reshape(batch, h, w, 1)


def check_request(dense, lat, shape, latent_shape) -> tuple[float, float]:
    """A request's outputs: the shapes, finite, metric depth inside [0, 120]
    m; → the depth range."""
    if tuple(dense.shape) != shape or (lat is not None and tuple(lat.shape) != latent_shape):
        raise AssertionError(f"bad output shapes {tuple(dense.shape)} "
                             f"{None if lat is None else tuple(lat.shape)}")
    if not (torch.isfinite(dense).all() and (lat is None or torch.isfinite(lat).all())):
        raise AssertionError("non-finite output")
    lo, hi = float(dense.min()), float(dense.max())
    if not (0.0 <= lo <= hi <= 120.0):
        raise AssertionError(f"dense depth outside the metric range [0, 120]: [{lo}, {hi}]")
    return lo, hi


# Phase 3 (a): the pipeline's graph against its eager twin on the same
# inputs, each comparison max|diff| / max|twin| over the final latent, the
# dense map and the program's other state (the latent's Adam v, Adagrad's
# sum, the affine). flash_bwd's float4 dq atomics make two eager runs
# differ, and the guidance's eps-norm rescale carries that through the
# steps, so the graph is held to GRAPH_SPREAD_FACTOR times the spread of
# the twin requests, or GRAPH_FLOOR where the spread is smaller. A request
# that finds the previous request's Adam v in its buffers reads O(1) on v
# (v keeps 0.999^50 = 95% of it over 50 steps).
# The spread is the largest distance between two twin requests. The
# distance of one pair is itself one draw: over a state of a number or two
# (the affine's scale and shift) a sound graph, a draw of the same
# distribution, lies past 4x one pair's distance about one time in seven
# (1 - (2/pi) atan(4) = 0.156 were the two distances independent). The
# floor covers that where the spread is far below it (TAESD's affine, 1e-5
# to 1e-4), not on the KL path, whose affine spread 3.1e-4 to 1.1e-3 in four
# runs at 50 steps, and below 2.5e-4 in a fifth, where the graph read
# 1.093e-3 against the floor (H100 80GB HBM3, 700 W). So where the first
# two twins leave any group past its limit, more twins run, up to
# GRAPH_TWINS: another twin can only widen the largest distance, so this
# decides as GRAPH_TWINS twins for every program would, and costs a twin
# request only where the first pair's spread is a low draw.
GRAPH_SPREAD_FACTOR, GRAPH_FLOOR, GRAPH_TWINS = 4.0, 1e-3, 4
GRAPH_TIMING_STEPS = 10  # (b): steps timed back to back, eager and graph
# Phase 3 (d): one step at a time from one state, the graph's replay against
# the eager step, at step indices 0, 1, N/2 and N-1, whatever the steps: the
# spread of two eager steps from one state does not grow with the steps, so
# these limits are fixed. Each reading is ||graph - eager|| / ||eager|| (L2)
# over the latent, Adam m, Adam v and the affine: an element whose gradient
# flips sign between two runs moves the latent by 2 lr at the first step,
# which a max-norm would read as O(lr / max|latent|) and an L2 norm spreads
# over the tensor. Readings at 50 steps on the four guided paths (H100 80GB
# HBM3, 700 W), sound / the step index not advanced before a replay: latent
# <= 5.2e-3 / >= 2.2e-2, Adam m and v <= 1.06e-2 / >= 0.23, the affine 0
# (its gradient takes no atomics) / >= 1.7e-3. Adagrad's sum of squared
# gradients takes Adam v's limit (the same squares, summed in place of
# averaged).
STEP_LIMITS = {"latent": 1.5e-2, "adam_m": 5e-2, "adam_v": 5e-2, "adagrad_sum": 5e-2,
               "affine": 1e-3}


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


def profile_step(run) -> dict:
    """Device ms (kernels, memsets and copies), device launches and the
    host's launch calls (runtime calls named ``cu*Launch*``) of ``run()``
    under ``torch.profiler``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    dev_us, device_launches, host_calls = 0.0, 0, 0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(evt, "self_device_time_total", None)
            t = getattr(evt, "self_cuda_time_total", 0.0) if t is None else t
            if t > 0:
                dev_us += t
                device_launches += evt.count
        elif evt.key.startswith("cu") and "Launch" in evt.key:
            host_calls += evt.count
    return {"device_ms": dev_us / 1e3, "device_launches": device_launches,
            "host_launch_calls": host_calls}


@torch.no_grad()
def step_timing(program, eager: bool, steps: int = GRAPH_TIMING_STEPS,
                name: str = "step", profile: bool = True) -> dict:
    """One run of ``program``'s phase ``name`` at a time (``step_eager``, or
    ``replay`` of its graph) at step indices 0, 1, ... (modulo the phase's
    count): ms per run by CUDA events over ``steps`` of them back to back
    (the host's pace where it is slower than the card), then, with
    ``profile``, one more under the profiler: device ms, device-busy share,
    launches."""
    step = program.step_eager if eager else program.replay
    count = dict(program.phases)[name]

    def run(k):
        step(k % count, name)

    run(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(steps):
        run(k)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    if not profile:
        return {"s_per_step": ms / 1e3}
    prof = profile_step(lambda: run(steps // 2))
    return {"s_per_step": ms / 1e3, **prof, "busy_share": prof["device_ms"] / ms}


INPUTS = ("images", "sparses", "noise", "prev", "mix")  # a program's request buffers


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.float().flatten() for t in tensors])


def _rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


@torch.no_grad()
def stepwise_check(label: str, graph, twin) -> dict:
    """Phase 3 (d): each step phase's graph one step at a time against its
    eager twin. The graph program takes the twin's request inputs and
    replays its prepare graph, and its state must then be the initial one
    exactly (optimizer state zero, the affine (1, 0)). Then, for each step
    phase (``graph.phases`` between prepare and finish) at step indices 0,
    1, N/2 and N-1, each from the graph program's current state: the twin
    program takes that state and runs ``step_eager(k)`` twice (the eager
    spread), the graph runs ``replay(k)``; each state group held to
    ``STEP_LIMITS``. → the readings."""
    for name in INPUTS:
        getattr(graph, name).copy_(getattr(twin, name))
    if hasattr(graph, "renoise"):  # LCM: the twin's request seed's re-noise
        graph.renoise.copy_(twin.renoise)
    graph.replay(0, "prepare")
    initial = 0.0
    for group, tensors in graph.state_groups(graph.phases[-2][0]).items():
        for t, init in zip(tensors, (1.0, 0.0) if group == "affine" else [0.0] * len(tensors)):
            if group != "latent":
                initial = max(initial, float((t - init).abs().max()))
    check(f"{label}: a request resets the state", initial, 0.0, "max|state - initial|")
    readings = {"reset_err": initial, "phases": {}}
    for name, n in graph.phases[1:-1]:
        groups = graph.state_groups(name)
        state = [t for ts in groups.values() for t in ts]
        twin_state = [t for ts in twin.state_groups(name).values() for t in ts]
        rows = {}
        for k in sorted({0, 1, n // 2, n - 1} & set(range(n))):
            start = [t.clone() for t in state]
            runs = []
            for _ in range(2):
                for dst, src in zip(twin_state, start):
                    dst.copy_(src)
                twin.step_eager(k, name)
                runs.append({g: _flat(ts).clone() for g, ts in twin.state_groups(name).items()})
            graph.replay(k, name)
            got = {g: _flat(ts) for g, ts in groups.items()}
            row = {}
            for what, ref in runs[0].items():
                diff, spread = _rel_l2(got[what], ref), _rel_l2(runs[1][what], ref)
                row[what] = {"graph_vs_eager": diff, "eager_spread": spread,
                             "max_rel": _rel(got[what], ref)}
                check(f"{label}: {name} {k} graph vs eager ({what}; eager vs eager "
                      f"{spread:.3e})", diff, STEP_LIMITS[what], "||diff||/||eager||")
            rows[k] = row
        readings["phases"][name] = rows
    torch.cuda.synchronize()
    return readings


def graph_check(label: str, pipe, images, sparses, kwargs: dict, latent_hw, expect) -> dict:
    """The graph checks of one program, after the pipeline's own requests of
    its signature: (a) two requests through ``pipe.twin()`` (fresh
    programs, every phase eager) and one through the pipeline's graphs on
    the same inputs, held as ``GRAPH_SPREAD_FACTOR`` says (more twin
    requests, up to ``GRAPH_TWINS``, where two leave a group past its
    limit); (b) eager and graph timing of every phase (``step_timing``: the
    prepare and finish steps, and each step phase), each capture's ms, its
    instantiation's ms, its pool growth and each request's peak; (c) each phase's capture's
    launch delta against one run of that phase (``expect(phase)``), and each
    request's launches against one request's (``expect()``); (d)
    ``stepwise_check``. → the readings."""
    n, h, w = images.shape[:3]
    eh, ew = latent_hw
    runs, readings = {}, {"requests": {}}

    def request(name: str) -> None:
        target = pipe if name == "graph" else pipe.twin()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        dense, lat = target(images, sparses, **kwargs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launches()
        reset_launches()
        if counts != expect():  # the graph's request: every phase replayed
            raise AssertionError(f"{label}: {name}'s launches {counts} != {expect()}")
        program = target.programs.find(images.shape)
        check_request(dense, lat, (n, h, w, 1), (n, eh, ew, 4))
        groups = program.state_groups(program.phases[-2][0])
        state = {g: _flat(ts).clone() for g, ts in groups.items() if g != "latent"}
        runs[name] = ({"latent": lat, "dense": dense, **state}, program)
        readings["requests"][name] = {"s": dt, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    for name in ("twin 1", "twin 2", "graph"):
        request(name)
    # the graph's dense map against its finish step run again, eagerly, on
    # the request's final state: the finish must decode the last step's
    # latent
    graph = runs["graph"][1]
    graph.step_eager(0, "finish")
    final = _rel(runs["graph"][0]["dense"], graph.dense)
    print(f"  (a) dense vs the finish rerun on the final state: {final:.3e} (limit {GRAPH_FLOOR})")
    check(f"{label}: the graph's dense map is the finish of its final state", final, GRAPH_FLOOR,
          "max|diff|/max|rerun|")
    readings["dense_vs_final_finish"] = final

    def spreads() -> dict:
        twins = [runs[k][0] for k in runs if k != "graph"]
        out = {}
        for what in runs["graph"][0]:
            spread = max(_rel(b[what], a[what]) for a, b in itertools.combinations(twins, 2))
            limit = max(GRAPH_SPREAD_FACTOR * spread, GRAPH_FLOOR)
            out[what] = {"graph_vs_twin": _rel(runs["graph"][0][what], twins[0][what]),
                         "twin_spread": spread, "limit": limit, "twins": len(twins),
                         "twin_spread_l2": _rel_l2(twins[1][what], twins[0][what])}
        return out

    out = spreads()
    while (any(r["graph_vs_twin"] > r["limit"] for r in out.values())
           and len(runs) - 1 < GRAPH_TWINS):
        more = f"twin {len(runs)}"
        print(f"  (a) the graph past a limit of {len(runs) - 1} twins: {more}")
        request(more)
        runs[more] = (runs[more][0], None)  # its outputs; its programs are let go
        out = spreads()
    for what, r in out.items():
        print(f"  (a) {what}: graph vs eager twin {r['graph_vs_twin']:.3e}, twin vs twin "
              f"{r['twin_spread']:.3e} (largest of {r['twins']} twins; max|diff|/max|twin|; "
              f"limit {r['limit']:.3e})")
        check(f"{label}: graph vs eager twin ({what})", r["graph_vs_twin"], r["limit"],
              "max|diff|/max|twin|")
    readings["graph_vs_twin"] = out
    graph, twin = runs["graph"][1], runs["twin 1"][1]
    if graph.tag != twin.tag or set(graph.graphs) != {p for p, _ in graph.phases}:
        raise AssertionError(f"{label}: the {graph.tag} program's graphs {sorted(graph.graphs)} "
                             f"are not its phases {graph.phases}")
    readings["program"] = graph.tag
    for phase, _ in graph.phases:
        want = {k: c for k, c in expect(phase).items() if c}
        print(f"  (c) {phase}: launches recorded at capture, added at every replay: "
              f"{graph.launch_delta[phase]}")
        if graph.launch_delta[phase] != want:
            raise AssertionError(f"{label}: the {phase} capture's launches "
                                 f"{graph.launch_delta[phase]} != one {phase}'s {want}")
    readings["launch_delta"] = graph.launch_delta
    readings["stepwise"] = stepwise_check(label, graph, twin)
    # the step phases under the profiler too; the prepare and finish steps,
    # once per request, by CUDA events alone
    profiled = {p: p not in ("prepare", "finish") for p, _ in graph.phases}
    readings["eager"] = {p: step_timing(twin, True, name=p, profile=profiled[p])
                         for p, _ in graph.phases}
    readings["graph"] = {p: {**step_timing(graph, False, name=p, profile=profiled[p]),
                             **graph.stats[p]} for p, _ in graph.phases}
    reset_launches()  # the timing's launches are no path's
    for phase, _ in graph.phases:
        e, g = readings["eager"][phase], readings["graph"][phase]
        device = (f", device {e['device_ms']:.2f} / {g['device_ms']:.2f} ms, busy "
                  f"{e['busy_share']:.1%} / {g['busy_share']:.1%}, host launch calls "
                  f"{e['host_launch_calls']} / {g['host_launch_calls']}"
                  if profiled[phase] else "")
        print(f"  (b) {phase}: eager {e['s_per_step'] * 1e3:.2f} ms / graph "
              f"{g['s_per_step'] * 1e3:.2f} ms per run (CUDA events over {GRAPH_TIMING_STEPS})"
              f"{device}; capture {g['capture_ms']:.1f} ms, instantiate "
              f"{g['instantiate_ms']:.1f} ms, pool growth {g['pool_growth_bytes'] / 2**30:.3f} GiB")
    print(f"  (b) request s and peak GiB {readings['requests']}")
    readings["card"] = card()
    return readings


def guided_path(path: GuidedPath, steps: int, bundle=None) -> tuple[dict, dict]:
    """Two guided requests through the pipeline on ``bundle`` (default: the
    seeded random bundle), launch counts checked per request; then the
    reference step. → (the path's launch counts, its readings: seconds per
    request, peak GiB, the reference step's largest readings)."""
    h, w = path.frame
    ring = ra.LocalRing(path.ring_size) if path.ring_size else None
    options = dict(path.options)
    print(f"guided path: MARIGOLD_UNET_CONFIG + {path.label} bf16, 2 requests x {steps} "
          f"guided steps, {h}x{w} frame, {path.points} sparse points, res {path.resolution}, "
          f"norm=const, learned affine{''.join(f', {k}={v}' for k, v in options.items())}")
    if bundle is None:
        t0 = time.perf_counter()
        bundle = make_random_bundle(
            seed=0, unet_config=registry.MARIGOLD_UNET_CONFIG, vae_config=path.vae_config,
            dtype=torch.bfloat16, device=DEV, vae_kind=path.vae_kind,
            text_config=registry.SD2_TEXT_CONFIG,
        )
        torch.cuda.synchronize()
        print(f"  bundle built in {time.perf_counter() - t0:.1f} s")
    pipe = DepthCompletionPipeline(bundle)
    eh, ew = latent_size(path.frame, path.resolution, bundle.vae.downsample_factor)
    images, sparses = path_inputs(path.frame, path.points)
    expected = expected_launches(registry.MARIGOLD_UNET_CONFIG, path.vae_kind, path.vae_config,
                                 (eh, ew), steps, path.ring_size)

    prev, before, seconds, peaks = None, {}, [], []
    reset_launches()  # just before the path: two requests
    for req in range(2):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense, lat = pipe(images, sparses, max_depth=120.0, steps=steps, norm="const",
                          closed_form=False, pred_latents_prev=prev,
                          resolution=path.resolution, ring_mesh=ring, **options)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        now = launches()
        counts = {k: now[k] - before.get(k, 0) for k in now}
        before = now
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        print(f"  request {req}: {seconds[-1]:.2f} s, {seconds[-1] / steps:.3f} s/step (incl. "
              f"encode and final decode), peak memory {peaks[-1]:.2f} GiB, launches {counts}")
        lo, hi = check_request(dense, lat, (1, h, w, 1), (1, eh, ew, 4))
        print(f"  request {req}: dense depth range [{lo:.3f}, {hi:.3f}] m")
        if counts != expected:
            raise AssertionError(f"kernel launches {counts} != expected {expected}")
        prev = lat
    totals = launches()  # read just after the path
    print(f"  path launches (2 requests): {totals}")
    reset_launches()
    program = pipe.programs.find(images.shape)
    for phase, st in program.stats.items():
        print(f"  {program.tag} program, {phase}: captured at request 0 in "
              f"{st['capture_ms']:.1f} ms, instantiated in {st['instantiate_ms']:.1f} ms, pool "
              f"growth {st['pool_growth_bytes'] / 2**30:.3f} GiB")

    def expect(phase=None):
        return expected_launches(registry.MARIGOLD_UNET_CONFIG, path.vae_kind, path.vae_config,
                                 (eh, ew), steps, path.ring_size, remat=program.remat,
                                 phase=phase)

    graphs = graph_check(path.label, pipe, images, sparses, dict(
        max_depth=120.0, steps=steps, norm="const", closed_form=False,
        resolution=path.resolution, ring_mesh=ring, **options), (eh, ew), expect)
    del pipe, program
    gc.collect()
    torch.cuda.empty_cache()
    bundle32 = fp32_bundle(bundle)
    if path.vae_kind == "kl":
        encode_check(bundle, bundle32, images.to(DEV))
    ref = reference_step_check(
        bundle, bundle32, images.to(DEV), sparses.to(DEV), path.resolution, ring, path.options,
        label="reference step" + "".join(f" {k}={v}" for k, v in options.items()))
    return totals, {"s_per_request": seconds, "peak_gib": max(peaks), "reference_step": ref,
                    "graph": graphs}


def checkpoint_bundle(root: Path, seed: int = 0):
    """Phase 3a: the seeded full-width trees (``make_random_params``: the
    Marigold UNet, TAESD, the SD2 text tower; bf16 on the card) written by
    ``scripts/make_synthetic_checkpoint_torch.py``'s ``write_checkpoint``
    (the port's exporters and safetensors writer, the published config
    JSONs) into an HF-layout directory under ``root`` (``marigold/``:
    ``unet/``, ``vae/`` (the writer's seeded float16 KL VAE, for phase 3b's
    ``--vae original``), ``text_encoder/``, ``scheduler/``; and
    ``taesd/``), then read back with ``load_bundle``. Every leaf of the
    loaded UNet, TAESD and text tower must equal its source bit for bit,
    the configs the registry's, and the context (the loaded tower's on the
    empty prompt) that of the source tower: [1, 2, 1024], finite. The
    directory stays for the later phases, which load it again. → (the
    loaded bundle, the model directory, the TAESD directory)."""
    print("checkpoint: MARIGOLD_UNET_CONFIG + TAESD_CONFIG + SD2_TEXT_CONFIG bf16, seed "
          f"{seed}, and the KL VAE (seeded float16), written in HF layout by write_checkpoint "
          "and loaded with load_bundle")
    bf16 = torch.bfloat16
    text_cfg = registry.text_config_from_transformers(synthetic.TEXT_ENCODER_CONFIG_JSON)
    params = make_random_params(seed, registry.MARIGOLD_UNET_CONFIG, "tiny",
                                registry.TAESD_CONFIG, text_cfg, bf16, DEV)
    with torch.no_grad():
        ctx_ref = clip_text.empty_prompt_context(params["text_encoder"], text_cfg)
    model_dir, taesd_dir = root / "marigold", root / "taesd"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = synthetic.write_checkpoint(
        model_dir, taesd_dir, seed=seed, log=lambda m: print(f"  {m}"), states={
            "unet": weights.to_diffusers_unet_state(params["unet"]),
            "text_encoder": weights.to_transformers_text_encoder_state(params["text_encoder"]),
            "taesd": weights.to_diffusers_taesd_state(params["vae"], registry.TAESD_CONFIG)})
    nbytes = sum(r["bytes"] for r in report.values())
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    bundle = load_bundle(model_dir, "tiny", taesd_dir, bf16, device=DEV)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    text = weights.load_text_encoder(model_dir / "text_encoder", text_cfg, bf16, DEV)
    print(f"  wrote {nbytes} bytes in {t_write:.2f} s; load_bundle in {t_load:.2f} s "
          "(the tower's context included)")
    if bundle.unet_config != registry.MARIGOLD_UNET_CONFIG or text_cfg != registry.SD2_TEXT_CONFIG \
            or bundle.vae.config != registry.TAESD_CONFIG or bundle.ddim_config != S.DDIMConfig():
        raise AssertionError(f"configs read back differ: {bundle.unet_config}, {text_cfg}, "
                             f"{bundle.vae.config}, {bundle.ddim_config}")
    for name, got, src in (("unet", bundle.unet_params, params["unet"]),
                           ("taesd", bundle.vae.params, params["vae"]),
                           ("text_encoder", text, params["text_encoder"])):
        g, r = weights._flatten(got), weights._flatten(src)
        if set(g) != set(r):
            raise AssertionError(f"checkpoint {name}: leaves {sorted(set(g) ^ set(r))[:4]}")
        bad = [p for p in r if g[p].dtype != r[p].dtype or not torch.equal(g[p], r[p])]
        print(f"  {name}: {len(r)} leaves, {sum(t.numel() for t in r.values())} parameters, "
              f"{len(bad)} differ")
        check(f"checkpoint {name} leaves bit-exact", len(bad), 0, "leaves differing")
    ctx = bundle.text_context
    if tuple(ctx.shape) != (1, 2, 1024) or ctx.dtype != bf16 or not torch.isfinite(ctx).all():
        raise AssertionError(f"bad context {tuple(ctx.shape)} {ctx.dtype}")
    check("checkpoint context vs the source tower's", max_err(ctx, ctx_ref), 0.0)
    del params, text
    return bundle, model_dir, taesd_dir


# Phase 3b: scripts/verify_checkpoint_torch.py, as a user runs it on the
# day the real weights arrive, on phase 3a's directory: its 2-step request
# at 128x160, res 128, with TAESD and with the KL VAE.
VERIFY_SCRIPT = Path(__file__).resolve().parent / "scripts" / "verify_checkpoint_torch.py"
VERIFY_FRAME, VERIFY_RES, VERIFY_STEPS = (128, 160), 128, 2


def verify_phase(model_dir: Path, taesd_dir: Path, precision: str = "bf16") -> dict:
    """Phase 3b: ``verify_checkpoint_torch.py`` in two processes at once on
    the card, ``--vae light`` (TAESD) and ``--vae original`` (the KL VAE
    phase 3a wrote): each must exit 0 and print OK, and the launches it
    printed must equal ``expected_launches`` of its request (its UNet's
    attention at 14x16 is below the flash kernels' 768, so conv3x3 and the
    epilogue launch; the KL path's convs at SD widths). ``precision``: its
    ``--precision`` (phase 5b runs it at fp32). → the ``verify`` line: per
    VAE, wall seconds, the launches and the output's summary."""
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    procs = {vae: subprocess.Popen(
        [sys.executable, str(VERIFY_SCRIPT), str(model_dir), "--taesd", str(taesd_dir), "--vae",
         vae, "--precision", precision], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for vae in ("light", "original")}
    t0 = time.perf_counter()
    result = {}
    try:
        for vae, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            wall = time.perf_counter() - t0
            lines = out.splitlines()
            print(f"verify --vae {vae} --precision {precision}: rc {proc.returncode} after "
                  f"{wall:.2f} s")
            print("\n".join("  " + line for line in lines))
            if proc.returncode != 0 or not lines or lines[-1] != "OK":
                raise AssertionError(f"verify --vae {vae} failed (rc {proc.returncode}):\n"
                                     + err[-3000:])
            got = json.loads(next(x for x in lines if x.startswith("launches "))[9:])
            kind, cfg = (("tiny", registry.TAESD_CONFIG) if vae == "light"
                         else ("kl", registry.SD_VAE_CONFIG))
            hw = latent_size(VERIFY_FRAME, VERIFY_RES, 8)
            want = {k: n for k, n in expected_launches(registry.MARIGOLD_UNET_CONFIG, kind, cfg,
                                                       hw, VERIFY_STEPS, dtype=dtype).items()
                    if k not in PROBE_KERNELS}
            if got != want:
                raise AssertionError(f"verify --vae {vae}: launches {got} != {want}")
            result[vae] = {"s": wall, "launches": got,
                           "summary": next(x.strip() for x in lines if "smoke step" in x)}
    finally:  # none outlives the phase, also when one fails
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return result


# Phase 4: the predict and analyze CLIs on the checkpoint directory
# Check (d): the arrays the CLI hands DepthCompletionPipeline must equal
# the generated image and 120·v/255 m sparse map, computed here without
# the port's IO (limit CLI_INPUT_LIMIT, in 0..255 and metres), and its
# frame 0 must agree with the pipeline called directly on the same weights
# and arrays (rms and max of the difference over the 120 m range). Two
# sound runs differ: flash_bwd adds dq with atomics, and 50 guided steps
# carry the difference (sound, NVIDIA H100 80GB HBM3, 700 W: rms 4.2e-4 to
# 4.4e-4, max 2.5e-2 to 2.7e-2 at 50 steps; 2.3e-5, 4.8e-4 at 2). At random
# weights the dense map barely depends on the image's channel order or the
# sparse scale: at 2 steps the planted faults F26 (the CLI's to_depth
# scaled by 255/max_sparse_depth) and F27 (the PNG decoder handing over
# BGR) of scripts/chip_smoke_faults.sh read rms 5.4e-5 and 4.7e-5, inside
# the sound 50-step noise; the input comparison catches both (PERF.md,
# Findings).
CLI_LIMITS = (5e-3, 0.2)
CLI_INPUT_LIMIT = 1e-5
CLI_FRAMES, CLI_FRAME, CLI_POINTS = 3, (480, 640), 500


def cli_dataset(root: Path, seed: int = 0, frames: int = CLI_FRAMES,
                frame: tuple[int, int] = CLI_FRAME, points: int = CLI_POINTS):
    """``scene/image/*.png`` (random RGB) and ``scene/sparse/*.png`` (8-bit
    grey, ``points`` points of 1..255 = 120·v/255 m), written with the
    port's PNG writer. → (the dataset root, the generated images and sparse
    bytes, [F, H, W, 3] and [F, H, W] uint8)."""
    rng = np.random.default_rng(seed)
    h, w = frame
    imgs = rng.integers(0, 256, (frames, h, w, 3), dtype=np.uint8)
    sparse = np.zeros((frames, h * w), np.uint8)
    for f in range(frames):
        idx = rng.choice(h * w, points, replace=False)
        sparse[f, idx] = rng.integers(1, 256, points)
    sparse = sparse.reshape(frames, h, w)
    for sub, arrays in (("image", imgs), ("sparse", sparse)):
        (root / "scene" / sub).mkdir(parents=True)
        for f, arr in enumerate(arrays):
            png.write_png(arr, root / "scene" / sub / f"{f:05d}.png")
    return root, imgs, sparse


@contextlib.contextmanager
def spy_pipeline():
    """Records what the CLI hands ``DepthCompletionPipeline``, per request:
    (images, sparses) as float32 arrays, the call's other arguments
    (positional, keyword), and the dense maps it returned (float32 on the
    host, as the CLI saves them)."""
    fed = []
    call = DepthCompletionPipeline.__call__

    def spy(self, images, sparses, *args, **kwargs):
        entry = (np.array(images, np.float32), np.array(sparses, np.float32), args, kwargs)
        out = call(self, images, sparses, *args, **kwargs)
        fed.append((*entry, out[0].float().cpu().numpy()))
        return out

    DepthCompletionPipeline.__call__ = spy
    try:
        yield fed
    finally:
        DepthCompletionPipeline.__call__ = call


def cli_phase(model_dir: Path, taesd_dir: Path, root: Path, steps: int) -> dict:
    """The predict CLI in process, with its defaults (res 768, bf16,
    ``--vae light``, dcz, vis grids, batch 1) and the smoke's ``--steps``,
    over a 3-frame 480x640 dataset, loading the checkpoint directory of
    phase 3a; (a) three dense maps (480, 640, 1), float32, finite, in
    [0, 120]; (b) three vis grids whose JPEG size is 2039x512 (the grid of
    three 480x640 views resized to height 512); (c) the kernel launches of
    the run three times one request's; (d) the arrays the CLI hands the
    pipeline equal to the generated ones, and frame 0 within
    ``CLI_LIMITS`` of ``DepthCompletionPipeline`` on the same directory's
    bundle (``load_bundle``, bit-exact to its source in phase 3a) called
    directly with those arrays. Then
    ``--resume true`` skips every frame and launches nothing, and the
    analyze CLI scores the outputs. → the ``cli`` line."""
    h, w = CLI_FRAME
    print(f"cli: predict over {CLI_FRAMES} frames of {h}x{w} ({CLI_POINTS} points), "
          f"{steps} steps, res 768, bf16, --vae light, dcz, vis, on the checkpoint directory")
    data, imgs, sparse = cli_dataset(root / "data")
    out = root / "out"
    argv = [str(data), str(out), "--checkpoint-dir", str(model_dir), "--taesd-dir",
            str(taesd_dir), "--steps", str(steps), "--log-level", "WARNING"]
    with spy_pipeline() as fed:
        reset_launches()  # just before the CLI run
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        totals = predict_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()  # just after
    frames = totals["frames"]
    print(f"  {frames} frames in {wall:.2f} s (the checkpoint load included): {totals}")
    denses = sorted((out / "scene" / "dense").glob("*.dcz"))
    if len(denses) != CLI_FRAMES or frames != CLI_FRAMES:
        raise AssertionError(f"(a) {len(denses)} dense files, {frames} frames written")
    dense = [codecs.load_array(p) for p in denses]
    for p, d in zip(denses, dense):
        if d.shape != (h, w, 1) or d.dtype != np.float32 or not np.isfinite(d).all() \
                or d.min() < 0.0 or d.max() > 120.0:
            raise AssertionError(f"(a) {p.name}: {d.shape} {d.dtype} [{d.min()}, {d.max()}]")
    grid_w = int(512 * (3 * w + 8) / (h + 4))
    for p in sorted((out / "scene" / "vis").glob("*_vis.jpg")):
        if image.image_size(p) != (grid_w, 512):
            raise AssertionError(f"(b) {p.name}: {image.image_size(p)} != {(grid_w, 512)}")
    if len(list((out / "scene" / "vis").glob("*_vis.jpg"))) != CLI_FRAMES:
        raise AssertionError("(b) vis grids missing")
    bundle = load_bundle(model_dir, "tiny", taesd_dir, torch.bfloat16, device=DEV)
    eh, ew = latent_size(CLI_FRAME, 768, bundle.vae.downsample_factor)
    one = expected_launches(registry.MARIGOLD_UNET_CONFIG, "tiny", registry.TAESD_CONFIG,
                            (eh, ew), steps)
    print(f"  launches {counts}")
    if counts != {k: CLI_FRAMES * n for k, n in one.items()}:
        raise AssertionError(f"(c) kernel launches {counts} != {CLI_FRAMES} x {one}")

    want_imgs = imgs.astype(np.float32)
    want_sparse = 120.0 * (sparse[..., None].astype(np.float32) / 255.0)
    if len(fed) != CLI_FRAMES or any(x.shape != (1, h, w, 3) or y.shape != (1, h, w, 1)
                                     for x, y, *_ in fed):
        raise AssertionError(f"(d) the pipeline was fed {[(x[0].shape, x[1].shape) for x in fed]}")
    err_img = max(float(np.abs(x[0] - want_imgs[f]).max()) for f, (x, *_) in enumerate(fed))
    err_sparse = max(float(np.abs(y[0] - want_sparse[f]).max())
                     for f, (_, y, *_) in enumerate(fed))
    print(f"  (d) the CLI's pipeline inputs against the generated arrays: image max "
          f"{err_img:.3e}, sparse max {err_sparse:.3e} m")
    check("cli pipeline input: image", err_img, CLI_INPUT_LIMIT)
    check("cli pipeline input: sparse depth", err_sparse, CLI_INPUT_LIMIT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct, _ = DepthCompletionPipeline(bundle)(
        want_imgs[:1], want_sparse[:1], max_depth=120.0, steps=steps, norm="const",
        resolution=768)
    torch.cuda.synchronize()
    t_direct = time.perf_counter() - t0
    diff = (dense[0] - direct[0].float().cpu().numpy()) / 120.0
    rms, worst = float(np.sqrt(np.mean(diff**2))), float(np.abs(diff).max())
    print(f"  (d) frame 0 against the direct call ({t_direct:.2f} s): rms {rms:.3e}, max "
          f"{worst:.3e} of the 120 m range")
    check("cli frame 0 vs the direct pipeline call (rms)", rms, CLI_LIMITS[0], "rms/120 m")
    check("cli frame 0 vs the direct pipeline call (max)", worst, CLI_LIMITS[1], "max/120 m")

    reset_launches()
    again = predict_cli.main([*argv, "--resume", "true"])
    resumed = launches()
    if again["frames"] != 0 or any(resumed.values()):
        raise AssertionError(f"resume ran {again['frames']} frames, launches {resumed}")
    print("  --resume true: 0 frames, 0 launches")
    results = analyze_cli.main([str(data), str(out), "--log-level", "WARNING"])
    mae, rmse = results["overall"]["mae"], results["overall"]["rmse"]
    if not (math.isfinite(mae) and math.isfinite(rmse)) or len(results["binned"]) != 12:
        raise AssertionError(f"analyze: {results['overall']}, {len(results['binned'])} bins")
    print(f"  analyze: mae {mae:.4f} m, rmse {rmse:.4f} m, 12 bins")
    return {
        "frames": frames, "steps": steps, "wall_s_per_frame": wall / frames,
        "direct_call_s": t_direct,
        **{f"time/{k}_s_per_frame": totals[f"time_{k}"] / frames for k in ("io", "infer", "vis")},
        "png_decode_ms_per_frame": 1e3 * totals["time_decode"] / frames,
        "jpeg_encode_ms_per_frame": 1e3 * totals["time_jpeg"] / frames,
        "dense_bytes_per_frame": totals["dense_bytes"] / frames,
        "analyze_mae": mae, "cli_vs_direct_rms": rms, "cli_vs_direct_max": worst,
        "card": card(),
    }


# ---------------------------------------------------------------------------
# Phase 4b: the host IO of the main path (JPEG frames in, .bl2 dense maps out)
# ---------------------------------------------------------------------------

FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "torch_io"
# Round trip of the phase's frames through the port's JPEG encoder (q95,
# 4:2:0) and decoder: sinusoid scenes with seeded noise (sigma 6) read
# 33.26-33.27 dB at 480x640 and 352x1216 (the decode is bit-exact to
# libjpeg-turbo, so the figure is the host's on any machine); a swapped
# channel order or a colour conversion off by its scale reads under 20 dB.
JPEG_PSNR_LIMIT = 32.0
HOST_IO_REPEATS = 10


def host_frames(seed: int, n: int, hw: tuple[int, int]) -> np.ndarray:
    """[n, H, W, 3] uint8 scenes: three sinusoids with seeded phases, plus
    seeded noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for _ in range(n):
        ph = rng.uniform(0, 2 * np.pi, 3)
        img = np.stack([127 + 100 * np.sin(xx / (23 + 7 * c) + yy / (31 + 5 * c) + ph[c])
                        for c in range(3)], -1)
        out.append(np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8))
    return np.stack(out)


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10 * math.log10(255.0**2 / mse) if mse else math.inf


def host_cpu() -> str:
    """The host CPU's model name as the kernel reports it, and the count."""
    import os
    import platform

    model = platform.processor() or "unknown"
    with contextlib.suppress(OSError):
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                model = line.split(":", 1)[1].strip()
                break
    return f"{model} ({os.cpu_count()} CPUs)"


def zstd_library() -> str:
    """The libzstd the ``.bl2`` codec loaded: its path (from the process's
    mappings) and version."""
    version = bl2.zstd_version()
    path = "libzstd.so.1"
    with contextlib.suppress(OSError):
        for line in Path("/proc/self/maps").read_text().splitlines():
            if "libzstd" in line:
                path = line.split()[-1]
                break
    return f"{path} {version}"


def median_ms(fn, reps: int = HOST_IO_REPEATS) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


BL2_CODECS, BL2_CLEVELS = ("blosclz", "lz4", "lz4hc", "zlib", "zstd"), (1, 5, 9)


def bl2_codec_table(dense: np.ndarray, root: Path) -> dict:
    """(f) Every ``.bl2`` codec the writer takes at clevel 1, 5 and 9 on one
    dense 480x640 map: written, read back bit-identical (byte for byte),
    save and load ms (median of 3) and the compression ratio, one line each.
    → {"codec/clevel": {"save_ms", "load_ms", "ratio"}}."""
    table, differ = {}, []
    path = root / "bl2_codec.bl2"
    for codec in BL2_CODECS:
        for clevel in BL2_CLEVELS:
            save_ms = median_ms(lambda: bl2.save_bl2(dense, path, clevel=clevel, codec=codec), 3)
            back = bl2.load_bl2(path)
            load_ms = median_ms(lambda: bl2.load_bl2(path), 3)
            if back.shape != dense.shape or back.tobytes() != dense.tobytes():
                differ.append(f"{codec}/{clevel}")
            ratio = dense.nbytes / path.stat().st_size
            table[f"{codec}/{clevel}"] = {"save_ms": save_ms, "load_ms": load_ms, "ratio": ratio}
            print(f"  (f) .bl2 {codec} clevel {clevel}: save {save_ms:.2f} ms, load "
                  f"{load_ms:.2f} ms, ratio {ratio:.3f}")
    check("host io (f) .bl2 every codec and clevel read back bit-identical (maps differing)",
          len(differ), 0, "maps")
    return table


def host_io_phase(model_dir: Path, taesd_dir: Path, root: Path, steps: int) -> dict:
    """The port's host IO on the main path: (a) every committed image
    fixture (``tests/data/torch_io/``: JPEG, PNG, GIF, BMP) decodes
    bit-exact to the cv2 decode recorded beside it, through this machine's
    g++ build of ``csrc/jpeg_decode.cpp``; then the predict CLI in process
    with its defaults and ``--compress bl2`` on the checkpoint directory
    of phase 3a over 3 frames of 480x640 written as JPEG by the port's
    encoder (q95, 4:2:0), with sparse PNGs of 500 points: (b) the frames
    it hands the pipeline equal ``load_img_array(path, "RGB")`` of each
    JPEG exactly, and lie within the encoder's round trip of the generated
    frames (``JPEG_PSNR_LIMIT``); (c) each dense ``.bl2`` loads back
    bit-identical to the map the pipeline returned for that frame; (d) the
    run's kernel launches are three times one request's; (e) host timings:
    JPEG decode ms per 480x640 and per 352x1216 frame, ``.bl2`` save and
    load ms and the compression ratio of one dense map, with the host CPU
    model and the libzstd loaded; (f) that map through every ``.bl2`` codec
    at clevel 1, 5 and 9 (``bl2_codec_table``). The fixtures of (a) include
    CMYK and YCCK JPEG, progressive JPEG cut after a few scans (libjpeg's
    block smoothing), RLE8, RLE4 and 16-bit BMP. → the ``host_io`` line."""
    names = sorted(p for p in FIXTURES.glob("*") if p.suffix != ".npy")
    if len(names) < 50:
        raise AssertionError(f"(a) {len(names)} image fixtures under {FIXTURES}")
    differ = []
    for p in names:
        want = np.load(p.with_suffix(".npy"))
        got = image.decode_image(p.read_bytes(), p.name)
        if got.shape != want.shape or got.dtype != want.dtype or not np.array_equal(got, want):
            differ.append(p.name)
    print(f"host io: (a) {len(names) - len(differ)} of {len(names)} fixtures bit-exact"
          + (f"; differ: {differ}" if differ else ""))
    check("host io (a) fixtures decoded bit-exact (files differing)", len(differ), 0, "files")

    h, w = CLI_FRAME
    data = root / "data_jpeg"
    frames = host_frames(1, CLI_FRAMES, CLI_FRAME)
    rng = np.random.default_rng(1)
    for sub in ("image", "sparse"):
        (data / "scene" / sub).mkdir(parents=True)
    for f in range(CLI_FRAMES):
        jpeg.write_jpeg(frames[f], data / "scene" / "image" / f"{f:05d}.jpg")
        sparse = np.zeros(h * w, np.uint8)
        sparse[rng.choice(h * w, CLI_POINTS, replace=False)] = rng.integers(1, 256, CLI_POINTS)
        png.write_png(sparse.reshape(h, w), data / "scene" / "sparse" / f"{f:05d}.png")
    out = root / "out_jpeg"
    argv = [str(data), str(out), "--checkpoint-dir", str(model_dir), "--taesd-dir",
            str(taesd_dir), "--steps", str(steps), "--compress", "bl2", "--log-level", "WARNING"]
    print(f"host io: predict over {CLI_FRAMES} JPEG frames of {h}x{w} ({CLI_POINTS} points), "
          f"{steps} steps, res 768, bf16, --vae light, --compress bl2")
    with spy_pipeline() as fed:
        reset_launches()  # just before the CLI run
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        totals = predict_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()  # just after
    print(f"  {totals['frames']} frames in {wall:.2f} s: {totals}")
    jpgs = sorted((data / "scene" / "image").glob("*.jpg"))
    denses = sorted((out / "scene" / "dense").glob("*.bl2"))
    if totals["frames"] != CLI_FRAMES or len(fed) != CLI_FRAMES or len(denses) != CLI_FRAMES:
        raise AssertionError(f"{totals['frames']} frames, {len(fed)} requests, "
                             f"{len(denses)} .bl2 files")

    bundle = load_bundle(model_dir, "tiny", taesd_dir, torch.bfloat16, device=DEV)
    eh, ew = latent_size(CLI_FRAME, 768, bundle.vae.downsample_factor)
    one = expected_launches(registry.MARIGOLD_UNET_CONFIG, "tiny", registry.TAESD_CONFIG,
                            (eh, ew), steps)
    del bundle
    print(f"  (d) launches {counts}")
    if counts != {k: CLI_FRAMES * n for k, n in one.items()}:
        raise AssertionError(f"(d) kernel launches {counts} != {CLI_FRAMES} x {one}")

    input_err, psnrs = 0.0, []
    for f, (p, entry) in enumerate(zip(jpgs, fed)):
        decoded = image.load_img_array(p, "RGB")
        input_err = max(input_err, float(np.abs(entry[0][0] - decoded.astype(np.float32)).max()))
        psnrs.append(psnr(decoded, frames[f]))
    print(f"  (b) pipeline input vs load_img_array: max {input_err:.3e}; round trip "
          f"{min(psnrs):.2f}-{max(psnrs):.2f} dB (limit {JPEG_PSNR_LIMIT} dB)")
    check("host io (b) pipeline input vs load_img_array of the JPEG", input_err, 0.0)
    check("host io (b) JPEG round trip of the generated frames (dB below the limit)",
          max(0.0, JPEG_PSNR_LIMIT - min(psnrs)), 0.0, "dB")

    differ_maps = []  # compared byte for byte: a garbled map may hold NaNs
    for p, entry in zip(denses, fed):
        got, want = codecs.load_array(p), entry[4][0]
        if got.shape != want.shape or got.dtype != want.dtype or got.tobytes() != want.tobytes():
            differ_maps.append(f"{p.name}: {got.shape} {got.dtype}")
    print(f"  (c) dense .bl2 loaded back against the pipeline's maps: "
          f"{CLI_FRAMES - len(differ_maps)} of {CLI_FRAMES} bit-identical"
          + (f"; differ: {differ_maps}" if differ_maps else ""))
    check("host io (c) dense .bl2 bit-identical to the pipeline's map (maps differing)",
          len(differ_maps), 0, "maps")

    data_640 = jpgs[0].read_bytes()
    wide = jpeg.encode_jpeg(host_frames(2, 1, (352, 1216))[0])
    dense = fed[0][4][0]
    tmp = root / "bl2_timing.bl2"
    save_ms = median_ms(lambda: codecs.save_array(dense, tmp, compress="bl2"))
    load_ms = median_ms(lambda: codecs.load_array(tmp))
    codec_table = bl2_codec_table(dense, root)
    result = {
        "frames": totals["frames"], "wall_s_per_frame": wall / totals["frames"],
        "fixtures": len(names), "fixtures_differing": len(differ),
        "input_max_err": input_err, "jpeg_psnr_db": min(psnrs),
        "bl2_maps_differing": len(differ_maps),
        "jpeg_decode_ms_480x640": median_ms(lambda: jpeg.decode_jpeg(data_640)),
        "jpeg_decode_ms_352x1216": median_ms(lambda: jpeg.decode_jpeg(wide)),
        "image_decode_ms_per_frame_cli": 1e3 * totals["time_decode"] / totals["frames"],
        "bl2_save_ms": save_ms, "bl2_load_ms": load_ms,
        "bl2_ratio": dense.nbytes / tmp.stat().st_size, "bl2_bytes": tmp.stat().st_size,
        "bl2_codecs": codec_table,
        "libzstd": zstd_library(), "host_cpu": host_cpu(), "card": card(),
    }
    print(f"  (e) JPEG decode {result['jpeg_decode_ms_480x640']:.2f} ms (480x640), "
          f"{result['jpeg_decode_ms_352x1216']:.2f} ms (352x1216); .bl2 save "
          f"{save_ms:.2f} ms, load {load_ms:.2f} ms, ratio {result['bl2_ratio']:.3f}; "
          f"{result['libzstd']}; host {result['host_cpu']}; {result['card']}")
    return result


# ---------------------------------------------------------------------------
# Phase 5: the sampler's other modes
# ---------------------------------------------------------------------------

# Per-input training step (``reference_step_check(per_input=True)``), as
# REF_LIMITS: (loss rel, affine-grad rel, latent-grad cosine gap). Sound
# readings over the seeds (NVIDIA H100 80GB HBM3, 700 W): loss rel <=
# 1.5e-6, affine rel <= 6.7e-3 (the unclamped decode's affine gradient sums
# every pixel's bf16 difference), cosine gap <= 2.3e-3 (PERF.md, PR 10).
PER_INPUT_LIMITS = (2e-5, 3e-2, 1e-2)
# LCM through the CLI against the same request through the plain versions
# (forward only: 4 UNet forwards, the decode), rms and max over the 120 m
# range: sound 5.0e-4 and 6.0e-3 (same card), limits 10x.
LCM_LIMITS = (5e-3, 6e-2)
# Remat against no remat, one guided step at batch 8: the losses (the same
# forward, rel), the affine grads (rel) and 1 - the latent grads' cosine
# (flash_bwd's dq atomics make two backward runs differ).
REMAT_LIMITS = (1e-6, REF_LIMITS["tiny"][1], REF_LIMITS["tiny"][2])
# The E=4 median of the ensemble's first four members against numpy's
# (which averages the two middle ones), m
MEDIAN_LIMIT = 1e-4
MODES_TRAIN_STEPS, LCM_STEPS, ENSEMBLE_SIZE, REMAT_BATCH = 10, 4, 5, 8
# remat through the step programs: a request of this many steps at batch 8
REMAT_PROGRAM_STEPS = 4
KL_REMAT_BATCHES = (1, 2, 4)
# sampler.STEP_PEAK_BYTES against this card: each measured peak at most
# this share above the committed estimate (the constants come from one
# such run; another card, CUDA release or PyTorch version moves the
# workspace a little)
STEP_PEAK_COVER = 1.05
# The peaked-softmax reference steps: the UNet's self-attention q and k
# projections scaled by PEAK_QK_SCALE each, so that a score's spread grows
# by its square (random weights: scores with a std of ~1/3, a near-uniform
# softmax over thousands of keys: a mean largest probability of 4.5e-4 in
# stage 0; scaled, 0.38); as REF_LIMITS, (loss rel, affine-grad rel,
# latent-grad cosine gap), kernels against the plain versions at the TAESD
# path's frames, and the ring against one flash call at the native path's.
# Sound readings over the seeds in three runs (NVIDIA H100 80GB HBM3, 700 W):
# loss rel <= 4.7e-6, affine rel <= 1.3e-3; cosine gap <= 2.0e-4 (kernels)
# and <= 1.3e-3 (ring). Under the planted faults of
# scripts/chip_smoke_faults.sh the least cosine gap over the seeds reads,
# kernels / ring: F2 (the backward skips key block 1) 1.1e-2 / 3.0e-2, F3
# (its dq drops block 1) 5.2e-3 / 1.1e-2, F20 (ds without di) 0.93 / -,
# F22 (the ring stores dk|dv over the travelling buffer) - / 0.28: the
# cosine-gap limits sit 10x and 3.8x above the sound readings and at least
# 2.3x below each of these (PERF.md, Findings).
PEAK_QK_SCALE = 4.0
PEAKED_LIMITS = (2e-5, 1e-2, 2e-3)
PEAKED_RING_LIMITS = (2e-5, 1e-2, 5e-3)


def peak_line(by_n: dict, pixels: int) -> tuple[float, float]:
    """(bytes per latent pixel, fixed bytes) through the end points of a
    {batch: peak GiB} row at ``pixels`` latent pixels a sample."""
    lo, hi = min(by_n), max(by_n)
    per_pixel = (by_n[hi] - by_n[lo]) * 2**30 / ((hi - lo) * pixels)
    return per_pixel, by_n[lo] * 2**30 - lo * per_pixel * pixels


@contextlib.contextmanager
def plain_decode():
    """The sampler's decodes through the plain conv and attention."""
    decode = S.decode_prediction
    S.decode_prediction = functools.partial(decode, conv_fn=_plain_conv3x3_fused,
                                            attention_fn=plain_attention)
    try:
        yield
    finally:
        S.decode_prediction = decode


def _range_diff(a, b) -> tuple[float, float]:
    """rms and max of (a - b) over the 120 m range."""
    d = (a.float().cpu() - b.float().cpu()) / 120.0
    return float(d.square().mean().sqrt()), float(d.abs().max())


def peaked_bundle(bundle):
    """``bundle`` with the q and k projections of every UNet self-attention
    scaled by ``PEAK_QK_SCALE`` (the other leaves shared)."""
    def scaled(tree, path=()):
        if isinstance(tree, dict):
            return {k: scaled(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [scaled(v, path + (i,)) for i, v in enumerate(tree)]
        if "attn1" in path and path[-2:] in (("to_q", "kernel"), ("to_k", "kernel")):
            return tree * PEAK_QK_SCALE
        return tree

    return dataclasses.replace(bundle, unet_params=scaled(bundle.unet_params))


def softmax_peak(bundle, images, sparses, resolution: int) -> float:
    """The mean, over 256 query rows of head 0, of the largest softmax
    probability in the UNet's first long self-attention (one forward at the
    first timestep, seed 2024's noise)."""
    cfg = S.SamplerConfig(resolution=resolution, norm="const")
    t = int(S.make_timesteps(cfg.ddim, cfg.steps)[0])
    img_lat, lat0, _, _, _ = S._prepare(bundle, images, sparses, cfg, None)
    stats = []

    def attention(q, k, v, heads):
        if not stats and q.shape[1] == k.shape[1] >= 768:
            d = q.shape[-1] // heads
            qs = q[0, :: q.shape[1] // 256, :d].float()
            p = (qs @ k[0, :, :d].float().T / math.sqrt(d)).softmax(-1)
            stats.append(float(p.amax(-1).mean()))
        return fa.flash_attention(q, k, v, heads)

    with torch.no_grad():
        S._Denoiser(bundle, img_lat, attention)(lat0, t)
    return stats[0]


def peaked_reference_steps(bundle, images, sparses) -> dict:
    """The reference step on ``peaked_bundle(bundle)``, where the attention
    backward matters to the gradient: kernels against the plain versions on
    the TAESD path's frames (``PEAKED_LIMITS``), and the ring (``LocalRing(4)``)
    against one flash call per layer on the native path's 352x1216 frames
    at res 1216 (``PEAKED_RING_LIMITS``). → the readings."""
    peaked = peaked_bundle(bundle)
    native = next(p for p in PATHS if p.ring_size)
    n_images, n_sparses = path_inputs(native.frame, native.points)
    images, sparses = images.to(DEV), sparses.to(DEV)
    n_images, n_sparses = n_images.to(DEV), n_sparses.to(DEV)
    peak = {"random": softmax_peak(bundle, images, sparses, 768),
            "scaled": softmax_peak(peaked, images, sparses, 768)}
    print(f"modes: peaked softmax (self-attention q, k x{PEAK_QK_SCALE}): mean largest "
          f"probability {peak['scaled']:.4f} (random weights: {peak['random']:.3e}) over 256 "
          "queries of the first stage-0 layer")
    peaked32 = fp32_bundle(peaked)
    ref = reference_step_check(peaked, peaked32, images, sparses, label="peaked reference step",
                               limits=PEAKED_LIMITS)
    ring = reference_step_check(peaked, peaked32, n_images, n_sparses, native.resolution,
                                ra.LocalRing(native.ring_size), label="peaked ring reference step",
                                limits=PEAKED_RING_LIMITS)
    return {"qk_scale": PEAK_QK_SCALE, "mean_max_p": peak, "reference_step": ref,
            "ring_reference_step": ring, "card": card()}


@torch.no_grad()
def former_request(bundle, images, sparses, cfg):
    """One request through the sampler's eager loops as they were before
    every branch had a program (``_prepare``; the no-training DDIM or LCM
    loop; the per-step steps with ``make_optimizer`` and ``eager_epilogue``;
    per-input training with ``make_optimizer``; the final decode) → (dense,
    latents). It holds what a program's graphs and their eager twin share:
    a fault in both (an optimizer row, the ε-norm rescale) shows only
    against it."""
    closed_form = cfg.resolved_closed_form()
    sched = S.make_schedule(cfg.ddim)
    img_lat, lat, dn, padding, orig_res = S._prepare(bundle, images, sparses, cfg, None)
    denoise = S._Denoiser(bundle, img_lat, fa.flash_attention)
    decode = functools.partial(S.decode_prediction, bundle)
    affine = []
    if cfg.scheduler == "lcm":
        ts = [int(t) for t in make_lcm_timesteps(cfg.ddim.num_train_timesteps, cfg.steps,
                                                 cfg.lcm)]
        key = prng.split(prng.PRNGKey(cfg.seed))[0]
        for i, t in enumerate(ts):
            key, sub = prng.split(key)
            last = i == len(ts) - 1
            lat, _ = lcm_step(sched, denoise(lat, t), t, -1 if last else ts[i + 1], lat, sub,
                              last, cfg.lcm)
    elif not cfg.train_latents:
        lat = ddim_denoise(denoise, sched, cfg, lat)
    else:
        n = images.shape[0]
        if not closed_form:
            affine = [torch.ones((n, 1, 1, 1), device=DEV).requires_grad_(True),
                      torch.zeros((n, 1, 1, 1), device=DEV).requires_grad_(True)]
        if cfg.train_method == "per-input":
            lat = ddim_denoise(denoise, sched, cfg, lat).requires_grad_(True)
            opt = make_optimizer(cfg.opt, lat, affine, cfg.lr_latent, cfg.lr_scaling)
            for _ in range(cfg.train_steps):
                _, grads = S.per_input_grads(decode, cfg, dn, images, orig_res, padding,
                                             closed_form, lat, affine)
                for p, g in zip([lat, *affine], grads):
                    p.grad = g
                opt.step()
        else:
            lat = lat.clone().requires_grad_(True)
            opt = make_optimizer(cfg.opt, lat, affine, cfg.lr_latent, cfg.lr_scaling)
            for t in S.make_timesteps(cfg.ddim, cfg.steps):
                _, out, grads = S.guided_step_grads(denoise, decode, sched, cfg, dn, images,
                                                    orig_res, padding, closed_form, lat,
                                                    affine, int(t))
                for p, g in zip(affine, grads[1:]):
                    p.grad = g
                eager_epilogue(sched, opt, lat, grads[0], out, int(t), cfg.steps)
        lat = lat.detach()
    dense = S.latent_to_affine(decode, lat, orig_res, padding, cfg.interp_mode)
    dense = torch.clamp(S._affine_to_metric(dense, dn, affine, closed_form), 0.0, 1.0)
    return S.denormalize_depth(dense, dn), lat


# (e): the former loop's optimizer is torch.optim's, whose CUDA kernels
# round Adam's division otherwise than the programs' tensor ops; where that
# flips the sign of an element's gradient (an L1 anchor at its value), the
# element moves by 2 lr a step, which a max-norm reads as O(lr / max|latent|)
# (per-input at 4 steps: 4.5e-3 of the largest latent, 1.1e-2 of the
# largest depth, against 0 between the graph and its twin). The request's
# latent is held in relative L2, with the latent step's limit as its floor;
# the dense map, which the decoder draws from the few such elements, reads
# 15x the latent's L2 (9.6e-3 against 6.2e-4) and is printed, not held.
FORMER_FLOOR = STEP_LIMITS["latent"]
# (f), per-input's train step: from one state the decode's backward is
# deterministic, so the graph's update and the former optimizer's differ by
# rounding alone; Adam's bias-correction row one step ahead changes the
# first update by 26%, the second by 14%.
FORMER_UPDATE_LIMIT = 1e-2


@torch.no_grad()
def former_step_check(label: str, program) -> dict:
    """(f) A program's graph one optimizer step at a time against the former
    eager step from the same state, a ``make_optimizer`` optimizer holding
    the program's optimizer state, at steps 0 and 1 of the request in the
    program's buffers (its prepare replayed first). General per-step (SGD,
    Adagrad, Adam without the epilogue): ``guided_step_grads`` at the host's
    t, then ``eager_epilogue`` (the rescale, the optimizer, the DDIM
    transition); the latent held to ``STEP_LIMITS`` (relative L2): SGD's
    step is the ε-norm-rescaled gradient times lr, 5% of the latent's norm.
    Per-input (after its denoise steps): ``per_input_grads``, then the
    optimizer; the update held to ``FORMER_UPDATE_LIMIT`` (relative L2).
    → the readings."""
    cfg, sched = program.cfg, program.sched
    per_input = program.tag == "per-input"
    phase = "train" if per_input else "step"
    program.replay(0, "prepare")
    if per_input:
        for k in range(program.steps):
            program.replay(k, "step")
    ts = S.make_timesteps(cfg.ddim, cfg.steps)
    rows = {}
    for k in (0, 1):
        before = program.latents.clone()
        lat = before.clone().requires_grad_(True)
        aff = [p.clone().requires_grad_(True) for p in program.affine]
        opt = make_optimizer(cfg.opt, lat, aff, cfg.lr_latent, cfg.lr_scaling)
        state = program.opt.state
        for i, p in enumerate([lat, *aff]):
            if cfg.opt == "adam":
                opt.state[p] = {"step": torch.tensor(float(k)),
                                "exp_avg": state["adam_m"][i].clone(),
                                "exp_avg_sq": state["adam_v"][i].clone()}
            elif cfg.opt == "adagrad":
                opt.state[p] = {"sum": state["adagrad_sum"][i].clone()}
        if per_input:
            _, grads = S.per_input_grads(program._decode, cfg, program.dn, program.images,
                                         program.orig_res, program.padding, program.closed_form,
                                         lat, aff)
            for p, g in zip([lat, *aff], grads):
                p.grad = g
            opt.step()
        else:
            t = int(ts[k])
            _, out, grads = S.guided_step_grads(
                program._denoise, program._decode, sched, cfg, program.dn, program.images,
                program.orig_res, program.padding, program.closed_form, lat, aff, t)
            for p, g in zip(aff, grads[1:]):
                p.grad = g
            eager_epilogue(sched, opt, lat, grads[0], out, t, cfg.steps)
        program.replay(k, phase)
        if per_input:
            what, limit = "the update", FORMER_UPDATE_LIMIT
            rows[k] = _rel_l2(program.latents - before, lat.detach() - before)
        else:
            what, limit = "latent", STEP_LIMITS["latent"]
            rows[k] = _rel_l2(program.latents, lat.detach())
        print(f"  (f) {phase} {k}: graph vs the former eager step ({what}) {rows[k]:.3e}")
        check(f"{label}: {phase} {k} graph vs the former eager step ({what})", rows[k], limit,
              "||diff||/||former||")
    return rows


# Phase 5's programs: the modes' requests, each through a fresh pipeline
# (its captures), then graph_check's. The per-step modes other than the
# fused one, no-training DDIM and per-input's denoise run at most this many
# steps: the fewest that give stepwise_check four distinct step indices
# (the readings per step do not depend on it; the smoke's time does).
# Per-input trains MODES_TRAIN_STEPS, LCM runs LCM_STEPS. LCM's second
# seed: graph_check runs it through the program that served the first,
# whose re-noise table must then be this seed's.
MODE_PROGRAM_STEPS, LCM_SECOND_SEED = 4, 7


def mode_program_check(label: str, bundle, images, sparses, kwargs: dict, mode: str,
                       latent_hw, train_steps: int = 0) -> dict:
    """One mode's program on the card (phase 5's ``programs`` line): the
    first request through a fresh pipeline (each phase's step 0 eager, its
    capture, its replays), its launches held to ``expected_launches(mode)``;
    ``graph_check`` at ``kwargs`` (LCM: at ``LCM_SECOND_SEED``, after a first
    request at the default seed); then (e) the graph's request against
    ``former_request``, the loop it replaced, over the latent (relative L2,
    ``GRAPH_SPREAD_FACTOR`` times (a)'s L2 spread or ``FORMER_FLOOR``); and
    for the general per-step modes and per-input (f) ``former_step_check``.
    → the readings."""
    pipe = DepthCompletionPipeline(bundle)
    first_kwargs = {k: v for k, v in kwargs.items() if k != "seed"}

    def expect(phase=None):
        return expected_launches(registry.MARIGOLD_UNET_CONFIG, bundle.vae.kind,
                                 registry.TAESD_CONFIG, latent_hw, kwargs["steps"], mode=mode,
                                 train_steps=train_steps, phase=phase)

    print(f"modes: {label} program ({mode}): {kwargs}")
    torch.cuda.synchronize()
    reset_launches()  # just before
    t0 = time.perf_counter()
    dense, lat = pipe(images, sparses, **first_kwargs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = launches()  # just after
    reset_launches()
    n, h, w = images.shape[:3]
    check_request(dense, lat, (n, h, w, 1), (n, *latent_hw, 4))
    print(f"  first request {first_s:.2f} s (captures included), launches "
          f"{ {k: c for k, c in counts.items() if c} }")
    if counts != expect():
        raise AssertionError(f"{label}: the first request's launches {counts} != {expect()}")
    readings = {"mode": mode, "steps": kwargs["steps"], "train_steps": train_steps,
                "first_request_s": first_s,
                "graph": graph_check(label, pipe, images, sparses, kwargs, latent_hw, expect)}
    cfg = S.SamplerConfig(**{"ddim": bundle.ddim_config, **kwargs} if bundle.ddim_config
                          else kwargs)
    ref_dense, ref_lat = former_request(bundle, images.to(DEV), sparses.to(DEV), cfg)
    dense, lat = pipe(images, sparses, **kwargs)
    diff = _rel_l2(lat, ref_lat)
    spread = readings["graph"]["graph_vs_twin"]["latent"]["twin_spread_l2"]
    limit = max(GRAPH_SPREAD_FACTOR * spread, FORMER_FLOOR)
    readings["former"] = {"latent": diff, "limit": limit, "dense": _rel_l2(dense, ref_dense)}
    print(f"  (e) latent: graph vs the former eager loop {diff:.3e} (limit {limit:.3e}); dense "
          f"{readings['former']['dense']:.3e}")
    check(f"{label}: graph vs the former eager loop (latent)", diff, limit, "||diff||/||former||")
    if mode in ("general", "per-input"):
        readings["former_steps"] = former_step_check(label, pipe.programs.find(images.shape))
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return readings


def modes_phase(model_dir: Path, taesd_dir: Path, root: Path, steps: int, res: int = 768) -> dict:
    """The sampler's other modes at full width on the checkpoint bundle of
    phase 3a (Marigold UNet, TAESD, the SD2 tower's context; bf16), 480x640
    frames with 500 points at res 768, norm=const; launches counted from 0
    for every request and held to ``expected_launches`` of its mode:

    - remat: one guided step at batch 8 with ``remat_unet="on"``, then
      "off" (and "off" at batch 1): losses, affine and latent grads within
      ``REMAT_LIMITS``, peak memory lower with remat; the peaks at batch 1
      and 8 give the bytes per latent pixel and the fixed bytes of
      ``remat_unet="auto"``;
    - ensemble: E=5, aligned-median, uncertainty: finite, MAD >= 0, every
      reduced pixel one aligned member's value (odd E), the median of the
      first four members against numpy's (``MEDIAN_LIMIT``), member 0
      against the plain batch-1 request on the same seed (``CLI_LIMITS``);
    - LCM: ``cli.predict --model lcm`` on the checkpoint directory, 4 steps,
      one frame, against the same request through the plain versions
      (``LCM_LIMITS``; that request launches no kernel);
    - per-input: ``train_method="per-input"``, ``train_steps=10``, learned
      affine; then one per-input step held as the reference step is
      (``PER_INPUT_LIMITS``);
    - KLD: a guided path with ``kld=True, kld_mode="strict"`` (two
      requests with the carry, the reference step with the penalty, the
      TAESD limits).

    → the ``modes`` line."""
    frame, points = CLI_FRAME, CLI_POINTS
    h, w = frame
    bundle = load_bundle(model_dir, "tiny", taesd_dir, torch.bfloat16, device=DEV)
    eh, ew = latent_size(frame, res, bundle.vae.downsample_factor)
    images, sparses = path_inputs(frame, points)
    pipe = DepthCompletionPipeline(bundle)
    modes: dict[str, dict] = {}

    def expect(mode, n_steps, **kw):
        return expected_launches(registry.MARIGOLD_UNET_CONFIG, "tiny", registry.TAESD_CONFIG,
                                 (eh, ew), n_steps, mode=mode, **kw)

    def counted(label, expected, fn):
        """``fn()`` with the launches counted from 0 and held to
        ``expected``; → (its result, seconds, peak GiB, launches)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()  # just before
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launches()  # just after
        reset_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        used = {k: n for k, n in counts.items() if n}
        print(f"  {label}: {dt:.2f} s, peak memory {peak:.2f} GiB, launches {used}")
        if counts != expected:
            raise AssertionError(f"{label}: kernel launches {counts} != expected {expected}")
        return out, dt, peak, used

    def request(label, expected, **options):
        return counted(label, expected, lambda: pipe(
            images, sparses, max_depth=120.0, norm="const", resolution=res, **options))

    # remat: one guided step, first, with nothing but the bundle alive
    print(f"modes: remat, one guided step at batch {REMAT_BATCH} and 1, {h}x{w}, res {res}")
    cfg = S.SamplerConfig(steps=steps, resolution=res, norm="const", closed_form=False)
    sched = S.make_schedule(cfg.ddim)
    t = int(S.make_timesteps(cfg.ddim, cfg.steps)[0])
    imgs_b, sps_b = path_inputs(frame, points, batch=REMAT_BATCH, seed=1)

    def guided_step(n, remat, bnd=bundle, vae_cfg=registry.TAESD_CONFIG):
        """The step twice (the first call at a new batch size sets up the
        libraries' plans and workspaces); → the second's (losses, grads,
        seconds, peak GiB, launches)."""
        kind = bnd.vae.kind
        imgs, sps = imgs_b[:n].to(DEV), sps_b[:n].to(DEV)
        img_lat, lat0, dn, padding, orig_res = S._prepare(bnd, imgs, sps, cfg, None)
        for _ in range(2):
            lat = lat0.clone().requires_grad_(True)
            aff = [torch.ones((n, 1, 1, 1), device=DEV).requires_grad_(True),
                   torch.zeros((n, 1, 1, 1), device=DEV).requires_grad_(True)]
            (losses, _, grads), dt, peak, used = counted(
                f"{kind} batch {n} remat {'on' if remat else 'off'}", expected_launches(
                    registry.MARIGOLD_UNET_CONFIG, kind, vae_cfg, (eh, ew), 1,
                    mode="step-remat" if remat else "step"),
                lambda: S.guided_step_grads(
                    S._Denoiser(bnd, img_lat, fa.flash_attention, remat),
                    functools.partial(S.decode_prediction, bnd), sched, cfg, dn, imgs,
                    orig_res, padding, False, lat, aff, t))
        return losses, grads, dt, peak, used

    on = guided_step(REMAT_BATCH, True)
    off = guided_step(REMAT_BATCH, False)
    one = guided_step(1, False)
    one_on = guided_step(1, True)
    loss_rel = max_rel(on[0], off[0])
    aff_rel = max(max_rel(a, b) for a, b in zip(on[1][1:], off[1][1:]))
    cos_gap = 1.0 - cos(on[1][0], off[1][0])
    check("remat losses (on vs off)", loss_rel, REMAT_LIMITS[0], "rel_err")
    check("remat affine grads (on vs off)", aff_rel, REMAT_LIMITS[1], "rel_err")
    check("remat latent grad (on vs off)", cos_gap, REMAT_LIMITS[2], "1-cos")
    check("remat peak memory below no remat", on[3] - off[3], -1e-3, "GiB(on) - GiB(off)")
    # peak bytes per (VAE kind, remat): batch → GiB; the KL VAE's decoder
    # on the same UNet weights (the bundle's, shared), its own random VAE
    peaks = {("tiny", False): {1: one[3], REMAT_BATCH: off[3]},
             ("tiny", True): {1: one_on[3], REMAT_BATCH: on[3]}}
    remat_s = {"tiny": {"on": on[2], "off": off[2], "off_batch1": one[2], "on_batch1": one_on[2]}}
    del on, off, one, one_on
    kl_small = make_random_bundle(seed=0, unet_config=registry.TINY_UNET_CONFIG,
                                  vae_config=registry.SD_VAE_CONFIG, dtype=torch.bfloat16,
                                  device=DEV, vae_kind="kl")
    kl = dataclasses.replace(bundle, vae=kl_small.vae)
    del kl_small
    print(f"modes: remat, the KL VAE: one guided step at batch {KL_REMAT_BATCHES}")
    for n in KL_REMAT_BATCHES:
        for remat in (False, True):
            r = guided_step(n, remat, kl, registry.SD_VAE_CONFIG)
            peaks.setdefault(("kl", remat), {})[n] = r[3]
            remat_s.setdefault("kl", {})[f"{'on' if remat else 'off'}_batch{n}"] = r[2]
            del r
    # the serving buckets 1 and 4 with the KL decoder, each its own step
    # program, sharing one pipeline's graph pool
    print(f"modes: the KL decoder's buckets 1 and 4 through their step programs, one pool, "
          f"{REMAT_PROGRAM_STEPS} steps")
    kl_pipe, kl_buckets = DepthCompletionPipeline(kl), {}
    for n in (1, 4):
        imgs_k, sps_k = path_inputs(frame, points, batch=n, seed=3)
        (dense, _), dt, peak, _ = counted(
            f"kl program batch {n}", expected_launches(
                registry.MARIGOLD_UNET_CONFIG, "kl", registry.SD_VAE_CONFIG, (eh, ew),
                REMAT_PROGRAM_STEPS),
            lambda: kl_pipe(imgs_k, sps_k, max_depth=120.0, norm="const", resolution=res,
                            steps=REMAT_PROGRAM_STEPS, closed_form=False, remat_unet="off"))
        check_request(dense, None, (n, h, w, 1), None)
        kl_buckets[n] = {"s_per_request": dt, "peak_gib": peak,
                         **kl_pipe.programs.find(imgs_k.shape).stats["step"]}
        print(f"  kl program batch {n}: pool growth "
              f"{kl_buckets[n]['pool_growth_bytes'] / 2**30:.2f} GiB, capture "
              f"{kl_buckets[n]['capture_ms']:.0f} ms")
    reserved = torch.cuda.max_memory_reserved() / 2**30  # since batch 4's request began
    print(f"  kl buckets 1 and 4 in one pool: most reserved {reserved:.2f} GiB of the card's "
          f"{torch.cuda.get_device_properties(DEV).total_memory / 2**30:.2f}")
    kl_buckets["max_reserved_gib"] = reserved
    del kl_pipe, imgs_k, sps_k, dense
    gc.collect()
    torch.cuda.empty_cache()
    pixels = eh * ew
    measured = {}  # (kind, remat) → (bytes per latent pixel, fixed bytes), through the end points
    for (kind, remat), by_n in peaks.items():
        measured[(kind, remat)] = peak_line(by_n, pixels)
        for n, gib in by_n.items():
            est = S.step_peak_bytes(kind, remat, n, (eh, ew), torch.bfloat16)
            print(f"  {kind} remat {'on' if remat else 'off'} batch {n}: peak {gib:.3f} GiB, "
                  f"sampler.py's estimate {est / 2**30:.3f} GiB")
            check(f"remat {kind} {'on' if remat else 'off'} batch {n}: the estimate covers the "
                  "peak", gib * 2**30 / est, STEP_PEAK_COVER, "peak/estimate")
    total = torch.cuda.get_device_properties(DEV).total_memory
    kl_hw = latent_size(frame, res, kl.vae.downsample_factor)
    limit = S.largest_batch("kl", kl_hw, DEV)
    imgs_x, sps_x = path_inputs(frame, points, batch=limit + 1, seed=2)

    def refused():
        try:
            DepthCompletionPipeline(kl)(imgs_x, sps_x, max_depth=120.0, norm="const",
                                        resolution=res, steps=steps, closed_form=False)
        except ValueError as exc:
            return str(exc)
        raise AssertionError(f"a KL batch of {limit + 1} was not refused")

    message, _, _, _ = counted(f"kl batch {limit + 1} (one above the limit)",
                               {k: 0 for k in launches()}, refused)
    print(f"  refused: {message}")
    if not message.endswith(f"the largest batch that fits at this geometry is {limit}"):
        raise AssertionError(f"the KL batch limit's error does not name {limit}: {message}")
    del kl, imgs_x, sps_x
    auto = {kind: {n: S.resolve_remat(cfg, n, (eh, ew), DEV, kind) for n in (1, 2, 4, 8, 16, 32)}
            for kind in ("tiny", "kl")}
    for (kind, remat), (per_pixel, fixed) in measured.items():
        print(f"  remat {kind} {'on' if remat else 'off'}: measured {per_pixel:.0f} bytes per "
              f"latent pixel + {fixed:.0f} fixed (sampler.py: "
              f"{S.STEP_PEAK_BYTES[(kind, remat, torch.bfloat16)]})")
    print(f"  card memory {total}; \"auto\" on at batch {auto}; the largest KL batch that fits "
          f"at {kl_hw[0]}x{kl_hw[1]}: {limit}")
    modes["remat"] = {
        "batch": REMAT_BATCH, "s_per_step": remat_s,
        "peak_gib": {f"{kind} {'on' if remat else 'off'}": {str(n): g for n, g in by_n.items()}
                     for (kind, remat), by_n in peaks.items()},
        "checks": {"loss_rel": loss_rel, "affine_rel": aff_rel, "latent_1_minus_cos": cos_gap},
        "bytes_per_latent_pixel_and_fixed": {f"{kind} {'on' if remat else 'off'}": list(v)
                                             for (kind, remat), v in measured.items()},
        "total_memory": total, "kl_batch_limit": limit,
        "auto_on_at_batch": {kind: {str(n): v for n, v in a.items()} for kind, a in auto.items()},
        "card": card(),
    }

    # remat through the step programs: a request at batch 8, with and
    # without, each its own program in one pipeline (one pool)
    print(f"modes: remat through the step programs, batch {REMAT_BATCH}, "
          f"{REMAT_PROGRAM_STEPS} steps")
    rpipe = DepthCompletionPipeline(bundle)
    programs = {}
    for remat in ("on", "off"):
        (dense, lat), dt, peak, _ = counted(
            f"program batch {REMAT_BATCH} remat {remat}",
            expect("per-step", REMAT_PROGRAM_STEPS, remat=remat == "on"),
            lambda: rpipe(imgs_b, sps_b, max_depth=120.0, norm="const", resolution=res,
                          steps=REMAT_PROGRAM_STEPS, closed_form=False, remat_unet=remat))
        check_request(dense, lat, (REMAT_BATCH, h, w, 1), (REMAT_BATCH, eh, ew, 4))
        program = rpipe.programs.find(imgs_b.shape)  # the request just run
        if program.remat != (remat == "on"):
            raise AssertionError(f"remat {remat}: the program's remat is {program.remat}")
        timing = step_timing(program, eager=False, steps=REMAT_PROGRAM_STEPS)
        reset_launches()
        stats = program.stats["step"]
        programs[remat] = {"s_per_request": dt, "peak_gib": peak, **stats, **timing}
        print(f"  program remat {remat}: {timing['s_per_step']:.3f} s/step replayed (one eager "
              f"step: {remat_s['tiny'][remat]:.3f} s), device {timing['device_ms']:.1f} ms/step, "
              f"busy {timing['busy_share']:.1%}; capture {stats['capture_ms']:.0f} ms, "
              f"instantiate {stats['instantiate_ms']:.0f} ms, pool growth "
              f"{stats['pool_growth_bytes'] / 2**30:.2f} GiB; request peak {peak:.2f} GiB")
    modes["remat"]["programs"] = programs
    modes["remat"]["kl_bucket_programs"] = kl_buckets
    del imgs_b, sps_b, rpipe, program, dense, lat
    gc.collect()
    torch.cuda.empty_cache()

    # ensemble
    print(f"modes: ensemble E={ENSEMBLE_SIZE}, aligned-median, uncertainty, {steps} steps")
    (denses, members, mad), dt, peak, used = request(
        "ensemble", expect("per-step", steps), steps=steps, closed_form=False,
        ensemble_size=ENSEMBLE_SIZE, ensemble_reduce="aligned-median", ensemble_uncertainty=True)
    check_request(denses, None, (1, h, w, 1), None)
    program = pipe.programs.find((ENSEMBLE_SIZE, h, w, 3))  # the E members' batch
    ens_program = {**program.stats["step"], **step_timing(program, eager=False)}
    reset_launches()
    print(f"  ensemble program: batch {program.latents.shape[0]}, "
          f"{ens_program['s_per_step']:.3f} s/step replayed, device "
          f"{ens_program['device_ms']:.1f} ms/step, capture {ens_program['capture_ms']:.0f} ms, "
          f"pool growth {ens_program['pool_growth_bytes'] / 2**30:.2f} GiB")
    del program
    if tuple(members.shape) != (1, ENSEMBLE_SIZE, h, w, 1) or not torch.isfinite(members).all():
        raise AssertionError(f"ensemble members {tuple(members.shape)}")
    if tuple(mad.shape) != (1, h, w, 1) or not torch.isfinite(mad).all() or mad.min() < 0:
        raise AssertionError(f"ensemble MAD {tuple(mad.shape)} min {float(mad.min())}")
    aligned = TE.align_members(members)
    odd_gap = float((aligned - denses[:, None]).abs().amin(dim=1).max())
    check("ensemble median is an aligned member's value (odd E)", odd_gap, 0.0, "max min|diff|")
    four = members[:, :4]
    even_err = float(np.abs(TE.reduce_members(four, "median")[0].cpu().numpy()
                            - np.median(four.cpu().numpy(), axis=1)).max())
    check("ensemble median of 4 members vs numpy", even_err, MEDIAN_LIMIT, "max|diff| m")
    (plain, _), guided_dt, guided_peak, _ = request(
        "guided (batch 1)", expect("per-step", steps), steps=steps, closed_form=False)
    m0_rms, m0_max = _range_diff(members[0, 0], plain[0])
    spread = float(members.std(dim=1).mean())
    print(f"  ensemble: member 0 vs the batch-1 request rms {m0_rms:.3e} max {m0_max:.3e} of "
          f"120 m; member spread (std) {spread:.3f} m; MAD mean {float(mad.mean()):.3f} m")
    check("ensemble member 0 vs the batch-1 request (rms)", m0_rms, CLI_LIMITS[0], "rms/120 m")
    check("ensemble member 0 vs the batch-1 request (max)", m0_max, CLI_LIMITS[1], "max/120 m")
    modes["ensemble"] = {
        "ensemble_size": ENSEMBLE_SIZE, "steps": steps, "s_per_request": dt, "launches": used,
        "peak_gib": peak, "checks": {"odd_median_gap": odd_gap, "median4_err": even_err,
                                     "member0_rms": m0_rms, "member0_max": m0_max},
        "member_std_m": spread, "program": ens_program, "card": card(),
    }
    del denses, members, mad, aligned

    # fast guidance: the UNet's output detached, no graph through it
    print(f"modes: fast guidance (detach_unet_grad), {steps} steps")
    (fast, _), dt, peak, used = request(
        "fast guidance", expect("fast_guidance", steps), steps=steps, closed_form=False,
        detach_unet_grad=True)
    check_request(fast, None, (1, h, w, 1), None)
    fast_rms, fast_max = _range_diff(fast[0], plain[0])
    print(f"  fast guidance: {dt / steps:.3f} s/step against {guided_dt / steps:.3f} guided; peak "
          f"{peak:.2f} GiB against {guided_peak:.2f}; dense vs the guided request rms "
          f"{fast_rms:.3e} max {fast_max:.3e} of 120 m")
    check("fast guidance peak below the guided request's", peak - guided_peak, -1e-3,
          "GiB(fast) - GiB(guided)")
    modes["fast_guidance"] = {
        "steps": steps, "s_per_request": dt, "guided_s_per_request": guided_dt,
        "launches": used, "peak_gib": peak, "guided_peak_gib": guided_peak,
        "dense_vs_guided": {"rms": fast_rms, "max": fast_max}, "card": card(),
    }
    del fast, plain

    # LCM through the CLI
    print(f"modes: LCM, cli.predict --model lcm, {LCM_STEPS} steps, 1 frame")
    data, _, _ = cli_dataset(root / "lcm_data", seed=1, frames=1)
    out_dir = root / "lcm_out"
    argv = [str(data), str(out_dir), "--checkpoint-dir", str(model_dir), "--taesd-dir",
            str(taesd_dir), "--model", "lcm", "--steps", str(LCM_STEPS), "--res", str(res),
            "--vis", "false",
            "--log-level", "WARNING"]
    with spy_pipeline() as fed:
        totals, dt, peak, used = counted("lcm (cli)", expect("forward", LCM_STEPS),
                                         lambda: predict_cli.main(argv))
    dense = codecs.load_array(out_dir / "scene" / "dense" / "00000.dcz")
    check_request(torch.from_numpy(dense)[None], None, (1, h, w, 1), None)
    (x, y, args, kwargs, _), = fed
    if (kwargs["scheduler"], kwargs["train_latents"], kwargs["closed_form"]) != ("lcm", False,
                                                                               True):
        raise AssertionError(f"lcm: the CLI asked for {kwargs}")
    with plain_decode():
        (plain, _), _, _, _ = counted(
            "lcm (plain versions)", {k: 0 for k in launches()},
            lambda: DepthCompletionPipeline(bundle).twin()(
                x, y, *args, **{**kwargs, "flash_attention": "off"}))
    lcm_rms, lcm_max = _range_diff(torch.from_numpy(dense), plain[0])
    print(f"  lcm: kernels vs plain versions rms {lcm_rms:.3e} max {lcm_max:.3e} of 120 m")
    check("lcm dense vs the plain versions (rms)", lcm_rms, LCM_LIMITS[0], "rms/120 m")
    check("lcm dense vs the plain versions (max)", lcm_max, LCM_LIMITS[1], "max/120 m")
    modes["lcm"] = {
        "steps": LCM_STEPS, "s_per_request": totals["time_infer"], "wall_s": dt,
        "launches": used, "peak_gib": peak, "checks": {"rms": lcm_rms, "max": lcm_max},
        "card": card(),
    }

    # per-input
    print(f"modes: per-input, {steps} steps + {MODES_TRAIN_STEPS} train steps")
    (dense, lat), dt, peak, used = request(
        "per-input", expect("per-input", steps, train_steps=MODES_TRAIN_STEPS), steps=steps,
        closed_form=False, train_method="per-input", train_steps=MODES_TRAIN_STEPS)
    check_request(dense, lat, (1, h, w, 1), (1, eh, ew, 4))
    bundle32 = fp32_bundle(bundle)
    ref = reference_step_check(bundle, bundle32, images.to(DEV), sparses.to(DEV), res,
                               per_input=True, label="per-input step")
    del bundle32
    modes["per-input"] = {"steps": steps, "train_steps": MODES_TRAIN_STEPS, "s_per_request": dt,
                          "launches": used, "peak_gib": peak, "checks": ref, "card": card()}

    # KLD: a guided path with the penalty
    kld = GuidedPath("TAESD_CONFIG, kld strict", "tiny", registry.TAESD_CONFIG, frame, points,
                     res, options=(("kld", True), ("kld_mode", "strict")))
    counts, info = guided_path(kld, steps, bundle)
    modes["kld"] = {"steps": steps, "s_per_request": info["s_per_request"],
                    "launches": {k: n // 2 for k, n in counts.items() if n},
                    "peak_gib": info["peak_gib"], "checks": info["reference_step"],
                    "graph": info["graph"], "card": card()}
    modes["peaked"] = peaked_reference_steps(bundle, images, sparses)

    # every mode's program: prepare, step and finish graphs (the programs line)
    n_prog = min(steps, MODE_PROGRAM_STEPS)
    base = dict(max_depth=120.0, norm="const", resolution=res)
    clip = dataclasses.replace(bundle.ddim_config or S.DDIMConfig(), clip_sample=True)
    specs = (  # label, expected_launches mode, request options, train steps
        ("lcm", "forward", dict(steps=LCM_STEPS, scheduler="lcm", train_latents=False,
                                seed=LCM_SECOND_SEED), 0),
        ("per-input", "per-input", dict(steps=n_prog, train_method="per-input",
                                        train_steps=MODES_TRAIN_STEPS, closed_form=False),
         MODES_TRAIN_STEPS),
        ("sgd", "general", dict(steps=n_prog, opt="sgd", closed_form=False), 0),
        ("adagrad", "general", dict(steps=n_prog, opt="adagrad", closed_form=False), 0),
        ("ddim", "forward", dict(steps=n_prog, train_latents=False), 0),
        ("adam_clip", "general", dict(steps=n_prog, closed_form=False, ddim=clip), 0),
    )
    modes["programs"] = {
        label: mode_program_check(label, bundle, images, sparses, {**base, **options}, mode,
                                  (eh, ew), train_steps)
        for label, mode, options, train_steps in specs}
    return modes


# ---------------------------------------------------------------------------
# Phase 5b: --precision fp32 on the card
# ---------------------------------------------------------------------------

FP32_STEPS = 10  # the KL and native requests and the dense-map check at fp32
FP32_CLI_STEPS = 4  # cli.predict --precision fp32, three frames
FP32_TIMING_STEPS = 4  # graph against eager ms per step, per fp32 path
# The dense map of a FP32_STEPS request through the fp32 kernels against the
# same request through the plain fp32 versions (rms, max over the 120 m
# range). Adam turns a gradient element whose sign the kernels' ~2^-21
# flips into a step of 2 lr, so the maps part by more than the kernels do:
# sound 3.6e-6 rms, 1.9e-4 max at 10 steps (H100 80GB HBM3, 700 W), limits
# 5.5x and 10x that. A guard against gross faults: one TF32 pass (F59) read
# 8.4e-6 rms and 4.3e-4 max at 4 steps, inside them (phase 2c and the
# reference step (c) catch it).
FP32_DENSE_LIMITS = (2e-5, 2e-3)
# the fp32 rows of sampler.STEP_PEAK_BYTES: TAESD at these batches (with
# and without remat), the KL decoder at these
FP32_PEAK_BATCHES = {"tiny": (1, 4), "kl": (1, 2)}
D128_HEADS = (5, 5, 20, 20)  # the Marigold UNet with stage 1 (640 channels) at d=128


def fp32_request_path(label: str, bundle, steps: int, frame, points: int, resolution: int,
                      ring_size: int | None = None) -> tuple[dict, dict]:
    """Two requests at fp32 through the pipeline (the second carrying the
    first's latents), each replaying its program's graphs and launching the
    fp32 kernels ``expected_launches(dtype=torch.float32)`` names; then the
    program's step eager (its own body, the graph's twin) against its graph,
    ms per step by CUDA events. → (the launches, the readings)."""
    h, w = frame
    ring = ra.LocalRing(ring_size) if ring_size else None
    pipe = DepthCompletionPipeline(bundle)
    eh, ew = latent_size(frame, resolution, bundle.vae.downsample_factor)
    images, sparses = path_inputs(frame, points)
    vae_cfg = registry.TAESD_CONFIG if bundle.vae.kind == "tiny" else registry.SD_VAE_CONFIG
    expected = expected_launches(bundle.unet_config, bundle.vae.kind, vae_cfg, (eh, ew), steps,
                                 ring_size, dtype=torch.float32)
    print(f"fp32 path {label}: 2 requests x {steps} guided steps, {h}x{w}, res {resolution}")
    prev, seconds, peaks, totals = None, [], [], {}
    for req in range(2):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launches()  # just before the request
        t0 = time.perf_counter()
        dense, lat = pipe(images, sparses, max_depth=120.0, steps=steps, norm="const",
                          closed_form=False, pred_latents_prev=prev, resolution=resolution,
                          ring_mesh=ring)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        counts = launches()  # just after
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        lo, hi = check_request(dense, lat, (1, h, w, 1), (1, eh, ew, 4))
        print(f"  request {req}: {seconds[-1]:.2f} s, peak {peaks[-1]:.2f} GiB, dense "
              f"[{lo:.3f}, {hi:.3f}] m, launches {({k: n for k, n in counts.items() if n})}")
        if counts != expected:
            raise AssertionError(f"fp32 {label}: kernel launches {counts} != expected {expected}")
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n
        prev = lat
    reset_launches()
    program = pipe.programs.find(images.shape)
    timing = {"graph": step_timing(program, eager=False, steps=FP32_TIMING_STEPS),
              "eager": step_timing(program, eager=True, steps=FP32_TIMING_STEPS)}
    reset_launches()  # the timing's launches are no path's
    g, e = timing["graph"], timing["eager"]
    print(f"  step: graph {g['s_per_step'] * 1e3:.2f} ms / eager {e['s_per_step'] * 1e3:.2f} ms per "
          f"run (CUDA events), device {g['device_ms']:.2f} / {e['device_ms']:.2f} ms, busy "
          f"{g['busy_share']:.1%} / {e['busy_share']:.1%}")
    del pipe, program
    gc.collect()
    torch.cuda.empty_cache()
    return totals, {"steps": steps, "s_per_request": seconds, "peak_gib": max(peaks),
                    "step_ms": {"graph": g["s_per_step"] * 1e3, "eager": e["s_per_step"] * 1e3},
                    "device_ms": {"graph": g["device_ms"], "eager": e["device_ms"]},
                    "busy_share": {"graph": g["busy_share"], "eager": e["busy_share"]}}


def fp32_peak_rows(bundle32, kl32) -> dict:
    """One fp32 guided step with and without UNet remat at
    ``FP32_PEAK_BATCHES`` (480x640 at res 768): each peak against
    ``sampler.STEP_PEAK_BYTES[(kind, remat, fp32)]`` (``STEP_PEAK_COVER``),
    and the rows the peaks give (bytes per latent pixel, fixed bytes,
    through the end points). → the readings."""
    frame, points = CLI_FRAME, CLI_POINTS
    cfg = S.SamplerConfig(steps=50, norm="const", closed_form=False)
    sched = S.make_schedule(cfg.ddim)
    t = int(S.make_timesteps(cfg.ddim, cfg.steps)[0])
    eh, ew = latent_size(frame, 768, bundle32.vae.downsample_factor)
    imgs_b, sps_b = path_inputs(frame, points, batch=max(max(b) for b in FP32_PEAK_BATCHES.values()),
                                seed=1)
    peaks = {}
    for bnd in (bundle32, kl32):
        kind = bnd.vae.kind
        for n in FP32_PEAK_BATCHES[kind]:
            for remat in (False, True):
                imgs, sps = imgs_b[:n].to(DEV), sps_b[:n].to(DEV)
                img_lat, lat0, dn, padding, orig_res = S._prepare(bnd, imgs, sps, cfg, None)
                for _ in range(2):  # the second: the libraries' plans and workspaces set up
                    lat = lat0.clone().requires_grad_(True)
                    aff = [torch.ones((n, 1, 1, 1), device=DEV).requires_grad_(True),
                           torch.zeros((n, 1, 1, 1), device=DEV).requires_grad_(True)]
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    S.guided_step_grads(S._Denoiser(bnd, img_lat, fa.flash_attention, remat),
                                        functools.partial(S.decode_prediction, bnd), sched, cfg,
                                        dn, imgs, orig_res, padding, False, lat, aff, t)
                    torch.cuda.synchronize()
                    gib = torch.cuda.max_memory_allocated() / 2**30
                    del lat, aff
                peaks.setdefault((kind, remat), {})[n] = gib
                est = S.step_peak_bytes(kind, remat, n, (eh, ew), torch.float32)
                print(f"  fp32 {kind} remat {'on' if remat else 'off'} batch {n}: peak {gib:.3f} "
                      f"GiB, sampler.py's estimate {est / 2**30:.3f} GiB")
                check(f"fp32 remat {kind} {'on' if remat else 'off'} batch {n}: the estimate "
                      "covers the peak", gib * 2**30 / est, STEP_PEAK_COVER, "peak/estimate")
                del img_lat, lat0, dn
                gc.collect()
                torch.cuda.empty_cache()
    reset_launches()  # these steps are no request's
    rows = {}
    for (kind, remat), by_n in peaks.items():
        key = f"{kind} {'on' if remat else 'off'}"
        rows[key] = list(peak_line(by_n, eh * ew))
        print(f"  fp32 remat {key}: measured {rows[key][0]:.0f} bytes per latent pixel + "
              f"{rows[key][1]:.0f} fixed (sampler.py: "
              f"{S.STEP_PEAK_BYTES[(kind, remat, torch.float32)]})")
    return {"peak_gib": {f"{k} {'on' if r else 'off'}": {str(n): g for n, g in by_n.items()}
                         for (k, r), by_n in peaks.items()},
            "bytes_per_latent_pixel_and_fixed": rows, "card": card()}


def fp32_phase(model_dir: Path, taesd_dir: Path, root: Path, steps: int) -> tuple[dict, dict]:
    """Phase 5b: ``--precision fp32`` on the card, every conv and flash call
    a launch of an fp32 kernel (3xTF32), on the checkpoint of phase 3a read
    at fp32 (the Marigold UNet, TAESD, the SD2 tower's context):

    - (a) TAESD at 480x640, res 768, ``steps`` guided steps, two requests
      with the carry (``fp32_request_path``: launches against
      ``expected_launches(dtype=fp32)``, graph against eager ms per step);
      (b) the KL VAE (``SD_VAE_CONFIG``, seeded fp32) and native resolution
      over ``LocalRing(4)`` (352x1216, res 1216), each at ``FP32_STEPS``;
    - (c) one fp32 guided step's losses, affine and latent gradients through
      the kernels against the plain versions (``FP32_REF_LIMITS``);
    - (d) the dense map of a ``FP32_STEPS`` request through the kernels
      against the same request through the plain fp32 versions
      (``FP32_DENSE_LIMITS``);
    - (e) ``cli.predict --precision fp32`` in its own process over three
      480x640 frames at ``FP32_CLI_STEPS``: exit 0, its logged launches three
      times one request's, finite maps; meanwhile (g);
    - (f) a guided step through the UNet with ``D128_HEADS`` (stage 1 at
      d=128: the generic flash pair) in bf16 (``REF_LIMITS``) and fp32
      (``FP32_REF_LIMITS``) against the plain step, its launches counted;
    - (g) ``scripts/verify_checkpoint_torch.py --precision fp32`` with
      either VAE (``verify_phase``);
    - (h) the fp32 rows of ``sampler.STEP_PEAK_BYTES`` (``fp32_peak_rows``).

    → (the ``fp32`` line, the launches of (a), (b) and (f))."""
    t_phase = time.perf_counter()
    counts, out = {}, {}
    bundle32 = load_bundle(model_dir, "tiny", taesd_dir, torch.float32, device=DEV)
    kl_vae = make_random_bundle(seed=0, unet_config=registry.TINY_UNET_CONFIG,
                                vae_config=registry.SD_VAE_CONFIG, dtype=torch.float32,
                                device=DEV, vae_kind="kl").vae
    kl32 = dataclasses.replace(bundle32, vae=kl_vae)
    native = next(p for p in PATHS if p.ring_size)
    for label, bnd, n_steps, frame, points, res, ring_size in (
        ("TAESD", bundle32, steps, (480, 640), 500, 768, None),
        ("KL", kl32, min(steps, FP32_STEPS), (480, 640), 500, 768, None),
        ("native-res", bundle32, min(steps, FP32_STEPS), native.frame, native.points,
         native.resolution, native.ring_size),
    ):
        got, out[label] = fp32_request_path(label, bnd, n_steps, frame, points, res, ring_size)
        for k, n in got.items():
            counts[k] = counts.get(k, 0) + n

    images_h, sparses_h = path_inputs((480, 640), 500)
    images, sparses = images_h.to(DEV), sparses_h.to(DEV)
    print("fp32 reference step: the fp32 kernels against the plain versions, fp32 bundle")
    out["reference_step"] = reference_step_check(bundle32, bundle32, images, sparses,
                                                 label="fp32 reference step",
                                                 seeds=REF_SEEDS[:2])

    n_steps = min(steps, FP32_STEPS)
    kw = dict(max_depth=120.0, steps=n_steps, norm="const", closed_form=False)
    dense_k, _ = DepthCompletionPipeline(bundle32)(images_h, sparses_h, **kw)
    reset_launches()
    with plain_decode():
        dense_p, _ = DepthCompletionPipeline(bundle32).twin()(images_h, sparses_h,
                                                             flash_attention="off", **kw)
    if any(n for k, n in launches().items() if k != "guidance_epilogue"):
        raise AssertionError(f"the plain fp32 request launched {launches()}")
    rms, mx = _range_diff(dense_k[0], dense_p[0])
    print(f"fp32 dense map ({n_steps} steps): kernels vs the plain versions rms {rms:.3e} max "
          f"{mx:.3e} of 120 m")
    check("fp32 dense map vs the plain versions (rms)", rms, FP32_DENSE_LIMITS[0], "rms/120 m")
    check("fp32 dense map vs the plain versions (max)", mx, FP32_DENSE_LIMITS[1], "max/120 m")
    out["dense_vs_plain"] = {"steps": n_steps, "rms": rms, "max": mx}
    del dense_k, dense_p

    data, _, _ = cli_dataset(root / "fp32_data")
    eh, ew = latent_size(CLI_FRAME, 768, bundle32.vae.downsample_factor)
    cli_steps = min(steps, FP32_CLI_STEPS)
    one = expected_launches(registry.MARIGOLD_UNET_CONFIG, "tiny", registry.TAESD_CONFIG,
                            (eh, ew), cli_steps, dtype=torch.float32)
    cmd = [sys.executable, "-m", "depth_completion_tpu_torch.cli.predict", str(data),
           str(root / "fp32_out"), "--checkpoint-dir", str(model_dir), "--taesd-dir",
           str(taesd_dir), "--precision", "fp32", "--steps", str(cli_steps), "--vis", "false"]
    # the CLI's process runs while the verifier's two do (each counts its
    # own launches)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=Path(__file__).resolve().parent)
    try:
        out["verify"] = verify_phase(model_dir, taesd_dir, "fp32")
        stdout, stderr = proc.communicate(timeout=600)
    finally:  # it does not outlive the phase, also when a check fails
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    cli_s = time.perf_counter() - t0
    logged = [json.loads(x) for x in re.findall(r"Kernel launches: (\{.*\})", stdout + stderr)]
    print(f"fp32 cli.predict --precision fp32 ({CLI_FRAMES} frames, {cli_steps} steps): rc "
          f"{proc.returncode} in {cli_s:.1f} s, launches "
          f"{[{k: n for k, n in x.items() if n} for x in logged]}")
    if proc.returncode != 0 or len(logged) != 1:
        raise AssertionError(f"cli.predict --precision fp32 exited {proc.returncode}:\n"
                             f"{stdout[-4000:]}\n{stderr[-4000:]}")
    want = {k: CLI_FRAMES * n for k, n in one.items() if n}
    if {k: n for k, n in logged[0].items() if n} != want:
        raise AssertionError(f"cli.predict --precision fp32 launched {logged[0]} != {want}")
    maps = sorted((root / "fp32_out").rglob("*.dcz"))
    for f in maps:
        check_request(torch.from_numpy(codecs.load_array(f))[None], None, (1, *CLI_FRAME, 1), None)
    if len(maps) != CLI_FRAMES:
        raise AssertionError(f"cli.predict --precision fp32 wrote {len(maps)} maps")
    out["cli"] = {"steps": cli_steps, "frames": CLI_FRAMES, "wall_s": cli_s,
                  "launches": {k: n for k, n in logged[0].items() if n}}

    d128 = {}
    for dtype, bnd in ((torch.bfloat16, load_bundle(model_dir, "tiny", taesd_dir, torch.bfloat16,
                                                    device=DEV)), (torch.float32, bundle32)):
        cfg128 = dataclasses.replace(bnd.unet_config, num_heads=D128_HEADS)
        b128 = dataclasses.replace(bnd, unet_config=cfg128)
        seeds = REF_SEEDS[:1]
        reset_launches()  # just before: only the steps under test launch kernels
        d128[fa.DTYPE_TAGS[dtype]] = reference_step_check(
            b128, fp32_bundle(b128), images, sparses, label=f"d=128 UNet step {fa.DTYPE_TAGS[dtype]}",
            seeds=seeds)
        got = launches()
        reset_launches()
        step = expected_launches(cfg128, "tiny", registry.TAESD_CONFIG, (eh, ew), 1, mode="step",
                                 dtype=dtype)
        want = {k: len(seeds) * n for k, n in step.items()}
        print(f"  d=128 UNet step {fa.DTYPE_TAGS[dtype]}: launches {({k: n for k, n in got.items() if n})}")
        if got != want:
            raise AssertionError(f"d=128 UNet step {fa.DTYPE_TAGS[dtype]}: launches {got} != {want}")
        for k, n in got.items():
            counts[k] = counts.get(k, 0) + n
        del bnd, b128
    out["d128_step"] = d128
    out["peaks"] = fp32_peak_rows(bundle32, kl32)
    out["phase_s"] = time.perf_counter() - t_phase
    out["card"] = card()
    print(f"fp32: phase 5b took {out['phase_s']:.1f} s")
    del bundle32, kl32, kl_vae
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


# ---------------------------------------------------------------------------
# Phase 6: the serving engine behind the serve CLI and its HTTP server
# ---------------------------------------------------------------------------

SERVE_MAX_STEPS, SERVE_CLIENTS, SERVE_REQUESTS = 10, 8, 24
# checks (b) and (c) widen the engine's batching window so that concurrent
# posts coalesce whatever the HTTP threads' timing (seconds)
SERVE_COALESCE_S = 2.0


class ServedBatches:
    """The engine's pipe, recording each batch it runs (on the compute
    thread): its size, whether it carried a latent, CUDA events before and
    after (device time per batch and the idle gap between batches, without
    a synchronisation), the kernel launches inside it, and, while
    ``keep`` is set, its inputs and dense output."""

    def __init__(self, pipe):
        self.pipe, self.bundle = pipe, pipe.bundle
        self.batches: list[dict] = []
        self.keep = False

    def __call__(self, images, sparses, **kwargs):
        before = launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dense, lat = self.pipe(images, sparses, **kwargs)
        end.record()
        now = launches()
        rec = {"n": images.shape[0], "carry": "pred_latents_prev" in kwargs, "start": start,
               "end": end, "launches": {k: now[k] - before[k] for k in now}}
        if self.keep:
            rec.update(images=np.array(images), sparses=np.array(sparses), dense=dense)
        self.batches.append(rec)
        return dense, lat


def _http(srv, method: str, path: str, body: bytes | None = None):
    """(status, body, headers, seconds) of one request to ``srv``."""
    host, port = srv.server_address
    conn = http.client.HTTPConnection(host, port, timeout=600)
    t0 = time.perf_counter()
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    dt = time.perf_counter() - t0
    conn.close()
    return resp.status, data, dict(resp.getheaders()), dt


def _npz(image, sparse) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, image=image, sparse=sparse)
    return buf.getvalue()


def _dense(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data))


def _post_all(srv, frames, path="/v1/complete"):
    """POST every frame at once, one client thread each; → the responses
    in frame order."""
    out = [None] * len(frames)

    def post(i):
        out[i] = _http(srv, "POST", path, _npz(*frames[i]))

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(frames))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    if any(r is None or r[0] != 200 for r in out):
        raise AssertionError(f"serve: a request failed: {[r and (r[0], r[1][:200]) for r in out]}")
    return out


def _row_order(batch: dict, frames) -> list[int]:
    """Which of ``frames`` each row of a recorded batch holds (by its sparse map)."""
    order = [int(np.argmin([np.abs(batch["sparses"][j] - f[1]).max() for f in frames]))
             for j in range(len(frames))]
    if sorted(order) != list(range(len(frames))):
        raise AssertionError(f"the batch's rows hold frames {order}")
    return order


def _closed_loop(srv, frames, requests: int) -> tuple[list[float], float]:
    """One client thread per frame, each posting its frame until ``requests``
    have been sent. → (latencies, seconds)."""
    lats, left, lock = [], [requests], threading.Lock()

    def client(i):
        while True:
            with lock:
                if left[0] <= 0:
                    return
                left[0] -= 1
            status, data, _, dt = _http(srv, "POST", "/v1/complete", _npz(*frames[i]))
            if status != 200:
                raise AssertionError(f"throughput request: {status} {data[:200]}")
            with lock:
                lats.append(dt)

    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(i,)) for i in range(len(frames))]
    for th in clients:
        th.start()
    for th in clients:
        th.join(900)
    if len(lats) != requests:
        raise AssertionError(f"throughput: {len(lats)} of {requests} requests answered")
    return sorted(lats), time.perf_counter() - t0


def serve_frames(frame, points: int, seed: int, n: int) -> list:
    """``n`` (image, sparse) numpy frames of ``path_inputs``."""
    imgs, sps = path_inputs(frame, points, batch=n, seed=seed)
    return [(imgs[i].numpy(), sps[i].numpy()) for i in range(n)]


def start_serve(model_dir: Path, taesd_dir: Path, argv: list[str]):
    """``cli.serve.run_serve`` in process on the checkpoint directory (port
    0, ``argv`` added), each warmup call timed, its pipe wrapped in
    ``ServedBatches`` and its HTTP server in a thread. → (engine, httpd,
    served, thread, warmup (batch, carry, s) per signature, run_serve's
    seconds)."""
    params = vars(serve_cli.build_parser().parse_args([
        "--checkpoint-dir", str(model_dir), "--taesd-dir", str(taesd_dir), "--port", "0",
        "--log-level", "WARNING", *argv]))
    warm = []
    call = DepthCompletionPipeline.__call__

    def timed(self, images, sparses, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = call(self, images, sparses, *args, **kwargs)
        torch.cuda.synchronize()
        warm.append((np.shape(images)[0], "pred_latents_prev" in kwargs, time.perf_counter() - t0))
        return result

    DepthCompletionPipeline.__call__ = timed
    try:
        t0 = time.perf_counter()
        engine, httpd = serve_cli.run_serve(**params, serve_forever=False)
        t_start = time.perf_counter() - t0
    finally:
        DepthCompletionPipeline.__call__ = call
    served = ServedBatches(engine.pipe)
    engine.pipe = served
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return engine, httpd, served, thread, warm, t_start


def stop_serve(engine, httpd, thread) -> None:
    httpd.shutdown()
    httpd.server_close()
    engine.shutdown()
    thread.join(10)


class TierLog:
    """A pipe that records, per call, its tier, the batch and the seconds
    since ``t0``; other attributes are the wrapped pipeline's."""

    def __init__(self, pipe, tier: str, log: list, t0: float):
        self.pipe, self.tier, self.log, self.t0 = pipe, tier, log, t0

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, images, sparses, **kwargs):
        out = self.pipe(images, sparses, **kwargs)
        self.log.append((self.tier, int(np.shape(images)[0]), time.perf_counter() - self.t0))
        return out


def _wait(engine, done, timeout_s: float = 300.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not done(engine.stats()):
        if time.monotonic() > deadline:
            raise AssertionError(f"serve: timed out waiting; stats {engine.stats()}")
        time.sleep(0.05)


def tiered_phase(model_dir: Path, taesd_dir: Path, n_steps: int, bundle, call_kwargs: dict,
                 frame: tuple[int, int], points: int) -> dict:
    """Phase 6's tiers:

    - (g) ``cli.serve.run_serve`` with ``--warmup-tiered --max-programs 4
      --max-batch 4`` on the checkpoint directory: warmup returns with tier
      0 (the eager twin) active; four concurrent frames right after it run
      as one batch on tier 0 (bucket 4 is promoted after bucket 1); once
      both signatures are promoted (each capture timed from the warmup's
      end), four more and a single frame run on the graphs and tier 0 is
      gone;
    - (h) an engine on the served bundle with ``max_programs=1`` over two
      geometries (480x640 and 240x320, ``max_batch=1``): promoting the
      second evicts the first; a request of the first geometry then runs
      on tier 0 (the eviction-aware dispatch), without a capture, and one
      of the second on its graph;
    - (i) ``run_serve --warmup-tiered --max-programs 1 --max-batch 1`` with
      ``--model lcm``, then with ``--opt sgd``: the signature's program (an
      LCM or a general-step program) is promoted, tier 0 drops, and a
      request then runs on the graph pipeline.
    → the readings."""
    from depth_completion_tpu_torch.serving import ServeRequest, ServingEngine

    h, w = frame
    out = {}

    def frames(seed, n, hw=frame):
        imgs, sps = path_inputs(hw, points, batch=n, seed=seed)
        return [(imgs[i].numpy(), sps[i].numpy()) for i in range(n)]

    # (g) through the serve CLI
    params = vars(serve_cli.build_parser().parse_args([
        "--checkpoint-dir", str(model_dir), "--taesd-dir", str(taesd_dir),
        "--steps", str(n_steps), "--max-batch", "4", "--warmup", f"{h}x{w}", "--warmup-tiered",
        "--max-programs", "4", "--max-delay-ms", str(SERVE_COALESCE_S * 1e3), "--port", "0",
        "--log-level", "WARNING"]))
    log, t0 = [], time.perf_counter()
    engine, httpd = serve_cli.run_serve(**params, serve_forever=False)
    try:
        warm_s = time.perf_counter() - t0
        with engine._tier_lock:  # record which tier serves each call from here on
            tier0_after_warmup = engine._tier0_pipe is not None
            if tier0_after_warmup:
                engine._tier0_pipe = TierLog(engine._tier0_pipe, "tier0", log, t0)
        engine.pipe = TierLog(engine.pipe, "graph", log, t0)
        first = [engine.submit(ServeRequest(image=i, sparse=s)) for i, s in frames(21, 4)]
        for r in first:
            r.wait(600)
        _wait(engine, lambda st: "tier0_active" not in st)
        later = [engine.submit(ServeRequest(image=i, sparse=s)) for i, s in frames(22, 4)]
        for r in later:
            r.wait(600)
        engine.complete(*frames(23, 1)[0], timeout=600)
        st = engine.stats()
        batches = [(t, n) for t, n, _ in log]
        print(f"  (g) run_serve --warmup-tiered --max-programs 4: {warm_s:.2f} s (load and warmup "
              f"on tier 0), tier 0 active after it: {tier0_after_warmup}; calls after it (tier, "
              f"batch; the graph calls of the promotions included): {batches}; promotions "
              f"{st['tier_promotions']}; programs {st['compiled_programs']}")
        first4 = next((b for b in batches if b[1] == 4), None)
        if not tier0_after_warmup or first4 != ("tier0", 4) \
                or [r._batch_size for r in first] != [4] * 4 \
                or batches[-2:] != [("graph", 4), ("graph", 1)] \
                or engine.pipe.max_programs != 4 or len(st["tier_promotions"]) != 2:
            raise AssertionError(f"(g) tiers: {tier0_after_warmup}, {batches}, {st}")
        out["g"] = {"run_serve_s": warm_s, "calls": [list(e) for e in log],
                    "promotions": st["tier_promotions"]}
    finally:
        httpd.server_close()
        engine.shutdown()
    del engine, httpd
    gc.collect()
    torch.cuda.empty_cache()

    # (h) max_programs=1 over two geometries
    log, t0 = [], time.perf_counter()
    small = (h // 2, w // 2)
    pipe = DepthCompletionPipeline(bundle, max_programs=1)
    engine = ServingEngine(TierLog(pipe, "graph", log, t0), call_kwargs, max_batch=1)
    engine._make_tier0_pipe = lambda effort: TierLog(pipe.twin(), "tier0", log, t0)
    try:
        engine.warmup([frame, small], tiered=True)
        warm_s = time.perf_counter() - t0
        _wait(engine, lambda st: len(st["tier_promotions"]) == 2)
        keys = [k[1] for k in pipe.program_keys()]
        before = len(log)
        engine.complete(*frames(24, 1)[0], timeout=600)  # the evicted geometry
        engine.complete(*frames(25, 1, small)[0], timeout=600)
        calls = [(t, n) for t, n, _ in log[before:]]
        after = [k[1] for k in pipe.program_keys()]
        st = engine.stats()
        print(f"  (h) max_programs=1: warmup {warm_s:.2f} s on tier 0; promotions "
              f"{st['tier_promotions']}; live programs {keys}; {h}x{w} then "
              f"{small[0]}x{small[1]} ran on {calls}; live after {after}")
        if keys != [(1, *small, 3)] or calls != [("tier0", 1), ("graph", 1)] or after != keys:
            raise AssertionError(f"(h) eviction-aware dispatch: {keys} {calls} {after}")
        out["h"] = {"warmup_s": warm_s, "calls": [list(e) for e in log],
                    "promotions": st["tier_promotions"]}
    finally:
        engine.shutdown()
    del engine, pipe
    gc.collect()
    torch.cuda.empty_cache()

    # (i) --max-programs 1 over a branch other than the fused step
    for name, extra, tag in (("lcm", ["--model", "lcm"], "lcm"),
                             ("sgd", ["--opt", "sgd"], "general-step")):
        params = vars(serve_cli.build_parser().parse_args([
            "--checkpoint-dir", str(model_dir), "--taesd-dir", str(taesd_dir),
            "--steps", str(n_steps), "--max-batch", "1", "--warmup", f"{h}x{w}",
            "--warmup-tiered", "--max-programs", "1", "--port", "0", "--log-level", "WARNING",
            *extra]))
        log, t0 = [], time.perf_counter()
        engine, httpd = serve_cli.run_serve(**params, serve_forever=False)
        try:
            warm_s = time.perf_counter() - t0
            with engine._tier_lock:
                tier0_after_warmup = engine._tier0_pipe is not None
            engine.pipe = TierLog(engine.pipe, "graph", log, t0)
            _wait(engine, lambda st: "tier0_active" not in st, timeout_s=120.0)
            engine.complete(*frames(26, 1)[0], timeout=600)
            st = engine.stats()
            tags = [k[0] for k in engine.pipe.program_keys()]
            print(f"  (i) run_serve {' '.join(extra)} --warmup-tiered --max-programs 1: "
                  f"{warm_s:.2f} s on tier 0, tier 0 active after it: {tier0_after_warmup}; "
                  f"promotions {st['tier_promotions']}; programs {tags}; the request after them "
                  f"ran on {log[-1][0]}")
            if not tier0_after_warmup or len(st["tier_promotions"]) != 1 or tags != [tag] \
                    or log[-1][:2] != ("graph", 1):
                raise AssertionError(f"(i) {name}: {tier0_after_warmup} {st} {tags} {log}")
            out[f"i_{name}"] = {"run_serve_s": warm_s, "promotions": st["tier_promotions"],
                                "programs": tags}
        finally:
            httpd.server_close()
            engine.shutdown()
        del engine, httpd
        gc.collect()
        torch.cuda.empty_cache()
    reset_launches()  # the tiers' launches are no count of the served traffic's
    return out


def serve_phase(model_dir: Path, taesd_dir: Path, steps: int) -> tuple[dict, dict]:
    """The serve CLI in process (``cli.serve.run_serve(serve_forever=False,
    port=0, max_batch=4, warmup=["480x640"])``) on the checkpoint directory
    of phase 3a, at ``min(steps, 10)`` steps per request, its HTTP server in
    a thread and clients in threads, frames of 480x640 with 500 points:

    - (a) warmup runs 3 signatures (buckets 1 and 4, and the carry) and
      captures two step programs (the carry replays bucket 1's);
    - (b) four concurrent distinct frames make one batch (stats: batches
      +1, batched_rows +4, padded_rows +0); each response is its frame's
      row of the batch the engine ran, bit for bit, and within
      ``CLI_LIMITS`` of a direct batch-1 ``pipe(...)`` call on its frame;
    - (c) three concurrent frames make one batch with padded_rows +1; the
      batch the engine ran is the three frames and a copy of the first,
      exactly, each response its own row, and the rows agree with a direct
      call on that padded batch;
    - (d) a session of 3 frames: frame 2 against a direct call carrying
      frame 1's latents; then the reset endpoint drops the session;
    - (e) 400 on a bad payload, 404 on an unknown path, 422 on an empty
      sparse map;
    - (f) each batch's kernel launches equal one request's (the graphs'
      replays counted);
    - (g), (h): the tiers (``tiered_phase``).

    Between (e) and (f), 8 closed-loop clients send 24 requests: requests/s,
    p50 and p95 latency, s/step at batch 1 and 4 and the device gap between
    consecutive batches (CUDA events), peak GiB. The launches are counted
    from 0 before the first live request and read after the last; the
    direct calls of (b)-(d) run after that. → (the ``serve`` line, the
    served traffic's launches)."""
    n_steps = min(steps, SERVE_MAX_STEPS)
    frame, points = CLI_FRAME, CLI_POINTS
    h, w = frame
    print(f"serve: cli.serve on the checkpoint directory, {n_steps} steps, --max-batch 4, "
          f"--warmup {h}x{w}, port 0")

    def frames(seed, n):
        return serve_frames(frame, points, seed, n)

    fb, fc, fd, load = frames(11, 4), frames(12, 3), frames(13, 3), frames(14, SERVE_CLIENTS)
    torch.cuda.reset_peak_memory_stats()
    engine, httpd, served, thread, warm, t_start = start_serve(
        model_dir, taesd_dir,
        ["--steps", str(n_steps), "--max-batch", "4", "--warmup", f"{h}x{w}"])
    try:
        print(f"  run_serve {t_start:.2f} s (load and warmup); warmup signatures "
              f"(batch, carry, s): {warm}")
        warmed = [k[1] for k in served.pipe.program_keys()]
        print(f"  (a) step programs captured at warmup (batch, h, w, c): {warmed}")
        if [(n, c) for n, c, _ in warm] != [(1, False), (4, False), (1, True)] \
                or sorted(warmed) != [(1, h, w, 3), (4, h, w, 3)]:
            raise AssertionError(f"(a) warmup ran {warm}, captured {warmed}")
        reset_launches()  # just before the served traffic
        status, data, _, first_s = _http(httpd, "POST", "/v1/complete", _npz(*frames(10, 1)[0]))
        if status != 200 or _dense(data).shape != (h, w, 1):
            raise AssertionError(f"first request: {status} {data[:200]}")
        print(f"  first live request: {first_s:.3f} s")

        # (b) and (c): concurrent frames in one batch
        engine.max_delay_ms, delay = SERVE_COALESCE_S * 1e3, engine.max_delay_ms
        moved, ran = [], []
        served.keep = True
        for fs in (fb, fc):
            before = engine.stats()
            answers = _post_all(httpd, fs)
            after = engine.stats()
            moved.append(({k: after[k] - before[k] for k in ("batches", "batched_rows",
                                                            "padded_rows")},
                          [int(r[2]["X-DCT-Batch-Size"]) for r in answers],
                          [_dense(r[1]) for r in answers]))
            ran.append(served.batches[-1])
        served.keep = False
        engine.max_delay_ms = delay
        for (m, sizes, _), n in zip(moved, (4, 3)):
            print(f"  ({'b' if n == 4 else 'c'}) {n} concurrent frames: {m}, batch sizes {sizes}")
            if m != {"batches": 1, "batched_rows": n, "padded_rows": 4 - n} or sizes != [n] * n:
                raise AssertionError(f"{n} concurrent frames did not make one batch of 4")

        # (d) a session of three frames, then its reset
        got_d, carried = [], []
        for img, sp in fd:
            status, data, _, _ = _http(httpd, "POST", "/v1/complete?session=cam0", _npz(img, sp))
            if status != 200:
                raise AssertionError(f"(d) session frame: {status} {data[:200]}")
            got_d.append(_dense(data))
            carried.append(engine._sessions["cam0"][0])
        status, data, _, _ = _http(httpd, "POST", "/v1/session/cam0/reset")
        print(f"  (d) reset: {status} {data.decode()}")
        if status != 200 or json.loads(data) != {"session": "cam0", "dropped": True} \
                or "cam0" in engine._sessions:
            raise AssertionError(f"(d) reset: {status} {data}")

        # (e) the error codes
        img, sp = fd[0]
        codes = {"bad payload": _http(httpd, "POST", "/v1/complete", b"not an npz")[0],
                 "unknown path": _http(httpd, "GET", "/v1/nope")[0],
                 "empty sparse": _http(httpd, "POST", "/v1/complete",
                                       _npz(img, np.zeros_like(sp)))[0]}
        print(f"  (e) {codes}")
        if codes != {"bad payload": 400, "unknown path": 404, "empty sparse": 422}:
            raise AssertionError(f"(e) status codes {codes}")

        # throughput: closed-loop clients
        first_traffic = len(served.batches)
        lats, span = _closed_loop(httpd, load, SERVE_REQUESTS)
        torch.cuda.synchronize()
        counts = launches()  # just after the served traffic
        reset_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        stop_serve(engine, httpd, thread)

    # (f) every batch launched one request's kernels
    eh, ew = latent_size(frame, 768, served.bundle.vae.downsample_factor)
    one = expected_launches(registry.MARIGOLD_UNET_CONFIG, "tiny", registry.TAESD_CONFIG,
                            (eh, ew), n_steps)
    bad = [(i, b["n"], b["launches"]) for i, b in enumerate(served.batches)
           if b["launches"] != one]
    print(f"  (f) {len(served.batches)} batches, each against {one}: {len(bad)} differ")
    if bad:
        raise AssertionError(f"(f) batch launches differ: {bad[:3]}")
    if {k: sum(b["launches"][k] for b in served.batches) for k in one} != counts:
        raise AssertionError(f"serve: launches {counts} outside the engine's batches")

    # the served rows against direct calls of the same pipeline (after the
    # traffic: these launches are comparisons)
    pipe, kw = served.pipe, dict(engine.call_kwargs)

    def direct(fs, **extra):
        return pipe(np.stack([f[0] for f in fs]), np.stack([f[1] for f in fs]), **kw, **extra)[0]

    def worst(pairs):
        errs = [_range_diff(torch.from_numpy(np.asarray(a)), b) for a, b in pairs]
        return max(e[0] for e in errs), max(e[1] for e in errs)

    # the batches' rows in arrival order: which frame each row holds; each
    # response must be its own frame's row of the batch the engine ran, bit
    # for bit (at random weights and few steps two frames' dense maps differ
    # by ~1e-4 of the range, inside the numerical limits below)
    orders = []
    for (_, _, got), fs, r, name in zip(moved, (fb, fc), ran, "bc"):
        order = _row_order(r, fs)
        rows = r["dense"].cpu().numpy()
        check(f"serve ({name}) each response is its own row of the batch (exact)",
              max(float(np.abs(got[i] - rows[order.index(i)]).max()) for i in range(len(fs))),
              0.0, "max|diff|")
        orders.append(order)
    readings = {}
    readings["b"] = worst((moved[0][2][i], direct([f])[0]) for i, f in enumerate(fb))
    order, ran_c = orders[1], ran[1]
    padded = [fc[i] for i in order] + [fc[order[0]]]
    pad_err = max(float(np.abs(ran_c["images"] - np.stack([f[0] for f in padded])).max()),
                  float(np.abs(ran_c["sparses"] - np.stack([f[1] for f in padded])).max()))
    print(f"  (c) the batch's rows hold frames {order} and a copy of its row 0: max|diff| "
          f"{pad_err:.3e}")
    check("serve (c) the padded batch is the frames and a copy of row 0", pad_err, 0.0,
          "max|diff|")
    ref = direct(padded)
    readings["c"] = worst([*((moved[1][2][i], ref[order.index(i)]) for i in range(3)),
                           (ran_c["dense"][3].cpu().numpy(), ref[3])])
    readings["d"] = worst([(got_d[1], direct(fd[1:2], pred_latents_prev=carried[0])[0])])
    no_carry = worst([(got_d[1], direct(fd[1:2])[0])])
    for name, what in (("b", "rows vs direct batch-1 calls"),
                       ("c", "rows vs the direct call on the padded batch"),
                       ("d", "session frame 2 vs the direct call with frame 1's latents")):
        rms, mx = readings[name]
        print(f"  ({name}) {what}: rms {rms:.3e}, max {mx:.3e} of 120 m")
        check(f"serve ({name}) {what} (rms)", rms, CLI_LIMITS[0], "rms/120 m")
        check(f"serve ({name}) {what} (max)", mx, CLI_LIMITS[1], "max/120 m")
    print(f"  (d) session frame 2 against the direct call without the carry: rms "
          f"{no_carry[0]:.3e}, max {no_carry[1]:.3e}")
    programs = [k[1] for k in pipe.program_keys()]
    print(f"  the served pipeline's step programs (batch, h, w, c): {programs}")
    del pipe
    tiers = tiered_phase(model_dir, taesd_dir, n_steps, served.bundle, kw, frame, points)

    per_step = {}
    for b in served.batches:
        per_step.setdefault(b["n"], []).append(b["start"].elapsed_time(b["end"]) / 1e3 / n_steps)
    traffic = served.batches[first_traffic:]
    gaps = sorted(a["end"].elapsed_time(b["start"]) for a, b in zip(traffic, traffic[1:]))
    line = {
        "steps": n_steps, "max_batch": engine.max_batch,
        "warmup_s": [{"batch": n, "carry": c, "s": dt} for n, c, dt in warm],
        "run_serve_s": t_start, "first_request_s": first_s,
        "clients": SERVE_CLIENTS, "requests": len(lats), "requests_per_s": len(lats) / span,
        "latency_s_p50": lats[len(lats) // 2], "latency_s_p95": lats[int(len(lats) * 0.95)],
        "batches": [b["n"] for b in traffic],
        "s_per_step": {f"batch{n}": sorted(v)[len(v) // 2] for n, v in sorted(per_step.items())},
        "device_gap_ms": {"median": gaps[len(gaps) // 2], "max": gaps[-1], "n": len(gaps)}
        if gaps else None,
        "peak_gib": peak, "programs": programs, "tiers": tiers,
        "checks": {**{f"{k}_{m}": v for k, (r, x) in readings.items()
                      for m, v in (("rms", r), ("max", x))}, "c_pad_err": pad_err},
        "card": card(),
    }
    print(f"  throughput: {len(lats)} requests from {SERVE_CLIENTS} clients in {span:.2f} s: "
          f"{line['requests_per_s']:.3f} req/s, p50 {line['latency_s_p50']:.3f} s, p95 "
          f"{line['latency_s_p95']:.3f} s; batches {line['batches']}; s/step "
          f"{line['s_per_step']}; device gap between batches {line['device_gap_ms']} ms; "
          f"peak {peak:.2f} GiB")
    return line, counts


SERVE_FP32_MAX_STEPS, SERVE_FP32_CLIENTS, SERVE_FP32_REQUESTS = 4, 4, 8


def fp32_serve_phase(model_dir: Path, taesd_dir: Path, steps: int) -> tuple[dict, dict]:
    """Phase 6's fp32 part: ``cli.serve.run_serve`` with ``--precision fp32``
    (``serve_forever=False``, port 0) on the checkpoint directory of phase
    3a, TAESD, ``--max-batch 4``, ``--warmup 480x640``, ``min(steps,
    SERVE_FP32_MAX_STEPS)`` steps a request, frames of 480x640 with 500
    points over HTTP:

    - (a) four concurrent frames make one batch; each response is its row of
      that batch, bit for bit, and within ``FP32_DENSE_LIMITS`` of a direct
      fp32 ``pipe(...)`` call on its frame;
    - (b) a session of two frames: frame 2 against a direct call carrying
      frame 1's latents (``FP32_DENSE_LIMITS``);
    - (c) every batch's kernel launches equal one request's
      ``expected_launches(dtype=torch.float32)`` (``conv3x3_fp32``, the fp32
      flash pair at d=64, the epilogue): no bf16 kernel launches;
    - (d) ``--vae original --max-batch 1``: one request over HTTP against a
      direct call, its launches the fp32 KL request's (``fp32_serve_kl``).

    Between (b) and (c), ``SERVE_FP32_CLIENTS`` closed-loop clients send
    ``SERVE_FP32_REQUESTS`` requests. Readings: warmup seconds per signature
    (the capture included), requests/s, p50 latency, s/step at batch 1 and
    4 (CUDA events per batch), peak GiB, the card. The launches are counted
    from 0 before the first live request and read after the last; the
    direct calls run after that. → (the readings, the served traffic's
    launches)."""
    n_steps = min(steps, SERVE_FP32_MAX_STEPS)
    frame, points = CLI_FRAME, CLI_POINTS
    h, w = frame
    print(f"serve fp32: cli.serve --precision fp32 on the checkpoint directory, {n_steps} steps, "
          f"--max-batch 4, --warmup {h}x{w}, port 0")
    batch_frames = serve_frames(frame, points, 31, 4)
    session_frames = serve_frames(frame, points, 32, 2)
    load = serve_frames(frame, points, 33, SERVE_FP32_CLIENTS)
    torch.cuda.reset_peak_memory_stats()
    engine, httpd, served, thread, warm, t_start = start_serve(
        model_dir, taesd_dir, ["--precision", "fp32", "--steps", str(n_steps), "--max-batch", "4",
                               "--warmup", f"{h}x{w}"])
    try:
        print(f"  run_serve {t_start:.2f} s (load and warmup); warmup signatures "
              f"(batch, carry, s): {warm}")
        if served.bundle.dtype != torch.float32:
            raise AssertionError(f"serve --precision fp32 loaded a {served.bundle.dtype} bundle")
        reset_launches()  # just before the served traffic
        engine.max_delay_ms, delay = SERVE_COALESCE_S * 1e3, engine.max_delay_ms
        served.keep = True
        before = engine.stats()
        answers = _post_all(httpd, batch_frames)
        after = engine.stats()
        served.keep = False
        engine.max_delay_ms = delay
        moved = {k: after[k] - before[k] for k in ("batches", "batched_rows", "padded_rows")}
        print(f"  (a) 4 concurrent frames: {moved}")
        if moved != {"batches": 1, "batched_rows": 4, "padded_rows": 0}:
            raise AssertionError(f"serve fp32 (a): 4 concurrent frames made {moved}")
        ran, got_a = served.batches[-1], [_dense(r[1]) for r in answers]
        got_b, carried = [], []
        for img, sp in session_frames:
            status, data, _, _ = _http(httpd, "POST", "/v1/complete?session=fp32", _npz(img, sp))
            if status != 200:
                raise AssertionError(f"serve fp32 (b) session frame: {status} {data[:200]}")
            got_b.append(_dense(data))
            carried.append(engine._sessions["fp32"][0])
        lats, span = _closed_loop(httpd, load, SERVE_FP32_REQUESTS)
        torch.cuda.synchronize()
        counts = launches()  # just after the served traffic
        reset_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        stop_serve(engine, httpd, thread)

    eh, ew = latent_size(frame, 768, served.bundle.vae.downsample_factor)
    one = expected_launches(served.bundle.unet_config, "tiny", served.bundle.vae.config, (eh, ew),
                            n_steps, dtype=torch.float32)
    bad = [(i, b["n"], b["launches"]) for i, b in enumerate(served.batches)
           if b["launches"] != one]
    bf16 = {k: n for k, n in counts.items() if n and k not in
            {k for k, v in one.items() if v}}
    print(f"  (c) {len(served.batches)} batches, each against "
          f"{({k: n for k, n in one.items() if n})}: {len(bad)} differ; kernels outside the fp32 "
          f"forms: {bf16}")
    if bad or bf16:
        raise AssertionError(f"serve fp32 (c): batch launches differ {bad[:3]}, other kernels "
                             f"{bf16}")
    if {k: sum(b["launches"][k] for b in served.batches) for k in one} != counts:
        raise AssertionError(f"serve fp32: launches {counts} outside the engine's batches")

    pipe, kw = served.pipe, dict(engine.call_kwargs)

    def direct(f, **extra):
        return pipe(f[0][None], f[1][None], **kw, **extra)[0][0]

    order = _row_order(ran, batch_frames)
    rows = ran["dense"].cpu().numpy()
    exact = max(float(np.abs(got_a[i] - rows[order.index(i)]).max()) for i in range(4))
    check("serve fp32 (a) each response is its own row of the batch (exact)", exact, 0.0,
          "max|diff|")
    readings = {"a": [_range_diff(torch.from_numpy(got_a[i]), direct(f))
                      for i, f in enumerate(batch_frames)],
                "b": [_range_diff(torch.from_numpy(got_b[1]),
                                  direct(session_frames[1], pred_latents_prev=carried[0]))]}
    for name, what in (("a", "rows vs direct batch-1 fp32 calls"),
                       ("b", "session frame 2 vs the direct call with frame 1's latents")):
        rms, mx = max(r[0] for r in readings[name]), max(r[1] for r in readings[name])
        readings[name] = (rms, mx)
        print(f"  ({name}) {what}: rms {rms:.3e}, max {mx:.3e} of 120 m")
        check(f"serve fp32 ({name}) {what} (rms)", rms, FP32_DENSE_LIMITS[0], "rms/120 m")
        check(f"serve fp32 ({name}) {what} (max)", mx, FP32_DENSE_LIMITS[1], "max/120 m")
    per_step = {}
    for b in served.batches:
        per_step.setdefault(b["n"], []).append(b["start"].elapsed_time(b["end"]) / 1e3 / n_steps)
    line = {
        "steps": n_steps, "max_batch": 4,
        "warmup_s": [{"batch": n, "carry": c, "s": dt} for n, c, dt in warm],
        "run_serve_s": t_start, "clients": SERVE_FP32_CLIENTS, "requests": len(lats),
        "requests_per_s": len(lats) / span, "latency_s_p50": lats[len(lats) // 2],
        "s_per_step": {f"batch{n}": sorted(v)[len(v) // 2] for n, v in sorted(per_step.items())},
        "peak_gib": peak, "exact_row_err": exact,
        "checks": {f"{k}_{m}": v for k, (r, x) in readings.items()
                   for m, v in (("rms", r), ("max", x))},
        "card": card(),
    }
    print(f"  throughput: {len(lats)} requests from {SERVE_FP32_CLIENTS} clients in {span:.2f} s: "
          f"{line['requests_per_s']:.3f} req/s, p50 {line['latency_s_p50']:.3f} s; s/step "
          f"{line['s_per_step']}; peak {peak:.2f} GiB")
    del pipe, served, engine, httpd
    gc.collect()
    torch.cuda.empty_cache()
    line["kl"], kl_counts = fp32_serve_kl(model_dir, taesd_dir, n_steps)
    for k, n in kl_counts.items():
        counts[k] += n
    return line, counts


def fp32_serve_kl(model_dir: Path, taesd_dir: Path, n_steps: int) -> tuple[dict, dict]:
    """(d): ``run_serve`` with ``--vae original --precision fp32 --max-batch 1
    --warmup 480x640``: one request over HTTP, its launches the fp32 KL
    request's (``expected_launches``), its dense map within
    ``FP32_DENSE_LIMITS`` of a direct call on its frame. → (the readings, the
    request's launches)."""
    frame, points = CLI_FRAME, CLI_POINTS
    h, w = frame
    img, sp = serve_frames(frame, points, 34, 1)[0]
    torch.cuda.reset_peak_memory_stats()
    engine, httpd, served, thread, warm, t_start = start_serve(
        model_dir, taesd_dir, ["--vae", "original", "--precision", "fp32", "--steps", str(n_steps),
                               "--max-batch", "1", "--warmup", f"{h}x{w}"])
    try:
        reset_launches()  # just before the request
        status, data, _, latency = _http(httpd, "POST", "/v1/complete", _npz(img, sp))
        torch.cuda.synchronize()
        counts = launches()  # just after
        reset_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        stop_serve(engine, httpd, thread)
    if status != 200:
        raise AssertionError(f"serve fp32 (d) KL request: {status} {data[:200]}")
    bundle = served.bundle
    eh, ew = latent_size(frame, 768, bundle.vae.downsample_factor)
    one = expected_launches(bundle.unet_config, "kl", bundle.vae.config, (eh, ew), n_steps,
                            dtype=torch.float32)
    print(f"  (d) --vae original: run_serve {t_start:.2f} s, warmup {warm}, request "
          f"{latency:.3f} s, launches {({k: n for k, n in counts.items() if n})}, peak "
          f"{peak:.2f} GiB")
    if bundle.vae.kind != "kl" or bundle.dtype != torch.float32 or counts != one:
        raise AssertionError(f"serve fp32 (d): a {bundle.vae.kind} {bundle.dtype} bundle launched "
                             f"{counts} != {one}")
    kw = dict(engine.call_kwargs)
    direct = served.pipe(img[None], sp[None], **kw)[0][0]
    rms, mx = _range_diff(torch.from_numpy(_dense(data)), direct)
    print(f"  (d) the served map vs a direct call: rms {rms:.3e}, max {mx:.3e} of 120 m")
    check("serve fp32 (d) KL map vs a direct call (rms)", rms, FP32_DENSE_LIMITS[0], "rms/120 m")
    check("serve fp32 (d) KL map vs a direct call (max)", mx, FP32_DENSE_LIMITS[1], "max/120 m")
    del served, engine, httpd, bundle
    gc.collect()
    torch.cuda.empty_cache()
    return {"run_serve_s": t_start, "warmup_s": [{"batch": n, "carry": c, "s": dt}
                                                 for n, c, dt in warm],
            "latency_s": latency, "peak_gib": peak, "rms": rms, "max": mx}, counts


# ---------------------------------------------------------------------------
# Phase 7: the distributed layer (torchrun, NCCL, tensor parallelism)
# ---------------------------------------------------------------------------

DIST_MAX_STEPS = 10
DIST_TIMEOUT_S = 240
KITTI_FRAMES, KITTI_FRAME, KITTI_POINTS, KITTI_RES = 2, (352, 1216), 2000, 1216
# (c)'s ensemble over a data axis of 2 ranks on one card: 3 frames x 2
# members put rows 0-2 on rank 0 and 3-5 on rank 1, whose first row is
# member 1 (its local index would say member 0)
ENSEMBLE_MESH = {"frames": 3, "members": 2, "steps": 2}
WORKER_SPLIT = "::"  # separates a CLI worker's runs


def start_torchrun(nproc: int, worker: str, out: Path, args: list[str],
                   timeout: float = DIST_TIMEOUT_S, check_rc: bool = True,
                   env: dict | None = None):
    """Start ``python -m torch.distributed.run --standalone
    --nproc_per_node=N`` of this script in ``worker`` mode, in a session of
    its own, its output into ``out``. → a function that waits for it (past
    ``timeout`` it kills every process of the session: torchrun's agent and
    its ranks) and returns (each rank's JSON result, the output's lines)."""
    out.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", str(Path(__file__).resolve()), worker, str(out), "--",
           *args]
    log_path, deadline = out / "output.log", time.monotonic() + timeout
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
                                env=None if env is None else {**os.environ, **env})

    def finish() -> tuple[list[dict], list[str]]:
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise AssertionError(f"torchrun {worker} x{nproc} did not finish in {timeout} s:\n"
                                 f"{log_path.read_text()[-3000:]}")
        lines = log_path.read_text().splitlines()
        for line in lines:
            if line.startswith("  "):  # the ranks' readings
                print(line)
        results = [json.loads(p.read_text()) for p in sorted(out.glob("rank*.json"))]
        if check_rc and (rc != 0 or len(results) != nproc):
            raise AssertionError(f"torchrun {worker} x{nproc} exited {rc} with {len(results)} "
                                 "results:\n" + "\n".join(lines[-60:]))
        return results, lines

    return finish


def torchrun(nproc: int, worker: str, out: Path, args: list[str]) -> list[dict]:
    """``start_torchrun`` and its wait → each rank's JSON result."""
    return start_torchrun(nproc, worker, out, args)()[0]


def _result(out: Path, payload: dict) -> None:
    (out / f"rank{os.environ.get('RANK', '0')}.json").write_text(json.dumps(payload))


def cli_worker(out: Path, args: list[str]) -> int:
    """One torchrun rank: the predict CLI in process for each run of
    ``args`` (runs separated by ``WORKER_SPLIT``), launches counted from 0
    around each. With one run the CLI joins the group itself
    (``--multihost true``); with more, the rank joins first and the runs
    share the group."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs, cur = [], []
    for a in args:
        if a == WORKER_SPLIT:
            runs.append(cur)
            cur = []
        else:
            cur.append(a)
    runs.append(cur)
    if len(runs) > 1:
        dist_core.initialize()
    results = []
    for argv in runs:
        reset_launches()  # just before the run
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        totals = predict_cli.main(argv)
        torch.cuda.synchronize()
        results.append({"totals": totals, "wall_s": time.perf_counter() - t0,
                        "launches": launches()})  # just after
    _result(out, {"rank": int(os.environ["RANK"]), "runs": results,
                  "nccl": ".".join(str(v) for v in torch.cuda.nccl.version())})
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def tp_worker(out: Path, args: list[str]) -> int:
    """One of two gloo ranks on one card (``cuda:0``; gloo's all_reduce and
    broadcast take CUDA tensors): one full-width TAESD guided step with the
    UNet tensor-parallel over both ranks (M=2) against the whole UNet
    (``reference_step_check``, ``REF_LIMITS``), launches counted; then an
    ensemble over a data axis of both ranks against the same ensemble in one
    process: the image rows and member noise each rank hands the sampler
    equal to the one-process rows it owns, exactly (at random weights the
    maps hardly see which frame or member a row is), and the members within
    ``CLI_LIMITS`` of the one-process members (two runs of one request)."""
    model_dir, taesd_dir = Path(args[0]), Path(args[1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = dist_core.initialize(device="cuda:0", backend="gloo")
    rank = dist.get_rank()
    result: dict = {"rank": rank, "backend": dist.get_backend()}
    try:
        bundle = load_bundle(model_dir, "tiny", taesd_dir, torch.bfloat16, device=dev)
        tp = sharding.shard_bundle(mesh_core.make_mesh(mesh_core.MeshSpec(data=1, model=2)),
                                   bundle, tensor_parallel=True)
        images, sparses = path_inputs(CLI_FRAME, CLI_POINTS)
        reset_launches()
        result["tp_step"] = reference_step_check(
            bundle, fp32_bundle(bundle), images.to(dev), sparses.to(dev), tp_bundle=tp,
            label=f"rank {rank}: tensor-parallel step (M=2)")
        result["tp_launches"] = launches()
        # per rank, the tensor-parallel and the whole step each launch one
        # step's kernels (a sharded stage's flash call on heads / M); the
        # fp32 run takes none
        one = expected_launches(registry.MARIGOLD_UNET_CONFIG, "tiny", registry.TAESD_CONFIG,
                                (72, 96), 1, mode="step")
        want = {k: 2 * len(REF_SEEDS) * n for k, n in one.items()}
        if result["tp_launches"] != want:
            raise AssertionError(f"rank {rank}: TP step launches {result['tp_launches']} != "
                                 f"{want}")
        departures = sharding.tp_departures(bundle.unet_params, bundle.unet_config, 2)
        result["tp_departures"] = {why: sum(1 for v in departures.values() if v == why)
                                   for why in sorted(set(departures.values()))}
        mesh = mesh_core.make_mesh(mesh_core.MeshSpec(data=2, model=1))
        images, sparses = path_inputs(CLI_FRAME, CLI_POINTS, batch=ENSEMBLE_MESH["frames"])
        kw = dict(max_depth=120.0, steps=ENSEMBLE_MESH["steps"], norm="const", resolution=768,
                  ensemble_size=ENSEMBLE_MESH["members"])
        with spy_ensemble_rows() as fed_mesh:
            reset_launches()
            _, members = DepthCompletionPipeline(bundle)(images, sparses, ensemble_mesh=mesh,
                                                         **kw)
            result["ensemble_launches"] = launches()
        want = expected_launches(registry.MARIGOLD_UNET_CONFIG, "tiny", registry.TAESD_CONFIG,
                                 (72, 96), ENSEMBLE_MESH["steps"])
        if result["ensemble_launches"] != want:  # this rank's rows, one request
            raise AssertionError(f"rank {rank}: ensemble launches {result['ensemble_launches']}"
                                 f" != {want}")
        with spy_ensemble_rows() as fed_one:
            _, alone = DepthCompletionPipeline(bundle)(images, sparses, **kw)
        rows = len(fed_mesh[0][0])
        own = slice(rank * rows, (rank + 1) * rows)
        rows_err = max(float((a - b[own]).abs().max()) for a, b in zip(fed_mesh[0], fed_one[0]))
        print(f"  rank {rank}: ensemble rows {own.start}-{own.stop - 1} of "
              f"{len(fed_one[0][0])}: images and member noise fed against one process's, max "
              f"{rows_err:.3e}")
        check(f"rank {rank}: ensemble rows fed over the data axis vs one process", rows_err,
              0.0)
        result["ensemble_rows_err"] = rows_err
        rms, worst = _range_errors([members.float().cpu().numpy()],
                                   [alone.float().cpu().numpy()])
        print(f"  rank {rank}: ensemble over a data axis of 2 against one process: members rms "
              f"{rms:.3e}, max {worst:.3e} of the 120 m range")
        check(f"rank {rank}: ensemble over the data axis vs one process (members, rms)", rms,
              CLI_LIMITS[0], "rms/120 m")
        check(f"rank {rank}: ensemble over the data axis vs one process (members, max)", worst,
              CLI_LIMITS[1], "max/120 m")
        result["ensemble_vs_one_process"] = {"rms": rms, "max": worst}
    finally:
        result["failures"] = FAILURES
        _result(out, result)
        dist.destroy_process_group()
    return 0


def nccl_pair_worker(out: Path, args: list[str]) -> int:
    """One of two NCCL ranks on one card: one all_reduce; → what NCCL says."""
    try:
        dist_core.initialize(device="cuda:0", initialization_timeout=60)
        x = torch.ones(1, device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        said = f"ran: all_reduce gave {float(x)}"
    except Exception as e:  # noqa: BLE001 - recorded, the phase's finding
        said = f"{type(e).__name__}: {str(e).strip().splitlines()[0][:300]}"
    _result(out, {"rank": int(os.environ["RANK"]), "said": said})
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


@contextlib.contextmanager
def spy_ensemble_rows():
    """Records the (images, init_noise) rows ``parallel.ensemble`` hands
    ``guided_sample``, per call."""
    fed = []
    call = TE.guided_sample

    def spy(bundle, images, sparses, cfg, *args, init_noise=None, **kwargs):
        fed.append((images.float(), init_noise.float()))
        return call(bundle, images, sparses, cfg, *args, init_noise=init_noise, **kwargs)

    TE.guided_sample = spy
    try:
        yield fed
    finally:
        TE.guided_sample = call


WORKERS = {"--cli-worker": cli_worker, "--tp-worker": tp_worker,
           "--nccl-pair-worker": nccl_pair_worker}


def _dense_maps(out: Path) -> list[np.ndarray]:
    return [codecs.load_array(p) for p in sorted((out / "scene" / "dense").glob("*.dcz"))]


def _range_errors(got: list[np.ndarray], ref: list[np.ndarray]) -> tuple[float, float]:
    """(rms, max) of the maps' difference over the 120 m range."""
    if len(got) != len(ref) or not got:
        raise AssertionError(f"{len(got)} maps against {len(ref)}")
    diff = np.stack(got) / 120.0 - np.stack(ref) / 120.0
    return float(np.sqrt(np.mean(diff**2))), float(np.abs(diff).max())


def distributed_phase(model_dir: Path, taesd_dir: Path, root: Path, steps: int, graphs: dict,
                      cli_out: Path) -> tuple[dict, dict]:
    """(a) ``torchrun --standalone --nproc_per_node=1`` of the predict CLI
    with ``--multihost true`` (a real NCCL group of one rank on the card) at
    ``min(steps, 10)`` steps over phase 4's three 480x640 frames on phase
    3's checkpoint directory: world 1, backend nccl, three frames written,
    launches three times one request's, the dense maps against phase 4's
    single-process run of the same frames and seed (the same CLI in process
    at those steps where phase 4 ran more) within phase 3's graph-against-
    eager limit for the dense map (``flash_bwd``'s dq atomics make two runs
    differ; at 50 steps that limit is loose) and within ``CLI_LIMITS`` (two
    runs of one request through the CLI); (c) two gloo ranks on the one
    card (``tp_worker``) and two NCCL ranks on it (``nccl_pair_worker``:
    what NCCL says), both beside (a)'s single-process reference, since none
    of the three is timed; (b) with two or more cards, at world min(4,
    cards): native-res over ``ProcessGroupRing`` on KITTI frames against
    the pipeline with ``LocalRing(P)``, data parallel at batch 4 and
    ``--mesh-model 2`` against the CLI in one process (``CLI_LIMITS``); on
    one card, that it did not run and why. → (the ``distributed`` line,
    (a)'s launch counts)."""
    t_phase = time.perf_counter()
    n_steps = min(steps, DIST_MAX_STEPS)
    dense_limit = graphs[PATHS[0].label]["graph_vs_twin"]["dense"]["limit"]
    data = root / "data"  # phase 4's frames
    base = ["--checkpoint-dir", str(model_dir), "--taesd-dir", str(taesd_dir), "--steps",
            str(n_steps), "--vis", "false", "--log-level", "WARNING"]
    print(f"distributed (a): torchrun --standalone --nproc_per_node=1 of the predict CLI, "
          f"--multihost true, {CLI_FRAMES} frames of {CLI_FRAME}, {n_steps} steps")
    out_a = root / "dist_a"
    (a,) = torchrun(1, "--cli-worker", root / "dist_a_results",
                    [str(data), str(out_a), *base, "--multihost", "true"])
    run = a["runs"][0]
    totals = run["totals"]
    if (totals["world"], totals["backend"], totals["frames"], totals["written"]) != \
            (1, "nccl", CLI_FRAMES, CLI_FRAMES):
        raise AssertionError(f"(a) totals {totals}")
    eh, ew = latent_size(CLI_FRAME, 768, 2 ** (len(registry.TAESD_CONFIG.encoder_blocks) - 1))
    one = expected_launches(registry.MARIGOLD_UNET_CONFIG, "tiny", registry.TAESD_CONFIG,
                            (eh, ew), n_steps)
    if run["launches"] != {k: CLI_FRAMES * n for k, n in one.items()}:
        raise AssertionError(f"(a) launches {run['launches']} != {CLI_FRAMES} x {one}")
    # (c) and the NCCL pair run beside (a)'s single-process reference (no
    # time is read from any of them)
    print("distributed (c): two gloo ranks on the one card: a tensor-parallel guided step "
          "(M=2) against the whole UNet; an ensemble over a data axis of 2")
    finish_c = start_torchrun(2, "--tp-worker", root / "dist_c_results",
                              [str(model_dir), str(taesd_dir)])
    finish_pair = start_torchrun(2, "--nccl-pair-worker", root / "dist_nccl_pair", [],
                                 timeout=90, check_rc=False, env={"NCCL_DEBUG": "WARN"})
    ref_dir = cli_out
    if n_steps != steps:
        ref_dir = root / "dist_a_reference"
        predict_cli.main([str(data), str(ref_dir), *base])
    got, ref = _dense_maps(out_a), _dense_maps(ref_dir)
    err = max(_rel(torch.from_numpy(g), torch.from_numpy(r)) for g, r in zip(got, ref))
    rms, worst = _range_errors(got, ref)
    a_line = {"world": totals["world"], "backend": totals["backend"], "nccl": a["nccl"],
              "steps": n_steps, "frames": totals["frames"],
              "s_per_frame": run["wall_s"] / totals["frames"],
              "infer_s_per_frame": totals["time_infer"] / totals["frames"],
              "launches": run["launches"], "vs_single_process": err, "graph_limit": dense_limit,
              "vs_single_process_rms": rms, "vs_single_process_max": worst}
    print(f"  (a) world {totals['world']}, backend {totals['backend']}, NCCL {a['nccl']}: "
          f"{a_line['s_per_frame']:.2f} s/frame (load included; infer "
          f"{a_line['infer_s_per_frame']:.2f}), launches {run['launches']}; dense maps against "
          f"the single-process run: max|diff|/max|ref| {err:.3e} (phase 3's graph limit "
          f"{dense_limit:.3e}), rms {rms:.3e} and max {worst:.3e} of the 120 m range")
    check("distributed (a): torchrun NCCL world 1 vs the single-process CLI (dense)", err,
          dense_limit, "max|diff|/max|ref|")
    check("distributed (a): vs the single-process CLI (rms)", rms, CLI_LIMITS[0], "rms/120 m")
    check("distributed (a): vs the single-process CLI (max)", worst, CLI_LIMITS[1], "max/120 m")

    c, _ = finish_c()
    for r in c:
        FAILURES.extend(r["failures"])
    pair, pair_log = finish_pair()
    warn = sorted({line.split("NCCL WARN", 1)[1].strip()[:200] for line in pair_log
                   if "NCCL WARN" in line})
    said = sorted({r["said"] for r in pair}) + warn or ["no rank reported"]
    print(f"  NCCL, two ranks on one card: {said}")
    c_line = {"backend": c[0]["backend"], "tp_step": [r["tp_step"] for r in c],
              "tp_launches_per_rank": c[0]["tp_launches"],
              "tp_departures": c[0]["tp_departures"],
              "ensemble_rows_err": [r["ensemble_rows_err"] for r in c],
              "ensemble_vs_one_process": [r["ensemble_vs_one_process"] for r in c],
              "ensemble_launches_per_rank": c[0]["ensemble_launches"], "nccl_pair": said}

    count = torch.cuda.device_count()
    if count >= 2:
        b_line = distributed_cards(model_dir, taesd_dir, root, base, min(4, count), ref_dir)
    else:
        b_line = {"ran": False, "reason": f"one card (torch.cuda.device_count() = {count}): "
                  "native-res over ProcessGroupRing, data parallel at batch 4 and "
                  "--mesh-model 2 need two or more"}
        print(f"distributed (b): not run: {b_line['reason']}")
    phase_s = time.perf_counter() - t_phase
    print(f"distributed: phase 7 took {phase_s:.1f} s")
    return ({"a": a_line, "b": b_line, "c": c_line, "phase_s": phase_s, "card": card()},
            run["launches"])


def distributed_cards(model_dir: Path, taesd_dir: Path, root: Path, base: list[str], world: int,
                      ref_dir: Path) -> dict:
    """(b): one torchrun of ``world`` ranks, one per card, running the CLI
    three times in one group: native-res on KITTI frames (the ring over the
    data axis of every rank), data parallel at batch 4, ``--mesh-model 2``;
    each against its one-card counterpart within ``CLI_LIMITS``."""
    print(f"distributed (b): {world} cards: native-res, data parallel at batch 4, "
          "--mesh-model 2")
    kitti, k_imgs, k_sparse = cli_dataset(root / "dist_kitti", seed=2, frames=KITTI_FRAMES,
                                          frame=KITTI_FRAME, points=KITTI_POINTS)
    four, _, _ = cli_dataset(root / "dist_four", seed=3, frames=4)
    runs = {"native_res": [str(kitti), str(root / "dist_b_native_res"), *base, "--res",
                           str(KITTI_RES), "--native-res", "true"],
            "data_parallel": [str(four), str(root / "dist_b_dp"), *base, "--batch-size", "4"],
            "mesh_model_2": [str(root / "data"), str(root / "dist_b_tp"), *base,
                             "--mesh-model", "2"]}
    args = []
    for argv in runs.values():
        args += [*argv, "--multihost", "true", WORKER_SPLIT]
    results = torchrun(world, "--cli-worker", root / "dist_b_results", args[:-1])
    # the one-card counterparts
    bundle = load_bundle(model_dir, "tiny", taesd_dir, torch.bfloat16, device=DEV)
    steps = int(base[base.index("--steps") + 1])
    pipe = DepthCompletionPipeline(bundle)
    native_ref = [pipe(k_imgs[f:f + 1].astype(np.float32),
                       120.0 * (k_sparse[f:f + 1, ..., None].astype(np.float32) / 255.0),
                       max_depth=120.0, steps=steps, norm="const", resolution=KITTI_RES,
                       ring_mesh=ra.LocalRing(world))[0][0].float().cpu().numpy()
                  for f in range(KITTI_FRAMES)]
    del pipe, bundle
    predict_cli.main([str(four), str(root / "dist_b_dp_reference"), *base, "--batch-size", "4"])
    refs = {"native_res": native_ref, "data_parallel": _dense_maps(root / "dist_b_dp_reference"),
            "mesh_model_2": _dense_maps(ref_dir)}
    outs = {"native_res": root / "dist_b_native_res", "data_parallel": root / "dist_b_dp",
            "mesh_model_2": root / "dist_b_tp"}
    line = {"ran": True, "world": world, "nccl": results[0]["nccl"]}
    for i, name in enumerate(runs):
        rms, worst = _range_errors(_dense_maps(outs[name]), refs[name])
        totals = [r["runs"][i]["totals"] for r in results]
        line[name] = {"rms": rms, "max": worst, "written": [t["written"] for t in totals],
                      "s_per_frame": results[0]["runs"][i]["wall_s"] / max(1, totals[0]["frames"]),
                      "launches_per_rank": [r["runs"][i]["launches"] for r in results]}
        print(f"  (b) {name}: against one card rms {rms:.3e}, max {worst:.3e} of the 120 m "
              f"range; written per rank {line[name]['written']}")
        check(f"distributed (b) {name} vs one card (rms)", rms, CLI_LIMITS[0], "rms/120 m")
        check(f"distributed (b) {name} vs one card (max)", worst, CLI_LIMITS[1], "max/120 m")
    return line


# ---------------------------------------------------------------------------
# Phase 8: the configuration drivers (scripts/*_torch.py), as a user runs them
# ---------------------------------------------------------------------------

SCRIPTS = Path(__file__).resolve().parent / "scripts"
# each driver at a reduced size: (script, its env)
DRIVERS = {
    "nativeres": ("bench_nativeres_torch.py", {"NR_BATCH": "1", "NR_STEPS": "2"}),
    "frontier": ("frontier_torch.py", {"FRONTIER_BATCH": "1", "FRONTIER_REF_STEPS": "2",
                                       "FRONTIER_MODES": "full-50,fast-50,lcm-4,ddim-10"}),
    "kitti": ("bench_kitti_torch.py", {"KB_FRAMES": "2", "KB_ENSEMBLE": "2", "KB_STEPS": "2"}),
    "scaling": ("bench_scaling_torch.py", {"BENCH_FULL": "1", "BENCH_STEPS": "2"}),
}
DRIVERS_TIMEOUT_S = 300
# expected_launches' mode of each frontier mode
FRONTIER_LAUNCH_MODES = {"full-50": "per-step", "fast-50": "fast_guidance", "lcm-4": "forward",
                         "lcm-8": "forward", "ddim-25": "per-step", "ddim-10": "per-step"}
# (c): kitti-native-ring1 against kitti-native on the same frames (2 steps,
# batch 1), (rms, max) of the dense maps' difference over the 120 m range.
# At P=1 the ring's forward is the flash forward kernel itself (one visiting
# block, no state); its backward is the ring step kernel (dq and dk|dv added
# in fp32 in place) where kitti-native runs flash_bwd (dq by atomics), and
# stage 2 and the mid block take the ring where kitti-native runs the plain
# attention. So the sound difference is systematic: rms 3.65e-5 to 3.70e-5,
# max 5.65e-4 to 6.87e-4 over twelve runs (NVIDIA H100 80GB HBM3, 700 W). At
# random weights the near-uniform softmax passes little gradient through the
# attention, and Adam's first steps move each element by about lr whatever
# the gradient's size, so a backward fault moves the maps little
# (scripts/ring1_sensitivity_torch.py): the ring's log-sum-exp saved in nats
# (F56, p off by 2^(0.31 lse2)) reads rms 1.28e-4, max 1.43e-3 to 1.54e-3;
# dk and dv swapped in the ring's backward 4.35e-5, 6.5e-4, which (c) cannot
# see (PERF.md, Findings). The limits sit 1.9x / 1.7x above the sound
# readings and 1.8x / 1.2x below F56's.
RING1_LIMITS = (7e-5, 1.2e-3)
# (f): a scaling row's request can take no less than this share of the same
# request timed here, alone on the card (the mean of three by the wall clock)
SCALING_TIME_SHARE = 0.5


def _driver_rows(stdout: str) -> list[dict]:
    return [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]


def _want_launches(got: dict, latent_hw, steps: int, **kwargs) -> dict:
    """``expected_launches`` of a bench-bundle request (Marigold UNet,
    TAESD) on the kernels a driver row counts; every other kernel must be
    0."""
    want = expected_launches(registry.MARIGOLD_UNET_CONFIG, "tiny", registry.TAESD_CONFIG,
                             tuple(latent_hw), steps, **kwargs)
    if any(n for k, n in want.items() if k not in got):
        raise AssertionError(f"a row counts {sorted(got)}, the request launches {want}")
    return {k: want[k] for k in got}


def drivers_phase(root: Path) -> dict:
    """Phase 8: the four configuration drivers, each as a user runs it
    (``python3 scripts/<driver>.py`` with its env, ``DRIVERS``), at once, each
    in a session of its own (past ``DRIVERS_TIMEOUT_S`` every process of it
    is killed); meanwhile (c) in process. (a) each exits 0 and prints
    parseable rows naming this card and its power limit; (b) each row's
    kernel launches (one timed request; bench_kitti: per batch of the CLI's
    run, the run's count a whole multiple) equal ``expected_launches`` of its
    mode, steps and latent (remat as the row reports it); (c) on the same
    frames, through ``bench_nativeres_torch.run_mode``, the dense maps of
    kitti-native-ring1 against kitti-native (``RING1_LIMITS``); (d) the
    frontier's full-50 is its reference and no other row is, every other
    row's drift finite and above 0, and every row's anchor MAE and drift
    equal to those recomputed here from the maps it saved; (e) bench_kitti's
    frames/s equals KB_BATCH over the steady ``time/infer`` (the fastest
    after the first) of the list it parsed, and it checked one map per frame
    (each finite and (352, 1216, 1), or it exits non-zero); (f) bench_scaling prints the n = 1 data-parallel
    row with scaling_efficiency 1.0 and the n = 1 ring row, and each row's
    request takes at least ``SCALING_TIME_SHARE`` of the same request timed
    here (the mean of three, by the wall clock up to their maps' copy).
    → the ``drivers`` line."""
    from scripts import bench_nativeres_torch as nativeres
    from scripts import bench_scaling_torch as scaling
    from scripts import drivers_torch

    t_phase = time.perf_counter()
    root.mkdir(parents=True, exist_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    env = {k: v for k, v in os.environ.items() if not k.endswith("_DEVICE")}
    extra = {"frontier": {"FRONTIER_SAVE": str(root / "frontier")}}
    procs, logs = {}, {}
    try:
        for name, (script, knobs) in DRIVERS.items():
            logs[name] = (root / f"{name}.out", root / f"{name}.err")
            with open(logs[name][0], "w") as out, open(logs[name][1], "w") as err:
                procs[name] = subprocess.Popen(
                    [sys.executable, str(SCRIPTS / script)], stdout=out, stderr=err,
                    env={**env, **knobs, **extra.get(name, {})}, start_new_session=True,
                    cwd=SCRIPTS.parent)
            print(f"drivers: {script} with {' '.join(f'{k}={v}' for k, v in knobs.items())}")

        # (c) in process while the drivers run
        bundle = drivers_torch.bench_bundle(DEV)
        images, sparse = drivers_torch.synthetic_frames(1, *nativeres.FRAME, nativeres.POINTS)
        modes = nativeres.make_modes(2)
        ring1 = {}
        for mode in ("kitti-native", "kitti-native-ring1"):
            row, ring1[mode] = nativeres.run_mode(DepthCompletionPipeline(bundle), modes[mode],
                                                  images, sparse, 1)
            print(f"  (c) {mode}: {row['frames_per_sec_per_chip']:.3f} frames/s, launches "
                  f"{row['launches']}")
        rms, worst = _range_errors([ring1["kitti-native-ring1"]], [ring1["kitti-native"]])
        check("drivers (c) kitti-native-ring1 vs kitti-native (rms)", rms, RING1_LIMITS[0],
              "rms/120 m")
        check("drivers (c) kitti-native-ring1 vs kitti-native (max)", worst, RING1_LIMITS[1],
              "max/120 m")

        deadline = time.monotonic() + DRIVERS_TIMEOUT_S
        outputs = {}
        for name, proc in procs.items():
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"drivers: {name} did not finish in {DRIVERS_TIMEOUT_S} s")
            out, err = (p.read_text() for p in logs[name])
            print(f"  (a) {DRIVERS[name][0]}: rc {rc} after "
                  f"{time.perf_counter() - t_phase:.1f} s")
            if rc != 0:
                raise AssertionError(f"drivers: {name} exited {rc}:\n{err[-3000:]}")
            outputs[name] = _driver_rows(out)
    finally:  # none outlives the phase, also when one fails
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()

    # (a) rows that name this card
    the_card = card()
    for name, rows in outputs.items():
        if not rows or any(r.get("card") != the_card for r in rows):
            raise AssertionError(f"drivers (a): {name}'s rows {rows} do not name {the_card}")
    nr, fr, (kb,), sc = (outputs[k] for k in DRIVERS)

    # (b) launches against expected_launches
    def hold(label: str, got: dict, want: dict) -> None:
        print(f"  (b) {label}: launches {got}")
        if got != want:
            raise AssertionError(f"drivers (b) {label}: launches {got} != {want}")

    if [r["mode"] for r in nr] != list(nativeres.make_modes(2)):
        raise AssertionError(f"drivers: bench_nativeres ran {[r['mode'] for r in nr]}")
    for r in nr:
        hold(f"nativeres {r['mode']}", r["launches"], _want_launches(
            r["launches"], r["latent_hw"], r["steps"], remat=r["remat"],
            ring_size=1 if r["mode"].endswith("ring1") else None))
    for r in fr:
        hold(f"frontier {r['mode']}", r["launches"], _want_launches(
            r["launches"], r["latent_hw"], r["steps"], remat=r["remat"],
            mode=FRONTIER_LAUNCH_MODES[r["mode"]]))
    kb_hw = latent_size(KITTI_FRAME, kb["resolution"],
                        2 ** (len(registry.TAESD_CONFIG.encoder_blocks) - 1))
    hold("kitti (per batch)", kb["launches"], _want_launches(kb["launches"], kb_hw, kb["steps"]))
    for r in sc:
        hold(f"scaling {r.get('mode', 'dp')} n={r['devices']}", r["launches"], _want_launches(
            r["launches"], r["latent_hw"], r["steps"], ring_size=r.get("ring_size")))

    # (d) the frontier's reference and drift, recomputed from its maps
    refs = [r["mode"] for r in fr if r.get("is_reference")]
    if refs != ["full-50"]:
        raise AssertionError(f"drivers (d): the frontier's references are {refs}")
    saved = {r["mode"]: np.load(root / "frontier" / f"{r['mode']}.npy") for r in fr}
    sp = np.load(root / "frontier" / "sparse.npy")
    valid = sp > 0
    for r in fr:
        out = saved[r["mode"]]
        figures = {"anchor_mae_m": float(np.abs(out[valid] - sp[valid]).mean())}
        if r["mode"] != "full-50":
            diff = out - saved["full-50"]
            figures["mae_vs_full_m"] = float(np.abs(diff).mean())
            figures["rmse_vs_full_m"] = float(np.sqrt((diff**2).mean()))
            if not all(math.isfinite(r[k]) and r[k] > 0 for k in ("mae_vs_full_m",
                                                                   "rmse_vs_full_m")):
                raise AssertionError(f"drivers (d): {r['mode']}'s drift {r}")
        print(f"  (d) frontier {r['mode']}: " + ", ".join(
            f"{k} {r[k]:.4e} (from its maps {v:.4e})" for k, v in figures.items()))
        for k, v in figures.items():
            if not math.isclose(r[k], v, rel_tol=1e-6, abs_tol=1e-9):
                raise AssertionError(f"drivers (d): {r['mode']}'s {k} {r[k]} != {v} from its maps")

    # (e) bench_kitti's frames/s and maps
    steady = min(kb["infer_s"][1:]) if len(kb["infer_s"]) > 1 else kb["infer_s"][0]
    print(f"  (e) kitti: {kb['value']:.4f} frames/s, time/infer {kb['infer_s']}, "
          f"{kb['device_memory_high_water_gib']} GiB")
    if not math.isclose(kb["value"], kb["batch"] / steady, rel_tol=1e-12):
        raise AssertionError(f"drivers (e): frames/s {kb['value']} != {kb['batch']} / {steady}")
    # the maps: the script exits non-zero unless each is finite and (352, 1216, 1)
    if kb["maps"] != kb["frames"] or len(kb["infer_s"]) * kb["batch"] < kb["frames"]:
        raise AssertionError(f"drivers (e): {kb['maps']} maps, {kb['infer_s']} for "
                             f"{kb['frames']} frames")

    # (f) bench_scaling's n = 1 rows, their time against this process's own
    dp1 = [r for r in sc if "mode" not in r and r["devices"] == 1]
    ring1_rows = [r for r in sc if r.get("mode") == "ring" and r["devices"] == 1]
    if len(dp1) != 1 or dp1[0]["scaling_efficiency"] != 1.0 or len(ring1_rows) != 1 \
            or ring1_rows[0]["vs_single_device"] != 1.0:
        raise AssertionError(f"drivers (f): scaling rows {sc}")
    images, sparse = scaling.frames(1, (480, 640))  # BENCH_FULL=1's request
    kwargs = dict(max_depth=120.0, steps=int(DRIVERS["scaling"][1]["BENCH_STEPS"]),
                  resolution=768, norm="const", closed_form=False)
    # the mean request by the wall clock up to the last maps' copy to the
    # host, which waits for the card whatever the loop's own synchronize does
    t0 = time.perf_counter()
    readings, _ = drivers_torch.measure(DepthCompletionPipeline(bundle), kwargs, images, sparse,
                                        3)
    own = (time.perf_counter() - t0 - readings["capture_plus_first_s"]) / 3
    for r in (*dp1, *ring1_rows):
        seconds = r["batch"] / r["frames_per_sec"]
        print(f"  (f) scaling {r.get('mode', 'dp')} n=1: {seconds:.4f} s per request "
              f"(here, alone: {own:.4f} s)")
        if seconds < SCALING_TIME_SHARE * own:
            raise AssertionError(f"drivers (f): a {r.get('mode', 'dp')} request in "
                                 f"{seconds:.4f} s, under {SCALING_TIME_SHARE} x {own:.4f} s")
    del bundle
    seconds = time.perf_counter() - t_phase
    print(f"drivers: phase 8 in {seconds:.1f} s")
    return {"seconds": seconds, "card": the_card,
            "ring1_vs_native": {"rms": rms, "max": worst, "limits": RING1_LIMITS},
            "scaling_request_here_s": own, "nativeres": nr, "frontier": fr, "kitti": kb,
            "scaling": sc}


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] in WORKERS:  # a torchrun rank of phase 7
        rest = sys.argv[3:]
        return WORKERS[sys.argv[1]](Path(sys.argv[2]), rest[1:] if rest[:1] == ["--"] else rest)
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50, help="guided steps per request")
    ap.add_argument("--only-distributed", action="store_true",
                    help="build, write the checkpoint, run the TAESD path, the CLI phase and "
                    "phase 7 only (a run across several cards); no kernels line")
    ap.add_argument("--only-drivers", action="store_true",
                    help="build and run phase 8 (the configuration drivers) only; no kernels "
                    "line")
    ap.add_argument("--only-fp32", action="store_true",
                    help="build, run phase 2c (the fp32 and head-dim kernel checks), write the "
                    "checkpoint and run phase 5b (--precision fp32) only; no kernels line")
    args = ap.parse_args()
    if args.only_distributed:
        return only_distributed(args.steps)
    if args.only_drivers:
        return only_drivers()
    if args.only_fp32:
        return only_fp32(args.steps)

    print(card())
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
    for sq, sk, heads, d, is_timed, n in (
        (6912, None, 5, 64, True, 1),  # UNet stage 0 at 576x768 (main path)
        (1728, None, 10, 64, True, 1),  # UNet stage 1 (main path)
        (2688, None, 5, 64, True, 1),  # KITTI stage-0 length (42 full tiles)
        (6688, None, 5, 64, True, 1),  # stage 0 at 352x1216, res 1216 (44x152 latent)
        (6900, None, 5, 64, False, 1),  # ragged: neither length a multiple of 64
        (1000, 2100, 5, 64, False, 1),  # ragged, Sq != Sk
        # the ring's per-shard launches at 44x152, all shards in one launch:
        (1672, None, 5, 64, False, 4),  # stage 0, P=4
        (418, None, 10, 64, False, 4),  # stage 1, P=4
        (3344, None, 5, 64, False, 2),  # stage 0, P=2
        (836, None, 10, 64, False, 2),  # stage 1, P=2
        (209, None, 20, 64, False, 2),  # stage 2, P=2: ragged, 4 tiles
        (57, None, 20, 64, False, 2),  # the mid block, P=2: below one 64-row tile
        (6912, None, 1, 512, True, 1),  # KL VAE mid attention at 576x768
        (6900, None, 1, 512, False, 1),  # ragged
        (1000, 2100, 1, 512, False, 1),  # ragged, Sq != Sk
    ):
        for nm, r in check_flash(sq, sk, heads, is_timed, d=d, n=n).items():
            runs.setdefault(nm, []).append(r)
    for s, heads, p, is_timed in (
        (6688, 5, 4, True),  # stage 0 of the native path (44x152 latent): 1672-row shards
        (1672, 10, 4, False),  # stage 1: 418-row shards
        (6688, 5, 2, False),
        (1672, 10, 2, False),
        (418, 20, 2, False),  # stage 2 at P=2: 209-row shards
        (114, 20, 2, False),  # the mid block at P=2: 57 rows, below one tile
    ):
        for nm, r in check_ring_steps(s, heads, p, is_timed).items():
            runs.setdefault(nm, []).append(r)
    ring_runs: dict[str, list] = {}  # the ring's passes, reported apart from the kernels
    for s, heads, p, is_timed in (
        (6688, 5, 4, True),  # stage 0 of the native path (44x152 latent)
        (1672, 10, 4, False),  # stage 1
        (6688, 5, 2, False),
        (1672, 10, 2, False),
    ):
        for nm, r in check_ring(s, heads, p, is_timed).items():
            ring_runs.setdefault(nm, []).append(r)
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
        # the native path's TAESD decoder (44x152 latent → 352x1216; widths
        # 152, 304 and 608 are ragged against 64-column tiles): its blocks
        # (ReLU), and its up-convs' form (no ReLU)
        check_conv(1, 44, 152, timed=False),
        check_conv(1, 88, 304, timed=False),
        check_conv(1, 176, 608, timed=False),
        check_conv(1, 352, 1216, timed=False),
        check_conv(1, 88, 304, relu=False, timed=False),
        check_conv(1, 176, 608, relu=False, timed=False),
        check_conv(1, 352, 1216, relu=False, timed=False),
    ]
    check_autograd()
    check_narrow_decode()
    check_narrow_request()
    # one sample per cluster: n = 1, 2 and 8 (bench.py's batch), both
    # prediction types; timed at n = 1 (the kernels line) and n = 8
    runs["guidance_epilogue"] = [
        check_epilogue(1, v_pred=True),
        check_epilogue(8, v_pred=True),
        *(check_epilogue(n, v_pred=vp, timed=False, latent_hw=hw) for n, vp, hw in (
            (2, True, (72, 96)), (1, False, (72, 96)), (2, False, (72, 96)),
            (8, False, (72, 96)),
            (1, True, (44, 152)), (1, False, (44, 152)), (8, True, (44, 152)),  # native path
            # res 1024: 16,384 float4s a sample, twice what the cluster holds
            (1, True, (128, 128)), (2, False, (128, 128)),
            # 1,961 float4s a sample: no multiple of the cluster's 4,096 threads
            (1, True, (37, 53)), (8, False, (37, 53)),
        )),
    ]
    probes, probe_entries = probe_phase()
    fp32_kernel_checks(runs, ring_runs)

    counts: dict[str, int] = {}
    ring_launches: dict[str, int] = {}  # kernel launches on the native (ring) path
    graphs: dict[str, dict] = {}  # each path's graph readings (phase 3 (a)-(c))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_checkpoint_") as tmp:
        # the TAESD path runs on the bundle read back from a checkpoint, the
        # CLI phase on the same directory
        loaded, model_dir, taesd_dir = checkpoint_bundle(Path(tmp))
        for path in PATHS:
            taesd_path = path.vae_kind == "tiny" and not path.ring_size
            path_counts, info = guided_path(path, args.steps, loaded if taesd_path else None)
            graphs[path.label] = info["graph"]
            loaded = None  # each path's peak memory its own
            for k, n in path_counts.items():
                counts[k] = counts.get(k, 0) + n
            if path.ring_size:
                ring_launches = path_counts
        cli = cli_phase(model_dir, taesd_dir, Path(tmp), args.steps)
        verify = verify_phase(model_dir, taesd_dir)
        host_io = host_io_phase(model_dir, taesd_dir, Path(tmp), args.steps)
        modes = modes_phase(model_dir, taesd_dir, Path(tmp), args.steps)
        fp32, fp32_counts = fp32_phase(model_dir, taesd_dir, Path(tmp), args.steps)
        for k, n in fp32_counts.items():
            counts[k] = counts.get(k, 0) + n
        serve, serve_counts = serve_phase(model_dir, taesd_dir, args.steps)
        serve["fp32"], fp32_serve_counts = fp32_serve_phase(model_dir, taesd_dir, args.steps)
        for k, n in itertools.chain(serve_counts.items(), fp32_serve_counts.items()):
            counts[k] = counts.get(k, 0) + n
        distributed, dist_counts = distributed_phase(
            model_dir, taesd_dir, Path(tmp), args.steps, graphs, Path(tmp) / "out")
        for k, n in dist_counts.items():
            counts[k] = counts.get(k, 0) + n
        drivers = drivers_phase(Path(tmp) / "drivers")
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
        "flash_fwd_ring": (fa_src, "depth_completion_tpu/ops/ring_attention.py:99"),
        "flash_bwd_ring": (fa_src, "depth_completion_tpu/ops/ring_attention.py:99"),
        "conv3x3": ("depth_completion_tpu_torch/csrc/conv3x3.cu",
                    "depth_completion_tpu/ops/conv3x3.py:81"),
        "guidance_epilogue": ("depth_completion_tpu_torch/csrc/guidance_epilogue.cu",
                              "depth_completion_tpu/ops/guidance_epilogue.py:62"),
        "conv3x3_fp32": ("depth_completion_tpu_torch/csrc/conv3x3.cu",
                         "depth_completion_tpu/ops/conv3x3.py:81"),
    }
    # the generic flash pair, per (dtype, head dim): fp32 at every head dim,
    # bf16 at 128-384, and the ring steps of every pair but bf16 at 64
    for dtype, lib in ((torch.float32, "flash_generic_f32"), (torch.bfloat16, "flash_generic_bf16")):
        for d in fa.HEAD_DIMS:
            for ring in (False, True):
                for name, line in zip(fa.launch_names(dtype, d, ring), (163, 534)):
                    if name not in sources:
                        sources[name] = (f"depth_completion_tpu_torch/csrc/{lib}.cu",
                                         "depth_completion_tpu/ops/ring_attention.py:99" if ring
                                         else f"{fa_py}:{line}")
    # the ring attention's passes (TPU kernel ops/ring_attention.py:99): P
    # launches of a ring step kernel each, counted under that kernel. Times
    # and bound at stage 0 of the native path, P=4; error over every case,
    # against the ring through the step twins.
    composites = []
    for name, kernel in (("ring_attention_fwd", "flash_fwd_ring"),
                         ("ring_attention_bwd", "flash_bwd_ring")):
        r = next(x for x in ring_runs[name] if "ms" in x)
        composites.append({
            "name": name, "source": "depth_completion_tpu_torch/ops/ring_attention.py",
            "replaces": "depth_completion_tpu/ops/ring_attention.py:99", "kernel": kernel,
            "native_path_kernel_launches": ring_launches[kernel],
            "max_abs_err": max(x["max_abs_err"] for x in ring_runs[name]),
            "ms": r["ms"], "single_flash_ms": r["single_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(json.dumps({"probes": probes}))
    print(json.dumps({"composites": composites}))
    print(json.dumps({"graphs": graphs}))
    print(json.dumps({"cli": cli}))
    print(json.dumps({"verify": verify}))
    print(json.dumps({"host_io": host_io}))
    programs = modes.pop("programs")
    print(json.dumps({"modes": modes}))
    print(json.dumps({"fp32": fp32}))
    print(json.dumps({"programs": programs}, default=str))
    print(json.dumps({"serve": serve}))
    print(json.dumps({"distributed": distributed}))
    print(json.dumps({"drivers": drivers}))
    # how a wrapper that runs more than one kernel counts its launches
    launch_notes = {"flash_bwd_d512": "one per call of dct_flash_bwd_d512, which runs three "
                                      "kernels: the di pre-pass, dk/dv, then dq"}
    entries = []
    # times and bound at the first timed shape (the TAESD path's largest for
    # flash d=64 and the conv; a middle ring step at stage 0 of the native
    # path); error over every shape checked
    for name, (src, replaces) in sources.items():
        r = next(x for x in runs[name] if "ms" in x)
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts.get(name, 0),
            "max_abs_err": max(x["max_abs_err"] for x in runs[name]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
        if "library_tf32_ms" in r:  # the fp32 conv: cuDNN with TF32 on, for scale
            entries[-1]["library_tf32_ms"] = r["library_tf32_ms"]
        if name in launch_notes:
            entries[-1]["launches_counted"] = launch_notes[name]
    entries.extend(probe_entries)  # launches from the probes' runs; 0 on every path
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def only_distributed(steps: int) -> int:
    """``--only-distributed``: the kernels' build, the checkpoint directory
    (phase 3a), the TAESD path (phase 3: its graph limits), the CLI phase
    (phase 4: the single-process maps) and phase 7, then the
    ``distributed`` line and the result line."""
    print(card())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_checkpoint_") as tmp:
        loaded, model_dir, taesd_dir = checkpoint_bundle(Path(tmp))
        _, info = guided_path(PATHS[0], steps, loaded)
        del loaded
        cli_phase(model_dir, taesd_dir, Path(tmp), steps)
        distributed, _ = distributed_phase(model_dir, taesd_dir, Path(tmp), steps,
                                           {PATHS[0].label: info["graph"]}, Path(tmp) / "out")
    if FAILURES:
        sys.stderr.write("chip_smoke: checks failed:\n  " + "\n  ".join(FAILURES) + "\n")
        return 1
    print(json.dumps({"distributed": distributed}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def only_fp32(steps: int) -> int:
    """``--only-fp32``: the kernels' build, phase 2c (``fp32_kernel_checks``),
    the checkpoint directory (phase 3a) and phase 5b (``fp32_phase``), then
    the ``fp32`` line and the result line."""
    print(card())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    runs: dict[str, list] = {}
    fp32_kernel_checks(runs, {})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_checkpoint_") as tmp:
        loaded, model_dir, taesd_dir = checkpoint_bundle(Path(tmp))
        del loaded
        gc.collect()
        torch.cuda.empty_cache()
        fp32, _ = fp32_phase(model_dir, taesd_dir, Path(tmp), steps)
    if FAILURES:
        sys.stderr.write("chip_smoke: checks failed:\n  " + "\n  ".join(FAILURES) + "\n")
        return 1
    print(json.dumps({"fp32": fp32}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def only_drivers() -> int:
    """``--only-drivers``: the kernels' build and phase 8, then the
    ``drivers`` line and the result line."""
    print(card())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_drivers_") as tmp:
        drivers = drivers_phase(Path(tmp))
    if FAILURES:
        sys.stderr.write("chip_smoke: checks failed:\n  " + "\n  ".join(FAILURES) + "\n")
        return 1
    print(json.dumps({"drivers": drivers}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
