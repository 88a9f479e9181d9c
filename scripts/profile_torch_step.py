"""Where a guided step's device time goes in the PyTorch/CUDA port.

    python3 scripts/profile_torch_step.py [--steps 5] [--vae light|original]
                                          [--upsample subpixel|nearest] [--ring P]
                                          [--precision bf16|fp32]

Builds the full-width Marigold bundle (random weights, seed 0; bf16, or fp32
with ``--precision fp32``, TF32 off as the CLI runs it) with the
TAESD decoder (``--vae light``) or the KL VAE at SD widths (``original``), runs
twice: once through the pipeline (its step captured as a CUDA graph and
replayed) and once through its eager twin (``pipe.twin()``, every step
eager). Each runs one warm-up request of ``--steps`` (the capture happens
there), then one request of ``--steps`` per-step guided DDIM
steps (480x640 frame, 500 sparse points, res 768, norm=const, learned
affine; with ``--ring P``, native-resolution mode: a 352x1216 frame, 2000
points, res 1216, the UNet's self-attention on ``LocalRing(P)``) under
``torch.profiler``. Prints, for each, the wall time per step, the
device-busy share of the profiled window, device time and device launches
(kernels, memsets and copies) per step by kernel family, the port's own
kernel launches per step (the wrappers' counts), and the top kernels by
device time; the last line is a JSON summary with a "graph" and an
"eager" entry. Needs a CUDA device; exits 2
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAMILIES = (  # first match wins; matched against the lower-cased kernel name
    # the ring step instantiations of the flash kernels' templates
    ("flash_fwd_ring (port)", ("flash_fwd_kernel<true", "flash_fwd_kernel<false, true")),
    # the generic pair (fp32 at every head dim, bf16 at 128-384), its ring
    # steps included, and its di pre-pass
    ("flash_fwd_generic (port)", ("flash_fwd_generic",)),
    ("flash_bwd_generic (port)", ("flash_bwd_generic", "flash_bwd_di_generic")),
    ("flash_bwd_ring (port)", ("flash_bwd_kernel<true",)),
    ("flash_fwd (port)", ("flash_fwd_kernel",)),
    ("flash_bwd (port)", ("flash_bwd_kernel", "flash_bwd_di_kernel")),
    ("flash_fwd_d512 (port)", ("flash_fwd_d512_kernel",)),
    ("flash_bwd_d512 (port)", ("flash_bwd_d512_kernel", "flash_bwd_dq_d512_kernel",
                               "flash_bwd_di_d512_kernel")),
    ("conv3x3 (port)", ("conv3x3_kernel",)),
    ("conv3x3_fp32 (port)", ("conv3x3_f32_kernel",)),
    ("guidance_epilogue (port)", ("guidance_epilogue_kernel",)),
    ("cudnn conv", ("conv", "cudnn", "xmma_fprop", "xmma_dgrad", "implicit_gemm", "winograd")),
    ("gemm", ("gemm", "cutlass", "sm90_xmma", "ampere_bf16", "nvjet")),
    ("norm", ("norm",)),
    ("softmax / reduce", ("softmax", "reduce")),
    ("elementwise / copy", ("elementwise", "vectorized", "copy", "cat", "fill", "index")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def upsample_conv_subpixel(params, x: torch.Tensor) -> torch.Tensor:
    """``conv2d(params, upsample_nearest_2x(x))`` on the source grid, as the
    JAX package computes it: output subpixel (di, dj) sees a 2x2 source
    neighbourhood with the kernel's rows and columns summed (in ``x.dtype``),
    so the four 2x2 kernels run as one conv with 4·Co outputs over ``x``
    padded by one; subpixel (di, dj) is its window shifted by (di, dj)."""
    import torch.nn.functional as F

    n, h, w, _ = x.shape
    k = params["kernel"].to(x.dtype)  # [Co, C, 3, 3]
    co = k.shape[0]

    def taps(a, i):  # last axis of 3 taps → subpixel i's two
        return (a[..., 0], a[..., 1] + a[..., 2]) if i == 0 else (a[..., 0] + a[..., 1], a[..., 2])

    wk = torch.cat([
        torch.stack([torch.stack(taps(r, dj), dim=-1) for r in taps(k.transpose(2, 3), di)], dim=-2)
        for di in (0, 1) for dj in (0, 1)
    ])  # [4·Co, C, 2, 2], block 2·di + dj
    b = params.get("bias")
    y = F.conv2d(x.permute(0, 3, 1, 2), wk, None if b is None else b.to(x.dtype).repeat(4),
                 padding=1).permute(0, 2, 3, 1)  # [N, H+1, W+1, 4·Co]
    sub = [[y[:, di:di + h, dj:dj + w, (2 * di + dj) * co:(2 * di + dj + 1) * co]
            for dj in (0, 1)] for di in (0, 1)]
    out = torch.stack([torch.stack(r, dim=3) for r in sub], dim=2)  # [N, H, 2, W, 2, Co]
    return out.reshape(n, 2 * h, 2 * w, co)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--vae", choices=("light", "original"), default="light")
    ap.add_argument("--upsample", choices=("nearest", "subpixel"), default="nearest",
                    help="KL decoder upsample conv: the port's conv of the nearest-2x "
                         "upsampled map, or the same function in subpixel form")
    ap.add_argument("--ring", type=int, default=0,
                    help="native-resolution mode over LocalRing(P) at KITTI size (0: off)")
    ap.add_argument("--precision", choices=("bf16", "fp32"), default="bf16",
                    help="the bundle's dtype (fp32: the fp32 kernels, TF32 off)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("profile_torch_step: needs a CUDA device\n")
        return 2

    from depth_completion_tpu_torch.models import registry, vae_kl
    from depth_completion_tpu_torch.models.bundle import make_random_bundle
    from depth_completion_tpu_torch.ops import conv3x3, flash_attention, guidance_epilogue
    from depth_completion_tpu_torch.ops.ring_attention import LocalRing
    from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline

    if args.upsample == "subpixel":
        vae_kl.upsample_conv_2x_matmul = upsample_conv_subpixel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind, vae_config = {"light": ("tiny", registry.TAESD_CONFIG),
                        "original": ("kl", registry.SD_VAE_CONFIG)}[args.vae]
    bundle = make_random_bundle(
        seed=0, unet_config=registry.MARIGOLD_UNET_CONFIG, vae_config=vae_config,
        dtype=torch.bfloat16 if args.precision == "bf16" else torch.float32, device="cuda",
        vae_kind=kind, text_config=registry.SD2_TEXT_CONFIG,
    )
    pipe = DepthCompletionPipeline(bundle)
    gen = torch.Generator().manual_seed(0)
    (h, w), points, res = ((352, 1216), 2000, 1216) if args.ring else ((480, 640), 500, 768)
    ring = LocalRing(args.ring) if args.ring else None
    images = torch.rand((1, h, w, 3), generator=gen) * 255.0
    sparses = torch.zeros((1, h * w))
    sparses[0, torch.randperm(h * w, generator=gen)[:points]] = \
        2.0 + 78.0 * torch.rand(points, generator=gen)
    sparses = sparses.reshape(1, h, w, 1)

    def request(target, steps):
        return target(images, sparses, max_depth=120.0, steps=steps, norm="const",
                      closed_form=False, resolution=res, ring_mesh=ring)

    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(smi)
    port_counts = (flash_attention.LAUNCHES, conv3x3.LAUNCHES, guidance_epilogue.LAUNCHES)
    per = args.steps
    summary = {"device": torch.cuda.get_device_name(0), "card": smi, "vae": args.vae,
               "upsample": args.upsample, "ring": args.ring, "precision": args.precision,
               "steps": per}
    # the pipeline replays its captured step; its twin runs every step eagerly
    for name, target in (("graph", pipe), ("eager", pipe.twin())):
        # warm-up at the profiled signature: lazy init, cuDNN heuristics,
        # kernel build and (graph) the capture, so the profiled request
        # replays every step
        request(target, per)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for counts in port_counts:
            counts.update({k: 0 for k in counts})
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            request(target, per)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        kernels: dict[str, tuple[float, int]] = {}
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            t = getattr(evt, "self_device_time_total", 0.0) / 1e3  # us → ms
            if t > 0:
                kernels[evt.key] = (t, evt.count)
        total = sum(t for t, _ in kernels.values())
        fams: dict[str, float] = {}
        fam_launches: dict[str, int] = {}
        for kname, (t, n) in kernels.items():
            fams[family(kname)] = fams.get(family(kname), 0.0) + t
            fam_launches[family(kname)] = fam_launches.get(family(kname), 0) + n
        launches = sum(fam_launches.values())
        port = {k: v / per for counts in port_counts for k, v in counts.items() if v}

        print(f"[{name}] --vae {args.vae} --upsample {args.upsample} --ring {args.ring} "
              f"--precision {args.precision} "
              f"({h}x{w}, res {res}): request of {per} guided steps: wall {wall_ms:.1f} ms "
              f"({wall_ms / per:.2f} ms/step, incl. encode and final decode); device busy "
              f"{total:.1f} ms ({100 * total / wall_ms:.1f}% of wall); peak memory "
              f"{peak_gib:.2f} GiB")
        print(f"[{name}] device launches per step: {launches / per:.1f} (kernels, memsets and "
              f"copies)")
        print(f"[{name}] port kernel launches per step (wrapper counts): {port}")
        print(f"[{name}] device ms and launches per step by kernel family:")
        for fam, t in sorted(fams.items(), key=lambda kv: -kv[1]):
            print(f"  {fam:22s} {t / per:9.3f}  ({100 * t / total:.1f}%)  "
                  f"{fam_launches[fam] / per:8.1f} launches")
        print(f"[{name}] top kernels (device ms per step, launches per step):")
        for kname, (t, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]:
            print(f"  {t / per:9.3f}  {n / per:7.1f}  {kname[:110]}")
        summary[name] = {
            "wall_ms_per_step": wall_ms / per, "device_ms_per_step": total / per,
            "busy_share": total / wall_ms, "peak_gib": peak_gib,
            "family_ms_per_step": {k: v / per for k, v in fams.items()},
            "launches_per_step": launches / per,
            "family_launches_per_step": {k: v / per for k, v in fam_launches.items()},
            "port_launches_per_step": port,
        }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
