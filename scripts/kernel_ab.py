"""Device time of the flash kernels (d=64 forward and backward, d=512
forward) and the fused 3x3 conv in two checkouts, side by side, on one CUDA
GPU.

    python3 scripts/kernel_ab.py BASE_DIR [--reps 20]

BASE_DIR is another checkout of this repository, e.g. the parent commit
unpacked with ``git archive`` into the git-ignored
``depth_completion_tpu_torch/_build/parent/``. Each tree's
``csrc/flash_attention.cu`` and ``csrc/conv3x3.cu`` is compiled with nvcc
(this tree's flags) into ``depth_completion_tpu_torch/_build/ab/``, loaded
with ctypes through the C entry points both trees share (``dct_flash_fwd``,
``dct_flash_bwd``, ``dct_flash_fwd_d512``, ``dct_conv3x3``), and timed at
the guided paths' shapes: ``reps`` launches captured in one CUDA graph and
replayed, so a time is the kernel's device time without the host's launch
overhead (``chip_smoke.py`` times through the Python wrappers, which at
small shapes measures the host). The backward's time holds what its entry
point launches (the ``di`` pre-pass and the kernel) and the zeroing of its
fp32 dq buffer, as the wrapper does; its inputs o and lse2 come from this
tree's forward. Turns: base, this tree, this tree, base; each tree's two
turns are averaged. The two trees' outputs on the same inputs are compared
(max abs difference over every output: both compute one function, in other
summation orders). Prints the card, one line per case, and last a JSON
object with every case.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from depth_completion_tpu_torch import _build  # noqa: E402
from depth_completion_tpu_torch.ops import conv3x3 as c3  # noqa: E402
from depth_completion_tpu_torch.probes import card  # noqa: E402

_p, _i, _l, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
SOURCES = ("flash_attention", "conv3x3")

# (S, heads, batch): UNet stages 0-1 at 576x768; the KITTI stage-0 length;
# stage 0 at 352x1216 in one call; the ring's per-step launches there (P=4)
FLASH_CASES = ((6912, 5, 1), (1728, 10, 1), (2688, 5, 1), (6688, 5, 1), (1672, 5, 4),
               (418, 10, 4))
# (S, heads, batch) at head dim 512: the KL VAE's mid attention at 576x768,
# and a ragged length
FLASH_D512_CASES = ((6912, 1, 1), (6900, 1, 1))
# (H, W, Ci, Co, relu): relu is the TAESD form (bias+ReLU; masked dx with
# the emitted operand), else the KL form (bias; dx without a mask)
CONV_CASES = ((576, 768, 64, 64, True), (72, 96, 64, 64, True), (352, 1216, 64, 64, True),
              (576, 768, 128, 128, False), (576, 768, 256, 128, False),
              (288, 384, 128, 256, False), (288, 384, 512, 256, False),
              (288, 384, 256, 256, False), (144, 192, 256, 512, False),
              (144, 192, 512, 512, False), (72, 96, 512, 512, False))


def build(tree: Path, tag: str) -> dict:
    """Compile the tree's two sources (in parallel) → {source: CDLL}."""
    out = ROOT / "depth_completion_tpu_torch" / "_build" / "ab" / tag
    out.mkdir(parents=True, exist_ok=True)
    csrc = tree / "depth_completion_tpu_torch" / "csrc"
    procs = {}
    for name in SOURCES:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(out / f"{name}.so"),
               str(csrc / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {csrc / name}.cu:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        if name == "flash_attention":
            for fwd in (lib.dct_flash_fwd, lib.dct_flash_fwd_d512):
                fwd.argtypes = [_p] * 5 + [_i] * 4 + [_l] * 8 + [_f, _p]
                fwd.restype = _i
            lib.dct_flash_bwd.argtypes = [_p] * 10 + [_i] * 4 + [_l] * 10 + [_f, _p]
            lib.dct_flash_bwd.restype = _i
        else:
            lib.dct_conv3x3.argtypes = [_p] * 7 + [_i] * 6 + [_p]
            lib.dct_conv3x3.restype = _i
        libs[name] = lib
    return libs


def graph_ms(fn, reps: int) -> float:
    """Device ms per call: ``reps`` calls captured in one CUDA graph, the
    graph replayed 5 times after a warm replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def flash_fwd(lib, q, k, v, heads: int):
    """→ (o, lse2) through ``dct_flash_fwd`` or, at head dim 512,
    ``dct_flash_fwd_d512``."""
    n, s, c = q.shape
    d = c // heads
    o = torch.empty_like(q)
    lse = torch.empty((n, heads, s), device=q.device, dtype=torch.float32)
    entry = lib.dct_flash_fwd if d == 64 else lib.dct_flash_fwd_d512
    status = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                   n, heads, s, s, s * c, c, s * c, c, s * c, c, s * c, c, 1.0 / math.sqrt(d),
                   _stream())
    _build.check(status, "flash_fwd")
    return o, lse


def flash_bwd(lib, q, k, v, o, do, lse, heads: int):
    """→ (dq in fp32, dk, dv) through ``dct_flash_bwd`` (d=64)."""
    n, s, c = q.shape
    di = torch.empty((n, heads, s), device=q.device, dtype=torch.float32)
    dq = torch.zeros((n, s, c), device=q.device, dtype=torch.float32)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    status = lib.dct_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                               do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
                               dk.data_ptr(), dv.data_ptr(), n, heads, s, s, s * c, c, s * c, c,
                               s * c, c, s * c, c, s * c, c, 1.0 / 8.0, _stream())
    _build.check(status, "flash_bwd")
    return dq, dk, dv


def conv(lib, x, w_hwio, bias=None, relu=False, mask=None):
    n, h, w, ci = x.shape
    co = w_hwio.shape[3]
    y = torch.empty((n, h, w, co), device=x.device, dtype=x.dtype)
    xm = torch.empty_like(x) if mask is not None else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    status = lib.dct_conv3x3(x.data_ptr(), w_hwio.data_ptr(), ptr(bias), None, ptr(mask),
                             y.data_ptr(), ptr(xm), n, h, w, ci, co, int(relu), _stream())
    _build.check(status, "conv3x3")
    return y


def turns(libs: dict, run, reps: int) -> dict:
    """base, this, this, base → per tree the mean ms, and the max abs
    difference over the outputs (``run`` returns a tensor or a tuple)."""
    times = {"base": [], "this": []}
    for tag in ("base", "this", "this", "base"):
        times[tag].append(graph_ms(lambda: run(libs[tag]), reps))
    outs = {tag: run(libs[tag]) for tag in times}
    outs = {tag: out if isinstance(out, tuple) else (out,) for tag, out in outs.items()}
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(outs["base"], outs["this"]))
    base, this = (sum(times[t]) / 2 for t in ("base", "this"))
    return {"base_ms": base, "this_ms": this, "speedup": base / this, "max_abs_diff": diff}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("base_dir", type=Path)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("kernel_ab: CUDA is not available; this script times the card\n")
        return 2
    print(card())
    libs = {"base": build(args.base_dir.resolve(), "base"), "this": build(ROOT, "this")}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    results = []
    flash_libs = {t: lib["flash_attention"] for t, lib in libs.items()}
    for s, heads, n in FLASH_CASES:
        q, k, v, do = (rnd(n, s, heads * 64) for _ in range(4))
        r = turns(flash_libs, lambda lib: flash_fwd(lib, q, k, v, heads)[0], args.reps)
        r.update(kernel="flash_fwd", shape=f"N={n} S={s} heads={heads}")
        results.append(r)
        o, lse = flash_fwd(flash_libs["this"], q, k, v, heads)
        r = turns(flash_libs, lambda lib: flash_bwd(lib, q, k, v, o, do, lse, heads), args.reps)
        r.update(kernel="flash_bwd", shape=f"N={n} S={s} heads={heads}")
        results.append(r)
    for s, heads, n in FLASH_D512_CASES:
        q, k, v = (rnd(n, s, heads * 512) for _ in range(3))
        r = turns(flash_libs, lambda lib: flash_fwd(lib, q, k, v, heads)[0], args.reps)
        r.update(kernel="flash_fwd_d512", shape=f"N={n} S={s} heads={heads}")
        results.append(r)
    for h, w, ci, co, relu in CONV_CASES:
        x, dy = rnd(1, h, w, ci), rnd(1, h, w, co)
        wt = rnd(3, 3, ci, co, scale=1.0 / math.sqrt(9 * ci))
        kf = rnd(3, 3, co, ci, scale=1.0 / math.sqrt(9 * co))
        b = rnd(co, scale=0.1)
        mask = c3.conv3x3_plain(x, wt, b, relu=relu)[0] if relu else None
        conv_libs = {t: lib["conv3x3"] for t, lib in libs.items()}
        form = "TAESD" if relu else "KL"
        r = turns(conv_libs, lambda lib: conv(lib, x, wt, b, relu), args.reps)
        r.update(kernel="conv3x3", shape=f"{h}x{w} {ci}->{co} {form} fwd")
        results.append(r)
        r = turns(conv_libs, lambda lib: conv(lib, dy, kf, mask=mask), args.reps)
        r.update(kernel="conv3x3", shape=f"{h}x{w} {co}->{ci} {form} {'masked ' if relu else ''}dx")
        results.append(r)
    for r in results:
        print(f"{r['kernel']} {r['shape']}: base {r['base_ms']:.4f} ms, this {r['this_ms']:.4f} ms "
              f"(x{r['speedup']:.3f}), max|diff| {r['max_abs_diff']:.3e}")
    print(json.dumps({"card": card(), "reps": args.reps, "cases": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
