"""Device time of the flash kernels (d=64 forward and backward, d=512
forward and backward), the generic flash pair (every other dtype and head
dim, and its ring steps), the ring's passes, the fused 3x3 conv and the
guidance epilogue in two checkouts, side by side, on one CUDA GPU.

    python3 scripts/kernel_ab.py BASE_DIR [--reps 20]

BASE_DIR is another checkout of this repository, e.g. the parent commit
unpacked with ``git archive`` into the git-ignored
``depth_completion_tpu_torch/_build/parent/``. Each tree's
``csrc/flash_attention.cu``, ``csrc/flash_generic_f32.cu``,
``csrc/flash_generic_bf16.cu``, ``csrc/conv3x3.cu`` and
``csrc/guidance_epilogue.cu`` is compiled with nvcc (this tree's flags)
into ``depth_completion_tpu_torch/_build/ab/``, loaded with ctypes through
the C entry points both trees share (``dct_flash_fwd``, ``dct_flash_bwd``,
``dct_flash_fwd_d512``, ``dct_flash_bwd_d512``, ``dct_flash_fwd_<f32|bf16>``,
``dct_flash_bwd_<f32|bf16>``, ``dct_conv3x3``, ``dct_conv3x3_f32``; the
epilogue through ``dct_guidance_epilogue_table`` or, in a tree from before
it, ``dct_guidance_epilogue``), and timed at the guided paths' shapes: ``reps`` launches
captured in one CUDA graph and replayed, so a time is the kernel's device
time without the host's launch overhead (``chip_smoke.py`` times through the
Python wrappers, which at small shapes measures the host). A backward's
time holds what its entry point launches (the ``di`` pre-pass and the
kernel) and the zeroing of its fp32 dq buffer, as the wrapper does; its
inputs o and lse2 come from this tree's forward. The ring's passes
(``LocalRing(P)`` at the native path's shapes) run each tree's form: with
the ring step entry points (``dct_flash_fwd_ring``, ``dct_flash_bwd_ring``),
this tree's ``ops.ring_attention`` over that tree's kernels; without, one
flash call per visiting block, ``roll`` and the eager fp32 merge the ring
had before them. The generic pair runs at every timed shape of PERF.md's
generic rows (``GENERIC_CASES``: whole calls, the backward with its ``di``
pre-pass and the zeroing of dq; ``GENERIC_RING_CASES``: a middle forward
step and a later backward step of a ``LocalRing(P)`` on carried state,
timed on working copies of the state, compared from fresh ones). The
conv runs both forms at every ``CONV_CASES`` shape, forward and dx (masked
where the case has ReLU): bf16 and fp32, each tree's fp32 form given the
weight layout it reads (K-major OHWI where the library exports
``dct_conv3x3_f32_k_major``, else HWIO), and this tree's wrapper-side
relayout of the weights alone (``weight_relayout``). Turns:
base, this tree, this tree, base; each tree's two turns are averaged. The
two trees' outputs on the same inputs are compared (max abs difference over
every output: both compute one function, in other summation orders).

The same turns then hold this tree's ``flash_bwd_d512`` (the two-kernel
design of its source note) against variants built beside it
(``VARIANTS``): the one-pass design (``scripts/kernel_ab_variants.cu``),
and the same with its dq atomics left out (the dq products kept, the adds
skipped: the result's dq is then wrong, its time what the atomics cost).
The guidance epilogue (in place on lat, m, v: timed on working copies,
compared from fresh ones) runs at batch 1 and 8 against the other tree,
and against this tree's source built with ``EPILOGUE_VARIANT_CLUSTER``
blocks per cluster. Prints the card, one line per case, and last a JSON
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
from depth_completion_tpu_torch.ops import flash_attention as fa  # noqa: E402
from depth_completion_tpu_torch.ops import guidance_epilogue as ge  # noqa: E402
from depth_completion_tpu_torch.ops import ring_attention as ra  # noqa: E402
from depth_completion_tpu_torch.probes import card  # noqa: E402
from depth_completion_tpu_torch.sched.ddim import make_schedule, make_timesteps  # noqa: E402

_p, _i, _l, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
SOURCES = ("flash_attention", "flash_generic_f32", "flash_generic_bf16", "conv3x3",
           "guidance_epilogue")
FWD_ARGS = [_p] * 5 + [_i] * 4 + [_l] * 8 + [_f, _p]
BWD_ARGS = [_p] * 10 + [_i] * 4 + [_l] * 10 + [_f, _p]
GENERIC_FWD_ARGS = [_p] * 8 + [_i] * 5 + [_l] * 8 + [_i, _i, _f, _p]
GENERIC_BWD_ARGS = [_p] * 11 + [_i] * 5 + [_l] * 10 + [_i, _i, _f, _p]
EPILOGUE_ARGS = [_p] * 5 + [_i, _l, _i, _i] + [_f] * 10 + [_p]
EPILOGUE_TABLE_ARGS = [_p] * 5 + [_i, _l, _i, _i, _p, _p] + [_f] * 4 + [_p]
# (N, EH, EW): the latent of res 768 at batch 1 and at bench.py's batch 8
EPILOGUE_CASES = ((1, 72, 96), (8, 72, 96))
# the other cluster size, built from this tree's source (a text edit)
EPILOGUE_CLUSTER_LINE = "constexpr int CLUSTER = {};"
EPILOGUE_VARIANT_CLUSTER = 8
# variants of this tree's d=512 backward: ``scripts/kernel_ab_variants.cu``
# (entry ``VARIANT_ENTRY``, the one-pass design) built over a copy of
# csrc/ whose flash_attention.cu takes these (old, new) text edits
VARIANTS = {
    "one_pass": (),
    "one_pass_no_dq_atomics": (("if (qr < sq) atomicAdd(", "if (qr < sq && sq < 0) atomicAdd("),),
}
VARIANT_ENTRY = "dct_flash_bwd_d512_one_pass"

# (S, heads, batch): UNet stages 0-1 at 576x768; the KITTI stage-0 length;
# stage 0 at 352x1216 in one call; the ring's per-step launches there (P=4)
FLASH_CASES = ((6912, 5, 1), (1728, 10, 1), (2688, 5, 1), (6688, 5, 1), (1672, 5, 4),
               (418, 10, 4))
# (S, heads, batch) at head dim 512: the KL VAE's mid attention at 576x768,
# and a ragged length
FLASH_D512_CASES = ((6912, 1, 1), (6900, 1, 1))
# the generic pair, whole calls (dtype, head dim, S, heads): the fp32 UNet
# stages 0 and 1 at 576x768 (10 + 10 launches a guided step between them),
# the KL VAE's fp32 mid attention, and chip_smoke.py's HEAD_DIM_CASES in both
# dtypes
GENERIC_CASES = (("fp32", 64, 6912, 5), ("fp32", 64, 1728, 10), ("fp32", 512, 6912, 1),
                 *((dt, d, s, h) for d, s, h in ((128, 1728, 5), (256, 6912, 1), (384, 1728, 2))
                   for dt in ("bf16", "fp32")))
# the generic pair's ring steps (dtype, head dim, shard rows, heads, P): the
# native fp32 path's stage 0, and chip_smoke.py's RING_STEP_HEADS at 4x432
GENERIC_RING_CASES = (("fp32", 64, 1672, 5, 4),
                      *((dt, d, 432, h, 4) for d, h in ((128, 5), (256, 1), (384, 2), (512, 1))
                        for dt in ("bf16", "fp32")))
# (S, heads, P): the native path's ring at stages 0 and 1 (44x152 latent)
RING_CASES = ((6688, 5, 4), (1672, 10, 4))
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
            for fn, args in ((lib.dct_flash_fwd, FWD_ARGS), (lib.dct_flash_fwd_d512, FWD_ARGS),
                             (lib.dct_flash_bwd, BWD_ARGS), (lib.dct_flash_bwd_d512, BWD_ARGS)):
                fn.argtypes, fn.restype = args, _i
            if hasattr(lib, "dct_flash_fwd_ring"):  # the ring step kernels
                lib.dct_flash_fwd_ring.argtypes = [_p] * 8 + [_i] * 4 + [_l] * 8 + [_i, _i, _f, _p]
                lib.dct_flash_bwd_ring.argtypes = [_p] * 9 + [_i] * 4 + [_l] * 10 + [_i, _f, _p]
                lib.dct_flash_fwd_ring.restype = lib.dct_flash_bwd_ring.restype = _i
        elif name.startswith("flash_generic"):
            sfx = name.rsplit("_", 1)[1]
            fwd, bwd = getattr(lib, f"dct_flash_fwd_{sfx}"), getattr(lib, f"dct_flash_bwd_{sfx}")
            fwd.argtypes, bwd.argtypes = GENERIC_FWD_ARGS, GENERIC_BWD_ARGS
            fwd.restype = bwd.restype = _i
        elif name == "conv3x3":
            for fn in (lib.dct_conv3x3, lib.dct_conv3x3_f32):
                fn.argtypes, fn.restype = [_p] * 7 + [_i] * 6 + [_p], _i
        else:
            _epilogue_types(lib)
        libs[name] = lib
    return libs


def build_epilogue_variant(cluster: int) -> ctypes.CDLL:
    """This tree's ``guidance_epilogue.cu`` with ``cluster`` blocks per
    cluster (its ``CLUSTER`` line edited in a copy)."""
    out = ROOT / "depth_completion_tpu_torch" / "_build" / "ab" / f"epilogue_c{cluster}"
    out.mkdir(parents=True, exist_ok=True)
    text = (ROOT / "depth_completion_tpu_torch" / "csrc" / "guidance_epilogue.cu").read_text()
    line = next(EPILOGUE_CLUSTER_LINE.format(c) for c in (8, 16)
                if EPILOGUE_CLUSTER_LINE.format(c) in text)
    (out / "guidance_epilogue.cu").write_text(text.replace(line,
                                                           EPILOGUE_CLUSTER_LINE.format(cluster)))
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "lib.so"),
           str(out / "guidance_epilogue.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the epilogue at cluster {cluster}:\n{proc.stdout}")
    lib = ctypes.CDLL(str(out / "lib.so"))
    _epilogue_types(lib)
    return lib


def _epilogue_types(lib) -> None:
    """The epilogue's entry point: ``dct_guidance_epilogue_table`` (the
    scalars from a device table at a device step index) or, in a tree from
    before it, ``dct_guidance_epilogue`` (six host floats)."""
    if hasattr(lib, "dct_guidance_epilogue_table"):
        lib.dct_guidance_epilogue_table.argtypes = EPILOGUE_TABLE_ARGS
        lib.dct_guidance_epilogue_table.restype = _i
    else:
        lib.dct_guidance_epilogue.argtypes, lib.dct_guidance_epilogue.restype = EPILOGUE_ARGS, _i


def build_variants() -> dict:
    """Compile ``VARIANTS`` (in parallel) → {name: CDLL}."""
    out = ROOT / "depth_completion_tpu_torch" / "_build" / "ab" / "variants"
    csrc = ROOT / "depth_completion_tpu_torch" / "csrc"
    procs = {}
    for name, edits in VARIANTS.items():
        copy = out / name / "csrc"
        copy.mkdir(parents=True, exist_ok=True)
        for src in (*csrc.glob("*.cu"), *csrc.glob("*.cuh")):
            text = src.read_text()
            for old, new in edits if src.name == "flash_attention.cu" else ():
                if text.count(old) != 1:
                    raise RuntimeError(f"variant {name}: {old!r} is not once in {src.name}")
                text = text.replace(old, new)
            (copy / src.name).write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(copy), "-o",
               str(out / name / "lib.so"), str(ROOT / "scripts" / "kernel_ab_variants.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        fn = getattr(lib, VARIANT_ENTRY)
        fn.argtypes, fn.restype = BWD_ARGS, _i
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


def flash_bwd(lib, q, k, v, o, do, lse, heads: int, entry: str | None = None):
    """→ (dq in fp32, dk, dv) through ``dct_flash_bwd`` or, at head dim 512,
    ``dct_flash_bwd_d512`` (or the entry point named)."""
    n, s, c = q.shape
    d = c // heads
    di = torch.empty((n, heads, s), device=q.device, dtype=torch.float32)
    dq = torch.zeros((n, s, c), device=q.device, dtype=torch.float32)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    entry = entry or ("dct_flash_bwd" if d == 64 else "dct_flash_bwd_d512")
    status = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                 do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
                                 dk.data_ptr(), dv.data_ptr(), n, heads, s, s, s * c, c, s * c,
                                 c, s * c, c, s * c, c, s * c, c, 1.0 / math.sqrt(d), _stream())
    _build.check(status, entry)
    return dq, dk, dv


def with_kernels(lib, fn):
    """``fn()`` with this tree's flash wrappers (``ops.flash_attention``)
    launching ``lib``'s kernels."""
    saved = fa._libs.get("flash_attention")
    fa._libs["flash_attention"] = lib
    try:
        return fn()
    finally:
        if saved is None:
            fa._libs.pop("flash_attention")
        else:
            fa._libs["flash_attention"] = saved


def ring_pass(lib, fwd: bool, q, k, v, o, do, lse, heads: int, p: int):
    """One pass of the ring over ``LocalRing(p)`` with ``lib``'s kernels:
    through this tree's ``ops.ring_attention`` where ``lib`` has the ring
    step kernels, else as the ring was before them."""
    if hasattr(lib, "dct_flash_fwd_ring"):
        ring = ra.LocalRing(p)
        if fwd:
            return with_kernels(lib, lambda: ra.ring_forward(q, k, v, heads, ring))
        return with_kernels(lib, lambda: ra.ring_backward(q, k, v, o, do, lse, heads, ring))
    if fwd:
        return ring_fwd_merged(lib, q, k, v, heads, p)
    return ring_bwd_merged(lib, q, k, v, o, do, lse, heads, p)


def _roll(x, p: int):
    """``LocalRing(p).shift``: shard r takes shard r-1's block."""
    return x.unflatten(0, (-1, p)).roll(1, dims=1).flatten(0, 1)


def ring_fwd_merged(lib, q, k, v, heads: int, p: int):
    """The ring's forward as it was before the ring step kernels: one flash
    call per visiting block, then the eager fp32 merge of (o_b, lse2_b)
    against a running max. → (o, lse2)."""
    n, s_loc, c = q.shape
    k_blk, v_blk = k, v
    for step in range(p):
        o_b, lse2_b = flash_fwd(lib, q, k_blk, v_blk, heads)
        o_b = o_b.float().view(n, s_loc, heads, c // heads)
        lse2_b = lse2_b.transpose(1, 2).unsqueeze(-1)
        if step == 0:
            m, w, acc = lse2_b, torch.ones_like(lse2_b), o_b
        else:
            m_new = torch.maximum(m, lse2_b)
            scale_old, scale_b = torch.exp2(m - m_new), torch.exp2(lse2_b - m_new)
            acc = acc * scale_old + o_b * scale_b
            w = w * scale_old + scale_b
            m = m_new
        if step < p - 1:
            k_blk, v_blk = _roll(k_blk, p), _roll(v_blk, p)
    o = (acc / w).to(q.dtype).view(n, s_loc, c)
    return o, (m + torch.log2(w)).squeeze(-1).transpose(1, 2).contiguous()


def ring_bwd_merged(lib, q, k, v, o, do, lse2, heads: int, p: int):
    """The ring's backward as it was before the ring step kernels: one flash
    backward per visiting block (its dq cast to bf16), the blocks' dq, dk
    and dv summed eagerly in fp32, dk/dv rotated P times. → (dq, dk, dv)."""
    k_blk, v_blk = k, v
    for step in range(p):
        dq_b, dk_b, dv_b = flash_bwd(lib, q, k_blk, v_blk, o, do, lse2, heads)
        dq_b = dq_b.to(q.dtype)
        if step == 0:
            dq, dk, dv = dq_b.float(), dk_b.float(), dv_b.float()
        else:
            dq, dk, dv = dq + dq_b, dk + dk_b, dv + dv_b
        if step < p - 1:
            k_blk, v_blk = _roll(k_blk, p), _roll(v_blk, p)
        dk, dv = _roll(dk, p), _roll(dv, p)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _strides(*xs) -> tuple:
    """(batch stride, row stride) of each contiguous [N, S, C] operand."""
    return tuple(v for x in xs for v in (x.stride(0), x.stride(1)))


def generic_fwd(lib, q, k, v, heads: int, state=None, state_in: bool = False,
                state_out: bool = False):
    """The generic forward through ``dct_flash_fwd_<f32|bf16>``: a whole call
    → (o, lse2); with ``state`` (m, l, acc, fp32) a ring step that reads it
    (``state_in``) and writes it in place (``state_out``) → the state."""
    n, s, c = q.shape
    d = c // heads
    fn = getattr(lib, "dct_flash_fwd_f32" if q.dtype == torch.float32 else "dct_flash_fwd_bf16")
    if state is None and not state_out:
        o = torch.empty_like(q)
        lse = torch.empty((n, heads, s), device=q.device, dtype=torch.float32)
        m = l_ = acc = None
    else:
        o = lse = None
        m, l_, acc = state
    ptr = [None if x is None else x.data_ptr() for x in (o, lse, m, l_, acc)]
    strides = _strides(q, k, v) + (s * c, c)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptr, n, heads, s, k.shape[1], d,
                *strides, int(state_in), int(state_out), 1.0 / math.sqrt(d), _stream())
    _build.check(status, "generic flash_fwd")
    return state if state_out else (o, lse)


def generic_bwd(lib, q, k, v, o, do, lse, heads: int, ring=None):
    """The generic backward through ``dct_flash_bwd_<f32|bf16>``: a whole
    call (the di pre-pass, dq zeroed) → (dq in fp32, dk, dv); with ``ring``
    = (di, dq, dkv) a later ring step adding into them in place → ring."""
    n, s, c = q.shape
    d = c // heads
    fn = getattr(lib, "dct_flash_bwd_f32" if q.dtype == torch.float32 else "dct_flash_bwd_bf16")
    if ring is None:
        di = torch.empty((n, heads, s), device=q.device, dtype=torch.float32)
        dq = torch.zeros((n, s, c), device=q.device, dtype=torch.float32)
        dk, dv, dkv = torch.empty_like(k), torch.empty_like(v), None
    else:
        di, dq, dkv = ring
        dk = dv = None
    ptr = [None if x is None else x.data_ptr() for x in (di, dq, dk, dv, dkv)]
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), *ptr, n, heads, s, k.shape[1], d, *_strides(q, k, v, o, do),
                int(ring is not None), int(ring is None), 1.0 / math.sqrt(d), _stream())
    _build.check(status, "generic flash_bwd")
    return ring if ring is not None else (dq, dk, dv)


def stateful_turns(libs: dict, run, state: tuple, reps: int) -> dict:
    """``turns`` for a step that updates ``state`` in place: timed on
    working copies, each tree's outputs from a fresh copy."""
    times = {"base": [], "this": []}
    work = tuple(x.clone() for x in state)
    for tag in ("base", "this", "this", "base"):
        times[tag].append(graph_ms(lambda: run(libs[tag], work), reps))
    outs = {tag: run(libs[tag], tuple(x.clone() for x in state)) for tag in times}
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(outs["base"], outs["this"]))
    base, this = (sum(times[t]) / 2 for t in ("base", "this"))
    return {"base_ms": base, "this_ms": this, "speedup": base / this, "max_abs_diff": diff}


def generic_cases(libs: dict, rnd, reps: int) -> list:
    """The generic pair's whole calls and ring steps, each tree's against
    the other's (inputs o and lse2, and the carried states, from this
    tree)."""
    results = []
    pair = {t: {"fp32": lib["flash_generic_f32"], "bf16": lib["flash_generic_bf16"]}
            for t, lib in libs.items()}
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    for dt, d, s, heads in GENERIC_CASES:
        libs_dt = {t: pair[t][dt] for t in pair}
        q, k, v, do = (rnd(1, s, heads * d, dtype=dtypes[dt]) for _ in range(4))
        r = turns(libs_dt, lambda lib: generic_fwd(lib, q, k, v, heads)[0], reps)
        r.update(kernel=f"flash_fwd_{dt}_d{d}", shape=f"N=1 S={s} heads={heads}")
        results.append(r)
        o, lse = generic_fwd(libs_dt["this"], q, k, v, heads)
        r = turns(libs_dt, lambda lib: generic_bwd(lib, q, k, v, o, do, lse, heads), reps)
        r.update(kernel=f"flash_bwd_{dt}_d{d}", shape=f"N=1 S={s} heads={heads}")
        results.append(r)
    for dt, d, s_loc, heads, p in GENERIC_RING_CASES:
        libs_dt = {t: pair[t][dt] for t in pair}
        q, k1, v1, k2, v2, do = (rnd(p, s_loc, heads * d, dtype=dtypes[dt]) for _ in range(6))
        this = libs_dt["this"]
        m = torch.empty((p, heads, s_loc), device="cuda", dtype=torch.float32)
        first = generic_fwd(this, q, k1, v1, heads, (m, torch.empty_like(m),
                            torch.empty((p, s_loc, heads * d), device="cuda",
                                        dtype=torch.float32)), state_out=True)
        first = tuple(x.clone() for x in first)
        # a middle step from the first's state, on working copies
        r = stateful_turns(libs_dt, lambda lib, st: generic_fwd(lib, q, k2, v2, heads, st, True,
                                                                True), first, reps)
        r.update(kernel=f"flash_fwd_ring_{dt}_d{d}", shape=f"{p}x{s_loc} heads={heads} middle")
        results.append(r)
        o, lse = generic_fwd(this, q, k1, v1, heads)
        c = heads * d
        di = torch.empty((p, heads, s_loc), device="cuda", dtype=torch.float32)
        dq = torch.zeros((p, s_loc, c), device="cuda", dtype=torch.float32)
        dkv = torch.zeros((p, s_loc, 2 * c), device="cuda", dtype=torch.float32)
        fn = getattr(this, "dct_flash_bwd_f32" if dt == "fp32" else "dct_flash_bwd_bf16")
        _build.check(fn(q.data_ptr(), k1.data_ptr(), v1.data_ptr(), o.data_ptr(), do.data_ptr(),
                        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), None, None, dkv.data_ptr(),
                        p, heads, s_loc, s_loc, d, *_strides(q, k1, v1, o, do), 1, 1,
                        1.0 / math.sqrt(d), _stream()), "generic flash_bwd first ring step")
        # a later step (di from the first), adding into working copies
        r = stateful_turns(libs_dt, lambda lib, st: generic_bwd(lib, q, k2, v2, o, do, lse, heads,
                                                                st), (di, dq, dkv), reps)
        r.update(kernel=f"flash_bwd_ring_{dt}_d{d}", shape=f"{p}x{s_loc} heads={heads} later")
        results.append(r)
    return results


def conv(lib, x, w_hwio, bias=None, relu=False, mask=None, w_k=None):
    """One conv through the tree's entry point of x's dtype; the fp32 form
    takes ``w_k`` (K-major) where the library reads that layout."""
    n, h, w, ci = x.shape
    co = w_hwio.shape[3]
    y = torch.empty((n, h, w, co), device=x.device, dtype=x.dtype)
    xm = torch.empty_like(x) if mask is not None else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    entry, wt = lib.dct_conv3x3, w_hwio
    if x.dtype == torch.float32:
        entry = lib.dct_conv3x3_f32
        wt = w_k if hasattr(lib, "dct_conv3x3_f32_k_major") else w_hwio
    status = entry(x.data_ptr(), wt.data_ptr(), ptr(bias), None, ptr(mask), y.data_ptr(),
                   ptr(xm), n, h, w, ci, co, int(relu), _stream())
    _build.check(status, "conv3x3")
    return (y, xm) if mask is not None else y


def epilogue(lib, lat, g, out, m, v, sc):
    """One v-prediction step through the tree's epilogue entry point, in
    place; ``sc`` = (the six scalars as floats, the same as a one-row device
    table, a device step index 0)."""
    n = lat.shape[0]
    floats, table, step = sc
    head = (lat.data_ptr(), g.data_ptr(), out.data_ptr(), m.data_ptr(), v.data_ptr(), n,
            lat.numel() // n, int(out.dtype == torch.bfloat16), 1)
    tail = (0.05, ge.ADAM_B1, ge.ADAM_B2, ge.ADAM_EPS, _stream())
    if hasattr(lib, "dct_guidance_epilogue_table"):
        status = lib.dct_guidance_epilogue_table(*head, table.data_ptr(), step.data_ptr(), *tail)
    else:
        status = lib.dct_guidance_epilogue(*head, *floats, *tail)
    _build.check(status, "guidance_epilogue")


def epilogue_turns(libs: dict, state: tuple, sc, reps: int) -> dict:
    """``turns`` for the in-place epilogue: each tree timed on working
    copies of (lat, g, out, m, v), its outputs taken from fresh ones."""
    lat, g, out, m, v = state
    work = [x.clone() for x in (lat, m, v)]
    times = {"base": [], "this": []}
    for tag in ("base", "this", "this", "base"):
        times[tag].append(graph_ms(
            lambda: epilogue(libs[tag], work[0], g, out, work[1], work[2], sc), reps))
    outs = {}
    for tag in times:
        fresh = [x.clone() for x in (lat, m, v)]
        epilogue(libs[tag], fresh[0], g, out, fresh[1], fresh[2], sc)
        outs[tag] = fresh
    diff = max(float((a - b).abs().max()) for a, b in zip(outs["base"], outs["this"]))
    base, this = (sum(times[t]) / 2 for t in ("base", "this"))
    return {"base_ms": base, "this_ms": this, "speedup": base / this, "max_abs_diff": diff}


def turns(libs: dict, run, reps: int) -> dict:
    """base, this, this, base → per tree the mean ms, and the max abs
    difference over the outputs (``run(libs[tag])`` returns a tensor or a
    tuple)."""
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

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    results = generic_cases(libs, rnd, args.reps)
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
    variants = build_variants()
    for s, heads, n in FLASH_D512_CASES:
        q, k, v, do = (rnd(n, s, heads * 512) for _ in range(4))
        r = turns(flash_libs, lambda lib: flash_fwd(lib, q, k, v, heads)[0], args.reps)
        r.update(kernel="flash_fwd_d512", shape=f"N={n} S={s} heads={heads}")
        results.append(r)
        o, lse = flash_fwd(flash_libs["this"], q, k, v, heads)
        r = turns(flash_libs, lambda lib: flash_bwd(lib, q, k, v, o, do, lse, heads), args.reps)
        r.update(kernel="flash_bwd_d512", shape=f"N={n} S={s} heads={heads}")
        results.append(r)
        for name, lib in variants.items():
            pair = {"base": (lib, VARIANT_ENTRY), "this": (flash_libs["this"], "dct_flash_bwd_d512")}
            r = turns(pair, lambda le: flash_bwd(le[0], q, k, v, o, do, lse, heads, le[1]),
                      args.reps)
            r.update(kernel=f"flash_bwd_d512 (base: variant {name})",
                     shape=f"N={n} S={s} heads={heads}")
            results.append(r)
    for s, heads, p in RING_CASES:
        q, k, v, do = (ra.LocalRing(p).shard(rnd(1, s, heads * 64)) for _ in range(4))
        r = turns(flash_libs, lambda lib: ring_pass(lib, True, q, k, v, None, None, None, heads,
                                                    p), args.reps)
        r.update(kernel="ring_attention_fwd", shape=f"S={s} heads={heads} P={p}")
        results.append(r)
        o, lse = ring_pass(flash_libs["this"], True, q, k, v, None, None, None, heads, p)
        r = turns(flash_libs, lambda lib: ring_pass(lib, False, q, k, v, o, do, lse, heads, p),
                  args.reps)
        r.update(kernel="ring_attention_bwd", shape=f"S={s} heads={heads} P={p}")
        results.append(r)
    relayout = []  # this tree's fp32 weight relayout per call (ops.conv3x3._k_major)
    conv_libs = {t: lib["conv3x3"] for t, lib in libs.items()}
    for dtype, name in ((torch.bfloat16, "conv3x3"), (torch.float32, "conv3x3_fp32")):
        for h, w, ci, co, relu in CONV_CASES:
            x, dy = rnd(1, h, w, ci, dtype=dtype), rnd(1, h, w, co, dtype=dtype)
            wt = rnd(3, 3, ci, co, scale=1.0 / math.sqrt(9 * ci), dtype=dtype)
            kf = rnd(3, 3, co, ci, scale=1.0 / math.sqrt(9 * co), dtype=dtype)
            wt_k, kf_k = c3._k_major(wt).contiguous(), c3._k_major(kf).contiguous()
            b = rnd(co, scale=0.1, dtype=dtype)
            mask = c3.conv3x3_plain(x, wt, b, relu=relu)[0] if relu else None
            form = "TAESD" if relu else "KL"
            r = turns(conv_libs, lambda lib: conv(lib, x, wt, b, relu, w_k=wt_k), args.reps)
            r.update(kernel=name, shape=f"{h}x{w} {ci}->{co} {form} fwd")
            results.append(r)
            r = turns(conv_libs, lambda lib: conv(lib, dy, kf, mask=mask, w_k=kf_k), args.reps)
            r.update(kernel=name,
                     shape=f"{h}x{w} {co}->{ci} {form} {'masked ' if relu else ''}dx")
            results.append(r)
            if dtype == torch.float32:
                oihw = wt.permute(3, 2, 0, 1).contiguous()  # the port's storage layout
                relayout.append({
                    "shape": f"{ci}->{co}",
                    "fwd_ms": graph_ms(lambda: c3._k_major(c3._hwio(oihw)).contiguous(),
                                       args.reps),
                    "dx_ms": graph_ms(
                        lambda: c3._k_major(c3._flip_transpose_hwio(oihw)).contiguous(),
                        args.reps),
                })
    epi_libs = {t: lib["guidance_epilogue"] for t, lib in libs.items()}
    variant = {"base": build_epilogue_variant(EPILOGUE_VARIANT_CLUSTER), "this": epi_libs["this"]}
    sched = make_schedule()
    t = int(make_timesteps(sched.config, 50)[3])
    floats = ge.epilogue_scalars(sched, t, 50, 3)
    sc = (floats, torch.tensor([floats], dtype=torch.float32, device="cuda"),
          torch.zeros(1, dtype=torch.int64, device="cuda"))
    for n, eh, ew in EPILOGUE_CASES:
        shape = (n, eh, ew, 4)
        lat, g, m = (torch.randn(shape, generator=gen, device="cuda") * s for s in (1.0, 1e-3, 0.3))
        out = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        v = m * m + 0.1 * torch.rand(shape, generator=gen, device="cuda")
        for pair, label in ((epi_libs, "guidance_epilogue"),
                            (variant, "guidance_epilogue (base: this tree at cluster "
                                      f"{EPILOGUE_VARIANT_CLUSTER})")):
            r = epilogue_turns(pair, (lat, g, out, m, v), sc, args.reps)
            r.update(kernel=label, shape=f"N={n} {eh}x{ew}x4 v-pred")
            results.append(r)
    for r in results:
        print(f"{r['kernel']} {r['shape']}: base {r['base_ms']:.4f} ms, this {r['this_ms']:.4f} ms "
              f"(x{r['speedup']:.3f}), max|diff| {r['max_abs_diff']:.3e}")
    for r in relayout:
        print(f"weight_relayout fp32 {r['shape']}: fwd {r['fwd_ms']:.4f} ms, dx {r['dx_ms']:.4f} ms")
    print(json.dumps({"card": card(), "reps": args.reps, "cases": results,
                      "weight_relayout": relayout}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
