"""The port stands alone: no JAX, no optax, nothing of the JAX package, and
none of the packages the card's machine lacks (safetensors, transformers,
click, cv2, tqdm, matplotlib, PIL, blosc2, ml_dtypes, loguru); nor does it
name the JAX package's native codec (``native/``, ``dcz_codec.so``) or the
system c-blosc library the JAX package's ``.bl2`` codec loads. The tests'
rank workers (``tests/torch_*_worker.py``, run in spawned processes) and
the port's scripts (the serving bench, the profiler, the kernel A/B, the
synthetic-checkpoint writer, the checkpoint verifier and the configuration
drivers: native resolution, the frontier, KITTI, scaling, what they share,
and the sensitivity of the smoke's ring check) are held to the same
rules."""

import ast
import glob
import os
import subprocess
import sys

from scripts.check_quality import _ast_lint, _undefined_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "depth_completion_tpu_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")
PROFILE = os.path.join(REPO, "scripts", "profile_torch_step.py")
KERNEL_AB = os.path.join(REPO, "scripts", "kernel_ab.py")
BENCH_SERVE = os.path.join(REPO, "scripts", "bench_serve_torch.py")
SYNTH_CHECKPOINT = os.path.join(REPO, "scripts", "make_synthetic_checkpoint_torch.py")
VERIFY_CHECKPOINT = os.path.join(REPO, "scripts", "verify_checkpoint_torch.py")
DRIVERS = [os.path.join(REPO, "scripts", f"{name}.py") for name in (
    "drivers_torch", "bench_nativeres_torch", "frontier_torch", "bench_kitti_torch",
    "bench_scaling_torch", "ring1_sensitivity_torch")]
SCRIPTS = [PROFILE, KERNEL_AB, BENCH_SERVE, SYNTH_CHECKPOINT, VERIFY_CHECKPOINT, *DRIVERS]
FORBIDDEN = ("jax", "jaxlib", "optax", "depth_completion_tpu", "safetensors", "transformers",
             "click", "cv2", "tqdm", "matplotlib", "PIL", "blosc2", "ml_dtypes", "loguru")


WORKERS = sorted(glob.glob(os.path.join(REPO, "tests", "torch_*_worker.py")))


def _port_files(exts=(".py",)):
    out = [SMOKE, *SCRIPTS, *WORKERS]
    for root, dirs, names in os.walk(PORT):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "_build")]
        out.extend(os.path.join(root, n) for n in names if n.endswith(exts))
    return out


def test_no_forbidden_imports():
    bad = []
    for path in _port_files():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                mods = [node.module]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                if top in FORBIDDEN:
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno}: {mod}")
    assert bad == []


def test_no_port_file_names_the_native_codec():
    """The port builds its own codec from ``csrc/dcz_codec.cpp``; no source
    of it opens or builds anything under ``native/``."""
    bad = []
    for path in _port_files((".py", ".cpp", ".cu", ".cuh")):
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if "native/" in line or "dcz_codec.so" in line or '"native"' in line:
                    bad.append(f"{os.path.relpath(path, REPO)}:{i}: {line.strip()}")
    assert bad == []


def test_no_port_file_names_libblosc():
    """The port's ``.bl2`` codec carries the blosc containers itself: no
    source of it loads or names the c-blosc shared library."""
    bad = []
    for path in _port_files((".py", ".cpp", ".cu", ".cuh")):
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if "libblosc" in line or 'find_library("blosc")' in line:
                    bad.append(f"{os.path.relpath(path, REPO)}:{i}: {line.strip()}")
    assert bad == []


def test_import_leaves_jax_unloaded():
    # modules loaded by the import itself, beyond those torch loads (an
    # interpreter's site hooks may preload others, and torch.hub imports
    # tqdm where it is installed)
    code = (
        "import sys, numpy, torch; before = set(sys.modules); "
        "import depth_completion_tpu_torch.pipeline.pipeline, "
        "depth_completion_tpu_torch.models.weights, "
        "depth_completion_tpu_torch.models.bundle, "
        "depth_completion_tpu_torch.cli.predict, depth_completion_tpu_torch.cli.analyze, "
        "depth_completion_tpu_torch.io, depth_completion_tpu_torch.io.bl2, "
        "depth_completion_tpu_torch.utils, depth_completion_tpu_torch.viz, "
        "depth_completion_tpu_torch.parallel.ensemble, depth_completion_tpu_torch.serving, "
        "depth_completion_tpu_torch.core.mesh, depth_completion_tpu_torch.parallel.sharding, "
        "tests.torch_parallel_worker, tests.torch_ring_worker, "
        "depth_completion_tpu_torch.serving.server, depth_completion_tpu_torch.cli.serve, "
        "scripts.make_synthetic_checkpoint_torch, scripts.verify_checkpoint_torch, "
        "scripts.bench_serve_torch, scripts.drivers_torch, scripts.bench_nativeres_torch, "
        "scripts.frontier_torch, scripts.bench_kitti_torch, scripts.bench_scaling_torch; "
        f"bad = [m for m in set(sys.modules) - before if m.split('.')[0] in {FORBIDDEN!r}]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_quality_gates_clean():
    targets = [PORT, SMOKE, *SCRIPTS, *WORKERS]
    assert _undefined_names(targets) == []
    assert _ast_lint(targets) == []
