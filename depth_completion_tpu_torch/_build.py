"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``. Libraries live in ``_build/`` beside this file, named by a hash
of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header rebuilds and an unchanged one loads at once. Nothing is built at import time: a machine without
``nvcc`` imports the package and runs its CPU paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("flash_attention", "conv3x3", "guidance_epilogue", "probe_mma", "probe_block_step",
           "probe_flash_twostream")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str) -> tuple[Path, subprocess.Popen | None]:
    """Start nvcc for ``name`` unless its library is current."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    proc.tmp = tmp  # type: ignore[attr-defined]
    return target, proc


def _finish(name: str, target: Path, proc: subprocess.Popen | None) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(proc.tmp, target)  # type: ignore[attr-defined]
    return log


def build_all() -> dict[str, str]:
    """Compile every kernel source at once (one nvcc each, in parallel);
    returns each source's compiler log (register and spill report)."""
    with _lock:
        started = {name: _start(name) for name in SOURCES}
        return {name: _finish(name, *started[name]) for name in SOURCES}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target, proc = _start(name)
            _finish(name, target, proc)
            lib = ctypes.CDLL(str(target))
            _libs[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
