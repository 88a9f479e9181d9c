"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``. Libraries live in ``_build/`` beside this file, named by a hash
of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header rebuilds and an unchanged one loads at once. Nothing is built at import time: a machine without
``nvcc`` imports the package and runs its CPU paths.

The host codecs (``csrc/<name>.cpp``: the dcz array codec with the
``.bl2`` chunk primitives, the PNG unfiltering loop, the JPEG decoder) are
built the same way with ``g++``, by ``load`` at their
first use, on any machine; with no ``g++`` they raise.
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
SOURCES = ("flash_attention", "flash_generic_f32", "flash_generic_bf16", "conv3x3",
           "guidance_epilogue", "probe_mma", "probe_block_step", "probe_flash_twostream")
HOST_SOURCES = ("dcz_codec", "png_unfilter", "jpeg_decode")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
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


def _source(name: str) -> Path:
    return CSRC / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def _target(name: str) -> Path:
    src = _source(name).read_bytes()
    if name in HOST_SOURCES:
        extra = " ".join(GXX_FLAGS).encode()
    else:
        headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
        extra = headers + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(src + extra).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str) -> tuple[Path, subprocess.Popen | None]:
    """Start the compiler for ``name`` (nvcc, or g++ for a host source)
    unless its library is current."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    if name in HOST_SOURCES:
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found: csrc/{name}.cpp cannot be built")
        cmd = [gxx, *GXX_FLAGS, "-o", str(tmp), str(_source(name))]
    else:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
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
        raise RuntimeError(f"the build of {_source(name).relative_to(CSRC.parent)} failed:\n{log}")
    os.replace(proc.tmp, target)  # type: ignore[attr-defined]
    return log


def build_all() -> dict[str, str]:
    """Compile every kernel and host source at once (one compiler each, in
    parallel); returns each source's compiler log (register and spill
    report)."""
    with _lock:
        started = {name: _start(name) for name in SOURCES + HOST_SOURCES}
        return {name: _finish(name, *started[name]) for name in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or, for a name in
    ``HOST_SOURCES``, ``csrc/<name>.cpp``), building it if needed."""
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
