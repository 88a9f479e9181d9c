"""The program cache: one program per signature, PyTorch counterpart of
the JAX pipeline's per-signature programs
(``depth_completion_tpu.pipeline.pipeline``: ``_lru_program``,
``program_keys`` and ``max_programs``, :70-126).

The JAX package jit-compiles the whole of ``guided_sample`` once per
(branch, batch, geometry, config) signature. The port's counterpart is a
``sampler.SamplerProgram`` per signature, one class per branch of the
sampler: fixed buffers and, on a card, a CUDA graph per phase (the prepare
step, the branch's step or steps, the finish step), each replayed as often
as the phase runs. The cache holds them:

- an LRU keyed by signature (``program_key``, whose first field names the
  branch): ``max_programs`` bounds the live programs, and an evicted
  program's graphs, buffers and share of the pool go with it (the caller
  that is running it keeps its reference until it returns);
- one graph memory pool for all its programs' graphs. A captured phase
  leaves no live tensor of its own in the pool (its results go into the
  program's fixed buffers), so the graphs of one cache, replayed one at a
  time on one stream, can share it: the pool is as large as the largest
  phase, not the sum of them;
- a lock around the LRU bookkeeping, as in JAX, so concurrent callers
  keep it consistent.

``EagerTwin`` is the cache's plain twin: the same programs and buffers,
each phase run eagerly on any device. It is tier 0 of the serving engine's
tiered warmup, and the reference that ``chip_smoke.py`` holds the graphs
to; no entry point chooses it by an option.

``LAUNCH_COUNTERS`` are the kernel wrappers' launch counts. A wrapper
counts in Python where it launches; a capture launches nothing, so each
program records what each phase's capture counted (``launch_delta[phase]``),
takes it off again, and adds it at every replay of that phase's graph,
where the kernels do launch.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable

import torch

from depth_completion_tpu_torch.ops import conv3x3, flash_attention, guidance_epilogue

LAUNCH_COUNTERS = (flash_attention.LAUNCHES, conv3x3.LAUNCHES, guidance_epilogue.LAUNCHES)


def launch_counts() -> dict[str, int]:
    return {name: n for counts in LAUNCH_COUNTERS for name, n in counts.items()}


def add_launches(delta: dict[str, int], sign: int = 1) -> None:
    """Add ``sign`` times ``delta`` to the wrappers' launch counts."""
    for counts in LAUNCH_COUNTERS:
        for name in counts:
            counts[name] += sign * delta.get(name, 0)


def program_key(branch: str, bundle: Any, images_shape: tuple, cfg: Any, remat: bool) -> tuple:
    """The signature of a request: (the sampler's branch
    (``sampler.sampler_branch``), images' shape [N, H, W, C], the sampler
    config without the fields that only shape the initial latent and the
    LCM re-noise (seed, beta: a carried or seeded latent shares the
    program), the remat setting, the bundle's identity (a graph holds its
    weights' addresses)). The config holds the resolution, the steps, the
    ring and every other field the program reads."""
    step_cfg = dataclasses.replace(cfg, seed=type(cfg).seed, beta=type(cfg).beta)
    return (branch, tuple(int(d) for d in images_shape), step_cfg, bool(remat), id(bundle))


def signature(key: tuple) -> tuple[int, int, int, int]:
    """A program key's images shape (batch, h, w, c): the part of the key
    that serving buckets and diagnostics read."""
    return key[1]


class ProgramCache:
    """An LRU of ``sampler.SamplerProgram``s sharing one graph memory pool."""

    capture = True  # run each program's phases as replays of their captured graphs

    def __init__(self, max_programs: int | None = None):
        if max_programs is not None and max_programs < 1:
            raise ValueError(f"max_programs must be >= 1, got {max_programs}")
        self.max_programs = max_programs
        self._programs: OrderedDict[tuple, Any] = OrderedDict()
        self._lock = threading.Lock()
        self._pool = None

    def keys(self) -> list[tuple]:
        """Live program signatures, oldest first."""
        with self._lock:
            return list(self._programs)

    def find(self, shape: tuple) -> Any:
        """The most recently used live program for images of ``shape``
        (batch, h, w, c), or None; the LRU order stays (diagnostics)."""
        shape = tuple(int(d) for d in shape)
        with self._lock:
            found = [p for k, p in self._programs.items() if signature(k) == shape]
        return found[-1] if found else None

    def get(self, key: tuple, make: Callable[[], Any]) -> Any:
        """The program for ``key``, made by ``make()`` on a miss; the least
        recently used beyond ``max_programs`` is dropped."""
        with self._lock:
            program = self._programs.get(key)
            if program is None:
                program = self._programs[key] = make()
                if self.max_programs is not None:
                    while len(self._programs) > self.max_programs:
                        self._programs.popitem(last=False)
            else:
                self._programs.move_to_end(key)
            return program

    def pool(self):
        """The cache's graph memory pool (made at the first capture)."""
        with self._lock:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            return self._pool

    def run(self, program: Any) -> None:
        """One request's phases: on a card, their captured graphs (each
        captured at the program's first request); on the CPU, eagerly."""
        program.run(self if self.capture else None)


class EagerTwin(ProgramCache):
    """The cache's plain twin: every phase run eagerly, on any device."""

    capture = False
