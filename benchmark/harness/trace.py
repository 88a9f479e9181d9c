"""The traced run's reduction: from ``torch.profiler`` events to device
busy time, idle gaps and time by kernel family.

``Trace`` holds the profiled events as plain tuples (name, on the device,
start s, end s), read once from the profiler, and the profiled
window: the ``bench.window`` span the drivers open around the profiled
requests. Device events are kernels, copies and sets alike.

``FAMILIES`` classifies kernel names (first match wins, on the lower-cased
name): the port's own kernels by their names in ``csrc/``, then the
library's.
"""

from __future__ import annotations

from dataclasses import dataclass

WINDOW_SPAN = "bench.window"

FAMILIES = (
    ("flash_fwd_ring", ("flash_fwd_kernel<true", "flash_fwd_kernel<false, true")),
    ("flash_fwd_generic", ("flash_fwd_generic",)),
    ("flash_bwd_generic", ("flash_bwd_generic", "flash_bwd_di_generic")),
    ("flash_bwd_ring", ("flash_bwd_kernel<true",)),
    ("flash_fwd", ("flash_fwd_kernel",)),
    ("flash_bwd", ("flash_bwd_kernel", "flash_bwd_di_kernel")),
    ("flash_fwd_d512", ("flash_fwd_d512_kernel",)),
    ("flash_bwd_d512", ("flash_bwd_d512_kernel", "flash_bwd_dq_d512_kernel",
                        "flash_bwd_di_d512_kernel")),
    ("conv3x3", ("conv3x3_kernel",)),
    ("conv3x3_fp32", ("conv3x3_f32_kernel",)),
    ("guidance_epilogue", ("guidance_epilogue_kernel",)),
    ("cudnn_conv", ("conv", "cudnn", "xmma_fprop", "xmma_dgrad", "implicit_gemm", "winograd")),
    ("gemm", ("gemm", "cutlass", "sm90_xmma", "ampere_bf16", "nvjet")),
    ("norm", ("norm",)),
    ("softmax_reduce", ("softmax", "reduce")),
    ("memcpy_memset", ("memcpy", "memset")),
    ("elementwise_copy", ("elementwise", "vectorized", "copy", "cat", "fill", "index")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


@dataclass(frozen=True)
class Event:
    name: str
    device: bool
    start: float  # s, the profiler's clock
    end: float


def _ns(e, what: str) -> float:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(e, f"{what}_us")()) * 1e3


def events_from_profiler(prof) -> list[Event]:
    """Every event of a finished ``torch.profiler.profile``, less the device
    timeline's copies of host annotations (``gpu_user_annotation``: a
    ``record_function`` range drawn over the device work it launched)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        device = e.device_type() == cuda
        if device and (getattr(e, "is_user_annotation", lambda: False)()
                       or "annotation" in str(getattr(e, "activity_type", lambda: "")()).lower()
                       or e.name().startswith("bench.")):
            continue
        start = _ns(e, "start")
        end = start + float(e.duration_ns()) if hasattr(e, "duration_ns") else _ns(e, "end")
        out.append(Event(e.name(), device, start * 1e-9, end * 1e-9))
    return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Trace:
    """A profiled window's events (see the module docstring)."""

    def __init__(self, events: list[Event]):
        spans = [e for e in events if not e.device and e.name == WINDOW_SPAN]
        if not spans:
            raise ValueError(f"the trace holds no {WINDOW_SPAN!r} span")
        self.start = min(e.start for e in spans)
        self.end = max(e.end for e in spans)
        self.device = [e for e in events if e.device and e.end > self.start and e.start < self.end]
        self.host = [e for e in events if not e.device]

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> list[list[float]]:
        return _merge([(max(e.start, self.start), min(e.end, self.end)) for e in self.device])

    def busy_s(self) -> float:
        """Seconds in which some kernel, copy or set ran."""
        return sum(e - s for s, e in self.busy_intervals())

    def family_seconds(self) -> dict[str, float]:
        """Device seconds by kernel family, clipped to the window."""
        out: dict[str, float] = {}
        for e in self.device:
            fam = family(e.name)
            out[fam] = out.get(fam, 0.0) + min(e.end, self.end) - max(e.start, self.start)
        return out

    def family_launches(self) -> dict[str, int]:
        """Kernel launches by family in the window: events, counted whole."""
        out: dict[str, int] = {}
        for e in self.device:
            fam = family(e.name)
            out[fam] = out.get(fam, 0) + 1
        return out

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The longest spans with nothing on the device, each named by the
        host ops running at its middle (the outermost benchmark span, then
        the innermost op)."""
        gaps, t = [], self.start
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:top]:
            mid = 0.5 * (s + e)
            around = [h for h in self.host if h.start <= mid <= h.end and h.name != WINDOW_SPAN]
            bench = [h for h in around if h.name.startswith("bench.")]
            inner = min(around, key=lambda h: h.end - h.start, default=None)
            parts = [min(bench, key=lambda h: h.start).name] if bench else []
            if inner is not None and (not bench or inner.name != parts[0]):
                parts.append(inner.name)
            out.append([" > ".join(parts) or "no host op", e - s])
        return out
