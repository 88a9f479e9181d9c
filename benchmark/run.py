"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is looked up by name in
``BENCHMARK.json``; everything that belongs to it is found by name under
``benchmark/``: ``configs/<config>.json``, ``traffic/<traffic>.json`` and
the driver ``drivers/<kind>.py`` that the mix's ``kind`` names,
``limits/<workload>.json`` (the correctness limits), and one reader
``metrics/<metric>.py`` per metric. The driver sets up the system under
test, warms it up, measures a window of ``--seconds`` and hands back a
record; the readers turn the record into metrics (``--trace 0``: the
cell's end-to-end metrics; ``--trace 1``: its per-layer metrics, read
from a profiled part of the window); the plain reference then decides
``correct`` (``harness.check``). The last line of standard output is the
result, one JSON object.

Exit codes: 0 with a result; 2 without a card (or fewer than the cell
asks for); 3 when JAX or the JAX package was loaded; 1 on any other
failure. Only the result line is printed on standard output.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "depth_completion_tpu")
CACHE = ROOT / ".bench_cache"


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no JAX through
    ``transformers``; few host threads."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def load_file(path: Path, name: str):
    """A module from a file of the benchmark, by path."""
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no {path.relative_to(BENCH)}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no {path.relative_to(BENCH)}")
    return json.loads(path.read_text())


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics this cell reports: its end-to-end ones (``--trace 0``)
    or its per-layer ones (``--trace 1``); a metric without ``workloads``
    is every cell's that reports the metric it ``moves``."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench_dir: Path = BENCH) -> dict:
    """One run of ``workload``: the result object (without printing)."""
    import torch

    from benchmark.harness import check, flops

    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise KeyError(f"BENCHMARK.json has no workload {workload!r}")
    config = read_json(bench_dir / "configs" / f"{cell['config']}.json")
    mix = read_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    limits = read_json(bench_dir / "limits" / f"{workload}.json")
    driver = load_file(bench_dir / "drivers" / f"{mix['kind']}.py", f"bench_driver_{mix['kind']}")
    metrics = cell_metrics(bench, workload, trace)
    readers = {m["name"]: load_file(bench_dir / "metrics" / f"{m['name']}.py",
                                    f"bench_metric_{m['name']}") for m in metrics}
    dev = torch.device(device)

    record = driver.run(config=config, mix=mix, seed=seed, seconds=seconds, trace=trace,
                        device=dev, t0=T0)
    start, end = record["window"]
    sys.stderr.write(f"setup_s {record['setup_s']:.3f}; window {end - start:.3f} s, "
                     f"{record['attempted']} requests, {record['failed']} failed\n")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    record["work"] = flops.count_work(config, mix["request"], mix["height"], mix["width"])
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(record)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    checked = record["checked"]
    complete = bool(checked) and all(c.get("dense") is not None for c in checked)
    t_ref = time.perf_counter()
    numbers = {}
    if complete:
        refs = check.reference_outputs(config, mix["request"], seed, checked, dev)
        decoded = check.decoded_maps(config, mix["request"], seed, checked, dev)
        numbers = check.compare(checked, refs, mix["request"], decoded)
    sys.stderr.write(f"reference s {time.perf_counter() - t_ref:.1f}\n")
    correct, shown = check.verdict(numbers, limits, complete)
    others = {k: v for k, v in numbers.items() if k not in shown}
    if others:
        sys.stderr.write(f"read, not compared (no limit): {others}\n")
    sys.stderr.write(f"peak GiB {record['memory_peak_bytes'] / 2**30:.3f}\n")
    for name, v in shown.items():
        sys.stderr.write(f"check {name} {v['value']!r} limit {v['limit']!r}\n")

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(record["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(record["attempted"]),
              "failed": int(record["failed"]), "metrics": values, "device": device_info}
    tr = record.get("trace")
    if trace and tr is not None:
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        fams = sorted(tr.family_seconds().items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k, v] for k, v in fams],
                               "idle_gaps": tr.idle_gaps(10)}
    result["checks"] = shown
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    bench = read_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        sys.stderr.write(f"BENCHMARK.json has no workload {args.workload!r}\n")
        return 1

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        sys.stderr.write(f"the cell needs {cell['chips']} CUDA device(s); "
                         f"{torch.cuda.device_count()} available\n")
        return 2
    torch.set_num_threads(4)
    sys.stderr.write(f"card: {card_line()}\n")
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        sys.stderr.write(f"loaded in this process: {', '.join(found)}; no result\n")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
