"""The harness on the CPU: every file it finds by name, the result line's
keys, the yardstick's arithmetic, and the isolation of the harness from
JAX and of the reference from the system under test."""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys

import pytest
import torch
from conftest import BENCH, ROOT
from torch.utils.flop_counter import FlopCounterMode

from benchmark import run
from benchmark.harness import flops
from benchmark.reference.nn import Numerics

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_named_file_is_found():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        mix = run.read_json(BENCH / "traffic" / f"{w['traffic']}.json")
        assert (BENCH / "drivers" / f"{mix['kind']}.py").is_file()
        assert run.read_json(BENCH / "limits" / f"{w['name']}.json")
        for trace in (False, True):
            metrics = run.cell_metrics(bench, w["name"], trace)
            assert metrics, (w["name"], trace)
            for m in metrics:
                reader = run.load_file(BENCH / "metrics" / f"{m['name']}.py", m["name"])
                assert callable(reader.read)
        e2e = {m["name"] for m in run.cell_metrics(bench, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        cells = set(e2e[m["moves"]].get("workloads", [w["name"] for w in bench["workloads"]]))
        assert set(m["workloads"]) <= cells


def test_result_line_has_the_contract_keys(tiny_bench):
    bench, d = tiny_bench
    for trace in (False, True):
        res = run.run_cell(bench, "taesd.offline.b8", 2**31 + 17, 0.2, trace, device="cpu",
                           bench_dir=d)
        keys = list(res)
        assert set(keys) >= {"correct", "attempted", "failed", "metrics", "device"}
        assert keys[-1] == "checks" and ("breakdown" in keys) == trace
        assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        if trace:
            assert {"busy_s", "window_s"} <= set(res["device"])
            assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
        want = {m["name"] for m in run.cell_metrics(bench, "taesd.offline.b8", trace)}
        assert set(res["metrics"]) <= want
        if not trace:
            assert set(res["metrics"]) == want
        json.dumps(res)


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "kl.offline.b1",
                          "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_bounds_match_the_kernel_table():
    fwd = {"kind": "unet_self", "n": 1, "s": 6912, "sk": 6912, "heads": 5, "d": 64}
    assert round(flops.flash_bound_s(fwd) * 1e3, 4) == 0.0618
    assert round(flops.flash_bound_s(fwd, backward=True) * 1e3, 4) == 0.1546
    conv = {"kind": "vae3x3", "n": 1, "h": 576, "w": 768, "ci": 64, "co": 64, "k": 3,
            "stride": 1, "relu": True, "skip": False, "bias": True}
    assert round(flops.conv_bound_s(conv) * 1e3, 4) == 0.0338
    big = dict(conv, ci=128, co=128, relu=False)  # the KL 128→128 conv: bound by its operations
    assert round(flops.conv_bound_s(big) * 1e3, 4) == 0.1319


def test_flop_counter_matches_a_hand_count():
    nx = Numerics()
    x = torch.randn(2, 12, 16, 8)
    p = {"kernel": torch.randn(24, 8, 3, 3), "bias": torch.randn(24)}
    with FlopCounterMode(display=False) as fc:
        nx.conv(p, x)
    assert fc.get_total_flops() == 2 * 2 * 12 * 16 * 8 * 24 * 9
    q, k, v = (torch.randn(2, 40, 32) for _ in range(3))
    with FlopCounterMode(display=False) as fc:
        nx.attention(q, k, v, 4)
    assert fc.get_total_flops() == flops.flash_flops(40, 40, 4, 8, n=2)


def test_work_counts_the_published_calls():
    cfg = run.read_json(BENCH / "configs" / "marigold-taesd.json")
    mix = run.read_json(BENCH / "traffic" / "offline-b8.json")
    work = flops.count_work(cfg, mix["request"], mix["height"], mix["width"])
    convs = [c for c in work["step"]["calls"] if flops.is_conv3x3(c)]
    flash = [c for c in work["step"]["calls"] if flops.is_flash_d64(c)]
    # TAESD's decoder: 10 block convs and upsample convs at each of three
    # scales and 3 at the last, each forward and input gradient
    assert len(convs) == 33 and len(flash) == 10
    assert sorted({(c["s"], c["heads"]) for c in flash}) == [(1728, 10), (6912, 5)]
    assert 3.0e12 < work["step"]["flops"] < 4.5e12


def _modules_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_nothing_loads_jax_and_the_reference_loads_nothing_of_the_port():
    metric_files = sorted(p.name for p in (BENCH / "metrics").glob("*.py"))
    loaded = _modules_after(
        "import benchmark.run as r, benchmark.control\n"
        "from pathlib import Path\n"
        "for p in sorted(Path('benchmark/drivers').glob('*.py')): r.load_file(p, 'd_' + p.stem)\n"
        f"for n in {metric_files!r}: r.load_file(Path('benchmark/metrics') / n, 'm_' + n)\n"
        "import depth_completion_tpu_torch.pipeline.pipeline, "
        "depth_completion_tpu_torch.serving.server, depth_completion_tpu_torch.models.bundle")
    assert "depth_completion_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "depth_completion_tpu"}
    loaded = _modules_after("import benchmark.reference.sampler, benchmark.harness.check, "
                            "benchmark.harness.flops, benchmark.harness.trace, "
                            "benchmark.harness.frames")
    assert "depth_completion_tpu_torch" not in loaded and "torch" in loaded


def test_trace_reduction():
    from benchmark.harness.trace import Event, Trace

    ev = [Event("bench.window", False, 0.0, 10.0), Event("bench.fetch", False, 6.0, 9.0),
          Event("cudaStreamSynchronize", False, 6.5, 8.5),
          Event("void flash_fwd_kernel<false, false>", True, 1.0, 3.0),
          Event("void conv3x3_kernel<64>", True, 2.0, 5.0),
          Event("Memcpy DtoH (Device -> Pinned)", True, 9.0, 9.5),
          Event("void flash_bwd_kernel<false>", True, 11.0, 12.0)]
    tr = Trace(ev)
    assert math.isclose(tr.busy_s(), 4.5) and math.isclose(tr.window_s, 10.0)
    fam = tr.family_seconds()
    assert fam == {"flash_fwd": 2.0, "conv3x3": 3.0, "memcpy_memset": 0.5}
    assert tr.family_launches() == {"flash_fwd": 1, "conv3x3": 1, "memcpy_memset": 1}
    gaps = tr.idle_gaps()
    assert gaps[0] == ["bench.fetch > cudaStreamSynchronize", 4.0]
    assert [g[1] for g in gaps] == [4.0, 1.0, 0.5]


@pytest.mark.parametrize("name", ["setup_s", "frames_per_s", "serve_p95_s"])
def test_end_to_end_readers(name):
    reqs = [{"sent": i, "done": i + 2.0, "frames": 8, "ok": True} for i in range(19)]
    reqs.append({"sent": 19, "done": 30.0, "frames": 8, "ok": False})
    record = {"setup_s": 12.5, "window": (0.0, 40.0), "requests": reqs}
    got = run.load_file(BENCH / "metrics" / f"{name}.py", name).read(record)
    want = {"setup_s": 12.5, "frames_per_s": 19 * 8 / 40.0, "serve_p95_s": 2.0}[name]
    assert math.isclose(got, want)


@pytest.mark.parametrize("name,kernel,per_step", [
    ("roofline_pct.conv3x3", "void conv3x3_kernel<64>", 2),
    ("roofline_pct.flash_d64", "void flash_fwd_kernel<false, false>", 1)])
def test_roofline_reads_only_the_calls_it_bounds(name, kernel, per_step):
    """A kernel roofline is read where its family's launches are the calls
    its bound counts, and is not read where they differ (a call routed to
    the kernel that the bound does not count)."""
    from benchmark.harness.trace import Event, Trace

    work = {"step": {"calls": [{"kind": "x"}] * 3}, "prepare": {"calls": [{"kind": "x"}]},
            "finish": {"calls": [{"kind": "x"}] * 2}}
    select = flops.is_conv3x3 if "conv" in name else flops.is_flash_d64
    work = {ph: {"calls": [dict(c, kind="vae3x3", k=3, stride=1, ci=64, co=64, n=1, h=8, w=8,
                                relu=False, skip=False, bias=True, s=1024, sk=1024, heads=5,
                                d=64) for c in v["calls"]]} for ph, v in work.items()}
    if "flash" in name:
        for ph in ("prepare", "finish"):
            work[ph]["calls"] = []
        for c in work["step"]["calls"]:
            c["kind"] = "unet_self"
    assert all(select(c) for ph in work.values() for c in ph["calls"])
    steps = 2
    want = flops.request_launches(work, select, steps, per_step)
    reader = run.load_file(BENCH / "metrics" / f"{name}.py", name)

    def record(launches):
        ev = [Event("bench.window", False, 0.0, 10.0)]
        ev += [Event(kernel, True, 0.1 * i, 0.1 * i + 0.05) for i in range(launches)]
        return {"trace": Trace(ev), "traced_frames": 1, "traced_requests": 1, "steps": steps,
                "work": work}

    assert want == steps * per_step * 3 + (3 if "conv" in name else 0)
    assert reader.read(record(want)) > 0
    assert reader.read(record(want + 1)) is None
