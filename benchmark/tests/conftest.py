"""A tiny copy of the benchmark for CPU tests: the real drivers and metric
readers, with the configurations and mixes cut to test sizes (the same
keys, tiny widths, 32x48 frames, a few steps, float32).

Limits at the test size: there the port runs float32 on the CPU and agrees
with the reference to ~1e-5, so each number a cell compares gets
``TINY_LIMIT``, far above that and far below what a fault or the control
reads."""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_UNET = dict(block_out_channels=[32, 64], num_heads=[2, 4], attention_stages=[True, False],
                 cross_attention_dim=32, layers_per_block=1, norm_groups=8)
TINY_TEXT = dict(vocab_size=512, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
TINY_LIMIT = 1e-3


def tiny_config(name: str) -> dict:
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c["unet"].update(TINY_UNET)
    c["text"].update(TINY_TEXT)
    if c["vae_kind"] == "kl":
        c["vae"].update(block_out_channels=[16, 32], layers_per_block=1, norm_groups=8)
    else:
        c["vae"].update(channels=16, encoder_blocks=[1, 1], decoder_blocks=[1, 1])
    c["dtype"] = "float32"
    return c


def tiny_mix(name: str, steps: int = 3) -> dict:
    t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    t.update(height=32, width=48, points=40)
    if t["kind"] == "offline":
        t["trace_min_s"] = 0.05
    t["request"].update(steps=steps, resolution=48)
    if t["kind"] == "serve":
        t["streams"] = 3
    else:
        t["batch"] = min(t["batch"], 4)
    return t


@pytest.fixture
def tiny_bench(tmp_path):
    """(BENCHMARK.json's dict, a benchmark directory of tiny files)."""
    torch.set_num_threads(2)
    d = tmp_path / "bench"
    d.mkdir()
    for sub in ("drivers", "metrics"):
        os.symlink(BENCH / sub, d / sub)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for sub in ("configs", "traffic", "limits"):
        (d / sub).mkdir()
    for c in bench["configs"]:
        (d / "configs" / f"{c['name']}.json").write_text(json.dumps(tiny_config(c["name"])))
    for w in bench["workloads"]:
        (d / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(tiny_mix(w["traffic"])))
        names = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        (d / "limits" / f"{w['name']}.json").write_text(
            json.dumps({name: TINY_LIMIT for name in names}))
    return bench, d
