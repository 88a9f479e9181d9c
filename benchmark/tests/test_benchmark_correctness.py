"""The correctness check on the CPU at test sizes: the plain reference starts
out equal to the system's plain path it stands for; the control (the
reference in float8) comes out not correct; and a run whose timed path is
broken underneath comes out not correct, once for each fault a cell can
have."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from conftest import tiny_config, tiny_mix

from benchmark import control, run
from benchmark.drivers.common import make_bundle, sampler_kwargs
from benchmark.harness import check
from benchmark.harness.frames import offline_batch

CPU = torch.device("cpu")


@pytest.mark.parametrize("config", ["marigold-taesd", "marigold-kl"])
def test_reference_equals_the_port_plain_path(config):
    """Three guided steps over two frames, then two more frames carrying
    their latents: the port on the CPU (float32, its plain twins) against
    the reference."""
    from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline

    torch.set_num_threads(2)
    cfg, mix = tiny_config(config), tiny_mix("offline-b8")
    pipe = DepthCompletionPipeline(make_bundle(cfg, 77, CPU))
    kwargs = sampler_kwargs(mix["request"])
    images, sparses = offline_batch(mix, 77, 0)
    dense, latent = pipe(images[:2], sparses[:2], **kwargs)
    dense_c, latent_c = pipe(images[2:4], sparses[2:4], pred_latents_prev=latent,
                             beta=mix["request"]["beta"], **kwargs)
    checked = [{"images": images[:2], "sparses": sparses[:2], "carry": None,
                "dense": dense.numpy(), "latent": latent.numpy()},
               {"images": images[2:4], "sparses": sparses[2:4], "carry": 0,
                "dense": dense_c.numpy(), "latent": latent_c.numpy()}]
    refs = check.reference_outputs(cfg, mix["request"], 77, checked, CPU)
    decoded = check.decoded_maps(cfg, mix["request"], 77, checked, CPU)
    numbers = check.compare(checked, refs, mix["request"], decoded)
    assert numbers["dense_rel"] < 1e-4 and numbers["latent_rel"] < 1e-4, numbers
    assert numbers["decode_rel"] < 1e-4, numbers


@pytest.mark.parametrize("workload", ["taesd.offline.b8", "kl.offline.b1",
                                      "taesd.serve.8streams"])
def test_control_is_not_correct(tiny_bench, workload):
    """The control (the reference in float8 in the system's place) against
    the cell's compared numbers at the test size's limits, over 25 steps
    (fewer leave the KL fit too close to the float32 one to tell)."""
    bench, d = tiny_bench
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = json.loads((d / "configs" / f"{cell['config']}.json").read_text())
    limits = json.loads((d / "limits" / f"{workload}.json").read_text())
    mix = tiny_mix(cell["traffic"], steps=25)
    for seed in (3, 2**31 + 5):
        ok, shown = check.verdict(control.control_numbers(cfg, mix, seed, CPU), limits, True)
        assert not ok, shown


def _no_step(self):
    """A guided step that returns its state unchanged."""


def _half_batch(call):
    def broken(self, images, sparses, *args, **kwargs):
        n = len(images)
        if n < 2:
            return call(self, images, sparses, *args, **kwargs)
        dense, latent = call(self, images[: n // 2], sparses[: n // 2], *args, **kwargs)
        fill = lambda t: torch.cat([t, t.mean(0, keepdim=True).expand(n - n // 2, *t.shape[1:])])
        return fill(dense), fill(latent)
    return broken


def _altered(finish):
    def broken(self):
        finish(self)
        self.dense.mul_(1.5)
    return broken


FAULTS = {
    "step_unchanged": ("depth_completion_tpu_torch.pipeline.sampler.FusedStepProgram", "step",
                       lambda orig: _no_step),
    "half_batch": ("depth_completion_tpu_torch.pipeline.pipeline.DepthCompletionPipeline",
                   "__call__", _half_batch),
    "answer_altered": ("depth_completion_tpu_torch.pipeline.sampler.SamplerProgram", "finish",
                       _altered),
}
CASES = [("taesd.offline.b8", f) for f in FAULTS] + [("kl.offline.b1", "step_unchanged"),
                                                       ("kl.offline.b1", "answer_altered"),
                                                       ("taesd.serve.8streams", "step_unchanged"),
                                                       ("taesd.serve.8streams", "answer_altered")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_broken_timed_path_is_not_correct(tiny_bench, monkeypatch, workload, fault):
    import importlib

    bench, d = tiny_bench
    where, attr, make = FAULTS[fault]
    module, cls = where.rsplit(".", 1)
    target = getattr(importlib.import_module(module), cls)
    monkeypatch.setattr(target, attr, make(getattr(target, attr)))
    res = run.run_cell(bench, workload, 2**31 + 99, 1.0, False, device="cpu", bench_dir=d)
    assert res["correct"] is False, res["checks"]


def test_sound_runs_are_correct(tiny_bench):
    bench, d = tiny_bench
    for w in ("kl.offline.b1", "taesd.serve.8streams"):
        res = run.run_cell(bench, w, 2**31 + 99, 1.0, False, device="cpu", bench_dir=d)
        assert res["correct"] is True, res["checks"]
        assert all(np.isfinite(v["value"]) for v in res["metrics"].values())
