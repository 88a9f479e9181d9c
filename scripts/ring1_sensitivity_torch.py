"""How far planted faults of the ring's backward move ``chip_smoke.py``
phase 8's check (c), the dense maps of kitti-native-ring1 against
kitti-native (one 352x1216 frame, batch 1, through
``bench_nativeres_torch.run_mode``): the sound ring, its log-sum-exp saved
in nats for the backward (the faults script's F56) and dk and dv swapped,
each on the drivers' bundle and on phase 5's peaked one (self-attention q
and k scaled until the softmax is peaked), at 2 and 4 guided steps. Prints
the card and one line per case: (rms, max) of the difference over the
120 m range, as (c) reads it. Needs one card. A one-off experiment: it
derived ``chip_smoke.RING1_LIMITS`` (PERF.md §6 holds its readings), and
nothing in the repo runs it; it swaps ``RingAttention`` in the module for
each planted fault.

    python3 scripts/ring1_sensitivity_torch.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402  (exits without a card)
from depth_completion_tpu_torch import _build  # noqa: E402
from depth_completion_tpu_torch.ops import ring_attention as ra  # noqa: E402
from depth_completion_tpu_torch.pipeline.pipeline import DepthCompletionPipeline  # noqa: E402
from scripts import bench_nativeres_torch as nativeres  # noqa: E402
from scripts import drivers_torch  # noqa: E402

SOUND = ra.RingAttention


class LseInNats(SOUND):
    """The forward saves lse2·ln 2 for the backward, which takes log2."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, ring):
        qs, ks, vs = ring.shard(q), ring.shard(k), ring.shard(v)
        step_fwd, _ = ra.ring_steps(q.shape[-1] // num_heads)
        o, lse2 = ra.ring_forward(qs, ks, vs, num_heads, ring, step_fwd)
        ctx.save_for_backward(qs, ks, vs, o, lse2 * 0.6931471805599453)
        ctx.num_heads, ctx.ring = num_heads, ring
        return ring.gather(o)


class SwapDkDv(SOUND):
    """The backward returns dv as dk and dk as dv."""

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv, _, _ = SOUND.backward(ctx, do)
        return dq, dv, dk, None, None


def main() -> None:
    print(smoke.card())
    _build.build_all()
    bundle = drivers_torch.bench_bundle(smoke.DEV)
    bundles = {"drivers": bundle, "peaked": smoke.peaked_bundle(bundle)}
    images, sparse = drivers_torch.synthetic_frames(1, *nativeres.FRAME, nativeres.POINTS)
    rows = []
    for steps in (2, 4):
        modes = nativeres.make_modes(steps)
        for name, b in bundles.items():
            _, native = nativeres.run_mode(DepthCompletionPipeline(b), modes["kitti-native"],
                                           images, sparse, 1)
            for fault, cls in (("sound", SOUND), ("lse_in_nats", LseInNats),
                               ("swap_dk_dv", SwapDkDv)):
                ra.RingAttention = cls
                try:
                    _, ring1 = nativeres.run_mode(DepthCompletionPipeline(b),
                                                  modes["kitti-native-ring1"], images, sparse, 1)
                finally:
                    ra.RingAttention = SOUND
                rms, worst = smoke._range_errors([ring1], [native])
                rows.append({"steps": steps, "bundle": name, "ring": fault, "rms": rms,
                             "max": worst})
                print(json.dumps(rows[-1]), flush=True)
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
