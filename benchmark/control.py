"""The correctness check's control, on the card at a cell's own size.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13

For each seed it makes frames such as a run of the cell checks (by the
drivers' rules: one row from each half of the cell's first request, or the
first frames of a stream with the second carrying the first), runs the
plain reference on them twice, once in float32 and once in ``FP8Numerics`` (the precision below the configuration's bf16,
put in the system's place), and prints the compared numbers of the second
against the first, and ``check.verdict``'s answer on them under the cell's
limits: the control has to come out not correct (``"correct": false``). The benchmark's own runs do not run this; its numbers are the
upper readings that the limits in ``limits/<workload>.json`` were set
below.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))


def checked_frames(mix: dict, seed: int) -> list[dict]:
    """Checked frames of the cell's kinds, without the system's outputs."""
    from benchmark.harness.frames import Stream, offline_batch

    if mix["kind"] == "offline":
        images, sparses = offline_batch(mix, seed, 0)
        rng = np.random.default_rng([seed % 2**63, 7])
        n = mix["batch"]
        rows = [0] if n == 1 else sorted({int(rng.integers(n // 2)),
                                          int(n // 2 + rng.integers(n - n // 2))})
        return [{"images": images[rows], "sparses": sparses[rows], "carry": None}]
    rng = np.random.default_rng([seed % 2**63, 11])
    stream = Stream(mix, seed, int(rng.integers(mix["streams"])))
    out = []
    for f in range(mix["check_frames"]):
        image, sparse = stream.frame(f)
        out.append({"images": image[None].astype(np.float32), "sparses": sparse[None],
                    "carry": f - 1 if f else None})
    return out


def _against(items, outputs, ref, config, mix, seed, device) -> dict[str, float]:
    from benchmark.harness import check

    items = [dict(item, dense=dense, latent=latent) for item, (dense, latent) in zip(items, outputs)]
    decoded = check.decoded_maps(config, mix["request"], seed, items, device)
    return check.compare(items, ref, mix["request"], decoded)


def _no_step(self, nx, k, img_latents, z, *args):
    return z


def control_numbers(config: dict, mix: dict, seed: int, device,
                    faults: bool = False) -> dict[str, float] | dict[str, dict]:
    """The compared numbers of the fp8 reference against the fp32 one; with
    ``faults``, {"control": those, and per planted fault its numbers}: the
    fault put in the reference in the system's place (``answer_altered``:
    the dense map x1.5 where it is made; ``step_unchanged``: every guided
    step returns the latent it was given; ``half_batch``: a second-half row
    answered with the first half's)."""
    from benchmark.harness import check
    from benchmark.reference.nn import FP8Numerics
    from benchmark.reference.sampler import Reference

    items = checked_frames(mix, seed)
    ref = check.reference_outputs(config, mix["request"], seed, items, device)
    ctl = check.reference_outputs(config, mix["request"], seed, items, device, FP8Numerics())

    def against(outputs):
        return _against(items, outputs, ref, config, mix, seed, device)

    numbers = against(ctl)
    if not faults:
        return numbers
    out = {"control": numbers, "answer_altered": against([(1.5 * d, lat) for d, lat in ref])}
    step = Reference.step
    Reference.step = _no_step
    try:
        still = check.reference_outputs(config, mix["request"], seed, items, device)
    finally:
        Reference.step = step
    out["step_unchanged"] = against(still)
    if mix["kind"] == "offline" and len(items[0]["images"]) == 2:
        (d, lat), = ref
        out["half_batch"] = against([(d[[0, 0]], lat[[0, 0]])])
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--faults", action="store_true",
                    help="also read each planted fault, put in the reference")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("control.py needs a CUDA device\n")
        return 2
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    config = json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text())
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{args.workload}.json").read_text())
    from benchmark.harness import check

    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        numbers = control_numbers(config, mix, seed, torch.device("cuda"), args.faults)
        by_case = numbers if args.faults else {"control": numbers}
        correct = {case: check.verdict(n, limits, True)[0] for case, n in by_case.items()}
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": numbers,
                          "limits": limits, "correct": correct,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
