#!/usr/bin/env bash
# Checkpoint-day drill of the PyTorch port: the counterpart of
# scripts/checkpoint_drill.sh. It proves the generate -> load -> convert ->
# sample -> CLI path at the real model geometry with nothing downloaded, so
# that on the day the real weights arrive only their values are untested.
#
#   1. writes a full-size synthetic HF-layout checkpoint (the 866M-parameter
#      Marigold UNet, the KL VAE, the SD2 text tower, TAESD, the scheduler)
#      with scripts/make_synthetic_checkpoint_torch.py
#   2. runs scripts/verify_checkpoint_torch.py on it (load, parameter
#      counts, one 2-step guided request; the launches it counted)
#   3. runs the port's predict CLI on one 480x640 frame against it
#      (--vae light, DRILL_STEPS steps, default 4, --compress npy) and
#      checks for a finite (480, 640, 1) dense map
#
# Each step prints its wall seconds on a line "drill step N: S s".
#
# Usage: scripts/checkpoint_drill_torch.sh [WORKDIR]
#   WORKDIR defaults to a new directory under TMPDIR. DRILL_DEVICE=cpu runs
#   on the CPU (slow at this geometry); the default is the GPU, and without
#   one the drill stops at step 2 with the port's device error.
set -euo pipefail
cd "$(dirname "$0")/.."

WORK="${1:-$(mktemp -d "${TMPDIR:-/tmp}/dct_checkpoint_drill_torch.XXXXXX")}"
export DRILL_WORK="$WORK"
DEVICE="${DRILL_DEVICE:-cuda}"
PY=(python3)

step() {  # step N COMMAND...: run it and print its wall seconds
    local n=$1 t0 t1
    shift
    t0=$(date +%s%N)
    "$@"
    t1=$(date +%s%N)
    local ms=$(( (t1 - t0) / 1000000 ))
    printf 'drill step %s: %d.%03d s\n' "$n" $((ms / 1000)) $((ms % 1000))
}

echo "=== [1/3] generating the full-size synthetic checkpoint under $WORK"
step 1 "${PY[@]}" scripts/make_synthetic_checkpoint_torch.py "$WORK/marigold-synth" \
    --taesd-out "$WORK/taesd"

echo "=== [2/3] verify_checkpoint_torch (load, parameter counts, one guided request)"
step 2 "${PY[@]}" scripts/verify_checkpoint_torch.py "$WORK/marigold-synth" \
    --taesd "$WORK/taesd" --device "$DEVICE"

echo "=== [3/3] the predict CLI end to end against the local checkpoint"
"${PY[@]}" - <<'EOF'
import os
from pathlib import Path

import numpy as np

from depth_completion_tpu_torch.io.image import save_img_array

rng = np.random.default_rng(0)
ds = Path(os.environ["DRILL_WORK"]) / "data" / "scene"
save_img_array(rng.integers(1, 255, size=(480, 640, 3)).astype(np.uint8),
               ds / "image" / "00000.png")
sparse = np.zeros((480, 640, 3), np.uint8)
mask = rng.random((480, 640)) < 0.002
sparse[mask, 0] = rng.integers(10, 250, mask.sum()).astype(np.uint8)
save_img_array(sparse, ds / "sparse" / "00000.png")
EOF
step 3 "${PY[@]}" -m depth_completion_tpu_torch.cli.predict "$WORK/data" "$WORK/out" \
    --model original --checkpoint-dir "$WORK/marigold-synth" --taesd-dir "$WORK/taesd" \
    --vae light --steps "${DRILL_STEPS:-4}" --res "${DRILL_RES:-768}" --vis false \
    --compress npy --device "$DEVICE"

"${PY[@]}" - <<'EOF'
import glob
import os

import numpy as np

fs = sorted(glob.glob(os.environ["DRILL_WORK"] + "/out/scene/dense/*.npy"))
if not fs:
    raise SystemExit("DRILL FAILED: no dense outputs written")
for f in fs:
    a = np.load(f)
    if a.shape != (480, 640, 1) or not np.isfinite(a).all():
        raise SystemExit(f"DRILL FAILED: {f}: {a.shape}, finite={np.isfinite(a).all()}")
print(f"DRILL OK: {len(fs)} dense frame(s), finite, full SD2 geometry")
EOF
