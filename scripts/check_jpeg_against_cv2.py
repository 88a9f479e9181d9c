"""Hold the port's JPEG decoder against ``cv2.imread`` beyond the fixtures.

Two checks, run on the CPU with OpenCV installed (the port never imports
it):

1. **Truncation.** Every committed JPEG fixture is cut at every ``--step``
   bytes from 40 bytes before its first SOS marker to its end (and just
   before its last 1, 2 and 3 bytes), written to a file and decoded by
   ``cv2.imread`` and by the port. libjpeg reads such a file with a fake EOI
   past its end, and block-smooths a progressive one whose coefficients
   1-9 are not all complete; the port does the same. Each cut is counted
   as equal (both give the same samples, or both no image) or differing.
2. **Coefficients past the valid range.** ``--random`` grey 64x64 files
   of random coefficients (up to 1000 in magnitude, quantisers up to 255)
   through the port's own entropy coder: the block where a truncated scan
   runs out of bits holds such values, and there the decoder follows
   libjpeg-turbo's SIMD IDCT lanes.

Prints the counts and exits 1 if a cut or a random file differs. Usage::

    python scripts/check_jpeg_against_cv2.py [--step 7] [--random 500]
"""

from __future__ import annotations

import argparse
import struct
import sys
import tempfile
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from depth_completion_tpu_torch.io import jpeg  # noqa: E402

DATA = ROOT / "tests" / "data" / "torch_io"


def decode_both(data: bytes, path: Path):
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    try:
        got = jpeg.decode_jpeg(data)
    except ValueError:
        got = None
    if want is None or got is None:
        return want is None and got is None
    return want.shape == got.shape and bool((want == got).all())


def truncation(step: int, path: Path) -> tuple[int, int, int]:
    same = none = other = 0
    for f in sorted(DATA.glob("jpeg_*.jpg")):
        data = f.read_bytes()
        first = data.index(b"\xff\xda")
        cuts = list(range(max(first - 40, 2), len(data) + 1, step)) + [len(data) - k for k in (1, 2, 3)]
        for cut in cuts:
            if decode_both(data[:cut], path):
                same += 1
                path.write_bytes(data[:cut])
                none += cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None
            else:
                other += 1
                print(f"  differs: {f.name} cut at {cut} of {len(data)}")
    return same, none, other


def grey_jpeg(coefs: np.ndarray, q: np.ndarray, h: int, w: int) -> bytes:
    """A baseline grey JPEG of the given natural-order blocks [B, 64] and
    natural-order quantisers [64], through the port's entropy coder."""
    tables = {k: jpeg._code_table(*v) for k, v in jpeg.HUFFMAN.items()}
    dqt = bytes([0]) + bytes(q[jpeg.ZIGZAG].astype(np.uint8))
    sof = struct.pack(">BHHB", 8, h, w, 1) + bytes([1, 0x11, 0])
    dht = b"".join(bytes([t]) + bytes(jpeg.HUFFMAN[k][0]) + jpeg.HUFFMAN[k][1]
                   for t, k in ((0x00, "dc_luma"), (0x10, "ac_luma")))
    scan = jpeg._scan(coefs[:, jpeg.ZIGZAG], np.zeros(len(coefs), np.int64), tables)
    return (b"\xff\xd8" + jpeg._marker(0xDB, dqt) + jpeg._marker(0xC0, sof)
            + jpeg._marker(0xC4, dht) + jpeg._marker(0xDA, bytes([1, 1, 0, 0, 63, 0]))
            + scan + b"\xff\xd9")


def random_blocks(n: int, path: Path) -> int:
    rng = np.random.default_rng(0)
    bad = 0
    for trial in range(n):
        mag = [3, 30, 200, 1000][trial % 4]
        c = rng.integers(-mag, mag + 1, (64, 64))
        c *= rng.random((64, 64)) < [0.1, 0.5, 1.0][trial % 3]
        if trial % 5 == 4:  # rows 1-7 zero: the SIMD code's DC shortcut
            c.reshape(64, 8, 8)[:, 1:] = 0
        c[:, 0] = np.clip(np.cumsum(rng.integers(-2047, 2048, 64)), -2047, 2047)
        q = rng.integers(1, [2, 16, 100, 256][trial // 4 % 4], 64)
        bad += not decode_both(grey_jpeg(c, q, 64, 64), path)
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--step", type=int, default=7, help="bytes between cut points")
    ap.add_argument("--random", type=int, default=500, help="random-coefficient files")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "probe.jpg"
        same, none, other = truncation(args.step, path)
        bad = random_blocks(args.random, path)
    print(f"truncated fixtures: {same + other} cuts, {same} equal to cv2.imread "
          f"({none} of them no image on both sides), {other} differ")
    print(f"random coefficients: {args.random} files, {bad} differ")
    return int(bool(other or bad))


if __name__ == "__main__":
    sys.exit(main())
