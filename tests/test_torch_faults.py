"""``scripts/chip_smoke_faults.sh --check-anchors``: every planted fault's
sed edit still changes the sources it patches. A stale anchor plants
nothing, and that fault's run would then test the sound tree (CPU only: no
kernel is built and ``chip_smoke.py`` is not run)."""

import os
import shutil
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join("scripts", "chip_smoke_faults.sh")
N_FAULTS = 67


def _check_anchors(root, *faults):
    return subprocess.run(["bash", os.path.join(root, SCRIPT), "--check-anchors", *faults],
                          capture_output=True, text=True, timeout=120)


def test_every_fault_edit_applies():
    r = _check_anchors(REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    applied = [line.split(":")[0] for line in r.stdout.splitlines()
               if line.endswith(": edits apply")]
    assert [name.split("_")[0] for name in applied] == [f"F{i}" for i in range(1, N_FAULTS + 1)]


def test_stale_anchor_exits_1(tmp_path):
    """A copy whose d=512 forward no longer has F21's anchor line: F21
    reports it and the script exits 1; F1 (other lines) still applies."""
    shutil.copytree(os.path.join(REPO, "depth_completion_tpu_torch"),
                    tmp_path / "depth_completion_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    (tmp_path / "scripts").mkdir()
    shutil.copy(os.path.join(REPO, SCRIPT), tmp_path / "scripts")
    cu = tmp_path / "depth_completion_tpu_torch" / "csrc" / "flash_attention.cu"
    text = cu.read_text()
    anchor = "rescale(o_acc, alpha0, alpha1);"
    assert text.count(anchor) == 1
    cu.write_text(text.replace(anchor, "rescale(o_acc, a0, a1);"))
    r = _check_anchors(str(tmp_path), "F1_rowsum", "F21_d512_alpha")
    assert r.returncode == 1, r.stdout + r.stderr
    assert "F1_rowsum: edits apply" in r.stdout
    assert "F21_d512_alpha: the edit did not apply to depth_completion_tpu_torch/csrc/" \
           "flash_attention.cu" in r.stdout
