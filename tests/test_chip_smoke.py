"""chip_smoke.py off the card: it must refuse to report without a GPU, and
its comparisons must catch what they are meant to catch.  The script
itself runs on the card (python chip_smoke.py)."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """On a CPU-only host (and in a directory holding nothing but the
    script) it exits non-zero and prints no JSON result."""
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        script, cwd = ROOT / "chip_smoke.py", ROOT
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("delta,n_diff,ok", [(2, 1, False), (1, 1, True),
                                             (1, 50, False)])
def test_plane_mismatch_tolerance(delta, n_diff, ok):
    """The fusion tolerance (<= 1e-5 of voxels, <= 1 unit each) flags a
    single 2-unit mismatch and too many 1-unit ones."""
    a = np.zeros((100, 100, 100), np.int16)
    b = a.copy()
    b.reshape(-1)[:n_diff] += delta
    n, worst, got = chip_smoke.plane_mismatch(
        (a, a), (b, a), max_fraction=chip_smoke.FUSION_MAX_FRACTION,
        max_units=chip_smoke.FUSION_MAX_UNITS)
    assert (n, worst, got) == (n_diff, delta, ok)


def test_rotation_deg_is_exact_near_zero():
    """The registration drift bound is 0.01 deg: the angle of R R^T for a
    float32 rotation must read ~0, not the ~0.01 deg that arccos of the
    trace alone returns."""
    t = np.radians(0.2)
    R = np.array([[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0],
                  [0, 0, 1]], np.float32)
    assert chip_smoke.rotation_deg(R) == pytest.approx(0.2, abs=1e-6)
    assert chip_smoke.rotation_deg(R.astype(np.float64) @ R.T) < 1e-5
