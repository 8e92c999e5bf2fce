"""Smoke tests: the shipped example scripts stay runnable (tiny configs),
and ``chip_smoke.py`` refuses to report without a GPU."""
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def _run(args, timeout=240):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "topology_example.py"),
         *args],
        capture_output=True, text=True, timeout=timeout, env=ENV, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_topology_example_weyl(tmp_path):
    os.chdir(tmp_path)
    stdout = _run(["weyl", "--npt", "12", "--nkz", "5"])
    assert "slice Chern" in stdout
    assert "-1.0" in stdout and "+0.0" in stdout


def test_topology_example_phase(tmp_path):
    os.chdir(tmp_path)
    stdout = _run(["phase", "--n", "5", "--npt", "10"])
    assert "phase diagram 5x5" in stdout
    # both topological lobes and the trivial region appear
    assert "+" in stdout and "-" in stdout and "." in stdout


def test_aps_example_synthetic_ptr_and_ltm(tmp_path):
    """The flagship example on the seeded synthetic model, PTR and LTM legs
    at npt=16: every curve finite, and the LTM DOS integrates to the 3
    bands over the window (aps normalization carries det B)."""
    out = tmp_path / "aps.npz"
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "aps_example.py"),
         "--npt", "16", "--with-ltm", "--out", str(out)],
        capture_output=True, text=True, timeout=600, env=ENV, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "synthetic" in r.stderr
    d = np.load(out)
    assert d["dos_ptr"].shape == d["dos_ltm"].shape == d["omega"].shape
    assert np.all(np.isfinite(d["dos_ptr"])) and np.all(np.isfinite(d["dos_ltm"]))
    detB = (2 * np.pi / 3.84) ** 3
    nstates = np.trapezoid(d["dos_ltm"], d["omega"]) / detB
    assert abs(nstates - 3.0) < 0.05


def test_chip_smoke_fails_without_gpu(tmp_path):
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, env=ENV,
                       cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr
