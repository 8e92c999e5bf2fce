"""Entry points: the compile check and the multi-device dry run."""
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_4():
    """Every sharded path on four virtual CPU devices, in a process of its
    own: a stuck collective rendezvous ends in a timeout, not in an aborted
    test interpreter."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run(
        [sys.executable, "-c", "import __graft_entry__ as g; g.dryrun_multichip(4)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]


def test_entry_step_matches_numpy():
    """entry() returns a jittable step whose DOS agrees with a NumPy dense
    evaluation of the same model in f64."""
    import jax

    sys.path.insert(0, REPO)
    import __graft_entry__ as g

    fn, args = g.entry()
    got = np.asarray(jax.jit(fn)(*args))
    s = g._flagship_series()
    C = np.asarray(s.c)
    u = np.arange(16) / 16
    ph = [np.exp(2j * np.pi * np.outer(u, s.offset[d] + np.arange(C.shape[d])))
          for d in range(3)]
    hk = np.einsum("ka,lb,mc,abcij->klmij", ph[0], ph[1], ph[2], C, optimize=True)
    e = np.linalg.eigvalsh(hk.reshape(-1, 3, 3))
    om = np.asarray(args[1])
    eta = float(args[2])
    ref = np.mean(np.sum(eta / ((om[:, None, None] - e[None]) ** 2 + eta**2) / np.pi,
                         axis=2), axis=1)
    assert got.dtype == np.float64
    assert np.allclose(got, ref, rtol=1e-10, atol=0)
