"""Drive the broadened-DOS main path once on a GPU and check every result.

    python chip_smoke.py          # one GPU: phases 0-5
    python chip_smoke.py --multi  # four GPUs: the sharded dry run, nothing else

The workload is the reference's ``aps_example`` (a 3-band cubic Wannier
Hamiltonian, Lorentzian DOS with eta = 1e-2 over omega in [10, 15] eV,
CubicSymIBZ, PTR(npt=100) and IAI at abstol 1e-3 under an ``hchebinterp``
interpolant at atol 1e-2), run through the library's entry points on a
seeded cubic t2g stand-in (``models.cubic_t2g``, "synthetic") with the
footprint of the SrVO3 model, in complex128/f64.

Phases, each printing one line with its cold and warm wall time and every
check as value beside limit:

0. device: fails unless JAX's first device is a GPU;
1. model: the synthetic Hamiltonian on a cubic lattice, a = 3.84 A;
2. PTR leg: solver vs a dense NumPy f64 reference over the full 100^3
   grid, and the interpolant vs the solver;
3. IAI leg: 33 omegas in [11, 14] vs phase 4's certified curve;
4. full-grid ladder: 1000 omegas to abstol 1e-3, and one npt=64 rung vs
   NumPy on the same grid;
5. LTM: the integrated DOS over the band window equals the band count.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``, printed only when
every phase passed.  Without a GPU, or on any failed check, the script
exits non-zero and prints no such line.
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
ETA = 1e-2
LO, HI = 10.0, 15.0
NPT = 100  # PTR and LTM grids
RUNG_NPT = 64  # the ladder rung checked against NumPy
LADDER = {"schedule": "auto"}  # LorentzianFullGrid options


def _fmt(x):
    return f"{x:.6g}" if isinstance(x, float) else str(x)


class Checks:
    """Collects value-beside-limit comparisons; every phase runs, and the
    script fails at the end if any comparison did."""

    def __init__(self):
        self.failed = []

    def le(self, name, value, limit):
        value = float(value)
        ok = bool(value <= limit)  # NaN fails
        if not ok:
            self.failed.append(name)
        return f"{name}={value:.3e} (limit {limit:.3e}{'' if ok else ', FAILED'})"

    def true(self, name, value):
        if not value:
            self.failed.append(name)
        return f"{name}={bool(value)}{'' if value else ' (FAILED)'}"


def report(phase, what, cold=None, warm=None, checks=(), **info):
    parts = [f"phase {phase} {what}:"]
    if cold is not None:
        parts.append(f"cold={cold:.3f}s")
    if warm is not None:
        parts.append(f"warm={warm:.3f}s")
    parts += [f"{k}={_fmt(v)}" for k, v in info.items()]
    parts += list(checks)
    print(" ".join(parts), flush=True)


def timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def device_phase(ndev):
    """Phase 0: fail unless the devices are GPUs; print what runs."""
    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found platform {dev.platform!r}")
    if len(devs) < ndev:
        raise SystemExit(f"chip_smoke: needs {ndev} GPUs, JAX found {len(devs)}")
    from autobzcore_tpu.utils.profiling import enable_compile_cache

    cache = enable_compile_cache()
    report(0, "device", kind=dev.device_kind, count=len(devs), jax=jax.__version__,
           cache=cache)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    return dev


# -- NumPy f64 references ----------------------------------------------------

def dense_bands(h, npt):
    """Eigenvalues (npt^3, m) of H(k) over the full fractional PTR grid."""
    C = np.asarray(h.c)
    u = np.arange(npt) / npt
    ph = [np.exp(2j * np.pi * np.outer(u, h.offset[d] + np.arange(C.shape[d])))
          for d in range(3)]
    hk = np.einsum("ka,lb,mc,abcij->klmij", ph[0], ph[1], ph[2], C, optimize=True)
    m = C.shape[-1]
    return np.linalg.eigvalsh(hk.reshape(-1, m, m))


def lorentz_sum(e, omegas, eta, block=32):
    """``sum_k sum_b eta / ((omega - e)^2 + eta^2) / pi`` for each omega."""
    e = e.reshape(-1)
    out = np.empty(len(omegas))
    for i in range(0, len(omegas), block):
        t = omegas[i:i + block, None] - e[None]
        out[i:i + block] = np.sum(eta / (t * t + eta * eta), axis=1) / np.pi
    return out


# -- phases --------------------------------------------------------------------

def run_single():
    checks = Checks()
    dev = device_phase(1)

    from autobzcore_tpu import FourierIntegrand, IntegralProblem, TrivialRep
    from autobzcore_tpu.brillouin import IAI, PTR
    from autobzcore_tpu.dos import DOSProblem, LTM, LorentzianFullGrid
    from autobzcore_tpu.dos import init as dos_init
    from autobzcore_tpu.models import flagship_model
    from autobzcore_tpu.models.observables import dos_trace
    from autobzcore_tpu.ops.grid_sweep import FullGridSpectralSweep
    from autobzcore_tpu.parallel.sweep import SweepSolver
    from autobzcore_tpu.utils.chebinterp import hchebinterp

    # phase 1: model
    (h, bz, label), t1 = timed(flagship_model, seed=SEED)
    detB = abs(float(np.linalg.det(bz.B)))
    report(1, f"model {label} cubic t2g", cold=t1, seed=SEED,
           coeffs="x".join(map(str, np.shape(h.c))), dtype=np.dtype(h.dtype).name,
           lattice=float(bz.A[0, 0]), nsyms=bz.nsyms, detB=detB)

    integrand = FourierIntegrand(dos_trace, h, eta=ETA, rep=TrivialRep())
    prob = IntegralProblem(integrand, bz)

    # phase 2: PTR leg (the aps leg) and its dense reference
    ptr = SweepSolver(prob, PTR(npt=NPT), abstol=1e-3, chunk=264)
    interp, t_cold = timed(hchebinterp, ptr, LO, HI, atol=1e-2)
    _, t_warm = timed(hchebinterp, ptr, LO, HI, atol=1e-2)
    om16 = np.linspace(10.5, 14.5, 16)
    got = np.asarray(ptr(om16))
    ref = lorentz_sum(dense_bands(h, NPT), om16, ETA) * detB / NPT**3
    report(2, f"PTR(npt={NPT}) interpolant", cold=t_cold, warm=t_warm,
           solver_evals=interp.numevals, panels=len(interp.panels),
           checks=[checks.le("rel_err_vs_numpy", np.max(np.abs(got - ref) / np.abs(ref)), 1e-9),
                   checks.le("interp_vs_solver", np.max(np.abs(interp(om16) - got)), 1e-2)])

    # phase 4: full-grid ladder (before phase 3, whose check reads its curve)
    wfg = np.linspace(LO, HI, 1000)
    fg = LorentzianFullGrid(ETA, **LADDER)
    cache = dos_init(DOSProblem(h, wfg, bz), fg, abstol=1e-3)
    (D, ok), t_cold = timed(fg.dos_sweep, cache.cacheval, wfg, abstol=1e-3,
                            with_status=True)
    _, t_warm = timed(fg.dos_sweep, cache.cacheval, wfg, abstol=1e-3)
    n1, n2, _ = cache.cacheval["ladder_hint"]
    eng = FullGridSpectralSweep(h, wfg, ETA)
    d64, t64 = timed(eng.rung, RUNG_NPT)
    ref64 = lorentz_sum(dense_bands(h, RUNG_NPT), wfg, ETA)
    report(4, "LorentzianFullGrid ladder, 1000 omegas", cold=t_cold, warm=t_warm,
           certifying_rungs=f"{n1},{n2}", rung_npt=RUNG_NPT, rung_wall=t64,
           checks=[checks.true("converged", ok),
                   checks.le("rung_err_vs_numpy", np.max(np.abs(d64 - ref64)),
                             1e-6 * np.max(ref64))])

    # phase 3: IAI leg vs phase 4's certified curve at the same omegas
    om33 = np.linspace(11.0, 14.0, 33)
    iai = SweepSolver(prob, IAI(inner_cap=64, inner_nbisect=4), abstol=1e-3,
                      chunk=33, scan=True, warm=True)
    u_cold, t_cold = timed(lambda: np.asarray(iai(om33)))
    ne_cold = iai.numevals
    u_warm, t_warm = timed(lambda: np.asarray(iai(om33)))
    ne_warm = iai.numevals - ne_cold
    curve = np.asarray(fg.dos_sweep(cache.cacheval, om33, abstol=1e-3)) * detB
    lim = 1e-3 + 1e-3 * detB
    report(3, "IAI warm scan, 33 omegas", cold=t_cold, warm=t_warm,
           evals_per_omega_cold=ne_cold / 33, evals_per_omega_warm=ne_warm / 33,
           wall_per_omega_cold=t_cold / 33, wall_per_omega_warm=t_warm / 33,
           checks=[checks.true("retcode", iai.retcode),
                   checks.le("cold_vs_fullgrid", np.max(np.abs(u_cold - curve)), lim),
                   checks.le("warm_vs_fullgrid", np.max(np.abs(u_warm - curve)), lim)])

    # phase 5: LTM sharp DOS and its integral over the band window
    ws = np.linspace(LO, HI, 501)

    def ltm_run():
        c = dos_init(DOSProblem(h, 12.5, bz), LTM(npt=NPT))
        np.asarray(c.cacheval["dos_sweep"](ws))
        return c

    ltm_cache, t_cold = timed(ltm_run)
    _, t_warm = timed(lambda: np.asarray(ltm_cache.cacheval["dos_sweep"](ws)))
    nos = ltm_cache.cacheval["nos_at"]
    nstates = float(nos(HI)) - float(nos(LO))
    report(5, f"LTM(npt={NPT})", cold=t_cold, warm=t_warm,
           checks=[checks.le("integrated_dos_minus_3", abs(nstates - 3.0), 1e-6)])
    return dev, checks


def run_multi():
    checks = Checks()
    dev = device_phase(4)
    import __graft_entry__

    _, wall = timed(__graft_entry__.dryrun_multichip, 4)
    report("multi", "dryrun_multichip(4): 8 sharded paths vs single-device", cold=wall)
    return dev, checks


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the four-GPU sharded dry run")
    args = p.parse_args(argv)
    dev, checks = run_multi() if args.multi else run_single()
    if checks.failed:
        print(f"chip_smoke: failed checks: {', '.join(checks.failed)}", file=sys.stderr)
        return 1
    import jax

    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
