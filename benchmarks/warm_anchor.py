"""Warm-scan anchor: the 12-omega flagship DOS slice used for knob A/Bs.

The flagship warm IAI leg is depth-bound (docs/DESIGN.md), so knob
rankings must come from device wall clock — but VALUE CORRECTNESS of a knob
(wider seed consumption, wider leaf bisection) is checkable cheaply on any
backend: every config must reproduce the shipped config's DOS values to the
certificate, with per-omega eval counts recorded for the eval-cost side of
the tradeoff.  12 omegas at 5 meV spacing straddling 12.5 eV, eta=1e-2,
abstol=1e-3, warm scan (sorted order), on the seeded synthetic flagship
model unless ``--hr``/``--wout`` name Wannier90 files.

Usage: python benchmarks/warm_anchor.py [--configs shipped seedw16 ...]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = {
    "shipped": {},
    "cold": {"warm": False},
    "leaf2": {"leaf_nbisect": 2},
    "leaf4": {"leaf_nbisect": 4},
    "seedw8": {"inner_seed_width": 8},
    "seedw16": {"inner_seed_width": 16},
    "leaf4+seedw8": {"leaf_nbisect": 4, "inner_seed_width": 8},
    "leaf4+seedw16": {"leaf_nbisect": 4, "inner_seed_width": 16},
    "presplit4": {"leaf_presplit": 4},
    "presplit8": {"leaf_presplit": 8},
    "presplit4+seedw8": {"leaf_presplit": 4, "inner_seed_width": 8},
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--configs", nargs="*", default=None)
    p.add_argument("--hr", default=None)
    p.add_argument("--wout", default=None)
    p.add_argument("--abstol", type=float, default=1e-3)
    p.add_argument("--chunk", type=int, default=12)
    args = p.parse_args(argv)

    from autobzcore_tpu import FourierIntegrand, IntegralProblem
    from autobzcore_tpu.brillouin import IAI
    from autobzcore_tpu.models import flagship_model
    from autobzcore_tpu.models.observables import dos_trace
    from autobzcore_tpu.parallel.sweep import SweepSolver

    h, bz, label = flagship_model(args.hr, args.wout)
    print(f"# {label} model", file=sys.stderr)
    eta = 1e-2
    integrand = FourierIntegrand(lambda hv, om, eta=None: dos_trace(hv, om, eta=eta),
                                 h, eta=eta)
    prob = IntegralProblem(integrand, bz)
    omegas = 12.5 + 0.005 * (np.arange(12) - 5.5)

    names = args.configs or list(CONFIGS)
    ref = None
    for name in names:
        kw = dict(CONFIGS[name])
        warm = kw.pop("warm", True)
        alg = IAI(inner_cap=128, warm_width=8, **kw)
        solver = SweepSolver(prob, alg, abstol=args.abstol,
                             chunk=args.chunk, scan=True, warm=warm)
        t0 = time.time()
        vals = np.asarray(solver(omegas), dtype=np.complex128).real
        wall = time.time() - t0
        rec = {"config": name, "wall_s": round(wall, 2),
               "evals_per_omega": float(solver.numevals) / len(omegas),
               "retcode": bool(solver.retcode),
               "dos": [round(float(v), 8) for v in vals]}
        if name == "shipped":
            ref = vals
        elif ref is not None:
            rec["max_delta_vs_shipped"] = float(np.max(np.abs(vals - ref)))
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
