"""Error-vs-cost scaling in the broadening eta: IAI vs (Auto)PTR.

The reference's headline efficiency claims (``src/brillouin.jl:366-367,403``,
quantified in the companion paper SciPost Phys. 15, 062 (2023)) are that
h-adaptive iterated integration (IAI) costs polylog(1/eta) on localized
integrands while the PTR's npt-to-tolerance grows polynomially in 1/eta.
This benchmark reproduces that scaling with THIS framework's native
algorithms on the 2D integer-lattice Green's-function trace
(``docs/src/examples.md:105``):

    g(omega) = int Tr (omega + i eta - H(k))^-1 dk,  H = cos k1 + cos k2

For each eta: the IAI eval count to ``abstol`` (from EvalCounter-style native
counts) and the smallest PTR npt whose value matches the IAI anchor to the
same tolerance (doubling search).

Usage: python benchmarks/eta_scaling.py [--etas 1e-1,1e-2,1e-3,1e-4]
       [--abstol 1e-3]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--etas", default="1e-1,1e-2,1e-3,1e-4")
    ap.add_argument("--abstol", type=float, default=1e-3)
    ap.add_argument("--omega", type=float, default=0.4)
    ap.add_argument("--max-npt", type=int, default=4096)
    args = ap.parse_args(argv)

    from autobzcore_tpu import (
        FBZ, IAI, PTR, FourierIntegrand, IntegralProblem, IntegralSolver, load_bz,
    )
    from autobzcore_tpu.models import tb_integer
    from autobzcore_tpu.models.observables import greens_function_trace
    from autobzcore_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()

    bz = load_bz(FBZ(), 2 * np.pi * np.eye(2))
    rows = []
    for eta_s in args.etas.split(","):
        eta = float(eta_s)
        fi = FourierIntegrand(greens_function_trace, tb_integer(2), eta=eta)
        # the integral stays O(1) as eta -> 0 (only the integrand's peak
        # grows ~1/eta), so the tolerance is fixed across eta
        abstol = args.abstol

        solver = IntegralSolver(IntegralProblem(fi, bz), IAI(), abstol=abstol)
        t0 = time.perf_counter()
        sol = solver.solve_p(jnp.float64(args.omega))
        t_iai = time.perf_counter() - t0
        anchor = complex(np.asarray(sol.u))

        # doubling search for the smallest npt that matches the anchor
        npt, n_ok = 16, None
        while npt <= args.max_npt:
            psol = IntegralSolver(
                IntegralProblem(fi, bz), PTR(npt=npt)
            ).solve_p(jnp.float64(args.omega))
            if abs(complex(np.asarray(psol.u)) - anchor) <= abstol:
                n_ok = npt
                break
            npt *= 2
        rows.append((eta, abstol, sol.numevals, t_iai, n_ok,
                     None if n_ok is None else n_ok**2))
        print(f"eta={eta:g}: abstol={abstol:g} IAI evals={sol.numevals} "
              f"({t_iai:.1f}s, retcode={sol.retcode})  PTR npt={n_ok} "
              f"evals={'>cap' if n_ok is None else n_ok ** 2}", file=sys.stderr)

    print("\n| eta | abstol | IAI evals | PTR evals (npt^2) | ratio |")
    print("|---|---|---|---|---|")
    for eta, tol, ne, t, n_ok, pe in rows:
        r = "-" if pe is None else f"{pe / ne:.1f}x"
        print(f"| {eta:g} | {tol:g} | {ne} | {pe if pe else '>16.7M'} | {r} |")


if __name__ == "__main__":
    main()
