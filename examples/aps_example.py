"""3-band cubic Wannier DOS — the reference's aps_example workload.

Reproduces ``aps_example/aps_example.jl``: take a 3-band Wannier
Hamiltonian, build the Lorentzian-broadened DOS integrand
``-Im Tr (w + i eta - H(k))^{-1} / pi``, integrate over the CubicSymIBZ with
PTR and IAI solvers, and adaptively interpolate the DOS over w in [10, 15] eV
with hchebinterp (atol 1e-2).  Every leg runs in complex128/f64.

Without ``--hr`` the Hamiltonian is the seeded cubic t2g stand-in
(``models.cubic_t2g``, "synthetic") with the footprint of the SrVO3 model;
with ``--hr svo_hr.dat --wout svo.wout`` it is read from Wannier90 files.

Differences from the reference flow:
- the PTR path evaluates the symmetry-reduced H(k) grid once and sweeps all
  omega in one vmapped kernel (the reference re-inverts per (k, omega));
- hchebinterp evaluates whole refinement frontiers as single batched sweeps.

Usage: python examples/aps_example.py [--hr svo_hr.dat --wout svo.wout]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run_iai(args, bz, integrand, out):
    from autobzcore_tpu import AuxQuadGKJL, IntegralProblem
    from autobzcore_tpu.brillouin import IAI
    from autobzcore_tpu.parallel.sweep import SweepSolver
    from autobzcore_tpu.utils.chebinterp import hchebinterp

    eta = args.eta
    # monolithic on-device nest, sequenced multi-omega dispatches: each
    # chunk of omegas runs as ONE device program (lax.map — every omega
    # keeps its own adaptive early exit; a vmapped lockstep wastes the
    # trips of the slowest omega on all others), and chunks dispatch
    # asynchronously so the host round trip per chunk amortizes away
    algs = (AuxQuadGKJL(order=args.iai_order or 7,
                        nbisect=args.iai_nbisect or 1)
            if (args.iai_order or args.iai_nbisect) else None)
    alg = IAI(algs=algs, inner_cap=args.iai_inner_cap,
              inner_nbisect=args.iai_inner_nbisect,
              warm_width=args.iai_warm_width,
              leaf_nbisect=args.iai_leaf_nbisect,
              leaf_presplit=args.iai_leaf_presplit,
              nest_presplit=args.iai_nest_presplit,
              inner_seed_width=args.iai_inner_seed_width)
    t0 = time.time()
    # warm=True: the scan carries each omega's surviving outer partition
    # into the next solve (sorted order), so adjacent omegas inherit the
    # adaptive structure instead of re-discovering it; --cold-iai disables
    # it for A/B eval-count comparisons.  chunk trades dispatch amortization
    # against mid-seed freshness (the carried inner partition refreshes once
    # per chunk).  block=W solves W ADJACENT omegas per nest (the integrand
    # broadcasts over the omega vector, so H(k) structure is shared and
    # refinement follows the block's worst channel): the sweep's sequential
    # solve count drops W-fold
    frontier_fn = SweepSolver(IntegralProblem(integrand, bz), alg,
                              abstol=args.abstol, chunk=args.iai_chunk,
                              scan=True, warm=not args.cold_iai,
                              block=args.iai_block)

    dos_iai = hchebinterp(frontier_fn, 10.0, 15.0, atol=args.atol_interp)
    ws = np.arange(10, 15 + eta / 100, eta / 100)
    out["dos_iai"] = dos_iai(ws)
    out["t_iai"] = time.time() - t0
    ne = frontier_fn.numevals
    print(f"IAI interpolant: {out['t_iai']:.2f}s, {ne:.3g} integrand evals over "
          f"{dos_iai.numevals} omegas ({ne / max(dos_iai.numevals, 1):.3g}/omega)",
          file=sys.stderr)
    ce = frontier_fn.chunk_evals
    if ce:
        # per-chunk eval telemetry (mid-seed staleness diagnostic)
        print("IAI chunk evals: " + " ".join(f"{v:.3g}" for v in ce),
              file=sys.stderr)
    cm = frontier_fn.chunk_meta
    if cm:
        # per-chunk [omega_first, omega_last] and |omega_first - seed key|
        # (pool-library seed-mismatch diagnostic; inf = the cold first chunk)
        print("IAI chunk seeds: " + " ".join(
            f"[{a:.4g},{b:.4g}]d={d:.2g}" for a, b, d in cm),
            file=sys.stderr)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--hr", default=None,
                   help="Wannier90 _hr.dat file (default: the seeded synthetic model)")
    p.add_argument("--wout", default=None,
                   help="Wannier90 .wout file with the lattice of --hr")
    p.add_argument("--seed", type=int, default=0, help="seed of the synthetic model")
    p.add_argument("--eta", type=float, default=1e-2)
    p.add_argument("--npt", type=int, default=100)
    p.add_argument("--atol-interp", type=float, default=1e-2)
    p.add_argument("--abstol", type=float, default=1e-3)
    p.add_argument("--with-iai", action="store_true", help="also run the IAI solver")
    p.add_argument("--cold-iai", action="store_true",
                   help="disable the cross-omega warm start (A/B comparisons)")
    p.add_argument("--iai-chunk", type=int, default=33,
                   help="omega chunk size for the IAI scan (dispatch "
                        "amortization vs mid-seed harvest freshness)")
    p.add_argument("--iai-block", type=int, default=1,
                   help="omegas solved per adaptive nest (vector-valued "
                   "integrand; one refinement trajectory serves the block). "
                   "Must divide --iai-chunk.")
    p.add_argument("--iai-warm-width", type=int, default=8,
                   help="outer warm-seed consumption width (intervals of the "
                        "carried pool re-evaluated per device iteration): "
                        "seed evals have no sequential dependency, so width "
                        "trades live memory for the seeding phase's trips")
    p.add_argument("--iai-order", type=int, default=None,
                   help="Gauss-Kronrod order for every IAI nest level "
                        "(default 7 = 15-point): higher orders cut the "
                        "serial trip count of all three levels for "
                        "eta-smoothed integrands while widening each "
                        "batched evaluation — the depth-bound leg's trade")
    p.add_argument("--iai-nbisect", type=int, default=None,
                   help="OUTER-level refinement width (worst intervals "
                        "bisected per while_loop trip; default 1 = pure "
                        "worst-first): width trades masked-lane inner "
                        "solves for outer serial trips")
    p.add_argument("--iai-inner-nbisect", type=int, default=4,
                   help="inner-level refinement width (NestedQuad "
                        "inner_nbisect).  Default 4: halves the mid-level "
                        "refinement trips at identical eval counts on the "
                        "flagship")
    p.add_argument("--iai-leaf-nbisect", type=int, default=None,
                   help="innermost-level refinement width (intervals "
                        "bisected per iteration): trades masked-lane evals "
                        "for leaf trip count on the depth-bound scan leg")
    p.add_argument("--iai-leaf-presplit", type=int, default=None,
                   help="innermost-level uniform presplit (P subintervals "
                        "per leaf segment evaluated in one batched trip): "
                        "trades idle-lane evals for the first ~log2(P) "
                        "serial leaf bisections")
    p.add_argument("--iai-nest-presplit", type=int, default=None,
                   help="EVERY-level uniform presplit (initdiv-style "
                        "anti-aliasing robustness; odd P recommended — "
                        "dyadic P preserves GK node-aliasing symmetry)")
    p.add_argument("--iai-inner-cap", type=int, default=64,
                   help="inner-level interval-pool capacity (live memory "
                        "scales with the per-level panel product; lower it "
                        "for omega blocks, which widen every nest tensor "
                        "block-fold).  Default 64")
    p.add_argument("--iai-inner-seed-width", type=int, default=None,
                   help="mid-seed consumption width (intervals re-evaluated "
                        "per device iteration when a warm inner pool seeds "
                        "from the carried partition): trades live memory "
                        "for seeding depth")
    p.add_argument("--skip-ptr", action="store_true",
                   help="skip the PTR interpolant leg (cheap IAI-only A/B "
                        "runs)")
    p.add_argument("--with-ltm", action="store_true",
                   help="also compute the sharp (eta->0) DOS by the linear tetrahedron method")
    p.add_argument("--with-fullgrid", action="store_true",
                   help="also compute the whole omega curve CONVERGED in the "
                   "k-grid via the streaming full-grid f64 ladder "
                   "(dos.LorentzianFullGrid; abstol from --abstol)")
    p.add_argument("--out", default="svo_dos.npz")
    args = p.parse_args(argv)

    import jax.numpy as jnp

    from autobzcore_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()

    from autobzcore_tpu import FourierIntegrand, IntegralProblem
    from autobzcore_tpu.brillouin import PTR, TrivialRep
    from autobzcore_tpu.models import flagship_model
    from autobzcore_tpu.models.observables import dos_trace
    from autobzcore_tpu.utils.chebinterp import hchebinterp

    h, bz, label = flagship_model(args.hr, args.wout, seed=args.seed)
    print(f"loaded {label} {np.shape(h.c)[-1]}-band model, {bz}", file=sys.stderr)

    eta = args.eta
    # the DOS trace is invariant under every point-group operation; declaring
    # TrivialRep lets array-valued outputs (omega BLOCKS, --iai-block) pass
    # the symmetric-BZ layer inside jit (UnknownRep would raise for arrays)
    integrand = FourierIntegrand(dos_trace, h, eta=eta, rep=TrivialRep())
    out = {}

    # PTR path: batched omega sweeps through the shared npt^3 IBZ rule,
    # compiled once (fixed-chunk padding across hchebinterp frontiers)
    from autobzcore_tpu.parallel.sweep import SweepSolver

    ws = np.arange(10, 15 + eta / 100, eta / 100)
    if args.skip_ptr:
        out["omega"] = ws
    else:
        prob = IntegralProblem(integrand, bz)
        alg = PTR(npt=args.npt)

        t0 = time.time()
        dos_sweep = SweepSolver(prob, alg, abstol=args.abstol, chunk=264)
        dos_ptr = hchebinterp(dos_sweep, 10.0, 15.0, atol=args.atol_interp)
        t_ptr = time.time() - t0
        print(f"PTR(npt={args.npt}) interpolant: {dos_ptr.numevals} solver "
              f"evals, {len(dos_ptr.panels)} panels, {t_ptr:.2f}s",
              file=sys.stderr)

        out.update({"omega": ws, "dos_ptr": dos_ptr(ws), "t_ptr": t_ptr})

    if args.with_iai:
        _run_iai(args, bz, integrand, out)

    if args.with_fullgrid:
        from autobzcore_tpu import DOSProblem
        from autobzcore_tpu.dos import LorentzianFullGrid
        from autobzcore_tpu.dos import init as dos_init

        t0 = time.time()
        # the eta=1e-2 curve needs npt >~ 500 for 1e-3; start at 400 so the
        # ladder certifies in ~3 rungs
        wfg = np.linspace(10.0, 15.0, 1000)
        fg = LorentzianFullGrid(eta, nmin=400, nmax=2000)
        cache = dos_init(DOSProblem(h, wfg, bz), fg, abstol=args.abstol)
        detB = abs(float(np.linalg.det(bz.B)))
        out["omega_fullgrid"] = wfg
        out["dos_fullgrid"] = np.asarray(
            fg.dos_sweep(cache.cacheval, wfg, abstol=args.abstol)
        ) * detB
        out["t_fullgrid"] = time.time() - t0
        i125 = int(np.argmin(np.abs(wfg - 12.5)))
        print(f"fullgrid ladder ({len(wfg)} omegas, abstol={args.abstol:g}): "
              f"{out['t_fullgrid']:.2f}s; DOS({wfg[i125]:.4f}) = "
              f"{out['dos_fullgrid'][i125]:.5f}",
              file=sys.stderr)

    if args.with_ltm:
        from autobzcore_tpu import DOSProblem
        from autobzcore_tpu.dos import LTM
        from autobzcore_tpu.dos import init as dos_init

        t0 = time.time()
        ltm = LTM(npt=args.npt)
        cache = dos_init(DOSProblem(h, 12.5, bz), ltm)
        # sharp DOS (no Lorentzian broadening) over the same omega window;
        # aps convention: integral over the BZ, hence the det(B) factor
        detB = abs(float(np.linalg.det(bz.B)))
        out["dos_ltm"] = np.asarray(ltm.dos_sweep(cache.cacheval, jnp.asarray(ws))) * detB
        out["t_ltm"] = time.time() - t0
        print(f"LTM(npt={args.npt}) sharp DOS: {out['t_ltm']:.2f}s", file=sys.stderr)

    np.savez(args.out, **out)
    # every leg that ran prints its own anchor
    anchors = []
    if "dos_iai" in out:
        i0 = int(np.argmin(np.abs(ws - 12.5)))
        anchors.append(f"IAI DOS(12.5 eV) = {float(out['dos_iai'][i0]):.4f}")
    if not args.skip_ptr:
        anchors.append(f"PTR DOS(12.5 eV) = {float(dos_ptr(12.5)):.4f}")
    print(f"wrote {args.out} ({label} model); " + ("; ".join(anchors) or "(no legs ran)"),
          file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
