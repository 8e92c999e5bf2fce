"""BASELINE config 5: 30-band near-singular DOS on one device.

Compares the two native routes to a 1000-energy broadened DOS curve for a
synthetic 30-band Wannier model (``models.synthetic_wannier``) on an npt=60
grid:

1. ``GGR(npt=60)`` on the InversionSymIBZ-reduced grid — spectral init
   (eigh + velocities) + the energy sweep;
2. ``FullGridSpectralSweep`` (m-generic: gather-assembled Hermitian
   matrices + batched eigvalsh) streaming the FULL npt^3 grid — one rung of
   the LorentzianFullGrid ladder.

The GGR box broadening handles eta -> 0 exactly; the full-grid engine
computes the eta-Lorentzian curve.  At eta ~ grid spacing they measure the
same physics; the comparison here is machinery cost per rung, the
VERDICT-r2 #2 criterion.

Usage: python benchmarks/bands30.py [--npt 60] [--eta 1e-4] [--bands 30]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--npt", type=int, default=60)
    p.add_argument("--eta", type=float, default=1e-4)
    p.add_argument("--bands", type=int, default=30)
    p.add_argument("--nE", type=int, default=1000)
    p.add_argument("--skip-ggr", action="store_true")
    args = p.parse_args(argv)

    import jax

    from autobzcore_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from autobzcore_tpu import GGR, DOSProblem, InversionSymIBZ, load_bz
    from autobzcore_tpu.dos import init as dos_init
    from autobzcore_tpu.models import synthetic_wannier
    from autobzcore_tpu.ops.grid_sweep import FullGridSpectralSweep

    h = synthetic_wannier(args.bands, nr=5, ndim=3, dtype=jnp.complex128)
    bz = load_bz(InversionSymIBZ(), np.eye(3))
    Es = np.linspace(-8.0, 8.0, args.nE)

    # --- full-grid engine (m-generic), one npt rung of the ladder ---
    eng = FullGridSpectralSweep(h, Es, args.eta, slab=2, slabs_per_dispatch=8,
                                omega_batch=50)
    t0 = time.time()
    D1 = eng.rung(args.npt) / args.npt**3
    t_cold = time.time() - t0
    t0 = time.time()
    D1 = eng.rung(args.npt) / args.npt**3
    t_fullgrid = time.time() - t0
    print(f"fullgrid m={args.bands} npt={args.npt} rung ({args.nE} energies): "
          f"warm {t_fullgrid:.1f}s (first {t_cold:.1f}s) "
          f"max D={np.max(D1):.4f}", file=sys.stderr)

    if not args.skip_ggr:
        # --- GGR route ---
        alg = GGR(npt=args.npt)
        # dos_init runs init_cacheval eagerly — time it directly instead of
        # paying the dominant spectral build twice
        t0 = time.time()
        cache = dos_init(DOSProblem(h, 0.0, bz), alg)
        t_init = time.time() - t0
        t0 = time.time()
        D2 = np.asarray(alg.dos_sweep(cache.cacheval, jnp.asarray(Es)))
        t_sweep = time.time() - t0
        print(f"GGR npt={args.npt} init {t_init:.1f}s + sweep {t_sweep:.2f}s",
              file=sys.stderr)
        print(f"speedup (fullgrid rung vs GGR init+sweep): "
              f"{(t_init + t_sweep) / t_fullgrid:.1f}x", file=sys.stderr)


if __name__ == "__main__":
    main()
