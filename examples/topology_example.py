"""Topological observables end-to-end: the Haldane phase diagram, a full
Berry/magnetization characterization at one point, the Kane-Mele quantum
spin Hall response, and a Weyl slice-Chern scan.

Everything runs on the cached-spectral-grid pattern (``models/berry.py``):
one batched (H, dH) build per model, then every observable is a masked
reduction — plus the gauge-invariant Wilson-loop Chern (integer-exact on
coarse grids) for the scans.

Usage:
  python examples/topology_example.py phase      [--n 13] [--npt 24]
  python examples/topology_example.py point      [--npt 96] [--t2 0.1]
  python examples/topology_example.py spin-hall  [--npt 72]
  python examples/topology_example.py weyl       [--npt 24] [--nkz 21]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=("phase", "point", "spin-hall", "weyl", "z2"),
                   nargs="?", default="phase")
    p.add_argument("--n", type=int, default=13, help="phase-diagram grid per axis")
    p.add_argument("--npt", type=int, default=24)
    p.add_argument("--t2", type=float, default=0.1)
    p.add_argument("--nkz", type=int, default=21)
    p.add_argument("--out", default="topology.npz")
    args = p.parse_args()

    from autobzcore_tpu.brillouin import FBZ, load_bz
    from autobzcore_tpu.models.berry import BerryCurvatureSolver, lattice_chern
    from autobzcore_tpu.models.tight_binding import (tb_haldane, tb_kane_mele_sz,
                                                     tb_weyl)

    bz2 = load_bz(FBZ(), np.eye(2))
    t0 = time.time()

    if args.mode == "phase":
        # Chern number of the lower Haldane band over the (phi, M/t2) plane;
        # the exact boundary is |M| = 3 sqrt(3) t2 |sin phi|
        phis = np.linspace(-np.pi, np.pi, args.n)
        Ms = np.linspace(-6 * args.t2, 6 * args.t2, args.n)
        C = np.zeros((args.n, args.n))
        for i, phi in enumerate(phis):
            for j, M in enumerate(Ms):
                h = tb_haldane(t2=args.t2, phi=float(phi), M=float(M))
                C[i, j] = round(lattice_chern(h, bz2, args.npt, bands=[0]))
        print(f"phase diagram {args.n}x{args.n} at npt={args.npt}: "
              f"{time.time()-t0:.1f}s")
        print("C(phi, M) rows phi=-pi..pi, cols M=-6t2..6t2:")
        for row in C.astype(int):
            print("".join({-1: "-", 0: ".", 1: "+"}[v] for v in row))
        np.savez(args.out, phis=phis, Ms=Ms, C=C)

    elif args.mode == "point":
        h = tb_haldane(t2=args.t2, phi=np.pi / 2, M=0.0)
        slv = BerryCurvatureSolver(h, bz2, npt=args.npt)
        C = np.asarray(slv.chern())
        I = np.asarray(slv.ahc(mu=0.0))
        e = np.asarray(slv.pack.e)
        lo, hi = e[:, 0].max(), e[:, 1].min()
        M1 = float(np.asarray(slv.orbital_magnetization(mu=lo + 0.1))[0, 1])
        M2 = float(np.asarray(slv.orbital_magnetization(mu=lo + 0.3))[0, 1])
        print(f"Haldane t2={args.t2}: C = {C.round(6)}, gap = [{lo:.4f}, {hi:.4f}]")
        print(f"  I_xy = {I[0,1]:.8f}  (C/2pi = {C[0]/2/np.pi:.8f})")
        print(f"  dM/dmu in gap = {(M2-M1)/0.2:.8f}  (Streda: {C[0]/2/np.pi:.8f})")
        print(f"  Wilson-loop C (npt=12): {lattice_chern(h, bz2, 12):.1f}")
        D = np.asarray(slv.berry_curvature_dipole(mu=hi + 0.3, beta=40.0))
        g = np.asarray(slv.quantum_metric())
        Om = np.asarray(slv.pack.Om)[:, :, 0, 1]
        detg = g[..., 0, 0] * g[..., 1, 1] - g[..., 0, 1] ** 2
        print(f"  BCD max|D| (metallic mu): {np.abs(D).max():.3e}  "
              f"(inversion-symmetric at M=0 -> ~0)")
        print(f"  metric-curvature bound: min(det g - (Om/2)^2) = "
              f"{(detg - (Om / 2) ** 2).min():.2e} (>= 0)")
        print(f"{time.time()-t0:.1f}s")

    elif args.mode == "spin-hall":
        h = tb_kane_mele_sz(lam_so=args.t2, M=0.0)
        slv = BerryCurvatureSolver(h, bz2, npt=args.npt)
        Sz = np.diag([0.5, 0.5, -0.5, -0.5])
        I_c = np.asarray(slv.ahc(mu=0.0))[0, 1]
        I_s = np.asarray(slv.operator_hall(Sz, mu=0.0))[0, 1]
        print(f"Kane-Mele lam_so={args.t2}: charge I_xy = {I_c:.2e} (TRS -> 0), "
              f"spin I^sz_xy = {I_s:.8f} (C_s/2pi = {-1/2/np.pi:.8f})")
        print(f"{time.time()-t0:.1f}s")

    elif args.mode == "z2":
        from autobzcore_tpu.models.berry import wilson_loop_spectrum, z2_invariant
        from autobzcore_tpu.models.tight_binding import tb_kane_mele

        for lam_r, M, label in ((0.0, 0.0, "Sz-conserving, topological"),
                                (0.05, 0.0, "Rashba, topological"),
                                (0.05, 0.8, "Rashba, trivial")):
            h = tb_kane_mele(lam_so=0.06, lam_r=lam_r, M=M)
            z2 = z2_invariant(h, args.npt if args.npt > 24 else 48)
            print(f"Kane-Mele lam_r={lam_r}, M={M} ({label}): Z2 = {z2}")
        th = wilson_loop_spectrum(tb_kane_mele(lam_so=0.06, lam_r=0.05), 48)
        np.savez(args.out, centers=th)
        print(f"Wannier-center flow (48 rows) -> {args.out}; {time.time()-t0:.1f}s")

    else:  # weyl
        h = tb_weyl(m=2.0)
        kzs = np.linspace(0.0, 0.5, args.nkz)
        Cs = [lattice_chern(h.contract(np.float64(kz)), bz2, args.npt, bands=[0])
              for kz in kzs]
        print("Weyl slice Chern C(kz) (nodes at kz = +-1/4):")
        for kz, c in zip(kzs, Cs):
            print(f"  kz={kz:+.3f}: {c:+.1f}")
        np.savez(args.out, kzs=kzs, C=np.asarray(Cs))
        print(f"{time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
