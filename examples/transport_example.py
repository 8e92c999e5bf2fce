"""3-band t2g optical conductivity at fixed filling — the transport workload the
reference's machinery exists to serve (its cited application paper, SciPost
Phys. 15, 062 (2023), computes exactly these kinetic coefficients with the
BZ layer that ``aps_example`` demonstrates on the DOS).

Flow (all on one device):
1. take the 3-band t2g Hamiltonian: the seeded synthetic stand-in
   (``models.cubic_t2g``), or a Wannier90 model with ``--hr``/``--wout``;
2. build the symmetry-reduced (H, dH) spectral grid ONCE;
3. pin the chemical potential to the n=1 (d^1) filling with
   ``ElectronCountSolver.find_mu`` — bisection on the cached grid;
4. sweep the optical conductivity kernel ``sigma_ab(Omega)`` with the
   adaptive Fermi-window frequency integral (``alpha=0``), plus the alpha=1
   thermoelectric numerator at Omega=0.

Usage: python examples/transport_example.py [--npt 60] [--beta 40]
       [--eta 5e-3] [--nomega 32] [--hr svo_hr.dat --wout svo.wout]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--hr", default=None,
                   help="Wannier90 _hr.dat file (default: the seeded synthetic model)")
    p.add_argument("--wout", default=None,
                   help="Wannier90 .wout file with the lattice of --hr")
    p.add_argument("--seed", type=int, default=0, help="seed of the synthetic model")
    p.add_argument("--npt", type=int, default=60)
    p.add_argument("--eta", type=float, default=5e-3)
    p.add_argument("--beta", type=float, default=40.0, help="1/kT in 1/eV")
    p.add_argument("--filling", type=float, default=1.0, help="electrons/cell")
    p.add_argument("--nomega", type=int, default=32)
    p.add_argument("--omega-max", type=float, default=2.0, help="eV")
    p.add_argument("--abstol", type=float, default=1e-5)
    p.add_argument("--out", default="sigma.npz")
    args = p.parse_args()

    from autobzcore_tpu.models import flagship_model
    from autobzcore_tpu.models.observables import spectral_velocity_pack
    from autobzcore_tpu.models.transport import (ElectronCountSolver,
                                                 KineticCoefficientSolver)
    from autobzcore_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()
    h, bz, label = flagship_model(args.hr, args.wout, seed=args.seed)
    bz = bz.full()
    print(f"{label} model")

    t0 = time.time()
    pack = spectral_velocity_pack(h, bz, args.npt)  # built ONCE, shared below
    ec = ElectronCountSolver(h, bz, args.npt, pack=pack)
    mu = ec.find_mu(args.filling, args.beta)
    t_mu = time.time() - t0
    print(f"mu(n={args.filling}, beta={args.beta}) = {mu:.6f} eV "
          f"[{t_mu:.1f} s incl. spectral build]; n(mu) = {ec(mu, args.beta):.6f}")

    t0 = time.time()
    kc = KineticCoefficientSolver(h, bz, args.npt, eta=args.eta,
                                  beta=args.beta, alpha=0, mu=mu, pack=pack)
    omegas = np.linspace(0.0, args.omega_max, args.nomega)
    sigma = kc.sweep(omegas, abstol=args.abstol)
    t_sig = time.time() - t0
    print(f"sigma(Omega) sweep: {args.nomega} frequencies in {t_sig:.1f} s "
          f"({kc.numevals} GK integrand evals, scan-chunked, "
          f"certified={kc.retcode})")
    print(f"  sigma_xx(0)   = {sigma[0, 0, 0]:.6f}")
    print(f"  sigma_xx(max) = {sigma[-1, 0, 0]:.6f}")

    kc1 = KineticCoefficientSolver(h, bz, args.npt, eta=args.eta,
                                   beta=args.beta, alpha=1, mu=mu, pack=pack)
    a1 = kc1(np.array([0.0]), abstol=args.abstol)[0]
    print(f"  alpha=1 numerator A1_xx(0) = {a1[0, 0]:.6f} (thermopower ~ A1/A0)")

    np.savez(args.out, omegas=omegas, sigma=sigma, mu=mu, a1=a1,
             beta=args.beta, eta=args.eta, npt=args.npt)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
