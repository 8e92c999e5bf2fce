"""North-star benchmark: flagship 3-band DOS, 1000 omegas, abstol <= 1e-5.

The aps_example DOS (1000 frequency points, eta=1e-2) converged to
abstol=1e-5, on the seeded synthetic flagship model unless ``--hr``/``--wout``
name Wannier90 files.

Error control is the framework's own AutoPTR ladder: symmetry-reduced PTR
rungs npt -> ~1.4 npt, stopping when the sup-norm of the change of the whole
1000-omega DOS curve falls under the tolerance (Richardson criterion,
reference ``src/algorithms.jl:393-432``).

abstol 1e-5 at eta = 1e-2 needs double precision (f32 energies carry ~1e-6
error -> ~4e-4 DOS error through the eta-Lorentzian).  The default
``--engine fullgrid`` streams the full npt^3 grid through
``ops/grid_sweep`` in complex128; ``--engine reduced`` runs the split-complex
f64 path (``ops/csplit_eval``) described next.

Execution shape of the reduced engine: the symmetry-reduced k-points (host C++ ``symptr_rule``)
stream through ONE fixed-size jitted block kernel — scattered-point Fourier
evaluation + closed-form Cardano eigenvalues + the 1000-omega Lorentzian
partial sum — so every rung of the ladder reuses the same compiled
executable (no per-rung recompiles, no padded-slab waste) and peak memory is
O(block).  Partial DOS vectors accumulate in host f64.

Usage: python benchmarks/northstar.py [--tol 1e-5] [--ladder 140,200,280,400,560]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BLOCK = 1 << 16  # k-points per compiled block


def make_block_fn(h, omegas, eta):
    """One compiled step: (B, 3) fractional points + weights -> eigenvalues'
    Lorentzian partial DOS (W,) in f64."""
    import jax
    import jax.numpy as jnp

    from autobzcore_tpu.ops.csplit_eval import evaluate_points_split, eigvalsh_split
    from autobzcore_tpu.ops.eigh3 import eigvalsh3_split

    c_np = np.asarray(h.c)
    cre = jnp.asarray(c_np.real, jnp.float64)
    cim = jnp.asarray(c_np.imag, jnp.float64)
    m = c_np.shape[-1]
    om = jnp.asarray(omegas, jnp.float64)

    eta32 = jnp.float32(eta)

    @jax.jit
    def block(X, w):
        hr, hi = evaluate_points_split(cre, cim, 3, X, h.offset, h.period)
        if m == 3:
            e = eigvalsh3_split(hr, hi)
        else:
            e = eigvalsh_split(hr, hi)
        w32 = w.astype(jnp.float32)

        def one(o):
            # o - e in (emulated) f64 — the cancellation step — then the
            # Lorentzian itself in f32: per-term rel error ~1e-7, and block
            # partials are summed in host f64, so the total stays ~1e-6
            t = (o - e).astype(jnp.float32)
            lor = eta32 / (t * t + eta32 * eta32)
            return jnp.sum(lor * w32[:, None]).astype(jnp.float64)

        return jax.lax.map(one, om, batch_size=100) / np.pi

    return block


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--eta", type=float, default=1e-2)
    ap.add_argument("--nomega", type=int, default=1000)
    ap.add_argument("--ladder", default="140,200,280,400,560",
                    help="comma list of npt rungs, or 'auto' for rate-fitted "
                    "scheduling (dos.fullgrid.next_rung_npt): geometric from "
                    "--nmin until two rung deltas exist, then the smallest "
                    "rung the observed exponential convergence certifies")
    ap.add_argument("--nmin", type=int, default=400,
                    help="first rung for --ladder auto")
    ap.add_argument("--nmax", type=int, default=2000,
                    help="rung cap for --ladder auto")
    ap.add_argument("--hr", default=None, help="Wannier90 _hr.dat (default: synthetic model)")
    ap.add_argument("--wout", default=None, help="Wannier90 .wout with the lattice of --hr")
    ap.add_argument("--save", default=None, help="save each rung's DOS curve to this .npz")
    ap.add_argument("--prev", default=None, help=".npz with a prior rung's curve (key D, npt) to diff against")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard fullgrid slabs over this many devices "
                    "(psum combine; 0 = single device). Validate without "
                    "GPUs via JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_"
                    "platform_device_count=4")
    ap.add_argument("--engine", choices=("fullgrid", "reduced"), default="fullgrid",
                    help="fullgrid: slab-streamed full npt^3 grid "
                    "(complex128 matrix products, no host symmetry enumeration); "
                    "reduced: symptr representatives through the scattered-"
                    "point block kernel (round-1 engine)")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from autobzcore_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()  # shared with aps_example and library users

    from autobzcore_tpu.models import flagship_model
    from autobzcore_tpu.ops.symptr import symptr_rule

    h, bz, label = flagship_model(args.hr, args.wout)
    print(f"{label} model", file=sys.stderr)
    detB = abs(float(np.linalg.det(bz.B)))  # aps convention: integral over the BZ
    omegas = np.linspace(10.0, 15.0, args.nomega)

    t0 = time.perf_counter()
    mesh = None
    if args.engine == "fullgrid":
        from autobzcore_tpu.ops.grid_sweep import FullGridSpectralSweep

        sweep = FullGridSpectralSweep(h, omegas, args.eta)
        if args.mesh:
            from jax.sharding import Mesh

            devs = jax.devices()
            if len(devs) < args.mesh:
                raise SystemExit(f"--mesh {args.mesh} but only {len(devs)} "
                                 f"{devs[0].platform} devices are visible")
            mesh = Mesh(np.array(devs[:args.mesh]), ("k",))
            print(f"sharding slabs over {args.mesh} {devs[0].platform} "
                  "devices (psum combine)", file=sys.stderr)
        t_compile = 0.0  # compiles fold into each rung's first dispatch
    else:
        block_fn = make_block_fn(h, omegas, args.eta)
        # compile once on a dummy block
        block_fn(jnp.zeros((BLOCK, 3), jnp.float64), jnp.zeros((BLOCK,), jnp.float64)
                 ).block_until_ready()
        t_compile = time.perf_counter() - t0
        print(f"block kernel compile: {t_compile:.1f}s (one-time, cached across rungs)",
              file=sys.stderr)

    prev = None
    if args.prev:
        prev = np.load(args.prev)["D"]
    total_t = 0.0
    err = float("inf")
    D = None

    from autobzcore_tpu.dos.fullgrid import next_rung_npt

    rungs = None if args.ladder == "auto" else [int(x) for x in args.ladder.split(",")]
    npts_done = []
    deltas = []

    def _next_npt():
        if rungs is not None:
            return rungs[len(npts_done)] if len(npts_done) < len(rungs) else None
        if not npts_done:
            return args.nmin
        return next_rung_npt(npts_done, deltas, args.tol, np.sqrt(2.0), args.nmax)

    while (npt := _next_npt()) is not None:
        if args.engine == "fullgrid":
            t_host = 0.0
            t0 = time.perf_counter()

            def prog(done, total, _t0=t0, _npt=npt):
                print(f"    npt={_npt}: slabs {done}/{total} at "
                      f"{time.perf_counter() - _t0:.1f}s", file=sys.stderr)

            if mesh is not None:
                acc = sweep.rung_sharded(npt, mesh)
            else:
                acc = sweep.rung(npt, progress=prog)
            D = acc * detB / npt**3
            t_dev = time.perf_counter() - t0
            total_t += t_dev
            if prev is not None:
                err = float(np.max(np.abs(D - prev)))
                deltas.append(err)
            print(f"npt={npt}: full grid ({npt ** 3:.3g} pts) device={t_dev:.2f}s "
                  f"max|dD|={err:.2e}", file=sys.stderr)
            prev = D
            npts_done.append(npt)
            if args.save:
                np.savez(args.save, D=D, npt=npt, omegas=omegas)
            if err <= args.tol:
                break
            continue
        t0 = time.perf_counter()
        reps, weights = symptr_rule(npt, 3, bz.syms)  # host, native C++ kernel
        t_host = time.perf_counter() - t0
        K = reps.shape[0]
        Kp = -(-K // BLOCK) * BLOCK
        X = np.zeros((Kp, 3))
        X[:K] = reps / npt
        W = np.zeros(Kp)
        W[:K] = weights
        t0 = time.perf_counter()
        acc = np.zeros(args.nomega)  # host f64 accumulation of block partials
        start = 0
        ckpt = f"{args.save}.rung{npt}.ckpt.npz" if args.save else None
        if ckpt and os.path.exists(ckpt):
            st = np.load(ckpt)
            acc, start = st["acc"], int(st["next"])
            print(f"  resuming rung npt={npt} at block {start // BLOCK}", file=sys.stderr)
        for i in range(start, Kp, BLOCK):
            acc += np.asarray(block_fn(jnp.asarray(X[i:i + BLOCK]),
                                       jnp.asarray(W[i:i + BLOCK])))
            if ckpt and (i // BLOCK) % 50 == 49:
                np.savez(ckpt, acc=acc, next=i + BLOCK)
        if ckpt and os.path.exists(ckpt):
            os.remove(ckpt)
        D = acc * detB / npt**3
        t_dev = time.perf_counter() - t0
        total_t += t_host + t_dev
        if prev is not None:
            err = float(np.max(np.abs(D - prev)))
            deltas.append(err)
        print(f"npt={npt}: K={K} ({Kp // BLOCK} blocks) symptr(host)={t_host:.2f}s "
              f"device={t_dev:.2f}s max|dD|={err:.2e}", file=sys.stderr)
        prev = D
        npts_done.append(npt)
        if args.save:
            np.savez(args.save, D=D, npt=npt, omegas=omegas)
        if err <= args.tol:
            break

    conv = "CONVERGED" if err <= args.tol else "NOT converged"
    i125 = int(np.argmin(np.abs(omegas - 12.5)))
    print(f"{conv} to {args.tol:g}: ladder wall {total_t:.2f}s (+ {t_compile:.1f}s "
          f"one-time compile); D({omegas[i125]:.4f})={D[i125]:.7f}", file=sys.stderr)
    return D


if __name__ == "__main__":
    main()
