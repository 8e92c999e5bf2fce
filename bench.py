"""Flagship benchmark: 3-band cubic Wannier DOS throughput on one GPU.

Measures the BASELINE.json headline metric — H(k) evaluation + eigenvalue
k-points per second on the 3-band flagship Hamiltonian (the seeded
synthetic cubic t2g stand-in, ``models.cubic_t2g``) — plus the end-to-end
1000-omega broadened-DOS sweep (the aps_example workload, reference
``aps_example/aps_example.jl:25-39``), a certified full-grid ladder canary
and a warm-vs-cold adaptive-sweep canary.  The baseline is a measured
single-threaded numpy implementation of the identical computation (proxy for
the reference's single-threaded Julia).  Everything runs in complex128/f64.

Fails (non-zero exit) when JAX finds no GPU.  Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline", ..., "device"}.
"""
import json
import os
import sys
import time

import numpy as np

os.environ.setdefault("OMP_NUM_THREADS", "1")  # keep the numpy baseline honest


def main():
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX found platform {dev.platform!r}")

    from __graft_entry__ import _flagship_series
    from autobzcore_tpu.ops.eigh3 import eigvalsh_small
    from autobzcore_tpu.ops.fourier_eval import evaluate_grid

    s = _flagship_series()
    m = s.c.shape[-1]
    cdtype = s.dtype

    npt = 100
    u = [np.arange(npt) / npt] * 3
    offsets, periods, sndim = s.offset, s.period, s.sndim

    @jax.jit
    def hk_eigh(c):
        hk = evaluate_grid(c, sndim, u, offsets, periods, None, cdtype)
        return eigvalsh_small(hk.reshape(-1, m, m))  # closed-form 3x3

    @jax.jit
    def dos_sweep(e, omegas, eta):
        lor = eta / ((omegas[:, None, None] - e[None, :, :]) ** 2 + eta**2) / jnp.pi
        return jnp.mean(jnp.sum(lor, axis=2), axis=1)

    c = jax.device_put(jnp.asarray(s.c), dev)
    e = hk_eigh(c).block_until_ready()  # warmup + compile
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        e = hk_eigh(c).block_until_ready()
    t_grid = (time.perf_counter() - t0) / reps

    # sustained device throughput: chain LOOPS iterations inside one program
    # so per-dispatch latency amortizes away — the number production sweeps
    # see, where dispatches chain on device
    LOOPS = 20

    @jax.jit
    def hk_eigh_rep(c):
        def body(i, acc):
            hk = evaluate_grid(c + acc * 0, sndim, u, offsets, periods, None, cdtype)
            return acc + jnp.sum(eigvalsh_small(hk.reshape(-1, m, m)))

        return jax.lax.fori_loop(0, LOOPS, body, jnp.float64(0.0))

    float(hk_eigh_rep(c))
    t0 = time.perf_counter()
    float(hk_eigh_rep(c))
    t_amort = (time.perf_counter() - t0) / LOOPS
    kpts_per_sec = npt**3 / t_amort

    omegas = jnp.linspace(10.0, 15.0, 1000)
    eta = jnp.float64(0.01)
    dos_sweep(e, omegas, eta).block_until_ready()
    t0 = time.perf_counter()
    dos_sweep(e, omegas, eta).block_until_ready()
    t_sweep = time.perf_counter() - t0

    # single-threaded numpy baseline on a subsample, extrapolated
    C = np.asarray(s.c, dtype=np.complex128)
    nb = 4096
    rng = np.random.default_rng(0)
    ks = rng.uniform(size=(nb, 3))
    freqs = [o + np.arange(n) for o, n in zip(offsets, C.shape[:3])]
    t0 = time.perf_counter()
    ph = [np.exp(2j * np.pi * np.outer(ks[:, j], freqs[j])) for j in range(3)]
    hk_np = np.einsum("ka,kb,kc,abcij->kij", ph[0], ph[1], ph[2], C, optimize=True)
    np.linalg.eigvalsh(hk_np)
    t_np = time.perf_counter() - t0
    np_rate = nb / t_np

    # ladder canary: a small certified auto-ladder on the flagship curve
    # (rate-fitted rung scheduler, dos/fullgrid.next_rung_npt + the
    # ops/grid_sweep engine); eta=0.1 keeps the rungs small (~16-96).  The
    # certificate and wall catch regressions in the scheduler or the slab
    # engine that the throughput lanes above cannot see.
    from autobzcore_tpu import FBZ, load_bz
    from autobzcore_tpu.dos import DOSProblem, LorentzianFullGrid
    from autobzcore_tpu.dos import init as dos_init

    bz3 = load_bz(FBZ(), np.eye(3))
    Es = np.linspace(10.0, 15.0, 32)
    alg = LorentzianFullGrid(0.1, nmin=16, nmax=256, schedule="auto")
    cache = dos_init(DOSProblem(s, Es, bz3), alg, abstol=1e-5)
    alg.dos_sweep(cache.cacheval, Es, abstol=1e-5)  # warm compile
    cache.cacheval.pop("ladder_hint", None)  # measure the FULL ladder
    t0 = time.perf_counter()
    D, lerr, lok, lnev = alg._ladder(cache.cacheval, Es, 1e-5, None, None)
    ladder_wall = time.perf_counter() - t0
    ladder_dos = float(D[np.argmin(np.abs(Es - 12.5))])
    hint = cache.cacheval.get("ladder_hint")
    ladder_rungs = [int(x) for x in hint[:2]] if hint else []

    # warm-machinery canary: a small warm-vs-cold adaptive scan (2D
    # tight-binding Green's function).  The cross-omega warm start's hot
    # path (coarsen_pool / _coarsen_partition / mid-seed harvest) can make
    # warm seeds cost MORE than cold ones, so the result records the evals
    # ratio (< 1 expected) and the value delta (certificate-bounded)
    from autobzcore_tpu import IAI, FourierIntegrand, IntegralProblem
    from autobzcore_tpu.models import tb_integer
    from autobzcore_tpu.models.observables import dos_trace
    from autobzcore_tpu.parallel.sweep import SweepSolver

    bz2 = load_bz(FBZ(), 2 * np.pi * np.eye(2))
    fi = FourierIntegrand(dos_trace, tb_integer(2), eta=0.1)
    prob2 = IntegralProblem(fi, bz2)
    oms2 = np.linspace(-3.0, 3.0, 64)
    alg2 = IAI(inner_cap=64, inner_nbisect=2)
    # abstol 1e-5: at 1e-4 the COLD solve's single-segment GK estimate is
    # deceived at omega=+-0.905 (see NestedQuad.nest_presplit), which would
    # dominate warm_max_delta and mask real warm-machinery regressions
    cold_sw = SweepSolver(prob2, alg2, abstol=1e-5, chunk=16, scan=True)
    uc2 = np.asarray(cold_sw(oms2))
    warm_sw = SweepSolver(prob2, alg2, abstol=1e-5, chunk=16, scan=True, warm=True)
    uw2 = np.asarray(warm_sw(oms2))
    warm_ratio = warm_sw.numevals / max(cold_sw.numevals, 1)
    warm_delta = float(np.max(np.abs(uw2 - uc2)))

    result = {
        "metric": "flagship_hk_eigh_kpoints_per_sec",
        "value": kpts_per_sec,
        "unit": "k-points/s sustained (npt=100^3, synthetic 3-band H(k) contraction "
                "+ eigenvalues, complex128, device-chained)",
        "vs_baseline": kpts_per_sec / np_rate,
        "ladder_wall_s": ladder_wall,
        "ladder_cert": float(lerr),
        "ladder_retcode": bool(lok),
        "ladder_final_rungs": ladder_rungs,
        "ladder_dos_12p5": ladder_dos,
        "warm_evals_ratio": warm_ratio,
        "warm_max_delta": warm_delta,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(
        f"# device={dev.device_kind} grid_dispatch={t_grid:.4f}s "
        f"grid_amortized={t_amort:.4f}s sweep_1000w={t_sweep:.4f}s "
        f"numpy_1thread={np_rate:.0f} kpts/s",
        file=sys.stderr,
    )
    print(json.dumps(result))


if __name__ == "__main__":
    main()
