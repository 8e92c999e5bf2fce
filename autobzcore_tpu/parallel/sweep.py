"""Device-parallel parameter sweeps.

On-device replacement for the reference's threaded ``batchsolve``
(``src/interfaces.jl:199-241``): instead of round-robining parameters over
threads with per-thread deepcopies, the whole sweep becomes one vmapped (and
optionally mesh-sharded) XLA program.  The omega-grid of a spectral-function
sweep is the natural data-parallel axis (cf. reference ``docs/src/dos.md:38-42``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..algorithms.base import effective_tolerances
from ..interfaces import IntegralProblem, init


def _host_only_cacheval(cv):
    """True when the algorithm's cacheval marks a host-side solve (pole-aware
    nest levels: data-dependent Newton deflation has no traceable form).  BZ
    wrappers nest their inner cacheval under ``"inner"``."""
    while isinstance(cv, dict):
        if "pole_nest" in cv:
            return True
        cv = cv.get("inner")
    return False


def _host_pipelined_sweep(prob, alg, ps_list, abstol, reltol, nthreads=4):
    """Host-thread pipelined fallback for host-only algorithms: the same
    uniform sweep entry points (``sweep_solve``/``SweepSolver``) the compiled
    sweeps use, backed by :func:`threaded_solve` (the reference sweeps ANY
    algorithm through one ``batchsolve``, ``src/interfaces.jl:210-218``)."""
    import logging

    logging.getLogger(__name__).info(
        "%s has no traceable solve form (host-side pole algorithms); "
        "falling back to the host-pipelined sweep (threaded_solve, "
        "nthreads=%d)", type(alg).__name__, nthreads)
    kws = {}
    if abstol is not None:
        kws["abstol"] = abstol
    if reltol is not None:
        kws["reltol"] = reltol
    return threaded_solve(prob, alg, ps_list, nthreads=nthreads, **kws)


def sweep_solve(prob: IntegralProblem, alg, ps, abstol=None, reltol=None, mesh=None, axis=None):
    """Solve ``prob`` at every parameter in the stacked pytree ``ps`` (leading
    axis = sweep axis) in one batched program.

    Returns ``(us, resids, converged, numevals)`` with the sweep axis
    leading (each parameter's convergence flag and integrand-evaluation
    count ride along with its value).  With ``mesh``, the
    parameter axis is sharded over ``mesh.axis_names[0]`` and results are
    gathered (data-parallel over omega/temperature/chemical-potential grids).

    Adaptive-npt PTR algorithms run a *batched refinement ladder*: every rung
    evaluates the whole sweep through one vmapped rule, refining until the
    worst parameter in the batch converges — so the smoothest and the
    sharpest omega share rule evaluations.
    """
    from ..algorithms.ptr import AutoSymPTRJL
    from ..brillouin import AutoPTR

    if isinstance(alg, (AutoPTR, AutoSymPTRJL)):
        return _sweep_autoptr(prob, alg, ps, abstol, reltol, mesh, axis)
    cache = init(prob, alg)
    if _host_only_cacheval(cache.cacheval):
        # pole-bearing nests: same entry point, host-pipelined backend
        tmap = jax.tree_util.tree_map
        leaves = jax.tree_util.tree_leaves(ps)
        n = np.shape(leaves[0])[0]
        ps_list = [tmap(lambda x: x[i], ps) for i in range(n)]
        sols = _host_pipelined_sweep(prob, alg, ps_list, abstol, reltol)
        us = tmap(lambda *vs: np.stack([np.asarray(v) for v in vs]),
                  *[s.u for s in sols])
        resids = np.array([float(np.max(np.abs(np.asarray(s.resid))))
                           if s.resid is not None else np.nan for s in sols])
        convs = np.array([bool(s.retcode) for s in sols])
        nevs = np.array([int(s.numevals) for s in sols])
        return us, resids, convs, nevs
    fn2, consts = _solve_fn_with_consts(prob, alg, cache)
    atol, rtol = effective_tolerances(abstol, reltol)

    def one(consts, p):
        return fn2(consts, p, atol, rtol)

    batched = jax.jit(jax.vmap(one, in_axes=(None, 0)))
    if mesh is not None:
        sharding = NamedSharding(mesh, P(axis or mesh.axis_names[0]))
        ps = jax.tree_util.tree_map(
            lambda x: jax.device_put(jnp.asarray(x), sharding), ps
        )
    return batched(consts, ps)


def _solve_fn_with_consts(prob, alg, cache):
    """(fn(consts, p, atol, rtol), consts): rule data threads through the
    batched jit as ARGUMENTS when the algorithm supports it — captured
    constants ship with the HLO to remote compile helpers (a stored-series
    npt=100 sweep kernel measured 365-520 s per compile as literals, and the
    executable never hits the persistent cache)."""
    from ..interfaces import _takes_mixed_parameters
    from ..parameters import merge_parameters

    got = None
    sfc = getattr(alg, "solve_fn_consts", None)
    if sfc is not None:
        got = sfc(cache.cacheval)
    if got is not None:
        fnc, consts = got
    else:
        fn = alg.solve_fn(cache.cacheval)
        fnc = lambda consts, p, atol, rtol: fn(p, atol, rtol)  # noqa: E731
        consts = ()
    if _takes_mixed_parameters(prob.f):
        preset = cache.p  # integrand-preset parameters resolved at init

        def fn2(consts, p, atol, rtol):
            return fnc(consts, merge_parameters(preset, p), atol, rtol)

        return fn2, consts
    return fnc, consts


def threaded_solve(prob, alg, ps, nthreads=4, warmup=True, **kwargs):
    """Pipeline independent ``p``-solves of ``prob`` across ``nthreads``
    host threads, sharing one compiled cache; returns ``IntegralSolution``s
    in ``ps`` order.  Pass ``cache=`` (from :func:`~autobzcore_tpu.init`)
    to reuse a prebuilt cache across calls (e.g. interpolation frontiers).

    For host-driven adaptive solvers (``IAI(host_outer=True)``: one bounded
    device dispatch per refinement step), a single solve alternates host
    heap work with device panels, leaving the device idle during every host
    phase and vice versa.  K threads keep the device queue fed while each
    parameter keeps its full per-parameter adaptivity — the
    pipelined-dispatch variant of the multi-omega driver (the ``lax.map``
    variant for fully-on-device solves is ``SweepSolver(scan=True)``).

    Thread safety: the shared cacheval is read-only here (jitted panel
    executables + rule data); the per-parameter state (heaps, totals) is
    local to each ``do_solve`` call, unlike ``IntegralSolver.solve_p``
    which mutates its cache.

    ``warmup=True`` runs the first parameter alone so compilation happens
    once instead of racing across threads.
    """
    out = [None] * len(ps := list(ps))
    for i, sol, _ in threaded_solve_iter(prob, alg, ps, nthreads=nthreads,
                                         warmup=warmup, **kwargs):
        out[i] = sol
    return out


def threaded_solve_iter(prob, alg, ps, nthreads=4, warmup=True, **kwargs):
    """Generator form of :func:`threaded_solve`: yields ``(index, solution,
    wall_seconds)`` **in ``ps`` order** as results become available
    (out-of-order completions buffer inside the executor's ordered ``map``).

    This is the streaming backend for ordered incremental persistence
    (``batchsolve``/``batchsolve_h5`` with ``nthreads>1``): the consumer sees
    results strictly in index order, so resume semantics (first missing row =
    first unsolved parameter) survive the parallelism.
    """
    import time as _time
    from concurrent.futures import ThreadPoolExecutor

    from ..interfaces import (IntegralSolution, _resolve_parameters,
                              _takes_mixed_parameters, init)
    from ..parameters import MixedParameters
    from ..utils.tree import host_complex_safe

    cache = kwargs.pop("cache", None)
    if cache is None:
        cache = init(prob, alg, **kwargs)
    elif kwargs:
        # a prebuilt cache carries its init-time tolerances; silently
        # dropping abstol/reltol here would run every solve at the WRONG
        # tolerance while reporting success
        raise ValueError(
            f"cache= already fixes the solve kwargs; got extra {sorted(kwargs)} "
            "(pass them to init() when building the cache)"
        )
    mixed = _takes_mixed_parameters(prob.f)

    def one(p):
        if mixed and not isinstance(p, MixedParameters):
            p = MixedParameters(p)
        _, p2 = _resolve_parameters(prob.f, p)
        t0 = _time.time()
        sol = cache.alg.do_solve(cache.f, cache.dom, p2, cache.cacheval,
                                 **cache.kwargs)
        # complex results come back as host-joined real pairs (same
        # contract as solve_)
        sol = IntegralSolution(host_complex_safe(sol.u),
                               host_complex_safe(sol.resid),
                               sol.retcode, sol.numevals)
        return sol, _time.time() - t0

    ps = list(ps)
    if not ps:
        return
    start = 0
    if warmup:
        sol, wall = one(ps[0])
        yield 0, sol, wall
        start = 1
    if len(ps) > start:
        with ThreadPoolExecutor(max_workers=max(1, int(nthreads))) as ex:
            for k, (sol, wall) in enumerate(ex.map(one, ps[start:])):
                yield start + k, sol, wall


def make_mesh(n_devices=None, axis_names=("p",), devices=None):
    """Build a 1D device mesh for sweep parallelism."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), axis_names)


def _sweep_autoptr(prob, alg, ps, abstol, reltol, mesh, axis=None):
    """Batched AutoPTR ladder (see :func:`sweep_solve`).

    Certificates are per lane (reference per-solve semantics,
    ``src/interfaces.jl:120-126``): each parameter gets its own residual,
    convergence flag, and honest evaluation count.  Lanes that converge at a
    rung are *dropped* from later rungs (the remaining lanes are gathered
    into a smaller batch), so a sweep mixing smooth and sharp parameters only
    pays fine grids for the parameters that need them.  Each rung compiles
    its own program anyway (the rule size changes with npt), so the shrinking
    batch costs no extra compilations.
    """
    from ..algorithms.base import effective_tolerances
    from ..algorithms.ptr import AutoSymPTRJL, build_ptr_run
    from ..brillouin import AutoPTR
    from ..domains import Basis
    from ..interfaces import _resolve_parameters, _takes_mixed_parameters
    from ..parameters import merge_parameters
    from ..utils.tree import tree_batched_norm, tree_sub

    from ..brillouin import TrivialRep, UnknownRep, symmetrize, sym_rep

    f, p0 = _resolve_parameters(prob.f, prob.p)
    if isinstance(alg, AutoPTR):
        bz_, dom, inner = alg.bz_to_standard(prob.dom)
        j = abs(float(np.linalg.det(bz_.B)))
        rep = sym_rep(f)

        # in-loop symmetrization (SymmetricRule semantics): every rung's
        # batched value maps to the full zone before the convergence test.
        # Values are batched over the sweep axis; TrivialRep/scalars scale by
        # nsyms, declared reps symmetrize leaf-wise (leading axes broadcast).
        def sym(tree):
            if bz_.is_full:
                return tree
            leaves = jax.tree_util.tree_leaves(tree)
            nonscalar = any(np.ndim(leaf) > 1 for leaf in leaves)  # axis 0 = sweep
            if isinstance(rep, UnknownRep) and nonscalar:
                raise ValueError(
                    "batched AutoPTR sweep over a symmetric BZ with an "
                    "array-valued integrand whose symmetry representation is "
                    "unknown: declare the integrand's `rep` or use the full BZ."
                )
            if isinstance(rep, (TrivialRep, UnknownRep)) or not nonscalar:
                return jax.tree_util.tree_map(lambda v: bz_.nsyms * v, tree)
            return rep.symmetrize(bz_, tree)
    else:
        dom, inner = prob.dom, alg
        j = 1.0

        def sym(tree):
            return tree
    atol, rtol = effective_tolerances(abstol, reltol)

    # rule data rides as jit ARGUMENTS (see _solve_fn_with_consts): captured
    # constants ship MB-scale stored-series arrays with the HLO to remote
    # compile helpers and miss the persistent cache
    if _takes_mixed_parameters(prob.f):
        def wrap(run_c):
            return jax.jit(jax.vmap(
                lambda c, p: run_c(c, merge_parameters(p0, p)),
                in_axes=(None, 0)))
    else:
        def wrap(run_c):
            return jax.jit(jax.vmap(run_c, in_axes=(None, 0)))

    tmap = jax.tree_util.tree_map
    ps = tmap(jnp.asarray, ps)
    n = jax.tree_util.tree_leaves(ps)[0].shape[0]

    def put(tree):
        if mesh is None:
            return tree
        sharding = NamedSharding(mesh, P(axis or mesh.axis_names[0]))
        return tmap(lambda x: jax.device_put(x, sharding), tree)

    lane_conv = np.zeros(n, bool)
    nev = np.zeros(n, np.int64)
    err = np.full(n, np.inf)
    val = None     # full-batch tree of each lane's latest iterate
    window = []    # last `keepmost` full-batch snapshots
    keepmost = max(2, int(getattr(inner, "keepmost", 2)))
    for npt in inner.npt_ladder():
        active = np.nonzero(~lane_conv)[0]
        if active.size == 0:
            break
        _, ne_rung, run_c, consts = build_ptr_run(f, dom, npt, inner.syms)
        nev[active] += int(ne_rung)
        gidx = active
        if mesh is not None:
            # sharded gathers must divide over the mesh axis: pad with the
            # last active lane and slice the duplicates back off below
            ndev = int(mesh.shape[axis or mesh.axis_names[0]])
            npad = -(-active.size // ndev) * ndev
            gidx = np.concatenate([active, np.full(npad - active.size, active[-1])])
        ps_a = ps if gidx.size == n and mesh is None else tmap(lambda x: x[gidx], ps)
        val_a = sym(wrap(run_c)(consts, put(ps_a)))
        if gidx.size != active.size:
            val_a = tmap(lambda v: v[: active.size], val_a)
        if val is None:
            val = val_a if active.size == n else tmap(
                lambda v: jnp.zeros((n,) + v.shape[1:], v.dtype).at[active].set(v),
                val_a)
        else:
            val = tmap(lambda full, v: full.at[active].set(v), val, val_a)
        if window:
            prev_a = tmap(lambda w: w[active], window[0])
            err_a = np.asarray(tree_batched_norm(tree_sub(val_a, prev_a))) * j
            tol_a = np.maximum(atol, rtol * np.asarray(tree_batched_norm(val_a)) * j)
            err[active] = err_a
            lane_conv[active] = err_a <= tol_a
        window.append(val)
        if len(window) >= keepmost:
            window.pop(0)
    us = tmap(lambda v: j * v, val)
    return us, jnp.asarray(err), lane_conv, nev


class SweepSolver:
    """Reusable compiled parameter sweep with fixed-chunk padding.

    Build once, call with any number of parameters: inputs are padded to a
    multiple of ``chunk`` so the compiled executable is reused across calls of
    varying size (e.g. hchebinterp refinement frontiers).  Parameters are
    single numeric arrays; for FourierIntegrand/ParameterIntegrand problems
    each value is merged as the next positional argument.

    After each call, ``self.retcode`` is True iff every (non-pad) parameter's
    solve converged, and ``self.numevals`` has accumulated the actual
    integrand evaluations (adaptive algorithms report their pool totals;
    fixed rules their point counts) — the same certificate/cost contract as
    a scalar ``solve``.

    ``scan=True`` sequences the chunk's solves inside ONE device program
    (``lax.map``) instead of vmapping them in lockstep: each parameter keeps
    its own adaptive early exit (an adaptive solver vmapped over a batch runs
    every lane until the WORST lane converges — measured 5x waste for IAI,
    docs/DESIGN.md), while per-solve dispatch overhead amortizes over the
    chunk.  Chunks themselves dispatch asynchronously, so the host
    round-trips overlap device work.  This is the multi-omega IAI sweep.

    ``group=N`` (with ``scan=True``) vmaps N *adjacent* parameters in lockstep
    inside each scan step: lockstep waste is bounded within the group while
    every device tensor gets N times wider.  On the flagship 3-level IAI nest
    the per-level vmaps already fill the device, so lockstep only multiplies
    whole inner solves.  The knob exists for shallow/cheap integrands whose
    panels genuinely underfill the device — measure before using.

    ``block=W`` (with ``scan=True``) solves W adjacent parameters in ONE
    adaptive nest (the parameter enters the integrand as a (W,)-vector).
    Certificate granularity is the BLOCK: a block is one solve with one
    convergence flag and one indivisible eval count; its lanes inherit the
    block certificate, and the exact per-block ``(converged, numevals)``
    arrays are exposed as ``self.block_certificates`` after each call (in
    solve order — sorted parameter order for warm sweeps).  ``numevals``
    sums the per-block counts exactly.

    ``warm=True`` composes with ``mesh``: the sorted parameters split into
    ndev contiguous regions and each device runs an independent warm chain
    (pool carry + shared seed library) — the multi-device form of the
    cross-parameter warm start.  ``chunk`` must divide over the mesh.

    Host-only algorithms (pole-aware nests: ContQuadGKJL/MeroQuadGKJL at any
    level) cannot be traced into a sweep program; this class then serves the
    SAME entry point through the host-pipelined backend
    (:func:`threaded_solve` with ``nthreads``), logging the fallback — the
    reference's uniform ``batchsolve`` contract for every algorithm
    (``src/interfaces.jl:210-218``).
    """

    def __init__(self, prob, alg, abstol=None, reltol=None, chunk=256, mesh=None,
                 scan=False, group=1, warm=False, warm_lib=12, block=1,
                 nthreads=4):
        from ..algorithms.base import effective_tolerances
        from ..interfaces import _takes_mixed_parameters, init
        from ..parameters import MixedParameters

        cache = init(prob, alg)
        self.numevals = 0
        self.chunk_evals = []
        self.chunk_meta = []
        self.retcode = None  # set by __call__
        self.block_certificates = None
        self.block = int(block)
        if _host_only_cacheval(cache.cacheval):
            # pole-bearing nests run host-side only: serve the SAME sweep
            # entry point through the host-pipelined backend instead of
            # raising (scan/warm/group/block knobs describe compiled sweep
            # programs and do not apply; the fallback logs itself)
            self._host_mode = (prob, alg, abstol, reltol, int(nthreads))
            self.block = 1
            return
        self._host_mode = None
        fn2, consts = _solve_fn_with_consts(prob, alg, cache)
        atol, rtol = effective_tolerances(abstol, reltol)
        wrap = MixedParameters if _takes_mixed_parameters(prob.f) else (lambda x: x)

        def one(consts, x):
            u, _, conv, ne = fn2(consts, wrap(x), atol, rtol)
            return u, conv, ne

        self.chunk = chunk
        self.mesh = mesh
        self._consts = consts
        g = int(group)
        if g > 1 and not scan:
            raise ValueError("group > 1 requires scan=True")
        blk = int(block)
        self.block = blk
        if blk > 1:
            # omega-BLOCK solves: each scan step solves `block` ADJACENT
            # parameters in ONE adaptive nest — the parameter enters the
            # integrand as a (block,)-vector (broadcasting over new leading
            # axes, e.g. models.observables.dos_trace), the per-interval
            # error is the 2-norm over the block's channels (>= the max, so
            # every channel certifies to abstol), and ONE refinement
            # trajectory serves the whole block.  This cuts the sweep's
            # SEQUENTIAL solve count block-fold: unlike `group` (vmapped
            # INDEPENDENT solves whose trip counts multiply as the lockstep
            # max — measured 5x waste), a block is a single solve, and
            # adjacent omegas share adaptive structure (the warm-start
            # premise), so its trip counts track the worst member, not the
            # sum.  For the depth-bound IAI sweeps this converts idle loop
            # depth into per-eval width the device has to spare.
            if not scan or g != 1 or mesh is not None:
                raise ValueError(
                    "block > 1 requires scan=True, group=1, and no mesh")
            if chunk % blk:
                raise ValueError(
                    f"chunk {chunk} must divide into blocks of {blk}")
        self._pool = None
        # omega-keyed pool library: the carried pool alone mis-seeds the
        # FIRST chunks of each hchebinterp call (the new frontier jumps back
        # in omega while the pool is tuned to the previous call's LAST
        # omega — measured: 13/29 chunks held 77% of the flagship leg's
        # evals).  Each chunk's final (omega, pool) snapshot enters a small
        # library and every chunk seeds from the nearest-omega entry.
        self._pool_x = None
        self._pool_lib = []
        self._warm_lib = int(warm_lib)
        if warm:
            # cross-parameter warm start (adaptive nests): the scan carries
            # the outer interval pool from each solve into the next, so
            # adjacent parameters inherit the partition instead of
            # re-discovering it; the pool also persists
            # across __call__s (hchebinterp frontiers keep warming up)
            if not scan or g != 1:
                raise ValueError(
                    "warm=True requires scan=True and group=1 "
                    "(the pool carry is a sequential chain per device)")
            sfw = getattr(alg, "solve_fn_warm", None)
            got = None if sfw is None else sfw(cache.cacheval)
            if got is None:
                raise ValueError(
                    f"{type(alg).__name__} has no warm-pool solve form "
                    "(warm=True needs an adaptive-outer NestedQuad/IAI with "
                    "precision='complex'/'split', on-device)")
            warm_fn, pool0 = got
            self._pool0 = jax.tree_util.tree_map(jnp.asarray, tuple(pool0))
            # mid-seed refresh (nested warm starts carry one inner-level
            # partition): its OWN small program, run once per chunk — see
            # NestedQuad.harvest_fn
            hfn = getattr(alg, "harvest_fn", None)
            harvest_fn = None if hfn is None else hfn(cache.cacheval)
            if _takes_mixed_parameters(prob.f):
                # integrand-preset parameters merge in, mirroring
                # _solve_fn_with_consts' wrapping of the cold path
                from ..parameters import merge_parameters

                preset = cache.p
                warm_inner = warm_fn

                def warm_fn(p, atol, rtol, pool):
                    return warm_inner(merge_parameters(preset, p), atol, rtol,
                                      pool)

                if harvest_fn is not None:
                    harvest_inner = harvest_fn

                    def harvest_fn(p, atol, rtol, pool):
                        return harvest_inner(merge_parameters(preset, p),
                                             atol, rtol, pool)

            if harvest_fn is None:
                self._harvest = None
            else:
                def _harvest(x, pool):
                    return harvest_fn(wrap(x), atol, rtol, pool)

                self._harvest = _harvest

            def step(pool, x):
                u, _, conv, ne, new_pool = warm_fn(wrap(x), atol, rtol, pool)
                return new_pool, (u, conv, ne)

            def seq_warm(consts, pool, xs):
                del consts  # rule data rides inside the warm closure
                if blk > 1:
                    xs = xs.reshape(-1, blk)
                pool, outs = jax.lax.scan(step, pool, xs)
                return _deblock(outs), pool

            self._batched_warm = jax.jit(seq_warm)
            self._batched_warm_sharded = None
            self._harvest_sharded = None
            if mesh is not None:
                # multi-device warm sweeps: the sorted omega
                # lanes partition into ndev CONTIGUOUS regions, one
                # independent warm chain (pool carry + library seeding) per
                # device.  Each dispatch advances every chain by chunk/ndev
                # solves via shard_map — no collectives, no cross-device
                # lockstep; pools ride device-resident between dispatches.
                from jax import shard_map

                w_axis = mesh.axis_names[0]
                w_ndev = int(mesh.shape[w_axis])
                if chunk % w_ndev:
                    raise ValueError(
                        f"chunk {chunk} must divide over {w_ndev} devices")
                tmap = jax.tree_util.tree_map

                def warm_shard(pool, xs):
                    pool = tmap(lambda v: v[0], pool)
                    out, new_pool = seq_warm((), pool, xs)
                    return out, tmap(lambda v: v[None], new_pool)

                # check_vma=False: the chains are collective-free, and the
                # seeded pool's while_loop mixes unvarying inits (zeros)
                # with shard-varying fills, which the vma checker rejects
                self._batched_warm_sharded = jax.jit(
                    shard_map(warm_shard, mesh=mesh,
                              in_specs=(P(w_axis), P(w_axis)),
                              out_specs=(P(w_axis), P(w_axis)),
                              check_vma=False))
                if self._harvest is not None:
                    base_harvest = self._harvest

                    def harvest_shard(x, pool):
                        pool = tmap(lambda v: v[0], pool)
                        new_pool, ne = base_harvest(x[0], pool)
                        return (tmap(lambda v: v[None], new_pool),
                                jnp.asarray(ne)[None])

                    self._harvest_sharded = jax.jit(
                        shard_map(harvest_shard, mesh=mesh,
                                  in_specs=(P(w_axis), P(w_axis)),
                                  out_specs=(P(w_axis), P(w_axis)),
                                  check_vma=False))
        else:
            self._batched_warm = None
            self._batched_warm_sharded = None
            self._harvest = None
            self._harvest_sharded = None

        def _deblock(outs):
            # flatten per-BLOCK outputs back to per-lane form on-device so
            # chunk dispatch stays async.  A block is ONE solve: its
            # convergence flag and eval count are indivisible, so lanes
            # INHERIT the block certificate and the per-lane eval column is
            # the even split (telemetry only — `numevals` and
            # `block_certificates` use the exact per-block counts threaded
            # through as extra outputs).
            if blk == 1:
                return outs
            u, conv, ne = outs
            for v in jax.tree_util.tree_leaves(u):
                if v.ndim < 2 or v.shape[1] != blk:
                    raise ValueError(
                        f"block={blk} requires the integrand to broadcast "
                        "over the omega-block vector: each block solve must "
                        "return one output channel per block member (shape "
                        f"({blk}, ...)), but the solve output has per-solve "
                        f"shape {tuple(v.shape[1:])}. Reducing integrands "
                        "(e.g. models.observables.dos_eig, which sums over "
                        "all axes) cannot run blocked.")
            u = jax.tree_util.tree_map(
                lambda v: v.reshape((-1,) + v.shape[2:]), u)
            return (u, jnp.repeat(conv, blk), jnp.repeat(ne / blk, blk),
                    conv, ne)

        def seq(consts, xs):
            # lax.map over groups of g lockstep-vmapped solves; xs length is
            # a multiple of g (chunk and chunk//ndev are validated below)
            if blk > 1:
                return _deblock(
                    jax.lax.map(lambda x: one(consts, x), xs.reshape(-1, blk)))
            if g == 1:
                return jax.lax.map(lambda x: one(consts, x), xs)
            grp = jax.vmap(lambda x: one(consts, x))
            out = jax.lax.map(grp, xs.reshape(-1, g))
            return jax.tree_util.tree_map(
                lambda v: v.reshape((-1,) + v.shape[2:]), out)

        if scan and mesh is not None:
            # multi-device adaptive sweep: omega chunks shard over the mesh
            # axis; EACH device sequences its local slice with lax.map, so
            # per-parameter early exit is preserved while devices run in
            # parallel (no cross-device lockstep — no collectives inside)
            from jax import shard_map

            axis = mesh.axis_names[0]
            ndev = mesh.shape[axis]
            if chunk % ndev:
                raise ValueError(f"chunk {chunk} must divide over {ndev} devices")
            if (chunk // ndev) % g:
                raise ValueError(
                    f"per-device slice {chunk // ndev} must divide into "
                    f"groups of {g}")

            self._batched = jax.jit(
                shard_map(seq, mesh=mesh,
                          in_specs=(P(), P(axis)), out_specs=P(axis))
            )
        elif scan:
            if chunk % g:
                raise ValueError(f"chunk {chunk} must divide into groups of {g}")
            self._batched = jax.jit(seq)
        else:
            self._batched = jax.jit(jax.vmap(one, in_axes=(None, 0)))
        # numevals/chunk_evals/chunk_meta/retcode/block_certificates are
        # initialized at the top of __init__ (shared with the host-mode
        # early return).  Conventions: `chunk_evals` gets one entry per
        # dispatched warm chunk counting REAL solves only (pad lanes — and
        # with block>1, pure-pad blocks — are excluded, the same convention
        # as `numevals`); `chunk_meta` gets one `(x_first, x_last,
        # seed_distance)` per chunk (seed_distance = |x_first − chosen seed
        # key|, inf on a cold chunk; with a mesh, the max over the per-device
        # chains).

    def _select_seed(self, x0, extra=None):
        """Seed pool for a chunk starting at ``x0``: the nearest-omega
        snapshot among the carried pool, the library, and the optional
        ``extra=(key, pool)`` candidate (a per-device chain carry); cold
        ``pool0`` if none exists yet.  Host-side only — no device sync."""
        best, best_d = None, np.inf
        if extra is not None:
            best, best_d = extra[1], abs(x0 - extra[0])
        if self._pool is not None and self._pool_x is not None \
                and abs(x0 - self._pool_x) < best_d:
            best, best_d = self._pool, abs(x0 - self._pool_x)
        for xk, pk in self._pool_lib:
            d = abs(x0 - xk)
            if d < best_d:
                best, best_d = pk, d
        if best is None:
            return (self._pool if self._pool is not None else self._pool0,
                    np.inf)
        return best, best_d

    def _lib_insert(self, x, pool):
        """Insert an (omega, pool) snapshot, keeping the library spread: at
        capacity, the entry nearest in omega to the newcomer is replaced."""
        if self._warm_lib <= 0:
            return
        if len(self._pool_lib) < self._warm_lib:
            self._pool_lib.append((x, pool))
            return
        j = min(range(len(self._pool_lib)),
                key=lambda k: abs(self._pool_lib[k][0] - x))
        self._pool_lib[j] = (x, pool)

    def __call__(self, xs):
        if self._host_mode is not None:
            # host-only algorithms (pole nests): same entry point, pipelined
            # through host threads — uniform sweeps for every algorithm
            # (reference batchsolve, src/interfaces.jl:210-218)
            prob, alg, abstol, reltol, nthreads = self._host_mode
            xs_list = list(np.asarray(xs))
            if not xs_list:
                self.retcode = True
                return np.zeros((0,))
            sols = _host_pipelined_sweep(prob, alg, xs_list, abstol, reltol,
                                         nthreads)
            self.retcode = all(bool(s.retcode) for s in sols)
            self.numevals += sum(int(s.numevals) for s in sols)
            return np.stack([np.asarray(s.u) for s in sols])
        xs = jnp.asarray(xs)
        n = xs.shape[0]
        blk = self.block
        if n == 0:
            # np.concatenate over zero chunks raises, and the last-value pad
            # below indexes xs[-1]; an empty sweep is simply empty — with the
            # dtype/trailing shape the real solve would produce
            spec = jax.eval_shape(
                self._batched, self._consts,
                jax.ShapeDtypeStruct((self.chunk,), xs.dtype))[0]
            self.retcode = True
            return np.zeros((0,) + spec.shape[1:], spec.dtype)
        c = self.chunk
        npad = -(-n // c) * c
        # pad with the last real value, not 0.0: a padded adaptive solve at
        # an arbitrary out-of-window parameter can be arbitrarily expensive
        xp = jnp.full((npad,), xs[n - 1], xs.dtype).at[:n].set(xs)
        if self.mesh is not None and self._batched_warm is None:
            sharding = NamedSharding(self.mesh, P(self.mesh.axis_names[0]))
            xp = jax.device_put(xp, sharding)
        blk_outs = []   # per-chunk (conv_blocks, ne_blocks) when blk > 1
        blk_masks = []  # real-block masks aligned with blk_outs
        if self._batched_warm is not None:
            # sequential chain(s): each chunk's final pool seeds the next,
            # and pools persist across calls (refinement frontiers revisit
            # nearby parameters).  Solves run in SORTED parameter order so
            # every seed comes from the nearest neighbor (hchebinterp
            # frontiers jump across panels); results un-sort below.  With a
            # mesh, the sorted lanes split into ndev contiguous regions and
            # each device runs its own chain (dispatch i advances every
            # chain by chunk/ndev solves).
            xp_np = np.asarray(xp)
            perm = np.argsort(xp_np, kind="stable")
            is_real_s = perm < n  # pad mask in sorted space
            sharded = self._batched_warm_sharded is not None
            if sharded:
                ndev = int(self.mesh.shape[self.mesh.axis_names[0]])
                s = c // ndev
                nreg = npad // ndev
                lay = [(np.arange(ndev)[:, None] * nreg + i * s
                        + np.arange(s)[None, :]).ravel()
                       for i in range(npad // c)]
                dev_carry = getattr(self, "_dev_carry", None)
                if dev_carry is None or len(dev_carry) != ndev:
                    dev_carry = [None] * ndev  # (x_last, pool) per chain
            else:
                lay = [np.arange(i, i + c) for i in range(0, npad, c)]
            xp_s = xp[perm]
            xs_np = xp_np[perm]
            tmap = jax.tree_util.tree_map
            outs_s = []
            hnes = []
            for idx in lay:
                if sharded:
                    seeds, dists = [], []
                    for d in range(ndev):
                        sd, dd = self._select_seed(float(xs_np[idx[d * s]]),
                                                   extra=dev_carry[d])
                        seeds.append(sd)
                        dists.append(dd)
                    seed = tmap(lambda *vs: jnp.stack(vs), *seeds)
                    o, pool = self._batched_warm_sharded(seed, xp_s[idx])
                    if self._harvest_sharded is not None:
                        xl_d = xp_s[idx[(np.arange(ndev) + 1) * s - 1]]
                        pool, h = self._harvest_sharded(xl_d, pool)
                        hnes.append(h)
                    for d in range(ndev):
                        pd = tmap(lambda v, d=d: v[d], pool)
                        xl = float(xs_np[idx[(d + 1) * s - 1]])
                        dev_carry[d] = (xl, pd)
                        self._lib_insert(xl, pd)
                    # the global carry follows the maximum-omega chain
                    self._pool_x, self._pool = dev_carry[-1]
                    self.chunk_meta.append((float(xs_np[idx[0]]),
                                            float(xs_np[idx[-1]]),
                                            float(np.max(dists))))
                else:
                    # seed from the nearest-omega snapshot (carried pool or
                    # library) — keys are host floats, selection never syncs
                    seed, seed_d = self._select_seed(float(xs_np[idx[0]]))
                    o, pool = self._batched_warm(self._consts, seed,
                                                 xp_s[idx])
                    if self._harvest is not None:
                        # refresh the carried inner-level partition at this
                        # chunk's final parameter (the next chunk's
                        # neighbor); keep the eval count as a device ref —
                        # float(h) here would block on the harvest each
                        # round and serialize the chunk dispatch-ahead
                        pool, h = self._harvest(xp_s[idx[-1]], pool)
                        hnes.append(h)
                    xl = float(xs_np[idx[-1]])
                    self._lib_insert(xl, pool)
                    self._pool, self._pool_x = pool, xl
                    self.chunk_meta.append((float(xs_np[idx[0]]), xl, seed_d))
                if blk > 1:
                    blk_outs.append((o[3], o[4]))
                    blk_masks.append(is_real_s[idx].reshape(-1, blk).any(1))
                    o = o[:3]
                outs_s.append(o)
            if sharded:
                self._dev_carry = dev_carry
            hne = float(np.sum([np.asarray(h) for h in hnes])) if hnes else 0
            # per-chunk eval telemetry for diagnosing mid-seed staleness
            # across a long sweep — materialized AFTER the loop so chunk
            # dispatch stays async (an eager sum would sync per chunk and
            # forfeit the dispatch-ahead that amortizes the host round
            # trip).  REAL solves only: pad lanes (and with block>1,
            # pure-pad blocks) are excluded, matching `numevals`.
            if blk > 1:
                self.chunk_evals.extend(
                    float(np.sum(np.asarray(b[1])[m]))
                    for b, m in zip(blk_outs, blk_masks))
            else:
                self.chunk_evals.extend(
                    float(np.sum(np.asarray(o[2])[is_real_s[idx]]))
                    for o, idx in zip(outs_s, lay))
            self.numevals += int(hne)
            # un-sort: concat follows `lay` order; map to sorted positions,
            # then back to the caller's order
            order = np.concatenate(lay)
            inv_order = np.empty_like(order)
            inv_order[order] = np.arange(npad)
            inv = np.empty_like(perm)
            inv[perm] = np.arange(npad)
            cat = tmap(
                lambda *vs: np.concatenate(
                    [np.asarray(v) for v in vs])[inv_order][inv],
                *outs_s)
            outs = [cat]
        else:
            outs = [self._batched(self._consts, xp[i: i + c])
                    for i in range(0, npad, c)]
            if blk > 1:
                for i, o in enumerate(outs):
                    blk_outs.append((o[3], o[4]))
                    # lanes i*c + j*blk .. are real iff the block start < n
                    starts = i * c + np.arange(c // blk) * blk
                    blk_masks.append(starts < n)
                outs = [o[:3] for o in outs]
        us = np.concatenate([np.asarray(o[0]) for o in outs])[:n]
        convs = np.concatenate([np.asarray(o[1]) for o in outs])[:n]
        nes = np.concatenate([np.asarray(o[2]) for o in outs])[:n]
        # pad lanes duplicate the last real parameter — exclude them from
        # both the certificate and the evaluation count
        self.retcode = bool(np.all(convs))
        if blk > 1:
            # a block is ONE solve: count each real block's evals exactly
            # once (the per-lane `nes` column is the even split and loses
            # the tail of a trimmed final block); surface the per-block
            # certificates in solve order (sorted order for warm sweeps)
            bc = np.concatenate([np.asarray(b[0]) for b in blk_outs])
            bn = np.concatenate([np.asarray(b[1]) for b in blk_outs])
            bm = np.concatenate(blk_masks)
            self.block_certificates = (bc[bm], bn[bm].astype(np.int64))
            self.numevals += int(np.sum(bn[bm]))
        else:
            self.numevals += int(np.sum(nes))
        return us
