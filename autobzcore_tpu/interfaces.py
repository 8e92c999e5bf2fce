"""Problem/solver interface (the SciML-like core runtime).

Native equivalent of reference ``src/interfaces.jl``: ``IntegralProblem``
(``:34``), ``init -> IntegralCache`` (``:78``), ``solve`` (``:106``),
``solve_`` (= ``solve!``, ``:116``), ``IntegralSolution`` (``:120``),
``IntegralSolver`` functor (``:142``), and ``batchsolve`` parameter sweeps
(``:234``).

The cache mechanism serves the same purpose as the reference's
(``src/interfaces.jl:50-62``): algorithm-specific precomputation — here
compiled XLA executables and device-resident rule data — is built once in
``init`` and reused across re-solves at new parameters ``p``.  JAX's
trace-once/compile-once model replaces the reference's type-probing cache
construction; re-solves with same-shaped ``p`` never retrace.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np

from .domains import interval_or_cube
from .parameters import MixedParameters, NullParameters, merge_parameters, ParameterIntegrand


@dataclass
class IntegralSolution:
    """``u``: the integral; ``resid``: error estimate (or None); ``retcode``:
    converged flag; ``numevals``: integrand evaluations (-1 = not counted,
    reference ``src/interfaces.jl:126``)."""

    u: Any
    resid: Any
    retcode: bool
    numevals: int = -1


class IntegralProblem:
    """``IntegralProblem(f, dom[, p])`` / ``(f, a, b[, p])``: integrand
    ``f(x, p)``, domain, parameters (reference ``src/interfaces.jl:34``)."""

    def __init__(self, f, *args):
        # forms: (f, dom), (f, dom, p), (f, a, b), (f, a, b, p)
        if len(args) == 1:
            dom, p = args[0], NullParameters()
        elif len(args) == 2:
            if _is_domainlike(args[0]):
                dom, p = args
            else:
                dom, p = interval_or_cube(args[0], args[1]), NullParameters()
        elif len(args) == 3:
            dom, p = interval_or_cube(args[0], args[1]), args[2]
        else:
            raise TypeError("IntegralProblem(f, dom[, p]) or IntegralProblem(f, a, b[, p])")
        self.f = f
        self.dom = dom
        self.p = p


def _is_domainlike(x):
    from .domains import Domain

    if isinstance(x, Domain):
        return True
    # BZ and iterated-limits domains duck-type via `ndim`
    return hasattr(x, "ndim") and not isinstance(x, (int, float, complex, np.ndarray)) and not hasattr(x, "shape")


_ALLOWED_KWARGS = ("abstol", "reltol", "maxiters")


def checkkwargs(kwargs):
    for key in kwargs:
        if key not in _ALLOWED_KWARGS:
            raise ValueError(f"keyword {key} unrecognized (allowed: {_ALLOWED_KWARGS})")


class IntegralCache:
    """Reusable solve state: problem data + algorithm cacheval (compiled
    executables, device rules) + solver kwargs (``src/interfaces.jl:50``)."""

    def __init__(self, f, dom, p, alg, cacheval, kwargs):
        self.f = f
        self.dom = dom
        self.p = p
        self.alg = alg
        self.cacheval = cacheval
        self.kwargs = kwargs


def init(prob: IntegralProblem, alg, **kwargs) -> IntegralCache:
    """Build a reusable (compiled) cache for the problem/algorithm pair;
    kwargs are ``abstol``/``reltol``/``maxiters`` (``src/interfaces.jl:78``)."""
    checkkwargs(kwargs)
    f, p = _resolve_parameters(prob.f, prob.p)
    cacheval = alg.init_cacheval(f, prob.dom, p)
    return IntegralCache(f, prob.dom, p, alg, cacheval, kwargs)


def solve(prob: IntegralProblem, alg, **kwargs) -> IntegralSolution:
    """One-shot ``init`` + ``solve_`` (reference ``src/interfaces.jl:106``)."""
    return solve_(init(prob, alg, **kwargs))


def solve_(cache: IntegralCache) -> IntegralSolution:
    """``solve!`` — compute the solution from an initialized cache."""
    sol = cache.alg.do_solve(cache.f, cache.dom, cache.p, cache.cacheval, **cache.kwargs)
    from .utils.tree import host_complex_safe

    # complex device results come back as real pairs rejoined on the host
    # (utils.tree.host_complex_safe; no-op on CPU)
    return IntegralSolution(
        host_complex_safe(sol.u), host_complex_safe(sol.resid), sol.retcode, sol.numevals
    )


class IntegralSolver:
    """Functor: ``solver(p) -> u`` (reference ``src/interfaces.jl:142-196``).

    For :class:`ParameterIntegrand`/``FourierIntegrand`` integrands the call
    syntax is ``solver(*args, **kwargs)`` and the parameters are merged with
    the integrand's preset ones (``src/parameters.jl:107-111``).
    """

    def __init__(self, f, *args, **kwargs):
        if isinstance(f, IntegralProblem) and len(args) == 1:
            args = (f.dom, args[0])
            f = f.f
        if len(args) == 3:
            a, b, alg = args
            dom = interval_or_cube(a, b)
        elif len(args) == 2:
            dom, alg = args
        else:
            raise TypeError("IntegralSolver(f, dom, alg) or IntegralSolver(f, a, b, alg)")
        checkkwargs(kwargs)
        self.f = f
        self.dom = dom
        self.alg = alg
        self.kwargs = kwargs
        self.cache = None

    @classmethod
    def from_problem(cls, prob: IntegralProblem, alg, **kwargs):
        return cls(prob.f, prob.dom, alg, **kwargs)

    def solve_p(self, p) -> IntegralSolution:
        if self.cache is None:
            prob = IntegralProblem(self.f, self.dom, p)
            self.cache = init(prob, self.alg, **self.kwargs)
            return solve_(self.cache)
        _, p2 = _resolve_parameters(self.f, p)
        self.cache.p = p2
        return solve_(self.cache)

    def __call__(self, *args, **kwargs):
        if _takes_mixed_parameters(self.f):
            p = MixedParameters(*args, **kwargs)
        else:
            if kwargs or len(args) > 1:
                raise TypeError("plain integrands take a single parameter argument")
            p = args[0] if args else NullParameters()
        return self.solve_p(p).u


def _takes_mixed_parameters(f):
    from .fourier import FourierIntegrand

    return isinstance(f, (ParameterIntegrand, FourierIntegrand))


def _resolve_parameters(f, p):
    """Merge integrand-preset parameters with solve-time ones (the reference's
    ``remake_cache`` hooks, ``src/parameters.jl:102-105``)."""
    if _takes_mixed_parameters(f):
        return f.with_parameters(p)
    return f, p


def batchsolve(solver: IntegralSolver, ps, T=None, callback=None, nthreads=1):
    """Evaluate ``solver`` at each parameter in ``ps`` (reference
    ``src/interfaces.jl:234``).  The compiled cache is shared across the sweep,
    so only the first call pays compilation.  Returns a list (or object array
    matching ``ps`` shape) of ``u`` values.

    ``T`` is accepted for reference API parity (the result eltype used there
    to preallocate the output array, ``src/interfaces.jl:234``) and ignored:
    dtypes come from the solves themselves.

    ``nthreads > 1`` pipelines the solves across host threads over one shared
    read-only cache — the reference's ``batchsolve`` is itself threaded
    (``Threads.@threads`` over parameter chunks with per-thread solver
    replicas, ``src/interfaces.jl:210-218``); here JAX's functional model
    makes the replicas unnecessary.  ``callback`` still fires **in index
    order** (out-of-order completions buffer), so incremental persistence
    keeps its resume semantics.

    For device-parallel sweeps over numeric parameter arrays see
    :func:`autobzcore_tpu.parallel.sweep.sweep_solve`.
    """
    arr = isinstance(ps, np.ndarray) and ps.dtype == object
    items = list(ps.reshape(-1)) if arr else list(ps)
    out = []
    if nthreads is not None and int(nthreads) > 1:
        from .parallel.sweep import threaded_solve_iter

        prob = IntegralProblem(solver.f, solver.dom)
        for i, sol, wall in threaded_solve_iter(
            prob, solver.alg, items, nthreads=nthreads, **solver.kwargs
        ):
            if callback is not None:
                callback(solver, i, i + 1, items[i], sol, wall)
            out.append(sol.u)
    else:
        for i, p in enumerate(items):
            t0 = time.time()
            sol = solver.solve_p(p)
            if callback is not None:
                callback(solver, i, i + 1, p, sol, time.time() - t0)
            out.append(sol.u)
    if arr:
        res = np.empty(len(out), dtype=object)
        for i, u in enumerate(out):
            res[i] = u
        return res.reshape(ps.shape)
    return out
