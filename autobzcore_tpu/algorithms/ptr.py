"""Periodic trapezoidal rule algorithms over a lattice Basis domain.

``MonkhorstPack`` is the native equivalent of the reference's fixed-npt PTR
(``src/algorithms.jl:342-380``); ``AutoSymPTRJL`` of the p-adaptive
``autosymptr`` driver (``src/algorithms.jl:393-432``).

Design: the rule is a dense masked reduction.  For symmetric BZs
the representative points and orbit weights are host-precomputed
(:func:`ops.symptr.symptr_rule`) and baked into the program as static gather
indices, so the integrand is evaluated only on the irreducible wedge — a
static-shape batch that maps straight onto vmapped device kernels.  AutoPTR
refinement is a host-driven ladder of compiled fixed-npt rules with a
Richardson-style error estimate from the previous rule (``keepmost``
semantics, reference ``src/algorithms.jl:400,429``); each rung's compiled rule
and any Fourier-series evaluations are cached in the cacheval and reused
across re-solves at new parameters — the reference's persistent AutoPTR rule
cache (``src/algorithms.jl:413``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..domains import Basis
from ..interfaces import IntegralSolution
from ..ops.symptr import ptr_points, symptr_rule
from ..utils.tree import tree_norm, tree_sub, tree_weighted_sum
from ..wrappers import batch_eval_fn
from .base import IntegralAlgorithm, effective_tolerances


def _frac_nodes(npt, d):
    """Full tensor grid of fractional coordinates, shape (npt^d, d)."""
    u = ptr_points(npt)
    grids = np.meshgrid(*([u] * d), indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=-1)


def build_ptr_run(f, dom: Basis, npt: int, syms):
    """Compile a fixed-npt PTR sum for integrand ``f`` over ``dom``.

    Returns (run(p) -> value, numevals).  With ``syms`` the value is the
    IBZ-scaled sum vol/(npt^d nsyms) * sum w_i f(x_i) (symmetrization to the
    full zone happens in the BZ layer, reference ``src/brillouin.jl:96-113``).
    """
    from ..fourier import FourierIntegrand

    d = dom.ndim
    B = jnp.asarray(dom.B)
    vol = dom.volume

    if syms is None:
        frac = _frac_nodes(npt, d)
        weights = np.full(frac.shape[0], 1.0)
        nsyms = 1
    else:
        reps, weights = symptr_rule(npt, d, syms)
        frac = reps.astype(np.float64) / npt
        nsyms = len(syms)

    scale = vol / (npt**d * nsyms)
    numevals = frac.shape[0]

    if isinstance(f, FourierIntegrand):
        # specialized rule: evaluate the Fourier series at all rule points once
        # (device, dim-by-dim contraction) and reuse across re-solves — the
        # reference's FourierPTR/FourierMonkhorstPack stored-series design
        # (src/fourier.jl:127-130,210-214).  Rule data (points, weights,
        # stored values) flows as jit ARGUMENTS: as closed-over constants the
        # MB-scale arrays bloat the HLO shipped to remote compile helpers
        # (measured 365-520 s per compile at npt=100, scaling with rule size).
        svals = f.series_values_on_grid(npt, frac if syms is not None else None)
        user = f.user_batch_fn()
        consts = (jnp.asarray(frac) @ B.T, jnp.asarray(weights), svals)

        @jax.jit
        def run_c(consts, p):
            xs, w, sv = consts
            fx = user(xs, sv, p)
            return jax.tree_util.tree_map(
                lambda v: scale * v, tree_weighted_sum(w, fx, axis=0)
            )

        def runner(p):
            return run_c(consts, p)

        return runner, numevals, run_c, consts

    batch_f = batch_eval_fn(f, in_ndim=1)
    consts = (jnp.asarray(frac) @ B.T, jnp.asarray(weights))  # Cartesian nodes

    @jax.jit
    def run_c(consts, p):
        nodes, w = consts
        fx = batch_f(nodes, p)
        return jax.tree_util.tree_map(
            lambda v: scale * v, tree_weighted_sum(w, fx, axis=0)
        )

    def runner(p):
        return run_c(consts, p)

    return runner, numevals, run_c, consts


class MonkhorstPack(IntegralAlgorithm):
    """Fixed-npt periodic trapezoidal rule over a lattice ``Basis``; with
    ``syms`` the sum runs over host-precomputed weighted representatives
    (``src/algorithms.jl:342``)."""

    def __init__(self, npt=50, syms=None):
        self.npt = npt
        self.syms = syms

    def init_cacheval(self, f, dom, p):
        run, numevals, run_c, consts = build_ptr_run(f, dom, self.npt, self.syms)
        return {"run": run, "numevals": numevals, "run_c": run_c, "consts": consts}

    def do_solve(self, f, dom, p, cacheval, abstol=None, reltol=None, maxiters=None):
        val = cacheval["run"](p)
        return IntegralSolution(val, None, True, cacheval["numevals"])

    def solve_fn(self, cacheval):
        run = cacheval["run"]
        ne = cacheval["numevals"]

        def fn(p, atol, rtol):
            return run(p), jnp.zeros(()), jnp.asarray(True), jnp.asarray(ne)

        return fn

    def solve_fn_consts(self, cacheval):
        """(fn(consts, p, atol, rtol) -> (u, resid, converged, numevals),
        consts): rule data as runtime arguments so enclosing jits (sweep
        batches) don't capture MB-scale constants — see build_ptr_run."""
        run_c = cacheval["run_c"]
        ne = cacheval["numevals"]

        def fn(consts, p, atol, rtol):
            return (run_c(consts, p), jnp.zeros(()), jnp.asarray(True),
                    jnp.asarray(ne))

        return fn, cacheval["consts"]


class AutoSymPTRJL(IntegralAlgorithm):
    """p-adaptive PTR: refine npt until the change between rules meets the
    tolerance (reference ``autosymptr``, ``src/algorithms.jl:393-432``).

    The refinement schedule honors the reference's ``(a, n0, dn, nmin, nmax)``
    parameters.  The upstream AutoSymPTR.jl use sites show the stored rule
    definition carries an *initial npt* and an *additive increment*
    (``nextrule`` builds ``npt + Δn``, ``src/fourier.jl:309-321``); with ``a``
    the integrand's localization ratio (period / feature width, e.g. ``1/eta``
    in lattice units):

    - initial ``npt0 = clamp(round(n0 / a), nmin, nmax)`` — ``n0`` points per
      localization feature;
    - increment ``dnpt = max(1, round(exp(dn) / a))`` — PTR error for analytic
      integrands decays exponentially in ``npt * a``, so a fixed additive step
      reduces the error by a constant factor per rung (``dn = log(10)``
      default: one decade per rung at ``a = 1``).

    ``keepmost`` controls the error-estimate window: the residual compares the
    newest rule against the oldest of the last ``keepmost`` iterates
    (``keepmost=2``, the default, is the successive difference).

    With ``bz`` set (the BZ layer's AutoPTR does this), every rung's value is
    symmetrized to the full zone *before* the convergence test — the
    reference's ``SymmetricRule`` in-loop symmetrization
    (``src/brillouin.jl:116-144``) — and the returned value is already
    symmetrized (``symmetrized_output``).
    """

    def __init__(self, norm=tree_norm, a=1.0, nmin=50, nmax=1000, n0=6.0,
                 dn=np.log(10.0), keepmost=2, syms=None, bz=None):
        self.norm = norm
        self.a = a
        self.nmin = nmin
        self.nmax = nmax
        self.n0 = n0
        self.dn = dn
        self.keepmost = max(2, int(keepmost))
        self.syms = syms
        self.bz = bz

    @property
    def symmetrized_output(self):
        return self.bz is not None

    def npt_ladder(self):
        npt0 = int(np.clip(round(self.n0 / self.a), self.nmin, self.nmax))
        dnpt = max(1, int(round(np.exp(self.dn) / self.a)))
        ladder = [npt0]
        while ladder[-1] < self.nmax:
            ladder.append(min(ladder[-1] + dnpt, self.nmax))
        return ladder

    def _symmetrizer(self, f):
        if self.bz is None:
            return lambda v: v
        from ..brillouin import symmetrize

        return lambda v: symmetrize(f, self.bz, v)

    def init_cacheval(self, f, dom, p):
        return {"rules": {}, "f": f, "dom": dom}

    def do_solve(self, f, dom, p, cacheval, abstol=None, reltol=None, maxiters=None):
        atol, rtol = effective_tolerances(abstol, reltol)
        rules = cacheval["rules"]
        sym = self._symmetrizer(f)
        window = []  # last `keepmost` symmetrized iterates
        total_evals = 0
        val = None
        err = None
        for npt in self.npt_ladder():
            if npt not in rules:
                rules[npt] = build_ptr_run(f, dom, npt, self.syms)[:2]
            run, ne = rules[npt]
            val = sym(run(p))
            total_evals += ne
            if window:
                err = self.norm(tree_sub(val, window[0]))
                tol = max(atol, rtol * float(self.norm(val)))
                if float(err) <= tol:
                    return IntegralSolution(val, err, True, total_evals)
            if maxiters is not None and total_evals >= maxiters:
                break
            window.append(val)
            if len(window) >= self.keepmost:
                window.pop(0)
        return IntegralSolution(val, err, False, total_evals)
