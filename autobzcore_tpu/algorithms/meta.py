"""Meta-algorithms: AbsoluteEstimate and EvalCounter.

Native equivalents of reference ``src/algorithms.jl:628-691``.  The eval
counter needs no integrand wrapping here: every adaptive driver carries its
evaluation count in the loop state, so ``EvalCounter`` simply surfaces it.
"""
from __future__ import annotations

from ..interfaces import IntegralSolution
from ..utils.tree import tree_norm
from .base import IntegralAlgorithm, effective_tolerances


class AbsoluteEstimate(IntegralAlgorithm):
    """Two-phase: cheap estimate under ``est_alg`` (with the kwargs given at
    construction), then ``abs_alg`` at ``abstol=max(abstol, reltol*norm(I))``,
    ``reltol=0`` (reference ``src/algorithms.jl:628-653``)."""

    def __init__(self, est_alg, abs_alg, norm=tree_norm, **kwargs):
        from ..interfaces import checkkwargs

        checkkwargs(kwargs)
        self.est_alg = est_alg
        self.abs_alg = abs_alg
        self.norm = norm
        self.kwargs = kwargs

    def init_cacheval(self, f, dom, p):
        return {
            "est": self.est_alg.init_cacheval(f, dom, p),
            "abs": self.abs_alg.init_cacheval(f, dom, p),
        }

    def do_solve(self, f, dom, p, cacheval, abstol=None, reltol=None, maxiters=None):
        import numpy as np

        sol = self.est_alg.do_solve(f, dom, p, cacheval["est"], **self.kwargs)
        val = float(self.norm(sol.u))
        rtol = np.sqrt(np.finfo(np.float64).eps) if reltol is None else reltol
        atol = max(0.0 if abstol is None else abstol, rtol * val)
        out = self.abs_alg.do_solve(
            f, dom, p, cacheval["abs"], abstol=atol, reltol=0.0, maxiters=maxiters
        )
        # both phases evaluate the integrand: count both, matching the
        # traced solve_fn_consts path (uncounted phases keep -1 semantics)
        if out.numevals >= 0 and sol.numevals >= 0:
            out = IntegralSolution(out.u, out.resid, out.retcode,
                                   out.numevals + sol.numevals)
        return out

    def solve_fn_consts(self, cacheval):
        """Traced two-phase solve for batched sweeps (``sweep_solve``/
        ``SweepSolver``): the estimate phase runs inside the same program and
        its norm feeds the absolute phase's tolerance as a traced scalar —
        so ``PTR_IAI``/``AutoPTR_IAI`` parameter sweeps batch like any other
        algorithm."""
        import jax.numpy as jnp

        from .base import effective_tolerances

        def sub(alg, cv):
            sfc = getattr(alg, "solve_fn_consts", None)
            if sfc is not None:
                got = sfc(cv)
                if got is not None:
                    return got
            fn = alg.solve_fn(cv)
            return (lambda consts, p, atol, rtol: fn(p, atol, rtol)), ()

        est_fn, est_consts = sub(self.est_alg, cacheval["est"])
        abs_fn, abs_consts = sub(self.abs_alg, cacheval["abs"])
        est_atol, est_rtol = effective_tolerances(
            self.kwargs.get("abstol"), self.kwargs.get("reltol")
        )
        norm = self.norm

        import numpy as np

        sqrt_eps = float(np.sqrt(np.finfo(np.float64).eps))

        def fn(consts, p, atol, rtol):
            ec, ac = consts
            u_est, _, _, ne_est = est_fn(ec, p, est_atol, est_rtol)
            # match do_solve (and the reference, src/algorithms.jl:649-650):
            # an unset reltol defaults to sqrt(eps), not zero.  Sweep drivers
            # collapse None -> 0.0 before tracing, so rtol == 0 here means
            # "unset" (an explicit reltol=0.0 also gets the sqrt(eps) floor —
            # the traced path cannot tell the two apart).
            rtol_eff = jnp.where(rtol > 0, rtol, sqrt_eps)
            atol2 = jnp.maximum(atol, rtol_eff * norm(u_est))
            u, e, conv, ne = abs_fn(ac, p, atol2, jnp.zeros(()))
            # both phases evaluate the integrand — count both (the same
            # total the eager do_solve path reports)
            return u, e, conv, ne + ne_est

        return fn, (est_consts, abs_consts)


class EvalCounter(IntegralAlgorithm):
    """Surface the wrapped algorithm's integrand evaluation count in
    ``sol.numevals`` (reference ``src/algorithms.jl:662-691``)."""

    def __init__(self, alg):
        self.alg = alg

    def init_cacheval(self, f, dom, p):
        return self.alg.init_cacheval(f, dom, p)

    def do_solve(self, f, dom, p, cacheval, **kwargs):
        return self.alg.do_solve(f, dom, p, cacheval, **kwargs)

    def solve_fn(self, cacheval):
        # sweeps count evaluations natively; delegate so EvalCounter-wrapped
        # algorithms batch like their wrapped algorithm
        return self.alg.solve_fn(cacheval)

    def solve_fn_consts(self, cacheval):
        sfc = getattr(self.alg, "solve_fn_consts", None)
        return None if sfc is None else sfc(cacheval)
