"""Nested (iterated) adaptive integration — the IAI backbone.

Native equivalent of the reference's ``NestedQuad`` meta-algorithm
(``src/algorithms.jl:450-612``) and its Fourier-specialized path
(``src/fourier.jl:394-510``).

Structure: each nesting level is a fixed-shape adaptive solver
(interval pool in ``lax.while_loop``); the inner level's solve is ``vmap``-ed
over the outer level's node panel, so the whole d-dimensional adaptive
recursion compiles to one XLA program with static shapes.  Irregular limits
(wedges, polytope slices) enter as traced segment endpoints.  The per-level
tolerance division matches the reference: an inner solve at outer node ``x``
gets ``abstol / len(inner segments)`` (``src/algorithms.jl:545,557,567``).

Integrand state that can be *contracted* one dimension at a time — the Fourier
workspace of reference ``src/fourier.jl:478`` — is threaded through the
recursion as a "carrier": fixing the outer coordinate contracts the series
coefficient tensor once per node, amortized across the whole inner panel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..interfaces import IntegralSolution
from ..limits import IteratedLimits
from ..ops.adaptive import fixed_rule_eval, gk_adaptive, gk_adaptive_guided
from ..utils.tree import tree_norm
from ..wrappers import batch_eval_fn
from .base import IntegralAlgorithm, effective_tolerances
from .gk import QuadGKJL
from .quadrature import QuadratureFunction


def _downcast_params(p):
    """f32/c64 copy of a parameter pytree for the guided search tier (keeps
    f64 parameters from promoting the c64 guide evaluations back to f64)."""
    def cast(v):
        try:
            v = jnp.asarray(v)
        except TypeError:
            return v
        if jnp.issubdtype(v.dtype, jnp.floating):
            return v.astype(jnp.float32)
        if jnp.issubdtype(v.dtype, jnp.complexfloating):
            return v.astype(jnp.complex64)
        return v

    return jax.tree_util.tree_map(cast, p)


def assemble_points(xs, coords):
    """Build (B, d) points: innermost variable is ``xs``; ``coords`` holds the
    already-fixed outer coordinates, outermost first."""
    cols = [xs] + [jnp.broadcast_to(c, xs.shape) for c in reversed(coords)]
    return jnp.stack(cols, axis=-1)


# probe abscissae (fractions of each level's span): off-center and
# symmetry-breaking so lattice-symmetric cancellations don't hide noise
_PROBE_TS = (0.1234, 0.3618, 0.6287, 0.8791)


def _real_leaf_pairs(t32, tS):
    """Aligned (f64-upcast search-tier, accurate-tier) real leaf pairs.

    Complex leaves expand to (re, im) in place, matching the order a
    ``SplitComplex`` pytree flattens its own (re, im) children — so the c64
    guide tree and the split-f64 tree align leafwise even though their
    complex representations differ."""
    def expand(tree):
        out = []
        for x in jax.tree_util.tree_leaves(tree):
            x = jnp.asarray(x)
            if jnp.iscomplexobj(x):
                out.extend([jnp.real(x), jnp.imag(x)])
            else:
                out.append(x)
        return out

    a, b = expand(t32), expand(tS)
    if len(a) != len(b):
        raise ValueError(
            "guided noise probe: search- and accurate-tier results do not "
            "align leafwise; pass an explicit guide_rfloor instead of 'auto'"
        )
    return list(zip(a, b))


def _probe_noise_rfloor(lims, c32, cS, p32, p, safety=4.0, lo=1e-7, hi=1e-2):
    """Measure the guided search tier's relative eval noise at solve time.

    Evaluates BOTH integrand tiers at a handful of probe points per nest
    level (``len(_PROBE_TS)^d`` leaf evaluations each) and returns
    ``safety * sum|f32 - f64| / sum|f64|`` — a plug-in estimate of the L1
    noise-to-mass ratio, which is exactly the scale at which the c64 search's
    ``|vk - vg|`` error estimate bottoms out (``err_floor ~ r * int|f|``, see
    ``ops/adaptive.gk_adaptive``).  This replaces the fixed ``guide_rfloor``
    constant that was calibrated on the SrVO3 anchor (measured p99 relative
    noise 2.7e-5): noise amplification scales as ``||H||/eta`` and is
    problem-dependent, so a measured floor is portable where the constant
    either wastes a saturating search or stops early.
    ``safety`` biases high — an overestimated floor hands more work to the
    split polish phase (correct, mildly slower); an underestimate falls back
    to the ``stall_patience`` detector.
    """
    def rec(lims, c32, cS, coords):
        segs = lims.outer_segments()
        a, b = segs[0], segs[-1]
        ts = jnp.asarray(_PROBE_TS, segs.dtype)
        xs = a + (b - a) * ts
        if lims.ndim == 1:
            v32 = c32.eval_batch(xs, coords, p32)
            vS = cS.eval_batch(xs, coords, p)
            num = jnp.zeros((), jnp.float64)
            den = jnp.zeros((), jnp.float64)
            for x32, xS in _real_leaf_pairs(v32, vS):
                xS64 = xS.astype(jnp.float64)
                num += jnp.sum(jnp.abs(x32.astype(jnp.float64) - xS64))
                den += jnp.sum(jnp.abs(xS64))
            return num, den

        def one(x):
            return rec(lims.fix(x), c32.fix(x), cS.fix(x), coords + (x,))

        nums, dens = jax.vmap(one)(xs)
        return jnp.sum(nums), jnp.sum(dens)

    num, den = rec(lims, c32, cS, ())
    r = safety * num / jnp.maximum(den, jnp.finfo(jnp.float64).tiny)
    return jnp.clip(r, lo, hi)


def _coarsen_partition(part, breakpoints, tol):
    """Error-guided sibling coarsening of a warm-start seed partition.

    ``part`` is the previous solve's surviving outer partition as an
    ``(n, 3)`` array of ``(a, b, E)`` rows (sorted, contiguous).  Adjacent
    equal-width pairs whose stored errors sum far below their equidistributed
    tolerance share merge into their parent — so fine structure that the NEW
    parameter no longer needs decays geometrically across a warm-started
    chain instead of accumulating monotonically (intervals otherwise only
    ever split; over a long omega sweep the partition would grow into the
    union of every feature it ever resolved).  Load-bearing intervals carry
    errors near their share and never merge, so the equilibrium seed stays
    within a small factor of the minimal partition.  Merging is always
    VALID (any contiguous cover is a legal starting heap — refinement
    re-splits anything merged too eagerly); the error test is only about
    efficiency.  Pairs straddling an original domain breakpoint (puncture /
    symmetry boundary) never merge.

    Like the device twin (``ops.adaptive.coarsen_pool``), a second
    cap-pressure trigger merges the CHEAPEST sibling pairs until the seed
    fits ``2x`` the load-bearing interval count: error estimates floor at
    eval noise far above ``1e-3 * share`` on hard integrands, so the
    absolute trigger alone would let the seed grow monotonically."""
    import numpy as np

    a, b, E = part[:, 0], part[:, 1], part[:, 2]
    L = float(b[-1] - a[0])
    inner_bks = np.asarray(breakpoints)[1:-1]
    n = len(part)
    # mergeable pairs and their costs (one pass; dyadic siblings are
    # disjoint so greedy merging cannot chain)
    pair_ok = np.zeros(n, bool)
    for i in range(n - 1):
        w_parent = b[i + 1] - a[i]
        widths_match = abs((b[i] - a[i]) - (b[i + 1] - a[i + 1])) <= 1e-9 * w_parent
        on_bk = inner_bks.size and bool(
            np.any(np.abs(inner_bks - b[i]) <= 1e-12 * max(L, 1.0)))
        contiguous = abs(b[i] - a[i + 1]) <= 1e-9 * max(w_parent, 1e-300)
        pair_ok[i] = widths_match and contiguous and not on_bk
    cost = np.full(n, np.inf)
    cost[:-1][pair_ok[:-1]] = (E[:-1] + E[1:])[pair_ok[:-1]]
    share = tol * (b - a + np.roll(b - a, -1)) / max(L, 1e-300)
    load = int(np.sum(E > 0.1 * tol * (b - a) / max(L, 1e-300)))
    target = max(2 * load, len(breakpoints), 8)
    need = max(n - target, 0)
    thr = -np.inf
    finite = np.sort(cost[np.isfinite(cost)])
    if need > 0 and finite.size:
        thr = finite[min(need - 1, finite.size - 1)]
    out = []
    i = 0
    while i < n:
        if i + 1 < n and pair_ok[i] and (
            cost[i] < 1e-3 * share[i] or cost[i] <= thr
        ):
            out.append((float(a[i]), float(b[i + 1])))
            i += 2
            continue
        out.append((float(a[i]), float(b[i])))
        i += 1
    return out


def _mid_seed_pool(mid_seed, segs2):
    """Denormalize a carried inner-level partition onto the CURRENT inner
    domain (warm-start seed for the level below the outermost).

    ``mid_seed = (ta, tb, te, tn)`` stores the partition in normalized
    coordinates ``t in [0, 1]`` because the inner domain moves with the outer
    variable (polyhedral IBZ limits: the ky range depends on kz) — an affine
    remap preserves exact tiling of ``[lo, hi]`` whatever the previous
    domain was, which is all a seed needs for a valid certificate (feature
    POSITIONS are approximate; each solve refines to its own tolerance).
    ``tn == 0`` is the cold sentinel: the current breakpoints seed instead
    (identical to the cold start, so the first solve needs no branch)."""
    ta, tb, te, tn = mid_seed
    dt = segs2.dtype
    lo, hi = segs2[0], segs2[-1]
    length = jnp.maximum(hi - lo, jnp.finfo(dt).tiny)
    capm = ta.shape[0]
    nseg2 = segs2.shape[0] - 1  # static
    a_cold = jnp.zeros((capm,), dt).at[:nseg2].set(segs2[:-1])
    b_cold = jnp.zeros((capm,), dt).at[:nseg2].set(segs2[1:])
    e_cold = jnp.full((capm,), jnp.inf, dt)  # inf = never merged by coarsen
    warm = tn > 0
    A = jnp.where(warm, lo + ta.astype(dt) * length, a_cold)
    B = jnp.where(warm, lo + tb.astype(dt) * length, b_cold)
    E = jnp.where(warm, te.astype(dt), e_cold)
    N = jnp.where(warm, tn, jnp.asarray(nseg2, tn.dtype))
    # rows beyond the live count hold normalization junk; zero-width them so
    # the rule evaluation's dead-slot mask drops them (the seed path skips
    # the coarsening that used to scrub these)
    live = jnp.arange(capm) < N
    A = jnp.where(live, A, 0)
    B = jnp.where(live, B, 0)
    E = jnp.where(live, E, 0)
    return A, B, E, N


def _mid_seed_norm(state, segs2):
    """Normalize an inner solve's final pool state for carrying
    (inverse of :func:`_mid_seed_pool`; junk beyond ``n`` live slots is
    masked by the pool's own live test on the next use)."""
    dt = segs2.dtype
    lo, hi = segs2[0], segs2[-1]
    length = jnp.maximum(hi - lo, jnp.finfo(dt).tiny)
    return ((state[0] - lo) / length, (state[1] - lo) / length,
            state[3], state[5])


class PlainCarrier:
    """Nest carrier for ordinary integrands: no per-level state."""

    def __init__(self, f):
        self.batch = batch_eval_fn(f, in_ndim=1)

    def fix(self, x):
        return self

    def eval_batch(self, xs, coords, p):
        return self.batch(assemble_points(xs, coords), p)


class NestedQuad(IntegralAlgorithm):
    """``NestedQuad(alg)`` or ``NestedQuad(algs_tuple)`` with one algorithm per
    dimension (index 0 = innermost), as in the reference."""

    def __init__(self, algs, inner_cap=512, inner_nbisect=2, split=False,
                 host_outer=False, host_nbisect=None, checkpoint=None,
                 leaf_nbisect=None, leaf_presplit=None, nest_presplit=None,
                 guide_rfloor="auto", guide_patience=6, guide_slack=1.0,
                 warm_start=False, warm_width=None, inner_seed_width=None):
        self.algs = algs
        # host-outer panel width: guided panels dispatch BOTH tiers per
        # refinement step, so the guided default is 1 bisection (2 intervals
        # x 15 GK nodes) to bound each dispatch, others 4.  The IAI wrapper
        # (brillouin.py) forwards its own resolved value.
        if host_nbisect is None:
            host_nbisect = 1 if split == "guided" else 4
        # split=True runs FourierIntegrand carriers in split-complex f64
        # (double precision from f64 pairs, never forming complex128);
        # split="guided" adds the f32-search tier: every adaptive level finds
        # its partition with cheap complex64 evaluations, then evaluates and
        # certifies only the surviving intervals in split-f64
        # (ops/adaptive.gk_adaptive_guided) — the savings compound across
        # nest levels
        self.guided = split == "guided"
        self.split = bool(split)
        # relative f32-noise floor for the guided search phase (keeps the
        # search from spinning where the c64 tier cannot resolve the error).
        # The default "auto" measures it from the integrand at solve time
        # (_probe_noise_rfloor): c64 eval noise is amplified ~||H||/eta and is
        # therefore problem-dependent — a fixed constant either wastes a
        # saturating search or stops early
        self.guide_rfloor = (guide_rfloor if guide_rfloor == "auto"
                             else float(guide_rfloor))
        # stalled-error patience for the guided search: the model-free backstop
        # when eval noise is amplified above guide_rfloor * L1 (c64 Green's
        # functions — see ops/adaptive.gk_adaptive docstring)
        self.guide_patience = int(guide_patience)
        # search-phase tolerance slack: the guided search stops at
        # guide_slack x the final tolerance — the search only FINDS the
        # partition, the split-tier polish certifies, so slack > 1 trades
        # cheap search-tier evals for a few expensive accurate-tier ones
        # (ops/adaptive.gk_adaptive_guided search_slack)
        self.guide_slack = float(guide_slack)
        # host_outer=True drives the OUTERMOST adaptive level from a host-side
        # heap: each refinement step is one bounded device call over a panel
        # of outer nodes (inner levels stay fully on-device).  This bounds
        # single-dispatch device time — required for tight tolerances through
        # execution-time-limited device transports — and is the adaptive
        # analogue of the streaming-block pattern in benchmarks/northstar.py.
        self.host_outer = host_outer
        # worst intervals bisected per host dispatch: round trips dominate
        # through remote transports, so several children batch into one call
        self.host_nbisect = host_nbisect
        # warm_start=True (host_outer only): successive solves on the SAME
        # cache seed their outer heap from the previous solve's surviving
        # partition (error-coarsened, re-evaluated at the new parameter with
        # the accurate tier — the guided search phase is skipped entirely).
        # Each solve keeps its own refinement and f64 certificate; only the
        # STARTING partition is shared, so correctness is untouched.  Built
        # for sequenced parameter sweeps (hchebinterp frontiers, DOS omega
        # scans) where adjacent solves need nearly identical partitions
        # (without it the flagship IAI leg re-discovers its partition for
        # every omega).
        self.warm_start = bool(warm_start)
        # warm-start seed batch width (on-device scans): seed evaluations
        # have no sequential dependency, so a wide batch collapses the
        # seeding phase to ~one device iteration (ops/adaptive seed_width)
        self.warm_width = warm_width
        # mid-seed consumption width: a seeded inner level otherwise
        # evaluates its carried partition 2*nbisect intervals at a time
        # (sequential device iterations INSIDE every enclosing panel lane —
        # pure depth on the scan leg).  Widening trades live memory
        # (width multiplies across the enclosing vmap lanes) for those
        # iterations.  None keeps the 2*nbisect default.
        self.inner_seed_width = inner_seed_width
        # checkpoint: path template for host-outer heap persistence; a killed
        # tight-tolerance solve resumes instead of restarting (the adaptive
        # analogue of northstar's per-rung block checkpointing).  The solve's
        # parameters hash into the filename so distinct solves never collide.
        self.checkpoint = checkpoint
        # inner-level adaptive pools are instantiated once per outer node of
        # every enclosing panel (vmap products), so their capacity/batch are
        # derated to bound live memory: a d-level nest has
        # prod(panel sizes) * cap live pool entries at the innermost level.
        self.inner_cap = inner_cap
        self.inner_nbisect = inner_nbisect
        # innermost-level batch width override: extra evals from batched
        # bisection do NOT multiply into deeper solves at the leaf, so wider
        # panels are affordable there, at the price of extra evals; None
        # keeps the level-default coupling
        self.leaf_nbisect = leaf_nbisect
        # innermost-level uniform presplit: start every leaf solve from P
        # subintervals per segment evaluated in ONE batched trip, cutting the
        # ~log2(P) serial bisection iterations most leaf solves spend.  Leaf
        # width does not multiply into deeper solves, so the extra evals ride
        # in otherwise-idle vmap lanes; the wall tradeoff is the innermost
        # max-trip reduction (docs/DESIGN.md "depth-bound").  None = 1 = off.
        self.leaf_presplit = leaf_presplit
        # EVERY-level uniform presplit — the `initdiv` robustness knob
        # (reference HCubatureJL exposes the same, src/algorithms.jl:99).
        # A single-segment GK estimate can be DECEIVED by structure that
        # aliases through the 15 nodes: measured on the 2D integer-lattice
        # DOS at omega=+-0.905, eta=0.1, the certified abstol=1e-4 solve
        # stops at true error 2.8e-3 with resid 7e-5 (the inherited-
        # partition warm solve gets it right).  nest_presplit=3 breaks the
        # aliasing symmetry at every level for ~P x the base eval cost.
        # None = 1 = off (reference parity: quadgk starts from the caller's
        # segments).
        self.nest_presplit = nest_presplit

    def _presplit_for(self, d_rem):
        """Uniform presplit for one nest level: the innermost honors
        ``leaf_presplit`` (depth lever), every level honors
        ``nest_presplit`` (anti-aliasing robustness)."""
        if d_rem == 1 and self.leaf_presplit:
            return int(self.leaf_presplit)
        return int(self.nest_presplit) if self.nest_presplit else 1

    def _level_knobs(self, alg, d_rem, ndim):
        """Pool cap and bisection width for one nest level (shared by the
        plain and guided tiers so the knob semantics cannot drift apart):
        the outermost level keeps the algorithm's own knobs; inner levels
        clamp to ``inner_cap``/``inner_nbisect``; the leaf may widen to
        ``leaf_nbisect`` (batch-width knob for the innermost vmapped pool)."""
        outermost = d_rem == ndim
        cap = alg.cap if outermost else min(alg.cap, self.inner_cap)
        if outermost:
            nbisect = alg.nbisect
        elif d_rem == 1 and self.leaf_nbisect is not None:
            nbisect = max(1, int(self.leaf_nbisect))
        else:
            nbisect = min(alg.nbisect, self.inner_nbisect)
        return cap, nbisect

    def _algs_for(self, ndim):
        if isinstance(self.algs, (tuple, list)):
            if len(self.algs) != ndim:
                raise ValueError("need one algorithm per dimension")
            return tuple(self.algs)
        return (self.algs,) * ndim

    def init_cacheval(self, f, dom, p):
        if not isinstance(dom, IteratedLimits):
            raise TypeError("NestedQuad requires an IteratedLimits domain")
        algs = self._algs_for(dom.ndim)

        from .pole import ContQuadGKJL, MeroQuadGKJL

        if any(isinstance(a, (ContQuadGKJL, MeroQuadGKJL)) for a in algs):
            # pole-aware levels are host algorithms (data-dependent Newton
            # deflation): the whole nest runs on the host — the reference's
            # any-algorithm-per-dimension contract
            # (``src/algorithms.jl:450-612``).  Pole algorithms may sit at
            # ANY level: a level
            # above the innermost evaluates its inner nest at COMPLEX
            # coordinates (the integrand must be analytic in that variable;
            # inner limits fix at the real part, so pole levels above the
            # innermost require limits independent of that variable —
            # rectangle nests, the reference's own contract for dented
            # contours).
            return {"pole_nest": algs}

        from ..fourier import FourierIntegrand

        if isinstance(f, FourierIntegrand):
            split = self.split

            def make_carrier():
                return f.nest_carrier(split=split)
        else:
            carrier0 = PlainCarrier(f)

            def make_carrier():
                return carrier0

        if self.guided:
            if isinstance(f, FourierIntegrand):
                def make_carrier32():
                    return f.nest_carrier(downcast=True)
            else:
                # no cheap tier for opaque integrands: the machinery still
                # works (search and evaluate tiers coincide), just no speedup
                make_carrier32 = make_carrier

        def solve_level(lims, carrier, coords, p, atol, rtol, maxiters,
                        noise_rfloor=0.0, stall_patience=0,
                        init_pool=None, return_state=False, mid_seed=None,
                        coarsen_seed=None):
            d_rem = lims.ndim
            alg = algs[d_rem - 1]
            segs = lims.outer_segments()
            inner_stats = d_rem > 1

            if d_rem == 1:
                def batch_f(xs, pp):
                    return carrier.eval_batch(xs, coords, pp)
            else:
                # inner solves return their innermost evaluation counts, which
                # the outer driver accumulates (exact EvalCounter semantics)
                def batch_f(xs, pp):
                    def one(x):
                        lims2 = lims.fix(x)
                        car2 = carrier.fix(x)
                        segs2 = lims2.outer_segments()
                        len2 = segs2[-1] - segs2[0]
                        inner_atol = atol / jnp.maximum(len2, jnp.finfo(segs2.dtype).tiny)
                        # mid_seed: warm-start the next level's pool from the
                        # carried NORMALIZED partition (see _mid_seed_pool) —
                        # consumed here, not propagated deeper
                        ip = (None if mid_seed is None
                              else _mid_seed_pool(mid_seed, segs2))
                        val, _, ne, _ = solve_level(
                            lims2, car2, coords + (x,), pp, inner_atol, rtol,
                            maxiters, noise_rfloor, stall_patience,
                            init_pool=ip,
                        )
                        return val, ne

                    return jax.vmap(one)(xs)

            if isinstance(alg, QuadratureFunction):
                if init_pool is not None or return_state:
                    raise TypeError(
                        "warm-start pools need an adaptive (QuadGKJL) "
                        "outermost level")
                x, w = alg.fun(alg.npt)
                val, ne = fixed_rule_eval(batch_f, p, segs, x, w, stats=inner_stats)
                z = jnp.zeros((), segs.dtype)
                return val, z, ne, jnp.asarray(True)
            if isinstance(alg, QuadGKJL):  # includes AuxQuadGKJL
                cap, nbisect = self._level_knobs(alg, d_rem, dom.ndim)
                presplit = self._presplit_for(d_rem)
                return gk_adaptive(
                    batch_f, p, segs, order=alg.order, cap=cap,
                    nbisect=nbisect, abstol=atol, reltol=rtol,
                    maxiters=maxiters, norm=alg.norm,
                    stats=inner_stats, noise_rfloor=noise_rfloor,
                    stall_patience=stall_patience, presplit=presplit,
                    # warm_width is an OUTERMOST knob; seeded inner levels
                    # take inner_seed_width (default None = 2*nbisect).
                    # Inner width multiplies live memory across every
                    # enclosing panel lane, but the iterations it removes
                    # are pure serial depth on the scan leg
                    init_pool=init_pool,
                    seed_width=(self.warm_width if d_rem == dom.ndim
                                else self.inner_seed_width),
                    # inner mid-seed pools arrive equilibrated (compact,
                    # dead-masked by _mid_seed_pool); only the outermost
                    # carried pool — and the harvest refresh, the mid
                    # carry's decay point — need the cross-parameter
                    # coarsening
                    seed_coarsen=(d_rem == dom.ndim if coarsen_seed is None
                                  else coarsen_seed),
                    _return_state=return_state,
                )
            raise TypeError(f"{type(alg).__name__} is not supported inside NestedQuad")

        auto_floor = self.guided and self.guide_rfloor == "auto"
        guide_rfloor = 0.0 if auto_floor else self.guide_rfloor
        guide_patience = self.guide_patience
        guide_slack = self.guide_slack

        def solve_level_g(lims, car32, carS, coords, p32, p, atol, rtol,
                          maxiters, rfloor):
            """Guided twin of ``solve_level``: each adaptive level searches
            with the c64 carrier (full-f32 inner recursion) and evaluates /
            certifies with the split-f64 carrier (guided inner recursion).
            ``rfloor`` is the search tier's L1-relative noise floor — a
            static float, or a traced scalar measured by the solve-time
            probe (guide_rfloor="auto")."""
            d_rem = lims.ndim
            alg = algs[d_rem - 1]
            segs = lims.outer_segments()
            inner_stats = d_rem > 1

            if d_rem == 1:
                def batch_f32(xs, pp):
                    return car32.eval_batch(xs, coords, pp)

                def batch_fS(xs, pp):
                    return carS.eval_batch(xs, coords, pp)
            else:
                # the c64 search recursion carries the L1-relative noise floor
                # so inner searches stop where f32 stops resolving instead of
                # saturating their pools against tiny absolute tolerances
                def batch_f32(xs, pp):
                    def one(x):
                        lims2 = lims.fix(x)
                        car2 = car32.fix(x)
                        segs2 = lims2.outer_segments()
                        len2 = segs2[-1] - segs2[0]
                        # the whole f32 recursion is search tier: the slack
                        # loosens it top to bottom (the split recursion below
                        # re-certifies at the unslacked tolerance)
                        inner_atol = (atol * guide_slack
                                      / jnp.maximum(len2, jnp.finfo(segs2.dtype).tiny))
                        val, _, ne, _ = solve_level(
                            lims2, car2, coords + (x,), pp, inner_atol, rtol,
                            maxiters, rfloor, guide_patience
                        )
                        return val, ne

                    return jax.vmap(one)(xs)

                def batch_fS(xs, pp):
                    def one(x):
                        lims2 = lims.fix(x)
                        c2_32 = car32.fix(x)
                        c2S = carS.fix(x)
                        segs2 = lims2.outer_segments()
                        len2 = segs2[-1] - segs2[0]
                        inner_atol = atol / jnp.maximum(len2, jnp.finfo(segs2.dtype).tiny)
                        val, _, ne, _ = solve_level_g(
                            lims2, c2_32, c2S, coords + (x,), p32, pp,
                            inner_atol, rtol, maxiters, rfloor
                        )
                        return val, ne

                    return jax.vmap(one)(xs)

            if isinstance(alg, QuadratureFunction):
                # fixed rule: nothing to search, evaluate split directly
                x, w = alg.fun(alg.npt)
                val, ne = fixed_rule_eval(batch_fS, p, segs, x, w, stats=inner_stats)
                z = jnp.zeros((), segs.dtype)
                return val, z, ne, jnp.asarray(True)
            if isinstance(alg, QuadGKJL):  # includes AuxQuadGKJL
                cap, nbisect = self._level_knobs(alg, d_rem, dom.ndim)
                presplit = self._presplit_for(d_rem)
                return gk_adaptive_guided(
                    batch_f32, batch_fS, p32, p, segs, order=alg.order,
                    cap=cap, nbisect=nbisect, abstol=atol, reltol=rtol,
                    guide_rfloor=rfloor, maxiters=maxiters,
                    stall_patience=guide_patience,
                    search_slack=guide_slack, presplit=presplit,
                    norm=alg.norm, stats=inner_stats,
                )
            raise TypeError(f"{type(alg).__name__} is not supported inside NestedQuad")

        if self.guided:
            # the auto noise probe evaluates BOTH tiers at len(_PROBE_TS)^d
            # points; those are real integrand evaluations and belong in
            # numevals (EvalCounter semantics)
            nprobe = 2 * len(_PROBE_TS) ** dom.ndim

            @jax.jit
            def run(p, atol, rtol, maxiters):
                p32 = _downcast_params(p)
                c32, cS = make_carrier32(), make_carrier()
                rfloor = (_probe_noise_rfloor(dom, c32, cS, p32, p)
                          if auto_floor else guide_rfloor)
                val, err, ne, conv = solve_level_g(dom, c32, cS, (),
                                                   p32, p, atol, rtol,
                                                   maxiters, rfloor)
                if auto_floor:
                    ne = ne + nprobe
                return val, err, ne, conv
        else:
            @jax.jit
            def run(p, atol, rtol, maxiters):
                # maxiters is threaded to every nesting level's adaptive driver,
                # matching the reference's kwarg pass-through (src/interfaces.jl:64-69)
                return solve_level(dom, make_carrier(), (), p, atol, rtol, maxiters)

        cacheval = {"run": run}

        top_alg0 = algs[dom.ndim - 1]
        if not self.guided and isinstance(top_alg0, QuadGKJL):
            # warm-pool twin of `run` for sequenced parameter scans
            # (SweepSolver(warm=True)): the OUTER pool seeds from the previous
            # solve's surviving partition and the final pool threads out as
            # the next solve's seed — the on-device leg of the cross-omega
            # warm start (the host-outer leg lives in _host_outer_solve).
            # For nests (ndim > 1) the pool also carries ONE normalized
            # inner-level partition (`mid_seed`): every inner solve at the
            # level below the outermost seeds from it instead of
            # re-discovering its partition from the domain breakpoints —
            # the inner DISCOVERY loop is the dominant serial depth of a
            # warm solve (the outer pool is inherited, but each of its
            # ~15*pool evaluations ran a full cold adaptive recursion).
            # One partition serves all outer nodes because inner structure
            # varies slowly along the outer variable; refinement patches
            # the difference per node, and each solve still certifies
            # independently.
            carry_mid = dom.ndim > 1 and isinstance(algs[dom.ndim - 2],
                                                    QuadGKJL)

            @jax.jit
            def run_warm(p, atol, rtol, maxiters, pool):
                outer_pool = tuple(pool[:4])
                mid_seed = pool[4] if carry_mid else None
                val, err, ne, conv, state = solve_level(
                    dom, make_carrier(), (), p, atol, rtol, maxiters,
                    init_pool=outer_pool, return_state=True,
                    mid_seed=mid_seed)
                new_pool = (state[0], state[1], state[3], state[5])
                if carry_mid:
                    # the mid seed passes through UNCHANGED here; the caller
                    # refreshes it with `harvest_mid` (a separate, much
                    # smaller program) once per chunk — embedding the
                    # refresh nest in this program multiplies its compile
                    # time
                    new_pool = new_pool + (mid_seed,)
                return val, err, ne, conv, new_pool

            cacheval["run_warm"] = run_warm

            if carry_mid:
                # refresh the carried inner partition with ONE inner solve
                # at the worst outer interval's midpoint (~1/10^3 of a
                # solve's evals, itself warm-seeded): the carry tracks the
                # moving parameter without threading per-node pool state
                # through the outer machinery.  Own jit: see run_warm note.
                @jax.jit
                def harvest_mid(p, atol, rtol, maxiters, pool):
                    a_o, b_o, e_o = pool[0], pool[1], pool[2]
                    mid_seed = pool[4]
                    # worst LIVE interval (slots beyond n may hold junk)
                    live = jnp.arange(a_o.shape[0]) < pool[3]
                    widx = jnp.argmax(jnp.where(live, e_o, -jnp.inf))
                    xh = (a_o[widx] + b_o[widx]) / 2
                    lims2 = dom.fix(xh)
                    car2 = make_carrier().fix(xh)
                    segs2 = lims2.outer_segments()
                    len2 = segs2[-1] - segs2[0]
                    inner_atol = atol / jnp.maximum(
                        len2, jnp.finfo(segs2.dtype).tiny)
                    _, _, hne, _, mstate = solve_level(
                        lims2, car2, (xh,), p, inner_atol, rtol, maxiters,
                        init_pool=_mid_seed_pool(mid_seed, segs2),
                        return_state=True, coarsen_seed=True)
                    new_mid = _mid_seed_norm(mstate, segs2)
                    return pool[:4] + (new_mid,), hne

                cacheval["harvest_mid"] = harvest_mid
            # cold seed: the initial segments in pool form (errors +inf so the
            # first solve's coarsening is a no-op) — warm-with-segments IS the
            # cold start, so the scan chain needs no first-step branch
            cap0, _ = self._level_knobs(top_alg0, dom.ndim, dom.ndim)
            segs0 = np.asarray(dom.outer_segments(), dtype=np.float64)
            nseg0 = len(segs0) - 1
            a0 = np.zeros(cap0)
            b0 = np.zeros(cap0)
            a0[:nseg0] = segs0[:-1]
            b0[:nseg0] = segs0[1:]
            e0 = np.full(cap0, np.inf)
            pool0 = (a0, b0, e0, np.int32(nseg0))
            if carry_mid:
                mid_cap, _ = self._level_knobs(algs[dom.ndim - 2],
                                               dom.ndim - 1, dom.ndim)
                # tn=0 = cold sentinel (first solve seeds from breakpoints)
                pool0 = pool0 + ((np.zeros(mid_cap), np.zeros(mid_cap),
                                  np.zeros(mid_cap), np.int32(0)),)
            cacheval["warm_pool0"] = pool0

        if auto_floor:
            # host-outer solves resolve the floor once per solve through this
            # (the on-device `run` probes inline at trace time instead)
            @jax.jit
            def probe_rfloor(p):
                p32 = _downcast_params(p)
                return _probe_noise_rfloor(dom, make_carrier32(),
                                           make_carrier(), p32, p)

            cacheval["probe_rfloor"] = probe_rfloor

        if self.host_outer and dom.ndim > 1:
            # one bounded device call per refinement step: inner solves for a
            # panel of outermost coordinates (vals, evals, converged)
            if self.guided:
                # the host driver resolves the floor ONCE per solve (probe or
                # static) and threads it as a traced scalar argument, so one
                # executable serves every dispatch and every floor value
                @jax.jit
                def panel(xs, p, atol, rtol, maxiters, rfloor):
                    p32 = _downcast_params(p)

                    def one(x):
                        lims2 = dom.fix(x)
                        c2_32 = make_carrier32().fix(x)
                        c2S = make_carrier().fix(x)
                        segs2 = lims2.outer_segments()
                        len2 = segs2[-1] - segs2[0]
                        inner_atol = atol / jnp.maximum(len2, jnp.finfo(segs2.dtype).tiny)
                        val, _, ne, conv = solve_level_g(
                            lims2, c2_32, c2S, (x,), p32, p,
                            inner_atol, rtol, maxiters, rfloor)
                        return val, ne, conv

                    return jax.vmap(one)(xs)

                # cheap f32 panel for the host-side search phase; the
                # L1-relative noise floor rides the whole c64 recursion
                @jax.jit
                def panel32(xs, p, atol, rtol, maxiters, rfloor):
                    p32 = _downcast_params(p)

                    def one(x):
                        lims2 = dom.fix(x)
                        car2 = make_carrier32().fix(x)
                        segs2 = lims2.outer_segments()
                        len2 = segs2[-1] - segs2[0]
                        # pure search-tier panel: slack applies (the accurate
                        # `panel` re-certifies at the unslacked tolerance)
                        inner_atol = (atol * guide_slack
                                      / jnp.maximum(len2, jnp.finfo(segs2.dtype).tiny))
                        val, _, ne, conv = solve_level(lims2, car2, (x,), p32,
                                                       inner_atol, rtol,
                                                       maxiters, rfloor,
                                                       guide_patience)
                        return val, ne, conv

                    return jax.vmap(one)(xs)

                cacheval["panel32"] = panel32
            else:
                @jax.jit
                def panel(xs, p, atol, rtol, maxiters):
                    def one(x):
                        lims2 = dom.fix(x)
                        car2 = make_carrier().fix(x)
                        segs2 = lims2.outer_segments()
                        len2 = segs2[-1] - segs2[0]
                        inner_atol = atol / jnp.maximum(len2, jnp.finfo(segs2.dtype).tiny)
                        val, _, ne, conv = solve_level(lims2, car2, (x,), p,
                                                       inner_atol, rtol, maxiters)
                        return val, ne, conv

                    return jax.vmap(one)(xs)

            cacheval["panel"] = panel
        return cacheval

    def do_solve(self, f, dom, p, cacheval, abstol=None, reltol=None, maxiters=None):
        from .gk import _budget

        if "pole_nest" in cacheval:
            return self._pole_nest_solve(f, dom, p, cacheval["pole_nest"],
                                         abstol, reltol, maxiters)
        if "panel" in cacheval:
            return self._host_outer_solve(dom, p, cacheval, abstol, reltol, maxiters)
        atol, rtol = effective_tolerances(abstol, reltol)
        val, err, ne, conv = cacheval["run"](p, atol, rtol, _budget(maxiters))
        if not bool(conv) and maxiters is None:
            # with an explicit eval budget, truncation is the requested
            # behavior — retcode=False alone reports it
            import warnings

            warnings.warn(
                "NestedQuad did not reach the requested tolerance (pool "
                "capacity or precision floor); inspect sol.resid, raise "
                "cap/inner_cap, or use the f64 PTR ladder for tight tolerances",
                stacklevel=2,
            )
        return IntegralSolution(val, err, bool(conv), int(ne))

    def _host_outer_solve(self, dom, p, cacheval, abstol, reltol, maxiters):
        """Worst-first host heap over the outermost dimension; each step is one
        device dispatch of ``2 * 15`` outer nodes (the two children's GK
        panels), so single-call device time stays bounded no matter how tight
        the tolerance — the adaptive analogue of the northstar streaming-block
        pattern, and the reference's recursion order (``src/fourier.jl:493``)
        with the outer loop on host."""
        import heapq

        import numpy as np

        from ..ops.quad_rules import kronrod
        from ..utils.tree import host_complex_safe
        from .gk import _budget

        atol, rtol = effective_tolerances(abstol, reltol)
        atol_f = float(atol)
        rtol_f = float(rtol)
        budget = _budget(maxiters)
        panel = cacheval["panel"]
        panel32 = cacheval.get("panel32")  # guided: cheap f32 search tier
        rfloor_f = 0.0
        probe_ne = 0
        if panel32 is not None:
            # resolve the guided search's noise floor once per solve: the
            # solve-time probe (guide_rfloor="auto", default) or the static
            # constant; both flow into the panels as a traced scalar arg
            if self.guide_rfloor == "auto":
                rfloor_f = float(cacheval["probe_rfloor"](p))
                # both tiers evaluate at len(_PROBE_TS)^d points — real
                # integrand evaluations, counted
                probe_ne = 2 * len(_PROBE_TS) ** dom.ndim
            else:
                rfloor_f = float(self.guide_rfloor)
            import os as _os0
            if _os0.environ.get("AUTOBZ_HOST_OUTER_DEBUG") == "1":
                import sys as _s
                print(f"[host-outer] guide rfloor = {rfloor_f:.3e} "
                      f"({'probed' if self.guide_rfloor == 'auto' else 'pinned'})",
                      file=_s.stderr, flush=True)
        top_alg = self._algs_for(dom.ndim)[dom.ndim - 1]
        order = getattr(top_alg, "order", 7)
        norm = getattr(top_alg, "norm", tree_norm)
        xk, wk, wg = kronrod(order)
        segs = np.asarray(dom.outer_segments(), dtype=np.float64)

        tm = jax.tree_util.tree_map

        # heap totals are host numpy — possibly complex128 (host_complex_safe
        # rejoins complex panel results on the host).  The norm of these
        # host values is host arithmetic, so it runs on the CPU backend
        # instead of round-tripping each heap total through the device.
        cpu0 = jax.devices("cpu")[0]

        def hnorm(tree):
            return float(norm(tm(lambda v: jax.device_put(np.asarray(v), cpu0),
                                 tree)))

        import os as _os
        import sys as _sys
        import time as _time

        dbg = _os.environ.get("AUTOBZ_HOST_OUTER_DEBUG") == "1"

        def rules(bounds, pan=None):
            """Evaluate the GK rule on a list of (a, b) intervals with ONE
            device call; returns per-interval (I, E, ne, conv)."""
            if pan is None:
                pan = panel
            nodes = np.concatenate(
                [(a + b) / 2 + (b - a) / 2 * xk for a, b in bounds]
            )
            t0 = _time.time() if dbg else 0.0
            # inner levels run unbudgeted: maxiters bounds the OUTER heap only
            # (a truncated inner solve would silently poison the stored panel
            # values — and any resumed checkpoint built from them)
            args = (jnp.asarray(nodes), p, jnp.asarray(atol_f),
                    jnp.asarray(rtol_f), _budget(None))
            if panel32 is not None:  # guided panels take the noise floor
                args += (jnp.asarray(rfloor_f),)
            vals, nes, convs = pan(*args)
            vals = tm(np.asarray, host_complex_safe(vals))
            if dbg:
                which = "panel32" if pan is panel32 else "panel"
                print(f"[host-outer] {which} n={len(bounds)} "
                      f"[{bounds[0][0]:.4g},{bounds[0][1]:.4g}]... "
                      f"t={_time.time() - t0:.2f}s", file=_sys.stderr, flush=True)
            nes = np.asarray(nes)
            convs = np.asarray(convs)
            npts = len(xk)
            out = []
            for i, (a, b) in enumerate(bounds):
                half = (b - a) / 2
                sl = slice(i * npts, (i + 1) * npts)

                def red(w):
                    return tm(lambda v: np.tensordot(w, v[sl], axes=(0, 0)) * half, vals)

                Ik = red(wk)
                Ig = red(wg)
                E = hnorm(tm(lambda x, y: x - y, Ik, Ig))
                out.append((Ik, E, int(nes[sl].sum()), bool(convs[sl].all())))
            return out

        ckpt_file = None
        if self.checkpoint is not None:
            import hashlib
            import pickle

            key = hashlib.sha1(
                repr((np.asarray(jax.tree_util.tree_leaves(p), dtype=object).tolist()
                      if jax.tree_util.tree_leaves(p) else (), atol_f, rtol_f,
                      segs.tolist())).encode()
            ).hexdigest()[:16]
            ckpt_file = f"{self.checkpoint}.{key}.pkl"

        state = None
        if ckpt_file is not None:
            import os
            import pickle

            if os.path.exists(ckpt_file):
                with open(ckpt_file, "rb") as fh:
                    state = pickle.load(fh)

        # warm start: the previous solve on this cache left its surviving
        # outer partition (+ the tolerance it certified at) in the shared
        # cacheval slot — any contiguous cover is a valid starting heap
        warm = None
        seed = None
        if self.warm_start:
            import threading

            warm = cacheval.setdefault(
                "warm_part", {"lock": threading.Lock(), "part": None,
                              "tol": atol_f})
            if state is None:
                with warm["lock"]:
                    seed = warm["part"]
                    seed_tol = warm["tol"]
        seeded = seed is not None

        if state is not None:
            heap, total, total_E, nev, inner_ok, count = state
        else:
            heap = []
            total = None
            total_E = 0.0
            nev = 0
            inner_ok = True
            if seeded:
                # re-evaluate the coarsened previous partition at the NEW
                # parameter with the ACCURATE tier (the guided search phase
                # is skipped entirely: the partition is already known), in
                # refine-shaped chunks so the same executable serves
                bounds = _coarsen_partition(seed, segs, seed_tol)
                chunk = max(2 * max(1, int(self.host_nbisect)), 2)
                init = []
                for i0 in range(0, len(bounds), chunk):
                    ch = bounds[i0:i0 + chunk]
                    pad = chunk - len(ch)
                    res = rules(ch + [(0.0, 0.0)] * pad, panel)
                    nev += sum(r[2] for r in res[len(ch):])  # padding ran
                    init += res[:len(ch)]
            else:
                bounds = list(zip(segs[:-1], segs[1:]))
                # a fresh guided run seeds the heap with the cheap f32 tier;
                # the upgrade pass replaces every stored value before
                # certification
                init = rules(bounds, panel32 if panel32 is not None else panel)
            for i, ((a, b), (I, E, ne, conv)) in enumerate(zip(bounds, init)):
                total = I if total is None else tm(np.add, total, I)
                total_E += E
                nev += ne
                inner_ok = inner_ok and conv
                heapq.heappush(heap, (-E, i, a, b, I))
            count = len(heap)

        def save_ckpt():
            if ckpt_file is None:
                return
            import pickle

            tmp = ckpt_file + ".tmp"
            with open(tmp, "wb") as fh:
                pickle.dump((heap, total, total_E, nev, inner_ok, count), fh)
            import os

            os.replace(tmp, ckpt_file)
        max_evals = float(budget)
        # bisect several worst intervals per dispatch: host<->device round
        # trips dominate through remote transports, and wider panels use the
        # device better; growing width amortizes late-stage refinement
        nbis = max(1, int(self.host_nbisect))
        iters_since_ckpt = 0

        def refine(pan, floor_rel=0.0, allow_ckpt=True, patience=0, slack=1.0):
            """Worst-first refinement of the heap through panel ``pan`` until
            ``max(atol, rtol·‖I‖, floor_rel·‖I‖)`` (the floor bounds the
            guided search phase at the f32 noise level).  ``patience`` > 0
            additionally stops after that many consecutive dispatches without
            a 3% improvement of the total error estimate — the model-free
            noise-floor detector for the search phase (eval noise through c64
            Green's functions is amplified ~||H||/eta above eps32, so no fixed
            floor_rel can be right; a stalled estimate detects the real one)."""
            nonlocal total, total_E, nev, inner_ok, count, iters_since_ckpt, heap
            best_E, stall = float("inf"), 0
            while True:
                tol_now = max(atol_f * slack,
                              max(rtol_f * slack, floor_rel) * hnorm(total))
                if not (total_E > tol_now and nev < max_evals and heap):
                    break
                if patience and stall >= patience:
                    break
                iters_since_ckpt += 1
                if allow_ckpt and iters_since_ckpt >= 16:
                    save_ckpt()
                    iters_since_ckpt = 0
                batch = []  # (a, b, I_parent, E_parent)
                picked_E = 0.0
                while heap and len(batch) < nbis:
                    # stop picking once the already-picked errors could settle it
                    if batch and total_E - picked_E <= tol_now:
                        break
                    negE, _, a, b, I = heapq.heappop(heap)
                    batch.append((a, b, I, -negE))
                    picked_E += -negE
                bounds = []
                for a, b, _, _ in batch:
                    m = (a + b) / 2
                    bounds += [(a, m), (m, b)]
                res = rules(bounds, pan)
                for k, (a, b, I, Ep) in enumerate(batch):
                    m = (a + b) / 2
                    I1, E1, n1, c1 = res[2 * k]
                    I2, E2, n2, c2 = res[2 * k + 1]
                    total = tm(lambda t, x, y, z: t + x + y - z, total, I1, I2, I)
                    total_E += E1 + E2 - Ep
                    nev += n1 + n2
                    inner_ok = inner_ok and c1 and c2
                    count += 1
                    heapq.heappush(heap, (-E1, 2 * count, a, m, I1))
                    heapq.heappush(heap, (-E2, 2 * count + 1, m, b, I2))
                if patience:
                    if total_E < 0.97 * best_E:
                        best_E, stall = total_E, 0
                    else:
                        stall += 1

        def upgrade_heap():
            """Guided phase 2: re-evaluate every surviving outer interval with
            the accurate panel (dispatch shape matches the refine dispatches,
            padded with zero-width intervals, so the same executable serves)."""
            nonlocal heap, total, total_E, nev, inner_ok
            # every search-tier value is replaced here, so search-phase inner
            # convergence flags (stall-stopped f32 solves report conv=False
            # by design) must not poison the accurate-tier certificate
            inner_ok = True
            entries = [(key, a, b) for (_, key, a, b, _) in heap]
            chunk = max(2 * nbis, 2)
            results = []
            for i0 in range(0, len(entries), chunk):
                ch = [(a, b) for _, a, b in entries[i0:i0 + chunk]]
                pad = chunk - len(ch)
                res = rules(ch + [(0.0, 0.0)] * pad, panel)
                nev += sum(r[2] for r in res)  # padding solves really ran
                results += res[:len(ch)]
            new_heap = []
            new_total = None
            new_E = 0.0
            for (key, a, b), (I, E, ne, conv) in zip(entries, results):
                new_total = I if new_total is None else tm(np.add, new_total, I)
                new_E += E
                inner_ok = inner_ok and conv
                heapq.heappush(new_heap, (-E, key, a, b, I))
            heap = new_heap
            total = new_total
            total_E = new_E

        if state is not None or seeded:
            # a resumed checkpoint or a warm-start seed always holds
            # accurate-tier values (checkpoints are disabled during the
            # guided search phase; seeds evaluate through the accurate panel)
            refine(panel)
        elif panel32 is not None:
            refine(panel32, floor_rel=rfloor_f, allow_ckpt=False,
                   patience=self.guide_patience, slack=self.guide_slack)
            upgrade_heap()
            refine(panel)
        else:
            refine(panel)
        final_tol = max(atol_f, rtol_f * hnorm(total))
        converged = total_E <= final_tol and inner_ok
        if warm is not None:
            # leave this solve's surviving partition (+ its certified errors
            # and tolerance) for the next solve on this cache to seed from
            part = np.array(sorted((a, b, -negE)
                                   for (negE, _, a, b, _) in heap))
            with warm["lock"]:
                warm["part"] = part
                warm["tol"] = final_tol
        if ckpt_file is not None:
            if not converged and nev >= max_evals:
                # budget truncation: keep the heap so a rerun with a larger
                # maxiters resumes (nev is cumulative across resumes)
                save_ckpt()
            else:
                import contextlib
                import os

                with contextlib.suppress(OSError):
                    os.remove(ckpt_file)
        if not converged and maxiters is None:
            import warnings

            warnings.warn(
                "host-outer NestedQuad stopped short of tolerance; inspect "
                "sol.resid or raise inner caps",
                stacklevel=3,
            )
        total = tm(jnp.asarray, total)
        return IntegralSolution(total, total_E, bool(converged),
                                int(nev) + probe_ne)

    def _pole_nest_solve(self, f, dom, p, algs, abstol, reltol, maxiters):
        """Host-recursive nest with pole-aware (ContQuadGK/MeroQuadGK) levels
        at ANY depth — the reference's any-algorithm-per-dimension
        ``NestedQuad`` contract (``src/algorithms.jl:450-612``).  Pole
        detection is data-dependent host work, so the whole nest runs on the
        host; the per-level tolerance division matches the device nest
        (``atol / inner span``, ``src/algorithms.jl:545,557,567``).

        A pole level's variable is evaluated at COMPLEX coordinates (dented
        contours / Newton polish), so the user integrand must be analytic in
        that component — same requirement as the reference's pole algorithms
        (``src/algorithms.jl:262-264``).  A pole level ABOVE the innermost
        additionally requires the inner limits not to depend on its variable
        (they fix at the real part): rectangle nests, the physically common
        case of a pole-hunting frequency integral wrapped around (or inside)
        a k-box."""
        import numpy as np

        from ..wrappers import unwrap_integrand
        from .pole import ContQuadGKJL, MeroQuadGKJL, _quadgk_host

        from .pole import _in_detection

        atol, rtol = effective_tolerances(abstol, reltol)
        g = unwrap_integrand(f)
        budget = np.inf if maxiters is None else int(maxiters)
        stats = {"nev": 0, "ok": True}

        def note_ok(conv):
            # inner solves running under a pole level's DETECTION phase may
            # legitimately land ON a pole (Newton polish of 1/f) and blow up;
            # those probes feed root-finding, not the integral, so they are
            # exempt from the nest's certificate
            if not _in_detection():
                stats["ok"] = stats["ok"] and bool(conv)

        # ONE jitted batched-panel evaluation shared by every plain-innermost
        # solve in the nest (per-point host dispatch of a jitted integrand
        # was measured to dominate outer-pole nests); traced once per
        # (K, d) complex shape
        gj = jax.jit(lambda pts, pp: g(pts, pp))

        def level(lims, coords, atol_l):
            d_rem = lims.ndim
            alg = algs[d_rem - 1]
            pole_here = isinstance(alg, (ContQuadGKJL, MeroQuadGKJL))
            segs = np.asarray(lims.outer_segments())
            if d_rem == 1:
                fixed = [complex(c) for c in reversed(coords)]

                def sub_f(x, pp):
                    return g(jnp.asarray(np.array([x] + fixed)), pp)

                if pole_here:
                    cv = alg.init_cacheval(sub_f, segs, p)
                    rem = None if budget == np.inf else max(1, int(budget - stats["nev"]))
                    sol = alg.do_solve(sub_f, segs.real.astype(float), p, cv,
                                       abstol=atol_l, reltol=rtol, maxiters=rem)
                    stats["nev"] += sol.numevals
                    note_ok(sol.retcode)
                    return complex(np.complex128(sol.u)), float(sol.resid)
                # plain innermost level under an outer pole level: host GK
                # with whole-panel batched integrand calls (outer coords may
                # already be complex; the 1D variable is real-valued but
                # complex-typed so the point array is uniform)
                fixed_arr = np.asarray(fixed, dtype=complex)

                def batch_f(xs, pp):
                    xs = np.asarray(xs, dtype=complex)
                    pts = np.concatenate(
                        [xs[:, None],
                         np.broadcast_to(fixed_arr, (xs.size, fixed_arr.size))],
                        axis=1)
                    vals = np.asarray(gj(jnp.asarray(pts), pp))
                    stats["nev"] += int(xs.size)
                    return vals

                # detection probes may sit ON a pole of an enclosing level,
                # where the integrand magnitude explodes (measured 1e16) and
                # an ABSOLUTE tolerance can never be met — root-finding only
                # needs a few relative digits of 1/f, so detection-phase
                # solves run at relative accuracy with a small panel budget
                detect = _in_detection()
                I, E, _, conv = _quadgk_host(
                    None, p, segs.real.astype(float), atol_l,
                    max(float(rtol), 1e-6) if detect else rtol,
                    order=getattr(alg, "order", 7),
                    max_segs=64 if detect else 10**4, batch_f=batch_f,
                    should_stop=(None if budget == np.inf
                                 else (lambda: stats["nev"] >= budget)),
                )
                note_ok(conv)
                return complex(I), float(E)

            if pole_here:
                # pole-aware middle/outer level: ITS 1D integrand is the
                # whole inner nest, evaluated at a complex coordinate; inner
                # limits fix at the real part (see docstring contract)
                def sub_nest(x, pp):
                    lims2 = lims.fix(float(np.real(x)))
                    segs2 = np.asarray(lims2.outer_segments(), dtype=float)
                    len2 = max(float(segs2[-1] - segs2[0]), 1e-300)
                    val, _ = level(lims2, coords + (complex(x),), atol_l / len2)
                    return val

                cv = alg.init_cacheval(sub_nest, segs.real.astype(float), p)
                # outer numevals would double-count: every sub_nest call's
                # true integrand evals are already accumulated by the inner
                # recursion, so only retcode/resid flow up from the solve
                sol = alg.do_solve(sub_nest, segs.real.astype(float), p, cv,
                                   abstol=atol_l, reltol=rtol, maxiters=None)
                note_ok(sol.retcode)
                return complex(np.complex128(sol.u)), float(sol.resid)

            def f_outer(x, pp):
                lims2 = lims.fix(float(np.real(x)))
                segs2 = np.asarray(lims2.outer_segments(), dtype=float)
                len2 = max(float(segs2[-1] - segs2[0]), 1e-300)
                val, _ = level(lims2, coords + (float(np.real(x)),), atol_l / len2)
                return val

            detect = _in_detection()  # see the innermost branch
            I, E, _, conv = _quadgk_host(
                f_outer, p, segs.real.astype(float), atol_l,
                max(float(rtol), 1e-6) if detect else rtol,
                order=getattr(alg, "order", 7),
                max_segs=64 if detect else 10**4,
                # the maxiters budget counts INNER integrand evals (stats),
                # which this level's own nev cannot see — stop outer heap
                # refinement once the nest's total is spent
                should_stop=(None if budget == np.inf
                             else (lambda: stats["nev"] >= budget)),
            )
            note_ok(conv)
            return I, E

        val, err = level(dom, (), atol)
        return IntegralSolution(jnp.asarray(val), err, bool(stats["ok"]), stats["nev"])

    def solve_fn(self, cacheval):
        from .gk import _budget

        if "pole_nest" in cacheval:
            raise ValueError(
                "NestedQuad with a pole-aware innermost level (ContQuadGKJL/"
                "MeroQuadGKJL) runs host-side only and cannot be traced into "
                "a sweep program; solve omegas one at a time via solve()/"
                "IntegralSolver, or use threaded_solve for pipelining")
        run = cacheval["run"]

        def fn(p, atol, rtol):
            val, err, ne, conv = run(p, atol, rtol, _budget(None))
            return val, err, conv, ne

        return fn

    def solve_fn_warm(self, cacheval):
        """Warm-pool sweep form: ``(fn(p, atol, rtol, pool) -> (u, resid,
        converged, numevals, new_pool), pool0)`` where ``pool`` is the
        ``(a, b, err, n)`` outer interval pool inherited from the previous
        solve and ``pool0`` the cold seed (the initial segments).  Returns
        None when the cache has no warm form (guided tier, pole nests,
        fixed-rule outer level)."""
        from .gk import _budget

        run_warm = cacheval.get("run_warm") if "pole_nest" not in cacheval else None
        if run_warm is None:
            return None

        def fn(p, atol, rtol, pool):
            val, err, ne, conv, new_pool = run_warm(p, atol, rtol,
                                                    _budget(None), pool)
            return val, err, conv, ne, new_pool

        return fn, cacheval["warm_pool0"]

    def harvest_fn(self, cacheval):
        """Mid-seed refresh form for warm sweeps: ``fn(p, atol, rtol, pool)
        -> (new_pool, numevals)`` re-solves the carried inner-level
        partition at the worst outer interval's midpoint (one inner solve,
        compiled as its OWN small program — see run_warm).  None when the
        nest carries no mid seed (1D, fixed-rule inner level, guided)."""
        from .gk import _budget

        harvest = cacheval.get("harvest_mid") if "pole_nest" not in cacheval else None
        if harvest is None:
            return None

        def fn(p, atol, rtol, pool):
            return harvest(p, atol, rtol, _budget(None), pool)

        return fn
