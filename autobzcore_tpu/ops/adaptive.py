"""Fixed-shape adaptive Gauss-Kronrod integrator (the on-device ``quadgk``).

The reference's h-adaptive 1D integrators (``quadgk``/``auxquadgk``, driven at
``src/algorithms.jl:73-91,202-240``) maintain a dynamic heap of segments and
bisect the worst one per iteration.  That shape-dynamic recursion does not map
to XLA, so here the segment heap becomes a **fixed-capacity interval pool**
inside ``lax.while_loop``:

- pool arrays ``(a[cap], b[cap], val[cap, ...], err[cap])`` hold all intervals;
- each iteration selects the ``nbisect`` worst intervals with ``top_k``,
  bisects them in bulk, and evaluates all new Gauss-Kronrod nodes in a single
  batched integrand call (``2*nbisect*(2n+1)`` nodes -> one ``vmap``/batch
  panel);
- convergence follows the reference's semantics: stop when
  ``total_err <= max(abstol, reltol*norm(total_val))``
  (``src/interfaces.jl:91-104``).

Auxiliary error control (the reference's ``auxquadgk`` / ``AuxValue``) falls
out of treating the result as a pytree and taking the per-interval error to be
the max over the AuxValue channels, so refinement continues until *both* the
value and auxiliary converge.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from ..ops.quad_rules import kronrod
from ..utils.tree import tree_batched_norm, tree_norm
from ..wrappers import AuxValue


def _err_norm(tree, batch_ndim):
    """Per-interval error norm; AuxValue channels are controlled separately."""
    if isinstance(tree, AuxValue):
        return jnp.maximum(
            tree_batched_norm(tree.val, batch_ndim) if batch_ndim else tree_norm(tree.val),
            tree_batched_norm(tree.aux, batch_ndim) if batch_ndim else tree_norm(tree.aux),
        )
    if batch_ndim:
        return tree_batched_norm(tree, batch_ndim)
    return tree_norm(tree)


def _count_dtype():
    """Dtype for evaluation counters: FLOAT, not int32.  Nested stats sum
    per-node inner-solve counts (a single saturating search measured 450M
    evals), so an outer level can exceed 2^31 and an int32 counter would
    wrap NEGATIVE — permanently passing the ``evals < max_evals`` budget
    check.  f64 counts exactly to 2^53; with x64 off, f32 is exact to 2^24
    and merely loses ulps beyond (monotone, never wraps) — strictly safer
    than modular int32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _as_eval_budget(maxiters):
    """Evaluation budget as a float scalar (see ``_count_dtype``); accepts
    None, Python ints, and traced values (so ``maxiters`` can be a jit
    argument, reference ``src/interfaces.jl:64-69``)."""
    cdt = _count_dtype()
    if maxiters is None:
        return jnp.asarray(2**62, cdt)
    try:
        return jnp.asarray(min(2**62, int(maxiters)), cdt)
    except (TypeError, jax.errors.ConcretizationTypeError, jax.errors.TracerArrayConversionError):
        return jnp.asarray(maxiters).astype(cdt)


def gk_rule_eval(batch_f, p, aa, bb, xk, wk, wg, node_builder, stats=False):
    """Evaluate the GK rule on a batch of intervals.

    ``aa, bb``: (K,) interval endpoints.  Returns (val pytree with leading K,
    err (K,), l1 (K,), stat_sum).  ``l1`` is the per-interval rule estimate of
    the L1 mass ``int |f|`` — the scale of floating-point noise in the error
    estimate (|vk - vg| at convergence is ~eps * sum wk|f|, NOT ~eps * |I|),
    used by the guided tier's relative noise floor.  ``node_builder(xs_flat)
    -> integrand input`` lets callers lift 1D nodes into d-dim points
    (NestedQuad).  With ``stats``, ``batch_f`` returns (values, per-node
    counts) and the summed counts are threaded out — used to propagate exact
    integrand evaluation counts through nested solves.
    """
    K = aa.shape[0]
    npts = xk.shape[0]
    mid = (aa + bb) / 2
    half = (bb - aa) / 2
    nodes = mid[:, None] + half[:, None] * xk[None, :]  # (K, npts)
    flat = nodes.reshape(-1)
    out = batch_f(node_builder(flat), p)  # leaves (K*npts, ...)
    if stats:
        fx, per_node = out
        stat_sum = jnp.sum(per_node.astype(_count_dtype()))
    else:
        fx = out
        stat_sum = jnp.asarray(K * npts, _count_dtype())

    def per_leaf(v):
        v = v.reshape((K, npts) + v.shape[1:])
        wshape = (1, npts) + (1,) * (v.ndim - 2)
        hshape = (K,) + (1,) * (v.ndim - 2)
        # rule reductions run in the VALUE's (real-counterpart) dtype: f64
        # weights times c64 guide-tier values would otherwise promote the
        # cheap search tier to complex128
        if jnp.issubdtype(v.dtype, jnp.inexact):
            rdt = jnp.finfo(v.dtype).dtype
            wk_, wg_, half_ = wk.astype(rdt), wg.astype(rdt), half.astype(rdt)
        else:
            wk_, wg_, half_ = wk, wg, half
        vk = jnp.sum(wk_.reshape(wshape) * v, axis=1) * half_.reshape(hshape)
        vg = jnp.sum(wg_.reshape(wshape) * v, axis=1) * half_.reshape(hshape)
        vl = jnp.sum(wk_.reshape(wshape) * jnp.abs(v), axis=1) * half_.reshape(hshape)
        return vk, vg, vl

    leaves, treedef = jax.tree_util.tree_flatten(fx)
    trips = [per_leaf(v) for v in leaves]  # one trace per leaf, not three
    valk = jax.tree_util.tree_unflatten(treedef, [t[0] for t in trips])
    valg = jax.tree_util.tree_unflatten(treedef, [t[1] for t in trips])
    vall = jax.tree_util.tree_unflatten(treedef, [t[2] for t in trips])
    diff = jax.tree_util.tree_map(lambda k, g: k - g, valk, valg)
    err = _err_norm(diff, 1)
    l1 = _err_norm(vall, 1)
    # zero-width intervals are DEAD POOL SLOTS (top_k picks them while live
    # intervals < nbisect; the guided upgrade sweeps them in its last chunk)
    # whose nodes all collapse onto one point — which may be outside the
    # integrand's domain or a singular endpoint (x=0 of the [0, inf)
    # transform).  The evaluation still happens (fixed shapes), but its
    # result must not reach the pool: half=0 only zeroes finite values,
    # NaN * 0 = NaN.  Mask outputs to exactly 0.
    dead = half == 0

    def mask_leaf(v):
        return jnp.where(dead.reshape((K,) + (1,) * (v.ndim - 1)),
                         jnp.zeros((), v.dtype), v)

    valk = jax.tree_util.tree_map(mask_leaf, valk)
    err = jnp.where(dead, 0, err)
    l1 = jnp.where(dead, 0, l1)
    return valk, err, l1, stat_sum


def coarsen_pool(a, b, e, n, segs, tol, merge_factor=1e-3, target_mult=2.0):
    """Error-guided sibling coarsening of a warm-start interval pool — the
    on-device twin of ``nested._coarsen_partition`` (fixed shapes, no host).

    ``(a, b, e)`` are cap-length pool arrays with ``n`` live slots (unsorted,
    dead slots zero-width); ``segs`` the original domain breakpoints; ``tol``
    the absolute tolerance the pool certifies against.  Sorts the pool by
    left endpoint, drops zero-width dead slots, merges true dyadic sibling
    pairs, and compacts survivors to the front.  Two merge triggers:

    - **absolute**: pairs whose stored errors sum below ``merge_factor`` of
      their equidistributed tolerance share are always stale — merge.
    - **cap pressure**: error estimates can FLOOR at eval noise far above
      ``merge_factor * share`` (c64 Green's functions), so the absolute
      trigger alone never fires and the pool would grow monotonically until
      it saturates its capacity (measured on the SrVO3 omega sweep: warm
      seeds grew PAST the cold eval count).  Estimate the load-bearing
      interval count (errors above a tenth of their share), set a size
      target of ``target_mult`` times it, and merge the CHEAPEST sibling
      pairs until the pool fits — stale structure drops by construction,
      bounded pools regardless of noise floors.

    Merging is always valid (any contiguous cover is a legal starting heap;
    refinement re-splits anything merged too eagerly at the cost of one
    extra panel).  Only exact siblings merge (left child at an even dyadic
    index within its original segment), so no merge chains can conflict.
    Returns ``(a2, b2, n2)``.
    """
    cap = a.shape[0]
    dt = a.dtype
    live = jnp.arange(cap) < n
    order = jnp.argsort(jnp.where(live, a, jnp.inf))
    a_s, b_s, e_s = a[order], b[order], e[order]
    live_s = live[order]
    w = b_s - a_s
    live_s = live_s & (w > 0)  # zero-width dead slots drop
    L = segs[-1] - segs[0]
    nseg = segs.shape[0] - 1
    seg_id = jnp.clip(jnp.searchsorted(segs, a_s, side="right") - 1, 0, nseg - 1)
    s0 = segs[seg_id]
    # dyadic left-child test: (a - s0) / w is an EVEN integer (bisection
    # midpoints are exact in binary floating point)
    k = (a_s - s0) / jnp.where(w > 0, w, 1.0)
    is_left = jnp.abs(k - jnp.round(k / 2) * 2) < 1e-6

    def shift(x, fill):
        return jnp.concatenate([x[1:], jnp.full((1,), fill, x.dtype)])

    a_n = shift(a_s, 0)
    b_n = shift(b_s, 0)
    e_n = shift(e_s, 0)
    w_n = b_n - a_n
    live_n = shift(live_s, False)
    seg_n = shift(seg_id, -1)
    eps_w = 1e-9 * jnp.maximum(w, w_n)
    siblings = (live_s & live_n & is_left & (w > 0)
                & (jnp.abs(b_s - a_n) <= eps_w)
                & (jnp.abs(w - w_n) <= eps_w)
                & (seg_id == seg_n))
    Lsafe = jnp.maximum(L, jnp.finfo(dt).tiny)
    share = tol * (w + w_n) / Lsafe
    cost = e_s + e_n
    merge_abs = siblings & (cost < merge_factor * share)
    # cap-pressure trigger: cheapest sibling pairs merge until the pool fits
    # target_mult x the load-bearing count
    n_live = jnp.sum(live_s)
    load = jnp.sum(live_s & (e_s > 0.1 * tol * w / Lsafe))
    target = jnp.maximum(jnp.maximum((target_mult * load).astype(n_live.dtype),
                                     jnp.asarray(nseg + 1, n_live.dtype)),
                         jnp.asarray(8, n_live.dtype))
    need = jnp.clip(n_live - target, 0, cap)
    csort = jnp.sort(jnp.where(siblings, cost, jnp.inf))
    kth = csort[jnp.clip(need - 1, 0, cap - 1)]
    merge_cap = siblings & (need > 0) & (cost <= kth) & jnp.isfinite(kth)
    merge = merge_abs | merge_cap
    merged_right = jnp.concatenate([jnp.zeros((1,), bool), merge[:-1]])
    keep = live_s & ~merged_right
    new_b = jnp.where(merge, b_n, b_s)
    order2 = jnp.argsort(~keep, stable=True)  # kept slots first, order intact
    live2 = keep[order2]
    a2 = jnp.where(live2, a_s[order2], 0)
    b2 = jnp.where(live2, new_b[order2], 0)
    return a2, b2, jnp.sum(keep).astype(jnp.int32)


def _gk_tolerances(dt, abstol, reltol):
    rtol_default = jnp.sqrt(jnp.finfo(dt).eps)
    if abstol is None and reltol is None:
        return jnp.zeros((), dt), rtol_default
    return (jnp.asarray(0.0 if abstol is None else abstol, dt),
            jnp.asarray(0.0 if reltol is None else reltol, dt))


def gk_adaptive(
    batch_f: Callable,
    p,
    segs,
    *,
    order: int = 7,
    cap: int = 256,
    nbisect: int = 4,
    abstol=None,
    reltol=None,
    maxiters=None,
    node_builder=lambda x: x,
    norm=tree_norm,
    stats=False,
    noise_rfloor=0.0,
    stall_patience=0,
    init_pool=None,
    seed_width=None,
    seed_coarsen=True,
    presplit=1,
    _return_state=False,
):
    """Adaptive GK integration of ``batch_f`` over the segments ``segs``.

    ``presplit=P`` > 1 starts the pool from P uniform subintervals per
    starting segment, evaluated in ONE batched trip.  Batch width is cheap
    on the device while while_loop trip counts are the serial cost
    (docs/DESIGN.md "depth-bound"), so a presplit trades P× initial evals for the first
    ~log2(P) bisection iterations most solves would spend anyway.  Clamped
    so the pool keeps refinement room; ignored on warm starts (the seed IS
    the presplit).

    ``init_pool=(a, b, e, n)`` warm-starts the pool from a previous solve's
    surviving partition (cap-length endpoint/error arrays, ``n`` live slots):
    the seed is sibling-coarsened against its stored errors (``coarsen_pool``)
    and re-evaluated in refinement-sized chunks before the standard loop
    runs — each solve keeps its own certificate, only the STARTING partition
    is inherited.  Passing the initial segments as the pool reproduces the
    cold start exactly, so a warm scan chain needs no branching.

    ``noise_rfloor`` > 0 adds an L1-relative term to the convergence
    tolerance: ``tol = max(abstol, reltol*|I|, noise_rfloor*int|f|)``.  The
    rule's error estimate cannot resolve below ~eps * int|f| (catastrophic
    cancellation scales with the L1 mass, not the integral), so a tier whose
    eps is known (the guided c64 search: ~eps32) uses this to stop at its
    own noise floor instead of saturating the pool against an absolute
    tolerance it can never certify.

    ``stall_patience`` > 0 adds a model-free noise-floor detector: stop when
    ``stall_patience`` consecutive bisection steps fail to shrink the total
    error estimate below 0.97x its best-so-far.  At the eval-noise floor a
    bisection conserves noise mass (each child's err ~ eps * child L1, and
    the children's L1 sums to the parent's), so the total stalls exactly
    where refinement stops being informative — with no noise model.  This is
    the backstop for searches whose noise is *amplified* above eps * L1
    (e.g. c64 Green's functions: cancellation in det(z - H) scales with
    ||H||/eta, measured up to ~400x eps32 on the SrVO3 anchor).

    ``segs``: (S+1,) breakpoints (may be traced — nested limits produce them on
    device).  Returns ``(val, err, numevals, converged)``.
    """
    xk_np, wk_np, wg_np = kronrod(order)
    segs = jnp.asarray(segs)
    dt = segs.dtype
    xk = jnp.asarray(xk_np, dt)
    wk = jnp.asarray(wk_np, dt)
    wg = jnp.asarray(wg_np, dt)
    npts = xk.shape[0]
    nseg = segs.shape[0] - 1

    atol, rtol = _gk_tolerances(dt, abstol, reltol)
    max_evals = _as_eval_budget(maxiters)

    if init_pool is not None:
        # warm start: coarsen the inherited partition, then re-evaluate it at
        # the CURRENT parameter in refinement-sized chunks (a dynamic
        # trip-count while_loop — the device memory profile matches the
        # refinement body, never the whole pool at once)
        a_in, b_in, e_in, n_in = init_pool
        if seed_coarsen:
            a_c, b_c, n0 = coarsen_pool(jnp.asarray(a_in, dt),
                                        jnp.asarray(b_in, dt),
                                        jnp.asarray(e_in),
                                        jnp.asarray(n_in), segs, atol)
        else:
            # already-equilibrated seed (compact, dead slots zero-width):
            # skip the sibling coarsening — its vmapped sorts dominate the
            # COMPILE cost when this path is instantiated per nest-panel
            # lane (the mid-seed case: 120 lanes x 3 sorts x 2 call sites
            # wedged the remote AOT compiler)
            a_c, b_c = jnp.asarray(a_in, dt), jnp.asarray(b_in, dt)
            n0 = jnp.asarray(n_in)
        # seed evaluations have NO sequential dependency (unlike refinement,
        # where each step's top_k depends on the last) — a wide seed_width
        # collapses the seeding phase to ~one device iteration, bounded only
        # by the live memory of seed_width*npts inner solves
        C = min(max(seed_width or 2 * nbisect, 2 * nbisect, 2), cap)
        probe = jax.eval_shape(
            lambda: gk_rule_eval(batch_f, p, segs[:1], segs[1:2], xk, wk, wg,
                                 node_builder, stats)[0])
        pool_val = jax.tree_util.tree_map(
            lambda s: jnp.zeros((cap,) + s.shape[1:], s.dtype), probe)
        pool_err = jnp.zeros((cap,), dt)
        pool_l1 = jnp.zeros((cap,), dt)

        def seed_cond(st):
            return st[0] * C < n0

        def seed_body(st):
            k, pv, pe, pl, ev = st
            start = jnp.minimum(k * C, cap - C)
            aa = jax.lax.dynamic_slice(a_c, (start,), (C,))
            bb = jax.lax.dynamic_slice(b_c, (start,), (C,))
            cval, cerr, cl1, cstat = gk_rule_eval(batch_f, p, aa, bb, xk, wk,
                                                  wg, node_builder, stats)
            idx = start + jnp.arange(C)
            pv = jax.tree_util.tree_map(lambda x, c: x.at[idx].set(c), pv, cval)
            return k + 1, pv, pe.at[idx].set(cerr), pl.at[idx].set(cl1), ev + cstat

        _, pool_val, pool_err, pool_l1, evals0 = jax.lax.while_loop(
            seed_cond, seed_body,
            (jnp.asarray(0, n0.dtype), pool_val, pool_err, pool_l1,
             jnp.zeros((), max_evals.dtype)))
        pool_a, pool_b = a_c, b_c
    else:
        # initial evaluation of all starting segments (optionally P-presplit:
        # widths are static, so the clamp resolves at trace time)
        a0 = segs[:-1]
        b0 = segs[1:]
        P = max(1, min(int(presplit), (cap - 2 * nbisect) // max(nseg, 1)))
        if P > 1:
            t = jnp.arange(P + 1, dtype=dt) / P
            allpts = a0[:, None] + (b0 - a0)[:, None] * t[None, :]
            a0 = allpts[:, :-1].reshape(-1)
            b0 = allpts[:, 1:].reshape(-1)
            nseg = nseg * P
        val0, err0, l10, stat0 = gk_rule_eval(batch_f, p, a0, b0, xk, wk, wg, node_builder, stats)

        def pad_leaf(v):
            out = jnp.zeros((cap,) + v.shape[1:], v.dtype)
            return out.at[:nseg].set(v)

        pool_val = jax.tree_util.tree_map(pad_leaf, val0)
        pool_a = jnp.zeros((cap,), dt).at[:nseg].set(a0)
        pool_b = jnp.zeros((cap,), dt).at[:nseg].set(b0)
        pool_err = jnp.zeros((cap,), dt).at[:nseg].set(err0)
        pool_l1 = jnp.zeros((cap,), dt).at[:nseg].set(l10)
        # under shard_map the body writes integrand-derived (device-varying)
        # endpoints into the pools, so the carry must START varying like the
        # values do (outside shard_map this folds to a no-op) — same pattern as
        # grid_sweep's fori carry
        vary = jnp.real(err0[0]) * 0
        pool_a = pool_a + vary
        pool_b = pool_b + vary
        n0 = jnp.asarray(nseg, jnp.int32)
        evals0 = stat0.astype(max_evals.dtype)

    def totals(pool_val, pool_err):
        tot_val = jax.tree_util.tree_map(lambda v: jnp.sum(v, axis=0), pool_val)
        tot_err = jnp.sum(pool_err)
        return tot_val, tot_err

    # the floor may be a TRACED scalar (the auto-calibrated probe measures it
    # from the integrand at solve time), so the on/off decision is static but
    # the value need not be
    use_floor = noise_rfloor is not None and (
        isinstance(noise_rfloor, jax.Array) or bool(noise_rfloor))

    def tol_of(tot_val, pool_l1):
        tol = jnp.maximum(atol, rtol * norm(tot_val))
        if use_floor:
            tol = jnp.maximum(tol, noise_rfloor * jnp.sum(pool_l1))
        return tol

    def cond(state):
        pool_a, pool_b, pool_val, pool_err, pool_l1, n, evals, best, stall = state
        tot_val, tot_err = totals(pool_val, pool_err)
        tol = tol_of(tot_val, pool_l1)
        not_conv = tot_err > tol
        room = n + nbisect <= cap
        under_budget = evals < max_evals
        ok = not_conv & room & under_budget
        if stall_patience:
            ok = ok & (stall < stall_patience)
        return ok

    def body(state):
        pool_a, pool_b, pool_err_arr = state[0], state[1], state[3]
        pool_val, pool_l1_arr, n, evals = state[2], state[4], state[5], state[6]
        best, stall = state[7], state[8]
        # worst `nbisect` intervals
        _, idx = jax.lax.top_k(pool_err_arr, nbisect)
        aa = pool_a[idx]
        bb = pool_b[idx]
        mm = (aa + bb) / 2
        ca = jnp.concatenate([aa, mm])
        cb = jnp.concatenate([mm, bb])
        cval, cerr, cl1, cstat = gk_rule_eval(batch_f, p, ca, cb, xk, wk, wg, node_builder, stats)
        # Left children overwrite parents, right children go to fresh slots —
        # as two SEQUENTIAL scatters, not one combined scatter: while n <
        # nbisect, top_k picks uninitialized zero-error slots whose indices
        # collide with the fresh-slot range, and a combined scatter with
        # duplicate indices has unspecified winner in XLA.  Scattering the
        # fresh right children second makes them win deterministically.
        new_idx = n + jnp.arange(nbisect, dtype=n.dtype)
        li = idx.astype(n.dtype)

        def two_scatter(arr, left, right):
            return arr.at[li].set(left).at[new_idx].set(right)

        pool_a = two_scatter(pool_a, ca[:nbisect], ca[nbisect:])
        pool_b = two_scatter(pool_b, cb[:nbisect], cb[nbisect:])
        pool_err_arr = two_scatter(pool_err_arr, cerr[:nbisect], cerr[nbisect:])
        pool_l1_arr = two_scatter(pool_l1_arr, cl1[:nbisect], cl1[nbisect:])
        pool_val = jax.tree_util.tree_map(
            lambda pv, cv: two_scatter(pv, cv[:nbisect], cv[nbisect:]),
            pool_val, cval,
        )
        if stall_patience:
            _, tot_err_new = totals(pool_val, pool_err_arr)
            improved = tot_err_new < 0.97 * best
            # update best ONLY on a counted improvement (the host refine()
            # semantic, nested.py): slow-but-genuine convergence then
            # compounds across steps until it clears the 3% bar and resets
            # the stall counter, instead of every 1-2% step counting as a
            # stall against a running min
            best = jnp.where(improved, tot_err_new, best)
            stall = jnp.where(improved, 0, stall + 1)
        return (pool_a, pool_b, pool_val, pool_err_arr, pool_l1_arr,
                n + nbisect, evals + cstat, best, stall)

    best0 = jnp.asarray(jnp.inf, dt)
    stall0 = jnp.asarray(0, jnp.int32)
    state = (pool_a, pool_b, pool_val, pool_err, pool_l1, n0, evals0,
             best0, stall0)
    state = jax.lax.while_loop(cond, body, state)
    pool_a, pool_b, pool_val, pool_err, pool_l1, n, evals = state[:7]
    tot_val, tot_err = totals(pool_val, pool_err)
    tol = tol_of(tot_val, pool_l1)
    converged = tot_err <= tol
    if _return_state:
        return tot_val, tot_err, evals, converged, state
    return tot_val, tot_err, evals, converged


def gk_adaptive_guided(
    batch_f32: Callable,
    batch_f: Callable,
    p32,
    p,
    segs,
    *,
    order: int = 7,
    cap: int = 256,
    nbisect: int = 4,
    abstol=None,
    reltol=None,
    guide_rfloor=2e-5,
    maxiters=None,
    node_builder=lambda x: x,
    norm=tree_norm,
    stats=False,
    upgrade_chunk=None,
    stall_patience=6,
    search_slack=1.0,
    presplit=1,
):
    """Low-precision-guided adaptive GK: search in f32, evaluate in split-f64.

    Three-phase integrator with no reference counterpart (the reference
    integrates in f64 throughout, ``src/algorithms.jl:73-91``):

    1. **Search** — run the standard interval-pool refinement with the cheap
       ``batch_f32`` integrand tier until the f32 error estimate reaches
       ``max(abstol, reltol·‖I‖, guide_rfloor·∫|f|)``.  The L1-relative term
       is the f32 noise model: the rule's error estimate bottoms out at
       ~eps32·∫|f| (cancellation scales with the absolute mass, not the
       integral), so flooring on ∫|f| stops the search exactly where f32
       stops being informative — flooring on ‖I‖ instead was measured to
       saturate every search pool at tight absolute tolerances (450M evals
       vs split's 23.7M on the SrVO3 nest at abstol 1e-5).  This finds
       *where* the integrand needs subdivision at a fraction of the
       split-f64 eval cost.  ``stall_patience`` backstops the noise model:
       eval noise can be *amplified* far above eps32·∫|f| (c64 Green's
       functions: cancellation in det(z−H) scales with ‖H‖/η, measured
       ~400×eps32 on the SrVO3 anchor), and a stalled total error estimate
       detects that floor with no model at all.
    2. **Upgrade** — re-evaluate the final pool's intervals with the accurate
       ``batch_f`` tier in chunks of ``upgrade_chunk`` intervals (a dynamic
       trip-count ``while_loop``, so only ~n/chunk chunks of real work run,
       not cap/chunk), producing true f64 values and error estimates.
    3. **Polish** — continue the standard refinement loop with ``batch_f``
       until the *f64* certificate meets ``max(abstol, reltol·‖I‖)``; for a
       well-guided search this phase runs few or zero iterations.

    Since refinement roughly doubles evaluation work (every kept interval's
    parent chain was also evaluated), phase 2 costs about half of a pure
    split-f64 refinement *per level* — and in a nest the saving compounds
    multiplicatively across levels.

    ``numevals`` counts every actual integrand evaluation of BOTH tiers.
    """
    xk_np, wk_np, wg_np = kronrod(order)
    segs = jnp.asarray(segs)
    dt = segs.dtype
    xk = jnp.asarray(xk_np, dt)
    wk = jnp.asarray(wk_np, dt)
    wg = jnp.asarray(wg_np, dt)
    npts = xk.shape[0]

    atol, rtol = _gk_tolerances(dt, abstol, reltol)
    max_evals = _as_eval_budget(maxiters)

    # ---- phase 1: f32-tier search (full pool machinery, floored reltol) ----
    # search_slack > 1 stops the search at a looser tolerance than the final
    # certificate: the search's only job is to FIND the partition, and the
    # split-tier polish (phase 3) refines the remainder — trading cheap
    # search-tier evals for a few expensive accurate-tier ones
    s_atol = atol * search_slack
    s_rtol = rtol * search_slack
    _, _, evals32, _, state32 = gk_adaptive(
        batch_f32, p32, segs, order=order, cap=cap, nbisect=nbisect,
        abstol=s_atol, reltol=s_rtol, noise_rfloor=guide_rfloor,
        stall_patience=stall_patience, presplit=presplit,
        maxiters=maxiters, node_builder=node_builder, norm=norm, stats=stats,
        _return_state=True,
    )
    pool_a, pool_b, n = state32[0], state32[1], state32[5]

    # ---- phase 2: chunked split-f64 upgrade of the surviving intervals -----
    C = int(upgrade_chunk) if upgrade_chunk else max(2 * nbisect, 4)
    C = min(C, cap)

    # fresh split-tier pools; unused slots keep zero-width (0, 0) intervals
    # whose rule values/errors come out exactly 0
    probe = jax.eval_shape(
        lambda: gk_rule_eval(batch_f, p, segs[:1], segs[1:2], xk, wk, wg,
                             node_builder, stats)[0]
    )
    pool_val = jax.tree_util.tree_map(
        lambda s: jnp.zeros((cap,) + s.shape[1:], s.dtype), probe)
    pool_err = jnp.zeros((cap,), dt)
    live = jnp.arange(cap) < n
    ua = jnp.where(live, pool_a, 0.0)
    ub = jnp.where(live, pool_b, 0.0)

    def up_cond(st):
        k = st[0]
        return k * C < n

    def up_body(st):
        k, pv, pe, ev = st
        start = jnp.minimum(k * C, cap - C)
        aa = jax.lax.dynamic_slice(ua, (start,), (C,))
        bb = jax.lax.dynamic_slice(ub, (start,), (C,))
        cval, cerr, _, cstat = gk_rule_eval(batch_f, p, aa, bb, xk, wk, wg,
                                            node_builder, stats)
        idx = start + jnp.arange(C)
        pv = jax.tree_util.tree_map(lambda a, c: a.at[idx].set(c), pv, cval)
        pe = pe.at[idx].set(cerr)
        return k + 1, pv, pe, ev + cstat

    _, pool_val, pool_err, evals = jax.lax.while_loop(
        up_cond, up_body, (jnp.asarray(0, n.dtype), pool_val, pool_err,
                           evals32))

    # ---- phase 3: polish with the accurate tier until the f64 certificate --
    def totals(pv, pe):
        tv = jax.tree_util.tree_map(lambda v: jnp.sum(v, axis=0), pv)
        return tv, jnp.sum(pe)

    def cond(state):
        _, _, pv, pe, nn, ev = state
        tv, te = totals(pv, pe)
        tol = jnp.maximum(atol, rtol * norm(tv))
        return (te > tol) & (nn + nbisect <= cap) & (ev < max_evals)

    def body(state):
        pa, pb, pv, pe, nn, ev = state
        _, idx = jax.lax.top_k(pe, nbisect)
        aa = pa[idx]
        bb = pb[idx]
        mm = (aa + bb) / 2
        ca = jnp.concatenate([aa, mm])
        cb = jnp.concatenate([mm, bb])
        cval, cerr, _, cstat = gk_rule_eval(batch_f, p, ca, cb, xk, wk, wg,
                                            node_builder, stats)
        new_idx = nn + jnp.arange(nbisect, dtype=nn.dtype)
        li = idx.astype(nn.dtype)

        def two_scatter(arr, left, right):
            return arr.at[li].set(left).at[new_idx].set(right)

        pa = two_scatter(pa, ca[:nbisect], ca[nbisect:])
        pb = two_scatter(pb, cb[:nbisect], cb[nbisect:])
        pe = two_scatter(pe, cerr[:nbisect], cerr[nbisect:])
        pv = jax.tree_util.tree_map(
            lambda a, c: two_scatter(a, c[:nbisect], c[nbisect:]), pv, cval)
        return pa, pb, pv, pe, nn + nbisect, ev + cstat

    state = (ua, ub, pool_val, pool_err, n, evals)
    state = jax.lax.while_loop(cond, body, state)
    _, _, pool_val, pool_err, n, evals = state
    tot_val, tot_err = totals(pool_val, pool_err)
    tol = jnp.maximum(atol, rtol * norm(tot_val))
    return tot_val, tot_err, evals, tot_err <= tol


def fixed_rule_eval(batch_f, p, segs, x, w, node_builder=lambda x: x, stats=False):
    """Apply a fixed rule (nodes ``x``, weights ``w`` on [-1,1]) to each
    segment of ``segs`` and sum (reference ``QuadratureFunction`` semantics,
    ``src/algorithms.jl:156-191``)."""
    segs = jnp.asarray(segs)
    x = jnp.asarray(x, segs.dtype)
    w = jnp.asarray(w, segs.dtype)
    aa = segs[:-1]
    bb = segs[1:]
    mid = (aa + bb) / 2
    half = (bb - aa) / 2
    nodes = (mid[:, None] + half[:, None] * x[None, :]).reshape(-1)  # (S*npt,)
    out = batch_f(node_builder(nodes), p)
    S = aa.shape[0]
    npt = x.shape[0]
    if stats:
        fx, per_node = out
        stat_sum = jnp.sum(per_node.astype(_count_dtype()))
    else:
        fx = out
        stat_sum = jnp.asarray(S * npt, _count_dtype())

    def leaf(v):
        v = v.reshape((S, npt) + v.shape[1:])
        wshape = (1, npt) + (1,) * (v.ndim - 2)
        hshape = (S,) + (1,) * (v.ndim - 2)
        if jnp.issubdtype(v.dtype, jnp.inexact):  # see per_leaf dtype note
            rdt = jnp.finfo(v.dtype).dtype
            w_, half_ = w.astype(rdt), half.astype(rdt)
        else:
            w_, half_ = w, half
        return jnp.sum(jnp.sum(w_.reshape(wshape) * v, axis=1) * half_.reshape(hshape), axis=0)

    return jax.tree_util.tree_map(leaf, fx), stat_sum
