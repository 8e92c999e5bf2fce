"""Fourier/Wannier fast path.

Native equivalent of reference ``src/fourier.jl`` (the package's raison
d'etre, see its design commentary at ``src/fourier.jl:1-16``) plus the
FourierSeriesEvaluators.jl surface it reexports:

- :class:`FourierSeries`: dense coefficient tensor + period/offset — a pytree,
  so series coefficients live on device and flow through jit/vmap.
- :class:`JacobianSeries`: evaluates ``(H(x), grad_z H(x))`` with closed-form
  derivative coefficients (``(2 pi i f) c_f``), *not* AD, matching reference
  semantics (``src/dos_ggr.jl:6-11``).
- :class:`FourierValue`: the ``(x, s)`` pair passed to user kernels
  (``src/fourier.jl:111``).
- :class:`FourierIntegrand`: bundles a user kernel with a series; compatible
  algorithms evaluate the series efficiently (grid contraction for PTR rules,
  per-level contraction for nested quadrature), replacing the reference's
  ``FourierWorkspace`` thread-replica machinery with batched contractions.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .ops.fourier_eval import (
    contract,
    evaluate_grid,
    evaluate_points,
    evaluate_points_jacobian,
    phase_matrix,
)
from .parameters import MixedParameters, NullParameters, ParameterIntegrand, merge_parameters


def _tuple_d(v, d, cast):
    if np.ndim(v) == 0:
        return (cast(v),) * d
    t = tuple(cast(x) for x in v)
    if len(t) != d:
        raise ValueError("per-dimension data must have length d")
    return t


@jax.tree_util.register_pytree_node_class
class FourierSeries:
    """d-dimensional trigonometric interpolant of (possibly matrix-valued)
    coefficients: ``s(x) = sum_n c[n] exp(2 pi i (n + offset) . x / period)``.

    ``c`` has shape ``(n_1, ..., n_d, *valshape)``; pass ``ndim=d`` when the
    values are arrays (e.g. ``(n1, n2, n3, m, m)`` Wannier Hamiltonians).
    ``offset[j]`` is the frequency index of ``c[0, ..., 0]`` along dim j
    (default: centered, ``-(n_j - 1) // 2``).
    """

    def __init__(self, c, period=1.0, offset=None, ndim=None, dtype=jnp.complex128):
        # Coefficients stay HOST-resident (numpy) unless already traced: they
        # are rule-construction data, embedded in programs as literals.
        if not isinstance(c, jax.core.Tracer):
            c = np.asarray(c, dtype)
        d = ndim if ndim is not None else c.ndim
        self.c = c
        self.sndim = int(d)
        self.period = _tuple_d(period, d, float)
        if offset is None:
            offset = tuple(-((c.shape[j] - 1) // 2) for j in range(d))
        self.offset = _tuple_d(offset, d, int)
        self.dtype = dtype

    @property
    def ndim(self):
        return self.sndim

    @property
    def valshape(self):
        return self.c.shape[self.sndim:]

    def tree_flatten(self):
        return (self.c,), (self.sndim, self.period, self.offset, self.dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        sndim, period, offset, dtype = aux
        obj = object.__new__(cls)
        obj.c = children[0]
        obj.sndim = sndim
        obj.period = period
        obj.offset = offset
        obj.dtype = dtype
        return obj

    # --- evaluation -------------------------------------------------------
    def __call__(self, x):
        x = jnp.atleast_1d(jnp.asarray(x))
        out = evaluate_points(self.c, self.sndim, x[None, :], self.offset, self.period, None, self.dtype)
        return out[0]

    def eval_points(self, X):
        return evaluate_points(self.c, self.sndim, X, self.offset, self.period, None, self.dtype)

    def eval_grid(self, nodes):
        nodes = [nodes] * self.sndim if not isinstance(nodes, (list, tuple)) else nodes
        return evaluate_grid(self.c, self.sndim, nodes, self.offset, self.period, None, self.dtype)

    def contract(self, x):
        """Fix the last variable; returns the (d-1)-dim series (the workspace
        contraction, reference ``src/fourier.jl:478``)."""
        c2 = contract(self.c, self.sndim, x, self.offset, self.period, None, self.dtype)
        obj = object.__new__(FourierSeries)
        obj.c = c2
        obj.sndim = self.sndim - 1
        obj.period = self.period[:-1]
        obj.offset = self.offset[:-1]
        obj.dtype = self.dtype
        return obj


@jax.tree_util.register_pytree_node_class
class JacobianSeries:
    """Evaluates to the tuple ``(H(x), V(x))`` with ``V[j] = dH/dz_j``
    (z = x/period), via closed-form derivative coefficients."""

    def __init__(self, s: FourierSeries):
        self.s = s

    @property
    def ndim(self):
        return self.s.sndim

    @property
    def sndim(self):
        # expose the wrapped series' spatial dimension so the BZ layer's
        # series/BZ dimension guard works through the Jacobian wrapper
        # (brillouin.py reads getattr(s, 'sndim', ...))
        return self.s.sndim

    @property
    def period(self):
        return self.s.period

    def tree_flatten(self):
        return (self.s,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])

    def eval_points(self, X):
        return evaluate_points_jacobian(
            self.s.c, self.s.sndim, X, self.s.offset, self.s.period, self.s.dtype
        )

    def __call__(self, x):
        x = jnp.atleast_1d(jnp.asarray(x))
        h, v = self.eval_points(x[None, :])
        return h[0], v[0]


@jax.tree_util.register_pytree_node_class
class FourierValue:
    """Point ``x`` and evaluated series ``s`` handed to user kernels."""

    def __init__(self, x, s):
        self.x = x
        self.s = s

    def tree_flatten(self):
        return (self.x, self.s), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def __repr__(self):
        return f"FourierValue(x={self.x!r}, s={self.s!r})"


class StoredSeriesValues:
    """Series values stored as (re, im) real array pairs.

    Persisted rule data is split into real pairs at jit boundaries and
    re-joined inside compiled programs (a complex-splitting boundary queued
    for removal, ROADMAP D2).
    """

    def __init__(self, parts, jacobian):
        self.parts = parts
        self.jacobian = jacobian

    def join(self):
        if self.jacobian:
            (hr, hi), (vr, vi) = self.parts
            return hr + 1j * hi, vr + 1j * vi
        re, im = self.parts
        return re + 1j * im


# pytree: stored rule data crosses jit boundaries as runtime ARGUMENTS —
# closed-over MB-scale constants bloat the HLO shipped to the remote compile
# helper (the SrVO3 npt=100 stored-series sweep kernel measured 365-520 s to
# compile as literals)
jax.tree_util.register_pytree_node(
    StoredSeriesValues,
    lambda s: ((s.parts,), s.jacobian),
    lambda jac, parts: StoredSeriesValues(parts[0], jac),
)


class FourierIntegrand:
    """``FourierIntegrand(f, s, *args, **kwargs)``: integrand evaluating
    ``f(FourierValue(x, s(x)), *args, **kwargs)`` with the series evaluated
    efficiently by compatible algorithms (reference ``src/fourier.jl:22-58``)."""

    def __init__(self, f, s, *args, **kwargs):
        self.rep = kwargs.pop("rep", None)
        if isinstance(f, ParameterIntegrand):
            self.pf = f
        else:
            self.pf = ParameterIntegrand(f, *args, **kwargs)
        if isinstance(s, (FourierSeries, JacobianSeries)):
            self.s = s
        else:
            raise TypeError("FourierIntegrand requires a FourierSeries/JacobianSeries")

    @property
    def p(self):
        return self.pf.p

    @property
    def f(self):
        return self.pf

    def with_parameters(self, p):
        bare = FourierIntegrand(ParameterIntegrand(self.pf.f), self.s)
        bare.rep = self.rep
        return bare, merge_parameters(self.p, p)

    # --- fallback pointwise evaluation (unspecialized algorithms) ---------
    def __call__(self, x, p=NullParameters()):
        x = jnp.atleast_1d(jnp.asarray(x))
        return self.pf(FourierValue(x, self.s(x)), p)

    # --- specialized PTR rule support -------------------------------------
    def series_values_on_grid(self, npt, frac=None):
        """Evaluate the series on the full ``npt^d`` fractional tensor grid by
        hierarchical contraction, then (optionally) gather the symmetry
        representatives ``frac`` (K, d) — the stored-series design of the
        reference's ``FourierPTR``/``FourierMonkhorstPack``
        (``src/fourier.jl:127-130,210-214``).

        Returns a :class:`StoredSeriesValues` holding (re, im) real device
        arrays: complex data never crosses a jit boundary, coefficients enter
        as HLO literals.
        """
        d = self.s.ndim
        periods = self.s.period  # JacobianSeries forwards the base period
        u = [np.arange(npt) / npt * periods[j] for j in range(d)]
        if frac is not None:
            idx = np.rint(np.asarray(frac) * npt).astype(np.int64)
            lin = np.ravel_multi_index(tuple(idx.T), (npt,) * d)
        else:
            lin = None
        if isinstance(self.s, JacobianSeries):
            base = self.s.s

            @jax.jit
            def ev():
                h = evaluate_grid(base.c, d, u, base.offset, base.period, None, base.dtype)
                grads = []
                for j in range(d):
                    derivs = tuple(1 if i == j else 0 for i in range(d))
                    grads.append(evaluate_grid(base.c, d, u, base.offset, base.period, derivs, base.dtype))
                v = jnp.stack(grads, axis=d)
                h = h.reshape((-1,) + h.shape[d:])
                v = v.reshape((-1, d) + v.shape[d + 1:])
                if lin is not None:
                    h = h[lin]
                    v = v[lin]
                return (jnp.real(h), jnp.imag(h)), (jnp.real(v), jnp.imag(v))

            return StoredSeriesValues(ev(), jacobian=True)
        ser = self.s

        @jax.jit
        def ev():
            vals = evaluate_grid(ser.c, d, u, ser.offset, ser.period, None, ser.dtype)
            flat = vals.reshape((-1,) + vals.shape[d:])
            if lin is not None:
                flat = flat[lin]
            return jnp.real(flat), jnp.imag(flat)

        return StoredSeriesValues(ev(), jacobian=False)

    def user_batch_fn(self):
        """``g(xs (K,d), stored, p)``: vmapped user kernel over stored series
        values (joined to complex inside the jit that calls this)."""
        pf = self.pf

        def g(xs, stored, p):
            svals = stored.join()

            def one(x, s, q):
                return pf(FourierValue(x, s), q)

            in_axes = (0, (0, 0) if isinstance(svals, tuple) else 0, None)
            return jax.vmap(one, in_axes=in_axes)(xs, svals, p)

        return g

    # --- nested quadrature support ----------------------------------------
    def nest_carrier(self, split=False, downcast=False):
        if isinstance(self.s, JacobianSeries):
            # Carry (H, dH) through the nest by AUGMENTATION: the derivative
            # series' coefficients are static tensors c * (2 pi i f_j), so
            # stacking them as a leading value channel makes every contraction
            # level jacobian-aware for free (the reference's FourierWorkspace
            # is series-type-generic the same way, src/fourier.jl:478).  The
            # user kernel still receives the (H, V) tuple via an unpacker.
            base = self.s.s
            c = np.asarray(base.c)
            d = base.sndim
            chans = [c]
            for j in range(d):
                f = np.arange(c.shape[j]) + base.offset[j]
                shape = [1] * c.ndim
                shape[j] = -1
                chans.append(c * (2j * np.pi * f).reshape(shape))
            c_aug = np.stack(chans, axis=d)  # (*spatial, d+1, *value)
            aug = FourierSeries(c_aug, period=base.period, offset=base.offset,
                                ndim=d, dtype=base.dtype)
            return _build_nest_carrier(_JacobianUnpack(self.pf), aug, split, downcast)
        return _build_nest_carrier(self.pf, self.s, split, downcast)


def _build_nest_carrier(pf, s, split, downcast):
    if downcast:
        # guide tier for the f32-search/split-evaluate nest: the same
        # series downcast to complex64 so search-phase evaluations stay in
        # single precision even under x64 tracing (phase_matrix computes
        # in the real counterpart of the series dtype)
        c64 = np.asarray(s.c).astype(np.complex64)
        return FourierCarrier(pf, FourierSeries(
            c64, period=s.period, offset=s.offset, ndim=s.sndim,
            dtype=jnp.complex64))
    if split:
        if not jax.config.jax_enable_x64:
            raise RuntimeError(
                "split-complex f64 carriers require jax_enable_x64=True "
                "(with x64 off the f64 pairs silently downcast to f32, "
                "defeating the double-precision tier)"
            )
        c = np.asarray(s.c)  # host coefficients -> f64 literal pairs
        return SplitFourierCarrier(
            pf,
            jnp.asarray(c.real, jnp.float64),
            jnp.asarray(c.imag, jnp.float64),
            s.offset, s.period, s.sndim,
        )
    return FourierCarrier(pf, s)


class _JacobianUnpack:
    """Adapter handing the user kernel the (H, V) tuple from an augmented
    (channel-stacked) series value: channel 0 is H, channels 1..d are dH/dz_j
    (see the JacobianSeries branch of ``FourierIntegrand.nest_carrier``)."""

    def __init__(self, pf):
        self.pf = pf

    @property
    def p(self):
        return self.pf.p

    def with_parameters(self, p):
        return _JacobianUnpack(self.pf.with_parameters(p))

    def __call__(self, v, p):
        # works for plain arrays AND SplitComplex (both index channel-first)
        return self.pf(FourierValue(v.x, (v.s[0], v.s[1:])), p)


class FourierCarrier:
    """Per-level series state for NestedQuad: fixing the outer coordinate
    contracts the coefficient tensor once, amortized over the whole inner
    panel (reference ``workspace_contract!`` at ``src/fourier.jl:478``)."""

    def __init__(self, pf, series: FourierSeries):
        self.pf = pf
        self.series = series

    def fix(self, x):
        return FourierCarrier(self.pf, self.series.contract(x))

    def eval_batch(self, xs, coords, p):
        from .algorithms.nested import assemble_points

        s = self.series
        assert s.sndim == 1
        ph = phase_matrix(xs, s.c.shape[0], s.offset[0], s.period[0], 0, s.dtype)
        flatc = s.c.reshape(s.c.shape[0], -1)
        # HIGHEST precision: a reduced-precision f32 matmul default (bf16 or
        # TF32 passes) costs percent-level DOS error at sharp spectral peaks
        # through this innermost evaluation
        svals = jnp.matmul(ph, flatc, precision=jax.lax.Precision.HIGHEST)
        svals = svals.reshape((xs.shape[0],) + s.c.shape[1:])
        pts = assemble_points(xs, coords)

        def one(x, sv):
            return self.pf(FourierValue(x, sv), p)

        return jax.vmap(one, in_axes=(0, 0))(pts, svals)


class SplitFourierCarrier:
    """Split-complex (f64 pairs) twin of :class:`FourierCarrier`, behind the
    opt-in ``IAI(precision="split"|"guided")`` tiers.

    Coefficients live as (re, im) f64 pairs and every contraction is
    elementwise or a single non-batched HIGHEST-precision tensordot, so the
    whole nested adaptive solve runs in double precision without ever
    materializing complex128.
    User kernels receive ``FourierValue(x, SplitComplex(h_re, h_im))``; the
    shipped observables (``models/observables``) handle both value types.

    The reference's headline IAI-at-tight-tolerance capability
    (``src/brillouin.jl:361-377``) also runs on the default complex128 path.
    """

    def __init__(self, pf, c_re, c_im, offset, period, sndim):
        self.pf = pf
        self.c_re = c_re
        self.c_im = c_im
        self.offset = offset
        self.period = period
        self.sndim = sndim

    def fix(self, x):
        """Contract the last spatial dim at scalar ``x`` (elementwise, f64-safe)."""
        from .ops.csplit_eval import phase_cs

        d = self.sndim
        n = self.c_re.shape[d - 1]
        cos, sin = phase_cs(jnp.reshape(x, (1,)), n, self.offset[d - 1],
                            self.period[d - 1], self.c_re.dtype)
        shp = (1,) * (d - 1) + (n,) + (1,) * (self.c_re.ndim - d)
        cb, sb = cos.reshape(shp), sin.reshape(shp)
        re2 = jnp.sum(self.c_re * cb - self.c_im * sb, axis=d - 1)
        im2 = jnp.sum(self.c_re * sb + self.c_im * cb, axis=d - 1)
        return SplitFourierCarrier(self.pf, re2, im2, self.offset[:-1],
                                   self.period[:-1], d - 1)

    def eval_batch(self, xs, coords, p):
        from .algorithms.nested import assemble_points
        from .ops.csplit_eval import contract_split, phase_cs
        from .ops.scomplex import SplitComplex

        assert self.sndim == 1
        n = self.c_re.shape[0]
        cos, sin = phase_cs(xs, n, self.offset[0], self.period[0], self.c_re.dtype)
        fre = self.c_re.reshape(n, -1)
        fim = self.c_im.reshape(n, -1)
        sre, sim = contract_split(fre, fim, cos, sin, 0)  # (K, V)
        vshape = (xs.shape[0],) + self.c_re.shape[1:]
        sre = sre.reshape(vshape)
        sim = sim.reshape(vshape)
        pts = assemble_points(xs, coords)

        def one(x, a, b):
            return self.pf(FourierValue(x, SplitComplex(a, b)), p)

        return jax.vmap(one, in_axes=(0, 0, 0))(pts, sre, sim)
