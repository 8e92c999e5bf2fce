"""Lindhard (non-interacting) susceptibility chi0(q, omega).

The canonical two-grid BZ workload after the DOS: the particle-hole bubble

    chi0(q, w) = (|det B| / npt^d) sum_k sum_{nm} |<u_n(k)|u_m(k+q)>|^2
                 (f_n(k) - f_m(k+q)) / (w + i eta + e_n(k) - e_m(k+q))

with Bloch overlap matrix elements from the eigenvector grid.  Shape:
ONE batched (H, eigh) build on the full ``npt^d`` grid; every momentum
transfer ``q`` ON THE GRID is a pure ``jnp.roll`` of the cached energies
and eigenvectors (no re-evaluation), and each (q, omega-chunk) query is a
broadcast reduction.  Requires a full-zone BZ — the integrand couples k
and k+q, so the symmetry-reduced weight trick does not apply pointwise.

Conventions: retarded, ``Im chi0 <= 0`` for ``w > 0``; the static
long-wavelength limit recovers the thermally smeared compressibility,
``Re chi0(q -> 0, 0) -> |det B| * mean_k sum_n f'(e_n) = -beta |det B| *
mean[f (1 - f)]`` (the tested anchor), and ``Im chi0`` vanishes for
frequencies inside a band gap (no particle-hole continuum).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..fourier import FourierSeries
from .transport import fermi


class LindhardSolver:
    """Reusable chi0 queries over one cached (e, U) grid.

    >>> slv = LindhardSolver(h, bz, npt=64, beta=50.0, mu=0.0, eta=1e-2)
    >>> slv(q=[0.25, 0.0], omegas=jnp.linspace(0, 4, 200))   # (W,) complex

    ``q`` is in FRACTIONAL coordinates and is snapped to the nearest grid
    vector (exact rolls; pass multiples of 1/npt for no snapping).
    """

    def __init__(self, h: FourierSeries, bz, npt, beta, mu=0.0, eta=1e-2):
        from ..ops.fourier_eval import evaluate_grid

        if getattr(bz, "syms", None) is not None:
            raise ValueError(
                "LindhardSolver requires a full-zone BZ (load_bz(FBZ, ...)): "
                "chi0 couples k and k+q, so pointwise IBZ weights do not apply"
            )
        d = bz.ndim
        self.npt = int(npt)
        self.ndim = d
        self.beta = float(beta)
        self.mu = float(mu)
        self.eta = float(eta)
        self._vol = abs(np.linalg.det(np.asarray(bz.B, dtype=np.float64)))
        u = [np.arange(npt) / npt * h.period[j] for j in range(d)]

        @jax.jit
        def build(cre, cim):
            c = (cre + 1j * cim).astype(h.dtype)
            hk = evaluate_grid(c, d, u, h.offset, h.period, None, h.dtype)
            if hk.ndim == d:  # scalar series
                hk = hk[..., None, None]
            e, U = jnp.linalg.eigh(hk)       # (npt,)*d + (m,) / (m, m)
            return e, jnp.real(U), jnp.imag(U)

        c = np.asarray(h.c)
        e, Ur, Ui = build(jnp.asarray(c.real), jnp.asarray(c.imag))
        self._e, self._Ur, self._Ui = e, Ur, Ui
        self._m = int(e.shape[-1])
        self._query = self._build_query()

    def _build_query(self):
        d, beta, mu, eta = self.ndim, self.beta, self.mu, self.eta
        vol, npt = self._vol, self.npt

        @jax.jit
        def query(e, Ur, Ui, shift, om_all):
            U = Ur + 1j * Ui
            eq = e
            Uq = U
            for ax in range(d):
                eq = jnp.roll(eq, -shift[ax], axis=ax)
                Uq = jnp.roll(Uq, -shift[ax], axis=ax)
            # overlap weights |<u_n(k)|u_m(k+q)>|^2: (K..., n, m)
            O = jnp.einsum("...in,...im->...nm", jnp.conj(U), Uq)
            W2 = jnp.abs(O) ** 2
            f = fermi(beta * (e - mu))
            fq = fermi(beta * (eq - mu))
            df = f[..., :, None] - fq[..., None, :]          # (K..., n, m)
            de = e[..., :, None] - eq[..., None, :]

            def at(om):
                den = om + 1j * eta + de
                val = jnp.sum(W2 * df / den) / (npt**d) * vol
                # (re, im) pair, joined on host in __call__ (a
                # complex-splitting boundary, ROADMAP D2)
                return jnp.real(val), jnp.imag(val)

            return jax.vmap(at)(om_all)

        return query

    def __call__(self, q, omegas):
        q = np.atleast_1d(np.asarray(q, dtype=np.float64))
        if q.shape != (self.ndim,):
            raise ValueError(f"q must have {self.ndim} components, got {q.shape}")
        shift = tuple(int(np.rint(qi * self.npt)) % self.npt for qi in q)
        om = jnp.atleast_1d(jnp.asarray(omegas))
        re, im = self._query(self._e, self._Ur, self._Ui, jnp.asarray(shift), om)
        return np.asarray(re) + 1j * np.asarray(im)


def cooper_bubble(slv: LindhardSolver, q=None):
    """Static particle-particle (Cooper) bubble on a :class:`LindhardSolver`
    grid, band-diagonal singlet form with time-reversed partners:

        chi_pp(q) = |det B| mean_k sum_n
                    (1 - f(xi_n(k)) - f(xi_n(-k + q))) / (xi_n(k) + xi_n(-k + q))

    with ``xi = e - mu``; the degenerate-denominator limit is taken
    analytically (``tanh(beta xi / 2) / (2 xi) -> beta / 4``).  The q = 0
    value carries the Cooper logarithm, ``chi_pp ~ N(mu) ln(beta W)`` —
    successive temperature halvings grow it by ``N(mu) ln 2`` (the tested
    anchor, with ``N(mu)`` from an independent GGR DOS).
    """
    d = slv.ndim
    q = np.zeros(d) if q is None else np.atleast_1d(np.asarray(q, np.float64))
    if q.shape != (d,):
        raise ValueError(f"q must have {d} components, got {q.shape}")
    shift = tuple(int(np.rint(qi * slv.npt)) % slv.npt for qi in q)

    @jax.jit
    def query(e, shift):
        xi = e - slv.mu
        rev = xi
        for ax in range(d):  # k -> -k: index i -> (-i) mod npt
            rev = jnp.roll(jnp.flip(rev, axis=ax), 1, axis=ax)
        for ax in range(d):  # then -k -> -k + q
            rev = jnp.roll(rev, -shift[ax], axis=ax)
        beta = slv.beta
        f1 = fermi(beta * xi)
        f2 = fermi(beta * rev)
        den = xi + rev
        num = 1.0 - f1 - f2
        tiny = jnp.abs(den) < 1e-10
        val = jnp.where(tiny, beta * f1 * (1.0 - f1),
                        num / jnp.where(tiny, 1.0, den))
        return jnp.mean(val) * slv._vol

    return float(query(slv._e, jnp.asarray(shift)))


def certified_chi0(h, bz, q, omegas, beta, mu=0.0, eta=1e-2, abstol=1e-3,
                   reltol=0.0, nmin=24, nmax=480, factor=2**0.5):
    """Richardson-certified Lindhard map vs the k-grid: run
    ``LindhardSolver(h, bz, npt, beta, mu, eta)(q, omegas)`` on the
    rate-fitted npt ladder until the whole chi0(q, omega) curve is
    grid-converged (``models.observables.certified_ladder`` — the
    certified-tolerance contract extended to response functions).

    Every rung is rounded up to a multiple of q's denominator (inferred via
    ``fractions.Fraction.limit_denominator``), so the q-snap is EXACT at
    every rung and the certificate never conflates snapping error with grid
    error.  Returns a :class:`~.observables.CertifiedSweep` whose ``u`` is
    the complex (W,) chi0 curve; ``retcode=False`` on honest nmax
    truncation."""
    from fractions import Fraction
    from math import lcm

    from .observables import certified_ladder

    q = np.atleast_1d(np.asarray(q, dtype=np.float64))
    dens = [Fraction(float(qi)).limit_denominator(1000).denominator
            for qi in q]
    mult = lcm(*dens) if dens else 1

    def eval_at(npt):
        slv = LindhardSolver(h, bz, int(npt), beta, mu=mu, eta=eta)
        return slv(q, omegas)

    return certified_ladder(eval_at, abstol, reltol, nmin, nmax, factor,
                            npt_multiple=mult)
