"""Matrix-valued local self-energies: DMFT-grade Green's functions.

The reference's BZ machinery exists to serve exactly this workload (its
companion application paper computes DMFT spectral functions and transport
with frequency-dependent self-energies; the constant-``eta`` DOS of
``aps_example`` is the ``Sigma = -i eta`` special case).  Here the general
case ships as a library:

    G(k, omega) = [ (omega + mu) I - Sigma(omega) - H(k) ]^{-1}

with ``Sigma(omega)`` an arbitrary matrix-valued (orbital-resolved) local
self-energy, supplied either as a callable or as data on a frequency grid
(:class:`SigmaInterpolant`).  ``Sigma`` breaks the Hermitian
eigendecomposition trick (``z - H`` no longer shares eigenvectors across
omega unless ``Sigma`` is scalar), so the engines invert per (k, omega) —
via the closed-form adjugate trace for m <= 3 (no LU) and batched
``solve`` otherwise.

Two execution shapes, same pattern as the DOS family:

- :func:`dos_integrand_sigma` — a standard ``FourierIntegrand`` for the
  adaptive pipeline (IAI / PTR / AutoPTR / sweeps).
- :class:`SigmaDOSSolver` — the grid engine: evaluate H on the
  (symmetry-reduced) grid ONCE, then every omega sweep is a chunked batched
  trace-inverse (``lax.map`` bounds memory).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..brillouin import TrivialRep
from ..fourier import FourierIntegrand, FourierSeries
from .observables import _inv_small, _trace_inv_small


@jax.tree_util.register_pytree_node_class
class SigmaInterpolant:
    """Piecewise-linear matrix-valued ``Sigma(omega)`` on a frequency grid —
    callable inside jit/vmap (the standard carrier for numerically tabulated
    DMFT self-energies).  ``values``: (W,) scalar or (W, m, m) matrices;
    evaluation clamps to the end intervals outside the grid."""

    def __init__(self, omegas, values):
        om = np.asarray(omegas)
        if om.ndim != 1 or om.shape[0] < 2:
            raise ValueError("SigmaInterpolant needs >= 2 grid frequencies")
        if not np.all(np.diff(om) > 0):
            raise ValueError(
                "SigmaInterpolant omegas must be strictly ascending "
                "(searchsorted on an unsorted grid silently mis-interpolates)")
        # HOST-resident (numpy) storage, split into (re, im): as closure
        # constants these embed as HLO literals for free (see
        # StoredSeriesValues / FourierSeries coefficients)
        self.omegas = om if isinstance(om, np.ndarray) else np.asarray(om)
        v = values if isinstance(values, np.ndarray) else np.asarray(values)
        self.values_re = np.real(v)
        self.values_im = np.imag(v)

    def tree_flatten(self):
        return (self.omegas, self.values_re, self.values_im), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.omegas, obj.values_re, obj.values_im = children
        return obj

    def __call__(self, om):
        om = jnp.asarray(om)
        og = jnp.asarray(self.omegas)  # numpy constants -> literals at trace
        i = jnp.clip(jnp.searchsorted(og, om, side="right") - 1,
                     0, og.shape[0] - 2)
        t = (om - og[i]) / (og[i + 1] - og[i])
        t = jnp.clip(t, 0.0, 1.0)
        tb = t.reshape(t.shape + (1,) * (self.values_re.ndim - 1))
        lerp = lambda v: (1 - tb) * jnp.asarray(v)[i] + tb * jnp.asarray(v)[i + 1]
        return lerp(self.values_re) + 1j * lerp(self.values_im)


@jax.tree_util.register_pytree_node_class
class SigmaCallable:
    """Static pytree wrapper for a plain-Python ``Sigma(omega)`` callable so
    it can ride through jitted parameter paths (sweeps, PTR runners) as
    auxiliary data.  Closed-form self-energies (Fermi liquid
    ``-i(eta + a omega^2)``, atomic-limit poles...) go through here;
    tabulated data uses :class:`SigmaInterpolant`."""

    def __init__(self, fn):
        self.fn = fn

    def tree_flatten(self):
        return (), self.fn

    @classmethod
    def tree_unflatten(cls, fn, children):
        return cls(fn)

    def __call__(self, om):
        return self.fn(om)


def _as_sigma(Sigma):
    if isinstance(Sigma, (SigmaInterpolant, SigmaCallable)):
        return Sigma
    return SigmaCallable(Sigma)


def _zmat(om, Sigma, m, dtype, mu=0.0):
    """(om + mu) I - Sigma(om) broadcast to (m, m)."""
    z = (jnp.asarray(om) + mu).astype(dtype)
    S = Sigma(om)
    S = jnp.asarray(S).astype(dtype)
    if S.ndim == 0:
        S = S * jnp.eye(m, dtype=dtype)
    return z * jnp.eye(m, dtype=dtype) - S


def greens_trace_sigma(hv, om, Sigma=None, mu=0.0):
    """``Tr G(k, om)`` with a matrix self-energy — FourierValue kernel for
    the adaptive pipeline."""
    H = hv.s
    m = H.shape[-1]
    M = _zmat(om, Sigma, m, H.dtype, mu) - H
    if m <= 3:
        return _trace_inv_small(M)
    return jnp.trace(jnp.linalg.solve(M, jnp.eye(m, dtype=M.dtype)))


def dos_trace_sigma(hv, om, Sigma=None, mu=0.0):
    """Spectral weight ``-Im Tr G / pi`` with a matrix self-energy."""
    return -jnp.imag(greens_trace_sigma(hv, om, Sigma=Sigma, mu=mu)) / jnp.pi


def transport_distribution_sigma(hv, om, Sigma=None, mu=0.0):
    """Kubo-Greenwood transport distribution with a MATRIX self-energy:
    ``Gamma_ab(om) = Tr[v_a A(om) v_b A(om)]`` with the full matrix spectral
    function ``A = (G - G^dagger) / (-2 pi i)``, ``G = [(om + mu) I -
    Sigma(om) - H]^{-1}`` — the general (non-band-diagonal) form the
    constant-``eta`` :func:`~.observables.transport_distribution` reduces to.
    Kernel over a ``JacobianSeries`` value ``(H, dH)``; runs in the adaptive
    pipeline (the nest carries JacobianSeries) and under vmap for grids."""
    H, V = hv.s
    m = H.shape[-1]
    M = _zmat(om, Sigma, m, H.dtype, mu) - H
    G = _inv_small(M)
    A = (G - jnp.conj(jnp.swapaxes(G, -1, -2))) / (-2j * jnp.pi)
    # Gamma_ab = Tr[v_a A v_b A]; real by construction (A, v Hermitian)
    vA = jnp.einsum("...aij,...jk->...aik", V, A)
    return jnp.real(jnp.einsum("...aij,...bji->...ab", vA, vA))


def dos_integrand_sigma(h: FourierSeries, Sigma, mu=0.0):
    """``FourierIntegrand`` for the self-energy DOS (TrivialRep: the trace is
    group-invariant, so IBZ solves symmetrize by pure weight)."""
    fi = FourierIntegrand(dos_trace_sigma, h, Sigma=_as_sigma(Sigma), mu=mu)
    fi.rep = TrivialRep()
    return fi


class SigmaDOSSolver:
    """Grid engine for self-energy spectral sweeps: H on the
    (symmetry-reduced) ``npt^d`` grid is evaluated ONCE; each call inverts
    ``z(omega) - H_k`` in chunked batches.

    >>> slv = SigmaDOSSolver(h, bz, npt=100, Sigma=SigmaInterpolant(w, S))
    >>> D = slv(omegas)              # (W,) DOS curve
    >>> P = SigmaDOSSolver(h, bz, npt, Sigma, project=True)(omegas)  # (W, m)

    ``project=True`` returns the ORBITAL-PROJECTED DOS ``-Im G_ii / pi``
    per orbital (rows sum to the total); note orbital weights are only
    meaningful over an IBZ whose group leaves the orbitals fixed (sign
    flips do; axis permutations permute symmetry-related orbitals).
    """

    def __init__(self, h: FourierSeries, bz, npt, Sigma, mu=0.0, omega_chunk=8,
                 project=False):
        self._project = bool(project)
        from .observables import gathered_grid, reduced_grid

        d = bz.ndim
        lin, weights, u, self._scale, _ = reduced_grid(bz, npt, h.period)
        self._mu = float(mu)
        self._Sigma = _as_sigma(Sigma)
        self._chunk = int(omega_chunk)
        self._dtype = h.dtype

        @jax.jit
        def grid():
            # coefficients embed as HLO literals (host numpy)
            hk = gathered_grid(h, d, u, lin)
            return jnp.real(hk), jnp.imag(hk)

        hk_re, hk_im = grid()                      # (K, m, m) device-resident
        # (re, im) pairs rejoined inside the sweep (a complex-splitting
        # boundary, ROADMAP D2)
        self._hk_re = hk_re
        self._hk_im = hk_im
        self._w = jnp.asarray(weights, hk_re.dtype)
        self._m = int(hk_re.shape[-1])
        self._sweep = self._build()

    def _build(self):
        m = self._m
        Sigma, mu, dtype = self._Sigma, self._mu, self._dtype
        scale, C = self._scale, self._chunk

        project = self._project

        def one(om, hk, w):
            M = _zmat(om, Sigma, m, dtype, mu)[None] - hk      # (K, m, m)
            if project:
                Gd = jnp.diagonal(_inv_small(M), axis1=-2, axis2=-1)  # (K, m)
                return -jnp.sum(w[:, None] * jnp.imag(Gd), axis=0) / jnp.pi * scale
            if m <= 3:
                tr = _trace_inv_small(M)
            else:
                tr = jnp.trace(jnp.linalg.solve(
                    M, jnp.broadcast_to(jnp.eye(m, dtype=M.dtype), M.shape)),
                    axis1=-2, axis2=-1)
            return -jnp.sum(w * jnp.imag(tr)) / jnp.pi * scale

        @jax.jit
        def sweep(om_all, hk_re, hk_im, w):
            hk = hk_re + 1j * hk_im
            nw = om_all.shape[0]
            pad = -(-nw // C) * C
            omp = jnp.zeros((pad,), om_all.dtype).at[:nw].set(om_all)
            D = jax.lax.map(jax.vmap(lambda om: one(om, hk, w)), omp.reshape(-1, C))
            return D.reshape((pad,) + D.shape[2:])[:nw]

        return sweep

    def __call__(self, omegas):
        return self._sweep(jnp.asarray(omegas), self._hk_re, self._hk_im, self._w)


class SigmaTransportSolver:
    """Kubo-Greenwood transport with a MATRIX self-energy on a cached grid:
    (H, dH) evaluated once on the (symmetry-reduced) ``npt^d`` grid, each
    omega computes ``Gamma_ab = sum_k w_k Tr[v_a A v_b A]`` with the full
    matrix spectral function (see :func:`transport_distribution_sigma`).
    IBZ results are group-averaged back to the full zone (rank-2 tensor,
    reference ``src/brillouin.jl:96-108`` semantics).  The constant-``eta``
    special case has a much cheaper band-diagonal GEMM engine
    (:class:`~.observables.TransportSolver`); use this one when ``Sigma``
    actually has structure."""

    def __init__(self, h: FourierSeries, bz, npt, Sigma, mu=0.0, omega_chunk=4):
        from .observables import gathered_grid, reduced_grid

        d = bz.ndim
        lin, weights, u, self._scale, self._Savg = reduced_grid(bz, npt, h.period)
        self._mu = float(mu)
        self._Sigma = _as_sigma(Sigma)
        self._chunk = int(omega_chunk)
        self._dtype = h.dtype
        self._d = d

        @jax.jit
        def grid():
            hk, vk = gathered_grid(h, d, u, lin, jacobian=True)
            return (jnp.real(hk), jnp.imag(hk), jnp.real(vk), jnp.imag(vk))

        self._parts = grid()
        self._w = jnp.asarray(weights, self._parts[0].dtype)
        self._m = int(self._parts[0].shape[-1])
        self._sweep = self._build()

    def _build(self):
        m, d = self._m, self._d
        Sigma, mu, dtype = self._Sigma, self._mu, self._dtype
        scale, C, Savg = self._scale, self._chunk, self._Savg

        def one(om, hk, vk, w):
            from ..fourier import FourierValue

            # shared kernel (batch-safe '...' einsums): the grid engine and
            # the adaptive pipeline compute the identical Gamma
            Gam = transport_distribution_sigma(FourierValue(None, (hk, vk)),
                                               om, Sigma=Sigma, mu=mu)
            return jnp.einsum("k,kab->ab", w, Gam) * scale

        @jax.jit
        def sweep(om_all, hk_re, hk_im, vk_re, vk_im, w):
            hk = hk_re + 1j * hk_im
            vk = vk_re + 1j * vk_im
            nw = om_all.shape[0]
            pad = -(-nw // C) * C
            omp = jnp.zeros((pad,), om_all.dtype).at[:nw].set(om_all)
            G = jax.lax.map(jax.vmap(lambda om: one(om, hk, vk, w)),
                            omp.reshape(-1, C))
            G = G.reshape(pad, d, d)[:nw]
            if Savg is not None:
                SinvT, Sinv_, n = Savg
                G = jnp.einsum("sab,wbc,scd->wad", jnp.asarray(SinvT, G.dtype),
                               G, jnp.asarray(Sinv_, G.dtype)) / n
            return G

        return sweep

    def __call__(self, omegas):
        return self._sweep(jnp.asarray(omegas), *self._parts, self._w)


def certified_sigma_dos(h: FourierSeries, bz, omegas, Sigma, mu=0.0,
                        abstol=1e-3, reltol=0.0, nmin=20, nmax=400,
                        factor=2**0.5, project=False):
    """Self-energy DOS sweep with AutoPTR-style whole-curve certification:
    :class:`SigmaDOSSolver` rungs on the rate-fitted npt ladder (see
    :func:`~.observables.certified_ladder`)."""
    from .observables import certified_ladder

    def eval_at(npt):
        return SigmaDOSSolver(h, bz, npt, Sigma, mu=mu, project=project)(omegas)

    return certified_ladder(eval_at, abstol, reltol, nmin, nmax, factor)


from .transport import KineticCoefficientSolver as _KineticBase


class SigmaKineticCoefficientSolver(_KineticBase):
    """Kinetic coefficients with a MATRIX self-energy: the two-frequency
    Kubo-Greenwood distribution ``Gamma_ab(w, w + Omega) = sum_k w_k
    Tr[v_a A(w) v_b A(w + Omega)]`` with full matrix spectral functions,
    fed through the same Fermi-window-truncated adaptive frequency
    integral as :class:`~.transport.KineticCoefficientSolver` (whose
    ``__call__``/``sweep`` drivers are inherited; ``Sigma = -i eta``
    reproduces it exactly).  ``alpha=0`` optical conductivity, ``alpha=1,
    2`` thermoelectric numerators.

    The (H, dH) grid is evaluated once on the (symmetry-reduced) zone;
    each GK node costs two batched closed-form inverses over the grid —
    heavier than the band-diagonal GEMM pack, so prefer the parent for
    scalar self-energies.
    """

    def __init__(self, h: FourierSeries, bz, npt, Sigma, beta, alpha=0,
                 mu=0.0, order=7, cap=256, wtol=1e-10):
        from .observables import reduced_grid
        from .transport import fermi_window

        if not isinstance(alpha, (int, np.integer)) or alpha < 0:
            raise ValueError("alpha must be a small non-negative integer")
        # driver state expected by the inherited __call__/sweep (the parent
        # __init__ is deliberately NOT called: its band-diagonal GEMM pack
        # does not apply to matrix self-energies)
        self.beta = float(beta)
        self.alpha = int(alpha)
        self.mu = float(mu)
        self.order = order
        self.cap = cap
        self.wtol = float(wtol)
        self.d = bz.ndim
        self.numevals = 0
        self.retcode = None

        d = bz.ndim
        lin, weights, u, scale, Savg = reduced_grid(bz, npt, h.period)
        Sig = _as_sigma(Sigma)
        dtype = h.dtype

        from .observables import gathered_grid

        @jax.jit
        def grid():
            hk, vk = gathered_grid(h, d, u, lin, jacobian=True)
            return (jnp.real(hk), jnp.imag(hk), jnp.real(vk), jnp.imag(vk))

        hr, hi_, vr, vi = grid()
        w_arr = jnp.asarray(weights, hr.dtype)
        m = int(hr.shape[-1])
        beta_, alpha_, mu_, d_ = self.beta, self.alpha, self.mu, self.d

        def _A(w, hk):
            M = _zmat(w, Sig, m, dtype, 0.0) - hk     # omega is ABSOLUTE
            G = _inv_small(M)
            return (G - jnp.conj(jnp.swapaxes(G, -1, -2))) / (-2j * jnp.pi)

        def integrand(w, Omega):
            hk = hr + 1j * hi_
            vk = vr + 1j * vi
            A1 = _A(w, hk)
            A2 = _A(w + Omega, hk)
            vA1 = jnp.einsum("kaij,kjn->kain", vk, A1)
            vA2 = jnp.einsum("kbij,kjn->kbin", vk, A2)
            Gam = jnp.real(jnp.einsum("kaij,kbji->kab", vA1, vA2))
            G = jnp.einsum("k,kab->ab", w_arr, Gam) * scale
            if Savg is not None:
                SinvT, Sinv_, n = Savg
                G = jnp.einsum("sab,bc,scd->ad", jnp.asarray(SinvT, G.dtype), G,
                               jnp.asarray(Sinv_, G.dtype)) / n
            win = fermi_window(w, Omega, beta_, mu_)
            mom = (beta_ * (w - mu_)) ** alpha_ if alpha_ else 1.0
            return mom * win * G

        self._integrand = integrand
