"""Band structures and spectral functions along high-symmetry k-paths.

Companion workflow to the BZ integrals: the same Wannier ``FourierSeries``
Hamiltonians that feed the DOS/transport solvers, evaluated along a path of
k-points (band plots, A(k, omega) maps).  The reference ships the
interpolation machinery this uses (``FourierSeriesEvaluators``, reference
``src/AutoBZCore.jl:62``) but no path driver; this is the standard companion
tool users expect next to a DOS curve.

Shape: the whole path is one ``evaluate_points`` batch + one batched
``eigh`` inside a single jitted program; A(k, omega) maps are one broadcast
Lorentzian contraction over the cached eigenvalues.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..fourier import FourierSeries


class KPath(NamedTuple):
    """A sampled polyline through the zone in FRACTIONAL coordinates.

    ``X``: (K, d) path points; ``s``: (K,) cumulative arclength (Cartesian
    when built with ``B``, fractional otherwise) — the plot abscissa;
    ``ticks``: indices into ``X`` of the input vertices (high-symmetry
    points); ``labels``: optional vertex labels."""

    X: object
    s: object
    ticks: object
    labels: object


def kpath(vertices, npts=50, B=None, labels=None) -> KPath:
    """Sample the polyline through ``vertices`` ((P, d) fractional corners)
    with ~``npts`` points per unit arclength segment (at least 2 per
    segment), duplicating no corner.  ``B`` (reciprocal basis, columns)
    makes ``s`` a Cartesian arclength so segments plot with true relative
    lengths."""
    V = np.asarray(vertices, dtype=np.float64)
    if V.ndim != 2 or len(V) < 2:
        raise ValueError("vertices must be (P >= 2, d)")
    M = np.eye(V.shape[1]) if B is None else np.asarray(B, dtype=np.float64)
    lens = np.linalg.norm((V[1:] - V[:-1]) @ M.T, axis=1)
    scale = npts / max(lens.max(), 1e-300)
    xs, ticks = [V[0][None]], [0]
    for j, L in enumerate(lens):
        n = max(2, int(round(L * scale)) + 1)  # points incl. both corners
        t = np.linspace(0.0, 1.0, n)[1:, None]
        xs.append(V[j] * (1 - t) + V[j + 1] * t)
        ticks.append(ticks[-1] + n - 1)
    X = np.concatenate(xs, axis=0)
    ds = np.linalg.norm((X[1:] - X[:-1]) @ M.T, axis=1)
    s = np.concatenate([[0.0], np.cumsum(ds)])
    return KPath(X, s, np.asarray(ticks), labels)


_KPATH_CACHE = {}


def _kpath_fn(kind, cshape, sndim, offset, period, dtype, extra=None):
    """One compiled executable per (kind, coefficient shape, ...): repeated
    path evaluations (scans, animations) skip recompilation — coefficients
    ride as (re, im) runtime arguments (same pattern as berry.py's
    builds)."""
    from ..ops.eigh3 import eigvalsh_small
    from ..ops.fourier_eval import evaluate_points

    key = (kind, cshape, sndim, offset, period, dtype, extra)
    fn = _KPATH_CACHE.get(key)
    if fn is not None:
        return fn

    @jax.jit
    def bands(cre, cim, X):
        c = (cre + 1j * cim).astype(dtype)
        hk = evaluate_points(c, sndim, X, offset, period, None, dtype)
        return eigvalsh_small(hk)   # analytic for m <= 3, LAPACK-style above

    @jax.jit
    def expect(cre, cim, X, Ore, Oim):
        from ..ops.eigh3 import eigh_small

        c = (cre + 1j * cim).astype(dtype)
        O = (Ore + 1j * Oim)  # (re, im) pair: complex jit args are rejected
        hk = evaluate_points(c, sndim, X, offset, period, None, dtype)
        _, U = eigh_small(hk)  # closed-form 2x2; QR above
        return jnp.real(jnp.einsum("kin,ij,kjn->kn", jnp.conj(U),
                                   O.astype(U.dtype), U))

    fn = {"bands": bands, "expect": expect}[kind]
    _KPATH_CACHE[key] = fn
    return fn


def band_structure(h: FourierSeries, path):
    """Band energies along a path: (K, m) ascending eigenvalues.  ``path``
    is a :class:`KPath` or a raw (K, d) fractional array."""
    X = jnp.asarray(path.X if isinstance(path, KPath) else path)
    fn = _kpath_fn("bands", np.shape(h.c), h.sndim, h.offset, h.period, h.dtype)
    c = np.asarray(h.c)
    return fn(jnp.asarray(c.real), jnp.asarray(c.imag), X)


def expectation_path(h: FourierSeries, path, O):
    """Band-resolved operator expectations along a path: (K, m) values
    ``<u_n(k)| O |u_n(k)>`` for an (m, m) Hermitian ``O`` — spin textures,
    orbital characters, sublattice polarizations."""
    X = jnp.asarray(path.X if isinstance(path, KPath) else path)
    fn = _kpath_fn("expect", np.shape(h.c), h.sndim, h.offset, h.period, h.dtype)
    c = np.asarray(h.c)
    Oa = np.asarray(O)
    return fn(jnp.asarray(c.real), jnp.asarray(c.imag), X,
              jnp.asarray(Oa.real), jnp.asarray(Oa.imag))


def spectral_path(h: FourierSeries, path, omegas, eta):
    """Momentum-resolved spectral function map A(k, omega) =
    (1/pi) sum_n eta / ((omega - e_n(k))^2 + eta^2) — the band-basis trace
    of ``-Im G / pi`` with constant broadening.  Returns (K, W); satisfies
    the sum rule ``int A domega = m`` per k-point."""
    e = band_structure(h, path)
    om = jnp.asarray(omegas)
    lor = eta / ((om[None, :, None] - e[:, None, :]) ** 2 + eta**2) / np.pi
    return jnp.sum(lor, axis=-1)
