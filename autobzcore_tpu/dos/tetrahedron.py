"""Linear tetrahedron method (LTM) for the density of states.

The reference names the "(Linear) Tetrahedron Method" as a wished-for future
DOS algorithm (reference ``docs/src/dos.md:14-16``); this implements it
for d = 1, 2, 3 following Lehmann–Taut (1972) / Bloechl (1994):
each grid cell of an ``npt^d`` periodic grid is split into d! simplices, the
band energy is linearly interpolated from the corner values, and the DOS of a
linear band over a simplex has a closed form in the sorted corner energies.

Formulation: eigenvalues are computed once on the symmetry-reduced grid
(one batched ``eigh``) and scattered back to the full grid with the
host-precomputed orbit map (``ops/symptr.symptr_orbit_map``); corner energies
are built from rolled views and sorted along a static size-(d+1) axis at init;
per-energy evaluation is a dense piecewise-polynomial reduction, so
1000-energy sweeps are one vmapped kernel over precomputed sorted corners —
the same "expensive init, cheap sweep" shape as :class:`~.ggr.GGR`.

Normalization matches GGR: the DOS is per unit *fractional* zone volume
(each band integrates to 1 over energy).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..brillouin import SymmetricBZ
from ..fourier import FourierSeries, JacobianSeries
from ..ops.fourier_eval import evaluate_grid
from ..ops.symptr import symptr_orbit_map
from .interfaces import DOSAlgorithm, DOSSolution

# simplex decompositions of the unit cell, corners as binary vertex labels
# (bit j = offset along grid axis j).  All simplices share the main diagonal
# 0 -> 2^d - 1 (Bloechl's choice, which makes the tiling conforming).
_SIMPLICES = {
    1: [(0, 1)],
    2: [(0, 1, 3), (0, 2, 3)],
    3: [(0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7), (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7)],
}


def _safe(x):
    return jnp.where(x > 0.0, x, 1.0)


def _dos_segment(E, ec, tol):
    """d=1: corners (2, ...) sorted ascending; DOS of a linear band."""
    e1, e2 = ec[0], ec[1]
    inside = (E >= e1) & (E < e2) & (e2 - e1 > tol)
    return jnp.where(inside, 1.0 / _safe(e2 - e1), 0.0)


def _dos_triangle(E, ec, tol):
    """d=2 (Lehmann–Taut): corners (3, ...) sorted ascending."""
    e1, e2, e3 = ec[0], ec[1], ec[2]
    d31 = _safe(e3 - e1)
    # flat (symmetry-degenerate) simplices are delta-spikes of measure zero:
    # drop them, as GGR drops v ~ 0 critical boxes
    ok = e3 - e1 > tol
    lo = (E >= e1) & (E < e2) & ok
    hi = (E >= e2) & (E < e3) & ok
    r = jnp.where(lo, 2.0 * (E - e1) / (_safe(e2 - e1) * d31), 0.0)
    r = r + jnp.where(hi, 2.0 * (e3 - E) / (_safe(e3 - e2) * d31), 0.0)
    return r


def _dos_tetrahedron(E, ec, tol):
    """d=3 (Bloechl Eq. A2-A4): corners (4, ...) sorted ascending."""
    e1, e2, e3, e4 = ec[0], ec[1], ec[2], ec[3]
    d21, d31, d41 = _safe(e2 - e1), _safe(e3 - e1), _safe(e4 - e1)
    d32, d42, d43 = _safe(e3 - e2), _safe(e4 - e2), _safe(e4 - e3)
    ok = e4 - e1 > tol  # drop flat (delta-spike) tetrahedra
    p1 = (E >= e1) & (E < e2) & ok
    p2 = (E >= e2) & (E < e3) & ok
    p3 = (E >= e3) & (E < e4) & ok
    r = jnp.where(p1, 3.0 * (E - e1) ** 2 / (d21 * d31 * d41), 0.0)
    mid = (3.0 * (e2 - e1) + 6.0 * (E - e2)
           - 3.0 * ((e3 - e1) + (e4 - e2)) * (E - e2) ** 2 / (d32 * d42)) / (d31 * d41)
    r = r + jnp.where(p2, mid, 0.0)
    r = r + jnp.where(p3, 3.0 * (e4 - E) ** 2 / (d41 * d42 * d43), 0.0)
    return r


_DOS_FORMULAS = {1: _dos_segment, 2: _dos_triangle, 3: _dos_tetrahedron}


def _nos_segment(E, ec, tol):
    """Fraction of a linear 1D segment below E (integrated DOS)."""
    e1, e2 = ec[0], ec[1]
    flat = e2 - e1 <= tol
    frac = jnp.clip((E - e1) / _safe(e2 - e1), 0.0, 1.0)
    return jnp.where(flat, jnp.where(E >= e1, 1.0, 0.0), frac)


def _nos_triangle(E, ec, tol):
    e1, e2, e3 = ec[0], ec[1], ec[2]
    e21, e31, e32 = _safe(e2 - e1), _safe(e3 - e1), _safe(e3 - e2)
    flat = e3 - e1 <= tol
    lo = (E >= e1) & (E < e2)
    hi = (E >= e2) & (E < e3)
    n = jnp.where(lo, (E - e1) ** 2 / (e21 * e31), 0.0)
    n = n + jnp.where(hi, 1.0 - (e3 - E) ** 2 / (e32 * e31), 0.0)
    n = n + jnp.where(E >= e3, 1.0, 0.0)
    return jnp.where(flat, jnp.where(E >= e1, 1.0, 0.0), n)


def _nos_tetrahedron(E, ec, tol):
    """Bloechl Eq. A1-A5: occupied fraction of a linear tetrahedron."""
    e1, e2, e3, e4 = ec[0], ec[1], ec[2], ec[3]
    e21, e31, e41 = _safe(e2 - e1), _safe(e3 - e1), _safe(e4 - e1)
    e32, e42, e43 = _safe(e3 - e2), _safe(e4 - e2), _safe(e4 - e3)
    flat = e4 - e1 <= tol
    p1 = (E >= e1) & (E < e2)
    p2 = (E >= e2) & (E < e3)
    p3 = (E >= e3) & (E < e4)
    x = E - e2
    n = jnp.where(p1, (E - e1) ** 3 / (e21 * e31 * e41), 0.0)
    mid = (e21**2 + 3.0 * e21 * x + 3.0 * x**2
           - ((e3 - e1) + (e4 - e2)) / (e32 * e42) * x**3) / (e31 * e41)
    n = n + jnp.where(p2, mid, 0.0)
    n = n + jnp.where(p3, 1.0 - (e4 - E) ** 3 / (e41 * e42 * e43), 0.0)
    n = n + jnp.where(E >= e4, 1.0, 0.0)
    return jnp.where(flat, jnp.where(E >= e1, 1.0, 0.0), n)


_NOS_FORMULAS = {1: _nos_segment, 2: _nos_triangle, 3: _nos_tetrahedron}


class LTM(DOSAlgorithm):
    """``LTM(npt=50)`` — linear tetrahedron DOS over an ``npt^d`` grid.

    Exact for linear bands; resolves van Hove structure without a broadening
    parameter (unlike Lorentzian sums) and without the velocity data GGR
    needs.  The delta function is sharp: values *at* band edges/critical
    energies follow the one-sided closed form.
    """

    def __init__(self, npt=50):
        self.npt = npt

    def init_cacheval(self, h, domain, p):
        if isinstance(h, JacobianSeries):
            h = h.s
        if not isinstance(h, FourierSeries):
            raise TypeError("LTM currently supports Fourier series Hamiltonians")
        if not isinstance(p, SymmetricBZ):
            raise TypeError("LTM supports BZ parameters from load_bz")
        bz = p
        d = bz.ndim
        if d not in _SIMPLICES:
            raise ValueError("LTM implemented for 1-, 2-, and 3-d BZs")
        npt = self.npt

        if bz.syms is None:
            lin = None
            full2rep = None
        else:
            reps, _, full2rep = symptr_orbit_map(npt, d, bz.syms)
            lin = np.ravel_multi_index(tuple(reps.T.astype(np.int64)), (npt,) * d)
        u = [np.arange(npt) / npt * h.period[j] for j in range(d)]
        simplices = _SIMPLICES[d]
        nvert = d + 1

        @jax.jit
        def sorted_corners():
            # eigenvalues on the (reduced) grid in ONE compiled program, in
            # the series' own dtype
            hk = evaluate_grid(h.c, d, u, h.offset, h.period, None, h.dtype)
            hk = hk.reshape((npt**d,) + hk.shape[d:])
            if lin is not None:
                hk = hk[lin]
            if hk.ndim == 1:
                hk = hk[:, None, None]
            e = jnp.linalg.eigvalsh(hk)
            if full2rep is not None:
                e = e[jnp.asarray(full2rep)]  # scatter back to the full grid
            m = e.shape[-1]
            # band-major, grid-minor layout: keep the large grid axis minor
            # (tiny (m, nvert) minor axes pad badly in tiled layouts)
            eg = e.T.reshape((m,) + (npt,) * d)
            # the 2^d cell-corner values via periodic rolls
            corners = []
            for v in range(2**d):
                shift = tuple(-((v >> j) & 1) for j in range(d))
                corners.append(jnp.roll(eg, shift, axis=tuple(range(1, d + 1))))
            cs = jnp.stack(corners)  # (2^d, m, npt..)
            cs = cs.reshape(2**d, m, npt**d)
            # per corner: stack across simplices, then an explicit min/max
            # exchange network sorts the nvert separate arrays elementwise —
            # XLA's sort op forces the sorted dim minor, re-creating the
            # tiny-minor-dim tiling blowup the layout above avoids
            cs = cs.reshape(2**d, m * npt**d)
            vs = [jnp.stack([cs[sx[v]] for sx in simplices]) for v in range(nvert)]
            nets = {2: [(0, 1)], 3: [(0, 1), (1, 2), (0, 1)],
                    4: [(0, 1), (2, 3), (0, 2), (1, 3), (1, 2)]}
            for i, j in nets[nvert]:
                vs[i], vs[j] = jnp.minimum(vs[i], vs[j]), jnp.maximum(vs[i], vs[j])
            return jnp.stack(vs)  # (nvert, S, m*N)

        ec = sorted_corners()
        nsimp = len(simplices)
        vol = 1.0 / (nsimp * npt**d)  # fractional volume per simplex
        formula = _DOS_FORMULAS[d]

        scale = float(jnp.max(ec) - jnp.min(ec)) or 1.0
        tol = 1e-9 * scale

        nos_formula = _NOS_FORMULAS[d]

        # the corner tensor enters as a jit ARGUMENT, not a closure constant,
        # so large grids are not baked into the compiled program as literals
        @jax.jit
        def dos_at_(E, ec):
            return vol * jnp.sum(formula(E, ec, tol))

        @jax.jit
        def nos_at_(E, ec):
            return vol * jnp.sum(nos_formula(E, ec, tol))

        dos_sweep_ = jax.jit(jax.vmap(dos_at_, in_axes=(0, None)))
        nos_sweep_ = jax.jit(jax.vmap(nos_at_, in_axes=(0, None)))

        return {
            "dos_at": lambda E: dos_at_(E, ec),
            "dos_sweep": lambda Es: dos_sweep_(Es, ec),
            "nos_at": lambda E: nos_at_(E, ec),
            "nos_sweep": lambda Es: nos_sweep_(Es, ec),
            "corners": ec,
            "numevals": int(npt**d if lin is None else len(lin)),
            "nvert": nvert,
        }

    def dos_solve(self, h, domain, p, cacheval, abstol=None, reltol=None, maxiters=None):
        if np.ndim(domain) != 0:
            raise TypeError("LTM supports domains of individual energies")
        return DOSSolution(cacheval["dos_at"](jnp.asarray(domain)), None, True,
                           cacheval["numevals"])

    def dos_sweep(self, cacheval, Es):
        """Batched DOS over an energy grid (one vmapped kernel)."""
        return cacheval["dos_sweep"](jnp.asarray(Es))

    def nos_sweep(self, cacheval, Es):
        """Integrated DOS N(E) (number of states per fractional zone volume,
        in [0, nbands]) — the tetrahedron closed form, not a quadrature."""
        return cacheval["nos_sweep"](jnp.asarray(Es))

    def fermi_level(self, cacheval, nstates, tol=1e-10, maxiter=200):
        """Energy E_F with N(E_F) = ``nstates`` (e.g. electrons per cell /
        spin degeneracy), by bisection on the closed-form N(E).

        Conditioning: the E_F error is ~ (N-resolution)/D(E_F), so fillings
        that pin E_F at a band-touching point (D -> 0, e.g. graphene at half
        filling) resolve only to O(1/npt) — raise ``npt`` there."""
        ec = cacheval["corners"]
        lo = float(jnp.min(ec)) - 1.0
        hi = float(jnp.max(ec)) + 1.0
        nos = cacheval["nos_at"]
        for _ in range(maxiter):
            mid = 0.5 * (lo + hi)
            if float(nos(mid)) < nstates:
                lo = mid
            else:
                hi = mid
            if hi - lo < tol:
                break
        return 0.5 * (lo + hi)


class AdaptiveGaussianBroadening(DOSAlgorithm):
    """``AdaptiveGaussianBroadening(npt=50, a=1.0)`` — Gaussian-smeared DOS
    with a per-(k, band) width set by the local band velocity,
    ``sigma_kb = a * ||v_kb|| / npt`` (Yates et al., PRB 75, 195121 (2007)).

    The second wished-for reference algorithm (``docs/src/dos.md:14-16``).
    Reuses GGR's spectral grid (energies + band velocities from the
    closed-form Jacobian series), so it shares the expensive-init /
    cheap-sweep cache shape.  ``min_sigma`` floors the width at flat bands.
    """

    def __init__(self, npt=50, a=1.0, min_sigma=None, precision="auto"):
        self.npt = npt
        self.a = a
        self.min_sigma = min_sigma
        self.precision = precision

    def init_cacheval(self, h, domain, p):
        from .ggr import GGR

        cv = GGR(self.npt, self.precision).init_cacheval(h, domain, p)
        e = cv["energies"]            # (K, m)
        v = cv["velocities"]          # (K, d, m)
        w = cv["weights"]             # (K,)
        npt = self.npt
        speed = jnp.sqrt(jnp.sum(v * v, axis=1))  # (K, m)
        sigma = self.a * speed / npt
        floor = self.min_sigma
        if floor is None:
            spread = float(jnp.max(e) - jnp.min(e)) or 1.0
            floor = 1e-3 * spread / npt
        sigma = jnp.maximum(sigma, floor)
        norm = 1.0 / (np.sqrt(2 * np.pi) * sigma)
        inv_total = 1.0 / float(jnp.sum(w))  # = npt^-d (fractional normalization)

        # spectral arrays as jit ARGUMENTS, not closure constants (remote
        # compiles ship captured literals — see ggr.py / tetrahedron LTM)
        @jax.jit
        def _dos_at(E, e, sigma, norm, w):
            g = norm * jnp.exp(-0.5 * ((E - e) / sigma) ** 2)
            return inv_total * jnp.sum(w[:, None] * g)

        _dos_vmap = jax.jit(jax.vmap(_dos_at, in_axes=(0, None, None, None, None)))

        return {
            "dos_at": lambda E: _dos_at(E, e, sigma, norm, w),
            "dos_sweep": lambda Es: _dos_vmap(Es, e, sigma, norm, w),
            "energies": e,
            "sigma": sigma,
            "numevals": cv["numevals"],
        }

    def dos_solve(self, h, domain, p, cacheval, abstol=None, reltol=None, maxiters=None):
        if np.ndim(domain) != 0:
            raise TypeError("AdaptiveGaussianBroadening supports scalar energies")
        return DOSSolution(cacheval["dos_at"](jnp.asarray(domain)), None, True,
                           cacheval["numevals"])

    def dos_sweep(self, cacheval, Es):
        return cacheval["dos_sweep"](jnp.asarray(Es))
