"""Irreducible-BZ polytopes and their iterated integration limits.

Native replacement for the reference's SymmetryReduceBZ extension
(``ext/SymmetryReduceBZExt.jl`` + ``ext/ibzlims.jl``): build the IBZ as a
convex polytope and expose it through the iterated-limits protocol so IAI can
integrate over it.

Construction (host, scipy): the first BZ is the Wigner-Seitz cell of the
reciprocal lattice (half-spaces against neighbor shells); the IBZ is its
intersection with the Voronoi domain of a generic point's orbit under the
point group — a fundamental domain of volume V_BZ / |G|.

Slicing (device): all faces are affine half-spaces ``n . x <= c``.  Fixing
the outermost coordinate keeps them affine, so inner segment endpoints are
computed with fixed-shape masked min/max reductions over the static face set —
the on-device version of the reference's per-slice polygon walking
(``ext/ibzlims.jl:198-289``).
"""
from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
from scipy.spatial import ConvexHull, HalfspaceIntersection

from ..limits import IteratedLimits

_BIG = 1e30


class ConvexPolytope:
    """H-representation ``normals @ x <= offsets`` with vertex list."""

    def __init__(self, normals, offsets, vertices):
        self.normals = np.asarray(normals, dtype=np.float64)
        self.offsets = np.asarray(offsets, dtype=np.float64)
        self.vertices = np.asarray(vertices, dtype=np.float64)

    @property
    def ndim(self):
        return self.normals.shape[1]

    @property
    def volume(self):
        return ConvexHull(self.vertices).volume

    def interior_point(self):
        return self.vertices.mean(axis=0)


def _dedupe_halfspaces(normals, offsets, tol=1e-9):
    keep_n, keep_o = [], []
    for n, o in zip(normals, offsets):
        nn = np.linalg.norm(n)
        if nn < tol:
            continue
        n, o = n / nn, o / nn
        dup = any(np.allclose(n, m, atol=1e-8) and abs(o - p) < 1e-8
                  for m, p in zip(keep_n, keep_o))
        if not dup:
            keep_n.append(n)
            keep_o.append(o)
    return np.array(keep_n), np.array(keep_o)


def _polytope_from_halfspaces(normals, offsets, interior):
    normals, offsets = _dedupe_halfspaces(normals, offsets)
    hs = np.hstack([normals, -offsets[:, None]])
    inter = HalfspaceIntersection(hs, interior)
    verts = inter.intersections
    hull = ConvexHull(verts)
    # re-extract the tight faces from the hull for a minimal H-representation
    eqs = np.unique(np.round(hull.equations, 12), axis=0)
    return ConvexPolytope(eqs[:, :-1], -eqs[:, -1], verts[hull.vertices] if verts.ndim == 2 else verts)


def _lll_reduce(B, delta=0.75):
    """Lenstra-Lenstra-Lovasz reduction of the lattice basis in B's COLUMNS
    (integer column operations only, so the lattice is unchanged)."""
    B = np.array(B, dtype=np.float64, copy=True)
    n = B.shape[1]

    def gso(B):
        Q = np.zeros_like(B)
        mu = np.zeros((n, n))
        for i in range(n):
            v = B[:, i].copy()
            for j in range(i):
                qj = Q[:, j]
                mu[i, j] = (B[:, i] @ qj) / (qj @ qj)
                v -= mu[i, j] * qj
            Q[:, i] = v
        return Q, mu

    Q, mu = gso(B)
    k = 1
    guard = 0
    while k < n and guard < 10000:
        guard += 1
        for j in range(k - 1, -1, -1):
            q = round(mu[k, j])
            if q:
                B[:, k] -= q * B[:, j]
                Q, mu = gso(B)
        nk = Q[:, k] @ Q[:, k]
        nk1 = Q[:, k - 1] @ Q[:, k - 1]
        if nk >= (delta - mu[k, k - 1] ** 2) * nk1:
            k += 1
        else:
            B[:, [k - 1, k]] = B[:, [k, k - 1]]
            Q, mu = gso(B)
            k = max(k - 1, 1)
    return B


def wigner_seitz(B):
    """First BZ: Wigner-Seitz cell of the lattice generated by columns of B
    (in the *Cartesian* frame).

    The basis is LLL-reduced first (integer column ops — the LATTICE, and
    hence its Wigner-Seitz cell, is unchanged), so skewed user bases (e.g.
    columns (1,10),(0,1), whose cell needs the bisector of m=(1,-10)) work:
    with a naive small shell a missing plane silently yields a cell LARGER
    than the fundamental domain, overcounting every IBZ integral
    downstream.  The neighbor shell still widens until the cell volume
    matches ``|det B|``, as a certificate."""
    B = np.asarray(B, dtype=np.float64)
    d = B.shape[0]
    target = abs(np.linalg.det(B))
    if d >= 2:
        B = _lll_reduce(B)

    def cell(r):
        shells = [np.array(v) for v in itertools.product(range(-r, r + 1), repeat=d)
                  if any(v)]
        normals, offsets = [], []
        for m in shells:
            g = B @ m
            normals.append(g)
            offsets.append(g @ g / 2)
        return _polytope_from_halfspaces(np.array(normals), np.array(offsets),
                                         np.zeros(d))

    if d < 2:
        return cell(2)  # 1D: +-b/2 from the first shell already
    # for an LLL-reduced basis in d<=3 the Voronoi-relevant vectors lie in
    # the +-1 coefficient shell, so +-2 always suffices and +-3 is pure
    # margin; a larger ladder only burns minutes of O(n^2) halfspace dedup
    # on a basis so degenerate the certificate below should just fail fast
    last = None
    for r in (2, 3):
        poly = cell(r)
        vol = poly.volume
        if abs(vol - target) <= 1e-9 * max(target, 1.0):
            return poly
        last = vol
    raise ValueError(
        f"Wigner-Seitz cell volume {last:.6g} != |det B| = {target:.6g} even "
        "with a +-3 neighbor shell after LLL reduction; the basis is likely "
        "numerically singular"
    )


def ibz_polytope(B, syms_recip_frac, seed_direction=None):
    """IBZ as BZ intersect Voronoi-domain of a generic orbit.

    ``syms_recip_frac``: (S, d, d) point ops acting on fractional reciprocal
    coordinates.  Returns the polytope in *fractional* coordinates.
    """
    B = np.asarray(B, dtype=np.float64)
    d = B.shape[0]
    ws = wigner_seitz(B)
    # generic interior point, fractional coords
    x0 = np.array([0.121, 0.073, 0.041][:d]) if seed_direction is None else np.asarray(seed_direction)
    x0_cart = B @ x0
    # shrink into the WS cell if needed
    while np.any(ws.normals @ x0_cart > ws.offsets - 1e-12):
        x0 = x0 / 2
        x0_cart = B @ x0
    normals = [n @ B for n in ws.normals]  # cartesian half-space -> frac coords
    offsets = list(ws.offsets)
    Gmetric = B.T @ B
    for S in syms_recip_frac:
        y = S @ x0
        if np.allclose(y, x0, atol=1e-12):
            continue
        # |k - x0|^2 <= |k - y|^2 in frac coords with metric B^T B
        nvec = Gmetric @ (y - x0)
        off = (y @ Gmetric @ y - x0 @ Gmetric @ x0) / 2
        normals.append(nvec)
        offsets.append(off)
    return _polytope_from_halfspaces(np.array(normals), np.array(offsets), x0)


class PolyhedralLimits(IteratedLimits):
    """Iterated limits over a convex polytope ``normals @ x <= offsets``.

    The outer variable is the last coordinate; its breakpoints (distinct
    vertex coordinates, where the active face set changes — reference
    ``get_segs``, ``ext/SymmetryReduceBZExt.jl:15-31``) are static.  Fixed
    coordinates substitute into the half-spaces, so inner bounds are masked
    min/max reductions over faces; at d = 2 additional breakpoints come from
    pairwise face intersections.
    """

    def __init__(self, polytope_or_normals, offsets=None, fixed=(), vertices=None):
        if isinstance(polytope_or_normals, ConvexPolytope):
            poly = polytope_or_normals
            self.normals = jnp.asarray(poly.normals)
            self.offsets = jnp.asarray(poly.offsets)
            self._static_vertices = poly.vertices
        else:
            self.normals = jnp.asarray(polytope_or_normals)
            self.offsets = offsets
            self._static_vertices = vertices
        self.fixed = tuple(fixed)  # coordinates fixed so far (outermost first)

    @property
    def ndim(self):
        return self.normals.shape[1] - len(self.fixed)

    def outer_segments(self):
        d_rem = self.ndim
        if not self.fixed:
            # static: distinct vertex coordinates along the outer axis
            vs = np.unique(np.round(self._static_vertices[:, d_rem - 1], 12))
            return jnp.asarray(vs)
        # reduced offsets after substituting fixed coords
        off = self._sub_offsets()
        A = self.normals[:, :d_rem]
        a = A[:, d_rem - 1]
        rest = A[:, : d_rem - 1]
        if d_rem == 1:
            lo = jnp.max(jnp.where(a < -1e-14, off / a, -_BIG))
            hi = jnp.min(jnp.where(a > 1e-14, off / a, _BIG))
            return jnp.stack([lo, jnp.maximum(lo, hi)])
        # d_rem == 2: polygon in (x1, x2).  The x2 breakpoints are ALL
        # polygon-vertex coordinates — the points where the active edge set
        # changes and the inner x1-interval endpoints kink (the reference
        # inserts these per slice: ``get_segs``, ext/SymmetryReduceBZExt.jl:15-31;
        # polygon walking, ext/ibzlims.jl:198-289).  Vertices are the feasible
        # pairwise edge intersections — a fixed-shape masked reduction: a
        # polygon cut from F half-planes has at most F vertices, so the sorted
        # feasible x2 values are clamped into F slots (infeasible/overflow
        # slots collapse onto hi as zero-width segments).
        a1 = rest[:, 0]
        a2 = a
        b = off
        F = a1.shape[0]
        i, j = jnp.triu_indices(F, k=1)
        det = a1[i] * a2[j] - a1[j] * a2[i]
        safe = jnp.abs(det) > 1e-12
        det_s = jnp.where(safe, det, 1.0)
        x1 = (b[i] * a2[j] - b[j] * a2[i]) / det_s
        x2 = (a1[i] * b[j] - a1[j] * b[i]) / det_s
        feas = safe & jnp.all(
            a1[None, :] * x1[:, None] + a2[None, :] * x2[:, None] <= b[None, :] + 1e-9,
            axis=1,
        )
        any_f = jnp.any(feas)
        lo = jnp.where(any_f, jnp.min(jnp.where(feas, x2, _BIG)), 0.0)
        hi = jnp.where(any_f, jnp.max(jnp.where(feas, x2, -_BIG)), 0.0)
        hi = jnp.maximum(lo, hi)
        verts = jnp.sort(jnp.where(feas, x2, _BIG))[:F]  # ascending, pads last
        return jnp.concatenate([lo[None], jnp.clip(verts, lo, hi)])

    def _sub_offsets(self):
        """offsets minus contribution of fixed coordinates (fixed[0] is the
        original last coordinate)."""
        D = self.normals.shape[1]
        off = self.offsets
        for k, x in enumerate(self.fixed):
            off = off - self.normals[:, D - 1 - k] * x
        return off

    def fix(self, x):
        return PolyhedralLimits(self.normals, self.offsets, self.fixed + (x,),
                                self._static_vertices)

    def interior_point(self):
        return self._static_vertices.mean(axis=0)
