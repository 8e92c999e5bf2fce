"""Berry curvature, Chern numbers, and the intrinsic anomalous Hall
conductivity on the cached spectral grid.

Beyond the reference's surface (AutoBZCore.jl ships the integration
machinery; its companion application packages compute transport responses
with it — cf. the kinetic-coefficient solvers in ``models/transport.py``).
Formulated like :class:`~.observables.TransportSolver`: the (H, dH) grid
is evaluated and eigendecomposed ONCE (one batched program), and every
(mu, beta) query is a masked reduction over the cached
band-resolved curvature.

Physics: the band Berry curvature from Kubo perturbation theory,

    Omega_n,ab(k) = -2 Im  sum_{m != n}  v_a,nm v_b,mn / (e_n - e_m)^2 ,

with ``v_a = dH/du_a`` the band-basis velocity in FRACTIONAL coordinates
``u`` (``k = B u``; the series evaluates as ``H(u) = sum_R c_R e^{2 pi i
R.u}``, derivative convention ``ops/fourier_eval.py`` module docstring).
Cartesian curvature follows by the rank-2 tensor transformation
``Omega^cart_ab = (B^-T Omega^frac B^-1)_ab``.

Observables:

- Chern numbers (2D): ``C_n = (1/2pi) int_{[0,1)^2} Omega^frac_n,12 du`` —
  basis-independent integers on gapped bands.
- Intrinsic anomalous Hall conductivity:
  ``sigma_ab = -(e^2/hbar) I_ab`` with
  ``I_ab = int d^dk/(2pi)^d  sum_n f(e_n) Omega^cart_n,ab``
  (this module returns the dimensionless ``I_ab``; in 2D with the chemical
  potential in a gap, ``I_xy = sign(det B) C_occ / (2pi)``, i.e.
  ``sigma_xy = -C_occ e^2/h`` for ``det B > 0``).

Symmetry: Berry curvature is odd under time reversal, and the lattice point
group stored on an IBZ need not commute with a TRS-broken Hamiltonian (the
IBZ reduction was derived from the lattice alone, reference
``src/brillouin.jl:260-307``), so this solver requires a full-zone
``load_bz(FBZ, ...)`` and raises otherwise — the same conservative stance
the reference takes when a representation is unknown
(``src/brillouin.jl:346-351``), except made an error because silent
symmetrization would zero the answer.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..fourier import FourierSeries
from .transport import fermi


class BerryPack(NamedTuple):
    """Band energies and band-resolved fractional-coordinate Berry curvature
    on the full ``npt^d`` zone grid (built once, queried per (mu, beta)).
    ``Mm`` is the band self-rotation moment entering the modern theory of
    orbital magnetization (same Kubo pair sum with a ``1/(e_n - e_m)``
    weight instead of ``1/(e_n - e_m)^2``)."""

    e: object        # (K, m) band energies
    Om: object       # (K, m, d, d) Omega^frac_n,ab per grid point and band
    Mm: object       # (K, m, d, d) m^frac_n,ab = sum_m Q_ab,nm / (e_n - e_m)
    vd: object       # (K, m, d) diagonal band velocities Re v_a,nn (group vel.)
    ndim: int
    npt: int


def _slab_rows(h, npt, d, max_pts=1 << 18):
    """Row slabs along the first grid dim: (S, L) first-coordinate table plus
    the fixed inner nodes.  Per-slab temps (K_loc, d, d, m, m) stay bounded,
    where an unchunked build at npt >= ~2048 would hold the whole grid's
    small-matrix products at once."""
    L = npt
    while L > 1 and L * npt ** (d - 1) > max_pts:
        L //= 2
    while npt % L:
        L -= 1
    u1 = np.arange(npt) / npt * h.period[0]
    inner = [np.arange(npt) / npt * h.period[j] for j in range(1, d)]
    return u1.reshape(-1, L), inner


def _eigh_batch(hk):
    from ..ops.eigh3 import eigh_small

    return eigh_small(hk)


def _pair_inv(e, degtol, power):
    """Degeneracy-masked band-pair denominators ``1/(e_n - e_m)^power``
    (zero on |de| <= degtol, incl. the diagonal) — THE shared masking rule
    for every Kubo sum in this module."""
    de = e[..., :, None] - e[..., None, :]
    safe = jnp.where(de == 0, 1.0, de)
    ok = jnp.abs(de) > degtol
    return jnp.where(ok, 1.0 / safe**power, 0.0)


def _band_pair_terms(hk, vk, degtol, with_moment=True):
    """(e, Om, Mm, vd) for a flat (K, ...) batch of H and dH values."""
    e, U = _eigh_batch(hk)
    vband = jnp.einsum("kmi,kdij,kjn->kdmn", jnp.conj(jnp.swapaxes(U, 1, 2)), vk, U)
    # Im[v_a,nm v_b,mn] band-pair products; (K, d, d, m, m) with [.., n, m]
    Q = jnp.imag(jnp.einsum("kanm,kbmn->kabnm", vband, vband))
    inv2 = _pair_inv(e, degtol, 2)
    # Omega_n,ab = -2 sum_m Q[a,b,n,m] / (e_n - e_m)^2
    Om = -2.0 * jnp.einsum("kabnm,knm->knab", Q, inv2)
    # group velocities: diagonal band-basis matrix elements (real)
    vd = jnp.real(jnp.einsum("kdnn->knd", vband))
    if not with_moment:
        return e, Om, None, vd
    inv1 = _pair_inv(e, degtol, 1)
    # self-rotation moment m_n,ab = sum_m Q[a,b,n,m] / (e_n - e_m)
    # (= -(1/2) Im <d_a u_n| x (H - e_n) |d_b u_n> antisymmetrized)
    Mm = jnp.einsum("kabnm,knm->knab", Q, inv1)
    return e, Om, Mm, vd


def _eval_slab(h, d, u1_blk, inner):
    """(H, dH) on one row slab, flattened to (L * npt^(d-1), ...)."""
    from ..ops.fourier_eval import evaluate_grid

    nodes = [u1_blk] + inner
    hk = evaluate_grid(h.c, d, nodes, h.offset, h.period, None, h.dtype)
    grads = []
    for j in range(d):
        derivs = tuple(1 if i == j else 0 for i in range(d))
        grads.append(evaluate_grid(h.c, d, nodes, h.offset, h.period, derivs, h.dtype))
    vk = jnp.stack(grads, axis=d)
    hk = hk.reshape((-1,) + hk.shape[d:])
    vk = vk.reshape((-1, d) + vk.shape[d + 1:])
    return hk, vk


def berry_pack(h: FourierSeries, bz, npt, degtol=1e-8) -> BerryPack:
    """Evaluate (H, dH) on the full npt^d grid, eigendecompose, and build the
    band Berry curvature.  Streams the grid in row slabs (``lax.map``) so
    peak device memory stays O(slab) at any npt.  ``degtol``: band pairs
    closer than this are dropped from the Kubo sum (the n = m term is
    excluded analytically; at an exact crossing the band curvature is
    undefined — only the total over the degenerate subspace is meaningful,
    and that total is what any filled-band sum here reproduces because the
    pair's +/- contributions cancel)."""
    if getattr(bz, "syms", None) is not None:
        raise ValueError(
            "BerryCurvatureSolver requires a full-zone BZ (load_bz(FBZ, ...)): "
            "Berry curvature is time-reversal-odd and the stored lattice point "
            "group need not be a symmetry of a TRS-broken Hamiltonian"
        )
    d = bz.ndim
    build = _berry_build_fn(npt, d, np.shape(h.c), h.period, h.offset,
                            h.dtype, degtol)
    c = np.asarray(h.c)
    # (re, im) real argument pair (a complex-splitting boundary, see
    # StoredSeriesValues)
    e, Om, Mm, vd = build(jnp.asarray(c.real), jnp.asarray(c.imag))
    return BerryPack(e, Om, Mm, vd, d, npt)


def _berry_build_fn(npt, d, cshape, period, offset, dtype, degtol):
    """Compiled slab-streamed curvature build, coefficients as a runtime
    argument — model scans (phase diagrams) reuse one executable per
    (npt, coefficient shape)."""
    key = ("berry", npt, d, cshape, period, offset, dtype, degtol)
    fn = _LATTICE_CHERN_CACHE.get(key)
    if fn is not None:
        return fn

    class _S:  # light series view for _eval_slab (period/offset/dtype + c)
        pass

    proto = _S()
    proto.period, proto.offset, proto.dtype = period, offset, dtype
    u1_slabs_np, inner = _slab_rows(proto, npt, d)
    u1_slabs_np = np.asarray(u1_slabs_np)

    @jax.jit
    def build(cre, cim):
        s = _S()
        s.c = (cre + 1j * cim).astype(dtype)
        s.period, s.offset, s.dtype = period, offset, dtype

        def slab(u1_blk):
            hk, vk = _eval_slab(s, d, u1_blk, inner)
            return _band_pair_terms(hk, vk, degtol)

        e, Om, Mm, vd = jax.lax.map(slab, jnp.asarray(u1_slabs_np))
        flat = lambda a: a.reshape((-1,) + a.shape[2:])
        return flat(e), flat(Om), flat(Mm), flat(vd)

    _LATTICE_CHERN_CACHE[key] = build
    return build


def _operator_build_fn(npt, d, cshape, period, offset, dtype, degtol,
                       oshape, odtype_str):
    """Compiled O-weighted curvature build with coefficients AND operator as
    runtime (re, im) arguments — operator-Hall scans over model parameters
    reuse one executable per shape, like every other build here."""
    key = ("ophall", npt, d, cshape, period, offset, dtype, degtol,
           oshape, odtype_str)
    fn = _LATTICE_CHERN_CACHE.get(key)
    if fn is not None:
        return fn

    class _S:
        pass

    proto = _S()
    proto.period, proto.offset, proto.dtype = period, offset, dtype
    u1_slabs_np, inner = _slab_rows(proto, npt, d)
    u1_slabs_np = np.asarray(u1_slabs_np)

    @jax.jit
    def build(cre, cim, Ore, Oim):
        s = _S()
        s.c = (cre + 1j * cim).astype(dtype)
        s.period, s.offset, s.dtype = period, offset, dtype
        Oj = Ore + 1j * Oim

        def slab(u1_blk):
            hk, vk = _eval_slab(s, d, u1_blk, inner)
            e, U = _eigh_batch(hk)
            Ud = jnp.conj(jnp.swapaxes(U, 1, 2))
            vband = jnp.einsum("kmi,kdij,kjn->kdmn", Ud, vk, U)
            Ob = jnp.einsum("kmi,ij,kjn->kmn", Ud, Oj.astype(U.dtype), U)
            J = 0.5 * (jnp.einsum("knp,kdpm->kdnm", Ob, vband)
                       + jnp.einsum("kdnp,kpm->kdnm", vband, Ob))
            Q = jnp.imag(jnp.einsum("kanm,kbmn->kabnm", J, vband))
            OmO = -2.0 * jnp.einsum("kabnm,knm->knab", Q, _pair_inv(e, degtol, 2))
            return e, OmO

        e, OmO = jax.lax.map(slab, jnp.asarray(u1_slabs_np))
        flat = lambda a: a.reshape((-1,) + a.shape[2:])
        return flat(e), flat(OmO)

    _LATTICE_CHERN_CACHE[key] = build
    return build


def berry_flux_integrand(h: FourierSeries, degtol=1e-8):
    """The occupied-band Berry flux ``sum_{e_n < mu} Omega^frac_n,12(k)`` as a
    standard :class:`~..fourier.FourierIntegrand` over a
    :class:`~..fourier.JacobianSeries` — so Chern numbers and anomalous Hall
    integrals flow through the framework's OWN solve pipeline (PTR, AutoPTR,
    IAI, EvalCounter, sweeps...) like any other physics integrand.

    ``mu`` is a solve-time parameter.  Over a full-zone 2D BZ,
    ``solve(IntegralProblem(fi, bz, mu), alg).u = |det B| * 2 pi * C_occ``
    (the gapped-band identity tested in ``tests/test_berry.py``).  Use a
    full-zone ``load_bz(FBZ(), ...)``: curvature is TRS-odd (see module
    docstring).
    """
    from ..fourier import FourierIntegrand, JacobianSeries

    def flux(v, mu=None):
        H, V = v.s
        e, U = jnp.linalg.eigh(H)
        Ud = jnp.conj(jnp.swapaxes(U, -1, -2))
        vband = jnp.einsum("...mi,...dij,...jn->...dmn", Ud, V, U)
        Q = jnp.imag(jnp.einsum("...nm,...mn->...nm", vband[..., 0, :, :],
                                vband[..., 1, :, :]))
        Om = -2.0 * jnp.sum(Q * _pair_inv(e, degtol, 2), axis=-1)   # (..., n)
        occ = (e < mu).astype(Om.dtype)
        return jnp.sum(occ * Om, axis=-1)

    return FourierIntegrand(flux, JacobianSeries(h))


def lattice_chern(h: FourierSeries, bz, npt, bands=None):
    """Gauge-invariant lattice Chern number via plaquette Wilson loops
    (Fukui–Hatsuda–Suzuki, J. Phys. Soc. Jpn. 74, 1674 (2005)) — EXACTLY
    integer on any grid fine enough that every plaquette flux is < pi, even
    where the Kubo curvature sum converges only algebraically.  Supports a
    degenerate multiband set via the non-Abelian link determinant.

    ``bands``: band indices forming the (gapped) set; default = the lower
    half.  Returns a float that is an integer to machine precision.
    """
    from ..ops.fourier_eval import evaluate_grid

    if getattr(bz, "syms", None) is not None:
        raise ValueError(
            "lattice_chern requires a full-zone BZ (load_bz(FBZ, ...)): "
            "Berry curvature is time-reversal-odd and the stored lattice point "
            "group need not be a symmetry of a TRS-broken Hamiltonian"
        )
    if bz.ndim != 2:
        raise ValueError("lattice_chern is defined for 2D zones")
    bands_t = None if bands is None else tuple(int(b) for b in bands)
    fn = _lattice_chern_fn(npt, h.period, h.offset, h.dtype, bands_t)
    c = np.asarray(h.c)
    return float(fn(jnp.asarray(c.real), jnp.asarray(c.imag))) / (2 * np.pi)


def _lattice_chern_fn(npt, period, offset, dtype, bands):
    """Compiled FHS plaquette-sum, coefficients as a runtime ARGUMENT so
    parameter scans (phase diagrams, Weyl kz slices) reuse ONE executable
    per (npt, shape) instead of recompiling every model instance."""
    from ..ops.fourier_eval import evaluate_grid

    key = (npt, period, offset, str(dtype), bands)
    fn = _LATTICE_CHERN_CACHE.get(key)
    if fn is not None:
        return fn
    u = [np.arange(npt) / npt * period[j] for j in range(2)]

    @jax.jit
    def field_sum(cre, cim):
        c = (cre + 1j * cim).astype(dtype)
        hk = evaluate_grid(c, 2, u, offset, period, None, dtype)
        _, U = jnp.linalg.eigh(hk)                     # (npt, npt, m, m)
        m = U.shape[-1]
        idx = jnp.arange(m // 2) if bands is None else jnp.asarray(bands)
        V = U[..., idx]                                # (npt, npt, m, nb)
        Vx = jnp.roll(V, -1, axis=0)                   # periodic grid links
        Vy = jnp.roll(V, -1, axis=1)

        def link(Va, Vb):
            M = jnp.einsum("xyim,xyin->xymn", jnp.conj(Va), Vb)
            det = jnp.linalg.det(M)
            return det / jnp.abs(det)

        Lx = link(V, Vx)
        Ly = link(V, Vy)
        # plaquette field strength: the loop product's phase is -Omega dx dy
        # in the A_j = i<u|d_j u> convention used by berry_pack (the overlap
        # <u(k)|u(k+dx)> carries phase -A_x dx), so negate to match chern()
        F = -jnp.angle(Lx * jnp.roll(Ly, -1, axis=0)
                       * jnp.conj(jnp.roll(Lx, -1, axis=1)) * jnp.conj(Ly))
        return jnp.sum(F)

    _LATTICE_CHERN_CACHE[key] = field_sum
    return field_sum


_LATTICE_CHERN_CACHE = {}


def wilson_loop_spectrum(h: FourierSeries, npt, bands=None, nloop=None):
    """Hybrid Wannier center flow: eigenphases of the non-Abelian Wilson
    loop around the k1 circle, as a function of k2.

    Returns centers (nk2, nb) in [-1/2, 1/2) (units of the a1 lattice
    vector), sorted per row.  The loop at each k2 multiplies the occupied-
    subspace link overlaps ``V(k1)^dagger V(k1 + dk1)`` around the zone
    (gauge-invariant spectrum; no smooth-gauge fixing needed).  The center
    flow winds by ``-C`` over one k2 period for a Chern band and exhibits
    the partner-switching pattern that defines the Z2 invariant
    (:func:`z2_invariant`).

    ``npt``: loop discretization along k1; ``nloop``: number of k2 rows
    (defaults to npt); ``bands``: band indices (default: lower half).
    """
    from ..ops.fourier_eval import evaluate_grid

    n2 = npt if nloop is None else int(nloop)
    bands_t = None if bands is None else tuple(int(b) for b in bands)
    key = ("wilson", npt, n2, np.shape(h.c), h.period, h.offset, h.dtype, bands_t)
    loops = _LATTICE_CHERN_CACHE.get(key)
    if loops is not None:
        return _wilson_tail(loops, h)
    u = [np.arange(npt) / npt * h.period[0],
         np.arange(n2) / n2 * h.period[1]]

    @jax.jit
    def loops(cre, cim):
        c = (cre + 1j * cim).astype(h.dtype)
        hk = evaluate_grid(c, 2, u, h.offset, h.period, None, h.dtype)
        _, U = _eigh_batch(hk)                        # (npt, n2, m, m)
        m = U.shape[-1]
        idx = jnp.arange(m // 2) if bands is None else jnp.asarray(bands)
        V = U[..., idx]                               # (npt, n2, m, nb)
        Vn = jnp.roll(V, -1, axis=0)
        L = jnp.einsum("xyim,xyin->xymn", jnp.conj(V), Vn)  # links along k1

        def step(W, Lx):
            return jnp.einsum("ymn,ynp->ymp", W, Lx), None

        nb = L.shape[-1]
        W0 = jnp.broadcast_to(jnp.eye(nb, dtype=L.dtype), (n2, nb, nb))
        W, _ = jax.lax.scan(step, W0, L)
        return jnp.real(W), jnp.imag(W)

    _LATTICE_CHERN_CACHE[key] = loops
    return _wilson_tail(loops, h)


def _wilson_tail(loops, h):
    c = np.asarray(h.c)
    wr, wi = loops(jnp.asarray(c.real), jnp.asarray(c.imag))
    # eigenphases of the tiny per-row loop matrices on HOST: general
    # (non-Hermitian) eig is CPU-only in jax, and (n2, nb, nb) is trivial
    lam = np.linalg.eigvals(np.asarray(wr) + 1j * np.asarray(wi))
    th = np.angle(lam) / (2 * np.pi)
    return np.sort(th, axis=-1)


def z2_invariant(h: FourierSeries, npt=48, bands=None, nloop=None):
    """Time-reversal Z2 invariant from Wannier-center flow over HALF the
    zone (Yu–Qi–Bernevig–Dai–Fang largest-gap tracking, PRB 84, 075119
    (2011)): follow the midpoint of the largest gap between sorted centers
    from k2 = 0 to k2 = 1/2 and count center crossings mod 2.

    Applies to time-reversal-symmetric models with an even occupied set
    (Kramers pairs); returns 0 or 1.
    """
    n2 = (npt if nloop is None else int(nloop))
    if n2 % 2:
        n2 += 1
    th = np.asarray(wilson_loop_spectrum(h, npt, bands=bands, nloop=n2))
    if th.shape[1] % 2:
        raise ValueError(
            "z2_invariant needs an even occupied set (Kramers pairs); got "
            f"{th.shape[1]} bands — pass bands=[...] explicitly")
    half = th[: n2 // 2 + 1]                          # k2 in [0, 1/2]
    nb = half.shape[1]

    def gap_center(row):
        ext = np.concatenate([row, [row[0] + 1.0]])
        gaps = np.diff(ext)
        j = int(np.argmax(gaps))
        gc = ext[j] + gaps[j] / 2
        return (gc + 0.5) % 1.0 - 0.5

    crossings = 0
    g = gap_center(half[0])
    for i in range(1, len(half)):
        g2 = gap_center(half[i])
        d_end = (g2 - g) % 1.0
        if d_end <= 0.5:
            lo, span = g, d_end
        else:  # moved the short way backwards
            lo, span = g2, 1.0 - d_end
        for x in half[i]:
            if 0 < (x - lo) % 1.0 <= span:
                crossings += 1
        g = g2
    return crossings % 2


class BerryCurvatureSolver:
    """Reusable Berry-curvature observables over one cached (H, dH) grid.

    >>> slv = BerryCurvatureSolver(h, load_bz(FBZ(), np.eye(2)), npt=120)
    >>> slv.chern()                  # per-band Chern numbers (2D)
    >>> slv.ahc(mu=0.0, beta=None)   # I_ab; sigma_ab = -(e^2/hbar) I_ab
    """

    def __init__(self, h: FourierSeries, bz, npt, degtol=1e-8, pack=None):
        if pack is None:
            pack = berry_pack(h, bz, npt, degtol=degtol)
        self.pack = pack
        self.bz = bz
        self._h = h
        Binv = np.linalg.inv(np.asarray(bz.B, dtype=np.float64))
        self._Binv = jnp.asarray(Binv)
        self._detB = float(np.linalg.det(np.asarray(bz.B, dtype=np.float64)))

    def _cart_average(self, band_weights, field):
        """``|det B|/(2pi)^d * B^-T [mean_k sum_n w_kn field_kn,ab] B^-1`` —
        the shared fractional-to-Cartesian zone average behind every (mu,
        beta) query."""
        p = self.pack
        X = jnp.mean(jnp.einsum("km,kmab->kab",
                                band_weights.astype(field.dtype), field), axis=0)
        Xc = self._Binv.T @ X @ self._Binv
        return abs(self._detB) / (2 * np.pi) ** p.ndim * Xc

    def chern(self):
        """Per-band Chern numbers (2D only): ``(1/2pi) mean_u Omega^frac_12``.
        Integers (to grid accuracy) whenever the band is isolated."""
        p = self.pack
        if p.ndim != 2:
            raise ValueError("chern() is defined for 2D zones")
        return jnp.mean(p.Om[:, :, 0, 1], axis=0) / (2 * np.pi)

    def ahc(self, mu=0.0, beta=None):
        """Dimensionless intrinsic anomalous Hall integral
        ``I_ab = int d^dk/(2pi)^d sum_n f(e_n) Omega^cart_n,ab``
        (``sigma_ab = -(e^2/hbar) I_ab``).  ``beta=None`` means zero
        temperature (step occupation)."""
        p = self.pack
        if beta is None:
            occ = (p.e < mu).astype(p.Om.dtype)
        else:
            occ = fermi(beta * (p.e - mu)).astype(p.Om.dtype)
        return self._cart_average(occ, p.Om)

    def anomalous_nernst(self, mu=0.0, beta=50.0):
        """Anomalous Nernst integral: the entropy-density-weighted Berry
        curvature (Xiao–Yao–Fang–Niu, PRL 97, 026603 (2006)),

            N_ab = int d^dk/(2pi)^d sum_n s_n(k) Omega^cart_n,ab ,
            s = -f ln f - (1 - f) ln(1 - f) ,

        evaluated with the overflow-stable form ``s(x) = softplus(x) -
        x sigmoid(x)``; the transverse thermoelectric response is
        ``alpha_ab = (k_B e/hbar) N_ab``.  Anchor (tested): the Mott
        relation ``N_ab -> (pi^2/(3 beta)) dI_ab/dmu`` at low temperature,
        with ``I`` the :meth:`ahc` integral."""
        p = self.pack
        x = beta * (p.e - mu)
        s = jax.nn.softplus(x) - x * jax.nn.sigmoid(x)
        return self._cart_average(s, p.Om)

    def berry_curvature_dipole(self, mu=0.0, beta=50.0):
        """Berry curvature dipole (the nonlinear Hall coefficient,
        Sodemann–Fu, PRL 115, 216806 (2015)) in the Fermi-surface form

            D_{a;bc} = int d^dk/(2pi)^d  sum_n (-df/de)(e_n) v_a,n Omega_n,bc

        evaluated as a smooth finite-``beta`` weighted grid sum over the
        cached pack (group velocities x band curvature; no curvature
        derivatives needed).  Returns (d, d, d) Cartesian.  Anchors
        (tested): vanishes identically under inversion symmetry (v is
        odd, Omega even) and for ``mu`` in a gap (no Fermi surface);
        switches on when inversion breaks at a metallic ``mu``."""
        p = self.pack
        x = beta * (p.e - mu)
        f = fermi(x)
        mdf = (beta * f * (1 - f)).astype(p.Om.dtype)   # -df/de, (K, m)
        Dfrac = jnp.mean(jnp.einsum("kn,kna,knbc->kabc", mdf, p.vd, p.Om), axis=0)
        Bi = self._Binv
        Dcart = jnp.einsum("ia,jb,kc,ijk->abc", Bi, Bi, Bi, Dfrac)
        return abs(self._detB) / (2 * np.pi) ** p.ndim * Dcart

    def quantum_metric(self, degtol=1e-8):
        """Band-resolved quantum metric (Fubini–Study / Provost–Vallee)
        ``g_n,ab(k) = sum_{m != n} Re[v_a,nm v_b,mn] / (e_n - e_m)^2`` in
        FRACTIONAL coordinates — the real part of the quantum geometric
        tensor whose imaginary part is ``-Omega/2``.  Returns (K, m, d, d);
        built once per solver (cached).  For any two-band model the
        pointwise bound ``det g >= (Omega/2)^2`` holds with equality on
        bands whose Bloch vector covers the sphere isotropically (the
        acceptance inequality in ``tests/test_berry.py``)."""
        cache = getattr(self, "_metric", None)
        if cache is not None and cache[0] == degtol:
            return cache[1]
        h, npt, d = self._h, self.pack.npt, self.pack.ndim
        u1_slabs, inner = _slab_rows(h, npt, d)

        @jax.jit
        def build(cre, cim):
            s = type("S", (), {})()
            s.c = (cre + 1j * cim).astype(h.dtype)
            s.period, s.offset, s.dtype = h.period, h.offset, h.dtype

            def slab(u1_blk):
                hk, vk = _eval_slab(s, d, u1_blk, inner)
                e, U = _eigh_batch(hk)
                vband = jnp.einsum("kmi,kdij,kjn->kdmn",
                                   jnp.conj(jnp.swapaxes(U, 1, 2)), vk, U)
                R = jnp.real(jnp.einsum("kanm,kbmn->kabnm", vband, vband))
                de = e[:, :, None] - e[:, None, :]
                safe = jnp.where(de == 0, 1.0, de)
                inv2 = jnp.where(jnp.abs(de) > degtol, 1.0 / safe**2, 0.0)
                # zero the diagonal n = m (Re[v_nn v_nn] != 0 but excluded)
                eye = jnp.eye(e.shape[-1], dtype=inv2.dtype)
                return jnp.einsum("kabnm,knm->knab", R, inv2 * (1 - eye))

            g = jax.lax.map(slab, jnp.asarray(u1_slabs))
            return g.reshape((-1,) + g.shape[2:])

        c = np.asarray(h.c)
        g = build(jnp.asarray(c.real), jnp.asarray(c.imag))
        self._metric = (degtol, g)
        return g

    def operator_hall(self, O, mu=0.0, beta=None, degtol=1e-8):
        """Operator-resolved intrinsic Hall integral (e.g. the SPIN Hall
        conductivity for ``O = s_z``):

            I^O_ab = int d^dk/(2pi)^d sum_n f(e_n) Omega^O_n,ab ,
            Omega^O_n,ab = -2 Im sum_{m != n} (J^O_a)_nm (v_b)_mn / (e_n - e_m)^2 ,

        with the symmetrized operator current ``J^O_a = (O v_a + v_a O)/2``
        (Kubo spin-Hall form; ``sigma^O_ab = -(e/hbar) I^O_ab``).  ``O`` is an
        (m, m) Hermitian matrix in the orbital basis.  When ``[H, O] = 0``
        this reduces to the O-eigenvalue-weighted curvature sum, so an
        s_z-conserving quantum spin Hall model gives the quantized spin
        Chern response ``I^sz_xy = sign(det B) (C_up - C_dn)/2 / (2 pi)``
        (the acceptance anchor in ``tests/test_berry.py``).

        Rebuilds an O-weighted curvature grid on first use per operator
        (cached on the operator's bytes); charge transport reuses the
        cheaper :meth:`ahc`.
        """
        Oarr = np.asarray(O)
        key = (Oarr.tobytes(), Oarr.shape, Oarr.dtype.str, float(degtol))
        cacheattr = getattr(self, "_op_cache", None)
        if cacheattr is None:
            cacheattr = self._op_cache = {}
        if key not in cacheattr:
            h = self._h
            build = _operator_build_fn(self.pack.npt, self.pack.ndim,
                                       np.shape(h.c), h.period, h.offset,
                                       h.dtype, degtol, Oarr.shape,
                                       Oarr.dtype.str)
            c = np.asarray(h.c)
            cacheattr[key] = build(jnp.asarray(c.real), jnp.asarray(c.imag),
                                   jnp.asarray(Oarr.real), jnp.asarray(Oarr.imag))
        e, OmO = cacheattr[key]
        if beta is None:
            occ = (e < mu).astype(OmO.dtype)
        else:
            occ = fermi(beta * (e - mu)).astype(OmO.dtype)
        return self._cart_average(occ, OmO)

    def orbital_magnetization(self, mu=0.0, beta=None):
        """Intrinsic orbital magnetization tensor ``M_ab`` (antisymmetric;
        in 2D the scalar magnetization is ``M[0, 1]``), in units ``e/hbar``,
        from the modern k-space theory (Shi–Vignale–Xiao–Niu, PRL 99,
        197202 (2007); Ceresoli et al., PRB 74, 024408 (2006)):

            M = int d^dk/(2pi)^d sum_n [ f_n m_n
                  + (1/beta) ln(1 + e^{-beta (e_n - mu)}) Omega_n ]

        with ``m_n`` the band self-rotation moment and the grand-potential
        Berry-curvature term reducing to ``(mu - e_n) theta(mu - e_n)`` at
        ``beta=None`` (zero temperature).  Inside a Chern gap,
        ``dM_xy/dmu = sign(det B) C_occ / (2 pi)`` — the quantized Streda
        slope (the acceptance anchor in ``tests/test_berry.py``)."""
        p = self.pack
        x = None if beta is None else beta * (p.e - mu)
        if beta is None:
            occ = (p.e < mu).astype(p.Om.dtype)
            gp = jnp.maximum(mu - p.e, 0.0).astype(p.Om.dtype)
        else:
            occ = fermi(x).astype(p.Om.dtype)
            gp = (jax.nn.softplus(-x) / beta).astype(p.Om.dtype)
        return self._cart_average(occ, p.Mm) + self._cart_average(gp, p.Om)


def certified_berry(h, bz, what="chern", abstol=1e-3, reltol=0.0, nmin=24,
                    nmax=480, factor=2**0.5, degtol=1e-8, **obs_kwargs):
    """Richardson-certified Berry observable vs the k-grid: run
    ``BerryCurvatureSolver(h, bz, npt).<what>(**obs_kwargs)`` on the
    rate-fitted npt ladder until the whole returned array is grid-converged
    (``models.observables.certified_ladder`` — the same certified-tolerance
    contract the reference's AutoPTR gives scalar BZ integrals,
    ``src/interfaces.jl:91-104``, extended to the topology family).

    ``what``: any zero-argument-or-keyword observable of
    :class:`BerryCurvatureSolver` — ``"chern"``, ``"ahc"``,
    ``"anomalous_nernst"``, ``"berry_curvature_dipole"``,
    ``"orbital_magnetization"``.  Returns a
    :class:`~.observables.CertifiedSweep`; ``retcode=False`` (honest
    truncation) when ``nmax`` is reached first.  On the Haldane anchor the
    certified Chern numbers are integer-exact and the certificate bounds the
    true npt->infinity error (tested)."""
    from .observables import certified_ladder

    def eval_at(npt):
        slv = BerryCurvatureSolver(h, bz, int(npt), degtol=degtol)
        return getattr(slv, what)(**obs_kwargs)

    return certified_ladder(eval_at, abstol, reltol, nmin, nmax, factor)
