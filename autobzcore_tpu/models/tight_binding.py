"""Canonical tight-binding model builders.

Fixtures matching the reference's test models: ``integer_lattice``
(``test/utils.jl:3-9``), ``tb_integer`` and ``tb_graphene``
(``test/dos.jl:8-41``), used for the analytic-DOS acceptance suite.
"""
from __future__ import annotations

import numpy as np

from ..fourier import FourierSeries


def integer_lattice(n, coeff=None):
    """Nearest-neighbor hopping coefficients on Z^n: C[+-e_i] = 1/(2n)
    (scalar-valued), centered offsets."""
    coeff = 1.0 / (2 * n) if coeff is None else coeff
    C = np.zeros((3,) * n)
    for i in range(n):
        for j in (0, 2):
            idx = tuple(j if k == i else 1 for k in range(n))
            C[idx] = coeff
    return C


def tb_integer(n, t=1.0, period=1.0, dtype=None):
    """n-dim integer-lattice tight-binding Hamiltonian as a 1x1 Fourier
    series: H(k) = 2t sum_i cos(2 pi k_i) (reference ``test/dos.jl:34-41``)."""
    import jax.numpy as jnp

    C = integer_lattice(n, coeff=t)[..., None, None]
    return FourierSeries(C, period=period, offset=(-1,) * n, ndim=n,
                         dtype=dtype or jnp.complex128)


def tb_graphene(t=1.0, period=1.0, dtype=None):
    """Graphene 2-band tight-binding model on the 2D hexagonal lattice in
    fractional coordinates (reference ``test/dos.jl:8-14``)."""
    import jax.numpy as jnp

    C = np.zeros((5, 5, 2, 2), dtype=np.complex128)  # offsets -2..2
    o = 2

    def put(i, j, a, b, val):
        C[i + o, j + o, a, b] = val

    put(1, 1, 0, 1, t)
    put(1, -2, 0, 1, t)
    put(-2, 1, 0, 1, t)
    put(-1, -1, 1, 0, t)
    put(-1, 2, 1, 0, t)
    put(2, -1, 1, 0, t)
    return FourierSeries(C, period=period, offset=(-2, -2), ndim=2,
                         dtype=dtype or jnp.complex128)


def tb_haldane(t1=1.0, t2=0.2, phi=np.pi / 2, M=0.0, period=1.0, dtype=None):
    """Haldane model on the honeycomb lattice in fractional coordinates —
    the canonical Chern insulator (TRS-broken 2-band model; Haldane, PRL 61,
    2015 (1988)).  Topological (|C| = 1) for ``|M| < 3 sqrt(3) |t2 sin phi|``,
    trivial otherwise — the fixture for the Berry/Chern acceptance tests.

    Blocks: ``H_AB(u) = t1 (1 + e^{-2 pi i u1} + e^{-2 pi i u2})``;
    ``H_AA = M + 2 t2 sum_i cos(2 pi b_i . u + phi)`` and
    ``H_BB = -M + 2 t2 sum_i cos(2 pi b_i . u - phi)`` over the cyclic NNN
    triple ``b = (1,0), (-1,1), (0,-1)``.
    """
    import jax.numpy as jnp

    C = np.zeros((3, 3, 2, 2), dtype=np.complex128)  # offsets -1..1
    o = 1

    def add(i, j, a, b, val):
        C[i + o, j + o, a, b] += val

    # nearest-neighbor A->B (and hermitian transpose entries)
    for (i, j) in ((0, 0), (-1, 0), (0, -1)):
        add(i, j, 0, 1, t1)
        add(-i, -j, 1, 0, t1)
    # on-site mass
    add(0, 0, 0, 0, M)
    add(0, 0, 1, 1, -M)
    # NNN with Haldane phase: +phi on A, -phi on B
    for (i, j) in ((1, 0), (-1, 1), (0, -1)):
        add(i, j, 0, 0, t2 * np.exp(1j * phi))
        add(-i, -j, 0, 0, t2 * np.exp(-1j * phi))
        add(i, j, 1, 1, t2 * np.exp(-1j * phi))
        add(-i, -j, 1, 1, t2 * np.exp(1j * phi))
    return FourierSeries(C, period=period, offset=(-1, -1), ndim=2,
                         dtype=dtype or jnp.complex128)


def tb_kane_mele_sz(t1=1.0, lam_so=0.1, M=0.0, period=1.0, dtype=None):
    """S_z-conserving Kane–Mele model (quantum spin Hall; Kane & Mele, PRL
    95, 226801 (2005)) as a 4-band block-diagonal series: spin-up = Haldane
    with ``phi = +pi/2, t2 = lam_so``, spin-down its time reverse
    (``phi = -pi/2``).  Basis order (A-up, B-up, A-dn, B-dn); use
    ``O = diag(1, 1, -1, -1)/2`` as the spin operator.  Spin Chern number
    ``(C_up - C_dn)/2 = -1`` in the topological phase
    (``|M| < 3 sqrt(3) lam_so``); total charge Chern is zero (TRS)."""
    import jax.numpy as jnp

    up = np.asarray(tb_haldane(t1=t1, t2=lam_so, phi=np.pi / 2, M=M).c)
    dn = np.asarray(tb_haldane(t1=t1, t2=lam_so, phi=-np.pi / 2, M=M).c)
    C = np.zeros(up.shape[:2] + (4, 4), dtype=np.complex128)
    C[..., :2, :2] = up
    C[..., 2:, 2:] = dn
    return FourierSeries(C, period=period, offset=(-1, -1), ndim=2,
                         dtype=dtype or jnp.complex128)


def tb_kane_mele(t1=1.0, lam_so=0.1, lam_r=0.0, M=0.0, period=1.0, dtype=None):
    """Full Kane–Mele model including the Rashba term (PRL 95, 226801
    (2005)): basis (A-up, B-up, A-dn, B-dn).  ``lam_r`` breaks S_z
    conservation, so the spin Hall response dequantizes while the Z2
    invariant stays 1 until the gap closes (|lam_r| ~ 2 sqrt(3) lam_so at
    M=0) — the workload :func:`~.berry.z2_invariant` exists for.
    ``lam_r=0`` reduces exactly to :func:`tb_kane_mele_sz`.

    NN bond unit vectors (Cartesian, for the ``s x d`` Rashba form):
    ``(0,1)`` for R=(0,0), ``(-s3/2,-1/2)`` for R=(-1,0),
    ``(s3/2,-1/2)`` for R=(0,-1)`` with ``s3 = sqrt(3)``.
    """
    import jax.numpy as jnp

    C = np.zeros((3, 3, 4, 4), dtype=np.complex128)
    o = 1
    sx = np.array([[0, 1], [1, 0]], dtype=np.complex128)
    sy = np.array([[0, -1j], [1j, 0]])

    def add(i, j, blk):
        # blk: 4x4 in (A-up, B-up, A-dn, B-dn); hermitian pair added
        C[i + o, j + o] += blk
        C[-i + o, -j + o] += blk.conj().T

    def ab_spin(spin_mat):
        """spin_mat (2x2 on spin) acting on the A->B sublattice hop."""
        blk = np.zeros((4, 4), dtype=np.complex128)
        for s1 in range(2):
            for s2 in range(2):
                blk[2 * s1 + 0, 2 * s2 + 1] = spin_mat[s1, s2]
        return blk

    # basis map: index = 2*spin + sublattice (A=0, B=1)
    s3 = np.sqrt(3.0)
    bonds = (((0, 0), (0.0, 1.0)), ((-1, 0), (-s3 / 2, -0.5)),
             ((0, -1), (s3 / 2, -0.5)))
    for (i, j), (dx, dy) in bonds:
        hop = t1 * np.eye(2) + 1j * lam_r * (sx * dy - sy * dx)
        add(i, j, ab_spin(hop))
    # on-site mass +M on A, -M on B (both spins); add half so the hermitian
    # pair in add() sums to the full value at R = 0
    mass = np.diag([M, -M, M, -M]).astype(np.complex128)
    add(0, 0, mass / 2)
    # NNN spin-orbit: +phi for up, -phi for dn with phi = pi/2 -> i lam_so
    for (i, j) in ((1, 0), (-1, 1), (0, -1)):
        blk = np.zeros((4, 4), dtype=np.complex128)
        for sl in (0, 1):                       # A-A and B-B, opposite sign
            sgn = 1.0 if sl == 0 else -1.0
            blk[0 + sl, 0 + sl] += 1j * sgn * lam_so       # spin up
            blk[2 + sl, 2 + sl] += -1j * sgn * lam_so      # spin down
        add(i, j, blk)
    return FourierSeries(C, period=period, offset=(-1, -1), ndim=2,
                         dtype=dtype or jnp.complex128)


def tb_weyl(m=2.0, period=1.0, dtype=None):
    """Minimal two-band Weyl semimetal on the cubic lattice:
    ``H = sin(2 pi k1) sx + sin(2 pi k2) sy + (m - sum_i cos(2 pi k_i)) sz``.
    For ``1 < m < 3`` a single pair of Weyl nodes sits on the k3 axis at
    ``cos(2 pi k3) = m - 2``; the k3-slice Chern number is -1 between the
    nodes and 0 outside — the fixture for the 3D topology-scan tests."""
    import jax.numpy as jnp

    C = np.zeros((3, 3, 3, 2, 2), dtype=np.complex128)
    o = 1
    sx = np.array([[0, 1], [1, 0]], dtype=np.complex128)
    sy = np.array([[0, -1j], [1j, 0]])
    sz = np.array([[1, 0], [0, -1]], dtype=np.complex128)
    # sin(2 pi k1) sx = (e^{i} - e^{-i})/(2i): C[+e1] = sx/(2i), C[-e1] = -sx/(2i)
    C[o + 1, o, o] += sx / 2j
    C[o - 1, o, o] += -sx / 2j
    C[o, o + 1, o] += sy / 2j
    C[o, o - 1, o] += -sy / 2j
    C[o, o, o] += m * sz
    for ax in range(3):
        for s in (+1, -1):
            idx = [o, o, o]
            idx[ax] += s
            C[tuple(idx)] += -sz / 2
    return FourierSeries(C, period=period, offset=(-1, -1, -1), ndim=3,
                         dtype=dtype or jnp.complex128)


def t2g_rep(g):
    """The t2g representation ``D(g)`` of a 3x3 signed permutation ``g``.

    The orbitals (yz, zx, xy) are the symmetric pair tensors
    ``Q_i = e_b e_c^T + e_c e_b^T`` with ``{b, c} = {0, 1, 2} \\ {i}``; ``g``
    maps ``Q_i`` to ``g Q_i g^T = +-Q_j``, so ``D(g)`` is a signed permutation
    and ``D(gh) = D(g) D(h)``."""
    g = np.asarray(g, dtype=np.float64)
    Q = []
    for i in range(3):
        b, c = [j for j in range(3) if j != i]
        q = np.zeros((3, 3))
        q[b, c] = q[c, b] = 1.0
        Q.append(q)
    D = np.zeros((3, 3))
    for i in range(3):
        gq = g @ Q[i] @ g.T
        for j in range(3):
            D[j, i] = np.sum(Q[j] * gq) / 2
    return D


def cubic_t2g(seed=0, dtype=None):
    """Seeded 3-band t2g stand-in for a cubic Wannier Hamiltonian, with the
    footprint of the SrVO3 t2g model: a 5x5x5 R-box of real hoppings.

    Random real hoppings ``H_R`` decaying like ``exp(-|R|)`` are made
    Hermitian (``H_{-R} = H_R^T``) and averaged over the 48 cubic operations,
    ``H_R <- mean_g D(g)^T H_{gR} D(g)`` with ``D = t2g_rep(g)``, so that
    ``H(g k) = D(g) H(k) D(g)^T`` holds exactly and every IBZ rule over
    ``CubicSymIBZ`` equals its full-zone sum.  The spectrum is then scaled to
    a 3 eV width and shifted by an on-site term to be centered on 12.5 eV
    (both measured on a 12^3 grid), so the bands fill about [11, 14] eV,
    inside the aps window [10, 15]."""
    import jax.numpy as jnp

    from ..ops.symptr import cube_automorphism_syms

    nr, center, width = 5, 12.5, 3.0
    rng = np.random.default_rng(seed)
    o = (nr - 1) // 2
    R = np.stack(np.meshgrid(*[np.arange(nr) - o] * 3, indexing="ij"), axis=-1)
    C = rng.normal(size=(nr, nr, nr, 3, 3))
    C *= np.exp(-np.linalg.norm(R, axis=-1))[..., None, None]
    C = (C + np.flip(C, axis=(0, 1, 2)).swapaxes(-1, -2)) / 2
    Cs = np.zeros_like(C)
    syms = cube_automorphism_syms(3)
    for g in syms:
        D = t2g_rep(g)
        gR = R @ np.asarray(g).T + o  # index of g R
        CgR = C[gR[..., 0], gR[..., 1], gR[..., 2]]
        Cs += np.einsum("ji,abcjk,kl->abcil", D, CgR, D)
    C = Cs / len(syms)
    # spectrum on a coarse grid sets the scale and the on-site shift
    u = np.arange(12) / 12
    ph = np.exp(2j * np.pi * np.outer(u, np.arange(nr) - o))
    hk = np.einsum("ka,lb,mc,abcij->klmij", ph, ph, ph, C, optimize=True)
    e = np.linalg.eigvalsh(hk.reshape(-1, 3, 3))
    scale = width / (e.max() - e.min())
    C *= scale
    C[o, o, o] += (center - scale * (e.max() + e.min()) / 2) * np.eye(3)
    return FourierSeries(C.astype(np.complex128), period=1.0, offset=(-o,) * 3, ndim=3,
                         dtype=dtype or jnp.complex128)


def flagship_model(hr=None, wout=None, seed=0, dtype=None):
    """``(h, bz, label)``: the flagship 3-band Hamiltonian and its
    ``CubicSymIBZ``.  With a Wannier90 ``hr`` file (and the ``wout`` file
    that holds its lattice) the model is read from them (label
    ``"wannier90"``); without, it is :func:`cubic_t2g` from ``seed`` on a
    cubic lattice with a = 3.84 Angstrom (label ``"synthetic"``)."""
    from ..brillouin import CubicSymIBZ, load_bz

    if hr is None:
        return (cubic_t2g(seed=seed, dtype=dtype),
                load_bz(CubicSymIBZ(), 3.84 * np.eye(3)), "synthetic")
    if wout is None:
        raise ValueError("a Wannier90 hr file needs its wout file for the lattice")
    from ..io.wannier90 import hamiltonian_fourier_series, read_w90_hrdat

    h = hamiltonian_fourier_series(read_w90_hrdat(hr), dtype=dtype)
    return h, load_bz(CubicSymIBZ(), wout), "wannier90"


def synthetic_wannier(nbands, nr=5, ndim=3, decay=1.0, seed=0, period=1.0, dtype=None):
    """Random Hermitian-symmetric Wannier-like model: ``nbands`` bands with
    exponentially decaying real-space hoppings on an ``nr^ndim`` R-box.
    Used for scale tests (e.g. the 30+ band near-singular DOS config)."""
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (nr,) * ndim
    o = -((nr - 1) // 2)
    C = rng.normal(size=shape + (nbands, nbands)) + 1j * rng.normal(size=shape + (nbands, nbands))
    grids = np.meshgrid(*[np.arange(nr) + o] * ndim, indexing="ij")
    dist = np.sqrt(sum(g.astype(float) ** 2 for g in grids))
    C *= np.exp(-decay * dist)[..., None, None] / np.sqrt(nbands)
    # hermitian symmetry c(-R) = c(R)^dagger by EXPLICIT -R pairing: np.flip
    # maps index i -> nr-1-i, which equals the -R partner only when the
    # offset box is centered (odd nr); for even nr it silently paired c(-1)
    # with c(2)^dagger and produced a non-Hermitian H(k).  Planes whose -R
    # lies outside the box have no partner and are zeroed.
    idx = np.indices(shape).reshape(ndim, -1).T
    Ch = np.zeros_like(C)
    for i in idx:
        p = -(i + o) - o  # index of -R
        if np.all((p >= 0) & (p < nr)):
            Ch[tuple(i)] = (C[tuple(i)] + C[tuple(p)].conj().T) / 2
    C = Ch
    return FourierSeries(C, period=period, offset=(o,) * ndim, ndim=ndim,
                         dtype=dtype or jnp.complex128)
