"""Split-complex (re, im) evaluation kernels: f64 precision without
complex128 arrays.

The opt-in split tiers (``IAI(precision="split"|"guided")``,
``GGR(precision="split"|"rayleigh")``, the ``reduced`` engine of
``benchmarks/northstar.py``) carry complex values as f64 real pairs; this
module implements their complex arithmetic:

- ``grid_hermitian_split``: Fourier-series evaluation on a tensor grid via
  cos/sin phase contractions (4 real tensordots per dimension);
- ``eigvalsh_split`` / ``eigh_split``: Hermitian eigensolve through the real
  symmetric embedding ``[[Re, -Im], [Im, Re]]`` (eigenvalues doubled; for
  eigenvectors, columns pair as (u_re, u_im)).

Everything here is jit-safe with only real arrays at the boundaries.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def phase_cs(x, n, offset, period, dtype=jnp.float64, deriv=0):
    """(cos, sin) parts of ``(2 pi i f)^deriv e^{i ang}``, ang = 2 pi f x/t.

    ``deriv=1`` gives the z-derivative phase ``2 pi f (-sin + i cos)``."""
    x = jnp.asarray(x, dtype)
    f = (offset + jnp.arange(n)).astype(dtype)
    ang = (2 * np.pi) * jnp.outer(x / period, f)
    c, s = jnp.cos(ang), jnp.sin(ang)
    for _ in range(deriv):
        fac = (2 * np.pi) * f[None, :]
        c, s = -fac * s, fac * c  # multiply by i*2pi*f
    return c, s


def contract_split(vre, vim, cos, sin, axis):
    """Contract split-complex ``v`` with phase ``e^{i ang}`` along ``axis``:
    (re + i im)(cos + i sin) summed over the axis, new axis prepends.

    Karatsuba form: 3 real tensordots instead of 4 —
    ``re = cc - ss``, ``im = (c+s)(re+im) - cc - ss``."""
    import jax

    prec = jax.lax.Precision.HIGHEST

    def td(c, v):
        return jnp.tensordot(c, v, axes=([1], [axis]), precision=prec)

    rr = td(cos, vre)
    ii = td(sin, vim)
    m3 = td(cos + sin, vre + vim)
    return rr - ii, m3 - rr - ii


def evaluate_grid_split(c_re, c_im, spatial_ndim, nodes, offsets, periods,
                        dtype=jnp.float64, derivs=None):
    """Split-complex tensor-grid evaluation; returns (re, im) arrays of shape
    ``(g_1, ..., g_d, *valshape)``.  Mirrors ``fourier_eval.evaluate_grid``."""
    d = spatial_ndim
    if derivs is None:
        derivs = (0,) * d
    vre = jnp.asarray(c_re, dtype)
    vim = jnp.asarray(c_im, dtype)
    vshape = vre.shape[d:]
    vre = vre.reshape(vre.shape[:d] + (-1,))
    vim = vim.reshape(vim.shape[:d] + (-1,))
    for j in range(d - 1, -1, -1):
        cos, sin = phase_cs(nodes[j], vre.shape[d - 1], offsets[j], periods[j], dtype, derivs[j])
        vre, vim = contract_split(vre, vim, cos, sin, d - 1)
    return (vre.reshape(vre.shape[:d] + vshape), vim.reshape(vim.shape[:d] + vshape))


def evaluate_points_split(c_re, c_im, spatial_ndim, X, offsets, periods,
                          dtype=jnp.float64, derivs=None):
    """Split-complex evaluation at an arbitrary (K, d) point batch; returns
    (re, im) arrays of shape (K, *valshape).  Mirrors
    ``fourier_eval.evaluate_points``: the trailing dimension contracts first
    as a big matmul, the rest per-point."""
    import jax

    prec = jax.lax.Precision.HIGHEST
    d = spatial_ndim
    if derivs is None:
        derivs = (0,) * d
    vre = jnp.asarray(c_re, dtype)
    vim = jnp.asarray(c_im, dtype)
    vshape = vre.shape[d:]
    vre = vre.reshape(vre.shape[:d] + (-1,))
    vim = vim.reshape(vim.shape[:d] + (-1,))
    K = X.shape[0]
    for j in range(d - 1, -1, -1):
        nj = vre.shape[j] if j == d - 1 else vre.shape[j + 1]
        cos, sin = phase_cs(X[:, j], nj, offsets[j], periods[j], dtype, derivs[j])
        if j == d - 1:
            vre, vim = contract_split(vre, vim, cos, sin, d - 1)
            # -> (K, n_1..n_{d-1}, V)
        else:
            # per-point contraction of axis j+1 with this point's phase row
            # (elementwise multiply+sum over the small coefficient axis)
            a = j + 1
            vre_m = jnp.moveaxis(vre, a, 1)
            vim_m = jnp.moveaxis(vim, a, 1)
            shape = (K, vre_m.shape[1]) + (1,) * (vre_m.ndim - 2)
            cb = cos.reshape(shape)
            sb = sin.reshape(shape)
            rr = jnp.sum(cb * vre_m, axis=1)
            ri = jnp.sum(cb * vim_m, axis=1)
            ir = jnp.sum(sb * vre_m, axis=1)
            ii = jnp.sum(sb * vim_m, axis=1)
            vre, vim = rr - ii, ri + ir
    return vre.reshape((K,) + vshape), vim.reshape((K,) + vshape)


def hermitian_embedding(h_re, h_im):
    """Real symmetric 2m x 2m embedding of Hermitian ``h = h_re + i h_im``:
    ``[[Re, -Im], [Im, Re]]`` (batched over leading axes)."""
    top = jnp.concatenate([h_re, -h_im], axis=-1)
    bot = jnp.concatenate([h_im, h_re], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def eigvalsh_split(h_re, h_im):
    """Eigenvalues of Hermitian ``h_re + i h_im`` via the real embedding.

    The embedding's 2m eigenvalues come in duplicated pairs; with ascending
    sort the distinct values sit at even indices."""
    E = hermitian_embedding(h_re, h_im)
    e2 = jnp.linalg.eigvalsh(E)  # (..., 2m) ascending, duplicated
    return e2[..., ::2]


def eigh_split(h_re, h_im, indep_tol=1e-7):
    """Eigen-decomposition of Hermitian ``h_re + i h_im`` via the real
    embedding: returns (e (..., m), u_re (..., m, m), u_im (..., m, m)) with
    eigenvector columns ``u[:, j] = u_re[:, j] + i u_im[:, j]``.

    Every real-embedding eigenvector ``v = (x; y)`` projects to a complex
    eigenvector ``u = x + iy`` and ``Jv = (-y; x)`` projects to ``i u``
    (parallel).  Picking every other column therefore fails inside degenerate
    eigenspaces (real dimension >= 4, e.g. at high-symmetry k-points), where
    LAPACK may return real columns whose complex projections are dependent.
    Instead, a sequential complex Gram-Schmidt over ALL ``2m`` projected
    columns (in ascending-eigenvalue order) keeps the first ``m`` independent
    ones: parallel projections drop out with residual ~eps and each degenerate
    cluster contributes exactly its complex dimension, so slot order matches
    the eigenvalue order."""
    import jax

    m = h_re.shape[-1]
    E = hermitian_embedding(h_re, h_im)
    e2, V = jnp.linalg.eigh(E)  # (..., 2m), (..., 2m, 2m)
    e = e2[..., ::2]
    batch = h_re.shape[:-2]
    dt = V.dtype
    # candidates: complex projections of all 2m real columns, scan axis first
    cand_re = jnp.moveaxis(V[..., :m, :], -1, 0)  # (2m, ..., m)
    cand_im = jnp.moveaxis(V[..., m:, :], -1, 0)

    slots = jnp.arange(m)

    def mgs_step(carry, cand):
        kept_re, kept_im, count = carry  # (..., m, m) rows = kept vectors
        ure, uim = cand

        def orth(rre, rim):
            # coef_j = <kept_j, r> (conjugated kept); unfilled rows are zero,
            # so they contribute nothing
            cre = jnp.sum(kept_re * rre[..., None, :] + kept_im * rim[..., None, :], axis=-1)
            cim = jnp.sum(kept_re * rim[..., None, :] - kept_im * rre[..., None, :], axis=-1)
            rre = rre - jnp.sum(cre[..., :, None] * kept_re - cim[..., :, None] * kept_im, axis=-2)
            rim = rim - jnp.sum(cre[..., :, None] * kept_im + cim[..., :, None] * kept_re, axis=-2)
            return rre, rim

        rre, rim = orth(ure, uim)
        rre, rim = orth(rre, rim)  # twice is enough (Kahan)
        nrm = jnp.sqrt(jnp.sum(rre * rre + rim * rim, axis=-1))
        keep = (nrm > indep_tol) & (count < m)
        inv = jnp.where(keep, 1.0 / jnp.where(nrm > 0, nrm, 1.0), 0.0)
        rre = rre * inv[..., None]
        rim = rim * inv[..., None]
        onehot = (slots == count[..., None]).astype(dt) * keep[..., None].astype(dt)
        kept_re = kept_re + onehot[..., :, None] * rre[..., None, :]
        kept_im = kept_im + onehot[..., :, None] * rim[..., None, :]
        return (kept_re, kept_im, count + keep.astype(count.dtype)), None

    init = (
        jnp.zeros(batch + (m, m), dt),
        jnp.zeros(batch + (m, m), dt),
        jnp.zeros(batch, jnp.int32),
    )
    (kept_re, kept_im, _), _ = jax.lax.scan(mgs_step, init, (cand_re, cand_im))
    # kept rows -> eigenvector columns
    u_re = jnp.swapaxes(kept_re, -1, -2)
    u_im = jnp.swapaxes(kept_im, -1, -2)
    return e, u_re, u_im
