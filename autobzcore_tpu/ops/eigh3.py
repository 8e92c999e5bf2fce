"""Closed-form eigenvalues for batched small Hermitian matrices.

``jnp.linalg.eigvalsh`` lowers to an iterative batched solver — overkill for
the 2x2/3x3 Hamiltonians that dominate Wannier DOS workloads.  These analytic
forms (trigonometric Cardano for 3x3) are pure elementwise arithmetic: no
iteration, fully parallel, and precision-polymorphic (c64, c128 or
split-f64).  Cardano on 10^6 complex128 3x3 matrices runs ~40x faster than
``jnp.linalg.eigvalsh`` on an H100 (PERF.md).

Used by the benchmark spectral path; fall back to ``eigvalsh`` for m > 3.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def eigvalsh2(h):
    """Eigenvalues of batched Hermitian 2x2 ``h`` (..., 2, 2), ascending."""
    a = jnp.real(h[..., 0, 0])
    c = jnp.real(h[..., 1, 1])
    b2 = jnp.abs(h[..., 0, 1]) ** 2
    mean = (a + c) / 2
    rad = jnp.sqrt(((a - c) / 2) ** 2 + b2)
    return jnp.stack([mean - rad, mean + rad], axis=-1)


def eigh2(h):
    """Closed-form eigendecomposition of batched Hermitian 2x2 ``h``:
    ``(e, U)`` with ascending eigenvalues and unitary ``U`` (columns are
    eigenvectors) — no iteration, so huge tiny-matrix batches stay
    elementwise instead of going through a batched eigensolver.

    Branch-stable: the upper-band eigenvector uses ``[d + r, conj(b)]`` for
    ``d >= 0`` and ``[b, r - d]`` otherwise (each degenerates only on the
    opposite sign), with an identity fallback at exact degeneracy r = 0.
    """
    a = jnp.real(h[..., 0, 0])
    c = jnp.real(h[..., 1, 1])
    b = h[..., 0, 1]
    d = (a - c) / 2
    r = jnp.sqrt(d**2 + jnp.abs(b) ** 2)
    mean = (a + c) / 2
    e = jnp.stack([mean - r, mean + r], axis=-1)

    pos = d >= 0
    v0 = jnp.where(pos, (d + r).astype(h.dtype), b)
    v1 = jnp.where(pos, jnp.conj(b), (r - d).astype(h.dtype))
    n = jnp.sqrt(jnp.abs(v0) ** 2 + jnp.abs(v1) ** 2)
    ok = n > 0
    nsafe = jnp.where(ok, n, 1.0)
    # degenerate (r = 0): any orthonormal pair works; use the identity
    up0 = jnp.where(ok, v0 / nsafe, jnp.zeros_like(v0))
    up1 = jnp.where(ok, v1 / nsafe, jnp.ones_like(v1))
    lo0 = -jnp.conj(up1)
    lo1 = jnp.conj(up0)
    U = jnp.stack([jnp.stack([lo0, up0], axis=-1),
                   jnp.stack([lo1, up1], axis=-1)], axis=-2)
    return e, U


def eigvalsh3(h):
    """Eigenvalues of batched Hermitian 3x3 ``h`` (..., 3, 3), ascending.

    Trigonometric (Cardano) solution of the characteristic cubic via matrix
    invariants [Smith, Comm. ACM 4 (1961) 168]."""
    rdt = jnp.real(h).dtype
    a11 = jnp.real(h[..., 0, 0])
    a22 = jnp.real(h[..., 1, 1])
    a33 = jnp.real(h[..., 2, 2])
    a12 = h[..., 0, 1]
    a13 = h[..., 0, 2]
    a23 = h[..., 1, 2]
    p1 = jnp.abs(a12) ** 2 + jnp.abs(a13) ** 2 + jnp.abs(a23) ** 2
    q = (a11 + a22 + a33) / 3
    d1, d2, d3 = a11 - q, a22 - q, a33 - q
    p2 = d1**2 + d2**2 + d3**2 + 2 * p1
    # scale-RELATIVE degeneracy guard: an absolute finfo.tiny floor would
    # let 1/sqrt overflow to inf -> NaN for (near-)scalar matrices like the
    # Gamma-point H of a cubic model, and under f32 flush-to-zero
    scale2 = q * q + p2
    thr = jnp.asarray(1e-24, rdt) * (scale2 + jnp.asarray(1e-30, rdt))
    p = jnp.sqrt(jnp.maximum(p2, thr) / 6)
    inv_p = 1.0 / p
    # det(B) where B = (A - qI)/p, expanded for Hermitian entries
    detB = (
        d1 * d2 * d3
        + 2 * jnp.real(a12 * a23 * jnp.conj(a13))
        - d1 * jnp.abs(a23) ** 2
        - d2 * jnp.abs(a13) ** 2
        - d3 * jnp.abs(a12) ** 2
    ) * inv_p**3
    r = jnp.clip(detB / 2, -1.0, 1.0)
    phi = jnp.arccos(r) / 3
    two_pi_3 = jnp.asarray(2 * np.pi / 3, rdt)
    e1 = q + 2 * p * jnp.cos(phi)
    e3 = q + 2 * p * jnp.cos(phi + 2 * two_pi_3)
    e2 = 3 * q - e1 - e3
    # (near-)scalar matrices: p ~ 0 -> all eigenvalues = diagonal
    diag = p2 <= thr
    e1 = jnp.where(diag, a33, e1)
    e2 = jnp.where(diag, a22, e2)
    e3 = jnp.where(diag, a11, e3)
    return jnp.sort(jnp.stack([e3, e2, e1], axis=-1), axis=-1)


def eigvalsh3_rows(a11, a22, a33, r12, i12, r13, i13, r23, i23):
    """Struct-of-arrays Cardano: the nine Hermitian entry planes as separate
    contiguous arrays (any common shape), returning ``(lo, mid, hi)``.

    The AoS form (slicing ``h[..., i, j]`` of a ``(K, 3, 3)`` array) reads
    each entry with stride 9; grid engines keep entry-major layouts and call
    this directly."""
    rdt = a11.dtype

    def abs2(re, im):
        return re * re + im * im

    b12, b13, b23 = abs2(r12, i12), abs2(r13, i13), abs2(r23, i23)
    p1 = b12 + b13 + b23
    q = (a11 + a22 + a33) / 3
    d1, d2, d3 = a11 - q, a22 - q, a33 - q
    p2 = d1**2 + d2**2 + d3**2 + 2 * p1
    # scale-relative guard (see eigvalsh3)
    scale2 = q * q + p2
    thr = jnp.asarray(1e-24, rdt) * (scale2 + jnp.asarray(1e-30, rdt))
    p = jnp.sqrt(jnp.maximum(p2, thr) / 6)
    inv_p = 1.0 / p
    # Re(a12 a23 conj(a13)) with split arithmetic
    re_triple = (r12 * r23 - i12 * i23) * r13 + (r12 * i23 + i12 * r23) * i13
    detB = (d1 * d2 * d3 + 2 * re_triple - d1 * b23 - d2 * b13 - d3 * b12) * inv_p**3
    r = jnp.clip(detB / 2, -1.0, 1.0)
    phi = jnp.arccos(r) / 3
    two_pi_3 = jnp.asarray(2 * np.pi / 3, rdt)
    e1 = q + 2 * p * jnp.cos(phi)
    e3 = q + 2 * p * jnp.cos(phi + 2 * two_pi_3)
    e2 = 3 * q - e1 - e3
    diag = p2 <= thr
    e1 = jnp.where(diag, a33, e1)  # largest
    e2 = jnp.where(diag, a22, e2)
    e3 = jnp.where(diag, a11, e3)  # smallest
    # 3-element ascending exchange network (cheaper than sort+stack on rows)
    lo = jnp.minimum(jnp.minimum(e1, e2), e3)
    hi = jnp.maximum(jnp.maximum(e1, e2), e3)
    mid = (e1 + e2 + e3) - lo - hi
    return lo, mid, hi


def eigvalsh3_split(h_re, h_im):
    """Split-complex variant: Hermitian ``h_re + i h_im`` without forming
    complex arrays (the split-f64 tiers)."""
    lo, mid, hi = eigvalsh3_rows(
        h_re[..., 0, 0], h_re[..., 1, 1], h_re[..., 2, 2],
        h_re[..., 0, 1], h_im[..., 0, 1],
        h_re[..., 0, 2], h_im[..., 0, 2],
        h_re[..., 1, 2], h_im[..., 1, 2],
    )
    return jnp.stack([lo, mid, hi], axis=-1)


def eigvalsh_small(h):
    """Dispatch: analytic for m in (1, 2, 3), LAPACK-style otherwise."""
    m = h.shape[-1]
    if m == 1:
        return jnp.real(h[..., 0, 0])[..., None]
    if m == 2:
        return eigvalsh2(h)
    if m == 3:
        return eigvalsh3(h)
    return jnp.linalg.eigvalsh(h)


def eigh_small(h):
    """Eigendecomposition dispatch: closed-form for m = 2 (``eigh2``),
    LAPACK-style otherwise — the (e, U) companion of ``eigvalsh_small``."""
    if h.shape[-1] == 2:
        return eigh2(h)
    return jnp.linalg.eigh(h)
