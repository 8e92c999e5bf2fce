"""Rayleigh-refined f64 Hermitian eigenvalues from a c64 eigensolve.

Full-f64 eigenvalues via the real-symmetric 2m x 2m embedding
(``csplit_eval.eigh_split``) pay an f64 QR on a matrix twice the size.  For
eigenVALUES, second-order perturbation theory gives a cheaper route (the
opt-in ``GGR(precision="rayleigh")`` tier):

1. ``eigh`` in complex64 (native, fast) -> vectors ``U`` with per-column
   error ~eps_f32 * kappa;
2. split-f64 Rayleigh quotients ``lambda_b = (u_b^H H u_b) / (u_b^H u_b)``
   with the EXACT (split-f64) ``H``: the eigenvalue error is second order in
   the eigenvector error — ~(1e-7)^2 * ||H|| / gap for isolated bands, and
   inside a near-degenerate cluster the quotient stays within the cluster's
   spread (harmless for spectral sums).

All contractions are elementwise broadcast-sums; bands process in chunks to
bound the (K, m, m, chunk) broadcast temporary.

Used by the GGR split path for general band counts; ``eigvalsh3_split``
(closed-form Cardano) stays the m = 3 fast path.
"""
from __future__ import annotations

import jax.numpy as jnp


def eigvalsh_rayleigh(h_re, h_im, band_chunk=None, return_vectors=False):
    """f64 eigenvalues of Hermitian ``h_re + i h_im`` (..., m, m), ascending
    up to f32-scale reorderings inside near-degenerate clusters.

    ``return_vectors=True`` additionally returns the c64 eigenbasis as
    ``(u_re, u_im)`` f64-cast columns — f32-accurate, which suffices for
    first-order quantities like band velocities ``diag(U^H dH U)``."""
    m = h_re.shape[-1]
    if band_chunk is None:
        # bound the (..., m, m, chunk) broadcast temporary: ~2 m^2 elements
        # per point keeps 30-band grids inside device memory
        band_chunk = max(1, min(m, 64 // m))
    hc = h_re.astype(jnp.float32) + 1j * h_im.astype(jnp.float32)
    _, U = jnp.linalg.eigh(hc)  # (..., m, m) c64, native
    Ur = jnp.real(U).astype(h_re.dtype)
    Ui = jnp.imag(U).astype(h_re.dtype)

    outs = []
    for b0 in range(0, m, band_chunk):
        b1 = min(m, b0 + band_chunk)
        ur = Ur[..., :, b0:b1]  # (..., m, B)
        ui = Ui[..., :, b0:b1]
        # Hu = H @ u, split-complex, elementwise broadcast-sum over j
        hr = h_re[..., :, :, None]  # (..., m, m, 1)
        hi = h_im[..., :, :, None]
        urj = ur[..., None, :, :]  # (..., 1, m, B)
        uij = ui[..., None, :, :]
        hu_re = jnp.sum(hr * urj - hi * uij, axis=-2)  # (..., m, B)
        hu_im = jnp.sum(hr * uij + hi * urj, axis=-2)
        # u^H (Hu): Hermitian quotient is real
        num = jnp.sum(ur * hu_re + ui * hu_im, axis=-2)  # (..., B)
        den = jnp.sum(ur * ur + ui * ui, axis=-2)
        outs.append(num / den)
    e = jnp.concatenate(outs, axis=-1)
    if return_vectors:
        return e, Ur, Ui
    return e
