"""Fourier-series evaluation primitives: batched hierarchical contraction.

Native equivalent of the FourierSeriesEvaluators.jl kernel surface the
reference drives (``workspace_allocate/contract!/evaluate!``, reference
``src/fourier.jl:61-86,132-164``, ``src/AutoBZCore.jl:62``).  The reference
contracts one dimension at a time per scalar point with per-thread workspace
caches; here the same hierarchy becomes **batched complex tensor
contractions** (matrix products):

- ``evaluate_grid``: evaluate on a tensor-product grid one dimension at a
  time — O(N^d * prod(n) / n_1 + ...) ~ the reference's "comparable to
  multidimensional FFT" cost (``docs/src/examples.md:63-78``).
- ``evaluate_points``: arbitrary (K, d) point batches, contracting the trailing
  dimension first so the heavy step is a single (K x n_d x rest) matmul.
- ``contract``: fix the outermost variable, producing the coefficient tensor of
  a (d-1)-dimensional series — the workspace step reused across inner panels
  in nested integration (``src/fourier.jl:478``).

Conventions: a series with coefficients ``c[(n1..nd), V...]``, integer offsets
``o`` and periods ``t`` evaluates as ``s(x) = sum_n c[n] e^{2 pi i (n+o) . x/t}``.
Derivatives are taken with respect to the standardized coordinate ``z = x/t``
(factor ``2 pi i f`` per order), matching the reference's period-multiplied
velocities (``src/dos_ggr.jl:30``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# All contractions run at HIGHEST precision: a reduced-precision default for
# f32 products (bf16 or TF32 passes) costs ~3 decimal digits in H(k) — a
# visible DOS error at sharp spectral features (eta ~ 1e-2).  The
# contraction is a tiny fraction of the spectral pipeline's FLOPs.
_PREC = jax.lax.Precision.HIGHEST


def phase_matrix(x, n, offset, period, deriv=0, dtype=jnp.complex128):
    """(K, n) matrix of ``(2 pi i f)^deriv * exp(2 pi i f x/t)``, f = offset + 0..n-1.

    Computed entirely in the real/complex counterparts of ``dtype`` — never
    materializing complex128 when a complex64 series is requested.
    """
    rdt = jnp.finfo(dtype).dtype  # real counterpart of the complex dtype
    x = jnp.asarray(x, rdt)
    f = (offset + jnp.arange(n)).astype(rdt)
    ang = (2 * np.pi) * jnp.outer(x / period, f)
    ph = jnp.exp(1j * ang.astype(dtype))
    if deriv:
        ph = ph * ((2j * np.pi) * f.astype(dtype)) ** deriv
    return ph


def _flatten_values(c, spatial_ndim):
    vshape = c.shape[spatial_ndim:]
    return c.reshape(c.shape[:spatial_ndim] + (-1,)), vshape


def evaluate_grid(c, spatial_ndim, nodes, offsets, periods, derivs=None, dtype=jnp.complex128):
    """Evaluate on the tensor grid ``nodes[0] x ... x nodes[d-1]``.

    Returns array of shape ``(len(nodes[0]), ..., len(nodes[d-1]), *valshape)``.
    """
    d = spatial_ndim
    v, vshape = _flatten_values(jnp.asarray(c, dtype), d)
    if derivs is None:
        derivs = (0,) * d
    for j in range(d - 1, -1, -1):
        # after each contraction one grid axis prepends and one spatial axis
        # drops, so the axis holding n_j is always position d-1
        ph = phase_matrix(nodes[j], v.shape[d - 1], offsets[j], periods[j], derivs[j], dtype)
        v = jnp.tensordot(ph, v, axes=([1], [d - 1]), precision=_PREC)
    # axes are now (g_1, ..., g_d, V)
    return v.reshape(v.shape[:d] + vshape)


def evaluate_points(c, spatial_ndim, X, offsets, periods, derivs=None, dtype=jnp.complex128):
    """Evaluate at an arbitrary batch ``X`` of shape (K, d) -> (K, *valshape)."""
    d = spatial_ndim
    v, vshape = _flatten_values(jnp.asarray(c, dtype), d)
    if derivs is None:
        derivs = (0,) * d
    K = X.shape[0]
    for j in range(d - 1, -1, -1):
        nj = v.shape[j] if j == d - 1 else v.shape[j + 1]
        ph = phase_matrix(X[:, j], nj, offsets[j], periods[j], derivs[j], dtype)
        if j == d - 1:
            # first contraction: big matmul (K, n_d) x (n_1..n_d, V)
            v = jnp.tensordot(ph, v, axes=([1], [d - 1]), precision=_PREC)  # (K, n_1..n_{d-1}, V)
        else:
            # batched: v (K, n_1..n_j.., V), contract axis j+1 per batch element
            v = _batched_contract(v, ph, j + 1)
    return v.reshape((K,) + vshape)


def _batched_contract(v, ph, axis):
    """Contract ``v[k, ..., n, ...]`` (n at ``axis``) with ``ph[k, n]``."""
    v = jnp.moveaxis(v, axis, 1)  # (K, n, rest...)
    out = jnp.einsum("kn,kn...->k...", ph, v, precision=_PREC)
    return out


def contract(c, spatial_ndim, x, offsets, periods, derivs=None, dtype=jnp.complex128):
    """Fix the last spatial variable at scalar ``x``: returns the coefficient
    tensor of the remaining (d-1)-dim series, shape ``(n_1..n_{d-1}, *val)``."""
    d = spatial_ndim
    v = jnp.asarray(c, dtype)
    deriv = 0 if derivs is None else derivs[d - 1]
    ph = phase_matrix(jnp.reshape(x, (1,)), v.shape[d - 1], offsets[d - 1], periods[d - 1], deriv, dtype)
    out = jnp.tensordot(ph, v, axes=([1], [d - 1]), precision=_PREC)  # (1, n_1..n_{d-1}, val)
    return out[0]


def evaluate_points_jacobian(c, spatial_ndim, X, offsets, periods, dtype=jnp.complex128):
    """Evaluate (H, grad_z H) at (K, d) points.

    Returns ``(h (K, *val), v (K, d, *val))`` where the gradient is with
    respect to the standardized coordinate z = x/t.
    """
    h = evaluate_points(c, spatial_ndim, X, offsets, periods, None, dtype)
    grads = []
    for j in range(spatial_ndim):
        derivs = tuple(1 if i == j else 0 for i in range(spatial_ndim))
        grads.append(evaluate_points(c, spatial_ndim, X, offsets, periods, derivs, dtype))
    return h, jnp.stack(grads, axis=1)
