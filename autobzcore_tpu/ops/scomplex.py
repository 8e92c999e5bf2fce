"""Split-complex value type for the opt-in split-f64 integrand tiers.

``IAI(precision="split"|"guided")`` carries complex values through the
interval pools without complex128 arrays.  :class:`SplitComplex` represents
complex arrays as (re, im) f64 pairs with enough operator algebra that the
shipped observable kernels — Green's-function traces, adjugate inverses,
Lorentzian DOS — read the same as their complex forms.  It is a registered
pytree, so it flows through ``vmap``/``lax.while_loop``/the GK pool machinery
unchanged.

All arithmetic is elementwise: no op here lowers to a matmul.

Complements ``ops/csplit_eval.py`` (grid/point evaluation + eigensolves on
split pairs); reference context: the IAI efficiency claim this enables at
tight tolerance is ``src/brillouin.jl:361-377``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _parts(x):
    """(re, im) of anything coercible: SplitComplex, complex scalars/arrays
    (host constants), or real scalars/arrays (im = 0)."""
    if isinstance(x, SplitComplex):
        return x.re, x.im
    if isinstance(x, complex) or (
        hasattr(x, "dtype") and jnp.issubdtype(np.result_type(x), np.complexfloating)
    ):
        if isinstance(x, jax.core.Tracer):
            raise TypeError(
                "complex traced arrays cannot mix with SplitComplex — keep the "
                "whole kernel split"
            )
        return np.real(x), np.imag(x)
    return x, None  # None == exact zero imaginary part


def _add_im(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def _neg_im(a):
    return None if a is None else -a


@jax.tree_util.register_pytree_node_class
class SplitComplex:
    """Complex array as a (re, im) real pair; ``im=None`` means exactly 0."""

    __slots__ = ("re", "im")

    def __init__(self, re, im=None):
        self.re = re
        self.im = im

    # --- pytree (a zero imaginary part materializes so leaves stay static) --
    def tree_flatten(self):
        im = jnp.zeros_like(self.re) if self.im is None else self.im
        return (self.re, im), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # --- array-ish surface --------------------------------------------------
    @property
    def shape(self):
        return jnp.shape(self.re)

    @property
    def ndim(self):
        return jnp.ndim(self.re)

    @property
    def real(self):
        return self.re

    @property
    def imag(self):
        return jnp.zeros_like(self.re) if self.im is None else self.im

    def join(self):
        """Materialize as a complex array."""
        return self.re + 1j * self.imag

    def conj(self):
        return SplitComplex(self.re, _neg_im(self.im))

    def abs2(self):
        return self.re * self.re if self.im is None else self.re * self.re + self.im * self.im

    def __repr__(self):
        return f"SplitComplex(re={self.re!r}, im={self.im!r})"

    # --- ring operations ------------------------------------------------------
    def __neg__(self):
        return SplitComplex(-self.re, _neg_im(self.im))

    def __add__(self, other):
        ore, oim = _parts(other)
        return SplitComplex(self.re + ore, _add_im(self.im, oim))

    __radd__ = __add__

    def __sub__(self, other):
        ore, oim = _parts(other)
        return SplitComplex(self.re - ore, _add_im(self.im, _neg_im(oim)))

    def __rsub__(self, other):
        ore, oim = _parts(other)
        return SplitComplex(ore - self.re, _add_im(oim, _neg_im(self.im)))

    def __mul__(self, other):
        a, b = self.re, self.im
        c, d = _parts(other)
        if b is None and d is None:
            return SplitComplex(a * c, None)
        if b is None:
            return SplitComplex(a * c, a * d)
        if d is None:
            return SplitComplex(a * c, b * c)
        return SplitComplex(a * c - b * d, a * d + b * c)

    __rmul__ = __mul__

    def __truediv__(self, other):
        c, d = _parts(other)
        if d is None:
            return SplitComplex(self.re / c, None if self.im is None else self.im / c)
        den = c * c + d * d
        a, b = self.re, self.imag
        return SplitComplex((a * c + b * d) / den, (b * c - a * d) / den)

    def __rtruediv__(self, other):
        return sc(other) / self

    def __getitem__(self, idx):
        return SplitComplex(self.re[idx], None if self.im is None else self.im[idx])


def sc(x):
    """Coerce to SplitComplex."""
    if isinstance(x, SplitComplex):
        return x
    re, im = _parts(x)
    return SplitComplex(re, im)


def sc_eye(m, dtype=jnp.float64):
    return SplitComplex(jnp.eye(m, dtype=dtype), None)


def sc_sum(z: SplitComplex, axis=None):
    return SplitComplex(
        jnp.sum(z.re, axis=axis), None if z.im is None else jnp.sum(z.im, axis=axis)
    )


def sc_trace(M: SplitComplex):
    """Trace over the last two axes."""
    tr = lambda x: jnp.trace(x, axis1=-2, axis2=-1)
    return SplitComplex(tr(M.re), None if M.im is None else tr(M.im))


def sc_transpose(M: SplitComplex):
    sw = lambda x: jnp.swapaxes(x, -1, -2)
    return SplitComplex(sw(M.re), None if M.im is None else sw(M.im))


def sc_det_small(M: SplitComplex):
    """Determinant for m <= 3, fully expanded (elementwise ops only — no LU,
    mirrors models/observables._trace_inv_small)."""
    m = M.shape[-1]
    if m == 1:
        return M[..., 0, 0]
    if m == 2:
        return M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
    if m == 3:
        a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
        d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
        g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
        return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    raise ValueError("sc_det_small supports m <= 3")


def sc_trace_inv_small(M: SplitComplex):
    """Tr M^{-1} for m <= 3 by the adjugate identity (split-complex twin of
    models/observables._trace_inv_small)."""
    m = M.shape[-1]
    if m == 1:
        return sc(1.0) / M[..., 0, 0]
    tr = sc_trace(M)
    det = sc_det_small(M)
    if m == 2:
        return tr / det
    # tr(adj(M)) = (tr(M)^2 - tr(M^2)) / 2; tr(M^2) elementwise
    tr2 = sc_sum(M * sc_transpose(M), axis=(-1, -2))
    return (tr * tr - tr2) / (sc(2.0) * det)
