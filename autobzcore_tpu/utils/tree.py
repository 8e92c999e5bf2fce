"""Pytree arithmetic and norms for integral results.

Integral results in this framework are arbitrary JAX pytrees (scalars, matrices,
nested containers, :class:`AuxValue`).  The adaptive drivers accumulate and
compare them with the helpers here, replacing the reference's reliance on Julia
type promotion (``LinearAlgebra.norm`` defaults, cf. reference
``src/algorithms.jl:17`` where ``norm`` is an algorithm hyperparameter).
"""
from __future__ import annotations

import operator
from functools import partial

import jax
import jax.numpy as jnp


def tree_add(a, b):
    return jax.tree_util.tree_map(operator.add, a, b)


def tree_sub(a, b):
    return jax.tree_util.tree_map(operator.sub, a, b)


def tree_scale(s, a):
    return jax.tree_util.tree_map(lambda x: s * x, a)


def tree_zeros_like(a):
    return jax.tree_util.tree_map(jnp.zeros_like, a)


def tree_sum(a, axis=None):
    """Sum each leaf over ``axis`` (used to reduce per-node values to an integral)."""
    return jax.tree_util.tree_map(lambda x: jnp.sum(x, axis=axis), a)


def tree_weighted_sum(w, a, axis=0):
    """``sum_i w[i] * a[i]`` along ``axis`` with weight broadcast over trailing dims."""

    def leaf(x):
        wshape = w.shape + (1,) * (x.ndim - w.ndim)
        return jnp.sum(jnp.reshape(w, wshape) * x, axis=axis)

    return jax.tree_util.tree_map(leaf, a)


def tree_norm(a):
    """2-norm over all flattened leaves (the reference's default ``norm``)."""
    leaves = jax.tree_util.tree_leaves(a)
    if not leaves:
        return jnp.zeros(())
    sq = sum(jnp.sum(jnp.abs(x) ** 2) for x in leaves)
    return jnp.sqrt(sq)


def tree_batched_norm(a, batch_ndim=1):
    """Per-batch-element 2-norm: leaves have shape (B, ...); returns (B,)."""
    leaves = jax.tree_util.tree_leaves(a)
    sq = None
    for x in leaves:
        axes = tuple(range(batch_ndim, x.ndim))
        term = jnp.sum(jnp.abs(x) ** 2, axis=axes)
        sq = term if sq is None else sq + term
    return jnp.sqrt(sq)


def tree_real_dtype(a, default=jnp.float64):
    for x in jax.tree_util.tree_leaves(a):
        return jnp.real(jnp.zeros((), dtype=jnp.asarray(x).dtype)).dtype
    return default


@partial(jax.jit, static_argnums=())
def _noop(x):
    return x


def host_complex_safe(x):
    """Materialize a (possibly complex) device pytree for host consumption.

    Complex leaves on non-CPU devices are split into (re, im) real transfers
    on device and rejoined as numpy complex arrays, for backends that
    cannot transfer complex buffers (a workaround queued for removal with
    the other complex-splitting boundaries, ROADMAP D2).  Real leaves and
    CPU arrays pass through untouched.
    """
    import jax

    def leaf(v):
        if not isinstance(v, jax.Array) or not jnp.iscomplexobj(v):
            return v
        try:
            platform = next(iter(v.devices())).platform
        except Exception:
            return v
        if platform == "cpu":
            return v
        import numpy as _np

        re, im = jax.jit(lambda u: (jnp.real(u), jnp.imag(u)))(v)
        return _np.asarray(re) + 1j * _np.asarray(im)

    return jax.tree_util.tree_map(leaf, x)
