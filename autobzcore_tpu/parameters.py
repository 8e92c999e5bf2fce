"""Parameter containers and the ParameterIntegrand protocol.

Native equivalent of reference ``src/parameters.jl``: ``MixedParameters``
(positional + keyword parameter container with a merge algebra,
``src/parameters.jl:11-35``), ``paramzip``/``paramproduct`` sweep builders
(``:56-79``), and ``ParameterIntegrand`` partial application (``:80-111``).

``MixedParameters`` is a registered pytree so parameter sweeps can be stacked
and fed to ``jax.vmap``/``lax.map`` (the on-device replacement for the
reference's threaded ``batchsolve``).
"""
from __future__ import annotations

import itertools

import jax
import numpy as np


class NullParameters:
    """Singleton representing absent parameters (reference ``src/interfaces.jl:23``)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "NullParameters()"


jax.tree_util.register_pytree_node(
    NullParameters, lambda p: ((), None), lambda aux, ch: NullParameters()
)


class MixedParameters:
    """Container for positional ``args`` and keyword ``kwargs`` parameters.

    ``p[i]`` accesses positional args, ``p.name`` accesses keywords, mirroring
    the reference semantics (``src/parameters.jl:22-24``).
    """

    def __init__(self, *args, **kwargs):
        object.__setattr__(self, "args", tuple(args))
        object.__setattr__(self, "kwargs", dict(kwargs))

    def __getitem__(self, i):
        return self.args[i]

    def __getattr__(self, name):
        try:
            return object.__getattribute__(self, "kwargs")[name]
        except KeyError:
            raise AttributeError(name) from None

    def __len__(self):
        return len(self.args)

    def __repr__(self):
        kw = ", ".join(f"{k}={v!r}" for k, v in self.kwargs.items())
        pos = ", ".join(repr(a) for a in self.args)
        return f"MixedParameters({', '.join(x for x in (pos, kw) if x)})"

    def __eq__(self, other):
        return (
            isinstance(other, MixedParameters)
            and self.args == other.args
            and self.kwargs == other.kwargs
        )


def _mp_flatten(p):
    keys = tuple(sorted(p.kwargs))
    children = p.args + tuple(p.kwargs[k] for k in keys)
    return children, (len(p.args), keys)


def _mp_unflatten(aux, children):
    nargs, keys = aux
    p = MixedParameters(*children[:nargs])
    object.__setattr__(p, "kwargs", dict(zip(keys, children[nargs:])))
    return p


jax.tree_util.register_pytree_node(MixedParameters, _mp_flatten, _mp_unflatten)


def merge_parameters(p, q):
    """The reference's 9-method ``merge`` algebra (``src/parameters.jl:22-35``):
    positional args append, keyword args overwrite."""
    if isinstance(q, NullParameters):
        return p
    if isinstance(p, NullParameters):
        p = MixedParameters()
    if not isinstance(p, MixedParameters):
        p = MixedParameters(p)
    if isinstance(q, MixedParameters):
        return _mk(p.args + q.args, {**p.kwargs, **q.kwargs})
    if isinstance(q, dict):
        return _mk(p.args, {**p.kwargs, **q})
    if isinstance(q, tuple):
        return _mk(p.args + q, p.kwargs)
    return _mk(p.args + (q,), p.kwargs)


def _mk(args, kwargs):
    p = MixedParameters(*args)
    object.__setattr__(p, "kwargs", kwargs)
    return p


def paramzip(*args, **kwargs):
    """Zip positional/keyword parameter sequences into a list of
    ``MixedParameters`` (reference ``src/parameters.jl:56-67``)."""
    n = None
    for seq in itertools.chain(args, kwargs.values()):
        n = len(seq) if n is None else n
        if len(seq) != n:
            raise ValueError("paramzip sequences must have equal length")
    if n is None:
        return []
    out = []
    for i in range(n):
        out.append(
            _mk(tuple(a[i] for a in args), {k: v[i] for k, v in kwargs.items()})
        )
    return out


def paramproduct(*args, **kwargs):
    """Cartesian product of parameter sequences as an ndarray (object) of
    ``MixedParameters`` (reference ``src/parameters.jl:69-79``).  The result is
    a nested list of shape ``(len(args[0]), ..., len(kwargs[-1]))`` flattened in
    C order."""
    seqs = list(args) + list(kwargs.values())
    nargs = len(args)
    keys = list(kwargs)
    shape = tuple(len(s) for s in seqs)
    out = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        vals = [seqs[j][idx[j]] for j in range(len(seqs))]
        out[idx] = _mk(tuple(vals[:nargs]), dict(zip(keys, vals[nargs:])))
    return out


class ParameterIntegrand:
    """Partially applied integrand ``f(x, *args, **kwargs)``.

    Called with ``(x, p)`` it merges the preset parameters with ``p``
    (reference ``src/parameters.jl:94-98``).
    """

    def __init__(self, f, *args, **kwargs):
        self.f = f
        self.p = MixedParameters(*args, **kwargs)

    def __call__(self, x, p=NullParameters()):
        q = merge_parameters(self.p, p)
        return self.f(x, *q.args, **q.kwargs)

    def with_parameters(self, p):
        """Return (bare integrand, merged parameters) for cache re-solves
        (reference ``remake_cache`` at ``src/parameters.jl:102-105``)."""
        return ParameterIntegrand(self.f), merge_parameters(self.p, p)
