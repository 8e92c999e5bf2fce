"""Full-grid spectral sweeps: slab-streamed H(k) + eigenvalues + broadened
DOS over a complete npt^3 PTR grid, in native complex128/f64.

Why full grid instead of symmetry-reduced representatives: on a tensor grid
the Fourier evaluation is two dense matrix products per slab, while
scattered points pay a per-point phase product for every coefficient; cubic
symmetry reduction only shrinks the point count by <= 48x, and the full grid
needs no host-side ``symptr_rule`` enumeration.  Orbit sums make the
full-grid sum exactly equal to the symmetrized reduced sum (reference
AutoPTR semantics, ``src/brillouin.jl:421-444``).

Streaming structure: persistent state is O(npt).  Dimension 3 is contracted
once per rung (``V``: (n1, n2*ne*npt)); each slab of S outer grid rows then
runs two complex128 matrix products over the ``ne = m (m+1)/2`` independent
Hermitian entries:

  stage A: slab phases (S, n1)    x V            -> J (n2, ne*S*npt3)
  stage B: phase table (npt2, n2) x J (per slab) -> H (npt2, ne, S*npt3)

Entry-major rows then feed the struct-of-arrays Cardano
(``ops/eigh3.eigvalsh3_rows``; general m assembles the matrices for
``jnp.linalg.eigvalsh``) and an omega-batched two-float Lorentzian
reduction (hi parts of ``omega - e`` cancel exactly by Sterbenz; lo parts
carry the f64 residue).

Used by ``dos.LorentzianFullGrid`` and ``benchmarks/northstar.py --engine
fullgrid``.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from autobzcore_tpu.ops.eigh3 import eigvalsh3_rows

_HIGHEST = jax.lax.Precision.HIGHEST


def _entries(m):
    """Hermitian entry order: the ``m`` real diagonals first, then the
    ``m (m-1) / 2`` complex upper off-diagonals (row-major)."""
    return tuple((i, i) for i in range(m)) + tuple(
        (i, j) for i in range(m) for j in range(i + 1, m)
    )


def _two_float(e):
    """Split f64 ``e`` into f32 ``(hi, lo)`` with ``hi + lo == e`` to ~2^-48
    relative.  Veltkamp's split keeps 24 significant bits in ``hi`` (exact in
    f32) and ``lo = e - hi`` exactly; the shorter ``e - f64(f32(e))`` is not
    used because XLA may fold that convert round trip away as excess
    precision, which silently zeroes ``lo``."""
    c = e * (2.0**29 + 1.0)
    hi = c - (c - e)
    return hi.astype(jnp.float32), (e - hi).astype(jnp.float32)


def _phase_table(npt, nfreq, offset):
    """Host-f64 phases ``exp(2 pi i u f)`` at the fractional PTR nodes."""
    freqs = offset + np.arange(nfreq)
    return np.exp(2j * np.pi * np.outer(np.arange(npt) / npt, freqs))


class FullGridSpectralSweep:
    """Broadened-DOS sweep engine for m-band Hermitian Fourier series
    (m=3 takes the SoA Cardano fast path; general m assembles the Hermitian
    matrices for a batched ``eigvalsh``).

    Parameters
    ----------
    series : FourierSeries with 3D spatial grid and square Hermitian values.
    omegas : (W,) frequency grid.
    eta : Lorentzian broadening.
    slab : grid rows of the outer dimension per streamed step.
    slabs_per_dispatch : fori_loop steps per device dispatch.
    omega_batch : omegas per Lorentzian pass (bounds the broadcast
        intermediate together with the ~1.6M-point chunking).
    """

    def __init__(self, series, omegas, eta, slab=8, slabs_per_dispatch=32,
                 omega_batch=100):
        c = np.asarray(series.c)
        if c.ndim != 5 or c.shape[-2] != c.shape[-1]:
            raise ValueError(
                "FullGridSpectralSweep requires a 3D series of square matrices"
            )
        m = int(c.shape[-1])
        self.m = m
        self.n1, self.n2, self.n3 = c.shape[:3]
        self.offset = tuple(int(o) for o in series.offset)
        # the engine keeps only the independent Hermitian entries, so a
        # non-Hermitian series would silently be "hermitianized" — verify
        # H(k) = H(k)^H densely at a few k-points
        rng = np.random.default_rng(7)
        for k in rng.uniform(size=(2, 3)):
            ph = [np.exp(2j * np.pi * k[d] * (self.offset[d] + np.arange(c.shape[d])))
                  for d in range(3)]
            hk = np.einsum("a,b,c,abcij->ij", ph[0], ph[1], ph[2], c)
            if not np.allclose(hk, hk.conj().T, rtol=1e-10,
                               atol=1e-10 * max(1.0, np.abs(hk).max())):
                raise ValueError(
                    "FullGridSpectralSweep requires a Hermitian series "
                    "(c(-R) = c(R)^H); H(k) at a test point is not Hermitian"
                )
        self.entries = _entries(m)
        self.ne = len(self.entries)
        c6 = np.stack([c[..., i, j] for (i, j) in self.entries], axis=-1)
        self.c6 = jnp.asarray(c6, jnp.complex128)
        # gather map for the general-m matrix assembly: entry index of
        # (min(i,j), max(i,j)), conjugated below the diagonal
        idx = np.zeros((m, m), np.int32)
        for e, (i, j) in enumerate(self.entries):
            idx[i, j] = e
            idx[j, i] = e
        self._idx_mat = idx
        self._lower = np.tril(np.ones((m, m), bool), -1)
        self.omegas = np.asarray(omegas, np.float64)
        self.eta = float(eta)
        self.slab = slab
        self.spd = slabs_per_dispatch
        W = self.omegas.size
        ob = max(1, min(int(omega_batch), W))
        while W % ob:
            ob -= 1
        self.omega_batch = ob
        self._run_cache = {}

    def set_omegas(self, omegas):
        """Swap the frequency grid WITHOUT recompiling: the omega values are
        runtime arguments of the rung kernels (only their COUNT is a compiled
        shape), so a same-length engine serves any energy grid — the
        interval-domain DOS driver reuses one engine across chebinterp
        refinement rounds this way."""
        omegas = np.asarray(omegas, np.float64)
        if omegas.size != self.omegas.size:
            raise ValueError(
                f"set_omegas needs the compiled width {self.omegas.size}, got {omegas.size}"
            )
        self.omegas = omegas

    # -- per-rung preparation ------------------------------------------------

    def _prepare(self, npt):
        """Contract dimension 3 once per rung: ``V`` (n1, n2*ne*npt3)."""
        n1 = self.n1

        @jax.jit
        def prep(c6, e3):
            # (n1, n2, n3, ne) x (npt3, n3) -> (npt3, n1, n2, ne)
            v = jnp.tensordot(e3, c6, axes=([1], [2]), precision=_HIGHEST)
            return jnp.transpose(v, (1, 2, 3, 0)).reshape(n1, -1)

        e3 = _phase_table(npt, self.n3, self.offset[2])
        return prep(self.c6, jnp.asarray(e3))

    # -- slab kernel ---------------------------------------------------------

    def _bands(self, h, npt):
        """Eigenvalue rows of the entry-major slab ``h`` (npt2, ne, S*npt3):
        a tuple of m arrays (npt2, S*npt3)."""
        m = self.m
        if m == 1:
            return (h[:, 0].real,)
        if m == 3:
            return eigvalsh3_rows(
                h[:, 0].real, h[:, 1].real, h[:, 2].real,
                h[:, 3].real, h[:, 3].imag,
                h[:, 4].real, h[:, 4].imag,
                h[:, 5].real, h[:, 5].imag,
            )
        full = h[:, self._idx_mat]  # (npt2, m, m, S*npt3)
        lower = jnp.asarray(self._lower)[None, :, :, None]
        full = jnp.where(lower, jnp.conj(full), full)
        full = jnp.moveaxis(full, 3, 1).reshape(-1, m, m)
        e = jnp.linalg.eigvalsh(full)  # (N, m)
        return tuple(e[:, b].reshape(npt, -1) for b in range(m))

    def _make_run(self, npt):
        S = self.slab
        n1, n2 = self.n1, self.n2
        ne = self.ne
        W = self.omegas.size
        OB = self.omega_batch
        eta32 = jnp.float32(self.eta)
        M2 = ne * S * npt  # stage-B row width (entry-major, (ne, S, npt3))
        # Lorentzian point chunking: ~1.6M point-band pairs per pass per band
        # loop, chunk along npt2
        rows = max(1, min(int(1.6e6 // (S * npt)), npt))
        while npt % rows:  # largest divisor of npt <= the memory-bound start
            rows -= 1
        nch = npt // rows
        CH = rows * S * npt

        @jax.jit
        def run(i0, nsl, P1, rowmask, e2, omhi, omlo, V):
            def body(i, acc):
                p1 = jax.lax.dynamic_slice(P1, (i * S, 0), (S, n1))
                w = jax.lax.dynamic_slice(rowmask, (i * S,), (S,))
                # ---- stage A: contract n1 ----
                J = jnp.dot(p1, V, precision=_HIGHEST)  # (S, n2*ne*npt3)
                J = jnp.transpose(J.reshape(S, n2, ne, npt), (1, 2, 0, 3)).reshape(n2, M2)
                # ---- stage B: contract n2 ----
                h = jnp.dot(e2, J, precision=_HIGHEST).reshape(npt, ne, S * npt)
                bands = self._bands(h, npt)
                # ---- Lorentzian reduction, chunked along npt2 ----
                wcol = jnp.repeat(w.astype(jnp.float32), npt)  # (S*npt3,)
                wch = jnp.broadcast_to(wcol[None], (rows, S * npt)).reshape(1, CH)

                def echunks(e):
                    ehi, elo = _two_float(e)
                    return ehi.reshape(nch, CH), elo.reshape(nch, CH)

                echs = ()
                for band in bands:
                    echs += echunks(band)

                def chunk(carry, xs):
                    def one(ob):
                        oh, ol = ob  # (OB,)
                        tot = jnp.zeros((OB,), jnp.float64)
                        for b in range(len(bands)):
                            ehi, elo = xs[2 * b], xs[2 * b + 1]
                            t = (oh[:, None] - ehi[None]) + (ol[:, None] - elo[None])
                            # f32 terms, f64 sums: an f32 running sum over a
                            # chunk's ~1e5 terms loses ~1e-6 of the total
                            lor = (eta32 / (t * t + eta32 * eta32)) * wch
                            tot = tot + jnp.sum(lor.astype(jnp.float64), axis=1)
                        return tot

                    d = jax.lax.map(
                        one, (omhi.reshape(-1, OB), omlo.reshape(-1, OB))
                    ).reshape(W)
                    return carry + d, None

                init = jnp.zeros((W,), jnp.float64) + w[0] * 0.0
                d, _ = jax.lax.scan(chunk, init, echs)
                return acc + d

            # init derives from rowmask so that under shard_map the carry is
            # device-varying like the body output (plain zeros are unvarying
            # and fail the while_loop carry-type check); outside shard_map
            # this is a constant-folded no-op
            init = jnp.zeros((W,), jnp.float64) + rowmask[0] * 0.0
            return jax.lax.fori_loop(i0, i0 + nsl, body, init)

        return run

    # -- public API ----------------------------------------------------------

    def _tables(self, npt, row_multiple):
        S = self.slab
        nrows = -(-npt // row_multiple) * row_multiple
        P1 = np.zeros((nrows, self.n1), np.complex128)
        P1[:npt] = _phase_table(npt, self.n1, self.offset[0])
        rowmask = np.zeros(nrows)
        rowmask[:npt] = 1.0
        e2 = _phase_table(npt, self.n2, self.offset[1])
        omhi = self.omegas.astype(np.float32)
        omlo = (self.omegas - omhi).astype(np.float32)
        return (jnp.asarray(P1), jnp.asarray(rowmask), jnp.asarray(e2),
                jnp.asarray(omhi), jnp.asarray(omlo), nrows // S)

    def rung(self, npt, progress=None):
        """DOS partial sums over the full npt^3 grid: returns the (W,) array
        ``sum_k sum_b eta/((omega - e_b(k))^2 + eta^2) / pi`` (caller applies
        the det(B)/npt^3 measure)."""
        V = self._prepare(npt)
        P1, rowmask, e2, omhi, omlo, nslab = self._tables(npt, self.slab)
        run = self._run_cache.setdefault(npt, self._make_run(npt))
        acc = np.zeros(self.omegas.size)
        for i0 in range(0, nslab, self.spd):
            nsl = min(self.spd, nslab - i0)
            acc += np.asarray(run(i0, nsl, P1, rowmask, e2, omhi, omlo, V))
            if progress is not None:
                progress(i0 + nsl, nslab)
        return acc / np.pi

    def rung_sharded(self, npt, mesh, axis="k"):
        """Mesh-parallel rung: outer-dimension grid rows shard over
        ``mesh``'s ``axis`` (the per-rung operands are O(npt) and
        replicate), per-device slab loops run independently, and one
        ``psum`` combines the (W,) DOS partials.  The full-grid analogue of
        the reference's ``BatchIntegrand`` distribution hook
        (``src/batch.jl:5-7``)."""
        from jax.sharding import PartitionSpec as P

        S = self.slab
        ndev = mesh.shape[axis]
        V = self._prepare(npt)
        P1, rowmask, e2, omhi, omlo, nslab = self._tables(npt, S * ndev)
        run = self._run_cache.setdefault(npt, self._make_run(npt))
        nsl_local = nslab // ndev

        @jax.jit
        def sharded(P1, rowmask, e2, omhi, omlo, V):
            def local(P1, rowmask, e2, omhi, omlo, V):
                d = run(0, nsl_local, P1, rowmask, e2, omhi, omlo, V)
                return jax.lax.psum(d, axis)

            spec = (P(axis), P(axis), P(), P(), P(), P())
            return jax.shard_map(local, mesh=mesh, in_specs=spec,
                                 out_specs=P())(P1, rowmask, e2, omhi, omlo, V)

        acc = np.asarray(sharded(P1, rowmask, e2, omhi, omlo, V))
        return acc / np.pi
