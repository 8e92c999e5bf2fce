"""Generalized Gilat-Raubenheimer DOS algorithm.

Native equivalent of reference ``src/dos_algorithms.jl`` + ``src/dos_ggr.jl``:
on a symmetry-reduced ``npt^d`` k-grid, eigendecompose ``H(k)``, extract band
velocities ``diag(U' dH U)`` in standardized coordinates, then accumulate
closed-form box-broadened delta contributions per (k, band).  Second-order
convergent; robust at band crossings [Liu, Yu, Duan, Gilat-correction per the
reference ``src/dos_ggr.jl:102``].

Formulation: the eigensolve grid is one batched ``jnp.linalg.eigh``; the per-E
accumulation is a dense vectorized reduction, so 1000-energy sweeps reuse the
spectral data at negligible cost (the reference's cache-reuse property,
``docs/src/dos.md:36-42``) and run as a single vmapped kernel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..brillouin import SymmetricBZ
from ..fourier import FourierSeries, JacobianSeries
from ..ops.fourier_eval import evaluate_grid
from ..ops.symptr import symptr_rule
from .interfaces import DOSAlgorithm, DOSSolution

_EPS = 1e-300


def _ggr_1d(b, dw, v, vtol):
    v1 = jnp.abs(v[..., 0])
    # critical points (v ~ 0) are measure-zero in the box model; the reference
    # formula yields Inf there (src/dos_ggr.jl:75-79) — we drop them instead
    inside = (dw <= b * v1) & (v1 > vtol)
    return jnp.where(inside, 1.0 / jnp.maximum(v1, _EPS), 0.0)


def _ggr_2d(b, dw, v, vtol):
    av = jnp.sort(jnp.abs(v), axis=-1)  # ascending
    v2, v1 = av[..., 0], av[..., 1]
    w1 = b * jnp.abs(v1 - v2)
    w3 = b * (v1 + v2)
    r1 = 2 * b / jnp.maximum(v1, _EPS)
    r2 = (b * (v1 + v2) - dw) / jnp.maximum(v1 * v2, _EPS)
    return jnp.where(v1 > vtol, jnp.where(dw <= w1, r1, jnp.where(dw <= w3, r2, 0.0)), 0.0)


def _ggr_3d(b, dw, v, vtol):
    av = jnp.sort(jnp.abs(v), axis=-1)  # ascending: v3 <= v2 <= v1
    v3, v2, v1 = av[..., 0], av[..., 1], av[..., 2]
    w1 = b * jnp.abs(v1 - v2 - v3)
    w2 = b * (v1 - v2 + v3)
    w3 = b * (v1 + v2 - v3)
    w4 = b * (v1 + v2 + v3)
    vv = jnp.sqrt(v1**2 + v2**2 + v3**2)
    d123 = jnp.maximum(v1 * v2 * v3, _EPS)
    d12 = jnp.maximum(v1 * v2, _EPS)
    caseA = 4 * b**2 / jnp.maximum(v1, _EPS)
    caseB = (2 * b**2 * (v1 * v2 + v2 * v3 + v3 * v1) - (dw**2 + (vv * b) ** 2)) / d123
    caseC = (
        b**2 * (v1 * v2 + 3 * v2 * v3 + v3 * v1)
        - b * dw * (-v1 + v2 + v3)
        - (dw**2 + (vv * b) ** 2) / 2
    ) / d123
    caseD = 2 * b * (b * (v1 + v2) - dw) / d12
    caseE = (b * (v1 + v2 + v3) - dw) ** 2 / (2 * d123)
    res = jnp.where(
        dw <= w1,
        jnp.where(v1 >= v2 + v3, caseA, caseB),
        jnp.where(dw <= w2, caseC, jnp.where(dw <= w3, caseD, jnp.where(dw <= w4, caseE, 0.0))),
    )
    return jnp.where(v1 > vtol, res, 0.0)


_GGR_FORMULAS = {1: _ggr_1d, 2: _ggr_2d, 3: _ggr_3d}


class GGR(DOSAlgorithm):
    """``GGR(npt=50)`` (reference ``src/dos_algorithms.jl:23``).

    Precision follows the series dtype: ``precision='auto'`` (and
    ``'complex'``) evaluates and eigendecomposes H(k) in the series' own
    complex dtype (complex128 by default).  The split-complex tiers are
    opt-in: ``'split'`` computes eigenvalues AND velocities in f64 through
    the real-embedding eigh; ``'rayleigh'`` gets f64 eigenvalues from a c64
    eigh + split-f64 Rayleigh quotients with f32-grade vectors (~1e-6
    relative DOS for isolated bands; at band crossings the arbitrary
    cluster basis changes how GGR splits box contributions).
    """

    def __init__(self, npt=50, precision="auto"):
        self.npt = npt
        self.precision = precision

    def _split_tier(self):
        """None (complex path) | 'rayleigh' | 'embedding'."""
        if self.precision == "split":
            return "embedding"
        if self.precision == "rayleigh":
            return "rayleigh"
        if self.precision in ("complex", "auto"):
            return None
        raise ValueError("precision must be 'auto', 'complex', 'split' or 'rayleigh'")

    def init_cacheval(self, h, domain, p):
        if isinstance(h, JacobianSeries):
            h = h.s
        if not isinstance(h, FourierSeries):
            raise TypeError("GGR currently supports Fourier series Hamiltonians")
        if not isinstance(p, SymmetricBZ):
            raise TypeError("GGR supports BZ parameters from load_bz")
        bz = p
        d = bz.ndim
        if d not in _GGR_FORMULAS:
            raise ValueError("GGR implemented for up to 3d BZ")
        vshape = np.shape(h.c)[h.sndim:]  # shape only — no host copy of c
        if len(vshape) not in (0, 2) or (len(vshape) == 2 and vshape[0] != vshape[1]):
            # the split tier infers band count as sqrt(prod(valshape)) — a
            # vector-valued series would silently reinterpret as fake
            # matrices; reject like LorentzianFullGrid does
            raise ValueError(
                f"GGR requires scalar or square-matrix series values, got {vshape}"
            )
        npt = self.npt

        if bz.syms is None:
            reps = None
            weights = np.ones(npt**d)
        else:
            reps, weights = symptr_rule(npt, d, bz.syms)

        # spectral data: grid evaluation + batched eigh in ONE compiled
        # program; only real arrays (energies, velocities) leave it.
        u = [np.arange(npt) / npt * h.period[j] for j in range(d)]
        if reps is not None:
            lin = np.ravel_multi_index(tuple(reps.T.astype(np.int64)), (npt,) * d)
        else:
            lin = None

        split_tier = self._split_tier()
        use_split = split_tier is not None

        def spectral_split():
            from ..ops.csplit_eval import eigh_split, evaluate_grid_split
            from ..ops.rayleigh import eigvalsh_rayleigh

            c_np = np.asarray(h.c)
            cre, cim = c_np.real, c_np.imag
            V = int(np.prod(c_np.shape[d:], dtype=np.int64)) or 1

            # Memory plan: the all-at-once build of a many-band grid holds
            # several full (npt^d, m, m) f64 tensors at once.  Evaluate in
            # slabs over the first grid dimension (a ~1.5e9-byte budget per
            # slab tensor), one dispatch per (slab, tensor), gathering each
            # slab's reduced representatives immediately.  Ragged per-slab
            # counts pad to the max; pad lanes carry weight 0 downstream.
            S = max(1, min(npt, int(1.5e9 // (8 * npt ** (d - 1) * V * 4))))
            nslab = -(-npt // S)
            lin_full = lin if lin is not None else np.arange(npt**d)
            rows = lin_full // npt ** (d - 1)
            slab_of = rows // S
            counts = np.bincount(slab_of, minlength=nslab)
            maxc = int(counts.max())
            idx = np.zeros((nslab, maxc), np.int64)
            msk = np.zeros((nslab, maxc), bool)
            for sl in range(nslab):
                members = np.nonzero(slab_of == sl)[0]
                local = lin_full[members] - sl * S * npt ** (d - 1)
                idx[sl, :len(members)] = local
                msk[sl, :len(members)] = True

            def make_ev(derivs):
                @jax.jit
                def one(u1, sidx):
                    nodes = [u1] + [u[j] for j in range(1, d)]
                    hr, hi = evaluate_grid_split(cre, cim, d, nodes, h.offset,
                                                 h.period, derivs=derivs)
                    # FLAT (K, V) layout: (..., m, m)-minor arrays pad onto
                    # (8, 128) tiles (4.3x at 30 bands) — keep the value axis
                    # one big minor dim in storage
                    hr = hr.reshape(-1, max(V, 1))[sidx] if V > 1 else hr.reshape(-1, 1)[sidx]
                    hi = hi.reshape(-1, max(V, 1))[sidx] if V > 1 else hi.reshape(-1, 1)[sidx]
                    return hr, hi

                return one

            evs = [make_ev(None)] + [
                make_ev(tuple(1 if i == j else 0 for i in range(d))) for j in range(d)
            ]
            u1_pad = np.zeros(nslab * S)
            u1_pad[:npt] = u[0]
            parts = [[] for _ in range(d + 1)]
            for sl in range(nslab):
                u1 = jnp.asarray(u1_pad[sl * S:(sl + 1) * S])
                sidx = jnp.asarray(idx[sl])
                for t, ev in enumerate(evs):
                    parts[t].append(ev(u1, sidx))
            cat = lambda t: (jnp.concatenate([a for a, _ in parts[t]]),
                             jnp.concatenate([b for _, b in parts[t]]))
            hr, hi = cat(0)
            grads = []
            for t in range(1, d + 1):
                grads += list(cat(t))

            m = int(np.sqrt(V)) if V > 1 else 1

            @jax.jit
            def combine(hr, hi, *grads):
                C = hr.shape[0]
                hr2 = hr.reshape(C, m, m)
                hi2 = hi.reshape(C, m, m)
                vr = jnp.stack([g.reshape(C, m, m) for g in grads[0::2]], axis=1)
                vi = jnp.stack([g.reshape(C, m, m) for g in grads[1::2]], axis=1)
                if split_tier == "rayleigh":
                    # f64 eigenvalues via c64 eigh + split-f64 Rayleigh
                    # quotients (the embedding QR below measured ~3 ms per
                    # 30-band k-point in emulated f64); the f32-grade
                    # vectors feed the first-order velocity diagonals
                    e, ur, ui = eigvalsh_rayleigh(hr2, hi2, return_vectors=True)
                else:
                    e, ur, ui = eigh_split(hr2, hi2)
                # real part of diag(U^H V U) with split arithmetic
                v = (
                    jnp.einsum("kim,kdij,kjm->kdm", ur, vr, ur)
                    + jnp.einsum("kim,kdij,kjm->kdm", ur, vi * -1, ui)
                    + jnp.einsum("kim,kdij,kjm->kdm", ui, vi, ur)
                    + jnp.einsum("kim,kdij,kjm->kdm", ui, vr, ui)
                )
                return e, v

            # chunk the eigensolve + velocity contraction over k: the
            # (C, d, m, m)-shaped broadcast temps pad 4.3x at 30 bands, so a
            # whole-grid combine re-OOMs; pad K to a chunk multiple (pad
            # lanes carry zero weight downstream)
            Kp = hr.shape[0]
            CH = max(1, min(Kp, int(4e8 // (8 * max(d, 1) * V * 4)) or 1))
            nch = -(-Kp // CH)
            pad = nch * CH - Kp
            if pad:
                z = lambda a: jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
                hr, hi = z(hr), z(hi)
                grads = [z(g) for g in grads]
            es, vs = [], []
            for i in range(nch):
                sl_ = slice(i * CH, (i + 1) * CH)
                e_c, v_c = combine(hr[sl_], hi[sl_], *[g[sl_] for g in grads])
                es.append(e_c)
                vs.append(v_c)
            e = jnp.concatenate(es)
            v = jnp.concatenate(vs)
            return e, v, (slab_of, msk, pad)

        @jax.jit
        def spectral():
            hk = evaluate_grid(h.c, d, u, h.offset, h.period, None, h.dtype)
            grads = []
            for j in range(d):
                derivs = tuple(1 if i == j else 0 for i in range(d))
                grads.append(evaluate_grid(h.c, d, u, h.offset, h.period, derivs, h.dtype))
            vk = jnp.stack(grads, axis=d)  # (npt.., d, m, m)
            hk = hk.reshape((npt**d,) + hk.shape[d:])  # flatten grid axes
            vk = vk.reshape((npt**d, d) + vk.shape[d + 1:])
            if lin is not None:
                hk = hk[lin]
                vk = vk[lin]
            if hk.ndim == 1:  # scalar-valued series -> 1x1 Hamiltonian
                hk = hk[:, None, None]
                vk = vk[:, :, None, None]
            e, U = jnp.linalg.eigh(hk)  # (K, m), (K, m, m)
            # band velocities: diag(U' dH U) per direction
            v = jnp.einsum("kmi,kdij,kjm->kdm", jnp.conj(jnp.swapaxes(U, 1, 2)), vk, U)
            return e, jnp.real(v)

        if use_split:
            energies, velocities, (slab_of, msk, kpad) = spectral_split()
            nslab, maxc = msk.shape
            wpad = np.zeros((nslab, maxc))
            for sl in range(nslab):
                members = np.nonzero(slab_of == sl)[0]
                wpad[sl, :len(members)] = np.asarray(weights)[members]
            w = jnp.asarray(np.concatenate([wpad.reshape(-1), np.zeros(kpad)]))
        else:
            energies, velocities = spectral()
            w = jnp.asarray(weights)
        formula = _GGR_FORMULAS[d]
        b = 1.0 / (2 * npt)
        # velocities at band critical points are numerical noise, not exact
        # zeros; gate the 1/v formulas on a scale-relative threshold
        vtol = 1e-10 * float(jnp.maximum(1.0, jnp.max(jnp.abs(velocities))))

        # spectral tensors enter as jit ARGUMENTS, not closure constants:
        # captured (K, m)/(K, d, m) arrays become HLO literals shipped with
        # every remote compile (the 365-523 s / HTTP-413 failure mode fixed
        # for LTM at tetrahedron.py and for stored series at fourier.py)
        @jax.jit
        def _dos_at(E, energies, velocities, w):
            dw = jnp.abs(E - energies)  # (K, m)
            vt = jnp.moveaxis(velocities, 1, 2)  # (K, m, d)
            contrib = formula(b, dw, vt, vtol)  # (K, m)
            return jnp.sum(w[:, None] * contrib)

        _dos_vmap = jax.jit(jax.vmap(_dos_at, in_axes=(0, None, None, None)))

        return {
            "dos_at": lambda E: _dos_at(E, energies, velocities, w),
            "dos_sweep": lambda Es: _dos_vmap(Es, energies, velocities, w),
            "energies": energies,
            "velocities": velocities,
            "weights": w,
            "numevals": int(energies.shape[0]),
        }

    def dos_solve(self, h, domain, p, cacheval, abstol=None, reltol=None, maxiters=None):
        if np.ndim(domain) != 0:
            raise TypeError("GGR supports domains of individual eigenvalues")
        if not isinstance(p, SymmetricBZ):
            raise TypeError("GGR supports BZ parameters from load_bz")
        A = cacheval["dos_at"](jnp.asarray(domain))
        return DOSSolution(A, None, True, cacheval["numevals"])

    def dos_sweep(self, cacheval, Es):
        """Batched DOS over an energy grid — the vmapped sweep reusing the
        eigensolve grid (beyond-reference convenience for 1000-omega sweeps)."""
        return cacheval["dos_sweep"](jnp.asarray(Es))
