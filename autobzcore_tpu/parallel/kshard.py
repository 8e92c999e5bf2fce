"""k-grid sharding over a device mesh.

The scale-out design: symmetry-reduced k-point batches are sharded over a
mesh axis and combined with ``psum`` over the device interconnect,
while parameter (omega) grids shard over a second, data-parallel axis.  This
replaces the reference's user-side ``BatchIntegrand`` distribution hook
(``src/batch.jl:5-7``) with jax collectives.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..brillouin import SymmetricBZ
from ..fourier import FourierSeries
from ..ops.symptr import symptr_rule


def _rule_data(bz: SymmetricBZ, npt: int):
    d = bz.ndim
    if bz.syms is None:
        strides = npt ** np.arange(d - 1, -1, -1)
        lin = np.arange(npt**d)
        reps = np.stack([(lin // s) % npt for s in strides], axis=-1)
        weights = np.ones(lin.shape[0])
    else:
        reps, weights = symptr_rule(npt, d, bz.syms)
    return reps, weights


def _shard_inputs(series, bz, npt, mesh, k_axis, w_axis, params):
    """Shared preamble of the sharded engines: pad the (symmetry-reduced)
    rule to the k-mesh, shard points/weights/parameters, return the
    full-zone scale.  Padded rows carry zero weight -> no contribution."""
    d = bz.ndim
    reps, weights = _rule_data(bz, npt)
    nk_dev = mesh.shape[k_axis]
    nw_dev = mesh.shape[w_axis]
    K = reps.shape[0]
    Kpad = -(-K // nk_dev) * nk_dev
    frac = np.zeros((Kpad, d))
    wgt = np.zeros(Kpad)
    # evaluate_points divides by the period internally, so the grid must
    # span [0, period)
    frac[:K] = reps.astype(np.float64) / npt * np.asarray(series.period)
    wgt[:K] = weights
    params = jnp.asarray(params)
    if params.shape[0] % nw_dev:
        raise ValueError(
            f"parameter count {params.shape[0]} must divide over {nw_dev} devices")
    scale = abs(np.linalg.det(bz.B)) / (npt**d)  # sum of all weights = npt^d
    return (
        jax.device_put(jnp.asarray(frac), NamedSharding(mesh, P(k_axis, None))),
        jax.device_put(jnp.asarray(wgt), NamedSharding(mesh, P(k_axis))),
        jax.device_put(params, NamedSharding(mesh, P(w_axis))),
        scale,
    )


def _hv_block(series, frac_blk):
    """(H, dH) at a sharded point block, scalar series promoted to 1x1."""
    from ..ops.fourier_eval import evaluate_points_jacobian

    hk, vk = evaluate_points_jacobian(series.c, series.sndim, frac_blk,
                                      series.offset, series.period, series.dtype)
    if hk.ndim == 1:
        hk = hk[:, None, None]
        vk = vk[:, :, None, None]
    return hk, vk


def spectral_sum_sharded(series: FourierSeries, bz: SymmetricBZ, npt: int,
                         omegas, eta: float, mesh: Mesh,
                         k_axis: str = "k", w_axis: str = "w"):
    """Broadened DOS  -Im Tr (w + i*eta - H(k))^{-1} / pi  integrated over the
    BZ, with k-points sharded over ``k_axis`` (psum-combined) and the omega
    grid sharded over ``w_axis``.

    Returns DOS values (len(omegas),), replicated over ``k_axis``.
    The eigendecomposition trick: Tr(z - H)^{-1} = sum_b (z - e_b)^{-1}, so
    the grid is eigendecomposed once and every omega reuses the spectrum.
    """
    from ..ops.fourier_eval import evaluate_points

    frac_sh, w_sh, om_sh, scale = _shard_inputs(series, bz, npt, mesh,
                                                k_axis, w_axis, omegas)
    c = series.c  # replicated (small)

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(k_axis, None), P(k_axis), P(w_axis)),
        out_specs=P(w_axis),
    )
    def block(frac_blk, w_blk, om_blk):
        hk = evaluate_points(c, series.sndim, frac_blk, series.offset,
                             series.period, None, series.dtype)
        if hk.ndim == 1:  # scalar-valued series -> 1x1 matrices
            hk = hk[:, None, None]
        e = jnp.linalg.eigvalsh(hk)  # (K_loc, m)
        # local Lorentzian sum, then psum over the k axis
        lor = eta / ((om_blk[:, None, None] - e[None, :, :]) ** 2 + eta**2) / jnp.pi
        local = jnp.sum(lor * w_blk[None, :, None], axis=(1, 2))
        return jax.lax.psum(local, k_axis)

    return block(frac_sh, w_sh, om_sh) * scale


def transport_sweep_sharded(series: FourierSeries, bz: SymmetricBZ, npt: int,
                            omegas, eta: float, mesh: Mesh,
                            k_axis: str = "k", w_axis: str = "w"):
    """Kubo-Greenwood transport sweep ``Gamma_ab(omega)`` with the
    (symmetry-reduced) k-grid sharded over ``k_axis`` (psum-combined) and the
    frequency grid data-parallel over ``w_axis`` — the multi-device layout
    for the transport family (single-device fast path:
    :class:`~..models.observables.TransportSolver`).

    Returns (len(omegas), d, d), group-averaged back to the full zone for
    IBZ inputs (rank-2 tensor symmetrization, reference
    ``src/brillouin.jl:96-108`` semantics for matrix-valued results).
    """
    frac_sh, w_sh, om_sh, scale = _shard_inputs(series, bz, npt, mesh,
                                                k_axis, w_axis, omegas)

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(k_axis, None), P(k_axis), P(w_axis)),
        out_specs=P(w_axis),
    )
    def block(frac_blk, w_blk, om_blk):
        hk, vk = _hv_block(series, frac_blk)
        e, U = jnp.linalg.eigh(hk)
        vband = jnp.einsum("kmi,kdij,kjn->kdmn", jnp.conj(jnp.swapaxes(U, 1, 2)), vk, U)
        Pk = jnp.real(jnp.einsum("kanm,kbmn->kabnm", vband, vband))
        Pw = Pk * w_blk[:, None, None, None, None]

        def gamma_at(om):
            A = eta / ((om - e) ** 2 + eta**2) / jnp.pi  # (Kloc, m)
            return jnp.einsum("kabnm,kn,km->ab", Pw, A, A)

        local = jax.vmap(gamma_at)(om_blk)
        return jax.lax.psum(local, k_axis)

    G = block(frac_sh, w_sh, om_sh) * scale
    if bz.syms is not None:
        Sinv = np.linalg.inv(np.asarray(bz.syms, dtype=np.float64))
        G = jnp.einsum("sab,wbc,scd->wad", jnp.asarray(Sinv.swapaxes(1, 2), G.dtype),
                       G, jnp.asarray(Sinv, G.dtype)) / len(Sinv)
    return G


def ggr_dos_sharded(series: FourierSeries, bz: SymmetricBZ, npt: int, Es,
                    mesh: Mesh, k_axis: str = "k", w_axis: str = "w"):
    """Sharded Gilat-Raubenheimer DOS sweep: the eigensolve grid shards over
    ``k_axis`` (psum-combined) while the energy grid is data-parallel over
    ``w_axis`` — the multi-device layout for near-singular DOS workloads
    (BASELINE.json config 5).

    Returns DOS values (len(Es),).
    """
    from ..dos.ggr import _GGR_FORMULAS

    d = bz.ndim
    formula = _GGR_FORMULAS[d]
    frac_sh, w_sh, E_sh, _ = _shard_inputs(series, bz, npt, mesh,
                                           k_axis, w_axis, Es)
    b = 1.0 / (2 * npt)

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(k_axis, None), P(k_axis), P(w_axis)),
        out_specs=P(w_axis),
    )
    def block(frac_blk, w_blk, E_blk):
        hk, vk = _hv_block(series, frac_blk)
        e, U = jnp.linalg.eigh(hk)
        v = jnp.real(jnp.einsum("kmi,kdij,kjm->kdm", jnp.conj(jnp.swapaxes(U, 1, 2)), vk, U))
        vt = jnp.moveaxis(v, 1, 2)  # (Kloc, m, d)
        # scale-relative velocity floor, GLOBAL over the sharded grid (pmax)
        # so the guard agrees with the single-chip GGR path
        # (dos/ggr.py vtol = 1e-10 * max(1, max|v|))
        vmax = jax.lax.pmax(jnp.max(jnp.abs(vt)), k_axis)
        vtol = 1e-10 * jnp.maximum(1.0, vmax)

        def dos_at(E):
            dw = jnp.abs(E - e)
            contrib = formula(b, dw, vt, vtol)
            return jnp.sum(w_blk[:, None] * contrib)

        local = jax.vmap(dos_at)(E_blk)
        return jax.lax.psum(local, k_axis)

    return block(frac_sh, w_sh, E_sh)
