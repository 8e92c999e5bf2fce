"""FullGridSpectralSweep (ops/grid_sweep.py) vs a dense direct reference."""
import numpy as np
import pytest

import jax.numpy as jnp

from autobzcore_tpu.fourier import FourierSeries
from autobzcore_tpu.ops.grid_sweep import FullGridSpectralSweep


def _random_hermitian_series(seed=0, n=5, m=3, n2=None):
    rng = np.random.default_rng(seed)
    n2 = n if n2 is None else n2
    C = rng.normal(size=(n, n2, n, m, m)) + 1j * rng.normal(size=(n, n2, n, m, m))
    r = np.linalg.norm(np.mgrid[: n, : n2, : n].astype(float)
                       - np.array([n // 2, n2 // 2, n // 2])[:, None, None, None],
                       axis=0)
    C *= np.exp(-r)[..., None, None]
    C = (C + np.flip(C, axis=(0, 1, 2)).conj().swapaxes(-1, -2)) / 2
    return FourierSeries(C, period=1.0, offset=(-(n // 2), -(n2 // 2), -(n // 2)),
                         ndim=3)


def _dense_dos(series, npt, omegas, eta):
    C = np.asarray(series.c)
    freqs = [series.offset[j] + np.arange(C.shape[j]) for j in range(3)]
    u = np.arange(npt) / npt
    ph = [np.exp(2j * np.pi * np.outer(u, f)) for f in freqs]
    hk = np.einsum("ka,lb,mc,abcij->klmij", ph[0], ph[1], ph[2], C, optimize=True)
    m = C.shape[-1]
    e = np.linalg.eigvalsh(hk.reshape(-1, m, m))
    t = omegas[:, None, None] - e[None]
    return np.sum(eta / (t * t + eta * eta), axis=(1, 2)) / np.pi


@pytest.mark.parametrize("npt", [8, 12])  # 12 exercises slab padding (slab=8)
def test_matches_dense(npt):
    s = _random_hermitian_series()
    omegas = np.linspace(-6.0, 6.0, 40)
    eta = 0.1
    sweep = FullGridSpectralSweep(s, omegas, eta, slab=8, slabs_per_dispatch=1,
                                  omega_batch=20)
    got = sweep.rung(npt)
    ref = _dense_dos(s, npt, omegas, eta)
    assert np.max(np.abs(got - ref)) < 1e-6 * npt**3  # f32 Lorentzian tier
    # the two-float Lorentzian keeps relative accuracy ~1e-7
    assert np.max(np.abs(got - ref) / np.abs(ref)) < 3e-6


def test_eigvalsh3_rows_matches_complex():
    from autobzcore_tpu.ops.eigh3 import eigvalsh3, eigvalsh3_rows

    rng = np.random.default_rng(7)
    A = rng.normal(size=(257, 3, 3)) + 1j * rng.normal(size=(257, 3, 3))
    H = (A + np.conj(np.swapaxes(A, -1, -2))) / 2
    ref = np.asarray(eigvalsh3(jnp.asarray(H)))
    lo, mid, hi = eigvalsh3_rows(
        jnp.asarray(H[..., 0, 0].real), jnp.asarray(H[..., 1, 1].real),
        jnp.asarray(H[..., 2, 2].real),
        jnp.asarray(H[..., 0, 1].real), jnp.asarray(H[..., 0, 1].imag),
        jnp.asarray(H[..., 0, 2].real), jnp.asarray(H[..., 0, 2].imag),
        jnp.asarray(H[..., 1, 2].real), jnp.asarray(H[..., 1, 2].imag),
    )
    got = np.stack([np.asarray(lo), np.asarray(mid), np.asarray(hi)], axis=-1)
    assert np.max(np.abs(got - ref)) < 1e-12


def test_rung_sharded_matches_serial():
    """8-device k-shard of the slab loop reproduces the single-device rung."""
    import jax
    from jax.sharding import Mesh

    s = _random_hermitian_series(seed=3)
    omegas = np.linspace(-5.0, 5.0, 20)
    sweep = FullGridSpectralSweep(s, omegas, 0.15, slab=4, omega_batch=10)
    mesh = Mesh(np.array(jax.devices("cpu")[:8]), ("k",))
    npt = 12  # nrows pads 12 -> 4*8 = 32: exercises both padding and sharding
    got = sweep.rung_sharded(npt, mesh)
    ref = sweep.rung(npt)
    assert np.max(np.abs(got - ref)) < 1e-10 * npt**3


@pytest.mark.parametrize("m", [1, 2, 5])
def test_matches_dense_general_m(m):
    """m-generic engine: gather-assembled Hermitian matrices + batched
    eigvalsh for m not in the Cardano fast path."""
    s = _random_hermitian_series(seed=13, n=3, m=m)
    omegas = np.linspace(-5.0, 5.0, 16)
    eta = 0.15
    sweep = FullGridSpectralSweep(s, omegas, eta, slab=4, slabs_per_dispatch=2,
                                  omega_batch=8)
    npt = 8
    got = sweep.rung(npt)
    ref = _dense_dos(s, npt, omegas, eta)
    # f64 eigenvalues; the two-float f32 Lorentzian sets the floor
    assert np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-3)) < 2e-5


@pytest.mark.parametrize("npt", [8, 12, 16])
@pytest.mark.parametrize("m", [1, 3, 4])
def test_plain_f64_matches_dense(m, npt):
    """The complex128 matrix-product stages reproduce a NumPy dense-f64
    H(k) + eigvalsh + Lorentzian reference within the two-float Lorentzian
    floor (1e-6 of max D, the engine's documented precision)."""
    s = _random_hermitian_series(seed=20 + m, n=5, m=m)
    omegas = np.linspace(-6.0, 6.0, 24)
    eta = 0.1
    sweep = FullGridSpectralSweep(s, omegas, eta, slab=4, slabs_per_dispatch=3,
                                  omega_batch=12)
    got = sweep.rung(npt)
    ref = _dense_dos(s, npt, omegas, eta)
    assert got.shape == ref.shape == omegas.shape
    assert np.max(np.abs(got - ref)) < 1e-6 * np.max(ref)


def test_deep_n2_stage_b_stays_f64():
    """n2 = 49 frequencies along dim 2 (a deep stage-B contraction) keeps
    dense-f64 agreement."""
    s = _random_hermitian_series(seed=11, n=3, n2=49)
    sweep = FullGridSpectralSweep(s, np.linspace(-4, 4, 8), 0.2, slab=4,
                                  omega_batch=4)
    npt = 8
    got = sweep.rung(npt)
    ref = _dense_dos(s, npt, np.linspace(-4, 4, 8), 0.2)
    assert np.max(np.abs(got - ref) / np.abs(ref)) < 3e-6


def test_rejects_non_hermitian_series():
    """A series with c(-R) != c(R)^H would be silently 'hermitianized' by the
    6-entry packing — the constructor must reject it (ADVICE r2)."""
    rng = np.random.default_rng(2)
    C = rng.normal(size=(3, 3, 3, 3, 3)) + 1j * rng.normal(size=(3, 3, 3, 3, 3))
    s = FourierSeries(C, period=1.0, offset=(-1, -1, -1), ndim=3)
    with pytest.raises(ValueError, match="Hermitian"):
        FullGridSpectralSweep(s, np.linspace(0, 1, 4), 0.1)


def test_omega_batch_zero_guarded():
    s = _random_hermitian_series(seed=4, n=3)
    sweep = FullGridSpectralSweep(s, np.linspace(0, 1, 5), 0.1, omega_batch=0)
    assert sweep.omega_batch == 1


def test_rejects_non_3d_or_nonsquare():
    rng = np.random.default_rng(1)
    C2 = rng.normal(size=(3, 3, 2, 2)) * (1 + 0j)  # 2D spatial grid
    s2 = FourierSeries(C2, period=1.0, offset=(-1, -1), ndim=2)
    with pytest.raises(ValueError):
        FullGridSpectralSweep(s2, np.linspace(0, 1, 4), 0.1)
    C3 = rng.normal(size=(3, 3, 3, 2, 3)) * (1 + 0j)  # non-square values
    s3 = FourierSeries(C3, period=1.0, offset=(-1, -1, -1), ndim=3)
    with pytest.raises(ValueError):
        FullGridSpectralSweep(s3, np.linspace(0, 1, 4), 0.1)


def test_two_float_split_is_exact():
    """The f32 (hi, lo) split of the Lorentzian's energies: hi is exactly an
    f32 value and hi + lo reproduces f64 e to ~2^-48 relative."""
    from autobzcore_tpu.ops.grid_sweep import _two_float

    e = np.random.default_rng(3).uniform(-15.0, 15.0, size=4096)
    hi, lo = (np.asarray(x) for x in _two_float(jnp.asarray(e)))
    assert hi.dtype == lo.dtype == np.float32
    assert np.all(np.abs(hi.astype(np.float64) - e) <= 2.0**-23 * np.abs(e))
    assert np.max(np.abs(hi.astype(np.float64) + lo.astype(np.float64) - e)
                  / np.abs(e)) < 2.0**-46
