"""The seeded cubic t2g stand-in (models.cubic_t2g) and flagship_model."""
import numpy as np
import pytest

from autobzcore_tpu import FBZ, CubicSymIBZ, IntegralProblem, PTR, TrivialRep, load_bz, solve
from autobzcore_tpu.fourier import FourierIntegrand
from autobzcore_tpu.models import cubic_t2g, flagship_model, t2g_rep
from autobzcore_tpu.models.observables import dos_trace
from autobzcore_tpu.ops.symptr import cube_automorphism_syms


def _hk(h, k):
    C = np.asarray(h.c)
    ph = [np.exp(2j * np.pi * k[d] * (h.offset[d] + np.arange(C.shape[d]))) for d in range(3)]
    return np.einsum("a,b,c,abcij->ij", ph[0], ph[1], ph[2], C)


def test_t2g_rep_is_a_representation():
    syms = cube_automorphism_syms(3)
    for g in syms[::5]:
        for f in syms[::7]:
            assert np.allclose(t2g_rep(g @ f), t2g_rep(g) @ t2g_rep(f))


@pytest.mark.parametrize("seed", [0, 1])
def test_cubic_covariance_all_48_operations(seed):
    """H(g k) = D(g) H(k) D(g)^T for every cubic operation, and H(k) is
    Hermitian, at random k."""
    h = cubic_t2g(seed=seed)
    syms = cube_automorphism_syms(3)
    assert len(syms) == 48
    for k in np.random.default_rng(seed + 10).uniform(size=(3, 3)):
        hk = _hk(h, k)
        assert np.allclose(hk, hk.conj().T, atol=1e-14)
        for g in syms:
            D = t2g_rep(g)
            assert np.allclose(_hk(h, g @ k), D @ hk @ D.T, atol=1e-13)


@pytest.mark.parametrize("seed", [0, 1])
def test_ibz_ptr_equals_fbz_ptr(seed):
    """The cubic IBZ rule's orbit sums reproduce the full-zone PTR sum."""
    h = cubic_t2g(seed=seed)
    A = 3.84 * np.eye(3)
    f = FourierIntegrand(dos_trace, h, eta=0.05, rep=TrivialRep())
    for om in (11.7, 12.5):
        ibz = solve(IntegralProblem(f, load_bz(CubicSymIBZ(), A), om), PTR(npt=12)).u
        fbz = solve(IntegralProblem(f, load_bz(FBZ(), A), om), PTR(npt=12)).u
        assert np.isclose(float(ibz), float(fbz), rtol=1e-12, atol=0)


def test_cubic_t2g_footprint_and_band_window():
    h = cubic_t2g(seed=0)
    C = np.asarray(h.c)
    assert C.shape == (5, 5, 5, 3, 3) and tuple(h.offset) == (-2, -2, -2)
    assert np.allclose(C.imag, 0)
    u = np.arange(20) / 20
    ph = np.exp(2j * np.pi * np.outer(u, np.arange(-2, 3)))
    hk = np.einsum("ka,lb,mc,abcij->klmij", ph, ph, ph, C, optimize=True)
    e = np.linalg.eigvalsh(hk.reshape(-1, 3, 3))
    assert 10.5 < e.min() and e.max() < 14.5


def test_flagship_model_synthetic_and_file_rules():
    h, bz, label = flagship_model(seed=3)
    assert label == "synthetic"
    assert bz.nsyms == 48 and np.allclose(bz.A, 3.84 * np.eye(3))
    assert np.allclose(np.asarray(h.c), np.asarray(cubic_t2g(seed=3).c))
    with pytest.raises(ValueError, match="wout"):
        flagship_model("model_hr.dat")
