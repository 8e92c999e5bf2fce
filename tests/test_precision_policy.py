"""Precision follows the series dtype, never the platform (GGR and LTM)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from autobzcore_tpu import DOSProblem, FBZ, GGR, load_bz
from autobzcore_tpu.dos import LTM
from autobzcore_tpu.dos import init as dos_init
from autobzcore_tpu.models import cubic_t2g


class _FakeDevice:
    platform = "tpu"


@pytest.mark.parametrize("precision", ["auto", "complex"])
def test_ggr_auto_is_complex_path_on_any_platform(monkeypatch, precision):
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice()])
    assert GGR(npt=8, precision=precision)._split_tier() is None
    assert GGR(npt=8, precision="split")._split_tier() == "embedding"
    with pytest.raises(ValueError):
        GGR(npt=8, precision="bf16")._split_tier()


@pytest.mark.parametrize("dtype,want", [(jnp.complex128, np.float64),
                                        (jnp.complex64, np.float32)])
def test_ltm_and_ggr_follow_series_dtype(dtype, want):
    h = cubic_t2g(seed=0, dtype=dtype)
    bz = load_bz(FBZ(), 3.84 * np.eye(3))
    ltm = dos_init(DOSProblem(h, 12.5, bz), LTM(npt=6)).cacheval
    assert ltm["corners"].dtype == want
    ggr = dos_init(DOSProblem(h, 12.5, bz), GGR(npt=6)).cacheval
    assert ggr["energies"].dtype == want
