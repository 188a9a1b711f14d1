"""The port's reference-compatible facade (``feos_tpu_torch.compat``).

The numpy-in, numpy-out contract of the reference's native solvers:
converged rows compacted in the ``(B_ok, 4)`` layout plus a full-length
failure mask (tests/test_compat.py:102-113), with values held to the C++
oracle and to the port's own solvers.
"""


import numpy as np
import pytest
import torch

from _torch_oracle import backend  # noqa: F401 (a fixture)
from feos_tpu_torch.compat import PcSaft
from feos_tpu_torch.solvers.vle import npt_density, pure_vle
from feos_tpu_torch.units import PA_PER_KT_TO_REDUCED

NONASSOC = [[1, 3.5, 150, 0, 0, 0, 0, 0], [1, 3.5, 200, 0, 0, 0, 0, 0]]
CONFIG3 = [[1, 3.5, 150, 0, 0.02, 1500, 1, 1], [1, 3.5, 200, 0, 0.03, 2500, 1, 1]]
README_PARAMS = [1.5, 3.5, 250.0, 0.0, 0.03, 1500.0, 1.0, 1.0]


@pytest.mark.parametrize("method", ["bubble_point", "dew_point"])
def test_binary_contract(method):
    """tests/test_compat.py::test_bubble_point_contract, both ways."""
    dens, nans = getattr(PcSaft, method)(
        np.array([NONASSOC]), np.array([[-0.15, 0.0]]), np.array([150.0]), np.array([0.5]),
        np.array([1e5]), device="cpu")
    assert isinstance(dens, np.ndarray) and isinstance(nans, np.ndarray)
    assert dens.shape == (1, 4) and nans.shape == (1,) and nans.dtype == bool
    assert not nans.any()
    # vapor (cols 0:2) less dense than liquid (cols 2:4)
    assert dens[0, :2].sum() < dens[0, 2:].sum()


@pytest.mark.parametrize("method,bubble", [("bubble_point", True), ("dew_point", False)])
def test_binary_values_and_compaction(backend, method, bubble):
    """Failed rows (a supercritical one) are dropped from the densities and
    flagged; the rest match the oracle's layout and values."""
    params = np.array([CONFIG3, CONFIG3, CONFIG3, NONASSOC])
    kij = np.array([[-0.15, 1000.0]] * 3 + [[-0.15, 0.0]])
    temperature = np.array([140.0, 2000.0, 160.0, 150.0])
    x1, p0 = np.full(4, 0.5), np.full(4, 1e5)
    dens, nans = getattr(PcSaft, method)(params, kij, temperature, x1, p0, device="cpu")
    assert nans.tolist() == [False, True, False, False]
    assert dens.shape == (3, 4)
    rho, _, ok = backend.mix_vle_densities(params, kij, temperature, x1, p0, bubble=bubble)
    np.testing.assert_array_equal(~nans, ok)
    np.testing.assert_allclose(dens, rho[ok], rtol=1e-8, atol=0)


def test_binary_kij_none_is_zero():
    args = (np.array([NONASSOC]),)
    rest = (np.array([150.0]), np.array([0.5]), np.array([1e5]))
    a, _ = PcSaft.bubble_point(*args, None, *rest, device="cpu")
    b, _ = PcSaft.bubble_point(*args, np.zeros((1, 2)), *rest, device="cpu")
    np.testing.assert_array_equal(a, b)


def test_non_binary_raises():
    with pytest.raises(ValueError):
        PcSaft.bubble_point(np.array([[NONASSOC[0]] * 3]), None, np.array([150.0]),
                            np.array([0.5]), np.array([1e5]), device="cpu")


def test_vapor_pressure_contract():
    params = np.array([README_PARAMS, README_PARAMS, README_PARAMS])
    temperature = np.array([300.0, 2000.0, 400.0])
    dens, nans = PcSaft.vapor_pressure(params, temperature, device="cpu")
    assert nans.tolist() == [False, True, False] and dens.shape == (2, 4)
    assert np.all(dens[:, 2:] == 0.0)
    rho_v, rho_l, ok = pure_vle(torch.as_tensor(params), torch.as_tensor(temperature))
    np.testing.assert_array_equal(dens[:, 0], rho_v.numpy()[ok.numpy()])
    np.testing.assert_array_equal(dens[:, 1], rho_l.numpy()[ok.numpy()])


def test_liquid_density_contract():
    params = np.array([README_PARAMS] * 2)
    temperature, pressure = np.array([300.0, 350.0]), np.array([1e5, 1e6])
    dens, nans = PcSaft.liquid_density(params, temperature, pressure, device="cpu")
    assert dens.shape == (2,) and not nans.any()
    p_red = torch.as_tensor(pressure / temperature * PA_PER_KT_TO_REDUCED)
    rho, _ = npt_density(torch.as_tensor(params), torch.as_tensor(temperature), p_red)
    np.testing.assert_allclose(dens, rho.numpy(), rtol=1e-12)
