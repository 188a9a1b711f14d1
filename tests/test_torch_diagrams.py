"""The port's binary phase diagrams against the JAX package.

The six cases of tests/test_diagrams.py, through ``feos_tpu_torch``:
p-x-y and T-x-y of propane/n-butane (Gross & Sadowski 2001) bracketed by the
pure components, the scalar-kij padding, the gc diagrams over a facade on
replicated n-butane/propane rows, the bubble-dew round trip and the T-x-y
closure through the pressure solver.  JAX's ``binary_pxy`` runs on the same
pair from the port's Raoult estimate: p at 1e-9, y1 at 1e-8, equal masks.
"""

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from feos_tpu import diagrams as jdiagrams
from feos_tpu_torch.diagrams import _raoult_init
from test_torch_gc_eos import IDENT, PARAMETER, parameter_tuple

PARAMS = np.array([[2.0020, 3.6184, 208.11, 0, 0, 0, 0, 0],
                   [2.3316, 3.7086, 222.88, 0, 0, 0, 0, 0]])
T = 300.0
N = 9
GC_SEGMENTS = [["CH3", "CH2", "CH2", "CH3"], ["CH3", "CH2", "CH3"]]
GC_BONDS = [[[0, 1], [1, 2], [2, 3]], [[0, 1], [1, 2]]]


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def gc_eos(rows=N):
    """n-butane / propane, replicated ``rows`` times."""
    return ft.GcPcSaftMix(IDENT, parameter_tuple(PARAMETER), [GC_SEGMENTS] * rows,
                          [GC_BONDS] * rows, [], None, device="cpu")


@pytest.fixture(scope="module")
def pxy():
    """The port's and JAX's p-x-y diagram of the pair at 300 K; JAX starts
    from the port's Raoult estimate (its own pure vapor pressures, held to
    the port in test_torch_vapor_pressure.py, would add their compile)."""
    with torch.no_grad():
        port = ft.binary_pxy(PARAMS, None, T, n_points=N, device="cpu")
        p0 = _raoult_init(_t(PARAMS), T, port.x1)
    ref = jdiagrams.binary_pxy(PARAMS, None, T, n_points=N, pressure_init=p0.numpy())
    return port, ref


def test_binary_pxy_shape_and_bounds(pxy):
    """tests/test_diagrams.py::test_binary_pxy_shape_and_bounds."""
    d, _ = pxy
    assert d.x1.shape == d.y1.shape == d.p.shape == d.nans.shape == (N,)
    assert not d.nans.any()
    with torch.no_grad():
        _, psat = ft.vapor_pressure(_t(PARAMS), _t([T, T]))
    psat = psat.numpy()
    p = d.p.numpy()
    assert np.all(p > 0.99 * psat.min()) and np.all(p < 1.01 * psat.max())
    # the light component (propane, the higher psat) enriches the vapor
    assert int(np.argmax(psat)) == 0
    assert np.all(d.y1.numpy() > d.x1.numpy())


@pytest.mark.parametrize("field,rtol,atol", [("p", 1e-9, 0.0), ("y1", 0.0, 1e-8),
                                             ("x1", 1e-15, 0.0)])
def test_binary_pxy_matches_jax(pxy, field, rtol, atol):
    port, ref = pxy
    np.testing.assert_array_equal(port.nans.numpy(), np.asarray(ref.nans))
    np.testing.assert_allclose(getattr(port, field).numpy(), np.asarray(getattr(ref, field)),
                               rtol=rtol, atol=atol)


def test_binary_pxy_scalar_kij():
    """A scalar kij is [k_ij, 0]: it must not be broadcast into the
    eps_AiBj column; any other shape raises, as do parameters that are not
    (2, 8)."""
    with torch.no_grad():
        d_scalar = ft.binary_pxy(PARAMS, 0.02, T, n_points=N, device="cpu")
        d_one = ft.binary_pxy(PARAMS, [0.02], T, n_points=N, device="cpu")
        d_pair = ft.binary_pxy(PARAMS, [0.02, 0.0], T, n_points=N, device="cpu")
    np.testing.assert_array_equal(d_scalar.p.numpy(), d_pair.p.numpy())
    np.testing.assert_array_equal(d_one.p.numpy(), d_pair.p.numpy())
    with pytest.raises(ValueError, match="k_ij"):
        ft.binary_pxy(PARAMS, [0.02, 0.0, 1.0], T, n_points=N, device="cpu")
    with pytest.raises(ValueError, match="k_ij"):
        ft.binary_txy(PARAMS, [[0.02, 0.0]], 3e5, n_points=N, device="cpu")
    with pytest.raises(ValueError, match=r"\(2, 8\)"):
        ft.binary_pxy(PARAMS[None], None, T, n_points=N, device="cpu")


def test_gc_binary_pxy():
    """tests/test_diagrams.py::test_gc_binary_pxy: the batch is the grid."""
    eos = gc_eos()
    with torch.no_grad():
        d = ft.gc_binary_pxy(eos, 300.0, n_points=N)
    assert d.x1.shape == d.y1.shape == d.p.shape == d.nans.shape == (N,)
    assert not d.nans.any()
    # x1 is the n-butane (heavy) fraction: the vapor is butane-lean
    assert np.all(d.y1.numpy() < d.x1.numpy())
    assert np.all(np.diff(d.p.numpy()) < 0.0)
    with pytest.raises(ValueError, match="batch dimension"):
        ft.gc_binary_pxy(eos, 300.0, n_points=N + 1)
    with pytest.raises(ValueError, match="batch dimension"):
        ft.gc_binary_txy(eos, 3e5, n_points=N + 1)


def test_bubble_dew_round_trip(pxy):
    """A dew solve at the bubble point's vapor composition recovers its
    pressure and liquid composition."""
    d, _ = pxy
    y = torch.stack([d.y1, 1.0 - d.y1], 1)
    batch = _t(np.tile(PARAMS, (N, 1, 1)))
    with torch.no_grad():
        p_dew, nans, x_back = ft.dew_point(batch, None, _t(np.full(N, T)), y, d.p,
                                           full_output=True)
    assert not nans.any()
    np.testing.assert_allclose(p_dew.numpy(), d.p.numpy(), rtol=1e-7)
    np.testing.assert_allclose(x_back[:, 0].numpy(), d.x1.numpy(), rtol=0, atol=1e-8)


def test_binary_txy():
    """tests/test_diagrams.py::test_binary_txy: bubble temperatures between
    the pure boiling points, falling with the propane fraction, the vapor
    propane-rich, and the bubble pressure at (x1, T) the isobar's."""
    p = 3e5
    with torch.no_grad():
        d = ft.binary_txy(PARAMS, None, p, n_points=N, device="cpu")
        nb, tb = ft.boiling_temperature(_t(PARAMS), _t([p, p]), 1.2 * _t(PARAMS[:, 2]))
    assert d.x1.shape == d.y1.shape == d.t.shape == d.nans.shape == (N,)
    assert not d.nans.any() and not nb.any()
    t = d.t.numpy()
    assert np.all(t > float(tb.min()) - 1e-9) and np.all(t < float(tb.max()) + 1e-9)
    assert np.all(np.diff(t) < 0.0)
    assert np.all(d.y1.numpy() > d.x1.numpy())
    with torch.no_grad():
        p_back, nans = ft.bubble_point(_t(np.tile(PARAMS, (N, 1, 1))), None, d.t, d.x1,
                                       _t(np.full(N, p)))
    assert not nans.any()
    np.testing.assert_allclose(p_back.numpy(), p, rtol=1e-9)


def test_gc_binary_txy():
    """tests/test_diagrams.py::test_gc_binary_txy."""
    eos = gc_eos()
    with torch.no_grad():
        d = ft.gc_binary_txy(eos, 3e5, n_points=N)
        assert not d.nans.any()
        assert np.all(np.diff(d.t.numpy()) > 0.0)
        assert np.all(d.y1.numpy() < d.x1.numpy())
        p_back, nans = eos.bubble_point(d.t, d.x1, _t(np.full(N, 3e5)))
    assert not nans.any()
    np.testing.assert_allclose(p_back.numpy(), 3e5, rtol=1e-9)


def test_gradient_flows_through_pxy():
    """A tensor of parameters that requires grad gets the bubble pressure's
    gradient through the diagram, as the JAX docstring promises."""
    params = _t(PARAMS).requires_grad_()
    d = ft.binary_pxy(params, None, T, n_points=3, device="cpu")
    d.p.sum().backward()
    assert torch.isfinite(params.grad).all() and params.grad[:, 2].abs().min() > 0.0
