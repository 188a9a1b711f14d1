"""The port's boiling temperatures against the JAX package.

The JAX package's own case (tests/test_tsolve.py: an associating fluid on a
1e4 to 2e6 Pa grid from 300 K) goes through the port's
``boiling_temperature`` and, in one jit, through JAX ``boiling_temperature``
with the gradients of sum T_b in epsilon_k and in the pressures (compiled
for about 40 s on a CPU, so ``tools/gen_port_fixtures.py`` writes JAX's
values to ``tests/golden/torch_tsolve_jax.npz``).  The round trip, finite
differences and the inverse-function identity hold the port on its own.
"""

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from _torch_golden import vendored
from feos_tpu_torch.solvers import tsolve

ROW = [1.5, 3.5, 250.0, 0, 0.03, 1500.0, 1, 1]
PURE = np.tile(ROW, (4, 1))
P_GRID = [1e4, 1e5, 5e5, 2e6]
T0 = 300.0
EPS = 250.0


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _params_at(eps):
    """PURE with its epsilon_k column set to the scalar tensor ``eps``."""
    par = _t(PURE).clone()
    par[:, 2] = eps
    return par


@pytest.fixture(scope="module")
def case():
    """(port, jax): each (nans, T_b, d sum(T_b)/d eps, d sum(T_b)/d p)."""
    eps = _t(EPS).requires_grad_()
    p = _t(P_GRID).requires_grad_()
    stats = {}
    nans, t = ft.boiling_temperature(_params_at(eps), p, T0, stats=stats)
    t.sum().backward()
    port = (nans.numpy(), t.detach().numpy(), float(eps.grad), p.grad.numpy(), stats)
    ref = vendored("tsolve", exact={"pure": PURE, "p_grid": P_GRID, "t0": T0, "eps": EPS})
    return port, tuple(ref[k] for k in OUTPUTS)


OUTPUTS = ("nans", "t", "grad_eps", "grad_p")


def jax_reference():
    """JAX's (nans, T_b, d sum(T_b)/d eps, d sum(T_b)/d p)."""
    import jax
    import jax.numpy as jnp
    from feos_tpu.models import pcsaft_pure as jpure

    @jax.jit
    def reference(e, pres):
        def loss(e, pres):
            nans, t = jpure.boiling_temperature(
                jnp.asarray(PURE).at[:, 2].set(e), pres, jnp.full((4,), T0))
            return t.sum(), (nans, t)

        (_, (nans, t)), (g_e, g_p) = jax.value_and_grad(loss, (0, 1), has_aux=True)(e, pres)
        return nans, t, g_e, g_p

    out = reference(jnp.float64(EPS), jnp.asarray(P_GRID))
    return {"pure": PURE, "p_grid": P_GRID, "t0": T0, "eps": EPS, **dict(zip(OUTPUTS, out))}


def test_values_match_jax(case):
    """The two packages' vapor pressures agree at 1e-9, so T_b does too."""
    port, ref = case
    np.testing.assert_array_equal(port[0], ref[0])
    assert not port[0].any()
    assert np.all(np.diff(port[1]) > 0)
    np.testing.assert_allclose(port[1], ref[1], rtol=1e-9, atol=0)
    assert 0 < port[4]["outer"] < 24


def test_round_trip(case):
    """The vapor pressure at T_b recovers the target pressures."""
    port, _ = case
    with torch.no_grad():
        nans, p_back = ft.vapor_pressure(_t(PURE), _t(port[1]))
    assert not nans.any()
    np.testing.assert_allclose(p_back.numpy(), P_GRID, rtol=1e-11)


def test_epsilon_gradient_central_fd(case):
    port, _ = case
    h = 1e-4
    with torch.no_grad():
        t_p = ft.boiling_temperature(_params_at(EPS + h), _t(P_GRID), T0)[1]
        t_m = ft.boiling_temperature(_params_at(EPS - h), _t(P_GRID), T0)[1]
    fd = float((t_p.sum() - t_m.sum()) / (2 * h))
    np.testing.assert_allclose(port[2], fd, rtol=1e-5)


def test_epsilon_gradient_matches_jax(case):
    """The JAX package's gradient rides its vapor pressure's f32 parameter
    tangents (ROADMAP C, its first fault), hence the 1e-4 bar."""
    port, ref = case
    np.testing.assert_allclose(port[2], ref[2], rtol=1e-4)


def test_pressure_gradient_is_inverse_slope(case):
    """dT_b/dp = 1/(dp_sat/dT) at T_b (inverse function theorem), with
    dp_sat/dT from the port's vapor-pressure temperature gradient."""
    port, _ = case
    t = _t(port[1]).requires_grad_()
    _, vp = ft.vapor_pressure(_t(PURE), t)
    vp.sum().backward()
    np.testing.assert_allclose(port[3], 1.0 / t.grad.numpy(), rtol=1e-6)


def test_pressure_gradient_matches_jax(case):
    port, ref = case
    np.testing.assert_allclose(port[3], ref[3], rtol=1e-6)


def test_unreachable_pressure_masked():
    """A target above the critical pressure comes back masked and NaN, with
    a finite gradient, and leaves the other rows as they were."""
    params = _t(PURE).requires_grad_()
    nans, t = ft.boiling_temperature(params, _t([1e5, 1e12, 1e5, 1e5]), T0)
    assert nans.tolist() == [False, True, False, False]
    assert torch.isnan(t[1]).item()
    np.testing.assert_allclose(t[0].item(), t[2].item(), rtol=1e-12)
    torch.where(nans, 0.0, t).sum().backward()
    assert torch.isfinite(params.grad).all()


def test_secant_loop_on_a_known_line():
    """On an exact Clausius-Clapeyron line ln p = 20 - 4000/T the secant
    lands on T = 4000/(20 - ln p) and stops at its tolerance."""
    target = torch.log(_t([1e3, 1e5]))
    stats = {}
    t, done = tsolve.saturation_temperature_loop(
        lambda temp: (20.0 - 4000.0 / temp, torch.ones_like(temp, dtype=torch.bool)),
        _t([250.0, 250.0]), target, stats=stats,
    )
    assert done.all() and 0 < stats["outer"] < 24
    np.testing.assert_allclose(t.numpy(), (4000.0 / (20.0 - target)).numpy(), rtol=1e-9)


def test_facade_matches_functional(case):
    port, _ = case
    eos = ft.PcSaftPure(PURE, device="cpu")
    with torch.no_grad():
        nans, t = eos.boiling_temperature(P_GRID, T0)
    assert not nans.any()
    np.testing.assert_allclose(t.numpy(), port[1], rtol=1e-13)
