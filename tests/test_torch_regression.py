"""The port's regression loss and Adam fit against the JAX package.

Vapor pressures and compressed-liquid densities of the README fluid, made
by the port at the README parameters, are the data.  In one jit, the port's
``pure_loss`` at parameters 1% off goes against JAX's f64 value and
gradient of the same identities at the port's densities (both targets), and
against the JAX package's shipped ``pure_loss`` on the density target,
whose tangents are f64 (the shipped vapor-pressure gradient rides f32
tangents and is held at 1e-4 in test_torch_vapor_pressure.py).  The port's
``fit_pure`` goes against JAX ``fit_pure`` on the density target.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from feos_tpu import regression as jregression
from feos_tpu.models import pcsaft_pure as jpure
from feos_tpu.units import KMOL_M3_TO_REDUCED, PA_PER_KT_TO_REDUCED, REDUCED_TO_PA_PER_KT
from feos_tpu_torch import regression

README_PARAMS = np.array([1.5, 3.5, 250.0, 0.0, 0.03, 1500.0, 1.0, 1.0])
START = README_PARAMS * np.array([1.01, 0.99, 1.01, 1.0, 1.01, 0.99, 1.0, 1.0])
T = np.array([250.0, 275.0, 300.0, 325.0, 350.0])
PRESSURE = np.full(5, 5e6)  # compressed liquid
B = len(T)
COLUMNS = ["m", "sigma", "epsilon_k", "mu", "kappa_ab", "epsilon_k_ab", "na", "nb"]


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _data():
    """(p_sat, rho_liq) of the README fluid: the targets."""
    params = _t(np.tile(README_PARAMS, (B, 1)))
    with torch.no_grad():
        nans, p_sat = ft.vapor_pressure(params, _t(T))
        nans_l, rho = ft.liquid_density(params, _t(T), _t(PRESSURE))
    assert not nans.any() and not nans_l.any()
    return p_sat.numpy(), rho.numpy()


@pytest.fixture(scope="module")
def case():
    p_sat, rho_liq = _data()
    port = {}
    for name, vp_target in (("both", p_sat), ("density", None)):
        q = _t(START).requires_grad_()
        loss = ft.pure_loss(q, _t(T), None if vp_target is None else _t(vp_target),
                            _t(rho_liq), _t(PRESSURE))
        loss.backward()
        port[name] = (loss.item(), q.grad.numpy())

    # the port's solved densities at START, sanitised as the port does
    par = _t(np.tile(START, (B, 1)))
    p_red = PRESSURE / T * PA_PER_KT_TO_REDUCED
    with torch.no_grad():
        rho_v, rho_l, ok = ft.pure_vle(par, _t(T))
        r_npt, ok_npt = ft.npt_density(par, _t(T), _t(p_red))
    rv = np.where(ok, rho_v.numpy(), 1e-5)
    rl = np.where(ok, rho_l.numpy(), 1e-3)
    r_npt = np.where(ok_npt, r_npt.numpy(), 1e-3)

    @jax.jit
    def reference(q, t, ps, rho_target, pres, pr, rv, rl, ok, r_npt, ok_npt):
        shipped = jax.value_and_grad(jregression.pure_loss)(q, t, None, rho_target, pres)

        def identity_loss(q):
            pp = jpure.PureParams.from_array(jnp.tile(q, (B, 1)))
            a_l = jax.vmap(jpure.phi_pure)(pp, t, rl) / rl
            a_v = jax.vmap(jpure.phi_pure)(pp, t, rv) / rv
            vp = -(a_v - a_l + jnp.log(rv / rl)) / (1.0 / rv - 1.0 / rl) * t * REDUCED_TO_PA_PER_KT
            _, pt, dpt = jax.vmap(jpure.pure_derivatives)(pp, t, r_npt)
            rho = (r_npt - (pt - pr) / dpt) / KMOL_M3_TO_REDUCED
            return (jregression.masked_relative_sse(jnp.where(ok, vp, 1.0), ps, ok)
                    + jregression.masked_relative_sse(jnp.where(ok_npt, rho, 1.0),
                                                      rho_target, ok_npt))

        # forward mode: the same f64 derivative, a quarter of the compile time
        return shipped, (identity_loss(q), jax.jacfwd(identity_loss)(q))

    ref = reference(*(jnp.asarray(x) for x in (
        START, T, p_sat, rho_liq, PRESSURE, p_red, rv, rl, ok.numpy(), r_npt,
        ok_npt.numpy())))
    ref = jax.tree_util.tree_map(np.asarray, ref)
    return port, {"density": (float(ref[0][0]), ref[0][1]),
                  "both": (float(ref[1][0]), ref[1][1])}


def test_masked_relative_sse_matches_jax():
    pred, target = np.array([1.1, 2.0, 2.9, 7.0]), np.array([1.0, 2.2, 3.0, 5.0])
    for ok in (np.array([True, True, True, False]), np.zeros(4, bool)):
        got = float(ft.masked_relative_sse(_t(pred), _t(target), torch.as_tensor(ok)))
        want = float(jregression.masked_relative_sse(jnp.asarray(pred), jnp.asarray(target),
                                                     jnp.asarray(ok)))
        assert got == pytest.approx(want, rel=1e-15) if ok.any() else got == want == np.inf


@pytest.mark.parametrize("target", ["both", "density"])
def test_loss_matches_jax(case, target):
    port, ref = case
    assert 0.0 < port[target][0]
    assert port[target][0] == pytest.approx(ref[target][0], rel=1e-9)


@pytest.mark.parametrize("i", range(8), ids=COLUMNS)
def test_gradient_matches_jax_identity_f64(case, i):
    """Both targets, against JAX's f64 derivative of the same identities at
    the port's densities.  mu is zero for this fluid, so its column is 0 on
    both sides."""
    port, ref = case
    np.testing.assert_allclose(port["both"][1][i], ref["both"][1][i], rtol=1e-12, atol=0)


@pytest.mark.parametrize("i", range(8), ids=COLUMNS)
def test_gradient_matches_jax_shipped(case, i):
    """The density target, against the JAX package's shipped gradient,
    whose tangents are f64 there."""
    port, ref = case
    np.testing.assert_allclose(port["density"][1][i], ref["density"][1][i], rtol=1e-8, atol=0)


def test_shared_parameters_sum_the_rows(case):
    """An (8,) vector is expanded over the rows, so its gradient is the sum
    of the per-row gradients of the same parameters as (B, 8)."""
    port, _ = case
    loss, grad = port["both"]
    p_sat, rho_liq = _data()
    q = _t(np.tile(START, (B, 1))).requires_grad_()
    loss_b = ft.pure_loss(q, _t(T), _t(p_sat), _t(rho_liq), _t(PRESSURE))
    loss_b.backward()
    assert float(loss_b) == loss
    np.testing.assert_allclose(q.grad.sum(0).numpy(), grad, rtol=1e-13, atol=0)


@pytest.fixture(scope="module")
def fits():
    """Three Adam steps on the density target from START, in both packages."""
    _, rho_liq = _data()
    port = ft.fit_pure(START, _t(T), rho_liq=_t(rho_liq), pressure=_t(PRESSURE), steps=3)
    ref = jregression.fit_pure(START, jnp.asarray(T), rho_liq=jnp.asarray(rho_liq),
                               pressure=jnp.asarray(PRESSURE), steps=3)
    return port, ref


def test_fit_matches_jax(fits):
    port, ref = fits
    np.testing.assert_allclose(port.loss_history.numpy(), np.asarray(ref.loss_history),
                               rtol=1e-8, atol=0)
    np.testing.assert_allclose(port.parameters.numpy(), np.asarray(ref.parameters),
                               rtol=1e-8, atol=0)


def test_fit_loss_decreases(fits):
    port, _ = fits
    losses = port.loss_history.numpy()
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    # Adam's first steps move each scaled parameter by about lr = 1e-2
    z = port.parameters.numpy() / np.where(START != 0, np.abs(START), 1.0)
    assert np.all(np.abs(z - np.sign(START) * np.where(START != 0, 1.0, 0.0)) < 0.04)


def _quadratic(parameters, *args, **kwargs):
    return ((parameters - 2.0) ** 2).sum()


def test_nonfinite_step_is_skipped(monkeypatch):
    """A step whose gradient is not finite leaves the parameters and Adam's
    state as they were: the fit equals one that skipped that step."""
    calls = []

    def flaky(parameters, *args, **kwargs):
        calls.append(1)
        loss = _quadratic(parameters)
        return loss * torch.nan if len(calls) == 2 else loss

    x0 = np.array([1.0, 3.0, -1.0, 0.0, 0.5, 2.0, 1.0, 1.0])
    monkeypatch.setattr(regression, "pure_loss", flaky)
    got = ft.fit_pure(x0, _t(T), steps=4)
    monkeypatch.setattr(regression, "pure_loss", _quadratic)
    want = ft.fit_pure(x0, _t(T), steps=3)
    assert torch.isnan(got.loss_history[1])
    np.testing.assert_array_equal(got.parameters.numpy(), want.parameters.numpy())


def test_step_applied_after_max_consecutive_errors(monkeypatch):
    """After MAX_CONSECUTIVE_ERRORS skipped steps in a row the next
    non-finite step is applied, as optax.apply_if_finite does."""
    n = regression.MAX_CONSECUTIVE_ERRORS
    monkeypatch.setattr(regression, "pure_loss",
                        lambda parameters, *a, **k: _quadratic(parameters) * torch.nan)
    x0 = np.ones(8)
    held = ft.fit_pure(x0, _t(T), steps=n)
    applied = ft.fit_pure(x0, _t(T), steps=n + 1)
    np.testing.assert_array_equal(held.parameters.numpy(), x0)
    assert torch.isnan(applied.parameters).all()
