"""The port's ``binary_loss`` and ``fit_binary`` against the JAX package.

The system of tests/test_regression.py::test_fit_binary_recovers_kij (a
non-associating pair, 8 rows): bubble pressures made by the port at kij =
-0.1 are the data.  Three steps of JAX's ``fit_binary`` from kij = 0 (loss
history and parameters, step by step), JAX's ``binary_loss`` at kij = 0,
and ``jacfwd`` of JAX's f64 stationary identity at the port's densities,
which gives the loss gradient in kij without the f32 partial molar volumes
of JAX's shipped gradient.  JAX compiles these for about 45 s on a CPU, so
``tools/gen_port_fixtures.py`` writes its values, with the data and the
port's densities they were taken at, to
``tests/golden/torch_binary_regression_jax.npz``.  The epsilon_k_AiBj fit,
the kij recovery and the failed rows' state are in
test_torch_binary_fit.py.
"""

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from _torch_golden import vendored

COMP = np.array([[1, 3.5, 150, 0, 0, 0, 0, 0], [1, 3.5, 200, 0, 0, 0, 0, 0]], dtype=float)
KIJ_TRUE = -0.1
B = 8
T = np.linspace(140.0, 160.0, B)
X1 = np.linspace(0.2, 0.8, B)
STEPS = 3


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _data(comp, kij, temperature, x1):
    """The port's bubble pressures: the data."""
    n = len(temperature)
    with torch.no_grad():
        p, nans = ft.bubble_point(_t(np.tile(comp, (n, 1, 1))), _t(np.tile(kij, (n, 1))),
                                  _t(temperature), _t(x1), _t(np.full(n, 1e5)))
    assert not nans.any()
    return p.numpy()


def _identity_pa(k, t, r_inc, r_bulk):
    """The bubble-point identity in Pa at (r_inc, r_bulk), per row, from
    JAX's f64 pieces, as a function of the pair [k_ij, eps_AiBj]."""
    import jax.numpy as jnp
    from feos_tpu.models import pcsaft_mix as jmix
    from feos_tpu.ops.derivatives import pressure_set as jpressure_set
    from feos_tpu.units import REDUCED_TO_PA_PER_KT

    pre = jmix.precompute_mix(jmix.MixParams.from_array(jnp.asarray(COMP)), k[0], k[1], t)

    def phi(x):
        return jmix.phi_mix_pre(pre, x, branches=frozenset())

    _, p_b, g_b, v_b = jpressure_set(phi, r_bulk)
    mu_b = jnp.log(r_bulk) + g_b
    rho_t = r_inc.sum()
    w = r_inc / rho_t
    v_bulk = (w * v_b).sum()
    g_bulk = (w * (jnp.log(r_inc) - mu_b)).sum()
    ident = -(phi(r_inc) / rho_t + p_b * v_bulk + g_bulk - 1.0) / (1.0 / rho_t - v_bulk)
    return ident * t * REDUCED_TO_PA_PER_KT


def _port_case():
    """The data, the port's loss, gradient and state at kij = 0 and its
    3-step fit, and its converged densities at kij = 0."""
    p_data = _data(COMP, [KIJ_TRUE, 0.0], T, X1)
    kij = _t([0.0, 0.0]).requires_grad_()
    loss, state = ft.binary_loss(kij, _t(COMP), _t(T), _t(X1), _t(p_data), return_state=True)
    loss.backward()
    with torch.no_grad():
        p, nans = ft.bubble_point(_t(np.tile(COMP, (B, 1, 1))), _t(np.zeros((B, 2))), _t(T),
                                  _t(X1), _t(p_data))
    port = {"loss": float(loss.detach()), "grad": kij.grad.numpy(), "p": p.numpy(),
            "nans": nans.numpy(), "state": state.numpy(),
            "fit": ft.fit_binary(COMP, T, X1, p_data, kij0=0.0, steps=STEPS, device="cpu")}
    u = port["state"]
    z = np.stack([X1, 1.0 - X1], 1)
    return port, p_data, {"r_inc": np.exp(u[:, :2]), "r_bulk": z * np.exp(u[:, 2:3])}


def jax_reference():
    """JAX's loss at kij = 0, its identity Jacobian at the port's densities
    and its 3-step fit on the port's data."""
    import jax
    import jax.numpy as jnp
    from feos_tpu import regression as jregression

    _, p_data, dens = _port_case()
    # fit_binary's own jits; binary_loss at its start reuses its cold solve's
    fit = jregression.fit_binary(COMP, T, X1, p_data, kij0=0.0, steps=STEPS)
    loss = jregression.binary_loss(jnp.zeros(2), COMP, T, X1, p_data)
    jac = jax.jit(jax.vmap(jax.jacfwd(_identity_pa), in_axes=(None, 0, 0, 0)))(
        jnp.zeros(2), jnp.asarray(T), dens["r_inc"], dens["r_bulk"])
    return {"comp": COMP, "t": T, "x1": X1, "p_data": p_data, **dens, "loss": loss,
            "jac": jac, "fit_parameters": fit.parameters, "fit_loss_history": fit.loss_history}


@pytest.fixture(scope="module")
def case():
    """The port's loss, gradient and state at kij = 0 and its 3-step fit;
    JAX's loss, identity Jacobian at the port's densities, and 3-step fit
    (vendored)."""
    port, p_data, dens = _port_case()
    ref = vendored("binary_regression", exact={"comp": COMP, "t": T, "x1": X1},
                   close={"p_data": p_data, **dens})
    fit = ft.FitResult(ref["fit_parameters"], ref["fit_loss_history"])
    return port, (ref["loss"], ref["jac"], fit), p_data


def test_loss_matches_jax(case):
    port, (loss, _, _), _ = case
    assert port["loss"] > 0.0 and not port["nans"].any()
    np.testing.assert_allclose(port["loss"], loss, rtol=1e-10)


def test_gradient_matches_jax_identity_f64(case):
    """d loss / d[k_ij, eps_AiBj] against the chain rule over JAX's f64
    identity Jacobian at the port's densities; eps_AiBj does nothing to a
    non-associating pair, so its column is 0 on both sides."""
    port, (_, jac, _), p_data = case
    rel = (port["p"] - p_data) / p_data
    want = (2.0 * rel / p_data) @ jac / B
    np.testing.assert_allclose(port["grad"], want, rtol=1e-10, atol=0)
    assert port["grad"][1] == 0.0


def test_fit_matches_jax_step_by_step(case):
    port, (_, _, fit), _ = case
    np.testing.assert_allclose(port["fit"].loss_history.numpy(), fit.loss_history, rtol=1e-8,
                               atol=0)
    np.testing.assert_allclose(port["fit"].parameters.numpy(), fit.parameters, rtol=1e-8,
                               atol=0)
    assert port["fit"].parameters[1] == 0.0
