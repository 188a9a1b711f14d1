"""The port's ``fit_binary`` on its own: the kij recovery of
tests/test_regression.py, the epsilon_k_AiBj fit step by step against
optax's Adam update written out over the port's ``binary_loss`` (JAX's
``fit_binary`` with an epsilon_k_AiBj fit needs a cross-associating pair,
whose program compiles for about a minute on this CPU), and the state a
failed row carries.  The step-by-step match with JAX's ``fit_binary`` is in
test_torch_binary_regression.py.  No JAX function is compiled here.
"""

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from test_torch_binary_regression import COMP, KIJ_TRUE, STEPS, T, X1, _data, _t

CONFIG3 = np.array([[1, 3.5, 150, 0, 0.02, 1500, 1, 1], [1, 3.5, 200, 0, 0.03, 2500, 1, 1]],
                   dtype=float)


@pytest.fixture(scope="module")
def p_data():
    """Bubble pressures of the pair at kij = -0.1: the data."""
    return _data(COMP, [KIJ_TRUE, 0.0], T, X1)


def test_fit_recovers_kij(p_data):
    """tests/test_regression.py::test_fit_binary_recovers_kij, at its bars."""
    res = ft.fit_binary(COMP, T, X1, p_data, kij0=0.0, steps=80, device="cpu")
    losses = res.loss_history.numpy()
    assert abs(float(res.parameters[0]) - KIJ_TRUE) < 5e-3
    assert losses[-1] < 1e-5
    assert losses[-1] < 1e-4 * losses[0]


def test_epsilon_fit_is_adam_over_binary_loss():
    """The epsilon_k_AiBj fit (config 3, 4 rows, data at kij = [-0.15, 1000],
    from kij = 0 and eps = 900): each of 3 steps is optax's Adam (lr 5e-3,
    b1 0.9, b2 0.999, eps 1e-8) over theta = [k_ij, eps_AiBj / 900] on the
    port's binary_loss, warm from the previous step's state, and the loss
    falls."""
    temperature, x1 = np.linspace(140.0, 160.0, 4), np.full(4, 0.5)
    p_data = _data(CONFIG3, [-0.15, 1000.0], temperature, x1)
    res = ft.fit_binary(CONFIG3, temperature, x1, p_data, kij0=0.0, epsilon_k_aibj0=900.0,
                        steps=STEPS, device="cpu")
    scale = _t([1.0, 900.0])
    args = (_t(CONFIG3), _t(temperature), _t(x1), _t(p_data))
    theta = _t([0.0, 1.0])
    with torch.no_grad():
        _, state = ft.binary_loss(theta * scale, *args, return_state=True)
    m, v, losses = torch.zeros(2, dtype=torch.float64), torch.zeros(2, dtype=torch.float64), []
    for step in range(1, STEPS + 1):
        th = theta.clone().requires_grad_()
        loss, state = ft.binary_loss(th * scale, *args, state0=state, return_state=True)
        loss.backward()
        losses.append(float(loss.detach()))
        m = 0.9 * m + 0.1 * th.grad
        v = 0.999 * v + 0.001 * th.grad**2
        m_hat, v_hat = m / (1.0 - 0.9**step), v / (1.0 - 0.999**step)
        theta = theta - 5e-3 * m_hat / (v_hat.sqrt() + 1e-8)
    np.testing.assert_allclose(res.loss_history.numpy(), losses, rtol=1e-12, atol=0)
    np.testing.assert_allclose(res.parameters.numpy(), (theta * scale).numpy(), rtol=1e-12,
                               atol=0)
    assert losses[-1] < losses[0] and res.parameters[1] != 900.0


def test_failed_row_keeps_its_state(p_data):
    """A row that fails (a supercritical 2000 K row) returns the state it
    was given; the converged rows return their own."""
    with torch.no_grad():
        _, state0 = ft.binary_loss(_t([0.0, 0.0]), _t(COMP), _t(T), _t(X1), _t(p_data),
                                   return_state=True)
    state0 = state0.numpy()
    temperature = T.copy()
    temperature[3] = 2000.0
    loss, state = ft.binary_loss(_t([0.0, 0.0]), _t(COMP), _t(temperature), _t(X1),
                                 _t(p_data), state0=_t(state0), return_state=True)
    state = state.numpy()
    assert np.isfinite(float(loss))
    np.testing.assert_array_equal(state[3], state0[3])
    np.testing.assert_allclose(np.delete(state, 3, 0), np.delete(state0, 3, 0), rtol=1e-8)
