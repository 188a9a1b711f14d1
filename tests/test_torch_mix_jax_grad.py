"""The port's bubble and dew pressure gradients, and the derivative set's
in the cross-association regime, against the JAX package.

JAX's ``bubble_point``/``dew_point`` take the partial molar volumes of their
gradient identity through an f32 closure, which leaves the gradient about
1e-7 off in relative terms.  The reference here is the same stationary
identity built from the JAX package's f64 pieces (``precompute_mix``,
``phi_mix_pre``, ``pressure_set``) and differentiated by ``jacfwd`` at the
port's converged densities, for config 3 of ``benchmarks/run_all.py`` and
seeded cross-associating pairs, in all 8 parameters of both components, kij
and eps_AiBj.  One jitted Jacobian returns the identity and the derivative
set at the bulk density, so the cross-associating states of
``test_torch_mix_eos`` share its compile (their identity is not used).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from feos_tpu.models import pcsaft_mix as jmix
from feos_tpu.ops.derivatives import pressure_set as jpressure_set
from feos_tpu.units import REDUCED_TO_PA_PER_KT
from test_torch_mix_eos import (
    OUTPUTS, _mix_states, _t, assert_jacobians_match, assert_rows_close, port_jacobians,
    regime_rows,
)
from test_torch_mix_jax_bubble import cross_systems

BUBBLE = {"bubble": True, "dew": False}


def _identity_and_set(p, k, t, r_inc, r_bulk):
    """``[identity p~, A, p~, mu_0, mu_1, v_0, v_1]``: the bubble/dew
    identity at (r_inc, r_bulk) and the derivative set at r_bulk, per row."""
    pre = jmix.precompute_mix(jmix.MixParams.from_array(p), k[0], k[1], t)

    def phi(x):
        return jmix.phi_mix_pre(pre, x, branches=frozenset({"cross"}))

    a, p_b, g_b, v_b = jpressure_set(phi, r_bulk)
    mu_b = jnp.log(r_bulk) + g_b
    rho_t = r_inc.sum()
    w = r_inc / rho_t
    v_bulk = (w * v_b).sum()
    g_bulk = (w * (jnp.log(r_inc) - mu_b)).sum()
    ident = -(phi(r_inc) / rho_t + p_b * v_bulk + g_bulk - 1.0) / (1.0 / rho_t - v_bulk)
    return jnp.concatenate([ident[None], a[None], p_b[None], g_b, v_b])


def _port_point(name, params, kij, temperature, x1):
    """The port's pressures, their gradients in the parameters and kij per
    row, and the converged (rho_inc, rho_bulk) from the returned state."""
    p_in, k_in = _t(params).requires_grad_(), _t(kij).requires_grad_()
    fn = ft.bubble_point if BUBBLE[name] else ft.dew_point
    p, nans, state = fn(p_in, k_in, _t(temperature), _t(x1), _t(np.full(len(x1), 1e5)),
                        state_output=True)
    assert not nans.any()
    g_par, g_kij = torch.autograd.grad(p.sum(), (p_in, k_in))
    state = state.numpy()
    z = np.stack([x1, 1.0 - x1], 1)
    rho_inc, rho_bulk = np.exp(state[:, :2]), z * np.exp(state[:, 2:3])
    return p.detach().numpy(), g_par.numpy(), g_kij.numpy(), rho_inc, rho_bulk


@pytest.fixture(scope="module")
def solved():
    """Per direction, the port's (p, dp/dparams, dp/dkij) and JAX's identity
    value and Jacobians at the port's densities; and the port's and JAX's
    Jacobians of the derivative set on the cross-associating states."""
    params, kij, temperature, x1 = cross_systems(seed=24, n=4)
    port, rows = {}, []
    for name in BUBBLE:
        p, g_par, g_kij, rho_inc, rho_bulk = _port_point(name, params, kij, temperature, x1)
        port[name] = p, g_par, g_kij
        rows.append((params, kij, temperature, rho_inc, rho_bulk))
    states = tuple(x[regime_rows("cross", "cross_eps")] for x in _mix_states())
    s_params, s_kij, s_temperature, s_rho = states
    rows.append((s_params, s_kij, s_temperature, 0.5 * s_rho, s_rho))
    args = [np.concatenate(a) for a in zip(*rows)]

    def with_value(*a):
        out = _identity_and_set(*a)
        return out, out

    ref = jax.jit(jax.vmap(jax.jacfwd(with_value, argnums=(0, 1), has_aux=True)))
    (j_par, j_kij), val = jax.tree_util.tree_map(np.asarray, ref(*args))
    B = len(x1)
    ref_out = {}
    for i, name in enumerate(BUBBLE):
        sl = slice(i * B, (i + 1) * B)
        scale = (temperature * REDUCED_TO_PA_PER_KT)[:, None, None]
        ref_out[name] = (val[sl, 0] * scale[:, 0, 0], j_par[sl, 0] * scale,
                         j_kij[sl, 0] * scale[:, 0])
    eos = port_jacobians(*states), (j_par[2 * B:, 1:], j_kij[2 * B:, 1:])
    return port, ref_out, eos


@pytest.mark.parametrize("name", list(BUBBLE))
def test_identity_value_is_the_pressure(solved, name):
    """The reference identity at the port's densities is the port's
    pressure, to the solve's tolerance: the densities are the solution."""
    port, ref, _ = solved
    np.testing.assert_allclose(ref[name][0], port[name][0], rtol=1e-8, atol=0)


@pytest.mark.parametrize("name", list(BUBBLE))
@pytest.mark.parametrize("wrt", [1, 2], ids=["params", "kij"])
def test_pressure_gradients_match_jax_identity(solved, name, wrt):
    """dp/d(8 parameters of both components) and dp/d(kij, eps_AiBj) in
    Pa against jacfwd of the f64 identity, row by row."""
    port, ref, _ = solved
    assert_rows_close(port[name][wrt], ref[name][wrt])


@pytest.mark.parametrize("j", range(len(OUTPUTS)), ids=OUTPUTS)
def test_parameter_gradients_match_jax(solved, j):
    """d(A, p~, mu, v)/d(parameters, kij) against JAX's jacfwd on the 36
    cross-associating states of test_torch_mix_eos (with and without an
    eps_AiBj override)."""
    assert_jacobians_match(*solved[2], j)
