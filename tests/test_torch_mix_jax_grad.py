"""The port's bubble and dew pressure gradients, and the derivative set's
in the cross-association regime, against the JAX package.

JAX's ``bubble_point``/``dew_point`` take the partial molar volumes of their
gradient identity through an f32 closure, which leaves the gradient about
1e-7 off in relative terms.  The reference here is the same stationary
identity built from the JAX package's f64 pieces (``precompute_mix``,
``phi_mix_pre``, ``pressure_set``) and differentiated by ``jacfwd`` at the
port's converged densities, for config 3 of ``benchmarks/run_all.py`` and
seeded cross-associating pairs, in all 8 parameters of both components, kij
and eps_AiBj; and JAX's ``jacfwd`` of the derivative set on the
cross-associating states of ``test_torch_mix_eos``.  JAX compiles these
Jacobians for about 40 s on a CPU, so ``tools/gen_torch_mix_jax_reference.py``
writes them, with the densities they were taken at, to
``tests/golden/torch_mix_jax.npz``; the fixture holds the port's live
densities to those within 1e-10.
"""

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from test_torch_mix_eos import (
    OUTPUTS, _mix_states, _t, assert_jacobians_match, assert_rows_close, port_jacobians,
    regime_rows,
)
from test_torch_mix_jax_bubble import REFERENCE, cross_systems

BUBBLE = {"bubble": True, "dew": False}


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
    value and Jacobians at the port's densities (vendored); and the port's
    and JAX's Jacobians of the derivative set on the cross-associating
    states."""
    ref = np.load(REFERENCE)
    params, kij, temperature, x1 = cross_systems(seed=24, n=4)
    for key, x in zip(("params", "kij", "t", "x1"), (params, kij, temperature, x1)):
        np.testing.assert_array_equal(ref[f"grad_{key}"], x, err_msg=f"stale grad_{key}")
    port, ref_out = {}, {}
    for name in BUBBLE:
        p, g_par, g_kij, rho_inc, rho_bulk = _port_point(name, params, kij, temperature, x1)
        port[name] = p, g_par, g_kij
        # the vendored Jacobians hold at the densities they were taken at
        for key, rho in (("rho_inc", rho_inc), ("rho_bulk", rho_bulk)):
            np.testing.assert_allclose(rho, ref[f"grad_{name}_{key}"], rtol=1e-10, atol=0)
        ref_out[name] = tuple(ref[f"grad_{name}_{key}"] for key in ("ident", "jpar", "jkij"))
    states = tuple(x[regime_rows("cross", "cross_eps")] for x in _mix_states())
    eos = port_jacobians(*states), (ref["grad_eos_jpar"], ref["grad_eos_jkij"])
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
