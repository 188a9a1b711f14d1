"""The port's critical-point solve against the JAX package.

Gross & Sadowski (2001) rows, the README row and a make_batch row on which
the critical Newton does not converge go through the port's
``critical_point`` and, in one jit, through JAX ``critical_point`` with the
gradient of sum T_c.  JAX compiles that for about a minute on a CPU, so
``tools/gen_port_fixtures.py`` writes its values to
``tests/golden/torch_critical_jax.npz``.  The critical conditions are
checked at the port's states, and the gradient against central finite
differences.
"""

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from _torch_golden import vendored

# Gross & Sadowski (2001), Table 1: [m, sigma, eps_k] (tests/test_critical.py)
GS2001 = [[1.0000, 3.7039, 150.03], [2.3316, 3.7086, 222.88], [3.8176, 3.8373, 242.78]]
README_PARAMS = [1.5, 3.5, 250.0, 0.0, 0.03, 1500.0, 1.0, 1.0]
# make_batch(100000, seed=0) row 9482: m near 1 with a strong dipole, where
# both packages' critical Newton fails (as on 4 more rows of that batch)
UNCONVERGED = ft.make_batch(100_000, seed=0)[0][[9482]]
PARAMS = np.concatenate([[r + [0.0] * 5 for r in GS2001], [README_PARAMS], UNCONVERGED])
FAILED = np.array([False] * 4 + [True])
COLUMNS = ["m", "sigma", "epsilon_k", "mu", "kappa_ab", "epsilon_k_ab", "na", "nb"]


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


OUTPUTS = ("nans", "tc", "rho_c", "grad")


def jax_reference():
    """JAX's (nans, T_c, rho_c, d sum(T_c) / d params) on PARAMS."""
    import jax
    import jax.numpy as jnp
    from feos_tpu.models import pcsaft_pure as jpure

    @jax.jit
    def reference(par):
        def loss(q):
            nans, tc, rho_c = jpure.critical_point(q)
            return jnp.sum(jnp.where(nans, 0.0, tc)), (nans, tc, rho_c)

        (_, aux), grad = jax.value_and_grad(loss, has_aux=True)(par)
        return (*aux, grad)

    return {"params": PARAMS, **dict(zip(OUTPUTS, reference(jnp.asarray(PARAMS))))}


@pytest.fixture(scope="module")
def case():
    """(port, jax): each (nans, T_c, rho_c, d sum(T_c) / d params)."""
    p = _t(PARAMS).requires_grad_()
    nans, tc, rho_c = ft.critical_point(p)
    torch.where(nans, 0.0, tc).sum().backward()
    port = (nans.numpy(), tc.detach().numpy(), rho_c.detach().numpy(), p.grad.numpy())
    ref = vendored("critical", exact={"params": PARAMS})
    return port, tuple(ref[k] for k in OUTPUTS)


def test_masks_match_jax(case):
    port, ref = case
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_array_equal(port[0], FAILED)


@pytest.mark.parametrize("j", [1, 2], ids=["T_c", "rho_c"])
def test_values_match_jax(case, j):
    port, ref = case
    np.testing.assert_allclose(port[j], ref[j], rtol=1e-9, atol=0)


@pytest.mark.parametrize("i", range(8), ids=COLUMNS)
def test_gradients_match_jax(case, i):
    """Failed rows get zero gradients on both sides.  T_c does not depend
    on sigma, which scales densities only, so that column is f64 rounding
    noise on both sides (~1e-13 here): each column is also allowed 1e-12 of
    the gradient's largest magnitude."""
    port, ref = case
    np.testing.assert_allclose(port[3][:, i], ref[3][:, i], rtol=1e-8,
                               atol=1e-12 * np.abs(ref[3]).max())


def test_critical_conditions_hold(case):
    """dp~/drho and d2p~/drho2 vanish at the port's states (the first
    analytically, the second by finite differences of the first; neither is
    the solver's own residual path; tests/test_critical.py's bars)."""
    port, _ = case
    p = ft.PureParams.from_numpy(PARAMS[~FAILED], "cpu")
    t = _t(port[1][~FAILED])
    rho = _t(port[2][~FAILED]) * ft.units.KMOL_M3_TO_REDUCED
    with torch.no_grad():
        _, pt, dpt = ft.pure_derivatives(p, t, rho)
        h = 1e-4
        _, _, dpt_p = ft.pure_derivatives(p, t, rho * (1 + h))
        _, _, dpt_m = ft.pure_derivatives(p, t, rho * (1 - h))
    assert torch.all(dpt.abs() / (pt / rho) < 1e-5)
    d2 = (dpt_p - dpt_m) / (2 * h * rho)
    assert torch.all(d2.abs() * rho**2 / pt < 1e-3)


def test_vle_solvable_below_not_above(case):
    port, _ = case
    eos = ft.PcSaftPure(PARAMS[~FAILED], device="cpu")
    with torch.no_grad():
        nans_lo, p_lo = eos.vapor_pressure(port[1][~FAILED] * 0.98)
        nans_hi, _ = eos.vapor_pressure(port[1][~FAILED] * 1.03)
    assert not nans_lo.any() and torch.isfinite(p_lo).all()
    assert nans_hi.all()


def test_gradients_central_fd():
    """d T_c / d params of the README row against central differences at
    the JAX package's steps (tests/test_critical.py), rows in one batch."""
    steps = ((0, 1e-5), (2, 1e-3), (5, 1e-2))
    rows = [np.asarray(README_PARAMS)]
    for j, h in steps:
        for sign in (1.0, -1.0):
            q = rows[0].copy()
            q[j] += sign * h
            rows.append(q)
    params = _t(np.stack(rows)).requires_grad_()
    nans, tc, _ = ft.critical_point(params)
    assert not nans.any()
    tc[0].backward()
    tc, grad = tc.detach().numpy(), params.grad[0].numpy()
    for n, (j, h) in enumerate(steps):
        fd = (tc[1 + 2 * n] - tc[2 + 2 * n]) / (2 * h)
        np.testing.assert_allclose(grad[j], fd, rtol=2e-5, err_msg=COLUMNS[j])


def test_solver_stats_and_facade():
    """``pure_critical`` reports its one phi_d2 call (the eta-grid scan) and
    its Newton iterations; the facade returns (nans, T_c, rho_c)."""
    stats = {}
    with torch.no_grad():
        rho_c, t_c, ok = ft.pure_critical(_t(PARAMS[:1]), stats=stats)
        nans, tc, rc = ft.PcSaftPure(PARAMS[:1], device="cpu").critical_point()
    assert ok.all() and stats["phi_d2_calls"] == 1 and 0 < stats["newton"] < 60
    assert float(tc[0]) == pytest.approx(float(t_c[0]), rel=1e-9)
    # methane: rho_c ~ 10 kmol/m^3 (exp. 10.1); a classical EOS overshoots
    assert 7.0 < float(rc[0]) < 15.0 and not nans.any()
