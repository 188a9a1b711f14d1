"""The port's NPT solve and liquid densities against the JAX package.

``npt_density`` against JAX ``npt_density(mixed_precision=False)``;
``liquid_density`` and ``equilibrium_liquid_density`` values and parameter
gradients against the JAX package's shipped functions and against JAX's f64
gradient of the same re-attachment identity at the port's densities; central
finite differences; the reference's 6-row grid against the C++ oracle.  The
JAX side runs once, in one jitted function of one fixed shape.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_oracle import backend  # noqa: F401 (a fixture)
import feos_tpu_torch as ft
from feos_tpu.models import pcsaft_pure as jpure
from feos_tpu.solvers.vle import npt_density as jax_npt_density
from feos_tpu.units import KMOL_M3_TO_REDUCED, PA_PER_KT_TO_REDUCED

# the reference's 6-row parameter grid and README example
# (tests/test_pcsaft_pure.py: REFERENCE_GRID, README_PARAMS)
REFERENCE_GRID = [
    [1.5, 3.2, 350, 0, 0, 0, 0, 0],
    [1.5, 3.2, 150, 2.5, 0.03, 2500, 2, 1],
    [1.5, 3.2, 150, 2.5, 0, 2500, 1, 1],
    [1.5, 3.2, 150, 2.5, 0.03, 0, 1, 1],
    [1.5, 3.2, 150, 2.5, 0, 0, 0, 0],
    [1.5, 3.2, 150, 2.5, 0.03, 2500, 0, 2],
]
README_PARAMS = [1.5, 3.5, 250.0, 0.0, 0.03, 1500.0, 1.0, 1.0]
COLUMNS = ["m", "sigma", "epsilon_k", "mu", "kappa_ab", "epsilon_k_ab", "na", "nb"]


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _log_loss(nans, rho):
    """sum of log rho over the converged rows."""
    return torch.where(nans, 0.0, torch.log(torch.where(nans, 1.0, rho))).sum()


def _inputs():
    """make_batch(64, seed=5) at seeded pressures from 1 kPa to 10 MPa, and
    the reference grid at 300 K and 1e5 Pa."""
    params, temperature = ft.make_batch(64, seed=5)
    pressure = np.geomspace(1e3, 1e7, 64)[np.random.default_rng(5).permutation(64)]
    params = np.concatenate([params, REFERENCE_GRID])
    temperature = np.concatenate([temperature, np.full(6, 300.0)])
    pressure = np.concatenate([pressure, np.full(6, 1e5)])
    return params, temperature, pressure


def _port(fn, params, *args):
    """``(nans, values, d sum(log values) / d params)`` through the port."""
    p = _t(params).requires_grad_()
    nans, rho = fn(p, *(_t(a) for a in args))
    _log_loss(nans, rho).backward()
    return nans.numpy(), rho.detach().numpy(), p.grad.numpy()


@pytest.fixture(scope="module")
def case():
    """Inputs, the port's results and, from one jit, JAX's."""
    params, temperature, pressure = _inputs()
    p_red = pressure / temperature * PA_PER_KT_TO_REDUCED
    port = {
        "liquid": _port(ft.liquid_density, params, temperature, pressure),
        "equilibrium": _port(ft.equilibrium_liquid_density, params, temperature),
    }
    with torch.no_grad():
        rho, ok = ft.npt_density(_t(params), _t(temperature), _t(p_red))
        port["npt"] = (ok.numpy(), rho.numpy())
        rho_v, rho_l, ok_vle = ft.pure_vle(_t(params), _t(temperature))
    # the port's solved densities, sanitised as the port sanitises them
    rho_npt = np.where(port["npt"][0], port["npt"][1], 1e-3)
    rho_v = np.where(ok_vle, rho_v.numpy(), 1e-5)
    rho_l = np.where(ok_vle, rho_l.numpy(), 1e-3)

    @jax.jit
    def reference(par, t, pres, pr, r_npt, ok_npt, rv, rl, ok_eq):
        def shipped(fn, *args):
            def loss(q):
                nans, rho = fn(q, *args)
                return jnp.sum(jnp.where(nans, 0.0, jnp.log(jnp.where(nans, 1.0, rho)))), (nans, rho)

            (_, (nans, rho)), grad = jax.value_and_grad(loss, has_aux=True)(par)
            return nans, rho, grad

        def liquid_identity(q):
            _, pt, dpt = jax.vmap(jpure.pure_derivatives)(jpure.PureParams.from_array(q), t, r_npt)
            rho = r_npt - (pt - pr) / dpt
            return jnp.sum(jnp.where(ok_npt, jnp.log(rho / KMOL_M3_TO_REDUCED), 0.0))

        def equilibrium_identity(q):
            pp = jpure.PureParams.from_array(q)
            a_l, p_l, dp_l = jax.vmap(jpure.pure_derivatives)(pp, t, rl)
            a_l = a_l / rl
            a_v = jax.vmap(jpure.phi_pure)(pp, t, rv) / rv
            p_eq = -(a_v - a_l + jnp.log(rv / rl)) / (1.0 / rv - 1.0 / rl)
            rho = rl - (p_l - p_eq) / dp_l
            return jnp.sum(jnp.where(ok_eq, jnp.log(rho / KMOL_M3_TO_REDUCED), 0.0))

        pp = jpure.PureParams.from_array(par)
        return {
            "liquid": shipped(jpure.liquid_density, t, pres),
            "equilibrium": shipped(jpure.equilibrium_liquid_density, t),
            # forward mode: the same f64 derivative, cheaper to compile
            "liquid_identity": jax.jacfwd(liquid_identity)(par),
            "equilibrium_identity": jax.jacfwd(equilibrium_identity)(par),
            "npt": jax.vmap(lambda q, tt, x: jax_npt_density(
                q, tt, x, liquid=True, mixed_precision=False))(pp, t, pr),
        }

    ref = reference(*(jnp.asarray(x) for x in (
        params, temperature, pressure, p_red, rho_npt, port["npt"][0],
        rho_v, rho_l, ok_vle.numpy(),
    )))
    ref = jax.tree_util.tree_map(np.asarray, ref)
    return port, ref


# -- npt_density ---------------------------------------------------------------


def test_npt_density_matches_jax_f64(case):
    """The liquid branch against JAX ``npt_density(mixed_precision=False)``."""
    port, ref = case
    ok, rho = port["npt"]
    jrho, jok = ref["npt"]
    np.testing.assert_array_equal(ok, jok)
    assert ok.sum() > 40
    np.testing.assert_allclose(rho[ok], jrho[ok], rtol=1e-10, atol=0)


def test_npt_density_branches_at_vapor_pressure():
    """At p_sat the liquid branch finds the VLE's liquid and the vapor
    branch its vapor (both at rtol 1e-10)."""
    params, temperature = (_t(x) for x in ft.make_batch(16, seed=7))
    with torch.no_grad():
        rho_v, rho_l, ok = ft.pure_vle(params, temperature)
        _, vp = ft.vapor_pressure(params, temperature)
        p_red = vp / temperature * PA_PER_KT_TO_REDUCED
        stats = {}
        liq, ok_l = ft.npt_density(params, temperature, p_red, stats=stats)
        vap, ok_v = ft.npt_density(params, temperature, p_red, liquid=False)
    assert ok.all() and ok_l.all() and ok_v.all()
    assert stats["phi_d2_calls"] == stats["npt"] > 0
    np.testing.assert_allclose(liq.numpy(), rho_l.numpy(), rtol=1e-10, atol=0)
    np.testing.assert_allclose(vap.numpy(), rho_v.numpy(), rtol=1e-10, atol=0)


# -- liquid_density and equilibrium_liquid_density ----------------------------


KINDS = ["liquid", "equilibrium"]


@pytest.mark.parametrize("kind", KINDS)
def test_values_match_jax(case, kind):
    """Values on the rows both accept.  The JAX package's shipped solve
    starts in f32, so a boundary row may be accepted by one side only
    (ROADMAP C, known fault 4): on these rows there is none."""
    port, ref = case
    nans, rho, _ = port[kind]
    jnans, jrho, _ = ref[kind]
    disagree = int((nans != jnans).sum())
    assert disagree == 0, f"{disagree} mask disagreements"
    both = ~nans & ~jnans
    assert both.sum() > 40
    np.testing.assert_allclose(rho[both], jrho[both], rtol=1e-9, atol=0)


def _assert_gradients_close(got, want, rtol):
    """The make_batch rows (na = nb) at ``rtol``.  The reference grid's
    one-sided (na = 0) and asymmetric (na = 2, nb = 1) association rows are
    ill-conditioned in f64 (ROADMAP C, the one-sided association fault):
    exact zeros come out as rounding noise (up to 2e-12 of the column's
    largest magnitude here) and sums lose digits, so those rows are also
    allowed 1e-11 of it."""
    np.testing.assert_allclose(got[:64], want[:64], rtol=rtol, atol=0)
    np.testing.assert_allclose(got[64:], want[64:], rtol=rtol,
                               atol=1e-11 * np.abs(want).max())


@pytest.mark.parametrize("i", range(8), ids=COLUMNS)
@pytest.mark.parametrize("kind", KINDS)
def test_gradients_match_jax_identity_f64(case, kind, i):
    """Against JAX's f64 derivative of the same identity at the port's
    densities: both sides differentiate the same function exactly."""
    port, ref = case
    _assert_gradients_close(port[kind][2][:, i], ref[kind + "_identity"][:, i], 1e-12)


@pytest.mark.parametrize("i", range(8), ids=COLUMNS)
@pytest.mark.parametrize("kind", KINDS)
def test_gradients_match_jax_shipped(case, kind, i):
    """Against the JAX package's shipped gradient, whose parameter tangents
    are f64 for these second-order identities."""
    port, ref = case
    _assert_gradients_close(port[kind][2][:, i], ref[kind][2][:, i], 1e-8)


# central finite differences, parameters and relative steps of the JAX
# package's own check (tests/test_pcsaft_pure.py::test_gradients_fd)
FD = {
    "liquid": ([1.5, 3.2, 150, 2.5, 0.03, 2500, 1, 1], 5e-9),
    "equilibrium": ([1.5, 3.2, 150, 2.5, 0.03, 2500, 2, 1], 5e-7),
}


@pytest.mark.parametrize("kind", KINDS)
def test_gradients_central_fd(kind):
    """Rows p, p + h_i e_i, p - h_i e_i (i < 6) in one batch at 300 K (and
    1e5 Pa); the gradient of row 0 comes from the same solve."""
    row, h = FD[kind]
    p0 = np.asarray(row, dtype=np.float64)
    rows = [p0]
    for i in range(6):
        for sign in (1.0, -1.0):
            q = p0.copy()
            q[i] += sign * p0[i] * h
            rows.append(q)
    params = _t(np.stack(rows)).requires_grad_()
    t = _t(np.full(len(rows), 300.0))
    if kind == "liquid":
        nans, rho = ft.liquid_density(params, t, _t(np.full(len(rows), 1e5)))
    else:
        nans, rho = ft.equilibrium_liquid_density(params, t)
    assert not nans.any()
    rho[0].backward()
    rho, grad = rho.detach().numpy(), params.grad[0].numpy()
    for i in range(6):
        fd_i = (rho[1 + 2 * i] - rho[2 + 2 * i]) / (2 * row[i] * h)
        assert abs((fd_i - grad[i]) / grad[i]) < 1e-4, (i, fd_i, grad[i])


def test_reference_grid_vs_cpp_oracle(backend):
    """The reference grid at 300 K and 1e5 Pa against the independent C++
    oracle (the JAX package's bars: liquid 1e-9, equilibrium 1e-8)."""
    params = np.asarray(REFERENCE_GRID, dtype=np.float64)
    t, p = np.full(6, 300.0), np.full(6, 1e5)
    with torch.no_grad():
        nans, rho_l = ft.liquid_density(_t(params), _t(t), _t(p))
        nans_eq, rho_eq = ft.equilibrium_liquid_density(_t(params), _t(t))
    assert not nans.any() and not nans_eq.any()
    rho_l_cpp, ok = backend.liquid_density_reduced(params, t, p)
    assert ok.all()
    np.testing.assert_allclose(rho_l.numpy(), rho_l_cpp / KMOL_M3_TO_REDUCED, rtol=1e-9)
    rho_cpp, ok = backend.vapor_pressure_densities(params, t)
    assert ok.all()
    np.testing.assert_allclose(rho_eq.numpy(), rho_cpp[:, 1] / KMOL_M3_TO_REDUCED, rtol=1e-8)


def test_liquid_at_vapor_pressure_equals_equilibrium():
    eos = ft.PcSaftPure(np.tile(README_PARAMS, (3, 1)), device="cpu")
    t = [250.0, 300.0, 350.0]
    with torch.no_grad():
        _, vp = eos.vapor_pressure(t)
        nans_eq, rho_eq = eos.equilibrium_liquid_density(t)
        nans, rho = eos.liquid_density(t, vp)
    assert not nans.any() and not nans_eq.any()
    np.testing.assert_allclose(rho.numpy(), rho_eq.numpy(), rtol=1e-9)


@pytest.mark.parametrize("kind", KINDS)
def test_gradients_finite_with_supercritical_row(kind):
    """A 2000 K row in the batch leaves the batch gradient finite."""
    p0 = _t(README_PARAMS).requires_grad_()
    t = _t([300.0, 2000.0, 350.0])
    if kind == "liquid":
        nans, rho = ft.liquid_density(p0.expand(3, 8), t, _t([1e5, 1e5, 1e5]))
    else:
        nans, rho = ft.equilibrium_liquid_density(p0.expand(3, 8), t)
        assert nans.tolist() == [False, True, False]
    loss = torch.where(nans, 0.0, rho).sum()
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(p0.grad).all()
