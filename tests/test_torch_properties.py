"""The port's residual property set against the JAX package.

The golden parameter rows (tests/golden/pure_helmholtz.json) at a liquid
and a vapour packing fraction go through the port's ``pure_properties`` and,
in one jit, through the JAX package's ``pure_properties`` (and
``mu_res_pure``); the parameter
gradient against central finite differences, the ideal-gas limit and the
facade.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from feos_tpu.models.pcsaft_pure import PureParams as JaxParams
from feos_tpu.models.pcsaft_pure import mu_res_pure as jax_mu_res_pure
from feos_tpu.properties import _pure_impl as jax_pure_properties

GOLDEN = Path(__file__).resolve().parent / "golden" / "pure_helmholtz.json"
ETAS = (0.45, 1e-3)  # liquid- (Z > 0 on every row) and vapour-like packing fractions
FIELDS = ft.ResidualProperties._fields


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _inputs():
    """Each golden row at the golden temperature, at both packing fractions."""
    d = json.loads(GOLDEN.read_text())
    params = np.asarray(d["params"], dtype=np.float64)
    n = len(params)
    temperature = np.full(n, d["temperature"])
    with torch.no_grad():
        eta_m = ft.precompute_pure(ft.PureParams.from_numpy(params, "cpu"),
                                   _t(temperature)).eta_m.numpy()
    density = np.concatenate([eta / eta_m for eta in ETAS])
    return np.concatenate([params, params]), np.tile(temperature, 2), density


@pytest.fixture(scope="module")
def case():
    params, temperature, density = _inputs()
    with torch.no_grad():
        props = ft.pure_properties(_t(params), _t(temperature), _t(density))
        port = {f: getattr(props, f).numpy() for f in FIELDS}
        port["mu_res"] = ft.mu_res_pure(ft.PureParams.from_numpy(params, "cpu"),
                                        _t(temperature), _t(density)).numpy()

    @jax.jit
    def reference(p, t, rho):
        props = jax_pure_properties(p, t, rho)
        out = {f: getattr(props, f) for f in FIELDS}
        out["mu_res"] = jax.vmap(jax_mu_res_pure)(p, t, rho)
        return out

    ref = reference(JaxParams.from_array(jnp.asarray(params)), jnp.asarray(temperature),
                    jnp.asarray(density))
    return port, {k: np.asarray(v) for k, v in ref.items()}


@pytest.mark.parametrize("field", FIELDS + ("mu_res",))
def test_fields_match_jax(case, field):
    port, ref = case
    assert np.all(np.isfinite(port[field]))
    np.testing.assert_allclose(port[field], ref[field], rtol=1e-10, atol=0)


def _loss(props):
    """A sum of fields whose gradient reaches every derivative order."""
    return props.s_res.sum() + props.c_p_res.sum() + props.ln_phi.sum()


@pytest.mark.parametrize("j", [0, 2, 5], ids=["m", "epsilon_k", "epsilon_k_ab"])
def test_parameter_gradient_central_fd(j):
    """The gradient of s_res + c_p_res + ln phi at a liquid and a vapour
    state of the README row against central differences (relative step
    1e-6)."""
    row = np.array([1.5, 3.5, 250.0, 0.0, 0.03, 1500.0, 1.0, 1.0])
    t = _t([300.0, 300.0])
    p = _t(np.tile(row, (2, 1))).requires_grad_()
    with torch.no_grad():
        eta_m = ft.precompute_pure(ft.PureParams.from_tensor(p), t).eta_m
    rho = _t(ETAS) / eta_m
    _loss(ft.pure_properties(p, t, rho)).backward()
    h = row[j] * 1e-6
    with torch.no_grad():
        f = []
        for sign in (1.0, -1.0):
            q = np.tile(row, (2, 1))
            q[:, j] += sign * h
            f.append(float(_loss(ft.pure_properties(_t(q), t, rho))))
    np.testing.assert_allclose(float(p.grad[:, j].sum()), (f[0] - f[1]) / (2 * h), rtol=1e-6)


def test_ideal_gas_limit():
    """Z -> 1 and every residual -> 0 as rho -> 0 (tests/test_properties.py)."""
    params = _t(np.tile([1.5, 3.5, 250.0, 0.0, 0.03, 1500.0, 1.0, 1.0], (2, 1)))
    with torch.no_grad():
        props = ft.pure_properties(params, _t([300.0, 400.0]), _t([1e-14, 1e-14]))
    np.testing.assert_allclose(props.compressibility.numpy(), 1.0, rtol=0, atol=1e-10)
    for field in ["s_res", "h_res", "c_v_res", "c_p_res", "ln_phi"]:
        np.testing.assert_allclose(getattr(props, field).numpy(), 0.0, rtol=0, atol=1e-7,
                                   err_msg=field)


def test_identities_and_facade(case):
    """g = h - T s, the pressure is the port's p~ (pure_derivatives), and
    the facade and no-grad calls give the same fields, detached."""
    port, _ = case
    params, temperature, density = _inputs()
    np.testing.assert_allclose(port["g_res"], port["h_res"] - temperature * port["s_res"],
                               rtol=1e-10, atol=1e-8)
    with torch.no_grad():
        _, pt, _ = ft.pure_derivatives(ft.PureParams.from_numpy(params, "cpu"),
                                       _t(temperature), _t(density))
        props = ft.PcSaftPure(params, device="cpu").residual_properties(temperature, density)
    np.testing.assert_allclose(port["pressure"],
                               pt.numpy() * temperature * ft.units.REDUCED_TO_PA_PER_KT,
                               rtol=1e-12)
    for f in FIELDS:
        assert not getattr(props, f).requires_grad
        np.testing.assert_array_equal(getattr(props, f).numpy(), port[f])
