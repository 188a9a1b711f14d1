"""The port's mixture residual properties against the JAX package, and the
thermodynamic consistency checks of tests/test_properties.py.

The 14 golden mixture regimes (tests/golden/mix_helmholtz.json: plain,
polar, self-, cross- and induced-associating, with and without an
eps_AiBj override) at the golden density and at a tenth of it go through
the port's ``mix_properties`` and JAX's ``mix_properties``: every field at
1e-10, so Phi_T, Phi_TT and S1_T through the association fixed points are
held to JAX's forward-mode derivatives in every regime.  The rest holds the
port on its own, as tests/test_properties.py:73-168 holds JAX: s_res and
c_v_res against central differences in T, Clausius-Clapeyron and
isofugacity at solved pure equilibria, c_p_res along an isobar, an
identical-species binary against the pure fluid, the ideal-gas limit.
JAX's ``mix_properties`` compiles for about 30 s on a CPU, so
``tools/gen_port_fixtures.py`` writes its fields to
``tests/golden/torch_mix_properties_jax.npz``.  The gc properties are in
test_torch_gc_properties.py.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from _torch_golden import vendored
from feos_tpu_torch.units import ANGSTROM, KB, KMOL_M3_TO_REDUCED, NAV, RGAS

GOLDEN = json.loads((Path(__file__).resolve().parent / "golden" / "mix_helmholtz.json")
                    .read_text())
FIELDS = ft.ResidualProperties._fields
ASSOC_PARAMS = [1.5, 3.5, 250.0, 0.0, 0.03, 1500.0, 1.0, 1.0]


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _states():
    """The golden rows at the golden density (where Z <= 0 on some rows, so
    ln phi is NaN in both packages) and at a tenth of it (Z > 0 on all)."""
    n = len(GOLDEN["params"])
    params = np.tile(np.asarray(GOLDEN["params"]), (2, 1, 1))
    kij = np.tile(np.asarray(GOLDEN["kij"]), (2, 1))
    density = np.concatenate([np.tile(GOLDEN["density"], (n, 1)),
                              0.1 * np.tile(GOLDEN["density"], (n, 1))])
    return params, kij, np.full(2 * n, GOLDEN["temperature"]), density


STATE_KEYS = ("params", "kij", "t", "rho")


def jax_reference():
    """JAX's ``mix_properties`` on :func:`_states`."""
    from feos_tpu.properties import mix_properties as jax_mix_properties

    states = _states()
    ref = jax_mix_properties(*states)
    return {**dict(zip(STATE_KEYS, states)), **{f: getattr(ref, f) for f in FIELDS}}


@pytest.fixture(scope="module")
def case():
    states = _states()
    with torch.no_grad():
        port = ft.mix_properties(*(_t(x) for x in states))
    ref = vendored("mix_properties", exact=dict(zip(STATE_KEYS, states)))
    return ({f: getattr(port, f).numpy() for f in FIELDS}, {f: ref[f] for f in FIELDS})


@pytest.mark.parametrize("field", FIELDS)
def test_fields_match_jax(case, field):
    port, ref = case
    assert port[field].shape == ref[field].shape
    finite = port["compressibility"] > 0.0 if field == "ln_phi" else slice(None)
    assert np.all(np.isfinite(port[field][finite]))
    np.testing.assert_allclose(port[field], ref[field], rtol=1e-10, atol=0)


def _fd_temperature(props, a_molar, temperature):
    """s_res and c_v_res against central differences (h = 1e-5 K) of the
    molar Helmholtz energy and of u_res = -R T^2 d(a/RT)/dT at rtol 2e-4
    (tests/test_properties.py's bar)."""
    h = 1e-5
    s_fd = -(a_molar(temperature + h) - a_molar(temperature - h)) / (2 * h)
    np.testing.assert_allclose(props.s_res.numpy(), s_fd.numpy(), rtol=2e-4)

    def u_molar(t):
        t = t.clone().requires_grad_()
        (a_t,) = torch.autograd.grad((a_molar(t) / (RGAS * t)).sum(), t)
        return -RGAS * t.detach() ** 2 * a_t

    cv_fd = (u_molar(temperature + h) - u_molar(temperature - h)) / (2 * h)
    np.testing.assert_allclose(props.c_v_res.numpy(), cv_fd.numpy(), rtol=2e-4)


def test_fd_temperature_all_regimes():
    """tests/test_properties.py::test_mix_fd_temperature_all_regimes."""
    params, kij, temperature, density = (_t(x) for x in _states())
    with torch.no_grad():
        props = ft.mix_properties(params, kij, temperature, density)
    assert torch.isfinite(props.c_p_res).all()

    def a_molar(t):
        return RGAS * t * ft.mix_helmholtz_energy_density(params, kij, t, density) \
            / density.sum(1)

    _fd_temperature(props, a_molar, temperature)


def test_clapeyron_and_isofugacity():
    """dp_sat/dT (autograd through the port's vapor pressure) against ds/dv
    from the residual entropies, and ln phi_V = ln phi_L, at solved pure
    equilibria (tests/test_properties.py::test_clapeyron_and_isofugacity)."""
    params = _t(np.tile(ASSOC_PARAMS, (3, 1)))
    t = _t([300.0, 350.0, 400.0]).requires_grad_()
    nans, vp = ft.vapor_pressure(params, t)
    vp.sum().backward()
    dp_dt = t.grad
    with torch.no_grad():
        rv, rl, ok = ft.pure_vle(params, t.detach())
        assert ok.all() and not nans.any()
        pv = ft.pure_properties(params, t.detach(), rv)
        pl = ft.pure_properties(params, t.detach(), rl)
    ds = (pv.s_res - pl.s_res) / NAV - KB * torch.log(rv / rl)
    dv = (1.0 / rv - 1.0 / rl) * ANGSTROM**3
    np.testing.assert_allclose(dp_dt.numpy(), (ds / dv).numpy(), rtol=1e-7)
    np.testing.assert_allclose(pv.ln_phi.numpy(), pl.ln_phi.numpy(), rtol=0, atol=1e-8)


def test_cp_isobaric_fd():
    """c_p_res = (dh_res/dT)_p with the liquid density re-solved at each
    temperature (tests/test_properties.py::test_cp_isobaric_fd)."""
    params = _t(np.tile(ASSOC_PARAMS, (3, 1)))
    temperature, p = _t([300.0, 320.0, 340.0]), _t(np.full(3, 5e6))

    def props_at(t):
        with torch.no_grad():
            nans, rho = ft.liquid_density(params, t, p)
            assert not nans.any()
            return ft.pure_properties(params, t, rho * KMOL_M3_TO_REDUCED)

    h = 1e-3
    cp_fd = (props_at(temperature + h).h_res - props_at(temperature - h).h_res) / (2 * h)
    np.testing.assert_allclose(props_at(temperature).c_p_res.numpy(), cp_fd.numpy(),
                               rtol=1e-4)


def test_pure_vs_mix_consistency():
    """An identical-species equimolar binary reproduces the pure fluid,
    through two code paths (tests/test_properties.py's rtol 2e-6); its two
    fugacity coefficients are the pure one's."""
    t = _t([300.0])
    with torch.no_grad():
        pm = ft.mix_properties(_t([[ASSOC_PARAMS, ASSOC_PARAMS]]), None, t, _t([[5e-3, 5e-3]]))
        pp = ft.pure_properties(_t([ASSOC_PARAMS]), t, _t([1e-2]))
    for field in ["pressure", "s_res", "h_res", "u_res", "c_v_res", "c_p_res"]:
        np.testing.assert_allclose(getattr(pm, field).numpy(), getattr(pp, field).numpy(),
                                   rtol=2e-6, err_msg=field)
    np.testing.assert_allclose(pm.ln_phi.numpy(), np.tile(pp.ln_phi.numpy(), 2)[None],
                               rtol=2e-6)


def test_ideal_gas_limit():
    """Z -> 1 and every residual -> 0 as the density goes to 0, in every
    golden regime."""
    params, kij, temperature, _ = _states()
    with torch.no_grad():
        props = ft.mix_properties(_t(params), _t(kij), _t(temperature),
                                  _t(np.full((len(params), 2), 1e-18)))
    np.testing.assert_allclose(props.compressibility.numpy(), 1.0, rtol=0, atol=1e-10)
    for field in ["s_res", "h_res", "c_v_res", "c_p_res", "ln_phi"]:
        np.testing.assert_allclose(getattr(props, field).numpy(), 0.0, rtol=0, atol=1e-7,
                                   err_msg=field)


@pytest.mark.parametrize("wrt", ["params", "kij"])
def test_gradient_central_fd(wrt):
    """d(s_res + c_p_res + ln phi) in epsilon_k of component 0 and in
    eps_AiBj, on the cross-associating golden row with an override ('a/a
    k'), against central differences (relative step 1e-6)."""
    row = GOLDEN["labels"].index("a/a k")
    params = np.asarray(GOLDEN["params"])[row:row + 1]
    kij = np.asarray(GOLDEN["kij"])[row:row + 1]
    t, rho = _t([300.0]), 0.01 * _t([GOLDEN["density"]])  # Z > 0 there

    def loss(p, k):
        props = ft.mix_properties(p, k, t, rho)
        return props.s_res.sum() + props.c_p_res.sum() + props.ln_phi.sum()

    p_in, k_in = _t(params).requires_grad_(), _t(kij).requires_grad_()
    loss(p_in, k_in).backward()
    base, i = (params, (0, 0, 2)) if wrt == "params" else (kij, (0, 1))
    got = (p_in if wrt == "params" else k_in).grad.numpy()[i]
    h = 1e-6 * base[i]
    f = []
    for sign in (1.0, -1.0):
        x = base.copy()
        x[i] += sign * h
        with torch.no_grad():
            f.append(float(loss(_t(x), _t(kij)) if wrt == "params" else loss(_t(params), _t(x))))
    assert got != 0.0
    np.testing.assert_allclose(got, (f[0] - f[1]) / (2 * h), rtol=1e-6)


def test_facade_matches_functional(case):
    port, _ = case
    params, kij, temperature, density = _states()
    with torch.no_grad():
        props = ft.PcSaftMix(params, kij, device="cpu").residual_properties(temperature,
                                                                            density)
    for f in FIELDS:
        assert not getattr(props, f).requires_grad
        np.testing.assert_array_equal(getattr(props, f).numpy(), port[f])
