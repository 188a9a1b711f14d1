"""The port's gc residual properties against the JAX package.

The 11 golden topologies (tests/golden/gc_helmholtz.json: plain, branched,
polar, self-, cross- and induced-associating) at the golden density and at
a tenth of it: JAX assembles their parameters (tests/conftest.py's
``golden_gc_eos``), ``GcParams.from_numpy`` carries them into the port, and
every field of the port's ``gc_properties`` is held to JAX's at 1e-10.
JAX's ``gc_properties`` compiles for about 20 s on a CPU, so
``tools/gen_port_fixtures.py`` writes its fields, with the parameters JAX
assembled, to ``tests/golden/torch_gc_properties_jax.npz``.
s_res and c_v_res against central differences in T, the ideal-gas limit,
the k_ab and phi gradients against central differences and the facade hold
the port on its own.
"""

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from _torch_golden import unflat, vendored
from test_torch_gc_eos import GOLDEN, IDENT, PARAMETER, _t, parameter_tuple
from feos_tpu_torch.units import RGAS
from test_torch_mix_properties import FIELDS, _fd_temperature

N = len(GOLDEN["labels"])


def _state():
    temperature = np.full(2 * N, GOLDEN["temperature"])
    rho = np.tile(GOLDEN["density"], (N, 1))
    return temperature, np.concatenate([rho, 0.1 * rho])


def golden_model(phi=None, records=None):
    """The port's facade on the golden topologies, twice over."""
    records = [tuple(k) for k in GOLDEN["kab_list"]] if records is None else records
    phi = np.tile(GOLDEN["phi"], (2, 1)) if phi is None else phi
    return ft.GcPcSaftMix(IDENT, parameter_tuple(PARAMETER), GOLDEN["segment_lists"] * 2,
                          GOLDEN["bond_lists"] * 2, records, phi, device="cpu")


def jax_reference():
    """The parameters JAX assembles for the golden topologies
    (``tests/conftest.py``'s ``golden_gc_eos``), and JAX's ``gc_properties``
    on them at :func:`_state`."""
    from _torch_golden import flat
    from feos_tpu.models.gc_pcsaft import GcPcSaftMix
    from feos_tpu.properties import gc_properties as jax_gc_properties

    eos = GcPcSaftMix(IDENT, parameter_tuple(PARAMETER), GOLDEN["segment_lists"],
                      GOLDEN["bond_lists"], [tuple(k) for k in GOLDEN["kab_list"]],
                      np.array(GOLDEN["phi"]))
    temperature, rho = _state()
    ref = jax_gc_properties(eos.params, temperature[:N], rho[:N]), \
        jax_gc_properties(eos.params, temperature[N:], rho[N:])
    return {"t": temperature, "rho": rho, **flat("params", eos.params),
            **{f: np.concatenate([np.asarray(getattr(r, f)) for r in ref]) for f in FIELDS}}


@pytest.fixture(scope="module")
def case():
    temperature, rho = _state()
    ref = vendored("gc_properties", exact={"t": temperature, "rho": rho})
    params = ft.GcParams.from_numpy(unflat(ref, "params"), device="cpu")
    params = ft.GcParams(*(torch.cat([x, x]) if x.dim() > 1 and x.shape[0] == N else x
                           for x in params))
    with torch.no_grad():
        port = ft.gc_properties(params, _t(temperature), _t(rho))
    return ({f: getattr(port, f).numpy() for f in FIELDS}, {f: ref[f] for f in FIELDS})


@pytest.mark.parametrize("field", FIELDS)
def test_fields_match_jax(case, field):
    port, ref = case
    assert port[field].shape == ref[field].shape
    finite = port["compressibility"] > 0.0 if field == "ln_phi" else slice(None)
    assert np.all(np.isfinite(port[field][finite]))
    np.testing.assert_allclose(port[field], ref[field], rtol=1e-10, atol=0)


def test_fd_temperature_all_topologies():
    """tests/test_properties.py::test_gc_fd_temperature_all_topologies."""
    eos = golden_model()
    temperature, rho = (_t(x) for x in _state())
    with torch.no_grad():
        props = eos.residual_properties(temperature, rho)
    params = eos.params.detach()
    assert torch.isfinite(props.c_p_res).all()

    def a_molar(t):
        return RGAS * t * ft.gc_helmholtz_energy_density(params, t, rho) / rho.sum(1)

    _fd_temperature(props, a_molar, temperature)


def test_ideal_gas_limit():
    with torch.no_grad():
        props = golden_model().residual_properties(np.full(2 * N, 300.0),
                                                   np.full((2 * N, 2), 1e-18))
    np.testing.assert_allclose(props.compressibility.numpy(), 1.0, rtol=0, atol=1e-10)
    for field in ["s_res", "h_res", "c_v_res", "c_p_res", "ln_phi"]:
        np.testing.assert_allclose(getattr(props, field).numpy(), 0.0, rtol=0, atol=1e-7,
                                   err_msg=field)


@pytest.mark.parametrize("wrt", ["k_ab", "phi"])
def test_gradient_central_fd(wrt):
    """d(s_res + c_p_res + ln phi, summed over the states where Z > 0) in
    the first k_ab value and in phi of the vapor-like 'ap/ap' row against
    central differences (relative step 1e-6)."""
    temperature, rho = (_t(x) for x in _state())

    def loss(**kw):
        eos = golden_model(**kw)
        props = eos.residual_properties(temperature, rho)
        ln_phi = torch.where((props.compressibility > 0.0)[:, None], props.ln_phi, 0.0)
        return props.s_res.sum() + props.c_p_res.sum() + ln_phi.sum(), eos

    value, eos = loss()
    value.backward()
    records = [tuple(k) for k in GOLDEN["kab_list"]]
    phi = np.tile(GOLDEN["phi"], (2, 1))
    row = N + GOLDEN["labels"].index("ap/ap")
    if wrt == "k_ab":
        got, k0 = eos.kab.grad[0].item(), records[0][2]
        h = 1e-6 * abs(k0)

        def at(sign):
            rec = [(records[0][0], records[0][1], k0 + sign * h)] + records[1:]
            return loss(records=rec)[0]
    else:
        got, h = eos.phi.grad[row, 0].item(), 1e-6

        def at(sign):
            p = phi.copy()
            p[row, 0] += sign * h
            return loss(phi=p)[0]

    with torch.no_grad():
        fd = (float(at(1.0)) - float(at(-1.0))) / (2 * h)
    assert got != 0.0
    np.testing.assert_allclose(got, fd, rtol=1e-6)


def test_facade_matches_functional(case):
    """The facade's fields, detached under no_grad, equal the functional
    form's on parameters JAX assembled."""
    port, _ = case
    temperature, rho = _state()
    with torch.no_grad():
        props = golden_model().residual_properties(temperature, rho)
    for f in FIELDS:
        assert not getattr(props, f).requires_grad
        np.testing.assert_allclose(getattr(props, f).numpy(), port[f], rtol=1e-12, atol=0)
