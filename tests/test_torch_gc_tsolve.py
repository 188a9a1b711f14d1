"""The port's gc bubble and dew temperatures against the JAX package and
finite differences.

Four rows of one ``GcPcSaftMix``: n-butane/propane (tests/test_tsolve.py's
gc system) twice, and two golden topologies with association, 'a/np'
(self) and 'a/a' (cross), with k_ab records on (CH3, CH2) and (>CH, >C<)
and phi.  The port's own bubble (dew) pressures at chosen temperatures are
the targets; the temperature solves from 1.05 T recover T.  JAX's
``gc_incipient_property`` solves the bubble pressures at the port's bubble
temperatures of the butane/propane rows, on parameters that JAX assembles
and ``GcParams.from_numpy`` carries into the port (the round trip at 1e-9,
the vapor composition at 1e-8, equal masks); JAX's dew solver would add
about 15 s of compile to this file, and the dew temperature runs the same
code as the mixture's, which test_torch_mix_tsolve.py holds to JAX's
``dew_point``.  Gradients in k_ab, the
segment parameters and phi are held to central differences and to the
implicit-function identity at the re-attached state.
"""

import jax
import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from feos_tpu.models import gc_pcsaft as jgc
from feos_tpu_torch.models import gc_pcsaft as gc
from test_torch_gc_eos import GOLDEN, IDENT, PARAMETER, _t, parameter_tuple

BUTANE_PROPANE = ([["CH3", "CH2", "CH2", "CH3"], ["CH3", "CH2", "CH3"]],
                  [[[0, 1], [1, 2], [2, 3]], [[0, 1], [1, 2]]])
ASSOC = (5, 7)  # 'a/np' and 'a/a'
SEGMENTS = [BUTANE_PROPANE[0]] * 2 + [GOLDEN["segment_lists"][i] for i in ASSOC]
BONDS = [BUTANE_PROPANE[1]] * 2 + [GOLDEN["bond_lists"][i] for i in ASSOC]
RECORDS = [("CH3", "CH2", -0.05), (">CH", ">C<", 0.02)]
PHI = np.array([[1.0, 1.02], [0.99, 1.0], [1.0, 1.0], [1.01, 0.98]])
T = np.array([280.0, 270.0, 300.0, 300.0])
X1 = np.array([0.5, 0.3, 0.4, 0.4])
BUBBLE = {"bubble": True, "dew": False}


def model(records=RECORDS, phi=PHI, parameter=PARAMETER):
    return ft.GcPcSaftMix(IDENT, parameter_tuple(parameter), SEGMENTS, BONDS, records, phi,
                          device="cpu")


def targets(name):
    """The port's bubble (dew) pressures at T: the targets."""
    with torch.no_grad():
        p, nans = getattr(model(), f"{name}_point")(T, X1, np.full(4, 1e5))
    assert not nans.any()
    return p


def solve_t(eos, name, pressure, **kw):
    return getattr(eos, f"{name}_point_t")(pressure, X1, 1.05 * T, **kw)


@pytest.fixture(scope="module")
def solved():
    """Per direction: the targets, the port's (T, nans, y, stats) and its
    gradients of sum T in the segment parameters, k_ab and phi; JAX's
    bubble solve at the port's butane/propane bubble temperatures."""
    port = {}
    for name in BUBBLE:
        p = targets(name)
        eos = model()
        stats = {}
        t, nans, y = solve_t(eos, name, p, full_output=True, stats=stats)
        t.sum().backward()
        port[name] = (p.numpy(), t.detach().numpy(), nans.numpy(), y.numpy(), stats,
                      [x.grad.numpy() for x in (eos.parameter, eos.kab, eos.phi)])
    j_params = jgc.assemble(IDENT, parameter_tuple(PARAMETER), SEGMENTS[:2], BONDS[:2],
                            RECORDS, PHI[:2])
    br = jgc.static_branches_gc(j_params)
    ref = jax.jit(lambda params, t, p: jgc.gc_incipient_property(
        params, t, X1[:2], p, bubble=True, branches=br, full_output=True))(
            j_params, port["bubble"][1][:2], port["bubble"][0][:2])
    ref = jax.tree_util.tree_map(np.asarray, ref)
    return port, ref, j_params


@pytest.mark.parametrize("name", list(BUBBLE))
def test_recovers_temperature(solved, name):
    """Every row converges, in every regime, and T recovers the
    temperatures of the targets within 1e-9."""
    port, _, _ = solved
    _, t, nans, _, stats, _ = port[name]
    assert not nans.any() and 0 < stats["outer"] < 24
    np.testing.assert_allclose(t, T, rtol=1e-9)


def test_jax_round_trip(solved):
    """JAX's bubble pressure at the port's butane/propane bubble
    temperatures is the target, and its vapor composition the port's."""
    port, ref, _ = solved
    p, _, nans, y, _, _ = port["bubble"]
    ref_p, ref_nans, ref_y = ref
    np.testing.assert_array_equal(nans[:2], ref_nans)
    np.testing.assert_allclose(ref_p, p[:2], rtol=1e-9)
    np.testing.assert_allclose(y[:2], ref_y, rtol=0, atol=1e-8)


def test_jax_parameters_carried_across(solved):
    """The same temperatures from the parameters JAX assembled, carried into
    the port by ``GcParams.from_numpy``."""
    port, _, j_params = solved
    params = ft.GcParams.from_numpy(j_params, device="cpu")
    with torch.no_grad():
        t, nans = ft.gc_incipient_temperature(params, _t(port["bubble"][0][:2]), _t(X1[:2]),
                                              _t(1.05 * T[:2]))
    assert not nans.any()
    np.testing.assert_allclose(t.numpy(), port["bubble"][1][:2], rtol=1e-11)


def test_dew_above_bubble(solved):
    """At the bubble rows' pressure and composition, the dew temperature
    lies above the bubble temperature."""
    port, _, _ = solved
    with torch.no_grad():
        t_d, nans = solve_t(model(), "dew", _t(port["bubble"][0]))
    assert not nans.any()
    assert np.all(t_d.numpy() > T)


def _total(name, p, **kw):
    """sum of T at the targets ``p`` for a model built from ``kw``, from the
    temperatures of the targets (the central differences need no search)."""
    with torch.no_grad():
        t, nans = getattr(model(**kw), f"{name}_point_t")(_t(p), X1, T)
    assert not nans.any()
    return float(t.sum())


@pytest.mark.parametrize("name,what", [("bubble", "k_ab"), ("bubble", "phi"),
                                       ("bubble", "epsilon_k OH"), ("dew", "m CH3")])
def test_gradient_central_fd(solved, name, what):
    """d sum(T) / d(one k_ab value, one phi entry, epsilon_k of OH, m of
    CH3) against central differences (relative step 1e-5)."""
    port, _, _ = solved
    p, grads = port[name][0], port[name][5]
    if what == "k_ab":
        base, h = np.array([k for _, _, k in RECORDS]), 1e-5

        def at(v):
            return _total(name, p, records=[(a, b, k) for (a, b, _), k in zip(RECORDS, v)])

        i, want = 1, grads[1][1]
    elif what == "phi":
        base, h, i, want = PHI, 1e-5, (3, 0), grads[2][3, 0]

        def at(v):
            return _total(name, p, phi=v)
    else:
        seg, col = {"epsilon_k OH": ("OH", 2), "m CH3": ("CH3", 0)}[what]
        base, i = PARAMETER, (IDENT.index(seg), col)
        h, want = 1e-5 * PARAMETER[i], grads[0][i]

        def at(v):
            return _total(name, p, parameter=v)

    up, down = base.copy(), base.copy()
    up[i] += h
    down[i] -= h
    np.testing.assert_allclose(want, (at(up) - at(down)) / (2 * h), rtol=1e-5)


@pytest.mark.parametrize("name", list(BUBBLE))
def test_gradients_are_the_implicit_function(solved, name, monkeypatch):
    """d sum(T)/dtheta = -sum_r (dp_r/dtheta)/(dp_r/dT_r) in the segment
    parameters, k_ab and phi, with both partials from the port's own
    pressure solve at the temperatures and state its temperature solve
    re-attached at (the rows share theta, so the sum over rows is taken as
    one product weighted by -1/(dp_r/dT_r))."""
    port, _, _ = solved
    calls = []
    incipient_property = gc.gc_incipient_property

    def spy(*args, **kwargs):
        if kwargs.get("full_output"):
            calls.append((args[1].detach().clone(), kwargs["state0"]))
        return incipient_property(*args, **kwargs)

    monkeypatch.setattr(gc, "gc_incipient_property", spy)
    with torch.no_grad():
        solve_t(model(), name, _t(port[name][0]))
    monkeypatch.undo()
    t_star, u_star = calls[0]
    eos, t = model(), t_star.requires_grad_()
    p, nans = getattr(eos, f"{name}_point")(t, X1, _t(port[name][0]), state0=u_star)
    assert not nans.any()
    (dp_dt,) = torch.autograd.grad(p.sum(), t, retain_graph=True)
    (-p / dp_dt).sum().backward()
    for got, want in zip(port[name][5], (eos.parameter, eos.kab, eos.phi)):
        want = want.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())
