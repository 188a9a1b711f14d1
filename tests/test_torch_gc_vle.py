"""The port's gc bubble and dew pressures against the C++ oracle and finite
differences.

The 11 golden topologies at 300 K and x1 = 0.4 (tests/test_gc_pcsaft.py's
oracle case), the replay of the 48 seeded random molecule pairs of
``tests/test_fuzz_oracle.py::test_fuzz_gc_random_topologies_vs_oracle`` and
config 4 of ``benchmarks/run_all.py`` (butane/propane, k_ab(CH3, CH2) =
-0.15, phi = [1.1, 0.98]) go through ``GcPcSaftMix.bubble_point``/
``dew_point`` and the independent ``cpu_backend.gc_vle_densities``.  The
k_ab and phi gradients of config 4 are held to central differences, and
``compat.GcPcSaft`` to the reference's contract.  No JAX function is
compiled here.
"""

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from feos_tpu_torch.compat import GcPcSaft
from test_torch_gc_assembly import fuzz_systems
from test_torch_gc_eos import (
    GOLDEN, IDENT, PARAMETER, _t, backend, parameter_tuple,  # noqa: F401
)

BUBBLE = {"bubble": True, "dew": False}
CONFIG4_SEGMENTS = [["CH3", "CH2", "CH2", "CH3"], ["CH3", "CH2", "CH3"]]
CONFIG4_BONDS = [[[0, 1], [1, 2], [2, 3]], [[0, 1], [1, 2]]]
CONFIG4_KAB = -0.15
CONFIG4_PHI = [1.1, 0.98]
CONFIG4_T = np.linspace(140.0, 160.0, 4)


def config4(rows, kab=CONFIG4_KAB):
    return ft.GcPcSaftMix(IDENT, parameter_tuple(PARAMETER), [CONFIG4_SEGMENTS] * rows,
                          [CONFIG4_BONDS] * rows, [("CH3", "CH2", kab)],
                          np.tile(CONFIG4_PHI, (rows, 1)), device="cpu")


def solve(eos, name, temperature, x1, **kw):
    """The port's (p, nans, ...) without a gradient, as numpy."""
    fn = eos.bubble_point if BUBBLE[name] else eos.dew_point
    with torch.no_grad():
        out = fn(temperature, x1, np.full(len(temperature), 1e5), **kw)
    return tuple(x.numpy() for x in out)


@pytest.fixture(scope="module")
def golden(backend):
    """Port (p, nans, y, state) and oracle (rho, p, ok) of the 11 golden
    topologies at 300 K, x1 = 0.4, each way."""
    eos = ft.GcPcSaftMix(IDENT, parameter_tuple(PARAMETER), GOLDEN["segment_lists"],
                         GOLDEN["bond_lists"], [tuple(k) for k in GOLDEN["kab_list"]],
                         np.array(GOLDEN["phi"]), device="cpu")
    n = len(GOLDEN["labels"])
    t, x = np.full(n, 300.0), np.full(n, 0.4)
    params = eos.params.detach()
    return {name: (solve(eos, name, t, x, full_output=True, state_output=True),
                   backend.gc_vle_densities(params, t, x, np.full(n, 1e5), bubble))
            for name, bubble in BUBBLE.items()}


@pytest.mark.parametrize("name", list(BUBBLE))
def test_golden_topologies_match_oracle(golden, name):
    """Every regime (plain, branched, dipolar, self, cross, induced):
    equal masks and p at rtol 1e-9 (tests/test_gc_pcsaft.py's bar)."""
    (p, nans, y, _), (rho_c, p_c, ok_c) = golden[name]
    assert ok_c.all() and not nans.any()
    np.testing.assert_allclose(p, p_c, rtol=1e-9)
    # the incipient composition is the oracle's coexisting phase's
    inc = rho_c[:, 0:2] if BUBBLE[name] else rho_c[:, 2:4]
    np.testing.assert_allclose(y, inc / inc.sum(1, keepdims=True), rtol=1e-7)


@pytest.mark.parametrize("name", list(BUBBLE))
def test_warm_start_reproduces_cold(golden, name):
    """A warm start from the returned state converges in one Newton
    iteration to within the solve's 1e-9 of the cold value."""
    (p, _, _, state), _ = golden[name]
    eos = ft.GcPcSaftMix(IDENT, parameter_tuple(PARAMETER), GOLDEN["segment_lists"],
                         GOLDEN["bond_lists"], [tuple(k) for k in GOLDEN["kab_list"]],
                         np.array(GOLDEN["phi"]), device="cpu")
    stats = {}
    n = len(p)
    p_w, nans_w = solve(eos, name, np.full(n, 300.0), np.full(n, 0.4), state0=_t(state),
                        stats=stats)
    assert not nans_w.any() and stats["npt"] == 0 and stats["ss"] == 0
    np.testing.assert_allclose(p_w, p, rtol=1e-9)


@pytest.mark.parametrize("name", list(BUBBLE))
def test_fuzz_topologies_match_oracle(backend, name):
    """The replay of the oracle fuzz sweep (48 rows, its seed, molecules,
    phi, temperatures and compositions): at most 1 mask mismatch, as that
    test allows, and p at 1e-9 on the rows both accept."""
    segment_lists, bond_lists, phi, rng = fuzz_systems()
    eos = ft.GcPcSaftMix(IDENT, parameter_tuple(PARAMETER), segment_lists, bond_lists,
                         [("CH3", "CH2", -0.05)], phi, device="cpu")
    params = eos.params.detach()
    m_mix, eps_mix = params.m_mix.numpy(), params.epsilon_k_mix.numpy()
    B = len(segment_lists)
    temperature = rng.uniform(0.55, 0.80, B) * (eps_mix * (0.89 + 0.38 * m_mix)).min(1)
    x1 = rng.uniform(0.1, 0.9, B)
    p, nans = solve(eos, name, temperature, x1)
    _, p_c, ok_c = backend.gc_vle_densities(params, temperature, x1, np.full(B, 1e5),
                                            BUBBLE[name])
    both = ok_c & ~nans
    assert both.sum() >= 0.6 * B
    assert (ok_c ^ ~nans).sum() <= 1, np.nonzero(ok_c ^ ~nans)
    np.testing.assert_allclose(p[both], p_c[both], rtol=1e-9)


@pytest.mark.parametrize("name", list(BUBBLE))
def test_config4_matches_oracle(backend, name):
    eos = config4(len(CONFIG4_T))
    x1 = np.full(len(CONFIG4_T), 0.5)
    p, nans = solve(eos, name, CONFIG4_T, x1)
    _, p_c, ok_c = backend.gc_vle_densities(eos.params.detach(), CONFIG4_T, x1,
                                            np.full(len(CONFIG4_T), 1e5), BUBBLE[name])
    assert ok_c.all() and not nans.any()
    np.testing.assert_allclose(p, p_c, rtol=1e-9)


@pytest.mark.parametrize("name", list(BUBBLE))
def test_config4_kab_and_phi_gradients_fd(name):
    """d p / d k_ab(CH3, CH2) and d p / d phi of config 4 at 150 K, x1 =
    0.5 (tests/test_gc_pcsaft.py's case) against central differences with
    steps of 1e-4 relative: within tests/test_gc_pcsaft.py's absolute 1.0
    Pa, and within rtol 1e-4 (the dew pressure is 2-3 Pa, so the absolute
    bar alone would check little)."""
    eos = config4(1)
    fn = eos.bubble_point if BUBBLE[name] else eos.dew_point
    p, nans = fn(np.array([150.0]), np.array([0.5]), np.array([1e5]))
    assert not nans.any()
    p.sum().backward()
    grad = np.concatenate([eos.kab.grad.numpy(), eos.phi.grad[0].numpy()])

    h = 1e-4 * np.abs(np.array([CONFIG4_KAB] + CONFIG4_PHI))
    fd = []
    k_fd = [solve(config4(1, CONFIG4_KAB + s * h[0]), name, np.array([150.0]),
                  np.array([0.5]))[0][0] for s in (1.0, -1.0)]
    fd.append((k_fd[0] - k_fd[1]) / (2.0 * h[0]))
    # phi: one row per step, one call
    phi = np.tile(CONFIG4_PHI, (4, 1))
    for r, (j, s) in enumerate([(0, 1.0), (0, -1.0), (1, 1.0), (1, -1.0)]):
        phi[r, j] += s * h[1 + j]
    eos4 = ft.GcPcSaftMix(IDENT, parameter_tuple(PARAMETER), [CONFIG4_SEGMENTS] * 4,
                          [CONFIG4_BONDS] * 4, [("CH3", "CH2", CONFIG4_KAB)], phi, device="cpu")
    p4 = solve(eos4, name, np.full(4, 150.0), np.full(4, 0.5))[0]
    fd += [(p4[0] - p4[1]) / (2.0 * h[1]), (p4[2] - p4[3]) / (2.0 * h[2])]
    assert np.all(np.abs(grad - fd) < 1.0), (grad, fd)
    np.testing.assert_allclose(grad, fd, rtol=1e-4)


def test_gradients_are_finite_and_failed_rows_nan():
    """A row that cannot converge (far above both critical points) is NaN,
    flagged, and leaves every gradient finite."""
    eos = config4(2)
    p, nans = eos.bubble_point(np.array([150.0, 900.0]), np.array([0.5, 0.5]),
                               np.array([1e5, 1e5]))
    assert nans.tolist() == [False, True] and torch.isnan(p[1])
    p[0].backward()
    for g in (eos.parameter.grad, eos.kab.grad, eos.phi.grad):
        assert torch.isfinite(g).all()


def _records(wanted):
    return [(r, PARAMETER[IDENT.index(r)]) for r in wanted]


@pytest.mark.parametrize("method", ["bubble_point", "dew_point"])
def test_compat_contract(backend, method):
    """compat.GcPcSaft mirrors the reference's constructor and contract
    (tests/test_compat.py::test_gc_contract): butane/propane at 230 and 240
    K, compacted (B_ok, 4) densities with the vapor lighter than the liquid,
    equal to the oracle's at 1e-9."""
    gc = GcPcSaft(_records(["CH3", "CH2"]), [CONFIG4_SEGMENTS] * 2, [CONFIG4_BONDS] * 2,
                  [("CH3", "CH2", -0.15)], np.tile(CONFIG4_PHI, (2, 1)), device="cpu")
    t, x, p0 = np.array([230.0, 240.0]), np.array([0.5, 0.5]), np.array([1e5, 1e5])
    dens, nans = getattr(gc, method)(t, x, p0)
    assert dens.shape == (2, 4) and not nans.any()
    assert np.all(dens[:, :2].sum(1) < dens[:, 2:].sum(1))
    rho_c, _, ok_c = backend.gc_vle_densities(gc.params, t, x, p0, method == "bubble_point")
    assert ok_c.all()
    np.testing.assert_allclose(dens, rho_c, rtol=1e-9)


def test_compat_compacts_failed_rows():
    gc = GcPcSaft(_records(["CH3", "CH2"]), [CONFIG4_SEGMENTS] * 2, [CONFIG4_BONDS] * 2,
                  [("CH3", "CH2", -0.15)], None, device="cpu")
    dens, nans = gc.bubble_point(np.array([900.0, 230.0]), np.array([0.5, 0.5]),
                                 np.array([1e5, 1e5]))
    assert nans.tolist() == [True, False] and dens.shape == (1, 4)
