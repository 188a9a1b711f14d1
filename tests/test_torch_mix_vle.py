"""The port's binary bubble and dew pressures against the C++ oracle, the
reference's anchors and finite differences.

Config 3 of ``benchmarks/run_all.py`` (a cross-associating pair with kij
and eps_AiBj) at four temperatures, a seeded batch of binary systems in
every regime and the non-associating pair of ``tests/test_compat.py`` go
through ``bubble_point``/``dew_point`` and through the independent C++
oracle ``cpu_backend.mix_vle_densities``.  Gradients in all 8 parameters
of component 0, kij and eps_AiBj are held to central differences, the
bubble pressure's at the bars of ``tests/test_pcsaft_mix.py``.
"""


import numpy as np
import pytest
import torch

from _torch_oracle import backend  # noqa: F401 (a fixture)
import feos_tpu_torch as ft
from feos_tpu_torch.models import pcsaft_mix as mix
from feos_tpu_torch.units import PA_PER_KT_TO_REDUCED

CONFIG3 = [[1, 3.5, 150, 0, 0.02, 1500, 1, 1], [1, 3.5, 200, 0, 0.03, 2500, 1, 1]]
CONFIG3_KIJ = [-0.15, 1000.0]
CONFIG3_T = np.linspace(140.0, 160.0, 4)
# the JAX package and the C++ oracle at these rows, printed to 8 decimals
ANCHORS = {
    "bubble": [345.42092106, 809.86800143, 1757.14938513, 3562.20472155],
    "dew": [0.06703126, 0.2419615, 0.77999089, 2.27776462],
}
NONASSOC = [[1, 3.5, 150, 0, 0, 0, 0, 0], [1, 3.5, 200, 0, 0, 0, 0, 0]]
NONASSOC_ANCHORS = {"bubble": 419901.14, "dew": 221902.57}  # Pa at 150 K, kij -0.15
REGIMES = ("none", "dipolar", "self", "cross", "cross_eps", "induced")
N_PER_REGIME = 6
BUBBLE = {"bubble": True, "dew": False}
# rows of _systems() that the port solves and the oracle does not, with the
# port's and the oracle's (unaccepted) pressures in Pa: bubble row 15, a
# self-associating component with eps_ab/T = 16.1 at 151.5 K
ORACLE_FAILS = {"bubble": {15: (184008.716, 141399.49)}, "dew": {}}


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _systems(seed=11):
    """N_PER_REGIME seeded binary systems per regime, at 0.6-0.8 of the
    lower component's corresponding-states critical temperature."""
    rng = np.random.default_rng(seed)
    rows, kijs = [], []
    for regime in REGIMES:
        for _ in range(N_PER_REGIME):
            p = np.zeros((2, 8))
            p[:, 0] = rng.uniform(1.0, 3.0, 2)
            p[:, 1] = rng.uniform(3.0, 4.0, 2)
            p[:, 2] = rng.uniform(150.0, 300.0, 2)
            kij = [rng.uniform(-0.05, 0.05), 0.0]
            if regime == "dipolar":
                p[0, 3] = rng.uniform(0.5, 3.0)
                p[1, 3] = rng.choice([0.0, rng.uniform(0.5, 3.0)])
            for i in {"self": [0], "cross": [0, 1], "cross_eps": [0, 1],
                      "induced": [0]}.get(regime, []):
                p[i, 4:8] = [rng.uniform(0.01, 0.04), rng.uniform(1000.0, 2500.0), 1.0, 1.0]
            if regime == "induced":
                p[1, 4:8] = [rng.uniform(0.01, 0.04), rng.uniform(1000.0, 2500.0), 0.0, 1.0]
            if regime == "cross_eps":
                kij[1] = rng.uniform(1500.0, 2500.0)
            rows.append(p)
            kijs.append(kij)
    params = np.asarray(rows)
    t_c = (params[..., 2] * (0.89 + 0.38 * params[..., 0])).min(1)
    temperature = rng.uniform(0.6, 0.8, len(rows)) * t_c
    return params, np.asarray(kijs), temperature, rng.uniform(0.1, 0.9, len(rows))


def _solve(params, kij, temperature, x1, p0, bubble):
    """(rho_inc, rho_bulk, ok, p [Pa]) of the port's detached solve."""
    t = _t(temperature)
    rho_inc, rho_bulk, ok, pt = mix.solve_incipient(
        _t(params), _t(kij), t, torch.stack([_t(x1), 1.0 - _t(x1)], 1),
        _t(p0) / t * PA_PER_KT_TO_REDUCED, bubble)
    p = pt * t / PA_PER_KT_TO_REDUCED
    return rho_inc.numpy(), rho_bulk.numpy(), ok.numpy(), p.numpy()


@pytest.fixture(scope="module")
def config3(backend):
    """Port (p, nans, y, state) and oracle (rho, p, ok) of config 3, each way."""
    B = len(CONFIG3_T)
    params, kij = np.tile(CONFIG3, (B, 1, 1)), np.tile(CONFIG3_KIJ, (B, 1))
    x1, p0 = np.full(B, 0.5), np.full(B, 1e5)
    out = {}
    for name, bubble in BUBBLE.items():
        fn = ft.bubble_point if bubble else ft.dew_point
        with torch.no_grad():
            port = fn(_t(params), _t(kij), _t(CONFIG3_T), _t(x1), _t(p0),
                      full_output=True, state_output=True)
        oracle = backend.mix_vle_densities(params, kij, CONFIG3_T, x1, p0, bubble=bubble)
        out[name] = port, oracle
    return out


@pytest.mark.parametrize("name", ["bubble", "dew"])
def test_config3_anchors(config3, name):
    (p, nans, _, _), (_, p_oracle, ok_oracle) = config3[name]
    assert not nans.any() and ok_oracle.all()
    p = p.numpy()
    np.testing.assert_allclose(p, p_oracle, rtol=1e-8, atol=0)
    # the anchors hold to the last printed decimal
    np.testing.assert_allclose(p, ANCHORS[name], rtol=0, atol=5e-9 + 1e-15 * p.max())


@pytest.mark.parametrize("name", ["bubble", "dew"])
def test_config3_incipient_composition(config3, name):
    """``full_output``'s incipient mole fractions against the oracle's
    densities (vapor columns 0:2 for bubble, liquid 2:4 for dew)."""
    (_, _, y, _), (rho, _, _) = config3[name]
    inc = rho[:, 0:2] if name == "bubble" else rho[:, 2:4]
    np.testing.assert_allclose(y.numpy(), inc / inc.sum(1, keepdims=True), rtol=1e-8)


@pytest.mark.parametrize("name", ["bubble", "dew"])
def test_warm_start_reproduces_cold(config3, name):
    """A solve from the first call's ``state_output`` skips the cold start
    and reproduces its pressures."""
    (p, _, _, state), _ = config3[name]
    # the cold value is carried from the state before the Newton's final
    # step, the warm one from the state after it: they differ by that step,
    # which the exit test bounds at 1e-9 in the residual
    B = len(CONFIG3_T)
    fn = ft.bubble_point if BUBBLE[name] else ft.dew_point
    stats = {}
    with torch.no_grad():
        p_warm, nans = fn(_t(np.tile(CONFIG3, (B, 1, 1))), _t(np.tile(CONFIG3_KIJ, (B, 1))),
                          _t(CONFIG3_T), _t(np.full(B, 0.5)), _t(np.full(B, 1e5)),
                          state0=state, stats=stats)
    assert not nans.any() and stats["npt"] == 0 and stats["newton"] <= 3
    np.testing.assert_allclose(p_warm.numpy(), p.numpy(), rtol=1e-9, atol=0)


def test_warm_start_with_nan_rows_fails_only_them(config3):
    (_, _, _, state), _ = config3["bubble"]
    state = state.clone()
    state[1] = torch.nan
    B = len(CONFIG3_T)
    with torch.no_grad():
        _, nans = ft.bubble_point(_t(np.tile(CONFIG3, (B, 1, 1))),
                                  _t(np.tile(CONFIG3_KIJ, (B, 1))), _t(CONFIG3_T),
                                  _t(np.full(B, 0.5)), _t(np.full(B, 1e5)), state0=state)
    assert nans.tolist() == [False, True, False, False]


@pytest.fixture(scope="module")
def regimes(backend):
    """The seeded systems through the port and the oracle, each way."""
    params, kij, temperature, x1 = _systems()
    p0 = np.full(len(x1), 1e5)
    out = {}
    for name, bubble in BUBBLE.items():
        port = _solve(params, kij, temperature, x1, p0, bubble)
        oracle = backend.mix_vle_densities(params, kij, temperature, x1, p0, bubble=bubble)
        out[name] = port, oracle
    return (params, kij, temperature, x1), out


@pytest.mark.parametrize("name", ["bubble", "dew"])
def test_masks_match_oracle(regimes, name):
    _, out = regimes
    (_, _, ok, p), (_, p_oracle, ok_oracle) = out[name]
    fails = ORACLE_FAILS[name]
    assert np.nonzero(ok != ok_oracle)[0].tolist() == sorted(fails)
    for i, (want, want_oracle) in fails.items():
        assert ok[i] and not ok_oracle[i]
        np.testing.assert_allclose([p[i], p_oracle[i]], [want, want_oracle], rtol=1e-8)
    assert ok.mean() > 0.85


@pytest.mark.parametrize("name", ["bubble", "dew"])
def test_pressures_and_densities_match_oracle(regimes, name):
    _, out = regimes
    (rho_inc, rho_bulk, ok, p), (rho, p_oracle, ok_oracle) = out[name]
    both = ok & ok_oracle
    np.testing.assert_allclose(p[both], p_oracle[both], rtol=1e-8, atol=0)
    vap, liq = (rho_inc, rho_bulk) if BUBBLE[name] else (rho_bulk, rho_inc)
    np.testing.assert_allclose(vap[both], rho[both, 0:2], rtol=1e-8, atol=0)
    np.testing.assert_allclose(liq[both], rho[both, 2:4], rtol=1e-8, atol=0)


@pytest.mark.parametrize("name", ["bubble", "dew"])
def test_equilibrium_conditions(regimes, name):
    """Equal p~ and total mu~ in both phases at the port's solution, from
    the exact phi (tests/test_solvers_mix.py: p~ rtol 1e-7, mu atol 1e-8)."""
    (params, kij, temperature, _), out = regimes
    rho_inc, rho_bulk, ok, _ = out[name][0]
    state = []
    for rho in (rho_inc, rho_bulk):
        with torch.no_grad():
            _, pt, mu, _ = mix.derivatives(_t(params[ok]), _t(kij[ok]), _t(temperature[ok]),
                                           _t(rho[ok]))
        state.append((pt.numpy(), mu.numpy() + np.log(rho[ok])))
    (p_inc, mu_inc), (p_bulk, mu_bulk) = state
    # the liquid's p~ cancels terms of its rho dp~/drho (up to ~0.1 A^-3
    # here): an f64 floor near 1e-16 A^-3, a large share of Pa-scale dew
    # pressures
    np.testing.assert_allclose(p_inc, p_bulk, rtol=1e-7, atol=1e-14)
    np.testing.assert_allclose(mu_inc, mu_bulk, rtol=0, atol=1e-8)
    dense = rho_inc.sum(1) if not BUBBLE[name] else rho_bulk.sum(1)
    light = rho_bulk.sum(1) if not BUBBLE[name] else rho_inc.sum(1)
    assert np.all(light[ok] < dense[ok])


@pytest.mark.parametrize("name", ["bubble", "dew"])
def test_nonassociating_pair(backend, name):
    """tests/test_compat.py's pair at 150 K, x1 = 0.5, kij -0.15."""
    params, kij = np.array([NONASSOC]), np.array([[-0.15, 0.0]])
    fn = ft.bubble_point if BUBBLE[name] else ft.dew_point
    with torch.no_grad():
        p, nans = fn(_t(params), _t(kij), _t([150.0]), _t([0.5]), _t([1e5]))
    _, p_oracle, ok = backend.mix_vle_densities(params, kij, [150.0], [0.5], [1e5],
                                                bubble=BUBBLE[name])
    assert not nans.any() and ok.all()
    np.testing.assert_allclose(p.numpy(), p_oracle, rtol=1e-8)
    # the anchor's last printed decimal, and the solve's 1e-9
    np.testing.assert_allclose(p.numpy(), [NONASSOC_ANCHORS[name]], rtol=1e-9, atol=5e-3)


def test_identical_components_give_pure_vapor_pressure():
    """A 'binary' of two identical components with kij = 0 reproduces the
    port's pure vapor pressure at any composition: bubble = dew = p_sat."""
    comp = [1.5, 3.5, 250.0, 0.0, 0.03, 1500.0, 1.0, 1.0]
    T, x = _t([300.0, 350.0]), _t([0.3, 0.3])
    p0 = _t([2e5, 1e6])
    params = _t([[comp, comp]] * 2)
    with torch.no_grad():
        _, vp = ft.vapor_pressure(_t([comp] * 2), T)
        pb, nb = ft.bubble_point(params, None, T, x, p0)
        pd, nd = ft.dew_point(params, None, T, x, p0)
    assert not nb.any() and not nd.any()
    np.testing.assert_allclose(pb.numpy(), vp.numpy(), rtol=1e-9)
    np.testing.assert_allclose(pd.numpy(), vp.numpy(), rtol=1e-9)


def test_dew_point_robust_to_high_p0(backend):
    """A size-asymmetric pair with the estimate far above the dew pressure
    (tests/test_pcsaft_mix.py::test_dew_point_robust_to_high_p0)."""
    params = np.array([[[2.33, 3.71, 222.88, 0, 0, 0, 0, 0],
                        [3.82, 3.84, 242.78, 0, 0, 0, 0, 0]]])
    eos = ft.PcSaftMix(params, None, device="cpu")
    with torch.no_grad():
        pd, nd = eos.dew_point([300.0], [0.4], [1e5])
        pb, nb = eos.bubble_point([300.0], [0.4], [1e5])
    assert not nd.any() and not nb.any()
    assert float(pd) < 0.5 * float(pb)
    _, p_oracle, ok = backend.mix_vle_densities(params, np.zeros((1, 2)), [300.0], [0.4],
                                                [1e5], bubble=False)
    assert ok.all()
    np.testing.assert_allclose(pd.numpy(), p_oracle, rtol=1e-8)


def test_bubble_point_all_gradients_fd():
    """d p_bubble / d(8 parameters of component 0, kij, eps_AiBj) against
    central differences at the bars of
    tests/test_pcsaft_mix.py::test_bubble_point_all_gradients_fd, with one
    batched solve for every difference."""
    base = np.array(CONFIG3)
    kij0, eps0 = -0.15, 1000.0
    params = _t(base[None]).requires_grad_()
    kij = _t([[kij0, eps0]]).requires_grad_()
    p, nans = ft.bubble_point(params, kij, _t([150.0]), _t([0.5]), _t([1e5]))
    assert not nans.any()
    g_par, g_kij = torch.autograd.grad(p.sum(), (params, kij))
    g_par, g_kij = g_par[0, 0].numpy(), g_kij[0].numpy()
    assert np.all(np.isfinite(g_par))

    hs = np.maximum(np.abs(base[0]), 1.0) * 3e-7
    h_kij, h_eps = 1e-8, 1e-4
    batch, kij_rows = [], []
    for i in range(8):
        for sgn in (1.0, -1.0):
            p_i = base.copy()
            p_i[0, i] += sgn * hs[i]
            batch.append(p_i)
            kij_rows.append([kij0, eps0])
    for j, h in ((0, h_kij), (1, h_eps)):
        for sgn in (1.0, -1.0):
            batch.append(base.copy())
            row = [kij0, eps0]
            row[j] += sgn * h
            kij_rows.append(row)
    n = len(batch)
    with torch.no_grad():
        p_all, nans = ft.bubble_point(_t(batch), _t(kij_rows), _t(np.full(n, 150.0)),
                                      _t(np.full(n, 0.5)), _t(np.full(n, 1e5)))
    assert not nans.any()
    p_all = p_all.numpy()
    fd_par = (p_all[0:16:2] - p_all[1:16:2]) / (2 * hs)
    scale = np.maximum(np.abs(fd_par), 1.0)
    np.testing.assert_allclose(g_par / scale, fd_par / scale, rtol=0, atol=2e-4)
    fd_kij = (p_all[16] - p_all[17]) / (2 * h_kij)
    assert abs(g_kij[0] - fd_kij) < 1.0, (g_kij[0], fd_kij)
    fd_eps = (p_all[18] - p_all[19]) / (2 * h_eps)
    assert abs(g_kij[1] - fd_eps) < abs(fd_eps) * 1e-3 + 1e-3, (g_kij[1], fd_eps)


def test_dew_point_all_gradients_fd():
    """d p_dew / d(8 parameters of component 0, kij, eps_AiBj) of config 3
    at 150 K (0.44 Pa) against central differences.  The dew pressure is
    so small that the bubble test's steps (3e-7 relative) move it by less
    than the solve's 1e-9 tolerance, so the steps here are 1e-4 relative:
    the differences' truncation error is then near 1e-8 and their noise
    from the solve near 1e-5."""
    base = np.array(CONFIG3)
    kij0, eps0 = -0.15, 1000.0
    params = _t(base[None]).requires_grad_()
    kij = _t([[kij0, eps0]]).requires_grad_()
    p, nans = ft.dew_point(params, kij, _t([150.0]), _t([0.5]), _t([1e5]))
    assert not nans.any()
    g_par, g_kij = torch.autograd.grad(p.sum(), (params, kij))
    g_par, g_kij = g_par[0, 0].numpy(), g_kij[0].numpy()

    hs = np.maximum(np.abs(base[0]), 1.0) * 1e-4
    batch, kij_rows = [], []
    for i in range(8):
        for sgn in (1.0, -1.0):
            p_i = base.copy()
            p_i[0, i] += sgn * hs[i]
            batch.append(p_i)
            kij_rows.append([kij0, eps0])
    h_k = (1e-4, 1e-1)
    for j in range(2):
        for sgn in (1.0, -1.0):
            batch.append(base.copy())
            row = [kij0, eps0]
            row[j] += sgn * h_k[j]
            kij_rows.append(row)
    n = len(batch)
    with torch.no_grad():
        p_all, nans = ft.dew_point(_t(batch), _t(kij_rows), _t(np.full(n, 150.0)),
                                   _t(np.full(n, 0.5)), _t(np.full(n, 1e5)))
    assert not nans.any()
    fd = (p_all.numpy()[0::2] - p_all.numpy()[1::2]) / (2 * np.concatenate([hs, h_k]))
    np.testing.assert_allclose(g_par, fd[:8], rtol=1e-4, atol=1e-4 * np.abs(fd[:8]).max())
    np.testing.assert_allclose(g_kij, fd[8:], rtol=1e-3, atol=0)


def test_dew_point_kij_gradient_fd():
    """tests/test_pcsaft_mix.py::test_dew_point_gradient_fd on the port."""
    h = 1e-8
    params = _t([NONASSOC] * 2)
    T, y, p0 = _t([150.0] * 2), _t([0.5] * 2), _t([1e5] * 2)
    with torch.no_grad():
        p, nans = ft.dew_point(params, _t([[-0.15, 0.0], [-0.15 + h, 0.0]]), T, y, p0)
    assert not nans.any()
    fd = float(p[1] - p[0]) / h
    kij = _t([[-0.15, 0.0]]).requires_grad_()
    p1, _ = ft.dew_point(params[:1], kij, T[:1], y[:1], p0[:1])
    (g,) = torch.autograd.grad(p1.sum(), kij)
    assert abs(float(g[0, 0]) - fd) < 1.0, (float(g[0, 0]), fd)


def test_failed_rows_are_nan_with_finite_gradients():
    """A supercritical row is masked, its pressure NaN, and the gradient of
    a loss over the converged rows stays finite everywhere."""
    params = _t([CONFIG3, CONFIG3]).requires_grad_()
    p, nans = ft.bubble_point(params, _t([CONFIG3_KIJ] * 2), _t([150.0, 2000.0]),
                              _t([0.5, 0.5]), _t([1e5, 1e5]))
    assert nans.tolist() == [False, True] and torch.isnan(p[1])
    torch.where(nans, 0.0, torch.log(torch.where(nans, 1.0, p))).sum().backward()
    assert torch.isfinite(params.grad).all()
    assert torch.equal(params.grad[1], torch.zeros_like(params.grad[1]))


def test_non_binary_raises():
    ternary = _t([[CONFIG3[0], CONFIG3[1], CONFIG3[0]]])
    with pytest.raises(ValueError):
        ft.bubble_point(ternary, None, _t([150.0]), _t([[0.3, 0.3, 0.4]]), _t([1e5]))
    with pytest.raises(ValueError):
        ft.PcSaftMix(ternary.numpy(), device="cpu")


@pytest.mark.parametrize("name", ["bubble", "dew"])
def test_temperature_gradient_fd(name):
    """d p / d T through the identity (with p = p~ T kB / A^3) against
    central differences of the solve, config 3 at 150 K."""
    fn = ft.bubble_point if BUBBLE[name] else ft.dew_point
    T = _t([150.0]).requires_grad_()
    p, nans = fn(_t([CONFIG3]), _t([CONFIG3_KIJ]), T, _t([0.5]), _t([1e5]))
    assert not nans.any()
    (g,) = torch.autograd.grad(p.sum(), T)
    h = 1e-4
    with torch.no_grad():
        pp, _ = fn(_t([CONFIG3] * 2), _t([CONFIG3_KIJ] * 2), _t([150.0 + h, 150.0 - h]),
                   _t([0.5] * 2), _t([1e5] * 2))
    np.testing.assert_allclose(float(g), float(pp[0] - pp[1]) / (2 * h), rtol=1e-7)
