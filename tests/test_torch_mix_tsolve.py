"""The port's bubble and dew temperatures against the JAX package.

JAX's ``bubble_point_t`` compiles for about 43 s on this CPU on the
non-associating rows of tests/test_tsolve.py (propane/n-butane), so the
port's temperatures are held through JAX's pressure solvers instead: in one
jit, JAX's ``bubble_point``/``dew_point`` solve at each temperature the port
returns (the round trip to the target pressure at 1e-9, the incipient
composition at 1e-8, equal masks), and ``jacfwd`` of JAX's f64 stationary
identity at the port's densities gives dT/dtheta = -(dp/dtheta)/(dp/dT) in
the parameters and kij.  That jit compiles for about 40 s here, so
``tools/gen_port_fixtures.py`` writes its values, with the port's
temperatures and densities they were taken at, to
``tests/golden/torch_mix_tsolve_jax.npz``.  The kij gradient against
central differences and the implicit-function identity hold the port on its
own.  Config 3 (cross association) is in test_torch_mix_tsolve_cross.py.
"""

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from _torch_golden import vendored
from feos_tpu_torch.models import pcsaft_mix as mix

# tests/test_tsolve.py: propane / n-butane (Gross & Sadowski 2001)
MIXP = np.tile([[2.0020, 3.6184, 208.11, 0, 0, 0, 0, 0],
                [2.3316, 3.7086, 222.88, 0, 0, 0, 0, 0]], (3, 1, 1))
KIJ = np.tile([0.02, 0.0], (3, 1))
X1 = np.array([0.2, 0.5, 0.8])
P_MIX = np.array([2e5, 3e5, 4e5])
T0 = 280.0
DIRECTIONS = {"bubble": (ft.bubble_point_t, ft.bubble_point),
              "dew": (ft.dew_point_t, ft.dew_point)}


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _identity_pa(p, k, t, r_inc, r_bulk):
    """The stationary bubble/dew pressure identity in Pa at (r_inc, r_bulk)
    from JAX's f64 pieces, per row."""
    import jax.numpy as jnp
    from feos_tpu.models import pcsaft_mix as jmix
    from feos_tpu.ops.derivatives import pressure_set as jpressure_set
    from feos_tpu.units import REDUCED_TO_PA_PER_KT

    pre = jmix.precompute_mix(jmix.MixParams.from_array(p), k[0], k[1], t)

    def phi(x):
        return jmix.phi_mix_pre(pre, x, branches=frozenset())

    _, p_b, g_b, v_b = jpressure_set(phi, r_bulk)
    mu_b = jnp.log(r_bulk) + g_b
    rho_t = r_inc.sum()
    w = r_inc / rho_t
    v_bulk = (w * v_b).sum()
    g_bulk = (w * (jnp.log(r_inc) - mu_b)).sum()
    ident = -(phi(r_inc) / rho_t + p_b * v_bulk + g_bulk - 1.0) / (1.0 / rho_t - v_bulk)
    return ident * t * REDUCED_TO_PA_PER_KT


def _densities(name, t_star):
    """The port's converged (rho_inc, rho_bulk) at its temperatures."""
    with torch.no_grad():
        _, nans, state = DIRECTIONS[name][1](_t(MIXP), _t(KIJ), t_star, _t(X1), _t(P_MIX),
                                             state_output=True)
    assert not nans.any()
    state = state.numpy()
    z = np.stack([X1, 1.0 - X1], 1)
    return np.exp(state[:, :2]), z * np.exp(state[:, 2:3])


def _port():
    """Per direction, the port's (T, nans, y, dT/dparams, dT/dkij, stats),
    and its temperatures and densities, which JAX is evaluated at."""
    port, dens = {}, []
    for name, (fn, _) in DIRECTIONS.items():
        par, kij = _t(MIXP).requires_grad_(), _t(KIJ).requires_grad_()
        stats = {}
        t, nans, y = fn(par, kij, _t(P_MIX), _t(X1), T0, full_output=True, stats=stats)
        t.sum().backward()
        port[name] = (t.detach(), nans.numpy(), y.numpy(), par.grad.numpy(),
                      kij.grad.numpy(), stats)
        dens.append(_densities(name, t.detach()))
    at = {"t_b": port["bubble"][0].numpy(), "t_d": port["dew"][0].numpy(),
          "r_inc": np.concatenate([d[0] for d in dens]),
          "r_bulk": np.concatenate([d[1] for d in dens])}
    return port, at


def jax_reference():
    """JAX's bubble and dew pressure solves at the port's temperatures, and
    dp/d(params, kij, T) of its identity at the port's densities."""
    import jax
    import jax.numpy as jnp
    from feos_tpu.models import pcsaft_mix as jmix

    _, at = _port()
    br = jmix.static_branches(MIXP)

    @jax.jit
    def reference(t_b, t_d, r_inc, r_bulk):
        bub = jmix.bubble_point(MIXP, KIJ, t_b, X1, P_MIX, branches=br, full_output=True)
        dew = jmix.dew_point(MIXP, KIJ, t_d, X1, P_MIX, branches=br, full_output=True)
        jac = jax.vmap(jax.jacfwd(_identity_pa, argnums=(0, 1, 2)))(
            jnp.concatenate([MIXP, MIXP]), jnp.concatenate([KIJ, KIJ]),
            jnp.concatenate([t_b, t_d]), r_inc, r_bulk)
        return bub, dew, jac

    bub, dew, jac = reference(*at.values())
    return {"mixp": MIXP, "kij": KIJ, "x1": X1, "p_mix": P_MIX, **at,
            **{f"bubble_{k}": x for k, x in zip(("p", "nans", "y"), bub)},
            **{f"dew_{k}": x for k, x in zip(("p", "nans", "y"), dew)},
            **dict(zip(("j_par", "j_kij", "j_t"), jac))}


@pytest.fixture(scope="module")
def solved():
    """Per direction, the port's (T, nans, y, dT/dparams, dT/dkij, stats),
    and JAX's pressure solves at the port's T and dp/d(params, kij, T) of
    its identity at the port's densities (vendored)."""
    port, at = _port()
    ref = vendored("mix_tsolve", exact={"mixp": MIXP, "kij": KIJ, "x1": X1, "p_mix": P_MIX},
                   close=at)
    j_par, j_kij, j_t = ref["j_par"], ref["j_kij"], ref["j_t"]
    n = len(X1)
    dt = {name: (-j_par[sl] / j_t[sl, None, None], -j_kij[sl] / j_t[sl, None])
          for name, sl in (("bubble", slice(0, n)), ("dew", slice(n, 2 * n)))}
    return port, {name: tuple(ref[f"{name}_{k}"] for k in ("p", "nans", "y"))
                  for name in DIRECTIONS}, dt


@pytest.mark.parametrize("name", list(DIRECTIONS))
def test_jax_round_trip(solved, name):
    """JAX's pressure at the port's temperature is the target pressure, and
    its incipient composition the port's; every row converges in both."""
    port, ref, _ = solved
    t, nans, y, *_ = port[name]
    p, ref_nans, ref_y = ref[name]
    np.testing.assert_array_equal(nans, ref_nans)
    assert not nans.any()
    np.testing.assert_allclose(p, P_MIX, rtol=1e-9, atol=0)
    np.testing.assert_allclose(y, ref_y, rtol=0, atol=1e-8)


@pytest.mark.parametrize("name", list(DIRECTIONS))
@pytest.mark.parametrize("wrt", [0, 1], ids=["params", "kij"])
def test_gradients_match_jax_identity(solved, name, wrt):
    """dT/d(8 parameters of both components) and dT/d(kij, eps_AiBj) against
    -(dp/dtheta)/(dp/dT) of JAX's f64 identity at the port's densities."""
    port, _, dt = solved
    got, want = port[name][3 + wrt], dt[name][wrt]
    scale = np.abs(want).reshape(len(want), -1).max(1)
    err = np.abs(got - want).reshape(len(want), -1) / scale[:, None]
    assert err.max() < 1e-9, err.max()


def _reattached_at(name, monkeypatch, pressure):
    """``(T*, u*)``: the temperature and state at which the port's
    temperature solve ran its differentiable solve (the one with
    ``full_output``), recorded from that call."""
    calls = []
    incipient_property = mix._incipient_property

    def spy(*args, **kwargs):
        if kwargs.get("full_output"):
            calls.append((args[2].detach().clone(), kwargs["state0"]))
        return incipient_property(*args, **kwargs)

    monkeypatch.setattr(mix, "_incipient_property", spy)
    with torch.no_grad():
        DIRECTIONS[name][0](_t(MIXP), _t(KIJ), pressure, _t(X1), T0)
    monkeypatch.undo()
    return calls[0]


@pytest.mark.parametrize("name", list(DIRECTIONS))
def test_gradients_are_the_implicit_function(solved, name, monkeypatch):
    """dT/dtheta = -(dp/dtheta)/(dp/dT) in the parameters and kij, with both
    partials from the port's own pressure solve at the temperature and state
    the temperature solve re-attached at."""
    port, _, _ = solved
    t_star, u_star = _reattached_at(name, monkeypatch, _t(P_MIX))
    t = t_star.requires_grad_()
    par, kij = _t(MIXP).requires_grad_(), _t(KIJ).requires_grad_()
    p, nans = DIRECTIONS[name][1](par, kij, t, _t(X1), _t(P_MIX), state0=u_star)
    assert not nans.any()
    p.sum().backward()
    dp_dt = t.grad.numpy()
    np.testing.assert_allclose(port[name][3], -par.grad.numpy() / dp_dt[:, None, None],
                               rtol=1e-10, atol=1e-12 * np.abs(port[name][3]).max())
    np.testing.assert_allclose(port[name][4], -kij.grad.numpy() / dp_dt[:, None],
                               rtol=1e-10, atol=1e-12 * np.abs(port[name][4]).max())


def test_pressure_gradient_is_inverse_slope(monkeypatch):
    """dT/dp = 1/(dp/dT) at the temperature and state of the re-attachment."""
    p = _t(P_MIX).requires_grad_()
    t, _ = ft.bubble_point_t(_t(MIXP), _t(KIJ), p, _t(X1), T0)
    t.sum().backward()
    t_star, u_star = _reattached_at("bubble", monkeypatch, _t(P_MIX))
    t_star.requires_grad_()
    pb, _ = ft.bubble_point(_t(MIXP), _t(KIJ), t_star, _t(X1), _t(P_MIX), state0=u_star)
    pb.sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), 1.0 / t_star.grad.numpy(), rtol=1e-12)


def test_dew_above_bubble(solved):
    """At equal pressure and overall composition, dew T >= bubble T; the
    vapor of the bubble point is richer in propane (light)."""
    port, _, _ = solved
    assert np.all(port["dew"][0].numpy() >= port["bubble"][0].numpy() - 1e-10)
    assert np.all(port["bubble"][2][:, 0] > X1)
    assert 0 < port["bubble"][5]["outer"] < 24 and 0 < port["dew"][5]["outer"] < 24


def test_kij_gradient_central_fd(solved):
    """tests/test_tsolve.py::test_mix_bubble_temperature_kij_grad_fd."""
    port, _, _ = solved
    h = 1e-4

    def total(k):
        kij = _t(np.tile([k, 0.0], (3, 1)))
        with torch.no_grad():
            return float(ft.bubble_point_t(_t(MIXP), kij, _t(P_MIX), _t(X1), T0)[0].sum())

    fd = (total(0.02 + h) - total(0.02 - h)) / (2 * h)
    np.testing.assert_allclose(port["bubble"][4][:, 0].sum(), fd, rtol=1e-4)


def test_unreachable_pressure_masked():
    """A target above the critical pressure comes back masked and NaN with a
    finite gradient, and leaves the other rows as they were."""
    par = _t(MIXP).requires_grad_()
    t, nans = ft.bubble_point_t(par, _t(KIJ), _t([2e5, 1e9, 4e5]), _t(X1), T0)
    assert nans.tolist() == [False, True, False]
    assert torch.isnan(t[1]).item()
    with torch.no_grad():
        t_ok, _ = ft.bubble_point_t(_t(MIXP[[0, 2]]), _t(KIJ[[0, 2]]), _t([2e5, 4e5]),
                                    _t(X1[[0, 2]]), T0)
    np.testing.assert_allclose(t.detach().numpy()[[0, 2]], t_ok.numpy(), rtol=1e-12)
    torch.where(nans, 0.0, t).sum().backward()
    assert torch.isfinite(par.grad).all()


def test_facade_and_raises(solved):
    """``PcSaftMix`` gives the functional results; a scalar x1 for three
    components raises (it is the binary convention)."""
    port, _, _ = solved
    eos = ft.PcSaftMix(MIXP, KIJ, device="cpu")
    with torch.no_grad():
        t_b, nans_b, y_b = eos.bubble_point_t(P_MIX, X1, T0, full_output=True)
        t_d, nans_d = eos.dew_point_t(P_MIX, X1, T0)
    assert not nans_b.any() and not nans_d.any()
    np.testing.assert_array_equal(t_b.numpy(), port["bubble"][0].numpy())
    np.testing.assert_array_equal(y_b.numpy(), port["bubble"][2])
    np.testing.assert_array_equal(t_d.numpy(), port["dew"][0].numpy())
    with pytest.raises(ValueError, match="binary"):
        ft.bubble_point_t(_t(np.tile(MIXP[:1, :1], (1, 3, 1))), None, 1e5, _t([0.2]), T0)
