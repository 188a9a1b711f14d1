"""The port's bubble and dew temperatures of config 3 of
``benchmarks/run_all.py`` (a cross-associating pair with kij and eps_AiBj)
against the JAX package.

The port's bubble (dew) pressures at T = linspace(140, 160, 4), x1 = 0.5 are
the targets; the temperature solves from 1.05 T must recover T.  JAX's
pressure solvers with every cross-association branch compile for about a
minute here, so JAX holds the result through ``jacfwd`` of its f64
stationary identity at the port's densities, in one jit for both
directions: the identity's value at the port's temperatures is the target
pressure, and -(dp/dtheta)/(dp/dT) is the port's temperature gradient in
kij and eps_AiBj.  That jit compiles for about 45 s on a CPU, so
``tools/gen_port_fixtures.py`` writes its values, with the port's
temperatures and densities they were taken at, to
``tests/golden/torch_mix_tsolve_cross_jax.npz``.
"""

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from _torch_golden import vendored

CONFIG3 = np.tile([[1, 3.5, 150, 0, 0.02, 1500, 1, 1], [1, 3.5, 200, 0, 0.03, 2500, 1, 1]],
                  (4, 1, 1)).astype(float)
KIJ3 = np.tile([-0.15, 1000.0], (4, 1))
T3 = np.linspace(140.0, 160.0, 4)
X1 = np.full(4, 0.5)
DIRECTIONS = {"bubble": (ft.bubble_point_t, ft.bubble_point),
              "dew": (ft.dew_point_t, ft.dew_point)}


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _identity_pa(p, k, t, r_inc, r_bulk):
    """The stationary bubble/dew identity in Pa, per row, from JAX's f64
    pieces with the cross-association branch."""
    import jax.numpy as jnp
    from feos_tpu.models import pcsaft_mix as jmix
    from feos_tpu.ops.derivatives import pressure_set as jpressure_set
    from feos_tpu.units import REDUCED_TO_PA_PER_KT

    pre = jmix.precompute_mix(jmix.MixParams.from_array(p), k[0], k[1], t)

    def phi(x):
        return jmix.phi_mix_pre(pre, x, branches=frozenset({"cross"}))

    _, p_b, g_b, v_b = jpressure_set(phi, r_bulk)
    mu_b = jnp.log(r_bulk) + g_b
    rho_t = r_inc.sum()
    w = r_inc / rho_t
    v_bulk = (w * v_b).sum()
    g_bulk = (w * (jnp.log(r_inc) - mu_b)).sum()
    ident = -(phi(r_inc) / rho_t + p_b * v_bulk + g_bulk - 1.0) / (1.0 / rho_t - v_bulk)
    return ident * t * REDUCED_TO_PA_PER_KT


def _port():
    """Per direction: the targets, the port's (T, nans, dT/dparams,
    dT/dkij) and its densities at T."""
    par, kij, x1 = _t(CONFIG3), _t(KIJ3), _t(X1)
    port, dens = {}, []
    for name, (fn_t, fn_p) in DIRECTIONS.items():
        with torch.no_grad():
            target, nans = fn_p(par, kij, _t(T3), x1, _t(np.full(4, 1e5)))
        assert not nans.any()
        p_in, k_in = par.clone().requires_grad_(), kij.clone().requires_grad_()
        stats = {}
        t, nans = fn_t(p_in, k_in, target, x1, _t(1.05 * T3), stats=stats)
        t.sum().backward()
        with torch.no_grad():
            p_back, nans_b, state = fn_p(par, kij, t, x1, target, state_output=True)
        assert not nans_b.any()
        port[name] = (target.numpy(), t.detach().numpy(), nans.numpy(), p_in.grad.numpy(),
                      k_in.grad.numpy(), p_back.numpy(), stats)
        u = state.numpy()
        dens.append((np.exp(u[:, :2]), np.stack([X1, 1.0 - X1], 1) * np.exp(u[:, 2:3])))
    t = np.concatenate([port["bubble"][1], port["dew"][1]])
    return port, {"t": t, "r_inc": np.concatenate([d[0] for d in dens]),
                  "r_bulk": np.concatenate([d[1] for d in dens])}


def jax_reference():
    """JAX's identity value and its Jacobians in kij and T, both directions
    stacked, at the port's temperatures and densities."""
    import jax

    _, at = _port()
    ref = jax.jit(jax.vmap(jax.jacfwd(lambda *a: (_identity_pa(*a),) * 2, argnums=(1, 2),
                                      has_aux=True)))
    (j_kij, j_t), value = ref(np.concatenate([CONFIG3, CONFIG3]),
                              np.concatenate([KIJ3, KIJ3]), at["t"], at["r_inc"], at["r_bulk"])
    return {"config3": CONFIG3, "kij3": KIJ3, "x1": X1, **at,
            "value": value, "j_kij": j_kij, "j_t": j_t}


@pytest.fixture(scope="module")
def solved():
    """Per direction: the port's results, and JAX's identity value and
    dT/dkij = -(dp/dkij)/(dp/dT) at the port's temperatures and densities
    (vendored)."""
    port, at = _port()
    ref = vendored("mix_tsolve_cross", exact={"config3": CONFIG3, "kij3": KIJ3, "x1": X1},
                   close=at)
    value, j_kij, j_t = ref["value"], ref["j_kij"], ref["j_t"]
    jax_out = {name: (value[sl], -j_kij[sl] / j_t[sl, None])
               for name, sl in (("bubble", slice(0, 4)), ("dew", slice(4, 8)))}
    return port, jax_out


@pytest.mark.parametrize("name", list(DIRECTIONS))
def test_recovers_temperature(solved, name):
    """Every row converges, T recovers the temperatures of the targets
    within 1e-9, and the port's pressure at T is the target within 1e-9."""
    port, _ = solved
    target, t, nans, _, _, p_back, stats = port[name][:7]
    assert not nans.any() and 0 < stats["outer"] < 24
    np.testing.assert_allclose(t, T3, rtol=1e-9)
    np.testing.assert_allclose(p_back, target, rtol=1e-9)


@pytest.mark.parametrize("name", list(DIRECTIONS))
def test_jax_identity_is_the_target(solved, name):
    """JAX's f64 identity at the port's densities and temperatures gives the
    target pressure."""
    port, ref = solved
    np.testing.assert_allclose(ref[name][0], port[name][0], rtol=1e-9)


@pytest.mark.parametrize("name", list(DIRECTIONS))
def test_gradients_match_jax_identity(solved, name):
    """dT/d(kij, eps_AiBj) against -(dp/dtheta)/(dp/dT) of JAX's f64
    identity, within 1e-9 of each row's largest entry (the parameter
    columns are held to the port's own identity in test_torch_mix_tsolve.py
    and, as pressure gradients, to JAX's in test_torch_mix_jax_grad.py)."""
    port, ref = solved
    got, want = port[name][4], ref[name][1]
    scale = np.abs(want).reshape(len(want), -1).max(1)
    err = np.abs(got - want).reshape(len(want), -1) / scale[:, None]
    assert err.max() < 1e-9, err.max()
