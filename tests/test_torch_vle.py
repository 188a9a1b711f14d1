"""The PyTorch port's pure VLE solver against the JAX package's f64 path.

One batch (a seeded ``make_batch`` sample, the reference's 6-row parameter
grid, the README rows and supercritical rows) goes through the port's
``pure_vle``, through JAX ``vmap(pure_vle(..., mixed_precision=False))`` in
one jit, and through the independent C++ oracle.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_oracle import backend  # noqa: F401 (a fixture)
import feos_tpu_torch as ft
from feos_tpu.models.pcsaft_pure import PureParams as JaxParams
from feos_tpu.solvers.vle import pure_vle as jax_pure_vle
from feos_tpu_torch.solvers import vle

# the reference's 6-row parameter grid and README example
# (tests/test_pcsaft_pure.py: REFERENCE_GRID, README_PARAMS, README_T)
REFERENCE_GRID = [
    [1.5, 3.2, 350, 0, 0, 0, 0, 0],
    [1.5, 3.2, 150, 2.5, 0.03, 2500, 2, 1],
    [1.5, 3.2, 150, 2.5, 0, 2500, 1, 1],
    [1.5, 3.2, 150, 2.5, 0.03, 0, 1, 1],
    [1.5, 3.2, 150, 2.5, 0, 0, 0, 0],
    [1.5, 3.2, 150, 2.5, 0.03, 2500, 0, 2],
]
README_PARAMS = [1.5, 3.5, 250.0, 0.0, 0.03, 1500.0, 1.0, 1.0]
README_T = [250.0, 300.0, 350.0, 400.0, 450.0]
SUPERCRITICAL = [
    ([1.0, 3.5, 150.0, 0, 0, 0, 0, 0], 1000.0),
    (README_PARAMS, 2000.0),
    ([1.5, 3.2, 150, 2.5, 0.03, 2500, 2, 1], 1500.0),
]
N_SUPER = len(SUPERCRITICAL)


def _inputs():
    params, temperature = ft.make_batch(256, seed=3)
    params = np.concatenate([
        params, REFERENCE_GRID, [README_PARAMS] * len(README_T),
        [p for p, _ in SUPERCRITICAL],
    ]).astype(np.float64)
    temperature = np.concatenate([
        temperature, [300.0] * len(REFERENCE_GRID), README_T,
        [t for _, t in SUPERCRITICAL],
    ])
    return params, temperature


@pytest.fixture(scope="module")
def solved(backend):
    """(params, T, port, jax, oracle): each solution as (rho_v, rho_l, ok)."""
    params, temperature = _inputs()
    port = vle.pure_vle(torch.as_tensor(params), torch.as_tensor(temperature))
    port = tuple(x.numpy() for x in port)

    solve = jax.jit(jax.vmap(lambda p, t: jax_pure_vle(p, t, mixed_precision=False)))
    ref = solve(JaxParams.from_array(jnp.asarray(params)), jnp.asarray(temperature))
    ref = tuple(np.asarray(x) for x in ref)

    rho, ok = backend.vapor_pressure_densities(params, temperature)
    oracle = (rho[:, 0], rho[:, 1], ok)
    return params, temperature, port, ref, oracle


def test_masks_agree_with_jax(solved):
    _, _, port, ref, _ = solved
    np.testing.assert_array_equal(port[2], ref[2])


def test_supercritical_rows_masked_others_converge(solved):
    _, _, port, _, _ = solved
    ok = port[2]
    assert not ok[-N_SUPER:].any()
    assert ok[:-N_SUPER].all()
    rho_v, rho_l = port[0][:-N_SUPER], port[1][:-N_SUPER]
    assert np.all(np.isfinite(rho_v)) and np.all(rho_l > rho_v)


@pytest.mark.parametrize("j", [0, 1], ids=["rho_v", "rho_l"])
def test_densities_match_jax(solved, j):
    _, _, port, ref, _ = solved
    both = port[2] & ref[2]
    np.testing.assert_allclose(port[j][both], ref[j][both], rtol=1e-10, atol=0)


@pytest.mark.parametrize("j", [0, 1], ids=["rho_v", "rho_l"])
def test_densities_match_cpp_oracle(solved, j):
    _, _, port, _, oracle = solved
    both = port[2] & oracle[2]
    assert both.sum() >= port[2].sum() - 2  # the oracle's own acceptance differs
    np.testing.assert_allclose(port[j][both], oracle[j][both], rtol=1e-9, atol=0)


def test_equilibrium_conditions_hold(solved):
    """p~ and mu~ of the two phases agree at the port's solution."""
    params, temperature, port, _, _ = solved
    ok = port[2]
    p = ft.PureParams.from_numpy(params[ok], "cpu")
    t = torch.as_tensor(temperature[ok])
    with torch.no_grad():
        rho = torch.as_tensor(np.stack([port[0][ok], port[1][ok]], 1))
        _, d1, _ = ft.phi_d2(torch.as_tensor(params[ok]), t, rho)
        _, pt, dpt = ft.pure_derivatives(p, t, rho)
    # the liquid p~ carries f64 cancellation noise of its terms' size,
    # rho_l dp~/drho_l, which pure_vle's acceptance allows at 4e-12
    noise = 4e-12 * (rho[:, 1] * dpt[:, 1]).abs()
    assert torch.all((pt[:, 0] - pt[:, 1]).abs() <= 1e-8 * pt[:, 1].abs() + noise)
    mu = d1 + torch.log(rho)
    np.testing.assert_allclose(mu[:, 0], mu[:, 1], rtol=0, atol=1e-8)


def test_rows_do_not_depend_on_batch(solved):
    """Per-row freezing: a row solved alone equals the same row in the batch."""
    params, temperature, port, _, _ = solved
    rows = [0, 100, 256, 262, len(params) - 1]
    alone = [
        vle.pure_vle(torch.as_tensor(params[i:i + 1]),
                     torch.as_tensor(temperature[i:i + 1]))
        for i in rows
    ]
    for i, (rho_v, rho_l, ok) in zip(rows, alone):
        assert bool(ok[0]) == port[2][i]
        if port[2][i]:
            np.testing.assert_allclose(
                [rho_v[0], rho_l[0]], [port[0][i], port[1][i]], rtol=1e-13, atol=0
            )


def test_stats_count_every_phi_d2_call(monkeypatch):
    """``stats["phi_d2_calls"]`` equals the calls the solve makes, which is
    what a launch count on the card is checked against."""
    calls = []

    def counting(*args):
        calls.append(args[2].shape)
        return ft.phi_d2(*args)

    monkeypatch.setattr(vle, "phi_d2", counting)
    params, temperature = _inputs()
    stats = {}
    vle.pure_vle(torch.as_tensor(params[250:270]), torch.as_tensor(temperature[250:270]),
                 stats=stats)
    assert stats["phi_d2_calls"] == len(calls) == 1 + stats["npt"] + stats["newton"]
    assert calls[0] == (20, len(vle._ETA_GRID))
