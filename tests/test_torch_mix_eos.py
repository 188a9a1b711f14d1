"""The PyTorch port's binary-mixture EOS against the JAX package.

The golden file holds the reference's phi and derivative set in 14 regimes;
a seeded batch of binary states in every regime (none, dipolar, self,
cross with and without an eps_AiBj override, induced) goes through the
port and through JAX's ``derivatives`` and ``precompute_mix`` in one jitted
function of one shape.  The Jacobians of the derivative set in the
parameters and kij are held to JAX's ``jacfwd`` by regime: the rows without
association here, the self- and induced-associating rows in
``test_torch_mix_eos_self.py`` and ``test_torch_mix_eos_induced.py``, and the
cross-associating rows in ``test_torch_mix_jax_grad.py`` (JAX compiles each
branch set for 15-40 s on a CPU, too long for one file).  The last test
holds the port free of JAX imports.
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from feos_tpu.models import pcsaft_mix as jmix
from feos_tpu.ops.derivatives import pressure_set as jpressure_set
from feos_tpu_torch.models import pcsaft_mix as mix

REPO = Path(__file__).resolve().parent.parent
GOLDEN = json.loads((REPO / "tests" / "golden" / "mix_helmholtz.json").read_text())
REGIMES = ("none", "dipolar", "self", "cross", "cross_eps", "induced")
N_PER_REGIME = 6
ETAS = (1e-3, 0.2, 0.45)  # vapor-like, intermediate, liquid packing fractions


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _mix_states(seed=7):
    """``(params (B, 2, 8), kij (B, 2), T (B,), rho (B, 2))``: N_PER_REGIME
    seeded systems per regime, each at the three packing fractions."""
    rng = np.random.default_rng(seed)
    rows, kijs = [], []
    for regime in REGIMES:
        for _ in range(N_PER_REGIME):
            p = np.zeros((2, 8))
            p[:, 0] = rng.uniform(1.0, 3.0, 2)
            p[:, 1] = rng.uniform(3.0, 4.0, 2)
            p[:, 2] = rng.uniform(150.0, 300.0, 2)
            kij = [rng.uniform(-0.1, 0.1), 0.0]
            if regime == "dipolar":
                p[0, 3] = rng.uniform(0.5, 3.0)
                p[1, 3] = rng.choice([0.0, rng.uniform(0.5, 3.0)])
            assoc = {"self": [0], "cross": [0, 1], "cross_eps": [0, 1],
                     "induced": [0]}.get(regime, [])
            for i in assoc:
                p[i, 4] = rng.uniform(0.01, 0.04)
                p[i, 5] = rng.uniform(1000.0, 3000.0)
                p[i, 6] = rng.choice([1.0, 2.0])
                p[i, 7] = rng.choice([1.0, 2.0])
            if regime == "induced":
                p[1, 4] = rng.uniform(0.01, 0.04)
                p[1, 5] = rng.uniform(1000.0, 3000.0)
                p[1, 7] = rng.choice([1.0, 2.0])
            if regime == "cross_eps":
                kij[1] = rng.uniform(1500.0, 2500.0)
            rows.append(p)
            kijs.append(kij)
    params = np.repeat(np.asarray(rows), len(ETAS), axis=0)
    kij = np.repeat(np.asarray(kijs), len(ETAS), axis=0)
    B = params.shape[0]
    temperature = rng.uniform(250.0, 400.0, B)
    x1 = rng.uniform(0.05, 0.95, B)
    z = np.stack([x1, 1.0 - x1], 1)
    m, sigma, eps = params[..., 0], params[..., 1], params[..., 2]
    d = sigma * (1.0 - 0.12 * np.exp(-3.0 * eps / temperature[:, None]))
    eta_m = np.pi / 6.0 * (z * m * d**3).sum(1)
    eta = np.tile(ETAS, B // len(ETAS))
    return params, kij, temperature, z * (eta / eta_m)[:, None]


# the six scalars of a state's derivative set, in the order of _flat
OUTPUTS = ("A", "p", "mu0", "mu1", "v0", "v1")


def _flat(a, p, mu, v):
    """``(B, 6)`` = [A, p~, mu_0, mu_1, v_0, v_1] per row."""
    return torch.cat([a[:, None], p[:, None], mu, v], 1)


def regime_rows(*names):
    """Mask of the rows of :func:`_mix_states` in the named regimes."""
    return np.repeat(np.isin(REGIMES, names), N_PER_REGIME * len(ETAS))


def jax_derivative_set(branches):
    """Per state, JAX's ``[A, p~, mu_0, mu_1, v_0, v_1]`` as a function of
    the ``(2, 8)`` parameters, ``(2,)`` kij, T and the ``(2,)`` density."""
    def item(p, k, t, r):
        pre = jmix.precompute_mix(jmix.MixParams.from_array(p), k[0], k[1], t)
        a, pt, mu, v = jpressure_set(lambda x: jmix.phi_mix_pre(pre, x, branches=branches), r)
        return jnp.concatenate([a[None], pt[None], mu, v])
    return item


def regime_jacobians(regimes, branches, keep=None):
    """The port's and JAX's Jacobians (:func:`port_jacobians`) on the states
    of the named regimes (and of ``keep``, a mask over them), JAX's with
    one jitted ``jacfwd`` under the phi branch set ``branches``."""
    args = tuple(x[regime_rows(*regimes)] for x in _mix_states())
    if keep is not None:
        args = tuple(x[keep(*args)] for x in args)
    item = jax_derivative_set(frozenset(branches))
    want = jax.jit(jax.vmap(jax.jacfwd(item, argnums=(0, 1))))(*args)
    return port_jacobians(*args), want


def port_jacobians(params, kij, temperature, rho):
    """The port's Jacobians of the six outputs in the parameters ``(B, 6, 2,
    8)`` and kij ``(B, 6, 2)``, by reverse mode over each output's row sum
    (rows are independent)."""
    p, k = _t(params).requires_grad_(), _t(kij).requires_grad_()
    out = _flat(*mix.derivatives(p, k, _t(temperature), _t(rho)))
    gp, gk = zip(*(torch.autograd.grad(out[:, j].sum(), (p, k), retain_graph=True)
                   for j in range(len(OUTPUTS))))
    return torch.stack(gp, 1).numpy(), torch.stack(gk, 1).numpy()


def assert_rows_close(got, want):
    """rtol 1e-10, with a floor of 1e-12 of each row's largest entry for
    entries that cancel to near zero."""
    got, want = got.reshape(len(got), -1), np.asarray(want).reshape(len(want), -1)
    scale = np.abs(want).max(1, keepdims=True)
    worst = np.max(np.abs(got - want) / (1e-10 * np.abs(want) + 1e-12 * scale))
    assert worst <= 1.0, worst


def assert_jacobians_match(got, want, j):
    """Output ``j``'s Jacobians in the parameters and in kij, row by row."""
    for g, w in zip(got, want):
        assert_rows_close(g[:, j], np.asarray(w)[:, j])


@pytest.fixture(scope="module")
def states():
    """(inputs, port (A, p, mu, v), JAX (A, p, mu, v), JAX MixPre leaves)."""
    params, kij, temperature, rho = _mix_states()
    with torch.no_grad():
        port = mix.derivatives(_t(params), _t(kij), _t(temperature), _t(rho))
    port = tuple(x.numpy() for x in port)
    br = jmix.static_branches(params)

    @jax.jit
    def ref(params, kij, temperature, rho):
        out = jmix.derivatives(params, kij, temperature, rho, branches=br)
        pre = jax.vmap(jmix.precompute_mix)(
            jmix.MixParams.from_array(params), kij[:, 0], kij[:, 1], temperature)
        return out, pre

    out, pre = ref(params, kij, temperature, rho)
    return ((params, kij, temperature, rho), port,
            tuple(np.asarray(x) for x in out), jax.tree_util.tree_map(np.asarray, pre))


def test_every_regime_is_present(states):
    (params, kij, temperature, rho), *_ = states
    pre = mix.precompute_mix(mix.MixParams.from_tensor(_t(params)), _t(kij[:, 0]),
                             _t(kij[:, 1]), _t(temperature))
    assert pre.self_m.any() and pre.cross_m.any() and pre.induced_m.any()
    assert pre.dipolar.any()
    assert (~(pre.self_m | pre.cross_m | pre.induced_m | pre.dipolar)).any()
    assert pre.branches == jmix.static_branches(params) == frozenset(mix.BRANCHES)


@pytest.mark.parametrize("j", range(4), ids=["A", "p", "mu", "v"])
def test_derivatives_match_jax(states, j):
    _, port, ref, _ = states
    np.testing.assert_allclose(port[j], ref[j], rtol=1e-12, atol=0)


def test_precompute_matches_jax(states):
    (params, kij, temperature, _), _, _, ref = states
    pre = mix.precompute_mix(mix.MixParams.from_numpy(params, "cpu"), _t(kij[:, 0]),
                             _t(kij[:, 1]), _t(temperature))
    for name in mix.MixPre._fields:
        if name == "branches":  # JAX's MixPre leaves it to static_branches
            continue
        got, want = getattr(pre, name), getattr(ref, name)
        if name == "dip":
            for f in got._fields:
                np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f),
                                           rtol=1e-13, atol=0, err_msg=f"dip.{f}")
        elif got.dtype == torch.bool:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=0, err_msg=name)


def test_q_form_matches_exact_values_and_first_derivatives(states):
    """The Q form is stationary in the site fractions: its value and
    first density derivatives equal the exact phi's where the site
    fractions reach their root.  At liquid packing (eta = 0.45) one seeded
    induced state (na = 2, eps_ab/T = 9) drives the damped Newton toward
    X = 0 in both packages, so the liquid states are left out."""
    (params, kij, temperature, rho), *_ = states
    keep = np.arange(len(rho)) % len(ETAS) < 2
    params, kij, temperature, rho = params[keep], kij[keep], temperature[keep], rho[keep]
    pre = mix.precompute_mix(mix.MixParams.from_tensor(_t(params)), _t(kij[:, 0]),
                             _t(kij[:, 1]), _t(temperature))
    r = _t(rho).requires_grad_()
    vals, grads = [], []
    for q in (False, True):
        phi = mix.phi_mix_pre(pre, r, assoc_q_form=q)
        vals.append(phi.detach().numpy())
        grads.append(torch.autograd.grad(phi.sum(), r)[0].numpy())
    np.testing.assert_allclose(vals[1], vals[0], rtol=1e-12, atol=1e-16)
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-10, atol=1e-13)


def _golden_inputs():
    n = len(GOLDEN["params"])
    return (_t(GOLDEN["params"]), _t(GOLDEN["kij"]), _t(np.full(n, GOLDEN["temperature"])),
            _t(np.tile(GOLDEN["density"], (n, 1))))


def test_helmholtz_energy_density_golden():
    with torch.no_grad():
        a = mix.helmholtz_energy_density(*_golden_inputs())
    np.testing.assert_allclose(a.numpy(), GOLDEN["a"], rtol=0, atol=1e-14)


@pytest.mark.parametrize("j,key,atol", [(0, "a", 1e-14), (1, "p", 1e-14), (2, "mu", 1e-14),
                                        (3, "v", 1e-11)], ids=["A", "p", "mu", "v"])
def test_derivatives_golden(j, key, atol):
    """A, p~, mu_i, v_i against the reference's DualTensor values, all 14
    regimes (tests/test_pcsaft_mix.py:36-60)."""
    with torch.no_grad():
        out = mix.derivatives(*_golden_inputs())
    np.testing.assert_allclose(out[j].numpy(), GOLDEN[key], rtol=0, atol=atol)


def test_facade_derivatives_golden():
    n = len(GOLDEN["params"])
    eos = ft.PcSaftMix(GOLDEN["params"], GOLDEN["kij"], device="cpu")
    a, p, mu, v = eos.derivatives(np.full(n, GOLDEN["temperature"]),
                                  np.tile(GOLDEN["density"], (n, 1)))
    np.testing.assert_allclose(a.detach().numpy(), GOLDEN["a"], rtol=0, atol=1e-14)
    np.testing.assert_allclose(v.detach().numpy(), GOLDEN["v"], rtol=0, atol=1e-11)
    phi = eos.helmholtz_energy_density(np.full(n, GOLDEN["temperature"]),
                                       np.tile(GOLDEN["density"], (n, 1)))
    np.testing.assert_allclose(phi.detach().numpy(), GOLDEN["a"], rtol=0, atol=1e-14)


def test_stacked_states_match_rowwise():
    """A ``(B, k, n)`` density evaluates each of the k states with its row's
    parameters."""
    params, kij, temperature, rho = _golden_inputs()
    stacked = torch.stack([rho, 0.5 * rho, 2.0 * rho], 1)
    with torch.no_grad():
        got = mix.helmholtz_energy_density(params, kij, temperature, stacked)
        for k, s in enumerate((1.0, 0.5, 2.0)):
            want = mix.helmholtz_energy_density(params, kij, temperature, s * rho)
            np.testing.assert_allclose(got[:, k].numpy(), want.numpy(), rtol=1e-14, atol=0)


def test_mix_reduces_to_pure_at_trace_dilution():
    """phi of a binary with a vanishing second component equals pure phi
    (tests/test_pcsaft_mix.py::test_mix_reduces_to_pure_at_trace_dilution)."""
    comp1 = [1.5, 3.2, 150, 2.5, 0.03, 2500, 1, 1]
    comp2 = [1.0, 3.0, 100, 0, 0, 0, 0, 0]
    with torch.no_grad():
        a_mix = mix.helmholtz_energy_density(_t([[comp1, comp2]]), None, _t([300.0]),
                                             _t([[0.004, 1e-30]]))
        a_pure = ft.phi_pure(ft.PureParams.from_numpy([comp1], "cpu"), _t([300.0]),
                             _t([0.004]))
    np.testing.assert_allclose(a_mix.numpy(), a_pure.numpy(), rtol=1e-12)


def test_parameter_gradients_are_finite_in_every_regime(states):
    """Autograd of sum(v) through the sanitised masked regimes gives finite
    gradients in the parameters and kij (a NaN from an unselected branch
    would survive torch.where)."""
    (params, kij, temperature, rho), *_ = states
    p, k = _t(params).requires_grad_(), _t(kij).requires_grad_()
    _, pt, mu, v = mix.derivatives(p, k, _t(temperature), _t(rho))
    gp, gk = torch.autograd.grad(pt.sum() + mu.sum() + v.sum(), (p, k))
    assert torch.isfinite(gp).all() and torch.isfinite(gk).all()


@pytest.fixture(scope="module")
def jacobians():
    return regime_jacobians(("none", "dipolar"), {"dipole"})


@pytest.mark.parametrize("j", range(len(OUTPUTS)), ids=OUTPUTS)
def test_parameter_gradients_match_jax(jacobians, j):
    """d(A, p~, mu, v)/d(parameters, kij) against JAX's jacfwd on the 36
    states without association, with and without dipoles."""
    assert_jacobians_match(*jacobians, j)


def test_port_imports_no_jax():
    """No file of the port, and not chip_smoke.py, imports jax or feos_tpu."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|feos_tpu)(\.|\s|$)", re.M)
    files = sorted((REPO / "feos_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert offenders == []
