"""The port's association fixed points and mixture building blocks against
the JAX package.

Each ``torch.autograd.Function`` is held to JAX's ``custom_jvp`` on seeded
physical inputs: the solution, and its first and second derivatives with
respect to all 8 inputs (JAX in one jitted function of one shape, which
compiles for about 20 s on a CPU: ``tools/gen_port_fixtures.py`` writes its
values to ``tests/golden/torch_association_jax.npz``).  ``gradcheck`` and
``gradgradcheck`` hold the backward to finite differences up to third
order, and the shared helpers of ``models/common.py`` are held to their JAX
versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_golden import vendored
from feos_tpu.models import common as jcommon
from feos_tpu_torch.models import common
from feos_tpu_torch.ops import association as assoc

N = 64


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float64))


def _cross_args(rng, n):
    """Association strengths in A^3 and site densities in A^-3 as PC-SAFT
    states give them; the cross strengths are the geometric means."""
    delta = np.exp(rng.uniform(np.log(10.0), np.log(5000.0), (n, 2)))
    rho = np.exp(rng.uniform(np.log(1e-5), np.log(1e-2), (n, 2)))
    na, nb = rng.choice([1.0, 2.0], (n, 2)), rng.choice([1.0, 2.0], (n, 2))
    d01 = np.sqrt(delta[:, 0] * delta[:, 1]) * rng.uniform(0.5, 1.5, n)
    return np.stack([delta[:, 0], d01, d01, delta[:, 1], rho[:, 0] * na[:, 0],
                     rho[:, 1] * na[:, 1], rho[:, 0] * nb[:, 0], rho[:, 1] * nb[:, 1]])


def _induced_args(rng, n):
    """``dij = Delta_ij rho_j``; component 1 has no A sites (na1 = 0)."""
    d = np.exp(rng.uniform(np.log(1e-3), np.log(20.0), (4, n)))
    na0 = rng.choice([1.0, 2.0], n)
    nb = rng.choice([1.0, 2.0], (2, n))
    return np.concatenate([d, [na0, np.zeros(n), nb[0], nb[1]]])


def _converged(residual, x, args):
    r = residual(*x, *args)
    r = r if isinstance(r, tuple) else (r,)
    return np.all([np.abs(ri.numpy()) < 1e-12 for ri in r], axis=0)


def _inputs():
    """Seeded inputs of both solvers that reach their root in the port."""
    rng = np.random.default_rng(5)
    cross = _cross_args(rng, 2 * N)
    x = assoc.cross_assoc_iterate(*_t(cross))
    cross = cross[:, _converged(assoc._cross_residual, x, _t(cross))][:, :N]
    induced = _induced_args(rng, 2 * N)
    x = assoc.induced_assoc_iterate(*_t(induced))
    induced = induced[:, _converged(assoc._induced_residual, (x,), _t(induced))][:, :N]
    assert cross.shape[1] == N and induced.shape[1] == N
    return cross, induced


ORDERS = ("value", "first", "second")


def jax_reference():
    """JAX's solution, first and second derivatives of both solvers'
    ``custom_jvp`` on :func:`_inputs`."""
    from feos_tpu.ops import association as jassoc

    cross, induced = _inputs()

    def derivs(f):
        def g(a):
            return jnp.stack(jnp.broadcast_arrays(*f(*a))) if f is jassoc.solve_cross_assoc \
                else f(*a)
        return jax.vmap(lambda a: (g(a), jax.jacfwd(g)(a), jax.hessian(g)(a)), in_axes=1)

    ref = jax.jit(lambda c, i: (derivs(jassoc.solve_cross_assoc)(c),
                                derivs(jassoc.solve_induced_assoc)(i)))
    out = ref(jnp.asarray(cross), jnp.asarray(induced))
    return {"cross": cross, "induced": induced,
            **{f"{name}_{k}": x for name, o in zip(("cross", "induced"), out)
               for k, x in zip(ORDERS, o)}}


@pytest.fixture(scope="module")
def cases():
    """Inputs that reach their root, and JAX's solution, first and second
    derivatives for both solvers (vendored)."""
    cross, induced = _inputs()
    ref = vendored("association", exact={"cross": cross, "induced": induced})
    return {name: (args, tuple(ref[f"{name}_{k}"] for k in ORDERS))
            for name, args in (("cross", cross), ("induced", induced))}


SOLVERS = {"cross": assoc.solve_cross_assoc, "induced": assoc.solve_induced_assoc}


def _port_derivs(name, args):
    """Per element: the solution ``(N, k)``, first derivatives ``(N, k, 8)``
    and second derivatives ``(N, k, 8, 8)`` of the k outputs."""
    a = [x.requires_grad_() for x in _t(args)]
    outs = SOLVERS[name](*a)
    outs = outs if isinstance(outs, tuple) else (outs,)
    val, jac, hess = [], [], []
    for o in outs:
        g = torch.autograd.grad(o.sum(), a, create_graph=True)
        rows = [torch.stack(torch.autograd.grad(gi.sum(), a, retain_graph=True), 1)
                for gi in g]
        val.append(o.detach())
        jac.append(torch.stack([gi.detach() for gi in g], 1))
        hess.append(torch.stack(rows, 1))
    return (torch.stack(val, 1).numpy(), torch.stack(jac, 1).numpy(),
            torch.stack(hess, 1).numpy())


@pytest.mark.parametrize("name", ["cross", "induced"])
@pytest.mark.parametrize("order", [0, 1, 2], ids=["value", "first", "second"])
def test_matches_jax_custom_jvp(cases, name, order):
    """rtol 1e-10, with a floor of 1e-13 of each element's largest entry
    for entries that cancel to near zero."""
    args, ref = cases[name]
    got = _port_derivs(name, args)[order]
    want = ref[order].reshape(got.shape)
    scale = np.abs(want).reshape(len(want), -1).max(1).reshape(-1, *(1,) * (want.ndim - 1))
    worst = np.max(np.abs(got - want) / (1e-10 * np.abs(want) + 1e-13 * scale))
    assert worst <= 1.0, worst


def _well_scaled(name, args):
    """Finite differences perturb by an absolute 1e-6, so the cross
    inputs are rescaled to site densities O(1): Delta -> Delta s and
    rho -> rho / s leave the fixed point unchanged."""
    if name == "cross":
        s = args[4:].max(0)
        args = np.concatenate([args[:4] * s, args[4:] / s])
    return args


@pytest.mark.parametrize("name", ["cross", "induced"])
def test_gradcheck(cases, name):
    args = [x[:6].requires_grad_() for x in _t(_well_scaled(name, cases[name][0]))]
    assert torch.autograd.gradcheck(SOLVERS[name], args)
    assert torch.autograd.gradgradcheck(SOLVERS[name], args)


@pytest.mark.parametrize("name", ["cross", "induced"])
def test_third_order_gradcheck(cases, name):
    """The backward's own backward is exact too: gradgradcheck of the
    gradient, as the bubble identity's parameter gradient needs."""
    args = [x[:4].requires_grad_() for x in _t(_well_scaled(name, cases[name][0]))]

    def grads(*a):
        out = SOLVERS[name](*a)
        out = out if isinstance(out, tuple) else (out,)
        s = sum((o * o).sum() for o in out)
        return torch.autograd.grad(s, a, create_graph=True)

    assert torch.autograd.gradgradcheck(grads, args)


def test_broadcast_inputs_reduce_gradients():
    """Arguments of different shapes broadcast; their gradients come back
    summed to each argument's shape."""
    rng = np.random.default_rng(1)
    args = _induced_args(rng, 3)
    a = [_t(x) for x in args[:4]] + [_t(x[0]).requires_grad_() for x in args[4:]]
    xa = assoc.solve_induced_assoc(*a)
    g = torch.autograd.grad(xa.sum(), a[4:])
    assert all(gi.shape == () for gi in g)


def test_masked_elements_give_unit_site_fractions():
    """Sanitised masked elements (all strengths zero) solve to X = 1."""
    z = torch.zeros(3, dtype=torch.float64)
    r = torch.full((3,), 1e-3, dtype=torch.float64)
    xa0, xa1 = assoc.solve_cross_assoc(z, z, z, z, r, r, r, r)
    assert torch.equal(xa0, torch.ones(3, dtype=torch.float64)) and torch.equal(xa1, xa0)
    one = torch.ones(3, dtype=torch.float64)
    xa = assoc.solve_induced_assoc(z, z, z, z, one, 0 * one, one, one)
    assert torch.equal(xa, one)


def test_common_helpers_match_jax():
    rng = np.random.default_rng(2)
    n = 16
    sigma = rng.uniform(3.0, 4.0, (n, 2))
    kappa = rng.uniform(0.01, 0.04, (n, 2))
    eps_ab = rng.uniform(1000.0, 3000.0, (n, 2))
    d = sigma * 0.95
    t = rng.uniform(200.0, 400.0, n)
    zeta2, zeta3 = rng.uniform(0.01, 0.3, n), rng.uniform(0.01, 0.45, n)
    zeta3_m1 = 1.0 / (1.0 - zeta3)
    eps_aibj = np.where(rng.random(n) < 0.5, 0.0, rng.uniform(1500.0, 2500.0, n))

    def jax_item(fn, *a):
        return np.asarray(jax.vmap(fn)(*(jnp.asarray(x) for x in a)))

    for i, j in ((0, 0), (0, 1), (1, 1)):
        want_t = jax_item(lambda ti, s, k, e, ex: jcommon.assoc_strength_tfactor(
            i, j, ti, s, k, e, epsilon_k_aibj=ex), t, sigma, kappa, eps_ab, eps_aibj)
        got_t = common.assoc_strength_tfactor(i, j, _t(t), _t(sigma), _t(kappa),
                                              _t(eps_ab), _t(eps_aibj))
        np.testing.assert_allclose(got_t.numpy(), want_t, rtol=1e-13, atol=0)
        dd = d[:, i] * d[:, j] / (d[:, i] + d[:, j])
        want_f = jax_item(jcommon.assoc_strength_from_tfactor, want_t, dd, zeta2, zeta3_m1)
        got_f = common.assoc_strength_from_tfactor(_t(want_t), _t(dd), _t(zeta2),
                                                   _t(zeta3_m1))
        np.testing.assert_allclose(got_f.numpy(), want_f, rtol=1e-14, atol=0)
        # the two factors together are JAX's whole association strength
        want = jax_item(lambda ti, s, k, e, di, z2, z3, ex: jcommon.association_strength(
            i, j, ti, s, k, e, di, z2, z3, epsilon_k_aibj=ex),
            t, sigma, kappa, eps_ab, d, zeta2, zeta3_m1, eps_aibj)
        got = common.assoc_strength_from_tfactor(got_t, _t(dd), _t(zeta2), _t(zeta3_m1))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=0)

    x = rng.uniform(0.01, 1.0, n)
    np.testing.assert_allclose(common.site_fraction_free_energy(_t(x)).numpy(),
                               np.asarray(jcommon.site_fraction_free_energy(jnp.asarray(x))),
                               rtol=1e-14)


def test_dipole_matches_jax():
    """precompute_dipole and phi_dipole_pre at seeded binary states, one
    component dipolar, both, or a trace dipolar composition."""
    rng = np.random.default_rng(3)
    n = 12
    m = rng.uniform(1.0, 3.0, (n, 2))
    sigma = rng.uniform(3.0, 4.0, (n, 2))
    eps = rng.uniform(150.0, 300.0, (n, 2))
    mu2 = rng.uniform(0.0, 5.0, (n, 2)) * (rng.random((n, 2)) < 0.7)
    t = rng.uniform(250.0, 400.0, n)
    rho = rng.uniform(1e-4, 1e-2, (n, 2))
    rho[0] = [1e-3, 1e-12]
    eta = rng.uniform(1e-3, 0.45, n)
    etas = eta[:, None] ** np.arange(7)

    def jax_phi(mi, si, ei, m2, ti, r, et):
        dp = jcommon.precompute_dipole(mi, si, ei, m2, ti)
        return dp, jcommon.phi_dipole_pre(dp, 2, r, et)

    want_dp, want = jax.vmap(jax_phi)(*(jnp.asarray(x) for x in (m, sigma, eps, mu2, t, rho, etas)))
    dp = common.precompute_dipole(_t(m), _t(sigma), _t(eps), _t(mu2), _t(t))
    for f in dp._fields:
        np.testing.assert_allclose(getattr(dp, f).numpy(), np.asarray(getattr(want_dp, f)),
                                   rtol=1e-13, atol=0, err_msg=f)
    got = common.phi_dipole_pre(dp, _t(rho), _t(etas), lambda x: x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=0)
