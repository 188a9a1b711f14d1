"""The port's gc cross-association fixed point (nA = nB = 1) against the JAX
package.

``SolveCrossAssocSym`` is held to JAX's ``solve_cross_assoc_sym``
``custom_jvp`` on seeded inputs of the size gc states give it (dij =
Delta_ij rho_j): the solution at 1e-12, and its first and second
derivatives with respect to all 4 inputs at 1e-10, JAX in one jitted
function of one shape.  ``gradcheck`` and ``gradgradcheck`` hold the
backward to finite differences up to third order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feos_tpu.ops import association as jassoc
from feos_tpu_torch.ops import association as assoc

N = 64


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float64))


def _args(rng, n):
    """dij = Delta_ij rho_j from 1e-3 to 30, the cross strengths about the
    geometric means of the self strengths."""
    d = np.exp(rng.uniform(np.log(1e-3), np.log(30.0), (2, n)))
    r = np.exp(rng.uniform(np.log(0.3), np.log(3.0), n))
    d01 = np.sqrt(d[0] * d[1]) * rng.uniform(0.5, 1.5, n)
    return np.stack([d[0], d01 * r, d01 / r, d[1]])


@pytest.fixture(scope="module")
def case():
    """Inputs that reach their root, and JAX's solution, first and second
    derivatives."""
    rng = np.random.default_rng(9)
    args = _args(rng, 2 * N)
    x = assoc.cross_assoc_sym_iterate(*_t(args))
    res = assoc._cross_sym_residual(*x, *_t(args))
    args = args[:, np.all([np.abs(r.numpy()) < 1e-12 for r in res], 0)][:, :N]
    assert args.shape[1] == N

    def g(a):
        return jnp.stack(jassoc.solve_cross_assoc_sym(*a))

    ref = jax.jit(jax.vmap(lambda a: (g(a), jax.jacfwd(g)(a), jax.hessian(g)(a)), in_axes=1))
    return args, jax.tree_util.tree_map(np.asarray, ref(jnp.asarray(args)))


def _port_derivs(args):
    """Per element: the solution ``(N, 2)``, first derivatives ``(N, 2, 4)``
    and second derivatives ``(N, 2, 4, 4)``."""
    a = [x.requires_grad_() for x in _t(args)]
    val, jac, hess = [], [], []
    for o in assoc.solve_cross_assoc_sym(*a):
        g = torch.autograd.grad(o.sum(), a, create_graph=True)
        rows = [torch.stack(torch.autograd.grad(gi.sum(), a, retain_graph=True), 1) for gi in g]
        val.append(o.detach())
        jac.append(torch.stack([gi.detach() for gi in g], 1))
        hess.append(torch.stack(rows, 1))
    return (torch.stack(val, 1).numpy(), torch.stack(jac, 1).numpy(),
            torch.stack(hess, 1).numpy())


@pytest.mark.parametrize("order,rtol", [(0, 1e-12), (1, 1e-10), (2, 1e-10)],
                         ids=["value", "first", "second"])
def test_matches_jax_custom_jvp(case, order, rtol):
    """With a floor of 1e-13 of each element's largest entry for entries
    that cancel to near zero."""
    args, ref = case
    got = _port_derivs(args)[order]
    want = ref[order].reshape(got.shape)
    scale = np.abs(want).reshape(len(want), -1).max(1).reshape(-1, *(1,) * (want.ndim - 1))
    worst = np.max(np.abs(got - want) / (rtol * np.abs(want) + 1e-13 * scale))
    assert worst <= 1.0, worst


def test_gradcheck(case):
    args = [x[:6].requires_grad_() for x in _t(case[0])]
    assert torch.autograd.gradcheck(assoc.solve_cross_assoc_sym, args)
    assert torch.autograd.gradgradcheck(assoc.solve_cross_assoc_sym, args)


def test_third_order_gradcheck(case):
    """The backward's own backward is exact too, as the bubble identity's
    parameter gradient needs."""
    args = [x[:4].requires_grad_() for x in _t(case[0])]

    def grads(*a):
        s = sum((o * o).sum() for o in assoc.solve_cross_assoc_sym(*a))
        return torch.autograd.grad(s, a, create_graph=True)

    assert torch.autograd.gradgradcheck(grads, args)


def test_masked_elements_give_unit_site_fractions():
    """Sanitised masked elements (all strengths zero) solve to X = 1."""
    z = torch.zeros(3, dtype=torch.float64)
    xa0, xa1 = assoc.solve_cross_assoc_sym(z, z, z, z)
    assert torch.equal(xa0, torch.ones(3, dtype=torch.float64)) and torch.equal(xa1, xa0)


def test_broadcast_inputs_reduce_gradients():
    args = _args(np.random.default_rng(1), 3)
    a = [_t(x) for x in args[:3]] + [_t(args[3, 0]).requires_grad_()]
    xa0, xa1 = assoc.solve_cross_assoc_sym(*a)
    (g,) = torch.autograd.grad((xa0 + xa1).sum(), a[3:])
    assert g.shape == ()
