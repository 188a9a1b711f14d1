"""Density derivatives of Helmholtz energy densities.

Counterpart of ``feos_tpu/ops/derivatives.py``: ``value_and_2derivs`` for
pure fluids, ``state_derivatives`` and ``pressure_set`` for mixtures.  The
functions are applied to whole ``(B, ...)`` tensors in which every row is an
independent state, so the gradient of ``f(x).sum()`` is every row's own
derivative, with no ``vmap``.

The JAX package nests forward-mode jvps.  Here the derivatives come from
reverse mode (``torch.autograd.grad``), which gives the same derivatives to
rounding and runs much faster in eager PyTorch: on the CPU, nested
``torch.func.jvp`` over ``phi_pure_pre`` took 90 ms a call at B=5, k=2
against 5.6 ms for this form, because PyTorch's forward-mode rules for
scalar operands run as Python decompositions.
"""

from __future__ import annotations

import torch


def value_and_2derivs(f, x):
    """Return ``(f(x), f'(x), f''(x))`` for an elementwise function ``f``.

    Under ``torch.no_grad()`` the results are detached; with grad mode on
    they stay differentiable in whatever ``f`` closes over (parameters).
    """
    keep_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        if not x.requires_grad:
            x = x.detach().requires_grad_()
        val = f(x)
        (d1,) = torch.autograd.grad(val.sum(), x, create_graph=True)
        (d2,) = torch.autograd.grad(d1.sum(), x, create_graph=keep_graph)
    if not keep_graph:
        val, d1 = val.detach(), d1.detach()
    return val, d1, d2


def state_derivatives(phi_fn, rho):
    """First and mixed second derivatives of A(n, V) = phi(n/V) V at V = 1.

    ``phi_fn`` maps partial densities ``(B, n)`` to phi ``(B,)``.  Returns
    ``(A, mu, A_V, A_nV, A_VV)``: ``mu (B, n) = dA/dn_i``, ``A_V = dA/dV``,
    ``A_nV (B, n) = d2A/dn_i dV`` and ``A_VV = d2A/dV2``, all at n = rho.
    Rows are independent, so two reverse passes over the row sum give
    every row's gradient and its V-derivative.  Under ``torch.no_grad()``
    the results are detached; with grad mode on they stay differentiable
    in whatever ``phi_fn`` closes over.
    """
    n = rho.shape[-1]
    keep_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        u = torch.cat([rho, torch.ones_like(rho[..., :1])], -1)
        if not u.requires_grad:
            u.requires_grad_()
        val = phi_fn(u[..., :n] / u[..., n:]) * u[..., n]
        (grad,) = torch.autograd.grad(val.sum(), u, create_graph=True)
        (grad_v,) = torch.autograd.grad(grad[..., n].sum(), u, create_graph=keep_graph)
    if not keep_graph:
        val, grad = val.detach(), grad.detach()
    return val, grad[..., :n], grad[..., n], grad_v[..., :n], grad_v[..., n]


def pressure_set(phi_fn, rho):
    """(A, p~, mu, v) of mixture states ``rho (B, n)``, as the reference's
    ``derivatives`` (feos_torch/pcsaft_mix.py:395-420):

        p~  = sum(rho) - dA/dV
        mu_i = dA/dn_i                      (residual, reduced)
        v_i  = -(1 - d2A/dn_i dV) / (-sum(rho) - d2A/dV2)

    ``v_i`` are reduced partial molar volumes.
    """
    val, mu, a_v, a_nv, a_vv = state_derivatives(phi_fn, rho)
    rho_tot = rho.sum(-1)
    p = rho_tot - a_v
    v = -(1.0 - a_nv) / (-rho_tot - a_vv)[..., None]
    return val, p, mu, v
