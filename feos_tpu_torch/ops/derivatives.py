"""Density derivatives of elementwise functions.

Counterpart of ``feos_tpu/ops/derivatives.py::value_and_2derivs``.  The
function is applied to whole ``(B, ...)`` tensors in which every element is
an independent scalar state, so the gradient of ``f(x).sum()`` is the
elementwise derivative f'(x), with no ``vmap``.

The JAX package nests two forward-mode jvps.  Here the two derivatives come
from reverse mode twice (``torch.autograd.grad``), which gives the same
derivatives to rounding and runs much faster in eager PyTorch: on the CPU, nested ``torch.func.jvp`` over ``phi_pure_pre`` took
90 ms a call at B=5, k=2 against 5.6 ms for this form, because PyTorch's
forward-mode rules for scalar operands run as Python decompositions.
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
