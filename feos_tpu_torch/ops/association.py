"""Association site-fraction solvers (cross, induced and gc cross regimes).

Counterpart of ``feos_tpu/ops/association.py``.  Each solver is a
``torch.autograd.Function``, the counterpart of the JAX ``custom_jvp``:

* ``forward`` runs the fixed ``_N_ITER`` damped Newton steps with analytic
  Jacobians under ``no_grad`` (negative iterates are pulled back to 0.2x
  the previous value), elementwise over tensors of any one shape;
* ``backward`` applies the implicit-function theorem at the saved solution
  x*: with F(x*, theta) = 0 the cotangent of theta is -(dF/dtheta)^T
  J^-T g, with the 1x1 or 2x2 solve in closed form and the vector-Jacobian
  product of the residual in theta at fixed x* from ``torch.func.vjp``.
  It is written in differentiable torch ops from the saved output, so
  differentiating it again reaches this backward once more: derivatives
  of every order are exact, as the JAX rule's are, and no iteration is
  ever differentiated.

Residual conventions follow the reference exactly.
"""

from __future__ import annotations

import torch

_N_ITER = 30


def _safe(d):
    """Guard a denominator against the sanitised (masked-out) elements,
    where the residuals are identically zero."""
    return torch.where(d.abs() > 1e-30, d, 1.0)


# ---------------------------------------------------------------------------
# Cross association: two self-associating components, 2 unknowns (XA0, XA1)
# ---------------------------------------------------------------------------


def _cross_residual(xa0, xa1, d00, d01, d10, d11, rhoa0, rhoa1, rhob0, rhob1):
    w0 = 1.0 + xa0 * rhoa0 * d00 + xa1 * rhoa1 * d01
    w1 = 1.0 + xa0 * rhoa0 * d10 + xa1 * rhoa1 * d11
    f0 = xa0 - 1.0 + xa0 / w0 * rhob0 * d00 + xa0 / w1 * rhob1 * d01
    f1 = xa1 - 1.0 + xa1 / w0 * rhob0 * d10 + xa1 / w1 * rhob1 * d11
    return f0, f1


def _cross_jac(xa0, xa1, d00, d01, d10, d11, rhoa0, rhoa1, rhob0, rhob1):
    """Analytic 2x2 Jacobian of the cross residual w.r.t. (xa0, xa1)."""
    w0 = 1.0 + xa0 * rhoa0 * d00 + xa1 * rhoa1 * d01
    w1 = 1.0 + xa0 * rhoa0 * d10 + xa1 * rhoa1 * d11
    q00 = rhob0 * d00 / w0
    q01 = rhob1 * d01 / w1
    q10 = rhob0 * d10 / w0
    q11 = rhob1 * d11 / w1
    j00 = 1.0 + q00 + q01 - xa0 * (q00 / w0 * rhoa0 * d00 + q01 / w1 * rhoa0 * d10)
    j01 = -xa0 * (q00 / w0 * rhoa1 * d01 + q01 / w1 * rhoa1 * d11)
    j10 = -xa1 * (q10 / w0 * rhoa0 * d00 + q11 / w1 * rhoa0 * d10)
    j11 = 1.0 + q10 + q11 - xa1 * (q10 / w0 * rhoa1 * d01 + q11 / w1 * rhoa1 * d11)
    return j00, j01, j10, j11


def _solve22(j00, j01, j10, j11, b0, b1):
    det = _safe(j00 * j11 - j01 * j10)
    return (j11 * b0 - j01 * b1) / det, (-j10 * b0 + j00 * b1) / det


@torch.no_grad()
def cross_assoc_iterate(*args):
    """The forward solve of :class:`SolveCrossAssoc` on detached inputs:
    ``_N_ITER`` damped Newton steps from X = 0.2."""
    x0 = torch.full_like(args[0], 0.2)
    xa0, xa1 = x0, x0
    for _ in range(_N_ITER):
        f0, f1 = _cross_residual(xa0, xa1, *args)
        dx0, dx1 = _solve22(*_cross_jac(xa0, xa1, *args), f0, f1)
        n0, n1 = xa0 - dx0, xa1 - dx1
        # damping (reference feos_torch/pcsaft_mix.py:304-308)
        xa0 = torch.where(n0 < 0.0, 0.2 * xa0, n0)
        xa1 = torch.where(n1 < 0.0, 0.2 * xa1, n1)
    return xa0, xa1


class SolveCrossAssoc(torch.autograd.Function):
    """(XA0, XA1) of the 2-unknown cross-association fixed point, with
    implicit derivatives of every order (see the module docstring)."""

    @staticmethod
    def forward(ctx, *args):
        xa0, xa1 = cross_assoc_iterate(*(a.detach() for a in args))
        ctx.save_for_backward(xa0, xa1, *args)
        return xa0, xa1

    @staticmethod
    def backward(ctx, g0, g1):
        xa0, xa1, *theta = ctx.saved_tensors
        j00, j01, j10, j11 = _cross_jac(xa0, xa1, *theta)
        # lambda = J^-T g: the transposed system
        l0, l1 = _solve22(j00, j10, j01, j11, g0, g1)
        _, vjp = torch.func.vjp(lambda *th: _cross_residual(xa0, xa1, *th), *theta)
        return vjp((-l0, -l1))


def solve_cross_assoc(d00, d01, d10, d11, rhoa0, rhoa1, rhob0, rhob1):
    """Solve the 2-unknown cross-association fixed point for (XA0, XA1);
    the arguments broadcast against each other."""
    return SolveCrossAssoc.apply(
        *torch.broadcast_tensors(d00, d01, d10, d11, rhoa0, rhoa1, rhob0, rhob1)
    )


# ---------------------------------------------------------------------------
# Induced association: one self-associating + one induced component, 1 unknown
# ---------------------------------------------------------------------------


def _induced_residual(xa, d00, d01, d10, d11, na0, na1, nb0, nb1):
    """Reference residual (feos_torch/pcsaft_mix.py:341-359); ``dij`` here
    are Delta_ij * rho_j."""
    xb0_i = 1.0 + xa * (na0 * d00 + na1 * d01)
    xb1_i = 1.0 + xa * (na0 * d10 + na1 * d11)
    f0 = xa * (xb0_i * xb1_i + nb0 * xb1_i * d00 + nb1 * xb0_i * d01) - xb0_i * xb1_i
    f1 = xa * (xb0_i * xb1_i + nb0 * xb1_i * d10 + nb1 * xb0_i * d11) - xb0_i * xb1_i
    return na0 * f0 + na1 * f1


def _induced_dfdx(xa, d00, d01, d10, d11, na0, na1, nb0, nb1):
    """Analytic d(residual)/dXA."""
    c0 = na0 * d00 + na1 * d01
    c1 = na0 * d10 + na1 * d11
    w0 = 1.0 + xa * c0
    w1 = 1.0 + xa * c1
    g0 = w0 * w1 + nb0 * w1 * d00 + nb1 * w0 * d01
    g1 = w0 * w1 + nb0 * w1 * d10 + nb1 * w0 * d11
    dww = c0 * w1 + c1 * w0
    dg0 = dww + nb0 * c1 * d00 + nb1 * c0 * d01
    dg1 = dww + nb0 * c1 * d10 + nb1 * c0 * d11
    return na0 * (g0 + xa * dg0 - dww) + na1 * (g1 + xa * dg1 - dww)


@torch.no_grad()
def induced_assoc_iterate(*args):
    """The forward solve of :class:`SolveInducedAssoc` on detached inputs."""
    xa = torch.full_like(args[0], 0.2)
    for _ in range(_N_ITER):
        new = xa - _induced_residual(xa, *args) / _safe(_induced_dfdx(xa, *args))
        xa = torch.where(new < 0.0, 0.2 * xa, new)
    return xa


class SolveInducedAssoc(torch.autograd.Function):
    """XA of the 1-unknown induced-association fixed point, with implicit
    derivatives of every order (see the module docstring)."""

    @staticmethod
    def forward(ctx, *args):
        xa = induced_assoc_iterate(*(a.detach() for a in args))
        ctx.save_for_backward(xa, *args)
        return xa

    @staticmethod
    def backward(ctx, g):
        xa, *theta = ctx.saved_tensors
        lam = g / _safe(_induced_dfdx(xa, *theta))
        _, vjp = torch.func.vjp(lambda *th: _induced_residual(xa, *th), *theta)
        return vjp(-lam)


def solve_induced_assoc(d00, d01, d10, d11, na0, na1, nb0, nb1):
    """Solve the 1-unknown induced-association fixed point for XA (``dij``
    are Delta_ij * rho_j); the arguments broadcast against each other."""
    return SolveInducedAssoc.apply(
        *torch.broadcast_tensors(d00, d01, d10, d11, na0, na1, nb0, nb1)
    )


# ---------------------------------------------------------------------------
# gc cross association, nA = nB = 1 (two unknowns)
# ---------------------------------------------------------------------------


def _cross_sym_residual(xa0, xa1, d00, d01, d10, d11):
    """gc cross-association residual, nA = nB = 1
    (reference feos_torch/gc_pcsaft.py:360-377); dij = Delta_ij * rho_j."""
    f0 = xa0 + xa0 * xa0 * d00 + xa0 * xa1 * d01 - 1.0
    f1 = xa1 + xa1 * xa0 * d10 + xa1 * xa1 * d11 - 1.0
    return f0, f1


def _cross_sym_jac(xa0, xa1, d00, d01, d10, d11):
    j00 = 1.0 + 2.0 * xa0 * d00 + xa1 * d01
    j01 = xa0 * d01
    j10 = xa1 * d10
    j11 = 1.0 + xa0 * d10 + 2.0 * xa1 * d11
    return j00, j01, j10, j11


@torch.no_grad()
def cross_assoc_sym_iterate(*args):
    """The forward solve of :class:`SolveCrossAssocSym` on detached inputs:
    ``_N_ITER`` damped Newton steps from X = 0.2."""
    x0 = torch.full_like(args[0], 0.2)
    xa0, xa1 = x0, x0
    for _ in range(_N_ITER):
        f0, f1 = _cross_sym_residual(xa0, xa1, *args)
        dx0, dx1 = _solve22(*_cross_sym_jac(xa0, xa1, *args), f0, f1)
        n0, n1 = xa0 - dx0, xa1 - dx1
        xa0 = torch.where(n0 < 0.0, 0.2 * xa0, n0)
        xa1 = torch.where(n1 < 0.0, 0.2 * xa1, n1)
    return xa0, xa1


class SolveCrossAssocSym(torch.autograd.Function):
    """(XA0, XA1) of the gc cross-association fixed point, with implicit
    derivatives of every order (see the module docstring)."""

    @staticmethod
    def forward(ctx, *args):
        xa0, xa1 = cross_assoc_sym_iterate(*(a.detach() for a in args))
        ctx.save_for_backward(xa0, xa1, *args)
        return xa0, xa1

    @staticmethod
    def backward(ctx, g0, g1):
        xa0, xa1, *theta = ctx.saved_tensors
        j00, j01, j10, j11 = _cross_sym_jac(xa0, xa1, *theta)
        l0, l1 = _solve22(j00, j10, j01, j11, g0, g1)
        _, vjp = torch.func.vjp(lambda *th: _cross_sym_residual(xa0, xa1, *th), *theta)
        return vjp((-l0, -l1))


def solve_cross_assoc_sym(d00, d01, d10, d11):
    """Solve the gc cross-association fixed point (nA = nB = 1) for (XA0,
    XA1); ``dij`` are Delta_ij * rho_j and broadcast against each other."""
    return SolveCrossAssocSym.apply(*torch.broadcast_tensors(d00, d01, d10, d11))
