"""Mixture PC-SAFT in PyTorch: Helmholtz energy density, its derivative
set, and bubble and dew pressures and temperatures and the pT flash of
n-component mixtures, with parameter gradients.

Counterpart of ``feos_tpu/models/pcsaft_mix.py``.  Parameters are ``(B, n,
8)`` tensors (``[m, sigma, epsilon_k, mu, kappa_ab, epsilon_k_ab, na, nb]``
per component) and compositions ``(B, n)``; a ``(B,)`` x1 is the binary
convention only.  The binary interaction ``kij`` is ``(B, 2)`` = ``[k_ij,
epsilon_k_AiBj]``, binary only too.  The JAX package writes phi per item
and maps it with ``vmap``; here the batch is the first axis of every
tensor and a density is ``(B, ..., n)``: row ``b`` of every state uses row
``b`` of the parameters.  Everything is ``torch.float64`` on the device of the inputs.

* The dipolar and the three association regimes are computed on every row
  of a regime some row can reach (``MixPre.branches``, found once by
  :func:`precompute_mix` from the same parameters as the row masks), with
  the JAX package's sanitisation of masked rows, and selected per row with
  ``torch.where``.
* The cross and induced association terms read the associating pair of
  each row wherever it sits (``MixPre.pair``), so a mixture's association
  does not depend on the order of its components; three or more
  associating components in one row raise ``ValueError``.  (The JAX
  package reads slots 0 and 1, and drops association for three.)
* The association fixed points are ``torch.autograd.Function``\\ s with
  exact implicit derivatives of every order
  (:mod:`feos_tpu_torch.ops.association`).
* Bubble and dew points run the detached f64 solver
  (:func:`feos_tpu_torch.solvers.vle.mix_vle`); the pressure's value comes
  from the solver's carried state, and its gradient from the stationary
  mixture identity, so no Newton iteration is ever differentiated.
* The isothermal pT flash (:func:`flash`) splits a feed inside the window
  of those bubble and dew solves
  (:mod:`feos_tpu_torch.solvers.flash`), and re-attaches its gradients by
  the implicit-function theorem on the equilibrium system.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..constants import A0, A1, A2, B0, B1, B2
from ..ops.association import (
    cross_assoc_iterate, induced_assoc_iterate, solve_cross_assoc, solve_induced_assoc,
)
from ..ops.derivatives import pressure_set
from ..solvers.flash import flash_model
from ..solvers.vle import mix_vle
from ..units import MU2_FACTOR, PA_PER_KT_TO_REDUCED, REDUCED_TO_PA_PER_KT
from .common import (
    DipolePre, assoc_strength_from_tfactor, assoc_strength_tfactor, phi_dipole_pre,
    precompute_dipole, site_fraction_free_energy,
)

PI = np.pi
F64 = torch.float64


class MixParams(NamedTuple):
    """Mixture parameters, one ``(B, n)`` tensor per column."""

    m: torch.Tensor
    sigma: torch.Tensor
    epsilon_k: torch.Tensor
    mu: torch.Tensor
    kappa_ab: torch.Tensor
    epsilon_k_ab: torch.Tensor
    na: torch.Tensor
    nb: torch.Tensor

    @classmethod
    def from_tensor(cls, parameters: torch.Tensor) -> "MixParams":
        """Columns of a ``(B, n, 8)`` tensor, as views that keep autograd."""
        return cls(*parameters.unbind(-1))

    @classmethod
    def from_numpy(cls, parameters, device="cuda") -> "MixParams":
        """The JAX package's ``(B, n, 8)`` parameters, as numpy, on
        ``device`` (the card unless the caller asks for the CPU)."""
        return cls.from_tensor(_f64(parameters, device))


def _f64(x, device):
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


# the phi regimes beyond hard sphere, chain and dispersion
BRANCHES = ("dipole", "self", "cross", "induced")


class MixPre(NamedTuple):
    """Density-independent mixture quantities at fixed (parameters, kij, T):
    the JAX package's ``MixPre`` with the batch first.  Computed once per
    solve and shared by every phi evaluation in its loops."""

    m: torch.Tensor        # (B, n)
    na: torch.Tensor       # (B, n)
    nb: torch.Tensor       # (B, n)
    md1: torch.Tensor      # (B, n) m * d
    md2: torch.Tensor      # (B, n) m * d^2
    md3: torch.Tensor      # (B, n) m * d^3
    d: torch.Tensor        # (B, n)
    e1: torch.Tensor       # (B, n, n) m_i m_j eps_ij/T sigma_ij^3 (kij applied)
    e2: torch.Tensor       # (B, n, n) e1 * eps_ij/T
    dip: DipolePre
    dipolar: torch.Tensor  # (B,) bool: any mu2 > 0
    self_st: torch.Tensor  # (B,) sigma_a^3 kappa (exp(eps_ab/T)-1), sanitised
    self_da: torch.Tensor  # (B,) associating diameter d_a, sanitised
    cross_t: torch.Tensor  # (B, n, n) T-factors with the eps_AiBj override
    ind_t: torch.Tensor    # (B, n, n) plain T-factors (induced regime)
    dd: torch.Tensor       # (B, n, n) d_i d_j / (d_i + d_j)
    self_m: torch.Tensor   # (B,) bool regime masks (parameter-only)
    cross_m: torch.Tensor
    induced_m: torch.Tensor
    pair: torch.Tensor     # (B, 2) int64 slots of the associating pair, (0, 1) elsewhere
    branches: frozenset    # the regimes some row reaches (BRANCHES names)


def _pairwise(f, n):
    """``(B, n, n)`` from ``f(i, j) -> (B,)``."""
    return torch.stack([torch.stack([f(i, j) for j in range(n)], -1) for i in range(n)], -2)


def precompute_mix(p: MixParams, kij, epsilon_k_aibj, temperature) -> MixPre:
    """Build :class:`MixPre` from ``(B, n)`` parameter columns and ``(B,)``
    ``kij``, ``epsilon_k_aibj`` and temperatures.  Plain torch ops, so
    gradients flow through."""
    m, sigma, epsilon_k = p.m, p.sigma, p.epsilon_k
    n = m.shape[-1]
    t = temperature[:, None]

    d = sigma * (1.0 - 0.12 * torch.exp(-3.0 * epsilon_k / t))

    # dispersion combining rules with kij; 1/T and 1/T^2 folded in
    eps_t = torch.sqrt(epsilon_k[:, :, None] * epsilon_k[:, None, :]) / t[:, :, None]
    offdiag = 1.0 - torch.eye(n, dtype=F64, device=m.device)
    eps_t = eps_t * (1.0 - kij[:, None, None] * offdiag)
    sigma_ij3 = (0.5 * (sigma[:, :, None] + sigma[:, None, :])) ** 3
    e1 = (m[:, :, None] * m[:, None, :]) * eps_t * sigma_ij3
    e2 = e1 * eps_t

    # dipole
    mu2 = p.mu**2 / (m * sigma**3 * epsilon_k) * MU2_FACTOR
    dipolar = (mu2 > 0.0).any(-1)
    dip = precompute_dipole(m, sigma, epsilon_k, sigma**3 * epsilon_k * mu2, temperature)

    # association regime masks (parameter-only, rho-free)
    is_assoc = p.na + p.nb != 0.0
    n_assoc = is_assoc.sum(-1)
    n_self = (p.na * p.nb != 0.0).sum(-1)
    self_m = (n_assoc == 1) & (n_self == 1)
    cross_m = (n_assoc == 2) & (n_self == 2)
    induced_m = (n_assoc == 2) & (n_self == 1)

    # self regime: single associating component, aggregated sites
    # (sanitised on masked rows so sqrt/exp gradients stay finite)
    kappa_s = torch.where(self_m, p.kappa_ab.sum(-1), 1.0)
    eps_ab_s = p.epsilon_k_ab.sum(-1)
    na_sum = torch.where(self_m, p.na.sum(-1), 1.0)
    sigma_a = torch.where(self_m, (p.na * sigma).sum(-1) / na_sum, 1.0)
    self_da = torch.where(self_m, (p.na * d).sum(-1) / na_sum, 1.0)
    self_st = sigma_a**3 * kappa_s * (torch.exp(eps_ab_s / temperature) - 1.0)

    # cross / induced regimes: pairwise T-factors, sanitised on masked rows
    # and on the components outside the associating pair (whose entries the
    # terms never read) so that the sqrt's gradients stay finite
    kappa_c = torch.where(cross_m[:, None] & is_assoc, p.kappa_ab, 1.0)
    kappa_i = torch.where(induced_m[:, None] & is_assoc, p.kappa_ab, 1.0)
    cross_t = _pairwise(lambda i, j: assoc_strength_tfactor(
        i, j, temperature, sigma, kappa_c, p.epsilon_k_ab, epsilon_k_aibj), n)
    ind_t = _pairwise(lambda i, j: assoc_strength_tfactor(
        i, j, temperature, sigma, kappa_i, p.epsilon_k_ab), n)
    dd = d[:, :, None] * d[:, None, :] / (d[:, :, None] + d[:, None, :])

    # the reachable regimes, from the masks themselves (one host sync)
    masks = torch.stack([dipolar, self_m, cross_m, induced_m, n_assoc > 2])
    *reached, too_many = masks.any(-1).tolist()
    if too_many:
        raise ValueError(TOO_MANY_ASSOCIATING)
    branches = frozenset(name for name, on in zip(BRANCHES, reached) if on)

    return MixPre(
        m=m, na=p.na, nb=p.nb,
        md1=m * d, md2=m * d * d, md3=m * d * d * d, d=d,
        e1=e1, e2=e2, dip=dip, dipolar=dipolar,
        self_st=self_st, self_da=self_da,
        cross_t=cross_t, ind_t=ind_t, dd=dd,
        self_m=self_m, cross_m=cross_m, induced_m=induced_m,
        pair=associating_pair(is_assoc, n_assoc), branches=branches,
    )


TOO_MANY_ASSOCIATING = ("three or more associating components in one mixture: the "
                        "association terms pair at most two")


def associating_pair(is_assoc, n_assoc):
    """``(B, 2)`` slots of the two associating components of each row
    (``is_assoc (B, n)``, ``n_assoc (B,)`` their count) in slot order, and
    (0, 1) on rows without two: a binary's pair is always (0, 1)."""
    n = is_assoc.shape[-1]
    first = torch.argsort((~is_assoc).to(torch.int8), dim=-1, stable=True)[:, :2]
    fallback = torch.arange(min(n, 2), device=is_assoc.device)
    return torch.where((n_assoc == 2)[:, None], first, fallback)


def pair_block(x, pair):
    """``x (B, n, n)`` on the associating ``pair (B, 2)``: ``(B, 2, 2)``."""
    rows = torch.take_along_dim(x, pair[:, :, None], dim=1)
    return torch.take_along_dim(rows, pair[:, None, :], dim=2)


def pair_slots(pair, col):
    """``at(x, j)``: ``x (B, ..., n)`` at slot j of each row's associating
    ``pair (B, 2)``, ``(B, ...)``; ``col`` as :func:`_columns` gives it.
    Each call is its own gather, as each ``x[..., j]`` is its own select: a
    binary's gradients then sum in the same order as with fixed slots."""
    idx = [col(pair[:, j:j + 1]) for j in range(2)]

    def at(x, j):
        return torch.take_along_dim(x, idx[j], dim=-1)[..., 0]

    return at


def _columns(density):
    """``col(x)``: a ``(B, *rest)`` row quantity reshaped to broadcast
    against a ``(B, ..., n)`` density's middle axes."""
    extra = (1,) * (density.dim() - 2)

    def col(x):
        return x.reshape(x.shape[0], *extra, *x.shape[1:])

    return col


def phi_mix_pre(pre: MixPre, density, assoc_q_form: bool = False):
    """Reduced residual Helmholtz energy density at ``density (B, ..., n)``
    from :class:`MixPre`; returns ``(B, ...)``.

    With ``assoc_q_form`` the association term is the Michelsen Q function
    at detached site fractions: values and first derivatives are exact,
    second derivatives miss the dX/drho term (see the JAX package's
    ``phi_mix``).  Regimes no row reaches (``pre.branches``) are skipped.
    """
    col = _columns(density)
    rho = density
    m = col(pre.m)
    dev = rho.device
    cA0, cA1, cA2, cB0, cB1, cB2 = (
        torch.as_tensor(c, dtype=F64, device=dev) for c in (A0, A1, A2, B0, B1, B2)
    )

    d = col(pre.d)
    zeta0 = PI / 6.0 * (m * rho).sum(-1)
    zeta1 = PI / 6.0 * (col(pre.md1) * rho).sum(-1)
    zeta2 = PI / 6.0 * (col(pre.md2) * rho).sum(-1)
    zeta3 = PI / 6.0 * (col(pre.md3) * rho).sum(-1)

    zeta23 = zeta2 / zeta3
    zeta3_2 = zeta3 * zeta3
    zeta3_3 = zeta3_2 * zeta3
    zeta3_m1 = 1.0 / (1.0 - zeta3)
    zeta3_m2 = zeta3_m1 * zeta3_m1
    etas = torch.stack([torch.ones_like(zeta3), zeta3, zeta3_2, zeta3_3,
                        zeta3_2 * zeta3_2, zeta3_2 * zeta3_3, zeta3_3 * zeta3_3], -1)

    # hard sphere (Boublik-Mansoori zeta form)
    hs = (6.0 / PI) * (
        zeta1 * zeta2 * zeta3_m1 * 3.0
        + zeta2 * zeta2 * zeta3_m2 * zeta23
        + (zeta2 * zeta23 * zeta23 - zeta0) * torch.log(1.0 - zeta3)
    )

    # hard chain
    c = (zeta2 * zeta3_m2)[..., None]
    g = zeta3_m1[..., None] + d * c * 1.5 - d * d * c * c * (zeta3[..., None] - 1.0) * 0.5
    hc = -(rho * (m - 1.0) * torch.log(g)).sum(-1)

    # dispersion: combining rules precomputed into (n, n) bases
    x = rho / rho.sum(-1, keepdim=True)
    mmean = (x * m).sum(-1)
    rho_ij = rho[..., :, None] * rho[..., None, :]
    rho1mix = (rho_ij * col(pre.e1)).sum((-1, -2))
    rho2mix = (rho_ij * col(pre.e2)).sum((-1, -2))

    m1 = ((mmean - 1.0) / mmean)[..., None]
    m2 = m1 * ((mmean - 2.0) / mmean)[..., None]
    I1 = ((m2 * cA2 + m1 * cA1 + cA0) * etas).sum(-1)
    I2 = ((m2 * cB2 + m1 * cB1 + cB0) * etas).sum(-1)
    C1 = 1.0 / (
        1.0
        + mmean * (8.0 * zeta3 - 2.0 * zeta3_2) * zeta3_m2 * zeta3_m2
        + (1.0 - mmean)
        * (20.0 * zeta3 - 27.0 * zeta3_2 + 12.0 * zeta3_2 * zeta3 - 2.0 * zeta3_2 * zeta3_2)
        / ((1.0 - zeta3) * (1.0 - zeta3) * (2.0 - zeta3) * (2.0 - zeta3))
    )
    disp = (-rho1mix * 2.0 * I1 - rho2mix * C1 * I2 * mmean) * PI

    phi = hs + hc + disp

    if "dipole" in pre.branches:
        dip = phi_dipole_pre(pre.dip, rho, etas, col)
        phi = phi + torch.where(col(pre.dipolar), dip, 0.0)

    # association regime dispatch (reference feos_torch/pcsaft_mix.py:117-152)
    for name, mask, term in (("self", pre.self_m, _phi_self_assoc),
                             ("cross", pre.cross_m, _phi_cross_assoc),
                             ("induced", pre.induced_m, _phi_induced_assoc)):
        if name in pre.branches:
            a = term(pre, rho, zeta2, zeta3_m1, col, assoc_q_form)
            phi = phi + torch.where(col(mask), a, 0.0)
    return phi


def q_f1(x):
    """Per-site Q-form free energy  f1(X) = ln X - X + 1."""
    return torch.log(x) - x + 1.0


def _phi_self_assoc(pre: MixPre, rho, zeta2, zeta3_m1, col, q_form=False):
    """Single self-associating component, closed form
    (reference feos_torch/pcsaft_mix.py:210-239)."""
    k = col(pre.self_da) * 0.5 * zeta2 * zeta3_m1
    delta = zeta3_m1 * (k * (2.0 * k + 3.0) + 1.0) * col(pre.self_st)
    rhoa = (col(pre.na) * rho).sum(-1)
    rhob = (col(pre.nb) * rho).sum(-1)
    aux = 1.0 + (rhoa - rhob) * delta
    sqrt = torch.sqrt(aux * aux + 4.0 * rhob * delta)
    xa = 2.0 / (sqrt + 1.0 + (rhob - rhoa) * delta)
    xb = 2.0 / (sqrt + 1.0 + (rhoa - rhob) * delta)
    if q_form:
        xa, xb = xa.detach(), xb.detach()
        return rhoa * q_f1(xa) + rhob * q_f1(xb) - rhoa * rhob * xa * xb * delta
    f = site_fraction_free_energy
    return rhoa * f(xa) + rhob * f(xb)


def _phi_cross_assoc(pre: MixPre, rho, zeta2, zeta3_m1, col, q_form=False):
    """Two self-associating components, 2-unknown fixed point
    (reference feos_torch/pcsaft_mix.py:241-321)."""
    mask = col(pre.cross_m)
    tfac, dd2 = pair_block(pre.cross_t, pre.pair), pair_block(pre.dd, pre.pair)

    def delta(i, j):
        dd = assoc_strength_from_tfactor(
            col(tfac[:, i, j]), col(dd2[:, i, j]), zeta2, zeta3_m1
        )
        return torch.where(mask, dd, 0.0)

    d00, d01, d10, d11 = delta(0, 0), delta(0, 1), delta(1, 0), delta(1, 1)
    # the pair's site densities, (B, ..., 2)
    idx = col(pre.pair)
    rhoa = torch.take_along_dim(rho * col(pre.na), idx, dim=-1)
    rhob = torch.take_along_dim(rho * col(pre.nb), idx, dim=-1)
    args = (d00, d01, d10, d11, rhoa[..., 0], rhoa[..., 1], rhob[..., 0], rhob[..., 1])
    if q_form:
        a = torch.broadcast_tensors(*(v.detach() for v in args))
        xa0, xa1 = cross_assoc_iterate(*a)
        xb0 = 1.0 / (1.0 + xa0 * a[4] * a[0] + xa1 * a[5] * a[1])
        xb1 = 1.0 / (1.0 + xa0 * a[4] * a[2] + xa1 * a[5] * a[3])
        # Q bilinear term: sum over (A_i, B_j) pairs with Delta_ij(rho)
        bil = (
            rhoa[..., 0] * rhob[..., 0] * xa0 * xb0 * d00
            + rhoa[..., 0] * rhob[..., 1] * xa0 * xb1 * d10
            + rhoa[..., 1] * rhob[..., 0] * xa1 * xb0 * d01
            + rhoa[..., 1] * rhob[..., 1] * xa1 * xb1 * d11
        )
        return (
            rhoa[..., 0] * q_f1(xa0) + rhoa[..., 1] * q_f1(xa1)
            + rhob[..., 0] * q_f1(xb0) + rhob[..., 1] * q_f1(xb1) - bil
        )
    xa0, xa1 = solve_cross_assoc(*args)
    xb0 = 1.0 / (1.0 + xa0 * rhoa[..., 0] * d00 + xa1 * rhoa[..., 1] * d01)
    xb1 = 1.0 / (1.0 + xa0 * rhoa[..., 0] * d10 + xa1 * rhoa[..., 1] * d11)
    f = site_fraction_free_energy
    return (rhoa[..., 0] * f(xa0) + rhoa[..., 1] * f(xa1)
            + rhob[..., 0] * f(xb0) + rhob[..., 1] * f(xb1))


def _phi_induced_assoc(pre: MixPre, rho, zeta2, zeta3_m1, col, q_form=False):
    """One self-associating + one induced (nA = 0) component
    (reference feos_torch/pcsaft_mix.py:324-393)."""
    return induced_assoc_term(pre.induced_m, pre.ind_t, pre.dd, pre.na, pre.nb, pre.pair,
                              rho, zeta2, zeta3_m1, col, q_form)


def induced_assoc_term(mask, tfac, dd, na, nb, pair, rho, zeta2, zeta3_m1, col,
                       q_form=False):
    """The induced-association term from ``(B,)`` regime ``mask``, ``(B, n,
    n)`` T-factors ``tfac`` and diameter factors ``dd``, ``(B, n)`` site
    counts and the ``(B, 2)`` slots of the associating ``pair``; shared by
    the mixture and the gc model."""
    mask = col(mask)
    tfac, dd = pair_block(tfac, pair), pair_block(dd, pair)
    at = pair_slots(pair, col)

    def delta_rho(i, j):
        d = assoc_strength_from_tfactor(col(tfac[:, i, j]), col(dd[:, i, j]), zeta2, zeta3_m1)
        return torch.where(mask, d * at(rho, j), 0.0)

    d00, d01 = delta_rho(0, 0), delta_rho(0, 1)
    d10, d11 = delta_rho(1, 0), delta_rho(1, 1)
    na, nb = col(na), col(nb)
    na0, na1, nb0, nb1 = at(na, 0), at(na, 1), at(nb, 0), at(nb, 1)
    args = (d00, d01, d10, d11, na0, na1, nb0, nb1)
    if q_form:
        a = torch.broadcast_tensors(*(v.detach() for v in args))
        xa = induced_assoc_iterate(*a)
        xb0 = 1.0 / (1.0 + xa * (a[4] * a[0] + a[5] * a[1]))
        xb1 = 1.0 / (1.0 + xa * (a[4] * a[2] + a[5] * a[3]))
        # sites: shared-A (rho-weighted na) + B_0 + B_1; dij here are
        # Delta_ij * rho_j, so rho_Ai rho_Bj Delta_ij = (na_i rho_i) nb_j d_ij
        rho_a = na0 * at(rho, 0) + na1 * at(rho, 1)
        bil = xa * (
            na0 * at(rho, 0) * (nb0 * xb0 * d00 + nb1 * xb1 * d01)
            + na1 * at(rho, 1) * (nb0 * xb0 * d10 + nb1 * xb1 * d11)
        )
        return (rho_a * q_f1(xa) + at(rho, 0) * nb0 * q_f1(xb0)
                + at(rho, 1) * nb1 * q_f1(xb1) - bil)
    xa = solve_induced_assoc(*args)
    xb0 = 1.0 / (1.0 + xa * (na0 * d00 + na1 * d01))
    xb1 = 1.0 / (1.0 + xa * (na0 * d10 + na1 * d11))
    f = site_fraction_free_energy
    return at(rho, 0) * (f(xa) * na0 + f(xb0) * nb0) + at(rho, 1) * (
        f(xa) * na1 + f(xb1) * nb1
    )


# ---------------------------------------------------------------------------
# Batched API
# ---------------------------------------------------------------------------


def _split_kij(kij, parameters):
    """``(k_ij, epsilon_k_AiBj)`` columns ``(B,)``; zeros for ``None``."""
    if kij is None:
        z = torch.zeros(parameters.shape[0], dtype=F64, device=parameters.device)
        return z, z
    return kij[:, 0], kij[:, 1]


def _pre(parameters, kij, temperature):
    k, e = _split_kij(kij, parameters)
    return precompute_mix(MixParams.from_tensor(parameters), k, e, temperature)


def helmholtz_energy_density(parameters, kij, temperature, density):
    """Batched phi (reference ``PcSaftMix.helmholtz_energy_density``):
    ``parameters (B, n, 8)``, ``kij (B, 2)`` or ``None``, ``temperature
    (B,)``, ``density (B, ..., n)`` in A^-3."""
    return phi_mix_pre(_pre(parameters, kij, temperature), density)


def derivatives(parameters, kij, temperature, density):
    """Batched ``(A, p~, mu_i, v_i)`` at ``density (B, n)``
    (reference feos_torch/pcsaft_mix.py:395-420)."""
    pre = _pre(parameters, kij, temperature)
    return pressure_set(lambda r: phi_mix_pre(pre, r), density)


def solve_incipient(parameters, kij, temperature, molefracs, p_red, bubble,
                    state0=None, stats=None):
    """The detached bubble/dew solve: ``(rho_inc (B, n), rho_bulk (B, n), ok
    (B,), p~_eq (B,))`` for ``(B, n, 8)`` parameters, ``(B, 2)`` kij (or
    ``None``; binary only), ``(B,)`` temperatures and reduced pressure
    estimates, and bulk compositions ``(B, n)``.  See
    :func:`feos_tpu_torch.solvers.vle.mix_vle`."""
    if parameters.dim() != 3 or parameters.shape[-1] != 8:
        raise ValueError("parameters must be (B, n, 8)")
    check_kij(kij, parameters.shape[1])
    pre = _pre(parameters.detach(), None if kij is None else kij.detach(),
               temperature.detach())
    return mix_vle(
        lambda r: phi_mix_pre(pre, r, assoc_q_form=True),
        lambda r: phi_mix_pre(pre, r),
        molefracs.detach(), p_red.detach(), pre.md3, incipient_is_vapor=bubble,
        u0_init=state0, stats=stats,
    )


def check_kij(kij, n):
    """kij is the binary interaction (the JAX package's rule)."""
    if kij is not None and n != 2:
        raise ValueError("kij can only be used for binary mixtures!")


def mixture_inputs(device, temperature, molefracs, pressure, n):
    """``(T (B,), z (B, n), p~ (B,))`` in f64 on ``device`` from temperatures,
    compositions and pressures in Pa, for ``n`` components.  A ``(B, n)``
    composition matrix passes through; a ``(B,)`` x1 is the reference's
    binary convention and raises for ``n != 2`` (the JAX package's rule)."""
    temperature = torch.as_tensor(temperature, dtype=F64, device=device)
    molefracs = torch.as_tensor(molefracs, dtype=F64, device=device)
    pressure = torch.as_tensor(pressure, dtype=F64, device=device)
    if molefracs.dim() == 1:
        if n != 2:
            raise ValueError(
                "scalar molefracs are the binary x1 convention; pass a "
                f"(B, {n}) composition matrix for {n}-component mixtures")
        molefracs = torch.stack([molefracs, 1.0 - molefracs], -1)
    return temperature, molefracs, pressure / temperature * PA_PER_KT_TO_REDUCED


def reattach_incipient(solved, temperature, phi_fn=None, full_output=False,
                       state_output=False):
    """Bubble/dew outputs from a detached solve, with stationary
    re-attachment.

    ``solved`` is ``(rho_inc, rho_bulk, ok, p~_eq)`` from :func:`mix_vle`.
    Failed rows are sanitised, and where ``phi_fn`` (the exact phi,
    differentiable in the parameters) is given, the gradient re-attaches
    through the stationary identity (reference
    feos_torch/pcsaft_mix.py:435-443 and :459-467)

        p~ = -(a_inc + p~_bulk v_bulk + g_bulk - 1) / (1/rho_inc - v_bulk)

    where 'bulk' is the phase of known composition (liquid for bubble,
    vapor for dew) and 'inc' the incipient phase, at the fixed detached
    densities: ``p~_eq + (identity - identity.detach())`` carries the
    solver's value and the identity's derivatives.  The identity's partial
    molar volumes v_bulk are second order in phi and taken in f64.

    Returns ``(p [Pa], nans)``, then the incipient composition with
    ``full_output`` and the converged log-state with ``state_output``.
    """
    rho_inc, rho_bulk, ok, pt_eq = solved
    # sanitise failed rows: NaN or zero densities would give NaN
    # derivatives, which the final torch.where cannot repair
    rho_inc = torch.where(ok[:, None], rho_inc, 1e-5)
    rho_bulk = torch.where(ok[:, None], rho_bulk, 1e-3)
    pt_eq = torch.where(ok, pt_eq, 1.0)
    if phi_fn is not None:
        ident = _identity(phi_fn, rho_inc, rho_bulk)
        pt_eq = pt_eq + (ident - ident.detach())
    pressure_out = torch.where(ok, pt_eq * temperature * REDUCED_TO_PA_PER_KT, torch.nan)
    out = (pressure_out, ~ok)
    if full_output:
        # incipient-phase composition; zero gradient (detached solver)
        y_inc = rho_inc / rho_inc.sum(-1, keepdim=True)
        out = out + (torch.where(ok[:, None], y_inc, torch.nan),)
    if state_output:
        # converged log-state for warm starts; NaN where failed
        u_state = torch.cat([torch.log(rho_inc), torch.log(rho_bulk.sum(-1))[:, None]], 1)
        out = out + (torch.where(ok[:, None], u_state, torch.nan),)
    return out


def needs_grad(*tensors):
    """Whether autograd is on and one of ``tensors`` requires a gradient."""
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in tensors)


def _incipient_property(parameters, kij, temperature, molefracs, pressure, bubble,
                        full_output=False, state0=None, state_output=False, stats=None):
    """Shared bubble/dew implementation: the detached solve
    (:func:`solve_incipient`), then :func:`reattach_incipient`."""
    temperature, molefracs, p_red = mixture_inputs(parameters.device, temperature, molefracs,
                                                   pressure, parameters.shape[1])
    solved = solve_incipient(parameters, kij, temperature, molefracs, p_red, bubble, state0,
                             stats)
    phi_fn = None
    if needs_grad(parameters, kij, temperature):
        phi_fn = partial(phi_mix_pre, _pre(parameters, kij, temperature))
    return reattach_incipient(solved, temperature, phi_fn, full_output, state_output)


def _identity(phi_fn, r_inc, r_bulk):
    """The stationary bubble/dew pressure identity at fixed densities."""
    _, p_b, g_b, v_b = pressure_set(phi_fn, r_bulk)
    mu_b = torch.log(r_bulk) + g_b
    rho_inc_t = r_inc.sum(-1)
    w = r_inc / rho_inc_t[:, None]
    a_inc = phi_fn(r_inc) / rho_inc_t
    v_bulk = (w * v_b).sum(-1)
    g_bulk = (w * (torch.log(r_inc) - mu_b)).sum(-1)
    return -(a_inc + p_b * v_bulk + g_bulk - 1.0) / (1.0 / rho_inc_t - v_bulk)


def bubble_point(parameters, kij, temperature, liquid_molefracs, pressure,
                 full_output=False, state0=None, state_output=False, stats=None):
    """Batched bubble-point pressure in Pa with gradients in the parameters,
    kij and T (reference feos_torch/pcsaft_mix.py:422-444).

    ``parameters (B, n, 8)`` are float64 tensors on one device, for any
    number n of components; ``temperature``, ``pressure`` (the initial
    estimate in Pa) and ``liquid_molefracs`` ``(B, n)`` follow them.  Two
    conventions are binary only, as in the JAX package: ``liquid_molefracs``
    as x1 per row ``(B,)``, and ``kij (B, 2)`` = ``[k_ij, epsilon_k_AiBj]``
    (pass ``None`` for n != 2); either raises ``ValueError`` otherwise.  The
    association terms read each row's associating pair wherever it sits in
    the component order; three or more associating components raise
    ``ValueError`` (the JAX package reads slots 0 and 1, and drops
    association for three).

    Returns ``(p, nans)``, NaN on failed rows; with ``full_output`` also the
    vapor composition ``(B, n)``, and with ``state_output`` the converged
    log-state ``(B, n+1)`` to pass back as ``state0`` for a warm start at
    nearby parameters.  If ``stats`` is a dict, it receives the solver's
    loop iterations.
    """
    return _incipient_property(parameters, kij, temperature, liquid_molefracs, pressure,
                               True, full_output, state0, state_output, stats)


def dew_point(parameters, kij, temperature, vapor_molefracs, pressure,
              full_output=False, state0=None, state_output=False, stats=None):
    """Batched dew-point pressure in Pa (reference
    feos_torch/pcsaft_mix.py:446-468) at the vapor composition
    ``vapor_molefracs`` ``(B, n)`` (x1 per row for a binary only);
    ``full_output`` adds the liquid composition ``(B, n)``.  The conventions
    for n, kij and association are :func:`bubble_point`'s."""
    return _incipient_property(parameters, kij, temperature, vapor_molefracs, pressure,
                               False, full_output, state0, state_output, stats)


def _incipient_temperature(parameters, kij, pressure, molefracs, t0, bubble,
                           full_output=False, stats=None):
    """Bubble or dew temperature: the warm-started secant over
    :func:`_incipient_property`
    (:func:`feos_tpu_torch.solvers.tsolve.incipient_temperature`)."""
    from ..solvers.tsolve import incipient_temperature

    kij_s = None if kij is None else kij.detach()
    return incipient_temperature(
        partial(_incipient_property, parameters, kij, bubble=bubble),
        partial(_incipient_property, parameters.detach(), kij_s, bubble=bubble),
        pressure, molefracs, t0, parameters.shape[0], parameters.device, full_output, stats)


def bubble_point_t(parameters, kij, pressure, liquid_molefracs, t0, full_output=False,
                   stats=None):
    """Batched bubble-point temperature in K at ``pressure`` [Pa], with
    gradients in the parameters, kij and the pressure (beyond the reference,
    which is pressure-explicit only).

    A cold bubble solve at the initial estimate ``t0`` seeds the solver
    state, a detached secant in (1/T, ln p) runs warm solves from it, and
    one differentiable warm solve at the converged temperature plus one
    symbolic Newton step in T re-attach the gradients.  ``pressure`` and
    ``t0`` are scalars or ``(B,)``; ``liquid_molefracs`` is ``(B, n)``, or
    x1 per row for a binary (the conventions of :func:`bubble_point`).
    Returns ``(t, nans)``, NaN on failed rows, and with ``full_output`` also
    the vapor composition ``(B, n)``.  If ``stats`` is a dict, it receives
    the secant's iterations as ``outer``.
    """
    return _incipient_temperature(parameters, kij, pressure, liquid_molefracs, t0, True,
                                  full_output, stats)


def dew_point_t(parameters, kij, pressure, vapor_molefracs, t0, full_output=False,
                stats=None):
    """Batched dew-point temperature in K at ``pressure`` [Pa]; with
    ``full_output`` also the liquid composition.  See :func:`bubble_point_t`."""
    return _incipient_temperature(parameters, kij, pressure, vapor_molefracs, t0, False,
                                  full_output, stats)


def flash(parameters, kij, temperature, molefracs, pressure, gradients=False, stats=None):
    """Batched isothermal pT flash at (T, p, z) of n-component mixtures.

    ``parameters (B, n, 8)`` are float64 tensors on one device;
    ``temperature`` [K], ``pressure`` [Pa] and ``molefracs`` (the feed,
    ``(B, n)``) follow them.  z1 per row and ``kij (B, 2)`` are binary only,
    and association follows the rule of :func:`bubble_point`.  The
    two-phase window comes from detached bubble and dew solves at the feed
    (their initial estimate floored at 1e5 Pa: the edge solvers recover from
    an estimate too high, not from one decades too low); inside it,
    successive substitution splits the feed
    (:func:`feos_tpu_torch.solvers.flash.flash_tp`).

    Returns ``(vapor_frac, x, y, rho, phase)``: beta ``(B,)`` (0 for a
    liquid, 1 for a vapor, NaN where failed), the liquid and vapor mole
    fractions ``(B, n)`` (the feed where single-phase, NaN where that phase
    does not exist), the total densities ``(B, 2)`` = [liquid, vapor] in
    A^-3 on two-phase rows (NaN elsewhere; the unit
    :func:`~feos_tpu_torch.properties.mix_properties` takes), and the int8
    phase code (0 liquid, 1 vapor, 2 two-phase, -1 failed).

    With ``gradients=False`` every output is detached.  With
    ``gradients=True`` the derivatives of beta, x, y and rho in the
    parameters, kij, T, z and p re-attach by the implicit-function theorem
    (:func:`feos_tpu_torch.solvers.flash.reattach_flash`), values unchanged.
    The z-gradient is the JAX package's: the residual holds the material
    balance of every component but the last, so z_n enters no equation and
    a scalar z1 feed carries dz through z_1 alone.  If ``stats`` is a dict,
    it receives the flash's loop iterations.
    """
    temperature, z, p_red = mixture_inputs(parameters.device, temperature, molefracs, pressure,
                                           parameters.shape[1])
    pressure = torch.as_tensor(pressure, dtype=F64, device=parameters.device)
    params_s, t_s, z_s = parameters.detach(), temperature.detach(), z.detach()
    kij_s = None if kij is None else kij.detach()
    p0 = torch.clamp(pressure.detach(), min=1e5)
    edges = (_incipient_property(params_s, kij_s, t_s, z_s, p0, True, full_output=True)
             + _incipient_property(params_s, kij_s, t_s, z_s, p0, False, full_output=True))
    pre_grad = None
    if gradients and needs_grad(parameters, kij, temperature, z, p_red):
        pre_grad = _pre(parameters, kij, temperature)
    else:
        z, p_red = z_s, p_red.detach()
    return flash_model(phi_mix_pre, _pre(params_s, kij_s, t_s), pre_grad, z, p_red, pressure,
                       edges, stats)


class PcSaftMix(nn.Module):
    """Module facade over the functional API (reference ``PcSaftMix``,
    feos_torch/pcsaft_mix.py:12) for mixtures of n components.

    Holds the ``(B, n, 8)`` parameters as an ``nn.Parameter`` on ``device``,
    the card unless the caller asks for the CPU.  A binary also holds ``kij``
    = ``[k_ij, epsilon_k_AiBj]`` ``(B, 2)`` (zeros when ``None``) as one;
    for n != 2 ``kij`` must be ``None`` and the facade holds none (the JAX
    package's rule).  Compositions are ``(B, n)`` (x1 per row for a binary
    only), and association reads each row's associating pair wherever it
    sits; three or more associating components raise ``ValueError``.
    """

    def __init__(self, parameters, kij=None, device="cuda"):
        super().__init__()
        params = _f64(parameters, device)
        if params.dim() != 3 or params.shape[-1] != 8:
            raise ValueError("parameters must be (B, n, 8)")
        check_kij(kij, params.shape[1])
        self.params = nn.Parameter(params)
        if params.shape[1] == 2:
            kij = np.zeros((params.shape[0], 2)) if kij is None else kij
            self.kij = nn.Parameter(_f64(kij, device))
        else:
            self.kij = None

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=F64, device=self.params.device)

    def helmholtz_energy_density(self, temperature, density):
        return helmholtz_energy_density(self.params, self.kij, self._tensor(temperature),
                                        self._tensor(density))

    def derivatives(self, temperature, density):
        return derivatives(self.params, self.kij, self._tensor(temperature),
                           self._tensor(density))

    def bubble_point(self, temperature, liquid_molefracs, pressure, full_output=False,
                     state0=None, state_output=False, stats=None):
        return bubble_point(self.params, self.kij, self._tensor(temperature),
                            self._tensor(liquid_molefracs), self._tensor(pressure),
                            full_output, state0, state_output, stats)

    def dew_point(self, temperature, vapor_molefracs, pressure, full_output=False,
                  state0=None, state_output=False, stats=None):
        return dew_point(self.params, self.kij, self._tensor(temperature),
                         self._tensor(vapor_molefracs), self._tensor(pressure),
                         full_output, state0, state_output, stats)

    def bubble_point_t(self, pressure, liquid_molefracs, t0, full_output=False, stats=None):
        """Bubble-point temperature at given pressure; see :func:`bubble_point_t`."""
        return bubble_point_t(self.params, self.kij, self._tensor(pressure),
                              self._tensor(liquid_molefracs), self._tensor(t0), full_output,
                              stats)

    def dew_point_t(self, pressure, vapor_molefracs, t0, full_output=False, stats=None):
        """Dew-point temperature at given pressure; see :func:`dew_point_t`."""
        return dew_point_t(self.params, self.kij, self._tensor(pressure),
                           self._tensor(vapor_molefracs), self._tensor(t0), full_output, stats)

    def flash(self, temperature, molefracs, pressure, gradients=False, stats=None):
        """Isothermal pT flash; see :func:`flash`."""
        return flash(self.params, self.kij, self._tensor(temperature), self._tensor(molefracs),
                     self._tensor(pressure), gradients, stats)

    def residual_properties(self, temperature, density):
        """Residual property set at (T, rho_i [A^-3]); see
        :func:`feos_tpu_torch.properties.mix_properties`."""
        from ..properties import mix_properties

        return mix_properties(self.params, self.kij, self._tensor(temperature),
                              self._tensor(density))
