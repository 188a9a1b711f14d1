"""Pure-component PC-SAFT in PyTorch: Helmholtz energy and vapor pressure.

Counterpart of ``feos_tpu/models/pcsaft_pure.py``.  The functions take
whole ``(B,)`` parameter columns and ``(B,)`` or ``(B, k)`` densities, with
the batch written out where the JAX package maps a per-item function with
``vmap``.  Everything is ``torch.float64``, on the device of the inputs.

The solver (:mod:`feos_tpu_torch.solvers.vle`) runs detached; gradients
come from plain autograd through the stationary re-attachment identity in
:func:`vapor_pressure`, so no Newton iteration is ever differentiated.

Parameter layout (per row): ``[m, sigma, epsilon_k, mu, kappa_ab,
epsilon_k_ab, na, nb]``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..constants import A0, A1, A2, B0, B1, B2, AD, BD, CD
from ..ops.derivatives import value_and_2derivs
from ..units import MU2_FACTOR, REDUCED_TO_PA_PER_KT

PI = np.pi
F64 = torch.float64


class PureParams(NamedTuple):
    """PC-SAFT pure-component parameters, one ``(B,)`` tensor per column."""

    m: torch.Tensor
    sigma: torch.Tensor
    epsilon_k: torch.Tensor
    mu: torch.Tensor
    kappa_ab: torch.Tensor
    epsilon_k_ab: torch.Tensor
    na: torch.Tensor
    nb: torch.Tensor

    @classmethod
    def from_tensor(cls, parameters: torch.Tensor) -> "PureParams":
        """Columns of a ``(B, 8)`` tensor, as views that keep autograd."""
        return cls(*parameters.unbind(-1))

    @classmethod
    def from_numpy(cls, parameters, device="cuda") -> "PureParams":
        """The JAX package's ``(B, 8)`` parameters, as numpy, on ``device``
        (the card unless the caller asks for the CPU)."""
        t = torch.as_tensor(np.asarray(parameters, dtype=np.float64), device=device)
        return cls.from_tensor(t)


class PurePre(NamedTuple):
    """Density-independent PC-SAFT quantities at fixed (parameters, T).

    Same fields, in the same order, as the JAX package's ``PurePre``; the
    coefficient vectors carry the batch first: ``c_i1`` is ``(B, 7)``.
    """

    m: torch.Tensor        # segment number (hs, hc, C1)
    eta_m: torch.Tensor    # pi/6 m d^3: eta = eta_m * rho
    c_i1: torch.Tensor     # (B, 7) I1 eta-polynomial coefficients
    c_i2: torch.Tensor     # (B, 7) I2 eta-polynomial coefficients
    me: torch.Tensor       # m * eps/T
    m2es3: torch.Tensor    # m^2 (eps/T) sigma^3 (dispersion prefactor)
    c_j1: torch.Tensor     # (B, 5) dipole J1 coefficients ad + bd * eps/T
    c_j2: torch.Tensor     # (B, 4) dipole J2 coefficients
    inv_s3: torch.Tensor   # 1 / sigma^3
    mu2eff: torch.Tensor   # mu^2 reduced and T-scaled (phi2 weight)
    delta_t: torch.Tensor  # (exp(eps_ab/T) - 1) sigma^3 kappa_ab
    na: torch.Tensor
    nb: torch.Tensor


def pure_pre_from_numpy(leaves, device) -> PurePre:
    """A :class:`PurePre` from the leaves of a batched JAX ``PurePre``
    (as numpy arrays, in field order), on ``device``."""
    return PurePre(
        *(torch.as_tensor(np.array(x, dtype=np.float64), device=device)
          for x in leaves)
    )


def precompute_pure(p: PureParams, temperature: torch.Tensor) -> PurePre:
    """Build :class:`PurePre` from ``(B,)`` parameter columns and ``(B,)``
    temperatures.  Plain torch ops, so gradients flow through."""
    m, sigma, epsilon_k = p.m, p.sigma, p.epsilon_k
    dev = m.device

    def const(c):
        return torch.as_tensor(c, dtype=F64, device=dev)

    cA0, cA1, cA2 = const(A0), const(A1), const(A2)
    cB0, cB1, cB2 = const(B0), const(B1), const(B2)
    cAD, cBD, cCD = const(AD), const(BD), const(CD)

    # temperature-dependent segment diameter
    d = sigma * (1.0 - 0.12 * torch.exp(-3.0 * epsilon_k / temperature))
    eta_m = PI / 6.0 * m * d**3

    # dispersion
    e = epsilon_k / temperature
    s3 = sigma**3
    m1 = ((m - 1.0) / m)[:, None]
    m2 = ((m - 2.0) / m)[:, None]
    c_i1 = m1 * (m2 * cA2 + cA1) + cA0
    c_i2 = m1 * (m2 * cB2 + cB1) + cB0

    # dipole coefficients (PCP-SAFT)
    mu2 = p.mu**2 / (m * s3 * epsilon_k) * MU2_FACTOR
    mu2eff = mu2 * e * s3
    mc = torch.clamp(m, max=2.0)
    md1 = (mc - 1.0) / mc
    md2 = md1 * (mc - 2.0) / mc
    md1c, md2c = md1[:, None], md2[:, None]
    ad = cAD[:, 0] + md1c * cAD[:, 1] + md2c * cAD[:, 2]
    bd = cBD[:, 0] + md1c * cBD[:, 1] + md2c * cBD[:, 2]
    c_j1 = ad + bd * e[:, None]
    c_j2 = cCD[:, 0] + md1c * cCD[:, 1] + md2c * cCD[:, 2]

    # association temperature factor
    delta_t = (torch.exp(p.epsilon_k_ab / temperature) - 1.0) * s3 * p.kappa_ab

    return PurePre(
        m=m,
        eta_m=eta_m,
        c_i1=c_i1,
        c_i2=c_i2,
        me=m * e,
        m2es3=m**2 * e * s3,
        c_j1=c_j1,
        c_j2=c_j2,
        inv_s3=1.0 / s3,
        mu2eff=mu2eff,
        delta_t=delta_t,
        na=p.na,
        nb=p.nb,
    )


def phi_pure_pre(pre: PurePre, density: torch.Tensor) -> torch.Tensor:
    """Reduced residual Helmholtz energy density from :class:`PurePre`.

    ``density`` is ``(B,)`` or ``(B, k)``: row ``b`` of every density uses
    row ``b`` of ``pre``.
    """
    rho = density
    tail = (1,) * (rho.dim() - 1)

    def col(x):
        return x.reshape(x.shape[0], *tail)

    m = col(pre.m)
    eta = col(pre.eta_m) * rho
    eta2 = eta * eta
    eta3 = eta2 * eta
    eta_m1 = 1.0 / (1.0 - eta)
    eta_m2 = eta_m1 * eta_m1
    etas = [torch.ones_like(eta), eta, eta2, eta3, eta2 * eta2, eta2 * eta3,
            eta3 * eta3]

    def poly(c, n):
        return sum(col(c[:, i]) * etas[i] for i in range(n))

    # hard sphere
    hs = m * rho * (4.0 * eta - 3.0 * eta2) * eta_m2

    # hard chain
    g = (1.0 - eta / 2.0) * eta_m1 * eta_m2
    hc = -rho * (m - 1.0) * torch.log(g)

    # dispersion
    I1 = poly(pre.c_i1, 7)
    I2 = poly(pre.c_i2, 7)
    C1 = 1.0 / (
        1.0
        + m * (8.0 * eta - 2.0 * eta2) * eta_m2 * eta_m2
        + (1.0 - m)
        * (20.0 * eta - 27.0 * eta2 + 12.0 * eta2 * eta - 2.0 * eta2 * eta2)
        / ((1.0 - eta) * (1.0 - eta) * (2.0 - eta) * (2.0 - eta))
    )
    I = 2.0 * I1 + C1 * I2 * col(pre.me)
    disp = (-PI * rho * rho * col(pre.m2es3)) * I

    # dipole (PCP-SAFT), as the scale-safe Pade of the JAX package:
    # phi2 mu2^2 / (1 - r mu2) with r = rho (J2/J1) (4 pi / 3); mu = 0 rows
    # give exactly zero with finite derivatives
    J1 = poly(pre.c_j1, 5)
    J2 = poly(pre.c_j2, 4)
    phi2 = -rho * rho * J1 * col(pre.inv_s3) * PI
    ratio = rho * (J2 / torch.where(J1 != 0.0, J1, 1.0)) * (4.0 / 3.0 * PI)
    mu2eff = col(pre.mu2eff)
    dipole = phi2 * mu2eff * mu2eff / (1.0 - ratio * mu2eff)

    # association (closed-form 2-site solution; zero when
    # kappa_ab * (exp(eps_ab/T) - 1) = 0)
    k = eta * eta_m1
    delta = (1.0 + k * (1.5 + 0.5 * k)) * eta_m1 * col(pre.delta_t)
    rhoa = col(pre.na) * rho
    rhob = col(pre.nb) * rho
    aux = 1.0 + (rhoa - rhob) * delta
    sqrt = torch.sqrt(aux * aux + 4.0 * rhob * delta)
    xa = 2.0 / (sqrt + 1.0 + (rhob - rhoa) * delta)
    xb = 2.0 / (sqrt + 1.0 - (rhob - rhoa) * delta)
    assoc = rhoa * (torch.log(xa) - 0.5 * xa + 0.5) + rhob * (
        torch.log(xb) - 0.5 * xb + 0.5
    )

    return hs + hc + disp + dipole + assoc


def phi_pure(p: PureParams, temperature, density):
    """Reduced residual Helmholtz energy density phi = A/(kB T V) in A^-3,
    for ``(B,)`` parameter columns and temperatures and ``(B,)`` or
    ``(B, k)`` densities."""
    return phi_pure_pre(precompute_pure(p, temperature), density)


def pure_derivatives(p: PureParams, temperature, density):
    """(phi, p~, dp~/drho) with p~ = rho - phi + rho phi' and
    dp~/drho = 1 + rho phi''."""
    val, d1, d2 = value_and_2derivs(
        lambda r: phi_pure(p, temperature, r), density
    )
    return val, density - val + density * d1, 1.0 + density * d2


def vapor_pressure(parameters: torch.Tensor, temperature: torch.Tensor):
    """Batched vapor pressure in Pa with parameter gradients.

    ``parameters`` is ``(B, 8)`` and ``temperature`` ``(B,)``, both float64
    on one device; either may require grad.  The VLE densities come from
    the detached solver, and the pressure is re-attached through

        p~ = -(a_V - a_L + ln(rho_V/rho_L)) / (1/rho_V - 1/rho_L)

    which is stationary in both converged densities, so autograd through it
    gives the implicit-function derivative of the solve.

    Returns ``(nans, p)``: ``nans`` flags failed rows, where ``p`` is NaN.
    """
    from ..solvers.vle import pure_vle  # here: solvers.vle imports this module

    rho_v, rho_l, ok = pure_vle(parameters.detach(), temperature.detach())
    # sanitise failed lanes before re-attachment: a NaN density there would
    # give NaN derivatives, and the zero cotangent that the final
    # torch.where routes to the lane cannot repair 0 * NaN
    rho_v = torch.where(ok, rho_v, 1e-5)
    rho_l = torch.where(ok, rho_l, 1e-3)

    p = PureParams.from_tensor(parameters)
    a_l = phi_pure(p, temperature, rho_l) / rho_l
    a_v = phi_pure(p, temperature, rho_v) / rho_v
    p_red = -(a_v - a_l + torch.log(rho_v / rho_l)) / (1.0 / rho_v - 1.0 / rho_l)
    pressure = p_red * temperature * REDUCED_TO_PA_PER_KT
    return ~ok, torch.where(ok, pressure, torch.nan)


class PcSaftPure(nn.Module):
    """Module facade over the functional API; holds the ``(B, 8)``
    parameters as an ``nn.Parameter`` on ``device``, the card unless the
    caller asks for the CPU.

    ``vapor_pressure`` returns ``(nans, p_Pa)``, fixed-shape and NaN on
    failed rows; ``helmholtz_energy`` and ``derivatives`` return values.
    """

    def __init__(self, parameters, device="cuda"):
        super().__init__()
        t = torch.as_tensor(np.asarray(parameters, dtype=np.float64), device=device)
        self.params = nn.Parameter(t)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=F64, device=self.params.device)

    def helmholtz_energy(self, temperature, density):
        p = PureParams.from_tensor(self.params)
        return phi_pure(p, self._tensor(temperature), self._tensor(density))

    def derivatives(self, temperature, density):
        p = PureParams.from_tensor(self.params)
        return pure_derivatives(p, self._tensor(temperature), self._tensor(density))

    def vapor_pressure(self, temperature):
        return vapor_pressure(self.params, self._tensor(temperature))
