"""Residual thermodynamic state properties from temperature derivatives.

Counterpart of the pure-component part of ``feos_tpu/properties.py``.  With
the reduced Helmholtz energy density ``Phi = A_res / (kB T V)`` (A^-3) and
the derivatives along the density ray rho (1 + s) at s = 0,

    S1 = rho dPhi/drho,    S2 = rho^2 d2Phi/drho2,

the property set per mole is

    p~            = rho - Phi + S1                         (reduced pressure)
    Z             = p~ / rho
    a_res /(RT)   = Phi / rho
    s_res / R     = -(Phi + T Phi_T) / rho
    u_res /(RT)   = -T Phi_T / rho
    h_res /(RT)   = u_res/(RT) + Z - 1
    g_res /(RT)   = a_res/(RT) + Z - 1
    c_v_res / R   = -T (2 Phi_T + T Phi_TT) / rho
    c_p_res / R   = c_v_res/R + (p~ + T p~_T)^2 / (rho (rho + S2)) - 1
    ln phi        = dPhi/drho - ln Z

with ``p~_T = -Phi_T + S1_T`` at fixed density.  Phi_T, Phi_TT and S1_T
come from autograd in T, S1 and S2 from autograd in s.  Temperatures in K,
densities reduced (A^-3); outputs molar SI: Pa, J/mol, J/(mol K).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .models.pcsaft_pure import PureParams, phi_pure
from .units import REDUCED_TO_PA_PER_KT, RGAS


class ResidualProperties(NamedTuple):
    """Batched residual property set, every field ``(B,)``."""

    pressure: torch.Tensor          # total pressure, Pa
    compressibility: torch.Tensor   # Z = p / (rho kB T)
    a_res: torch.Tensor             # residual molar Helmholtz energy, J/mol
    s_res: torch.Tensor             # residual molar entropy, J/(mol K)
    u_res: torch.Tensor             # residual molar internal energy, J/mol
    h_res: torch.Tensor             # residual molar enthalpy, J/mol
    g_res: torch.Tensor             # residual molar Gibbs energy, J/mol
    c_v_res: torch.Tensor           # residual molar isochoric heat capacity, J/(mol K)
    c_p_res: torch.Tensor           # residual molar isobaric heat capacity, J/(mol K)
    ln_phi: torch.Tensor            # ln fugacity coefficient


def _leaf(x):
    return x if x.requires_grad else x.detach().requires_grad_()


def pure_properties(parameters: torch.Tensor, temperature, density) -> ResidualProperties:
    """Batched pure-component residual properties at (T, rho).

    ``parameters`` is ``(B, 8)``, ``temperature`` and the reduced number
    ``density`` (A^-3) are ``(B,)``.  With grad mode on, every field is
    differentiable with respect to those of the three that require grad.
    """
    keep_graph = torch.is_grad_enabled() and any(
        x.requires_grad for x in (parameters, temperature, density))
    p = PureParams.from_tensor(parameters)
    with torch.enable_grad():
        t = _leaf(temperature)
        rho = _leaf(density)
        s = torch.zeros_like(rho, requires_grad=True)
        x = rho * (1.0 + s)
        phi = phi_pure(p, t, x)

        def d(y, wrt):
            return torch.autograd.grad(y.sum(), wrt, create_graph=True)[0]

        mu, s1, phi_t = torch.autograd.grad(phi.sum(), (x, s, t), create_graph=True)
        s2, s1_t = d(s1, s), d(s1, t)
        phi_tt = d(phi_t, t)

    ptilde = rho - phi + s1
    ptilde_t = -phi_t + s1_t
    z = ptilde / rho
    a_rt = phi / rho
    s_r = -(a_rt + t * phi_t / rho)
    u_rt = -t * phi_t / rho
    cv_r = -t * (2.0 * phi_t + t * phi_tt) / rho
    cp_r = cv_r + (ptilde + t * ptilde_t) ** 2 / (rho * (rho + s2)) - 1.0

    rt = RGAS * t
    out = ResidualProperties(
        pressure=ptilde * t * REDUCED_TO_PA_PER_KT,
        compressibility=z,
        a_res=rt * a_rt,
        s_res=RGAS * s_r,
        u_res=rt * u_rt,
        h_res=rt * (u_rt + z - 1.0),
        g_res=rt * (a_rt + z - 1.0),
        c_v_res=RGAS * cv_r,
        c_p_res=RGAS * cp_r,
        ln_phi=mu - torch.log(z),
    )
    if not keep_graph:
        out = ResidualProperties(*(f.detach() for f in out))
    return out
