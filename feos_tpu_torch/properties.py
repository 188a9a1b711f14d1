"""Residual thermodynamic state properties from temperature derivatives.

Counterpart of ``feos_tpu/properties.py``.  With the reduced Helmholtz
energy density ``Phi = A_res / (kB T V)`` (A^-3), the partial densities
rho_i with total rho = sum_i rho_i, and the derivatives along the
composition ray rho_i (1 + s) at s = 0,

    S1 = sum_i rho_i dPhi/drho_i,    S2 = rho^T (d2Phi/drho drho) rho,

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
    ln phi_i      = dPhi/drho_i - ln Z

with ``p~_T = -Phi_T + S1_T`` at fixed density.  mu_i = dPhi/drho_i, Phi_T,
Phi_TT and S1_T come from autograd in rho and T, S1 and S2 from autograd in
s; second derivatives in T pass through the association fixed points'
``autograd.Function`` objects, whose backward is differentiable.
Temperatures in K, densities reduced (A^-3); outputs molar SI: Pa, J/mol,
J/(mol K).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .models.gc_pcsaft import phi_gc_pre, precompute_gc
from .models.pcsaft_mix import _pre, phi_mix_pre
from .models.pcsaft_pure import PureParams, phi_pure
from .units import REDUCED_TO_PA_PER_KT, RGAS


class ResidualProperties(NamedTuple):
    """Batched residual property set, every field ``(B,)`` but ``ln_phi``,
    which is ``(B, n)`` for mixtures."""

    pressure: torch.Tensor          # total pressure, Pa
    compressibility: torch.Tensor   # Z = p / (rho kB T)
    a_res: torch.Tensor             # residual molar Helmholtz energy, J/mol
    s_res: torch.Tensor             # residual molar entropy, J/(mol K)
    u_res: torch.Tensor             # residual molar internal energy, J/mol
    h_res: torch.Tensor             # residual molar enthalpy, J/mol
    g_res: torch.Tensor             # residual molar Gibbs energy, J/mol
    c_v_res: torch.Tensor           # residual molar isochoric heat capacity, J/(mol K)
    c_p_res: torch.Tensor           # residual molar isobaric heat capacity, J/(mol K)
    ln_phi: torch.Tensor            # ln fugacity coefficient(s)


def _leaf(x):
    return x if x.requires_grad else x.detach().requires_grad_()


def _properties(phi_fn, inputs, temperature, density) -> ResidualProperties:
    """The property set at ``temperature (B,)`` and partial densities
    ``density (B, n)`` from ``phi_fn(T, rho) -> (B,)``; ``ln_phi`` is ``(B,
    n)``.  With grad mode on, every field is differentiable with respect to
    those of ``inputs`` (the tensors behind ``phi_fn``), ``temperature`` and
    ``density`` that require grad; otherwise the fields are detached."""
    keep_graph = torch.is_grad_enabled() and any(
        x.requires_grad for x in (*inputs, temperature, density))
    with torch.enable_grad():
        t = _leaf(temperature)
        rho = _leaf(density)
        s = torch.zeros(rho.shape[0], dtype=rho.dtype, device=rho.device, requires_grad=True)
        x = rho * (1.0 + s)[:, None]
        phi = phi_fn(t, x)

        def d(y, wrt):
            return torch.autograd.grad(y.sum(), wrt, create_graph=True)[0]

        mu, s1, phi_t = torch.autograd.grad(phi.sum(), (x, s, t), create_graph=True)
        s2, s1_t = d(s1, s), d(s1, t)
        phi_tt = d(phi_t, t)

    rho_t = rho.sum(-1)
    ptilde = rho_t - phi + s1
    ptilde_t = -phi_t + s1_t
    z = ptilde / rho_t
    a_rt = phi / rho_t
    s_r = -(a_rt + t * phi_t / rho_t)
    u_rt = -t * phi_t / rho_t
    cv_r = -t * (2.0 * phi_t + t * phi_tt) / rho_t
    cp_r = cv_r + (ptilde + t * ptilde_t) ** 2 / (rho_t * (rho_t + s2)) - 1.0

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
        ln_phi=mu - torch.log(z)[:, None],
    )
    if not keep_graph:
        out = ResidualProperties(*(f.detach() for f in out))
    return out


def pure_properties(parameters: torch.Tensor, temperature, density) -> ResidualProperties:
    """Batched pure-component residual properties at (T, rho).

    ``parameters`` is ``(B, 8)``, ``temperature`` and the reduced number
    density ``density`` (A^-3) are ``(B,)``; ``ln_phi`` is ``(B,)``.  With
    grad mode on, every field is differentiable with respect to those of
    the three that require grad.
    """
    p = PureParams.from_tensor(parameters)
    out = _properties(lambda t, r: phi_pure(p, t, r[:, 0]), (parameters,), temperature,
                      density[:, None])
    return out._replace(ln_phi=out.ln_phi[:, 0])


def mix_properties(parameters: torch.Tensor, kij, temperature, density) -> ResidualProperties:
    """Batched mixture residual properties at (T, rho_i).

    ``parameters`` is ``(B, n, 8)``, ``kij`` the ``(B, 2)`` ``[k_ij,
    epsilon_k_AiBj]`` (or ``None``), ``temperature (B,)`` and ``density``
    the reduced partial densities ``(B, n)``; ``ln_phi`` is ``(B, n)``.
    Differentiable as :func:`pure_properties`, kij included.
    """
    inputs = (parameters,) if kij is None else (parameters, kij)
    return _properties(lambda t, r: phi_mix_pre(_pre(parameters, kij, t), r), inputs,
                       temperature, density)


def gc_properties(params, temperature, density) -> ResidualProperties:
    """Batched gc-PC-SAFT residual properties at (T, rho_i) over assembled
    :class:`~feos_tpu_torch.models.gc_pcsaft.GcParams`; ``ln_phi`` is ``(B,
    n)``.  Differentiable in the tensors behind ``params`` (segment
    parameters, k_ab, phi) as :func:`pure_properties`.
    """
    return _properties(lambda t, r: phi_gc_pre(precompute_gc(params, t), r), tuple(params),
                       temperature, density)
