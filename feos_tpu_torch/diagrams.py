"""Binary phase diagrams from the batched bubble-point solvers.

Counterpart of ``feos_tpu/diagrams.py``.  The batch axis is the composition
grid: an isothermal p-x-y diagram is one batched bubble-pressure solve over
x1 in [x_eps, 1 - x_eps] with the incipient vapor composition, and an
isobaric T-x-y diagram one batched bubble-temperature solve.  The bubble
curve is (x1, p) or (x1, T); the dew curve is the same pressures or
temperatures at the converged vapor composition y1.  Initial estimates come
from the pure components: Raoult's law over the pure vapor pressures for
p-x-y, the mole-fraction mix of the pure boiling points for T-x-y (both
through ``phi_d2``).  Rows whose solve fails are NaN with ``nans`` True.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .models.pcsaft_mix import bubble_point, bubble_point_t
from .models.pcsaft_pure import boiling_temperature, vapor_pressure

F64 = torch.float64


class BinaryTxy(NamedTuple):
    """Isobaric T-x-y diagram, every field ``(N,)`` over the composition
    grid: the bubble curve (x1, t), the dew curve (y1, t), t in K."""

    x1: torch.Tensor
    y1: torch.Tensor
    t: torch.Tensor
    nans: torch.Tensor


class BinaryPxy(NamedTuple):
    """Isothermal p-x-y diagram, every field ``(N,)`` over the composition
    grid: the bubble curve (x1, p), the dew curve (y1, p), p in Pa."""

    x1: torch.Tensor
    y1: torch.Tensor
    p: torch.Tensor
    nans: torch.Tensor


def _grid(n_points, x_eps, device):
    """x1 on the open interval: the pure endpoints are degenerate."""
    return torch.linspace(x_eps, 1.0 - x_eps, n_points, dtype=F64, device=device)


def _binary(parameters, kij, n_points, device):
    """The ``(2, 8)`` parameters and kij, each tiled to ``n_points`` rows.
    A scalar kij means ``[k_ij, 0]``: broadcasting it to the pair would
    switch on an epsilon_k_AiBj override equal to k_ij."""
    pp = torch.as_tensor(parameters, dtype=F64, device=device)
    if pp.shape != (2, 8):
        raise ValueError(f"parameters must be (2, 8), got {tuple(pp.shape)}")
    if kij is None:
        return pp, pp.expand(n_points, 2, 8), None
    k = torch.as_tensor(kij, dtype=F64, device=device)
    if k.dim() == 0 or k.shape == (1,):
        k = torch.cat([k.reshape(1), k.new_zeros(1)])
    elif k.shape != (2,):
        raise ValueError("kij must be a scalar k_ij or the pair [k_ij, eps_AiBj], "
                         f"got shape {tuple(k.shape)}")
    return pp, pp.expand(n_points, 2, 8), k.expand(n_points, 2)


@torch.no_grad()
def _raoult_init(parameters, temperature, x1):
    """Raoult initial pressure from the pure-component vapor pressures."""
    t2 = torch.full((2,), temperature, dtype=F64, device=parameters.device)
    nans, psat = vapor_pressure(parameters, t2)
    psat = torch.where(nans, 1e5, psat)
    return x1 * psat[0] + (1.0 - x1) * psat[1]


def binary_pxy(parameters, kij, temperature, n_points=51, x_eps=1e-3, pressure_init=None,
               device="cuda") -> BinaryPxy:
    """Isothermal p-x-y diagram of one binary mixture at ``temperature`` K.

    ``parameters`` is one ``(2, 8)`` matrix and ``kij`` is ``None``, a scalar
    k_ij or ``[k_ij, eps_AiBj]``.  ``pressure_init`` (Pa, scalar or ``(N,)``)
    defaults to Raoult's law over the pure vapor pressures.  Gradients of
    ``p`` with respect to tensor parameters flow through the bubble point's
    stationary identity.  Runs on ``device``, the card unless the caller
    asks for the CPU.
    """
    x1 = _grid(n_points, x_eps, device)
    pp, batch, kb = _binary(parameters, kij, n_points, device)
    if pressure_init is None:
        pressure_init = _raoult_init(pp.detach(), temperature, x1)
    p0 = torch.as_tensor(pressure_init, dtype=F64, device=device).expand(n_points)
    t = torch.full((n_points,), temperature, dtype=F64, device=device)
    p, nans, y = bubble_point(batch, kb, t, x1, p0, full_output=True)
    return BinaryPxy(x1=x1, y1=y[:, 0], p=p, nans=nans)


def binary_txy(parameters, kij, pressure, n_points=51, x_eps=1e-3, t_init=None,
               device="cuda") -> BinaryTxy:
    """Isobaric T-x-y diagram of one binary mixture at ``pressure`` Pa.

    Arguments as :func:`binary_pxy`.  ``t_init`` (K, scalar or ``(N,)``)
    defaults to the mole-fraction mix of the pure boiling points at
    ``pressure``, solved from 1.2 epsilon_k (a pure solve that fails falls
    back to that start).  Runs on ``device``, the card unless the caller
    asks for the CPU.
    """
    x1 = _grid(n_points, x_eps, device)
    pp, batch, kb = _binary(parameters, kij, n_points, device)
    if t_init is None:
        with torch.no_grad():
            start = 1.2 * pp[:, 2].detach()
            nans_b, tb = boiling_temperature(pp.detach(), pressure, start)
            tb = torch.where(nans_b, start, tb)
        t_init = x1 * tb[0] + (1.0 - x1) * tb[1]
    t0 = torch.as_tensor(t_init, dtype=F64, device=device).expand(n_points)
    p = torch.full((n_points,), pressure, dtype=F64, device=device)
    t, nans, y = bubble_point_t(batch, kb, p, x1, t0, full_output=True)
    return BinaryTxy(x1=x1, y1=y[:, 0], t=t, nans=nans)


def _gc_check(eos, n_points, name):
    """The facade's parameters; raises unless its batch holds ``n_points``
    rows of a binary (gc parameters are assembled per row, so the facade is
    built on ``n_points`` copies of the binary)."""
    params = eos.params
    rows, n_comp = params.m_mix.shape
    if rows != n_points:
        raise ValueError(
            f"eos batch dimension ({rows}) must equal n_points ({n_points}): gc parameters "
            "are assembled per batch row, so build the facade on n_points replicas of "
            "the binary")
    if n_comp != 2:
        raise ValueError(f"{name} needs a binary, got {n_comp} components")
    return params


def gc_binary_txy(eos, pressure, n_points=51, x_eps=1e-3, t_init=None) -> BinaryTxy:
    """Isobaric T-x-y diagram of a gc binary.  ``eos`` is a
    :class:`~feos_tpu_torch.models.gc_pcsaft.GcPcSaftMix` on ``n_points``
    copies of the binary; ``t_init`` (K, scalar or ``(N,)``) defaults to 1.2
    times the mean component epsilon_k.  Runs on the facade's device."""
    params = _gc_check(eos, n_points, "gc_binary_txy")
    dev = params.m.device
    x1 = _grid(n_points, x_eps, dev)
    if t_init is None:
        t_init = 1.2 * params.epsilon_k_mix.detach().mean()
    t0 = torch.as_tensor(t_init, dtype=F64, device=dev).expand(n_points)
    p = torch.full((n_points,), pressure, dtype=F64, device=dev)
    t, nans, y = eos.bubble_point_t(p, x1, t0, full_output=True)
    return BinaryTxy(x1=x1, y1=y[:, 0], t=t, nans=nans)


def gc_binary_pxy(eos, temperature, n_points=51, x_eps=1e-3, pressure_init=1e5) -> BinaryPxy:
    """Isothermal p-x-y diagram of a gc binary.  ``eos`` as in
    :func:`gc_binary_txy`; ``pressure_init`` (Pa, scalar or ``(N,)``) is the
    solver's estimate.  Runs on the facade's device."""
    params = _gc_check(eos, n_points, "gc_binary_pxy")
    dev = params.m.device
    x1 = _grid(n_points, x_eps, dev)
    t = torch.full((n_points,), temperature, dtype=F64, device=dev)
    p0 = torch.as_tensor(pressure_init, dtype=F64, device=dev).expand(n_points)
    p, nans, y = eos.bubble_point(t, x1, p0, full_output=True)
    return BinaryPxy(x1=x1, y1=y[:, 0], p=p, nans=nans)
