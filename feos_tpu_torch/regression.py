"""Pure-component PC-SAFT parameter regression with ``torch.optim``.

Counterpart of ``feos_tpu/regression.py``'s ``pure_loss`` and ``fit_pure``:
a relative least-squares loss on vapor pressures and liquid densities over
the converged rows, minimised by Adam through the solvers' re-attached
gradients.  The fit is a plain Python loop, one host round trip a step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .models.pcsaft_pure import liquid_density, vapor_pressure

F64 = torch.float64
# steps skipped in a row on non-finite gradients before one is applied
# anyway (optax.apply_if_finite's max_consecutive_errors in the JAX package)
MAX_CONSECUTIVE_ERRORS = 20


def masked_relative_sse(pred, target, ok):
    """Mean of ((pred - target)/target)^2 over converged rows.

    Returns +inf when no row converged: a silent 0 would make a fully
    diverged parameter vector look like a perfect fit.
    """
    rel = torch.where(ok, (pred - target) / target, 0.0)
    n_ok = ok.sum()
    loss = (rel * rel).sum() / torch.clamp(n_ok, min=1)
    return torch.where(n_ok > 0, loss, torch.inf)


def pure_loss(parameters: torch.Tensor, temperature, p_sat=None, rho_liq=None,
              pressure=None):
    """Combined relative-SSE loss on vapor pressure (Pa) and/or liquid
    density (kmol/m^3, at ``pressure`` Pa).

    ``parameters`` is one ``(8,)`` vector shared by every row (its gradient
    sums over the rows) or a ``(B, 8)`` batch of per-row parameters.
    """
    if parameters.dim() == 1:
        parameters = parameters.expand(temperature.shape[0], 8)
    loss = torch.zeros((), dtype=F64, device=parameters.device)
    if p_sat is not None:
        nans, vp = vapor_pressure(parameters, temperature)
        loss = loss + masked_relative_sse(torch.where(nans, 1.0, vp), p_sat, ~nans)
    if rho_liq is not None:
        nans, rl = liquid_density(parameters, temperature, pressure)
        loss = loss + masked_relative_sse(torch.where(nans, 1.0, rl), rho_liq, ~nans)
    return loss


class FitResult(NamedTuple):
    parameters: torch.Tensor
    loss_history: torch.Tensor


def fit_pure(initial_parameters, temperature, p_sat=None, rho_liq=None,
             pressure=None, steps=200):
    """Fit PC-SAFT parameters to pure-component data by Adam.

    ``initial_parameters`` is a numpy array, ``(8,)`` shared by every row
    or ``(B, 8)``; the data are ``(B,)`` float64 tensors on the device
    the fit runs on.  Optimisation runs on scaled parameters
    z = params / |params_0| (zeros scale to 1), so one learning rate serves
    parameters five orders of magnitude apart.  The optimiser is Adam with
    lr 1e-2, whose defaults equal the JAX package's ``optax.adam(1e-2)``.  A
    step whose gradient is not finite is skipped and leaves Adam's state
    untouched, up to ``MAX_CONSECUTIVE_ERRORS`` in a row.

    Returns ``FitResult(parameters, loss_history)``; the history holds the
    loss before each step.
    """
    params0 = torch.as_tensor(np.asarray(initial_parameters, dtype=np.float64),
                              device=temperature.device)
    scale = torch.where(params0 != 0.0, params0.abs(), 1.0)
    z = (params0 / scale).requires_grad_()
    opt = torch.optim.Adam([z], lr=1e-2)
    losses = []
    not_finite = 0
    for _ in range(steps):
        opt.zero_grad()
        loss = pure_loss(z * scale, temperature, p_sat, rho_liq, pressure)
        loss.backward()
        losses.append(loss.detach())
        not_finite = 0 if bool(torch.isfinite(z.grad).all()) else not_finite + 1
        if not_finite == 0 or not_finite > MAX_CONSECUTIVE_ERRORS:
            opt.step()
    return FitResult((z * scale).detach(), torch.stack(losses))
