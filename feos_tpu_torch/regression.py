"""PC-SAFT parameter regression with ``torch.optim``.

Counterpart of ``feos_tpu/regression.py``'s ``pure_loss``, ``fit_pure``,
``binary_loss``, ``fit_binary`` and ``fit_gc``: relative least-squares
losses over the converged rows (vapor pressures and liquid densities of
pure components; bubble pressures of binaries and of gc binaries),
minimised by Adam through the solvers' re-attached gradients.
A fit is a plain Python loop (:func:`run_adam`), one host round trip a
step; the bubble-point fits carry the solver's converged state from step
to step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .models.gc_pcsaft import GcTopology, assemble, gc_bubble_point, kab_matrix
from .models.pcsaft_mix import bubble_point
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


def run_adam(theta, lr, steps, loss_fn, aux=None):
    """Adam on ``theta`` for ``steps`` steps; ``loss_fn(theta, aux)`` returns
    ``(loss, aux)``, and the auxiliary value (a solver's converged state, or
    ``None``) rides from each step to the next without a gradient.

    Adam's defaults equal optax's.  A step whose gradient is not finite is
    skipped and leaves Adam's state untouched, up to
    ``MAX_CONSECUTIVE_ERRORS`` in a row (optax's ``apply_if_finite``, which
    the JAX package wraps around its optimiser).  Returns ``(theta, loss
    history)``, the history holding the loss before each step.
    """
    theta = theta.detach().clone().requires_grad_()
    opt = torch.optim.Adam([theta], lr=lr)
    losses = []
    not_finite = 0
    for _ in range(steps):
        opt.zero_grad()
        loss, aux = loss_fn(theta, aux)
        loss.backward()
        losses.append(loss.detach())
        not_finite = 0 if bool(torch.isfinite(theta.grad).all()) else not_finite + 1
        if not_finite == 0 or not_finite > MAX_CONSECUTIVE_ERRORS:
            opt.step()
    return theta.detach(), torch.stack(losses)


def fit_pure(initial_parameters, temperature, p_sat=None, rho_liq=None,
             pressure=None, steps=200):
    """Fit PC-SAFT parameters to pure-component data by Adam.

    ``initial_parameters`` is a numpy array, ``(8,)`` shared by every row
    or ``(B, 8)``; the data are ``(B,)`` float64 tensors on the device
    the fit runs on.  Optimisation runs on scaled parameters
    z = params / |params_0| (zeros scale to 1), so one learning rate serves
    parameters five orders of magnitude apart.  The optimiser is
    :func:`run_adam` with lr 1e-2, the JAX package's ``optax.adam(1e-2)``.

    Returns ``FitResult(parameters, loss_history)``; the history holds the
    loss before each step.
    """
    params0 = torch.as_tensor(np.asarray(initial_parameters, dtype=np.float64),
                              device=temperature.device)
    scale = torch.where(params0 != 0.0, params0.abs(), 1.0)

    def loss_fn(z, aux):
        return pure_loss(z * scale, temperature, p_sat, rho_liq, pressure), aux

    z, losses = run_adam(params0 / scale, 1e-2, steps, loss_fn)
    return FitResult(z * scale, losses)


def bubble_loss(p, nans, p_data, state, state0=None):
    """``(loss, state to carry)`` of a bubble-point fit step: the relative
    SSE of the pressures ``p`` over the converged rows against ``p_data``,
    and the solver's converged ``state``, detached, in which rows that
    failed keep ``state0`` (NaN would poison their warm start for good; the
    parameters move, so a row that failed this step may converge from its
    old state the next)."""
    loss = masked_relative_sse(torch.where(nans, 1.0, p), p_data, ~nans)
    if state0 is not None:
        state = torch.where(nans[:, None], state0, state)
    return loss, state.detach()


def binary_loss(kij_pair, parameters, temperature, liquid_molefracs, p_bubble, state0=None,
                return_state=False):
    """Relative-SSE loss of bubble pressures for one binary pair.

    ``kij_pair`` is the ``(2,)`` tensor ``[k_ij, epsilon_k_AiBj]`` shared by
    every data row, ``parameters`` the ``(2, 8)`` component parameters, and
    the data are ``(B,)`` tensors of temperatures, liquid mole fractions x1
    and bubble pressures [Pa], which are also the solver's pressure
    estimates.  ``state0 (B, 3)`` is a converged
    solver state from a previous call at nearby parameters (a warm start).
    Returns the loss and, with ``return_state``, the converged state to
    carry, detached, in which failed rows keep ``state0``
    (:func:`bubble_loss`).
    """
    B = temperature.shape[0]
    p, nans, state = bubble_point(parameters.expand(B, 2, 8), kij_pair.expand(B, 2),
                                  temperature, liquid_molefracs, p_bubble, state0=state0,
                                  state_output=True)
    loss, state = bubble_loss(p, nans, p_bubble, state, state0)
    return (loss, state) if return_state else loss


def fit_binary(parameters, temperature, liquid_molefracs, p_bubble, kij0=0.0,
               epsilon_k_aibj0=None, steps=100, device="cuda"):
    """Fit the binary interaction parameters k_ij and, optionally, the
    cross-association energy epsilon_k_AiBj to bubble-point data.

    The ``(2, 8)`` component parameters stay fixed; the data are ``(B,)``
    temperatures, liquid mole fractions x1 and bubble pressures [Pa] (also
    the solver's pressure estimates), as arrays or tensors.  Adam with lr
    5e-3 (:func:`run_adam`, the JAX package's ``optax.adam(5e-3)``) runs on
    theta = ``[k_ij, epsilon_k_AiBj / |epsilon_k_aibj0|]``; with
    ``epsilon_k_aibj0`` None, epsilon_k_AiBj stays 0 (the combining rule)
    and only k_ij is fitted.  One cold solve seeds the state that
    warm-starts every step.  The fit runs on ``device``, the card unless
    the caller asks for the CPU.  Returns ``FitResult([k_ij,
    epsilon_k_AiBj], loss_history)``.
    """
    def f64(x):
        return torch.as_tensor(x, dtype=F64, device=device)

    parameters, temperature, liquid_molefracs, p_bubble = map(
        f64, (parameters, temperature, liquid_molefracs, p_bubble))
    fit_eps = epsilon_k_aibj0 is not None
    eps0 = float(epsilon_k_aibj0) if fit_eps else 0.0
    eps_scale = abs(eps0) if eps0 != 0.0 else 1.0
    scale = f64([1.0, eps_scale if fit_eps else 0.0])

    def loss_fn(theta, state0):
        return binary_loss(theta * scale, parameters, temperature, liquid_molefracs, p_bubble,
                           state0=state0, return_state=True)

    theta0 = f64([float(kij0), eps0 / eps_scale])
    with torch.no_grad():
        _, state = loss_fn(theta0, None)
    theta, losses = run_adam(theta0, 5e-3, steps, loss_fn, state)
    return FitResult(theta * scale, losses)


def fit_gc(segment_identifier, parameter, segment_lists, bond_lists,
           binary_segment_records, temperature, liquid_molefracs, p_bubble, phi=None,
           steps=100, device="cuda"):
    """Fit the gc binary segment parameters k_ab to bubble-point data.

    Segment parameters and molecule topologies stay fixed; the k_ab of every
    record ``(seg_a, seg_b, k0)`` in ``binary_segment_records`` is fitted
    from its ``k0`` against ``(temperature, liquid_molefracs (x1), p_bubble
    [Pa])`` rows, which are also the solver's pressure estimates.
    ``segment_lists``/``bond_lists`` describe one system, tiled over the
    rows, or one per row; ``parameter`` is the 8-tuple of ``(S,)`` segment
    columns.  Adam with lr 5e-3 (:func:`run_adam`), the JAX package's
    ``optax.adam(5e-3)``; one cold solve seeds the state that warm-starts
    every step.  The fit runs on ``device``, the card unless the caller asks
    for the CPU.  Returns ``FitResult(k_ab values, loss_history)``.
    """
    def f64(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)

    temperature, liquid_molefracs, p_bubble = map(f64, (temperature, liquid_molefracs,
                                                        p_bubble))
    B = temperature.shape[0]
    if len(segment_lists) != B:
        if len(segment_lists) != 1:
            raise ValueError("segment_lists must describe one system or one per data row")
        segment_lists, bond_lists = list(segment_lists) * B, list(bond_lists) * B
    topology = GcTopology.build(segment_identifier, segment_lists, bond_lists)
    seg_params = f64(np.stack([np.asarray(c, dtype=np.float64) for c in parameter], -1))
    if phi is not None:
        phi = f64(phi).reshape(-1, topology.counts.shape[1]).expand(B, -1)
    pairs = [(s1, s2) for s1, s2, _ in binary_segment_records]

    def loss_fn(theta, state0):
        kab = kab_matrix(segment_identifier, pairs, theta)
        params = assemble(topology, seg_params, kab, phi)
        p, nans, state = gc_bubble_point(params, temperature, liquid_molefracs, p_bubble,
                                         state0=state0, state_output=True)
        return bubble_loss(p, nans, p_bubble, state, state0)

    theta0 = f64([k for _, _, k in binary_segment_records])
    with torch.no_grad():
        _, state = loss_fn(theta0, None)
    theta, losses = run_adam(theta0, 5e-3, steps, loss_fn, state)
    return FitResult(theta, losses)
