"""PC-SAFT parameter regression with ``torch.optim``.

Counterpart of ``feos_tpu/regression.py``'s ``pure_loss``, ``fit_pure``,
``binary_loss``, ``fit_binary`` and ``fit_gc``: relative least-squares
losses over the converged rows (vapor pressures and liquid densities of
pure components; bubble pressures of binaries and of gc binaries),
minimised by Adam through the solvers' re-attached gradients.
A fit is a plain Python loop (:func:`run_adam`), one host round trip a
step; the bubble-point fits carry the solver's converged state from step
to step.  With a ``mesh`` (``parallel/mesh.py``), each process is given the
global data and fits on its block of rows: the loss terms and their
converged counts and the parameter gradient are summed across processes,
so every process takes the same steps as a fit of the whole batch in one
process (to rounding) and holds the same parameters.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .models.gc_pcsaft import GcTopology, assemble, gc_bubble_point, kab_matrix
from .models.pcsaft_mix import bubble_point
from .models.pcsaft_pure import liquid_density, vapor_pressure
from .parallel.mesh import all_reduce_sum

F64 = torch.float64
# steps skipped in a row on non-finite gradients before one is applied
# anyway (optax.apply_if_finite's max_consecutive_errors in the JAX package)
MAX_CONSECUTIVE_ERRORS = 20


def masked_relative_sse(pred, target, ok, mesh=None):
    """Mean of ((pred - target)/target)^2 over converged rows.

    A row whose target is not finite (a row ``pad_to_multiple`` added) is
    no data: it is left out as a failed row is, and its target never meets
    a gradient (0 * NaN would poison it).  With a ``mesh``, the mean runs
    over the converged rows of every process: this process's share of it,
    which the fit sums across processes.

    Returns +inf when no row converged: a silent 0 would make a fully
    diverged parameter vector look like a perfect fit.
    """
    ok = ok & torch.isfinite(target)
    target = torch.where(ok, target, 1.0)
    rel = torch.where(ok, (pred - target) / target, 0.0)
    n_ok = ok.sum() if mesh is None else all_reduce_sum(ok.sum(), mesh)
    loss = (rel * rel).sum() / torch.clamp(n_ok, min=1)
    return torch.where(n_ok > 0, loss, torch.inf)


def pure_loss(parameters: torch.Tensor, temperature, p_sat=None, rho_liq=None,
              pressure=None, mesh=None):
    """Combined relative-SSE loss on vapor pressure (Pa) and/or liquid
    density (kmol/m^3, at ``pressure`` Pa).

    ``parameters`` is one ``(8,)`` vector shared by every row (its gradient
    sums over the rows) or a ``(B, 8)`` batch of per-row parameters.  With
    a ``mesh``, the rows are this process's block and the loss is its share
    (:func:`masked_relative_sse`).
    """
    if parameters.dim() == 1:
        parameters = parameters.expand(temperature.shape[0], 8)
    loss = torch.zeros((), dtype=F64, device=parameters.device)
    if p_sat is not None:
        nans, vp = vapor_pressure(parameters, temperature)
        loss = loss + masked_relative_sse(torch.where(nans, 1.0, vp), p_sat, ~nans, mesh)
    if rho_liq is not None:
        nans, rl = liquid_density(parameters, temperature, pressure)
        loss = loss + masked_relative_sse(torch.where(nans, 1.0, rl), rho_liq, ~nans, mesh)
    return loss


class FitResult(NamedTuple):
    parameters: torch.Tensor
    loss_history: torch.Tensor


def run_adam(theta, lr, steps, loss_fn, aux=None, mesh=None):
    """Adam on ``theta`` for ``steps`` steps; ``loss_fn(theta, aux)`` returns
    ``(loss, aux)``, and the auxiliary value (a solver's converged state, or
    ``None``) rides from each step to the next without a gradient.

    Adam's defaults equal optax's.  A step whose gradient is not finite is
    skipped and leaves Adam's state untouched, up to
    ``MAX_CONSECUTIVE_ERRORS`` in a row (optax's ``apply_if_finite``, which
    the JAX package wraps around its optimiser).  With a ``mesh``, the loss
    is this process's share: the gradient and the recorded loss are summed
    across processes before the step, so every process decides to skip or
    take it alike and holds the same ``theta``.  Returns ``(theta, loss
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
        if mesh is None:
            losses.append(loss.detach())
        else:
            theta.grad = all_reduce_sum(theta.grad, mesh)
            losses.append(all_reduce_sum(loss, mesh))
        not_finite = 0 if bool(torch.isfinite(theta.grad).all()) else not_finite + 1
        if not_finite == 0 or not_finite > MAX_CONSECUTIVE_ERRORS:
            opt.step()
    return theta.detach(), torch.stack(losses)


def _data_rows(*columns):
    """The rows in which every given ``(B, ...)`` column is finite: the
    fit's data.  The others are rows ``pad_to_multiple`` added."""
    valid = None
    for c in columns:
        if c is not None:
            ok = torch.isfinite(c).reshape(c.shape[0], -1).all(1)
            valid = ok if valid is None else valid & ok
    return valid


def _stand_in(x, valid):
    """``x`` with every row that is not ``valid`` replaced by a copy of the
    first valid row: a padded row then gives the solver and the
    re-attachment finite inputs, so its zero cotangent meets no NaN
    (0 * NaN would poison a shared parameter's gradient), while its NaN
    target keeps it out of the loss (:func:`masked_relative_sse`)."""
    if x is None:
        return None
    first = torch.argmax(valid.to(torch.uint8))
    return torch.where(valid.reshape(-1, *(1,) * (x.dim() - 1)), x, x[first])


def _no_data(x, valid):
    """The target ``x`` with NaN on the rows that are not ``valid``."""
    return None if x is None else torch.where(valid, x, torch.nan)


def fit_pure(initial_parameters, temperature, p_sat=None, rho_liq=None,
             pressure=None, steps=200, mesh=None):
    """Fit PC-SAFT parameters to pure-component data by Adam.

    ``initial_parameters`` is a numpy array, ``(8,)`` shared by every row
    or ``(B, 8)``; the data are ``(B,)`` float64 tensors on the device
    the fit runs on.  Optimisation runs on scaled parameters
    z = params / |params_0| (zeros scale to 1), so one learning rate serves
    parameters five orders of magnitude apart.  The optimiser is
    :func:`run_adam` with lr 1e-2, the JAX package's ``optax.adam(1e-2)``.

    With a ``mesh`` (``parallel.batch_mesh``), every process passes the
    global data (arrays or tensors) and fits on its block of rows on
    ``mesh.device``; per-row parameters stay whole on every process, and
    each process's loss takes its rows of them.  Rows that hold a value
    that is not finite (``pad_to_multiple``'s) are no data, and per-row
    parameters come back on them as those of the first row of data.

    Returns ``FitResult(parameters, loss_history)``; the history holds the
    loss before each step.
    """
    device = temperature.device if mesh is None else mesh.device

    def f64(x):
        return None if x is None else torch.as_tensor(x, dtype=F64, device=device)

    temperature, p_sat, rho_liq, pressure = map(f64, (temperature, p_sat, rho_liq, pressure))
    valid = _data_rows(temperature, p_sat, rho_liq, pressure)
    temperature, pressure = _stand_in(temperature, valid), _stand_in(pressure, valid)
    p_sat, rho_liq = _no_data(p_sat, valid), _no_data(rho_liq, valid)
    params0 = f64(np.asarray(initial_parameters, dtype=np.float64))
    per_row = params0.dim() == 2
    if per_row:
        params0 = _stand_in(params0, valid)
    scale = torch.where(params0 != 0.0, params0.abs(), 1.0)
    rows = slice(None) if mesh is None else mesh.block(temperature.shape[0])
    temperature, p_sat, rho_liq, pressure = (
        None if x is None else x[rows] for x in (temperature, p_sat, rho_liq, pressure))

    def loss_fn(z, aux):
        q = z * scale
        return pure_loss(q[rows] if per_row else q, temperature, p_sat, rho_liq, pressure,
                         mesh), aux

    z, losses = run_adam(params0 / scale, 1e-2, steps, loss_fn, mesh=mesh)
    return FitResult(z * scale, losses)


def bubble_loss(p, nans, p_data, state, state0=None, mesh=None):
    """``(loss, state to carry)`` of a bubble-point fit step: the relative
    SSE of the pressures ``p`` over the converged rows against ``p_data``
    (with a ``mesh``, this process's share of it), and the solver's
    converged ``state``, detached, in which rows that failed keep ``state0``
    (NaN would poison their warm start for good; the parameters move, so a
    row that failed this step may converge from its old state the next)."""
    loss = masked_relative_sse(torch.where(nans, 1.0, p), p_data, ~nans, mesh)
    if state0 is not None:
        state = torch.where(nans[:, None], state0, state)
    return loss, state.detach()


def _bubble_data(temperature, liquid_molefracs, p_bubble, mesh):
    """A bubble-point fit's data on this process: ``(T, x1, p data, p
    estimates)``, with the rows ``pad_to_multiple`` added given stand-in
    inputs and no data (:func:`_stand_in`), and with a ``mesh`` this
    process's block of rows."""
    valid = _data_rows(temperature, liquid_molefracs, p_bubble)
    data = (_stand_in(temperature, valid), _stand_in(liquid_molefracs, valid),
            _no_data(p_bubble, valid), _stand_in(p_bubble, valid))
    if mesh is None:
        return data
    rows = mesh.block(temperature.shape[0])
    return tuple(x[rows] for x in data)


def binary_loss(kij_pair, parameters, temperature, liquid_molefracs, p_bubble, p0=None,
                state0=None, return_state=False, mesh=None):
    """Relative-SSE loss of bubble pressures for one binary pair.

    ``kij_pair`` is the ``(2,)`` tensor ``[k_ij, epsilon_k_AiBj]`` shared by
    every data row, ``parameters`` the ``(2, 8)`` component parameters, and
    the data are ``(B,)`` tensors of temperatures, liquid mole fractions x1
    and bubble pressures [Pa]; ``p0`` holds the solver's pressure estimates
    (``p_bubble`` when None).  ``state0 (B, 3)`` is a converged
    solver state from a previous call at nearby parameters (a warm start).
    With a ``mesh``, the rows are this process's block and the loss its
    share (:func:`masked_relative_sse`).
    Returns the loss and, with ``return_state``, the converged state to
    carry, detached, in which failed rows keep ``state0``
    (:func:`bubble_loss`).
    """
    B = temperature.shape[0]
    p, nans, state = bubble_point(parameters.expand(B, 2, 8), kij_pair.expand(B, 2),
                                  temperature, liquid_molefracs,
                                  p_bubble if p0 is None else p0, state0=state0,
                                  state_output=True)
    loss, state = bubble_loss(p, nans, p_bubble, state, state0, mesh)
    return (loss, state) if return_state else loss


def fit_binary(parameters, temperature, liquid_molefracs, p_bubble, kij0=0.0,
               epsilon_k_aibj0=None, steps=100, device="cuda", mesh=None):
    """Fit the binary interaction parameters k_ij and, optionally, the
    cross-association energy epsilon_k_AiBj to bubble-point data.

    The ``(2, 8)`` component parameters stay fixed; the data are ``(B,)``
    temperatures, liquid mole fractions x1 and bubble pressures [Pa] (also
    the solver's pressure estimates), as arrays or tensors.  Adam with lr
    5e-3 (:func:`run_adam`, the JAX package's ``optax.adam(5e-3)``) runs on
    theta = ``[k_ij, epsilon_k_AiBj / |epsilon_k_aibj0|]``; with
    ``epsilon_k_aibj0`` None, epsilon_k_AiBj stays 0 (the combining rule)
    and only k_ij is fitted.  One cold solve seeds the state that
    warm-starts every step; each process keeps its own.  The fit runs on
    ``device``, the card unless the caller asks for the CPU; with a
    ``mesh``, every process passes the global data and fits on its block of
    rows on ``mesh.device``.  Rows holding a value that is not finite
    (``pad_to_multiple``'s) are no data.  Returns ``FitResult([k_ij,
    epsilon_k_AiBj], loss_history)``.
    """
    if mesh is not None:
        device = mesh.device

    def f64(x):
        return torch.as_tensor(x, dtype=F64, device=device)

    temperature, liquid_molefracs, p_data, p0 = _bubble_data(
        *map(f64, (temperature, liquid_molefracs, p_bubble)), mesh)
    parameters = f64(parameters)
    fit_eps = epsilon_k_aibj0 is not None
    eps0 = float(epsilon_k_aibj0) if fit_eps else 0.0
    eps_scale = abs(eps0) if eps0 != 0.0 else 1.0
    scale = f64([1.0, eps_scale if fit_eps else 0.0])

    def loss_fn(theta, state0):
        return binary_loss(theta * scale, parameters, temperature, liquid_molefracs, p_data,
                           p0=p0, state0=state0, return_state=True, mesh=mesh)

    theta0 = f64([float(kij0), eps0 / eps_scale])
    with torch.no_grad():
        _, state = loss_fn(theta0, None)
    theta, losses = run_adam(theta0, 5e-3, steps, loss_fn, state, mesh)
    return FitResult(theta * scale, losses)


def fit_gc(segment_identifier, parameter, segment_lists, bond_lists,
           binary_segment_records, temperature, liquid_molefracs, p_bubble, phi=None,
           steps=100, device="cuda", mesh=None):
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
    for the CPU; with a ``mesh``, every process passes the global data and
    fits on its block of rows on ``mesh.device``.  Rows holding a value
    that is not finite (``pad_to_multiple``'s) are no data.  Returns
    ``FitResult(k_ab values, loss_history)``.
    """
    if mesh is not None:
        device = mesh.device

    def f64(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)

    B = len(temperature)
    if len(segment_lists) != B:
        if len(segment_lists) != 1:
            raise ValueError("segment_lists must describe one system or one per data row")
        segment_lists, bond_lists = list(segment_lists) * B, list(bond_lists) * B
    temperature, liquid_molefracs, p_data, p0 = _bubble_data(
        *map(f64, (temperature, liquid_molefracs, p_bubble)), mesh)
    rows = slice(None) if mesh is None else mesh.block(B)
    topology = GcTopology.build(segment_identifier, segment_lists[rows], bond_lists[rows])
    seg_params = f64(np.stack([np.asarray(c, dtype=np.float64) for c in parameter], -1))
    if phi is not None:
        phi = f64(phi).reshape(-1, topology.counts.shape[1]).expand(B, -1)[rows]
    pairs = [(s1, s2) for s1, s2, _ in binary_segment_records]

    def loss_fn(theta, state0):
        kab = kab_matrix(segment_identifier, pairs, theta)
        params = assemble(topology, seg_params, kab, phi)
        p, nans, state = gc_bubble_point(params, temperature, liquid_molefracs, p0,
                                         state0=state0, state_output=True)
        return bubble_loss(p, nans, p_data, state, state0, mesh)

    theta0 = f64([k for _, _, k in binary_segment_records])
    with torch.no_grad():
        _, state = loss_fn(theta0, None)
    theta, losses = run_adam(theta0, 5e-3, steps, loss_fn, state, mesh)
    return FitResult(theta, losses)
