"""Batched gradient-free pure VLE solver in PyTorch (f64).

Counterpart of the f64 path of ``feos_tpu/solvers/vle.py::pure_vle``
(``mixed_precision=False``): the same initialisation, Newton iterations,
tolerances and residual acceptance, on ``(B, ...)`` tensors.

* The JAX package maps per-row ``lax.while_loop``s with ``vmap``, which
  freezes each row at its own exit.  Here each loop runs over the whole
  batch and carries a per-row iteration count; a row is active while it is
  not done and under its iteration cap, and only active rows take the
  update.  The loop stops when no row is active (one host sync per
  iteration).
* Every phi evaluation goes through the ``phi_d2`` kernel wrapper.
* Failures are a boolean ``ok`` per row on fixed shapes, never exceptions.
* Everything runs under ``torch.no_grad()`` on detached inputs; gradients
  re-attach outside, through stationary identities.

All quantities are reduced: densities in A^-3, p~ = p A^3/(kB T),
mu~ = mu/(kB T).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.phi_d2 import phi_d2
from ..models.pcsaft_pure import PureParams, precompute_pure

_MAX_NPT_ITER = 60
_MAX_VLE_ITER = 80
_STEP_TOL = 3e-12
# residual acceptance: well above the f64 cancellation noise of
# p~ = rho - phi + rho*phi', far below any unconverged state
_RES_RTOL = 1e-6
# _vle_newton's residual exit: p~ within 1e-9 relative plus 1e-12 of the
# liquid's rho dp~/drho, mu~ within 1e-9
_NEWTON_RES_RTOL = 1e-9
_NEWTON_RES_ABS = 1e-12
_NEWTON_MU_TOL = 1e-9
F64 = torch.float64

# Static packing-fraction grid that brackets the unstable region for the
# near-critical initialisation (see ``_spinodal_estimate``).
_ETA_GRID = np.concatenate(
    [np.geomspace(1e-4, 0.01, 8, endpoint=False), np.linspace(0.01, 0.55, 40)]
)


class _Rows(NamedTuple):
    """Per-row inputs of the loops: the kernel's arguments and the packing
    fraction factor eta = eta_m * rho."""

    params: torch.Tensor       # (B, 8), contiguous
    temperature: torch.Tensor  # (B,)
    eta_m: torch.Tensor        # (B,)


def _eos_pure_multi(rows: _Rows, rho):
    """(p~, dp~/drho, mu~_tot, dmu~/drho) at ``rho (B, k)``: one kernel call."""
    val, d1, d2 = phi_d2(rows.params, rows.temperature, rho)
    ptilde = rho - val + rho * d1
    dptilde = 1.0 + rho * d2
    mu = d1 + torch.log(rho)
    dmu = d2 + 1.0 / rho
    return ptilde, dptilde, mu, dmu


def _npt_multi_pure(rows: _Rows, p_targets, rho0, branch_sign):
    """Solve k pure NPT problems p~(rho) = p_target per row in one loop.

    ``p_targets`` and ``rho0`` are ``(B, k)``; ``branch_sign`` (k,) is +1
    for liquid-branch and -1 for vapor-branch lanes: inside the unstable
    region (dp~/drho <= 0) the iterate walks toward its branch.  The k lanes
    of a row share the row's loop but freeze one by one; the last evaluated
    (p~, dp~, mu~) is carried, so acceptance needs no re-evaluation.

    Returns ``(rho, ok, mu, iterations)``, the first three ``(B, k)``.
    """
    B, k = p_targets.shape
    dev = p_targets.device
    lr_max = torch.log(0.74 / rows.eta_m)[:, None]  # packing-fraction cap
    lr = torch.log(rho0)
    keep = torch.stack([
        torch.full((B, k), torch.inf, dtype=F64, device=dev),
        torch.ones((B, k), dtype=F64, device=dev),
        torch.zeros((B, k), dtype=F64, device=dev),
    ])
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros((B, k), dtype=torch.bool, device=dev)
    n_iter = 0
    while True:
        active = (~done).any(1) & (it < _MAX_NPT_ITER)
        if not bool(active.any()):
            break
        rho = torch.exp(lr)
        ptilde, dptilde, mu, _ = _eos_pure_multi(rows, rho)
        r = ptilde - p_targets
        dr = rho * dptilde  # d p~ / d ln rho
        pos = dr > 0.0
        newton = r / torch.where(pos, dr, 1.0)
        step = torch.where(pos, torch.clamp(newton, -0.5, 0.5), -branch_sign * 0.2)
        converged = (newton.abs() < _STEP_TOL) & pos
        bad = ~torch.isfinite(step)
        step = torch.where(bad, 0.0, step)
        freeze = done | converged | bad
        lr_new = torch.where(freeze, lr, torch.minimum(lr - step, lr_max))
        keep_new = torch.where(done, keep, torch.stack([ptilde, dptilde, mu]))

        a = active[:, None]
        lr = torch.where(a, lr_new, lr)
        keep = torch.where(a, keep_new, keep)
        done = torch.where(a, freeze, done)
        it = it + active
        n_iter += 1

    rho = torch.exp(lr)
    ptilde, dptilde, mu = keep
    resid = (ptilde - p_targets).abs() / (
        rho * torch.where(dptilde > 0.0, dptilde, 1.0)
    ).abs()
    ok = torch.isfinite(rho) & (dptilde > 0.0) & (resid < _RES_RTOL)
    return rho, ok, mu, n_iter


def _spinodal_estimate(rows: _Rows):
    """Grid-scan estimate of the inflection state of p~(rho).

    Evaluates dp~/drho on ``_ETA_GRID`` and returns ``(p_inf, rho_inf,
    supercritical)``: the pressure and density at the grid minimum of
    dp~/drho, and whether that minimum is positive (no van der Waals loop).
    """
    grid = torch.as_tensor(_ETA_GRID, dtype=F64, device=rows.eta_m.device)
    rhos = grid[None, :] / rows.eta_m[:, None]
    ptildes, dptildes, _, _ = _eos_pure_multi(rows, rhos)
    i_min = torch.argmin(dptildes, dim=1, keepdim=True)
    supercritical = dptildes.gather(1, i_min)[:, 0] > 0.0
    p_inf = torch.clamp(ptildes.gather(1, i_min)[:, 0], min=1e-12)
    rho_inf = rhos.gather(1, i_min)[:, 0]
    return p_inf, rho_inf, supercritical


def _vle_init(rows: _Rows):
    """Initial ``(ln rho_V, ln rho_L)`` for the VLE Newton, per row.

    Deep subcritical rows take the liquid at vanishing pressure and the
    ideal-vapor saturation estimate ln p~0 = mu~_tot(rho_L); near-critical
    rows start both phases from NPT solves at the inflection pressure.

    Returns ``(lvl0 (B, 2), ln rho_inf, ok_l, supercritical, iterations)``.
    """
    eta_m = rows.eta_m
    dev = eta_m.device
    p_inf, rho_inf, supercritical = _spinodal_estimate(rows)

    # lane 0: liquid at vanishing pressure; lane 1: liquid at p_inf
    rho_liq = 0.5 / eta_m
    rho_init, ok_init, mu_init, n_liq = _npt_multi_pure(
        rows,
        torch.stack([torch.full_like(p_inf, 1e-10), p_inf], 1),
        torch.stack([rho_liq, rho_liq], 1),
        torch.tensor([1.0, 1.0], dtype=F64, device=dev),
    )
    ok_tiny = ok_init[:, 0] & (eta_m * rho_init[:, 0] < 0.7)
    rho_l0 = torch.where(ok_tiny, rho_init[:, 0], rho_init[:, 1])
    ok_l = ok_tiny | ok_init[:, 1]

    # saturation estimate from the ideal-vapor identity ln p~0 = mu~(rho_L)
    mu0 = mu_init[:, 0]
    p_mu = torch.exp(torch.clamp(mu0, -78.0, 78.0))
    p0 = torch.where(ok_tiny, p_mu, p_inf)

    rho_v0, ok_v, _, n_vap = _npt_multi_pure(
        rows,
        p0[:, None],
        torch.clamp(p0, min=1e-30)[:, None],
        torch.tensor([-1.0], dtype=F64, device=dev),
    )
    # the vapor estimate lives in log space: where the NPT refinement is
    # unusable, ln rho_V = mu~_tot(rho_L) is the ideal-vapor identity itself
    rv = rho_v0[:, 0]
    ln_rho_v0 = torch.where(
        ok_v[:, 0] & (p0 > 1e-33) & (rv > 0.0),
        torch.log(torch.where(rv > 0.0, rv, 1.0)),
        torch.where(ok_tiny, mu0, torch.log(torch.clamp(p0, min=1e-300))),
    )
    lvl0 = torch.stack([ln_rho_v0, torch.log(rho_l0)], 1)
    return lvl0, torch.log(rho_inf), ok_l, supercritical, n_liq + n_vap


def _vle_newton(rows: _Rows, lvl0, ln_inf):
    """Damped 2x2 Newton on ``(ln rho_V, ln rho_L)`` with branch projection.

    Iterates stay on their branch (rho_V below, rho_L above the inflection
    density).  A row exits on step size, on residuals (``_NEWTON_*``),
    or when its residual merit stops improving for 3 armed iterations
    (a stall at the evaluation-noise floor).  Rows that exit on step or
    residual apply the final Newton step; stalled rows freeze in place.

    Returns ``(lvl (B, 2), keep (4, B) = [r_p, r_mu, dpt_V, dpt_L],
    iterations)``.
    """
    B = lvl0.shape[0]
    dev = lvl0.device
    lvl = lvl0
    keep = torch.full((4, B), torch.inf, dtype=F64, device=dev)
    best = torch.full((B,), torch.inf, dtype=F64, device=dev)
    stale = torch.zeros(B, dtype=torch.int64, device=dev)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    n_iter = 0
    while True:
        active = ~done & (it < _MAX_VLE_ITER)
        if not bool(active.any()):
            break
        rho = torch.exp(lvl)  # (B, 2) = [rho_V, rho_L]
        pt, dpt, mu, dmu = _eos_pure_multi(rows, rho)
        r1 = pt[:, 0] - pt[:, 1]
        r2 = mu[:, 0] - mu[:, 1]
        j00 = rho[:, 0] * dpt[:, 0]
        j01 = -rho[:, 1] * dpt[:, 1]
        j10 = rho[:, 0] * dmu[:, 0]
        j11 = -rho[:, 1] * dmu[:, 1]
        det = j00 * j11 - j01 * j10
        det = torch.where(det.abs() > 1e-30, det, 1e-30)
        dv = (j11 * r1 - j01 * r2) / det
        dl = (-j10 * r1 + j00 * r2) / det
        # exit on step size or on residuals at the acceptance level (the
        # absolute term covers the liquid-pressure cancellation noise)
        p_allow = (_NEWTON_RES_RTOL * j00.abs()
                   + _NEWTON_RES_ABS * (rho[:, 1] * dpt[:, 1]).abs())
        res_ok = (r1.abs() < p_allow) & (r2.abs() < _NEWTON_MU_TOL)
        # noise-floor stall detection
        merit = torch.maximum(r1.abs() / p_allow, r2.abs() / _NEWTON_MU_TOL)
        improved = merit < 0.9 * best
        armed = merit < 1e3
        stale_new = torch.where(improved, 0, torch.where(armed, stale + 1, stale))
        best_new = torch.minimum(best, merit)
        stalled = stale_new >= 3
        converged = ((dv.abs() + dl.abs()) < _STEP_TOL) | res_ok | stalled
        step = torch.clamp(torch.stack([dv, dl], 1), -0.2, 0.2)
        bad = ~torch.isfinite(step).all(1)
        step = torch.where(bad[:, None], 0.0, step)
        new = lvl - step
        new = torch.stack(
            [torch.minimum(new[:, 0], ln_inf), torch.maximum(new[:, 1], ln_inf)], 1
        )
        freeze = done | converged | bad
        # non-stalled active rows take the computed step, including the
        # final step on the iteration they converge
        apply = ~done & ~bad & ~stalled
        lvl_new = torch.where(apply[:, None], new, lvl)
        keep_new = torch.where(done, keep, torch.stack([r1, r2, dpt[:, 0], dpt[:, 1]]))

        lvl = torch.where(active[:, None], lvl_new, lvl)
        keep = torch.where(active, keep_new, keep)
        best = torch.where(active, best_new, best)
        stale = torch.where(active, stale_new, stale)
        done = torch.where(active, freeze, done)
        it = it + active
        n_iter += 1
    return lvl, keep, n_iter


@torch.no_grad()
def pure_vle(params, temperature, stats=None):
    """Pure-component vapor-liquid equilibrium, all in f64.

    ``params (B, 8)`` and ``temperature (B,)`` are float64 on one device.
    Solves p~(rho_V) = p~(rho_L), mu~(rho_V) = mu~(rho_L) by a damped 2x2
    Newton in (ln rho_V, ln rho_L) and accepts rows on their residuals.

    If ``stats`` is a dict, it receives the number of batch iterations of
    each loop; each iteration is one ``phi_d2`` call, and so is the
    spinodal scan, so ``stats["phi_d2_calls"]`` is the solve's call count.

    Returns ``(rho_v, rho_l, ok)``; supercritical rows are masked.
    """
    params = params.detach().contiguous()
    temperature = temperature.detach().contiguous()
    pre = precompute_pure(PureParams.from_tensor(params), temperature)
    rows = _Rows(params, temperature, pre.eta_m)

    lvl0, ln_inf, ok_l, supercritical, n_npt = _vle_init(rows)
    lvl, keep, n_newton = _vle_newton(rows, lvl0, ln_inf)
    if stats is not None:
        stats.update(npt=n_npt, newton=n_newton, phi_d2_calls=1 + n_npt + n_newton)
    rho = torch.exp(lvl)
    rho_v, rho_l = rho[:, 0], rho[:, 1]

    # residual-based acceptance from the carried loop state; the pressure
    # tolerance carries an absolute allowance for the f64 cancellation noise
    # of the liquid pressure (terms of size rho_l * dp_l), which dominates
    # when the vapor pressure is many orders smaller (strong association at
    # low T)
    r_p, r_mu, dpt_v, dpt_l = keep
    p_noise = 4e-12 * (rho_l * dpt_l).abs()
    res_p_ok = r_p.abs() < (_RES_RTOL * (rho_v * dpt_v).abs() + p_noise)
    ok = (
        ok_l
        & ~supercritical
        & torch.isfinite(rho).all(1)
        & res_p_ok
        & (r_mu.abs() < 1e-7)
        & (rho_l > rho_v * (1.0 + 1e-6))
        & (dpt_v > 0.0)
        & (dpt_l > 0.0)
    )
    return rho_v, rho_l, ok
