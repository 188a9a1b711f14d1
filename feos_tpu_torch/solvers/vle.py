"""Batched gradient-free pure VLE, density and critical-point solvers, and
the n-component bubble/dew solver, in PyTorch (f64).

Counterpart of the f64 paths of ``feos_tpu/solvers/vle.py`` (``pure_vle``
and ``npt_density`` with ``mixed_precision=False``, ``pure_critical``,
``mix_vle`` with ``phi_fn32=None``): the same initialisation, Newton
iterations, tolerances and residual acceptance, on ``(B, ...)`` tensors.

* The JAX package maps per-row ``lax.while_loop``s with ``vmap``, which
  freezes each row at its own exit.  Here each loop runs over the whole
  batch and carries a per-row iteration count; a row is active while it is
  not done and under its iteration cap, and only active rows take the
  update.  The loop stops when no row is active (one host sync per
  iteration).
* Every pure phi evaluation goes through the ``phi_d2`` kernel wrapper,
  except the critical Newton's, which needs phi''' and T-derivatives and
  runs ``phi_pure`` in torch ops (as the JAX package runs it outside
  Pallas).  The mixture solver takes phi closures in torch ops.
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
from ..models.pcsaft_pure import PureParams, phi_pure, precompute_pure

PI = np.pi
_MAX_NPT_ITER = 60
_MAX_VLE_ITER = 80
_MAX_CRIT_ITER = 60
_STEP_TOL = 3e-12
# residual acceptance: well above the f64 cancellation noise of
# p~ = rho - phi + rho*phi', far below any unconverged state
_RES_RTOL = 1e-6
# _vle_newton's residual exit: p~ within 1e-9 relative plus 1e-12 of the
# liquid's rho dp~/drho, mu~ within 1e-9
_NEWTON_RES_RTOL = 1e-9
_NEWTON_RES_ABS = 1e-12
_NEWTON_MU_TOL = 1e-9
# _mix_newton's pressure residual exit: 1e-9 of sum(rho_inc) plus 1e-13 of
# the bulk's total density
_MIX_RES_P_ABS = 1e-13
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
    # a lane whose target or start is not finite (a NaN row that
    # pad_to_multiple added) can never converge: done from the start, it
    # does not hold the loop to its cap
    done = ~(torch.isfinite(p_targets) & torch.isfinite(rho0))
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


@torch.no_grad()
def npt_density(params, temperature, p_target, liquid=True, stats=None):
    """Single-branch pure NPT solve p~(rho) = p_target, all in f64.

    ``params (B, 8)``, ``temperature (B,)`` and the reduced ``p_target (B,)``
    are float64 on one device.  The liquid branch starts at packing fraction
    0.5, the vapor branch at the ideal-gas density p~ = rho; each iteration
    is one ``phi_d2`` call at ``(B, 1)``.  If ``stats`` is a dict, it
    receives the loop's iterations as ``npt`` and ``phi_d2_calls``.

    Returns ``(rho, ok)``; rows whose root packs above eta = 0.7 are masked.
    """
    params = params.detach().contiguous()
    temperature = temperature.detach().contiguous()
    p_target = p_target.detach()
    eta_m = precompute_pure(PureParams.from_tensor(params), temperature).eta_m
    rows = _Rows(params, temperature, eta_m)
    rho0 = 0.5 / eta_m if liquid else torch.clamp(p_target, min=1e-30)
    sign = torch.tensor([1.0 if liquid else -1.0], dtype=F64, device=eta_m.device)
    rho, ok, _, n_iter = _npt_multi_pure(rows, p_target[:, None], rho0[:, None], sign)
    if stats is not None:
        stats.update(npt=n_iter, phi_d2_calls=n_iter)
    rho = rho[:, 0]
    return rho, ok[:, 0] & (eta_m * rho < 0.7)


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


def _phi_d2_d3(p: PureParams, temperature, rho):
    """(phi'', phi''') at ``(B,)`` states, by reverse mode three times.

    These need phi''' and, in the critical Newton's Jacobian, T-derivatives,
    which ``phi_d2`` does not give, so they run ``phi_pure`` in torch ops.
    With grad mode on, both stay differentiable in ``rho``, ``temperature``
    and the parameters.
    """
    keep_graph = torch.is_grad_enabled()
    with torch.enable_grad():
        x = rho if rho.requires_grad else rho.detach().requires_grad_()
        val = phi_pure(p, temperature, x)
        (d1,) = torch.autograd.grad(val.sum(), x, create_graph=True)
        (d2,) = torch.autograd.grad(d1.sum(), x, create_graph=True)
        (d3,) = torch.autograd.grad(d2.sum(), x, create_graph=keep_graph)
    if not keep_graph:
        d2 = d2.detach()
    return d2, d3


def _crit_residual(p: PureParams, u):
    """Residuals of the pure critical conditions at ``u (B, 2) = [ln rho,
    ln T]``, as ``(B, 2)``:

        R1 = dp~/drho = 1 + rho phi''
        R2 = rho d2p~/drho2 = rho (phi'' + rho phi''')

    Both are O(1) near the solution, so one unscaled 2x2 Newton treats them
    evenly.
    """
    e = torch.exp(u)
    rho, t = e[:, 0], e[:, 1]
    d2, d3 = _phi_d2_d3(p, t, rho)
    return torch.stack([1.0 + rho * d2, rho * (d2 + rho * d3)], 1)


_CRIT_RES_TOL = 3e-8


def _val_and_jac(f, u):
    """Value ``(B, j)`` and per-row Jacobians ``(B, j, k)`` of a row-wise
    ``f: (B, k) -> (B, j)``, detached.  Rows are independent, so the
    gradient of ``f(u)[:, i].sum()`` is row i of every row's Jacobian."""
    with torch.enable_grad():
        u = u.detach().requires_grad_()
        r = f(u)
        j = r.shape[1]
        rows = [
            torch.autograd.grad(r[:, i].sum(), u, retain_graph=i < j - 1)[0]
            for i in range(j)
        ]
    return r.detach(), torch.stack(rows, 1)


def _newton_2x2(r, J):
    """The Newton step ``J^-1 r`` of 2x2 systems, ``(B, 2)``, with the
    determinant kept off zero."""
    det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    det = torch.where(det.abs() > 1e-30, det, 1e-30)
    return torch.stack([
        (J[:, 1, 1] * r[:, 0] - J[:, 0, 1] * r[:, 1]) / det,
        (-J[:, 1, 0] * r[:, 0] + J[:, 0, 0] * r[:, 1]) / det,
    ], 1)


@torch.no_grad()
def pure_critical(params, stats=None):
    """Critical point ``(rho_c, T_c)`` of pure PC-SAFT fluids, all in f64.

    Solves dp/drho = 0 and d2p/drho2 = 0 by a damped 2x2 Newton in
    ``(ln rho, ln T)`` per row, from the corresponding-states estimate
    T0 = eps_k (0.89 + 0.38 m) and the density of least dp~/drho on
    ``_ETA_GRID`` at T0 (one ``phi_d2`` call at ``(B, 48)``).  Rows freeze
    at their own exit, as in :func:`_vle_newton`.  If ``stats`` is a dict,
    it receives the Newton iterations as ``newton`` and ``phi_d2_calls``.

    Returns ``(rho_c, T_c, ok)``.
    """
    params = params.detach().contiguous()
    p = PureParams.from_tensor(params)
    dev = params.device
    t0 = p.epsilon_k * (0.89 + 0.38 * p.m)
    eta_m0 = precompute_pure(p, t0).eta_m
    rhos = torch.as_tensor(_ETA_GRID, dtype=F64, device=dev)[None, :] / eta_m0[:, None]
    _, dptildes, _, _ = _eos_pure_multi(_Rows(params, t0.contiguous(), eta_m0), rhos)
    rho0 = rhos.gather(1, torch.argmin(dptildes, dim=1, keepdim=True))[:, 0]
    u = torch.stack([torch.log(rho0), torch.log(t0)], 1)
    lo, hi = torch.log(0.2 * t0), torch.log(5.0 * t0)

    B = params.shape[0]
    keep = torch.full((B, 2), torch.inf, dtype=F64, device=dev)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    n_iter = 0
    while True:
        active = ~done & (it < _MAX_CRIT_ITER)
        if not bool(active.any()):
            break
        r, J = _val_and_jac(lambda v: _crit_residual(p, v), u)
        du = _newton_2x2(r, J)
        converged = r.abs().amax(1) < _CRIT_RES_TOL
        bad = ~torch.isfinite(du).all(1)
        step = torch.where(bad[:, None], 0.0, torch.clamp(du, -0.2, 0.2))
        new = u - step
        # keep the iterate physical: eta(T) < 0.6, T within a broad band of
        # the corresponding-states estimate
        t_new = torch.exp(new[:, 1])
        d_new = p.sigma * (1.0 - 0.12 * torch.exp(-3.0 * p.epsilon_k / t_new))
        eta_m_new = PI / 6.0 * p.m * d_new**3
        new = torch.stack([
            torch.minimum(new[:, 0], torch.log(0.6 / eta_m_new)),
            torch.clamp(new[:, 1], lo, hi),
        ], 1)
        freeze = done | converged | bad
        u_new = torch.where(freeze[:, None], u, new)
        keep_new = torch.where(done[:, None], keep, r)

        a = active[:, None]
        u = torch.where(a, u_new, u)
        keep = torch.where(a, keep_new, keep)
        done = torch.where(active, freeze, done)
        it = it + active
        n_iter += 1
    if stats is not None:
        stats.update(newton=n_iter, phi_d2_calls=1)

    e = torch.exp(u)
    rho_c, t_c = e[:, 0], e[:, 1]
    ok = (
        torch.isfinite(u).all(1)
        & (keep.abs().amax(1) < _CRIT_RES_TOL)
        & (precompute_pure(p, t_c).eta_m * rho_c < 0.7)
    )
    return rho_c, t_c, ok


# ---------------------------------------------------------------------------
# Mixture solvers (generic over the Helmholtz-energy-density closures)
# ---------------------------------------------------------------------------

_N_SS_WARMUP = 16
_MAX_MIX_ITER = 80


def _states_eos(phi_fn, R):
    """``(p~ (B, k), mu~_res (B, k, n))`` of stacked states ``R (B, k, n)``,
    detached: one reverse pass over the row sum."""
    with torch.enable_grad():
        R = R.detach().requires_grad_()
        phi = phi_fn(R)
        (g,) = torch.autograd.grad(phi.sum(), R)
    return R.sum(-1) + (R * g).sum(-1) - phi.detach(), g


def _states_hess(phi_fn, R):
    """``(p~, mu~_res, H)`` of stacked states ``R (B, k, n)``, detached, with
    the Hessians ``H (B, k, n, n) = d2phi/drho_i drho_j`` from n more
    reverse passes over the gradient."""
    n = R.shape[-1]
    with torch.enable_grad():
        R = R.detach().requires_grad_()
        phi = phi_fn(R)
        (g,) = torch.autograd.grad(phi.sum(), R, create_graph=True)
        H = torch.stack([
            torch.autograd.grad(g[..., j].sum(), R, retain_graph=j < n - 1)[0]
            for j in range(n)
        ], -1)
    g = g.detach()
    return R.sum(-1) + (R * g).sum(-1) - phi.detach(), g, H


def _solve3(J, r):
    """Cramer solve of 3x3 systems ``J (B, 3, 3)``, ``r (B, 3)``."""
    c00 = J[:, 1, 1] * J[:, 2, 2] - J[:, 1, 2] * J[:, 2, 1]
    c01 = J[:, 1, 2] * J[:, 2, 0] - J[:, 1, 0] * J[:, 2, 2]
    c02 = J[:, 1, 0] * J[:, 2, 1] - J[:, 1, 1] * J[:, 2, 0]
    det = J[:, 0, 0] * c00 + J[:, 0, 1] * c01 + J[:, 0, 2] * c02
    det = torch.where(det.abs() > 1e-30, det, 1e-30)
    x0 = (
        r[:, 0] * c00
        + r[:, 1] * (J[:, 0, 2] * J[:, 2, 1] - J[:, 0, 1] * J[:, 2, 2])
        + r[:, 2] * (J[:, 0, 1] * J[:, 1, 2] - J[:, 0, 2] * J[:, 1, 1])
    )
    x1 = (
        r[:, 0] * c01
        + r[:, 1] * (J[:, 0, 0] * J[:, 2, 2] - J[:, 0, 2] * J[:, 2, 0])
        + r[:, 2] * (J[:, 0, 2] * J[:, 1, 0] - J[:, 0, 0] * J[:, 1, 2])
    )
    x2 = (
        r[:, 0] * c02
        + r[:, 1] * (J[:, 0, 1] * J[:, 2, 0] - J[:, 0, 0] * J[:, 2, 1])
        + r[:, 2] * (J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0])
    )
    return torch.stack([x0, x1, x2], 1) / det[:, None]


class MixLimits(NamedTuple):
    """Per-row branch limits of the Newton projection, ``(B,)`` each."""

    ln_inc_min: torch.Tensor
    ln_inc_max: torch.Tensor
    ln_bulk_min: torch.Tensor
    ln_bulk_max: torch.Tensor


def _mix_limits(phi_fn, z, p0, md3, incipient_is_vapor):
    """Packing-fraction grid scan of p~(rho; z) per row.

    Detects the van der Waals loop by differences along ``_ETA_GRID``,
    caps the pressure estimate at half the vapor-spinodal pressure, and
    returns ``(p0_capped, MixLimits)``: the incipient phase's limits are
    widened by the extreme per-component size ratio, since it rotates its
    composition away from the bulk's z.
    """
    B = z.shape[0]
    inf = torch.full((B,), torch.inf, dtype=F64, device=z.device)
    z_md3 = (z * md3).sum(-1)
    eta_factor = PI / 6.0 * z_md3

    grid = torch.as_tensor(_ETA_GRID, dtype=F64, device=z.device)
    rho_grid = grid[None, :] / eta_factor[:, None]
    pt_grid, _ = _states_eos(phi_fn, z[:, None, :] * rho_grid[:, :, None])
    # mechanical instability between grid points i and i+1
    unstable = pt_grid[:, 1:] < pt_grid[:, :-1]
    has_loop = unstable.any(1)
    seen = torch.cat([torch.zeros_like(unstable[:, :1]), unstable.cumsum(1) > 0], 1)
    p_sv = torch.where(seen, -torch.inf, pt_grid).amax(1)
    p0 = torch.where(has_loop, torch.minimum(p0, 0.5 * p_sv), p0)
    p0 = torch.clamp(p0, min=1e-30)

    k_seg = unstable.shape[1]
    idx = torch.arange(k_seg, device=z.device)
    first_u = torch.where(unstable, idx, k_seg).amin(1)
    last_u = torch.where(unstable, idx, -1).amax(1)
    ln_grid = torch.log(rho_grid)

    def at(i):
        return ln_grid.gather(1, torch.clamp(i, max=k_seg)[:, None])[:, 0]

    ln_rho_sv = torch.where(has_loop, at(first_u), inf)
    ln_rho_sl = torch.where(has_loop, at(last_u + 1), -inf)
    if incipient_is_vapor:
        # incipient vapor rotates toward smaller molecules: the spinodal cap
        # at equal eta sits at a higher molar density
        cap = ln_rho_sv + torch.log(z_md3 / md3.amin(-1))
        return p0, MixLimits(-inf, cap, ln_rho_sl, inf)
    # incipient liquid rotates toward larger molecules: the branch floor at
    # equal eta sits at a lower molar density
    floor = ln_rho_sl + torch.log(z_md3 / md3.amax(-1))
    return p0, MixLimits(floor, inf, -inf, ln_rho_sv)


def _mix_init(phi_q, phi_exact, z, p0, md3, incipient_is_vapor, stats):
    """Cold start of the mixture Newton, per row:

    1. the grid scan (:func:`_mix_limits`);
    2. NPT solves of both phase branches at p0 in one 2-lane Newton loop
       (lane 0 liquid from eta = 0.5, lane 1 vapor from rho = p0), each
       step's slope d p~/d ln rho from the exact phi's Hessian;
    3. ``_N_SS_WARMUP`` successive-substitution steps on the incipient
       fugacities (dew: with a bulk re-estimate each step).

    Returns ``(u0 (B, n+1) = [ln rho_inc, ln rho_bulk_t], limits, init_ok)``.
    """
    dev = z.device
    z_md3 = (z * md3).sum(-1)
    eta_factor = PI / 6.0 * z_md3

    p0, limits = _mix_limits(phi_q, z, p0, md3, incipient_is_vapor)

    # -- branch NPT solves (lane 0 = liquid, lane 1 = vapor) ---------------
    branch_sign = torch.tensor([1.0, -1.0], dtype=F64, device=dev)
    lr_cap = torch.log(0.74 / eta_factor)[:, None]
    B = z.shape[0]
    lr = torch.log(torch.stack([0.5 / eta_factor, p0], 1))
    keep = torch.stack([torch.full((B, 2), torch.inf, dtype=F64, device=dev),
                        torch.ones((B, 2), dtype=F64, device=dev)])
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros((B, 2), dtype=torch.bool, device=dev)
    n_npt = 0
    while True:
        active = (~done).any(1) & (it < _MAX_NPT_ITER)
        if not bool(active.any()):
            break
        R = z[:, None, :] * torch.exp(lr)[:, :, None]
        pt, _, H = _states_hess(phi_exact, R)
        # d p~ / d ln rho along the ray R = z rho
        dpt = (R * (1.0 + (R[..., :, None] * H).sum(-2))).sum(-1)
        r = pt - p0[:, None]
        pos = dpt > 0.0
        newton = r / torch.where(pos, dpt, 1.0)
        step = torch.where(pos, torch.clamp(newton, -0.5, 0.5), -branch_sign * 0.2)
        converged = (newton.abs() < _STEP_TOL) & pos
        bad = ~torch.isfinite(step)
        step = torch.where(bad, 0.0, step)
        freeze = done | converged | bad
        lr_new = torch.where(freeze, lr, torch.minimum(lr - step, lr_cap))
        keep_new = torch.where(done, keep, torch.stack([pt, dpt]))

        a = active[:, None]
        lr = torch.where(a, lr_new, lr)
        keep = torch.where(a, keep_new, keep)
        done = torch.where(a, freeze, done)
        it = it + active
        n_npt += 1
    pt_f, dpt_f = keep
    pos = dpt_f > 0.0
    npt_ok = pos & ((pt_f - p0[:, None]).abs() / torch.where(pos, dpt_f, 1.0)
                    < max(_STEP_TOL * 1e3, 1e-6))

    i_bulk = 0 if incipient_is_vapor else 1
    rho_bulk_t0 = torch.exp(lr[:, i_bulk])
    rho_inc_t0 = torch.exp(lr[:, 1 - i_bulk])
    init_ok = npt_ok[:, i_bulk] & torch.isfinite(rho_bulk_t0)

    # -- successive-substitution warmup ------------------------------------
    ln_i = torch.log(z * rho_inc_t0[:, None])
    ln_bt = torch.log(rho_bulk_t0)
    for _ in range(_N_SS_WARMUP):
        R = torch.stack([torch.exp(ln_i), z * torch.exp(ln_bt)[:, None]], 1)
        _, g = _states_eos(phi_q, R)
        target = torch.log(z) + ln_bt[:, None] + g[:, 1] - g[:, 0]
        if incipient_is_vapor:
            # vapor: the fugacity fixed point is a contraction
            ln_i = ln_i + torch.clamp(target - ln_i, -1.0, 1.0)
        else:
            # liquid incipient: rotate only the composition and pin the
            # packing fraction at the NPT liquid's; re-estimate the bulk
            # (vapor) total from the ideal-vapor identity
            ln_x = target - torch.logsumexp(target, -1, keepdim=True)
            eta_corr = z_md3 / (torch.exp(ln_x) * md3).sum(-1)
            mu_inc = ln_i + g[:, 0]
            ln_i = ln_x + torch.log(rho_inc_t0 * eta_corr)[:, None]
            ln_bt = torch.minimum(
                torch.logsumexp(torch.clamp(mu_inc, -78.0, 78.0), -1), limits.ln_bulk_max
            )
    if stats is not None:
        stats.update(npt=n_npt, ss=_N_SS_WARMUP)
    return torch.cat([ln_i, ln_bt[:, None]], 1), limits, init_ok


def _mix_newton(phi_q, phi_exact, z, u0, limits: MixLimits):
    """Damped full Newton on ``u = [ln rho_inc (n), ln rho_bulk_t]`` per row.

    The residual ``[mu~_i(inc) - mu~_i(bulk), p~(inc) - p~(bulk)]`` comes
    from the Q-form phi (exact first derivatives).  The Jacobian is
    assembled from the exact phi's f64 Hessians (the Q form's second
    derivatives miss the dX/drho term, which stalls Newton at strong
    association):

        J[i, j] = H_inc[i, j] rho_inc[j] + delta_ij           (j < n)
        J[i, n] = -(sum_j H_bulk[i, j] rho_bulk[j] + 1)
        J[n, j] = rho_inc[j] (1 + sum_i rho_inc[i] H_inc[i, j])
        J[n, n] = -sum_j rho_bulk[j] (1 + sum_i rho_bulk[i] H_bulk[i, j])

    A row exits on step size, on residual, or on a stall at the evaluation
    noise floor (its merit not below 0.9x its best for 3 armed
    iterations); rows that exit on step or residual apply the final step,
    stalled rows freeze in place.  The last evaluated residual is carried.

    Returns ``(u, out (B, n+4) = [residual (n+1), p~_inc, p~_bulk,
    pressure-row stiffness], iterations)``.
    """
    B, n1 = u0.shape
    n = n1 - 1
    dev = u0.device
    eye = torch.eye(n, dtype=F64, device=dev)

    def project(u):
        # keep each phase on its branch (outside the unstable region)
        ln_inc_tot = torch.logsumexp(u[:, :n], -1)
        clipped = torch.minimum(torch.maximum(ln_inc_tot, limits.ln_inc_min),
                                limits.ln_inc_max)
        bulk = torch.minimum(torch.maximum(u[:, n], limits.ln_bulk_min), limits.ln_bulk_max)
        return torch.cat([u[:, :n] + (clipped - ln_inc_tot)[:, None], bulk[:, None]], 1)

    u = u0
    out_keep = torch.full((B, n + 4), torch.inf, dtype=F64, device=dev)
    best = torch.full((B,), torch.inf, dtype=F64, device=dev)
    stale = torch.zeros(B, dtype=torch.int64, device=dev)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    n_iter = 0
    while True:
        active = ~done & (it < _MAX_MIX_ITER)
        if not bool(active.any()):
            break
        e = torch.exp(u)
        r_inc, r_bulk = e[:, :n], z * e[:, n:]
        R = torch.stack([r_inc, r_bulk], 1)
        pt, g = _states_eos(phi_q, R)
        mu = torch.log(R) + g
        _, _, H = _states_hess(phi_exact, R)
        h_inc, h_bulk = H[:, 0], H[:, 1]
        j_mu_inc = h_inc * r_inc[:, None, :] + eye
        j_mu_bulk = -((h_bulk * r_bulk[:, None, :]).sum(-1) + 1.0)
        j_p_inc = r_inc * (1.0 + (r_inc[:, :, None] * h_inc).sum(1))
        j_p_bulk = -(r_bulk * (1.0 + (r_bulk[:, :, None] * h_bulk).sum(1))).sum(-1)
        J = torch.cat([torch.cat([j_mu_inc, j_mu_bulk[:, :, None]], 2),
                       torch.cat([j_p_inc, j_p_bulk[:, None]], 1)[:, None, :]], 1)
        # pressure-row stiffness |d p~/d ln rho| of the stiffer phase: the
        # absolute evaluation-noise scale of the pressure residual
        stiff = torch.maximum(J[:, n, n].abs(), J[:, n, :n].abs().sum(-1))
        out = torch.cat([mu[:, 0] - mu[:, 1], (pt[:, 0] - pt[:, 1])[:, None], pt, stiff[:, None]], 1)
        r = out[:, : n + 1]
        # the binary keeps the JAX package's Cramer solve with its det clamp;
        # wider rows take LU with partial pivoting without the error check
        # (so without a host sync on the card): a singular row's step is not
        # finite and ``bad`` stops it, as the JAX package's jnp.linalg.solve
        step = (_solve3(J, r) if n == 2
                else torch.linalg.solve_ex(J, r[..., None])[0][..., 0])
        p_allow = (_NEWTON_RES_RTOL * e[:, :n].sum(-1)
                   + _MIX_RES_P_ABS * e[:, n])
        res_mu = r[:, :n].abs().amax(-1)
        res_ok = (res_mu < _NEWTON_MU_TOL) & (r[:, n].abs() < p_allow)
        merit = torch.maximum(res_mu / _NEWTON_MU_TOL, r[:, n].abs() / p_allow)
        improved = merit < 0.9 * best
        armed = merit < 1e3
        stale_new = torch.where(improved, 0, torch.where(armed, stale + 1, stale))
        best_new = torch.minimum(best, merit)
        stalled = stale_new >= 3
        converged = (step.abs().amax(-1) < _STEP_TOL) | res_ok | stalled
        bad = ~torch.isfinite(step).all(-1)
        step = torch.where(bad[:, None], 0.0, torch.clamp(step, -0.5, 0.5))
        # non-stalled active rows take the computed step, including the
        # final step on the iteration they converge
        apply = ~done & ~bad & ~stalled
        u_new = torch.where(apply[:, None], project(u - step), u)
        out_new = torch.where(done[:, None], out_keep, out)

        a = active[:, None]
        u = torch.where(a, u_new, u)
        out_keep = torch.where(a, out_new, out_keep)
        best = torch.where(active, best_new, best)
        stale = torch.where(active, stale_new, stale)
        done = torch.where(active, done | converged | bad, done)
        it = it + active
        n_iter += 1
    return u, out_keep, n_iter


@torch.no_grad()
def mix_vle(phi_q, phi_exact, z, p0, md3, incipient_is_vapor: bool, u0_init=None,
            stats=None):
    """Bubble/dew-point solve of mixtures, all in f64, detached.

    The bulk phase has the known mole fractions ``z (B, n)`` (liquid for
    bubble, vapor for dew); the unknowns are the incipient phase's partial
    densities and the bulk's total density, in log space.  ``phi_q`` and
    ``phi_exact`` map ``(B, k, n)`` densities to phi ``(B, k)``: the Q-form
    phi for residuals and first derivatives, the exact phi for Hessians.
    ``p0 (B,)`` is the reduced pressure estimate and ``md3 (B, n)`` = m d^3.

    With ``u0_init (B, n+1)``, a converged log-state from a nearby solve,
    only the grid scan runs (for the projection limits) before the Newton;
    rows whose warm state is not finite fail their mask.  If ``stats`` is
    a dict, it receives each loop's iterations.

    Returns ``(rho_inc (B, n), rho_bulk (B, n), ok (B,), p~_eq (B,))``, the
    reduced pressure from the carried residual state on the vapor side.
    """
    B, n = z.shape
    if u0_init is not None:
        _, limits = _mix_limits(phi_q, z, p0, md3, incipient_is_vapor)
        u0 = u0_init.detach().to(F64)
        init_ok = torch.isfinite(u0).all(-1)
        # a NaN warm state would poison its row's Newton; park such rows at
        # a harmless interior point and let init_ok fail them
        u0 = torch.where(init_ok[:, None], u0, 0.0)
        if stats is not None:
            stats.update(npt=0, ss=0)
    else:
        u0, limits, init_ok = _mix_init(phi_q, phi_exact, z, p0, md3,
                                        incipient_is_vapor, stats)
    u, out, n_newton = _mix_newton(phi_q, phi_exact, z, u0, limits)
    if stats is not None:
        stats.update(newton=n_newton)

    e_u = torch.exp(u)
    rho_inc = e_u[:, :n]
    rho_bulk = z * e_u[:, n:]
    r = out[:, : n + 1]
    # the vapor side's p~ is well-conditioned; the liquid's is a
    # cancellation of large terms
    pt_eq = out[:, n + 1] if incipient_is_vapor else out[:, n + 2]
    scale_p = rho_inc.sum(-1)
    res_mu = r[:, :n].abs().amax(-1)
    # absolute allowance for the liquid-pressure cancellation noise, from
    # the carried pressure-row stiffness (the JAX package's calibration)
    p_noise = 6e-12 * out[:, n + 3]
    res_p = r[:, n].abs() / (scale_p + p_noise / _RES_RTOL)
    trivial = (torch.log(scale_p) - u[:, n]).abs() < 1e-5
    if incipient_is_vapor:
        ordered = scale_p < rho_bulk.sum(-1)
    else:
        ordered = scale_p > rho_bulk.sum(-1)
    ok = (
        init_ok
        & torch.isfinite(u).all(-1)
        & (res_mu < 1e-7)
        & (res_p < _RES_RTOL)
        & ~trivial
        & ordered
        & (pt_eq > 0.0)
    )
    return rho_inc, rho_bulk, ok, pt_eq
