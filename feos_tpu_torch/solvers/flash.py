"""Batched isothermal pT flash (two-phase split at given T, p, z), f64.

Counterpart of ``feos_tpu/solvers/flash.py`` on ``(B, ...)`` tensors:

* the two-phase window comes from the model's own bubble and dew solves at
  the feed, p_dew < p < p_bubble (:func:`flash_window`);
* ln K starts from a log-interpolation between the two edge solutions, and
  successive substitution refines it: a clipped Rachford-Rice Newton, a
  two-lane NPT Newton warm-started from the previous densities (liquid and
  vapor stacked through one phi graph), and the fugacity update, with
  Michelsen's dominant-eigenvalue extrapolation every third iteration
  (:func:`flash_tp`);
* the solve runs detached; :func:`reattach_flash` re-attaches the
  derivatives of beta, x, y and the densities by the implicit-function
  theorem on the full (2n+1) equilibrium system (:func:`flash_resid`), as
  one symbolic Newton step at the converged state.

The JAX package maps one row's ``while_loop`` with ``vmap``; here the loop
runs over the whole batch, converged rows freeze with ``torch.where``, and
the loop stops when no active row is left (one host sync an iteration).
The NPT loops, which JAX runs for a fixed count, stop early once every
active row's Newton step is below ``_STEP_TOL``: the steps after it move
ln rho by rounding only.

Reduced units throughout: densities in A^-3, p~ = p A^3/(kB T).
"""

from __future__ import annotations

import math

import torch

from .. import tracing
from .vle import _MAX_NPT_ITER, _STEP_TOL, _states_eos, _states_hess, _val_and_jac

PI = math.pi
F64 = torch.float64

_MAX_SS_ITER = 200
# warm NPT steps per successive-substitution iteration (the densities move
# O(d ln K) between iterations and Newton is quadratic from the previous
# root); the polish after the loop takes up to 8
_N_NPT_WARM = 4
_N_NPT_POLISH = 8
_LNK_TOL = 1e-10
_RR_ITER = 24
# failed rows are parked here before the implicit-function step
_PARK_LNR = (math.log(1e-3), math.log(1e-5))


def flash_window(z, pressure, p_bub, nan_b, y_bub, p_dew, nan_d, x_dew, run_flash):
    """Window classification, ln K initialisation and output packing.

    ``run_flash(lnK0, beta0, active) -> (beta, x, y, lnr, ok)`` is the
    model's flash core; ``active`` marks the rows inside the two-phase
    window (the rest carry filler inputs and freeze at iteration 0).
    Returns ``(vapor_frac, x, y, rho, phase)``: ``phase`` is int8, 0 liquid,
    1 vapor, 2 two-phase, -1 failed; beta is 0 / 1 / NaN off the two-phase
    rows; x (y) is the feed where only the liquid (vapor) exists and NaN
    where that phase does not; ``rho (B, 2)`` = [liquid, vapor] is NaN in
    both lanes off the two-phase rows.  At the degenerate point p = p_bubble
    = p_dew the row is liquid.
    """
    ok_b, ok_d = ~nan_b, ~nan_d
    is_liq = ok_b & (pressure >= p_bub)
    is_vap = ok_d & (pressure <= p_dew) & ~is_liq
    two_phase = ok_b & ok_d & (pressure < p_bub) & (pressure > p_dew)

    # ln K from a log-interpolation of the edge solutions in ln p
    lnk_bub = torch.log(y_bub / z)
    lnk_dew = torch.log(z / x_dew)
    denom = torch.log(p_bub) - torch.log(p_dew)
    w = (torch.log(p_bub) - torch.log(pressure)) / torch.where(denom.abs() > 1e-30, denom, 1.0)
    w = torch.clamp(torch.where(torch.isfinite(w), w, 0.5), 0.02, 0.98).detach()
    lnk0 = torch.where(two_phase[:, None],
                       (1.0 - w[:, None]) * lnk_bub + w[:, None] * lnk_dew,
                       math.log(2.0)).detach()

    beta, x, y, lnr, ok = run_flash(lnk0, w, two_phase)
    ok = ok & two_phase

    nan = torch.full_like(z, torch.nan)
    phase = torch.where(ok, 2, torch.where(is_liq, 0, torch.where(is_vap, 1, -1)))
    single = torch.where(is_liq, 0.0, torch.where(is_vap, 1.0, nan[:, 0]))
    beta_out = torch.where(ok, beta, single)
    x_out = torch.where(ok[:, None], x, torch.where(is_liq[:, None], z, nan))
    y_out = torch.where(ok[:, None], y, torch.where(is_vap[:, None], z, nan))
    rho = torch.where(ok[:, None], torch.exp(lnr), torch.nan)
    return beta_out, x_out, y_out, rho, phase.to(torch.int8)


def _rachford_rice(z, K, beta0):
    """Clipped scalar Newton on the Rachford-Rice equation, per row.

    h(beta) = sum_i z_i (K_i - 1) / (1 + beta (K_i - 1)) decreases on
    [0, 1], so a Newton clipped to [1e-12, 1 - 1e-12] converges from any
    start; 24 iterations reach f64 noise.  ``z``, ``K (B, n)``, ``beta0
    (B,)``.
    """
    km1 = K - 1.0
    b = torch.clamp(beta0, 1e-12, 1.0 - 1e-12)
    for _ in range(_RR_ITER):
        den = 1.0 + b[:, None] * km1
        h = (z * km1 / den).sum(-1)
        dh = -(z * km1 * km1 / (den * den)).sum(-1)
        b = torch.clamp(b - h / torch.where(dh < 0.0, dh, -1.0), 1e-12, 1.0 - 1e-12)
    return b


def _comps_of(z, lnk, beta):
    """``(beta, x, y)`` from ln K by Rachford-Rice, x and y normalised."""
    K = torch.exp(lnk)
    b = _rachford_rice(z, K, beta)
    x = z / (1.0 + b[:, None] * (K - 1.0))
    x = x / x.sum(-1, keepdim=True)
    y = K * x
    return b, x, y / y.sum(-1, keepdim=True)


@torch.no_grad()
def flash_tp(phi_q, phi_exact, z, p_red, md3, lnk0, beta0, active, stats=None):
    """The detached flash core on ``(B, ...)`` rows, all in f64.

    ``phi_q`` and ``phi_exact`` map ``(B, k, n)`` densities to ``(B, k)``:
    the Q-form phi gives the pressures and chemical potentials, the exact
    phi's Hessians the NPT slopes d p~/d ln rho and the mechanical-stability
    test (the Q form's second derivatives miss the dX/drho association
    term).  ``z (B, n)``, ``p_red (B,)``, ``md3 (B, n)`` = m d^3, ``lnk0 (B,
    n)`` and ``beta0 (B,)`` the initial estimates, ``active (B,)`` the rows
    to solve; the others freeze at iteration 0.  If ``stats`` is a dict, it
    receives the batch iterations of each loop.

    Returns ``(beta, x, y, lnr (B, 2) = ln [rho_L, rho_V], ok)``; ``ok`` is
    False on inactive rows.
    """
    dev = z.device
    tracing.count("sync.flash_tp")  # the signs' copy from host memory to the card
    branch_sign = torch.tensor([1.0, -1.0], dtype=F64, device=dev)
    counts = {"npt": 0, "ss": 0, "npt_warm": 0, "polish": 0}

    def pt_and_slope(comps, lr):
        """(p~, d p~/d ln rho_t) of the two stacked phases at fixed
        compositions; along the ray rho = c rho_t the slope is sum(rho) +
        rho^T H rho."""
        R = comps * torch.exp(lr)[..., None]
        pt, _ = _states_eos(phi_q, R)
        _, _, H = _states_hess(phi_exact, R)
        dpt = R.sum(-1) + (R[..., :, None] * H * R[..., None, :]).sum((-1, -2))
        return pt, dpt

    def npt_steps(lr, x, y, n_steps, rows, key):
        """Up to ``n_steps`` Newton steps on ln [rho_L, rho_V] at fixed (x,
        y); stops once every row of ``rows`` stepped below _STEP_TOL."""
        comps = torch.stack([x, y], 1)
        # packing-fraction cap per lane (the hard-sphere term diverges at 1)
        lr_cap = torch.log(0.74 / (PI / 6.0 * (comps * md3[:, None, :]).sum(-1)))
        for _ in range(n_steps):
            pt, dpt = pt_and_slope(comps, lr)
            pos = dpt > 0.0
            newton = (pt - p_red[:, None]) / torch.where(pos, dpt, 1.0)
            # dpt <= 0: the iterate is in the unstable region; walk the
            # liquid lane denser and the vapor lane thinner
            step = torch.where(pos, torch.clamp(newton, -0.5, 0.5), -branch_sign * 0.2)
            step = torch.where(torch.isfinite(step), step, 0.0)
            lr = torch.minimum(lr - step, lr_cap)
            counts[key] += 1
            tracing.count("sync.flash_npt")
            if not bool(((step.abs() >= _STEP_TOL) & rows[:, None]).any()):
                break
        return lr

    beta, x, y = _comps_of(z, lnk0, beta0)
    # self-initialisation: liquid at packing fraction 0.5, vapor at the
    # ideal-gas density rho = p~
    eta_liq = 0.5 / (PI / 6.0 * (x * md3).sum(-1))
    lnr = torch.log(torch.stack([eta_liq, torch.clamp(p_red, min=1e-30)], 1))
    lnr = npt_steps(lnr, x, y, _MAX_NPT_ITER, active, "npt")

    lnk = lnk0
    done = ~active
    d_prev = torch.zeros_like(lnk0)
    it = 0
    while it < _MAX_SS_ITER:
        tracing.count("sync.flash_ss")
        if not bool((~done).any()):
            break
        b, x, y = _comps_of(z, lnk, beta)
        lnr_new = npt_steps(lnr, x, y, _N_NPT_WARM, ~done, "npt_warm")
        R = torch.stack([x, y], 1) * torch.exp(lnr_new)[..., None]
        _, g = _states_eos(phi_q, R)
        lnk_ss = g[:, 0] - g[:, 1] + (lnr_new[:, 0] - lnr_new[:, 1])[:, None]
        d = lnk_ss - lnk
        # dominant-eigenvalue extrapolation (Michelsen's GDEM): successive
        # substitution contracts with rate lambda, so the remaining
        # correction is d / (1 - lambda); lambda from two consecutive plain
        # deltas, every third iteration, clipped to 0.95 (a step of at most
        # 20x, inside the NPT warm start's basin)
        den = (d_prev * d_prev).sum(-1)
        lam = torch.clamp((d * d_prev).sum(-1) / torch.where(den > 0.0, den, 1.0), -0.95, 0.95)
        accel = (it % 3 == 2) and it >= 5
        lnk_new = lnk_ss
        if accel:
            use = (den > 0.0) & torch.isfinite(lam)
            lnk_new = torch.where(use[:, None], lnk + d / (1.0 - lam)[:, None], lnk_ss)
        converged = d.abs().amax(-1) < _LNK_TOL
        bad = ~torch.isfinite(lnk_new).all(-1) | ~torch.isfinite(lnr_new).all(-1)
        # the converging update is applied, then the row freezes
        upd = ~(done | bad)
        lnk = torch.where(upd[:, None], lnk_new, lnk)
        lnr = torch.where(upd[:, None], lnr_new, lnr)
        beta = torch.where(upd, b, beta)
        d_prev = torch.where(upd[:, None], d, d_prev)
        done = done | converged | bad
        it += 1
    counts["ss"] = it

    # polish at the post-loop compositions, then the acceptance test at
    # the returned state, independent of the loop's own exit
    b, x, y = _comps_of(z, lnk, beta)
    lnr = npt_steps(lnr, x, y, _N_NPT_POLISH, active, "polish")
    comps = torch.stack([x, y], 1)
    pt, g = _states_eos(phi_q, comps * torch.exp(lnr)[..., None])
    _, dpt = pt_and_slope(comps, lnr)
    res_k = (lnk - (g[:, 0] - g[:, 1] + (lnr[:, 0] - lnr[:, 1])[:, None])).abs().amax(-1)
    # the liquid p~ is a cancellation of O(phi) terms: its f64 noise floor
    # is about an ulp of the pressure-row stiffness rho dp~/drho
    p_noise = 6e-12 * dpt
    ok = (
        active
        & done
        & (res_k < 1e-7)
        & ((pt - p_red[:, None]).abs() < 1e-6 * p_red[:, None] + p_noise).all(-1)
        & (dpt > 0.0).all(-1)                   # both phases mechanically stable
        & (lnr[:, 0] > lnr[:, 1])               # liquid denser than vapor
        & (lnk.abs().amax(-1) > 1e-6)           # a non-trivial split
        & (b > 1e-10) & (b < 1.0 - 1e-10)
        & torch.isfinite(x).all(-1) & torch.isfinite(y).all(-1)
    )
    if stats is not None or tracing.on():
        tracing.report(stats, "flash_tp", **counts)
    return b, x, y, lnr, ok


def flash_resid(phi_fn, z, p_red, v):
    """The flash residual F(v) ``(B, 2n+1)`` at ``v = [ln R_L (n), ln R_V
    (n), beta]`` (R the partial densities), differentiable in ``v`` and in
    whatever ``phi_fn``, ``z`` and ``p_red`` depend on:

    * mu_i(R_L) - mu_i(R_V), total chemical potentials (n);
    * p~(R_L) - p~, p~(R_V) - p~ (2);
    * beta y_i + (1 - beta) x_i - z_i for i < n-1 (the last balance is the
      sum of the others).

    ``phi_fn`` is the exact phi: the Jacobian takes its second derivatives.
    """
    n = z.shape[-1]
    R = torch.stack([torch.exp(v[:, :n]), torch.exp(v[:, n:2 * n])], 1)
    beta = v[:, 2 * n:]
    with torch.enable_grad():
        leaf = R if R.requires_grad else R.detach().requires_grad_()
        phi = phi_fn(leaf)
        (g,) = torch.autograd.grad(phi.sum(), leaf, create_graph=True)
    pt = R.sum(-1) + (R * g).sum(-1) - phi
    mu = v[:, :2 * n].reshape(-1, 2, n) + g
    x = R[:, 0] / R[:, 0].sum(-1, keepdim=True)
    y = R[:, 1] / R[:, 1].sum(-1, keepdim=True)
    return torch.cat([mu[:, 0] - mu[:, 1], pt - p_red[:, None],
                      (beta * y + (1.0 - beta) * x - z)[:, : n - 1]], 1)


def reattach_flash(resid_fn, beta, x, y, lnr, ok):
    """Implicit-function derivatives of the detached flash state.

    ``resid_fn(v) -> (B, 2n+1)`` is :func:`flash_resid` through the exact
    phi, differentiable in the inputs theta.  At the detached state v*
    (failed rows parked at beta 0.5, x = y = 1/n, rho = [1e-3, 1e-5]) one
    symbolic Newton step

        v = v* + (Delta - Delta.detach()),  Delta = -J^-1 F(v*, theta)

    with J = dF/dv taken at v* and detached, keeps every value and carries
    dv/dtheta = -J^-1 dF/dtheta.  On failed rows J is the identity and F
    is 0, so their gradients are exactly zero.  Returns ``(beta, x, y,
    lnr)`` with the solver's values and these derivatives.
    """
    n = x.shape[1]
    okc = ok[:, None]
    beta = torch.where(ok, beta, 0.5)
    x = torch.where(okc, x, 1.0 / n)
    y = torch.where(okc, y, 1.0 / n)
    tracing.count("sync.reattach_flash")  # the parking state's copy from host memory
    lnr = torch.where(okc, lnr, torch.tensor(_PARK_LNR, dtype=F64, device=x.device))
    v = torch.cat([torch.log(x) + lnr[:, :1], torch.log(y) + lnr[:, 1:], beta[:, None]], 1)

    _, J = _val_and_jac(resid_fn, v)
    eye = torch.eye(2 * n + 1, dtype=F64, device=v.device)
    J = torch.where(ok[:, None, None], J, eye)
    F = torch.where(okc, resid_fn(v), 0.0)
    delta = -torch.linalg.solve(J, F[..., None])[..., 0]
    v_t = v + (delta - delta.detach())

    def attach(value, expr):
        return value + (expr - expr.detach())

    r_l, r_v = torch.exp(v_t[:, :n]), torch.exp(v_t[:, n:2 * n])
    rho_l, rho_v = r_l.sum(-1, keepdim=True), r_v.sum(-1, keepdim=True)
    return (attach(beta, v_t[:, 2 * n]), attach(x, r_l / rho_l), attach(y, r_v / rho_v),
            attach(lnr, torch.log(torch.cat([rho_l, rho_v], 1))))


def flash_model(phi_pre, pre, pre_grad, z, p_red, pressure, edges, stats=None):
    """The flash of one model on its detached and differentiable inputs.

    ``phi_pre(pre, rho, assoc_q_form=False)`` is the model's phi; ``pre``
    its detached precompute and ``pre_grad`` the differentiable one (None:
    no gradient is re-attached).  ``z (B, n)`` and ``p_red (B,)`` carry
    whatever gradients the caller wants; ``pressure (B,)`` [Pa] places the
    rows in the window of ``edges`` = ``(p_bub, nan_b, y_bub, p_dew, nan_d,
    x_dew)``, the detached edge solves.  Returns :func:`flash_window`'s
    outputs.
    """
    z_s, p_red_s = z.detach(), p_red.detach()

    def phi_q(rho):
        return phi_pre(pre, rho, assoc_q_form=True)

    def phi_exact(rho):
        return phi_pre(pre, rho)

    def run_flash(lnk0, beta0, active):
        out = flash_tp(phi_q, phi_exact, z_s, p_red_s, pre.md3, lnk0, beta0, active, stats)
        if pre_grad is None:
            return out
        beta, x, y, lnr, ok = out

        def resid(v):
            return flash_resid(lambda rho: phi_pre(pre_grad, rho), z, p_red, v)

        return (*reattach_flash(resid, beta, x, y, lnr, ok), ok)

    return flash_window(z, pressure.detach(), *edges, run_flash)
