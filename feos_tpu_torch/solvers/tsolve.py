"""Saturation-temperature solves by outer iteration over a pressure solver.

Counterpart of ``feos_tpu/solvers/tsolve.py`` for the pure case.  A secant
iteration in (1/T, ln p), where saturation lines are nearly straight
(Clausius-Clapeyron), runs on detached inputs; afterwards one
differentiable pressure solve at the converged temperature and one symbolic
Newton step

    T_out = T* - (p(theta, T*) - p_target) / (dp/dT)|*

re-attach the first-order gradients with respect to the EOS parameters and
``p_target`` by the implicit function theorem.  The pure pressure solver
has no warm-start state, so each outer step re-enters it cold, as in the
JAX package.
"""

from __future__ import annotations

import torch

# Secant slope prior: d ln p / d(1/T) ~ -(d ln p/d ln T) * T with
# d ln p/d ln T ~ 10 near the normal boiling point (Trouton's rule); only
# the first step uses it, after which measured slopes take over.
_TROUTON_DLNP_DLNT = 10.0
# per-step limit on the 1/T move (relative)
_MAX_REL_STEP = 0.2
_LNP_TOL = 3e-9  # on |ln p - ln p_target|; the inner solve is ~1e-9 rel
_MAX_OUTER = 24


@torch.no_grad()
def saturation_temperature_loop(solve, t0, lnp_target, stats=None):
    """Batched secant iteration for T with ln p(T) = lnp_target.

    ``solve(T (B,)) -> (lnp (B,), ok (B,))`` is a detached pressure solve,
    ``lnp`` NaN where it failed.  Every outer step evaluates the whole
    batch; converged rows hold their temperature.  Rows whose target is
    unreachable (above the critical pressure) exhaust ``_MAX_OUTER`` with
    ``done`` False; failed evaluations bisect back toward the last good
    iterate.  If ``stats`` is a dict, it receives the outer iterations as
    ``outer``.

    Returns ``(T*, done)``.
    """
    i_t0 = 1.0 / t0
    i_t, i_t_prev = i_t0, i_t0
    lnp_prev = torch.full_like(i_t0, torch.nan)
    done = torch.zeros(i_t0.shape, dtype=torch.bool, device=i_t0.device)
    n_outer = 0
    while n_outer < _MAX_OUTER and not bool(done.all()):
        lnp, ok = solve(1.0 / i_t)
        fin = ok & torch.isfinite(lnp)
        err = lnp - lnp_target
        # measured secant slope where two finite points exist, the Trouton
        # prior otherwise; saturation slopes are negative in (1/T, ln p),
        # and the clamp keeps a noisy slope from reversing the march
        d_it = i_t - i_t_prev
        have_prev = torch.isfinite(lnp_prev) & (d_it.abs() > 1e-14 * i_t)
        b = torch.where(
            fin & have_prev,
            (lnp - lnp_prev) / torch.where(d_it.abs() > 0, d_it, 1.0),
            -_TROUTON_DLNP_DLNT / i_t0,
        )
        b = torch.minimum(b, -1e-2 / i_t0)
        lim = _MAX_REL_STEP * i_t
        step = torch.clamp((lnp_target - lnp) / b, -lim, lim)
        # failed evaluation (past the critical point, out of the solver's
        # reach): bisect back toward the last good iterate
        i_t_next = torch.where(fin, i_t + step, 0.5 * (i_t + i_t_prev))
        done_new = done | (fin & (err.abs() < _LNP_TOL))
        live = fin & ~done
        i_t_prev = torch.where(live, i_t, i_t_prev)
        lnp_prev = torch.where(live, lnp, lnp_prev)
        i_t = torch.where(done_new, i_t, i_t_next)
        done = done_new
        n_outer += 1
    if stats is not None:
        stats["outer"] = n_outer
    return 1.0 / i_t, done


def reattach_temperature(solve_diff, t_star, p_target, done):
    """Exact first-order gradients for converged saturation temperatures.

    ``solve_diff(T) -> p (B,)`` is the differentiable pressure solve (the
    parameters live in its closure).  ``dp/dT`` is the gradient of the same
    call along a detached ``T*`` leaf, itself detached; the symbolic Newton
    step then carries the implicit-function gradients while moving the
    value only by the solver's residual.

    Returns ``T`` (B,), NaN where ``done`` is False.
    """
    keep_graph = torch.is_grad_enabled()
    t_s = t_star.detach().requires_grad_()
    with torch.enable_grad():
        p_at = solve_diff(t_s)
        (dp_dt,) = torch.autograd.grad(p_at.sum(), t_s, retain_graph=keep_graph)
    if not keep_graph:
        p_at = p_at.detach()
    # failed rows carry NaN pressures; park their denominator so that a NaN
    # cannot poison the batch gradient (their output is masked anyway)
    dp_dt = torch.where(done & torch.isfinite(dp_dt) & (dp_dt.abs() > 0.0), dp_dt, 1.0)
    p_safe = torch.where(done & torch.isfinite(p_at), p_at, p_target)
    t_out = t_s.detach() - (p_safe - p_target) / dp_dt
    return torch.where(done, t_out, torch.nan)
