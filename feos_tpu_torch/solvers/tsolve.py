"""Saturation-temperature solves by outer iteration over a pressure solver.

Counterpart of ``feos_tpu/solvers/tsolve.py``.  A secant iteration in
(1/T, ln p), where saturation lines are nearly straight (Clausius-Clapeyron),
runs on detached inputs; afterwards one differentiable pressure solve at the
converged temperature and one symbolic Newton step

    T_out = T* - (p(theta, T*) - p_target) / (dp/dT)|*

re-attach the first-order gradients with respect to the EOS parameters and
``p_target`` by the implicit function theorem.  The pure boiling point
re-enters its pressure solver cold at every outer step, as in the JAX
package; the bubble and dew temperatures (:func:`incipient_temperature`)
carry the mixture solver's converged state from step to step, so each
outer step is a warm solve.
"""

from __future__ import annotations

import torch

from .. import tracing

# Secant slope prior: d ln p / d(1/T) ~ -(d ln p/d ln T) * T with
# d ln p/d ln T ~ 10 near the normal boiling point (Trouton's rule); only
# the first step uses it, after which measured slopes take over.
_TROUTON_DLNP_DLNT = 10.0
# per-step limit on the 1/T move (relative)
_MAX_REL_STEP = 0.2
_LNP_TOL = 3e-9  # on |ln p - ln p_target|; the inner solve is ~1e-9 rel
_MAX_OUTER = 24


@torch.no_grad()
def saturation_temperature_loop(solve, t0, lnp_target, u0=None, stats=None):
    """Batched secant iteration for T with ln p(T) = lnp_target.

    Without a solver state (``u0`` None, the pure boiling point),
    ``solve(T (B,)) -> (lnp (B,), ok (B,))`` is a detached pressure solve,
    ``lnp`` NaN where it failed, and the loop returns ``(T*, done)``.  With
    ``u0 (B, k)``, the starting state of a warm-started solver (the bubble
    and dew temperatures pass the state of a cold solve at ``t0``),
    ``solve(T, u) -> (lnp, ok, u')`` and the loop returns ``(T*, u*,
    done)``: rows whose solve succeeded and which were not yet done take
    ``u'``, so ``u*`` is each row's state at its ``T*``, and a failed row
    keeps its last good state.

    Every outer step evaluates the whole batch; converged rows hold their
    temperature.  Rows whose target is unreachable (above the critical
    pressure) exhaust ``_MAX_OUTER`` with ``done`` False; failed
    evaluations bisect back toward the last good iterate.  If ``stats`` is
    a dict, it receives the outer iterations as ``outer``.
    """
    i_t0 = 1.0 / t0
    i_t, i_t_prev = i_t0, i_t0
    lnp_prev = torch.full_like(i_t0, torch.nan)
    done = torch.zeros(i_t0.shape, dtype=torch.bool, device=i_t0.device)
    u = u0
    n_outer = 0
    while n_outer < _MAX_OUTER:
        tracing.count("sync.saturation_temperature_loop")
        if bool(done.all()):
            break
        if u is None:
            lnp, ok = solve(1.0 / i_t)
        else:
            lnp, ok, u_new = solve(1.0 / i_t, u)
            u = torch.where((ok & ~done)[:, None], u_new, u)
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
    if stats is not None or tracing.on():
        tracing.report(stats, "saturation_temperature_loop", outer=n_outer)
    if u0 is None:
        return 1.0 / i_t, done
    return 1.0 / i_t, u, done


def reattach_temperature(solve_diff, t_star, p_target, done):
    """Exact first-order gradients for converged saturation temperatures.

    ``solve_diff(T) -> p (B,)`` is the differentiable pressure solve (the
    parameters, and for a warm-started solver the state ``u*`` at ``T*``,
    live in its closure).  ``dp/dT`` is the gradient of the same call along
    a detached ``T*`` leaf, itself detached: it holds the explicit T of the
    pressure as well as the T dependence of the stationary identity behind
    it.  The symbolic Newton step then carries the implicit-function
    gradients while moving the value only by the solver's residual.

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


def incipient_temperature(prop, prop_s, pressure, molefracs, t0, rows, device,
                          full_output=False, stats=None):
    """Bubble or dew temperature at given pressure and bulk composition
    (the JAX package's ``_incipient_temperature`` and
    ``gc_incipient_temperature``), shared by the mixture and gc models.

    ``prop(T, z, p0, full_output=, state0=, state_output=)`` is the
    model's bubble or dew pressure with its live parameters, ``prop_s`` the
    same with detached ones; ``pressure`` (Pa) and ``t0`` (K) are scalars or
    ``(rows,)``.  A cold solve at ``t0`` with the target isobar as the
    pressure estimate seeds the state; the secant loop runs warm solves
    from it; one differentiable warm solve at ``(T*, u*)`` re-attaches the
    gradients (:func:`reattach_temperature`) and gives the incipient
    composition at ``T*``, detached and NaN on failed rows.  A row whose
    cold solve fails stays masked: the loop cannot take up a row that never
    produced a state.

    Returns ``(T, nans)`` and with ``full_output`` the incipient
    composition ``(rows, n)``; ``stats`` receives the outer iterations.
    """
    p_target = torch.as_tensor(pressure, dtype=torch.float64, device=device).expand(rows)
    t0 = torch.as_tensor(t0, dtype=torch.float64, device=device).detach().expand(rows)
    x_s = torch.as_tensor(molefracs, dtype=torch.float64, device=device).detach()
    p_s = p_target.detach()

    def solve(temperature, u):
        pw, nans, u_new = prop_s(temperature, x_s, p_s, state0=u, state_output=True)
        return torch.log(pw), ~nans, u_new  # pw is NaN on failed rows

    with torch.no_grad():
        _, _, u0 = prop_s(t0, x_s, p_s, state_output=True)
    t_star, u_star, done = saturation_temperature_loop(solve, t0, torch.log(p_s), u0, stats)

    composition = []

    def solve_diff(temperature):
        pw, _, y = prop(temperature, molefracs, p_s, full_output=True, state0=u_star)
        composition.append(y)
        return pw

    t_out = reattach_temperature(solve_diff, t_star, p_target, done)
    if not full_output:
        return t_out, ~done
    return t_out, ~done, torch.where(done[:, None], composition[0].detach(), torch.nan)
