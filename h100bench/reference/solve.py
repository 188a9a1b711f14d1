"""The yardstick's phase equilibria: textbook solvers over ``pcsaft.phi``.

* :func:`pure_vle`: the saturated densities of a pure component, by Newton
  on ln p~ (the Gibbs-Duhem slope 1/rho_L - 1/rho_V) around a liquid and a
  vapour root at each trial pressure;
* :func:`liquid_density`: the liquid density at a given pressure;
* :func:`bubble_point`: the bubble pressure of a mixture, from Raoult's law
  over the pure vapour pressures, successive substitution on the K-values,
  then Newton on (ln rho_L, ln rho_V,i);
* the gradients by the implicit-function theorem: the saturation pressure's
  from the equal-Gibbs-energy condition at fixed densities, the liquid
  density's from dp~/dtheta over dp~/drho, the bubble pressure's from one
  Newton step on the converged state with the graph on.

Everything is batched over rows, in the dtype of the inputs, and runs on
whatever device they are on.  Imports only torch and ``pcsaft``.
"""

from __future__ import annotations

import torch

from .pcsaft import KMOL_M3_TO_REDUCED, PA_PER_K_TO_REDUCED, PI, Params, grad_rho, phi


def _tol(dtype):
    """A Newton step below this (relative, or in logarithms) has converged:
    2^10 ulps, above the rounding noise of p~ and mu~ in the liquid."""
    return 1024.0 * torch.finfo(dtype).eps


def _accept(dtype):
    """The largest residual (in mu~ or relative p~) a converged state may
    keep: 2^16 ulps, 1.5e-11 in float64."""
    return 65536.0 * torch.finfo(dtype).eps


def pure_derivs(par: Params, temperature, rho):
    """``(phi, phi', phi'')`` at ``rho (B,)``, detached."""
    with torch.enable_grad():
        r = rho.detach().requires_grad_()
        val = phi(par, temperature, r[:, None])
        (d1,) = torch.autograd.grad(val.sum(), r, create_graph=True)
        (d2,) = torch.autograd.grad(d1.sum(), r)
    return val.detach(), d1.detach(), d2


def _state(par, temperature, rho):
    """``(p~, mu~, dp~/drho)`` of the pure fluid at ``rho``."""
    f, f1, f2 = pure_derivs(par, temperature, rho)
    return rho + rho * f1 - f, torch.log(rho) + f1, 1.0 + rho * f2


def _eta_m(par, temperature):
    d = par.sigma[:, 0] * (1.0 - 0.12 * torch.exp(-3.0 * par.epsilon_k[:, 0] / temperature))
    return PI / 6.0 * par.m[:, 0] * d**3


def _root(par, temperature, target, rho, liquid, eta_m, active=None, evals=None, iters=60):
    """Newton for p~(rho) = target on one branch, from ``rho``: a liquid
    start lies above the root (eta 0.5), a vapour start below it (the ideal
    gas); a step that leaves the branch (dp~/drho <= 0 or a density out of
    range) moves toward the start's side instead.  Rows outside ``active``
    keep ``rho``; ``evals (B,)`` counts each row's evaluations while it
    iterates.  Returns ``(rho, ok, mu~)``, mu~ at the returned rho."""
    tol = _tol(rho.dtype)
    rho_max = 0.74 / eta_m
    done = torch.zeros_like(rho, dtype=torch.bool) if active is None else ~active
    for _ in range(iters):
        if evals is not None:
            evals += (~done).long()
        p, _, dp = _state(par, temperature, rho)
        new = rho - (p - target) / dp
        bad = ~(dp > 0) | ~(new > 0) | ~(new < rho_max) | ~torch.isfinite(new)
        new = torch.where(bad, rho * (1.05 if liquid else 0.5), new)
        if liquid:
            new = torch.where(bad, torch.minimum(new, 0.9 * rho_max), new)
        step = (new - rho).abs() / rho
        rho = torch.where(done, rho, new)
        done = done | ((step < tol) & ~bad)
        if bool(done.all()):
            break
    p, mu, dp = _state(par, temperature, rho)
    ok = done & (dp > 0) & torch.isfinite(rho)
    return rho, ok, mu


def pure_vle(parameters, temperature, iters=40, evals=None):
    """Saturated ``(rho_V, rho_L, ok)`` in A^-3 of ``parameters (B, 8)`` at
    ``temperature (B,)``.  ``evals (B,)``, if given, receives the phi
    evaluations each row took: the yardstick's count of the work a row
    needs, which the kernels' rooflines take."""
    par = Params.of(parameters)
    tol, accept = 4.0 * _tol(parameters.dtype), _accept(parameters.dtype)
    eta_m = _eta_m(par, temperature)
    zero = torch.zeros_like(temperature)
    rho_l, ok, mu_l = _root(par, temperature, zero, 0.5 / eta_m, True, eta_m, evals=evals)
    # the ideal vapour in equilibrium with that liquid
    ln_p = mu_l
    rho_v = torch.exp(ln_p)
    done = torch.zeros_like(ok)
    g = torch.full_like(ln_p, torch.inf)
    for _ in range(iters):
        active = ok & ~done
        pt = torch.exp(ln_p)
        rho_l, okl, mul = _root(par, temperature, pt, rho_l, True, eta_m, active, evals)
        rho_v, okv, muv = _root(par, temperature, pt, torch.where(active, torch.minimum(rho_v, pt),
                                                                  rho_v), False, eta_m, active, evals)
        g = torch.where(active, mul - muv, g)
        step = torch.clamp(g / (pt * (1.0 / rho_l - 1.0 / rho_v)), -1.0, 1.0)
        ok = ok & (done | (okl & okv & (rho_l > rho_v)))
        ln_p = torch.where(active & ok, ln_p - step, ln_p)
        done = done | ((g.abs() < tol) & ok)
        if bool((done | ~ok).all()):
            break
    # the state at the last pressure each row took (done rows kept theirs)
    pt = torch.exp(ln_p)
    rho_l, okl, mul = _root(par, temperature, pt, rho_l, True, eta_m)
    rho_v, okv, muv = _root(par, temperature, pt, rho_v, False, eta_m)
    ok = okl & okv & (rho_l > rho_v * (1.0 + 1e-6)) & ((mul - muv).abs() < accept)
    return rho_v, rho_l, ok


def saturation_identity(parameters, temperature, rho_v, rho_l):
    """p~ = -(a_V - a_L + ln(rho_V/rho_L)) / (1/rho_V - 1/rho_L), a = phi/rho:
    equal Gibbs energies at the saturation pressure, at fixed densities;
    differentiable in the parameters."""
    par = Params.of(parameters)
    a_v = phi(par, temperature, rho_v[:, None]) / rho_v
    a_l = phi(par, temperature, rho_l[:, None]) / rho_l
    return -(a_v - a_l + torch.log(rho_v / rho_l)) / (1.0 / rho_v - 1.0 / rho_l)


def vapor_pressure(parameters, temperature, evals=None):
    """``(p [Pa], ok, d ln p / d parameters (B, 8))``; p NaN and the
    gradient 0 where ``ok`` is False.  ``evals``: see :func:`pure_vle`."""
    with torch.no_grad():
        rho_v, rho_l, ok = pure_vle(parameters, temperature, evals=evals)
    rho_v = torch.where(ok, rho_v, 1e-5)
    rho_l = torch.where(ok, rho_l, 1e-3)
    with torch.enable_grad():
        q = parameters.detach().requires_grad_()
        pt = saturation_identity(q, temperature, rho_v, rho_l)
        (g,) = torch.autograd.grad(torch.log(pt).sum(), q)
    p = pt.detach() * temperature / PA_PER_K_TO_REDUCED
    return torch.where(ok, p, torch.nan), ok, torch.where(ok[:, None], g, 0.0)


def liquid_density(parameters, temperature, pressure, evals=None):
    """``(rho_L [kmol/m^3], ok, d rho_L / d parameters (B, 8))`` at
    ``pressure [Pa]``: the liquid root, and the implicit derivative
    -(dp~/dtheta) / (dp~/drho) at it.  ``evals (B,)``, if given, receives
    each row's phi evaluations."""
    par = Params.of(parameters)
    target = pressure / temperature * PA_PER_K_TO_REDUCED
    eta_m = _eta_m(par, temperature)
    with torch.no_grad():
        rho, ok, _ = _root(par, temperature, target, 0.5 / eta_m, True, eta_m, evals=evals)
    ok = ok & (rho * eta_m < 0.7) & (rho * eta_m > 0.1)
    rho = torch.where(ok, rho, 1e-3)
    with torch.enable_grad():
        q = parameters.detach().requires_grad_()
        r = rho.detach().requires_grad_()
        val = phi(Params.of(q), temperature, r[:, None])
        (d1,) = torch.autograd.grad(val.sum(), r, create_graph=True)
        pt = r + r * d1 - val
        dpt_dq, dpt_dr = torch.autograd.grad(pt.sum(), (q, r))
    g = -dpt_dq / dpt_dr[:, None]
    out = rho / KMOL_M3_TO_REDUCED
    return (torch.where(ok, out, torch.nan), ok,
            torch.where(ok[:, None], g / KMOL_M3_TO_REDUCED, 0.0))


def _mix_state(par, temperature, rho, create_graph=False):
    """``(p~, mu~_i)`` of a mixture at partial densities ``rho (B, n)``."""
    f, g = grad_rho(par, temperature, rho, create_graph=create_graph)
    return rho.sum(-1) + (rho * g).sum(-1) - f, torch.log(rho) + g


def _ln_fugacity_coeff(par, temperature, rho):
    pt, mu = _mix_state(par, temperature, rho)
    return mu - torch.log(pt[:, None]), pt


def _mix_root(par, temperature, z, target, rho, liquid, iters=60):
    """Total density on one branch at composition ``z (B, n)`` where
    p~ = target, by Newton on the total density (dp~/drho by autograd)."""
    tol = _tol(rho.dtype)
    zm = (par.m * _diam(par, temperature) ** 3 * z).sum(-1) * PI / 6.0
    rho_max = 0.74 / zm
    done = torch.zeros_like(rho, dtype=torch.bool)
    for _ in range(iters):
        with torch.enable_grad():
            r = rho.detach().requires_grad_()
            pt, _ = _mix_state(par, temperature, r[:, None] * z, create_graph=True)
            (dp,) = torch.autograd.grad(pt.sum(), r)
        pt = pt.detach()
        new = rho - (pt - target) / dp
        bad = ~(dp > 0) | ~(new > 0) | ~(new < rho_max) | ~torch.isfinite(new)
        new = torch.where(bad, rho * (1.05 if liquid else 0.5), new)
        if liquid:
            new = torch.where(bad, torch.minimum(new, 0.9 * rho_max), new)
        step = (new - rho).abs() / rho
        rho = torch.where(done, rho, new)
        done = done | ((step < tol) & ~bad)
        if bool(done.all()):
            break
    return rho, done


def _diam(par, temperature):
    return par.sigma * (1.0 - 0.12 * torch.exp(-3.0 * par.epsilon_k / temperature[:, None]))


def _bubble_residual(par, temperature, x, u, create_graph=False):
    """Residuals of a bubble point in u = (ln rho_L, ln rho_V,i): the
    pressures' difference (relative to the liquid's total density) and the
    chemical potentials' differences."""
    rho_l = torch.exp(u[:, :1]) * x
    rho_v = torch.exp(u[:, 1:])
    p_l, mu_l = _mix_state(par, temperature, rho_l, create_graph=create_graph)
    p_v, mu_v = _mix_state(par, temperature, rho_v, create_graph=create_graph)
    return torch.cat([((p_l - p_v) / rho_l.sum(-1))[:, None], mu_l - mu_v], -1), p_v


def _jacobian(f, u):
    """``(f(u), df/du)`` for a row-wise ``f: (B, k) -> (B, k)``."""
    with torch.enable_grad():
        v = u.detach().requires_grad_()
        out = f(v)
        res = out[0] if isinstance(out, tuple) else out
        rows = [torch.autograd.grad(res[:, i].sum(), v, retain_graph=True)[0]
                for i in range(res.shape[1])]
    return out, torch.stack(rows, 1)


def bubble_point(parameters, kij, eps_aibj, temperature, x, iters=60, ss_iters=12):
    """Bubble pressures of ``parameters (B, n, 8)`` with ``kij``,
    ``eps_aibj`` ``(B,)`` at ``temperature (B,)`` and liquid composition
    ``x (B, n)``: ``(p [Pa], ok, u)``, u = (ln rho_L, ln rho_V,i) converged.
    Cold: every start is the yardstick's own."""
    dt = parameters.dtype
    tol = _tol(dt)
    B, n, _ = parameters.shape
    par = Params.of(parameters, kij, eps_aibj)
    with torch.no_grad():
        # Raoult's law over the pure components' saturation pressures
        psat = []
        for i in range(n):
            rv, rl, ok_i = pure_vle(parameters[:, i, :].contiguous(), temperature)
            psat.append(saturation_identity(parameters[:, i, :], temperature, rv, rl))
        psat = torch.stack(psat, -1)
        pt = (x * psat).sum(-1)
        y = x * psat / pt[:, None]
        zm_l = (par.m * _diam(par, temperature) ** 3 * x).sum(-1) * PI / 6.0
        rl = 0.5 / zm_l
        rv = pt.clone()
        for _ in range(ss_iters):
            rl, _ = _mix_root(par, temperature, x, pt, rl, True)
            rv, _ = _mix_root(par, temperature, y, pt, torch.minimum(rv, pt), False)
            lnf_l, _ = _ln_fugacity_coeff(par, temperature, rl[:, None] * x)
            lnf_v, _ = _ln_fugacity_coeff(par, temperature, rv[:, None] * y)
            k = torch.exp(lnf_l - lnf_v)
            s = (x * k).sum(-1)
            pt = pt * s
            y_new = x * k / s[:, None]
            settled = bool(((y_new - y).abs().amax(-1) < 1e-4).all()
                           & ((s - 1.0).abs() < 1e-4).all())
            y = y_new
            if settled:
                break
        u = torch.cat([torch.log(rl)[:, None], torch.log(rv[:, None] * y)], -1)
        done = torch.zeros(B, dtype=torch.bool, device=parameters.device)
        for _ in range(iters):
            (res, _), jac = _jacobian(
                lambda v: _bubble_residual(par, temperature, x, v, create_graph=True), u)
            step = torch.linalg.solve(jac, res[:, :, None])[..., 0]
            step = torch.clamp(step, -0.5, 0.5)
            new = u - step
            fine = torch.isfinite(new).all(-1)
            u = torch.where((done | ~fine)[:, None], u, new)
            done = done | (fine & (step.abs().amax(-1) < tol))
            if bool(done.all()):
                break
        res, p_v = _bubble_residual(par, temperature, x, u)
        rho_l = torch.exp(u[:, 0])
        rho_vt = torch.exp(u[:, 1:]).sum(-1)
        ok = (done & (res.abs().amax(-1) < _accept(dt)) & (rho_l > rho_vt * (1.0 + 1e-6))
              & torch.isfinite(p_v))
    p = torch.where(ok, p_v * temperature / PA_PER_K_TO_REDUCED, torch.nan)
    return p, ok, u


def bubble_pressure_attached(parameters, kij, eps_aibj, temperature, x, u):
    """The bubble pressure [Pa] at the converged state ``u``, with the
    implicit-function gradient in whatever ``parameters``, ``kij`` and
    ``eps_aibj`` require: one Newton step on u with a detached Jacobian
    (the residual is 0 at u, so the step's first derivatives are
    -J^-1 dR/dtheta), then the vapour's pressure."""
    par0 = Params.of(parameters.detach(), kij.detach(), eps_aibj.detach())
    _, jac = _jacobian(
        lambda v: _bubble_residual(par0, temperature, x, v, create_graph=True)[0], u)
    par = Params.of(parameters, kij, eps_aibj)
    res, _ = _bubble_residual(par, temperature, x, u.detach(), create_graph=True)
    u1 = u.detach() - torch.linalg.solve(jac.detach(), res[:, :, None])[..., 0]
    rho_v = torch.exp(u1[:, 1:])
    p_v, _ = _mix_state(par, temperature, rho_v, create_graph=True)
    return p_v * temperature / PA_PER_K_TO_REDUCED
