"""``fit_pure``'s step: the relative SSE of vapor pressures and of liquid
densities at those pressures, with its gradient in every row's parameters.

One step is ``vapor_pressure`` and ``liquid_density`` of theta (1.01 times
the rows' own parameters, as after a first fit step) on the cell's rows and
``masked_relative_sse`` of each against its data, as
``regression.pure_loss`` composes them, then the backward, at fixed inputs.
The data are the reference's saturation pressures and saturated liquid
densities at the rows' own parameters.  A row counts as done when both of
its solves converged.

Parameters: ``rows``, ``warmup_steps``, ``reference_block``, ``theta_factor``.
"""

from __future__ import annotations

import torch

import feos_tpu_torch as ftt
from feos_tpu_torch import regression

from h100bench import roofline
from h100bench.common import (
    CheckedSteps, mask_mismatches, max_rel, max_row_scaled, pure_rows, worst,
)
from h100bench.reference import solve as ref
from h100bench.reference.pcsaft import KMOL_M3_TO_REDUCED, PA_PER_K_TO_REDUCED


def data(params, temperature, block):
    """The fit's data from the reference: ``(p_sat [Pa], rho_L [kmol/m^3])``,
    NaN where it found no saturation state."""
    ps, rs = [], []
    for lo in range(0, params.shape[0], block):
        par, t = params[lo:lo + block], temperature[lo:lo + block]
        with torch.no_grad():
            rho_v, rho_l, ok = ref.pure_vle(par, t)
            pt = ref.saturation_identity(par, t, rho_v, rho_l)
        ps.append(torch.where(ok, pt * t / PA_PER_K_TO_REDUCED, torch.nan))
        rs.append(torch.where(ok, rho_l / KMOL_M3_TO_REDUCED, torch.nan))
    return torch.cat(ps), torch.cat(rs)


def reference(theta, temperature, pressure, p_data, rho_data, block, dtype=torch.float64,
              evals=None):
    """The reference's outputs of a step at ``theta``: ``(ok_p, p, ok_r,
    rho, loss, grad)``; ``evals`` receives each row's phi evaluations of
    the saturation and of the liquid density solves."""
    cols = []
    for lo in range(0, theta.shape[0], block):
        sl = slice(lo, lo + block)
        th, t, pr = (x[sl].to(dtype) for x in (theta, temperature, pressure))
        ev = (None, None) if evals is None else (evals[0][sl], evals[1][sl])
        p, okp, glnp = ref.vapor_pressure(th, t, evals=ev[0])
        rho, okr, grho = ref.liquid_density(th, t, pr, evals=ev[1])
        cols.append((okp, p.double(), glnp.double(), okr, rho.double(), grho.double()))
    okp, p, glnp, okr, rho, grho = (torch.cat(c) for c in zip(*cols))
    terms, grad = [], torch.zeros_like(glnp)
    for ok, x, dx, target in ((okp, p, glnp * p[:, None], p_data),
                              (okr, rho, grho, rho_data)):
        use = ok & torch.isfinite(target)
        n = use.sum().clamp(min=1)
        rel = torch.where(use, (x - target) / target, 0.0)
        terms.append((rel * rel).sum() / n)
        grad = grad + torch.where(use[:, None], 2.0 * rel[:, None] / target[:, None] * dx, 0.0) / n
    return okp, p, okr, rho, terms[0] + terms[1], grad


def compare(out, want):
    okp, p, okr, rho, loss, grad = out
    okp_r, p_r, okr_r, rho_r, loss_r, grad_r = want
    return {"mask_mismatches": mask_mismatches(okp, okp_r) + mask_mismatches(okr, okr_r),
            "p_rel": max_rel(p, p_r, okp & okp_r),
            "rho_rel": max_rel(rho, rho_r, okr & okr_r),
            "loss_rel": abs(float(loss) - float(loss_r)) / abs(float(loss_r)),
            "grad_rel": max_row_scaled(grad, grad_r, (okp & okp_r) | (okr & okr_r))}


class Cell:
    def __init__(self, spec, config, seed, device):
        self.spec, self.config, self.seed, self.device = spec, config, seed, device
        self.rows = spec["params"]["rows"]
        self.block = spec["params"]["reference_block"]

    def setup(self):
        self.params, self.temperature = pure_rows(self.rows, self.seed, self.device,
                                                  self.config["distribution"])
        self.p_data, self.rho_data = data(self.params, self.temperature, self.block)
        # rows without data keep a finite pressure; their NaN targets leave
        # them out of the loss, as fit_pure's padded rows
        self.pressure = torch.where(torch.isfinite(self.p_data), self.p_data, 1e5).contiguous()
        self.theta0 = (self.params * self.spec["params"]["theta_factor"]).contiguous()
        self.theta = self.theta0.clone().requires_grad_()
        self.kept = None

    def warm_up(self):
        for _ in range(self.spec["params"]["warmup_steps"]):
            self.step()

    def begin_window(self):
        self.kept = CheckedSteps(self.seed)

    def step(self):
        th = self.theta
        th.grad = None
        nans_p, vp = ftt.vapor_pressure(th, self.temperature)
        nans_r, rl = ftt.liquid_density(th, self.temperature, self.pressure)
        loss = (regression.masked_relative_sse(torch.where(nans_p, 1.0, vp), self.p_data, ~nans_p)
                + regression.masked_relative_sse(torch.where(nans_r, 1.0, rl), self.rho_data,
                                                 ~nans_r))
        loss.backward()
        if self.kept is not None:
            self.kept.add((~nans_p, vp.detach(), ~nans_r, rl.detach(), loss.detach(), th.grad))
        return (~nans_p & ~nans_r).sum()

    def release(self):
        self.theta = None

    def _reference(self, dtype=torch.float64, evals=None):
        return reference(self.theta0, self.temperature, self.pressure, self.p_data,
                         self.rho_data, self.block, dtype, evals)

    def check(self):
        self.evals = tuple(torch.zeros(self.rows, dtype=torch.long, device=self.device)
                           for _ in range(2))
        want = self._reference(evals=self.evals)
        return worst(compare(out, want) for out in self.kept.steps())

    def control(self, dtype):
        return compare(self._reference(dtype), self._reference())

    def work(self):
        th, t = self.theta0, self.temperature
        return {"pure_vle": roofline.pure_vle_work(th, t, self.evals[0]),
                "vp_identity": roofline.vp_identity_work(th),
                "phi_d2": roofline.density_solve_work(th, t, self.evals[1])}
