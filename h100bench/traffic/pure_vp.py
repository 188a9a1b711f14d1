"""Vapor pressures with the gradient of sum ln p in every row's 8 parameters.

One step is ``feos_tpu_torch.vapor_pressure`` on the cell's rows, then the
backward of sum ln p over the converged rows (``bench.py``'s loss), at
fixed inputs: the pure-component regression's inner step.  A row counts as
done when its solve converged.

Parameters (the workload file's ``params``): ``rows``, ``warmup_steps``,
``reference_block`` (rows the reference solves at once), ``check_rows``
(the rows, drawn from the seed, whose answers the reference judges: all of
them, or a sample where solving all would outlast the window).
"""

from __future__ import annotations

import torch

import feos_tpu_torch as ftt

from h100bench import roofline
from h100bench.common import (
    CheckedSteps, generator, mask_mismatches, max_rel, max_row_scaled, pure_rows, worst,
)
from h100bench.reference import solve as ref


def log_sum(nans, p):
    return torch.where(nans, 0.0, torch.log(torch.where(nans, 1.0, p))).sum()


def reference(params, temperature, block, dtype=torch.float64, evals=None):
    """The reference's ``(p, ok, d ln p / d params)`` in ``dtype``, in
    blocks of rows; ``evals (B,)`` receives each row's phi evaluations."""
    outs = []
    for lo in range(0, params.shape[0], block):
        sl = slice(lo, lo + block)
        e = None if evals is None else evals[sl]
        p, ok, g = ref.vapor_pressure(params[sl].to(dtype), temperature[sl].to(dtype), evals=e)
        if e is not None:
            evals[sl] = e
        outs.append((p.double(), ok, g.double()))
    return tuple(torch.cat(c) for c in zip(*outs))


def compare(out, want):
    """The compared numbers of one step's ``(ok, p, grad)`` against the
    reference's ``(p, ok, grad)``."""
    ok, p, grad = out
    p_ref, ok_ref, g_ref = want
    both = ok & ok_ref
    return {"mask_mismatches": mask_mismatches(ok, ok_ref),
            "p_rel": max_rel(p, p_ref, both),
            "grad_rel": max_row_scaled(grad, g_ref, both)}


class Cell:
    def __init__(self, spec, config, seed, device):
        self.spec, self.config, self.seed, self.device = spec, config, seed, device
        self.rows = spec["params"]["rows"]

    def setup(self):
        self.params, self.temperature = pure_rows(self.rows, self.seed, self.device,
                                                  self.config["distribution"])
        self.q = self.params.clone().requires_grad_()
        self.kept = None

    def warm_up(self):
        for _ in range(self.spec["params"]["warmup_steps"]):
            self.step()

    def begin_window(self):
        self.kept = CheckedSteps(self.seed)

    def step(self):
        self.q.grad = None
        nans, vp = ftt.vapor_pressure(self.q, self.temperature)
        log_sum(nans, vp).backward()
        if self.kept is not None:
            self.kept.add((~nans, vp.detach(), self.q.grad))
        return (~nans).sum()

    def release(self):
        self.q = None

    def _sample(self):
        n = self.spec["params"].get("check_rows", self.rows)
        if n >= self.rows:
            return torch.arange(self.rows, device=self.device)
        g = generator(self.seed + 1, self.device)
        return torch.randperm(self.rows, generator=g, device=self.device)[:n].sort().values

    def check(self):
        self.rows_checked = idx = self._sample()
        self.evals = torch.zeros(len(idx), dtype=torch.long, device=self.device)
        want = reference(self.params[idx], self.temperature[idx],
                         self.spec["params"]["reference_block"], evals=self.evals)
        return worst(compare(tuple(x[idx] for x in out), want) for out in self.kept.steps())

    def control(self, dtype):
        """The compared numbers of the reference in ``dtype`` put in the
        program's place, on the rows a check judges."""
        block = self.spec["params"]["reference_block"]
        idx = self._sample()
        par, t = self.params[idx], self.temperature[idx]
        p, ok, g = reference(par, t, block, dtype=dtype)
        return compare((ok, p, g), reference(par, t, block))

    def work(self):
        """Work a step of each kernel family: one solve and one identity.
        The solve's evaluations are the reference's on the checked rows,
        scaled to the batch where those are a sample."""
        idx = self.rows_checked
        ops, _ = roofline.pure_vle_work(self.params[idx], self.temperature[idx], self.evals)
        n = len(idx)
        ops = roofline.OPS_ROW * self.rows + (ops - roofline.OPS_ROW * n) * self.rows / n
        nbytes = self.rows * roofline.BYTES_VLE_ROW + roofline.ETA_GRID_BYTES
        return {"pure_vle": (ops, nbytes), "vp_identity": roofline.vp_identity_work(self.params)}
