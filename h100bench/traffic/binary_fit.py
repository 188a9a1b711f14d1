"""``fit_binary``'s warm step: bubble pressures of a binary with the
gradient of their relative SSE in theta = (k_ij, epsilon_k_AiBj / scale).

One step is ``bubble_point`` of the pair at theta, warm-started from the
previous step's converged state, and ``regression.bubble_loss`` against the
data, as ``regression.binary_loss`` composes them, then the backward.
Between steps theta moves by a seeded step of Adam's size (the learning
rate, in each coordinate), as a fit's steps move it.  The data are the
reference's bubble pressures at the configuration's k_ij and
epsilon_k_AiBj.  Set-up seeds the state with one cold solve, as
``fit_binary`` does.  A row counts as done when its solve converged.

Parameters: ``rows``, ``warmup_steps``, ``theta0``, ``lr``.
"""

from __future__ import annotations

import numpy as np
import torch

import feos_tpu_torch as ftt
from feos_tpu_torch import regression

from h100bench.common import CheckedSteps, mask_mismatches, max_rel, worst
from h100bench.reference import solve as ref

F64 = torch.float64


def compare(out, want):
    ok, p, loss, grad = out
    ok_r, p_r, loss_r, grad_r = want
    scale = float(grad_r.abs().max())
    return {"mask_mismatches": mask_mismatches(ok, ok_r),
            "p_rel": max_rel(p, p_r, ok & ok_r),
            "loss_rel": abs(float(loss) - float(loss_r)) / abs(float(loss_r)),
            "grad_rel": float((grad - grad_r).abs().max()) / scale}


class Cell:
    def __init__(self, spec, config, seed, device):
        self.spec, self.config, self.seed, self.device = spec, config, seed, device
        self.rows = spec["params"]["rows"]

    def _f64(self, x):
        return torch.as_tensor(x, dtype=F64, device=self.device)

    def setup(self):
        c, B = self.config, self.rows
        self.components = self._f64(c["components"]).expand(B, 2, 8)
        self.temperature = torch.linspace(*c["temperature_k"], B, dtype=F64, device=self.device)
        self.x1 = torch.full((B,), c["x1"], dtype=F64, device=self.device)
        self.scale = self._f64([1.0, c["epsilon_k_aibj_scale"]])
        p, ok, _ = self._reference_bubble(c["kij"], c["epsilon_k_aibj"])
        self.p_data = torch.where(ok, p, torch.nan)
        self.rng = np.random.default_rng([int(self.seed) % (2**63), 29])
        self.theta = self._f64(self.spec["params"]["theta0"])
        self.kept = None
        with torch.no_grad():  # fit_binary's cold solve that seeds the warm state
            p, nans, state = ftt.bubble_point(
                self.components, (self.theta * self.scale).expand(B, 2), self.temperature,
                self.x1, self.p_data, state_output=True)
            _, self.state = regression.bubble_loss(p, nans, self.p_data, state)

    def _reference_bubble(self, kij, eps_aibj, dtype=F64):
        B = self.rows
        x = torch.stack([self.x1, 1.0 - self.x1], -1).to(dtype)
        return ref.bubble_point(self.components.to(dtype).contiguous(),
                                torch.full((B,), kij, dtype=dtype, device=self.device),
                                torch.full((B,), eps_aibj, dtype=dtype, device=self.device),
                                self.temperature.to(dtype), x)

    def warm_up(self):
        for _ in range(self.spec["params"]["warmup_steps"]):
            self.step()

    def begin_window(self):
        self.kept = CheckedSteps(self.seed)

    def step(self):
        B = self.rows
        theta = self.theta.clone().requires_grad_()
        p, nans, state = ftt.bubble_point(
            self.components, (theta * self.scale).expand(B, 2), self.temperature, self.x1,
            self.p_data, state0=self.state, state_output=True)
        loss, self.state = regression.bubble_loss(p, nans, self.p_data, state, self.state)
        loss.backward()
        if self.kept is not None:
            self.kept.add((self.theta, (~nans, p.detach(), loss.detach(), theta.grad)))
        move = self.rng.choice([-1.0, 1.0], size=2) * self.spec["params"]["lr"]
        self.theta = self.theta + self._f64(move)
        return (~nans).sum()

    def release(self):
        self.state = None

    def reference(self, theta, dtype=F64):
        """The reference's ``(ok, p, loss, d loss / d theta)`` at ``theta``,
        from a cold solve of its own."""
        th = theta.detach().to(dtype)
        kij, eps = float(th[0]), float(th[1] * self.scale[1])
        p, ok, u = self._reference_bubble(kij, eps, dtype)
        # rows the reference could not solve stay out of the loss; give them
        # a converged row's state so that their zero weight meets no NaN
        u = torch.where(ok[:, None], u, u[torch.argmax(ok.to(torch.uint8))])
        B = self.rows
        x = torch.stack([self.x1, 1.0 - self.x1], -1).to(dtype)
        t = th.clone().requires_grad_()
        with torch.enable_grad():
            pa = ref.bubble_pressure_attached(
                self.components.to(dtype).contiguous(), t[0].expand(B),
                (t[1] * self.scale[1].to(dtype)).expand(B), self.temperature.to(dtype), x, u)
            target = self.p_data.to(dtype)
            use = ok & torch.isfinite(target)
            target = torch.where(use, target, 1.0)
            rel = torch.where(use, (pa - target) / target, 0.0)
            loss = (rel * rel).sum() / use.sum().clamp(min=1)
            (g,) = torch.autograd.grad(loss, t)
        return ok, p.double(), loss.detach().double(), g.double()

    def check(self):
        return worst(compare(out, self.reference(theta)) for theta, out in self.kept.steps())

    def control(self, dtype):
        """The reference in ``dtype`` in the program's place, at theta after
        ten of the seed's moves."""
        moves = self.rng.choice([-1.0, 1.0], size=(10, 2)).sum(0) * self.spec["params"]["lr"]
        theta = self._f64(self.spec["params"]["theta0"]) + self._f64(moves)
        return compare(self.reference(theta, dtype), self.reference(theta))

    def work(self):
        return {}
