"""What the traffic kinds share: seeded inputs made on the device, the
numbers compared against the reference, and the choice of checked steps."""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``--seed`` (any whole number)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    return g


def pure_rows(rows: int, seed: int, device, dist: dict):
    """``(parameters (B, 8), temperature (B,))`` in float64 on ``device``,
    drawn in one call from the seed: ``bench.py::make_batch``'s distribution
    (BASELINE config 5), whose bounds ``dist`` holds."""
    u = torch.rand((rows, 7), generator=generator(seed, device), device=device, dtype=F64)

    def span(col, key):
        lo, hi = dist[key]
        return lo + (hi - lo) * u[:, col]

    m, sigma, eps = span(0, "m"), span(1, "sigma"), span(2, "epsilon_k")
    mu = torch.where(u[:, 3] < dist["dipolar_share"], span(4, "mu"), 0.0)
    assoc = (u[:, 5] < dist["associating_share"]).to(F64)
    kappa = assoc * dist["kappa_ab"]
    eps_ab = assoc * dist["epsilon_k_ab"]
    params = torch.stack([m, sigma, eps, mu, kappa, eps_ab, assoc, assoc], 1).contiguous()
    lo, hi = dist["reduced_temperature"]
    temperature = (lo + (hi - lo) * u[:, 6]) * eps / hi * dist["temperature_factor"]
    return params, temperature.contiguous()


def mask_mismatches(ok, ok_ref) -> float:
    """Rows whose converged flag differs from the reference's."""
    return float((ok != ok_ref).sum())


def max_rel(x, ref, mask) -> float:
    """Largest |x - ref| / |ref| over the rows in ``mask``; NaN counts as
    infinitely far."""
    if not bool(mask.any()):
        return 0.0
    err = ((x - ref).abs() / ref.abs())[mask]
    err = torch.where(torch.isfinite(err), err, torch.inf)
    return float(err.max())


def max_row_scaled(g, ref, mask) -> float:
    """Largest |g - ref| of a row over that row's largest |ref|, over the
    rows in ``mask``: each row's gradient against its own scale."""
    if not bool(mask.any()):
        return 0.0
    scale = ref.abs().amax(-1, keepdim=True)
    err = ((g - ref).abs() / torch.where(scale > 0, scale, 1.0)).amax(-1)[mask]
    err = torch.where(torch.isfinite(err), err, torch.inf)
    return float(err.max())


def worst(readings) -> dict:
    """Each compared number's largest value over ``readings`` (dicts of
    numbers, one a kept step); NaN counts as infinitely far."""
    out = {}
    for reading in readings:
        for k, v in reading.items():
            out[k] = max(out.get(k, 0.0), v if v == v else float("inf"))
    return out


class CheckedSteps:
    """Keeps the outputs of the window's first step, its last, and one more
    drawn from the seed (reservoir sampling, so every step is as likely):
    the steps whose answers the reference judges."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng([int(seed) % (2**63), 17])
        self.first = self.last = self.drawn = None
        self.seen = 0

    def add(self, out):
        self.seen += 1
        if self.first is None:
            self.first = out
        elif self.rng.random() < 1.0 / (self.seen - 1):
            self.drawn = out
        self.last = out

    def steps(self):
        """The kept steps' outputs, each once."""
        out = []
        for o in (self.first, self.drawn, self.last):
            if o is not None and all(o is not k for k in out):
                out.append(o)
        return out
