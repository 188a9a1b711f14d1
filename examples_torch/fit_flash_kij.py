"""Fit k_ij to two-phase SPLIT data through the differentiable flash, on
the PyTorch port.

With ``flash(..., gradients=True)`` the loss can target what a separator
actually measures, the coexisting phase COMPOSITIONS at given (T, p, z),
because x/y/beta carry exact implicit-function-theorem derivatives with
respect to k_ij (``feos_tpu_torch/solvers/flash.py::reattach_flash``).

Synthetic ground truth at k_ij = -0.1; the fit starts at 0 and recovers
it from x/y data alone (no pressures in the loss).

Run:  python examples_torch/fit_flash_kij.py [--device cpu]
FIT_STEPS sets the number of Adam steps (default 100).
"""

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from feos_tpu_torch import bubble_point, dew_point, flash

COMPONENTS = np.array(
    [[1.0, 3.5, 150.0, 0, 0, 0, 0, 0], [1.0, 3.5, 200.0, 0, 0, 0, 0, 0]]
)
KIJ_TRUE = -0.1

# synthetic "experimental" splits over a (T, z) grid at mid-window p
B = 24
T = np.linspace(142.0, 158.0, B)
Z1 = np.tile(np.linspace(0.3, 0.7, 6), 4)


def schedule(step):
    """optax.exponential_decay(2e-2, 30, 0.3) as a factor of lr 2e-2."""
    return 0.3 ** (step / 30)


def main(device="cuda", steps=None):
    """Returns ``(k_ij, loss history)``; the history holds the loss before
    each step and, last, the loss at the fitted k_ij."""
    steps = int(os.environ.get("FIT_STEPS", 100)) if steps is None else steps

    def f64(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)

    params, t, z1 = f64(np.tile(COMPONENTS, (B, 1, 1))), f64(T), f64(Z1)

    def run_flash(kij_scalar, pressure):
        kij = torch.stack([kij_scalar.expand(B), torch.zeros_like(t)], -1)
        return flash(params, kij, t, z1, pressure, gradients=True)

    # pick pressures inside the true-kij two-phase window
    kij_true = f64(np.tile([KIJ_TRUE, 0.0], (B, 1)))
    with torch.no_grad():
        p_bub, nb = bubble_point(params, kij_true, t, z1, f64(np.full(B, 1e5)))
        p_dew, nd = dew_point(params, kij_true, t, z1, f64(np.full(B, 1e5)))
    assert not (bool(nb.any()) or bool(nd.any()))
    pressure = torch.sqrt(p_bub * p_dew)

    with torch.no_grad():
        _, x_exp, y_exp, _, phase_t = run_flash(f64(KIJ_TRUE), pressure)
    assert bool((phase_t == 2).all())

    def loss_fn(kij_scalar):
        _, x, y, _, phase = run_flash(kij_scalar, pressure)
        ok = (phase == 2)[:, None]
        # masked-loss pattern: substitute the TARGET on non-two-phase rows
        # BEFORE squaring, so those rows contribute exactly zero residual AND
        # zero gradient.  (Masking after the square -- where(ok, se, 0) -- is a
        # NaN trap: a row that leaves the two-phase window mid-optimization
        # carries NaN fillers, and reverse-mode 0 * NaN poisons the whole
        # gradient.)
        xs = torch.where(ok, x, x_exp)
        ys = torch.where(ok, y, y_exp)
        se = (xs - x_exp) ** 2 + (ys - y_exp) ** 2
        return se.sum() / torch.clamp(ok.sum(), min=1)

    kij = f64(0.0).requires_grad_()
    opt = torch.optim.Adam([kij], lr=2e-2)
    lr = torch.optim.lr_scheduler.LambdaLR(opt, schedule)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = loss_fn(kij)
        loss.backward()
        losses.append(float(loss.detach()))
        opt.step()
        lr.step()
    with torch.no_grad():
        losses.append(float(loss_fn(kij)))
    return float(kij.detach()), np.array(losses)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    kij, losses = main(parser.parse_args().device)
    print(f"fitted k_ij = {kij:+.6f}  (true {KIJ_TRUE:+.4f})")
    print(f"loss: {losses[0]:.3e} -> {losses[-1]:.3e}")
    assert abs(kij - KIJ_TRUE) < 5e-3
