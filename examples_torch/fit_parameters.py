"""Large-scale PC-SAFT parameter regression (the reference paper's workload),
on the PyTorch port.

Fits pure-component PC-SAFT parameters to synthetic vapor-pressure +
liquid-density data by Adam with an exponentially decaying learning rate.
Launched as N processes (one card each), the batch is split over them and
the gradient is summed across them (``feos_tpu_torch.parallel``).

Run:  python examples_torch/fit_parameters.py [--device cpu]
      torchrun --nproc-per-node N examples_torch/fit_parameters.py   (N divides 64)
FIT_STEPS sets the number of Adam steps (default 300).
"""

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from feos_tpu_torch import PcSaftPure, pure_loss
from feos_tpu_torch.parallel import all_reduce_sum, batch_mesh, initialize_multi_host

# ground truth: an associating fluid (README example of the reference)
TRUE = np.array([1.5, 3.5, 250.0, 0.0, 0.03, 1500.0, 1.0, 1.0])
B = 64


def schedule(step):
    """optax.exponential_decay(2e-2, 100, 0.5) as a factor of lr 2e-2."""
    return 0.5 ** (step / 100)


def main(device="cuda", steps=None, mesh=None):
    """Fit from a perturbed guess; with a ``mesh``, this process fits its
    block of the 64 rows.  Returns ``(parameters, loss history)``."""
    steps = int(os.environ.get("FIT_STEPS", 300)) if steps is None else steps
    if mesh is not None:
        device = mesh.device
    # synthetic "experimental" data
    temperature = torch.linspace(250.0, 420.0, B, dtype=torch.float64, device=device)
    eos = PcSaftPure(np.tile(TRUE, (B, 1)), device=device)
    with torch.no_grad():
        _, p_sat = eos.vapor_pressure(temperature)
        _, rho_liq = eos.equilibrium_liquid_density(temperature)
    if mesh is not None:
        rows = mesh.block(B)
        temperature, p_sat, rho_liq = temperature[rows], p_sat[rows], rho_liq[rows]

    # start from a perturbed guess and fit m, sigma, epsilon_k, kappa_ab, eps_ab
    start = TRUE.copy()
    start[[0, 1, 2]] = [1.8, 3.3, 235.0]
    start = torch.as_tensor(start, device=device)
    scale = torch.where(start != 0.0, start.abs(), 1.0)
    z = (start / scale).requires_grad_()
    opt = torch.optim.Adam([z], lr=2e-2)
    lr = torch.optim.lr_scheduler.LambdaLR(opt, schedule)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        # NPT liquid density at p_sat == saturated liquid density
        loss = pure_loss(z * scale, temperature, p_sat=p_sat, rho_liq=rho_liq,
                         pressure=p_sat, mesh=mesh)
        loss.backward()
        if mesh is not None:
            z.grad, loss = all_reduce_sum(z.grad, mesh), all_reduce_sum(loss, mesh)
        losses.append(float(loss.detach()))
        if bool(torch.isfinite(z.grad).all()):  # a non-finite step is skipped
            opt.step()
            lr.step()
    return (z * scale).detach().cpu().numpy(), np.array(losses)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    world_size = int(os.environ.get("WORLD_SIZE", 1))
    mesh = None
    if world_size > 1:  # torchrun's environment, passed on explicitly
        rank = int(os.environ["RANK"])
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        initialize_multi_host(f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
                              world_size, rank)
        mesh = batch_mesh(device=None if args.device == "cuda" else args.device)
    try:
        parameters, losses = main(args.device, mesh=mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    np.set_printoptions(precision=5, suppress=True)
    print(f"loss: {losses[0]:.3e} -> {losses[-1]:.3e}")
    print("fitted:", parameters)
    print("truth: ", TRUE)
