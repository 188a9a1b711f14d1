"""Binary interaction-parameter regression (the companion paper's workload),
on the PyTorch port.

Fits k_ij of a binary PC-SAFT mixture to synthetic bubble-point data by
Adam, with parameter gradients through the stationary bubble-point
identity (no solver unrolling).

Run:  python examples_torch/fit_binary_kij.py [--device cpu]
FIT_STEPS sets the number of Adam steps (default 100).
"""

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from feos_tpu_torch import bubble_point, fit_binary

# two non-associating components; ground-truth interaction parameter
COMPONENTS = np.array(
    [[1.0, 3.5, 150.0, 0, 0, 0, 0, 0], [1.0, 3.5, 200.0, 0, 0, 0, 0, 0]]
)
KIJ_TRUE = -0.1

# synthetic "experimental" bubble points over a (T, x) grid
B = 32
T = np.linspace(140.0, 160.0, B)
X1 = np.tile(np.linspace(0.2, 0.8, 8), 4)


def main(device="cuda", steps=None):
    """Returns the ``FitResult``."""
    steps = int(os.environ.get("FIT_STEPS", 100)) if steps is None else steps

    def f64(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)

    with torch.no_grad():
        p_exp, nans = bubble_point(f64(np.tile(COMPONENTS, (B, 1, 1))),
                                   f64(np.tile([KIJ_TRUE, 0.0], (B, 1))), f64(T), f64(X1),
                                   f64(np.full(B, 1e5)))
    assert not bool(nans.any())
    return fit_binary(COMPONENTS, T, X1, p_exp, kij0=0.0, steps=steps, device=device)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    result = main(parser.parse_args().device)
    print(f"fitted k_ij = {float(result.parameters[0]):+.6f}  (true {KIJ_TRUE:+.4f})")
    print(f"loss: {float(result.loss_history[0]):.3e} -> {float(result.loss_history[-1]):.3e}")
