"""Isothermal p-x-y diagram of propane / n-butane in one batched solve, on
the PyTorch port.

The composition grid is the batch axis: 51 bubble-point solves (plus their
incipient-vapor compositions) run as one batch, warm started from the
Raoult estimate built on the pure-component solver.

Run:  python examples_torch/pxy_diagram.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from feos_tpu_torch import binary_pxy

# m, sigma, epsilon_k, mu, kappa_ab, epsilon_k_ab, na, nb
# (Gross & Sadowski 2001 pure-component parameters)
PROPANE = [2.0020, 3.6184, 208.11, 0, 0, 0, 0, 0]
BUTANE = [2.3316, 3.7086, 222.88, 0, 0, 0, 0, 0]

T = 300.0  # K


def main(device="cuda", n_points=51):
    """Prints every fifth point and returns the ``BinaryPxy``."""
    d = binary_pxy(np.array([PROPANE, BUTANE]), None, T, n_points=n_points, device=device)
    x1, y1, p = (a.detach().cpu().numpy() for a in (d.x1, d.y1, d.p))
    print(f"# propane(1) / n-butane(2) at T = {T} K")
    print(f"# {'x1':>8} {'y1':>8} {'p/bar':>10}")
    for i in range(0, n_points, 5):
        print(f"  {x1[i]:8.4f} {y1[i]:8.4f} {p[i] / 1e5:10.4f}")
    assert not bool(d.nans.any())
    return d


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
