"""Isobaric T-x-y diagram of propane / n-butane in one batched solve, on the
PyTorch port.

The temperature-explicit dual of examples_torch/pxy_diagram.py: the
composition grid is the batch axis of a single saturation-TEMPERATURE solve
(``bubble_point_t``: a secant outer iteration over warm-started
bubble-pressure solves; ``feos_tpu_torch/solvers/tsolve.py``).  Initial
temperatures come from the mole-fraction mix of the pure boiling points,
the T-side analog of the Raoult warm start.

Run:  python examples_torch/txy_diagram.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from feos_tpu_torch import binary_txy

# m, sigma, epsilon_k, mu, kappa_ab, epsilon_k_ab, na, nb
# (Gross & Sadowski 2001 pure-component parameters)
PROPANE = [2.0020, 3.6184, 208.11, 0, 0, 0, 0, 0]
BUTANE = [2.3316, 3.7086, 222.88, 0, 0, 0, 0, 0]

P = 3e5  # Pa


def main(device="cuda", n_points=51):
    """Prints every fifth point and returns the ``BinaryTxy``."""
    d = binary_txy(np.array([PROPANE, BUTANE]), None, P, n_points=n_points, device=device)
    x1, y1, t = (a.detach().cpu().numpy() for a in (d.x1, d.y1, d.t))
    print(f"# propane(1) / n-butane(2) at p = {P / 1e5:.1f} bar")
    print(f"# {'x1':>8} {'y1':>8} {'T/K':>10}")
    for i in range(0, n_points, 5):
        print(f"  {x1[i]:8.4f} {y1[i]:8.4f} {t[i]:10.4f}")
    assert not bool(d.nans.any())
    return d


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
