"""gc binary segment-parameter regression (k_ab fitting), on the PyTorch
port.

Fits the CH3/OH binary segment interaction parameter k_ab of a
heterosegmented gc-PC-SAFT ethanol/butane system to synthetic bubble-point
data by Adam.  Gradients flow through the gc parameter assembly and the
stationary bubble-point identity.

Run:  python examples_torch/fit_gc_kab.py [--device cpu]
FIT_STEPS sets the number of Adam steps (default 100).
"""

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from feos_tpu_torch import GcPcSaftMix, fit_gc

# segment parameters from the vendored sauer2014 heterosegmented table
FIXTURE = Path(__file__).resolve().parent.parent / "tests" / "sauer2014_hetero.json"
SEGS = json.loads(FIXTURE.read_text())
IDENT = [r["identifier"] for r in SEGS]
PARAMETER = tuple(
    np.array([r["model_record"].get(k, 0) for r in SEGS])
    for k in ["m", "sigma", "epsilon_k", "mu", "kappa_ab", "epsilon_k_ab", "na", "nb"]
)

# ethanol (CH3-CH2-OH) / n-butane (CH3-CH2-CH2-CH3)
TOPO_SEGS = [["CH3", "CH2", "OH"], ["CH3", "CH2", "CH2", "CH3"]]
TOPO_BONDS = [[[0, 1], [1, 2]], [[0, 1], [1, 2], [2, 3]]]
KAB_TRUE = -0.05

# synthetic "experimental" bubble points over a (T, x) grid
B = 16
T = np.linspace(300.0, 330.0, B)
X1 = np.tile(np.linspace(0.2, 0.8, 8), 2)


def main(device="cuda", steps=None):
    """Returns the ``FitResult``."""
    steps = int(os.environ.get("FIT_STEPS", 100)) if steps is None else steps
    eos = GcPcSaftMix(IDENT, PARAMETER, [TOPO_SEGS] * B, [TOPO_BONDS] * B,
                      [("CH3", "OH", KAB_TRUE)], None, device=device)
    with torch.no_grad():
        p_exp, nans = eos.bubble_point(T, X1, np.full(B, 1e5))
    assert not bool(nans.any())
    return fit_gc(IDENT, PARAMETER, [TOPO_SEGS], [TOPO_BONDS], [("CH3", "OH", 0.0)],
                  T, X1, p_exp.cpu().numpy(), steps=steps, device=device)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    result = main(parser.parse_args().device)
    print(f"fitted k_ab(CH3,OH) = {float(result.parameters[0]):+.6f}  (true {KAB_TRUE:+.4f})")
    print(f"loss: {float(result.loss_history[0]):.3e} -> {float(result.loss_history[-1]):.3e}")
