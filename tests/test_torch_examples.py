"""The port's six examples (``examples_torch/``), each run in this process
on the CPU with a few optimiser steps (two; three for ``fit_parameters``,
whose second Adam step overshoots; one for the flash fit) or its full
diagram: every fit's loss falls and every diagram's dew curve closes (a dew
solve at each (T, y1) returns the diagram's pressure within 1e-8, as
chip_smoke.py's phase 14 holds them).  A fresh interpreter imports all six
and the data-parallel module and holds them free of JAX and feos_tpu.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft

EXAMPLES = Path(__file__).resolve().parent.parent / "examples_torch"
NAMES = ("fit_parameters", "fit_binary_kij", "fit_gc_kab", "fit_flash_kij", "pxy_diagram",
         "txy_diagram")


def load(name):
    """The example ``examples_torch/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_every_example_has_a_counterpart():
    """The same six file names as the JAX package's examples/."""
    jax_names = sorted(p.stem for p in (EXAMPLES.parent / "examples").glob("*.py"))
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == jax_names == sorted(NAMES)


def test_fit_parameters():
    parameters, losses = load("fit_parameters").main(device="cpu", steps=3)
    assert losses.shape == (3,) and np.all(np.isfinite(losses)) and losses[2] < losses[0]
    assert np.all(np.isfinite(parameters))


@pytest.mark.parametrize("name", ["fit_binary_kij", "fit_gc_kab"])
def test_bubble_point_fits(name):
    result = load(name).main(device="cpu", steps=2)
    losses = result.loss_history.numpy()
    assert losses.shape == (2,) and losses[1] < losses[0]
    # Adam's first step moves k by its learning rate toward the truth
    assert -0.01 - 1e-9 < float(result.parameters[0]) < 0.0


def test_fit_flash_kij():
    example = load("fit_flash_kij")
    kij, losses = example.main(device="cpu", steps=1)
    assert losses.shape == (2,) and losses[1] < losses[0]
    assert example.KIJ_TRUE < kij < 0.0


@pytest.mark.parametrize("name", ["pxy_diagram", "txy_diagram"])
def test_diagram_closes(name):
    example = load(name)
    d = example.main(device="cpu")
    assert d.x1.shape == (51,) and not bool(d.nans.any())
    n = len(d.x1)
    system = torch.as_tensor(np.tile([example.PROPANE, example.BUTANE], (n, 1, 1)),
                             dtype=torch.float64)
    if name == "pxy_diagram":
        temperature, pressure = torch.full((n,), example.T, dtype=torch.float64), d.p
    else:
        temperature, pressure = d.t, torch.full((n,), example.P, dtype=torch.float64)
    with torch.no_grad():
        p, nans = ft.dew_point(system, None, temperature.detach(),
                               torch.stack([d.y1, 1.0 - d.y1], 1).detach(), pressure.detach())
    assert not bool(nans.any())
    np.testing.assert_allclose(p.numpy(), pressure.detach().numpy(), rtol=1e-8, atol=0)


def test_examples_import_no_jax():
    """All six examples and the data-parallel module load without JAX or
    feos_tpu (checked in a fresh interpreter)."""
    code = "\n".join([
        "import importlib.util, sys",
        "import feos_tpu_torch.parallel.mesh",
        f"for name in {NAMES!r}:",
        f"    path = {str(EXAMPLES)!r} + '/' + name + '.py'",
        "    spec = importlib.util.spec_from_file_location(name, path)",
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))",
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'feos_tpu')))",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=EXAMPLES.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
