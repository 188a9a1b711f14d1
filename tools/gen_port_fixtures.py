"""Write the JAX package's reference values that the port's tests read.

For each name below, ``tests/test_torch_<name>.py`` defines
``jax_reference()``: it runs the JAX package on its CPU backend (and, where
JAX is evaluated at the port's converged states, the port on the CPU) and
returns a dict of numpy arrays, its inputs among them.  This script writes
that dict to ``tests/golden/torch_<name>_jax.npz``, which the file (and the
files named beside it) read through ``tests/_torch_golden.py::vendored``
after holding the vendored inputs to the ones they build.

    golden file                        read by test_torch_*.py
    torch_critical_jax.npz             critical
    torch_tsolve_jax.npz               tsolve
    torch_mix_tsolve_cross_jax.npz     mix_tsolve_cross
    torch_liquid_density_jax.npz       liquid_density
    torch_binary_regression_jax.npz    binary_regression
    torch_mix_eos_jax.npz              mix_eos, mix_eos_self, mix_eos_induced
    torch_gc_eos_jax.npz               gc_eos, gc_eos_self, gc_eos_cross, gc_eos_induced
    torch_mix_tsolve_jax.npz           mix_tsolve
    torch_gc_grad_jax.npz              gc_grad
    torch_regression_jax.npz           regression
    torch_mix_properties_jax.npz       mix_properties
    torch_gc_tsolve_jax.npz            gc_tsolve
    torch_flash_live_jax.npz           flash (Rachford-Rice, window, residual, masks)
    torch_association_jax.npz          association
    torch_vapor_pressure_jax.npz       vapor_pressure
    torch_vle_jax.npz                  vle
    torch_diagrams_jax.npz             diagrams
    torch_gc_properties_jax.npz        gc_properties
    torch_parallel_jax.npz             parallel (JAX's fit_pure on an 8-device mesh)

Rerun a file's entry after changing the inputs it builds.  Run from the
repository root, all of them (about 10 min on an 8-core CPU, JAX's compiles
nearly all of it: 10-65 s a file) or the named ones:

    python tools/gen_port_fixtures.py [name ...]

The flash's edge solves and Jacobians (``tools/gen_torch_flash_reference.py``),
the mixture bubble/dew values (``tools/gen_torch_mix_jax_reference.py``) and
the n-component ones (``tools/gen_torch_multicomponent_reference.py``) have
generators of their own.
"""

import importlib
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

# the 8-device CPU mesh that tests/conftest.py gives the JAX package's tests
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

# golden name -> test module that defines jax_reference()
FILES = {
    "critical": "test_torch_critical",
    "tsolve": "test_torch_tsolve",
    "mix_tsolve_cross": "test_torch_mix_tsolve_cross",
    "liquid_density": "test_torch_liquid_density",
    "binary_regression": "test_torch_binary_regression",
    "mix_eos": "test_torch_mix_eos",
    "gc_eos": "test_torch_gc_eos",
    "mix_tsolve": "test_torch_mix_tsolve",
    "gc_grad": "test_torch_gc_grad",
    "regression": "test_torch_regression",
    "mix_properties": "test_torch_mix_properties",
    "gc_tsolve": "test_torch_gc_tsolve",
    "flash_live": "test_torch_flash",
    "association": "test_torch_association",
    "vapor_pressure": "test_torch_vapor_pressure",
    "vle": "test_torch_vle",
    "diagrams": "test_torch_diagrams",
    "gc_properties": "test_torch_gc_properties",
    "parallel": "test_torch_parallel",
}


def main(names):
    unknown = sorted(set(names) - set(FILES))
    if unknown:
        raise SystemExit(f"unknown names {unknown}; known: {sorted(FILES)}")
    t0 = time.perf_counter()
    for name in names or FILES:
        t1 = time.perf_counter()
        rec = importlib.import_module(FILES[name]).jax_reference()
        out = ROOT / "tests" / "golden" / f"torch_{name}_jax.npz"
        np.savez_compressed(out, **{k: np.asarray(v) for k, v in rec.items()})
        print(f"{out.relative_to(ROOT)}: {len(rec)} arrays, {time.perf_counter() - t1:.1f} s",
              flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:])
