"""JAX's reference values for the port's tests, read from vendored files.

JAX compiles the solves and Jacobians that the port's tests hold the port
to for 10-65 s a file on a CPU.  So a test file ``test_torch_<name>.py``
whose reference needs such a compile defines ``jax_reference()``, which
runs the JAX package and returns a dict of numpy arrays (the inputs it ran
on among them), and ``tools/gen_port_fixtures.py`` writes that dict to
``tests/golden/torch_<name>_jax.npz``.  The tests read the file through
:func:`vendored`, which first holds the vendored inputs to the inputs the
file builds now, so a stale file fails loudly.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np

GOLDEN = Path(__file__).resolve().parent / "golden"


def vendored(name, exact=None, close=None):
    """The arrays of ``tests/golden/torch_<name>_jax.npz``, after checking
    that each array of ``exact`` equals the vendored one of its key, and
    each of ``close`` (the port's own converged states, which JAX was
    evaluated at) is within 1e-12 of it relative, which allows for rounding
    on another CPU."""
    ref = dict(np.load(GOLDEN / f"torch_{name}_jax.npz"))
    hint = f"stale vendored input: rerun python tools/gen_port_fixtures.py {name}"
    for key, x in (exact or {}).items():
        np.testing.assert_array_equal(np.asarray(x), ref[key], err_msg=f"{key}: {hint}")
    for key, x in (close or {}).items():
        np.testing.assert_allclose(np.asarray(x), ref[key], rtol=1e-12, atol=0,
                                   err_msg=f"{key}: {hint}")
    return ref


def flat(prefix, tree):
    """A named tuple of arrays (nested named tuples included) as the
    ``{prefix_field: array}`` entries of a vendored file."""
    out = {}
    for field, x in tree._asdict().items():
        if hasattr(x, "_asdict"):
            out.update(flat(f"{prefix}_{field}", x))
        elif x is not None and not isinstance(x, (frozenset, str)):
            out[f"{prefix}_{field}"] = np.asarray(x)
    return out


def unflat(ref, prefix):
    """The entries ``prefix_*`` of a vendored file as attributes of a
    namespace (the inverse of :func:`flat` one level deep)."""
    head = f"{prefix}_"
    return SimpleNamespace(**{k[len(head):]: v for k, v in ref.items() if k.startswith(head)})
