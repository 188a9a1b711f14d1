"""The port's gradients of the gc derivative set with one
self-associating segment and the induced IA segment, against the JAX
package.

The induced-association rows of ``test_torch_gc_eos.gc_states`` go through
the port's ``gc_derivatives`` under autograd and through JAX's ``jacfwd`` of
``assemble`` -> ``precompute_gc`` -> ``pressure_set`` in one jitted
function of one shape (vendored in ``tests/golden/torch_gc_eos_jax.npz``
by ``tools/gen_port_fixtures.py``).  The table here gives IA no dipole
moment, so that JAX compiles the induced branch alone (with the dipole it
compiles for 37 s on a CPU); the dipole term's Jacobians on IA rows are
held to JAX in ``test_torch_gc_eos.py``.
"""

import pytest

from test_torch_gc_eos import (
    COLUMNS, IDENT_NZ, OUTPUTS, PARAMETER_NZ, assert_jacobians_match, regime_jacobians,
)


def induced_parameter():
    """The table without epsilon_k = 0 segments, with IA's dipole zeroed."""
    parameter = PARAMETER_NZ.copy()
    parameter[IDENT_NZ.index("IA"), COLUMNS.index("mu")] = 0.0
    return parameter


@pytest.fixture(scope="module")
def jacobians():
    return regime_jacobians(("induced",), induced_parameter())


@pytest.mark.parametrize("j", range(len(OUTPUTS)), ids=OUTPUTS)
def test_parameter_gradients_match_jax(jacobians, j):
    """d(A, p~, mu, v)/d(segment parameters, k_ab, phi) against JAX's
    jacfwd on the 6 induced-associating states."""
    assert_jacobians_match(*jacobians, j)
