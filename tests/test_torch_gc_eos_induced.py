"""The port's gradients of the gc derivative set with one
self-associating segment and the induced IA segment, against the JAX
package.

The induced-association rows of ``test_torch_gc_eos.gc_states`` go through
the port's ``gc_derivatives`` under autograd and through JAX's ``jacfwd`` of
``assemble`` -> ``precompute_gc`` -> ``pressure_set`` in one jitted
function of one shape.  The table here gives IA no dipole moment, so that
JAX compiles the induced branch alone (with the dipole it compiles for 37 s
on a CPU, too long for one file); the dipole term's Jacobians on IA rows
are held to JAX in ``test_torch_gc_eos.py``.
"""

import pytest

from test_torch_gc_eos import (
    COLUMNS, IDENT_NZ, OUTPUTS, PARAMETER_NZ, assert_jacobians_match, regime_jacobians,
)


@pytest.fixture(scope="module")
def jacobians():
    parameter = PARAMETER_NZ.copy()
    parameter[IDENT_NZ.index("IA"), COLUMNS.index("mu")] = 0.0
    return regime_jacobians(("induced",), {"induced"}, parameter)


@pytest.mark.parametrize("j", range(len(OUTPUTS)), ids=OUTPUTS)
def test_parameter_gradients_match_jax(jacobians, j):
    """d(A, p~, mu, v)/d(segment parameters, k_ab, phi) against JAX's
    jacfwd on the 6 induced-associating states."""
    assert_jacobians_match(*jacobians, j)
