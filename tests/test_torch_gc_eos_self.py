"""The port's gradients of the gc derivative set with one
self-associating segment (OH or NH2 beside a non-associating molecule),
against the JAX package.

The self-association rows of ``test_torch_gc_eos.gc_states`` go through
the port's ``gc_derivatives`` under autograd and through JAX's ``jacfwd`` of
``assemble`` -> ``precompute_gc`` -> ``pressure_set`` in one jitted
function of one shape.
"""

import pytest

from test_torch_gc_eos import OUTPUTS, assert_jacobians_match, regime_jacobians


@pytest.fixture(scope="module")
def jacobians():
    return regime_jacobians(("self",), {"self"})


@pytest.mark.parametrize("j", range(len(OUTPUTS)), ids=OUTPUTS)
def test_parameter_gradients_match_jax(jacobians, j):
    """d(A, p~, mu, v)/d(segment parameters, k_ab, phi) against JAX's
    jacfwd on the 6 self-associating states."""
    assert_jacobians_match(*jacobians, j)
