"""The port's gradients of the gc derivative set with two self-associating
segments (OH and NH2), against the JAX package.

The cross-association rows of ``test_torch_gc_eos.gc_states`` go through
the port's ``gc_derivatives`` under autograd and through JAX's ``jacfwd`` of
``assemble`` -> ``precompute_gc`` -> ``pressure_set`` in one jitted
function of one shape (vendored in ``tests/golden/torch_gc_eos_jax.npz`` by
``tools/gen_port_fixtures.py``).
"""

import pytest

from test_torch_gc_eos import OUTPUTS, assert_jacobians_match, regime_jacobians


@pytest.fixture(scope="module")
def jacobians():
    return regime_jacobians(("cross",))


@pytest.mark.parametrize("j", range(len(OUTPUTS)), ids=OUTPUTS)
def test_parameter_gradients_match_jax(jacobians, j):
    """d(A, p~, mu, v)/d(segment parameters, k_ab, phi) against JAX's
    jacfwd on the 6 cross-associating states."""
    assert_jacobians_match(*jacobians, j)
