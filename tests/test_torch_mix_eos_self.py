"""The port's parameter gradients of the binary-mixture derivative set with
one self-associating component, against the JAX package.

The self-association rows of ``test_torch_mix_eos._mix_states`` go through
the port's ``derivatives`` under autograd and through JAX's ``jacfwd`` of
``pressure_set`` in one jitted function of one shape.
"""

import pytest

from test_torch_mix_eos import OUTPUTS, assert_jacobians_match, regime_jacobians


@pytest.fixture(scope="module")
def jacobians():
    return regime_jacobians(("self",), {"self"})


@pytest.mark.parametrize("j", range(len(OUTPUTS)), ids=OUTPUTS)
def test_parameter_gradients_match_jax(jacobians, j):
    """d(A, p~, mu, v)/d(parameters, kij) against JAX's jacfwd on the 18
    states with one self-associating component."""
    assert_jacobians_match(*jacobians, j)
