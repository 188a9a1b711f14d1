"""The port's parameter gradients of the binary-mixture derivative set in
the induced-association regime, against the JAX package.

The induced rows of ``test_torch_mix_eos._mix_states`` (one self-associating
component, one with B sites only) go through the port's ``derivatives``
under autograd and through JAX's ``jacfwd`` of ``pressure_set`` in one
jitted function of one shape.
"""

import numpy as np
import pytest
import torch

from feos_tpu_torch.models import pcsaft_mix as mix
from test_torch_mix_eos import OUTPUTS, _t, assert_jacobians_match, regime_jacobians


def _site_fractions_reach_root(params, kij, temperature, rho):
    """The states whose site fractions reach their root, where the Q form
    equals the exact phi.  It leaves out one liquid state (eta = 0.45,
    na = 2, eps_ab/T = 9): there the fixed 30-step damped Newton of both
    packages drives X toward 0 without reaching the root (X ~ 1e-21,
    residual 2), and implicit derivatives at a point that is no root are
    not defined."""
    pre = mix.precompute_mix(mix.MixParams.from_tensor(_t(params)), _t(kij[:, 0]),
                             _t(kij[:, 1]), _t(temperature))
    with torch.no_grad():
        exact, q = (mix.phi_mix_pre(pre, _t(rho), assoc_q_form=f).numpy()
                    for f in (False, True))
    return np.isclose(q, exact, rtol=1e-12, atol=1e-16)


@pytest.fixture(scope="module")
def jacobians():
    return regime_jacobians(("induced",), {"induced"}, keep=_site_fractions_reach_root)


@pytest.mark.parametrize("j", range(len(OUTPUTS)), ids=OUTPUTS)
def test_parameter_gradients_match_jax(jacobians, j):
    """d(A, p~, mu, v)/d(parameters, kij) against JAX's jacfwd on 17 of the
    18 induced states."""
    assert len(jacobians[0][0]) == 17
    assert_jacobians_match(*jacobians, j)
