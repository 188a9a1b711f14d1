"""The port's dew pressures against the JAX package's ``dew_point``.

Config 3 of ``benchmarks/run_all.py`` over 130-170 K and seeded
cross-associating pairs (with and without an eps_AiBj override) go through
the port and, offline, through JAX's ``dew_point`` (f32 warmup, f64
polish), whose outputs ``tools/gen_torch_mix_jax_reference.py`` writes to
``tests/golden/torch_mix_jax.npz``.  Values are compared on the rows both
accept, and the mask disagreements are counted (there are none on these
rows).
"""

import numpy as np
import pytest

import feos_tpu_torch as ft
from test_torch_mix_jax_bubble import port_and_reference


@pytest.fixture(scope="module")
def solved():
    return port_and_reference("dew", ft.dew_point, seed=22)


def test_masks_agree_with_jax(solved):
    (_, nans, _), (_, ref_nans, _) = solved
    assert int((nans != ref_nans).sum()) == 0
    assert not nans.any()


@pytest.mark.parametrize("j", [0, 2], ids=["p", "y"])
def test_values_match_jax(solved, j):
    port, ref = solved
    both = ~port[1] & ~ref[1]
    np.testing.assert_allclose(port[j][both], ref[j][both], rtol=1e-8, atol=0)
