"""The port's dew pressures against the JAX package's ``dew_point``.

Config 3 of ``benchmarks/run_all.py`` over 130-170 K and seeded
cross-associating pairs (with and without an eps_AiBj override) go through
the port and through JAX's ``dew_point`` (f32 warmup, f64 polish) in one
jitted call.  Values are compared on the rows both accept, and the mask
disagreements are counted (there are none on these rows).
"""

import jax
import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from feos_tpu.models import pcsaft_mix as jmix

from test_torch_mix_jax_bubble import cross_systems


@pytest.fixture(scope="module")
def solved():
    params, kij, temperature, x1 = cross_systems(seed=22, n=4)
    p0 = np.full(len(x1), 1e5)
    t = [torch.as_tensor(x) for x in (params, kij, temperature, x1, p0)]
    with torch.no_grad():
        port = ft.dew_point(*t, full_output=True)
    br = jmix.static_branches(params)
    ref = jax.jit(lambda *a: jmix.dew_point(*a, branches=br, full_output=True))(
        params, kij, temperature, x1, p0)
    return [x.numpy() for x in port], [np.asarray(x) for x in ref]


def test_masks_agree_with_jax(solved):
    (_, nans, _), (_, ref_nans, _) = solved
    assert int((nans != ref_nans).sum()) == 0
    assert not nans.any()


@pytest.mark.parametrize("j", [0, 2], ids=["p", "y"])
def test_values_match_jax(solved, j):
    port, ref = solved
    both = ~port[1] & ~ref[1]
    np.testing.assert_allclose(port[j][both], ref[j][both], rtol=1e-8, atol=0)
