"""The port's bubble pressures against the JAX package's ``bubble_point``.

Config 3 of ``benchmarks/run_all.py`` over 130-170 K and seeded
cross-associating pairs (with and without an eps_AiBj override) go through
the port and, offline, through JAX's ``bubble_point`` (f32 warmup, f64
polish): ``tools/gen_torch_mix_jax_reference.py`` writes JAX's outputs to
``tests/golden/torch_mix_jax.npz`` (JAX compiles this solve for about a
minute on a CPU).  Values are compared on the rows both accept, and the mask
disagreements are counted (there are none on these rows).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft

CONFIG3 = [[1, 3.5, 150, 0, 0.02, 1500, 1, 1], [1, 3.5, 200, 0, 0.03, 2500, 1, 1]]
REFERENCE = Path(__file__).resolve().parent / "golden" / "torch_mix_jax.npz"


def cross_systems(seed, n=8):
    """Config 3 at n temperatures, and n seeded cross-associating pairs
    (every other one with an eps_AiBj override), with x1 and T."""
    rng = np.random.default_rng(seed)
    p = np.zeros((n, 2, 8))
    p[..., 0] = rng.uniform(1.0, 2.5, (n, 2))
    p[..., 1] = rng.uniform(3.0, 4.0, (n, 2))
    p[..., 2] = rng.uniform(150.0, 300.0, (n, 2))
    p[..., 4] = rng.uniform(0.01, 0.04, (n, 2))
    p[..., 5] = rng.uniform(1000.0, 2500.0, (n, 2))
    p[..., 6:8] = 1.0
    kij = np.stack([rng.uniform(-0.05, 0.05, n),
                    np.where(np.arange(n) % 2, rng.uniform(1500.0, 2500.0, n), 0.0)], 1)
    t_c = (p[..., 2] * (0.89 + 0.38 * p[..., 0])).min(1)
    params = np.concatenate([np.tile(CONFIG3, (n, 1, 1)), p])
    kij = np.concatenate([np.tile([-0.15, 1000.0], (n, 1)), kij])
    temperature = np.concatenate([np.linspace(130.0, 170.0, n),
                                  rng.uniform(0.6, 0.8, n) * t_c])
    x1 = np.concatenate([np.full(n, 0.5), rng.uniform(0.1, 0.9, n)])
    return params, kij, temperature, x1


def jax_reference(name, inputs):
    """JAX's ``(p, nans, composition)`` of the ``name`` solve from the
    vendored file, after checking that it was written for ``inputs``."""
    ref = np.load(REFERENCE)
    for key, x in zip(("params", "kij", "t", "x1"), inputs):
        np.testing.assert_array_equal(ref[f"{name}_{key}"], x, err_msg=f"stale {name}_{key}")
    return [ref[f"{name}_{key}"] for key in ("p", "nans", "comp")]


def port_and_reference(name, fn, seed):
    """The port's ``fn`` with ``full_output`` on cross_systems(seed, n=4),
    and JAX's vendored outputs on the same inputs."""
    params, kij, temperature, x1 = cross_systems(seed=seed, n=4)
    p0 = np.full(len(x1), 1e5)
    t = [torch.as_tensor(x) for x in (params, kij, temperature, x1, p0)]
    with torch.no_grad():
        port = fn(*t, full_output=True)
    return [x.numpy() for x in port], jax_reference(name, (params, kij, temperature, x1))


@pytest.fixture(scope="module")
def solved():
    return port_and_reference("bubble", ft.bubble_point, seed=21)


def test_masks_agree_with_jax(solved):
    (_, nans, _), (_, ref_nans, _) = solved
    assert int((nans != ref_nans).sum()) == 0
    assert not nans.any()


@pytest.mark.parametrize("j", [0, 2], ids=["p", "y"])
def test_values_match_jax(solved, j):
    port, ref = solved
    both = ~port[1] & ~ref[1]
    np.testing.assert_allclose(port[j][both], ref[j][both], rtol=1e-8, atol=0)
