"""Seeded parameter batches for the vapor-pressure workload.

A copy of ``bench.make_batch``, which cannot be imported here because
``bench.py`` imports jax.  The same numpy generator draws the same columns in
the same order, so a seed gives both packages identical inputs.
"""

import numpy as np


def make_batch(B, seed=0):
    """Physically diverse parameter batch around common fluids (fp64).

    Returns ``(params (B, 8), temperature (B,))`` as numpy arrays in the
    column order ``[m, sigma, epsilon_k, mu, kappa_ab, epsilon_k_ab, na, nb]``.
    """
    rng = np.random.default_rng(seed)
    m = rng.uniform(1.0, 3.0, B)
    sigma = rng.uniform(3.0, 4.0, B)
    epsilon_k = rng.uniform(150.0, 300.0, B)
    mu = np.where(rng.random(B) < 0.3, rng.uniform(0.5, 3.0, B), 0.0)
    assoc = rng.random(B) < 0.3
    kappa = np.where(assoc, 0.03, 0.0)
    eps_ab = np.where(assoc, 1800.0, 0.0)
    na = np.where(assoc, 1.0, 0.0)
    nb = np.where(assoc, 1.0, 0.0)
    params = np.stack([m, sigma, epsilon_k, mu, kappa, eps_ab, na, nb], axis=1)
    # reduced temperatures safely subcritical
    temperature = rng.uniform(0.55, 0.75, B) * epsilon_k / 0.75 * 1.1
    return params, temperature
