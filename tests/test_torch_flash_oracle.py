"""The port's flash against the C++ oracle (``cpu_backend.mix_flash`` and
``cpu_backend.gc_flash``).

The 48 random binary systems of
``tests/test_fuzz_oracle.py::test_fuzz_flash_vs_oracle`` (seed 20260821:
every association regime, dipolar overlaps, eps_AiBj overrides) are drawn
again in the same order, with pressures log-blended 0.2-0.8 into the
two-phase windows of the oracle's own bubble and dew solves (the port's
flash finds its windows itself).  The port and the oracle must agree on
the phase code of all but 0.02 B + 1 rows and, on the rows both split, on
beta (rtol 1e-6, atol 1e-9), x and y (atol 1e-8) and rho (rtol 1e-8), that
test's bars.  The gc rows (tests/test_flash.py's butane/propane at 300 K, config 4
of benchmarks/run_all.py with k_ab and phi, and the 11 golden topologies,
every gc association regime) are held to the oracle at mid-window the same
way.  No JAX function is compiled here.
"""

import numpy as np
import pytest
import torch

from _torch_oracle import backend  # noqa: F401 (a fixture)
import feos_tpu_torch as ft
from test_fuzz_oracle import _random_params, _tc_estimate
from test_torch_gc_eos import GOLDEN, IDENT, PARAMETER, parameter_tuple

SEGMENTS = [["CH3", "CH2", "CH2", "CH3"], ["CH3", "CH2", "CH3"]]
BONDS = [[[0, 1], [1, 2], [2, 3]], [[0, 1], [1, 2]]]


def fuzz_draw():
    """The draw of test_fuzz_flash_vs_oracle, in its order: parameters,
    kij, T, z1, then (after its edge solves) the blend weights."""
    rng = np.random.default_rng(20260821)
    B = 48
    p1 = _random_params(rng, B)
    p2 = _random_params(rng, B, schemes=("2B", "1A"))
    params = np.stack([p1, p2], axis=1)
    both_2b = (p1[:, 6] * p1[:, 7] > 0) & (p2[:, 6] * p2[:, 7] > 0)
    eps_ab_ij = np.where(both_2b & (rng.random(B) < 0.5), rng.uniform(1200.0, 2600.0, B), 0.0)
    kij = np.stack([rng.uniform(-0.15, 0.15, B), eps_ab_ij], axis=1)
    tc = np.minimum(_tc_estimate(p1), _tc_estimate(p2))
    T = rng.uniform(0.55, 0.85, B) * tc
    z1 = rng.uniform(0.1, 0.9, B)
    w = rng.uniform(0.2, 0.8, B)
    return params, kij, T, z1, w


def agree(port, oracle, edges_ok, min_two=0.0):
    """Phase codes within 0.02 B + 1 mismatches; values at the flash bars
    on the rows both split.  Returns the counts of those rows and of the
    mismatches."""
    bj, xj, yj, rj, phj = (o.numpy() for o in port)
    bo, xo, yo, ro, pho = oracle
    B = len(bj)
    two_j = edges_ok & (phj == 2)
    two_o = edges_ok & (pho == 2)
    mismatch = two_j ^ two_o
    assert two_j.sum() >= min_two * B, f"only {two_j.sum()}/{B} two-phase"
    assert mismatch.sum() <= 0.02 * B + 1, (
        f"{mismatch.sum()} phase mismatches at rows {np.nonzero(mismatch)[0][:10]}")
    both = two_j & two_o
    np.testing.assert_allclose(bo[both], bj[both], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(xo[both], xj[both], rtol=0, atol=1e-8)
    np.testing.assert_allclose(yo[both], yj[both], rtol=0, atol=1e-8)
    np.testing.assert_allclose(ro[both], rj[both], rtol=1e-8)
    return int(both.sum()), int(mismatch.sum())


def test_fuzz_flash_replay_vs_oracle(backend):
    params, kij, T, z1, w = fuzz_draw()
    B = len(T)
    p0 = np.full(B, 1e5)
    _, p_bub, ok_b = backend.mix_vle_densities(params, kij, T, z1, p0, True)
    _, p_dew, ok_d = backend.mix_vle_densities(params, kij, T, z1, p0, False)
    edges_ok = ok_b & ok_d
    assert edges_ok.sum() >= 0.6 * B
    p = np.where(edges_ok, np.exp((1 - w) * np.log(p_bub) + w * np.log(p_dew)), 1e5)
    with torch.no_grad():
        port = ft.PcSaftMix(params, kij, device="cpu").flash(T, z1, p)
    n_both, n_mismatch = agree(port, backend.mix_flash(params, kij, T, z1, p), edges_ok,
                               min_two=0.55)
    assert n_mismatch <= 1 and n_both >= 0.55 * B - 1


def gc_systems():
    """(label, model, T, z1): the gc rows the oracle checks."""
    gold = len(GOLDEN["labels"])
    return [
        ("butane/propane 300 K", ft.GcPcSaftMix(
            IDENT, parameter_tuple(PARAMETER), [SEGMENTS] * 3, [BONDS] * 3, [], None,
            device="cpu"), np.full(3, 300.0), np.array([0.3, 0.5, 0.7])),
        ("config 4", ft.GcPcSaftMix(
            IDENT, parameter_tuple(PARAMETER), [SEGMENTS] * 4, [BONDS] * 4,
            [("CH3", "CH2", -0.15)], np.tile([1.1, 0.98], (4, 1)), device="cpu"),
         np.linspace(140.0, 160.0, 4), np.full(4, 0.5)),
        ("golden topologies", ft.GcPcSaftMix(
            IDENT, parameter_tuple(PARAMETER), GOLDEN["segment_lists"], GOLDEN["bond_lists"],
            [tuple(k) for k in GOLDEN["kab_list"]], np.array(GOLDEN["phi"]), device="cpu"),
         np.full(gold, 300.0), np.full(gold, 0.4)),
    ]


@pytest.mark.parametrize("case", range(3), ids=["300K", "config4", "golden"])
def test_gc_flash_vs_oracle(backend, case):
    _, model, T, z1 = gc_systems()[case]
    B = len(T)
    params = model.params.detach()
    p0 = np.full(B, 1e5)
    _, p_bub, ok_b = backend.gc_vle_densities(params, T, z1, p0, True)
    _, p_dew, ok_d = backend.gc_vle_densities(params, T, z1, p0, False)
    edges_ok = ok_b & ok_d
    p = np.where(edges_ok, np.sqrt(p_bub * p_dew), 1e5)
    with torch.no_grad():
        port = model.flash(T, z1, p)
    n_both, n_mismatch = agree(port, backend.gc_flash(params, T, z1, p), edges_ok)
    assert n_mismatch == 0 and n_both == edges_ok.sum()
