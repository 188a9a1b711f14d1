"""The port's gc parameter assembly against the JAX package's ``assemble``.

The port builds each distinct molecule topology once (``GcTopology``) and
assembles the parameter half with torch ops; the JAX package counts every
row in host numpy.  Both run on the 11 topologies of the golden file and
on the 48 seeded random molecule pairs of
``tests/test_fuzz_oracle.py::test_fuzz_gc_random_topologies_vs_oracle``,
and every field must agree: the integer-valued fields exactly, the others
at rtol 1e-14.  JAX's ``assemble`` runs eagerly (host numpy and a few jnp
ops); the one JAX compile here is a ternary's derivative set.
"""

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from feos_tpu.models import gc_pcsaft as jgc
from feos_tpu_torch.models import gc_pcsaft as gc
from test_torch_gc_eos import (
    GOLDEN, IDENT, PARAMETER, _t, parameter_tuple, random_molecule,
)

# fields holding counts or indices, equal exactly
EXACT = ("bonds_p", "na", "nb", "kab", "bond_a", "bond_b", "phi_corr", "sigma", "epsilon_k")
FUZZ_KINDS = [("alkane", "alkane"), ("branched", "aldehyde"), ("alcohol", "alkane"),
              ("alcohol", "amine"), ("alcohol", "induced")]


def fuzz_systems(rows=48):
    """The seeded systems of test_fuzz_gc_random_topologies_vs_oracle, with
    its temperatures and compositions: ``(segment_lists, bond_lists, phi,
    rng)``, the generator positioned after phi."""
    rng = np.random.default_rng(20260821)
    segment_lists, bond_lists = [], []
    for i in range(rows):
        ka, kb = FUZZ_KINDS[i % len(FUZZ_KINDS)]
        (sa, ba), (sb, bb) = random_molecule(rng, ka), random_molecule(rng, kb)
        segment_lists.append([sa, sb])
        bond_lists.append([ba, bb])
    return segment_lists, bond_lists, rng.uniform(0.95, 1.1, (rows, 2)), rng


FUZZ_SEGMENTS, FUZZ_BONDS, FUZZ_PHI, _ = fuzz_systems()
CASES = {
    "golden": (GOLDEN["segment_lists"], GOLDEN["bond_lists"],
               [tuple(k) for k in GOLDEN["kab_list"]], np.array(GOLDEN["phi"])),
    "fuzz": (FUZZ_SEGMENTS, FUZZ_BONDS, [("CH3", "CH2", -0.05)], FUZZ_PHI),
    # single-segment molecules: no bond anywhere, the dummy pair (0, 0)
    "unbonded": ([[["CH3"], ["OH"]]] * 3, [[[], []]] * 3, [], None),
}


def port_assemble(segment_lists, bond_lists, records, phi):
    topology = gc.GcTopology.build(IDENT, segment_lists, bond_lists)
    kab = gc.kab_matrix(IDENT, [r[:2] for r in records], _t([r[2] for r in records]))
    return gc.assemble(topology, _t(PARAMETER), kab, None if phi is None else _t(phi))


@pytest.mark.parametrize("case", list(CASES))
def test_assembly_matches_jax(case):
    segment_lists, bond_lists, records, phi = CASES[case]
    got = port_assemble(segment_lists, bond_lists, records, phi)
    want = jgc.assemble(IDENT, parameter_tuple(PARAMETER), segment_lists, bond_lists,
                        records, phi)
    for name in gc.GcParams._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        if name in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-14, atol=0, err_msg=name)


def test_distinct_topologies_are_built_once():
    """4,096 rows of one system hold one topology; the golden file's 11
    topologies repeated give 11, in order of first appearance."""
    segs = [[["CH3", "CH2", "CH2", "CH3"], ["CH3", "CH2", "CH3"]]] * 4096
    bonds = [[[[0, 1], [1, 2], [2, 3]], [[0, 1], [1, 2]]]] * 4096
    topology = gc.GcTopology.build(IDENT, segs, bonds)
    assert topology.counts.shape == (1, 2, len(IDENT)) and not topology.rows.any()
    topology = gc.GcTopology.build(IDENT, GOLDEN["segment_lists"] * 3, GOLDEN["bond_lists"] * 3)
    assert topology.counts.shape[0] == 11
    np.testing.assert_array_equal(topology.rows, np.tile(np.arange(11), 3))


def test_from_numpy_round_trips():
    """``GcParams.from_numpy`` carries JAX's assembled parameters into the
    port unchanged, and the port's derivative set on them equals the one on
    its own assembly."""
    segment_lists, bond_lists, records, phi = CASES["golden"]
    want = jgc.assemble(IDENT, parameter_tuple(PARAMETER), segment_lists, bond_lists,
                        records, phi)
    got = gc.GcParams.from_numpy(want, device="cpu")
    for name in gc.GcParams._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.bond_a.dtype == torch.int64
    n = len(segment_lists)
    t, rho = _t(np.full(n, 300.0)), _t(np.tile(GOLDEN["density"], (n, 1)))
    with torch.no_grad():
        a = ft.gc_derivatives(got, t, rho)
        b = ft.gc_derivatives(port_assemble(segment_lists, bond_lists, records, phi), t, rho)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-14, atol=1e-300)


def test_two_associating_segments_in_one_component_raise():
    with pytest.raises(ValueError, match="one associating segment per component"):
        port_assemble([[["OH", "CH2", "NH2"], ["CH3", "CH3"]]], [[[[0, 1], [1, 2]], [[0, 1]]]],
                      [], None)


def test_unknown_segment_raises():
    with pytest.raises(ValueError, match="unknown segments"):
        port_assemble([[["CH3", "XX"], ["CH3"]]], [[[[0, 1]], []]], [], None)


def test_kab_matrix_is_symmetric_and_last_record_wins():
    """As the JAX package's sequential ``.at[].set``: a later record of the
    same unordered pair overrides an earlier one."""
    records = [("CH3", "CH2", 0.1), ("OH", "NH2", -0.2), ("CH2", "CH3", 0.3)]
    got = gc.kab_matrix(IDENT, [r[:2] for r in records], _t([r[2] for r in records]))
    want = jgc.assemble(IDENT, parameter_tuple(PARAMETER), [[["CH3"], ["CH2"]]], [[[], []]],
                        records).kab
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[IDENT.index("CH3"), IDENT.index("CH2")] == 0.3


def test_associating_components_beyond_a_binary_raise():
    """The cross and induced terms pair two components, so a ternary with
    three associating components raises (the JAX package silently drops
    their association); two are gathered wherever they sit, so the
    derivative set does not depend on the order of the components; one
    associating component is well defined for any n; a scalar x1 is the
    binary convention only."""
    bonds = [[[[0, 1]], [[0, 1]], [[0, 1]]]]
    t, rho = _t([300.0]), _t([[1e-3, 1e-3, 1e-3]])
    three = port_assemble([[["CH3", "OH"], ["CH3", "NH2"], ["CH3", "OH"]]], bonds, [], None)
    with pytest.raises(ValueError, match="three or more associating"):
        ft.gc_derivatives(three, t, rho)
    order = [2, 0, 1]
    mols = [["CH3", "OH"], ["CH3", "NH2"], ["CH3", "CH3"]]
    two = port_assemble([mols], bonds, [], None)
    moved = port_assemble([[mols[i] for i in order]], bonds, [], None)
    rho_2 = _t([[1e-3, 2e-3, 3e-3]])
    with torch.no_grad():
        a, p, mu, v = ft.gc_derivatives(two, t, rho_2)
        a_m, p_m, mu_m, v_m = ft.gc_derivatives(moved, t, rho_2[:, order])
    for x, y in ((a_m, a), (p_m, p), (mu_m, mu[:, order]), (v_m, v[:, order])):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-12)
    one = port_assemble([[["CH3", "OH"], ["CH3", "CH2"], ["CH3", "CH3"]]], bonds, [], None)
    want = jgc.gc_derivatives(jgc.assemble(
        IDENT, parameter_tuple(PARAMETER), [[["CH3", "OH"], ["CH3", "CH2"], ["CH3", "CH3"]]],
        bonds, []), np.array([300.0]), rho.numpy(), branches=frozenset({"self"}))
    with torch.no_grad():
        got = ft.gc_derivatives(one, t, rho)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-12)
    with pytest.raises(ValueError, match="binary x1 convention"):
        ft.gc_bubble_point(one, t, _t([0.3]), _t([1e5]))
