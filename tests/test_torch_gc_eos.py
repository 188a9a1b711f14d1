"""The PyTorch port's gc-PC-SAFT EOS against the JAX package, the golden
file and the C++ oracle.

The golden file holds the reference's phi and derivative set for 11
molecule topologies (plain, branched, polar, self-, cross- and
induced-associating).  A seeded batch of binary gc systems in every regime
(random molecules from the sauer2014 segments, random k_ab records and
phi, three packing fractions) goes through the port's ``gc_derivatives``
and through JAX's ``gc_derivatives`` and ``precompute_gc`` in one jitted
function of one shape.  The Jacobians of the derivative set in the
``(S, 8)`` segment parameters, the k_ab values and phi are held to JAX's
``jacfwd`` through ``assemble`` -> ``precompute_gc`` -> ``pressure_set`` by
regime: the rows without association here, the self-, cross- and
induced-associating rows in ``test_torch_gc_eos_self.py``,
``test_torch_gc_eos_cross.py`` and ``test_torch_gc_eos_induced.py`` (JAX
compiles each branch set for 15-40 s on a CPU).

JAX's epsilon_k derivatives are NaN wherever the segment table holds a
segment with epsilon_k = 0 (``>C<`` in sauer2014), used or not: autograd
of sqrt(eps_a eps_c) at a zero product.  The Jacobians are therefore taken
on the table without such segments, and the port's own treatment of them is
held to finite differences here.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_oracle import backend  # noqa: F401 (a fixture)
import feos_tpu_torch as ft
from feos_tpu.models import gc_pcsaft as jgc
from feos_tpu_torch.models import gc_pcsaft as gc

REPO = Path(__file__).resolve().parent.parent
GOLDEN = json.loads((REPO / "tests" / "golden" / "gc_helmholtz.json").read_text())
SAUER = json.loads((REPO / "tests" / "sauer2014_hetero.json").read_text())
COLUMNS = ("m", "sigma", "epsilon_k", "mu", "kappa_ab", "epsilon_k_ab", "na", "nb")
IDENT = [r["identifier"] for r in SAUER]
# (S, 8) segment parameters of the sauer2014 table
PARAMETER = np.array([[r["model_record"].get(k, 0.0) for k in COLUMNS] for r in SAUER])
# the table without its epsilon_k = 0 segments (>C<), on which JAX's
# epsilon_k derivatives are finite
NONZERO = PARAMETER[:, 2] > 0.0
IDENT_NZ = [s for s, keep in zip(IDENT, NONZERO) if keep]
PARAMETER_NZ = PARAMETER[NONZERO]
REGIMES = ("none", "dipolar", "self", "cross", "induced")
# molecule families per regime (pairs of _random_molecule kinds)
KINDS = {
    "none": [("alkane", "alkane"), ("branched", "alkane")],
    "dipolar": [("branched", "aldehyde"), ("induced", "induced")],
    "self": [("alcohol", "alkane"), ("branched", "amine")],
    "cross": [("alcohol", "amine"), ("amine", "alcohol")],
    "induced": [("alcohol", "induced"), ("amine", "induced")],
}
ETAS = (1e-3, 0.2, 0.45)  # vapor-like, intermediate, liquid packing fractions
KAB_PAIRS = [("CH3", "CH2"), ("CH3", "OH"), ("CH2", "CH=O"), (">CH", "NH2")]


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def parameter_tuple(parameter):
    """The JAX package's 8-tuple of segment columns."""
    return tuple(parameter[:, i] for i in range(8))


def random_molecule(rng, kind):
    """A random molecule of one family from the sauer2014 segments (the
    generator of tests/test_fuzz_oracle.py::_random_gc_molecule): linear
    alkanes, 2-methyl branched alkanes, and chains ending in OH or NH2
    (self-associating), CH=O (dipolar) or IA (acceptor only, dipolar)."""
    k = int(rng.integers(0, 4))
    segs = ["CH3"] + ["CH2"] * k
    if kind == "branched":
        segs += [">CH", "CH3", "CH3"]
        b = k + 1
        bonds = [[i, i + 1] for i in range(b + 1)] + [[b, b + 2]]
    else:
        segs += [{"alkane": "CH3", "alcohol": "OH", "amine": "NH2",
                  "aldehyde": "CH=O", "induced": "IA"}[kind]]
        bonds = [[i, i + 1] for i in range(len(segs) - 1)]
    return segs, bonds


def gc_states(seed=3):
    """Seeded binary gc states, two molecule families per regime, each at
    the three packing fractions: ``(segment_lists, bond_lists, kab values
    (R,) for KAB_PAIRS, phi (B, 2), T (B,), rho (B, 2), regime per row)``."""
    rng = np.random.default_rng(seed)
    segment_lists, bond_lists, regimes = [], [], []
    for regime in REGIMES:
        for ka, kb in KINDS[regime]:
            (sa, ba), (sb, bb) = random_molecule(rng, ka), random_molecule(rng, kb)
            for _ in ETAS:
                segment_lists.append([sa, sb])
                bond_lists.append([ba, bb])
                regimes.append(regime)
    B = len(regimes)
    kab = rng.uniform(-0.05, 0.05, len(KAB_PAIRS))
    phi = rng.uniform(0.95, 1.1, (B, 2))
    temperature = rng.uniform(250.0, 400.0, B)
    x1 = rng.uniform(0.05, 0.95, B)
    z = np.stack([x1, 1.0 - x1], 1)
    # the packing fraction from the segment diameters
    counts = np.array([[[c.count(s) for s in IDENT] for c in row] for row in segment_lists])
    m, sigma, eps = PARAMETER[:, 0], PARAMETER[:, 1], PARAMETER[:, 2]
    d = sigma * (1.0 - 0.12 * np.exp(-3.0 * eps / temperature[:, None]))
    md3 = (counts * m * d[:, None, :] ** 3).sum(-1)
    eta = np.tile(ETAS, B // len(ETAS))
    rho = z * (eta / (np.pi / 6.0 * (z * md3).sum(1)))[:, None]
    return segment_lists, bond_lists, kab, phi, temperature, rho, np.array(regimes)


def port_params(segment_lists, bond_lists, kab, phi, parameter=PARAMETER, ident=IDENT):
    """The port's assembled :class:`GcParams` on the CPU."""
    topology = gc.GcTopology.build(ident, segment_lists, bond_lists)
    return gc.assemble(topology, _t(parameter), gc.kab_matrix(ident, KAB_PAIRS, _t(kab)),
                       _t(phi))


def jax_params(segment_lists, bond_lists, kab, phi, parameter=PARAMETER, ident=IDENT):
    return jgc.assemble(ident, parameter_tuple(parameter), segment_lists, bond_lists,
                        [(a, b, k) for (a, b), k in zip(KAB_PAIRS, kab)], phi)


# the six scalars of a state's derivative set, in the order of _flat
OUTPUTS = ("A", "p", "mu0", "mu1", "v0", "v1")


def _flat(a, p, mu, v):
    return torch.cat([a[:, None], p[:, None], mu, v], 1)


def regime_jacobians(regimes, branches, parameter=PARAMETER_NZ):
    """The port's and JAX's Jacobians of the derivative set in the segment
    parameters ``(B, 6, S, 8)``, the k_ab values ``(B, 6, R)`` and phi ``(B,
    6, B, 2)`` on the states of the named regimes, with the segment table
    ``parameter`` (default: the table without epsilon_k = 0 segments); JAX's
    in one jitted ``jacfwd`` under the phi branch set ``branches``."""
    segment_lists, bond_lists, kab, phi, temperature, rho, rows = gc_states()
    keep = np.isin(rows, regimes)
    segment_lists = [s for s, k in zip(segment_lists, keep) if k]
    bond_lists = [b for b, k in zip(bond_lists, keep) if k]
    phi, temperature, rho = phi[keep], temperature[keep], rho[keep]
    br = frozenset(branches)

    def item(par, kv, ph, t, r):
        g = jax_params(segment_lists, bond_lists, kv, ph, par, IDENT_NZ)
        return jnp.concatenate([x.reshape(len(t), -1) for x in jgc.gc_derivatives(
            g, t, r, branches=br)], 1)

    want = jax.jit(jax.jacfwd(item, argnums=(0, 1, 2)))(
        parameter, kab, phi, temperature, rho)
    got = port_jacobians(segment_lists, bond_lists, parameter, kab, phi, temperature, rho)
    return got, want


def port_jacobians(segment_lists, bond_lists, parameter, kab, phi, temperature, rho):
    """The port's Jacobians (as :func:`regime_jacobians`), one reverse pass
    per row and output: the segment parameters are shared by the rows."""
    par, kv, ph = (_t(x).requires_grad_() for x in (parameter, kab, phi))
    topology = gc.GcTopology.build(IDENT_NZ, segment_lists, bond_lists)
    params = gc.assemble(topology, par, gc.kab_matrix(IDENT_NZ, KAB_PAIRS, kv), ph)
    out = _flat(*gc.gc_derivatives(params, _t(temperature), _t(rho)))
    jac = [[torch.autograd.grad(out[b, j], (par, kv, ph), retain_graph=True)
            for j in range(out.shape[1])] for b in range(out.shape[0])]
    return tuple(np.stack([[np.asarray(row[j][w]) for j in range(len(row))] for row in jac])
                 for w in range(3))


def assert_rows_close(got, want):
    """rtol 1e-10, with a floor of 1e-12 of each row's largest entry for
    entries that cancel to near zero (a row of exact zeros, where a state's
    molecules hold none of the k_ab pairs, must be matched exactly)."""
    got, want = got.reshape(len(got), -1), np.asarray(want).reshape(len(want), -1)
    scale = np.abs(want).max(1, keepdims=True)
    err = np.abs(got - want)
    allow = 1e-10 * np.abs(want) + 1e-12 * scale
    worst = np.max(np.where(err == 0.0, 0.0, err / np.where(allow > 0.0, allow, 1e-300)))
    assert worst <= 1.0, worst


def assert_jacobians_match(got, want, j):
    """Output ``j``'s Jacobians in the segment parameters, k_ab and phi,
    row by row."""
    for g, w in zip(got, want):
        assert_rows_close(g[:, j], np.asarray(w)[:, j])


@pytest.fixture(scope="module")
def states():
    """(inputs, port (A, p, mu, v), JAX (A, p, mu, v), JAX GcPre leaves)."""
    segment_lists, bond_lists, kab, phi, temperature, rho, _ = gc_states()
    with torch.no_grad():
        port = gc.gc_derivatives(port_params(segment_lists, bond_lists, kab, phi),
                                 _t(temperature), _t(rho))
    jp = jax_params(segment_lists, bond_lists, kab, phi)

    @jax.jit
    def ref(g, temperature, rho):
        out = jgc.gc_derivatives(g, temperature, rho)
        pre = jax.vmap(jgc.precompute_gc, in_axes=(jgc._GC_BATCH_AXES, 0))(g, temperature)
        return out, pre

    out, pre = ref(jp, temperature, rho)
    return ((segment_lists, bond_lists, kab, phi, temperature, rho),
            tuple(x.numpy() for x in port), tuple(np.asarray(x) for x in out),
            jax.tree_util.tree_map(np.asarray, pre))


def test_every_regime_is_present(states):
    (segment_lists, bond_lists, kab, phi, temperature, _), *_ = states
    pre = gc.precompute_gc(port_params(segment_lists, bond_lists, kab, phi), _t(temperature))
    assert pre.self_m.any() and pre.cross_m.any() and pre.induced_m.any()
    assert pre.dipolar.any()
    assert (~(pre.self_m | pre.cross_m | pre.induced_m | pre.dipolar)).any()
    assert pre.branches == frozenset({"dipole", "self", "cross", "induced"})


@pytest.mark.parametrize("j", range(4), ids=["A", "p", "mu", "v"])
def test_derivatives_match_jax(states, j):
    _, port, ref, _ = states
    np.testing.assert_allclose(port[j], ref[j], rtol=1e-12, atol=0)


def test_precompute_matches_jax(states):
    (segment_lists, bond_lists, kab, phi, temperature, _), _, _, ref = states
    pre = gc.precompute_gc(port_params(segment_lists, bond_lists, kab, phi), _t(temperature))
    for name in gc.GcPre._fields:
        if name == "branches":  # JAX's GcPre leaves it to static_branches_gc
            continue
        got, want = getattr(pre, name), getattr(ref, name)
        if name == "dip":
            for f in got._fields:
                np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f),
                                           rtol=1e-13, atol=0, err_msg=f"dip.{f}")
        elif got.dtype == torch.bool:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=0, err_msg=name)


def test_q_form_matches_exact_values_and_first_derivatives(states):
    """The Q form is stationary in the site fractions: its value and first
    density derivatives equal the exact phi's, at every state here."""
    (segment_lists, bond_lists, kab, phi, temperature, rho), *_ = states
    pre = gc.precompute_gc(port_params(segment_lists, bond_lists, kab, phi), _t(temperature))
    r = _t(rho).requires_grad_()
    vals, grads = [], []
    for q in (False, True):
        a = gc.phi_gc_pre(pre, r, assoc_q_form=q)
        vals.append(a.detach().numpy())
        grads.append(torch.autograd.grad(a.sum(), r)[0].numpy())
    np.testing.assert_allclose(vals[1], vals[0], rtol=1e-12, atol=1e-16)
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-10, atol=1e-13)


def golden_eos():
    return ft.GcPcSaftMix(IDENT, parameter_tuple(PARAMETER), GOLDEN["segment_lists"],
                          GOLDEN["bond_lists"], [tuple(k) for k in GOLDEN["kab_list"]],
                          np.array(GOLDEN["phi"]), device="cpu")


def _golden_state():
    n = len(GOLDEN["labels"])
    return np.full(n, GOLDEN["temperature"]), np.tile(GOLDEN["density"], (n, 1))


def test_helmholtz_energy_density_golden():
    with torch.no_grad():
        a = golden_eos().helmholtz_energy_density(*_golden_state())
    np.testing.assert_allclose(a.numpy(), GOLDEN["a"], rtol=0, atol=1e-14)


@pytest.mark.parametrize("j,key,atol", [(0, "a", 1e-14), (1, "p", 1e-14), (2, "mu", 1e-13),
                                        (3, "v", 1e-11)], ids=["A", "p", "mu", "v"])
def test_derivatives_golden(j, key, atol):
    """A, p~, mu_i, v_i against the reference's values over the 11
    topologies, at the bars of tests/test_gc_pcsaft.py:57-73."""
    with torch.no_grad():
        out = golden_eos().derivatives(*_golden_state())
    np.testing.assert_allclose(out[j].numpy(), GOLDEN[key], rtol=0, atol=atol)


def test_derivatives_match_cpp_oracle(backend):
    """The independent C++ gc core over the 11 golden topologies, at the
    bars of tests/test_gc_pcsaft.py:130-146 (its mu is the total chemical
    potential)."""
    eos = golden_eos()
    temperature, rho = _golden_state()
    params = eos.params.detach()
    with torch.no_grad():
        a, p, mu, _ = gc.gc_derivatives(params, _t(temperature), _t(rho))
    phi_c, p_c, mu1_c, mu2_c = backend.gc_derivatives(params, temperature, rho)
    np.testing.assert_allclose(a.numpy(), phi_c, rtol=0, atol=1e-14)
    np.testing.assert_allclose(p.numpy(), p_c, rtol=0, atol=1e-14)
    np.testing.assert_allclose(mu.numpy() + np.log(rho), np.stack([mu1_c, mu2_c], 1),
                               rtol=0, atol=1e-13)


def test_reduces_to_homosegmented():
    """Molecules of m = 1 segments X bonded in a chain are homosegmented
    PC-SAFT chains of m = 2 and 3 (tests/test_gc_pcsaft.py:176-209), against
    the port's own mixture model."""
    x = np.array([[1.0, 3.5, 220.0, 0, 0, 0, 0, 0]])
    eos = ft.GcPcSaftMix(["X"], parameter_tuple(x), [[["X", "X"], ["X", "X", "X"]]],
                         [[[[0, 1]], [[0, 1], [1, 2]]]], [], None, device="cpu")
    t, rho = np.array([300.0]), np.array([[0.001, 0.002]])
    homo = _t([[[2.0, 3.5, 220.0, 0, 0, 0, 0, 0], [3.0, 3.5, 220.0, 0, 0, 0, 0, 0]]])
    with torch.no_grad():
        a_gc = eos.helmholtz_energy_density(t, rho)
        a_homo = ft.mix_helmholtz_energy_density(homo, None, _t(t), _t(rho))
    np.testing.assert_allclose(a_gc.numpy(), a_homo.numpy(), rtol=1e-13)


def test_stacked_states_match_rowwise():
    """A ``(B, k, n)`` density evaluates each of the k states with its row's
    parameters."""
    eos = golden_eos()
    temperature, rho = (_t(x) for x in _golden_state())
    with torch.no_grad():
        params = eos.params
        got = ft.gc_helmholtz_energy_density(params, temperature,
                                             torch.stack([rho, 0.5 * rho, 2.0 * rho], 1))
        for k, s in enumerate((1.0, 0.5, 2.0)):
            want = ft.gc_helmholtz_energy_density(params, temperature, s * rho)
            np.testing.assert_allclose(got[:, k].numpy(), want.numpy(), rtol=1e-14, atol=0)


def test_zero_epsilon_segment_gradients():
    """The golden topologies use >C< (epsilon_k = 0).  The port's
    gradients of sum(p~ + mu + v) in all segment parameters are finite, and
    zero for the segments no molecule uses; d/d epsilon_k of every other
    used segment equals central differences.  That of >C< leaves out the
    dispersion bases' sqrt(eps_a eps_c), whose one-sided derivative is
    infinite there, and keeps its finite terms (the diameter)."""
    eos = golden_eos()
    temperature, rho = (_t(x) for x in _golden_state())
    kab = eos.params.kab.detach()

    def loss(par):
        params = gc.assemble(eos.topology, par, kab, eos.phi.detach())
        _, p, mu, v = gc.gc_derivatives(params, temperature, rho)
        return p.sum() + mu.sum() + v.sum()

    par = eos.parameter.detach().clone().requires_grad_()
    (grad,) = torch.autograd.grad(loss(par), par)
    assert torch.isfinite(grad).all()
    zero = IDENT.index(">C<")
    used = [i for i, s in enumerate(IDENT)
            if i != zero and any(s in c for row in GOLDEN["segment_lists"] for c in row)]
    for i in used:
        h = 1e-5 * PARAMETER[i, 2]
        up, down = par.detach().clone(), par.detach().clone()
        up[i, 2] += h
        down[i, 2] -= h
        with torch.no_grad():
            fd = (loss(up) - loss(down)) / (2.0 * h)
        np.testing.assert_allclose(grad[i, 2].item(), fd.item(), rtol=1e-6, err_msg=IDENT[i])
    unused = [i for i, s in enumerate(IDENT)
              if not any(s in c for row in GOLDEN["segment_lists"] for c in row)]
    assert torch.all(grad[unused] == 0.0)


@pytest.fixture(scope="module")
def jacobians():
    return regime_jacobians(("none", "dipolar"), {"dipole"})


@pytest.mark.parametrize("j", range(len(OUTPUTS)), ids=OUTPUTS)
def test_parameter_gradients_match_jax(jacobians, j):
    """d(A, p~, mu, v)/d(segment parameters, k_ab, phi) against JAX's jacfwd
    on the 12 states without association, with and without dipoles."""
    assert_jacobians_match(*jacobians, j)
