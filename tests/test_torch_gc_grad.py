"""The port's gc bubble and dew pressure gradients against the JAX package.

JAX's ``gc_incipient_property`` takes the partial molar volumes of its
gradient identity through an f32 closure, so its gradient is off by about
1e-7 relative.  The reference here is the same stationary identity built
from the JAX package's f64 pieces (``assemble``, ``precompute_gc``,
``phi_gc_pre``, ``pressure_set``) and differentiated by ``jacfwd`` at the
port's converged densities, in the ``(S, 8)`` segment parameters, the k_ab
values and phi, for config 4 of ``benchmarks/run_all.py`` (butane/propane)
and for cross-associating ethanol/ethylamine rows.

The port runs on the whole sauer2014 table.  JAX's epsilon_k derivatives
are NaN on any table that holds an epsilon_k = 0 segment (>C<), so the
reference runs on the table of the segments these molecules use, which
gives the same parameters; the port's gradients in every other segment
must be exactly zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from feos_tpu.models import gc_pcsaft as jgc
from feos_tpu.ops.derivatives import pressure_set as jpressure_set
from feos_tpu.units import REDUCED_TO_PA_PER_KT
from test_torch_gc_eos import IDENT, PARAMETER, assert_rows_close, parameter_tuple

BUBBLE = {"bubble": True, "dew": False}
USED = ["CH3", "CH2", "OH", "NH2"]
RECORDS = [("CH3", "CH2", -0.15), ("CH2", "OH", 0.02)]
# config 4 at four temperatures, then ethanol/ethylamine (cross association)
SEGMENTS = ([[["CH3", "CH2", "CH2", "CH3"], ["CH3", "CH2", "CH3"]]] * 4
            + [[["CH3", "CH2", "OH"], ["CH3", "CH2", "NH2"]]] * 2)
BONDS = ([[[[0, 1], [1, 2], [2, 3]], [[0, 1], [1, 2]]]] * 4
         + [[[[0, 1], [1, 2]], [[0, 1], [1, 2]]]] * 2)
PHI = np.array([[1.1, 0.98]] * 4 + [[1.0, 1.05]] * 2)
TEMPERATURE = np.array([140.0, 146.0, 153.0, 160.0, 300.0, 330.0])
X1 = np.array([0.5, 0.5, 0.5, 0.5, 0.4, 0.6])


def _identity(par, kv, phi, temperature, r_inc, r_bulk):
    """The bubble/dew identity in Pa at (r_inc, r_bulk), per row, on the
    table of the USED segments."""
    g = jgc.assemble(USED, parameter_tuple(par), SEGMENTS, BONDS,
                     [(a, b, k) for (a, b, _), k in zip(RECORDS, kv)], phi)
    br = frozenset({"cross"})

    def item(gi, t, ri, rb):
        pre = jgc.precompute_gc(gi, t)

        def phi_fn(x):
            return jgc.phi_gc_pre(pre, x, branches=br)

        _, p_b, g_b, v_b = jpressure_set(phi_fn, rb)
        rho_t = ri.sum()
        w = ri / rho_t
        v_bulk = (w * v_b).sum()
        g_bulk = (w * (jnp.log(ri) - (jnp.log(rb) + g_b))).sum()
        pt = -(phi_fn(ri) / rho_t + p_b * v_bulk + g_bulk - 1.0) / (1.0 / rho_t - v_bulk)
        return pt * t * REDUCED_TO_PA_PER_KT

    return jax.vmap(item, in_axes=(jgc._GC_BATCH_AXES, 0, 0, 0))(g, temperature, r_inc, r_bulk)


def _port(name):
    """The port's pressures, their per-row gradients in the segment
    parameters ``(B, S, 8)``, k_ab ``(B, R)`` and phi ``(B, B, 2)``, and the
    converged (rho_inc, rho_bulk) from the returned state."""
    eos = ft.GcPcSaftMix(IDENT, parameter_tuple(PARAMETER), SEGMENTS, BONDS, RECORDS, PHI,
                         device="cpu")
    fn = eos.bubble_point if BUBBLE[name] else eos.dew_point
    p, nans, state = fn(TEMPERATURE, X1, np.full(len(X1), 1e5), state_output=True)
    assert not nans.any()
    grads = [torch.autograd.grad(p[b], (eos.parameter, eos.kab, eos.phi), retain_graph=True)
             for b in range(len(p))]
    grads = [torch.stack(g).numpy() for g in zip(*grads)]
    state = state.numpy()
    z = np.stack([X1, 1.0 - X1], 1)
    return p.detach().numpy(), grads, np.exp(state[:, :2]), z * np.exp(state[:, 2:3])


@pytest.fixture(scope="module")
def solved():
    """Per direction, the port's (p, gradients) and the reference identity's
    value and Jacobians at the port's densities, in one jitted call."""
    port = {name: _port(name) for name in BUBBLE}
    rows = [port[name][2:] for name in BUBBLE]
    used = [IDENT.index(s) for s in USED]
    B = len(X1)

    def with_value(par, kv, phi, r_inc, r_bulk):
        out = jnp.concatenate([_identity(par, kv, phi, TEMPERATURE, r_inc[i * B:(i + 1) * B],
                                         r_bulk[i * B:(i + 1) * B]) for i in range(2)])
        return out, out

    ref = jax.jit(jax.jacfwd(with_value, argnums=(0, 1, 2), has_aux=True))
    (j_par, j_kab, j_phi), val = jax.tree_util.tree_map(np.asarray, ref(
        PARAMETER[used], np.array([k for *_, k in RECORDS]), PHI,
        np.concatenate([r[0] for r in rows]), np.concatenate([r[1] for r in rows])))
    return {name: (port[name][:2], (val[i * B:(i + 1) * B], j_par[i * B:(i + 1) * B],
                                    j_kab[i * B:(i + 1) * B], j_phi[i * B:(i + 1) * B]))
            for i, name in enumerate(BUBBLE)}, used


@pytest.mark.parametrize("name", list(BUBBLE))
def test_identity_value_is_the_pressure(solved, name):
    """The reference identity at the port's densities is the port's
    pressure, to the solve's tolerance."""
    (p, _), (val, *_) = solved[0][name]
    np.testing.assert_allclose(val, p, rtol=1e-8, atol=0)


@pytest.mark.parametrize("name", list(BUBBLE))
@pytest.mark.parametrize("wrt", ["segments", "kab", "phi"])
def test_pressure_gradients_match_jax_identity(solved, name, wrt):
    """dp/d(segment parameters, k_ab, phi) in Pa against jacfwd of the f64
    identity, row by row (rtol 1e-10 with a 1e-12 floor of each row's
    largest entry)."""
    ((_, grads), (_, j_par, j_kab, j_phi)), used = solved[0][name], solved[1]
    got = {"segments": grads[0][:, used], "kab": grads[1], "phi": grads[2]}[wrt]
    want = {"segments": j_par, "kab": j_kab, "phi": j_phi}[wrt]
    assert_rows_close(got, want)


@pytest.mark.parametrize("name", list(BUBBLE))
def test_unused_segments_have_zero_gradient(solved, name):
    (_, grads), used = solved[0][name][0], solved[1]
    unused = [i for i in range(len(IDENT)) if i not in used]
    assert np.all(grads[0][:, unused] == 0.0)
