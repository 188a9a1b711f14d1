"""The port's n-component mixture paths against the JAX package.

The ternaries below (shared with ``tools/gen_torch_multicomponent_reference.py``,
which writes JAX's values on them to ``tests/golden/torch_multicomponent_jax.npz``:
JAX compiles a ternary bubble solve for about a minute a regime set on a CPU):

* the non-associating ternary of ``tests/test_multicomponent.py`` at
  180-200 K;
* a cross-associating ternary: config 3's pair of ``benchmarks/run_all.py``
  and an inert component, at 140-160 K, in the JAX package's slot order
  [A, B, inert] (the JAX package reads association from slots 0 and 1);
* gc butane/propane/pentane at 230-250 K, and a gc cross-associating
  ternary [1-propanol, 1-propylamine, butane] at 320-340 K.

Compositions are seeded Dirichlet draws around a fixed feed.  The port's
bubble and dew pressures (p rtol 1e-8, the binary bar of
``test_torch_mix_jax_bubble.py``; incipient compositions atol 1e-8; equal
masks), bubble temperatures (rtol 1e-8), flash (``test_torch_flash.py``'s
bars) and mixture properties (1e-10) are held to JAX's vendored values, dew
and gc bubble temperatures at JAX's pressures return the rows' T (rtol
1e-8), the gc flash splits inside JAX's window by its own equilibrium
conditions, and the port is held to ``tests/test_multicomponent.py``'s
own checks: dew below bubble, the trace-dilution limit of the binary
(mixture and gc, rtol 1e-5), and kij and a scalar x1 rejected for n > 2.  Association under permutations of the
components is in ``test_torch_multicomponent_assoc.py``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft

HERE = Path(__file__).resolve().parent
REFERENCE = HERE / "golden" / "torch_multicomponent_jax.npz"

COMPS = [  # tests/test_multicomponent.py:20-24
    [1.0, 3.5, 150, 0, 0, 0, 0, 0],
    [1.6, 3.6, 180, 0, 0, 0, 0, 0],
    [2.3, 3.7, 222, 0, 0, 0, 0, 0],
]
ASSOC_A = [1, 3.5, 150, 0, 0.02, 1500, 1, 1]
ASSOC_B = [1, 3.5, 200, 0, 0.03, 2500, 1, 1]
INERT = [1, 3.5, 175, 0, 0, 0, 0, 0]
CROSS = [ASSOC_A, ASSOC_B, INERT]
ROWS = 4  # per system

BUTANE = (["CH3", "CH2", "CH2", "CH3"], [[0, 1], [1, 2], [2, 3]])
PROPANE = (["CH3", "CH2", "CH3"], [[0, 1], [1, 2]])
PENTANE = (["CH3", "CH2", "CH2", "CH2", "CH3"], [[0, 1], [1, 2], [2, 3], [3, 4]])
PROPANOL = (["CH3", "CH2", "CH2", "OH"], [[0, 1], [1, 2], [2, 3]])
PROPYLAMINE = (["CH3", "CH2", "CH2", "NH2"], [[0, 1], [1, 2], [2, 3]])
GC_NONASSOC = [BUTANE, PROPANE, PENTANE]
GC_CROSS = [PROPANOL, PROPYLAMINE, BUTANE]
GC_KAB = [("CH3", "CH2", -0.02)]
FLASH_ROWS = (1, 2)  # two non-associating rows


def _feeds(rng, z, n):
    return rng.dirichlet(30.0 * np.asarray(z), n)


def ternaries(seed=31, n=ROWS):
    """``(params (2n, 3, 8), T (2n,), z (2n, 3))``: n rows of the
    non-associating ternary, then n of the cross-associating one."""
    rng = np.random.default_rng(seed)
    params = np.concatenate([np.tile(COMPS, (n, 1, 1)), np.tile(CROSS, (n, 1, 1))])
    temperature = np.concatenate([np.linspace(180.0, 200.0, n), np.linspace(140.0, 160.0, n)])
    z = np.concatenate([_feeds(rng, [0.3, 0.3, 0.4], n), _feeds(rng, [0.4, 0.4, 0.2], n)])
    return params.astype(float), temperature, z


def gc_ternaries(seed=32, n=ROWS):
    """``(molecules, T (2n,), z (2n, 3))``: n rows of butane/propane/pentane,
    then n of the cross-associating gc ternary; ``molecules`` per row, each
    a list of three (segments, bonds)."""
    rng = np.random.default_rng(seed)
    molecules = [GC_NONASSOC] * n + [GC_CROSS] * n
    temperature = np.concatenate([np.linspace(230.0, 250.0, n), np.linspace(320.0, 340.0, n)])
    z = np.concatenate([_feeds(rng, [0.3, 0.3, 0.4], n), _feeds(rng, [0.4, 0.4, 0.2], n)])
    return molecules, temperature, z


def sauer2014():
    """The segment identifiers and the 8-tuple of segment columns."""
    segs = json.loads((HERE / "sauer2014_hetero.json").read_text())
    cols = ("m", "sigma", "epsilon_k", "mu", "kappa_ab", "epsilon_k_ab", "na", "nb")
    return ([r["identifier"] for r in segs],
            tuple(np.array([r["model_record"].get(c, 0.0) for r in segs]) for c in cols))


def gc_lists(molecules):
    """Per-row segment lists and bond lists of ``molecules``."""
    return ([[m[0] for m in row] for row in molecules],
            [[m[1] for m in row] for row in molecules])


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def reference():
    """JAX's vendored values, after checking that they were written for the
    inputs of this module."""
    ref = np.load(REFERENCE)
    params, temperature, z = ternaries()
    for key, x in (("mix_params", params), ("mix_t", temperature), ("mix_z", z)):
        np.testing.assert_array_equal(ref[key], x, err_msg=f"stale {key}")
    _, temperature, z = gc_ternaries()
    for key, x in (("gc_t", temperature), ("gc_z", z)):
        np.testing.assert_array_equal(ref[key], x, err_msg=f"stale {key}")
    return ref


def gc_model(molecules, device="cpu"):
    ident, parameter = sauer2014()
    segments, bonds = gc_lists(molecules)
    return ft.GcPcSaftMix(ident, parameter, segments, bonds, GC_KAB, None, device=device)


@pytest.fixture(scope="module")
def ref():
    return reference()


@pytest.fixture(scope="module")
def solved():
    """The port's (p, nans, composition, state) of each model and direction
    on the CPU, without gradients."""
    params, temperature, z = ternaries()
    molecules, gc_temperature, gc_z = gc_ternaries()
    eos = gc_model(molecules)
    out = {}
    with torch.no_grad():
        for name, fn in (("bubble", ft.bubble_point), ("dew", ft.dew_point)):
            out["mix", name] = [x.numpy() for x in fn(
                _t(params), None, _t(temperature), _t(z), _t(np.full(len(z), 1e5)),
                full_output=True, state_output=True)]
            out["gc", name] = [x.numpy() for x in getattr(eos, f"{name}_point")(
                _t(gc_temperature), _t(gc_z), _t(np.full(len(gc_z), 1e5)),
                full_output=True, state_output=True)]
    return out


CASES = [(m, d) for m in ("mix", "gc") for d in ("bubble", "dew")]


@pytest.mark.parametrize("model,name", CASES)
def test_masks_agree_with_jax(solved, ref, model, name):
    nans, ref_nans = solved[model, name][1], ref[f"{model}_{name}_nans"]
    assert int((nans != ref_nans).sum()) == 0
    assert not nans.any()


@pytest.mark.parametrize("model,name", CASES)
def test_pressures_match_jax(solved, ref, model, name):
    p = solved[model, name][0]
    np.testing.assert_allclose(p, ref[f"{model}_{name}_p"], rtol=1e-8, atol=0)


@pytest.mark.parametrize("model,name", CASES)
def test_incipient_compositions_match_jax(solved, ref, model, name):
    comp = solved[model, name][2]
    assert comp.shape == (2 * ROWS, 3)
    np.testing.assert_allclose(comp, ref[f"{model}_{name}_comp"], rtol=0, atol=1e-8)


@pytest.mark.parametrize("model", ["mix", "gc"])
def test_dew_below_bubble(solved, model):
    """tests/test_multicomponent.py::test_ternary_bubble_dew on every row."""
    assert np.all(solved[model, "dew"][0] < solved[model, "bubble"][0])


def test_bubble_temperature_matches_jax(ref):
    """bubble_point_t of the non-associating rows at JAX's bubble pressures,
    from 1.05 T: T against JAX's at rtol 1e-8, and the vapor composition."""
    params, temperature, z = (x[:ROWS] for x in ternaries())
    p = ref["mix_bubble_p"][:ROWS]
    with torch.no_grad():
        t, nans, y = ft.bubble_point_t(_t(params), None, _t(p), _t(z), _t(1.05 * temperature),
                                       full_output=True)
    assert not nans.numpy().any() and not ref["t_nans"].any()
    np.testing.assert_allclose(t.numpy(), ref["t_t"], rtol=1e-8, atol=0)
    np.testing.assert_allclose(y.numpy(), ref["t_comp"], rtol=0, atol=1e-8)


def test_dew_temperature_at_jax_dew_pressures(ref):
    """dew_point_t of the non-associating rows at JAX's dew pressures, from
    1.05 T, returns the rows' T (rtol 1e-8, the bar above) with the liquid
    composition JAX's dew point gives (atol 1e-8)."""
    params, temperature, z = (x[:ROWS] for x in ternaries())
    with torch.no_grad():
        t, nans, x = ft.dew_point_t(_t(params), None, _t(ref["mix_dew_p"][:ROWS]), _t(z),
                                    _t(1.05 * temperature), full_output=True)
    assert not nans.numpy().any()
    np.testing.assert_allclose(t.numpy(), temperature, rtol=1e-8, atol=0)
    np.testing.assert_allclose(x.numpy(), ref["mix_dew_comp"][:ROWS], rtol=0, atol=1e-8)


def test_gc_bubble_temperature_at_jax_bubble_pressures(ref):
    """The gc facade's bubble_point_t at JAX's gc bubble pressures of
    butane/propane/pentane returns the rows' T (rtol 1e-8) and JAX's vapor
    composition (atol 1e-8)."""
    molecules, temperature, z = (x[:ROWS] for x in gc_ternaries())
    with torch.no_grad():
        t, nans, y = gc_model(molecules).bubble_point_t(
            _t(ref["gc_bubble_p"][:ROWS]), _t(z), _t(1.05 * temperature), full_output=True)
    assert not nans.numpy().any()
    np.testing.assert_allclose(t.numpy(), temperature, rtol=1e-8, atol=0)
    np.testing.assert_allclose(y.numpy(), ref["gc_bubble_comp"][:ROWS], rtol=0, atol=1e-8)


def test_gc_flash_splits_inside_jax_window(ref):
    """gc_flash of two butane/propane/pentane rows at the log-midpoint of
    JAX's gc bubble and dew pressures splits both rows, with the material
    balance within 1e-9 and isofugacity through gc_properties within 1e-7
    (tests/test_flash.py's bars)."""
    rows = list(FLASH_ROWS)
    molecules, temperature, z = gc_ternaries()
    eos = gc_model([molecules[i] for i in rows])
    t, z = _t(temperature[rows]), _t(z[rows])
    p = _t(np.sqrt(ref["gc_bubble_p"][rows] * ref["gc_dew_p"][rows]))
    with torch.no_grad():
        beta, x, y, rho, phase = eos.flash(t, z, p)
        params = eos.params.detach()
        props_l = ft.gc_properties(params, t, x * rho[:, :1])
        props_v = ft.gc_properties(params, t, y * rho[:, 1:])
    assert bool((phase == 2).all())
    balance = beta[:, None] * y + (1.0 - beta[:, None]) * x
    np.testing.assert_allclose(balance.numpy(), z.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose((x * torch.exp(props_l.ln_phi)).numpy(),
                               (y * torch.exp(props_v.ln_phi)).numpy(), rtol=1e-7)


def test_flash_matches_jax(ref):
    """flash at the log-midpoint of JAX's bubble and dew pressures on two
    rows: equal phase codes, beta rtol 1e-6 / atol 1e-9, x and y atol
    1e-8, rho rtol 1e-8 (test_torch_flash.py's bars)."""
    rows = list(FLASH_ROWS)
    params, temperature, z = (x[rows] for x in ternaries())
    with torch.no_grad():
        beta, x, y, rho, phase = (o.numpy() for o in ft.flash(
            _t(params), None, _t(temperature), _t(z), _t(ref["flash_p"])))
    np.testing.assert_array_equal(phase, ref["flash_phase"])
    assert np.all(phase == 2)
    np.testing.assert_allclose(beta, ref["flash_beta"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(x, ref["flash_x"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(y, ref["flash_y"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(rho, ref["flash_rho"], rtol=1e-8)


@pytest.mark.parametrize("field", ft.ResidualProperties._fields)
def test_properties_match_jax(ref, field):
    """mix_properties at the liquid and the vapor of the first
    cross-associating bubble point, every field at 1e-10."""
    i = ROWS
    params, temperature, _ = ternaries()
    with torch.no_grad():
        props = ft.mix_properties(_t(np.stack([params[i]] * 2)), None,
                                  _t(np.full(2, temperature[i])), _t(ref["props_rho"]))
    np.testing.assert_allclose(getattr(props, field).numpy(), ref[f"props_{field}"],
                               rtol=1e-10, atol=0)


def test_trace_dilution_reduces_to_binary():
    """tests/test_multicomponent.py::test_ternary_reduces_to_binary_at_trace_dilution
    on the port: a vanishing third component gives the binary's bubble
    pressure at rtol 1e-5."""
    T = _t([180.0, 200.0])
    p0 = _t([1e5, 1e5])
    z_tr = _t(np.tile([0.4 - 5e-9, 0.6 - 5e-9, 1e-8], (2, 1)))
    with torch.no_grad():
        pb3, nb3 = ft.bubble_point(_t(np.tile(COMPS, (2, 1, 1))), None, T, z_tr, p0)
        pb2, nb2 = ft.bubble_point(_t(np.tile(COMPS[:2], (2, 1, 1))), None, T, _t([0.4, 0.4]),
                                   p0)
    assert not nb3.any() and not nb2.any()
    np.testing.assert_allclose(pb3.numpy(), pb2.numpy(), rtol=1e-5)


def test_gc_trace_dilution_reduces_to_binary():
    """tests/test_multicomponent.py::test_gc_ternary_bubble_dew_and_trace_dilution's
    limit on the port: butane/propane with trace pentane gives the binary."""
    T = _t([230.0, 250.0])
    p0 = _t([1e5, 1e5])
    z_tr = _t(np.tile([0.4 - 5e-9, 0.6 - 5e-9, 1e-8], (2, 1)))
    with torch.no_grad():
        pb3, nb3 = gc_model([GC_NONASSOC] * 2).bubble_point(T, z_tr, p0)
        pb2, nb2 = gc_model([GC_NONASSOC[:2]] * 2).bubble_point(T, _t([0.4, 0.4]), p0)
    assert not nb3.any() and not nb2.any()
    np.testing.assert_allclose(pb3.numpy(), pb2.numpy(), rtol=1e-5)


def test_kij_rejected_for_ternary():
    """tests/test_multicomponent.py::test_kij_rejected_for_ternary: the
    functional form and the facade."""
    args = (_t([180.0]), _t([[0.3, 0.3, 0.4]]), _t([1e5]))
    with pytest.raises(ValueError, match="binary"):
        ft.bubble_point(_t([COMPS]), _t([[0.0, 0.0]]), *args)
    with pytest.raises(ValueError, match="binary"):
        ft.PcSaftMix([COMPS], np.zeros((1, 2)), device="cpu")


def test_scalar_x1_rejected_for_ternary():
    """A (B,) composition is the binary x1 convention only."""
    with pytest.raises(ValueError, match="binary x1 convention"):
        ft.dew_point(_t([COMPS]), None, _t([180.0]), _t([0.3]), _t([1e5]))
    with pytest.raises(ValueError, match="binary x1 convention"):
        gc_model([GC_NONASSOC]).bubble_point(_t([230.0]), _t([0.3]), _t([1e5]))


def test_facade_takes_ternaries():
    """PcSaftMix holds no kij for n != 2 and solves (B, 3) compositions, as
    the functional form does."""
    params, temperature, z = (x[:2] for x in ternaries())
    eos = ft.PcSaftMix(params, device="cpu")
    assert eos.kij is None
    with torch.no_grad():
        p, nans = eos.bubble_point(temperature, z, np.full(2, 1e5))
        want, _ = ft.bubble_point(_t(params), None, _t(temperature), _t(z), _t([1e5, 1e5]))
    assert not nans.any()
    np.testing.assert_array_equal(p.numpy(), want.numpy())
