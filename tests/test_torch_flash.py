"""The port's isothermal pT flash against the JAX package's.

``_rachford_rice``, ``flash_window`` and ``flash_resid`` (on the
cross-associating row of tests/test_flash.py with its eps_AiBj override)
and the mask helpers go through both packages live, in one jitted JAX
function.  JAX's ``flash`` and ``gc_flash`` take minutes to compile on a
CPU, so their outputs on tests/test_flash.py's six binary rows and its three
gc rows, each at five pressures (mid-window, log-blends 0.999 toward either
edge, 1.2 p_bubble, 0.8 p_dew), are read from
tests/golden/torch_flash_jax.npz (``tools/gen_torch_flash_reference.py``).
The port runs every pressure of a model in one call and must give JAX's
phase codes, with beta within rtol 1e-6 / atol 1e-9, x and y within atol
1e-8 and rho within rtol 1e-8 (tests/test_fuzz_oracle.py's flash bars).
Then tests/test_flash.py's own checks run on the port: material balance,
isobaric closure and isofugacity through the port's ``mix_properties`` /
``gc_properties``, the edge limits, the single-phase classification, and
the facade against the function.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from feos_tpu.models import pcsaft_mix as jmix
from feos_tpu.solvers import flash as jflash
from feos_tpu.units import REDUCED_TO_PA_PER_KT
from feos_tpu.utils import masking as jmask
from feos_tpu_torch.models.pcsaft_mix import _pre, phi_mix_pre
from feos_tpu_torch.solvers import flash as tflash
from feos_tpu_torch.solvers.vle import _val_and_jac
from feos_tpu_torch.utils import masking as tmask
from test_torch_gc_eos import IDENT, PARAMETER, parameter_tuple

GOLDEN = dict(np.load(Path(__file__).resolve().parent / "golden" / "torch_flash_jax.npz"))
KINDS = ("mid", "bubble_edge", "dew_edge", "liquid", "vapor")
GC_SEGMENTS = [["CH3", "CH2", "CH2", "CH3"], ["CH3", "CH2", "CH3"]]
GC_BONDS = [[[0, 1], [1, 2], [2, 3]], [[0, 1], [1, 2]]]
ASSOC_ROW = 2  # the cross-associating row of tests/test_flash.py


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def gc_model(rows):
    """tests/test_flash.py::test_gc_flash's butane/propane on ``rows`` rows."""
    return ft.GcPcSaftMix(IDENT, parameter_tuple(PARAMETER), [GC_SEGMENTS] * rows,
                          [GC_BONDS] * rows, [], None, device="cpu")


def tiled(model, key):
    """The model's golden inputs with the five pressures stacked into one
    batch, and the port's flash of them reshaped to (5, B, ...)."""
    k, b = GOLDEN[f"{key}_p"].shape
    t, z1 = np.tile(GOLDEN[f"{key}_t"], k), np.tile(GOLDEN[f"{key}_z1"], k)
    with torch.no_grad():
        out = model.flash(t, z1, GOLDEN[f"{key}_p"].reshape(-1))
    return [o.numpy().reshape((k, b) + tuple(o.shape[1:])) for o in out]


@pytest.fixture(scope="module")
def mix():
    k = len(KINDS)
    model = ft.PcSaftMix(np.tile(GOLDEN["mix_params"], (k, 1, 1)),
                         np.tile(GOLDEN["mix_kij"], (k, 1)), device="cpu")
    return tiled(model, "mix")


@pytest.fixture(scope="module")
def gc():
    return tiled(gc_model(3 * len(KINDS)), "gc")


def held_to_jax(port, key, i):
    """Pressure kind ``i`` of the port's outputs against JAX's: equal phase
    codes and NaN patterns, the flash bars on two-phase rows, exact
    single-phase rows."""
    beta, x, y, rho, phase = (o[i] for o in port)
    ref = [GOLDEN[f"{key}_{name}"][i] for name in ("beta", "x", "y", "rho", "phase")]
    np.testing.assert_array_equal(phase, ref[4])
    for got, want in zip((beta, x, y, rho), ref):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    two = phase == 2
    np.testing.assert_allclose(beta[two], ref[0][two], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(x[two], ref[1][two], rtol=0, atol=1e-8)
    np.testing.assert_allclose(y[two], ref[2][two], rtol=0, atol=1e-8)
    np.testing.assert_allclose(rho[two], ref[3][two], rtol=1e-8)
    np.testing.assert_array_equal(beta[~two], ref[0][~two])
    np.testing.assert_array_equal(x[~two], ref[1][~two])
    np.testing.assert_array_equal(y[~two], ref[2][~two])


@pytest.mark.parametrize("i", range(len(KINDS)), ids=KINDS)
def test_flash_matches_jax(mix, i):
    held_to_jax(mix, "mix", i)


@pytest.mark.parametrize("i", range(len(KINDS)), ids=KINDS)
def test_gc_flash_matches_jax(gc, i):
    held_to_jax(gc, "gc", i)


def window_inputs():
    """Seeded edge solutions over every window case: inside, on and outside
    either edge, the degenerate p = p_bubble = p_dew, failed edges."""
    rng = np.random.default_rng(7)
    B = 12
    z1 = rng.uniform(0.1, 0.9, B)
    z = np.stack([z1, 1.0 - z1], 1)
    p_bub = rng.uniform(2e5, 5e5, B)
    p_dew = p_bub * rng.uniform(0.1, 0.9, B)
    y1 = np.clip(z1 * rng.uniform(1.1, 1.6, B), 0.0, 0.99)
    x1 = z1 * rng.uniform(0.4, 0.9, B)
    p = np.sqrt(p_bub * p_dew) * rng.uniform(0.9, 1.1, B)
    p[1], p[2], p[3], p[4] = p_bub[1], p_dew[2], 1.5 * p_bub[3], 0.5 * p_dew[4]
    p_dew[5] = p_bub[5] = p[5]
    nan_b = np.zeros(B, bool)
    nan_d = np.zeros(B, bool)
    nan_b[6], nan_d[7], nan_b[8], nan_d[8] = True, True, True, True
    p[7] = 0.5 * p_dew[7]
    # the flash core's outputs on every row, as a stub returns them
    beta = rng.uniform(0.1, 0.9, B)
    xs = np.stack([x1, 1.0 - x1], 1)
    ys = np.stack([y1, 1.0 - y1], 1)
    lnr = np.log(np.stack([rng.uniform(0.01, 0.02, B), rng.uniform(1e-5, 1e-4, B)], 1))
    ok = rng.random(B) < 0.8
    return (z, p, p_bub, nan_b, np.stack([y1, 1.0 - y1], 1), p_dew, nan_d,
            np.stack([x1, 1.0 - x1], 1)), (beta, xs, ys, lnr, ok)


def resid_state():
    """The cross-associating row at its mid-window split (JAX's), perturbed
    off the root so that every residual is nonzero."""
    i, n = ASSOC_ROW, 2
    x, y = GOLDEN["mix_x"][0, i], GOLDEN["mix_y"][0, i]
    lnr = np.log(GOLDEN["mix_rho"][0, i])
    v = np.concatenate([np.log(x) + lnr[0], np.log(y) + lnr[1], [GOLDEN["mix_beta"][0, i]]])
    v = v[None] + np.random.default_rng(3).normal(0.0, 1e-3, (4, 2 * n + 1))
    p_red = GOLDEN["mix_p"][0, i] / (GOLDEN["mix_t"][i] * REDUCED_TO_PA_PER_KT)
    z = np.array([GOLDEN["mix_z1"][i], 1.0 - GOLDEN["mix_z1"][i]])
    return (np.tile(GOLDEN["mix_params"][i], (4, 1, 1)), np.tile(GOLDEN["mix_kij"][i], (4, 1)),
            np.full(4, GOLDEN["mix_t"][i]), np.tile(z, (4, 1)), np.full(4, p_red), v)


@pytest.fixture(scope="module")
def jax_live():
    """Rachford-Rice, the window, the residual with its Jacobian and the
    masked reductions from JAX, in one jitted function."""
    rng = np.random.default_rng(11)
    z = rng.dirichlet(np.ones(3), 16)
    K = np.exp(rng.normal(0.0, 1.5, (16, 3)))
    beta0 = rng.uniform(-0.2, 1.2, 16)
    win, core = window_inputs()
    res = resid_state()
    br = jmix.static_branches(res[0])
    vals = rng.normal(size=16)
    nans = rng.random(16) < 0.3

    def resid(params, kij, t, zz, pr, v):
        def item(pi, ki, ei, ti, zi, pri, vi):
            pre = jmix.precompute_mix(pi, ki, ei, ti)
            return jflash.flash_resid(lambda r: jmix.phi_mix_pre(pre, r, branches=br),
                                      zi, pri, vi)
        return jax.vmap(item)(jmix.MixParams.from_array(params), kij[:, 0], kij[:, 1], t, zz,
                              pr, v)

    @jax.jit
    def run(z, K, beta0, win, core, res, vals, nans):
        seen = {}

        def stub(lnk0, w, active):
            seen.update(lnk0=lnk0, w=w, active=active)
            return core

        packed = jflash.flash_window(*win, stub)
        F = resid(*res)
        J = jax.jacfwd(lambda v: resid(*res[:5], v))(res[5])
        J = jnp.stack([J[b, :, b, :] for b in range(J.shape[0])])
        return (jax.vmap(jflash._rachford_rice)(z, K, beta0), packed, seen, F, J,
                jmask.masked_mean(vals, nans), jmask.masked_sum(vals, nans))

    out = run(z, K, beta0, win, core, res, vals, nans)
    inputs = {"rr": (z, K, beta0), "window": (win, core), "resid": res, "mask": (vals, nans)}
    return inputs, jax.tree_util.tree_map(np.asarray, out)


def test_rachford_rice_matches_jax(jax_live):
    inputs, (rr, *_) = jax_live
    got = tflash._rachford_rice(*(_t(a) for a in inputs["rr"]))
    np.testing.assert_allclose(got.numpy(), rr, rtol=1e-14, atol=1e-15)


def test_flash_window_matches_jax(jax_live):
    """Outputs, phase codes and the core's (ln K0, beta0, active) equal to
    JAX's on every window case."""
    inputs, (_, packed, seen, *_) = jax_live
    win, core = inputs["window"]
    got = {}

    def stub(lnk0, w, active):
        got.update(lnk0=lnk0, w=w, active=active)
        return tuple(torch.as_tensor(a) for a in core)

    win_t = [torch.as_tensor(a) for a in win]
    out = tflash.flash_window(*win_t, stub)
    assert out[4].dtype == torch.int8
    for a, b in zip(out, packed):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-15, atol=0)
    for key in ("lnk0", "w"):
        np.testing.assert_allclose(got[key].numpy(), seen[key], rtol=1e-15, atol=1e-16)
    np.testing.assert_array_equal(got["active"].numpy(), seen["active"])
    assert set(out[4].tolist()) == {-1, 0, 1, 2}


def test_flash_resid_matches_jax(jax_live):
    """F and dF/dv at the cross-associating row, exact phi."""
    inputs, (_, _, _, F, J, *_) = jax_live
    params, kij, t, z, p_red, v = (_t(a) for a in inputs["resid"])
    pre = _pre(params, kij, t)

    def resid(vv):
        return tflash.flash_resid(lambda r: phi_mix_pre(pre, r), z, p_red, vv)

    got_f, got_j = _val_and_jac(resid, v)
    np.testing.assert_allclose(got_f.numpy(), F, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(got_j.numpy(), J, rtol=1e-9, atol=1e-11)


def test_masking_matches_jax(jax_live):
    inputs, (*_, mean, total) = jax_live
    vals, nans = inputs["mask"]
    v, m = _t(vals), torch.as_tensor(nans)
    np.testing.assert_allclose(tmask.masked_mean(v, m).numpy(), mean, rtol=1e-15)
    np.testing.assert_allclose(tmask.masked_sum(v, m).numpy(), total, rtol=1e-15)
    for got, want in zip(tmask.compact(m, v, _t(vals * 2)),
                         jmask.compact(nans, vals, vals * 2)):
        np.testing.assert_array_equal(got.numpy(), want)
    # a NaN on a failed row reaches neither the value nor the gradient
    v = _t(np.where(nans, np.nan, vals)).requires_grad_()
    tmask.masked_mean(v, m).backward()
    assert torch.isfinite(v.grad).all() and (v.grad[m] == 0).all()


def mix_consistency(p, beta, x, y, rho, rtol_fug=1e-7):
    """tests/test_flash.py::_check_consistency through the port's
    mix_properties, with its bars."""
    t, z1 = GOLDEN["mix_t"], GOLDEN["mix_z1"]
    params, kij = _t(GOLDEN["mix_params"]), _t(GOLDEN["mix_kij"])
    z = np.stack([z1, 1.0 - z1], axis=-1)
    recon = beta[:, None] * y + (1.0 - beta[:, None]) * x
    np.testing.assert_allclose(recon, z, rtol=0, atol=1e-9)
    with torch.no_grad():
        props_l = ft.mix_properties(params, kij, _t(t), _t(x * rho[:, :1]))
        props_v = ft.mix_properties(params, kij, _t(t), _t(y * rho[:, 1:]))
    noise_pa = 2e-14 * t * REDUCED_TO_PA_PER_KT
    assert np.all(np.abs(props_l.pressure.numpy() - p) < 1e-8 * p + noise_pa)
    np.testing.assert_allclose(props_v.pressure.numpy(), p, rtol=1e-8)
    f_l = x * np.exp(props_l.ln_phi.numpy())
    f_v = y * np.exp(props_v.ln_phi.numpy())
    bar = (rtol_fug + noise_pa / p)[:, None]
    assert np.all(np.abs(f_l - f_v) <= bar * np.abs(f_v)), (np.abs(f_l / f_v - 1.0), bar)


@pytest.mark.parametrize("i", range(3), ids=KINDS[:3])
def test_two_phase_consistency(mix, i):
    beta, x, y, rho, phase = (o[i] for o in mix)
    assert np.all(phase == 2)
    assert np.all((beta > 0.0) & (beta < 1.0)) and np.all(rho[:, 0] > rho[:, 1])
    mix_consistency(GOLDEN["mix_p"][i], beta, x, y, rho)


def test_edge_limits(mix):
    """p -> p_bubble: beta -> 0, x -> z, y -> the bubble solve's incipient
    vapor; p -> p_dew: beta -> 1, y -> z, x -> the dew solve's liquid."""
    z = np.stack([GOLDEN["mix_z1"], 1.0 - GOLDEN["mix_z1"]], -1)
    with torch.no_grad():
        args = (_t(GOLDEN["mix_params"]), _t(GOLDEN["mix_kij"]), _t(GOLDEN["mix_t"]),
                _t(GOLDEN["mix_z1"]), _t(np.full(6, 1e5)))
        _, _, y_bub = ft.bubble_point(*args, full_output=True)
        _, _, x_dew = ft.dew_point(*args, full_output=True)
    beta, x, y = (o[1] for o in mix[:3])
    assert np.all(beta < 0.02)
    np.testing.assert_allclose(x, z, atol=5e-3)
    np.testing.assert_allclose(y, y_bub.numpy(), atol=5e-3)
    beta, x, y = (o[2] for o in mix[:3])
    assert np.all(beta > 0.98)
    np.testing.assert_allclose(y, z, atol=5e-3)
    np.testing.assert_allclose(x, x_dew.numpy(), atol=5e-3)


def test_single_phase_classification(mix):
    z = np.stack([GOLDEN["mix_z1"], 1.0 - GOLDEN["mix_z1"]], -1)
    beta, x, y, rho, phase = (o[3] for o in mix)
    assert np.all(phase == 0) and np.all(beta == 0.0) and np.all(x == z)
    assert np.isnan(y).all() and np.isnan(rho).all()
    beta, x, y, rho, phase = (o[4] for o in mix)
    assert np.all(phase == 1) and np.all(beta == 1.0) and np.all(y == z)
    assert np.isnan(x).all() and np.isnan(rho).all()


def test_gc_consistency(gc):
    """tests/test_flash.py::test_gc_flash on the port: material balance,
    the vapor lean in n-butane, p and fugacities through gc_properties."""
    beta, x, y, rho, phase = (o[0] for o in gc)
    p, t, z1 = GOLDEN["gc_p"][0], GOLDEN["gc_t"], GOLDEN["gc_z1"]
    assert np.all(phase == 2)
    z = np.stack([z1, 1.0 - z1], axis=-1)
    np.testing.assert_allclose(beta[:, None] * y + (1.0 - beta[:, None]) * x, z, rtol=0,
                               atol=1e-9)
    assert np.all(y[:, 0] < x[:, 0])
    with torch.no_grad():
        params = gc_model(3).params
        props_l = ft.gc_properties(params, _t(t), _t(x * rho[:, :1]))
        props_v = ft.gc_properties(params, _t(t), _t(y * rho[:, 1:]))
    np.testing.assert_allclose(props_l.pressure.numpy(), p, rtol=1e-8)
    np.testing.assert_allclose(props_v.pressure.numpy(), p, rtol=1e-8)
    np.testing.assert_allclose(x * np.exp(props_l.ln_phi.numpy()),
                               y * np.exp(props_v.ln_phi.numpy()), rtol=1e-7)


def test_functional_matches_facade(mix):
    """``flash`` on the facade's tensors gives the facade's outputs, bit for
    bit, and the tiled call's phase codes and values (within the flash bars:
    a batch's NPT loops stop together) on the mid-window rows."""
    model = ft.PcSaftMix(GOLDEN["mix_params"], GOLDEN["mix_kij"], device="cpu")
    args = (GOLDEN["mix_t"], GOLDEN["mix_z1"], GOLDEN["mix_p"][0])
    with torch.no_grad():
        out_m = model.flash(*args)
        out_f = ft.flash(_t(GOLDEN["mix_params"]), _t(GOLDEN["mix_kij"]), *(_t(a) for a in args))
    for a, b in zip(out_f, out_m):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    beta, x, y, rho, phase = (o.numpy() for o in out_f)
    np.testing.assert_array_equal(phase, mix[4][0])
    np.testing.assert_allclose(beta, mix[0][0], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(x, mix[1][0], rtol=0, atol=1e-8)
    np.testing.assert_allclose(y, mix[2][0], rtol=0, atol=1e-8)
    np.testing.assert_allclose(rho, mix[3][0], rtol=1e-8)
