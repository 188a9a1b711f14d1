"""Association in the port's n-component mixtures: the same mixture in any
component order.

The JAX package reads the cross and induced association terms from slots 0
and 1, so a ternary whose associating pair sits elsewhere gets the wrong
association, and three associating components silently get none.  The port
gathers each row's associating pair wherever it sits.  Held here:

* every permutation of the cross-associating ternaries of
  ``test_torch_multicomponent.py`` (config 3's pair and an inert; gc
  1-propanol, 1-propylamine and butane) gives the same bubble and dew
  pressures and incipient compositions within 1e-10 relative and the same
  gradients (parameters, or segment parameters, k_ab and phi) within 1e-9
  relative (1e-12 of the largest as a floor), and JAX's vendored values of
  its own slot order (p rtol 1e-8, compositions atol 1e-8);
* three associating components raise ``ValueError``;
* binaries, which now run through the same gather, give the values, masks
  and gradients of ``tests/golden/torch_binary_record.npz`` bit for bit
  (``tools/record_torch_binary_reference.py`` wrote it before the gather
  existed);
* the ternary pressure gradients in the parameters match ``jax.jacfwd`` of
  the f64 stationary identity at JAX's converged densities (vendored) at
  rtol 1e-8, and central differences on one row at rtol 1e-4.
"""

import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from test_torch_multicomponent import (
    CROSS, GC_CROSS, ROWS, _t, gc_model, gc_ternaries, reference, ternaries,
)

REPO = Path(__file__).resolve().parent.parent
RECORD = REPO / "tests" / "golden" / "torch_binary_record.npz"
PERMS = list(itertools.permutations(range(3)))
BUBBLE = {"bubble": True, "dew": False}


def assert_close_rows(got, want, rtol):
    """Entrywise within rtol, with a floor of 1e-12 of each row's largest
    entry for entries that cancel to near zero."""
    got, want = got.reshape(len(got), -1), want.reshape(len(want), -1)
    scale = np.abs(want).max(1, keepdims=True)
    worst = np.max(np.abs(got - want) / (rtol * np.abs(want) + 1e-12 * scale))
    assert worst <= 1.0, worst


@pytest.fixture(scope="module")
def ref():
    return reference()


@pytest.fixture(scope="module")
def permuted():
    """The cross-associating rows of ternaries() in every component order,
    one batch of 6 x ROWS rows: per direction the port's (p, nans,
    composition) and dp/dparams (the gradient of sum p), all mapped back to
    JAX's order [A, B, inert]."""
    params, temperature, z = (x[ROWS:] for x in ternaries())
    P = np.concatenate([params[:, list(pm)] for pm in PERMS])
    Z = np.concatenate([z[:, list(pm)] for pm in PERMS])
    T = np.tile(temperature, len(PERMS))
    inv = [np.argsort(pm) for pm in PERMS]
    out = {}
    for name, fn in (("bubble", ft.bubble_point), ("dew", ft.dew_point)):
        p_in = _t(P).requires_grad_()
        p, nans, comp = fn(p_in, None, _t(T), _t(Z), _t(np.full(len(T), 1e5)),
                           full_output=True)
        (grad,) = torch.autograd.grad(p.sum(), p_in)
        p, nans = p.detach().numpy(), nans.numpy()
        comp, grad = comp.numpy(), grad.numpy()
        k = len(PERMS)
        out[name] = (p.reshape(k, ROWS), nans.reshape(k, ROWS),
                     np.stack([c[:, i] for c, i in zip(comp.reshape(k, ROWS, 3), inv)]),
                     np.stack([g[:, i] for g, i in zip(grad.reshape(k, ROWS, 3, 8), inv)]))
    return out


@pytest.mark.parametrize("name", list(BUBBLE))
def test_mixture_permutation_invariance(permuted, name):
    p, nans, comp, grad = permuted[name]
    assert not nans.any()
    for k in range(1, len(PERMS)):
        np.testing.assert_allclose(p[k], p[0], rtol=1e-10, atol=0)
        np.testing.assert_allclose(comp[k], comp[0], rtol=1e-10, atol=0)
        assert_close_rows(grad[k], grad[0], 1e-9)


@pytest.mark.parametrize("name", list(BUBBLE))
def test_every_order_matches_jax_in_its_slot_order(permuted, ref, name):
    """JAX is right where the associating pair sits in slots 0 and 1: every
    order of the port matches it there."""
    p, _, comp, _ = permuted[name]
    for k in range(len(PERMS)):
        np.testing.assert_allclose(p[k], ref[f"mix_{name}_p"][ROWS:], rtol=1e-8, atol=0)
        np.testing.assert_allclose(comp[k], ref[f"mix_{name}_comp"][ROWS:], rtol=0, atol=1e-8)


@pytest.fixture(scope="module")
def gc_permuted():
    """The gc cross-associating rows in every molecule order, one model over
    6 x ROWS rows: per direction (p, nans, composition), and the gradients
    of each order's sum p in the segment parameters and k_ab (shared by the
    rows, one backward pass per order) and in phi (per row), in JAX's
    order."""
    _, temperature, z = (x[ROWS:] for x in gc_ternaries())
    rows = [[GC_CROSS[i] for i in pm] for pm in PERMS for _ in range(ROWS)]
    Z = np.concatenate([z[:, list(pm)] for pm in PERMS])
    T = np.tile(temperature, len(PERMS))
    inv = [np.argsort(pm) for pm in PERMS]
    eos = gc_model(rows)
    k = len(PERMS)
    out = {}
    for name in BUBBLE:
        fn = getattr(eos, f"{name}_point")
        p, nans, comp = fn(_t(T), _t(Z), _t(np.full(len(T), 1e5)), full_output=True)
        per_order = p.reshape(k, ROWS).sum(1)
        grads = [torch.autograd.grad(per_order[j], (eos.parameter, eos.kab, eos.phi),
                                     retain_graph=j < k - 1) for j in range(k)]
        phi = np.stack([g[2].numpy()[j * ROWS:(j + 1) * ROWS][:, inv[j]]
                        for j, g in enumerate(grads)])
        out[name] = (p.detach().numpy().reshape(k, ROWS), nans.numpy().reshape(k, ROWS),
                     np.stack([c[:, i]
                               for c, i in zip(comp.numpy().reshape(k, ROWS, 3), inv)]),
                     np.stack([g[0].numpy() for g in grads]),
                     np.stack([g[1].numpy() for g in grads]), phi)
    return out


@pytest.mark.parametrize("name", list(BUBBLE))
def test_gc_permutation_invariance(gc_permuted, name):
    p, nans, comp, g_par, g_kab, g_phi = gc_permuted[name]
    assert not nans.any()
    for k in range(1, len(PERMS)):
        np.testing.assert_allclose(p[k], p[0], rtol=1e-10, atol=0)
        np.testing.assert_allclose(comp[k], comp[0], rtol=1e-10, atol=0)
        for g in (g_par, g_kab, g_phi):
            assert_close_rows(g[k][None], g[0][None], 1e-9)


@pytest.mark.parametrize("name", list(BUBBLE))
def test_gc_every_order_matches_jax_in_its_slot_order(gc_permuted, ref, name):
    p, _, comp, *_ = gc_permuted[name]
    for k in range(len(PERMS)):
        np.testing.assert_allclose(p[k], ref[f"gc_{name}_p"][ROWS:], rtol=1e-8, atol=0)
        np.testing.assert_allclose(comp[k], ref[f"gc_{name}_comp"][ROWS:], rtol=0, atol=1e-8)


def test_three_associating_components_raise():
    """The JAX package drops association here; the port refuses."""
    params = _t([[CROSS[0], CROSS[1], CROSS[0]]])
    args = (_t([150.0]), _t([[0.3, 0.3, 0.4]]), _t([1e5]))
    with pytest.raises(ValueError, match="three or more associating"):
        ft.bubble_point(params, None, *args)
    with pytest.raises(ValueError, match="three or more associating"):
        ft.mix_derivatives(params, None, args[0], _t([[1e-3, 1e-3, 1e-3]]))
    with pytest.raises(ValueError, match="three or more associating"):
        gc_model([[GC_CROSS[0], GC_CROSS[1], GC_CROSS[0]]]).dew_point(*args)


@pytest.fixture(scope="module")
def record():
    sys.path.insert(0, str(REPO / "tools"))
    import record_torch_binary_reference as rec

    return rec, np.load(RECORD)


def _assert_recorded(got, want, prefix):
    for key, value in got.items():
        value = value.detach().numpy() if torch.is_tensor(value) else value
        np.testing.assert_array_equal(value, want[f"{prefix}{key}"], err_msg=key)


def test_binary_derivative_set_is_bit_identical(record):
    """Every binary regime's (A, p~, mu, v) and gradients in the parameters
    and kij."""
    rec, want = record
    got = rec.derivative_set(want["eos_params"], want["eos_kij"], want["eos_t"],
                             want["eos_rho"])
    _assert_recorded(got, want, "eos_")


@pytest.mark.parametrize("name", list(BUBBLE))
def test_binary_bubble_dew_are_bit_identical(record, name):
    """p, mask, composition, state and gradients of cross-, induced- and
    self-associating binaries."""
    rec, want = record
    fn = ft.bubble_point if BUBBLE[name] else ft.dew_point
    got = rec.incipient(fn, want["vle_params"], want["vle_kij"], want["vle_t"],
                        want["vle_x1"])
    _assert_recorded(got, want, f"{name}_")


def test_gc_binaries_are_bit_identical(record):
    """The 11 golden gc topologies (every regime), bubble and dew, with
    gradients in the segment parameters, k_ab and phi."""
    rec, want = record
    _assert_recorded(rec.gc_golden(), want, "")


@pytest.mark.parametrize("name", list(BUBBLE))
def test_pressure_gradients_match_jax_identity(ref, name):
    """dp/dparams of the non- and cross-associating ternaries against the
    vendored jacfwd of JAX's f64 identity at JAX's densities, rtol 1e-8
    (1e-12 of each row's largest as a floor); the identity there is the
    pressure."""
    params, temperature, z = ternaries()
    p_in = _t(params).requires_grad_()
    fn = ft.bubble_point if BUBBLE[name] else ft.dew_point
    p, nans = fn(p_in, None, _t(temperature), _t(z), _t(np.full(len(z), 1e5)))
    (grad,) = torch.autograd.grad(p.sum(), p_in)
    assert not nans.any()
    np.testing.assert_allclose(ref[f"jac_{name}_ident"], p.detach().numpy(), rtol=1e-8)
    assert_close_rows(grad.numpy(), ref[f"jac_{name}_params"], 1e-8)


def test_gradient_matches_central_differences():
    """dp_bubble/d(theta) of the first cross-associating row in the order
    [inert, A, B] against central differences (h = 1e-4 relative, rtol 1e-4,
    the bar of test_torch_gc_vle.py's k_ab and phi check) in sigma of the
    inert, epsilon_k of A, kappa_ab of A and epsilon_k_ab of B."""
    params, temperature, z = (x[ROWS] for x in ternaries())
    order = [2, 0, 1]
    base, z = params[order], z[order]
    entries = [(0, 1), (1, 2), (1, 4), (2, 5)]
    p_in = _t(base[None]).requires_grad_()
    p, nans = ft.bubble_point(p_in, None, _t([temperature]), _t(z[None]), _t([1e5]))
    (grad,) = torch.autograd.grad(p.sum(), p_in)
    rows = []
    for i, j in entries:
        for sign in (1.0, -1.0):
            q = base.copy()
            q[i, j] *= 1.0 + sign * 1e-4
            rows.append(q)
    n = len(rows)
    with torch.no_grad():
        p_fd, nans_fd = ft.bubble_point(_t(rows), None, _t(np.full(n, temperature)),
                                        _t(np.tile(z, (n, 1))), _t(np.full(n, 1e5)))
    assert not nans.any() and not nans_fd.any()
    p_fd = p_fd.numpy().reshape(-1, 2)
    h = np.array([2e-4 * base[i, j] for i, j in entries])
    fd = (p_fd[:, 0] - p_fd[:, 1]) / h
    got = np.array([grad.numpy()[0, i, j] for i, j in entries])
    np.testing.assert_allclose(got, fd, rtol=1e-4)
