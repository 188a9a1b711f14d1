"""Implicit-function gradients of the port's flash (``gradients=True``).

The checks of tests/_flash_grad_checks.py, run on the port, on its two-row
system (a non-associating pair with kij, the cross-associating pair with
its eps_AiBj override) at JAX's mid-window pressures:

* the binary phase rule: at fixed (T, p) x, y and rho do not depend on the
  feed, and the lever rule gives dbeta/dz1 = 1/(y1 - x1) (rtol 1e-6,
  atol 1e-6);
* central finite differences of the detached solve in kij (h 1e-6),
  epsilon_k (h 1e-4), p (1e-6 relative) and T (h 1e-4), at rtol 2e-4 and
  atol 2e-9 (T: 2e-8), and dbeta/dp < 0;
* ``gradients=True`` leaves every output bit-identical;
* JAX's own ``gradients=True`` Jacobians on these rows, vendored in
  tests/golden/torch_flash_jax.npz by tools/gen_torch_flash_reference.py
  (JAX needs minutes to compile them): every entry within 1e-8 relative,
  with a floor of 1e-12 of the largest entry of its output, but the phase
  rule's zeros, which are rounding noise in both packages;
* the gc path (tests/test_flash.py's butane/propane): the lever rule and
  the finite difference in p (atol 1e-12);
* failed rows (a supercritical row, and a converged row marked failed)
  take zero, finite gradients.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from _flash_grad_checks import KIJ, PARAMS, T, Z1
from feos_tpu_torch.models.pcsaft_mix import _pre, phi_mix_pre
from feos_tpu_torch.solvers.flash import flash_resid, reattach_flash
from feos_tpu_torch.units import PA_PER_KT_TO_REDUCED
from test_torch_flash import gc_model

GOLDEN = dict(np.load(Path(__file__).resolve().parent / "golden" / "torch_flash_jax.npz"))
MIDP = GOLDEN["grad_p"]
B = len(T)


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def stacked(beta, x, y, rho):
    return torch.cat([beta[:, None], x, y, rho], 1)


@pytest.fixture(scope="module")
def jac():
    """The port's outputs (B, 7) at MIDP with gradients, the same call
    without, and the per-row Jacobian (B, 7, 21) in [kij (2), parameters
    (2 x 8), p, T, x1]."""
    inputs = [_t(a).requires_grad_() for a in (KIJ, PARAMS, MIDP, T, Z1)]
    kij, params, p, t, z1 = inputs
    beta, x, y, rho, phase = ft.flash(params, kij, t, z1, p, gradients=True)
    outs = stacked(beta, x, y, rho)
    rows = []
    for j in range(outs.shape[1]):
        g = torch.autograd.grad(outs[:, j].sum(), inputs, retain_graph=True)
        rows.append(torch.cat([g[0], g[1].reshape(B, -1), g[2][:, None], g[3][:, None],
                               g[4][:, None]], 1))
    detached = ft.flash(*(x.detach() for x in (params, kij, t, z1, p)))
    return (outs.detach(), phase), detached, torch.stack(rows, 1).numpy()


def test_primals_unchanged_by_gradients(jac):
    (outs, phase), detached, _ = jac
    assert (phase == 2).all()
    assert torch.equal(phase, detached[4])
    assert torch.equal(outs, stacked(*detached[:4]))


def test_phase_rule_anchors(jac):
    (outs, _), _, J = jac
    x1, y1 = outs[:, 1].numpy(), outs[:, 3].numpy()
    np.testing.assert_allclose(J[:, 0, -1], 1.0 / (y1 - x1), rtol=1e-6)
    np.testing.assert_allclose(J[:, 1:, -1], 0.0, atol=1e-6)


def test_jacobian_matches_jax(jac):
    """Every entry within 1e-8 relative plus 1e-12 of its output's largest,
    but the phase rule's zeros (d{x, y, rho}/dz1), rounding noise in both
    packages: those are within 1e-11 of their output's largest on both."""
    (outs, _), _, J = jac
    ref = GOLDEN["grad_jacobian"]
    np.testing.assert_allclose(outs.numpy(), GOLDEN["grad_values"], rtol=1e-8, atol=1e-9)
    scale = np.abs(ref).max(-1, keepdims=True)
    zero = np.zeros(ref.shape, bool)
    zero[:, 1:, -1] = True
    err = np.abs(J - ref)
    ok = err <= 1e-8 * np.abs(ref) + 1e-12 * scale
    assert ok[~zero].all(), (err / (np.abs(ref) + 1e-12 * scale))[~zero].max()
    assert (np.abs(J) <= 1e-11 * scale)[zero].all() and (np.abs(ref) <= 1e-11 * scale)[zero].all()


def fd_rows():
    """The cases ``(label, Jacobian column, step)`` and the detached inputs
    of their + and - rows, stacked in one batch in that order."""
    h_p = 1e-6 * MIDP
    cases = [("kij", 0, 1e-6), ("epsilon_k", 4, 1e-4), ("pressure", 18, h_p),
             ("temperature", 19, 1e-4)]
    kij, params, p, t = [], [], [], []
    for _, col, h in cases:
        for sign in (1.0, -1.0):
            k_, q_, p_, t_ = KIJ.copy(), PARAMS.copy(), MIDP.copy(), T.copy()
            if col < 2:
                k_[:, col] += sign * h
            elif col < 18:
                q_.reshape(B, -1)[:, col - 2] += sign * h
            elif col == 18:
                p_ = p_ + sign * h
            else:
                t_ = t_ + sign * h
            kij.append(k_)
            params.append(q_)
            p.append(p_)
            t.append(t_)
    return cases, [np.concatenate(a) for a in (kij, params, p, t)]


@pytest.fixture(scope="module")
def fd():
    cases, (kij, params, p, t) = fd_rows()
    with torch.no_grad():
        out = ft.flash(_t(params), _t(kij), _t(t), _t(np.tile(Z1, 2 * len(cases))), _t(p))
    assert (out[4] == 2).all()
    outs = stacked(*out[:4]).numpy().reshape(len(cases), 2, B, -1)
    return {label: (col, h, outs[i]) for i, (label, col, h) in enumerate(cases)}


@pytest.mark.parametrize("label", ["kij", "epsilon_k", "pressure", "temperature"])
def test_finite_differences(jac, fd, label):
    _, _, J = jac
    col, h, (hi, lo) = fd[label]
    h = np.broadcast_to(h, (B,))[:, None]
    atol = 2e-8 if label == "temperature" else 2e-9
    np.testing.assert_allclose(J[:, :, col], (hi - lo) / (2 * h), rtol=2e-4, atol=atol)
    if label == "pressure":
        assert (J[:, 0, col] < 0.0).all()  # more liquid at higher pressure


def test_gc_gradients():
    """Lever rule and dx/dz1 = dy/dz1 = drho/dz1 = 0, and the central
    difference in p (rtol 2e-4, atol 1e-12), on the gc rows at their
    mid-window pressures."""
    p_mid = GOLDEN["gc_p"][0]
    t, z1_np = GOLDEN["gc_t"], GOLDEN["gc_z1"]
    model = gc_model(3)
    z1 = _t(z1_np).requires_grad_()
    p = _t(p_mid).requires_grad_()
    beta, x, y, rho, phase = model.flash(t, z1, p, gradients=True)
    assert (phase == 2).all()
    outs = stacked(beta, x, y, rho)
    dz, dp = zip(*(torch.autograd.grad(outs[:, j].sum(), (z1, p), retain_graph=True)
                   for j in range(outs.shape[1])))
    dz, dp = torch.stack(dz, 1).numpy(), torch.stack(dp, 1).numpy()
    xy = outs.detach().numpy()
    np.testing.assert_allclose(dz[:, 0], 1.0 / (xy[:, 3] - xy[:, 1]), rtol=1e-6)
    np.testing.assert_allclose(dz[:, 1:], 0.0, atol=1e-6)

    h = 1e-6 * p_mid
    with torch.no_grad():
        out = gc_model(6).flash(np.tile(t, 2), np.tile(z1_np, 2),
                                np.concatenate([p_mid + h, p_mid - h]))
    assert (out[4] == 2).all()
    hi, lo = stacked(*out[:4]).numpy().reshape(2, 3, -1)
    np.testing.assert_allclose(dp, (hi - lo) / (2 * h[:, None]), rtol=2e-4, atol=1e-12)


def test_failed_rows_take_zero_gradients():
    """A supercritical row (no window: phase -1) among converged ones, and a
    converged row that the re-attachment is told failed: zero, finite
    gradients there, nonzero on the others."""
    params = _t(np.concatenate([PARAMS, PARAMS[:1]])).requires_grad_()
    kij = _t(np.concatenate([KIJ, KIJ[:1]])).requires_grad_()
    t = _t(np.concatenate([T, [400.0]]))
    beta, x, y, rho, phase = ft.flash(params, kij, t, _t(np.append(Z1, 0.4)),
                                      _t(np.append(MIDP, 1e5)), gradients=True)
    assert phase.tolist() == [2, 2, -1]
    two = phase == 2
    loss = ft.utils.masked_sum(beta + x[:, 0] + torch.log(rho[:, 0]), ~two)
    loss.backward()
    for g in (params.grad, kij.grad):
        assert torch.isfinite(g).all()
        assert (g[2] == 0).all() and (g[:2].abs().sum() > 0)

    # the re-attachment itself: row 1 marked failed is parked, gradient 0
    params = _t(PARAMS).requires_grad_()
    with torch.no_grad():
        beta, x, y, rho, _ = ft.flash(params, _t(KIJ), _t(T), _t(Z1), _t(MIDP))
    pre = _pre(params, _t(KIJ), _t(T))
    z = _t(np.stack([Z1, 1.0 - Z1], 1))
    p_red = _t(MIDP / T * PA_PER_KT_TO_REDUCED)
    ok = torch.tensor([True, False])
    out = reattach_flash(lambda v: flash_resid(lambda r: phi_mix_pre(pre, r), z, p_red, v),
                         beta, x, y, torch.log(rho), ok)
    stacked(*out).sum().backward()
    assert torch.isfinite(params.grad).all()
    assert (params.grad[1] == 0).all() and params.grad[0].abs().sum() > 0
    for got, want in zip(out, (beta, x, y, torch.log(rho))):
        assert torch.equal(got[0].detach(), want[0])
