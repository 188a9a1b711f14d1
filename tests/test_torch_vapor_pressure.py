"""The port's main path as a whole: vapor pressures and parameter gradients.

README anchors, JAX ``value_and_grad(vapor_pressure)`` on a seeded batch
(one jit of one fixed shape, which compiles for about 15 s on a CPU:
``tools/gen_port_fixtures.py`` writes its values, with the port's densities
it was taken at, to ``tests/golden/torch_vapor_pressure_jax.npz``), central
finite differences, and the failure mask.  Everything runs on CPU tensors,
where ``phi_d2`` takes its plain version.
"""

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from _torch_golden import vendored

README_PARAMS = [1.5, 3.5, 250.0, 0.0, 0.03, 1500.0, 1.0, 1.0]
README_T = [250.0, 300.0, 350.0, 400.0, 450.0]
README_VP = [20693.5960, 216164.6184, 1049770.6187, 3281855.9640, 7875531.7021]
README_GRAD = [-6.7923e4, -1.7737e4, -7.0413e2, 0.0, -5.7458e5, -6.9122e1,
               -3.6892e4, -3.6892e4]


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _log_loss(nans, vp):
    """sum of log p over the converged rows, as bench.py's loss."""
    return torch.where(nans, 0.0, torch.log(torch.where(nans, 1.0, vp))).sum()


@pytest.fixture(scope="module")
def readme():
    eos = ft.PcSaftPure(np.tile(README_PARAMS, (5, 1)), device="cpu")
    nans, vp = eos.vapor_pressure(README_T)
    vp[0].backward()
    return nans, vp.detach().numpy(), eos.params.grad[0].numpy()


def test_readme_vapor_pressures(readme):
    nans, vp, _ = readme
    assert not nans.any()
    np.testing.assert_allclose(vp, README_VP, rtol=5e-9)


def test_readme_gradient(readme):
    _, _, grad = readme
    np.testing.assert_allclose(grad, README_GRAD, rtol=5e-4)


def _port_batch():
    """A seeded 64-row batch: the inputs, the port's (nans, p, gradient of
    sum log p) and its VLE densities."""
    params, temperature = ft.make_batch(64, seed=5)

    p = _t(params).requires_grad_()
    nans, vp = ft.vapor_pressure(p, _t(temperature))
    _log_loss(nans, vp).backward()
    port = (nans.numpy(), vp.detach().numpy(), p.grad.numpy())
    with torch.no_grad():
        rho_v, rho_l, _ = ft.pure_vle(_t(params), _t(temperature))
    return {"params": params, "t": temperature}, port, {"rv": rho_v.numpy(),
                                                        "rl": rho_l.numpy()}


OUTPUTS = ("nans", "vp", "grad", "grad64")


def jax_reference():
    """``value_and_grad(vapor_pressure)`` as the JAX package ships it, and
    the f64 gradient of its re-attachment identity at the port's
    densities, in one jit."""
    import jax
    import jax.numpy as jnp
    from feos_tpu.models.pcsaft_pure import PureParams as JaxParams
    from feos_tpu.models.pcsaft_pure import phi_pure as jax_phi_pure
    from feos_tpu.models.pcsaft_pure import vapor_pressure as jax_vapor_pressure

    inputs, _, dens = _port_batch()

    @jax.jit
    def reference(par, t, rv, rl):
        def loss(q):
            nans, vp = jax_vapor_pressure(q, t)
            return jnp.sum(jnp.where(nans, 0.0, jnp.log(jnp.where(nans, 1.0, vp)))), (nans, vp)

        def identity_loss(q):
            pp = JaxParams.from_array(q)
            a_l = jax.vmap(jax_phi_pure)(pp, t, rl) / rl
            a_v = jax.vmap(jax_phi_pure)(pp, t, rv) / rv
            p_red = -(a_v - a_l + jnp.log(rv / rl)) / (1.0 / rv - 1.0 / rl)
            return jnp.sum(jnp.log(p_red))

        (_, (nans, vp)), grad = jax.value_and_grad(loss, has_aux=True)(par)
        return nans, vp, grad, jax.grad(identity_loss)(par)

    ref = reference(*(jnp.asarray(x) for x in (*inputs.values(), *dens.values())))
    return {**inputs, **dens, **dict(zip(OUTPUTS, ref))}


@pytest.fixture(scope="module")
def batch():
    """A seeded 64-row batch through the port and through JAX (vendored):
    ``value_and_grad(vapor_pressure)`` as the JAX package ships it, and the
    f64 gradient of its re-attachment identity at the port's densities."""
    inputs, port, dens = _port_batch()
    ref = vendored("vapor_pressure", exact=inputs, close=dens)
    return tuple(ref[k] for k in OUTPUTS), port


def test_batch_masks_match_jax(batch):
    (jnans, _, _, _), (nans, _, _) = batch
    np.testing.assert_array_equal(nans, jnans)
    assert not nans.any()


def test_batch_values_match_jax(batch):
    (_, jvp, _, _), (_, vp, _) = batch
    np.testing.assert_allclose(vp, jvp, rtol=1e-9, atol=0)


COLUMNS = ["m", "sigma", "epsilon_k", "mu", "kappa_ab", "epsilon_k_ab", "na", "nb"]


@pytest.mark.parametrize("i", range(8), ids=COLUMNS)
def test_batch_gradients_match_jax_identity_f64(batch, i):
    """Against JAX reverse mode of the same identity in f64: both sides
    differentiate the same function exactly.  Columns that are exactly zero
    for a row (mu = 0, no association) are zero on both sides."""
    (_, _, _, jgrad64), (_, _, grad) = batch
    np.testing.assert_allclose(grad[:, i], jgrad64[:, i], rtol=1e-12, atol=0)


@pytest.mark.parametrize("i", range(8), ids=COLUMNS)
def test_batch_gradients_match_jax_value_and_grad(batch, i):
    """Against the JAX package's shipped gradient, whose parameter tangents
    ride an f32 clone of the identity: on this batch it sits up to 4.6e-5
    relative from its own f64 gradient (m and sigma columns), so the bar is
    the reference's gradient acceptance, 1e-4."""
    (_, _, jgrad, _), (_, _, grad) = batch
    np.testing.assert_allclose(grad[:, i], jgrad[:, i], rtol=1e-4, atol=0)


# central finite differences, parameters and step of the JAX package's own
# check (tests/test_pcsaft_pure.py::test_gradients_fd, vapor_pressure case)
FD_PARAMS = [1.5, 3.2, 150, 2.5, 0.03, 2500, 1, 2]
FD_T = 300.0
FD_H = 5e-9


@pytest.fixture(scope="module")
def fd():
    """Rows p, p + h_i e_i, p - h_i e_i (i < 6) in one batch; the gradient of
    row 0 comes from the same solve."""
    p0 = np.asarray(FD_PARAMS, dtype=np.float64)
    rows = [p0]
    for i in range(6):
        for sign in (1.0, -1.0):
            q = p0.copy()
            q[i] += sign * p0[i] * FD_H
            rows.append(q)
    params = _t(np.stack(rows)).requires_grad_()
    nans, vp = ft.vapor_pressure(params, _t(np.full(len(rows), FD_T)))
    assert not nans.any()
    vp[0].backward()
    return vp.detach().numpy(), params.grad[0].numpy()


@pytest.mark.parametrize("i", range(6))
def test_gradients_central_fd(fd, i):
    vp, grad = fd
    h = FD_PARAMS[i] * FD_H
    fd_i = (vp[1 + 2 * i] - vp[2 + 2 * i]) / (2 * h)
    assert abs((fd_i - grad[i]) / grad[i]) < 1e-4, (fd_i, grad[i])


def test_temperature_gradient_central_fd():
    """dp/dT through the same identity, against central differences in T."""
    t0, h = 320.0, 320.0 * 1e-7
    params = _t(np.tile(README_PARAMS, (3, 1)))
    temperature = _t([t0, t0 + h, t0 - h]).requires_grad_()
    _, vp = ft.vapor_pressure(params, temperature)
    vp[0].backward()
    fd_t = (vp[1] - vp[2]).item() / (2 * h)
    assert abs(fd_t / float(temperature.grad[0]) - 1.0) < 1e-6


def test_failure_mask_supercritical():
    params = _t(np.tile([1.0, 3.5, 150.0, 0, 0, 0, 0, 0], (3, 1)))
    nans, vp = ft.vapor_pressure(params, _t([100.0, 130.0, 1000.0]))
    assert nans.tolist() == [False, False, True]
    assert torch.isnan(vp[2]) and torch.isfinite(vp[:2]).all()


def test_gradients_finite_with_failed_row():
    """A supercritical row in the batch leaves the batch gradient finite."""
    p0 = _t(README_PARAMS).requires_grad_()
    nans, vp = ft.vapor_pressure(p0.expand(3, 8), _t([300.0, 2000.0, 350.0]))
    assert nans.tolist() == [False, True, False]
    loss = torch.where(nans, 0.0, vp).sum()
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(p0.grad).all()
