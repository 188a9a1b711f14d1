"""The vp_identity kernel's arithmetic, built for the host, against the
plain graph's autograd and the JAX package; the ``autograd.Function`` that
uses it as ``vapor_pressure``'s backward on the card.

``g++`` builds ``feos_tpu_torch/csrc/vp_identity.cuh`` (p~ of the
vapor-pressure identity and its partials in the 8 parameters and T, by the
hand-written adjoint each thread of the kernel runs) into a ctypes shim,
``vp_identity_host.cpp``, and once more on a counting scalar
(``vp_identity_ops.cpp``) for the bound's operation counts.  JAX's f64
gradient of the identity on ``tests/test_torch_vapor_pressure.py``'s batch
is read from ``tests/golden/torch_vapor_pressure_jax.npz``.
"""

import ctypes
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from _torch_golden import vendored
from _torch_host import gxx_build, ptr
from feos_tpu_torch import tracing
from feos_tpu_torch.kernels import vp_identity as kernel
from feos_tpu_torch.kernels.phi_d2 import max_scaled_error

# chip_smoke.py holds the bound's operation counts; importing it runs nothing
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

P_RTOL = 1e-12          # p~ against the plain graph
PARTIALS_BOUND = 1e-10  # max_scaled_error of each partial against autograd
JAX_RTOL = 1e-12        # tests/test_torch_vapor_pressure.py's bar for grad64


class Host:
    """ctypes front of ``vp_identity_host.cpp``; numpy in and out."""

    def __init__(self, lib):
        self.lib = lib

    def __call__(self, params, temperature, rho_v, rho_l):
        """``(p~ (B,), partials (B, 9))``."""
        params, temperature, rho_v, rho_l = (
            np.ascontiguousarray(x, dtype=np.float64)
            for x in (params, temperature, rho_v, rho_l))
        B = len(temperature)
        ptilde, partials = np.empty(B), np.empty((B, 9))
        self.lib.feos_vp_identity_host(ptr(params), ptr(temperature), ptr(rho_v), ptr(rho_l),
                                       ptr(ptilde), ptr(partials), ctypes.c_int64(B))
        return ptilde, partials


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return Host(gxx_build(tmp_path_factory, "vp_identity_host.cpp"))


@pytest.fixture(scope="module")
def count_ops(tmp_path_factory):
    """``count_ops(par, T, rho_v, rho_l)`` -> [ops, exp, log, sqrt]."""
    lib = gxx_build(tmp_path_factory, "vp_identity_ops.cpp")

    def run(par, temperature, rho_v, rho_l):
        par = np.ascontiguousarray(par, dtype=np.float64)
        counts = (ctypes.c_int64 * 4)()
        lib.feos_vp_identity_ops(ptr(par), ctypes.c_double(temperature),
                                 ctypes.c_double(rho_v), ctypes.c_double(rho_l), counts)
        return list(counts)

    return run


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float64))


def _plain(params, temperature, rho_v, rho_l):
    return tuple(x.numpy() for x in kernel.vp_identity_plain(
        _t(params), _t(temperature), _t(rho_v), _t(rho_l)))


def _solved(params, temperature):
    """The solver's densities, sanitised on failed rows as
    ``vapor_pressure`` does, and the mask."""
    rho_v, rho_l, ok = ft.pure_vle(_t(params), _t(temperature))
    return (torch.where(ok, rho_v, 1e-5).numpy(), torch.where(ok, rho_l, 1e-3).numpy(),
            ok.numpy())


def _agree(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=P_RTOL, atol=0)
    for j in range(9):
        assert max_scaled_error(got[1][:, j], want[1][:, j]) < PARTIALS_BOUND, j


def _scaled_errors(got, want):
    """``|a - b| / (|b| + 1e-3 max|b|)`` of each partial, the floor taken
    over its column (``max_scaled_error`` element by element)."""
    scale = np.abs(want).max(0)
    return np.abs(got - want) / (np.abs(want) + 1e-3 * scale)


# rows the header's shortcuts would get wrong, each solved at 300 K
SPECIAL = {
    "na=nb": [1.5, 3.2, 250.0, 0.0, 0.03, 1500.0, 1.0, 1.0],
    "na=nb=2, dipolar": [1.8, 3.3, 230.0, 1.5, 0.02, 1800.0, 2.0, 2.0],
    "kappa_ab>0, eps_ab=0": [1.5, 3.2, 250.0, 0.0, 0.03, 0.0, 1.0, 1.0],
    "kappa_ab=0, eps_ab>0": [1.5, 3.2, 250.0, 0.0, 0.0, 1500.0, 1.0, 1.0],
    "one-sided sites": [1.5, 3.2, 250.0, 2.5, 0.03, 1500.0, 0.0, 2.0],
    "mu=0, no sites": [2.2, 3.6, 280.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    "failed": [1.5, 3.2, 250.0, 2.5, 0.03, 1500.0, 1.0, 1.0],
}
SPECIAL_T = {name: 300.0 for name in SPECIAL} | {"failed": 2000.0}


@pytest.fixture(scope="module")
def special(host):
    """The special rows after 64 seeded ones, whose partials set each
    column's scale; the host build's and the plain graph's results."""
    seeded, seeded_t = ft.make_batch(64, seed=6)
    params = np.concatenate([seeded, list(SPECIAL.values())])
    temperature = np.concatenate([seeded_t, [SPECIAL_T[name] for name in SPECIAL]])
    rho_v, rho_l, ok = _solved(params, temperature)
    assert ok.tolist() == [True] * 64 + [name != "failed" for name in SPECIAL]
    args = (params, temperature, rho_v, rho_l)
    return host(*args), _plain(*args)


@pytest.mark.parametrize("name", list(SPECIAL))
def test_special_rows_match_plain(special, name):
    """p~ within 1e-12 and each partial within 1e-10 of autograd of the
    plain graph, scaled as ``max_scaled_error`` scales a column."""
    got, want = special
    i = 64 + list(SPECIAL).index(name)
    np.testing.assert_allclose(got[0][i], want[0][i], rtol=P_RTOL, atol=0)
    assert np.all(np.isfinite(got[1][i]))
    assert np.all(_scaled_errors(got[1], want[1])[i] < PARTIALS_BOUND)
    if name == "kappa_ab>0, eps_ab=0":
        # the association term is zero in value, not in its eps_ab partial
        assert got[1][i, 5] != 0.0
    if name.startswith("mu=0"):
        assert np.all(got[1][i, 3:8] == 0.0)


def test_seeded_rows_match_plain(special):
    got, want = special
    _agree((got[0][:64], got[1][:64]), (want[0][:64], want[1][:64]))


@pytest.fixture(scope="module")
def jax_batch():
    """tests/test_torch_vapor_pressure.py's 64 rows at the port's densities,
    and JAX's f64 gradient of sum log p~ there (``grad64``)."""
    params, temperature = ft.make_batch(64, seed=5)
    rho_v, rho_l, ok = _solved(params, temperature)
    ref = vendored("vapor_pressure", exact={"params": params, "t": temperature},
                   close={"rv": rho_v, "rl": rho_l})
    assert ok.all()
    return params, temperature, rho_v, rho_l, ref["grad64"]


def test_batch_matches_plain(host, jax_batch):
    params, temperature, rho_v, rho_l, _ = jax_batch
    _agree(host(params, temperature, rho_v, rho_l), _plain(params, temperature, rho_v, rho_l))


@pytest.mark.parametrize("i", range(8))
def test_batch_matches_jax_f64_gradient(host, jax_batch, i):
    """d log p~ / d parameter i against JAX's reverse mode of the same
    identity in f64, at tests/test_torch_vapor_pressure.py's bar; columns
    that are exactly zero (mu = 0, no association) are zero on both sides."""
    params, temperature, rho_v, rho_l, grad64 = jax_batch
    ptilde, partials = host(params, temperature, rho_v, rho_l)
    np.testing.assert_allclose(partials[:, i] / ptilde, grad64[:, i], rtol=JAX_RTOL, atol=0)


def test_rows_do_not_depend_on_batch(host, jax_batch):
    params, temperature, rho_v, rho_l, _ = jax_batch
    whole = host(params, temperature, rho_v, rho_l)
    for i in (0, 63):
        alone = host(*(x[i:i + 1] for x in (params, temperature, rho_v, rho_l)))
        np.testing.assert_array_equal(alone[0][0], whole[0][i])
        np.testing.assert_array_equal(alone[1][0], whole[1][i])


# -- the work the bound counts ------------------------------------------------


def test_op_counts_match_header(count_ops):
    """chip_smoke.vp_identity_ops() gives each row's tally of the header
    exactly, on rows of every regime of make_batch with m on both sides of
    2 and na != nb on some; rows with kappa_ab = 0 and eps_ab > 0, whose
    association strength is zero in value, need fewer and are covered."""
    params, temperature = ft.make_batch(200, seed=8)
    params[::7, 6] = 2.0  # na != nb on some associating rows
    zero_strength = np.zeros(len(params), dtype=bool)
    zero_strength[3::11] = params[3::11, 5] != 0.0
    params[3::11, 4] = 0.0
    ops = smoke.vp_identity_ops(_t(params))
    for k, (par, t) in enumerate(zip(params, temperature)):
        counts = count_ops(par, t, 1e-4, 1e-2)
        if zero_strength[k]:
            assert counts[0] < int(ops[k]), (k, par)
        else:
            assert counts[0] == int(ops[k]), (k, par)
        assoc = par[4] != 0.0 or par[5] != 0.0
        assert counts[1:] == [2, 2 + 4 * assoc, 2 * assoc]


# -- the Function on CPU tensors ----------------------------------------------


def _host_kernel(host):
    """A stand-in for ``kernel.vp_identity`` that returns the host build's
    p~ and partials as tensors."""
    def run(params, temperature, rho_v, rho_l):
        got = host(*(x.numpy() for x in (params, temperature, rho_v, rho_l)))
        return _t(got[0]), _t(got[1])
    return run


def _vapor_pressure(attach, params, temperature):
    """``vapor_pressure``'s steps with the re-attachment ``attach``."""
    rho_v, rho_l, ok = ft.pure_vle(params.detach(), temperature.detach())
    rho_v = torch.where(ok, rho_v, 1e-5)
    rho_l = torch.where(ok, rho_l, 1e-3)
    p = attach(params, temperature, rho_v, rho_l) * temperature
    return ~ok, torch.where(ok, p, torch.nan)


def _grads(attach, params, temperature):
    p = _t(params).requires_grad_()
    t = _t(temperature).requires_grad_()
    nans, vp = _vapor_pressure(attach, p, t)
    torch.where(nans, 0.0, torch.log(torch.where(nans, 1.0, vp))).sum().backward()
    return nans, vp.detach(), p.grad, t.grad


def test_function_gradients_equal_plain_path(host, monkeypatch):
    """Fed the host build's partials, the Function's gradients in the
    parameters and in T equal the plain graph's; a failed row in the batch
    gives finite gradients."""
    params, temperature = ft.make_batch(16, seed=9)
    params[5] = SPECIAL["failed"]
    temperature[5] = SPECIAL_T["failed"]
    plain = _grads(kernel.identity_plain, params, temperature)
    monkeypatch.setattr(kernel, "vp_identity", _host_kernel(host))
    got = _grads(kernel.VaporPressureIdentity.apply, params, temperature)
    assert plain[0].tolist() == got[0].tolist() == [i == 5 for i in range(16)]
    ok = ~got[0]
    np.testing.assert_allclose(got[1][ok], plain[1][ok], rtol=P_RTOL, atol=0)
    for g, want in zip(got[2:], plain[2:]):
        assert torch.isfinite(g).all()
        assert max_scaled_error(g, want) < PARTIALS_BOUND


def test_function_passes_no_gradient_to_densities(host, monkeypatch):
    monkeypatch.setattr(kernel, "vp_identity", _host_kernel(host))
    params, temperature = ft.make_batch(4, seed=10)
    rho_v, rho_l, _ = _solved(params, temperature)
    rv, rl = _t(rho_v).requires_grad_(), _t(rho_l).requires_grad_()
    p = _t(params).requires_grad_()
    kernel.VaporPressureIdentity.apply(p, _t(temperature), rv, rl).sum().backward()
    assert rv.grad is None and rl.grad is None and p.grad is not None


def test_cpu_wrapper_takes_the_plain_path(jax_batch):
    params, temperature, rho_v, rho_l, _ = jax_batch
    with tracing.record() as rec:
        got = kernel.vp_identity(*(_t(x) for x in (params, temperature, rho_v, rho_l)))
    want = _plain(params, temperature, rho_v, rho_l)
    assert "launch.vp_identity" not in rec.counters
    assert rec.counters["calls.kernel.vp_identity"] == 1
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
