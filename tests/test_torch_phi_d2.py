"""The phi_d2 kernels' arithmetic, built for the host, against the plain
version and the JAX package.

``g++`` builds ``feos_tpu_torch/csrc/pcsaft_pure_d3.cuh`` (the row stage,
each Helmholtz term and their sum, as the CUDA kernels call them) into a
ctypes shim, and a second time on a scalar type that counts its operations.
Seeded rows in four regimes go through the shim, through ``phi_d2_plain``
and through JAX ``value_and_2derivs`` of ``phi_pure`` (one jit of one fixed
shape) at the solver's three density shapes: k = 1 (the vapour NPT lane),
k = 2 (liquid and vapour lanes, the 2x2 Newton) and k = 48 (the spinodal
scan).
"""

import ctypes
import importlib.util
import inspect
import json
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from feos_tpu_torch import tracing
from feos_tpu.models import pcsaft_pure as jpure
from feos_tpu.ops.derivatives import value_and_2derivs as jvalue_and_2derivs
from feos_tpu_torch.kernels.phi_d2 import max_scaled_error, phi_d2, phi_d2_plain
from feos_tpu_torch.solvers.vle import _ETA_GRID

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden" / "pure_helmholtz.json"
CSRC = REPO / "feos_tpu_torch" / "csrc"

# chip_smoke.py holds the bound's operation counts and work(); importing it
# runs nothing
_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

ROWS = 32                  # rows a regime
KERNEL_BOUND = 1e-11       # max_scaled_error, as chip_smoke.py holds the card to
REGIMES = ("nonpolar", "dipolar", "associating", "mixed")
# the solver's density shapes as packing fractions: columns of one
# (rows, 51) matrix, so that JAX compiles one shape
ETAS = {1: [1e-3], 2: [0.45, 1e-3], 48: list(_ETA_GRID)}
COLUMNS = {1: slice(0, 1), 2: slice(1, 3), 48: slice(3, 51)}


def _regime(name):
    """``ROWS`` seeded rows of one regime, from ``make_batch``."""
    params, temperature = ft.make_batch(ROWS, seed=REGIMES.index(name) + 20)
    rng = np.random.default_rng(REGIMES.index(name))
    if name != "mixed":
        params[:, 3] = rng.uniform(0.5, 3.0, ROWS) if name == "dipolar" else 0.0
        params[:, 4:] = 0.0
    if name == "associating":
        # make_batch's association (2B sites, eps_ab = 1800 K), and every
        # third row with na = 2.  Rows with one-sided sites or eps_ab/T
        # beyond ~12 are ill-conditioned: two f64 orderings of phi' and
        # phi'' (the plain version and either header) differ there by up to
        # 2e-10 in max_scaled_error
        params[:, 4] = 0.03
        params[:, 5] = 1800.0
        params[:, 6] = np.where(np.arange(ROWS) % 3 == 0, 2.0, 1.0)
        params[:, 7] = 1.0
    return params, temperature


def _eta_m(params, temperature):
    m, sigma, eps = params[:, 0], params[:, 1], params[:, 2]
    d = sigma * (1.0 - 0.12 * np.exp(-3.0 * eps / temperature))
    return np.pi / 6.0 * m * d**3


def _inputs():
    """Every regime's rows, stacked, and their (rows, 51) densities."""
    parts = [_regime(name) for name in REGIMES]
    params = np.concatenate([p for p, _ in parts])
    temperature = np.concatenate([t for _, t in parts])
    etas = np.concatenate([ETAS[1], ETAS[2], ETAS[48]])
    rho = etas[None, :] / _eta_m(params, temperature)[:, None]
    return params, temperature, rho


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float64))


def _gxx_build(tmp_path_factory, source):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's arithmetic for the host")
    lib_path = tmp_path_factory.mktemp("phi_d2") / f"lib{Path(source).stem}.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{CSRC}",
         "-o", str(lib_path), str(CSRC / source)],
        check=True, capture_output=True, text=True,
    )
    return ctypes.CDLL(str(lib_path))


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


class Host:
    """ctypes front of ``phi_d2_host.cpp``; numpy in and out."""

    def __init__(self, lib):
        self.lib = lib

    def row_consts(self, params, temperature):
        params, temperature = (np.ascontiguousarray(x, dtype=np.float64)
                               for x in (params, temperature))
        rc = np.empty((len(temperature), 32))
        self.lib.feos_row_consts_host(_ptr(params), _ptr(temperature), _ptr(rc),
                                      ctypes.c_int64(len(temperature)))
        return rc

    def _stage(self, fn, rc, rho, lead):
        rc, rho = (np.ascontiguousarray(x, dtype=np.float64) for x in (rc, rho))
        out = np.empty(lead + rho.shape)
        fn(_ptr(rc), _ptr(rho), _ptr(out), ctypes.c_int64(rho.shape[0]),
           ctypes.c_int64(rho.shape[1]))
        return out

    def phi_d3(self, rc, rho):
        return self._stage(self.lib.feos_phi_d3_host, rc, rho, (3,))

    def terms(self, rc, rho):
        return self._stage(self.lib.feos_phi_terms_host, rc, rho, (4, 3))

    def phi_d2(self, params, temperature, rho):
        params, temperature, rho = (np.ascontiguousarray(x, dtype=np.float64)
                                    for x in (params, temperature, rho))
        out = np.empty((3,) + rho.shape)
        self.lib.feos_phi_d2_host(_ptr(params), _ptr(temperature), _ptr(rho), _ptr(out),
                                  ctypes.c_int64(rho.shape[0]), ctypes.c_int64(rho.shape[1]))
        return out


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return Host(_gxx_build(tmp_path_factory, "phi_d2_host.cpp"))


@pytest.fixture(scope="module")
def count_ops(tmp_path_factory):
    """``count_ops(par, T, rho)`` -> (row stage, one density) counts, each
    ``[ops, exp, log, sqrt]``, from ``phi_d2_ops.cpp``."""
    lib = _gxx_build(tmp_path_factory, "phi_d2_ops.cpp")

    def run(par, temperature, rho):
        par = np.ascontiguousarray(par, dtype=np.float64)
        counts = (ctypes.c_int64 * 8)()
        lib.feos_phi_d2_ops(_ptr(par), ctypes.c_double(temperature),
                            ctypes.c_double(rho), counts)
        return list(counts[:4]), list(counts[4:])

    return run


@pytest.fixture(scope="module")
def case():
    """numpy inputs and JAX (phi, phi', phi'') at every density, in one jit."""
    params, temperature, rho = _inputs()

    @jax.jit
    def reference(par, t, r):
        p = jpure.PureParams.from_array(par)
        per_row = jax.vmap(
            lambda q, tt, x: jvalue_and_2derivs(lambda y: jpure.phi_pure(q, tt, y), x),
            (None, None, 0),
        )
        return jax.vmap(per_row)(p, t, r)

    ref = np.stack([np.asarray(x) for x in reference(
        jnp.asarray(params), jnp.asarray(temperature), jnp.asarray(rho))])
    return params, temperature, rho, ref


def _rows(name):
    i = REGIMES.index(name)
    return slice(i * ROWS, (i + 1) * ROWS)


# -- the shim against the plain version and JAX --------------------------------


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("k", [1, 2, 48])
def test_host_kernel_matches_plain_and_jax(host, case, k, regime):
    params, temperature, rho, ref = case
    rows, cols = _rows(regime), COLUMNS[k]
    par, t, r = params[rows], temperature[rows], np.ascontiguousarray(rho[rows, cols])
    got = host.phi_d2(par, t, r)
    plain = phi_d2_plain(_t(par), _t(t), _t(r))
    for j in range(3):
        assert max_scaled_error(got[j], plain[j].numpy()) < KERNEL_BOUND, ("plain", j)
        assert max_scaled_error(got[j], ref[j][rows, cols]) < KERNEL_BOUND, ("jax", j)


def test_row_stage_matches_precompute(host, case):
    """RowConsts, field for field, against the port's ``precompute_pure``."""
    params, temperature, _, _ = case
    rc = host.row_consts(params, temperature)
    pre = ft.precompute_pure(ft.PureParams.from_numpy(params, "cpu"), _t(temperature))
    want = np.concatenate([x.reshape(len(temperature), -1).numpy() for x in pre], 1)
    assert want.shape == rc.shape == (len(temperature), 32)
    for j in range(32):
        np.testing.assert_allclose(rc[:, j], want[:, j], rtol=1e-13,
                                   atol=1e-15 * np.abs(want[:, j]).max(), err_msg=str(j))


@pytest.mark.parametrize("regime", REGIMES)
def test_terms_add_up_to_phi(host, case, regime):
    """The four per-term functions, none skipped, add up to phi_d3."""
    params, temperature, rho, _ = case
    rows = _rows(regime)
    rc = host.row_consts(params[rows], temperature[rows])
    terms = host.terms(rc, rho[rows])
    whole = host.phi_d3(rc, rho[rows])
    np.testing.assert_allclose(terms[0] + terms[1] + terms[2] + terms[3], whole,
                               rtol=1e-15, atol=0)


@pytest.mark.parametrize("j, key", [(0, "a"), (1, "p"), (2, "dp")])
def test_host_kernel_golden(host, j, key):
    """phi, p~ and dp~/drho against the vendored golden values at atol 1e-14."""
    d = json.loads(GOLDEN.read_text())
    n = len(d["params"])
    rho = d["density"]
    phi, d1, d2 = host.phi_d2(d["params"], np.full(n, d["temperature"]),
                              np.full((n, 1), rho))[:, :, 0]
    got = (phi, rho - phi + rho * d1, 1.0 + rho * d2)[j]
    np.testing.assert_allclose(got, d[key], rtol=0, atol=1e-14)


# -- exact zeros ----------------------------------------------------------------

_BASE = [1.8, 3.4, 230.0, 0.0, 0.0, 0.0, 0.0, 0.0]
# first column of each RowConsts field: PurePre's order, the coefficient
# vectors 7, 7, 5 and 4 wide
_WIDTH = [{"c_i1": 7, "c_i2": 7, "c_j1": 5, "c_j2": 4}.get(f, 1) for f in ft.PurePre._fields]
_START = dict(zip(ft.PurePre._fields, np.cumsum([0] + _WIDTH[:-1])))
_RHO = np.array([[1e-5, 1e-4, 5e-3, 1.5e-2]])


def _twin(host, row, twin):
    rows = np.array([row, twin])
    rho = np.repeat(_RHO, 2, 0)
    return host.phi_d2(rows, np.full(2, 300.0), rho)


@pytest.mark.parametrize("row", [
    [1.8, 3.4, 230.0, 0.0, 0.0, 2500.0, 2.0, 1.0],   # kappa_ab = 0
    [1.8, 3.4, 230.0, 0.0, 0.03, 0.0, 1.0, 1.0],     # eps_ab = 0
], ids=["kappa_ab=0", "eps_ab=0"])
def test_no_association_equals_non_associating_twin(host, row):
    out = _twin(host, row, _BASE)
    assert np.all(np.isfinite(out))
    np.testing.assert_array_equal(out[:, 0], out[:, 1])


def test_mu_zero_dipole_term_is_exactly_zero(host):
    """With mu = 0 the dipole term, evaluated rather than skipped, is 0 in
    value and both derivatives, so skipping it changes no bit."""
    rc = host.row_consts(np.array([_BASE]), np.array([300.0]))
    terms = host.terms(rc, _RHO)
    assert np.all(terms[2] == 0.0)
    np.testing.assert_array_equal(terms[0] + terms[1] + terms[2] + terms[3],
                                  host.phi_d3(rc, _RHO))


def test_j1_zero_equals_non_polar_twin(host):
    """A J1 of exactly 0 takes the guard's constant 1 in the Pade
    denominator: the dipole term is then exactly 0, and the dipolar row
    equals its mu = 0 twin bit for bit."""
    polar = list(_BASE)
    polar[3] = 2.5
    rc = host.row_consts(np.array([polar, _BASE]), np.full(2, 300.0))
    rc[:, _START["c_j1"]:_START["c_j1"] + 5] = 0.0
    mu2eff = rc[:, _START["mu2eff"]]
    assert mu2eff[0] != 0.0 and mu2eff[1] == 0.0
    out = host.phi_d3(rc, np.repeat(_RHO, 2, 0))
    assert np.all(np.isfinite(out))
    np.testing.assert_array_equal(out[:, 0], out[:, 1])


# -- the work the bound counts ----------------------------------------------------


@pytest.mark.parametrize("dipolar", [0, 1])
@pytest.mark.parametrize("sites", [None, (1.0, 1.0), (2.0, 1.0)],
                         ids=["non-associating", "na=nb", "na!=nb"])
def test_op_counts_match_header(count_ops, dipolar, sites):
    """The header does no more operations than the bound's fixed counts
    (chip_smoke.py's OPS_*), and the transcendentals the term needs."""
    na, nb = sites or (1.0, 1.0)
    associating = sites is not None
    par = [1.5, 3.2, 350.0, 2.5 * dipolar, 0.03 * associating,
           2500.0 * associating, na, nb]
    row, elem = count_ops(par, 300.0, 5e-3)
    assert row[0] <= smoke.OPS_ROW
    assert row[1:] == [2, 0, 0]
    assoc = 0 if not associating else (
        smoke.OPS_ASSOC_SYMMETRIC if na == nb else smoke.OPS_ASSOC)
    assert elem[0] <= smoke.OPS_ELEMENT + dipolar * smoke.OPS_DIPOLE + assoc
    logs = 1 + (0 if not associating else (1 if na == nb else 2))
    assert elem[1:] == [0, logs, int(associating)]


def test_phi_d2_work_counts_each_row(count_ops, case):
    """chip_smoke.work() adds each row's terms, and covers what the header
    does on every row."""
    params, temperature, _, _ = case
    k = 48
    ops, nbytes = smoke.work(_t(params), _t(temperature), k)
    want, header = 0, 0
    for par, t in zip(params, temperature):
        mu, kappa_ab, eps_ab, na, nb = par[3:]
        element = smoke.OPS_ELEMENT + (mu != 0.0) * smoke.OPS_DIPOLE
        if kappa_ab * (np.exp(eps_ab / t) - 1.0) != 0.0:
            element += smoke.OPS_ASSOC_SYMMETRIC if na == nb else smoke.OPS_ASSOC
        want += smoke.OPS_ROW + k * element
        row, elem = count_ops(par, t, 1e-3)
        header += row[0] + k * elem[0]
    assert ops == want
    assert header <= ops
    assert nbytes == len(params) * (8 + 1) * 8 + len(params) * k * 4 * 8


# -- the wrapper and the entry points ---------------------------------------------


def test_cpu_path_counts_no_launches():
    params, temperature, rho = (_t(x) for x in _inputs())
    with tracing.record() as rec:
        phi_d2(params, temperature, rho)
    assert not any(k.startswith("launch.phi_d2") for k in rec.counters)
    assert rec.counters["calls.kernel.phi_d2"] == 1


@pytest.mark.parametrize("entry", ["PcSaftPure", "PureParams.from_numpy"])
def test_entry_points_default_to_cuda(entry):
    fn = ft.PcSaftPure if entry == "PcSaftPure" else ft.PureParams.from_numpy
    assert inspect.signature(fn).parameters["device"].default == "cuda"
