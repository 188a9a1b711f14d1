"""The PyTorch port's pure-component EOS against the JAX package.

Seeded numpy inputs go through both packages: constants, units and batches,
phi and its precomputed split, the phi_d2 kernel's plain version, and the
kernel's own arithmetic built for the host with g++.  The JAX side runs once
per file, in one jitted function of one fixed shape.
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from feos_tpu import constants as jconstants
from feos_tpu import units as junits
from feos_tpu.models import pcsaft_pure as jpure
from feos_tpu.ops.derivatives import value_and_2derivs as jvalue_and_2derivs
from feos_tpu_torch import constants, tracing, units
from feos_tpu_torch.kernels.phi_d2 import max_scaled_error, phi_d2, phi_d2_plain
from feos_tpu_torch.models.pcsaft_pure import phi_pure_pre, pure_pre_from_numpy

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden" / "pure_helmholtz.json"
CSRC = REPO / "feos_tpu_torch" / "csrc"

B = 512
ETAS = (1e-3, 0.2, 0.45)  # vapor-like, intermediate, liquid packing fractions
# the bound the kernel is held to (see max_scaled_error)
KERNEL_BOUND = 1e-11


def _inputs():
    """512 seeded rows plus edge rows (mu = 0 with and without association,
    kappa_ab = 0, m < 2 and m > 2), at three packing fractions each."""
    params, temperature = ft.make_batch(B - 4, seed=11)
    edge = np.array([
        [1.0, 3.5, 150.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [1.5, 3.2, 150.0, 2.5, 0.0, 2500.0, 1.0, 1.0],
        [2.0, 3.2, 250.0, 0.0, 0.03, 2500.0, 2.0, 1.0],
        [2.9, 3.9, 280.0, 3.0, 0.03, 1800.0, 0.0, 2.0],
    ])
    params = np.concatenate([params, edge])
    temperature = np.concatenate([temperature, [200.0, 300.0, 350.0, 400.0]])
    m, sigma, eps = params[:, 0], params[:, 1], params[:, 2]
    d = sigma * (1.0 - 0.12 * np.exp(-3.0 * eps / temperature))
    eta_m = np.pi / 6.0 * m * d**3
    rho = np.ascontiguousarray(np.asarray(ETAS)[None, :] / eta_m[:, None])
    return params, temperature, rho


@pytest.fixture(scope="module")
def case():
    """numpy inputs and every JAX-side output of this file, from one jit."""
    from benchmarks.pallas_experiment import _fused_d2

    params, temperature, rho = _inputs()

    @jax.jit
    def reference(par, t, r):
        p = jpure.PureParams.from_array(par)
        per_state = jax.vmap(jax.vmap(jpure.phi_pure, (None, None, 0)))
        pre = jax.vmap(jpure.precompute_pure)(p, t)
        d2 = jax.vmap(jax.vmap(
            lambda q, x: jvalue_and_2derivs(lambda y: jpure.phi_pure_pre(q, y), x),
            (None, 0),
        ))(pre, r)
        cols = tuple(par[:, i:i + 1] for i in range(8))
        return {
            "phi": per_state(p, t, r),
            "pre": tuple(pre),
            "phi_pre": jax.vmap(jax.vmap(jpure.phi_pure_pre, (None, 0)))(pre, r),
            "value_and_2derivs": d2,
            "fused_d2": _fused_d2(cols, t[:, None], r),
        }

    out = jax.tree_util.tree_map(
        np.array, reference(jnp.asarray(params), jnp.asarray(temperature),
                              jnp.asarray(rho))
    )
    return params, temperature, rho, out


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


# -- numpy-only modules and the batch generator ------------------------------


@pytest.mark.parametrize("name", ["A0", "A1", "A2", "B0", "B1", "B2", "AD", "BD", "CD"])
def test_constants_equal_jax_package(name):
    np.testing.assert_array_equal(getattr(constants, name), getattr(jconstants, name))


@pytest.mark.parametrize("name", [
    "KB", "NAV", "ANGSTROM", "RGAS", "PA_PER_KT_TO_REDUCED",
    "REDUCED_TO_PA_PER_KT", "KMOL_M3_TO_REDUCED", "MU2_FACTOR",
])
def test_units_equal_jax_package(name):
    assert getattr(units, name) == getattr(junits, name)


@pytest.mark.parametrize("seed", [0, 3])
def test_make_batch_equals_bench(seed):
    # bench.py points the JAX compilation cache at its own directory when
    # imported; restore this process's settings afterwards
    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    try:
        import bench
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    for a, b in zip(ft.make_batch(1000, seed=seed), bench.make_batch(1000, seed=seed)):
        np.testing.assert_array_equal(a, b)


# -- Helmholtz energy ----------------------------------------------------------


def test_phi_pure_matches_jax(case):
    params, temperature, rho, ref = case
    p = ft.PureParams.from_numpy(params, "cpu")
    phi = ft.phi_pure(p, _t(temperature), _t(rho))
    np.testing.assert_allclose(phi.numpy(), ref["phi"], rtol=1e-13, atol=0)


def test_phi_pure_pre_on_jax_pre_matches_jax(case):
    _, _, rho, ref = case
    pre = pure_pre_from_numpy(ref["pre"], "cpu")
    np.testing.assert_allclose(
        phi_pure_pre(pre, _t(rho)).numpy(), ref["phi_pre"], rtol=1e-13, atol=0
    )


def test_precompute_matches_jax(case):
    params, temperature, _, ref = case
    pre = ft.precompute_pure(ft.PureParams.from_numpy(params, "cpu"), _t(temperature))
    # the coefficient sums cancel at some rows: hold them to 1e-15 of the
    # field's scale as well as 1e-13 relative
    for name, got, want in zip(ft.PurePre._fields, pre, ref["pre"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-13,
                                   atol=1e-15 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("i, key", [(0, "a"), (1, "p"), (2, "dp")])
def test_derivatives_golden(i, key):
    """phi, p~, dp~/drho against the vendored golden values at atol 1e-14."""
    d = json.loads(GOLDEN.read_text())
    n = len(d["params"])
    eos = ft.PcSaftPure(np.array(d["params"]), device="cpu")
    with torch.no_grad():
        out = eos.derivatives(np.full(n, d["temperature"]), np.full(n, d["density"]))
    np.testing.assert_allclose(out[i].numpy(), d[key], rtol=0, atol=1e-14)


def test_helmholtz_energy_facade(case):
    params, temperature, rho, ref = case
    eos = ft.PcSaftPure(params, device="cpu")
    with torch.no_grad():
        phi = eos.helmholtz_energy(temperature, rho[:, 2])
    np.testing.assert_allclose(phi.numpy(), ref["phi"][:, 2], rtol=1e-13, atol=0)


# -- the phi_d2 kernel's plain version ----------------------------------------


@pytest.mark.parametrize("reference", ["value_and_2derivs", "fused_d2"])
@pytest.mark.parametrize("j", [0, 1, 2], ids=["phi", "d1", "d2"])
def test_phi_d2_plain_matches_jax(case, reference, j):
    """Against the solver's JAX evaluation (vle.py::_eos_pure_multi) and the
    Pallas kernel's own math (pallas_experiment._fused_d2), both in f64."""
    params, temperature, rho, ref = case
    got = phi_d2(_t(params), _t(temperature), _t(rho))[j].numpy()
    assert max_scaled_error(got, ref[reference][j]) < KERNEL_BOUND


def test_phi_d2_cpu_path_does_not_count_launches():
    params, temperature, rho = _inputs()
    with tracing.record() as rec:
        phi_d2(_t(params), _t(temperature), _t(rho))
    assert "launch.phi_d2" not in rec.counters and rec.counters["calls.kernel.phi_d2"] == 1


@pytest.mark.parametrize("bad", ["dtype", "shape", "rows", "contiguous", "device"])
def test_phi_d2_rejects_bad_input(bad):
    params, temperature, rho = (_t(x) for x in _inputs())
    if bad == "dtype":
        rho = rho.float()
    elif bad == "shape":
        rho = rho[:, 0]
    elif bad == "rows":
        temperature = temperature[1:]
    elif bad == "contiguous":
        rho = rho.t().contiguous().t()
    else:
        rho = rho.to("meta")
    with pytest.raises((ValueError, TypeError)):
        phi_d2(params, temperature, rho)


# -- the kernel's arithmetic, built for the host ------------------------------


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """pcsaft_pure_d3.cuh built by g++ into a ctypes-loaded library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's arithmetic for the host")
    lib_path = tmp_path_factory.mktemp("phi_d2_host") / "libphi_d2_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{CSRC}",
         "-o", str(lib_path), str(CSRC / "phi_d2_host.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    ptr = ctypes.c_void_p
    lib.feos_phi_d2_host.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_int64, ctypes.c_int64]
    lib.feos_phi_d2_host.restype = None

    def run(params, temperature, rho):
        params, temperature, rho = (
            np.ascontiguousarray(x, dtype=np.float64) for x in (params, temperature, rho)
        )
        n, k = rho.shape
        out = np.empty((3, n, k))
        lib.feos_phi_d2_host(params.ctypes.data, temperature.ctypes.data,
                             rho.ctypes.data, out.ctypes.data, n, k)
        return out

    return run


def test_host_kernel_matches_plain(host_kernel):
    """The kernel's arithmetic at the solver's shapes: (B, 2) states and the
    (B, 48) spinodal grid, against the plain version."""
    from feos_tpu_torch.solvers.vle import _ETA_GRID

    params, temperature, rho3 = _inputs()
    eta_m = ETAS[0] / rho3[:, 0]
    for rho in (rho3[:, [2, 0]], _ETA_GRID[None, :] / eta_m[:, None]):
        rho = np.ascontiguousarray(rho)
        got = host_kernel(params, temperature, rho)
        want = phi_d2_plain(_t(params), _t(temperature), _t(rho))
        for j in range(3):
            assert max_scaled_error(got[j], want[j].numpy()) < KERNEL_BOUND, j


def test_host_kernel_golden(host_kernel):
    d = json.loads(GOLDEN.read_text())
    n = len(d["params"])
    rho = d["density"]
    phi, d1, d2 = host_kernel(d["params"], np.full(n, d["temperature"]),
                              np.full((n, 1), rho))[:, :, 0]
    np.testing.assert_allclose(phi, d["a"], rtol=0, atol=1e-14)
    np.testing.assert_allclose(rho - phi + rho * d1, d["p"], rtol=0, atol=1e-14)
    np.testing.assert_allclose(1.0 + rho * d2, d["dp"], rtol=0, atol=1e-14)


def test_host_kernel_dipole_and_association_edges(host_kernel):
    """mu = 0 gives an exactly zero dipole term, and kappa_ab = 0 or
    epsilon_k_ab = 0 an exactly zero association term: the row then equals
    the same row with those parameters cleared, derivatives included."""
    base = [1.8, 3.4, 230.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    rows = np.array([
        base,
        [1.8, 3.4, 230.0, 0.0, 0.03, 0.0, 1.0, 1.0],     # eps_ab = 0
        [1.8, 3.4, 230.0, 0.0, 0.0, 2500.0, 2.0, 1.0],   # kappa_ab = 0
    ])
    rho = np.array([[1e-4, 5e-3, 1.5e-2]] * 3)
    out = host_kernel(rows, np.full(3, 300.0), rho)
    assert np.all(np.isfinite(out))
    for r in (1, 2):
        np.testing.assert_array_equal(out[:, r], out[:, 0])


# -- the package boundary -----------------------------------------------------


def test_import_loads_no_jax():
    code = (
        "import sys, feos_tpu_torch, feos_tpu_torch.solvers.vle, "
        "feos_tpu_torch.solvers.tsolve, feos_tpu_torch.properties, "
        "feos_tpu_torch.regression, feos_tpu_torch.kernels.build\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'feos_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
