"""The frozen operation tallies of h100bench/roofline.py equal the tallies
of the port's kernel headers (csrc/phi_d2_ops.cpp, csrc/vp_identity_ops.cpp,
built here with g++) for the regimes of the cells' rows."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from h100bench import roofline
from h100bench.harness import ROOT

CSRC = ROOT / "feos_tpu_torch" / "csrc"


def _build(tmp_path_factory, source):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the tally")
    out = tmp_path_factory.mktemp("tally") / f"lib{source.split('.')[0]}.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", f"-I{CSRC}", "-o", str(out),
                    str(CSRC / source)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


@pytest.fixture(scope="module")
def phi_ops(tmp_path_factory):
    lib = _build(tmp_path_factory, "phi_d2_ops.cpp")

    def run(par, temperature, rho):
        par = np.ascontiguousarray(par, dtype=np.float64)
        counts = (ctypes.c_int64 * 8)()
        lib.feos_phi_d2_ops(_ptr(par), ctypes.c_double(temperature), ctypes.c_double(rho), counts)
        return counts[0], counts[4]

    return run


@pytest.fixture(scope="module")
def vp_ops(tmp_path_factory):
    lib = _build(tmp_path_factory, "vp_identity_ops.cpp")

    def run(par, temperature, rho_v, rho_l):
        par = np.ascontiguousarray(par, dtype=np.float64)
        counts = (ctypes.c_int64 * 4)()
        lib.feos_vp_identity_ops(_ptr(par), ctypes.c_double(temperature), ctypes.c_double(rho_v),
                                 ctypes.c_double(rho_l), counts)
        return counts[0]

    return run


REGIMES = [(dip, sites, m) for dip in (0, 1) for sites in (None, (1.0, 1.0), (2.0, 1.0))
           for m in (1.5, 2.5)]


def _row(dip, sites, m):
    na, nb = sites or (0.0, 0.0)
    assoc = sites is not None
    return np.array([m, 3.4, 220.0, 2.0 * dip, 0.03 * assoc, 1800.0 * assoc, na, nb])


@pytest.mark.parametrize("dip,sites,m", REGIMES)
def test_phi_d2_tally(phi_ops, dip, sites, m):
    par = _row(dip, sites, m)
    row, element = phi_ops(par, 250.0, 5e-3)
    per = roofline.ops_per_evaluation(torch.tensor(par)[None], torch.tensor([250.0]))
    assert row == roofline.OPS_ROW
    assert element == int(per[0])


@pytest.mark.parametrize("dip,sites,m", REGIMES)
def test_vp_identity_tally(vp_ops, dip, sites, m):
    par = _row(dip, sites, m)
    assert vp_ops(par, 250.0, 1e-4, 1e-2) == int(roofline.vp_identity_ops(torch.tensor(par)[None])[0])


def test_work_sums_rows():
    params = torch.tensor(np.stack([_row(*r) for r in REGIMES]))
    temperature = torch.full((len(REGIMES),), 250.0, dtype=torch.float64)
    evals = torch.arange(1, len(REGIMES) + 1)
    ops, nbytes = roofline.pure_vle_work(params, temperature, evals)
    per = roofline.ops_per_evaluation(params, temperature)
    assert ops == len(REGIMES) * roofline.OPS_ROW + int((evals * per).sum())
    assert nbytes == len(REGIMES) * roofline.BYTES_VLE_ROW + roofline.ETA_GRID_BYTES
    ops, nbytes = roofline.density_solve_work(params, temperature, evals)
    assert ops == int((evals * (per + roofline.OPS_ROW)).sum())
    assert roofline.bound_s(34e12, 0) == pytest.approx(1.0)
