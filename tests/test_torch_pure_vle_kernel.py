"""The pure_vle kernels' arithmetic, built for the host, against the plain
solver and the JAX package.

``g++`` builds ``feos_tpu_torch/csrc/pure_vle.cuh`` (the scan point, the
combine and the solve from the scan's result) into a ctypes shim,
``pure_vle_host.cpp``, which runs them in the kernels' order: 16 lanes of 3
grid points a row reduced as the scan kernel's shuffle tree reduces them,
then the solve.  Its rows are held to ``pure_vle_plain`` (the batched torch
loops) on a seeded ``make_batch``, near-critical, supercritical, NaN,
dipolar and associating rows: equal masks, densities within 1e-10.  JAX's
f64 ``pure_vle`` on the 270 rows of ``tests/test_torch_vle.py`` is read
from ``tests/golden/torch_vle_jax.npz`` and held at that file's bars.  The
combine is held to the serial scan, bit for bit, in random reduction trees.
"""

import ctypes

import numpy as np
import pytest
import torch

import feos_tpu_torch as ft
from _torch_golden import vendored
from _torch_host import gxx_build, ptr
from feos_tpu_torch.solvers.vle import _ETA_GRID, pure_vle_plain

RTOL = 1e-10
NEAR_CRITICAL = (0.98, 0.99)
REGIMES = ("nonpolar", "dipolar", "associating", "mixed")


class Host:
    """ctypes front of ``pure_vle_host.cpp``; numpy in and out."""

    def __init__(self, lib):
        self.lib = lib

    def __call__(self, params, temperature):
        """``(rho_v, rho_l, ok, iters)``, ``iters (B, 3)`` = [NPT iterations,
        Newton iterations, phi evaluations] of each row."""
        params, temperature, grid = (np.ascontiguousarray(x, dtype=np.float64)
                                     for x in (params, temperature, _ETA_GRID))
        B = len(temperature)
        rho_v, rho_l = np.empty(B), np.empty(B)
        ok = np.empty(B, dtype=np.uint8)
        iters = np.empty((B, 3), dtype=np.int32)
        self.lib.feos_pure_vle_host(ptr(params), ptr(temperature), ptr(grid), ptr(rho_v),
                                    ptr(rho_l), ptr(ok), ptr(iters), ctypes.c_int64(B))
        return rho_v, rho_l, ok.astype(bool), iters


    def combine(self, dpt, pt, rho, j, merges):
        """``scan_combine`` of the points ``(dpt, pt)`` with grid indices
        ``j`` in the tree ``merges`` ((n - 1, 2) slot pairs), ``rho`` by grid
        index: ``(p_inf, rho_inf, supercritical)``."""
        dpt, pt, rho = (np.ascontiguousarray(x, dtype=np.float64) for x in (dpt, pt, rho))
        j, merges = (np.ascontiguousarray(x, dtype=np.int32) for x in (j, merges))
        out = np.empty(3)
        self.lib.feos_scan_combine_host(ptr(dpt), ptr(pt), ptr(rho), ptr(j), ptr(merges),
                                        ctypes.c_int(len(dpt)), ptr(out))
        return out[0], out[1], bool(out[2])


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return Host(gxx_build(tmp_path_factory, "pure_vle_host.cpp"))


def _plain(params, temperature, stats=None):
    out = pure_vle_plain(torch.as_tensor(params), torch.as_tensor(temperature), stats=stats)
    return tuple(x.numpy() for x in out)


def _agree(got, want):
    """Equal masks, and both densities within RTOL on the converged rows."""
    np.testing.assert_array_equal(got[2], want[2])
    ok = want[2]
    for j in range(2):
        np.testing.assert_allclose(got[j][ok], want[j][ok], rtol=RTOL, atol=0)


def _regimes():
    """Seeded rows of four regimes, as tests/test_torch_phi_d2.py draws
    them: non-polar, dipolar, associating (na = 1 or 2, nb = 1) and both."""
    parts = []
    for i, name in enumerate(REGIMES):
        params, temperature = ft.make_batch(32, seed=i + 20)
        rng = np.random.default_rng(i)
        if name != "mixed":
            params[:, 3] = rng.uniform(0.5, 3.0, 32) if name == "dipolar" else 0.0
            params[:, 4:] = 0.0
        if name == "associating":
            params[:, 4] = 0.03
            params[:, 5] = 1800.0
            params[:, 6] = np.where(np.arange(32) % 3 == 0, 2.0, 1.0)
            params[:, 7] = 1.0
        parts.append((params, temperature))
    return (np.concatenate([p for p, _ in parts]), np.concatenate([t for _, t in parts]))


@pytest.fixture(scope="module")
def batch(host):
    """``make_batch(2000, seed=0)`` through the shim and the plain solver."""
    params, temperature = ft.make_batch(2000, seed=0)
    stats = {}
    return params, temperature, host(params, temperature), _plain(params, temperature, stats), stats


def test_make_batch_matches_plain(batch):
    _, _, got, want, _ = batch
    assert want[2].all()
    _agree(got, want)


def test_iteration_counts(batch):
    """The per-row counters bracket the phi evaluations, and their maxima
    are the plain loops' batch iterations (the NPT counters add the liquid
    and vapor loops, whose maxima the plain path adds)."""
    _, _, got, _, stats = batch
    npt, newton, evals = got[3].T
    assert np.all(evals >= 48 + npt + 2 * newton)
    assert np.all(evals <= 48 + 2 * npt + 2 * newton)
    assert abs(int(newton.max()) - stats["newton"]) <= 1
    assert 0 < npt.max() <= stats["npt"] + 1


@pytest.mark.parametrize("regime", REGIMES)
def test_regimes_match_plain(host, regime):
    params, temperature = _regimes()
    rows = slice(32 * REGIMES.index(regime), 32 * REGIMES.index(regime) + 32)
    _agree(host(params[rows], temperature[rows]), _plain(params[rows], temperature[rows]))


@pytest.fixture(scope="module")
def critical():
    """Seeded rows and their critical temperatures (the port's solver)."""
    params, _ = ft.make_batch(24, seed=11)
    _, t_c, ok = ft.pure_critical(torch.as_tensor(params))
    assert bool(ok.all())
    return params, t_c.numpy()


@pytest.mark.parametrize("share", NEAR_CRITICAL)
def test_near_critical_rows_match_plain(host, critical, share):
    """At 0.98 and 0.99 T_c, where the solve starts from the spinodal
    estimate and fails on some rows: the masks agree row for row."""
    params, t_c = critical
    _agree(host(params, share * t_c), _plain(params, share * t_c))


def test_supercritical_rows_masked(host, critical):
    params, t_c = critical
    got = host(params, 1.2 * t_c)
    assert not got[2].any()
    _agree(got, _plain(params, 1.2 * t_c))


def test_nan_rows_finish_at_once(host):
    """A NaN row (the padding of ``pad_to_multiple``) is masked and takes
    no NPT iteration and one Newton iteration: it cannot hold its warp to
    the 60/80 caps."""
    params, temperature = ft.make_batch(6, seed=4)
    params[[1, 4]] = np.nan
    temperature[4] = np.nan
    got = host(params, temperature)
    want = _plain(params, temperature)
    _agree(got, want)
    assert not got[2][[1, 4]].any() and got[2][[0, 2, 3, 5]].all()
    np.testing.assert_array_equal(got[3][[1, 4]], [[0, 1, 50], [0, 1, 50]])


def test_rows_do_not_depend_on_batch(host, batch):
    """A thread a row: each row alone gives its in-batch result to the bit."""
    params, temperature, got, _, _ = batch
    for i in (0, 7, 1999):
        alone = host(params[i:i + 1], temperature[i:i + 1])
        for j in range(4):
            np.testing.assert_array_equal(alone[j][0], got[j][i])


def test_matches_jax(host):
    """JAX's vendored f64 ``pure_vle`` on tests/test_torch_vle.py's 270 rows
    (the file holds their inputs) at that file's bars: equal masks,
    densities within 1e-10 on rows both accept."""
    ref = vendored("vle")
    got = host(ref["params"], ref["t"])
    np.testing.assert_array_equal(got[2], ref["ok"])
    both = got[2] & ref["ok"]
    for j, key in enumerate(("rho_v", "rho_l")):
        np.testing.assert_allclose(got[j][both], ref[key][both], rtol=RTOL, atol=0)


def _serial_scan(dpt, pt, rho):
    """The scan as the serial loop runs it: the first NaN of dp~/drho, else
    the first point of the least value; ``(p_inf, rho_inf, supercritical)``
    with p_inf = max(p~, 1e-12), NaN kept."""
    best = 0
    for j in range(1, len(dpt)):
        if np.isnan(dpt[best]):
            break
        if np.isnan(dpt[j]) or dpt[j] < dpt[best]:
            best = j
    p = pt[best]
    return (1e-12 if p < 1e-12 else p), rho[best], bool(dpt[best] > 0.0)


def _argmin_scan(dpt, pt, rho):
    """The same as ``_spinodal_estimate`` computes it, with torch.argmin."""
    d, p, r = (torch.as_tensor(x)[None] for x in (dpt, pt, rho))
    i = torch.argmin(d, dim=1, keepdim=True)
    return (float(torch.clamp(p.gather(1, i), min=1e-12)), float(r.gather(1, i)),
            bool(d.gather(1, i) > 0.0))


def _scan_row(rng, kind):
    """48 (dp~/drho, p~, rho) of a scan row of the given kind."""
    n = len(_ETA_GRID)
    dpt = rng.normal(size=n) * 10.0 ** rng.integers(-3, 4)
    if kind == "ties":
        dpt = rng.choice(rng.normal(size=4), size=n)
        dpt[rng.integers(n, size=3)] = [0.0, -0.0, 0.0]
    elif kind == "nan":
        dpt[rng.choice(n, size=rng.integers(1, 4), replace=False)] = np.nan
    elif kind == "inf":
        dpt[rng.choice(n, size=6, replace=False)] = rng.choice([np.inf, -np.inf], size=6)
    elif kind == "positive":
        dpt = np.abs(dpt) + 1e-3
        dpt[rng.choice(n, size=4, replace=False)] = dpt.min()  # a tie at the minimum
    pt = rng.normal(size=n) * 1e-11
    pt[rng.integers(n)] = np.nan
    return dpt, pt, _ETA_GRID / rng.uniform(0.5, 2.0)


def _random_tree(rng, n):
    """n - 1 merges of random pairs of the slots still open, each pair in
    random order."""
    open_, merges = list(range(n)), []
    while len(open_) > 1:
        a, b = rng.choice(len(open_), size=2, replace=False)
        merges.append((open_[a], open_[b]))
        open_.pop(b)
    return np.asarray(merges)


@pytest.mark.parametrize("kind", ("numbers", "ties", "nan", "inf", "positive"))
def test_scan_combine_matches_serial_scan(host, kind):
    """scan_combine in random permutations of a row's 48 points and random
    reduction trees gives the serial scan's (p_inf, rho_inf, supercritical)
    bit for bit, as torch.argmin gives it: the first NaN, else the least
    value, ties to the lowest index."""
    rng = np.random.default_rng(["numbers", "ties", "nan", "inf", "positive"].index(kind))
    n = len(_ETA_GRID)
    for _ in range(40):
        dpt, pt, rho = _scan_row(rng, kind)
        want = _serial_scan(dpt, pt, rho)
        np.testing.assert_array_equal(_argmin_scan(dpt, pt, rho), want)
        for _ in range(5):
            perm = rng.permutation(n)
            got = host.combine(dpt[perm], pt[perm], rho, perm, _random_tree(rng, n))
            assert np.array(got[:2]).tobytes() == np.array(want[:2]).tobytes()
            assert got[2] == want[2]
    if kind == "positive":
        assert want[2]


def test_cpu_wrapper_takes_the_plain_path():
    """On CPU tensors ``pure_vle`` runs ``pure_vle_plain`` and counts no
    launch of the kernel."""
    from feos_tpu_torch.kernels import pure_vle as kernel

    params, temperature = (torch.as_tensor(x) for x in ft.make_batch(8, seed=2))
    before = kernel.pure_vle.launches
    stats = {}
    got = ft.pure_vle(params, temperature, stats=stats)
    want = pure_vle_plain(params, temperature)
    assert kernel.pure_vle.launches == before and "phi_d2_calls" in stats
    for a, b in zip(got, want):
        assert torch.equal(a, b)
