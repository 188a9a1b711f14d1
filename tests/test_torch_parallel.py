"""The port's data parallelism (``feos_tpu_torch/parallel/mesh.py`` and the
fits' ``mesh=``) against one process and against the JAX package's mesh.

Two processes join a gloo group through a file store in a temporary
directory and run ``tests/_torch_parallel_worker.py`` on the CPU: a
round trip of 13 rows padded to 14 through ``shard_batch``/``gather_batch``,
``data_parallel(vapor_pressure)`` on the same 13 rows padded, three Adam
steps of ``fit_pure`` (vapor pressures with shared and with per-row
parameters, 15 rows padded to 16; liquid densities, 16 rows) and two of
``fit_binary`` (7 rows padded to 8).  This process
runs the same cases without a mesh.  The two ranks must hold bitwise equal
parameters, agree with one process at rtol 1e-12 (the sums run in another
order), mask the padded rows, and match JAX's ``fit_pure`` on its 8-device
CPU mesh at test_torch_regression.py's bar, on the density target (JAX's
vapor-pressure gradient rides f32 tangents).  JAX's mesh fit compiles for
about 20 s, so ``tools/gen_port_fixtures.py`` writes it, with the data it
ran on, to ``tests/golden/torch_parallel_jax.npz``.  JAX's own fit cannot
run on NaN-padded rows (a NaN temperature gives it a NaN gradient), so it
runs on the 16 rows without padding.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_parallel_worker as worker
import feos_tpu_torch as ft
from _torch_golden import vendored
from feos_tpu_torch.parallel import (
    BatchMesh, batch_mesh, data_parallel, gather_batch, initialize_multi_host,
    pad_to_multiple, shard_batch,
)

WORLD = 2
TIMEOUT = 300  # seconds a rank may take before the test fails


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the two ranks wrote."""
    out = tmp_path_factory.mktemp("parallel")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, worker.__file__, str(rank), str(WORLD),
                               f"file://{out / 'store'}", str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for rank in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(out / f"rank{rank}.npz")) for rank in range(WORLD)]


@pytest.fixture(scope="module")
def one_process():
    """Every fit without a mesh: on the data padded as the ranks pad it,
    and on the data without padding."""
    return worker.fits(None, WORLD), worker.fits(None, 1)


@pytest.mark.parametrize("rank", range(WORLD))
def test_shard_gather_round_trip(ranks, rank):
    x, n_valid = pad_to_multiple(np.arange(39.0).reshape(13, 3), WORLD)
    got = ranks[rank]
    assert n_valid == 13 and x.shape == (14, 3)
    np.testing.assert_array_equal(got["rank"], [rank, WORLD])
    np.testing.assert_array_equal(got["block"], x[7 * rank:7 * (rank + 1)])
    np.testing.assert_array_equal(got["round_trip"], x)
    np.testing.assert_array_equal(got["mask_round_trip"], [False] * 13 + [True])


def test_data_parallel_vapor_pressure(ranks):
    """Equal to the one-process call on the valid rows, the padded row
    masked, and the same on both ranks."""
    params, temperature = worker.vp_rows()
    with torch.no_grad():
        nans, p = ft.vapor_pressure(worker._t(params), worker._t(temperature))
    for got in ranks:
        assert got["vp_nans"].shape == (14,) and got["vp_nans"][13]
        assert np.isnan(got["vp"][13])
        np.testing.assert_array_equal(got["vp_nans"][:13], nans.numpy())
        np.testing.assert_allclose(got["vp"][:13], p.numpy(), rtol=1e-12, atol=0)


FITS = ("pure_shared", "pure_per_row", "density16", "binary")


@pytest.mark.parametrize("fit", FITS)
def test_ranks_hold_identical_parameters(ranks, fit):
    for key in (f"{fit}_theta", f"{fit}_loss"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])


@pytest.mark.parametrize("fit", FITS)
def test_fit_matches_one_process(ranks, one_process, fit):
    """Loss history and parameters at rtol 1e-12, against one process on
    the same padded rows and on the rows without padding (per-row
    parameters: the rows of data)."""
    padded, plain = one_process
    n = len(plain[f"{fit}_theta"])
    for ref in (padded, plain):
        for key in (f"{fit}_loss", f"{fit}_theta"):
            np.testing.assert_allclose(ranks[0][key][:n], ref[key][:n], rtol=1e-12, atol=0)
    assert np.all(np.isfinite(ranks[0][f"{fit}_loss"]))


def test_per_row_padding_takes_no_step(ranks):
    """The padded row of the per-row fit is no data: its parameters stay
    those of the first row of data, and every other row moved."""
    theta = ranks[0]["pure_per_row_theta"]
    start = worker.per_row_start(15)
    np.testing.assert_array_equal(theta[15], start[0])
    assert np.all(theta[:15, 2] != start[:, 2])


def jax_reference():
    """JAX's ``fit_pure`` on its 8-device CPU mesh (as tests/test_sharding.py
    builds it): three steps from START on the 16 liquid densities."""
    import jax.numpy as jnp
    from feos_tpu.parallel.mesh import batch_mesh as jax_batch_mesh
    from feos_tpu.regression import fit_pure as jax_fit_pure

    temperature, pressure, rho_liq = worker.density_data(16)
    res = jax_fit_pure(worker.START, jnp.asarray(temperature), rho_liq=jnp.asarray(rho_liq),
                       pressure=jnp.asarray(pressure), steps=worker.FIT_STEPS,
                       mesh=jax_batch_mesh())
    return {"start": worker.START, "t": temperature, "pressure": pressure,
            "rho_liq": rho_liq, "theta": res.parameters, "loss": res.loss_history}


def test_fit_matches_jax_mesh(ranks):
    temperature, pressure, rho_liq = worker.density_data(16)
    ref = vendored("parallel", exact={"start": worker.START, "t": temperature,
                                      "pressure": pressure}, close={"rho_liq": rho_liq})
    np.testing.assert_allclose(ranks[0]["density16_loss"], ref["loss"], rtol=1e-8, atol=0)
    np.testing.assert_allclose(ranks[0]["density16_theta"], ref["theta"], rtol=1e-8, atol=0)


def test_workers_import_no_jax(ranks):
    """The mesh, the fits and the solvers ran without JAX or feos_tpu."""
    for got in ranks:
        assert got["jax_modules"].size == 0, got["jax_modules"]


def test_single_process_is_a_no_op():
    """Without an address or a group: (0, 1), and a mesh of this process
    alone whose blocks are the whole batch."""
    assert initialize_multi_host() == (0, 1)
    assert not torch.distributed.is_initialized()
    mesh = batch_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.distributed) == (0, 1, False)
    x = np.arange(6.0)
    np.testing.assert_array_equal(gather_batch(shard_batch(x, mesh), mesh).numpy(), x)
    out = data_parallel(lambda a, s: (a * s, a > 2), mesh, 1)(x, 2.0)
    np.testing.assert_array_equal(out[0].numpy(), 2 * x)


def test_failed_initialization_raises():
    """A rendezvous that cannot happen raises: the process does not go on
    alone."""
    with pytest.raises(ValueError, match="num_processes"):
        initialize_multi_host("localhost:1")
    with pytest.raises((RuntimeError, ValueError)):
        initialize_multi_host(num_processes=1, process_id=0, backend="gloo",
                              init_method="nowhere://store")
    assert not torch.distributed.is_initialized()


def test_uneven_batch_raises():
    mesh = BatchMesh(0, 2, None, torch.device("cpu"), False)
    with pytest.raises(ValueError, match="pad_to_multiple"):
        shard_batch(np.arange(5.0), mesh)
