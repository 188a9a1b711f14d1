"""One process of ``tests/test_torch_parallel.py``'s two-process gloo group.

    python tests/_torch_parallel_worker.py RANK WORLD_SIZE INIT_METHOD OUT_DIR

joins the group at ``INIT_METHOD`` (a ``file://`` store), runs every case
below with a mesh over the group on the CPU, and writes what it got to
``OUT_DIR/rank<RANK>.npz``; the test runs the same cases in one process and
compares.  The cases live here so that both sides build the same data.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

README = np.array([1.5, 3.5, 250.0, 0.0, 0.03, 1500.0, 1.0, 1.0])
START = README * np.array([1.0, 1.0, 0.98, 1.0, 1.0, 1.0, 1.0, 1.0])
FIT_STEPS = 3
# tests/test_torch_binary_regression.py's non-associating pair
COMP = np.array([[1, 3.5, 150, 0, 0, 0, 0, 0], [1, 3.5, 200, 0, 0, 0, 0, 0]], dtype=float)
BINARY_STEPS = 2


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def vp_rows():
    """13 README rows from 250 to 400 K: ``(params (13, 8), T (13,))``."""
    return np.tile(README, (13, 1)), np.linspace(250.0, 400.0, 13)


def pure_data(n):
    """``(T, p_sat)`` of the README fluid at n temperatures from 250 to 400 K,
    the port's vapor pressures."""
    import feos_tpu_torch as ft

    temperature = np.linspace(250.0, 400.0, n)
    with torch.no_grad():
        nans, p = ft.vapor_pressure(_t(np.tile(README, (n, 1))), _t(temperature))
    assert not nans.any()
    return temperature, p.numpy()


def density_data(n):
    """``(T, p, rho_liq)`` of the README fluid compressed to 5 MPa at n
    temperatures from 250 to 350 K, the port's liquid densities."""
    import feos_tpu_torch as ft

    temperature, pressure = np.linspace(250.0, 350.0, n), np.full(n, 5e6)
    with torch.no_grad():
        nans, rho = ft.liquid_density(_t(np.tile(README, (n, 1))), _t(temperature),
                                      _t(pressure))
    assert not nans.any()
    return temperature, pressure, rho.numpy()


def per_row_start(n):
    """Per-row start parameters: START with epsilon_k spread by +-1%."""
    start = np.tile(START, (n, 1))
    start[:, 2] *= np.linspace(0.99, 1.01, n)
    return start


def binary_data(n):
    """``(T, x1, p_bubble)`` of COMP at kij = -0.1, the port's bubble
    pressures."""
    import feos_tpu_torch as ft

    temperature, x1 = np.linspace(140.0, 160.0, n), np.linspace(0.2, 0.8, n)
    with torch.no_grad():
        p, nans = ft.bubble_point(_t(np.tile(COMP, (n, 1, 1))),
                                  _t(np.tile([-0.1, 0.0], (n, 1))), _t(temperature), _t(x1),
                                  _t(np.full(n, 1e5)))
    assert not nans.any()
    return temperature, x1, p.numpy()


def fits(mesh, multiple):
    """Every fit of the test with ``mesh`` (None: one process), its data
    padded to a multiple of ``multiple`` rows: fit_pure on 15 vapor
    pressures (shared and per-row parameters) and on 16 liquid densities,
    fit_binary on 7 bubble pressures."""
    import feos_tpu_torch as ft
    from feos_tpu_torch.parallel import pad_to_multiple

    def pad(x):
        return pad_to_multiple(np.asarray(x), multiple)[0]

    out = {}
    temperature, p_sat = pure_data(15)
    for name, start in (("shared", START), ("per_row", pad(per_row_start(15)))):
        res = ft.fit_pure(start, _t(pad(temperature)), p_sat=_t(pad(p_sat)), steps=FIT_STEPS,
                          mesh=mesh)
        out[f"pure_{name}_theta"] = res.parameters.numpy()
        out[f"pure_{name}_loss"] = res.loss_history.numpy()
    temperature, pressure, rho_liq = density_data(16)
    res = ft.fit_pure(START, _t(temperature), rho_liq=_t(rho_liq), pressure=_t(pressure),
                      steps=FIT_STEPS, mesh=mesh)
    out["density16_theta"] = res.parameters.numpy()
    out["density16_loss"] = res.loss_history.numpy()
    temperature, x1, p_bubble = (pad(x) for x in binary_data(7))
    res = ft.fit_binary(COMP, temperature, x1, p_bubble, kij0=0.0, steps=BINARY_STEPS,
                        device="cpu", mesh=mesh)
    out["binary_theta"], out["binary_loss"] = res.parameters.numpy(), res.loss_history.numpy()
    return out


def main(rank, world_size, init_method, out_dir):
    torch.set_num_threads(1)
    import feos_tpu_torch as ft
    from feos_tpu_torch.parallel import (
        batch_mesh, data_parallel, gather_batch, initialize_multi_host, pad_to_multiple,
        shard_batch,
    )

    got = initialize_multi_host(num_processes=world_size, process_id=rank, backend="gloo",
                                init_method=init_method)
    assert got == (rank, world_size), got
    try:
        mesh = batch_mesh(device="cpu")
        out = {"rank": np.array([mesh.rank, mesh.world_size])}
        x, n_valid = pad_to_multiple(np.arange(39.0).reshape(13, 3), world_size)
        block = shard_batch(x, mesh)
        out["block"] = block.numpy()
        out["round_trip"] = gather_batch(block, mesh).numpy()
        out["mask_round_trip"] = gather_batch(torch.isnan(block[:, 0]), mesh).numpy()
        params, temperature = vp_rows()
        nans, p = data_parallel(ft.vapor_pressure, mesh, 2)(
            pad_to_multiple(params, world_size)[0], pad_to_multiple(temperature, world_size)[0])
        out["vp_nans"], out["vp"] = nans.numpy(), p.detach().numpy()
        out.update(fits(mesh, world_size))
        out["jax_modules"] = np.array(sorted(m for m in sys.modules
                                             if m.split(".")[0] in ("jax", "feos_tpu")))
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        torch.distributed.destroy_process_group()
    print(f"rank {rank} of {world_size}: done", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
