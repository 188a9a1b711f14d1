"""pure_vle: the whole pure-component VLE solve of a row batch in one call.

The wrapper of the CUDA kernels in ``feos_tpu_torch/csrc/pure_vle.cu``,
which compute ``solvers/vle.py::pure_vle_plain`` step for step
(``csrc/pure_vle.cuh``): a spinodal scan with 16 threads a row, then the
solve with one thread a row, on the caller's stream.  ``solvers.vle.pure_vle``
calls it, so every pure VLE caller (``vapor_pressure``,
``equilibrium_liquid_density``, ``boiling_temperature``, the diagrams' pure
seeds, ``fit_pure``) gets the kernels on the card.

On a CPU tensor it takes ``pure_vle_plain``.  On a CUDA tensor it launches
the kernels or raises; it never falls back.  Each call is the tracer's
span ``feos.kernel.pure_vle``; each launch counts ``launch.pure_vle`` and
leaves its per-row counts with the tracer (:mod:`feos_tpu_torch.tracing`).
"""

from __future__ import annotations

import torch

from .. import tracing
from .build import library

_GRIDS = {}  # the spinodal grid on each device it was asked for
BOTH = 3  # feos_pure_vle's `stages`: the scan (1) and the solve (2)


def _check(params, temperature):
    B = temperature.shape[0] if temperature.dim() == 1 else -1
    if tuple(params.shape) != (B, 8) or temperature.dim() != 1:
        raise ValueError(
            f"want params (B, 8) and temperature (B,), got {tuple(params.shape)} and "
            f"{tuple(temperature.shape)}"
        )
    for name, t in (("params", params), ("temperature", temperature)):
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.device != params.device:
            raise ValueError(f"{name} on {t.device}, params on {params.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _eta_grid(device):
    """``_ETA_GRID``, numpy's 48 values to the bit, on ``device``."""
    if device not in _GRIDS:
        from ..solvers.vle import _ETA_GRID

        _GRIDS[device] = torch.as_tensor(_ETA_GRID, dtype=torch.float64, device=device)
    return _GRIDS[device]


def launch(params, temperature):
    """The kernels on one row batch: ``(rho_v, rho_l, ok, iters)`` with
    ``iters (B, 3)`` int32 = [NPT iterations, Newton iterations, phi
    evaluations] of each row.  ``params (B, 8)`` and ``temperature (B,)`` are
    contiguous float64 on one CUDA device."""
    _check(params, temperature)
    if params.device.type != "cuda":
        raise ValueError(f"the pure_vle kernel runs on cuda, not {params.device}")
    lib = library()
    B, dev = params.shape[0], params.device
    spinodal = torch.empty((B, 3), dtype=torch.float64, device=dev)  # the scan's result
    rho_v = torch.empty(B, dtype=torch.float64, device=dev)
    rho_l = torch.empty(B, dtype=torch.float64, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    iters = torch.empty((B, 3), dtype=torch.int32, device=dev)
    err = lib.feos_pure_vle(
        params.data_ptr(), temperature.data_ptr(), _eta_grid(dev).data_ptr(),
        spinodal.data_ptr(), rho_v.data_ptr(), rho_l.data_ptr(), ok.data_ptr(),
        iters.data_ptr(), B, BOTH, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pure_vle kernel launch failed: cudaError {err}")
    tracing.launched("pure_vle", iters=iters)
    return rho_v, rho_l, ok, iters


@tracing.traced("kernel")
def pure_vle(params, temperature, stats=None):
    """``(rho_v, rho_l, ok)`` of ``params (B, 8)`` at ``temperature (B,)``,
    contiguous float64 on one device.

    If ``stats`` is a dict: on the card it receives the largest NPT and
    Newton iteration counts of any row as ``npt`` and ``newton`` (one sync)
    and ``pure_vle_launches`` (also the tracer's ``pure_vle.*`` counters);
    on the CPU, ``pure_vle_plain``'s keys.
    """
    _check(params, temperature)
    if params.device.type == "cpu":
        from ..solvers.vle import pure_vle_plain

        return pure_vle_plain(params, temperature, stats=stats)
    rho_v, rho_l, ok, iters = launch(params, temperature)
    if stats is not None:
        tracing.count("sync.pure_vle_stats")
        npt, newton, _ = iters.max(0).values.tolist() if len(iters) else (0, 0, 0)
        tracing.report(stats, "pure_vle", npt=npt, newton=newton, pure_vle_launches=1)
    return rho_v, rho_l, ok
