"""phi_d2: (phi, phi', phi'') of pure PC-SAFT for a ``(B, k)`` density batch.

The wrapper of the CUDA kernels in ``feos_tpu_torch/csrc/phi_d2.cu``, the port
of the repo's one TPU kernel (``benchmarks/pallas_experiment.py::_kernel``).
Every phi evaluation inside the VLE solve goes through it.

On a CPU tensor it takes :func:`phi_d2_plain`, the same function in torch
ops.  On a CUDA tensor it launches the kernel variant the library picks for
``k`` or raises; it never falls back.  Each call is the tracer's span
``feos.kernel.phi_d2``; each launch counts ``launch.phi_d2`` and
``launch.phi_d2.k<k>`` (:mod:`feos_tpu_torch.tracing`).
"""

from __future__ import annotations

import torch

from .. import tracing
from ..models.pcsaft_pure import PureParams, phi_pure_pre, precompute_pure
from ..ops.derivatives import value_and_2derivs
from .build import library


# Floor of max_scaled_error, as a fraction of the largest |b|.
SCALE_FLOOR = 1e-3


def max_scaled_error(a, b):
    """``max |a - b| / (|b| + SCALE_FLOOR * max|b|)``: the scale-aware
    relative error the kernel is held to against its plain version (the
    form of ``benchmarks/pallas_experiment.py``'s check).

    The floor keeps elements where phi' or phi'' crosses zero from turning
    f64 rounding into a large relative error: those are sums of terms of
    the array's scale, and two f64 orderings of them differ by about 1e-14
    of that scale.  Elements above the floor are held to the bound
    relatively, smaller ones to ``bound * SCALE_FLOOR`` of the scale.
    """
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    scale = b.abs().max()
    return float(((a - b).abs() / (b.abs() + SCALE_FLOOR * scale)).max())


@torch.no_grad()
def phi_d2_plain(params, temperature, rho):
    """The kernel's function in torch ops: ``value_and_2derivs`` over
    ``phi_pure_pre``.  Like the kernel, it returns detached tensors."""
    pre = precompute_pure(PureParams.from_tensor(params), temperature)
    return value_and_2derivs(lambda r: phi_pure_pre(pre, r), rho)


def _check(params, temperature, rho):
    if rho.dim() != 2:
        raise ValueError(f"rho must be (B, k), got {tuple(rho.shape)}")
    B = rho.shape[0]
    if tuple(params.shape) != (B, 8) or tuple(temperature.shape) != (B,):
        raise ValueError(
            f"want params (B, 8) and temperature (B,) for rho (B, k) = "
            f"{tuple(rho.shape)}, got {tuple(params.shape)} and "
            f"{tuple(temperature.shape)}"
        )
    for name, t in (("params", params), ("temperature", temperature), ("rho", rho)):
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.device != rho.device:
            raise ValueError(f"{name} on {t.device}, rho on {rho.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@tracing.traced("kernel")
def phi_d2(params, temperature, rho):
    """``(phi, phi', phi'')`` at ``rho (B, k)`` for ``params (B, 8)`` and
    ``temperature (B,)``, all contiguous float64 on one device."""
    _check(params, temperature, rho)
    if rho.device.type == "cpu":
        return phi_d2_plain(params, temperature, rho)
    if rho.device.type != "cuda":
        raise ValueError(f"phi_d2 runs on cpu or cuda, not {rho.device}")
    lib = library()
    B, k = rho.shape
    out = torch.empty((3, B, k), dtype=torch.float64, device=rho.device)
    stream = torch.cuda.current_stream(rho.device).cuda_stream
    err = lib.feos_phi_d2(
        params.data_ptr(), temperature.data_ptr(), rho.data_ptr(),
        out.data_ptr(), B, k, rho.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"phi_d2 kernel launch failed: cudaError {err}")
    tracing.launched("phi_d2", k=k)
    return out[0], out[1], out[2]
