"""vp_identity: the vapor-pressure identity p~ and its 9 partials, as the
main path's backward.

At converged densities (rho_V, rho_L) the reduced vapor pressure is

    p~ = -(a_V - a_L + ln(rho_V/rho_L)) / (1/rho_V - 1/rho_L),  a = phi/rho,

stationary in both densities, so its partials in the 8 parameters and T
at fixed densities are the implicit-function derivative of the solve.
:func:`vp_identity` returns p~ and those partials, ``(B, 9)``: on a CUDA
tensor from one launch of the kernel in ``feos_tpu_torch/csrc/
vp_identity.cu`` (a hand-written adjoint, ``csrc/vp_identity.cuh``), which it
counts as the tracer's ``launch.vp_identity``, or raises; on a CPU tensor
from :func:`vp_identity_plain`, autograd of the identity in torch ops.  Each
call is the tracer's span ``feos.kernel.vp_identity``.
:class:`VaporPressureIdentity` uses them as the forward and backward of
``vapor_pressure``'s re-attachment on the card.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .. import tracing
from .build import library

SLOTS = 9  # the partials: [m, sigma, epsilon_k, mu, kappa_ab, epsilon_k_ab, na, nb, T]


def identity_plain(parameters, temperature, rho_v, rho_l):
    """The identity's p~ in torch ops, differentiable in ``parameters`` and
    ``temperature``: the plain version of the kernel's value."""
    from ..models.pcsaft_pure import PureParams, phi_pure

    p = PureParams.from_tensor(parameters)
    a_l = phi_pure(p, temperature, rho_l) / rho_l
    a_v = phi_pure(p, temperature, rho_v) / rho_v
    return -(a_v - a_l + torch.log(rho_v / rho_l)) / (1.0 / rho_v - 1.0 / rho_l)


def vp_identity_plain(params, temperature, rho_v, rho_l):
    """The kernel's function in torch ops: ``(p~, partials (B, 9))`` from
    autograd of :func:`identity_plain` (rows are independent, so the
    gradient of the sum holds each row's partials).  Detached."""
    with torch.enable_grad():
        p = params.detach().requires_grad_()
        t = temperature.detach().requires_grad_()
        ptilde = identity_plain(p, t, rho_v.detach(), rho_l.detach())
        d_p, d_t = torch.autograd.grad(ptilde.sum(), (p, t))
    return ptilde.detach(), torch.cat([d_p, d_t[:, None]], 1)


def _check(params, temperature, rho_v, rho_l):
    B = temperature.shape[0] if temperature.dim() == 1 else -1
    if tuple(params.shape) != (B, 8) or temperature.dim() != 1:
        raise ValueError(
            f"want params (B, 8) and temperature (B,), got {tuple(params.shape)} and "
            f"{tuple(temperature.shape)}"
        )
    for name, t in (("params", params), ("temperature", temperature), ("rho_v", rho_v),
                    ("rho_l", rho_l)):
        if name.startswith("rho") and tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be (B,) = ({B},), got {tuple(t.shape)}")
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.device != params.device:
            raise ValueError(f"{name} on {t.device}, params on {params.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@tracing.traced("kernel")
def vp_identity(params, temperature, rho_v, rho_l):
    """``(p~ (B,), partials (B, 9))`` for ``params (B, 8)`` at ``temperature``,
    ``rho_v`` and ``rho_l`` ``(B,)``, all contiguous float64 on one device;
    the partials are d p~ / d[m, sigma, epsilon_k, mu, kappa_ab,
    epsilon_k_ab, na, nb, T] at fixed densities."""
    _check(params, temperature, rho_v, rho_l)
    if params.device.type == "cpu":
        return vp_identity_plain(params, temperature, rho_v, rho_l)
    if params.device.type != "cuda":
        raise ValueError(f"vp_identity runs on cpu or cuda, not {params.device}")
    lib = library()
    B, dev = params.shape[0], params.device
    ptilde = torch.empty(B, dtype=torch.float64, device=dev)
    partials = torch.empty((B, SLOTS), dtype=torch.float64, device=dev)
    err = lib.feos_vp_identity(
        params.data_ptr(), temperature.data_ptr(), rho_v.data_ptr(), rho_l.data_ptr(),
        ptilde.data_ptr(), partials.data_ptr(), B, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"vp_identity kernel launch failed: cudaError {err}")
    tracing.launched("vp_identity")
    return ptilde, partials


class VaporPressureIdentity(torch.autograd.Function):
    """p~ of the identity at detached densities, differentiable in the
    parameters and T through the partials :func:`vp_identity` returns with
    it: the backward is ``grad * partials``, no graph."""

    @staticmethod
    def forward(ctx, params, temperature, rho_v, rho_l):
        ptilde, partials = vp_identity(
            *(x.detach().contiguous() for x in (params, temperature, rho_v, rho_l)))
        ctx.save_for_backward(partials)
        return ptilde

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (partials,) = ctx.saved_tensors
        d = grad[:, None] * partials
        d_params = d[:, :8] if ctx.needs_input_grad[0] else None
        d_t = d[:, 8] if ctx.needs_input_grad[1] else None
        return d_params, d_t, None, None


def attach(parameters, temperature, rho_v, rho_l):
    """The identity's p~ at the converged densities, with the parameters'
    and T's gradients: :class:`VaporPressureIdentity` on the card, the
    plain graph (:func:`identity_plain`) on the CPU."""
    if parameters.device.type == "cpu":
        return identity_plain(parameters, temperature, rho_v, rho_l)
    return VaporPressureIdentity.apply(parameters, temperature, rho_v.detach(), rho_l.detach())
