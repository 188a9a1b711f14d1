"""Peaks of the card and the work the main path's kernels must do.

A kernel's roofline share is the least time the card could take for the
work the inputs need, max(f64 operations / peak f64 rate, bytes / peak
memory rate), over the time the kernel took.  The operation counts are
frozen tallies of the port's kernel header (``csrc/phi_d2_ops.cpp`` and
``csrc/vp_identity_ops.cpp`` build the headers on a scalar that counts
every +, -, *, / and fmin; ``h100bench/tests`` holds these numbers to them),
so a later change to a kernel changes its time and never its work.  How
many phi evaluations a row needs comes from the benchmark's own reference
solve of the same rows, never from the kernel's counters.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet: f64 outside the tensor cores, and HBM3
PEAK_F64_FLOPS = 34e12
PEAK_BYTES_PER_S = 3.35e12

# phi, phi', phi'' of one row at one density (pcsaft_pure_d3.cuh): the row
# stage once a row and launch, the density stage at every evaluation, the
# dipole term on rows with mu != 0, the association term on rows with
# kappa_ab (exp(eps_ab/T) - 1) != 0, shorter where na = nb
OPS_ROW = 146
OPS_ELEMENT = 321
OPS_DIPOLE = 94
OPS_ASSOC = 165
OPS_ASSOC_SYMMETRIC = 93
BYTES_ROW = 72          # 8 parameters and T
BYTES_ELEMENT = 32      # rho in; phi, phi', phi'' out
# pure_vle: the row's inputs; rho_V, rho_L, the mask and three int32 counters out
BYTES_VLE_ROW = 72 + 16 + 1 + 12
ETA_GRID_BYTES = 48 * 8
# vp_identity (vp_identity.cuh, the adjoint): p~ and its 9 partials of a
# non-polar, non-associating row; what a dipole and the association add
# (less where na = nb); what a row with m > 2 saves
OPS_VP_ROW = 630
OPS_VP_DIPOLE = 384
OPS_VP_ASSOC = 173
OPS_VP_ASSOC_SYMMETRIC = 151
OPS_VP_SAVED_M2 = 4
OPS_VP_SAVED_M2_DIPOLE = 52
BYTES_VP_ROW = 21 * 8   # 8 parameters, T, rho_V, rho_L in; p~ and 9 partials out


def bound_s(ops: float, nbytes: float) -> float:
    """The least time, in seconds, for ``ops`` f64 operations and ``nbytes``."""
    return max(ops / PEAK_F64_FLOPS, nbytes / PEAK_BYTES_PER_S)


def _regimes(params, temperature):
    mu, kappa, eps_ab, na, nb = (params[:, j] for j in (3, 4, 5, 6, 7))
    dipolar = mu != 0.0
    associating = (kappa * (torch.exp(eps_ab / temperature) - 1.0)) != 0.0
    return dipolar, associating, na == nb


def ops_per_evaluation(params, temperature):
    """``(B,)`` f64 operations of one phi, phi', phi'' evaluation of each row."""
    dipolar, associating, symmetric = _regimes(params, temperature)
    assoc = torch.where(symmetric, OPS_ASSOC_SYMMETRIC, OPS_ASSOC) * associating
    return OPS_ELEMENT + dipolar * OPS_DIPOLE + assoc


def pure_vle_work(params, temperature, evaluations):
    """``(ops, bytes)`` of the whole pure VLE solve of these rows, with
    ``evaluations (B,)`` phi evaluations a row."""
    per = ops_per_evaluation(params, temperature).double()
    ops = params.shape[0] * OPS_ROW + float((evaluations.double() * per).sum())
    return ops, params.shape[0] * BYTES_VLE_ROW + ETA_GRID_BYTES


def density_solve_work(params, temperature, evaluations):
    """``(ops, bytes)`` of a density solve that takes one (B, 1) evaluation
    a row and launch (phi_d2 at k = 1): the row stage and one density each
    time, each input read and each output written each time."""
    per = (ops_per_evaluation(params, temperature) + OPS_ROW).double()
    n = evaluations.double()
    return float((n * per).sum()), float(n.sum()) * (BYTES_ROW + BYTES_ELEMENT)


def vp_identity_ops(params):
    """``(B,)`` f64 operations of p~ and its partials for each row."""
    m, mu, kappa, eps_ab, na, nb = (params[:, j] for j in (0, 3, 4, 5, 6, 7))
    dipolar = (mu != 0.0).long()
    assoc = torch.where(na == nb, OPS_VP_ASSOC_SYMMETRIC, OPS_VP_ASSOC)
    return (OPS_VP_ROW + dipolar * OPS_VP_DIPOLE
            + assoc * ((kappa != 0.0) | (eps_ab != 0.0))
            - (m > 2.0).long() * (OPS_VP_SAVED_M2 + dipolar * OPS_VP_SAVED_M2_DIPOLE))


def vp_identity_work(params):
    """``(ops, bytes)`` of the identity's kernel on these rows."""
    return float(vp_identity_ops(params).sum()), params.shape[0] * BYTES_VP_ROW


def share(trace, family, kernels):
    """Percent of its roofline that the kernels of these function names
    reach in the traced window: the least time for ``family``'s work a step
    (``trace.work``) over their device time a step; None where the trace
    holds none of them or the cell has no such work."""
    seconds = trace.kernel_seconds(kernels)
    work = trace.work.get(family)
    if seconds <= 0 or work is None:
        return None
    return 100.0 * bound_s(*work) / seconds
