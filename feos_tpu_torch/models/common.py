"""Shared PC-SAFT mixture building blocks: dipole integrals and association
strengths.

Counterpart of ``feos_tpu/models/common.py``.  The JAX package writes these
per item over a static component axis and maps them with ``vmap``; here the
component axis is the last axis of ``(B, n)`` tensors, and the batch is
written out.  ``exp_full`` is not ported: it works around the TPU's
scalar ``exp``, and ``torch.exp`` is full f64 on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from ..constants import AD, BD, CD

PI = np.pi
F64 = torch.float64


class DipolePre(NamedTuple):
    """Density-independent dipole quantities (see :func:`precompute_dipole`).

    ``pc`` is ``(B, n_pairs, 5)``: one J2 eta-coefficient vector per
    unordered component pair (i <= j, row-major), scaled by the pair's
    1/sigma^3 and multiplicity; ``tc`` ``(B, n_triplets, 4)`` is the J3
    analogue over i <= j <= k.  ``mu2t`` ``(B, n)`` is the per-component
    mu^2 term over its largest component ``mu2_max`` ``(B,)``, so that the
    pair and triplet sums stay O(1) at trace dipolar composition.
    """

    pc: torch.Tensor
    tc: torch.Tensor
    mu2t: torch.Tensor
    mu2_max: torch.Tensor


def _pairs(n):
    return [(i, j) for i in range(n) for j in range(i, n)]


def _triplets(n):
    return [(i, j, k) for i in range(n) for j in range(i, n) for k in range(j, n)]


def precompute_dipole(m, sigma, epsilon_k, mu2_scaled, temperature) -> DipolePre:
    """The rho-free half of the dipole term, for ``(B, n)`` parameter
    columns and ``(B,)`` temperatures."""
    n = m.shape[-1]
    dev = m.device
    tracing.count("sync.precompute_dipole", 3)  # three copies from host memory to the card
    cAD, cBD, cCD = (torch.as_tensor(c, dtype=F64, device=dev) for c in (AD, BD, CD))
    t = temperature[:, None]

    mu2_term = mu2_scaled / t
    mc = torch.clamp(m, max=2.0)
    mu2_max = mu2_term.amax(-1)
    mu2_max = torch.where(mu2_max > 0.0, mu2_max, 1.0)
    mu2_term = mu2_term / mu2_max[:, None]

    pc = []
    for i, j in _pairs(n):
        sigma_ij_3 = (0.5 * (sigma[:, i] + sigma[:, j])) ** 3
        mij = torch.sqrt(mc[:, i] * mc[:, j])
        mij1 = ((mij - 1.0) / mij)[:, None]
        mij2 = mij1 * ((mij - 2.0) / mij)[:, None]
        eps_ij_t = (torch.sqrt(epsilon_k[:, i] * epsilon_k[:, j]) / temperature)[:, None]
        a = cAD[:, 0] + mij1 * cAD[:, 1] + mij2 * cAD[:, 2]
        b = cBD[:, 0] + mij1 * cBD[:, 1] + mij2 * cBD[:, 2]
        c = 1.0 if i == j else 2.0
        pc.append((eps_ij_t * b + a) * (c / sigma_ij_3)[:, None])

    tc = []
    for i, j, k in _triplets(n):
        sigma_ij = 0.5 * (sigma[:, i] + sigma[:, j])
        sigma_ik = 0.5 * (sigma[:, i] + sigma[:, k])
        sigma_jk = 0.5 * (sigma[:, j] + sigma[:, k])
        mijk = (mc[:, i] * mc[:, j] * mc[:, k]) ** (1.0 / 3.0)
        mijk1 = ((mijk - 1.0) / mijk)[:, None]
        mijk2 = mijk1 * ((mijk - 2.0) / mijk)[:, None]
        c3 = {1: 1.0, 2: 3.0, 3: 6.0}[len({i, j, k})]
        tc.append(
            (cCD[:, 0] + mijk1 * cCD[:, 1] + mijk2 * cCD[:, 2])
            * (c3 / (sigma_ij * sigma_ik * sigma_jk))[:, None]
        )

    return DipolePre(pc=torch.stack(pc, 1), tc=torch.stack(tc, 1),
                     mu2t=mu2_term, mu2_max=mu2_max)


def phi_dipole_pre(dp: DipolePre, rho, etas, col):
    """Dipolar contribution from precomputed coefficients.

    ``rho`` is ``(B, ..., n)`` and ``etas`` ``(B, ..., 7)`` (powers of the
    packing fraction); ``col`` reshapes a ``(B, *rest)`` row quantity to
    broadcast against ``rho``'s middle axes.  The sums accumulate on the
    dipolar composition weights v = (w mu2t) / sum(w mu2t), which sum to
    one; the powers of (rho_t wd mu2_max) reattach at the end, and rows
    without a dipole give exactly zero with finite derivatives.
    """
    n = rho.shape[-1]
    rho_t = rho.sum(-1)
    u = (rho / rho_t[..., None]) * col(dp.mu2t)
    wd = u.sum(-1)
    v = u / torch.where(wd > 0.0, wd, 1.0)[..., None]
    v2 = torch.stack([v[..., i] * v[..., j] for i, j in _pairs(n)], -1)
    v3 = torch.stack([v[..., i] * v[..., j] * v[..., k] for i, j, k in _triplets(n)], -1)
    j2 = (col(dp.pc) * etas[..., None, :5]).sum(-1)
    j3 = (col(dp.tc) * etas[..., None, :4]).sum(-1)
    s2h = -PI * (v2 * j2).sum(-1)
    s3h = -(4.0 / 3.0 * PI * PI) * (v3 * j3).sum(-1)
    scale = rho_t * wd * col(dp.mu2_max)
    phi2 = scale * scale * s2h
    ratio = scale * s3h / torch.where(s2h != 0.0, s2h, 1.0)
    return phi2 / (1.0 - ratio)


def assoc_strength_tfactor(i, j, temperature, sigma, kappa_ab, epsilon_k_ab,
                           epsilon_k_aibj=None):
    """Density-independent factor of the association strength Delta_AiBj
    for ``(B, n)`` parameter columns: sigma_ij^3 kappa_ij (exp(eps_ij/T) -
    1), ``(B,)``.  A nonzero ``epsilon_k_aibj`` ``(B,)`` overrides the
    arithmetic-mean cross energy for i != j.  Callers sanitise ``kappa_ab``
    on masked rows (kappa > 0) so that the sqrt has finite gradients."""
    sigma3_kappa = (sigma[:, i] * sigma[:, j]) ** 1.5 * torch.sqrt(
        kappa_ab[:, i] * kappa_ab[:, j]
    )
    eps = 0.5 * (epsilon_k_ab[:, i] + epsilon_k_ab[:, j])
    if epsilon_k_aibj is not None and i != j:
        eps = torch.where(epsilon_k_aibj != 0.0, epsilon_k_aibj, eps)
    return sigma3_kappa * (torch.exp(eps / temperature) - 1.0)


def assoc_strength_from_tfactor(tfac, dd_ij, zeta2, zeta3_m1):
    """Reattach the density-dependent hard-sphere contact factor to a
    precomputed association T-factor; ``dd_ij = d_i d_j / (d_i + d_j)``."""
    k = dd_ij * zeta2 * zeta3_m1
    return zeta3_m1 * (k * (2.0 * k + 3.0) + 1.0) * tfac


def site_fraction_free_energy(x):
    """f(X) = ln X - X/2 + 1/2 per association site."""
    return torch.log(x) - 0.5 * x + 0.5
