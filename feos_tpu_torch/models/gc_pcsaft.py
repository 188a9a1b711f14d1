"""Heterosegmented gc-PC-SAFT in PyTorch: parameter assembly, Helmholtz
energy density, its derivative set, and bubble and dew pressures and
temperatures and the pT flash of n-component mixtures, with gradients in
the segment parameters, k_ab and phi.

Counterpart of ``feos_tpu/models/gc_pcsaft.py``.  The molecule topologies
are host data, built once per distinct topology (:class:`GcTopology`) and
gathered onto the rows by index; everything derived from parameters
(:func:`assemble`, :func:`precompute_gc`) is torch ops, so gradients in the
``(S, 8)`` segment parameters, the k_ab record values and phi flow
through it.  The batch is the first axis of every tensor and a density is
``(B, ..., n)``; everything is ``torch.float64`` on the device of the
inputs.

* The dipolar and association regimes are computed on every row of a
  regime some row reaches (``GcPre.branches``, found by
  :func:`precompute_gc` from its own row masks), with the JAX package's
  sanitisation of masked rows, and selected per row with ``torch.where``.
  The cross and induced terms read each row's associating pair wherever it
  sits (``GcPre.pair``); three or more associating components raise
  ``ValueError`` (the JAX package reads slots 0 and 1).
* Bubble and dew points run the detached f64 solver and re-attach the
  gradient through the stationary identity shared with the mixture model
  (:func:`feos_tpu_torch.models.pcsaft_mix.reattach_incipient`); the
  flash (:func:`gc_flash`) is the mixture model's over the gc phi.
"""

from __future__ import annotations

from collections import Counter
from functools import partial
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .. import tracing
from ..constants import A0, A1, A2, B0, B1, B2
from ..ops.association import cross_assoc_sym_iterate, solve_cross_assoc_sym
from ..ops.derivatives import pressure_set
from ..solvers.flash import flash_model
from ..solvers.vle import mix_vle
from ..units import MU2_FACTOR
from .common import (
    DipolePre, assoc_strength_from_tfactor, phi_dipole_pre, precompute_dipole,
)
from .pcsaft_mix import (
    BRANCHES, TOO_MANY_ASSOCIATING, _columns, _f64, associating_pair, induced_assoc_term,
    mixture_inputs, needs_grad, pair_block, pair_slots, q_f1, reattach_incipient,
)

PI = np.pi
F64 = torch.float64


class GcTopology(NamedTuple):
    """Molecule topologies of a batch of rows, as host numpy.

    Each distinct topology is counted once: ``counts (U, n, S)`` segment
    counts and ``bonds_p (U, n, P)`` bond counts on the bonded segment pairs
    ``(bond_a, bond_b)`` (the pairs bonded in any row, row-major over the
    lower triangle of (S, S); the dummy pair (0, 0) where no molecule has a
    bond).  ``rows (B,)`` is each row's topology.
    """

    segment_identifier: tuple
    counts: np.ndarray
    bonds_p: np.ndarray
    bond_a: np.ndarray
    bond_b: np.ndarray
    rows: np.ndarray

    @classmethod
    def build(cls, segment_identifier, segment_lists, bond_lists) -> "GcTopology":
        """From per-row lists of per-component segment names and bond index
        pairs (reference feos_torch/gc_pcsaft.py:26-86)."""
        seg_idx = {s: i for i, s in enumerate(segment_identifier)}
        unique, rows = {}, np.empty(len(segment_lists), dtype=np.int64)
        for b, (segs, bonds) in enumerate(zip(segment_lists, bond_lists, strict=True)):
            key = tuple((tuple(c), tuple(tuple(bd) for bd in cb))
                        for c, cb in zip(segs, bonds, strict=True))
            rows[b] = unique.setdefault(key, len(unique))
        n = {len(key) for key in unique}
        if len(n) != 1:
            raise ValueError("every row must have the same number of components")
        counts = np.zeros((len(unique), n.pop(), len(seg_idx)))
        pair_counts = Counter()  # (topology, component, hi, lo) -> bonds
        for u, key in enumerate(unique):
            for c, (comp_segs, comp_bonds) in enumerate(key):
                unknown = set(comp_segs) - seg_idx.keys()
                if unknown:
                    raise ValueError(f"unknown segments {sorted(unknown)}")
                for s in comp_segs:
                    counts[u, c, seg_idx[s]] += 1.0
                for i, j in comp_bonds:
                    hi, lo = sorted((seg_idx[comp_segs[i]], seg_idx[comp_segs[j]]))[::-1]
                    pair_counts[u, c, hi, lo] += 1
        pairs = sorted({(hi, lo) for _, _, hi, lo in pair_counts}) or [(0, 0)]
        column = {pair: k for k, pair in enumerate(pairs)}
        bonds_p = np.zeros(counts.shape[:2] + (len(pairs),))
        for (u, c, hi, lo), k in pair_counts.items():
            bonds_p[u, c, column[hi, lo]] = k
        bond_a, bond_b = (np.array(x, dtype=np.int64) for x in zip(*pairs))
        return cls(tuple(segment_identifier), counts, bonds_p, bond_a, bond_b, rows)


class GcParams(NamedTuple):
    """Assembled gc parameters: the JAX package's ``GcParams`` with the
    batch first.  Row fields: ``m (B, n, S)`` segment counts times segment
    m, ``bonds_p (B, n, P)``, the dispersion bases ``e1b``/``e2b (B, n,
    n)``, ``phi_corr`` and the component aggregates ``(B, n)``.  Segment
    fields, shared by the rows: ``sigma``/``epsilon_k (S,)``, ``kab (S,
    S)``, and the bonded pairs ``bond_a``/``bond_b (P,)`` (int64)."""

    m: torch.Tensor
    bonds_p: torch.Tensor
    e1b: torch.Tensor
    e2b: torch.Tensor
    phi_corr: torch.Tensor
    m_mix: torch.Tensor
    sigma_mix: torch.Tensor
    epsilon_k_mix: torch.Tensor
    mu2: torch.Tensor
    sigma_assoc: torch.Tensor
    epsilon_k_assoc: torch.Tensor
    kappa_ab: torch.Tensor
    epsilon_k_ab: torch.Tensor
    na: torch.Tensor
    nb: torch.Tensor
    sigma: torch.Tensor
    epsilon_k: torch.Tensor
    kab: torch.Tensor
    bond_a: torch.Tensor
    bond_b: torch.Tensor

    @classmethod
    def from_numpy(cls, params, device="cuda") -> "GcParams":
        """Another package's assembled ``GcParams`` (fields convertible to
        numpy) on ``device``, the card unless the caller asks for the CPU."""
        def field(name):
            x = np.array(getattr(params, name))  # a writable copy
            if name in ("bond_a", "bond_b"):
                return torch.as_tensor(x.astype(np.int64), device=device)
            return _f64(x, device)
        return cls(*(field(name) for name in cls._fields))

    def detach(self) -> "GcParams":
        return GcParams(*(x.detach() for x in self))


def kab_matrix(segment_identifier, pairs, values):
    """The symmetric ``(S, S)`` k_ab from ``pairs`` of segment names and
    their ``(R,)`` ``values`` (zero elsewhere; a later record of the same
    pair wins), differentiable in ``values``."""
    seg_idx = {s: i for i, s in enumerate(segment_identifier)}
    record = np.full((len(seg_idx),) * 2, -1)
    for r, (s1, s2) in enumerate(pairs):
        i, j = seg_idx[s1], seg_idx[s2]
        record[i, j] = record[j, i] = r
    padded = torch.cat([values, values.new_zeros(1)])  # index -1: no record
    tracing.count("sync.kab_matrix")  # the record's copy from host memory
    return padded[torch.as_tensor(record, device=values.device)]


def assemble(topology: GcTopology, parameter, kab, phi=None) -> GcParams:
    """:class:`GcParams` from the topology, the ``(S, 8)`` segment
    parameters ``[m, sigma, epsilon_k, mu, kappa_ab, epsilon_k_ab, na, nb]``,
    the ``(S, S)`` k_ab (:func:`kab_matrix`) and the ``(B, n)`` dispersion
    correction ``phi`` (ones for ``None``); the parameter half of the JAX
    package's ``assemble`` (reference feos_torch/gc_pcsaft.py:13-114)."""
    dev = parameter.device
    tracing.count("sync.assemble", 5)  # five copies of the topology from host memory
    rows = torch.as_tensor(topology.rows, device=dev)
    counts = _f64(topology.counts, dev)[rows]  # (B, n, S)
    m_seg, sigma, epsilon_k, mu, kappa_ab, epsilon_k_ab, na, nb = parameter.unbind(-1)

    m = counts * m_seg
    m_mix = m.sum(2)
    sigma_mix = ((m * sigma**3).sum(2) / m_mix) ** (1.0 / 3.0)
    epsilon_k_mix = (m * epsilon_k).sum(2) / m_mix
    mu2 = (counts * mu**2).sum(2) / m_mix * MU2_FACTOR

    is_assoc = counts * torch.sign(kappa_ab * epsilon_k_ab)
    tracing.count("sync.assemble")
    if bool((is_assoc.sum(2) > 1).any()):
        raise ValueError("Only up to one associating segment per component is allowed!")

    B, n = m_mix.shape
    phi_corr = torch.ones((B, n), dtype=F64, device=dev) if phi is None else phi

    # the dispersion bases (see the JAX package's assemble): the (S, S)
    # segment contraction is density- and temperature-free.  sqrt(eps_a
    # eps_c) takes a zero derivative where the product is zero (a segment
    # with epsilon_k = 0, such as >C<): there it is constant in eps_a, and
    # autograd's eps_c / (2 sqrt(0)) would make every epsilon_k gradient NaN
    eps_ac = epsilon_k[:, None] * epsilon_k[None, :]
    se = torch.where(eps_ac > 0.0, torch.sqrt(torch.where(eps_ac > 0.0, eps_ac, 1.0)), 0.0)
    sigma_ab3 = (0.5 * (sigma[:, None] + sigma[None, :])) ** 3
    kfac = 1.0 - kab

    def base(w):
        return torch.einsum("bia,ac,bjc->bij", m, w * sigma_ab3, m)

    offdiag = (1.0 - torch.eye(n, dtype=F64, device=dev)).bool()
    sqphi = torch.sqrt(phi_corr[:, :, None] * phi_corr[:, None, :])
    e1b = sqphi * torch.where(offdiag, base(se * kfac), base(se))
    e2b = sqphi * sqphi * torch.where(offdiag, base(se * se * kfac * kfac), base(se * se))

    return GcParams(
        m=m, bonds_p=_f64(topology.bonds_p, dev)[rows], e1b=e1b, e2b=e2b,
        phi_corr=phi_corr, m_mix=m_mix, sigma_mix=sigma_mix, epsilon_k_mix=epsilon_k_mix,
        mu2=mu2, sigma_assoc=(is_assoc * sigma).sum(2),
        epsilon_k_assoc=(is_assoc * epsilon_k).sum(2), kappa_ab=(counts * kappa_ab).sum(2),
        epsilon_k_ab=(counts * epsilon_k_ab).sum(2), na=(counts * na).sum(2),
        nb=(counts * nb).sum(2), sigma=sigma, epsilon_k=epsilon_k, kab=kab,
        bond_a=torch.as_tensor(topology.bond_a, device=dev),
        bond_b=torch.as_tensor(topology.bond_b, device=dev),
    )


class GcPre(NamedTuple):
    """Density-independent gc quantities at fixed (assembled parameters,
    T): the JAX package's ``GcPre`` with the batch first."""

    md0: torch.Tensor       # (B, n) total segment number
    md1: torch.Tensor       # (B, n) m @ d
    md2: torch.Tensor       # (B, n) m @ d^2
    md3: torch.Tensor       # (B, n) m @ d^3
    bonds_p: torch.Tensor   # (B, n, P)
    dd_p: torch.Tensor      # (B, P) d_a d_b / (d_a + d_b) on bonded pairs
    e1t: torch.Tensor       # (B, n, n) dispersion base / T
    e2t: torch.Tensor       # (B, n, n) squared base / T^2
    dip: DipolePre
    dipolar: torch.Tensor   # (B,) bool
    na: torch.Tensor        # (B, n)
    nb: torch.Tensor        # (B, n)
    is_assoc: torch.Tensor  # (B, n) sign(kappa_ab * epsilon_k_ab)
    self_st: torch.Tensor   # (B,) sigma_s^3 kappa (exp(eps_ab/T)-1), sanitised
    self_d: torch.Tensor    # (B,) associating-segment diameter, sanitised
    cross_t: torch.Tensor   # (B, n, n) pairwise T-factors (cross regime)
    dd_cross: torch.Tensor  # (B, n, n) d_i d_j/(d_i+d_j) (cross sanitisation)
    ind_t: torch.Tensor     # (B, n, n) pairwise T-factors (induced regime)
    dd_ind: torch.Tensor    # (B, n, n) (induced sanitisation)
    self_m: torch.Tensor    # (B,) bool regime masks (parameter-only)
    cross_m: torch.Tensor
    induced_m: torch.Tensor
    pair: torch.Tensor      # (B, 2) int64 slots of the associating pair, (0, 1) elsewhere
    branches: frozenset     # the regimes some row reaches (BRANCHES names)


def _gc_assoc_tfactors(g: GcParams, temperature, mask):
    """Pairwise association T-factors and diameter factors with the gc
    sanitisation (reference feos_torch/gc_pcsaft.py:549-564): the diameter
    is recomputed from the associating segment's own sigma/epsilon_k.
    ``mask (B, n)`` marks the associating pair of the regime's rows; the
    other entries, which the terms never read, are sanitised."""
    t = temperature[:, None]
    sigma = torch.where(mask, g.sigma_assoc, 1.0)
    kappa = torch.where(mask, g.kappa_ab, 1.0)
    d = sigma * (1.0 - 0.12 * torch.exp(-3.0 * g.epsilon_k_assoc / t))
    sigma3_kappa = (sigma[:, :, None] * sigma[:, None, :]) ** 1.5 * torch.sqrt(
        kappa[:, :, None] * kappa[:, None, :])
    eps = 0.5 * (g.epsilon_k_ab[:, :, None] + g.epsilon_k_ab[:, None, :])
    tfac = sigma3_kappa * (torch.exp(eps / t[:, :, None]) - 1.0)
    dd = d[:, :, None] * d[:, None, :] / (d[:, :, None] + d[:, None, :])
    return tfac, dd


def precompute_gc(g: GcParams, temperature) -> GcPre:
    """Build :class:`GcPre` for ``(B,)`` temperatures; torch ops throughout,
    so segment-parameter, k_ab, phi and temperature gradients flow."""
    t = temperature[:, None]
    d = g.sigma * (1.0 - 0.12 * torch.exp(-3.0 * g.epsilon_k / t))  # (B, S)

    def m_dot(x):
        return (g.m @ x[:, :, None])[..., 0]

    dd_p = d[:, g.bond_a] * d[:, g.bond_b] / (d[:, g.bond_a] + d[:, g.bond_b])
    dip = precompute_dipole(g.m_mix, g.sigma_mix, g.epsilon_k_mix, g.mu2, temperature)
    dipolar = (g.mu2 > 0.0).any(-1)

    # association regime masks (parameter-only)
    is_assoc = g.kappa_ab * g.epsilon_k_ab != 0.0
    n_assoc = is_assoc.sum(-1)
    n_self = (g.na * g.nb != 0.0).sum(-1)
    self_m = (n_assoc == 1) & (n_self == 1)
    cross_m = (n_assoc == 2) & (n_self == 2)
    induced_m = (n_assoc == 2) & (n_self == 1)

    # self regime: per-row sums over the components, sanitised
    sigma_s = torch.where(self_m, g.sigma_assoc.sum(-1), 1.0)
    kappa_s = torch.where(self_m, g.kappa_ab.sum(-1), 1.0)
    self_d = sigma_s * (1.0 - 0.12 * torch.exp(-3.0 * g.epsilon_k_assoc.sum(-1) / temperature))
    self_st = sigma_s**3 * kappa_s * (torch.exp(g.epsilon_k_ab.sum(-1) / temperature) - 1.0)

    cross_t, dd_cross = _gc_assoc_tfactors(g, temperature, cross_m[:, None] & is_assoc)
    ind_t, dd_ind = _gc_assoc_tfactors(g, temperature, induced_m[:, None] & is_assoc)

    # the reachable regimes, from the masks themselves (one host sync)
    masks = torch.stack([dipolar, self_m, cross_m, induced_m, n_assoc > 2])
    tracing.count("sync.precompute_gc")
    *reached, too_many = masks.any(-1).tolist()
    if too_many:
        raise ValueError(TOO_MANY_ASSOCIATING)
    branches = frozenset(name for name, on in zip(BRANCHES, reached) if on)

    return GcPre(
        md0=g.m.sum(-1), md1=m_dot(d), md2=m_dot(d * d), md3=m_dot(d * d * d),
        bonds_p=g.bonds_p, dd_p=dd_p,
        e1t=g.e1b / t[:, :, None], e2t=g.e2b / (t * t)[:, :, None],
        dip=dip, dipolar=dipolar, na=g.na, nb=g.nb,
        is_assoc=torch.sign(g.kappa_ab * g.epsilon_k_ab),
        self_st=self_st, self_d=self_d, cross_t=cross_t, dd_cross=dd_cross,
        ind_t=ind_t, dd_ind=dd_ind,
        self_m=self_m, cross_m=cross_m, induced_m=induced_m,
        pair=associating_pair(is_assoc, n_assoc), branches=branches,
    )


def phi_gc_pre(pre: GcPre, density, assoc_q_form: bool = False):
    """Reduced residual Helmholtz energy density at ``density (B, ..., n)``
    from :class:`GcPre`; returns ``(B, ...)`` (reference
    feos_torch/gc_pcsaft.py:116-253).  ``assoc_q_form`` as in
    :func:`feos_tpu_torch.models.pcsaft_mix.phi_mix_pre`."""
    col = _columns(density)
    rho = density
    dev = rho.device
    tracing.count("sync.phi_gc_pre", 6)  # six copies from host memory to the card
    cA0, cA1, cA2, cB0, cB1, cB2 = (
        torch.as_tensor(c, dtype=F64, device=dev) for c in (A0, A1, A2, B0, B1, B2)
    )

    md0 = col(pre.md0)
    zeta0 = PI / 6.0 * (md0 * rho).sum(-1)
    zeta1 = PI / 6.0 * (col(pre.md1) * rho).sum(-1)
    zeta2 = PI / 6.0 * (col(pre.md2) * rho).sum(-1)
    zeta3 = PI / 6.0 * (col(pre.md3) * rho).sum(-1)

    zeta23 = zeta2 / zeta3
    zeta3_2 = zeta3 * zeta3
    zeta3_3 = zeta3_2 * zeta3
    zeta3_m1 = 1.0 / (1.0 - zeta3)
    zeta3_m2 = zeta3_m1 * zeta3_m1
    etas = torch.stack([torch.ones_like(zeta3), zeta3, zeta3_2, zeta3_3,
                        zeta3_2 * zeta3_2, zeta3_2 * zeta3_3, zeta3_3 * zeta3_3], -1)

    # hard sphere
    hs = (6.0 / PI) * (
        zeta1 * zeta2 * zeta3_m1 * 3.0
        + zeta2 * zeta2 * zeta3_m2 * zeta23
        + (zeta2 * zeta23 * zeta23 - zeta0) * torch.log(1.0 - zeta3)
    )

    # hard chain over the bonded segment pairs (reference
    # feos_torch/gc_pcsaft.py:156-165): ln g on the P pairs, (B, ..., P)
    cdab = (zeta2 * zeta3_m2)[..., None] * col(pre.dd_p)
    g_ab = zeta3_m1[..., None] + cdab * 3.0 - cdab * cdab * (zeta3[..., None] - 1.0) * 2.0
    ln_g = torch.log(g_ab)
    hc = -(rho[..., :, None] * col(pre.bonds_p) * ln_g[..., None, :]).sum((-1, -2))

    # dispersion over component pairs through the precomputed bases
    x = rho / rho.sum(-1, keepdim=True)
    mmean = (x * md0).sum(-1)
    rho_ij = rho[..., :, None] * rho[..., None, :]
    rho1mix = (rho_ij * col(pre.e1t)).sum((-1, -2))
    rho2mix = (rho_ij * col(pre.e2t)).sum((-1, -2))

    m1 = ((mmean - 1.0) / mmean)[..., None]
    m2 = m1 * ((mmean - 2.0) / mmean)[..., None]
    I1 = ((m2 * cA2 + m1 * cA1 + cA0) * etas).sum(-1)
    I2 = ((m2 * cB2 + m1 * cB1 + cB0) * etas).sum(-1)
    C1 = 1.0 / (
        1.0
        + mmean * (8.0 * zeta3 - 2.0 * zeta3_2) * zeta3_m2 * zeta3_m2
        + (1.0 - mmean)
        * (20.0 * zeta3 - 27.0 * zeta3_2 + 12.0 * zeta3_2 * zeta3 - 2.0 * zeta3_2 * zeta3_2)
        / ((1.0 - zeta3) * (1.0 - zeta3) * (2.0 - zeta3) * (2.0 - zeta3))
    )
    disp = (-rho1mix * 2.0 * I1 - rho2mix * C1 * I2 * mmean) * PI

    phi = hs + hc + disp

    # dipole on the component-level mixed parameters
    if "dipole" in pre.branches:
        dip = phi_dipole_pre(pre.dip, rho, etas, col)
        phi = phi + torch.where(col(pre.dipolar), dip, 0.0)

    # association regimes (reference feos_torch/gc_pcsaft.py:220-251)
    if "self" in pre.branches:
        a = _phi_self_assoc(pre, rho, zeta2, zeta3_m1, col, assoc_q_form)
        phi = phi + torch.where(col(pre.self_m), a, 0.0)
    if "cross" in pre.branches:
        a = _phi_cross_assoc(pre, rho, zeta2, zeta3_m1, col, assoc_q_form)
        phi = phi + torch.where(col(pre.cross_m), a, 0.0)
    if "induced" in pre.branches:
        a = induced_assoc_term(pre.induced_m, pre.ind_t, pre.dd_ind, pre.na, pre.nb,
                               pre.pair, rho, zeta2, zeta3_m1, col, assoc_q_form)
        phi = phi + torch.where(col(pre.induced_m), a, 0.0)
    return phi


def _phi_self_assoc(pre: GcPre, rho, zeta2, zeta3_m1, col, q_form=False):
    """Single self-associating segment, closed form for nA = nB = 1
    (reference feos_torch/gc_pcsaft.py:309-330)."""
    rho_a = (col(pre.is_assoc) * rho).sum(-1)
    k = col(pre.self_d) * 0.5 * zeta2 * zeta3_m1
    delta = zeta3_m1 * (k * (2.0 * k + 3.0) + 1.0) * col(pre.self_st)
    xa = 2.0 / (torch.sqrt(1.0 + 4.0 * delta * rho_a) + 1.0)
    if q_form:
        # two sites (A, B) per molecule share the fraction xa
        xa = xa.detach()
        return 2.0 * rho_a * q_f1(xa) - rho_a * rho_a * xa * xa * delta
    return rho_a * (2.0 * torch.log(xa) - xa + 1.0)


def _phi_cross_assoc(pre: GcPre, rho, zeta2, zeta3_m1, col, q_form=False):
    """Two self-associating segments, nA = nB = 1 fixed point
    (reference feos_torch/gc_pcsaft.py:333-380)."""
    mask = col(pre.cross_m)
    tfac, dd = pair_block(pre.cross_t, pre.pair), pair_block(pre.dd_cross, pre.pair)
    at = pair_slots(pre.pair, col)

    def delta_rho(i, j):
        d = assoc_strength_from_tfactor(col(tfac[:, i, j]), col(dd[:, i, j]), zeta2, zeta3_m1)
        return torch.where(mask, d * at(rho, j), 0.0)

    d00, d01, d10, d11 = delta_rho(0, 0), delta_rho(0, 1), delta_rho(1, 0), delta_rho(1, 1)
    rho0, rho1 = at(rho, 0), at(rho, 1)
    if q_form:
        xa0, xa1 = cross_assoc_sym_iterate(
            *torch.broadcast_tensors(*(v.detach() for v in (d00, d01, d10, d11))))
        # dij = Delta_ij rho_j, so rho_i rho_j Delta_ij x_i x_j = rho_i x_i x_j d_ij
        bil = rho0 * xa0 * (xa0 * d00 + xa1 * d01) + rho1 * xa1 * (xa0 * d10 + xa1 * d11)
        return 2.0 * (rho0 * q_f1(xa0) + rho1 * q_f1(xa1)) - bil
    xa0, xa1 = solve_cross_assoc_sym(d00, d01, d10, d11)

    def f(x):
        return 2.0 * torch.log(x) - x + 1.0

    return rho0 * f(xa0) + rho1 * f(xa1)


# ---------------------------------------------------------------------------
# Batched API
# ---------------------------------------------------------------------------


def gc_helmholtz_energy_density(params: GcParams, temperature, density):
    """Batched phi ``(B, ...)`` at ``density (B, ..., n)`` in A^-3."""
    return phi_gc_pre(precompute_gc(params, temperature), density)


def gc_derivatives(params: GcParams, temperature, density):
    """Batched ``(A, p~, mu_i, v_i)`` at ``density (B, n)``."""
    return pressure_set(partial(phi_gc_pre, precompute_gc(params, temperature)), density)


def solve_incipient_gc(params: GcParams, temperature, molefracs, p_red, bubble,
                       state0=None, stats=None):
    """The detached gc bubble/dew solve: ``(rho_inc (B, n), rho_bulk (B, n),
    ok (B,), p~_eq (B,))`` for bulk compositions ``(B, n)`` and reduced
    pressure estimates ``(B,)``.  See
    :func:`feos_tpu_torch.solvers.vle.mix_vle`."""
    pre = precompute_gc(params.detach(), temperature.detach())
    return mix_vle(
        partial(phi_gc_pre, pre, assoc_q_form=True), partial(phi_gc_pre, pre),
        molefracs.detach(), p_red.detach(), pre.md3, incipient_is_vapor=bubble,
        u0_init=state0, stats=stats,
    )


def gc_incipient_property(params: GcParams, temperature, molefracs, pressure, bubble,
                          full_output=False, state0=None, state_output=False, stats=None):
    """Batched gc bubble (``bubble=True``) or dew pressure in Pa: the
    detached solve, then the stationary re-attachment of
    :func:`feos_tpu_torch.models.pcsaft_mix.reattach_incipient`, with
    gradients in whatever ``params`` and ``temperature`` require."""
    temperature, molefracs, p_red = mixture_inputs(params.m.device, temperature, molefracs,
                                                   pressure, params.m_mix.shape[1])
    solved = solve_incipient_gc(params, temperature, molefracs, p_red, bubble, state0, stats)
    phi_fn = None
    if needs_grad(*params, temperature):
        phi_fn = partial(phi_gc_pre, precompute_gc(params, temperature))
    return reattach_incipient(solved, temperature, phi_fn, full_output, state_output)


def gc_bubble_point(params: GcParams, temperature, liquid_molefracs, pressure,
                    full_output=False, state0=None, state_output=False, stats=None):
    """Batched gc bubble-point pressure (reference
    feos_torch/gc_pcsaft.py:470-490) of mixtures of n molecules.
    ``liquid_molefracs`` is ``(B, n)``, or x1 per row for a binary only (it
    raises ``ValueError`` otherwise); ``pressure`` the initial estimate in
    Pa.  Association reads each row's associating pair wherever it sits;
    three or more associating molecules raise ``ValueError``.  Returns
    ``(p, nans)``, NaN on failed rows; ``full_output`` adds the vapor
    composition ``(B, n)`` and ``state_output`` the converged log-state
    ``(B, n+1)``, which ``state0`` takes back for a warm start.  If
    ``stats`` is a dict, it receives the solver's loop iterations."""
    return gc_incipient_property(params, temperature, liquid_molefracs, pressure, True,
                                 full_output, state0, state_output, stats)


def gc_dew_point(params: GcParams, temperature, vapor_molefracs, pressure,
                 full_output=False, state0=None, state_output=False, stats=None):
    """Batched gc dew-point pressure (reference
    feos_torch/gc_pcsaft.py:492-512) at the vapor composition ``(B, n)``;
    ``full_output`` adds the liquid composition.  See
    :func:`gc_bubble_point`."""
    return gc_incipient_property(params, temperature, vapor_molefracs, pressure, False,
                                 full_output, state0, state_output, stats)


def gc_incipient_temperature(params: GcParams, pressure, molefracs, t0, bubble=True,
                             full_output=False, stats=None):
    """Batched gc bubble (``bubble=True``) or dew temperature in K at
    ``pressure`` [Pa], with gradients in whatever ``params`` (the segment
    parameters, k_ab and phi behind them) and ``pressure`` require: the
    warm-started secant of
    :func:`feos_tpu_torch.models.pcsaft_mix.bubble_point_t` over
    :func:`gc_incipient_property`, for ``(B, n)`` compositions (x1 per row
    for a binary only).  Returns ``(t, nans)`` and with ``full_output`` the
    incipient composition ``(B, n)``; ``stats``
    receives the secant's iterations as ``outer``."""
    from ..solvers.tsolve import incipient_temperature

    return incipient_temperature(
        partial(gc_incipient_property, params, bubble=bubble),
        partial(gc_incipient_property, params.detach(), bubble=bubble),
        pressure, molefracs, t0, params.m_mix.shape[0], params.m.device, full_output, stats)


def gc_flash(params: GcParams, temperature, molefracs, pressure, gradients=False, stats=None):
    """Batched isothermal pT flash of gc mixtures of n molecules: the
    contract of :func:`feos_tpu_torch.models.pcsaft_mix.flash` (a ``(B, n)``
    feed; z1 per row for a binary only), over the gc phi, with the window
    from detached gc bubble and dew solves.  With
    ``gradients=True`` the derivatives of beta, x, y and rho re-attach in
    whatever ``params`` (the segment parameters, k_ab and phi behind them),
    T, z and p require."""
    dev = params.m.device
    temperature, z, p_red = mixture_inputs(dev, temperature, molefracs, pressure,
                                           params.m_mix.shape[1])
    pressure = torch.as_tensor(pressure, dtype=F64, device=dev)
    g_s, t_s, z_s = params.detach(), temperature.detach(), z.detach()
    p0 = torch.clamp(pressure.detach(), min=1e5)
    edges = (gc_incipient_property(g_s, t_s, z_s, p0, True, full_output=True)
             + gc_incipient_property(g_s, t_s, z_s, p0, False, full_output=True))
    pre_grad = None
    if gradients and needs_grad(*params, temperature, z, p_red):
        pre_grad = precompute_gc(params, temperature)
    else:
        z, p_red = z_s, p_red.detach()
    return flash_model(phi_gc_pre, precompute_gc(g_s, t_s), pre_grad, z, p_red, pressure,
                       edges, stats)


class GcPcSaftMix(nn.Module):
    """Module facade (reference ``GcPcSaftMix``, feos_torch/gc_pcsaft.py:13)
    for mixtures of any number n of molecules per row.

    The constructor takes the reference's ``(segment_identifier, parameter,
    segment_lists, bond_lists, binary_segment_records, phi=None)``, with
    ``parameter`` the 8-tuple of ``(S,)`` segment columns and n molecules in
    each row's segment and bond lists.  Compositions are ``(B, n)`` (x1 per
    row for a binary only); association reads each row's associating pair
    wherever it sits, and three or more associating molecules raise
    ``ValueError``.  It holds the
    ``(S, 8)`` segment parameters, the k_ab record values ``(R,)`` and phi
    ``(B, n)`` as ``nn.Parameter``\\ s on ``device`` (the card unless the
    caller asks for the CPU) and the topology as host data, and assembles
    :class:`GcParams` with torch ops on every call, so ``.backward()``
    reaches all three.
    """

    def __init__(self, segment_identifier, parameter, segment_lists, bond_lists,
                 binary_segment_records, phi=None, device="cuda"):
        super().__init__()
        if len(parameter) != 8:
            raise ValueError("parameter is the 8-tuple of segment columns")
        self.topology = GcTopology.build(segment_identifier, segment_lists, bond_lists)
        self.kab_pairs = tuple((s1, s2) for s1, s2, _ in binary_segment_records)
        self.parameter = nn.Parameter(_f64(np.stack([np.asarray(c, dtype=np.float64)
                                                     for c in parameter], -1), device))
        self.kab = nn.Parameter(_f64([k for _, _, k in binary_segment_records], device))
        shape = (len(self.topology.rows), self.topology.counts.shape[1])
        self.phi = nn.Parameter(_f64(np.ones(shape) if phi is None else phi, device))

    @property
    def params(self) -> GcParams:
        kab = kab_matrix(self.topology.segment_identifier, self.kab_pairs, self.kab)
        return assemble(self.topology, self.parameter, kab, self.phi)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=F64, device=self.parameter.device)

    def helmholtz_energy_density(self, temperature, density):
        return gc_helmholtz_energy_density(self.params, self._tensor(temperature),
                                           self._tensor(density))

    def derivatives(self, temperature, density):
        return gc_derivatives(self.params, self._tensor(temperature), self._tensor(density))

    def bubble_point(self, temperature, liquid_molefracs, pressure, full_output=False,
                     state0=None, state_output=False, stats=None):
        return gc_bubble_point(self.params, temperature, liquid_molefracs, pressure,
                               full_output, state0, state_output, stats)

    def dew_point(self, temperature, vapor_molefracs, pressure, full_output=False,
                  state0=None, state_output=False, stats=None):
        return gc_dew_point(self.params, temperature, vapor_molefracs, pressure,
                            full_output, state0, state_output, stats)

    def bubble_point_t(self, pressure, liquid_molefracs, t0, full_output=False, stats=None):
        """Bubble-point temperature at given pressure; see
        :func:`gc_incipient_temperature`."""
        return gc_incipient_temperature(self.params, pressure, liquid_molefracs, t0, True,
                                        full_output, stats)

    def dew_point_t(self, pressure, vapor_molefracs, t0, full_output=False, stats=None):
        """Dew-point temperature at given pressure; see
        :func:`gc_incipient_temperature`."""
        return gc_incipient_temperature(self.params, pressure, vapor_molefracs, t0, False,
                                        full_output, stats)

    def flash(self, temperature, molefracs, pressure, gradients=False, stats=None):
        """Isothermal pT flash; see :func:`gc_flash`."""
        return gc_flash(self.params, self._tensor(temperature), self._tensor(molefracs),
                        self._tensor(pressure), gradients, stats)

    def residual_properties(self, temperature, density):
        """Residual property set at (T, rho_i [A^-3]); see
        :func:`feos_tpu_torch.properties.gc_properties`."""
        from ..properties import gc_properties

        return gc_properties(self.params, self._tensor(temperature), self._tensor(density))
