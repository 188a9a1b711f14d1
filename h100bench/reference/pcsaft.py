"""PC-SAFT written out plainly in torch, in any floating dtype.

The benchmark's yardstick for the equation of state: the residual Helmholtz
energy density of an n-component mixture (a pure component is n = 1), from
the published equations, with no kernel, cache or shortcut:

* hard spheres (Boublik/Mansoori-Carnahan-Starling-Leland) and hard chains,
  and dispersion with the van der Waals one-fluid rules and k_ij, as Gross &
  Sadowski, Ind. Eng. Chem. Res. 40 (2001) 1244;
* dipoles as Gross & Vrabec, AIChE J. 52 (2006) 1194 (A2 / (1 - A3/A2));
* two-site association (sites A and B, counts na and nb a molecule),
  Wertheim/Chapman, with the cross energy epsilon_k_AiBj when it is given.

Units: temperatures in K, partial densities in molecules per cubic
Angstrom, phi = A / (kB T V) in A^-3, reduced pressure p~ = p A^3 / (kB T).
Parameter columns, per component: [m, sigma (A), epsilon_k (K), mu (D),
kappa_ab, epsilon_k_ab (K), na, nb].  Imports nothing but torch.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

KB = 1.380649e-23            # J/K (CODATA 2018, exact)
NAV = 6.02214076e23          # 1/mol
ANGSTROM = 1e-10             # m
PA_PER_K_TO_REDUCED = ANGSTROM**3 / KB   # p [Pa] / T [K] -> p~ [A^-3]
KMOL_M3_TO_REDUCED = 1e3 * NAV * ANGSTROM**3
MU2_FACTOR = 1e-19 / KB      # D^2 / (K A^3) -> dimensionless
PI = math.pi

# Gross & Sadowski 2001, table 1 (the digits feos publishes): a_0i, a_1i, a_2i and
# b_0i, b_1i, b_2i, i = 0..6
A_DISP = (
    (0.91056314451539, 0.63612814494991, 2.68613478913903, -26.5473624914884,
     97.7592087835073, -159.5915408656, 91.2977740839123),
    (-0.3084016918272, 0.18605311591713, -2.50300472586548, 21.4197936296668,
     -65.2558853303492, 83.3186804808856, -33.7469229297323),
    (-0.09061483509767, 0.4527842806392, 0.59627007280101, -1.72418291311787,
     -4.13021125311661, 13.7766318697211, -8.67284703679646),
)
B_DISP = (
    (0.72409469413165, 2.2382791860938, -4.00258494846342, -21.00357681484648,
     26.8556413626615, 206.5513384066188, -355.60235612207947),
    (-0.5755498075345, 0.69950955214436, 3.89256733895307, -17.21547164777212,
     192.6722644652495, -161.8264616487648, -165.2076934555607),
    (0.09768831158356, -0.255757498161, -9.15585615297321, 20.64207597439724,
     -38.80443005206285, 93.6267740770146, -29.66690558514725),
)
# Gross & Vrabec 2006, table 1: a_0n..a_2n, b_0n..b_2n (n = 0..4), c_0n..c_2n (n = 0..3)
A_DIP = (
    (0.30435038064, -0.13585877707, 1.44933285154, 0.35569769252, -2.06533084541),
    (0.95346405973, -1.8396383192, 2.0131180118, -7.37249576667, 8.23741345333),
    (-1.16100802773, 4.5258606732, 0.97512223853, -12.2810377713, 5.9397574742),
)
B_DIP = (
    (0.21879385627, -1.18964307357, 1.16268885692, 0.0, 0.0),
    (-0.58731641193, 1.24891317047, -0.50852797392, 0.0, 0.0),
    (3.486957558, -14.9159739347, 15.37202186, 0.0, 0.0),
)
C_DIP = (
    (-0.06467735252, 0.19758818347, -0.80875619458, 0.69028490492),
    (-0.95208758351, 2.99242575222, -2.38026356489, -0.27012609786),
    (-0.62609792333, 1.29246858189, 1.654278309, -3.43967436378),
)


class Params(NamedTuple):
    """One ``(B, n)`` tensor a parameter column; ``kij`` and ``eps_aibj`` are
    ``(B,)`` or None (binary interaction and cross-association energy)."""

    m: torch.Tensor
    sigma: torch.Tensor
    epsilon_k: torch.Tensor
    mu: torch.Tensor
    kappa_ab: torch.Tensor
    epsilon_k_ab: torch.Tensor
    na: torch.Tensor
    nb: torch.Tensor
    kij: torch.Tensor | None = None
    eps_aibj: torch.Tensor | None = None

    @classmethod
    def of(cls, columns: torch.Tensor, kij=None, eps_aibj=None) -> "Params":
        """From ``(B, 8)`` (one component) or ``(B, n, 8)`` columns."""
        if columns.dim() == 2:
            columns = columns[:, None, :]
        return cls(*columns.unbind(-1), kij, eps_aibj)


def _poly(coef, m, x, dtype, device):
    """sum_k (c0k + (m-1)/m c1k + (m-1)(m-2)/m^2 c2k) x^k for ``m`` and ``x``
    of one shape."""
    c = torch.tensor(coef, dtype=dtype, device=device)
    m1 = (m - 1.0) / m
    m2 = m1 * (m - 2.0) / m
    out = torch.zeros_like(x)
    for k in range(c.shape[1] - 1, -1, -1):
        out = out * x + (c[0, k] + m1 * c[1, k] + m2 * c[2, k])
    return out


def _safe_sqrt(x):
    """sqrt with a finite gradient at 0 (where the value is 0)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def phi(par: Params, temperature: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Residual Helmholtz energy density ``(B,)`` at partial densities
    ``rho (B, n)``; differentiable in the densities, the parameters and T."""
    dt, dev = rho.dtype, rho.device
    n = rho.shape[-1]
    t = temperature[:, None]
    m, sig, eps = par.m, par.sigma, par.epsilon_k
    d = sig * (1.0 - 0.12 * torch.exp(-3.0 * eps / t))

    zeta = [PI / 6.0 * (rho * m * d**k).sum(-1) for k in range(4)]
    z0, z1, z2, z3 = zeta
    z3m = 1.0 / (1.0 - z3)

    # hard spheres and hard chains
    hs = 6.0 / PI * (3.0 * z1 * z2 * z3m + z2**3 * z3m**2 / z3
                     + (z2**3 / z3**2 - z0) * torch.log(1.0 - z3))
    half_d = d / 2.0
    g_ii = (z3m[:, None] + half_d * 3.0 * (z2 * z3m**2)[:, None]
            + half_d**2 * 2.0 * (z2**2 * z3m**3)[:, None])
    hc = -(rho * (m - 1.0) * torch.log(g_ii)).sum(-1)

    # dispersion
    rho_t = rho.sum(-1)
    x = rho / rho_t[:, None]
    mbar = (x * m).sum(-1)
    eta = z3
    eps_ij = torch.sqrt(eps[:, :, None] * eps[:, None, :])
    if par.kij is not None and n > 1:
        off = 1.0 - torch.eye(n, dtype=dt, device=dev)
        eps_ij = eps_ij * (1.0 - par.kij[:, None, None] * off)
    sig_ij3 = ((sig[:, :, None] + sig[:, None, :]) / 2.0) ** 3
    w = (rho * m)[:, :, None] * (rho * m)[:, None, :] * sig_ij3
    e_t = eps_ij / t[:, :, None]
    m2es3 = (w * e_t).sum((-1, -2))
    m2e2s3 = (w * e_t**2).sum((-1, -2))
    i1 = _poly(A_DISP, mbar, eta, dt, dev)
    i2 = _poly(B_DISP, mbar, eta, dt, dev)
    c1 = 1.0 / (1.0 + mbar * (8.0 * eta - 2.0 * eta**2) / (1.0 - eta) ** 4
                + (1.0 - mbar) * (20.0 * eta - 27.0 * eta**2 + 12.0 * eta**3 - 2.0 * eta**4)
                / ((1.0 - eta) * (2.0 - eta)) ** 2)
    disp = -2.0 * PI * i1 * m2es3 - PI * mbar * c1 * i2 * m2e2s3

    out = hs + hc + disp + _dipole(par, t, rho, eta, sig, eps)
    return out + _association(par, t, rho, d, z2, z3m)


def _dipole(par, t, rho, eta, sig, eps):
    """Gross & Vrabec's A2 / (1 - A3/A2), as a density (rho A)."""
    if not bool((par.mu != 0.0).any()):
        return torch.zeros_like(eta)
    dt, dev = rho.dtype, rho.device
    m = par.m
    mu2 = par.mu**2 / (m * eps * sig**3) * MU2_FACTOR           # mu*^2
    q = rho * (eps / t) * sig**3 * mu2                          # (B, n)
    s = sig
    eps_ij = torch.sqrt(eps[:, :, None] * eps[:, None, :])
    s_ij = (s[:, :, None] + s[:, None, :]) / 2.0
    m_ij = torch.clamp(torch.sqrt(m[:, :, None] * m[:, None, :]), max=2.0)
    eta2 = eta[:, None, None].expand_as(m_ij)
    j2 = (_poly(A_DIP, m_ij, eta2, dt, dev)
          + _poly(B_DIP, m_ij, eta2, dt, dev) * eps_ij / t[:, :, None])
    phi2 = -PI * (q[:, :, None] * q[:, None, :] * j2 / s_ij**3).sum((-1, -2))
    m_ijk = torch.clamp((m[:, :, None, None] * m[:, None, :, None] * m[:, None, None, :])
                        ** (1.0 / 3.0), max=2.0)
    eta3 = eta[:, None, None, None].expand_as(m_ijk)
    c = torch.tensor(C_DIP, dtype=dt, device=dev)
    m1 = (m_ijk - 1.0) / m_ijk
    m2 = m1 * (m_ijk - 2.0) / m_ijk
    j3 = torch.zeros_like(m_ijk)
    for k in range(c.shape[1] - 1, -1, -1):
        j3 = j3 * eta3 + (c[0, k] + m1 * c[1, k] + m2 * c[2, k])
    r = (q[:, :, None, None] * q[:, None, :, None] * q[:, None, None, :] * j3
         / (s_ij[:, :, :, None] * s_ij[:, :, None, :] * s_ij[:, None, :, :]))
    phi3 = -4.0 * PI**2 / 3.0 * r.sum((-1, -2, -3))
    on = phi2 != 0.0
    den = torch.where(on, phi2 - phi3, 1.0)
    return torch.where(on, phi2 * phi2 / den, 0.0)


def _association(par, t, rho, d, z2, z3m):
    """Two-site association: sum_i rho_i (na_i f(X_Ai) + nb_i f(X_Bi)),
    f(X) = ln X - X/2 + 1/2."""
    n = rho.shape[-1]
    kap, eab = par.kappa_ab, par.epsilon_k_ab
    if not bool(((kap * (par.na + par.nb)) != 0.0).any()):
        return torch.zeros_like(z2)
    s3 = par.sigma**3
    ks = _safe_sqrt(s3[:, :, None] * kap[:, :, None] * s3[:, None, :] * kap[:, None, :])
    diag = torch.eye(n, dtype=torch.bool, device=rho.device)
    ks = torch.where(diag, (s3 * kap)[:, :, None].expand_as(ks), ks)
    e_ij = (eab[:, :, None] + eab[:, None, :]) / 2.0
    if par.eps_aibj is not None and n > 1:
        cross = (par.eps_aibj != 0.0)[:, None, None] & ~diag
        e_ij = torch.where(cross, par.eps_aibj[:, None, None].expand_as(e_ij), e_ij)
    dd = d[:, :, None] * d[:, None, :] / (d[:, :, None] + d[:, None, :])
    k = dd * (z2 * z3m)[:, None, None]
    g = z3m[:, None, None] * (1.0 + 3.0 * k + 2.0 * k * k)
    delta = g * ks * (torch.exp(e_ij / t[:, :, None]) - 1.0)   # (B, n, n)
    na, nb = par.na, par.nb
    if n == 1:
        dd1 = rho[:, 0] * delta[:, 0, 0]
        a, b = na[:, 0], nb[:, 0]
        xa = 2.0 / (1.0 + (b - a) * dd1 + torch.sqrt((1.0 + (b - a) * dd1) ** 2 + 4.0 * a * dd1))
        xb = 2.0 / (1.0 + (a - b) * dd1 + torch.sqrt((1.0 + (a - b) * dd1) ** 2 + 4.0 * b * dd1))
        xa, xb = xa[:, None], xb[:, None]
    else:
        xa, xb = _site_fractions(rho, delta, na, nb)
    f = lambda xx: torch.log(xx) - 0.5 * xx + 0.5  # noqa: E731
    return (rho * (na * f(xa) + nb * f(xb))).sum(-1)


def _site_residual(x, mab, mba):
    """F(X) = X (1 + M X_other) - 1 and its Jacobian, X = [X_A, X_B] (B, 2n)."""
    n = mab.shape[-1]
    xa, xb = x[:, :n], x[:, n:]
    sa = 1.0 + (mab @ xb[:, :, None])[..., 0]
    sb = 1.0 + (mba @ xa[:, :, None])[..., 0]
    res = torch.cat([xa * sa - 1.0, xb * sb - 1.0], -1)
    top = torch.cat([torch.diag_embed(sa), xa[:, :, None] * mab], -1)
    bot = torch.cat([xb[:, :, None] * mba, torch.diag_embed(sb)], -1)
    return res, torch.cat([top, bot], -2)


def _site_fractions(rho, delta, na, nb, iters=60):
    """X_A, X_B ``(B, n)`` of X_Ai = 1/(1 + sum_j rho_j nb_j Delta_ij X_Bj)
    and X_Bi = 1/(1 + sum_j rho_j na_j Delta_ij X_Aj): Newton, shrinking
    toward 0 (x 0.2) where a step would leave X > 0, to convergence
    without a graph, then two Newton steps with one, so that
    first and second derivatives in the densities and parameters are the
    implicit ones."""
    n = rho.shape[-1]
    mab = (rho * nb)[:, None, :] * delta
    mba = (rho * na)[:, None, :] * delta
    with torch.no_grad():
        ab, ba = mab.detach(), mba.detach()
        # start: each site as if its partners' fractions were its own,
        # X = 2 / (1 + sqrt(1 + 4 s)), exact for one self-associating
        # component with na = nb
        s = torch.cat([ab.sum(-1), ba.sum(-1)], -1)
        x = 2.0 / (1.0 + torch.sqrt(1.0 + 4.0 * s))
        # to 1e-9 relative (2^22 ulps); the two Newton steps below square it
        tol = 4194304.0 * torch.finfo(rho.dtype).eps
        for _ in range(iters):
            res, jac = _site_residual(x, ab, ba)
            step = torch.linalg.solve(jac, res[:, :, None])[..., 0]
            new = x - step
            x = torch.where(new > 0.0, new, 0.2 * x)
            if bool(((step.abs() <= tol * x) & (new > 0.0)).all()):
                break
    for _ in range(2):
        res, jac = _site_residual(x, mab, mba)
        x = x - torch.linalg.solve(jac, res[:, :, None])[..., 0]
    return x[:, :n], x[:, n:]


def grad_rho(par: Params, temperature, rho, create_graph=False):
    """``(phi (B,), dphi/drho_i (B, n))``; the graph is kept with
    ``create_graph``."""
    with torch.enable_grad():
        r = rho if rho.requires_grad else rho.detach().requires_grad_()
        val = phi(par, temperature, r)
        (g,) = torch.autograd.grad(val.sum(), r, create_graph=create_graph)
    return val, g
