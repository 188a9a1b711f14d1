"""Reference-compatible facade: numpy in, numpy out.

Counterpart of ``feos_tpu/compat.py`` (``PcSaft``, ``GcPcSaft``).  The
reference exposes its native solvers as static methods that return the
converged rows only, compacted, plus a full-length boolean failure mask
(reference src/pcsaft.rs:17-80):

    from feos_tpu_torch.compat import PcSaft
    densities, nans = PcSaft.vapor_pressure(params, temperature)

The solves run on ``device``, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.gc_pcsaft import GcTopology, assemble, kab_matrix, solve_incipient_gc
from .models.pcsaft_mix import mixture_inputs, solve_incipient
from .solvers.vle import npt_density, pure_vle
from .units import PA_PER_KT_TO_REDUCED


def _t(x, device):
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


class PcSaft:
    """Static batched solvers with the reference's return conventions
    (reference src/pcsaft.rs:13-80).  Its bubble and dew points are the
    reference's binary API (x1 per row, ``(B, 2, 8)`` parameters, the
    ``(B_ok, 4)`` packing); n-component mixtures use
    :func:`feos_tpu_torch.bubble_point` and :func:`~feos_tpu_torch.dew_point`."""

    @staticmethod
    def vapor_pressure(parameters, temperature, device="cuda"):
        """-> (densities[B_ok, 4] with [rho_V, rho_L, 0, 0] reduced, nans[B])."""
        rv, rl, ok = pure_vle(_t(parameters, device), _t(temperature, device))
        ok = ok.cpu().numpy()
        out = np.zeros((int(ok.sum()), 4))
        out[:, 0] = rv.cpu().numpy()[ok]
        out[:, 1] = rl.cpu().numpy()[ok]
        return out, ~ok

    @staticmethod
    def liquid_density(parameters, temperature, pressure, device="cuda"):
        """-> (densities[B_ok] reduced, nans[B]); pressure in Pa."""
        t = _t(temperature, device)
        p_red = _t(pressure, device) / t * PA_PER_KT_TO_REDUCED
        rho, ok = npt_density(_t(parameters, device), t, p_red, liquid=True)
        ok = ok.cpu().numpy()
        return rho.cpu().numpy()[ok], ~ok

    @staticmethod
    def bubble_point(parameters, kij, temperature, liquid_molefracs, pressure,
                     device="cuda"):
        """-> (densities[B_ok, 4] = [rho_V_1, rho_V_2, rho_L_1, rho_L_2], nans[B])
        (packing as reference src/pcsaft.rs:216-231)."""
        return _binary_vle(parameters, kij, temperature, liquid_molefracs, pressure,
                           True, device)

    @staticmethod
    def dew_point(parameters, kij, temperature, vapor_molefracs, pressure, device="cuda"):
        """Mirror of ``bubble_point`` for a known vapor composition."""
        return _binary_vle(parameters, kij, temperature, vapor_molefracs, pressure,
                           False, device)


class GcPcSaft:
    """Stateful gc solver facade with the reference's constructor and
    return conventions (reference src/gc_pcsaft.rs:15-171).

    ``segment_records`` is a list of ``(name, array8)`` tuples with the
    8-vector ``[m, sigma, epsilon_k, mu, kappa_ab, epsilon_k_ab, na, nb]``;
    ``segments``/``bonds`` are per-row pairs of segment-name lists and bond
    index-pair lists, ``phi`` the ``(B, 2)`` dispersion correction (or
    ``None``).  The solves run on ``device``, the card unless the caller
    asks for the CPU.  Like the reference, it is binary only; n-component gc
    mixtures use :class:`~feos_tpu_torch.GcPcSaftMix`.
    """

    def __init__(self, segment_records, segments, bonds, binary_segment_records, phi,
                 device="cuda"):
        names = [name for name, _ in segment_records]
        parameter = _t(np.stack([np.asarray(r, dtype=np.float64)
                                 for _, r in segment_records]), device)
        kab = kab_matrix(names, [(a, b) for a, b, _ in binary_segment_records],
                         _t([k for _, _, k in binary_segment_records], device))
        self.params = assemble(GcTopology.build(names, segments, bonds), parameter, kab,
                               None if phi is None else _t(phi, device))
        _binary_only(self.params.m_mix.shape[1])

    def _solve(self, temperature, molefracs, pressure, bubble):
        t, z, p_red = mixture_inputs(self.params.m.device, temperature, molefracs, pressure, 2)
        rho_inc, rho_bulk, ok, _ = solve_incipient_gc(self.params, t, z, p_red, bubble)
        return _pack_binary(rho_inc, rho_bulk, ok, bubble)

    def bubble_point(self, temperature, liquid_molefracs, pressure):
        """-> (densities[B_ok, 4] = [rho_V_1, rho_V_2, rho_L_1, rho_L_2], nans[B])."""
        return self._solve(temperature, liquid_molefracs, pressure, bubble=True)

    def dew_point(self, temperature, vapor_molefracs, pressure):
        """Mirror of ``bubble_point`` for a known vapor composition."""
        return self._solve(temperature, vapor_molefracs, pressure, bubble=False)


def _binary_only(n):
    if n != 2:
        raise ValueError(f"the reference's bubble and dew API is binary only, got {n} "
                         "components")


def _binary_vle(parameters, kij, temperature, molefracs, pressure, bubble, device):
    parameters = _t(parameters, device)
    _binary_only(parameters.shape[1])
    t, z, p_red = mixture_inputs(device, temperature, molefracs, pressure, 2)
    rho_inc, rho_bulk, ok, _ = solve_incipient(
        parameters, None if kij is None else _t(kij, device), t, z, p_red, bubble,
    )
    return _pack_binary(rho_inc, rho_bulk, ok, bubble)


def _pack_binary(rho_inc, rho_bulk, ok, bubble):
    """Compact converged rows into the reference's (B_ok, 4) layout
    [rho_V_1, rho_V_2, rho_L_1, rho_L_2] (reference src/pcsaft.rs:216-231)."""
    ok = ok.cpu().numpy()
    rho_inc = rho_inc.cpu().numpy()[ok]
    rho_bulk = rho_bulk.cpu().numpy()[ok]
    out = np.zeros((rho_inc.shape[0], 4))
    if bubble:  # incipient phase is the vapor
        out[:, 0:2] = rho_inc
        out[:, 2:4] = rho_bulk
    else:
        out[:, 0:2] = rho_bulk
        out[:, 2:4] = rho_inc
    return out, ~ok
