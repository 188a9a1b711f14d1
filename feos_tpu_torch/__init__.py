"""feos_tpu_torch: the PyTorch and CUDA port of feos_tpu, for NVIDIA Hopper.

Differentiable PC-SAFT in f64.  Pure components: the Helmholtz energy and
its density derivatives, residual properties, and batched vapor pressures,
liquid densities, critical points and boiling temperatures with exact
reverse-mode gradients with respect to all 8 parameters of every row, and
the parameter fit built on them.  Mixtures of n components: the Helmholtz
energy with its association fixed points and derivative set (A, p~, mu,
v), and batched bubble and dew pressures and temperatures with gradients
with respect to the parameters, residual properties and the isothermal pT
flash with implicit-function gradients; for binaries also kij and
epsilon_k_AiBj with their fit, and p-x-y and T-x-y diagrams.
Heterosegmented (group-contribution) mixtures: the same, with gradients in
the segment parameters, k_ab and phi, and the k_ab fit.  Association reads
each row's associating pair wherever it sits in the component order; three
or more associating components raise ``ValueError``.

* :class:`PcSaftPure` -- ``nn.Module`` facade holding ``(B, 8)`` parameters;
* :func:`vapor_pressure`, :func:`liquid_density`,
  :func:`equilibrium_liquid_density`, :func:`critical_point`,
  :func:`boiling_temperature` -- functional forms, ``(nans, values)``;
* :func:`pure_properties` -- residual property set at (T, rho);
* :func:`pure_loss`, :func:`fit_pure` -- parameter regression;
* :class:`PcSaftMix` -- ``nn.Module`` facade holding ``(B, n, 8)``
  parameters and, for a binary, ``(B, 2)`` kij; compositions ``(B, n)``
  (x1 per row for a binary only); :func:`bubble_point`, :func:`dew_point`
  -- functional forms, ``(p, nans)`` as in the JAX package;
  :func:`bubble_point_t`, :func:`dew_point_t` -- temperatures at given
  pressure, ``(t, nans)``; :func:`mix_derivatives`,
  :func:`mix_helmholtz_energy_density`; :func:`mix_properties`;
* :class:`GcPcSaftMix` -- ``nn.Module`` facade holding the ``(S, 8)``
  segment parameters, the k_ab record values and phi, over a
  :class:`GcTopology` (molecules, host data); :func:`gc_bubble_point`,
  :func:`gc_dew_point` -- functional forms on assembled :class:`GcParams`,
  ``(p, nans)``; :func:`gc_incipient_temperature` -- bubble or dew
  temperatures, ``(t, nans)``; :func:`gc_derivatives`,
  :func:`gc_helmholtz_energy_density`, :func:`precompute_gc`;
  :func:`gc_properties`;
* :func:`binary_loss`, :func:`fit_binary` -- kij (and epsilon_k_AiBj)
  regression on bubble pressures; :func:`fit_gc` -- k_ab regression on gc
  bubble pressures; both warm-started from step to step;
* :func:`flash`, :func:`gc_flash` (and the facades' ``flash``) --
  isothermal pT flash, ``(vapor_frac, x, y, rho, phase)``, with
  ``gradients=True`` for implicit-function derivatives; :func:`flash_tp`
  -- its detached batched core;
* :mod:`feos_tpu_torch.utils` -- ``compact``, ``masked_mean``,
  ``masked_sum`` over the solvers' failure masks;
* :func:`binary_pxy`, :func:`binary_txy`, :func:`gc_binary_pxy`,
  :func:`gc_binary_txy` -- phase diagrams (:class:`BinaryPxy`,
  :class:`BinaryTxy`);
* :mod:`feos_tpu_torch.compat` -- the reference's numpy contract
  (``PcSaft``, ``GcPcSaft``);
* :func:`phi_d2` -- the hand-written CUDA kernel behind the solvers' phi
  evaluations (its plain PyTorch version on CPU tensors).

Every function takes its device from its tensors or from a ``device``
argument, which defaults to ``"cuda"``: the entry points run on the card
unless the caller asks for the CPU.  The package imports neither jax nor
``feos_tpu``.
"""

from . import units, utils
from .data import make_batch
from .diagrams import (
    BinaryPxy, BinaryTxy, binary_pxy, binary_txy, gc_binary_pxy, gc_binary_txy,
)
from .kernels.phi_d2 import phi_d2
from .models.gc_pcsaft import (
    GcParams,
    GcPcSaftMix,
    GcTopology,
    gc_bubble_point,
    gc_derivatives,
    gc_dew_point,
    gc_flash,
    gc_helmholtz_energy_density,
    gc_incipient_temperature,
    precompute_gc,
)
from .models.pcsaft_mix import (
    MixParams,
    PcSaftMix,
    bubble_point,
    bubble_point_t,
    dew_point,
    dew_point_t,
    flash,
    precompute_mix,
)
from .models.pcsaft_mix import derivatives as mix_derivatives
from .models.pcsaft_mix import helmholtz_energy_density as mix_helmholtz_energy_density
from .models.pcsaft_pure import (
    PcSaftPure,
    PurePre,
    PureParams,
    boiling_temperature,
    critical_point,
    equilibrium_liquid_density,
    liquid_density,
    mu_res_pure,
    phi_pure,
    precompute_pure,
    pure_derivatives,
    vapor_pressure,
)
from .properties import ResidualProperties, gc_properties, mix_properties, pure_properties
from .regression import (
    FitResult, binary_loss, fit_binary, fit_gc, fit_pure, masked_relative_sse, pure_loss,
)
from .solvers.flash import flash_tp
from .solvers.vle import mix_vle, npt_density, pure_critical, pure_vle

__all__ = [
    "BinaryPxy",
    "BinaryTxy",
    "FitResult",
    "GcParams",
    "GcPcSaftMix",
    "GcTopology",
    "MixParams",
    "PcSaftMix",
    "PcSaftPure",
    "PureParams",
    "PurePre",
    "ResidualProperties",
    "binary_loss",
    "binary_pxy",
    "binary_txy",
    "boiling_temperature",
    "bubble_point",
    "bubble_point_t",
    "critical_point",
    "dew_point",
    "dew_point_t",
    "equilibrium_liquid_density",
    "fit_binary",
    "fit_gc",
    "fit_pure",
    "flash",
    "flash_tp",
    "gc_binary_pxy",
    "gc_binary_txy",
    "gc_bubble_point",
    "gc_derivatives",
    "gc_dew_point",
    "gc_flash",
    "gc_helmholtz_energy_density",
    "gc_incipient_temperature",
    "gc_properties",
    "liquid_density",
    "make_batch",
    "masked_relative_sse",
    "mix_derivatives",
    "mix_helmholtz_energy_density",
    "mix_properties",
    "mix_vle",
    "mu_res_pure",
    "npt_density",
    "phi_d2",
    "phi_pure",
    "precompute_gc",
    "precompute_mix",
    "precompute_pure",
    "pure_critical",
    "pure_derivatives",
    "pure_loss",
    "pure_properties",
    "pure_vle",
    "units",
    "utils",
    "vapor_pressure",
]
