"""feos_tpu_torch: the PyTorch and CUDA port of feos_tpu, for NVIDIA Hopper.

Differentiable pure-component PC-SAFT in f64: the Helmholtz energy and its
density derivatives, and batched vapor pressures with exact reverse-mode
gradients with respect to all 8 parameters of every row.

* :class:`PcSaftPure` -- ``nn.Module`` facade holding ``(B, 8)`` parameters;
* :func:`vapor_pressure` -- functional form, ``(nans, p_Pa)``;
* :func:`phi_d2` -- the hand-written CUDA kernel behind every phi
  evaluation of the VLE solve (its plain PyTorch version on CPU tensors).

Every function takes its device from its tensors or from a ``device``
argument, which defaults to ``"cuda"``: the entry points run on the card
unless the caller asks for the CPU.  The package imports neither jax nor
``feos_tpu``.
"""

from . import units
from .data import make_batch
from .kernels.phi_d2 import phi_d2
from .models.pcsaft_pure import (
    PcSaftPure,
    PurePre,
    PureParams,
    phi_pure,
    precompute_pure,
    pure_derivatives,
    vapor_pressure,
)
from .solvers.vle import pure_vle

__all__ = [
    "PcSaftPure",
    "PurePre",
    "PureParams",
    "make_batch",
    "phi_d2",
    "phi_pure",
    "precompute_pure",
    "pure_derivatives",
    "pure_vle",
    "units",
    "vapor_pressure",
]
