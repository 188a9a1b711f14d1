"""Failure-mask helpers.

Counterpart of ``feos_tpu/utils/masking.py``.  The solvers return
fixed-shape outputs with NaN on failed rows and a boolean mask; these
helpers drop the failed rows (:func:`compact`) or reduce over the converged
ones (:func:`masked_mean`, :func:`masked_sum`).  They take tensors and
keep autograd; ``compact`` also takes numpy arrays.
"""

from __future__ import annotations

import torch


def compact(nans, *arrays):
    """The rows of ``arrays`` where ``nans`` is False, as tensors on their
    own devices (the reference's ``reduce``, without its in-place
    semantics)."""
    keep = ~torch.as_tensor(nans, dtype=torch.bool)
    tensors = [torch.as_tensor(a) for a in arrays]
    return tuple(a[keep.to(a.device)] for a in tensors)


def masked_mean(values, nans, fill=0.0):
    """Mean over the converged rows (``fill`` stands in for the others, so a
    NaN there never reaches the sum or its gradient)."""
    ok = ~nans
    return torch.where(ok, values, fill).sum() / torch.clamp(ok.sum(), min=1)


def masked_sum(values, nans, fill=0.0):
    """Sum over the converged rows."""
    return torch.where(~nans, values, fill).sum()
