"""Mask helpers for the solvers' fixed-shape outputs."""

from .masking import compact, masked_mean, masked_sum

__all__ = ["compact", "masked_mean", "masked_sum"]
