"""Evaluation metrics."""

from .metrics import spherical_mask

__all__ = ["spherical_mask"]
