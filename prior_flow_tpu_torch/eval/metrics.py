"""Spherical evaluation weights (counterpart of
``prior_flow_tpu/eval/metrics.py``; only ``spherical_mask`` so far)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..geometry import erp


@lru_cache(maxsize=16)
def spherical_mask(H: int, W: int) -> np.ndarray:
    """cos(latitude) weights normalised to sum 1 over the image, (H, W)
    float32 (``prior_flow_tpu/eval/metrics.py:21``). The cached array is
    shared: callers copy it, never write to it."""
    n = np.arange(H, dtype=np.float64)[:, None]
    mask = np.broadcast_to(np.cos(erp.n2phi(n, H)), (H, W))
    out = (mask / mask.sum()).astype(np.float32)
    out.flags.writeable = False
    return out
