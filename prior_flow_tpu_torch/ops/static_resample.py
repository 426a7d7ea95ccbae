"""Resampling at a fixed (host-built) grid
(counterpart of ``prior_flow_tpu/ops/static_resample.py:262``).

The JAX module pairs each forward resample with a precomputed transpose
plan, so that its backward avoids XLA:TPU scatters. Inference needs no
backward, so only the forward contract is kept here: the value of the
matching sampler at the fixed grid.
"""

from __future__ import annotations

import torch

from .samplers import cycle_bilinear_sample, cycle_grid_sample


def resample_static(img: torch.Tensor, grid: torch.Tensor,
                    mode: str = "cycle_bilinear") -> torch.Tensor:
    """img: (B, H, W, C); grid: (H2, W2, 2) batch-invariant pixel grid.

    ``mode='cycle_bilinear'``: x wrapped mod W, zero padding, the seam quirk;
    ``mode='cycle_grid'``: true longitude wrap and latitude clamp.
    """
    if grid.dim() == 3:
        grid = grid.unsqueeze(0).expand(img.shape[0], -1, -1, -1)
    if mode == "cycle_bilinear":
        return cycle_bilinear_sample(img, grid)
    if mode == "cycle_grid":
        return cycle_grid_sample(img, grid)
    raise ValueError(f"unknown resample mode {mode!r}")
