"""Resampling at a fixed (host-built) grid
(counterpart of ``prior_flow_tpu/ops/static_resample.py:262``).

The JAX module pairs each forward resample with a precomputed transpose
plan, so that its backward avoids XLA:TPU scatters. The port keeps the
contract and not the plans: the forward is the matching sampler at the
fixed grid, its VJP is autograd of the sampler's gathers (exact: a gather's
transpose is a scatter-add with the same weights), and
``resample_static_transpose`` applies that VJP on its own, as
``apply_transpose`` does for the taped backward.
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


def resample_static_transpose(ct: torch.Tensor, grid: torch.Tensor,
                              src_hw, mode: str = "cycle_bilinear"):
    """The linear transpose of ``resample_static(img, grid, mode)``
    (counterpart of ``prior_flow_tpu/ops/static_resample.py::
    apply_transpose``): the cotangent ``ct`` (B, H2, W2, C) of the resample's
    output -> the cotangent (B, H, W, C) of its input, ``src_hw = (H, W)``.
    Computed as ``torch.autograd.grad`` of the gathers."""
    with torch.enable_grad():
        img = torch.zeros((ct.shape[0], *src_hw, ct.shape[-1]),
                          dtype=ct.dtype, device=ct.device, requires_grad=True)
        (g,) = torch.autograd.grad(resample_static(img, grid, mode), img, ct)
    return g
