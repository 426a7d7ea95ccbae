"""Image and flow rotation warps between ERP views
(counterpart of ``prior_flow_tpu/ops/warp.py:27-110``). Channels-last:
images ``(B, H, W, C)``, flows ``(B, H, W, 2)``; grids ``(H, W, 2)`` or
``(B, H, W, 2)`` torch tensors.
"""

from __future__ import annotations

import torch

from ..geometry import erp, grids
from .samplers import cycle_bilinear_sample, cycle_grid_sample
from .static_resample import resample_static


def _bcast(grid: torch.Tensor, B: int) -> torch.Tensor:
    return grid.unsqueeze(0).expand(B, -1, -1, -1) if grid.dim() == 3 else grid


def img_rotate(image: torch.Tensor, sample_grid: torch.Tensor) -> torch.Tensor:
    """Resample an image through a rotation grid with the wrap-x
    grid_sample semantics (``prior_flow_tpu/ops/warp.py:27``)."""
    return cycle_bilinear_sample(image, _bcast(sample_grid, image.shape[0]))


def flo_rotate(flow: torch.Tensor, sample_grid_w2c: torch.Tensor,
               sample_grid_c2w: torch.Tensor) -> torch.Tensor:
    """Rotate a vector field between ERP views
    (``prior_flow_tpu/ops/warp.py:69``): push the world-frame endpoints
    through the world->camera grid (coordinate payload, ``is_grid``), take
    the camera-frame flow with its x wrapped into [-W/2, W/2), and resample
    it at the camera->world grid."""
    B, H, W, _ = flow.shape
    w2c = _bcast(sample_grid_w2c, B)
    start_w = grids.identity_grid_on(H, W, flow.device).unsqueeze(0)
    end_w = erp.flow_to_endpoint(start_w, flow, H, W)
    end_c = cycle_grid_sample(w2c, end_w, is_grid=True)
    flow_c = end_c - w2c
    flow_c = torch.stack([erp.u_clip(flow_c[..., 0], W), flow_c[..., 1]],
                         dim=-1)
    return resample_static(flow_c, sample_grid_c2w, mode="cycle_grid")


def flo_a2b(flow: torch.Tensor, g: grids.RotationGrids = None) -> torch.Tensor:
    """A-frame flow -> B-frame flow at full resolution
    (``prior_flow_tpu/ops/warp.py:106``), through the (H, W) ``a2b_w2c``
    and ``a2b`` grids. ``g`` is the bundle already on ``flow``'s device
    (e.g. ``PriOrRAFT.rotation_grids``); without it the grids are copied
    there."""
    H, W = flow.shape[1], flow.shape[2]
    if g is None:
        g = grids.rotation_grids(H, W).to_device(flow.device)
    return flo_rotate(flow, g.a2b_w2c, g.a2b)
