"""Image, flow and coordinate warps between ERP views, and the flow resizes
(counterpart of ``prior_flow_tpu/ops/warp.py``). Channels-last: images
``(B, H, W, C)``, flows and coordinate fields ``(B, H, W, 2)``; grids
``(H, W, 2)`` or ``(B, H, W, 2)`` torch tensors. The convenience wrappers
(``img_a2b``, ``flo_b2a``, ``coord_a2b``, ...) fetch the cached host grids
and copy them to the input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import erp, grids
from ..geometry import rotation as rot
from .samplers import (bilinear_sample, cycle_bilinear_sample,
                       cycle_grid_sample, masked_bilinear_interpolate)
from .static_resample import resample_static


def _bcast(grid: torch.Tensor, B: int) -> torch.Tensor:
    return grid.unsqueeze(0).expand(B, -1, -1, -1) if grid.dim() == 3 else grid


def _on(grid: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host grid as a float32 tensor on ``like``'s device."""
    return torch.from_numpy(np.asarray(grid)).to(like.device)


def _identity(H: int, W: int, like: torch.Tensor) -> torch.Tensor:
    return grids.identity_grid_on(H, W, like.device).unsqueeze(0)


def img_rotate(image: torch.Tensor, sample_grid: torch.Tensor) -> torch.Tensor:
    """Resample an image through a rotation grid with the wrap-x
    grid_sample semantics (``prior_flow_tpu/ops/warp.py:27``)."""
    return cycle_bilinear_sample(image, _bcast(sample_grid, image.shape[0]))


def img_a2b(image: torch.Tensor) -> torch.Tensor:
    """A (primitive) view -> B (orthogonal) view
    (``prior_flow_tpu/ops/warp.py:55``)."""
    H, W = image.shape[1], image.shape[2]
    return img_rotate(image, _on(grids.view_grid(H, W, "a2b"), image))


def img_b2a(image: torch.Tensor) -> torch.Tensor:
    """B view -> A view (``prior_flow_tpu/ops/warp.py:62``)."""
    H, W = image.shape[1], image.shape[2]
    return img_rotate(image, _on(grids.view_grid(H, W, "b2a"), image))


def flo_rotate(flow: torch.Tensor, sample_grid_w2c: torch.Tensor,
               sample_grid_c2w: torch.Tensor) -> torch.Tensor:
    """Rotate a vector field between ERP views
    (``prior_flow_tpu/ops/warp.py:69``): push the world-frame endpoints
    through the world->camera grid (coordinate payload, ``is_grid``), take
    the camera-frame flow with its x wrapped into [-W/2, W/2), and resample
    it at the camera->world grid."""
    B, H, W, _ = flow.shape
    w2c = _bcast(sample_grid_w2c, B)
    end_w = erp.flow_to_endpoint(_identity(H, W, flow), flow, H, W)
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


def flo_b2a(flow: torch.Tensor) -> torch.Tensor:
    """B-frame flow -> A-frame flow (``prior_flow_tpu/ops/warp.py:113``)."""
    g = grids.rotation_grids(flow.shape[1], flow.shape[2])
    return flo_rotate(flow, _on(g.b2a_w2c, flow), _on(g.b2a, flow))


def coord_rotate(coords: torch.Tensor, sample_grid_w2c: torch.Tensor,
                 sample_grid_c2w: torch.Tensor) -> torch.Tensor:
    """Rotate an absolute coordinate field
    (``prior_flow_tpu/ops/warp.py:120``): both resamples carry a coordinate
    payload (``is_grid``)."""
    B = coords.shape[0]
    end_c = cycle_grid_sample(_bcast(sample_grid_w2c, B), coords, is_grid=True)
    return cycle_grid_sample(end_c, _bcast(sample_grid_c2w, B), is_grid=True)


def coord_a2b(coords: torch.Tensor) -> torch.Tensor:
    """Absolute coordinate field A -> B (``prior_flow_tpu/ops/warp.py:157``)."""
    g = grids.rotation_grids(coords.shape[1], coords.shape[2])
    return coord_rotate(coords, _on(g.a2b_w2c, coords), _on(g.a2b, coords))


def coord_b2a(coords: torch.Tensor) -> torch.Tensor:
    """Absolute coordinate field B -> A (``prior_flow_tpu/ops/warp.py:164``)."""
    g = grids.rotation_grids(coords.shape[1], coords.shape[2])
    return coord_rotate(coords, _on(g.b2a_w2c, coords), _on(g.b2a, coords))


def cycle_warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp an image by a flow with the true-wrap sampler
    (``prior_flow_tpu/ops/warp.py:131``)."""
    H, W = image.shape[1], image.shape[2]
    return cycle_grid_sample(image, _identity(H, W, image) + flow)


def img_rotate_theta(image: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate an ERP image by an x-axis Euler angle
    (``prior_flow_tpu/ops/warp.py:141``)."""
    H, W = image.shape[1], image.shape[2]
    return img_rotate(image, _on(grids.sample_grid(H, W, (0.0, 0.0,
                                                          float(theta))),
                                 image))


def flo_rotate_theta(flow: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate an ERP flow field by an x-axis Euler angle
    (``prior_flow_tpu/ops/warp.py:148``)."""
    H, W = flow.shape[1], flow.shape[2]
    angles = (0.0, 0.0, float(theta))
    return flo_rotate(flow,
                      _on(grids.sample_grid(H, W, angles, transpose=True),
                          flow),
                      _on(grids.sample_grid(H, W, angles), flow))


def flow_to_camera(flow_world: torch.Tensor, R) -> torch.Tensor:
    """Re-express a world-frame ERP flow in a rotated camera frame through
    per-pixel spherical angle differences, on the world pixel grid
    (``prior_flow_tpu/ops/warp.py:171``). ``R``: (3, 3) numpy rotation."""
    B, H, W, _ = flow_world.shape
    start = _identity(H, W, flow_world)
    end = erp.flow_to_endpoint(start, flow_world, H, W)
    Rt = np.asarray(R).T

    def to_cam(coords_px):
        cart = rot.spherical_to_cartesian(erp.plane_to_spherical(coords_px,
                                                                 H, W))
        return rot.cartesian_to_spherical(rot.rotate_cartesian(cart, Rt))

    d_px = erp.spherical_to_plane(to_cam(end) - to_cam(start), H, W,
                                  is_flow=True)
    return torch.stack([erp.u_clip(d_px[..., 0], W), d_px[..., 1]], dim=-1)


def rotating_warping(src_feat: torch.Tensor, R, coords: torch.Tensor):
    """Warp per-candidate features through a spherical rotation
    (``prior_flow_tpu/ops/warp.py:200``): coords (B, N, H1, W1, 2) go to
    the sphere, are rotated by ``R`` and mapped to (H2, W2) pixel coords,
    where ``src_feat`` (B, H2, W2, C) is sampled with the masked wrap-x
    sampler. Returns (B, N, H1, W1, C)."""
    B, H2, W2, C = src_feat.shape
    _, N, H1, W1, _ = coords.shape
    cart = rot.rotate_cartesian(
        rot.spherical_to_cartesian(erp.plane_to_spherical(coords, H1, W1)), R)
    px = erp.spherical_to_plane(rot.cartesian_to_spherical(cart), H2, W2)
    out = masked_bilinear_interpolate(src_feat, px.reshape(B, N * H1, W1, 2))
    return out.reshape(B, N, H1, W1, C)


def legacy_warp(image: torch.Tensor, flow: torch.Tensor, cyclic: bool = False):
    """Backward warp with a binarised validity mask
    (``prior_flow_tpu/ops/warp.py:219``): grid = identity + flow, sampled
    with the plain (or wrap-x) sampler; an all-ones image resampled there,
    zeroed below 0.9999, is multiplied in. Returns (warped, mask)."""
    H, W = image.shape[1], image.shape[2]
    grid = _identity(H, W, image) + flow
    sampler = cycle_bilinear_sample if cyclic else bilinear_sample
    mask = sampler(torch.ones_like(image), grid)
    mask = torch.where(mask < 0.9999, 0.0, 1.0).to(image.dtype)
    return sampler(image, grid) * mask, mask


def _resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int):
    """Bilinear resize with align_corners=True, in pixel coordinates
    (``prior_flow_tpu/ops/warp.py:233``). The sample coordinates may
    differ from XLA's ``linspace`` in their last bit."""
    B, H, W, _ = x.shape
    ys = torch.linspace(0.0, H - 1.0, out_h, device=x.device)
    xs = torch.linspace(0.0, W - 1.0, out_w, device=x.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([gx, gy], dim=-1).expand(B, out_h, out_w, 2)
    return bilinear_sample(x, coords)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """8x bilinear upsample of a flow with 8x magnitude
    (``prior_flow_tpu/ops/warp.py:243``)."""
    H, W = flow.shape[1], flow.shape[2]
    return 8.0 * _resize_bilinear_align_corners(flow, 8 * H, 8 * W)


def downflow8(flow: torch.Tensor) -> torch.Tensor:
    """1/8 bilinear downsample with 1/8 magnitude
    (``prior_flow_tpu/ops/warp.py:252``)."""
    H, W = flow.shape[1], flow.shape[2]
    return _resize_bilinear_align_corners(flow, H // 8, W // 8) / 8.0
