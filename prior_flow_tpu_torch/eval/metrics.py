"""Spherical evaluation metrics (counterpart of
``prior_flow_tpu/eval/metrics.py``): latitude weights, the great-circle
(SEPE) distance, the planar end-point error and the pole/equator region
masks.

The distances are torch functions over channels-last flows (B, H, W, 2)
and run on the flows' device. The weights and masks are host arrays built
once per (H, W) and cached; callers copy them, never write to them.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..geometry import erp, grids
from ..ops.warp import img_rotate


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


@lru_cache(maxsize=16)
def spherical_mask(H: int, W: int) -> np.ndarray:
    """cos(latitude) weights normalised to sum 1 over the image, (H, W)
    float32 (``prior_flow_tpu/eval/metrics.py:21``)."""
    n = np.arange(H, dtype=np.float64)[:, None]
    mask = np.broadcast_to(np.cos(erp.n2phi(n, H)), (H, W))
    return _frozen((mask / mask.sum()).astype(np.float32))


def _haversine(x):
    return torch.square(torch.sin(x / 2.0))


def _haversine_inverse(y):
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(y, 0.0, 1.0)))


def _start(H: int, W: int, like: torch.Tensor) -> torch.Tensor:
    return grids.identity_grid_on(H, W, like.device).unsqueeze(0)


def _endpoint_spherical(flow, H: int, W: int):
    end = erp.flow_to_endpoint(_start(H, W, flow), flow, H, W)
    return erp.m2theta(end[..., 0], W), erp.n2phi(end[..., 1], H)


def great_circle_distance(pred_flow, gt_flow, method: str = "Haversine",
                          R: float = 1.0):
    """SEPE: the great-circle distance between the predicted and the true
    flow's end points on the unit sphere, (B, H, W, 2) -> (B, H, W)
    (``prior_flow_tpu/eval/metrics.py:48``)."""
    if method not in ("Haversine", "Cosine"):
        raise ValueError(f"unknown method {method!r}")
    H, W = pred_flow.shape[1], pred_flow.shape[2]
    th_p, ph_p = _endpoint_spherical(pred_flow, H, W)
    th_g, ph_g = _endpoint_spherical(gt_flow, H, W)
    if method == "Cosine":
        cos_a = (torch.sin(ph_p) * torch.sin(ph_g)
                 + torch.cos(ph_p) * torch.cos(ph_g) * torch.cos(th_g - th_p))
        alpha = torch.arccos(torch.clamp(cos_a, -1.0, 1.0))
    else:
        hav = (_haversine(ph_g - ph_p)
               + torch.cos(ph_p) * torch.cos(ph_g) * _haversine(th_g - th_p))
        alpha = _haversine_inverse(hav)
    return alpha * R


def spherical_flow_magnitude(flow, R: float = 1.0):
    """Great-circle arc length of each flow vector, (B, H, W, 2) ->
    (B, H, W) (``prior_flow_tpu/eval/metrics.py:70``)."""
    H, W = flow.shape[1], flow.shape[2]
    start = _start(H, W, flow)
    th_s = erp.m2theta(start[..., 0], W)
    ph_s = erp.n2phi(start[..., 1], H)
    th_e, ph_e = _endpoint_spherical(flow, H, W)
    hav = (_haversine(ph_e - ph_s)
           + torch.cos(ph_s) * torch.cos(ph_e) * _haversine(th_e - th_s))
    return R * _haversine_inverse(hav)


def epe(pred_flow, gt_flow):
    """Euclidean end-point error per pixel, (B, H, W)
    (``prior_flow_tpu/eval/metrics.py:85``)."""
    return torch.sqrt(torch.sum((pred_flow - gt_flow) ** 2, dim=-1))


def _pole_a(H: int, W: int, delta_phi: float) -> np.ndarray:
    max_phi = delta_phi / 2
    min_n = int(round(erp.phi2n(max_phi, H)))
    max_n = int(round(erp.phi2n(-max_phi, H)))
    center = np.zeros((H, W), np.float32)
    center[min_n:max_n, :] = 1
    return 1.0 - center


def rotated_pole(pole_a: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """``pole_a`` resampled through a rotation grid with ``img_rotate``
    (float32, before the 0.5 threshold)."""
    out = img_rotate(torch.from_numpy(pole_a)[None, :, :, None],
                     torch.from_numpy(np.asarray(grid)))
    return out[0, :, :, 0].numpy()


@lru_cache(maxsize=8)
def generate_polemask(H: int, W: int, delta_phi: float = math.pi / 2):
    """(pole_mask_A, pole_mask_B), each (H, W) int64: A marks latitudes
    beyond +-delta_phi/2, B is A rotated into the orthogonal view and
    thresholded at 0.5 (``prior_flow_tpu/eval/metrics.py:91``)."""
    pole_a = _pole_a(H, W, delta_phi)
    pre = rotated_pole(pole_a, grids.view_grid(H, W, "a2b"))
    pole_b = np.where(pre < 0.5, 0.0, 1.0)
    return (_frozen(pole_a.astype(np.int64)),
            _frozen(pole_b.astype(np.int64)))


@lru_cache(maxsize=8)
def generate_polemask_d(H: int, W: int, delta_phi: float = math.pi / 2):
    """(pole_mask_A, pole_mask_D): the D view through a y-axis rotation
    (``prior_flow_tpu/eval/metrics.py:114``)."""
    pole_a = _pole_a(H, W, delta_phi)
    pre = rotated_pole(pole_a, grids.sample_grid(H, W,
                                                 (0.0, -math.pi / 2, 0.0)))
    pole_d = np.where(pre < 0.5, 0.0, 1.0)
    return (_frozen(pole_a.astype(np.int64)),
            _frozen(pole_d.astype(np.int64)))


REGIONS = ("All", "Equator", "Poles", "Center")


@lru_cache(maxsize=8)
def _region_items(H: int, W: int):
    pole_a, pole_b = generate_polemask(H, W)
    return (("All", _frozen(np.ones((H, W), bool))),
            ("Equator", _frozen((1 - pole_a).astype(bool))),
            ("Poles", _frozen(pole_a.astype(bool))),
            ("Center", _frozen(pole_b.astype(bool))))


def region_masks(H: int, W: int):
    """The named region masks {All, Equator, Poles, Center}, bool (H, W)
    (``prior_flow_tpu/eval/metrics.py:133``): Poles = |phi| > 45 degrees,
    Equator its complement, Center the pole mask of the B view. The arrays
    are built once per (H, W)."""
    return dict(_region_items(H, W))
