"""Equirectangular rotation grids and flow rotation, plain numpy and torch.

A pixel (m, n) of an H x W panorama sits at longitude
theta = 2 pi ((m + 0.5) / W - 0.5) and latitude phi = pi (0.5 - (n + 0.5) / H).
The orthogonal view B is view A rotated about the x axis by -pi/2; the
grids say, for every pixel of one view, where it reads in the other.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import identity, wrap_grid_sample

EPS = 1e-6


def rotation_x(theta: float) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def _away_from_zero(x):
    return x + np.sign(x) * (np.abs(x) < EPS) * EPS


def sample_grid(H: int, W: int, R: np.ndarray) -> np.ndarray:
    """(H, W, 2) float32 pixel coords [x, y] that each pixel of the output
    view reads in the source view, rotated by ``R`` (float64 math)."""
    n, m = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
                       indexing="ij")
    theta = ((m + 0.5) / W - 0.5) * 2.0 * math.pi
    phi = (0.5 - (n + 0.5) / H) * math.pi
    cart = np.stack([np.cos(phi) * np.cos(theta), np.cos(phi) * np.sin(theta),
                     np.sin(phi)], axis=-1) @ R.T
    phi2 = np.arcsin(np.clip(cart[..., 2], -1.0, 1.0))
    theta2 = np.arctan2(_away_from_zero(cart[..., 1]), _away_from_zero(cart[..., 0]))
    x = (theta2 / (2.0 * math.pi) + 0.5) * W - 0.5
    y = (0.5 - phi2 / math.pi) * H - 0.5
    return np.stack([x, y], axis=-1).astype(np.float32)


def grids(H: int, W: int, device) -> dict:
    """The A <-> B grids at (H, W) and at 1/8 (suffix ``_8``); ``*_w2c``
    the transposed rotation."""
    R_ab, R_ba = rotation_x(-math.pi / 2), rotation_x(math.pi / 2)
    out = {}
    for suffix, (h, w) in (("", (H, W)), ("_8", (H // 8, W // 8))):
        for name, R in (("a2b", R_ab), ("b2a", R_ba)):
            out[name + suffix] = torch.from_numpy(sample_grid(h, w, R)).to(device)
            out[name + "_w2c" + suffix] = torch.from_numpy(sample_grid(h, w, R.T)).to(device)
    return out


def rotate_flow(flow, w2c, c2w):
    """A flow field (B, H, W, 2) seen from the other view: end points
    pushed through ``w2c`` (a coordinate payload), the camera-frame flow's
    x wrapped into [-W/2, W/2), read back at ``c2w``."""
    B, H, W, _ = flow.shape
    start = identity(H, W, flow.device)[None]
    end = start + flow
    end = torch.stack([torch.remainder(end[..., 0] + 0.5, W) - 0.5,
                       end[..., 1].clamp(-0.5, H - 0.5)], dim=-1)
    w2c_b = w2c[None].expand(B, -1, -1, -1)
    cam = wrap_grid_sample(w2c_b, end, is_grid=True) - w2c_b
    cam = torch.stack([torch.remainder(cam[..., 0] + W / 2.0, W) - W / 2.0,
                       cam[..., 1]], dim=-1)
    return wrap_grid_sample(cam, c2w[None].expand(B, -1, -1, -1))
