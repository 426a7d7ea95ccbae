"""Spherical rotation math and ERP resampling-grid generation, host side.

Counterpart of ``prior_flow_tpu/geometry/rotation.py``: grids are built
once per (H, W, rotation) in float64 numpy and cast to float32. The
sphere maps also take torch tensors, for the warps that rotate per-pixel
coordinates on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import erp

_EPS = 1e-6


def rotation_matrix(theta_list, axis_list=("z", "y", "x"), dtype=np.float64):
    """Compose Euler rotations R = R_axis0(t0) @ R_axis1(t1) @ ...
    (``prior_flow_tpu/geometry/rotation.py:23``). Returns a (3, 3) array."""
    R = np.eye(3, dtype=dtype)
    for axis, theta in zip(axis_list, theta_list):
        c, s = math.cos(theta), math.sin(theta)
        if axis == "x":
            M = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=dtype)
        elif axis == "y":
            M = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=dtype)
        elif axis == "z":
            M = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=dtype)
        else:
            raise ValueError(f"unknown axis {axis!r}")
        R = R @ M
    return R


def _xp(x):
    """The array namespace of ``x``: numpy for host grids, torch for tensors
    (``flow_to_camera`` and ``rotating_warping`` run these on the device)."""
    return torch if isinstance(x, torch.Tensor) else np


def _stack(xp, parts):
    return torch.stack(parts, dim=-1) if xp is torch else np.stack(parts, -1)


def diverge_zero(x, eps: float = _EPS):
    """Push |x| < eps away from zero, sign-preserving; exact zeros stay."""
    xp = _xp(x)
    near_zero = xp.abs(x) < eps
    return x + xp.sign(x) * near_zero * eps


def spherical_to_cartesian(sph):
    """(..., 2) [theta, phi] -> (..., 3) [x, y, z] on the unit sphere."""
    xp = _xp(sph)
    theta, phi = sph[..., 0], sph[..., 1]
    return _stack(xp, [xp.cos(phi) * xp.cos(theta),
                       xp.cos(phi) * xp.sin(theta),
                       xp.sin(phi)])


def cartesian_to_spherical(cart):
    """(..., 3) [x, y, z] -> (..., 2) [theta, phi], with the diverge_zero
    guard inside atan2."""
    xp = _xp(cart)
    x, y, z = cart[..., 0], cart[..., 1], cart[..., 2]
    phi = xp.arcsin(xp.clip(z, -1.0, 1.0))
    theta = xp.arctan2(diverge_zero(y), diverge_zero(x))
    return _stack(xp, [theta, phi])


def rotate_cartesian(cart, R):
    """Apply a (3, 3) rotation to a (..., 3) Cartesian grid
    (``prior_flow_tpu/geometry/rotation.py:81``); a tensor is rotated in
    its own dtype on its own device."""
    Rt = np.asarray(R).T
    if isinstance(cart, torch.Tensor):
        return cart @ torch.as_tensor(Rt, dtype=cart.dtype, device=cart.device)
    return cart @ Rt


def plane_grid(H: int, W: int, dtype=np.float64) -> np.ndarray:
    """Identity pixel grid (H, W, 2) with [..., 0] = x, [..., 1] = y."""
    xx, yy = np.meshgrid(np.arange(W, dtype=dtype), np.arange(H, dtype=dtype))
    return np.stack([xx, yy], axis=-1)


def make_sample_grid_sized(H1: int, W1: int, H2: int, W2: int,
                           R: np.ndarray) -> np.ndarray:
    """Rotation resampling grid between two ERP sizes
    (``prior_flow_tpu/geometry/rotation.py:101``): every pixel of an
    (H1, W1) output is lifted to the sphere, rotated by ``R`` and mapped to
    the pixel coordinates it samples in an (H2, W2) source. float64 math,
    float32 (H1, W1, 2) result."""
    grid = plane_grid(H1, W1)
    sph = np.stack([erp.m2theta(grid[..., 0], W1),
                    erp.n2phi(grid[..., 1], H1)], axis=-1)
    sph_rot = cartesian_to_spherical(
        rotate_cartesian(spherical_to_cartesian(sph), R))
    m = erp.theta2m(sph_rot[..., 0], W2)
    n = erp.phi2n(sph_rot[..., 1], H2)
    return np.stack([m, n], axis=-1).astype(np.float32)


def make_sample_grid(H: int, W: int, R: np.ndarray) -> np.ndarray:
    """ERP resampling grid for a spherical rotation at one size
    (``prior_flow_tpu/geometry/rotation.py:117``)."""
    return make_sample_grid_sized(H, W, H, W, R)
