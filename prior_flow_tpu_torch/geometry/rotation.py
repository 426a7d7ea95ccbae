"""Spherical rotation math and ERP resampling-grid generation, host side.

Counterpart of ``prior_flow_tpu/geometry/rotation.py``: grids are built
once per (H, W, rotation) in float64 numpy and cast to float32.
"""

from __future__ import annotations

import math

import numpy as np

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


def diverge_zero(x: np.ndarray, eps: float = _EPS) -> np.ndarray:
    """Push |x| < eps away from zero, sign-preserving; exact zeros stay."""
    near_zero = np.abs(x) < eps
    return x + np.sign(x) * near_zero * eps


def spherical_to_cartesian(sph: np.ndarray) -> np.ndarray:
    """(..., 2) [theta, phi] -> (..., 3) [x, y, z] on the unit sphere."""
    theta, phi = sph[..., 0], sph[..., 1]
    return np.stack([np.cos(phi) * np.cos(theta),
                     np.cos(phi) * np.sin(theta),
                     np.sin(phi)], axis=-1)


def cartesian_to_spherical(cart: np.ndarray) -> np.ndarray:
    """(..., 3) [x, y, z] -> (..., 2) [theta, phi], with the diverge_zero
    guard inside atan2."""
    x, y, z = cart[..., 0], cart[..., 1], cart[..., 2]
    phi = np.arcsin(np.clip(z, -1.0, 1.0))
    theta = np.arctan2(diverge_zero(y), diverge_zero(x))
    return np.stack([theta, phi], axis=-1)


def plane_grid(H: int, W: int, dtype=np.float64) -> np.ndarray:
    """Identity pixel grid (H, W, 2) with [..., 0] = x, [..., 1] = y."""
    xx, yy = np.meshgrid(np.arange(W, dtype=dtype), np.arange(H, dtype=dtype))
    return np.stack([xx, yy], axis=-1)


def make_sample_grid(H: int, W: int, R: np.ndarray) -> np.ndarray:
    """ERP resampling grid for a spherical rotation
    (``prior_flow_tpu/geometry/rotation.py:117``): every output pixel is
    lifted to the sphere, rotated by ``R`` and mapped back to the source
    pixel coordinates it samples. float64 math, float32 (H, W, 2) result."""
    grid = plane_grid(H, W)
    sph = np.stack([erp.m2theta(grid[..., 0], W),
                    erp.n2phi(grid[..., 1], H)], axis=-1)
    cart_rot = spherical_to_cartesian(sph) @ np.asarray(R).T
    sph_rot = cartesian_to_spherical(cart_rot)
    m = erp.theta2m(sph_rot[..., 0], W)
    n = erp.phi2n(sph_rot[..., 1], H)
    return np.stack([m, n], axis=-1).astype(np.float32)
