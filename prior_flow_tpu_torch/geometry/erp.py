"""ERP (equirectangular projection) coordinate algebra.

Counterpart of ``prior_flow_tpu/geometry/erp.py``. The scalar and grid
maps are plain arithmetic, so they serve both the float64 numpy grid
builders and torch tensors; ``u_clip`` and ``flow_to_endpoint`` are
torch-only.

Conventions: coordinate grids are channels-last ``(..., 2)`` with
``[..., 0] = x (m)`` and ``[..., 1] = y (n)``; pixel centres sit at
half-integer normalised coordinates (``u = (m + 0.5) / W``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi


def n2v(n, H):
    """Vertical pixel index [0, H) -> normalised v in (0, 1)."""
    return (n + 0.5) / H


def v2n(v, H):
    return v * H - 0.5


def v2phi(v):
    """Normalised v -> latitude phi in (-pi/2, pi/2); v = 0 is the north pole."""
    return (0.5 - v) * PI


def phi2v(phi):
    return 0.5 - phi / PI


def n2phi(n, H):
    return v2phi(n2v(n, H))


def phi2n(phi, H):
    return v2n(phi2v(phi), H)


def m2u(m, W):
    """Horizontal pixel index [0, W) -> normalised u in (0, 1)."""
    return (m + 0.5) / W


def u2m(u, W):
    return u * W - 0.5


def u2theta(u):
    """Normalised u -> longitude theta in [-pi, pi]."""
    return (u - 0.5) * 2.0 * PI


def theta2u(theta):
    return theta / (2.0 * PI) + 0.5


def m2theta(m, W):
    return u2theta(m2u(m, W))


def theta2m(theta, W):
    return u2m(theta2u(theta), W)


def _stack(a, b):
    """Stack two equally shaped numpy arrays or torch tensors on a new last
    axis."""
    if isinstance(a, torch.Tensor):
        return torch.stack([a, b], dim=-1)
    return np.stack([a, b], axis=-1)


def plane_to_spherical(grid, H, W):
    """Pixel grid ``(..., 2)`` [m, n] -> spherical grid ``(..., 2)``
    [theta, phi] (``prior_flow_tpu/geometry/erp.py:94``)."""
    return _stack(m2theta(grid[..., 0], W), n2phi(grid[..., 1], H))


def spherical_to_plane(sph, H, W, is_flow=False):
    """Spherical grid ``(..., 2)`` [theta, phi] -> pixel grid ``(..., 2)``
    (``prior_flow_tpu/geometry/erp.py:104``). With ``is_flow=True`` the
    input is an angular displacement and the output the pixel displacement
    ``d_m = d_theta * W / (2 pi)``, ``d_n = d_phi * H / (-pi)``."""
    if not is_flow:
        return _stack(theta2m(sph[..., 0], W), phi2n(sph[..., 1], H))
    return _stack(sph[..., 0] * W / (2.0 * PI), sph[..., 1] * H / (-PI))


def piecewise_fun(x, bound):
    """Piecewise-linear [0, bound) -> [-0.5, bound - 0.5)
    (``prior_flow_tpu/geometry/erp.py:134``)."""
    if isinstance(x, torch.Tensor):
        return torch.where(x >= bound - 0.5, x - bound, x)
    return np.where(x >= bound - 0.5, x - bound, x)


def u_clip(u: torch.Tensor, W: int) -> torch.Tensor:
    """Wrap horizontal flow periodically into [-W/2, W/2)
    (``prior_flow_tpu/geometry/erp.py:126``)."""
    return torch.remainder(u + W / 2.0, W) - W / 2.0


def flow_to_endpoint(startpoint: torch.Tensor, flow: torch.Tensor,
                     H: int, W: int) -> torch.Tensor:
    """Start coords + flow -> endpoint coords, x wrapped into
    [-0.5, W - 0.5) and y clamped to [-0.5, H - 0.5]
    (``prior_flow_tpu/geometry/erp.py:142``)."""
    end = startpoint + flow
    ex = torch.remainder(end[..., 0] + 0.5, W) - 0.5
    ey = torch.clamp(end[..., 1], -0.5, H - 0.5)
    return torch.stack([ex, ey], dim=-1)
