"""Precomputed spherical-rotation grid bundles
(counterpart of ``prior_flow_tpu/geometry/grids.py``).

A->B uses Euler angles (z, y, x) = (0, 0, -pi/2); B->A uses (0, 0, +pi/2).
``a2b`` produces the B view from A (camera->world direction), ``a2b_w2c``
is the same rotation transposed (world->camera), suffix ``_8`` marks the
1/8-resolution variant. Entries are float32 numpy ``(h, w, 2)`` arrays,
cached per (H, W); ``to_device`` gives torch copies.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .rotation import make_sample_grid, rotation_matrix


class RotationGrids(NamedTuple):
    a2b: np.ndarray
    a2b_8: np.ndarray
    a2b_w2c: np.ndarray
    a2b_w2c_8: np.ndarray
    b2a: np.ndarray
    b2a_8: np.ndarray
    b2a_w2c: np.ndarray
    b2a_w2c_8: np.ndarray

    def to_device(self, device) -> "RotationGrids":
        """The same bundle as float32 torch tensors on ``device``."""
        return RotationGrids(*(torch.from_numpy(g).to(device) for g in self))


@lru_cache(maxsize=16)
def rotation_grids(H: int, W: int) -> RotationGrids:
    """Grid bundle for images of shape (H, W); 1/8 grids use (H//8, W//8)."""
    if H % 8 or W % 8:
        raise ValueError(f"(H, W) must be divisible by 8, got {(H, W)}")
    R_a2b = rotation_matrix([0.0, 0.0, -math.pi / 2])
    R_b2a = rotation_matrix([0.0, 0.0, math.pi / 2])
    h8, w8 = H // 8, W // 8
    return RotationGrids(
        a2b=make_sample_grid(H, W, R_a2b),
        a2b_8=make_sample_grid(h8, w8, R_a2b),
        a2b_w2c=make_sample_grid(H, W, R_a2b.T),
        a2b_w2c_8=make_sample_grid(h8, w8, R_a2b.T),
        b2a=make_sample_grid(H, W, R_b2a),
        b2a_8=make_sample_grid(h8, w8, R_b2a),
        b2a_w2c=make_sample_grid(H, W, R_b2a.T),
        b2a_w2c_8=make_sample_grid(h8, w8, R_b2a.T),
    )


@lru_cache(maxsize=32)
def sample_grid(H: int, W: int, euler_zyx: tuple,
                transpose: bool = False) -> np.ndarray:
    """One cached rotation grid (H, W, 2) float32 for Euler angles (z, y, x)
    (``prior_flow_tpu/geometry/grids.py:63``)."""
    R = rotation_matrix(list(euler_zyx))
    return make_sample_grid(H, W, R.T if transpose else R)


_VIEW_ANGLES = {"a2b": -math.pi / 2, "b2a": math.pi / 2}


def view_grid(H: int, W: int, name: str) -> np.ndarray:
    """The ``a2b`` or ``b2a`` grid at (H, W): the bundle's where H and W
    divide by 8, else the same rotation built alone
    (``prior_flow_tpu/ops/warp.py:55-66``)."""
    if H % 8 == 0 and W % 8 == 0:
        return getattr(rotation_grids(H, W), name)
    return sample_grid(H, W, (0.0, 0.0, _VIEW_ANGLES[name]))


@lru_cache(maxsize=32)
def identity_grid(H: int, W: int) -> np.ndarray:
    """Identity pixel-coordinate grid (H, W, 2) float32, [..., 0] = x
    (``prior_flow_tpu/geometry/grids.py:70``). The cached array is shared:
    callers copy it, never write to it."""
    x, y = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    out = np.stack([x, y], axis=-1)
    out.flags.writeable = False
    return out


def identity_grid_on(H: int, W: int, device) -> torch.Tensor:
    """Identity pixel-coordinate grid (H, W, 2) f32, [..., 0] = x, built
    on ``device`` (no host-to-device copy)."""
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    return torch.stack([x, y], dim=-1)
