"""The DCCL level lookup's three stages, each alone: the CUDA kernel's
wrappers and their plain PyTorch versions.

Counterparts of the JAX package's ``tools/microbench_kernel_split.py``
kernels ``_own_only_kernel``, ``_gridwin_only_kernel`` and
``_cross_only_kernel`` (via ``_variant_call``). Each stage is the part of
``dccl_lookup.dccl_level_lookup`` (kernel 1) that it names, both branches,
one level, run by kernel 1's column body with the other stages compiled
out (``csrc/dccl_stages.cu``):

- ``dccl_own_only``: the own 9x9 window taps, (own_A, own_B);
- ``dccl_gridwin_only``: the cross tap coords, (cAx, cAy, cBx, cBy), the
  rotation grids sampled at the level-scaled windows;
- ``dccl_cross_only``: the grid window and the cross taps in the other
  branch's volume, (cross_A, cross_B).

They take kernel 1's arguments and give its bits: own and cross its own and
cross outputs, the grid window the coords kernel's coords. A tensor on the
CPU goes through the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dccl_lookup import (NTAP, RADIUS, _check_grids, _check_level,
                          _device_or_plain, grid_window_coords,
                          sample_volume_level, window_delta)

# the entry's stage number and output count of each stage
STAGES = {"own": (0, 2), "cross": (1, 2), "gridwin": (2, 4)}


def dccl_own_only_plain(vol_A, vol_B, cen_A, cen_B, grid_A, grid_B,
                        scale: float):
    """vol_*: (B, Q, Hl, Wl) f32 or bf16; cen_*: (B, Q, 2) f32 unscaled 1/8
    centres; grid_* unused (kept for one signature). Returns (own_A, own_B),
    each (B, Q, 81) f32: ``sample_volume_level`` at the level-scaled
    window, as ``dccl_level_lookup_plain`` computes them."""
    delta = window_delta(RADIUS, cen_A.device)
    return tuple(sample_volume_level(v, (c * scale).unsqueeze(2) + delta).float()
                 for v, c in ((vol_A, cen_A), (vol_B, cen_B)))


def dccl_gridwin_only_plain(vol_A, vol_B, cen_A, cen_B, grid_A, grid_B,
                            scale: float):
    """Returns (cAx, cAy, cBx, cBy), each (B, Q, 81) f32:
    ``grid_window_coords`` of each branch's grid at its centres. The
    volumes are unused."""
    return (*grid_window_coords(cen_A, grid_A, scale),
            *grid_window_coords(cen_B, grid_B, scale))


def dccl_cross_only_plain(vol_A, vol_B, cen_A, cen_B, grid_A, grid_B,
                          scale: float):
    """Returns (cross_A, cross_B), each (B, Q, 81) f32: branch A's grid
    window sampled in volume B, branch B's in volume A."""
    cAx, cAy, cBx, cBy = dccl_gridwin_only_plain(vol_A, vol_B, cen_A, cen_B,
                                                 grid_A, grid_B, scale)
    return (sample_volume_level(vol_B, torch.stack([cAx, cAy], -1)).float(),
            sample_volume_level(vol_A, torch.stack([cBx, cBy], -1)).float())


PLAIN = {"own": dccl_own_only_plain, "gridwin": dccl_gridwin_only_plain,
         "cross": dccl_cross_only_plain}


_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRIES = _build.Entries({"dccl_stage": [_i, _p, _p, _i, _p, _p, _p, _p, _p,
                                         _p, _p, _p, _i, _i, _i, _i, _i, _f,
                                         _p]})


def _stage(stage: str, wrapper, vol_A, vol_B, cen_A, cen_B, grid_A, grid_B,
           scale: float):
    name = wrapper.__name__
    if _device_or_plain(name, vol_A):
        return PLAIN[stage](vol_A, vol_B, cen_A, cen_B, grid_A, grid_B, scale)
    _check_level(name, vol_A, vol_B, cen_A, cen_B, (grid_A, grid_B))
    _check_grids(grid_A, grid_B)
    B, Q, Hl, Wl = vol_A.shape
    Hg, Wg, _ = grid_A.shape
    number, n_out = STAGES[stage]
    outs = torch.empty((n_out, B, Q, NTAP), dtype=torch.float32,
                       device=vol_A.device).unbind(0)
    ptrs = [o.data_ptr() for o in outs] + [None] * (4 - n_out)
    ENTRIES.launch("dccl_stage", vol_A.device, number, vol_A.data_ptr(),
                   vol_B.data_ptr(), int(vol_A.dtype == torch.bfloat16),
                   cen_A.data_ptr(), cen_B.data_ptr(), grid_A.data_ptr(),
                   grid_B.data_ptr(), *ptrs, B * Q, Hl, Wl, Hg, Wg,
                   float(scale))
    wrapper.launches += 1
    return tuple(outs)


def dccl_own_only(vol_A, vol_B, cen_A, cen_B, grid_A, grid_B, scale: float):
    """Kernel 1's own taps alone; arguments as ``dccl_level_lookup``,
    results as ``dccl_own_only_plain``."""
    return _stage("own", dccl_own_only, vol_A, vol_B, cen_A, cen_B, grid_A,
                  grid_B, scale)


def dccl_gridwin_only(vol_A, vol_B, cen_A, cen_B, grid_A, grid_B,
                      scale: float):
    """Kernel 1's grid-window stage alone; arguments as
    ``dccl_level_lookup``, results as ``dccl_gridwin_only_plain``."""
    return _stage("gridwin", dccl_gridwin_only, vol_A, vol_B, cen_A, cen_B,
                  grid_A, grid_B, scale)


def dccl_cross_only(vol_A, vol_B, cen_A, cen_B, grid_A, grid_B, scale: float):
    """Kernel 1's grid window and cross taps, no own taps; arguments as
    ``dccl_level_lookup``, results as ``dccl_cross_only_plain``."""
    return _stage("cross", dccl_cross_only, vol_A, vol_B, cen_A, cen_B,
                  grid_A, grid_B, scale)


for _w in (dccl_own_only, dccl_gridwin_only, dccl_cross_only):
    _w.launches = 0
