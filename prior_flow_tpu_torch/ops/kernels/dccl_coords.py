"""DCCL cross tap coords for one branch at one pyramid level: the CUDA
kernel's wrapper and its plain PyTorch version.

Counterpart of ``prior_flow_tpu/ops/pallas/dccl_gather.py::
dccl_grid_coords`` (kernel ``_coords_kernel``); kernel source
``prior_flow_tpu_torch/csrc/dccl_coords.cu``. The 1/8 world-to-camera
rotation grid is sampled at the 81 level-scaled window coords around each
centre: the stage of the lookup that places its cross taps. The backward of
the lookup recomputes these coords from the centres instead of keeping
them. The kernel shares its arithmetic with the lookup kernel
(``csrc/dccl_common.cuh``), so on the card both give the same bits.

A tensor on the CPU goes through the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dccl_lookup import NTAP, grid_window_coords


def dccl_grid_coords_plain(cen: torch.Tensor, grid: torch.Tensor,
                           scale: float):
    """cen: (N, 2) f32 unscaled 1/8 centres; grid: (Hg, Wg, 2) f32.
    Returns (cx, cy), each (N, 81) f32, slot k = i*9 + j with x-offset i-4
    and y-offset j-4: ``cycle_bilinear_sample`` of the grid at the window
    coords, the computation of ``dccl_level_lookup_plain``."""
    cx, cy = grid_window_coords(cen, grid, scale)
    return cx.contiguous(), cy.contiguous()


def _kernel():
    fn = _build.load_library().lib.dccl_grid_coords
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def dccl_grid_coords(cen: torch.Tensor, grid: torch.Tensor, scale: float):
    """Cross tap coords of one branch at one level; same arguments and
    results as ``dccl_grid_coords_plain``."""
    if cen.device.type == "cpu":
        return dccl_grid_coords_plain(cen, grid, scale)
    if cen.device.type != "cuda":
        raise RuntimeError(f"dccl_grid_coords: no kernel for device "
                           f"{cen.device}")
    if grid.device != cen.device:
        raise ValueError("dccl_grid_coords: inputs on different devices")
    if cen.dim() != 2 or cen.shape[1] != 2 or cen.dtype != torch.float32:
        raise ValueError(f"centres must be (N, 2) float32, got "
                         f"{tuple(cen.shape)} {cen.dtype}")
    if grid.dim() != 3 or grid.shape[2] != 2 or grid.dtype != torch.float32:
        raise ValueError(f"grid must be (Hg, Wg, 2) float32, got "
                         f"{tuple(grid.shape)} {grid.dtype}")
    if not (cen.is_contiguous() and grid.is_contiguous()):
        raise ValueError("dccl_grid_coords: inputs must be contiguous")
    N = cen.shape[0]
    Hg, Wg, _ = grid.shape
    cx = torch.empty((N, NTAP), dtype=torch.float32, device=cen.device)
    cy = torch.empty((N, NTAP), dtype=torch.float32, device=cen.device)
    with torch.cuda.device(cen.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _kernel()(cen.data_ptr(), grid.data_ptr(), cx.data_ptr(),
                           cy.data_ptr(), N, Hg, Wg, float(scale), stream)
    _build.check(status, "dccl_grid_coords")
    dccl_grid_coords.launches += 1
    return cx, cy


dccl_grid_coords.launches = 0
