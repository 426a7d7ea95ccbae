"""DCCL cross tap coords: the CUDA kernel's wrappers and their plain
PyTorch versions.

Counterpart of ``prior_flow_tpu/ops/pallas/dccl_gather.py::
dccl_grid_coords`` (kernel ``_coords_kernel``); kernel source
``prior_flow_tpu_torch/csrc/dccl_coords.cu``. The 1/8 world-to-camera
rotation grid is sampled at the 81 level-scaled window coords around each
centre: the stage of the lookup that places its cross taps. One body, kernel
1's grid-window stage run alone (one thread per centre, branch and window
column), serves three entries:

- ``dccl_cross_coords``: both branches at every level in one launch, the
  planes route's call (``ops/corr.py::DCCLFused``);
- ``dccl_grid_coords``: one branch at one level;
- ``gridwin_variants.gridwin_pair``: both branches at one level, the
  grid-window tool's pair.

The kernel shares its arithmetic with the lookup and scatter kernels
(``csrc/dccl_common.cuh``), so on the card all give the same bits. The grid
route's backward computes the coords inside the scatter instead.

A tensor on the CPU goes through the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dccl_lookup import NTAP, _device_or_plain, grid_window_coords

MAX_LEVELS = 8   # the level scales one launch of dccl_cross_coords takes


def dccl_grid_coords_plain(cen: torch.Tensor, grid: torch.Tensor,
                           scale: float):
    """cen: (N, 2) f32 unscaled 1/8 centres; grid: (Hg, Wg, 2) f32.
    Returns (cx, cy), each (N, 81) f32, slot k = i*9 + j with x-offset i-4
    and y-offset j-4: ``cycle_bilinear_sample`` of the grid at the window
    coords, the computation of ``dccl_level_lookup_plain``."""
    cx, cy = grid_window_coords(cen, grid, scale)
    return cx.contiguous(), cy.contiguous()


def dccl_cross_coords_plain(cen_A, cen_B, grid_A, grid_B, scales):
    """cen_*: (..., 2) f32 unscaled 1/8 centres, N of them; grid_*:
    (Hg, Wg, 2) f32; scales: the L level scales. Returns (xA, yA, xB, yB),
    each (L*N, 81) f32, level after level: ``dccl_grid_coords_plain`` of
    grid A at cen_A and of grid B at cen_B at each scale, stacked."""
    outs = []
    for cen, grid in ((cen_A, grid_A), (cen_B, grid_B)):
        levels = [dccl_grid_coords_plain(cen.reshape(-1, 2), grid, s)
                  for s in scales]
        outs += [torch.cat([lv[j] for lv in levels]) for j in (0, 1)]
    return tuple(outs)


_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (L, cenA, cenB, gridA, gridB, xA, yA, xB, yB, N, Hg, Wg, scales, stream)
CROSS_COORDS_ARGTYPES = [_i, _p, _p, _p, _p, _p, _p, _p, _p, _ll, _i, _i, _p,
                         _p]
ENTRIES = _build.Entries({
    "dccl_cross_coords": CROSS_COORDS_ARGTYPES,
    "dccl_grid_coords": [_p, _p, _p, _p, _ll, _i, _i, ctypes.c_float, _p]})


def check_inputs(name, cens, grids):
    """Centres (..., 2) f32 of one shape, grids (Hg, Wg, 2) f32 of one
    shape, all contiguous on one device."""
    dev = cens[0].device
    for c in cens:
        if c.device != dev or c.dtype != torch.float32 or c.shape[-1] != 2 \
                or c.shape != cens[0].shape or not c.is_contiguous():
            raise ValueError(f"{name}: centres must be contiguous (..., 2) "
                             f"float32 of one shape on one device, got "
                             f"{tuple(c.shape)} {c.dtype} on {c.device}")
    for g in grids:
        if g.device != dev or g.dtype != torch.float32 or g.dim() != 3 \
                or g.shape[2] != 2 or g.shape != grids[0].shape \
                or not g.is_contiguous():
            raise ValueError(f"{name}: grids must be contiguous (Hg, Wg, 2) "
                             f"float32 of one shape on the centres' device, "
                             f"got {tuple(g.shape)} {g.dtype} on {g.device}")


def launch_cross_coords(name, cen_A, cen_B, grid_A, grid_B, scales):
    """Checks the inputs and launches the both-branch entry; the caller
    (``dccl_cross_coords`` or ``gridwin_pair``) counts the launch."""
    check_inputs(name, (cen_A, cen_B), (grid_A, grid_B))
    L = len(scales)
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"{name}: 1 to {MAX_LEVELS} level scales, got {L}")
    N = cen_A.numel() // 2
    Hg, Wg, _ = grid_A.shape
    outs = torch.empty((4, L * N, NTAP), dtype=torch.float32,
                       device=cen_A.device).unbind(0)
    ENTRIES.launch("dccl_cross_coords", cen_A.device, L, cen_A.data_ptr(),
                   cen_B.data_ptr(), grid_A.data_ptr(), grid_B.data_ptr(),
                   *(o.data_ptr() for o in outs), N, Hg, Wg,
                   (ctypes.c_float * L)(*map(float, scales)))
    return outs


def dccl_cross_coords(cen_A, cen_B, grid_A, grid_B, scales):
    """Both branches' cross tap coords at every level in one launch; same
    arguments and results as ``dccl_cross_coords_plain``, bitwise equal to
    it on the card."""
    if _device_or_plain("dccl_cross_coords", cen_A):
        return dccl_cross_coords_plain(cen_A, cen_B, grid_A, grid_B, scales)
    outs = launch_cross_coords("dccl_cross_coords", cen_A, cen_B, grid_A,
                               grid_B, scales)
    dccl_cross_coords.launches += 1
    return outs


dccl_cross_coords.launches = 0


def dccl_grid_coords(cen: torch.Tensor, grid: torch.Tensor, scale: float):
    """Cross tap coords of one branch at one level; same arguments and
    results as ``dccl_grid_coords_plain``, bitwise equal to it on the
    card."""
    if _device_or_plain("dccl_grid_coords", cen):
        return dccl_grid_coords_plain(cen, grid, scale)
    if cen.dim() != 2:
        raise ValueError(f"dccl_grid_coords: centres must be (N, 2), got "
                         f"{tuple(cen.shape)}")
    check_inputs("dccl_grid_coords", (cen,), (grid,))
    N = cen.shape[0]
    Hg, Wg, _ = grid.shape
    cx, cy = torch.empty((2, N, NTAP), dtype=torch.float32,
                         device=cen.device).unbind(0)
    ENTRIES.launch("dccl_grid_coords", cen.device, cen.data_ptr(),
                   grid.data_ptr(), cx.data_ptr(), cy.data_ptr(), N, Hg, Wg,
                   float(scale))
    dccl_grid_coords.launches += 1
    return cx, cy


dccl_grid_coords.launches = 0
