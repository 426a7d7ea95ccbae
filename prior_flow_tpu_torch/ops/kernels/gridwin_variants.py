"""Variants of the DCCL grid-window stage: the CUDA kernels' wrappers and
their plain PyTorch version.

Counterparts of the JAX package's ``tools/microbench_gridwin.py`` kernels;
kernel sources ``prior_flow_tpu_torch/csrc/gridwin_variants.cu`` and, for
the pair, ``csrc/dccl_coords.cu``:

- ``gridwin_variant`` (``_variant_kernel``, via ``variant_call``): the
  cross tap coords of two rotation grids at one centre set, each variant
  on kernel 1's grid-window column body (one thread per centre, branch and
  window column; 10 row pairs of grid cells per column), by one of
  ``VARIANTS``: ``direct`` (the grids read through the read-only cache:
  one launch of the coords kernel's both-branch entry with the centre set
  for both branches) or ``smem_grid`` (both grids staged in shared memory
  by persistent blocks), each bit for bit the coords kernel's coords; or
  one of the ungated ``DIAGNOSTICS``, which split the column body's time:
  ``reads`` (the column's row-pair reads alone, each tap the unweighted sum
  of its two rows' cells) and ``arith`` (the column's corner arithmetic
  alone, no grid read: each tap the sum of its valid corners' weights and
  of weight x offset), whose outputs are not coords, each with a plain
  version of its own (``DIAGNOSTIC_PLAINS``);
- ``gridwin_pair`` (``_pair_kernel``, via ``pair_call``): both branches'
  coords, each at its own centres, in one launch of the coords kernel's
  both-branch entry at one level (kernel 1's grid-window column body).

A tensor on the CPU goes through the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dccl_coords import check_inputs, launch_cross_coords
from .dccl_lookup import NTAP, _device_or_plain, grid_window_coords

VARIANTS = {"direct": 0, "smem_grid": 1}
DIAGNOSTICS = {"reads": 2, "arith": 3}
# shared memory one block may opt into on sm_90; the smem_grid variant
# stages both (Hg, Wg, 2) f32 grids there beside its output stage (4 x 32
# centres x 81 f32)
SMEM_BYTES = 232448
SMEM_STAGE_BYTES = 4 * 32 * NTAP * 4


def gridwin_pair_plain(cen_A, cen_B, grid_A, grid_B, scale: float):
    """cen_*: (N, 2) f32 unscaled 1/8 centres; grid_*: (Hg, Wg, 2) f32.
    Returns (cAx, cAy, cBx, cBy), each (N, 81) f32: ``grid_window_coords``
    of grid A at cen_A and of grid B at cen_B."""
    return tuple(c.contiguous() for c in (
        *grid_window_coords(cen_A, grid_A, scale),
        *grid_window_coords(cen_B, grid_B, scale)))


def gridwin_variant_plain(cen, grid_A, grid_B, scale: float):
    """Both grids at one centre set: ``gridwin_pair_plain(cen, cen, ...)``,
    what every semantic variant computes."""
    return gridwin_pair_plain(cen, cen, grid_A, grid_B, scale)


def gridwin_reads_plain(cen, grid_A, grid_B, scale: float):
    """The reads diagnostic: for each grid, window column i reads the cells
    (xa, y) and (xb, y) of rows y = y0 .. y0 + 9, with xa = (floor(cen.x *
    scale) + i - 4) mod Wg, xb = min(xa + 1, Wg - 1), y0 = floor(cen.y *
    scale) - 4 and every row clamped to [0, Hg - 1]; tap k = i*9 + j is the
    sum of rows j and j + 1, each row the sum of its two cells. Returns
    (x A, y A, x B, y B), each (N, 81) f32."""
    Hg, Wg, _ = grid_A.shape
    c = cen.reshape(-1, 2)
    dev = c.device
    fx = torch.floor(c[:, 0] * scale).long()
    fy = torch.floor(c[:, 1] * scale).long()
    xa = (fx[:, None] + torch.arange(-4, 5, device=dev)) % Wg
    xb = torch.clamp(xa + 1, max=Wg - 1)
    y = torch.clamp(fy[:, None] + torch.arange(-4, 6, device=dev), 0, Hg - 1)
    outs = []
    for grid in (grid_A, grid_B):
        flat = grid.reshape(-1, 2)
        row = (flat[y[:, None, :] * Wg + xa[:, :, None]]
               + flat[y[:, None, :] * Wg + xb[:, :, None]])
        tap = (row[:, :, :-1] + row[:, :, 1:]).reshape(c.shape[0], NTAP, 2)
        outs += [tap[..., 0].contiguous(), tap[..., 1].contiguous()]
    return tuple(outs)


def gridwin_arith_plain(cen, grid_A, grid_B, scale: float):
    """The arith diagnostic: the grid-window sampling of both grids at
    ``cen`` on a probe grid whose cell at offset o = y * Wg + x holds
    (1, o), so that tap k gives (the sum of its valid corners' weights,
    the sum of weight x offset). Returns (x A, y A, x B, y B), each (N, 81)
    f32; A and B agree, the grids' values being unread."""
    Hg, Wg, _ = grid_A.shape
    cells = torch.arange(Hg * Wg, dtype=torch.float32, device=cen.device)
    probe = torch.stack([torch.ones_like(cells), cells], -1).reshape(Hg, Wg,
                                                                     2)
    return gridwin_variant_plain(cen, probe, probe, scale)


DIAGNOSTIC_PLAINS = {"reads": gridwin_reads_plain,
                     "arith": gridwin_arith_plain}


_p = ctypes.c_void_p
ENTRIES = _build.Entries({"gridwin_variant": [
    ctypes.c_int, _p, _p, _p, _p, _p, _p, _p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, _p]})


def _launch_variant(code: int, cen, grid_A, grid_B, scale: float):
    """Checks the inputs and launches ``gridwin_variants.cu``'s entry
    (smem_grid or a diagnostic); the caller counts the launch."""
    need = 2 * grid_A.numel() * 4 + SMEM_STAGE_BYTES
    if code == VARIANTS["smem_grid"] and need > SMEM_BYTES:
        raise ValueError(f"gridwin_variant: two {tuple(grid_A.shape)} grids "
                         f"and the output stage take {need} bytes, more "
                         f"than the {SMEM_BYTES} of one block's shared "
                         f"memory")
    check_inputs("gridwin_variant", (cen,), (grid_A, grid_B))
    N = cen.numel() // 2
    Hg, Wg, _ = grid_A.shape
    outs = torch.empty((4, N, NTAP), dtype=torch.float32,
                       device=cen.device).unbind(0)
    ENTRIES.launch("gridwin_variant", cen.device, code, cen.data_ptr(),
                   grid_A.data_ptr(), grid_B.data_ptr(),
                   *(o.data_ptr() for o in outs), N, Hg, Wg, float(scale))
    return outs


def gridwin_variant(cen, grid_A, grid_B, scale: float,
                    variant: str = "direct"):
    """Grid A's and grid B's cross tap coords at ``cen`` by ``variant``;
    for a semantic variant, the same arguments and results as
    ``gridwin_variant_plain``, for a diagnostic as its plain version in
    ``DIAGNOSTIC_PLAINS``."""
    code = {**VARIANTS, **DIAGNOSTICS}.get(variant)
    if code is None:
        raise ValueError(f"variant must be one of "
                         f"{sorted(VARIANTS) + sorted(DIAGNOSTICS)}, got "
                         f"{variant!r}")
    if _device_or_plain("gridwin_variant", cen):
        plain = DIAGNOSTIC_PLAINS.get(variant, gridwin_variant_plain)
        return plain(cen, grid_A, grid_B, scale)
    if variant == "direct":
        outs = launch_cross_coords("gridwin_variant", cen, cen, grid_A,
                                   grid_B, [scale])
    else:
        outs = _launch_variant(code, cen, grid_A, grid_B, scale)
    gridwin_variant.launches += 1
    return outs


gridwin_variant.launches = 0


def gridwin_pair(cen_A, cen_B, grid_A, grid_B, scale: float):
    """Both branches' cross tap coords in one launch; same arguments and
    results as ``gridwin_pair_plain``."""
    if _device_or_plain("gridwin_pair", cen_A):
        return gridwin_pair_plain(cen_A, cen_B, grid_A, grid_B, scale)
    outs = launch_cross_coords("gridwin_pair", cen_A, cen_B, grid_A, grid_B,
                               [scale])
    gridwin_pair.launches += 1
    return outs


gridwin_pair.launches = 0
