"""Variants of the DCCL grid-window stage: the CUDA kernels' wrappers and
their plain PyTorch version.

Counterparts of the JAX package's ``tools/microbench_gridwin.py`` kernels;
kernel sources ``prior_flow_tpu_torch/csrc/gridwin_variants.cu`` and, for
the pair, ``csrc/dccl_coords.cu``:

- ``gridwin_variant`` (``_variant_kernel``, via ``variant_call``): the
  cross tap coords of two rotation grids at one centre set, by one of
  ``VARIANTS``: ``direct`` (a thread per tap, the grids read through the
  read-only cache) or ``smem_grid`` (both grids staged in shared memory by
  persistent blocks), each bit for bit the coords kernel's coords; or one
  of the ungated ``DIAGNOSTICS``: ``reads`` (the grid reads alone, corner
  values summed unweighted) and ``arith`` (the corner arithmetic alone, no
  grid read), whose outputs are not coords;
- ``gridwin_pair`` (``_pair_kernel``, via ``pair_call``): both branches'
  coords, each at its own centres, in one launch of the coords kernel's
  both-branch entry at one level (kernel 1's grid-window column body).

A tensor on the CPU goes through the plain version (the diagnostics have
none and raise there); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dccl_coords import check_inputs, launch_cross_coords
from .dccl_lookup import NTAP, _device_or_plain, grid_window_coords

VARIANTS = {"direct": 0, "smem_grid": 1}
DIAGNOSTICS = {"reads": 2, "arith": 3}
# shared memory one block may opt into on sm_90 (the smem_grid variant
# stages both (Hg, Wg, 2) f32 grids there)
SMEM_BYTES = 232448


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


_p = ctypes.c_void_p
ENTRIES = _build.Entries({"gridwin_variant": [
    ctypes.c_int, _p, _p, _p, _p, _p, _p, _p, _p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, _p]})


def gridwin_variant(cen, grid_A, grid_B, scale: float,
                    variant: str = "direct"):
    """Grid A's and grid B's cross tap coords at ``cen`` by ``variant``;
    for a semantic variant, the same arguments and results as
    ``gridwin_variant_plain``."""
    code = {**VARIANTS, **DIAGNOSTICS}.get(variant)
    if code is None:
        raise ValueError(f"variant must be one of "
                         f"{sorted(VARIANTS) + sorted(DIAGNOSTICS)}, got "
                         f"{variant!r}")
    if _device_or_plain("gridwin_variant", cen):
        if variant in DIAGNOSTICS:
            raise ValueError(f"gridwin_variant: the diagnostic {variant!r} "
                             f"runs on the card only")
        return gridwin_variant_plain(cen, grid_A, grid_B, scale)
    if variant == "smem_grid" and 2 * grid_A.numel() * 4 > SMEM_BYTES:
        raise ValueError(f"gridwin_variant: two {tuple(grid_A.shape)} grids "
                         f"take {2 * grid_A.numel() * 4} bytes, more than the "
                         f"{SMEM_BYTES} of one block's shared memory")
    check_inputs("gridwin_variant", (cen,), (grid_A, grid_B))
    N = cen.numel() // 2
    Hg, Wg, _ = grid_A.shape
    outs = torch.empty((4, N, NTAP), dtype=torch.float32,
                       device=cen.device).unbind(0)
    ENTRIES.launch("gridwin_variant", cen.device, code, cen.data_ptr(),
                   cen.data_ptr(), grid_A.data_ptr(), grid_B.data_ptr(),
                   *(o.data_ptr() for o in outs), N, Hg, Wg, float(scale))
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
