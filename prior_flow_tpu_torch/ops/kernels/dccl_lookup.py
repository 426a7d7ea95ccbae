"""DCCL level lookup for both branches: the CUDA kernels' wrappers and
their plain PyTorch versions.

Kernel source ``prior_flow_tpu_torch/csrc/dccl_lookup.cu``; three entries,
counterparts of the JAX package's ``prior_flow_tpu/ops/pallas/
dccl_gather.py`` kernels:

- ``dccl_level_lookup`` (``_dccl_grid_kernel``, via
  ``dccl_level_lookup_grid_fused``): for one pyramid level, each branch
  gets its own 9x9 window taps from its own volume, and cross taps: the 1/8
  rotation grid bilinearly sampled at the level-scaled window coords, then
  used unscaled to sample the OTHER branch's volume;
- ``dccl_lookup_all_levels`` (``_dccl_grid_kernel_all``, via
  ``dccl_packed_lookup_grid_all``): the same for every level in one launch;
- ``dccl_level_lookup_coords`` (``_dccl_kernel``, via
  ``dccl_packed_lookup_planes``): the own taps as above and the cross taps
  at GIVEN coords (the other branch's volume sampled there).

A tensor on the CPU goes through the plain version; a CUDA tensor launches
the kernel or raises. Kernel 1 and the all-levels launch write into given
arrays at a row stride and a column offset (``out``), so the grid route's
levels land in the four (B, Q, L*81) fields without a copy. The entries are
bound once (``ENTRIES``) and each wrapper checks its inputs in one pass:
issued back to back, a launch costs the host less than the card. The
wrappers themselves are forward-only; their gradients are
``ops/corr.py::DCCLAllLevelsLookup`` and ``DCCLLevelLookupCoords``, whose
backwards run the scatter kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..samplers import cycle_bilinear_sample
from . import _build

RADIUS = 4
NTAP = (2 * RADIUS + 1) ** 2


def window_delta(radius: int = RADIUS, device=None) -> torch.Tensor:
    """(K, 2) window offsets: tap k = i*(2r+1) + j has x-offset i-r and
    y-offset j-r (the reference's meshgrid(dy, dx) order)."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    n = 2 * radius + 1
    return torch.stack([d.repeat_interleave(n), d.repeat(n)], dim=-1)


def sample_volume_level(vol_l: torch.Tensor, coords: torch.Tensor):
    """Wrap-x bilinear sample of a per-query level volume.
    vol_l: (B, Q, Hl, Wl); coords: (B, Q, K, 2) -> (B, Q, K)."""
    B, Q, Hl, Wl = vol_l.shape
    K = coords.shape[2]
    out = cycle_bilinear_sample(vol_l.reshape(B * Q, Hl, Wl, 1),
                                coords.reshape(B * Q, K, 2))
    return out.reshape(B, Q, K)


def dccl_level_lookup_coords_plain(vol_A, vol_B, cen_A, cen_B, scale: float,
                                   cxA, cyA, cxB, cyB):
    """Plain version of the lookup at given cross coords: own taps at the
    level-scaled window (``sample_volume_level``), branch A's cross taps at
    (cxA, cyA) in volume B and branch B's at (cxB, cyB) in volume A
    (``_dccl_kernel``, ``dccl_gather.py:323-330``).

    vol_*: (B, Q, Hl, Wl) f32 or bf16; cen_*: (B, Q, 2) f32 unscaled 1/8
    coords; cx*, cy*: (B, Q, 81) f32. Returns (own_A, cross_A, own_B,
    cross_B), each (B, Q, 81) f32.
    """
    delta = window_delta(RADIUS, cen_A.device)
    outs = []
    for own_vol, other_vol, cen, cx, cy in ((vol_A, vol_B, cen_A, cxA, cyA),
                                            (vol_B, vol_A, cen_B, cxB, cyB)):
        coords = (cen * scale).unsqueeze(2) + delta           # (B, Q, K, 2)
        outs.append(sample_volume_level(own_vol, coords).float())
        outs.append(sample_volume_level(other_vol,
                                        torch.stack([cx, cy], -1)).float())
    return tuple(outs)


def grid_window_coords(cen, grid, scale: float):
    """The cross tap coords of the plain lookup: ``cycle_bilinear_sample``
    of the (Hg, Wg, 2) grid at the window around ``cen * scale``.
    cen: (..., 2) f32 -> (cx, cy), each (..., 81) f32."""
    win = (cen * scale).unsqueeze(-2) + window_delta(RADIUS, cen.device)
    out = cycle_bilinear_sample(grid.unsqueeze(0), win.reshape(1, -1, 2))
    out = out.reshape(win.shape)
    return out[..., 0], out[..., 1]


def dccl_level_lookup_plain(vol_A, vol_B, cen_A, cen_B, grid_A, grid_B,
                            scale: float):
    """Plain version: the gathers of ``DCCL(lookup_mode='gather')``
    (``prior_flow_tpu/ops/corr.py:345-360``) for both branches.

    vol_*: (B, Q, Hl, Wl) f32 or bf16; cen_*: (B, Q, 2) f32 unscaled 1/8
    coords; grid_*: (Hg, Wg, 2) f32 world-to-camera grids (A->B for branch
    A). Returns (own_A, cross_A, own_B, cross_B), each (B, Q, 81) f32.
    """
    return dccl_level_lookup_coords_plain(
        vol_A, vol_B, cen_A, cen_B, scale,
        *grid_window_coords(cen_A, grid_A, scale),
        *grid_window_coords(cen_B, grid_B, scale))


def dccl_lookup_all_levels_plain(vols_A, vols_B, cen_A, cen_B, grid_A,
                                 grid_B, scales):
    """Plain version of the all-levels launch: one
    ``dccl_level_lookup_plain`` per level. vols_*: L volumes (B, Q, Hl, Wl);
    scales: L level scales. Returns L tuples (own_A, cross_A, own_B,
    cross_B)."""
    return tuple(dccl_level_lookup_plain(vA, vB, cen_A, cen_B, grid_A, grid_B,
                                         s)
                 for vA, vB, s in zip(vols_A, vols_B, scales))


def _check_level(name, vol_A, vol_B, cen_A, cen_B, more=()):
    """One pass over the inputs: device, no autograd, contiguity; then the
    volumes' dtype and shapes and the centres'."""
    dev = vol_A.get_device()     # an int: cheaper to compare than devices
    grad = torch.is_grad_enabled()
    for t in (vol_A, vol_B, cen_A, cen_B, *more):
        if t.get_device() != dev:
            raise ValueError(f"{name}: inputs on different devices")
        if grad and t.requires_grad:
            raise RuntimeError(f"{name}: the wrapper is forward-only; "
                               f"differentiate through its ops.corr Function")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if vol_A.dtype not in (torch.float32, torch.bfloat16) \
            or vol_B.dtype != vol_A.dtype:
        raise TypeError(f"volumes must both be float32 or bfloat16, got "
                        f"{vol_A.dtype} and {vol_B.dtype}")
    if vol_A.dim() != 4 or vol_B.shape != vol_A.shape:
        raise ValueError(f"volumes must be (B, Q, Hl, Wl) of one shape, got "
                         f"{tuple(vol_A.shape)} and {tuple(vol_B.shape)}")
    B, Q = vol_A.shape[:2]
    for c in (cen_A, cen_B):
        if c.shape != (B, Q, 2) or c.dtype != torch.float32:
            raise ValueError(f"centres must be ({B}, {Q}, 2) float32, got "
                             f"{tuple(c.shape)} {c.dtype}")


def _check_grids(grid_A, grid_B):
    if grid_A.dim() != 3 or grid_A.shape[-1] != 2 \
            or grid_B.shape != grid_A.shape:
        raise ValueError(f"grids must be (Hg, Wg, 2) of one shape, got "
                         f"{tuple(grid_A.shape)} and {tuple(grid_B.shape)}")
    if grid_A.dtype != torch.float32 or grid_B.dtype != torch.float32:
        raise TypeError("grids must be float32")


_p, _i, _f, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
ENTRIES = _build.Entries({
    "dccl_level_lookup": [_p, _p, _i, _p, _p, _p, _p, _p, _p, _p, _p, _ll, _i,
                          _i, _i, _i, _i, _i, _f, _p],
    "dccl_lookup_all_levels": [_i, _p, _p, _i, _p, _p, _p, _p, _p, _ll, _i,
                               _p, _p, _p, _i, _i, _p],
    "dccl_level_lookup_coords": [_p, _p, _i, _p, _p, _p, _p, _p, _p, _p, _p,
                                 _p, _p, _i, _i, _i, _f, _p],
})


def _device_or_plain(name, vol):
    """True when ``vol`` lies on the CPU (take the plain version); raises
    on a device with no kernel."""
    if vol.device.type == "cpu":
        return True
    if vol.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {vol.device}")
    return False


def _targets(out, B, Q, cols: int, device):
    """The four output arrays and their row stride: new (B, Q, 81) arrays
    when ``out`` is None, else ``out``, four (B, Q, C >= cols) f32 arrays of
    one row layout (unit column stride, C' >= C elements from row to
    row). New arrays are four allocations: the ``priorflow::`` ops return
    them, and a custom op's outputs may not share storage."""
    if out is None:
        return [torch.empty((B, Q, NTAP), dtype=torch.float32, device=device)
                for _ in range(4)], NTAP
    ld = out[0].stride(1)
    for o in out:
        if (o.device != device or o.dtype != torch.float32 or o.dim() != 3
                or tuple(o.shape[:2]) != (B, Q) or o.shape[2] < cols
                or o.stride(2) != 1 or o.stride(1) != ld
                or o.stride(0) != Q * ld):
            raise ValueError(f"out must be four ({B}, {Q}, >= {cols}) "
                             f"float32 arrays of one row layout on {device}")
    return list(out), ld


def _into(out, col, results):
    """Copies the plain version's results into columns col .. col + 80 of
    ``out`` and returns those columns."""
    views = tuple(o[..., col:col + NTAP] for o in out)
    for v, r in zip(views, results):
        v.copy_(r)
    return views


def dccl_level_lookup(vol_A, vol_B, cen_A, cen_B, grid_A, grid_B,
                      scale: float, out=None, col: int = 0):
    """Both branches' own and cross taps for one pyramid level; same
    arguments and results as ``dccl_level_lookup_plain``. With ``out``
    (four (B, Q, C) f32 arrays, see ``_targets``) the taps go into columns
    col .. col + 80 of each, on the card straight from the kernel, and the
    results are those columns."""
    if _device_or_plain("dccl_level_lookup", vol_A):
        res = dccl_level_lookup_plain(vol_A, vol_B, cen_A, cen_B, grid_A,
                                      grid_B, scale)
        return res if out is None else _into(out, col, res)
    _check_level("dccl_level_lookup", vol_A, vol_B, cen_A, cen_B,
                 (grid_A, grid_B))
    _check_grids(grid_A, grid_B)
    B, Q, Hl, Wl = vol_A.shape
    Hg, Wg, _ = grid_A.shape
    outs, ld = _targets(out, B, Q, col + NTAP, vol_A.device)
    ENTRIES.launch("dccl_level_lookup", vol_A.device,
                   vol_A.data_ptr(), vol_B.data_ptr(),
                   int(vol_A.dtype == torch.bfloat16),
                   cen_A.data_ptr(), cen_B.data_ptr(),
                   grid_A.data_ptr(), grid_B.data_ptr(),
                   *(o.data_ptr() for o in outs), ld, col,
                   B * Q, Hl, Wl, Hg, Wg, float(scale))
    dccl_level_lookup.launches += 1
    return tuple(outs) if out is None else tuple(
        o[..., col:col + NTAP] for o in outs)


dccl_level_lookup.launches = 0

MAX_LEVELS = 4   # the level descriptors the all-levels launch takes


def dccl_lookup_all_levels(vols_A, vols_B, cen_A, cen_B, grid_A, grid_B,
                           scales, out=None):
    """Every level's both-branch taps in one launch; same arguments and
    results as ``dccl_lookup_all_levels_plain``, bitwise equal to one
    ``dccl_level_lookup`` per level on the card. With ``out`` (four
    (B, Q, C >= 81 L) f32 arrays) level l's taps go into columns
    81 l .. 81 l + 80, and each level's results are those columns."""
    L = len(vols_A)
    if _device_or_plain("dccl_lookup_all_levels", vols_A[0]):
        res = dccl_lookup_all_levels_plain(vols_A, vols_B, cen_A, cen_B,
                                           grid_A, grid_B, scales)
        return res if out is None else tuple(
            _into(out, lvl * NTAP, r) for lvl, r in enumerate(res))
    if not 1 <= L <= MAX_LEVELS or len(vols_B) != L or len(scales) != L:
        raise ValueError(f"dccl_lookup_all_levels: 1 to {MAX_LEVELS} levels "
                         f"of volume pairs and scales, got {len(vols_A)}, "
                         f"{len(vols_B)} and {len(scales)}")
    for vA, vB in zip(vols_A, vols_B):
        _check_level("dccl_lookup_all_levels", vA, vB, cen_A, cen_B)
        if vA.dtype != vols_A[0].dtype:
            raise TypeError("dccl_lookup_all_levels: levels of mixed dtypes")
    _check_grids(grid_A, grid_B)
    if grid_A.device != cen_A.device or grid_B.device != cen_A.device \
            or not (grid_A.is_contiguous() and grid_B.is_contiguous()):
        raise ValueError("dccl_lookup_all_levels: grids must be contiguous, "
                         "on the centres' device")
    B, Q = cen_A.shape[:2]
    Hg, Wg, _ = grid_A.shape
    dev = cen_A.device
    if out is None:
        levels = [_targets(None, B, Q, NTAP, dev)[0] for _ in range(L)]
        ld = NTAP
    else:
        arrays, ld = _targets(out, B, Q, L * NTAP, dev)
        levels = [[o[..., lvl * NTAP:(lvl + 1) * NTAP] for o in arrays]
                  for lvl in range(L)]
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))
    ENTRIES.launch("dccl_lookup_all_levels", dev,
                   L, ptrs(vols_A), ptrs(vols_B),
                   int(vols_A[0].dtype == torch.bfloat16),
                   cen_A.data_ptr(), cen_B.data_ptr(),
                   grid_A.data_ptr(), grid_B.data_ptr(),
                   ptrs([o for lv in levels for o in lv]), ld, B * Q,
                   (ctypes.c_int * L)(*(v.shape[2] for v in vols_A)),
                   (ctypes.c_int * L)(*(v.shape[3] for v in vols_A)),
                   (ctypes.c_float * L)(*(float(s) for s in scales)),
                   Hg, Wg)
    dccl_lookup_all_levels.launches += 1
    return tuple(tuple(lv) for lv in levels)


dccl_lookup_all_levels.launches = 0


def dccl_level_lookup_coords(vol_A, vol_B, cen_A, cen_B, scale: float,
                             cxA, cyA, cxB, cyB):
    """Both branches' own taps and their cross taps at given coords for one
    level; same arguments and results as
    ``dccl_level_lookup_coords_plain``."""
    if _device_or_plain("dccl_level_lookup_coords", vol_A):
        return dccl_level_lookup_coords_plain(vol_A, vol_B, cen_A, cen_B,
                                              scale, cxA, cyA, cxB, cyB)
    coords = (cxA, cyA, cxB, cyB)
    _check_level("dccl_level_lookup_coords", vol_A, vol_B, cen_A, cen_B,
                 coords)
    B, Q, Hl, Wl = vol_A.shape
    for c in coords:
        if c.shape != (B, Q, NTAP) or c.dtype != torch.float32:
            raise ValueError(f"cross coords must be ({B}, {Q}, {NTAP}) "
                             f"float32, got {tuple(c.shape)} {c.dtype}")
    outs, _ = _targets(None, B, Q, NTAP, vol_A.device)
    ENTRIES.launch("dccl_level_lookup_coords", vol_A.device,
                   vol_A.data_ptr(), vol_B.data_ptr(),
                   int(vol_A.dtype == torch.bfloat16),
                   cen_A.data_ptr(), cen_B.data_ptr(),
                   *(c.data_ptr() for c in coords),
                   *(o.data_ptr() for o in outs),
                   B * Q, Hl, Wl, float(scale))
    dccl_level_lookup_coords.launches += 1
    return tuple(outs)


dccl_level_lookup_coords.launches = 0
