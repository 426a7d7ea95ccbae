"""DCCL volume scatter: the transpose of the level lookup for one volume,
summed over S stacked iterations. The CUDA kernel's two entries' wrappers
and their plain PyTorch versions.

Counterpart of the one-hot einsum backward of
``prior_flow_tpu/ops/pallas/dccl_gather.py``: ``_scatter_own_cross`` (S = 1,
the lookup's VJP) and ``_scatter_grads_window_multi`` +
``_scatter_grads_multi`` (S = iters, the taped backward). Kernel source
``prior_flow_tpu_torch/csrc/dccl_scatter.cu``: one block per query plane,
summed in shared memory and written once in the volume's dtype.

- ``dccl_level_scatter_grid``: the cross taps' coords are the other
  branch's grid window (``grid_window_coords``), computed in the kernel;
  the backward of the grid route and of the taped step.
- ``dccl_level_scatter``: the cross taps at given coords; the backward of
  the planes route.

The cotangents may be a level's column slice of (S, B, Q, L*81) arrays:
the kernel reads them at their row stride. Every corner rule is the exact
transpose of the port's own sampler, so the result equals
``torch.autograd`` of ``dccl_level_lookup_plain``. One rule differs from the
JAX backward: an x that wraps to exactly W contributes zero here (the
port's forward samples zero there), where ``_one_hot_pair`` clips it to
column W-1 (ROADMAP Queue 3).

A tensor on the CPU goes through the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dccl_lookup import (NTAP, RADIUS, _device_or_plain, grid_window_coords,
                          window_delta)


def _corners(x, y, H: int, W: int):
    """The sampler's four corners at (x, y): (flat in-plane index, weight)
    pairs in the order (dy, dx) = 00, 01, 10, 11. Invalid corners get
    weight 0 at a clamped index, as the plain sampler's gathers do."""
    x = torch.remainder(x, W)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    for dy in (0, 1):
        for dx in (0, 1):
            cx = x0 + dx
            cy = y0 + dy
            wgt = (fx if dx else (1.0 - fx)) * (fy if dy else (1.0 - fy))
            valid = (cx >= 0) & (cx <= W - 1) & (cy >= 0) & (cy <= H - 1)
            ix = torch.clamp(cx, 0, max(W - 1, 0)).long()
            iy = torch.clamp(cy, 0, max(H - 1, 0)).long()
            yield iy * W + ix, wgt * valid


def dccl_level_scatter_plain(g_own, cen, scale: float, g_cross, cx, cy,
                             Hl: int, Wl: int, dtype=torch.float32):
    """One volume's cotangent at one level, summed over S iterations.

    g_own, g_cross, cx, cy: (S, B, Q, 81) f32; cen: (S, B, Q, 2) f32
    unscaled centres. Own taps sit at ``cen*scale + window``; cross taps
    (the OTHER branch's, which sampled this volume) at (cx, cy). Returns
    (B, Q, Hl, Wl) in ``dtype``, accumulated in f32 by ``index_add_`` and
    cast once.
    """
    S, B, Q, _ = g_own.shape
    if Hl * Wl == 0:
        return torch.zeros((B, Q, Hl, Wl), dtype=dtype, device=cen.device)
    own = (cen * scale).unsqueeze(-2) + window_delta(RADIUS, cen.device)
    base = (torch.arange(B * Q, device=cen.device) * (Hl * Wl)).reshape(
        1, B, Q, 1)
    out = torch.zeros(B * Q * Hl * Wl, dtype=torch.float32, device=cen.device)
    for g, x, y in ((g_own, own[..., 0], own[..., 1]), (g_cross, cx, cy)):
        for idx, w in _corners(x, y, Hl, Wl):
            out.index_add_(0, (base + idx).reshape(-1),
                           (g.float() * w).reshape(-1))
    return out.reshape(B, Q, Hl, Wl).to(dtype)


def dccl_level_scatter_grid_plain(g_own, cen, g_cross, cen_other, grid,
                                  scale: float, Hl: int, Wl: int,
                                  dtype=torch.float32):
    """The grid entry's plain version: the other branch's cross tap coords
    (``grid_window_coords`` of ``grid`` at ``cen_other``), then
    ``dccl_level_scatter_plain``. cen_other: (S, B, Q, 2) f32; grid:
    (Hg, Wg, 2) f32; the rest as ``dccl_level_scatter_plain``."""
    cx, cy = grid_window_coords(cen_other, grid, scale)
    return dccl_level_scatter_plain(g_own, cen, scale, g_cross, cx, cy, Hl,
                                    Wl, dtype)


_p, _i, _f, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
ENTRIES = _build.Entries({
    "dccl_level_scatter_grid": [_p, _ll, _p, _p, _ll, _p, _p, _i, _i, _p, _i,
                                _i, _ll, _i, _i, _f, _p],
    "dccl_level_scatter": [_p, _ll, _p, _p, _ll, _p, _p, _p, _i, _i, _ll, _i,
                           _i, _f, _p],
})


def _row_stride(name, t, shape) -> int:
    """The row stride of an (S, B, Q, 81) f32 array read as S*B*Q rows: a
    level's column slice of (S, B, Q, C) arrays, or a contiguous array."""
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {tuple(shape)} float32, got "
                         f"{tuple(t.shape)} {t.dtype}")
    S, B, Q, _ = shape
    ld = t.stride(2)
    if t.stride(3) != 1 or t.stride(1) != Q * ld or t.stride(0) != B * Q * ld \
            or ld < NTAP:
        raise ValueError(f"{name}: rows must have unit column stride and one "
                         f"row stride, got strides {t.stride()}")
    return ld


def _check_inputs(name, g_own, g_cross, centres, others, dtype):
    """Devices, shapes and layouts in one pass; returns the cotangents' row
    strides."""
    dev = g_own.device
    if g_own.dim() != 4 or g_own.shape[-1] != NTAP:
        raise ValueError(f"tap cotangents must be (S, B, Q, {NTAP}), got "
                         f"{tuple(g_own.shape)}")
    cen_shape = tuple(g_own.shape[:3]) + (2,)
    for t in (g_cross, *centres, *others):
        if t.device != dev:
            raise ValueError(f"{name}: inputs on different devices")
    for t in centres:
        if tuple(t.shape) != cen_shape or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: centres must be contiguous {cen_shape} "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"output dtype must be float32 or bfloat16, got "
                        f"{dtype}")
    return (_row_stride(name, g_own, g_own.shape),
            _row_stride(name, g_cross, g_own.shape))


def dccl_level_scatter_grid(g_own, cen, g_cross, cen_other, grid,
                            scale: float, Hl: int, Wl: int,
                            dtype=torch.float32):
    """One volume's cotangent at one level, summed over S iterations, the
    cross taps' coords computed from ``grid`` at ``cen_other``; same
    arguments and result as ``dccl_level_scatter_grid_plain``."""
    dev = g_own.device
    if _device_or_plain("dccl_level_scatter_grid", g_own):
        return dccl_level_scatter_grid_plain(g_own, cen, g_cross, cen_other,
                                             grid, scale, Hl, Wl, dtype)
    ld_own, ld_cross = _check_inputs("dccl_level_scatter_grid", g_own,
                                     g_cross, (cen, cen_other), (grid,),
                                     dtype)
    if grid.dim() != 3 or grid.shape[2] != 2 or grid.dtype != torch.float32 \
            or not grid.is_contiguous():
        raise ValueError(f"grid must be contiguous (Hg, Wg, 2) float32, got "
                         f"{tuple(grid.shape)} {grid.dtype}")
    S, B, Q, _ = g_own.shape
    dv = torch.empty((B, Q, Hl, Wl), dtype=dtype, device=dev)
    ENTRIES.launch("dccl_level_scatter_grid", dev,
                   g_own.data_ptr(), ld_own, cen.data_ptr(),
                   g_cross.data_ptr(), ld_cross, cen_other.data_ptr(),
                   grid.data_ptr(), grid.shape[0], grid.shape[1],
                   dv.data_ptr(), int(dtype == torch.bfloat16), S, B * Q, Hl,
                   Wl, float(scale))
    dccl_level_scatter_grid.launches += 1
    return dv


dccl_level_scatter_grid.launches = 0


def dccl_level_scatter(g_own, cen, scale: float, g_cross, cx, cy,
                       Hl: int, Wl: int, dtype=torch.float32):
    """One volume's cotangent at one level, summed over S iterations, the
    cross taps at given coords (contiguous); same arguments and result as
    ``dccl_level_scatter_plain``."""
    dev = g_own.device
    if _device_or_plain("dccl_level_scatter", g_own):
        return dccl_level_scatter_plain(g_own, cen, scale, g_cross, cx, cy,
                                        Hl, Wl, dtype)
    ld_own, ld_cross = _check_inputs("dccl_level_scatter", g_own, g_cross,
                                     (cen,), (cx, cy), dtype)
    for c in (cx, cy):
        if c.shape != g_own.shape or c.dtype != torch.float32 \
                or not c.is_contiguous():
            raise ValueError(f"cx and cy must be contiguous "
                             f"{tuple(g_own.shape)} float32, got "
                             f"{tuple(c.shape)} {c.dtype}")
    S, B, Q, _ = g_own.shape
    dv = torch.empty((B, Q, Hl, Wl), dtype=dtype, device=dev)
    ENTRIES.launch("dccl_level_scatter", dev,
                   g_own.data_ptr(), ld_own, cen.data_ptr(),
                   g_cross.data_ptr(), ld_cross, cx.data_ptr(), cy.data_ptr(),
                   dv.data_ptr(), int(dtype == torch.bfloat16), S, B * Q, Hl,
                   Wl, float(scale))
    dccl_level_scatter.launches += 1
    return dv


dccl_level_scatter.launches = 0
