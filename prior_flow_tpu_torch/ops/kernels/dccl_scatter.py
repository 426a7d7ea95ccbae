"""DCCL volume scatter: the transpose of the level lookup for one volume,
summed over S stacked iterations. The CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of the one-hot einsum backward of
``prior_flow_tpu/ops/pallas/dccl_gather.py``: ``_scatter_own_cross`` (S = 1,
the lookup's VJP) and ``_scatter_grads_window_multi`` +
``_scatter_grads_multi`` (S = iters, the taped backward). Kernel source
``prior_flow_tpu_torch/csrc/dccl_scatter.cu``: f32 atomics into a zeroed
f32 buffer, cast once to the volume's dtype.

Every corner rule is the exact transpose of the port's own sampler, so the
result equals ``torch.autograd`` of ``dccl_level_lookup_plain``. One rule
differs from the JAX backward: an x that wraps to exactly W contributes
zero here (the port's forward samples zero there), where ``_one_hot_pair``
clips it to column W-1 (ROADMAP Queue 3).

A tensor on the CPU goes through the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dccl_lookup import NTAP, RADIUS, window_delta


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


def _kernel():
    fn = _build.load_library().lib.dccl_level_scatter
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, p, p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(g_own, cen, g_cross, cx, cy, dtype):
    tensors = (g_own, cen, g_cross, cx, cy)
    if any(t.device != g_own.device for t in tensors):
        raise ValueError("dccl_level_scatter: inputs on different devices")
    if g_own.dim() != 4 or g_own.shape[-1] != NTAP:
        raise ValueError(f"tap cotangents must be (S, B, Q, {NTAP}), got "
                         f"{tuple(g_own.shape)}")
    for t in (g_cross, cx, cy):
        if t.shape != g_own.shape:
            raise ValueError(f"g_cross, cx and cy must match g_own "
                             f"{tuple(g_own.shape)}, got {tuple(t.shape)}")
    if cen.shape != g_own.shape[:3] + (2,):
        raise ValueError(f"centres must be {tuple(g_own.shape[:3]) + (2,)}, "
                         f"got {tuple(cen.shape)}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("dccl_level_scatter: inputs must be float32")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"output dtype must be float32 or bfloat16, got "
                        f"{dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dccl_level_scatter: inputs must be contiguous")


def dccl_level_scatter(g_own, cen, scale: float, g_cross, cx, cy,
                       Hl: int, Wl: int, dtype=torch.float32):
    """One volume's cotangent at one level, summed over S iterations; same
    arguments and result as ``dccl_level_scatter_plain``."""
    dev = g_own.device
    if dev.type == "cpu":
        return dccl_level_scatter_plain(g_own, cen, scale, g_cross, cx, cy,
                                        Hl, Wl, dtype)
    if dev.type != "cuda":
        raise RuntimeError(f"dccl_level_scatter: no kernel for device {dev}")
    _check_inputs(g_own, cen, g_cross, cx, cy, dtype)
    S, B, Q, _ = g_own.shape
    dv = torch.zeros((B, Q, Hl, Wl), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = _kernel()(g_own.data_ptr(), g_cross.data_ptr(),
                           cen.data_ptr(), cx.data_ptr(), cy.data_ptr(),
                           dv.data_ptr(), S, B * Q, Hl, Wl, float(scale),
                           stream)
    _build.check(status, "dccl_level_scatter")
    dccl_level_scatter.launches += 1
    return dv if dtype == torch.float32 else dv.to(dtype)


dccl_level_scatter.launches = 0
