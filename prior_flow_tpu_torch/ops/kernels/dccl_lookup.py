"""DCCL level lookup for both branches: the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of ``prior_flow_tpu/ops/pallas/dccl_gather.py::
dccl_level_lookup_grid_fused`` (kernel ``_dccl_grid_kernel``); kernel
source ``prior_flow_tpu_torch/csrc/dccl_lookup.cu``. For one pyramid level,
each branch gets its own 9x9 window taps from its own volume, and cross
taps: the 1/8 rotation grid bilinearly sampled at the level-scaled window
coords, then used unscaled to sample the OTHER branch's volume.

A tensor on the CPU goes through the plain version; a CUDA tensor launches
the kernel or raises. The wrapper itself is forward-only; its gradient is
``ops/corr.py::DCCLLevelLookup``, whose backward runs the coords and
scatter kernels.
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


def dccl_level_lookup_plain(vol_A, vol_B, cen_A, cen_B, grid_A, grid_B,
                            scale: float):
    """Plain version: the gathers of ``DCCL(lookup_mode='gather')``
    (``prior_flow_tpu/ops/corr.py:345-360``) for both branches.

    vol_*: (B, Q, Hl, Wl) f32 or bf16; cen_*: (B, Q, 2) f32 unscaled 1/8
    coords; grid_*: (Hg, Wg, 2) f32 world-to-camera grids (A->B for branch
    A). Returns (own_A, cross_A, own_B, cross_B), each (B, Q, 81) f32.
    """
    B, Q = cen_A.shape[:2]
    delta = window_delta(RADIUS, cen_A.device)
    outs = []
    for own_vol, other_vol, cen, grid in ((vol_A, vol_B, cen_A, grid_A),
                                          (vol_B, vol_A, cen_B, grid_B)):
        coords = (cen * scale).unsqueeze(2) + delta           # (B, Q, K, 2)
        outs.append(sample_volume_level(own_vol, coords).float())
        coords_other = cycle_bilinear_sample(
            grid.unsqueeze(0), coords.reshape(1, -1, 2)).reshape(B, Q, NTAP, 2)
        outs.append(sample_volume_level(other_vol, coords_other).float())
    return tuple(outs)


def _check_inputs(vol_A, vol_B, cen_A, cen_B, grid_A, grid_B):
    tensors = (vol_A, vol_B, cen_A, cen_B, grid_A, grid_B)
    dev = vol_A.device
    if any(t.device != dev for t in tensors):
        raise ValueError("dccl_level_lookup: inputs on different devices")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("dccl_level_lookup: the wrapper is forward-only; "
                           "differentiate through ops.corr.DCCLLevelLookup")
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
    if grid_A.dim() != 3 or grid_A.shape[-1] != 2 \
            or grid_B.shape != grid_A.shape:
        raise ValueError(f"grids must be (Hg, Wg, 2) of one shape, got "
                         f"{tuple(grid_A.shape)} and {tuple(grid_B.shape)}")
    if grid_A.dtype != torch.float32 or grid_B.dtype != torch.float32:
        raise TypeError("grids must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dccl_level_lookup: inputs must be contiguous")


def _kernel():
    fn = _build.load_library().lib.dccl_level_lookup
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, p, p, p, p, p, p, p, i, i, i, i, i,
                   ctypes.c_float, p]
    fn.restype = i
    return fn


def dccl_level_lookup(vol_A, vol_B, cen_A, cen_B, grid_A, grid_B,
                      scale: float):
    """Both branches' own and cross taps for one pyramid level; same
    arguments and results as ``dccl_level_lookup_plain``."""
    if vol_A.device.type == "cpu":
        return dccl_level_lookup_plain(vol_A, vol_B, cen_A, cen_B,
                                       grid_A, grid_B, scale)
    if vol_A.device.type != "cuda":
        raise RuntimeError(f"dccl_level_lookup: no kernel for device "
                           f"{vol_A.device}")
    _check_inputs(vol_A, vol_B, cen_A, cen_B, grid_A, grid_B)
    B, Q, Hl, Wl = vol_A.shape
    Hg, Wg, _ = grid_A.shape
    outs = [torch.empty((B, Q, NTAP), dtype=torch.float32, device=vol_A.device)
            for _ in range(4)]
    with torch.cuda.device(vol_A.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _kernel()(
            vol_A.data_ptr(), vol_B.data_ptr(),
            int(vol_A.dtype == torch.bfloat16),
            cen_A.data_ptr(), cen_B.data_ptr(),
            grid_A.data_ptr(), grid_B.data_ptr(),
            *(o.data_ptr() for o in outs),
            B * Q, Hl, Wl, Hg, Wg, float(scale), stream)
    _build.check(status, "dccl_level_lookup")
    dccl_level_lookup.launches += 1
    return tuple(outs)


dccl_level_lookup.launches = 0
