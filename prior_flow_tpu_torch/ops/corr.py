"""All-pairs correlation volumes, pyramids, flaw maps and the DCCL
(Dual-Cost Collaborative Lookup); counterpart of
``prior_flow_tpu/ops/corr.py``.

Parity quirks kept from the reference (``prior_flow_tpu/ops/corr.py:14-26``):
- tap k = i*9 + j has x-offset i-4 and y-offset j-4;
- cross coords are sampled from the 1/8 grid at level-scaled centres and are
  not rescaled for levels above 0;
- the cross grid is sampled with the plain wrap-x sampler, without the
  coordinate-payload seam fix.

Layouts are the JAX package's: feature maps (B, H, W, C), volumes
(B, Q, H2, W2) with Q = H1*W1, lookups (B, H1, W1, L*81) channels-last.

Gradients reach the volumes only: the lookup coords are detached every
iteration (``prior_flow_tpu/models/prior_raft.py:215,220``).
``DCCLLevelLookup`` is the lookup's differentiable form (the custom VJP of
``dccl_packed_lookup_grid``); ``DCCLFused.record`` serves the taped
backward, which scatters all iterations at once.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .kernels.dccl_coords import dccl_grid_coords
from .kernels.dccl_lookup import (RADIUS, dccl_level_lookup,
                                  dccl_level_lookup_plain, window_delta)
from .kernels.dccl_scatter import dccl_level_scatter
from .static_resample import resample_static

__all__ = ["all_pairs_correlation", "avg_pool2", "build_pyramid",
           "groupwise_corr", "DCCLFused", "DCCLLevelLookup", "window_delta",
           "dccl_level_lookup", "dccl_level_lookup_plain"]


def all_pairs_correlation(fmap1: torch.Tensor, fmap2: torch.Tensor):
    """(B, H, W, C) x2 -> (B, H*W, H, W) f32 cost volume scaled by 1/sqrt(C)
    (``prior_flow_tpu/ops/corr.py:46``). A plain f32 matmul, as the JAX
    package leaves it to XLA."""
    B, H, W, C = fmap1.shape
    a = fmap1.reshape(B, H * W, C).float()
    b = fmap2.reshape(B, H * W, C).float()
    vol = torch.matmul(a, b.transpose(1, 2))
    return vol.reshape(B, H * W, H, W) / math.sqrt(C)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 mean over the last two axes of (B, Q, H, W); odd
    trailing rows/columns are dropped (avg_pool2d floor behaviour)."""
    B, Q, H, W = x.shape
    x = x[:, :, :H // 2 * 2, :W // 2 * 2]
    return x.reshape(B, Q, H // 2, 2, W // 2, 2).mean(dim=(3, 5))


def build_pyramid(volume: torch.Tensor, num_levels: int = 4):
    """Average-pooled correlation pyramid over the target axes."""
    pyr = [volume]
    for _ in range(num_levels - 1):
        pyr.append(avg_pool2(pyr[-1]))
    return pyr


def groupwise_corr(fea1: torch.Tensor, fea2: torch.Tensor, num_groups: int):
    """Per-group mean of elementwise products, the "flaw" map
    (``prior_flow_tpu/ops/corr.py:723``): (B, H, W, C) -> (B, H, W, G)."""
    B, H, W, C = fea1.shape
    if C % num_groups:
        raise ValueError(f"{C} channels do not split into {num_groups} groups")
    return (fea1 * fea2).reshape(B, H, W, num_groups,
                                 C // num_groups).mean(dim=-1)


class DCCLLevelLookup(torch.autograd.Function):
    """One level's both-branch lookup with its VJP (counterpart of
    ``dccl_packed_lookup_grid``'s custom VJP,
    ``prior_flow_tpu/ops/pallas/dccl_gather.py:841-891``).

    Forward: ``dccl_level_lookup`` (the CUDA kernel on the card). Backward:
    each branch's cross tap coords recomputed from the saved centres
    (``dccl_grid_coords``), then one scatter per volume with S = 1: volume A
    takes branch A's own taps and branch B's cross taps, volume B the
    converse (``:882-887``). The centres and grids get no gradient.
    """

    @staticmethod
    def forward(ctx, vol_A, vol_B, cen_A, cen_B, grid_A, grid_B,
                scale: float):
        outs = dccl_level_lookup(vol_A, vol_B, cen_A, cen_B, grid_A, grid_B,
                                 scale)
        ctx.save_for_backward(cen_A, cen_B, grid_A, grid_B)
        ctx.scale = scale
        ctx.vol = (vol_A.shape, vol_A.dtype)
        return outs

    @staticmethod
    def backward(ctx, g_ownA, g_crossA, g_ownB, g_crossB):
        cen_A, cen_B, grid_A, grid_B = ctx.saved_tensors
        (B, Q, Hl, Wl), dtype = ctx.vol
        s = ctx.scale
        one = lambda t: t.contiguous().reshape(1, B, Q, -1)
        cxA, cyA = dccl_grid_coords(cen_A.reshape(B * Q, 2), grid_A, s)
        cxB, cyB = dccl_grid_coords(cen_B.reshape(B * Q, 2), grid_B, s)
        d_A = dccl_level_scatter(one(g_ownA), one(cen_A), s, one(g_crossB),
                                 one(cxB), one(cyB), Hl, Wl, dtype)
        d_B = dccl_level_scatter(one(g_ownB), one(cen_B), s, one(g_crossA),
                                 one(cxA), one(cyA), Hl, Wl, dtype)
        return d_A, d_B, None, None, None, None, None


class DCCLFused:
    """Both branches' DCCL, one level lookup per pyramid level
    (``prior_flow_tpu/ops/corr.py:373``).

    ``level_lookup`` is ``DCCLLevelLookup.apply`` (the CUDA kernels for
    CUDA tensors, the plain versions on the CPU, with the volumes'
    gradient) or ``dccl_level_lookup_plain`` (the plain gathers on any
    device, differentiated by autograd: the kernels' reference).
    """

    def __init__(self, num_levels: int = 4, radius: int = RADIUS,
                 level_lookup=DCCLLevelLookup.apply):
        if radius != RADIUS:
            raise ValueError(f"the lookup is built for radius {RADIUS}")
        self.num_levels = num_levels
        self.level_lookup = level_lookup

    def __call__(self, coords_A, coords_B, pyr_A: Sequence, pyr_B: Sequence,
                 a2b_w2c_8, b2a_w2c_8, a2b_8, b2a_8):
        """coords_*: (B, h1, w1, 2) current 1/8 coords; pyr_*: per-level
        (B, Q, Hl, Wl) volumes; grids: (h8, w8, 2) f32 tensors.
        Returns (own_A, cross_A, own_B, cross_B), each (B, h1, w1, L*81)
        f32, cross fields rotated back into their query frames."""
        B, h1, w1, _ = coords_A.shape
        Q = h1 * w1
        cqA = coords_A.reshape(B, Q, 2).float().contiguous()
        cqB = coords_B.reshape(B, Q, 2).float().contiguous()
        levels = [self.level_lookup(pyr_A[i], pyr_B[i], cqA, cqB,
                                    a2b_w2c_8, b2a_w2c_8, 1.0 / 2.0 ** i)
                  for i in range(self.num_levels)]
        return self._finish(levels, B, h1, w1, a2b_8, b2a_8)

    @torch.no_grad()
    def record(self, coords_A, coords_B, pyr_A: Sequence, pyr_B: Sequence,
               a2b_w2c_8, b2a_w2c_8, a2b_8, b2a_8):
        """Primal-only lookup for the taped backward
        (``prior_flow_tpu/ops/corr.py:516-570``): returns
        ``((corr_A, corr_B), (cen_A, cen_B))`` with corr_* the summed own +
        back-rotated cross fields (B, h1, w1, L*81) f32 that the update
        blocks read, and cen_* the unscaled centres (B, Q, 2) from which the
        backward recomputes the cross tap coords."""
        own_A, cross_A, own_B, cross_B = self(
            coords_A, coords_B, pyr_A, pyr_B, a2b_w2c_8, b2a_w2c_8, a2b_8,
            b2a_8)
        B, h1, w1, _ = coords_A.shape
        cen = [c.reshape(B, h1 * w1, 2).float().contiguous()
               for c in (coords_A, coords_B)]
        return (own_A + cross_A, own_B + cross_B), tuple(cen)

    @staticmethod
    def _finish(levels, B, h1, w1, a2b_8, b2a_8):
        """Concatenate the levels and rotate each branch's cross field back
        with ONE resample over the level-concatenated channels
        (``prior_flow_tpu/ops/corr.py:572-587``; resampling is channelwise,
        so rotate-then-concat equals concat-then-rotate)."""
        def cat(j):
            return torch.cat([lv[j].reshape(B, h1, w1, -1) for lv in levels],
                             dim=-1)

        cross_A = resample_static(cat(1), b2a_8)
        cross_B = resample_static(cat(3), a2b_8)
        return cat(0), cross_A, cat(2), cross_B
