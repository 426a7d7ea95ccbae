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
iteration (``prior_flow_tpu/models/prior_raft.py:215,220``). The lookups'
differentiable forms are ``DCCLLevelLookup`` (the custom VJP of
``dccl_packed_lookup_grid``), ``DCCLLevelLookupCoords`` (of
``dccl_packed_lookup_planes``) and ``DCCLAllLevelsLookup`` (of
``dccl_packed_lookup_grid_all``); ``DCCLFused.record`` serves the taped
backward, which scatters all iterations at once.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import torch

from .kernels.dccl_coords import dccl_grid_coords
from .kernels.dccl_lookup import (NTAP, RADIUS, dccl_level_lookup,
                                  dccl_level_lookup_coords,
                                  dccl_level_lookup_plain,
                                  dccl_lookup_all_levels, window_delta)
from .kernels.dccl_scatter import dccl_level_scatter
from .static_resample import resample_static

__all__ = ["all_pairs_correlation", "avg_pool2", "build_pyramid",
           "build_pyramid_lean", "groupwise_corr", "DCCLFused",
           "DCCLLevelLookup", "DCCLLevelLookupCoords", "DCCLAllLevelsLookup",
           "window_delta", "dccl_level_lookup", "dccl_level_lookup_plain"]


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


def build_pyramid_lean(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4, dtype=torch.bfloat16,
                       q_chunk: int = 4096):
    """``build_pyramid(all_pairs_correlation(f1, f2))`` cast to ``dtype``,
    built in query chunks so that the whole f32 volume never exists
    (``prior_flow_tpu/ops/corr.py:83-123``).

    Per chunk: one f32 matmul of the chunk's queries against all of fmap2,
    scaled by 1/sqrt(C), then every level pooled in f32 (pooling runs over
    the target axes only, so it commutes with chunking the queries), cast
    and written into the preallocated ``dtype`` levels. Peak extra memory
    is one chunk's f32 pyramid: 0.71 GB at 1024x2048 (Q = 32768) and
    q_chunk 4096, where the dense build holds a 4.3 GB level-0 volume and a
    5.7 GB f32 pyramid per branch. Differentiable when autograd records
    (the chunks are written by slice assignment).
    """
    B, H, W, C = fmap1.shape
    Q = H * W
    a = fmap1.reshape(B, Q, C).float()
    b = fmap2.reshape(B, Q, C).float().transpose(1, 2)
    q_chunk = min(q_chunk, Q)
    assert Q % q_chunk == 0, (Q, q_chunk)
    levels = [torch.empty((B, Q, H >> i, W >> i), dtype=dtype,
                          device=fmap1.device) for i in range(num_levels)]
    for q0 in range(0, Q, q_chunk):
        vol = torch.matmul(a[:, q0:q0 + q_chunk], b).reshape(
            B, q_chunk, H, W) / math.sqrt(C)
        for i in range(num_levels):
            levels[i][:, q0:q0 + q_chunk] = vol
            if i + 1 < num_levels:
                vol = avg_pool2(vol)
    return levels


def groupwise_corr(fea1: torch.Tensor, fea2: torch.Tensor, num_groups: int):
    """Per-group mean of elementwise products, the "flaw" map
    (``prior_flow_tpu/ops/corr.py:723``): (B, H, W, C) -> (B, H, W, G)."""
    B, H, W, C = fea1.shape
    if C % num_groups:
        raise ValueError(f"{C} channels do not split into {num_groups} groups")
    return (fea1 * fea2).reshape(B, H, W, num_groups,
                                 C // num_groups).mean(dim=-1)


def _scatter_both(g_ownA, g_crossA, g_ownB, g_crossB, cen_A, cen_B, scale,
                  cxA, cyA, cxB, cyB, vol_shape, dtype):
    """The lookup's transpose at one level: one scatter per volume with
    S = 1. Volume A takes branch A's own taps and branch B's cross taps,
    volume B the converse (``dccl_gather.py:882-887``)."""
    B, Q, Hl, Wl = vol_shape
    one = lambda t: t.contiguous().reshape(1, B, Q, -1)
    d_A = dccl_level_scatter(one(g_ownA), one(cen_A), scale, one(g_crossB),
                             one(cxB), one(cyB), Hl, Wl, dtype)
    d_B = dccl_level_scatter(one(g_ownB), one(cen_B), scale, one(g_crossA),
                             one(cxA), one(cyA), Hl, Wl, dtype)
    return d_A, d_B


def _grid_level_backward(grads, cen_A, cen_B, grid_A, grid_B, scale,
                         vol_shape, dtype):
    """Backward of one level of the grid route: each branch's cross tap
    coords recomputed from the saved centres (``dccl_grid_coords``), then
    the two scatters."""
    BQ = vol_shape[0] * vol_shape[1]
    cxA, cyA = dccl_grid_coords(cen_A.reshape(BQ, 2), grid_A, scale)
    cxB, cyB = dccl_grid_coords(cen_B.reshape(BQ, 2), grid_B, scale)
    return _scatter_both(*grads, cen_A, cen_B, scale, cxA, cyA, cxB, cyB,
                         vol_shape, dtype)


class DCCLLevelLookup(torch.autograd.Function):
    """One level's both-branch lookup with its VJP (counterpart of
    ``dccl_packed_lookup_grid``'s custom VJP,
    ``prior_flow_tpu/ops/pallas/dccl_gather.py:841-891``).

    Forward: ``dccl_level_lookup`` (the CUDA kernel on the card). Backward:
    each branch's cross tap coords recomputed from the saved centres
    (``dccl_grid_coords``), then one scatter per volume with S = 1. The
    centres and grids get no gradient.
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
    def backward(ctx, *grads):
        d_A, d_B = _grid_level_backward(grads, *ctx.saved_tensors, ctx.scale,
                                        *ctx.vol)
        return d_A, d_B, None, None, None, None, None


class DCCLLevelLookupCoords(torch.autograd.Function):
    """One level's both-branch lookup at given cross tap coords, with its
    VJP (counterpart of ``dccl_packed_lookup_planes``' custom VJP,
    ``dccl_gather.py:783-821``).

    Forward: ``dccl_level_lookup_coords`` (the CUDA kernel on the card).
    Backward: one scatter per volume with S = 1 at the SAVED given coords,
    nothing recomputed. The centres and coords get no gradient.
    """

    @staticmethod
    def forward(ctx, vol_A, vol_B, cen_A, cen_B, scale: float, cxA, cyA, cxB,
                cyB):
        outs = dccl_level_lookup_coords(vol_A, vol_B, cen_A, cen_B, scale,
                                        cxA, cyA, cxB, cyB)
        ctx.save_for_backward(cen_A, cen_B, cxA, cyA, cxB, cyB)
        ctx.scale = scale
        ctx.vol = (vol_A.shape, vol_A.dtype)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        cen_A, cen_B, cxA, cyA, cxB, cyB = ctx.saved_tensors
        d_A, d_B = _scatter_both(*grads, cen_A, cen_B, ctx.scale, cxA, cyA,
                                 cxB, cyB, *ctx.vol)
        return d_A, d_B, None, None, None, None, None, None, None


class DCCLAllLevelsLookup(torch.autograd.Function):
    """Every level's both-branch lookup in one launch, with its VJP
    (counterpart of ``dccl_packed_lookup_grid_all``' custom VJP,
    ``dccl_gather.py:945-1003``).

    ``apply(cen_A, cen_B, grid_A, grid_B, scales, *vols)`` with ``vols`` =
    (A_0, B_0, A_1, B_1, ...) returns the 4L outputs (own_A, cross_A,
    own_B, cross_B) level after level. Forward: ``dccl_lookup_all_levels``
    (one CUDA launch on the card). Backward: per level, the backward of
    ``DCCLLevelLookup`` (``_packed_grid_all_bwd``, ``:984-999``).
    """

    @staticmethod
    def forward(ctx, cen_A, cen_B, grid_A, grid_B, scales, *vols):
        outs = dccl_lookup_all_levels(vols[0::2], vols[1::2], cen_A, cen_B,
                                      grid_A, grid_B, scales)
        ctx.save_for_backward(cen_A, cen_B, grid_A, grid_B)
        ctx.scales = tuple(scales)
        ctx.vols = [(v.shape, v.dtype) for v in vols[0::2]]
        return tuple(o for level in outs for o in level)

    @staticmethod
    def backward(ctx, *grads):
        d = []
        for lvl, (s, vol) in enumerate(zip(ctx.scales, ctx.vols)):
            d += _grid_level_backward(grads[4 * lvl:4 * lvl + 4],
                                      *ctx.saved_tensors, s, *vol)
        return (None,) * 5 + tuple(d)


# the JAX package samples the cross tap coords inside the lookup kernel only
# for 1/8 grids up to this wide (one TPU lane row, ``ops/corr.py:440``) and
# takes the planes route above it; the port keeps that routing, not a limit
# of its own kernels, which take any grid width
GRID_IN_KERNEL_MAX_WIDTH = 128


def cross_coords_all_levels(cen, grid, scales):
    """One branch's cross tap coords at every level in one
    ``dccl_grid_coords`` launch: the centres (B, Q, 2), pre-scaled per level
    and stacked on the query axis, at scale 1.0. Returns (cx, cy), each
    (L*B*Q, 81) f32, level after level. Scaling by a power of two is exact,
    so these are the coords the grid route's kernel computes; they stand in
    for the JAX package's ``sample_image_window_planes`` einsums
    (``ops/corr.py:452-461``), the same function up to f32 rounding."""
    flat = cen.reshape(-1, 2)
    return dccl_grid_coords(torch.cat([flat * s for s in scales]), grid, 1.0)


class DCCLFused:
    """Both branches' DCCL over all pyramid levels
    (``prior_flow_tpu/ops/corr.py:373``), by one of three routes, chosen as
    in the JAX package:

    - the grid route (the default): one ``level_lookup`` per level, the
      cross tap coords computed inside the kernel;
    - the all-levels grid route (``fuse_levels``): one
      ``DCCLAllLevelsLookup`` launch for every level;
    - the planes route (``grid_in_kernel=False``, or a 1/8 grid wider than
      128 columns, as at 1024x2048): both branches' cross tap coords for
      all levels first, one ``dccl_grid_coords`` launch per branch with
      the level-scaled centres stacked on the query axis, then one
      ``DCCLLevelLookupCoords`` per level (``ops/corr.py:445-464,
      503-507``). ``fuse_levels`` has no effect here.

    The three give the same bits: scaling a centre by a power of two is
    exact, so the planes route's coords are the ones the grid route's
    kernel computes. ``level_lookup`` (the grid route only) is
    ``DCCLLevelLookup.apply`` (the CUDA kernels for CUDA tensors, the plain
    versions on the CPU, with the volumes' gradient) or
    ``dccl_level_lookup_plain`` (the plain gathers on any device,
    differentiated by autograd: the kernels' reference). ``fuse_levels=None``
    reads ``PRIORFLOW_DCCL_FUSE_LEVELS``.
    """

    def __init__(self, num_levels: int = 4, radius: int = RADIUS,
                 level_lookup=DCCLLevelLookup.apply,
                 grid_in_kernel: bool = True, fuse_levels: bool = None):
        if radius != RADIUS:
            raise ValueError(f"the lookup is built for radius {RADIUS}")
        self.num_levels = num_levels
        self.level_lookup = level_lookup
        self.grid_in_kernel = grid_in_kernel
        if fuse_levels is None:     # as the JAX package, ops/corr.py:398-402
            fuse_levels = os.environ.get("PRIORFLOW_DCCL_FUSE_LEVELS",
                                         "0") == "1"
        self.fuse_levels = fuse_levels

    def planes_route(self, grid) -> bool:
        """True when the lookup takes the planes route for this grid."""
        return (not self.grid_in_kernel
                or grid.shape[1] > GRID_IN_KERNEL_MAX_WIDTH)

    def __call__(self, coords_A, coords_B, pyr_A: Sequence, pyr_B: Sequence,
                 a2b_w2c_8, b2a_w2c_8, a2b_8, b2a_8):
        """coords_*: (B, h1, w1, 2) current 1/8 coords; pyr_*: per-level
        (B, Q, Hl, Wl) volumes; grids: (h8, w8, 2) f32 tensors.
        Returns (own_A, cross_A, own_B, cross_B), each (B, h1, w1, L*81)
        f32, cross fields rotated back into their query frames."""
        B, h1, w1, _ = coords_A.shape
        Q = h1 * w1
        L = self.num_levels
        cqA = coords_A.reshape(B, Q, 2).float().contiguous()
        cqB = coords_B.reshape(B, Q, 2).float().contiguous()
        scales = [1.0 / 2.0 ** i for i in range(L)]
        if self.planes_route(a2b_w2c_8):
            planes = (*cross_coords_all_levels(cqA, a2b_w2c_8, scales),
                      *cross_coords_all_levels(cqB, b2a_w2c_8, scales))
            levels = [DCCLLevelLookupCoords.apply(
                pyr_A[i], pyr_B[i], cqA, cqB, scales[i],
                *(p[i * B * Q:(i + 1) * B * Q].reshape(B, Q, NTAP)
                  for p in planes)) for i in range(L)]
        elif self.fuse_levels:
            vols = [v for i in range(L) for v in (pyr_A[i], pyr_B[i])]
            outs = DCCLAllLevelsLookup.apply(cqA, cqB, a2b_w2c_8, b2a_w2c_8,
                                             tuple(scales), *vols)
            levels = [outs[4 * i:4 * i + 4] for i in range(L)]
        else:
            levels = [self.level_lookup(pyr_A[i], pyr_B[i], cqA, cqB,
                                        a2b_w2c_8, b2a_w2c_8, scales[i])
                      for i in range(L)]
        return self._finish(levels, B, h1, w1, a2b_8, b2a_8)

    @torch.no_grad()
    def record(self, coords_A, coords_B, pyr_A: Sequence, pyr_B: Sequence,
               a2b_w2c_8, b2a_w2c_8, a2b_8, b2a_8):
        """Primal-only lookup for the taped backward
        (``prior_flow_tpu/ops/corr.py:516-570``): returns
        ``((corr_A, corr_B), (cen_A, cen_B))`` with corr_* the summed own +
        back-rotated cross fields (B, h1, w1, L*81) f32 that the update
        blocks read, and cen_* the unscaled centres (B, Q, 2) from which the
        backward recomputes the cross tap coords. Refuses the planes route,
        as the JAX package does (``:546-548``)."""
        if self.planes_route(a2b_w2c_8):
            raise ValueError("the taped DCCL recording requires the "
                             "grid-in-kernel lookup route")
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
