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
differentiable forms are ``DCCLAllLevelsLookup`` (every level of the grid
route, the custom VJPs of ``dccl_packed_lookup_grid`` and
``dccl_packed_lookup_grid_all``) and ``DCCLLevelLookupCoords`` (of
``dccl_packed_lookup_planes``); ``DCCLFused.record`` serves the taped
backward, which scatters all iterations at once.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import torch

# importing ops.kernels registers the priorflow:: ops the lookups call
from .kernels.dccl_lookup import (NTAP, RADIUS, dccl_level_lookup,
                                  dccl_level_lookup_plain, window_delta)
from .kernels.dccl_scatter import dccl_level_scatter, dccl_level_scatter_grid
from .static_resample import resample_static

__all__ = ["all_pairs_correlation", "avg_pool2", "build_pyramid",
           "build_pyramid_lean", "groupwise_corr", "DCCLFused",
           "DCCLLevelLookupCoords", "DCCLAllLevelsLookup",
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


def _rows(t):
    """A (B, Q, 81) cotangent, or a level's column slice of (B, Q, L*81),
    as the (1, B, Q, 81) rows the scatter reads at their row stride; copied
    only when its layout has no single row stride."""
    B, Q = t.shape[:2]
    ld = t.stride(1)
    if not (t.stride(2) == 1 and ld >= NTAP and t.stride(0) == Q * ld):
        t = t.contiguous()
    return t.unsqueeze(0)


def _scatter_both(g_ownA, g_crossA, g_ownB, g_crossB, cen_A, cen_B, scale,
                  cxA, cyA, cxB, cyB, vol_shape, dtype):
    """The transpose of the lookup at given coords at one level: one
    scatter per volume with S = 1. Volume A takes branch A's own taps and
    branch B's cross taps, volume B the converse
    (``dccl_gather.py:882-887``)."""
    B, Q, Hl, Wl = vol_shape
    one = lambda t: t.reshape(1, B, Q, -1)
    d_A = dccl_level_scatter(_rows(g_ownA), one(cen_A), scale, _rows(g_crossB),
                             one(cxB), one(cyB), Hl, Wl, dtype)
    d_B = dccl_level_scatter(_rows(g_ownB), one(cen_B), scale, _rows(g_crossA),
                             one(cxA), one(cyA), Hl, Wl, dtype)
    return d_A, d_B


class DCCLLevelLookupCoords(torch.autograd.Function):
    """One level's both-branch lookup at given cross tap coords, with its
    VJP (counterpart of ``dccl_packed_lookup_planes``' custom VJP,
    ``dccl_gather.py:783-821``).

    Forward: the op ``priorflow::dccl_level_lookup_coords``
    (``ops/kernels/library.py``; the CUDA kernel on the card).
    Backward: one given-coords scatter per volume with S = 1 at the SAVED
    given coords, nothing recomputed. The centres and coords get no
    gradient.
    """

    @staticmethod
    def forward(ctx, vol_A, vol_B, cen_A, cen_B, scale: float, cxA, cyA, cxB,
                cyB):
        outs = torch.ops.priorflow.dccl_level_lookup_coords(
            vol_A, vol_B, cen_A, cen_B, scale, cxA, cyA, cxB, cyB)
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
    """Every level of the grid route's both-branch lookup, with its VJP
    (counterpart of the custom VJPs of ``dccl_packed_lookup_grid``,
    ``dccl_gather.py:841-891``, and ``dccl_packed_lookup_grid_all``,
    ``:945-1003``).

    ``apply(cen_A, cen_B, grid_A, grid_B, scales, fuse, *vols)`` with
    ``vols`` = (A_0, B_0, A_1, B_1, ...) returns (own_A, cross_A, own_B,
    cross_B), each (B, Q, L*81) f32, level l in columns 81 l .. 81 l + 80.
    Forward: the op ``priorflow::dccl_lookup_levels``
    (``ops/kernels/library.py``), whose kernels write straight into those
    four arrays, one ``dccl_level_lookup`` launch per level, or one
    ``dccl_lookup_all_levels`` launch with ``fuse``. Backward: per level,
    on column views of the cotangents, one grid-entry scatter per volume
    (``_packed_grid_all_bwd``, ``:984-999``).
    """

    @staticmethod
    def forward(ctx, cen_A, cen_B, grid_A, grid_B, scales, fuse, *vols):
        out = torch.ops.priorflow.dccl_lookup_levels(
            list(vols[0::2]), list(vols[1::2]), cen_A, cen_B, grid_A, grid_B,
            list(scales), fuse)
        ctx.save_for_backward(cen_A, cen_B, grid_A, grid_B)
        ctx.scales = tuple(scales)
        ctx.vols = [(v.shape, v.dtype) for v in vols[0::2]]
        return out

    @staticmethod
    def backward(ctx, *grads):
        cen_A, cen_B, grid_A, grid_B = ctx.saved_tensors
        B, Q = cen_A.shape[:2]
        cA, cB = cen_A.reshape(1, B, Q, 2), cen_B.reshape(1, B, Q, 2)
        d = []
        for lvl, (s, (shape, dtype)) in enumerate(zip(ctx.scales, ctx.vols)):
            cols = slice(lvl * NTAP, (lvl + 1) * NTAP)
            # volume A takes branch A's own taps and branch B's cross taps,
            # the cross tap coords computed inside the scatter
            g_ownA, g_crossA, g_ownB, g_crossB = (_rows(g[..., cols])
                                                  for g in grads)
            Hl, Wl = shape[2:]
            d += [dccl_level_scatter_grid(g_ownA, cA, g_crossB, cB, grid_B, s,
                                          Hl, Wl, dtype),
                  dccl_level_scatter_grid(g_ownB, cB, g_crossA, cA, grid_A, s,
                                          Hl, Wl, dtype)]
        return (None,) * 6 + tuple(d)


# the JAX package samples the cross tap coords inside the lookup kernel only
# for 1/8 grids up to this wide (one TPU lane row, ``ops/corr.py:440``) and
# takes the planes route above it; the port keeps that routing, not a limit
# of its own kernels, which take any grid width
GRID_IN_KERNEL_MAX_WIDTH = 128


class DCCLFused:
    """Both branches' DCCL over all pyramid levels
    (``prior_flow_tpu/ops/corr.py:373``), by one of three routes, chosen as
    in the JAX package:

    - the grid route (the default): ``DCCLAllLevelsLookup``, one lookup
      launch per level, the cross tap coords computed inside the kernel,
      each level written straight into the four (B, Q, L*81) fields;
    - the all-levels grid route (``fuse_levels``): the same Function with
      one launch for every level;
    - the planes route (``grid_in_kernel=False``, or a 1/8 grid wider than
      128 columns, as at 1024x2048): both branches' cross tap coords for
      all levels first, in one ``dccl_cross_coords`` launch (the level
      scale applied inside), then one ``DCCLLevelLookupCoords`` per level
      (``ops/corr.py:445-464, 503-507``). The coords stand in for the JAX
      package's ``sample_image_window_planes`` einsums (``:452-461``),
      the same function up to f32 rounding. ``fuse_levels`` has no effect
      here.

    The three give the same bits: scaling a centre by a power of two is
    exact, so the planes route's coords are the ones the grid route's
    kernel computes. ``level_lookup`` replaces the grid route's Function
    by a lookup called level by level, its levels concatenated: the
    kernels' reference ``dccl_level_lookup_plain`` (the plain gathers on
    any device, differentiated by autograd); ``fuse_levels`` takes
    precedence over it. ``fuse_levels=None`` reads
    ``PRIORFLOW_DCCL_FUSE_LEVELS``.
    """

    def __init__(self, num_levels: int = 4, radius: int = RADIUS,
                 level_lookup=None, grid_in_kernel: bool = True,
                 fuse_levels: bool = None):
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
            planes = torch.ops.priorflow.dccl_cross_coords(
                cqA, cqB, a2b_w2c_8, b2a_w2c_8, scales)
            fields = _concat([DCCLLevelLookupCoords.apply(
                pyr_A[i], pyr_B[i], cqA, cqB, scales[i],
                *(p[i * B * Q:(i + 1) * B * Q].reshape(B, Q, NTAP)
                  for p in planes)) for i in range(L)])
        elif self.fuse_levels or self.level_lookup is None:
            vols = [v for i in range(L) for v in (pyr_A[i], pyr_B[i])]
            fields = DCCLAllLevelsLookup.apply(
                cqA, cqB, a2b_w2c_8, b2a_w2c_8, tuple(scales),
                self.fuse_levels, *vols)
        else:
            fields = _concat([self.level_lookup(pyr_A[i], pyr_B[i], cqA, cqB,
                                                a2b_w2c_8, b2a_w2c_8,
                                                scales[i])
                              for i in range(L)])
        return self._finish(fields, B, h1, w1, a2b_8, b2a_8)

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
    def _finish(fields, B, h1, w1, a2b_8, b2a_8):
        """Rotate each branch's cross field back with ONE resample over the
        level-concatenated channels (``prior_flow_tpu/ops/corr.py:572-587``;
        resampling is channelwise, so rotate-then-concat equals
        concat-then-rotate). ``fields``: the four (B, Q, L*81) fields."""
        own_A, cross_A, own_B, cross_B = (f.reshape(B, h1, w1, -1)
                                          for f in fields)
        return (own_A, resample_static(cross_A, b2a_8), own_B,
                resample_static(cross_B, a2b_8))


def _concat(levels):
    """Per-level (own_A, cross_A, own_B, cross_B) -> the four (B, Q, L*81)
    fields."""
    return [torch.cat([lv[j] for lv in levels], dim=-1) for j in range(4)]
