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
backward and the deferred path (``DCCLDeferredRebind``), which scatter all
iterations at once through ``stacked_volume_cotangents``. ``DCCL`` (``mxu``,
``gather``) is the JAX package's one-branch lookup without a kernel,
differentiated by autograd.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import torch

# importing ops.kernels registers the priorflow:: ops the lookups call
from .kernels.dccl_lookup import (NTAP, RADIUS, dccl_level_lookup,
                                  dccl_level_lookup_plain,
                                  sample_volume_level, window_delta)
from ..parallel import spatial
from .kernels.dccl_scatter import dccl_level_scatter, dccl_level_scatter_grid
from .samplers import bilinear_corners, cycle_bilinear_sample
from .static_resample import resample_static, resample_static_transpose

__all__ = ["all_pairs_correlation", "avg_pool2", "build_pyramid",
           "build_pyramid_lean", "groupwise_corr", "DCCL", "DCCLFused",
           "lookup_window_mxu", "sample_image_window_mxu",
           "sample_volume_level", "sample_volume_level_mxu",
           "DCCLOnTheFly", "OnTheFlyTaps", "tap_values",
           "DCCLLevelLookupCoords", "DCCLAllLevelsLookup",
           "DCCLDeferredRebind", "stacked_volume_cotangents",
           "window_delta", "dccl_level_lookup", "dccl_level_lookup_plain"]


def all_pairs_correlation(fmap1: torch.Tensor, fmap2: torch.Tensor):
    """(B, H, W, C) queries x (B, H2, W2, C) targets -> (B, H*W, H2, W2)
    f32 cost volume scaled by 1/sqrt(C) (``prior_flow_tpu/ops/corr.py:46``;
    height-sharded, the rank's query rows against the gathered fmap2). A
    plain f32 matmul, as the JAX package leaves it to XLA."""
    B, H, W, C = fmap1.shape
    H2, W2 = fmap2.shape[1:3]
    a = fmap1.reshape(B, H * W, C).float()
    b = fmap2.reshape(B, H2 * W2, C).float()
    vol = torch.matmul(a, b.transpose(1, 2))
    return vol.reshape(B, H * W, H2, W2) / math.sqrt(C)


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
    (the chunks are written by slice assignment). The queries are fmap1's
    (a rank's rows, height-sharded), the targets fmap2's.
    """
    B, H1, W1, C = fmap1.shape
    H, W = fmap2.shape[1:3]
    Q = H1 * W1
    a = fmap1.reshape(B, Q, C).float()
    b = fmap2.reshape(B, H * W, C).float().transpose(1, 2)
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


def stacked_volume_cotangents(g_A, g_B, cen_A, cen_B, levels, grids):
    """The volume cotangents of S recorded iterations of the grid route
    at once (``dccl_gather.py::_rebind_bwd``, ``:1235-1277``): the shared
    step of the taped backward (``train/trainer.py::taped_value_and_grad``)
    and of ``DCCLDeferredRebind``.

    g_*: the stacked cotangents (S, B, h1, w1, L*81) of the summed own +
    back-rotated cross fields; cen_*: the recorded unscaled centres
    (S, B, Q, 2); ``levels``: per level (Hl, Wl, dtype) of the volumes;
    ``grids``: the ``RotationGrids`` the lookups ran on. First the
    transposed back-rotation of each branch's cross part, then per level
    and volume ONE grid-entry scatter with S = iterations, which reads the
    level's columns of the stacked cotangents in place and computes the
    other branch's cross tap coords itself. Returns per level the pair
    (d vol_A, d vol_B). Height-sharded, g_* and cen_* are the rank's
    queries (global centres): the transposed back-rotation is that of
    the sharded ``resample_static`` (a reduce-scatter, run on every rank)
    and each scatter writes the rank's rows of its volume."""
    S, B, h1, w1, C = g_A.shape
    Q = h1 * w1

    def back_rot_t(gf, grid):
        # own and cross were summed, so both read the field cotangent
        ct = resample_static_transpose(gf.reshape(S * B, h1, w1, C), grid,
                                       (h1, w1))
        return ct.reshape(S, B, Q, C)

    gA_cross = back_rot_t(g_A, grids.b2a_8)
    gB_cross = back_rot_t(g_B, grids.a2b_8)
    gA_own = g_A.reshape(S, B, Q, C)
    gB_own = g_B.reshape(S, B, Q, C)
    d = []
    for lvl, (Hl, Wl, dtype) in enumerate(levels):
        s = 1.0 / 2.0 ** lvl
        sl = slice(lvl * NTAP, (lvl + 1) * NTAP)
        # volume A takes branch A's own taps and branch B's cross taps
        d.append((
            dccl_level_scatter_grid(gA_own[..., sl], cen_A, gB_cross[..., sl],
                                    cen_B, grids.b2a_w2c_8, s, Hl, Wl, dtype),
            dccl_level_scatter_grid(gB_own[..., sl], cen_B, gA_cross[..., sl],
                                    cen_A, grids.a2b_w2c_8, s, Hl, Wl, dtype)))
    return d


class DCCLDeferredRebind(torch.autograd.Function):
    """Re-binds the fields of a no-grad recording pass to the volumes
    (counterpart of ``dccl_deferred_rebind`` / ``_rebind``,
    ``dccl_gather.py:1193-1302``), for ``PriOrRAFT(deferred_vol_grad=True)``.

    ``apply(fields_A, fields_B, cen_A, cen_B, grids, *vols)`` with the
    recorded stacked fields (S, B, h1, w1, L*81), the recorded centres
    (S, B, Q, 2), the ``RotationGrids`` of the recording and ``vols`` =
    (A_0, B_0, A_1, B_1, ...). Forward: the identity on the two stacked
    fields. Backward: ``stacked_volume_cotangents`` at the recorded centres
    (the cross tap coords are recomputed inside the scatter, not taped:
    ~3.2 GB at 512x1024, batch 4, ``dccl_gather.py:1049-1051``). The
    lookup is linear in the volume and its coords carry no gradient, so
    this is the sum of every iteration's lookup backward. Fields, centres
    and grids get no gradient.
    """

    @staticmethod
    def forward(ctx, fields_A, fields_B, cen_A, cen_B, grids, *vols):
        ctx.save_for_backward(cen_A, cen_B)
        ctx.grids = grids
        ctx.levels = [(v.shape[2], v.shape[3], v.dtype) for v in vols[0::2]]
        return fields_A.view_as(fields_A), fields_B.view_as(fields_B)

    @staticmethod
    def backward(ctx, g_A, g_B):
        cen_A, cen_B = ctx.saved_tensors
        d = stacked_volume_cotangents(g_A, g_B, cen_A, cen_B, ctx.levels,
                                      ctx.grids)
        return (None,) * 5 + tuple(t for pair in d for t in pair)


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
        concat-then-rotate). ``fields``: the four (B, Q, L*81) fields.
        Height-sharded, the queries are the rank's rows and the cross
        fields are gathered before the back-rotation (``resample_static``
        under a space scope)."""
        own_A, cross_A, own_B, cross_B = (f.reshape(B, h1, w1, -1)
                                          for f in fields)
        return (own_A, resample_static(cross_A, b2a_8), own_B,
                resample_static(cross_B, a2b_8))


def _concat(levels):
    """Per-level (own_A, cross_A, own_B, cross_B) -> the four (B, Q, L*81)
    fields."""
    return [torch.cat([lv[j] for lv in levels], dim=-1) for j in range(4)]


# -- the one-hot and gather lookups (lookup_mode 'mxu' / 'gather') ------------

def _window_weights(centers, extent: int, radius: int, wrap: bool):
    """Separable one-hot bilinear weights of a (2r+1)-tap window
    (``prior_flow_tpu/ops/corr.py:126-168``): for a 1-D coordinate t and
    offset d in [-r, r], corners floor(t_d) and floor(t_d) + 1 with weights
    (1 - frac, frac), t_d = (t + d) mod extent with ``wrap``; a corner
    outside [0, extent - 1] weighs zero (floor(t_d) + 1 == extent too: the
    seam quirk). centers: (...) f32 -> (..., 2r+1, extent) f32 with
    out[tap] = sum_c w[tap, c] * v[c]."""
    n = 2 * radius + 1
    t = torch.remainder(centers, extent) if wrap else centers
    t0 = torch.floor(t)
    frac = (t - t0)[..., None, None]
    d = torch.arange(n, dtype=torch.float32, device=t.device) - radius
    base = t0[..., None] + d
    if wrap:
        base = torch.remainder(base, extent)
    cols = torch.arange(extent, dtype=torch.float32, device=t.device)
    base = base[..., None]
    return (torch.where(cols == base, 1.0 - frac, 0.0)
            + torch.where(cols == base + 1.0, frac, 0.0))


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(..., preferred_element_type=float32)``: the operands'
    values (bf16 exactly representable) multiplied and summed in f32."""
    return torch.einsum(eq, a.float(), b.float())


def lookup_window_mxu(vol_l: torch.Tensor, coords: torch.Tensor,
                      radius: int = RADIUS) -> torch.Tensor:
    """Own-branch window lookup as two one-hot contractions
    (``prior_flow_tpu/ops/corr.py:171``). vol_l: (B, Q, Hl, Wl); coords:
    (B, Q, 2) level-scaled centres -> (B, Q, K) f32, tap k = i*(2r+1)+j
    with x-offset i-r, y-offset j-r. The weights are in the volume's
    dtype, each contraction sums in f32, and the first is rounded to the
    volume's dtype before the second, as in JAX."""
    B, Q, Hl, Wl = vol_l.shape
    n = 2 * radius + 1
    dt = vol_l.dtype
    wy = _window_weights(coords[..., 1], Hl, radius, wrap=False).to(dt)
    wx = _window_weights(coords[..., 0], Wl, radius, wrap=True).to(dt)
    tmp = _einsum_f32("bqic,bqrc->bqir", wx, vol_l)
    out = _einsum_f32("bqir,bqjr->bqij", tmp.to(dt), wy)
    return out.reshape(B, Q, n * n)


def sample_image_window_mxu(img: torch.Tensor, coords: torch.Tensor,
                            radius: int = RADIUS) -> torch.Tensor:
    """Window lookup into a shared image (B, H, W, C) at per-query centres
    (B, Q, 2) -> (B, Q, K, C) f32, as one-hot contractions, rows first
    (``prior_flow_tpu/ops/corr.py:198``): the cross tap coords from the
    1/8 rotation grid."""
    B, H, W, C = img.shape
    Q = coords.shape[1]
    n = 2 * radius + 1
    wy = _window_weights(coords[..., 1], H, radius, wrap=False)
    wx = _window_weights(coords[..., 0], W, radius, wrap=True)
    tmp = _einsum_f32("bqjr,brcd->bqjcd", wy, img)
    out = _einsum_f32("bqjcd,bqic->bqijd", tmp, wx)
    return out.reshape(B, Q, n * n, C)


# the (B, Q, k, Hl) f32 intermediate of ``sample_volume_level_mxu`` is held
# under this many bytes by chunking the taps (``ops/corr.py:274-280``)
MXU_TAP_BUDGET = 256 * 1024 * 1024


def sample_volume_level_mxu(vol_l: torch.Tensor,
                            coords: torch.Tensor) -> torch.Tensor:
    """``sample_volume_level`` at arbitrary per-tap coords (B, Q, K, 2) as
    one-hot contractions, each tap a radius-0 weight row over rows and
    columns (``prior_flow_tpu/ops/corr.py:261``) -> (B, Q, K) f32. The
    taps go in chunks as large as keep the (B, Q, k, Hl) f32 intermediate
    within ``MXU_TAP_BUDGET``."""
    B, Q, Hl, Wl = vol_l.shape
    K = coords.shape[2]
    tap_chunk = max(1, min(K, MXU_TAP_BUDGET // 4 // max(B * Q * Hl, 1)))
    dt = vol_l.dtype
    outs = []
    for k0 in range(0, K, tap_chunk):
        c = coords[:, :, k0:k0 + tap_chunk]
        wy = _window_weights(c[..., 1], Hl, 0, wrap=False)[..., 0, :].to(dt)
        wx = _window_weights(c[..., 0], Wl, 0, wrap=True)[..., 0, :].to(dt)
        tmp = _einsum_f32("bqkc,bqrc->bqkr", wx, vol_l)
        outs.append(_einsum_f32("bqkr,bqkr->bqk", tmp.to(dt), wy))
    return torch.cat(outs, dim=-1)


class DCCL:
    """One branch's DCCL over all levels without a kernel (counterpart of
    ``prior_flow_tpu/ops/corr.py:294-370``), what the JAX model runs off
    the TPU. ``lookup_mode``: ``"mxu"``, windowed one-hot contractions
    (matrix products); ``"gather"``, the plain bilinear gathers of the
    reference's grid_sample chain. The two compute the same function.

    ``__call__(coords, pyr_own, pyr_other, grid_w2c_8, grid_back_8)``:
    coords (B, h1, w1, 2), the branch's 1/8 coords; ``grid_w2c_8`` maps
    query-frame coords into the other branch's frame (sampled at the
    level-scaled window, not rescaled for levels above 0); ``grid_back_8``
    rotates the cross field back into the query frame, by
    ``resample_static`` for a batch-invariant (h8, w8, 2) grid, by
    ``cycle_bilinear_sample`` for a per-batch one, once over all levels'
    channels. Returns ``(own,
    cross)``, each (B, h1, w1, L*(2r+1)^2) f32. Differentiable in the
    volumes by autograd.

    Height-sharded (a ``parallel.spatial.scope``), ``coords`` and the
    volumes' queries are the rank's rows and both grids the whole image's:
    the lookups read the rank's volume rows, and the back-rotation gathers
    the cross field's rows and samples the rank's rows of the grid (the
    sharded ``resample_static``, or the same by hand for a per-batch
    grid).
    """

    MODES = ("mxu", "gather")

    def __init__(self, num_levels: int = 4, radius: int = RADIUS,
                 lookup_mode: str = "mxu"):
        if lookup_mode not in self.MODES:
            raise ValueError(f"DCCL lookup_mode must be one of {self.MODES}, "
                             f"got {lookup_mode!r}")
        self.num_levels = num_levels
        self.radius = radius
        self.lookup_mode = lookup_mode

    def __call__(self, coords, pyr_own: Sequence, pyr_other: Sequence,
                 grid_w2c_8, grid_back_8):
        B, h1, w1, _ = coords.shape
        Q = h1 * w1
        delta = window_delta(self.radius, coords.device)
        K = delta.shape[0]
        cq = coords.reshape(B, Q, 2)
        if grid_w2c_8.dim() == 3:
            grid_w2c_8 = grid_w2c_8.expand(B, *grid_w2c_8.shape)
        space = spatial.current()
        if grid_back_8.dim() == 3:
            back_rot = resample_static
        elif space is None:
            back_rot = cycle_bilinear_sample
        else:
            def back_rot(field, grid):
                return cycle_bilinear_sample(
                    spatial.gather_rows(field, 1, space),
                    spatial.rows(grid, space, dim=1))
        own_out, cross_out = [], []
        for i in range(self.num_levels):
            centers = cq / (2.0 ** i)
            if self.lookup_mode == "mxu":
                own = lookup_window_mxu(pyr_own[i], centers, self.radius)
                coords_other = sample_image_window_mxu(grid_w2c_8, centers,
                                                       self.radius)
                cross = sample_volume_level_mxu(pyr_other[i], coords_other)
            else:
                coords_lvl = centers[:, :, None, :] + delta
                own = sample_volume_level(pyr_own[i], coords_lvl)
                coords_other = cycle_bilinear_sample(grid_w2c_8, coords_lvl)
                cross = sample_volume_level(pyr_other[i], coords_other)
            own_out.append(own.reshape(B, h1, w1, K))
            cross_out.append(cross.reshape(B, h1, w1, K))
        # one back-rotation over the levels' channels: resampling is
        # channelwise, so this is JAX's per-level rotation, bitwise
        cross = back_rot(torch.cat(cross_out, dim=-1), grid_back_8)
        return torch.cat(own_out, dim=-1).float(), cross.float()


# -- on-the-fly correlation (corr_mode='onthefly') -----------------------------

# taps per gather in the tap path: a third of the 81-tap window, JAX's
# ``DCCLOnTheFly`` default (``prior_flow_tpu/ops/corr.py:623``)
TAP_CHUNK = 27

def _tap_rows(f2, x, y):
    """Per corner of ``cycle_bilinear_sample``'s read at the taps (x, y),
    each (B, q, k), x wrapped mod Wl: the row indices into
    ``f2.reshape(B*Hl*Wl, C)`` and the weights, both (B, q, k)."""
    B, Hl, Wl, _ = f2.shape
    base = (torch.arange(B, device=f2.device) * (Hl * Wl)).view(B, 1, 1)
    return [(base + iy * Wl + ix, w) for ix, iy, w in
            bilinear_corners(torch.remainder(x, Wl), y, Hl, Wl)]


def tap_values(f1, f2, x, y):
    """<f1[q], cycle-bilinear(f2, (x, y)[q, k])> (``DCCLOnTheFly._tap_values``,
    ``prior_flow_tpu/ops/corr.py:649-659``), in chunks of ``TAP_CHUNK``
    taps. f1: (B, q, C);
    f2: (B, Hl, Wl, C); x, y: (B, q, K) -> (B, q, K) in f1's dtype.

    By linearity each corner's dot <f1, f2[corner]> is taken first and the
    dots are blended with the corner weights, so only the gathered rows of
    one corner, (B, q, k, C), exist at a time. An empty level (no rows)
    gives zeros, as the sampler does."""
    B, q, K = x.shape
    Hl, Wl, C = f2.shape[1:]
    out = f1.new_zeros((B, q, K))
    if Hl * Wl == 0:
        return out
    flat = f2.reshape(B * Hl * Wl, C)
    f1c = f1.reshape(B * q, C, 1)
    for k0 in range(0, K, TAP_CHUNK):
        xs, ys = x[..., k0:k0 + TAP_CHUNK], y[..., k0:k0 + TAP_CHUNK]
        k = xs.shape[-1]
        for idx, w in _tap_rows(f2, xs, ys):
            rows = flat.index_select(0, idx.reshape(-1)).view(B * q, k, C)
            out[..., k0:k0 + k] += w * torch.bmm(rows, f1c).view(B, q, k)
    return out


def tap_values_backward(g, f1, f2, x, y, d_f1, d_f2):
    """Adds the VJP of ``tap_values`` for the cotangent g (B, q, K) into
    d_f1 (B, q, C) and d_f2 (B, Hl, Wl, C), either may be None. The gathered
    rows are read again, not saved: d_f1[q] = sum_k g[q, k] bilinear(f2,
    tap); d_f2 is the exact transpose of the bilinear read, each corner's
    weighted g[q, k] f1[q] added into its row (``index_add_``), nothing
    where the forward sampled zero."""
    B, q, K = x.shape
    Hl, Wl, C = f2.shape[1:]
    if Hl * Wl == 0:
        return
    flat = f2.reshape(B * Hl * Wl, C)
    d_flat = None if d_f2 is None else d_f2.view(B * Hl * Wl, C)
    f1r = f1.reshape(B * q, 1, C)
    for k0 in range(0, K, TAP_CHUNK):
        xs, ys = x[..., k0:k0 + TAP_CHUNK], y[..., k0:k0 + TAP_CHUNK]
        k = xs.shape[-1]
        gs = g[..., k0:k0 + k]
        for idx, w in _tap_rows(f2, xs, ys):
            gw = (gs * w).reshape(B * q, 1, k)
            if d_f1 is not None:
                rows = flat.index_select(0, idx.reshape(-1)).view(B * q, k, C)
                d_f1 += torch.bmm(gw, rows).view(B, q, C)
            if d_flat is not None:
                d_flat.index_add_(0, idx.reshape(-1),
                                  (gw.transpose(1, 2) * f1r).view(-1, C))


def _query_chunks(Q: int, query_chunk: int, auto: int):
    """The query ranges of ``DCCLOnTheFly``'s chunking
    (``prior_flow_tpu/ops/corr.py:696-707``): ``query_chunk`` 0 chunks by
    ``auto`` above ``auto`` queries, -1 never; a chunk of gcd(Q, chunk)."""
    qc = query_chunk
    if qc == 0 and Q > auto:
        qc = auto
    qc = math.gcd(Q, qc) if 0 < qc < Q else Q
    return [(q0, q0 + qc) for q0 in range(0, Q, qc)]


# the branch whose f1 rows and f2 levels own_A, cross_A, own_B and cross_B
# read: own taps the branch's own, cross taps the other branch's
SIDE_BRANCH = (0, 1, 1, 0)


class OnTheFlyTaps(torch.autograd.Function):
    """Both branches' own and cross tap values at every level, computed from
    the feature pyramids, with a VJP that recomputes instead of saving.

    ``apply(cen_A, cen_B, grid_A, grid_B, scales, chunks, f1_A, f1_B,
    *f2s)``, f2s = (A_0, B_0, A_1, B_1, ...), returns (own_A, cross_A,
    own_B, cross_B), each (B, Q, L*81), level l in columns 81 l .. 81 l + 80,
    the layout of ``DCCLAllLevelsLookup``. Per query chunk: the cross tap
    coords of both branches at every level in one ``priorflow::
    dccl_cross_coords`` op (the CUDA kernel on the card), the own taps at
    centre x scale + offset, then ``tap_values`` per level, branch and side.
    Branch A's cross taps read branch B's features at its grid's coords,
    as the volume route's cross lookup reads volume B.

    Saved: the centres, grids, f1 and the f2 levels, which the model holds
    anyway; the backward recomputes the coords (one op per chunk) and the
    gathers (``tap_values_backward``). The centres and grids get no
    gradient. Autocast is off inside: the dots stay in the features' dtype.
    """

    @staticmethod
    def _coords(cen_A, cen_B, grid_A, grid_B, scales, q0, q1):
        """Per level: ((ownA_x, ownA_y), (crossA_x, crossA_y), (ownB ...),
        (crossB ...)) of the chunk's queries, each (B, q, 81)."""
        cA = cen_A[:, q0:q1].contiguous()
        cB = cen_B[:, q0:q1].contiguous()
        B, q, _ = cA.shape
        planes = torch.ops.priorflow.dccl_cross_coords(cA, cB, grid_A, grid_B,
                                                      list(scales))
        delta = window_delta(RADIUS, cA.device).to(cA.dtype)
        out = []
        for lvl, s in enumerate(scales):
            rows = slice(lvl * B * q, (lvl + 1) * B * q)
            xA, yA, xB, yB = (p[rows].view(B, q, NTAP) for p in planes)
            own = [((c * s)[..., None, 0] + delta[:, 0],
                    (c * s)[..., None, 1] + delta[:, 1]) for c in (cA, cB)]
            out.append((own[0], (xA, yA), own[1], (xB, yB)))
        return out

    @staticmethod
    def forward(ctx, cen_A, cen_B, grid_A, grid_B, scales, chunks, f1_A, f1_B,
                *f2s):
        B, Q, _ = f1_A.shape
        L = len(scales)
        fields = [f1_A.new_empty((B, Q, L * NTAP)) for _ in range(4)]
        with torch.autocast(f1_A.device.type, enabled=False):
            for q0, q1 in chunks:
                f1s = (f1_A[:, q0:q1], f1_B[:, q0:q1])
                for lvl, coords in enumerate(OnTheFlyTaps._coords(
                        cen_A, cen_B, grid_A, grid_B, scales, q0, q1)):
                    cols = slice(lvl * NTAP, (lvl + 1) * NTAP)
                    for j, b in enumerate(SIDE_BRANCH):
                        fields[j][:, q0:q1, cols] = tap_values(
                            f1s[b], f2s[2 * lvl + b], *coords[j])
        ctx.save_for_backward(cen_A, cen_B, grid_A, grid_B, f1_A, f1_B, *f2s)
        ctx.scales, ctx.chunks = scales, chunks
        return tuple(fields)

    @staticmethod
    def backward(ctx, *grads):
        cen_A, cen_B, grid_A, grid_B, f1_A, f1_B, *f2s = ctx.saved_tensors
        need = ctx.needs_input_grad
        d_f1 = [torch.zeros_like(f) if need[6 + i] else None
                for i, f in enumerate((f1_A, f1_B))]
        d_f2 = [torch.zeros_like(f) if need[8 + i] else None
                for i, f in enumerate(f2s)]
        with torch.autocast(f1_A.device.type, enabled=False):
            for q0, q1 in ctx.chunks:
                f1s = (f1_A[:, q0:q1], f1_B[:, q0:q1])
                d1s = [None if d is None else d[:, q0:q1] for d in d_f1]
                for lvl, coords in enumerate(OnTheFlyTaps._coords(
                        cen_A, cen_B, grid_A, grid_B, ctx.scales, q0, q1)):
                    cols = slice(lvl * NTAP, (lvl + 1) * NTAP)
                    for j, b in enumerate(SIDE_BRANCH):
                        if grads[j] is not None:
                            tap_values_backward(
                                grads[j][:, q0:q1, cols], f1s[b],
                                f2s[2 * lvl + b], *coords[j], d1s[b],
                                d_f2[2 * lvl + b])
        return (None,) * 6 + tuple(d_f1) + tuple(d_f2)


class DCCLOnTheFly:
    """Both branches' DCCL over all levels, the correlation computed per tap
    from feature pyramids, never as a volume (counterpart of
    ``prior_flow_tpu/ops/corr.py:590-720``, the reference's
    ``alt_cuda_corr`` capability).

    Exact, not an approximation: the pyramid pools the volume over the
    target axes only and correlation is linear in fmap2, so pooling fmap2
    gives the pooled volume, and bilinear sampling commutes with the
    feature dot. Memory O(HW C) per level instead of O((HW)^2): the only
    route where the volumes outgrow the card (at 2048x4096 two bf16
    volume pyramids need 91.6 GB).

    Called like ``DCCLFused`` with feature pyramids in place of volume
    pyramids: ``pyr_*`` is ``build_pyramid``'s list of (f1 (B, Q, C), f2_l
    (B, Hl, Wl, C)); returns (own_A, cross_A, own_B, cross_B), each
    (B, h1, w1, L*81) f32, the cross fields rotated back into their query
    frames. The JAX class takes one branch per call; this one serves both,
    so one coords op per query chunk places both branches' cross taps.
    Queries are processed in chunks of ``QUERY_CHUNK_AUTO`` above that many
    (``query_chunk`` 0), never (-1), or of gcd(Q, ``query_chunk``); taps in
    chunks of ``TAP_CHUNK``. The work is ``OnTheFlyTaps``: plain gathers
    and matrix products, no kernel of its own.
    """

    QUERY_CHUNK_AUTO = 16384

    def __init__(self, num_levels: int = 4, radius: int = RADIUS,
                 query_chunk: int = 0):
        if radius != RADIUS:
            raise ValueError(f"the lookup is built for radius {RADIUS}")
        self.num_levels = num_levels
        self.query_chunk = query_chunk

    @staticmethod
    def build_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                      num_levels: int = 4):
        """(B, h, w, C) x2 -> ``num_levels`` pairs (f1 (B, Q, C), f2_l
        (B, Hl, Wl, C)) (``prior_flow_tpu/ops/corr.py:632-646``): f1 =
        fmap1 / sqrt(C), shared by every level; f2 2x2 mean-pooled per
        level, odd trailing rows and columns dropped as ``avg_pool2``
        drops them from the volume."""
        B, h, w, C = fmap1.shape
        f1 = (fmap1 / math.sqrt(C)).reshape(B, h * w, C)
        levels, f2 = [], fmap2
        for i in range(num_levels):
            levels.append((f1, f2))
            if i + 1 < num_levels:
                _, Hl, Wl, _ = f2.shape
                f2 = f2[:, :Hl // 2 * 2, :Wl // 2 * 2].reshape(
                    B, Hl // 2, 2, Wl // 2, 2, C).mean(dim=(2, 4))
        return levels

    def __call__(self, coords_A, coords_B, pyr_A: Sequence, pyr_B: Sequence,
                 a2b_w2c_8, b2a_w2c_8, a2b_8, b2a_8):
        B, h1, w1, _ = coords_A.shape
        Q = h1 * w1
        L = self.num_levels
        cqA = coords_A.reshape(B, Q, 2).float().contiguous()
        cqB = coords_B.reshape(B, Q, 2).float().contiguous()
        f2s = [pyr[i][1] for i in range(L) for pyr in (pyr_A, pyr_B)]
        fields = OnTheFlyTaps.apply(
            cqA, cqB, a2b_w2c_8, b2a_w2c_8,
            tuple(1.0 / 2.0 ** i for i in range(L)),
            _query_chunks(Q, self.query_chunk, self.QUERY_CHUNK_AUTO),
            pyr_A[0][0], pyr_B[0][0], *f2s)
        return DCCLFused._finish(fields, B, h1, w1, a2b_8, b2a_8)
