"""The forward's kernels as ``torch.library`` ops, namespace ``priorflow``.

``torch.export`` and AOTInductor trace a model on FakeTensors, which have
no data pointer, so they cannot trace a wrapper's ctypes launch. Each op
here has three implementations:

- CPU: the kernel's plain version;
- CUDA: the wrapper's launch, which counts itself in
  ``<wrapper>.launches`` and raises on a build or launch error;
- fake: the output shapes and dtypes, for the tracer.

| op | kernel (PERF.md row) | wrapper |
| --- | --- | --- |
| ``dccl_lookup_levels`` | kernel 1 per level (1), or the all-levels launch with ``fuse`` (4) | ``dccl_lookup.dccl_level_lookup``, ``dccl_lookup_all_levels`` |
| ``instance_norm_sums`` | the sums (2) | ``instance_norm.instance_norm_sums`` |
| ``dccl_level_lookup_coords`` | the lookup at given cross coords (3) | ``dccl_lookup.dccl_level_lookup_coords`` |
| ``dccl_cross_coords`` | the cross tap coords (4 levels, both branches) (5) | ``dccl_coords.dccl_cross_coords`` |

The forwards of ``ops/corr.py``'s lookups and of
``instance_norm.InstanceNormFunction`` call these ops, eager and exported
alike, so what runs is what is exported. Their backwards and the scatter
stay ctypes calls: the JAX package exports no training step.

A compiler may hand an op a tensor in another layout than eager code
would (a padded or permuted one). The ops are tagged
``needs_exact_strides``, so Inductor passes each input with the strides
it had when traced: the model's own tensors, contiguous. The wrappers'
checks still raise on a non-contiguous input.
"""

import torch

from .dccl_coords import dccl_cross_coords as _cross_coords
from .dccl_coords import dccl_cross_coords_plain
from .dccl_lookup import (NTAP, dccl_level_lookup,
                          dccl_level_lookup_coords_plain,
                          dccl_lookup_all_levels,
                          dccl_lookup_all_levels_plain)
from .dccl_lookup import dccl_level_lookup_coords as _lookup_coords
from .instance_norm import instance_norm_sums as _sums
from .instance_norm import instance_norm_sums_plain

Tensor = torch.Tensor
_TAGS = (torch.Tag.needs_exact_strides,)


def _fields(cen_A, n_levels):
    """Four new (B, Q, L*81) f32 fields, one allocation each."""
    B, Q = cen_A.shape[:2]
    return [cen_A.new_empty((B, Q, n_levels * NTAP)) for _ in range(4)]


# -- rows 1 and 4 -------------------------------------------------------------

@torch.library.custom_op("priorflow::dccl_lookup_levels", mutates_args=(),
                         device_types="cpu", tags=_TAGS)
def dccl_lookup_levels(vols_A: list[Tensor], vols_B: list[Tensor],
                       cen_A: Tensor, cen_B: Tensor, grid_A: Tensor,
                       grid_B: Tensor, scales: list[float],
                       fuse: bool) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Both branches' own and cross taps at every level of the grid route:
    (own_A, cross_A, own_B, cross_B), each (B, Q, L*81) f32, level l in
    columns 81 l .. 81 l + 80. vols_*: L volumes (B, Q, Hl, Wl) f32 or
    bf16; cen_*: (B, Q, 2) f32; grid_*: (Hg, Wg, 2) f32; scales: the L
    level scales. On the card one ``dccl_level_lookup`` launch per level,
    or with ``fuse`` one ``dccl_lookup_all_levels`` launch, each writing
    straight into the four fields; on the CPU the plain version (``fuse``
    changes nothing there)."""
    levels = dccl_lookup_all_levels_plain(vols_A, vols_B, cen_A, cen_B,
                                          grid_A, grid_B, scales)
    return tuple(torch.cat([lv[j] for lv in levels], dim=-1)
                 for j in range(4))


@dccl_lookup_levels.register_kernel("cuda")
def _(vols_A, vols_B, cen_A, cen_B, grid_A, grid_B, scales, fuse):
    if not len(vols_A) == len(vols_B) == len(scales):
        raise ValueError(f"dccl_lookup_levels: {len(vols_A)} and "
                         f"{len(vols_B)} volumes for {len(scales)} scales")
    out = _fields(cen_A, len(scales))
    if fuse:
        dccl_lookup_all_levels(vols_A, vols_B, cen_A, cen_B, grid_A, grid_B,
                               scales, out=out)
    else:
        for lvl, s in enumerate(scales):
            dccl_level_lookup(vols_A[lvl], vols_B[lvl], cen_A, cen_B, grid_A,
                              grid_B, s, out=out, col=lvl * NTAP)
    return tuple(out)


@dccl_lookup_levels.register_fake
def _(vols_A, vols_B, cen_A, cen_B, grid_A, grid_B, scales, fuse):
    return tuple(_fields(cen_A, len(scales)))


# -- row 3 --------------------------------------------------------------------

@torch.library.custom_op("priorflow::dccl_level_lookup_coords",
                         mutates_args=(), device_types="cpu", tags=_TAGS)
def dccl_level_lookup_coords(vol_A: Tensor, vol_B: Tensor, cen_A: Tensor,
                             cen_B: Tensor, scale: float, cxA: Tensor,
                             cyA: Tensor, cxB: Tensor, cyB: Tensor
                             ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """One level's own taps and the cross taps at given coords, both
    branches: (own_A, cross_A, own_B, cross_B), each (B, Q, 81) f32 (the
    arguments of ``dccl_lookup.dccl_level_lookup_coords_plain``)."""
    return dccl_level_lookup_coords_plain(vol_A, vol_B, cen_A, cen_B, scale,
                                          cxA, cyA, cxB, cyB)


@dccl_level_lookup_coords.register_kernel("cuda")
def _(vol_A, vol_B, cen_A, cen_B, scale, cxA, cyA, cxB, cyB):
    return _lookup_coords(vol_A, vol_B, cen_A, cen_B, scale, cxA, cyA, cxB,
                          cyB)


@dccl_level_lookup_coords.register_fake
def _(vol_A, vol_B, cen_A, cen_B, scale, cxA, cyA, cxB, cyB):
    return tuple(_fields(cen_A, 1))


# -- row 5 --------------------------------------------------------------------

@torch.library.custom_op("priorflow::dccl_cross_coords", mutates_args=(),
                         device_types="cpu", tags=_TAGS)
def dccl_cross_coords(cen_A: Tensor, cen_B: Tensor, grid_A: Tensor,
                      grid_B: Tensor, scales: list[float]
                      ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Both branches' cross tap coords at every level: (xA, yA, xB, yB),
    each (L*N, 81) f32 for N centres (the arguments of
    ``dccl_coords.dccl_cross_coords_plain``)."""
    return dccl_cross_coords_plain(cen_A, cen_B, grid_A, grid_B, scales)


@dccl_cross_coords.register_kernel("cuda")
def _(cen_A, cen_B, grid_A, grid_B, scales):
    return _cross_coords(cen_A, cen_B, grid_A, grid_B, scales)


@dccl_cross_coords.register_fake
def _(cen_A, cen_B, grid_A, grid_B, scales):
    n = len(scales) * (cen_A.numel() // 2)
    return tuple(cen_A.new_empty((n, NTAP)) for _ in range(4))


# -- row 2 --------------------------------------------------------------------

@torch.library.custom_op("priorflow::instance_norm_sums", mutates_args=(),
                         device_types="cpu", tags=_TAGS)
def instance_norm_sums(x: Tensor, y: Tensor) -> tuple[Tensor, Tensor]:
    """Per-(sample, channel) f32 sums of y and x*y over H*W of NCHW
    inputs, accumulated in f64: two (B, C) f32 tensors."""
    return instance_norm_sums_plain(x, y)


@instance_norm_sums.register_kernel("cuda")
def _(x, y):
    return _sums(x, y)


@instance_norm_sums.register_fake
def _(x, y):
    return tuple(x.new_empty(x.shape[:2], dtype=torch.float32)
                 for _ in range(2))


OPS = (dccl_lookup_levels, instance_norm_sums, dccl_level_lookup_coords,
       dccl_cross_coords)
