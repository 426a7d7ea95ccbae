"""Bilinear samplers with the reference's three boundary semantics
(counterpart of ``prior_flow_tpu/ops/samplers.py``).

1. ``bilinear_sample``: ``grid_sample(align_corners=True)`` with zero
   padding, in pixel coordinates.
2. ``cycle_bilinear_sample``: the same after x is wrapped mod W. After the
   wrap, x in (W-1, W) still blends toward the zero pad beyond the last
   column, not toward column 0 (the reference's seam quirk, kept on
   purpose), and an x that rounds to exactly W samples zero.
3. ``cycle_grid_sample``: true longitude wrap (x1 = (x0+1) % W), latitude
   clamp, and the ``adjust_sample_m`` fix when the payload is itself a
   coordinate grid (``is_grid``).

All math is in pixel coordinates. ``F.grid_sample`` is not used: its
normalisation divides by H-1, which is 0 on the 1-row pyramid levels of
small inputs. Images are channels-last ``(B, H, W, C)``; coordinates are
``(B, ..., 2)`` with ``[..., 0] = x`` and ``[..., 1] = y``; outputs are
``(B, ..., C)``.

Backward: autograd of the gathers, the exact VJP (a gather's transpose is
a scatter-add with the same corner weights); the JAX package's
transpose-plan machinery only avoids XLA:TPU scatters.
"""

from __future__ import annotations

import torch


def _gather_2d(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor):
    """img[b, iy, ix, :] for integer index tensors of shape (B, Q)."""
    B, H, W, C = img.shape
    flat = img.reshape(B, H * W, C)
    idx = (iy * W + ix).unsqueeze(-1).expand(-1, -1, C)
    return torch.gather(flat, 1, idx)


def _bilinear_core(img, x, y):
    """align_corners=True bilinear, zero outside [0, W-1] x [0, H-1].

    x, y: (B, Q) float pixel coordinates -> (B, Q, C). The four corner terms
    are summed in the order (dy, dx) = 00, 01, 10, 11, as in the JAX
    sampler (``prior_flow_tpu/ops/samplers.py:38``) and in the DCCL kernel.
    An empty image (the 1/64 pyramid level of a 32-pixel-high input has no
    rows) samples zero everywhere, as in JAX.
    """
    B, H, W, C = img.shape
    if H * W == 0:
        return img.new_zeros((B, x.shape[1], C)) + 0.0 * x.unsqueeze(-1)
    out = None
    for ix, iy, wgt in bilinear_corners(x, y, H, W):
        term = _gather_2d(img, ix, iy) * wgt.unsqueeze(-1)
        out = term if out is None else out + term
    return out


def bilinear_corners(x, y, H: int, W: int):
    """The four corners of the align_corners=True bilinear read at pixel
    coordinates (x, y) of an H x W image, in the order (dy, dx) = 00, 01,
    10, 11: (ix, iy, weight), the indices clamped into the image, the
    weight 0 where the corner lies outside it."""
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
            yield (torch.clamp(cx, 0, W - 1).long(),
                   torch.clamp(cy, 0, H - 1).long(), wgt * valid)


def _flatten_coords(coords):
    lead = coords.shape[:-1]
    return coords.reshape(lead[0], -1, 2), lead


def bilinear_sample(img, coords, mask: bool = False):
    """``grid_sample(align_corners=True, padding_mode='zeros')`` in pixel
    coordinates (``prior_flow_tpu/ops/samplers.py:117``). With ``mask=True``
    it also returns the in-bounds mask the reference computes: strict
    inequalities on the normalised coordinates, in the image's dtype."""
    H, W = img.shape[1], img.shape[2]
    flat, lead = _flatten_coords(coords)
    x, y = flat[..., 0], flat[..., 1]
    out = _bilinear_core(img, x, y).reshape(*lead, img.shape[-1])
    if not mask:
        return out
    xn = 2 * x / (W - 1) - 1
    yn = 2 * y / (H - 1) - 1
    m = ((xn > -1) & (xn < 1) & (yn > -1) & (yn < 1)).to(img.dtype)
    return out, m.reshape(*lead)


def _wrap_x(coords, W: int):
    return torch.stack([torch.remainder(coords[..., 0], W), coords[..., 1]],
                       dim=-1)


def cycle_bilinear_sample(img, coords, mask: bool = False):
    """``bilinear_sample`` with x wrapped mod W first
    (``prior_flow_tpu/ops/samplers.py:139``)."""
    return bilinear_sample(img, _wrap_x(coords, img.shape[2]), mask=mask)


def _binarised_ones(img, coords):
    """The reference's validity mask: an all-ones image resampled at
    ``coords``, 0 below 0.9999 and 1 elsewhere."""
    m = bilinear_sample(torch.ones_like(img), coords)
    return torch.where(m < 0.9999, 0.0, 1.0).to(img.dtype)


def masked_bilinear_interpolate(img, grid):
    """Wrap-x bilinear sample times a binarised validity mask
    (``prior_flow_tpu/ops/samplers.py:220``)."""
    wrapped = _wrap_x(grid, img.shape[2])
    return bilinear_sample(img, wrapped) * _binarised_ones(img, wrapped)


def cycle_interpolate(img, grid, nearest: bool = False):
    """Wrap-aware interpolation over the image with a copy of column 0
    appended (width W + 1), x wrapped mod W, times a binarised validity
    mask; ``nearest=True`` rounds to the nearest pixel instead
    (``prior_flow_tpu/ops/samplers.py:237``)."""
    B, H, W, C = img.shape
    padded = torch.cat([img, img[:, :, :1, :]], dim=2)
    coords = _wrap_x(grid, W)
    if not nearest:
        return bilinear_sample(padded, coords) * _binarised_ones(padded,
                                                                 coords)
    ix = torch.round(coords[..., 0]).long()
    iy = torch.round(coords[..., 1]).long()
    valid = (ix >= 0) & (ix <= W) & (iy >= 0) & (iy <= H - 1)
    ix = torch.clamp(ix, 0, W)
    iy = torch.clamp(iy, 0, H - 1)
    lead = coords.shape[:-1]
    out = _gather_2d(padded, ix.reshape(B, -1), iy.reshape(B, -1))
    return out.reshape(*lead, C) * valid.unsqueeze(-1)


def cycle_grid_sample(img, grid, is_grid: bool = False):
    """Gather bilinear sample with true longitude wrap and pole clamp
    (``prior_flow_tpu/ops/samplers.py:150``).

    With ``is_grid=True`` the payload is a coordinate grid: the x channel of
    the b/c/d corners is re-expressed in the branch of the a corner before
    blending, so interpolation never averages across the +-W seam.
    """
    B, H, W, C = img.shape
    flat, lead = _flatten_coords(grid)
    x = torch.remainder(flat[..., 0], W)
    y = flat[..., 1]
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f

    x0 = x0f.long() % W
    x1 = (x0f.long() + 1) % W
    y0 = torch.clamp(y0f, 0, H - 1).long()
    y1 = torch.clamp(y0f + 1, 0, H - 1).long()

    Ia = _gather_2d(img, x0, y0)
    Ib = _gather_2d(img, x0, y1)
    Ic = _gather_2d(img, x1, y0)
    Id = _gather_2d(img, x1, y1)

    if is_grid:
        half = W / 2.0

        def adjust(I):
            m = Ia[..., 0] + torch.remainder(
                (I[..., 0] - Ia[..., 0]) + half, W) - half
            return torch.cat([m.unsqueeze(-1), I[..., 1:]], dim=-1)

        Ib, Ic, Id = adjust(Ib), adjust(Ic), adjust(Id)

    wa = ((1 - fx) * (1 - fy)).unsqueeze(-1)
    wb = ((1 - fx) * fy).unsqueeze(-1)
    wc = (fx * (1 - fy)).unsqueeze(-1)
    wd = (fx * fy).unsqueeze(-1)
    out = wa * Ia + wb * Ib + wc * Ic + wd * Id
    return out.reshape(*lead, C)
