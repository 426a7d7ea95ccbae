"""Single-branch RAFT, the perspective-image model family (counterpart of
``prior_flow_tpu/models/raft.py``): upstream RAFT's architecture with the
plain (non-wrapping) correlation lookup, basic and ``small=True``.

Attribute names are the reference's (``fnet``, ``cnet``, ``update_block``),
so the JAX package's ``export_state_dict`` and upstream ``raft-things``
state dicts load strictly. The forward follows ``PriOrRAFT``'s contract:
uint8-range RGB images (B, H, W, 3); ``test_mode=True`` (the default)
returns the last prediction (B, H, W, 2) under no_grad, ``test_mode=False``
the stacked (iters, B, H, W, 2) predictions, differentiable. Coords are
detached each iteration. Mixed precision is ``torch.autocast(bfloat16)``
around the networks; the fmaps, the dense f32 volume pyramid and its
lookups stay f32, as JAX builds them. As in JAX, ``small=True`` keeps
``corr_radius=4`` (upstream uses 3) and fixes its widths at hidden 96,
context 64. On the card the feature encoder's instance norms run the sums
kernel; the lookup is plain gathers (XLA code in JAX, no Pallas kernel).

Height sharding (``parallel/spatial.py``): inside a ``spatial.scope`` the
forward takes this rank's real rows of each image (any H a multiple of
8 and of S; the strips of ``spatial.shard_rows``, padded on entry as
JAX's partitioner pads an uneven split) and returns its rows of the
flow, as ``PriOrRAFT`` does: the convolutions
and norms exchange rows (the group norm's and the batch statistics' sums
cross ranks), fmap2 is gathered (the volume's targets), the volume rows,
the lookups and ``coords0`` are the rank's queries in global pixels, and
both upsamplers read the rows they need (``upsample_flow_convex`` a
halo, ``upflow8`` the gathered flow).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..geometry import grids as gridlib
from ..nn.encoder import BasicEncoder, SmallEncoder
from ..nn.update import BasicUpdateBlock, SmallUpdateBlock
from ..ops.corr import all_pairs_correlation, build_pyramid
from ..ops.kernels.dccl_lookup import window_delta
from ..ops.samplers import bilinear_sample
from ..ops.warp import upflow8
from ..parallel import spatial
from ..utils.precision import check_precision, precision_scope
from .prior_raft import PriOrRAFT, _nchw, _nhwc, upsample_flow_convex


def corr_block_lookup(pyramid, coords: torch.Tensor, radius: int = 4):
    """Upstream RAFT's window lookup (``prior_flow_tpu/models/raft.py:32``):
    per level a (2r+1)^2 window around the level-scaled coords, bilinear
    with zero padding on every side (``ops.samplers.bilinear_sample``, no
    x wrap). pyramid: (B, Q, Hl, Wl) per level; coords: (B, h, w, 2) ->
    (B, h, w, L*(2r+1)^2) f32, tap k = i*(2r+1) + j at x-offset i-r and
    y-offset j-r."""
    B, h, w, _ = coords.shape
    Q = h * w
    delta = window_delta(radius, coords.device)
    K = delta.shape[0]
    cq = coords.reshape(B, Q, 1, 2)
    out = []
    for i, vol in enumerate(pyramid):
        c = (cq / 2.0 ** i + delta).reshape(B * Q, K, 2)
        Hl, Wl = vol.shape[2:]
        samp = bilinear_sample(vol.reshape(B * Q, Hl, Wl, 1), c)
        out.append(samp.reshape(B, h, w, K))
    return torch.cat(out, dim=-1)


class RAFT(nn.Module):
    """Standard RAFT (``prior_flow_tpu/models/raft.py:55``): basic (hidden
    128, context 128, ``fnet`` 256, instance-normed features, batch-normed
    context, ``BasicUpdateBlock``, convex upsampling) or ``small`` (hidden
    96, context 64, ``fnet`` 128, ``SmallEncoder``s with instance / no
    norm, ``SmallUpdateBlock``, bilinear ``upflow8``). ``precision``,
    ``mixed_precision``, ``dropout`` (and its ``generator``) and
    ``bn_running_average`` act as on ``PriOrRAFT``."""

    def __init__(self, hidden_dim: int = 128, context_dim: int = 128,
                 corr_levels: int = 4, corr_radius: int = 4,
                 dropout: float = 0.0, mixed_precision: bool = False,
                 small: bool = False, bn_running_average: bool = True,
                 precision: Optional[str] = None):
        super().__init__()
        check_precision(precision)
        self.precision = precision
        self.mixed_precision = mixed_precision
        self.dropout = dropout
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        corr_planes = corr_levels * (2 * corr_radius + 1) ** 2
        if small:
            self.hidden_dim, context_dim = 96, 64
            self.fnet = SmallEncoder(128, "instance", dropout)
            self.cnet = SmallEncoder(96 + 64, "none", dropout)
            self.update_block = SmallUpdateBlock(96, corr_planes)
        else:
            self.hidden_dim = hidden_dim
            self.fnet = BasicEncoder(256, "instance", dropout)
            self.cnet = BasicEncoder(hidden_dim + context_dim, "batch",
                                     dropout, bn_running_average)
            self.update_block = BasicUpdateBlock(hidden_dim, corr_planes)

    _autocast = PriOrRAFT._autocast
    dropout_generator = PriOrRAFT.dropout_generator

    def forward(self, image1, image2, iters: int = 12,
                init_flow: Optional[torch.Tensor] = None,
                test_mode: bool = True, generator=None):
        """``generator``: the dropout draws of a training forward
        (``test_mode=False``) in train mode."""
        if iters < 1:
            raise ValueError("iters must be at least 1")
        grad = torch.no_grad() if test_mode else contextlib.nullcontext()
        with precision_scope(self.precision), grad:
            return self._forward(image1, image2, iters, init_flow,
                                 not test_mode, generator)

    def _forward(self, image1, image2, iters, init_flow, train: bool,
                 generator):
        dev = image1.device
        space = spatial.current()
        if space is not None:   # the rank's real rows -> its strip
            space = spatial.enter(image1.shape[1], dev)
            image1, image2 = space.pad(image1, 1), space.pad(image2, 1)
            if init_flow is not None:
                init_flow = space.pad(init_flow, 1, 8)
        B, H, W, _ = image1.shape
        gen = self.dropout_generator(generator) if train else None
        image1 = _nchw(2.0 * (image1 / 255.0) - 1.0).contiguous()
        image2 = _nchw(2.0 * (image2 / 255.0) - 1.0).contiguous()
        with self._autocast(dev):
            cnet = self.cnet(image1, gen)
            fmap1, fmap2 = self.fnet([image1, image2], gen)
        hd = self.hidden_dim
        net, inp = torch.tanh(cnet[:, :hd]), F.relu(cnet[:, hd:])
        if space is not None:   # the targets: fmap2 of the whole image
            fmap2 = spatial.gather_rows(fmap2, 2, space)
        pyramid = build_pyramid(all_pairs_correlation(
            _nhwc(fmap1.float()), _nhwc(fmap2.float())), self.corr_levels)

        h8, w8 = H // 8, W // 8
        if space is None:
            coords0 = gridlib.identity_grid_on(h8, w8, dev)
        else:
            coords0 = spatial.identity_rows(h8, w8, dev, space)
        coords0 = coords0.expand(B, h8, w8, 2)
        coords1 = coords0 if init_flow is None else coords0 + init_flow
        preds = []
        for it in range(iters):
            want = train or it == iters - 1
            coords1 = coords1.detach()
            corr = corr_block_lookup(pyramid, coords1, self.corr_radius)
            flow = coords1 - coords0
            with self._autocast(dev):
                net, mask, delta = self.update_block(
                    net, inp, _nchw(corr), _nchw(flow), with_mask=want)
            coords1 = coords1 + _nhwc(delta)
            if want:
                flow = coords1 - coords0
                preds.append(upflow8(flow) if mask is None
                             else upsample_flow_convex(flow, _nhwc(mask)))
        out = torch.stack(preds) if train else preds[-1]
        # the rank's real rows of the flows
        return out if space is None else space.crop(out, out.dim() - 3)
