"""PriOr-RAFT (counterpart of ``prior_flow_tpu/models/prior_raft.py``).

Inputs are uint8-range RGB images (B, H, W, 3) in [0, 255], channels-last
as in the JAX package. ``test_mode=True`` returns the final upsampled
branch-A flow (B, H, W, 2), under no_grad; ``test_mode=False`` is the
training forward and returns both branches' per-iteration upsampled flows
stacked as (iters, B, H, W, 2), differentiable. ``encode`` and
``iterate_taped`` are the pieces of the taped backward
(``train/trainer.py::taped_value_and_grad``). Inside, the networks run
NCHW; coordinates, flows, flaw maps and lookups stay channels-last, the
layout the samplers take.

Mixed precision: ``torch.autocast(bfloat16)`` around the networks only.
Feature maps, the volume matmul, the lookups and the flaw maps stay f32,
and the pyramid is stored in bf16 (``prior_raft.py:385``), the split the
JAX package makes. Above ``LEAN_BUILD_QUERIES`` 1/8 queries (as at
1024x2048) the pyramids are built in query chunks
(``ops.corr.build_pyramid_lean``, ``prior_raft.py:394-409``), and there
the 1/8 grid is wider than 128 columns, so ``DCCLFused`` takes its planes
route. ``DCCLOnTheFly``, the two-scan ``deferred_vol_grad`` path and
rematerialisation are not ported.

Dropout (``dropout`` > 0) acts in the encoders of the training forward
only, in train mode, and draws from the ``generator`` the caller passes
(the trainer keys one by (seed, step)); a training forward in train mode
without one raises. Test-mode forwards and eval mode never drop.

Precision (``prior_raft.py:142-144``): ``precision=None`` runs under
torch's backend flags as the caller left them (torch's default lets cuDNN
convolutions use TF32); ``"highest"`` runs the forward, and a training
step (``train/trainer.py``), with TF32 off for cuDNN convolutions and for
matmuls, as JAX's ``jax.default_matmul_precision('highest')`` does, then
puts the caller's flags back.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..geometry import grids as gridlib
from ..nn.encoder import BasicEncoder
from ..nn.update import BasicMultiUpdateBlock, BasicUpdateBlock
from ..ops.corr import (DCCLFused, all_pairs_correlation, build_pyramid,
                        build_pyramid_lean, groupwise_corr)
from ..ops.samplers import cycle_bilinear_sample
from ..ops.warp import flo_rotate, img_rotate
from ..utils.precision import check_precision, precision_scope


# above this many 1/8 queries (H*W/64) the pyramids are built in query
# chunks, as in the JAX package (``prior_raft.py:394``): the dense build's
# f32 volume and f32 pyramid would not fit beside each other before the
# cast on the device the JAX package sized it for
LEAN_BUILD_QUERIES = 16384


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor):
    """Convex-combination 8x upsampling (``prior_raft.py:58``).

    flow: (B, h, w, 2); mask: (B, h, w, 576) ordered (9, 8, 8) channel-major
    -> (B, 8h, 8w, 2). Neighbourhoods in F.unfold order k = ky*3 + kx.
    """
    B, h, w, C = flow.shape
    m = mask.permute(0, 3, 1, 2).float().reshape(B, 1, 9, 8, 8, h, w)
    m = torch.softmax(m, dim=2)
    f = (8.0 * flow).permute(0, 3, 1, 2).float()
    neigh = F.unfold(f, [3, 3], padding=1).reshape(B, C, 9, 1, 1, h, w)
    up = torch.sum(m * neigh, dim=2)                      # (B, C, 8, 8, h, w)
    up = up.permute(0, 4, 2, 5, 3, 1)                     # (B, h, 8, w, 8, C)
    return up.reshape(B, 8 * h, 8 * w, C).to(flow.dtype)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class StepConsts(NamedTuple):
    """Loop-invariant inputs of every GRU iteration."""

    inp_A: torch.Tensor
    inp_B: torch.Tensor
    fmap1_A: torch.Tensor
    fmap2_A: torch.Tensor
    coords0: torch.Tensor
    grids: gridlib.RotationGrids


class PriOrRAFT(nn.Module):
    """Dual-branch RAFT with DCCL and ODDC; attribute names are the
    reference's (``fnet``, ``cnet``, ``ODDC``, ``update_block``)."""

    def __init__(self, hidden_dim: int = 128, context_dim: int = 128,
                 corr_levels: int = 4, corr_radius: int = 4,
                 dropout: float = 0.0, mixed_precision: bool = False,
                 precision: Optional[str] = None):
        super().__init__()
        check_precision(precision)
        self.precision = precision
        self.hidden_dim = hidden_dim
        self.corr_levels = corr_levels
        self.mixed_precision = mixed_precision
        corr_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.dropout = dropout
        self.fnet = BasicEncoder(256, "instance", dropout=dropout)
        self.cnet = BasicEncoder(hidden_dim + context_dim, "batch",
                                 dropout=dropout)
        self.ODDC = BasicMultiUpdateBlock(hidden_dim, corr_planes)
        self.update_block = BasicUpdateBlock(hidden_dim, corr_planes)
        self.dccl = DCCLFused(corr_levels, corr_radius)
        self._grids = {}

    def _autocast(self, device):
        return torch.autocast(device.type, dtype=torch.bfloat16,
                              enabled=self.mixed_precision)

    def dropout_generator(self, generator):
        """The generator a training forward's encoders drop out from:
        ``generator`` in train mode with dropout on, else None."""
        if not (self.training and self.dropout > 0):
            return None
        if generator is None:
            raise ValueError("dropout in training draws from an explicit "
                             "generator: pass generator=")
        return generator

    def rotation_grids(self, H: int, W: int, device) -> gridlib.RotationGrids:
        """The (H, W) grid bundle on ``device``, copied there once."""
        key = (H, W, str(device))
        if key not in self._grids:
            self._grids[key] = gridlib.rotation_grids(H, W).to_device(device)
        return self._grids[key]

    def encode(self, image1, image2, g: gridlib.RotationGrids,
               generator=None):
        """Normalisation, orthogonal view and both encoders
        (``prior_raft.py:342``). Returns NCHW ``net_A, net_B, inp_A,
        inp_B`` and the channels-last f32 fmaps (fmap1_A, fmap2_A, fmap1_B,
        fmap2_B). Given a ``generator`` (``dropout_generator``'s), the
        encoders drop out from it, the context encoder first."""
        image1_A = 2.0 * (image1 / 255.0) - 1.0
        image2_A = 2.0 * (image2 / 255.0) - 1.0
        rotated = img_rotate(torch.cat([image1_A, image2_A], dim=-1), g.a2b)
        image1_B, image2_B = rotated[..., :3], rotated[..., 3:]
        views = [_nchw(v).contiguous()
                 for v in (image1_A, image2_A, image1_B, image2_B)]
        with self._autocast(image1.device):
            cnet_A, cnet_B = self.cnet([views[0], views[2]], generator)
            fmaps = self.fnet(views, generator)
        hd = self.hidden_dim
        net_A, inp_A = torch.tanh(cnet_A[:, :hd]), F.relu(cnet_A[:, hd:])
        net_B, inp_B = torch.tanh(cnet_B[:, :hd]), F.relu(cnet_B[:, hd:])
        fmaps = tuple(_nhwc(f.float()).contiguous() for f in fmaps)
        return net_A, net_B, inp_A, inp_B, fmaps

    def build_pyramids(self, fmaps):
        """Both branches' 4-level pyramids from the channels-last fmaps,
        stored in bf16 under mixed precision (``prior_raft.py:385``), built
        in query chunks above ``LEAN_BUILD_QUERIES`` queries
        (``prior_raft.py:394-414``; the same bits as the dense build);
        differentiable when autograd records."""
        fmap1_A, fmap2_A, fmap1_B, fmap2_B = fmaps
        dt = torch.bfloat16 if self.mixed_precision else torch.float32
        pairs = ((fmap1_A, fmap2_A), (fmap1_B, fmap2_B))
        _, h8, w8, _ = fmap1_A.shape
        if h8 * w8 > LEAN_BUILD_QUERIES:
            return tuple(build_pyramid_lean(f1, f2, self.corr_levels, dt)
                         for f1, f2 in pairs)
        return tuple([p.to(dt).contiguous() for p in build_pyramid(
            all_pairs_correlation(f1, f2), self.corr_levels)]
            for f1, f2 in pairs)

    def _step(self, net_A, net_B, coords1_A, coords1_B, k: StepConsts,
              corr_fn, mask_A: bool, mask_B: bool):
        """One GRU iteration (``prior_raft.py:193-277``). ``corr_fn(c_A,
        c_B)`` returns both branches' summed own + cross fields. The coords
        are detached first (``:215,220``): no gradient runs along the
        trajectory."""
        g = k.grids
        coords1_A = coords1_A.detach()
        coords1_B = coords1_B.detach()
        flow_A = coords1_A - k.coords0
        warped_A = cycle_bilinear_sample(k.fmap2_A, coords1_A)
        flaw_A = groupwise_corr(k.fmap1_A, warped_A, num_groups=4)

        flow_B = coords1_B - k.coords0
        flow_B_A = flo_rotate(flow_B, g.b2a_w2c_8, g.b2a_8)
        warped_B_A = cycle_bilinear_sample(k.fmap2_A, k.coords0 + flow_B_A)
        flaw_B_A = groupwise_corr(k.fmap1_A, warped_B_A, num_groups=4)

        corr_A, corr_B = corr_fn(coords1_A, coords1_B)
        with self._autocast(coords1_A.device):
            net_A, up_mask_A, delta_A = self.ODDC(
                net_A, k.inp_A, _nchw(flow_A), _nchw(corr_A), _nchw(flaw_A),
                _nchw(flow_B_A), _nchw(flaw_B_A), with_mask=mask_A)
            net_B, up_mask_B, delta_B = self.update_block(
                net_B, k.inp_B, _nchw(corr_B), _nchw(flow_B),
                with_mask=mask_B)
        return (net_A, net_B, coords1_A + _nhwc(delta_A),
                coords1_B + _nhwc(delta_B), up_mask_A, up_mask_B)

    def _recur(self, net_A, net_B, coords1_A, coords1_B, k: StepConsts,
               corr_fn, iters: int, train: bool):
        """The GRU loop. ``train``: both mask heads every iteration and
        both branches upsampled each time, stacked (iters, B, H, W, 2)
        (``_step``, ``prior_raft.py:279-287``); otherwise only branch A's
        last mask and one final upsample (``_step_test``)."""
        preds_A, preds_B, mask = [], [], None
        for it in range(iters):
            last = it == iters - 1
            net_A, net_B, coords1_A, coords1_B, mask_A, mask_B = self._step(
                net_A, net_B, coords1_A, coords1_B, k, corr_fn,
                mask_A=train or last, mask_B=train)
            if train:
                preds_A.append(upsample_flow_convex(coords1_A - k.coords0,
                                                    _nhwc(mask_A)))
                preds_B.append(upsample_flow_convex(coords1_B - k.coords0,
                                                    _nhwc(mask_B)))
            elif last:
                mask = _nhwc(mask_A)
        if train:
            return torch.stack(preds_A), torch.stack(preds_B)
        return upsample_flow_convex(coords1_A - k.coords0, mask)

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
                 generator=None):
        B, H, W, _ = image1.shape
        dev = image1.device
        g = self.rotation_grids(H, W, dev)
        net_A, net_B, inp_A, inp_B, fmaps = self.encode(
            image1, image2, g,
            self.dropout_generator(generator) if train else None)
        pyr_A, pyr_B = self.build_pyramids(fmaps)

        h8, w8 = H // 8, W // 8
        coords0 = gridlib.identity_grid_on(h8, w8, dev).expand(B, h8, w8, 2)
        coords1_A = coords0
        coords1_B = coords0
        if init_flow is not None:
            coords1_A = coords1_A + init_flow
            coords1_B = coords1_B + flo_rotate(init_flow, g.a2b_w2c_8, g.a2b_8)

        def corr_fn(c_A, c_B):
            own_A, cross_A, own_B, cross_B = self.dccl(
                c_A, c_B, pyr_A, pyr_B, g.a2b_w2c_8, g.b2a_w2c_8, g.a2b_8,
                g.b2a_8)
            return own_A + cross_A, own_B + cross_B

        k = StepConsts(inp_A, inp_B, fmaps[0], fmaps[1], coords0, g)
        return self._recur(net_A, net_B, coords1_A, coords1_B, k, corr_fn,
                           iters, train)

    def iterate_taped(self, net_A, net_B, inp_A, inp_B, fmap1_A, fmap2_A,
                      pyr_A, pyr_B, iters: int = 12):
        """GRU loop of the taped backward (``prior_raft.py:542-587``).

        The standard differentiable recurrence, except that the lookups run
        primal-only on the (detached) pyramids through ``DCCLFused.record``
        and each iteration's summed fields become autograd leaves: after
        ``backward`` their ``.grad`` holds exactly the per-iteration field
        cotangents that one stacked scatter per level and branch turns into
        the volume cotangents. Returns ``((preds_A, preds_B), (fields_A,
        fields_B), (cen_A, cen_B))``: stacked (iters, B, H, W, 2) flows, the
        lists of field leaves (B, h8, w8, L*81), and the stacked
        (iters, B, Q, 2) centres."""
        B, _, h8, w8 = net_A.shape
        g = self.rotation_grids(8 * h8, 8 * w8, net_A.device)
        coords0 = gridlib.identity_grid_on(h8, w8, net_A.device).expand(
            B, h8, w8, 2)
        pyr_A = [p.detach() for p in pyr_A]
        pyr_B = [p.detach() for p in pyr_B]
        fields_A, fields_B, cens_A, cens_B = [], [], [], []

        def corr_fn(c_A, c_B):
            (f_A, f_B), (cen_A, cen_B) = self.dccl.record(
                c_A, c_B, pyr_A, pyr_B, g.a2b_w2c_8, g.b2a_w2c_8, g.a2b_8,
                g.b2a_8)
            fields_A.append(f_A.requires_grad_())
            fields_B.append(f_B.requires_grad_())
            cens_A.append(cen_A)
            cens_B.append(cen_B)
            return f_A, f_B

        k = StepConsts(inp_A, inp_B, fmap1_A, fmap2_A, coords0, g)
        preds = self._recur(net_A, net_B, coords0, coords0, k, corr_fn,
                            iters, train=True)
        return (preds, (fields_A, fields_B),
                (torch.stack(cens_A), torch.stack(cens_B)))
