"""PriOr-RAFT, test-mode forward (counterpart of
``prior_flow_tpu/models/prior_raft.py``).

Inputs are uint8-range RGB images (B, H, W, 3) in [0, 255], channels-last
as in the JAX package; the output is the final upsampled branch-A flow
(B, H, W, 2). Inside, the networks run NCHW; coordinates, flows, flaw maps
and lookups stay channels-last, the layout the samplers take.

Mixed precision: ``torch.autocast(bfloat16)`` around the networks only.
Feature maps, the volume matmul, the lookups and the flaw maps stay f32,
and the pyramid is stored in bf16 (``prior_raft.py:385``), the split the
JAX package makes. The training forward, ``DCCLOnTheFly`` and the deferred
and taped gradient paths are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..geometry import grids as gridlib
from ..nn.encoder import BasicEncoder
from ..nn.update import BasicMultiUpdateBlock, BasicUpdateBlock
from ..ops.corr import (DCCLFused, all_pairs_correlation, build_pyramid,
                        groupwise_corr)
from ..ops.samplers import cycle_bilinear_sample
from ..ops.warp import flo_rotate, img_rotate


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


class PriOrRAFT(nn.Module):
    """Dual-branch RAFT with DCCL and ODDC; attribute names are the
    reference's (``fnet``, ``cnet``, ``ODDC``, ``update_block``)."""

    def __init__(self, hidden_dim: int = 128, context_dim: int = 128,
                 corr_levels: int = 4, corr_radius: int = 4,
                 dropout: float = 0.0, mixed_precision: bool = False):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.corr_levels = corr_levels
        self.mixed_precision = mixed_precision
        corr_planes = corr_levels * (2 * corr_radius + 1) ** 2
        # dropout acts only in training (not ported); kept for the
        # reference's constructor and the demo's flag
        self.dropout = dropout
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(hidden_dim + context_dim, "batch")
        self.ODDC = BasicMultiUpdateBlock(hidden_dim, corr_planes)
        self.update_block = BasicUpdateBlock(hidden_dim, corr_planes)
        self.dccl = DCCLFused(corr_levels, corr_radius)
        self._grids = {}

    def _autocast(self, device):
        return torch.autocast(device.type, dtype=torch.bfloat16,
                              enabled=self.mixed_precision)

    def rotation_grids(self, H: int, W: int, device) -> gridlib.RotationGrids:
        """The (H, W) grid bundle on ``device``, copied there once."""
        key = (H, W, str(device))
        if key not in self._grids:
            self._grids[key] = gridlib.rotation_grids(H, W).to_device(device)
        return self._grids[key]

    def encode(self, image1, image2, g: gridlib.RotationGrids):
        """Normalisation, orthogonal view and both encoders
        (``prior_raft.py:342``). Returns NCHW ``net_A, net_B, inp_A,
        inp_B`` and the channels-last f32 fmaps (fmap1_A, fmap2_A, fmap1_B,
        fmap2_B)."""
        image1_A = 2.0 * (image1 / 255.0) - 1.0
        image2_A = 2.0 * (image2 / 255.0) - 1.0
        rotated = img_rotate(torch.cat([image1_A, image2_A], dim=-1), g.a2b)
        image1_B, image2_B = rotated[..., :3], rotated[..., 3:]
        views = [_nchw(v).contiguous()
                 for v in (image1_A, image2_A, image1_B, image2_B)]
        with self._autocast(image1.device):
            cnet_A, cnet_B = self.cnet([views[0], views[2]])
            fmaps = self.fnet(views)
        hd = self.hidden_dim
        net_A, inp_A = torch.tanh(cnet_A[:, :hd]), F.relu(cnet_A[:, hd:])
        net_B, inp_B = torch.tanh(cnet_B[:, :hd]), F.relu(cnet_B[:, hd:])
        fmaps = tuple(_nhwc(f.float()).contiguous() for f in fmaps)
        return net_A, net_B, inp_A, inp_B, fmaps

    @torch.no_grad()
    def forward(self, image1, image2, iters: int = 12,
                init_flow: Optional[torch.Tensor] = None,
                test_mode: bool = True):
        if not test_mode:
            raise NotImplementedError("only the test-mode forward is ported")
        if iters < 1:
            raise ValueError("iters must be at least 1")
        B, H, W, _ = image1.shape
        dev = image1.device
        g = self.rotation_grids(H, W, dev)
        net_A, net_B, inp_A, inp_B, fmaps = self.encode(image1, image2, g)
        fmap1_A, fmap2_A, fmap1_B, fmap2_B = fmaps

        corr_dtype = torch.bfloat16 if self.mixed_precision else torch.float32
        pyr_A = [p.to(corr_dtype).contiguous() for p in build_pyramid(
            all_pairs_correlation(fmap1_A, fmap2_A), self.corr_levels)]
        pyr_B = [p.to(corr_dtype).contiguous() for p in build_pyramid(
            all_pairs_correlation(fmap1_B, fmap2_B), self.corr_levels)]

        h8, w8 = H // 8, W // 8
        coords0 = gridlib.identity_grid_on(h8, w8, dev).expand(B, h8, w8, 2)
        coords1_A = coords0
        coords1_B = coords0
        if init_flow is not None:
            coords1_A = coords1_A + init_flow
            coords1_B = coords1_B + flo_rotate(init_flow, g.a2b_w2c_8, g.a2b_8)

        up_mask_A = None
        for it in range(iters):
            flow_A = coords1_A - coords0
            warped_A = cycle_bilinear_sample(fmap2_A, coords1_A)
            flaw_A = groupwise_corr(fmap1_A, warped_A, num_groups=4)

            flow_B = coords1_B - coords0
            flow_B_A = flo_rotate(flow_B, g.b2a_w2c_8, g.b2a_8)
            warped_B_A = cycle_bilinear_sample(fmap2_A, coords0 + flow_B_A)
            flaw_B_A = groupwise_corr(fmap1_A, warped_B_A, num_groups=4)

            own_A, cross_A, own_B, cross_B = self.dccl(
                coords1_A, coords1_B, pyr_A, pyr_B,
                g.a2b_w2c_8, g.b2a_w2c_8, g.a2b_8, g.b2a_8)

            last = it == iters - 1
            with self._autocast(dev):
                net_A, mask_A, delta_A = self.ODDC(
                    net_A, inp_A, _nchw(flow_A), _nchw(own_A + cross_A),
                    _nchw(flaw_A), _nchw(flow_B_A), _nchw(flaw_B_A),
                    with_mask=last)
                net_B, _, delta_B = self.update_block(
                    net_B, inp_B, _nchw(own_B + cross_B), _nchw(flow_B),
                    with_mask=False)
            coords1_A = coords1_A + _nhwc(delta_A)
            coords1_B = coords1_B + _nhwc(delta_B)
            if last:
                up_mask_A = _nhwc(mask_A)

        return upsample_flow_convex(coords1_A - coords0, up_mask_A)
