"""Frozen plain RAFT basic (Teed & Deng, arXiv 2003.12039): one branch,
the all-pairs correlation pyramid read through a (2r+1)^2 window with zero
padding on every side, weights from a state dict in the reference layout
(``fnet``, ``cnet``, ``update_block``)."""

from __future__ import annotations

import torch
from torch.nn import functional as F

from .common import (Arith, basic_encoder, basic_update, correlation_pyramid,
                     identity, sample_per_query, upsample_convex, window)
from .priorraft import encoder_spec, heads_spec, motion_spec


def param_spec(cfg) -> list:
    planes = cfg["corr_levels"] * (2 * cfg["corr_radius"] + 1) ** 2
    return (encoder_spec("fnet", cfg["fnet_dim"], norm=False)
            + encoder_spec("cnet", cfg["hidden_dim"] + cfg["context_dim"], norm=True)
            + motion_spec("update_block.encoder", planes, multi=False)
            + heads_spec("update_block", cfg["hidden_dim"]))


def forward(sd, cfg, image1, image2, iters, ar: Arith = None):
    """Test mode: the last iteration's upsampled flow (B, H, W, 2)."""
    ar = ar or Arith()
    B, H, W, _ = image1.shape
    dev = image1.device
    hd, r, L = cfg["hidden_dim"], cfg["corr_radius"], cfg["corr_levels"]
    nchw = lambda t: t.permute(0, 3, 1, 2).contiguous()
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    i1 = nchw(2.0 * (image1.float() / 255.0) - 1.0)
    i2 = nchw(2.0 * (image2.float() / 255.0) - 1.0)
    c = basic_encoder(sd, "cnet", i1, "batch", ar)
    f = basic_encoder(sd, "fnet", torch.cat([i1, i2]), "instance", ar)
    net, inp = torch.tanh(c[:, :hd]), F.relu(c[:, hd:])
    pyr = correlation_pyramid(nhwc(f[:B]).contiguous(), nhwc(f[B:]).contiguous(), L, ar)
    h8, w8 = H // 8, W // 8
    c0 = identity(h8, w8, dev)[None].expand(B, -1, -1, -1)
    c1 = c0
    d = window(r, dev)
    for it in range(iters):
        last = it == iters - 1
        cq = c1.reshape(B, h8 * w8, 1, 2)
        corr = torch.cat([sample_per_query(pyr[i], cq / 2.0 ** i + d, wrap_x=False)
                          for i in range(L)], -1).reshape(B, h8, w8, -1)
        net, mask, delta = basic_update(sd, "update_block", net, inp, nchw(corr),
                                        nchw(c1 - c0), last, ar)
        c1 = c1 + nhwc(delta)
    return upsample_convex(c1 - c0, nhwc(mask))
