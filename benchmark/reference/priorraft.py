"""Frozen plain PriOr-RAFT: the dual-branch RAFT of PriOr-Flow (arXiv
2506.23897) with the Dual-Cost Collaborative Lookup (DCCL) and the
orthogonal-view-driven update (ODDC), weights read from a state dict in
the reference layout (``fnet``, ``cnet``, ``ODDC``, ``update_block``).

Departures from the paper's own code, each also what the program does:
the cross taps of DCCL are read from the 1/8 world-to-camera grid at the
level-scaled window and not rescaled per level; wrapped reads at x in
(W-1, W) blend toward zero, not column 0.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from . import geometry
from .common import (Arith, basic_encoder, bilinear, conv, correlation_pyramid,
                     identity, sample_per_query, update_heads, upsample_convex,
                     window, basic_update)

HIDDEN = 128


def param_spec(cfg) -> list:
    """[(name, shape)] of every tensor of the state dict, in order; a name
    ending in ``running_mean`` / ``running_var`` is a buffer."""
    spec = encoder_spec("fnet", cfg["fnet_dim"], norm=False)
    spec += encoder_spec("cnet", cfg["hidden_dim"] + cfg["context_dim"], norm=True)
    planes = cfg["corr_levels"] * (2 * cfg["corr_radius"] + 1) ** 2
    spec += motion_spec("ODDC.encoder", planes, multi=True)
    spec += heads_spec("ODDC", cfg["hidden_dim"])
    spec += motion_spec("update_block.encoder", planes, multi=False)
    spec += heads_spec("update_block", cfg["hidden_dim"])
    return spec


def _conv(name, cin, cout, kh, kw=None):
    return [(name + ".weight", (cout, cin, kh, kw or kh)), (name + ".bias", (cout,))]


def _bn(name, c):
    return [(f"{name}.{k}", (c,)) for k in ("weight", "bias", "running_mean", "running_var")]


def encoder_spec(p, out_dim, norm: bool):
    spec = _conv(p + ".conv1", 3, 64, 7) + (_bn(p + ".norm1", 64) if norm else [])
    cin = 64
    for i, (_, cout, stride) in enumerate(((64, 64, 1), (64, 96, 2), (96, 128, 2)), 1):
        for j in range(2):
            b = f"{p}.layer{i}.{j}"
            s = stride if j == 0 else 1
            spec += _conv(b + ".conv1", cin, cout, 3) + _conv(b + ".conv2", cout, cout, 3)
            if norm:
                spec += _bn(b + ".norm1", cout) + _bn(b + ".norm2", cout)
                if s != 1:
                    spec += _bn(b + ".norm3", cout)
            if s != 1:
                spec += _conv(b + ".downsample.0", cin, cout, 1)
                if norm:
                    spec += _bn(b + ".downsample.1", cout)
            cin = cout
    return spec + _conv(p + ".conv2", 128, out_dim, 1)


def motion_spec(p, planes, multi: bool):
    if multi:
        return (_conv(p + ".convc1_A", planes, 256, 1) + _conv(p + ".convc2_A", 256, 128, 3)
                + _conv(p + ".convf1_A", 2, 128, 7) + _conv(p + ".convf2_A", 128, 64, 3)
                + _conv(p + ".convf1_B", 2, 128, 7) + _conv(p + ".convf2_B", 128, 64, 3)
                + _conv(p + ".conv_conf1", 8, 32, 3) + _conv(p + ".conv_conf2", 32, 16, 3)
                + _conv(p + ".conv_A", 128 + 64 + 64 + 16, 124, 3))
    return (_conv(p + ".convc1", planes, 256, 1) + _conv(p + ".convc2", 256, 192, 3)
            + _conv(p + ".convf1", 2, 128, 7) + _conv(p + ".convf2", 128, 64, 3)
            + _conv(p + ".conv", 256, 126, 3))


def heads_spec(p, hd):
    cin = hd + 128 + hd
    spec = []
    for k, (kh, kw) in (("1", (1, 5)), ("2", (5, 1))):
        for g in ("z", "r", "q"):
            spec += _conv(f"{p}.gru.conv{g}{k}", cin, hd, kh, kw)
    spec += _conv(p + ".flow_head.conv1", hd, 256, 3) + _conv(p + ".flow_head.conv2", 256, 2, 3)
    return spec + _conv(p + ".mask.0", hd, 256, 3) + _conv(p + ".mask.2", 256, 576, 1)


def multi_update(sd, p, net, inp, flow_A, corr_A, flaw_A, flow_B_A, flaw_B_A, with_mask, ar):
    e = p + ".encoder"
    relu = F.relu
    cor = relu(conv(sd, e + ".convc2_A", relu(conv(sd, e + ".convc1_A", corr_A, ar, 1, 0)), ar))
    flo_A = relu(conv(sd, e + ".convf2_A", relu(conv(sd, e + ".convf1_A", flow_A, ar)), ar))
    flo_B = relu(conv(sd, e + ".convf2_B", relu(conv(sd, e + ".convf1_B", flow_B_A, ar)), ar))
    cf = relu(conv(sd, e + ".conv_conf1", torch.cat([flaw_A, flaw_B_A], dim=1), ar))
    cf = relu(conv(sd, e + ".conv_conf2", cf, ar))
    out = relu(conv(sd, e + ".conv_A", torch.cat([cor, flo_A, flo_B, cf], dim=1), ar))
    motion = torch.cat([out, flow_A, flow_B_A], dim=1)
    return update_heads(sd, p, net, inp, motion, with_mask, ar)


def flaw(f1, f2, groups=4):
    """Per-group mean of the products of two channels-last feature maps."""
    B, h, w, C = f1.shape
    return (f1 * f2).reshape(B, h, w, groups, C // groups).mean(dim=-1)


def dccl(coords, pyr_own, pyr_other, grid_w2c, grid_back, radius):
    """One branch's summed own and back-rotated cross lookups over every
    level: coords (B, h, w, 2) -> (B, h, w, L*(2r+1)^2)."""
    B, h, w, _ = coords.shape
    d = window(radius, coords.device)
    cq = coords.reshape(B, h * w, 1, 2)
    gw = grid_w2c[None].expand(B, -1, -1, -1)
    own, cross = [], []
    for i in range(len(pyr_own)):
        win = cq / 2.0 ** i + d                                  # (B, Q, K, 2)
        own.append(sample_per_query(pyr_own[i], win, wrap_x=True))
        other = bilinear(gw, win, wrap_x=True)                    # (B, Q, K, 2)
        cross.append(sample_per_query(pyr_other[i], other, wrap_x=True))
    own = torch.cat(own, -1).reshape(B, h, w, -1)
    cross = torch.cat(cross, -1).reshape(B, h, w, -1)
    cross = bilinear(cross, grid_back[None].expand(B, -1, -1, -1), wrap_x=True)
    return own + cross


def forward(sd, cfg, image1, image2, iters, ar: Arith = None):
    """image1, image2 (B, H, W, 3) in [0, 255] -> test mode's final
    upsampled branch-A flow (B, H, W, 2)."""
    ar = ar or Arith()
    B, H, W, _ = image1.shape
    dev = image1.device
    g = geometry.grids(H, W, dev)
    hd, r, L = cfg["hidden_dim"], cfg["corr_radius"], cfg["corr_levels"]
    i1A = 2.0 * (image1.float() / 255.0) - 1.0
    i2A = 2.0 * (image2.float() / 255.0) - 1.0
    rot = bilinear(torch.cat([i1A, i2A], -1), g["a2b"][None].expand(B, -1, -1, -1), wrap_x=True)
    i1B, i2B = rot[..., :3], rot[..., 3:]
    nchw = lambda t: t.permute(0, 3, 1, 2).contiguous()
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    c = basic_encoder(sd, "cnet", torch.cat([nchw(i1A), nchw(i1B)]), "batch", ar)
    f = basic_encoder(sd, "fnet", torch.cat([nchw(v) for v in (i1A, i2A, i1B, i2B)]),
                      "instance", ar)
    cA, cB = c[:B], c[B:]
    f1A, f2A, f1B, f2B = (nhwc(f[k * B:(k + 1) * B]).contiguous() for k in range(4))
    net_A, inp_A = torch.tanh(cA[:, :hd]), F.relu(cA[:, hd:])
    net_B, inp_B = torch.tanh(cB[:, :hd]), F.relu(cB[:, hd:])
    pyr_A = correlation_pyramid(f1A, f2A, L, ar)
    pyr_B = correlation_pyramid(f1B, f2B, L, ar)
    h8, w8 = H // 8, W // 8
    c0 = identity(h8, w8, dev)[None].expand(B, -1, -1, -1)
    c1A, c1B = c0, c0
    for it in range(iters):
        last = it == iters - 1
        corr_A = dccl(c1A, pyr_A, pyr_B, g["a2b_w2c_8"], g["b2a_8"], r)
        corr_B = dccl(c1B, pyr_B, pyr_A, g["b2a_w2c_8"], g["a2b_8"], r)
        flow_A = c1A - c0
        flaw_A = flaw(f1A, bilinear(f2A, c1A, wrap_x=True))
        flow_B = c1B - c0
        flow_B_A = geometry.rotate_flow(flow_B, g["b2a_w2c_8"], g["b2a_8"])
        flaw_B_A = flaw(f1A, bilinear(f2A, c0 + flow_B_A, wrap_x=True))
        net_A, mask_A, d_A = multi_update(
            sd, "ODDC", net_A, inp_A, nchw(flow_A), nchw(corr_A), nchw(flaw_A),
            nchw(flow_B_A), nchw(flaw_B_A), last, ar)
        net_B, _, d_B = basic_update(sd, "update_block", net_B, inp_B, nchw(corr_B),
                                     nchw(flow_B), False, ar)
        c1A = c1A + nhwc(d_A)
        c1B = c1B + nhwc(d_B)
    return upsample_convex(c1A - c0, nhwc(mask_A))
