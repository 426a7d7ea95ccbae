"""The yardstick's counts: FLOPs of a pair or a step, from the frozen
reference's shapes, and the bytes each port kernel must move at a cell's
shapes, with the table of the card's published peaks.

FLOPs count each convolution (2 x cin x cout x kh x kw per output pixel)
and the all-pairs correlation (2 x C per query-target pair) of a
test-mode forward; samplers, norms, pooling and elementwise ops are left
out, so the count is a floor of the work.
"""

from __future__ import annotations

import torch

from .reference import geometry
from .reference.common import bilinear, identity, window

# NVIDIA H100 SXM data sheet, dense: FLOP/s by arithmetic, HBM bytes/s
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12


def _stage_stride(name: str) -> int:
    """The output stride of an encoder tensor by its name."""
    if ".conv1." in name and name.count(".") == 2:     # the stem
        return 2
    for i, s in (("layer1", 2), ("layer2", 4), ("layer3", 8)):
        if f".{i}." in name:
            return s
    return 8


def forward_flops(fam, cfg, H: int, W: int, iters: int) -> float:
    """FLOPs of one pair's test-mode forward."""
    total = 0.0
    for name, shape in fam.param_spec(cfg):
        if len(shape) != 4:
            continue
        cout, cin, kh, kw = shape
        per_px = 2.0 * cin * cout * kh * kw
        root = name.split(".")[0]
        if root in fam.VIEWS:
            s = _stage_stride(name)
            total += per_px * (H // s) * (W // s) * fam.VIEWS[root]
            continue
        px = (H // 8) * (W // 8)
        if ".mask." in name:
            runs = 1 if root in fam.TEST_MASKS else 0
        else:
            runs = iters
        total += per_px * px * runs
    q = (H // 8) * (W // 8)
    total += fam.VOLUMES * 2.0 * q * q * cfg["fnet_dim"]
    return total


def pair_flops(fam, cfg, traffic) -> float:
    return forward_flops(fam, cfg, traffic["height"], traffic["width"], cfg["iters"])


def peak_flops(traffic) -> tuple:
    """(FLOP/s, arithmetic) the cell's convolutions run in: bf16 under mixed
    precision, TF32 for f32 at torch's default cuDNN flags."""
    kind = "bf16" if traffic["precision"] == "bf16" else "tf32"
    return PEAK_FLOPS[kind], kind


# -- bytes of the port's DCCL kernels -----------------------------------------

def _unique_corners(coords, Hl: int, Wl: int) -> int:
    """Distinct elements of a (Q, Hl, Wl) per-query plane that a bilinear
    read with x wrapped mod Wl touches with nonzero weight at per-query tap
    coords (Q, K, 2)."""
    Q = coords.shape[0]
    x = torch.remainder(coords[..., 0], Wl)
    y = coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    q = torch.arange(Q, device=coords.device)[:, None]
    keys = []
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            cx, cy = x0 + dx, y0 + dy
            ok = (wx * wy > 0) & (cx <= Wl - 1) & (cy >= 0) & (cy <= Hl - 1)
            keys.append((q * (Hl * Wl) + cy.clamp(0, Hl - 1).long() * Wl
                         + cx.clamp(0, Wl - 1).long())[ok])
    return int(torch.unique(torch.cat(keys)).numel())


def dccl_window_elements(H: int, W: int, levels: int, radius: int, device) -> list:
    """Per level, the volume elements both branches' own and cross windows
    need for one image at the identity coords (zero flow): [(own, cross)]."""
    g = geometry.grids(H, W, device)
    h8, w8 = H // 8, W // 8
    cen = identity(h8, w8, device).reshape(-1, 1, 2)
    d = window(radius, device)
    out = []
    for lv in range(levels):
        Hl, Wl = h8 >> lv, w8 >> lv
        win = cen / 2.0 ** lv + d
        own = 2 * _unique_corners(win, Hl, Wl)
        cross = 0
        for grid in (g["a2b_w2c_8"], g["b2a_w2c_8"]):
            taps = bilinear(grid[None], win.reshape(1, -1, 2), wrap_x=True).reshape(win.shape)
            cross += _unique_corners(taps, Hl, Wl)
        out.append((own, cross))
    return out


def lookup_bytes(H, W, batch, levels, radius, vol_bytes, device) -> float:
    """Bytes of one forward's grid-route lookups per iteration, all levels,
    both branches: the windows' volume elements once, the four (B, Q, 81)
    f32 fields written, the centres and the two 1/8 grids read."""
    h8, w8 = H // 8, W // 8
    bq = batch * h8 * w8
    k = (2 * radius + 1) ** 2
    total = 0.0
    for own, cross in dccl_window_elements(H, W, levels, radius, device):
        total += batch * (own + cross) * vol_bytes + 4 * bq * k * 4 + 2 * bq * 8
        total += 2 * h8 * w8 * 2 * 4
    return total
